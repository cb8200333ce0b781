// Fused fold step for Hopper (sm_90a): unpack -> forward FFT -> chirp ->
// per-subband inverse FFT -> detect -> fold, for real-sampled 8-bit TFP input.
//
// Replaces the Pallas kernel dspsr_tpu/ops/megakernel.py::build_megastep.
// The TPU kernel expressed every transform as a dense DFT matmul (the shape
// its matrix unit wanted, ~885 GFLOP a flagship block); here the same
// factorisation runs as radix-2 FFTs in shared memory, about 100x fewer
// operations, so the step is bound by the bytes of its intermediates, not
// by arithmetic.  A flagship block (R1 = R2 = 512, 75 windows, 2 pols) moves
// the 68 MB of raw codes, 630 MB of stage-1 columns and 315 MB of spectra
// through device memory twice each.  What the design does about it: the
// inverse FFT, detection and fold are one kernel, so the 270 MB of subband
// voltages never leave shared memory; the forward transform is split in two
// passes (columns, then rows) whose tiles are written with coalesced runs.
// Fusing the forward passes, or walking the windows in L2-sized groups, is
// later work.
//
// Four kernels run in order on the caller's stream (plus two memsets):
//   mega_fwd1,   the forward passes shared with megafil.cu (see
//   mega_fwd2    mega_common.cuh): unpack, columns, twiddle; rows, chirp.
//   mega_invfold per (subband, window, input channel): length-freq_res
//                inverse FFT of each needed pol (scaled by 1/freq_res), keep
//                nfilt_pos <= t < nfilt_pos + nkeep, detect, fold into a
//                shared-memory [nplane, nbin] profile, add it to the block
//                accumulator.  The per-chunk ifftshift of the reference is
//                skipped: it is a (-1)^t factor that every detection product
//                cancels (the output is detected, never voltage).
//   mega_finish  profiles_out = profiles_in + block sum; hits likewise.
//
// Phase and bin placement are bit-exact with the reference: the phase is
// phi0 + dphi * (t - nfilt_pos) in f32 with each operation rounded
// separately (__fmul_rn/__fadd_rn: no FMA contraction), then
// frac = phi - floor(phi), bin = min(floor(frac * nbin), nbin - 1).  The
// sample-exact bounds compare the block output index w*nkeep + t - nfilt_pos
// as an integer, which equals the reference's f32 index below 2^24.
//
// Sums and their order.  On the TPU the windows ran in order and the sum was
// carried in VMEM.  Here windows run in parallel: each thread sums a run of
// consecutive samples that share a bin, adds it to the shared-memory profile
// with an atomic, and each CTA adds its profile to the block accumulator with
// global atomics.  The order of float additions therefore changes from run to
// run; profiles agree with the float64 reference to 2e-5 relative at the test
// geometry and with the plain PyTorch version to 1e-4 relative at the
// flagship geometry.  Hits are integer counts (unsigned atomics), exact, and
// are converted to float once, when added to the carried hits.
//
// The kernels allocate nothing and do not synchronise.  Each C entry point
// returns cudaGetLastError() (or the first error met).

#include "mega_common.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
mega_invfold(const float2* __restrict__ ybuf, const float* __restrict__ phi0,
             const float* __restrict__ dphi, float* __restrict__ pacc,
             unsigned* __restrict__ hacc, int npolf, int npart, int nsub,
             int M, int logM, int nfilt_pos, int nkeep, int nbin, int nplane,
             int det, int fourth, int lo, int hi) {
  extern __shared__ float2 sm[];
  float2* tw = sm;
  float2* a = tw + M / 2;
  float* prof = (float*)(a + npolf * M);
  unsigned* hit = (unsigned*)(prof + nplane * nbin);
  const int s = blockIdx.x;
  const int w = blockIdx.y;
  const int c = blockIdx.z;
  make_twiddles(tw, M, +1.0);
  for (int i = threadIdx.x; i < nplane * nbin; i += blockDim.x) prof[i] = 0.f;
  for (int i = threadIdx.x; i < nbin; i += blockDim.x) hit[i] = 0u;
  const long long n = (long long)nsub * M;
  for (int pf = 0; pf < npolf; ++pf) {
    const float2* src =
        ybuf + ((long long)(c * npolf + pf) * npart + w) * n + (long long)s * M;
    for (int j = threadIdx.x; j < M; j += blockDim.x)
      a[pf * M + bitrev(j, logM)] = src[j];
  }
  fft_smem(a, npolf, logM, M, tw);

  const float p0 = phi0[w];
  const float dp = dphi[w];
  const float inv_m = 1.0f / (float)M;
  const float fnbin = (float)nbin;
  // each thread folds a run of consecutive kept samples, summing while the
  // bin stays the same (a window spans a small fraction of a turn)
  const int per = (nkeep + blockDim.x - 1) / blockDim.x;
  const int i0 = threadIdx.x * per;
  const int i1 = min(i0 + per, nkeep);
  float acc[kMaxPlanes];
  unsigned cnt = 0;
  int cur = -1;
  for (int i = i0; i < i1; ++i) {
    const int g = w * nkeep + i;  // output index within the block
    if (g < lo || g >= hi) continue;
    const float phi = __fadd_rn(p0, __fmul_rn(dp, (float)i));
    const float frac = __fsub_rn(phi, floorf(phi));
    int b = (int)floorf(__fmul_rn(frac, fnbin));
    b = min(max(b, 0), nbin - 1);
    if (b != cur) {
      if (cur >= 0) {
#pragma unroll
        for (int p = 0; p < kMaxPlanes; ++p)
          if (p < nplane) atomicAdd(&prof[p * nbin + cur], acc[p]);
        atomicAdd(&hit[cur], cnt);
      }
      cur = b;
      cnt = 0;
#pragma unroll
      for (int p = 0; p < kMaxPlanes; ++p) acc[p] = 0.f;
    }
    const int t = nfilt_pos + i;
    const float2 va = a[t];
    const float2 xa = make_float2(va.x * inv_m, va.y * inv_m);
    float2 xb = make_float2(0.f, 0.f);
    if (npolf > 1) {
      const float2 vb = a[M + t];
      xb = make_float2(vb.x * inv_m, vb.y * inv_m);
    }
    float pl[kMaxPlanes];
    detect(xa, xb, det, fourth, pl);
#pragma unroll
    for (int p = 0; p < kMaxPlanes; ++p)
      if (p < nplane) acc[p] += pl[p];
    ++cnt;
  }
  if (cur >= 0) {
#pragma unroll
    for (int p = 0; p < kMaxPlanes; ++p)
      if (p < nplane) atomicAdd(&prof[p * nbin + cur], acc[p]);
    atomicAdd(&hit[cur], cnt);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nplane * nbin; i += blockDim.x) {
    const float v = prof[i];
    if (v != 0.f) {
      const int p = i / nbin;
      const int b = i - p * nbin;
      atomicAdd(&pacc[(((long long)c * nplane + p) * nsub + s) * nbin + b], v);
    }
  }
  if (s == 0) {
    for (int b = threadIdx.x; b < nbin; b += blockDim.x)
      if (hit[b]) atomicAdd(&hacc[(long long)c * nbin + b], hit[b]);
  }
}

__global__ void __launch_bounds__(kThreads)
mega_finish(const float* __restrict__ pin, const float* __restrict__ pacc,
            float* __restrict__ pout, int nprof,
            const float* __restrict__ hin, const unsigned* __restrict__ hacc,
            float* __restrict__ hout, int nhits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < nprof) pout[i] = pin[i] + pacc[i];
  if (i < nhits) hout[i] = hin[i] + (float)hacc[i];
}

}  // namespace

extern "C" {

const char* megastep_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Shared-memory bytes of the three transform kernels (the Python wrapper
// checks the same sums against the card's limit before launching).
int megastep_smem_bytes(int which, int R1, int row_len, int M, int npolf,
                        int nplane, int nbin, int tile) {
  if (which < 2) return fwd_smem_bytes(which, R1, row_len, tile);
  return (M / 2 + npolf * M) * (int)sizeof(float2) + (nplane * nbin + nbin) * 4;
}

// One fused fold step.  Pointers are device pointers; scratch buffers are
// sized by the wrapper: cbuf float2[nchan*npolf, npart, R1, row_len], ybuf
// float2[nchan*npolf, npart, R1*R2], pacc float[nchan, nplane, nsub, nbin],
// hacc uint32[nchan, nbin].  Output samples g of the block fold only when
// lo <= g < hi.
int megastep_launch(const void* raw, const void* phi0, const void* dphi,
                    const void* gr, const void* gi, const void* prof_in,
                    const void* hits_in, void* prof_out, void* hits_out,
                    void* cbuf, void* ybuf, void* pacc, void* hacc, int nchan,
                    int npol, int pol0, int npolf, int npart, int R1, int R2,
                    int nsub, int M, int nfilt_pos, int nkeep, int nbin,
                    int nplane, int det, int fourth, int twos, float scale,
                    float offset, int nsamp_step, int tc, int tk, int lo,
                    int hi, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  cudaError_t err;
  const int smem3 = megastep_smem_bytes(2, R1, 2 * R2, M, npolf, nplane, nbin, 0);
  if ((err = cudaFuncSetAttribute(mega_invfold,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem3)) != cudaSuccess)
    return (int)err;
  const size_t nprof = (size_t)nchan * nplane * nsub * nbin;
  const size_t nhits = (size_t)nchan * nbin;
  if ((err = cudaMemsetAsync(pacc, 0, nprof * sizeof(float), stream)) != cudaSuccess)
    return (int)err;
  if ((err = cudaMemsetAsync(hacc, 0, nhits * sizeof(unsigned), stream)) != cudaSuccess)
    return (int)err;
  if ((err = launch_forward(raw, gr, gi, cbuf, ybuf, nchan, npol, pol0, npolf,
                            npart, R1, R2, twos, scale, offset, nsamp_step,
                            tc, tk, stream)) != cudaSuccess)
    return (int)err;

  dim3 g3(nsub, npart, nchan);
  mega_invfold<<<g3, kThreads, smem3, stream>>>(
      (const float2*)ybuf, (const float*)phi0, (const float*)dphi,
      (float*)pacc, (unsigned*)hacc, npolf, npart, nsub, M, ilog2(M),
      nfilt_pos, nkeep, nbin, nplane, det, fourth, lo, hi);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int nmax = (int)(nprof > nhits ? nprof : nhits);
  mega_finish<<<(nmax + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      (const float*)prof_in, (const float*)pacc, (float*)prof_out, (int)nprof,
      (const float*)hits_in, (const unsigned*)hacc, (float*)hits_out,
      (int)nhits);
  return (int)cudaGetLastError();
}

}  // extern "C"
