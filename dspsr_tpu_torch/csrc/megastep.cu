// Fused fold step for Hopper (sm_90a): unpack -> forward FFT -> chirp ->
// per-subband inverse FFT -> detect -> fold, for 1/2/4/8-bit codes (fixed
// levels, or JA98 dynamic 2-bit levels with excision weights) or float32
// samples, optionally apodized: real-sampled (TFP, or CASPSR 8-bit bytes)
// or complex (analytic, TFP).
//
// Replaces the Pallas kernel dspsr_tpu/ops/megakernel.py::build_megastep.
// The TPU kernel expressed every transform as a dense DFT matmul (the shape
// its matrix unit wanted, ~885 GFLOP a flagship block); here the same
// factorisation runs as register-resident FFTs (see mega_common.cuh), about
// 10 GFLOP, so the step is bound by moving data, not by arithmetic.  The
// tensor cores are not used: single-pass TF32 keeps about three digits and
// cannot meet the 2e-5 tolerance, and the arithmetic is not the bound.  A
// flagship block (R1 = R2 = 512, 75 windows, 2 pols packed as one complex
// sequence) reads 79 MB of codes twice and writes and reads 315 MB of
// stage-1 columns and 315 MB of spectra: about 1.3 GB, 0.40 ms at the
// device-memory rate.  Measured on an H100 (700 W) the step takes about
// 1.2 ms, of which the two forward passes take 0.9 and mega_invfold 0.28
// (1.1 TB/s for its 315 MB: the fold's shared-memory atomics and profile
// flush sit on top of the inverse).  The inverse FFT, detection and fold are
// one kernel, so the 270 MB of subband voltages never leave shared memory.
//
// Five kernels run in order on the caller's stream (plus two memsets),
// after the JA98 pre-pass (mega_ja98, mega_ja98_windows) for dynamic 2-bit
// input:
//   mega_polpow, the forward half shared with megafil.cu (see
//   mega_fwd1,   mega_common.cuh): pol energies; unpack, columns, twiddle;
//   mega_fwd2    rows, pol separation, chirp.  Complex input runs
//                mega_fwd1<P, kComplexTfp> and mega_fwd2c per pol instead
//                and has no mega_polpow; its spectra land in the same
//                natural (centred) order, so the kernels below do not
//                change.
//   mega_invfold per (subband, window, input channel): length-freq_res
//                inverse FFT of each needed pol (scaled by 1/freq_res), keep
//                nfilt_pos <= t < nfilt_pos + nkeep, detect, fold into a
//                shared-memory [nplane, nbin] profile, add it to the block
//                accumulator.  The per-chunk ifftshift of the reference is
//                skipped: it is a (-1)^t factor that every detection product
//                cancels (the output is detected, never voltage).  A
//                window whose JA98 weight is 0 folds nothing.
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

// wgt, when not null, is each window's weight float[nchan, npart] (0 or 1,
// JA98 excision): a window of weight 0 returns before its inverse, so it
// adds nothing and counts no hits; otherwise its sums are scaled by the
// weight and its hits counted.
template <int P, int NS>
__global__ void __launch_bounds__(kMaxThreads)
mega_invfold(const float2* __restrict__ ybuf, const float* __restrict__ phi0,
             const float* __restrict__ dphi, const float* __restrict__ wgt,
             float* __restrict__ pacc, unsigned* __restrict__ hacc,
             const float2* __restrict__ tw, int npart, int nsub, int M,
             int nfilt_pos, int nkeep, int nbin, int nplane, int det,
             int fourth, int lo, int hi) {
  extern __shared__ float2 sm[];
  const int ld = seq_ld(M);
  float* prof = (float*)(sm + NS * ld);
  unsigned* hit = (unsigned*)(prof + nplane * nbin);
  const int s = blockIdx.x;
  const int w = blockIdx.y;
  const int c = blockIdx.z;
  const float wt = wgt ? __ldg(wgt + (long long)c * npart + w) : 1.f;
  if (wt == 0.f) return;  // the whole CTA, before any barrier
  for (int i = threadIdx.x; i < nplane * nbin; i += blockDim.x) prof[i] = 0.f;
  for (int i = threadIdx.x; i < nbin; i += blockDim.x) hit[i] = 0u;
  inverse_subband<P, NS>(ybuf, sm, tw, npart, nsub, M, s, w, c);

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
    const float2 va = sm[sidx(t)];
    const float2 xa = make_float2(va.x * inv_m, va.y * inv_m);
    float2 xb = make_float2(0.f, 0.f);
    if (NS > 1) {
      const float2 vb = sm[ld + sidx(t)];
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
      atomicAdd(&pacc[(((long long)c * nplane + p) * nsub + s) * nbin + b],
                v * wt);
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

// The inverse-and-fold kernel for freq_res M and npolf pols.
decltype(&mega_invfold<16, 2>) invfold_kernel(int M, int npolf) {
  if (M >= 16) return npolf == 2 ? &mega_invfold<16, 2> : &mega_invfold<16, 1>;
  return npolf == 2 ? &mega_invfold<8, 2> : &mega_invfold<8, 1>;
}

}  // namespace

extern "C" {

const char* megastep_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Shared-memory bytes (kind 0) or threads (kind 1) of the three transform
// kernels: which 0 = mega_fwd1 (tile of `tile` columns), 1 = mega_fwd2
// (tile of `tile` row pairs; complex input, layout kComplexTfp:
// mega_fwd2c, `tile` rows), 2 = mega_invfold.  The Python wrapper checks
// them against the card's limits before launching.
int megastep_resources(int kind, int which, int R1, int row_len, int M,
                       int npolf, int nplane, int nbin, int tile, int layout) {
  if (kind == 1) return transform_threads(which, R1, row_len, M, tile);
  if (which < 2)
    return fwd_smem_bytes(which, R1, row_len, tile, layout == kComplexTfp);
  return inv_smem_bytes(M, npolf) + (nplane * nbin + nbin) * 4;
}

// One fused fold step.  Pointers are device pointers; tw is the wrapper's
// twiddle-table buffer (see Tables in mega_common.cuh); scratch buffers are
// sized by the wrapper: psum float[nchan, npart, 2], cbuf float2[nchan *
// nseq, npart, R1, row_len] (nseq npolf for complex input, else 1), ybuf
// float2[nchan*npolf, npart, R1*R2], pacc float[nchan, nplane, nsub, nbin],
// hacc uint32[nchan, nbin].  layout is the raw bytes' Layout and code their
// Code (see mega_common.cuh); row_len is R2 for complex input and 2*R2 for
// real input.  window is null or the taper float[R1*row_len]; for JA98
// codes levels holds the lo, hi and weight tables (npw + 1 floats each),
// and nlow uint16[nchan*npol*ndim, nweights], wblk float[nchan, nweights]
// and wwin float[nchan, npart] are the pre-pass's scratch (nweights =
// samples a block / npw).  Output samples g of the block fold only when lo
// <= g < hi.
int megastep_launch(const void* raw, const void* phi0, const void* dphi,
                    const void* gr, const void* gi, const void* tw,
                    const void* prof_in, const void* hits_in, void* prof_out,
                    void* hits_out, void* psum, void* cbuf, void* ybuf,
                    void* pacc, void* hacc, const void* window,
                    const void* levels, void* nlow, void* wblk, void* wwin,
                    int nchan, int npol, int pol0,
                    int npolf, int npart, int R1, int R2, int nsub, int M,
                    int nfilt_pos, int nkeep, int nbin, int nplane, int det,
                    int fourth, int twos, float scale, float offset,
                    int nsamp_step, int tc, int tk, int lo, int hi,
                    int layout, int code, int npw, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  cudaError_t err;
  const int row_len = layout == kComplexTfp ? R2 : 2 * R2;
  const Unpack u = make_unpack(
      twos, scale, offset, window, levels, nlow, npw,
      (long long)(npart - 1) * nsamp_step + (long long)R1 * row_len);
  auto inv = invfold_kernel(M, npolf);
  const int smem3 =
      megastep_resources(0, 2, R1, row_len, M, npolf, nplane, nbin, 0, layout);
  if ((err = cudaFuncSetAttribute(inv,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem3)) != cudaSuccess)
    return (int)err;
  const size_t nprof = (size_t)nchan * nplane * nsub * nbin;
  const size_t nhits = (size_t)nchan * nbin;
  if ((err = cudaMemsetAsync(pacc, 0, nprof * sizeof(float), stream)) != cudaSuccess)
    return (int)err;
  if ((err = cudaMemsetAsync(hacc, 0, nhits * sizeof(unsigned), stream)) != cudaSuccess)
    return (int)err;
  if ((err = launch_forward(raw, gr, gi, tw, psum, cbuf, ybuf, nullptr,
                            nchan, npol, pol0, npolf, npolf == 2 ? 3 : 1,
                            npart, R1, R2, M, code, u, wblk, wwin,
                            nsamp_step, tc, tk, layout,
                            stream)) != cudaSuccess)
    return (int)err;

  inv<<<dim3(nsub, npart, nchan), transform_threads(2, R1, row_len, M, 0),
        smem3, stream>>>(
      (const float2*)ybuf, (const float*)phi0, (const float*)dphi,
      code == kCodeJA98 ? (const float*)wwin : nullptr, (float*)pacc,
      (unsigned*)hacc, tables(tw, R1, row_len, M).inv, npart,
      nsub, M, nfilt_pos, nkeep, nbin, nplane, det, fourth, lo, hi);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int nmax = (int)(nprof > nhits ? nprof : nhits);
  mega_finish<<<(nmax + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      (const float*)prof_in, (const float*)pacc, (float*)prof_out, (int)nprof,
      (const float*)hits_in, (const unsigned*)hacc, (float*)hits_out,
      (int)nhits);
  return (int)cudaGetLastError();
}

// The JA98 pre-pass alone (mega_ja98, mega_ja98_windows), for checks and
// timing: 2-bit codes of nsamp_block samples of nchan*npol*ndim digitizers
// -> nlow, wblk and wwin as in megastep_launch.
int megastep_ja98(const void* raw, const void* levels, void* nlow, void* wblk,
                  void* wwin, int nchan, int npol, int ndim, int npart,
                  int nsamp_step, int nsamp_fft, int npw, void* stream_ptr) {
  const Unpack u = make_unpack(
      0, 1.f, 0.f, nullptr, levels, nlow, npw,
      (long long)(npart - 1) * nsamp_step + nsamp_fft);
  return (int)launch_ja98(raw, u, wblk, wwin, nchan, npol, ndim, npart,
                          nsamp_step, nsamp_fft, (cudaStream_t)stream_ptr);
}

}  // extern "C"
