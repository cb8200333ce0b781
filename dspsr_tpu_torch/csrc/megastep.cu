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
//   mega_fwd1    per (input channel x pol, window, tile of columns m):
//                unpack codes, 2N-sample window viewed as W[n1, m] with
//                n = n1*row_len + m; radix-R1 FFT over n1, twiddle
//                exp(-2 pi i m k1 / 2N); store C[k1, m].
//   mega_fwd2    per (input channel x pol, window, tile of rows k1): FFT of
//                length row_len = 2*R2 over m, keep k2 < R2 (Nyquist
//                dropped), multiply the chirp, store the spectrum in natural
//                bin order k = k2*R1 + k1.
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPlanes = 14;

__device__ __forceinline__ unsigned bitrev(unsigned x, int bits) {
  return __brev(x) >> (32 - bits);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// tw[j] = exp(sign * 2 pi i j / L) for j < L/2, rounded from double.
__device__ void make_twiddles(float2* tw, int L, double sign) {
  for (int j = threadIdx.x; j < L / 2; j += blockDim.x) {
    double s, c;
    sincospi(sign * 2.0 * j / L, &s, &c);
    tw[j] = make_float2((float)c, (float)s);
  }
}

// nseq in-place radix-2 decimation-in-time FFTs of length 2^logL, sequence
// stride ld, on input already in bit-reversed order.  Every thread of the
// block takes part; ends with a barrier.
__device__ void fft_smem(float2* a, int nseq, int logL, int ld,
                         const float2* tw) {
  const int L = 1 << logL;
  const int half = L >> 1;
  const int nbf = nseq * half;
  for (int s = 1; s <= logL; ++s) {
    const int h = 1 << (s - 1);
    const int tstride = L >> s;
    __syncthreads();
    for (int b = threadIdx.x; b < nbf; b += blockDim.x) {
      const int seq = b >> (logL - 1);
      const int r = b & (half - 1);
      const int grp = r >> (s - 1);
      const int k = r & (h - 1);
      const int i0 = seq * ld + grp * 2 * h + k;
      const int i1 = i0 + h;
      const float2 u = a[i0];
      const float2 v = cmul(a[i1], tw[k * tstride]);
      a[i0] = make_float2(u.x + v.x, u.y + v.y);
      a[i1] = make_float2(u.x - v.x, u.y - v.y);
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
mega_fwd1(const uint8_t* __restrict__ raw, float2* __restrict__ cbuf,
          int nchan, int npol, int pol0, int npolf, int npart, int R1,
          int logR1, int row_len, int nsamp_step, int tc, int twos,
          float scale, float offset) {
  extern __shared__ float2 sm[];
  float2* tw = sm;
  float2* a = sm + R1 / 2;
  const int ld = R1 + 1;
  const int m0 = blockIdx.x * tc;
  const int w = blockIdx.y;
  const int cp = blockIdx.z;
  const int c = cp / npolf;
  const int pol = pol0 + (cp - c * npolf);
  make_twiddles(tw, R1, -1.0);
  const long long t0 = (long long)w * nsamp_step + m0;
  for (int idx = threadIdx.x; idx < tc * R1; idx += blockDim.x) {
    const int col = idx % tc;
    const int n1 = idx / tc;
    const long long t = t0 + (long long)n1 * row_len + col;
    const uint8_t byte = raw[(t * nchan + c) * npol + pol];
    const float code = twos ? (float)(int8_t)byte : (float)byte;
    a[col * ld + bitrev(n1, logR1)] = make_float2(code * scale + offset, 0.f);
  }
  fft_smem(a, tc, logR1, ld, tw);
  // twiddle exp(-2 pi i m k1 / (2N)), 2N = R1 * row_len; the argument is
  // reduced exactly in integers first
  const long long two_n = (long long)R1 * row_len;
  float2* dst = cbuf + ((long long)cp * npart + w) * R1 * row_len;
  for (int idx = threadIdx.x; idx < tc * R1; idx += blockDim.x) {
    const int col = idx % tc;
    const int k1 = idx / tc;
    const int m = m0 + col;
    const long long r = ((long long)m * k1) % two_n;
    float s, co;
    sincospif(-2.0f * (float)r / (float)two_n, &s, &co);
    dst[(long long)k1 * row_len + m] =
        cmul(a[col * ld + k1], make_float2(co, s));
  }
}

__global__ void __launch_bounds__(kThreads)
mega_fwd2(const float2* __restrict__ cbuf, float2* __restrict__ ybuf,
          const float* __restrict__ gr, const float* __restrict__ gi,
          int npolf, int npart, int R1, int R2, int row_len, int logrow,
          int tk) {
  extern __shared__ float2 sm[];
  float2* tw = sm;
  float2* a = sm + row_len / 2;
  const int ld = row_len + 1;
  const int k10 = blockIdx.x * tk;
  const int w = blockIdx.y;
  const int cp = blockIdx.z;
  const int c = cp / npolf;
  make_twiddles(tw, row_len, -1.0);
  const float2* src =
      cbuf + (((long long)cp * npart + w) * R1 + k10) * row_len;
  for (int idx = threadIdx.x; idx < tk * row_len; idx += blockDim.x) {
    const int r = idx / row_len;
    const int m = idx - r * row_len;
    a[r * ld + bitrev(m, logrow)] = src[idx];
  }
  fft_smem(a, tk, logrow, ld, tw);
  const long long n = (long long)R1 * R2;
  float2* dst = ybuf + ((long long)cp * npart + w) * n;
  const float* grc = gr + (long long)c * n;
  const float* gic = gi + (long long)c * n;
  for (int idx = threadIdx.x; idx < tk * R2; idx += blockDim.x) {
    const int r = idx % tk;
    const int k2 = idx / tk;
    const long long k = (long long)k2 * R1 + k10 + r;
    dst[k] = cmul(a[r * ld + k2], make_float2(grc[k], gic[k]));
  }
}

enum Det { kDetOne = 0, kDetSum = 1, kDetPPQQ = 2, kDetCoh = 3, kDetStokes = 4 };

// Detected planes of one output sample from the (1/freq_res-scaled) voltages
// of the first and second folded pol (reference detection order, plus the 10
// unique S_i * S_j products after the Stokes planes when fourth != 0).
__device__ __forceinline__ void detect(float2 a, float2 b, int det,
                                       int fourth, float* pl) {
  const float pp = a.x * a.x + a.y * a.y;
  if (det == kDetOne) {
    pl[0] = pp;
    return;
  }
  const float qq = b.x * b.x + b.y * b.y;
  if (det == kDetSum) {
    pl[0] = pp + qq;
    return;
  }
  if (det == kDetPPQQ) {
    pl[0] = pp;
    pl[1] = qq;
    return;
  }
  const float re = a.x * b.x + a.y * b.y;
  const float im = a.x * b.y - a.y * b.x;
  if (det == kDetCoh) {
    pl[0] = pp; pl[1] = qq; pl[2] = re; pl[3] = im;
  } else {
    pl[0] = pp + qq; pl[1] = pp - qq; pl[2] = 2.f * re; pl[3] = 2.f * im;
  }
  if (fourth) {
    int k = 4;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = i; j < 4; ++j) pl[k++] = pl[i] * pl[j];
  }
}

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

int ilog2(int x) {
  int r = 0;
  while ((1 << r) < x) ++r;
  return r;
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
  switch (which) {
    case 0: return (R1 / 2 + tile * (R1 + 1)) * (int)sizeof(float2);
    case 1: return (row_len / 2 + tile * (row_len + 1)) * (int)sizeof(float2);
    default:
      return (M / 2 + npolf * M) * (int)sizeof(float2) +
             (nplane * nbin + nbin) * 4;
  }
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
  const int row_len = 2 * R2;
  cudaError_t err;
  const int smem1 = megastep_smem_bytes(0, R1, row_len, M, npolf, nplane, nbin, tc);
  const int smem2 = megastep_smem_bytes(1, R1, row_len, M, npolf, nplane, nbin, tk);
  const int smem3 = megastep_smem_bytes(2, R1, row_len, M, npolf, nplane, nbin, 0);
  if ((err = cudaFuncSetAttribute(mega_fwd1,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem1)) != cudaSuccess)
    return (int)err;
  if ((err = cudaFuncSetAttribute(mega_fwd2,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem2)) != cudaSuccess)
    return (int)err;
  if ((err = cudaFuncSetAttribute(mega_invfold,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem3)) != cudaSuccess)
    return (int)err;
  const size_t nprof = (size_t)nchan * nplane * nsub * nbin;
  const size_t nhits = (size_t)nchan * nbin;
  if ((err = cudaMemsetAsync(pacc, 0, nprof * sizeof(float), stream)) != cudaSuccess)
    return (int)err;
  if ((err = cudaMemsetAsync(hacc, 0, nhits * sizeof(unsigned), stream)) != cudaSuccess)
    return (int)err;

  dim3 g1(row_len / tc, npart, nchan * npolf);
  mega_fwd1<<<g1, kThreads, smem1, stream>>>(
      (const uint8_t*)raw, (float2*)cbuf, nchan, npol, pol0, npolf, npart, R1,
      ilog2(R1), row_len, nsamp_step, tc, twos, scale, offset);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  dim3 g2(R1 / tk, npart, nchan * npolf);
  mega_fwd2<<<g2, kThreads, smem2, stream>>>(
      (const float2*)cbuf, (float2*)ybuf, (const float*)gr, (const float*)gi,
      npolf, npart, R1, R2, row_len, ilog2(row_len), tk);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

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
