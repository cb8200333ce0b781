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
// Five kernels run in order on the caller's stream (plus three memsets),
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
//                window whose weight (JA98 times the caller's external
//                weight) is 0 folds nothing.
//   mega_finish  profiles_out = profiles_in + block sum; hits likewise.
//
// Past one CTA (freq_res above 8192 points, or the [nplane, nbin] profile
// too large beside the inverse: -F 64:D at the flagship band from DM ~5,
// J1713+0747's 15.99 and J0613-0200's 38.78 among them) the multi-pass
// inverse of mega_common.cuh replaces mega_invfold: mega_inva (pass A),
// then mega_invbfold, pass B with the fold (see there).  Real input at R2 =
// 8192 runs the long row pass in place of mega_fwd2.  A J0613-0200 block (8
// windows of 2^24 samples) moves about 10 GB through device memory, and
// each pass reads or writes its 1.07 GB of columns, rows or spectra at
// 1.1-2.3 TB/s.
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
// flagship geometry.  Hits are integer counts in each CTA (unsigned
// atomics in shared memory), added to the block's float accumulator hacc as
// count * window weight, as the reference weights its one-hot: exact while
// a bin of a block counts fewer than 2^24 hits, as the float32 carried hits
// (the reference's too) need anyway.
//
// The kernels allocate nothing and do not synchronise.  Each C entry point
// returns cudaGetLastError() (or the first error met).

#include "mega_common.cuh"

namespace {

// Each window's weight: the JA98 window weight wja (0 or 1) times the
// caller's external weight wext (any value), each 1 when null.  A window of
// weight 0 returns before its inverse, so it adds nothing and counts no
// hits; otherwise its sums are scaled by the weight.
__device__ __forceinline__ float window_weight(const float* __restrict__ wja,
                                               const float* __restrict__ wext,
                                               long long i) {
  float wt = wja ? __ldg(wja + i) : 1.f;
  if (wext) wt *= __ldg(wext + i);
  return wt;
}

// The phase bin of kept sample i of window w (see the note at the top).
__device__ __forceinline__ int fold_bin(float p0, float dp, int i,
                                        float fnbin, int nbin) {
  const float phi = __fadd_rn(p0, __fmul_rn(dp, (float)i));
  const float frac = __fsub_rn(phi, floorf(phi));
  const int b = (int)floorf(__fmul_rn(frac, fnbin));
  return min(max(b, 0), nbin - 1);
}

// The fold of one CTA's items i0 .. i1 - 1 (as each kernel walks its
// tile): index(it) is the kept-sample index of item it (out of range
// skips it), load(it, xa, xb) its pols' values.  Each thread sums a run of
// consecutive items that share a bin (a window spans a small fraction of a
// turn) and hands each run to flush(bin, acc, cnt).
template <class Index, class Load, class Flush>
__device__ __forceinline__ void fold_runs(int i0, int i1, int w, int nkeep,
                                          int lo, int hi, float p0, float dp,
                                          int nbin, int nplane, int det,
                                          int fourth, Index index, Load load,
                                          Flush flush) {
  const float fnbin = (float)nbin;
  float acc[kMaxPlanes];
  unsigned cnt = 0;
  int cur = -1;
  for (int it = i0; it < i1; ++it) {
    const int i = index(it);
    if (i < 0 || i >= nkeep) continue;
    const int g = w * nkeep + i;  // output index within the block
    if (g < lo || g >= hi) continue;
    const int b = fold_bin(p0, dp, i, fnbin, nbin);
    if (b != cur) {
      if (cur >= 0) flush(cur, acc, cnt);
      cur = b;
      cnt = 0;
#pragma unroll
      for (int p = 0; p < kMaxPlanes; ++p) acc[p] = 0.f;
    }
    float2 xa, xb;
    load(it, xa, xb);
    float pl[kMaxPlanes];
    detect(xa, xb, det, fourth, pl);
#pragma unroll
    for (int p = 0; p < kMaxPlanes; ++p)
      if (p < nplane) acc[p] += pl[p];
    ++cnt;
  }
  if (cur >= 0) flush(cur, acc, cnt);
}

template <int P, int NS>
__global__ void __launch_bounds__(kMaxThreads)
mega_invfold(const float2* __restrict__ ybuf, const float* __restrict__ phi0,
             const float* __restrict__ dphi, const float* __restrict__ wja,
             const float* __restrict__ wext, float* __restrict__ pacc,
             float* __restrict__ hacc, const float2* __restrict__ tw,
             int npart, int nsub, int M, int nfilt_pos, int nkeep, int nbin, int nplane, int det,
             int fourth, int lo, int hi) {
  extern __shared__ float2 sm[];
  const int ld = seq_ld(M);
  float* prof = (float*)(sm + NS * ld);
  unsigned* hit = (unsigned*)(prof + nplane * nbin);
  const int s = blockIdx.x;
  const int w = blockIdx.y;
  const int c = blockIdx.z;
  const float wt = window_weight(wja, wext, (long long)c * npart + w);
  if (wt == 0.f) return;  // the whole CTA, before any barrier
  for (int i = threadIdx.x; i < nplane * nbin; i += blockDim.x) prof[i] = 0.f;
  for (int i = threadIdx.x; i < nbin; i += blockDim.x) hit[i] = 0u;
  inverse_subband<P, NS>(ybuf, sm, tw, npart, nsub, M, s, w, c);

  const float inv_m = 1.0f / (float)M;
  // each thread folds a run of consecutive kept samples
  const int per = (nkeep + blockDim.x - 1) / blockDim.x;
  const int i0 = threadIdx.x * per;
  fold_runs(
      i0, min(i0 + per, nkeep), w, nkeep, lo, hi, phi0[w], dphi[w], nbin,
      nplane, det, fourth, [](int i) { return i; },
      [&](int i, float2& xa, float2& xb) {
        const int t = nfilt_pos + i;
        const float2 va = sm[sidx(t)];
        xa = make_float2(va.x * inv_m, va.y * inv_m);
        xb = make_float2(0.f, 0.f);
        if (NS > 1) {
          const float2 vb = sm[ld + sidx(t)];
          xb = make_float2(vb.x * inv_m, vb.y * inv_m);
        }
      },
      [&](int b, const float(&acc)[kMaxPlanes], unsigned cnt) {
#pragma unroll
        for (int p = 0; p < kMaxPlanes; ++p)
          if (p < nplane) atomicAdd(&prof[p * nbin + b], acc[p]);
        atomicAdd(&hit[b], cnt);
      });
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
      if (hit[b]) atomicAdd(&hacc[(long long)c * nbin + b], hit[b] * wt);
  }
}

// Pass B of the multi-pass inverse with the fold (pass A is mega_inva of
// mega_common.cuh): per (tile of S <= q consecutive rows a .. a + S - 1 of
// subband s = a / q, window, input channel), the length-R1 inverse of every
// transformed pol's rows (inverse_rows), 1/M, then the fold of sample t =
// n2 + q*n1 (n2 = a mod q + r) as mega_invfold folds it: the same phase,
// bin, bounds and weights.  The tile's samples in time order are idx = n1*S
// + r; each thread folds a run of consecutive idx, summing while the bin
// stays the same.  Unless GLOBAL, the sums go to a shared-memory [nplane,
// nbin] profile after pass B's tile, added to the block accumulator at the
// end; with GLOBAL (a profile too large to sit beside the tile: 14 planes
// at 4096 bins need 245 KB) each run's sums go to it directly with global
// atomics.  Tiles of subband 0 count the hits.
template <int P, int NS, bool GLOBAL>
__global__ void __launch_bounds__(kMaxThreads)
mega_invbfold(const float2* __restrict__ zbuf, const float* __restrict__ phi0,
              const float* __restrict__ dphi, const float* __restrict__ wja,
              const float* __restrict__ wext, float* __restrict__ pacc,
              float* __restrict__ hacc, Tables tb, int npart, int R1,
              int R2, int q, int nfilt_pos, int nkeep, int nbin, int nplane,
              int det, int fourth, int lo, int hi, int S) {
  extern __shared__ float2 sm[];
  const int ld = seq_ld(R1);
  const int a = blockIdx.x * S;  // the tile's first row
  const int w = blockIdx.y;
  const int c = blockIdx.z;
  const int nsub = R2 / q;
  const int s = a / q;
  const int n2a = a & (q - 1);
  const float wt = window_weight(wja, wext, (long long)c * npart + w);
  if (wt == 0.f) return;  // the whole CTA, before any barrier
  float* prof = (float*)(sm + NS * S * ld);
  unsigned* hit = (unsigned*)(prof + nplane * nbin);
  if (!GLOBAL) {
    for (int i = threadIdx.x; i < nplane * nbin; i += blockDim.x)
      prof[i] = 0.f;
    for (int i = threadIdx.x; i < nbin; i += blockDim.x) hit[i] = 0u;
  }
  inverse_rows<P, NS>(zbuf, sm, tb.r1, npart, R1, (long long)R1 * R2, a, w,
                      c, S);

  const float inv_m = 1.0f / (float)(R1 * q);
  // plane p of this subband's profile at pc + p*nsub*nbin
  float* pc = pacc + ((long long)c * nplane * nsub + s) * nbin;
  float* hc = hacc + (long long)c * nbin;
  const int items = S * R1;
  const int per = (items + blockDim.x - 1) / blockDim.x;
  const int i0 = threadIdx.x * per;
  const int lg = __ffs(S) - 1;
  // item idx of the tile is sample t = n2a + r + q*n1 (r = idx mod S, n1 =
  // idx / S): kept-sample index t - nfilt_pos
  fold_runs(
      i0, min(i0 + per, items), w, nkeep, lo, hi, phi0[w], dphi[w], nbin,
      nplane, det, fourth,
      [&](int idx) {
        return n2a + (idx & (S - 1)) + q * (idx >> lg) - nfilt_pos;
      },
      [&](int idx, float2& xa, float2& xb) {
        const int n1 = idx >> lg;
        const int r = idx & (S - 1);
        const float2 va = sm[r * ld + sidx(n1)];
        xa = make_float2(va.x * inv_m, va.y * inv_m);
        xb = make_float2(0.f, 0.f);
        if (NS > 1) {
          const float2 vb = sm[(S + r) * ld + sidx(n1)];
          xb = make_float2(vb.x * inv_m, vb.y * inv_m);
        }
      },
      [&](int b, const float(&acc)[kMaxPlanes], unsigned cnt) {
        if (GLOBAL) {
#pragma unroll
          for (int p = 0; p < kMaxPlanes; ++p)
            if (p < nplane)
              atomicAdd(pc + (long long)p * nsub * nbin + b, acc[p] * wt);
          if (s == 0) atomicAdd(hc + b, cnt * wt);
        } else {
#pragma unroll
          for (int p = 0; p < kMaxPlanes; ++p)
            if (p < nplane) atomicAdd(&prof[p * nbin + b], acc[p]);
          atomicAdd(&hit[b], cnt);
        }
      });
  if (GLOBAL) return;
  __syncthreads();
  for (int i = threadIdx.x; i < nplane * nbin; i += blockDim.x) {
    const float v = prof[i];
    if (v != 0.f) {
      const int p = i / nbin;
      atomicAdd(pc + (long long)p * nsub * nbin + (i - p * nbin), v * wt);
    }
  }
  if (s == 0) {
    for (int b = threadIdx.x; b < nbin; b += blockDim.x)
      if (hit[b]) atomicAdd(hc + b, hit[b] * wt);
  }
}

__global__ void __launch_bounds__(kThreads)
mega_finish(const float* __restrict__ pin, const float* __restrict__ pacc,
            float* __restrict__ pout, int nprof,
            const float* __restrict__ hin, const float* __restrict__ hacc,
            float* __restrict__ hout, int nhits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < nprof) pout[i] = pin[i] + pacc[i];
  if (i < nhits) hout[i] = hin[i] + hacc[i];
}

// The inverse-and-fold kernel for freq_res M and npolf pols.
decltype(&mega_invfold<16, 2>) invfold_kernel(int M, int npolf) {
  if (M >= 16) return npolf == 2 ? &mega_invfold<16, 2> : &mega_invfold<16, 1>;
  return npolf == 2 ? &mega_invfold<8, 2> : &mega_invfold<8, 1>;
}

// Pass B with the fold for R1, npolf pols and the global-atomic fold or not.
template <bool G>
decltype(&mega_invbfold<16, 2, G>) invbfold_kernel(int R1, int npolf) {
  if (R1 >= 16)
    return npolf == 2 ? &mega_invbfold<16, 2, G> : &mega_invbfold<16, 1, G>;
  return npolf == 2 ? &mega_invbfold<8, 2, G> : &mega_invbfold<8, 1, G>;
}

}  // namespace

extern "C" {

const char* megastep_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Shared-memory bytes (kind 0) or threads (kind 1) of pass `which` (Pass
// in mega_common.cuh): the forward passes (tile of `tile` columns, or of
// row pairs for real input and rows for complex input, layout kComplexTfp;
// the long row pass), mega_invfold (kInv), and the multi-pass inverse's
// mega_inva (kInvA) and mega_invbfold (kInvB with the shared-memory
// profile, kInvBGlobal without).  The Python wrapper checks them against
// the card's limits before launching.
int megastep_resources(int kind, int which, int R1, int row_len, int M,
                       int npolf, int nplane, int nbin, int tile, int layout) {
  return pass_resources(kind, which, R1, row_len, M, npolf, tile,
                        layout == kComplexTfp, (nplane * nbin + nbin) * 4);
}

// The registers, local (spill) bytes and most threads a block of the
// multi-pass inverse's pass `which` (kInvA: mega_inva for length q;
// kInvB, kInvBGlobal: mega_invbfold for R1 and npolf pols), into out[0..2].
int megastep_attributes(int which, int R1, int q, int npolf, int* out) {
  if (which == kInvA)
    return (int)kernel_attributes(inva_kernel<false>(q), out);
  if (which == kInvB)
    return (int)kernel_attributes(invbfold_kernel<false>(R1, npolf), out);
  if (which == kInvBGlobal)
    return (int)kernel_attributes(invbfold_kernel<true>(R1, npolf), out);
  return (int)cudaErrorInvalidValue;
}

// One fused fold step.  Pointers are device pointers; tw is the wrapper's
// twiddle-table buffer (see Tables in mega_common.cuh); scratch buffers are
// sized by the wrapper: psum float[nchan, npart, 2], cbuf float2[nchan *
// nseq, npart, R1, row_len] (nseq npolf for complex input, else 1), ybuf
// float2[nchan*npolf, npart, R1*R2], pacc float[nchan, nplane, nsub, nbin],
// hacc float[nchan, nbin].  layout is the raw bytes' Layout and code
// their Code (see mega_common.cuh); row_len is R2 for complex input and
// 2*R2 for real input.  window is null or the taper float[R1*row_len]; for
// JA98 codes levels holds the lo, hi and weight tables (npw + 1 floats
// each), and nlow uint16[nchan*npol*ndim, nweights], wblk float[nchan,
// nweights] and wwin float[nchan, npart] are the pre-pass's scratch
// (nweights = samples a block / npw).  wext is null or the caller's window
// weights float[nchan, npart], which multiply the JA98 ones.  ftp is the
// channel-transposed copy of the codes when nchan > 1, else null (see
// launch_forward).  Output samples g of the block fold
// only when lo <= g < hi.  tk == 0 (real input) runs the long row pass in
// place of mega_fwd2; for complex input from R2 = kClusterR2 tk is the
// CTAs of a mega_fwd2cc cluster; ta > 0 runs the
// multi-pass inverse (tiles ta and tb <= q, tw2 the table buffer of (R1, q,
// M), cbuf its zbuf) with the fold in pass B, by global atomics when gfold,
// else the one-CTA mega_invfold.
int megastep_launch(const void* raw, const void* phi0, const void* dphi,
                    const void* gr, const void* gi, const void* tw,
                    const void* tw2, const void* prof_in,
                    const void* hits_in, void* prof_out, void* hits_out,
                    void* psum, void* cbuf, void* ybuf, void* pacc,
                    void* hacc, const void* wext,
                    const void* window, const void* levels, void* nlow,
                    void* wblk, void* wwin, void* ftp, int nchan, int npol,
                    int pol0,
                    int npolf, int npart, int R1, int R2, int nsub, int M,
                    int nfilt_pos, int nkeep, int nbin, int nplane, int det,
                    int fourth, int twos, float scale, float offset,
                    int nsamp_step, int tc, int tk, int ta, int tb,
                    int gfold, int lo, int hi, int layout, int code, int npw,
                    void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  cudaError_t err;
  const int row_len = layout == kComplexTfp ? R2 : 2 * R2;
  const int q = M / R1;
  const Unpack u = make_unpack(
      twos, scale, offset, window, levels, nlow, npw,
      (long long)(npart - 1) * nsamp_step + (long long)R1 * row_len);
  if (ta > 0 && (tb < 1 || tb > q)) return (int)cudaErrorInvalidValue;
  const size_t nprof = (size_t)nchan * nplane * nsub * nbin;
  const size_t nhits = (size_t)nchan * nbin;
  if ((err = cudaMemsetAsync(pacc, 0, nprof * sizeof(float), stream)) != cudaSuccess)
    return (int)err;
  if ((err = cudaMemsetAsync(hacc, 0, nhits * sizeof(float), stream)) != cudaSuccess)
    return (int)err;
  if ((err = launch_forward(raw, gr, gi, tw, psum, cbuf, ybuf, nullptr, ftp,
                            nchan, npol, pol0, npolf, npolf == 2 ? 3 : 1,
                            npart, R1, R2, M, code, u, wblk, wwin,
                            nsamp_step, tc, tk, layout,
                            stream)) != cudaSuccess)
    return (int)err;

  const float* wja = code == kCodeJA98 ? (const float*)wwin : nullptr;
  auto res = [&](int kind, int which, int tile) {
    return megastep_resources(kind, which, R1, row_len, M, npolf, nplane,
                              nbin, tile, layout);
  };
  if (ta > 0) {
    if ((err = launch_inva(ybuf, cbuf, nullptr, tw2, nchan, npolf, 0, npart,
                           R1, R2, M, ta, stream)) != cudaSuccess)
      return (int)err;
    const int which = gfold ? kInvBGlobal : kInvB;
    err = launch(gfold ? invbfold_kernel<true>(R1, npolf)
                       : invbfold_kernel<false>(R1, npolf),
                 dim3(R2 / tb, npart, nchan), res(1, which, tb),
                 res(0, which, tb), stream, (const float2*)cbuf,
                 (const float*)phi0, (const float*)dphi, wja,
                 (const float*)wext, (float*)pacc, (float*)hacc,
                 tables(tw2, R1, q, M), npart, R1, R2, q,
                 nfilt_pos, nkeep, nbin, nplane, det, fourth, lo, hi, tb);
  } else {
    err = launch(invfold_kernel(M, npolf), dim3(nsub, npart, nchan),
                 res(1, kInv, 0), res(0, kInv, 0), stream,
                 (const float2*)ybuf, (const float*)phi0, (const float*)dphi,
                 wja, (const float*)wext, (float*)pacc, (float*)hacc,
                 tables(tw, R1, row_len, M).inv, npart, nsub,
                 M, nfilt_pos, nkeep, nbin, nplane, det, fourth, lo, hi);
  }
  if (err != cudaSuccess) return (int)err;

  const int nmax = (int)(nprof > nhits ? nprof : nhits);
  mega_finish<<<(nmax + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      (const float*)prof_in, (const float*)pacc, (float*)prof_out, (int)nprof,
      (const float*)hits_in, (const float*)hacc, (float*)hits_out,
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
                          nsamp_step, nsamp_fft, nullptr, 0,
                          (cudaStream_t)stream_ptr);
}

}  // extern "C"
