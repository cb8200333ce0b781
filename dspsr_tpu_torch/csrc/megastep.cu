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
// 1.0 ms, of which the two forward passes take 0.7 and mega_invfold 0.21
// (1.5 TB/s for its 315 MB; its inverse alone takes 0.18).  The inverse
// FFT, detection and fold are one kernel, so the 270 MB of subband
// voltages never leave shared memory.
//
// What bounds the fold on this card is its instructions a sample, not its
// atomics or the profile's flush.  Timed in variants of the first form
// (PERF.md, section 6): without the fold the kernel ran 0.18 of its 0.28 ms on
// the flagship, 0.56 of 1.23 on mega_guppi_2bit (a run is about one sample
// there) and 0.56 of 1.02 in pass B at J0613; without the flush it saved
// 2-10%, with plain shared adds for its atomics it lost 2-13%.  So the fold
// is cut to what a sample needs: the plane count is a template parameter (one
// plane sums one float, not fourteen predicated adds), the voltages fold
// unscaled and a run's sums take 1/M^2 and the window weight once, and each
// run goes straight to the block accumulator with a global atomic that
// returns nothing (a reduction done in L2), so no profile is zeroed, held in
// shared memory or flushed.  On mega_guppi_2bit (1.8 turns a window, about
// one sample a bin) that is a reduction a sample, about 60M a block, and the
// kernel still takes 1.02 ms there against 0.56 for its inverse alone.  Not
// kept (slower): lanes on adjacent samples with a warp-segmented scan of the
// runs, a persistent CTA carrying a shared profile over the arc of bins its
// windows touch, and an L2 prefetch of its next item (twice the first form's
// time: the scan's shuffles are a longer chain than the runs they save); the
// runs over an odd count of samples a thread (the padded layout's banks
// collide, +12%); two samples in flight a thread (4-6% slower than one); pass
// B at 8 rows (4% slower at J0613, 10% at J1713 than 4 rows).  Mixed, not
// kept: these runs into a shared profile zeroed and flushed over the arc of
// bins the window touches took mega_guppi_2bit to 0.91 ms but the flagship
// to 0.227 (its runs are a thread's whole count, so the zeroing, barrier
// and colliding shared atomics cost more than the reductions they save).
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
//                inverse FFT of each needed pol, keep nfilt_pos <= t <
//                nfilt_pos + nkeep, detect, fold each thread's runs of one
//                bin into the block accumulator (1/freq_res^2 a run).  The
//                per-chunk ifftshift of the reference is skipped: it is a
//                (-1)^t factor that every detection product cancels (the
//                output is detected, never voltage).  A window whose weight
//                (JA98 times the caller's external weight) is 0, or that
//                keeps no sample inside the bounds, folds nothing and skips
//                its inverse.
//   mega_finish  profiles_out = profiles_in + block sum; hits likewise.
//
// Past one CTA (freq_res above 8192 points: -F 64:D at the flagship band
// from DM ~5, J1713+0747's 15.99 and J0613-0200's 38.78 among them) the
// multi-pass inverse of mega_common.cuh replaces mega_invfold: mega_inva
// (pass A), then mega_invbfold, pass B with the fold (see there).  Real input at R2 =
// 8192 runs the long row pass in place of mega_fwd2.  A J0613-0200 block (8
// windows of 2^24 samples) moves about 10 GB through device memory, and
// each pass reads or writes its 1.07 GB of columns, rows or spectra at
// 1.1-2.9 TB/s; mega_invbfold, in tiles of 4 rows (256 threads, two CTAs
// an SM), reads its 1.07 GB in 0.75 ms (1.4 TB/s; 0.32 at the
// device-memory rate).
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
// consecutive samples that share a bin and adds it to the block accumulator
// with a global atomic.  The order of float additions therefore changes from
// run to run; profiles agree with the float64 reference to 2e-5 relative at
// the test geometry and with the plain PyTorch version to 1e-4 relative at
// the flagship geometry.  A run's hits are its integer count times the
// window weight, added to the block's float accumulator hacc, as the
// reference weights its one-hot: exact wherever the weights are 0 or 1,
// while a bin of a block counts fewer than 2^24 hits, as the float32
// carried hits (the reference's too) need anyway.
//
// The kernels allocate nothing and do not synchronise.  Each C entry point
// returns cudaGetLastError() (or the first error met).

#include "mega_common.cuh"

namespace {

// Each window's weight: the JA98 window weight wja (0 or 1) times the
// caller's external weight wext (any value), each 1 when null.  A window of
// weight 0 is skipped before its inverse, so it adds nothing and counts no
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

// The kept samples of window w that fold: i0 <= i < i1, those whose block
// output index w*nkeep + i lies in [lo, hi).
__device__ __forceinline__ void kept_range(int w, int nkeep, int lo, int hi,
                                           int& i0, int& i1) {
  i0 = max(0, lo - w * nkeep);
  i1 = min(nkeep, hi - w * nkeep);
}

// The fold of one CTA's items 0 .. n - 1 (in time order): thread k sums
// the NPL planes of items k*per .. k*per + per - 1 while their bin stays
// the same and hands each run to flush(bin, sums, count).  item(idx, pl)
// returns item idx's bin (-1: not folded, passed over) and its detected
// planes pl.
template <int NPL, class Item, class Flush>
__device__ __forceinline__ void fold_runs(int n, Item item, Flush flush) {
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int j0 = threadIdx.x * per;
  const int j1 = min(j0 + per, n);
  float acc[NPL];
#pragma unroll
  for (int p = 0; p < NPL; ++p) acc[p] = 0.f;
  unsigned cnt = 0;
  int cur = -1;
  for (int j = j0; j < j1; ++j) {
    float pl[kMaxPlanes];
    const int b = item(j, pl);
    if (b < 0) continue;
    if (b != cur) {
      if (cur >= 0) flush(cur, acc, cnt);
      cur = b;
      cnt = 0;
#pragma unroll
      for (int p = 0; p < NPL; ++p) acc[p] = 0.f;
    }
#pragma unroll
    for (int p = 0; p < NPL; ++p) acc[p] += pl[p];
    ++cnt;
  }
  if (cur >= 0) flush(cur, acc, cnt);
}

// Add a run's sums to the block accumulator: plane p of the subband at pc +
// p*pstride, bin b, times f (see fold_scale); and, unless hc is null
// (subband 0 counts the hits), its count times the window weight wt at hc
// + b.  The atomics return nothing, so they are reductions done in L2 that
// the thread does not wait for.
template <int NPL>
__device__ __forceinline__ void add_run(float* __restrict__ pc,
                                        long long pstride,
                                        float* __restrict__ hc, float f,
                                        float wt, int b,
                                        const float (&acc)[NPL],
                                        unsigned cnt) {
#pragma unroll
  for (int p = 0; p < NPL; ++p) atomicAdd(pc + p * pstride + b, acc[p] * f);
  if (hc) atomicAdd(hc + b, (float)cnt * wt);
}

// The fold's 1/M: up to four planes (quadratic in the voltages) fold the
// unscaled voltages and scale each run's sums by wt/M^2 (the voltage scale
// vs is 1); with the fourth moments, whose products of M^4 could overflow,
// each voltage is scaled by 1/M (vs) and a run's sums by wt.
template <int NPL>
__device__ __forceinline__ void fold_scale(int M, float wt, float& vs,
                                           float& f) {
  const float inv_m = 1.0f / (float)M;
  vs = NPL < kMaxPlanes ? 1.f : inv_m;
  f = NPL < kMaxPlanes ? inv_m * inv_m * wt : wt;
}

// The one-CTA inverse with the fold, per (subband s, window w, input
// channel c), for NPL detected planes: a window of weight 0 or with no
// kept sample in [lo, hi) returns at once; else the inverse FFT of each
// needed pol (inverse_subband), then the fold (fold_runs) of kept samples
// i0 .. i1 - 1: sample t = nfilt_pos + i, detect, bin; each run of one bin
// goes straight to the block accumulator (add_run).
template <int P, int NS, int NPL>
__global__ void __launch_bounds__(kMaxThreads)
mega_invfold(const float2* __restrict__ ybuf, const float* __restrict__ phi0,
             const float* __restrict__ dphi, const float* __restrict__ wja,
             const float* __restrict__ wext, float* __restrict__ pacc,
             float* __restrict__ hacc, const float2* __restrict__ tw,
             int npart, int nsub, int M, int nfilt_pos, int nkeep, int nbin,
             int det, int fourth, int lo, int hi) {
  extern __shared__ float2 sm[];
  const int ld = seq_ld(M);
  const int s = blockIdx.x;
  const int w = blockIdx.y;
  const int c = blockIdx.z;
  const float wt = window_weight(wja, wext, (long long)c * npart + w);
  int i0, i1;
  kept_range(w, nkeep, lo, hi, i0, i1);
  if (wt == 0.f || i0 >= i1) return;  // the whole CTA, before any barrier
  inverse_subband<P, NS>(ybuf, sm, tw, npart, nsub, M, s, w, c);

  float vs, f;
  fold_scale<NPL>(M, wt, vs, f);
  const float p0 = phi0[w], dp = dphi[w], fnbin = (float)nbin;
  float* pc = pacc + ((long long)c * NPL * nsub + s) * nbin;
  float* hc = s == 0 ? hacc + (long long)c * nbin : nullptr;
  fold_runs<NPL>(
      i1 - i0,
      [&](int j, float(&pl)[kMaxPlanes]) {
        const int i = i0 + j;
        const int t = nfilt_pos + i;
        const float2 va = sm[sidx(t)];
        const float2 vb = NS > 1 ? sm[ld + sidx(t)] : make_float2(0.f, 0.f);
        detect(make_float2(va.x * vs, va.y * vs),
               make_float2(vb.x * vs, vb.y * vs), det, fourth, pl);
        return fold_bin(p0, dp, i, fnbin, nbin);
      },
      [&](int b, const float(&acc)[NPL], unsigned cnt) {
        add_run<NPL>(pc, (long long)nsub * nbin, hc, f, wt, b, acc, cnt);
      });
}

// Pass B of the multi-pass inverse with the fold (pass A is mega_inva of
// mega_common.cuh): per (tile of S <= q consecutive rows a .. a + S - 1 of
// subband s = a / q, window, input channel), the length-R1 inverse of every
// transformed pol's rows (inverse_rows), then the fold (fold_runs) of the
// tile's samples in time order idx = n1*S + r, sample t = n2 + q*n1 (n2 =
// a mod q + r), as mega_invfold folds it: the same phase, bin, bounds,
// weights, 1/M and runs straight to the block accumulator.  Tiles of
// subband 0 count the hits.
template <int P, int NS, int NPL>
__global__ void __launch_bounds__(kMaxThreads)
mega_invbfold(const float2* __restrict__ zbuf, const float* __restrict__ phi0,
              const float* __restrict__ dphi, const float* __restrict__ wja,
              const float* __restrict__ wext, float* __restrict__ pacc,
              float* __restrict__ hacc, Tables tb, int npart, int R1,
              int R2, int q, int nfilt_pos, int nkeep, int nbin, int det,
              int fourth, int lo, int hi, int S) {
  extern __shared__ float2 sm[];
  const int ld = seq_ld(R1);
  const int a = blockIdx.x * S;  // the tile's first row
  const int w = blockIdx.y;
  const int c = blockIdx.z;
  const int nsub = R2 / q;
  const int s = a / q;
  const int n2a = a & (q - 1);
  const float wt = window_weight(wja, wext, (long long)c * npart + w);
  int i0, i1;
  kept_range(w, nkeep, lo, hi, i0, i1);
  if (wt == 0.f || i0 >= i1) return;  // the whole CTA, before any barrier
  inverse_rows<P, NS>(zbuf, sm, tb.r1, npart, R1, (long long)R1 * R2, a, w,
                      c, S);

  float vs, f;
  fold_scale<NPL>(R1 * q, wt, vs, f);
  const float p0 = phi0[w], dp = dphi[w], fnbin = (float)nbin;
  float* pc = pacc + ((long long)c * NPL * nsub + s) * nbin;
  float* hc = s == 0 ? hacc + (long long)c * nbin : nullptr;
  const int lg = __ffs(S) - 1;
  fold_runs<NPL>(
      S * R1,
      [&](int idx, float(&pl)[kMaxPlanes]) {
        const int n1 = idx >> lg;
        const int r = idx & (S - 1);
        const int i = n2a + r + q * n1 - nfilt_pos;
        if (i < i0 || i >= i1) return -1;
        const float2 va = sm[r * ld + sidx(n1)];
        const float2 vb =
            NS > 1 ? sm[(S + r) * ld + sidx(n1)] : make_float2(0.f, 0.f);
        detect(make_float2(va.x * vs, va.y * vs),
               make_float2(vb.x * vs, vb.y * vs), det, fourth, pl);
        return fold_bin(p0, dp, i, fnbin, nbin);
      },
      [&](int b, const float(&acc)[NPL], unsigned cnt) {
        add_run<NPL>(pc, (long long)nsub * nbin, hc, f, wt, b, acc, cnt);
      });
}

// The instance of fold kernel K (mega_invfold or mega_invbfold) for P
// points a thread, npolf pols and nplane detected planes (one pol folds
// one plane).
#define FOLD_INSTANCE(K, P, npolf, nplane)                        \
  ((npolf) == 1       ? &K<P, 1, 1>                               \
   : (nplane) == 2    ? &K<P, 2, 2>                               \
   : (nplane) == 4    ? &K<P, 2, 4>                               \
   : (nplane) == kMaxPlanes ? &K<P, 2, kMaxPlanes>                \
                      : &K<P, 2, 1>)

// The inverse-and-fold kernel for freq_res M, npolf pols, nplane planes.
decltype(&mega_invfold<16, 2, 1>) invfold_kernel(int M, int npolf,
                                                 int nplane) {
  return M >= 16 ? FOLD_INSTANCE(mega_invfold, 16, npolf, nplane)
                 : FOLD_INSTANCE(mega_invfold, 8, npolf, nplane);
}

// Pass B with the fold for R1, npolf pols and nplane planes.
decltype(&mega_invbfold<16, 2, 1>) invbfold_kernel(int R1, int npolf,
                                                   int nplane) {
  return R1 >= 16 ? FOLD_INSTANCE(mega_invbfold, 16, npolf, nplane)
                  : FOLD_INSTANCE(mega_invbfold, 8, npolf, nplane);
}

#undef FOLD_INSTANCE

__global__ void __launch_bounds__(kThreads)
mega_finish(const float* __restrict__ pin, const float* __restrict__ pacc,
            float* __restrict__ pout, int nprof,
            const float* __restrict__ hin, const float* __restrict__ hacc,
            float* __restrict__ hout, int nhits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < nprof) pout[i] = pin[i] + pacc[i];
  if (i < nhits) hout[i] = hin[i] + hacc[i];
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
// mega_inva (kInvA) and mega_invbfold (kInvB).  The fold holds no profile
// in shared memory.  The Python wrapper checks them against the card's
// limits before launching.
int megastep_resources(int kind, int which, int R1, int row_len, int M,
                       int npolf, int tile, int layout) {
  return pass_resources(kind, which, R1, row_len, M, npolf, tile,
                        layout == kComplexTfp);
}

// mega_rowfft's registers, local bytes, most threads a block, cluster
// CTAs and clusters the card holds at once (row_attributes), into
// out[0..4].
int megastep_row_attributes(int R1, int row_len, int* out) {
  return (int)row_attributes(R1, row_len, out);
}

// The registers, local (spill) bytes and most threads a block of the
// fold's inverse kernel `which` (kInv: mega_invfold for freq_res M; kInvA:
// mega_inva for length q; kInvB: mega_invbfold for R1) with npolf pols and
// nplane planes, into out[0..2].
int megastep_attributes(int which, int R1, int q, int M, int npolf,
                        int nplane, int* out) {
  if (which == kInv)
    return (int)kernel_attributes(invfold_kernel(M, npolf, nplane), out);
  if (which == kInvA)
    return (int)kernel_attributes(inva_kernel<false>(q), out);
  if (which == kInvB)
    return (int)kernel_attributes(invbfold_kernel(R1, npolf, nplane), out);
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
// M), cbuf its zbuf) with the fold in pass B, else the one-CTA
// mega_invfold.
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
                    int lo, int hi, int layout, int code, int npw,
                    void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  cudaError_t err;
  const int row_len = layout == kComplexTfp ? R2 : 2 * R2;
  const int q = M / R1;
  const Unpack u = make_unpack(
      twos, scale, offset, window, levels, nlow, npw,
      (long long)(npart - 1) * nsamp_step + (long long)R1 * row_len);
  if (ta > 0 && (tb < 1 || tb > q || q % tb)) return (int)cudaErrorInvalidValue;
  if (nplane != 1 && nplane != 2 && nplane != 4 && nplane != kMaxPlanes)
    return (int)cudaErrorInvalidValue;
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
    return megastep_resources(kind, which, R1, row_len, M, npolf, tile,
                              layout);
  };
  if (ta > 0) {
    if ((err = launch_inva(ybuf, cbuf, nullptr, tw2, nchan, npolf, 0, npart,
                           R1, R2, M, ta, stream)) != cudaSuccess)
      return (int)err;
    err = launch(invbfold_kernel(R1, npolf, nplane),
                 dim3(R2 / tb, npart, nchan), res(1, kInvB, tb),
                 res(0, kInvB, tb), stream,
                 (const float2*)cbuf, (const float*)phi0, (const float*)dphi,
                 wja, (const float*)wext, (float*)pacc, (float*)hacc,
                 tables(tw2, R1, q, M), npart, R1, R2, q, nfilt_pos, nkeep,
                 nbin, det, fourth, lo, hi, tb);
  } else {
    err = launch(invfold_kernel(M, npolf, nplane),
                 dim3(nsub, npart, nchan),
                 res(1, kInv, 0), res(0, kInv, 0), stream,
                 (const float2*)ybuf, (const float*)phi0, (const float*)dphi,
                 wja, (const float*)wext, (float*)pacc, (float*)hacc,
                 tables(tw, R1, row_len, M).inv, npart, nsub, M, nfilt_pos,
                 nkeep, nbin, det, fourth, lo, hi);
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
// -> nlow, wblk and wwin as in megastep_launch, and the channel-transposed
// copy ftp as launch_forward makes it (exactly when nchan > 1).
int megastep_ja98(const void* raw, const void* levels, void* nlow, void* wblk,
                  void* wwin, void* ftp, int nchan, int npol, int ndim,
                  int npart, int nsamp_step, int nsamp_fft, int npw,
                  void* stream_ptr) {
  const long long T = (long long)(npart - 1) * nsamp_step + nsamp_fft;
  const Unpack u = make_unpack(0, 1.f, 0.f, nullptr, levels, nlow, npw, T);
  return (int)launch_ja98(raw, u, wblk, wwin, nchan, npol, ndim, npart,
                          nsamp_step, nsamp_fft, ftp, ftp_stride(T),
                          (cudaStream_t)stream_ptr);
}

}  // extern "C"
