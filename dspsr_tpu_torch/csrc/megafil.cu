// Fused search front end for Hopper (sm_90a): unpack -> forward FFT ->
// chirp -> per-subband inverse FFT -> detect, stored in time order, for
// 1/2/4/8-bit codes or float32 samples, optionally apodized: real-sampled
// (TFP, or CASPSR 8-bit bytes) or complex (analytic, TFP; the forward
// passes of mega_common.cuh per pol, see there); or, in place of the
// detection, the undetected voltage of every input pol.  For JA98 2-bit
// input the pre-pass of mega_common.cuh runs first and its window weights
// are the step's weights output (the data are not weighted).
//
// Replaces the Pallas kernel dspsr_tpu/ops/megakernel.py::build_megafil in
// its scalar-chirp and Jones forms, detected or voltage output, with the XLA
// de-permute that followed it: the digifil path, and the hybrid fold
// engine's front end, which adds the pre-response passband tap (see item 5
// of mega_common.cuh), hands in the chirp (times an RFI mask) on every
// call, and takes the voltage for cyclic folding.  The tap adds
// 2 atomicAdds a bin a window to mega_fwd2 and, with PP or QQ detection,
// the second pol's separation.  The TPU kernel ran every transform as dense
// DFT matmuls and wrote [R2, R1] time planes that a second XLA pass put back
// in time order; here the transforms are register-resident FFTs (see
// mega_common.cuh) and the inverse pass stores each detected sample
// straight to its place in time order.  A flagship search block (R1 = R2 =
// 512, 75 windows, 2 pols packed as one complex sequence) reads 79 MB of
// codes twice, writes and reads 315 MB of stage-1 columns and 315 MB of
// spectra, and writes 68 MB of detected output: about 1.4 GB, 0.42 ms at
// the device-memory rate.  Measured on an H100 (700 W) it takes about
// 1.2 ms, of which the two forward passes take 0.9; megafil_invdet reads
// its 315 MB and writes its 68 MB in 0.20 ms (1.9 TB/s), in CTAs of 256
// threads and 70 KB of shared memory at freq_res 4096.  The
// inverse, detection and the time-order store are one kernel, so the
// subband voltages never reach device memory and no de-permute pass
// exists.
//
// Four kernels (five with the multi-pass inverse, below) run in order on
// the caller's stream:
//   mega_polpow,   the forward half shared with megastep.cu (see
//   mega_fwd1,     mega_common.cuh): pol energies; unpack, columns,
//   mega_fwd2      twiddle; rows, pol separation, passband, chirp.
//   megafil_invdet per (subband s, window w, input channel c):
//                  length-freq_res inverse FFT of each transformed pol,
//                  scaled by 1/freq_res; for nfilt_pos <= t < nfilt_pos +
//                  nkeep, detect and store
//                  out[c*nsub + s, plane, w*nkeep + t - nfilt_pos].
//                  Consecutive threads store consecutive samples.  The
//                  per-chunk ifftshift of the reference is skipped: it is a
//                  (-1)^t factor that every detection product cancels.
//   megafil_invvolt in place of megafil_invdet for the voltage output: the
//                  same inverse; each kept sample of each pol is stored as
//                  one float2, x * (+-1/freq_res), to
//                  out[c*nsub + s, pol, w*nkeep + t - nfilt_pos] (complex64,
//                  consecutive threads on consecutive samples).  The sign
//                  restores the skipped ifftshift, (-1)^t with t the index
//                  in the freq_res chunk, where the reference restores it
//                  (flip: nsub > 1 or complex input); odd-lag cyclic
//                  products do not cancel it.  A cyclic block at the
//                  hybrid_cyclic width (R1 = R2 = 512, 38 windows, two
//                  pols) reads 160 MB of spectra and writes 137 MB of
//                  voltage: 0.09 ms at the device-memory rate.
//
// The nsub == 1 convolution (hybrid_conv32: 32 complex channels, freq_res
// = N = 2^19, R1 1024, R2 512) keeps a length-N inverse, 4 MB a pol, that
// no CTA's shared memory holds.  Past one CTA the wrapper runs the
// multi-pass inverse instead of megafil_invdet/megafil_invvolt: megafil_inva
// and megafil_invb (see there), two passes through device memory like the
// forward's, over the scratch the forward's cbuf leaves free.  The TPU
// kernel ran the same two-stage split as dense DFT matmuls in VMEM
// (megakernel.py:1302-1310); here each stage is the register-resident FFT.
// A hybrid_conv32 block (4 windows) moves about 6.9 GB: 245 MB of codes,
// 2 x 1.07 GB of stage-1 columns, spectra and inverse scratch each, 237 MB
// of Intensity out: 2.1 ms at the device-memory rate.
//
// The Jones 2x2 mix (matrix convolution, polarization calibration; see
// jones_mix in mega_common.cuh) goes where both pols' spectra of a bin first
// meet: the load of megafil_inva, or of the one-CTA inverse.  The forward
// row passes then store both pols with the scalar slot (ones, or the RFI
// mask) applied, which commutes with the mix.
//
// Every output sample is written exactly once and nothing is summed across
// blocks, so the detected output does not depend on scheduling order (the
// passband does, in its last bits).  The kernels
// allocate nothing and do not synchronise.  Each C entry point returns
// cudaGetLastError() (or the first error met).

#include "mega_common.cuh"

namespace {

template <int P, int NS, bool JONES>
__global__ void __launch_bounds__(kMaxThreads)
megafil_invdet(const float2* __restrict__ ybuf, float* __restrict__ out,
               const float2* __restrict__ tw, const float2* __restrict__ jones,
               int jpol0, int npart, int nsub, int M, int nfilt_pos,
               int nkeep, int nplane, int det) {
  extern __shared__ float2 sm[];
  const int ld = seq_ld(M);
  const int s = blockIdx.x;
  const int w = blockIdx.y;
  const int c = blockIdx.z;
  inverse_subband<P, NS, JONES>(ybuf, sm, tw, npart, nsub, M, s, w, c, jones,
                                jpol0);

  const float inv_m = 1.0f / (float)M;
  const long long ntime = (long long)npart * nkeep;
  float* dst = out + (long long)(c * nsub + s) * nplane * ntime +
               (long long)w * nkeep;
  for (int i = threadIdx.x; i < nkeep; i += blockDim.x) {
    const int t = nfilt_pos + i;
    const float2 va = sm[sidx(t)];
    const float2 xa = make_float2(va.x * inv_m, va.y * inv_m);
    float2 xb = make_float2(0.f, 0.f);
    if (NS > 1) {
      const float2 vb = sm[ld + sidx(t)];
      xb = make_float2(vb.x * inv_m, vb.y * inv_m);
    }
    float pl[kMaxPlanes];
    detect(xa, xb, det, 0, pl);
#pragma unroll
    for (int p = 0; p < 4; ++p)
      if (p < nplane) dst[p * ntime + i] = pl[p];
  }
}

template <int P, int NS, bool JONES>
__global__ void __launch_bounds__(kMaxThreads)
megafil_invvolt(const float2* __restrict__ ybuf, float2* __restrict__ out,
                const float2* __restrict__ tw, const float2* __restrict__ jones,
                int jpol0, int npart, int nsub, int M, int nfilt_pos,
                int nkeep, int flip) {
  extern __shared__ float2 sm[];
  const int ld = seq_ld(M);
  const int s = blockIdx.x;
  const int w = blockIdx.y;
  const int c = blockIdx.z;
  inverse_subband<P, NS, JONES>(ybuf, sm, tw, npart, nsub, M, s, w, c, jones,
                                jpol0);

  const float inv_m = 1.0f / (float)M;
  const long long ntime = (long long)npart * nkeep;
  float2* dst = out + (long long)(c * nsub + s) * NS * ntime +
                (long long)w * nkeep;
  for (int i = threadIdx.x; i < nkeep; i += blockDim.x) {
    const int t = nfilt_pos + i;
    const float g = (flip & t & 1) ? -inv_m : inv_m;
#pragma unroll
    for (int q = 0; q < NS; ++q) {
      const float2 v = sm[q * ld + sidx(t)];
      dst[q * ntime + i] = make_float2(v.x * g, v.y * g);
    }
  }
}

// The multi-pass inverse (nsub == 1, freq_res M = N = R1*R2 past one CTA).
// With the spectrum in natural order k = k2*R1 + k1 (centred for complex
// input) and the sample n = n2 + R2*n1,
//   exp(2 pi i k n / N) = exp(2 pi i k2 n2 / R2) exp(2 pi i k1 n2 / N)
//                         exp(2 pi i k1 n1 / R1),
// so the inverse runs as two passes through device memory, as the forward
// does, with zbuf (the forward's cbuf, free by then and as large) between:
//   megafil_inva  per (input channel, window, tile of S consecutive k1):
//                 the length-R2 inverse over k2 of each output pol's
//                 spectrum (the Jones mix in its load), times
//                 exp(+2 pi i k1 n2 / N), stored Z[q][n2*R1 + k1] (runs of S
//                 consecutive k1, as mega_fwd1's columns).
//   megafil_invb  per (input channel, window, tile of S consecutive n2): the
//                 length-R1 inverse over k1 of every output pol's rows, 1/N;
//                 sample t = n2 + R2*n1 is kept for nfilt_pos <= t <
//                 nfilt_pos + nkeep and detected, or stored as voltage with
//                 the (-1)^t sign of megafil_invvolt, straight to time order
//                 (runs of S consecutive samples).
// tb is the table buffer of the geometry (R1, R2, M): tb.row is the
// length-R2 FFT table (for real input the forward's row table is 2*R2 long)
// and the inter-stage factors lo/hi are over N.  nout output pols; zbuf is
// float2[nchan*nout, npart, N].
template <int P, bool JONES>
__global__ void __launch_bounds__(kMaxThreads)
megafil_inva(const float2* __restrict__ ybuf, float2* __restrict__ zbuf,
             const float2* __restrict__ jones, Tables tb, int nout, int jpol0,
             int npart, int R1, int R2, int S) {
  extern __shared__ float2 sm[];
  const int T = R2 / P;
  const int col = threadIdx.x & (S - 1);
  const int j = threadIdx.x / S;
  const int k1 = blockIdx.x * S + col;
  const int w = blockIdx.y;
  const int c = blockIdx.z;
  const long long n = (long long)R1 * R2;
  const int mask = (1 << tb.log2n) - 1;
  const int lo_mask = (1 << tb.lo_bits) - 1;
  float2 v[P];
  for (int q = 0; q < nout; ++q) {
    const float2* y = ybuf + ((long long)(c * (JONES ? 2 : nout) +
                                          (JONES ? 0 : q)) * npart + w) * n +
                      k1;
    const float2* jp = JONES ? jones + ((long long)c * 4 + 2 * (jpol0 + q)) *
                                           n + k1
                             : nullptr;
    auto load = [&](int, float2(&x)[P]) {
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const long long k = (long long)(j + T * i) * R1;
        if constexpr (JONES)
          x[i] = jones_mix(y, jp, (long long)npart * n, n, k);
        else
          x[i] = y[k];
      }
    };
    // one sequence a column; the last pass's reads end at a barrier, so
    // the next pol's first pass may write the same shared memory
    fft_seqs<P, 1, +1, true>(v, load, sm + col * seq_ld(R2), 0, j, R2,
                             __ffs(R2) - 1, tb.row);
    float2* dst = zbuf + ((long long)(c * nout + q) * npart + w) * n + k1;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int n2 = j + T * i;
      const int e = (k1 * n2) & mask;
      const float2 t = cmul(__ldg(tb.hi + (e >> tb.lo_bits)),
                            __ldg(tb.lo + (e & lo_mask)));
      dst[(long long)n2 * R1] = cmul(v[i], make_float2(t.x, -t.y));
    }
  }
}

template <int P, int NS>
__global__ void __launch_bounds__(kMaxThreads)
megafil_invb(const float2* __restrict__ zbuf, void* __restrict__ out,
             Tables tb, int npart, int R1, int R2, int nfilt_pos, int nkeep,
             int nplane, int det, int voltage, int flip, int S) {
  extern __shared__ float2 sm[];
  const int T = R1 / P;
  const int ld = seq_ld(R1);
  const int i = threadIdx.x / T;  // row of the tile
  const int j = threadIdx.x - i * T;
  const int a = blockIdx.x * S;   // the tile's first n2
  const int w = blockIdx.y;
  const int c = blockIdx.z;
  const long long n = (long long)R1 * R2;
  const float2* src =
      zbuf + ((long long)(c * NS) * npart + w) * n + (long long)(a + i) * R1;
  float2 v[P];
  auto load = [&](int q, float2(&x)[P]) {
    const float2* z = src + (long long)q * npart * n;
#pragma unroll
    for (int ii = 0; ii < P; ++ii) x[ii] = z[j + T * ii];
  };
  // pol q of row i at slot q*S + i, in natural order after
  fft_seqs<P, NS, +1, false>(v, load, sm + i * ld, S * ld, j, R1,
                             __ffs(R1) - 1, tb.r1);

  const float inv_n = 1.0f / (float)n;
  const long long ntime = (long long)npart * nkeep;
  const int lg = __ffs(S) - 1;
  // consecutive threads on consecutive n2: runs of S consecutive samples
  for (int idx = threadIdx.x; idx < S * R1; idx += blockDim.x) {
    const int n1 = idx >> lg;
    const int r = idx & (S - 1);
    const int t = a + r + R2 * n1;
    const int o = t - nfilt_pos;
    if (o < 0 || o >= nkeep) continue;
    const long long dst = (long long)w * nkeep + o;
    const float2 va = sm[r * ld + sidx(n1)];
    const float2 vb =
        NS > 1 ? sm[(S + r) * ld + sidx(n1)] : make_float2(0.f, 0.f);
    if (voltage) {
      const float g = (flip & t & 1) ? -inv_n : inv_n;
      float2* vo = (float2*)out + (long long)c * NS * ntime + dst;
      vo[0] = make_float2(va.x * g, va.y * g);
      if (NS > 1) vo[ntime] = make_float2(vb.x * g, vb.y * g);
    } else {
      float pl[kMaxPlanes];
      detect(make_float2(va.x * inv_n, va.y * inv_n),
             make_float2(vb.x * inv_n, vb.y * inv_n), det, 0, pl);
      float* po = (float*)out + (long long)c * nplane * ntime + dst;
#pragma unroll
      for (int p = 0; p < 4; ++p)
        if (p < nplane) po[p * ntime] = pl[p];
    }
  }
}

// Shared-memory bytes (kind 0) or threads (kind 1) of the multi-pass
// inverse's passes: which 3 megafil_inva (tile of `tile` columns k1, one
// sequence of R2 a column at a time), 4 megafil_invb (tile of `tile` rows
// n2, nout sequences of R1 a row).
int multipass_resources(int kind, int which, int R1, int R2, int nout,
                        int tile) {
  const int L = which == 3 ? R2 : R1;
  if (kind == 1) return tile * (L / fft_points(L));
  return (which == 3 ? 1 : nout) * tile * seq_ld(L) * (int)sizeof(float2);
}

// The one-CTA inverse-and-detect kernel for freq_res M, nout pols and the
// Jones mix (J) or not.
template <bool J>
decltype(&megafil_invdet<16, 2, J>) invdet_kernel(int M, int nout) {
  if (M >= 16)
    return nout == 2 ? &megafil_invdet<16, 2, J> : &megafil_invdet<16, 1, J>;
  return nout == 2 ? &megafil_invdet<8, 2, J> : &megafil_invdet<8, 1, J>;
}

// The one-CTA voltage inverse, likewise.
template <bool J>
decltype(&megafil_invvolt<16, 2, J>) invvolt_kernel(int M, int nout) {
  if (M >= 16)
    return nout == 2 ? &megafil_invvolt<16, 2, J> : &megafil_invvolt<16, 1, J>;
  return nout == 2 ? &megafil_invvolt<8, 2, J> : &megafil_invvolt<8, 1, J>;
}

}  // namespace

extern "C" {

const char* megafil_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Shared-memory bytes (kind 0) or threads (kind 1) of the transform
// kernels: which 0 and 1 are the forward passes (tile of `tile` columns, or
// of row pairs for real input and rows for complex input, layout
// kComplexTfp), 2 the one-CTA inverse, 3 and 4 the multi-pass inverse's
// passes (multipass_resources).  npolf is the pols the inverse transforms.
// The Python wrapper checks them against the card's limits before
// launching.
int megafil_resources(int kind, int which, int R1, int row_len, int M,
                      int npolf, int tile, int layout) {
  if (which >= 3)
    return multipass_resources(
        kind, which, R1, layout == kComplexTfp ? row_len : row_len / 2,
        npolf, tile);
  if (kind == 1) return transform_threads(which, R1, row_len, M, tile);
  if (which < 2)
    return fwd_smem_bytes(which, R1, row_len, tile, layout == kComplexTfp);
  return inv_smem_bytes(M, npolf);
}

// The multi-pass inverse on the caller's stream (see megafil_inva): ybuf ->
// zbuf -> out.  tw2 is the table buffer of (R1, R2, M); ta and tb are the
// passes' tiles.
static cudaError_t launch_multipass(
    const void* ybuf, void* zbuf, void* out, const void* jones,
    const void* tw2, int nchan, int nout, int jpol0, int npart, int R1,
    int R2, int nfilt_pos, int nkeep, int nplane, int det, int voltage,
    int flip, int ta, int tb, cudaStream_t stream) {
  cudaError_t err;
  const Tables t2 = tables(tw2, R1, R2, R1 * R2);
  auto inva = R2 >= 16 ? (jones ? &megafil_inva<16, true>
                                 : &megafil_inva<16, false>)
                      : (jones ? &megafil_inva<8, true>
                               : &megafil_inva<8, false>);
  const int smem_a = multipass_resources(0, 3, R1, R2, nout, ta);
  if ((err = cudaFuncSetAttribute(inva,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem_a)) != cudaSuccess)
    return err;
  inva<<<dim3(R1 / ta, npart, nchan), multipass_resources(1, 3, R1, R2, nout, ta),
         smem_a, stream>>>((const float2*)ybuf, (float2*)zbuf,
                           (const float2*)jones, t2, nout, jpol0, npart, R1,
                           R2, ta);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  auto invb = R1 >= 16 ? (nout == 2 ? &megafil_invb<16, 2> : &megafil_invb<16, 1>)
                       : (nout == 2 ? &megafil_invb<8, 2> : &megafil_invb<8, 1>);
  const int smem_b = multipass_resources(0, 4, R1, R2, nout, tb);
  if ((err = cudaFuncSetAttribute(invb,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem_b)) != cudaSuccess)
    return err;
  invb<<<dim3(R2 / tb, npart, nchan), multipass_resources(1, 4, R1, R2, nout, tb),
         smem_b, stream>>>((const float2*)zbuf, out, t2, npart, R1, R2,
                           nfilt_pos, nkeep, nplane, det, voltage, flip, tb);
  return cudaGetLastError();
}

// One fused search front-end step.  Pointers are device pointers; tw is the
// wrapper's twiddle-table buffer (see Tables in mega_common.cuh); the
// forward transforms npolf pols from pol0 and keeps those in `store` (bit 0
// the first, bit 1 the second) for the inverse; gr/gi are float[nchan,
// R1*R2] in natural bin order (centred for complex input).  The inverse
// transforms nout pols: the stored ones, or with a Jones response (jones
// float2[nchan, 4, R1*R2], store 3) the mixes of output pols jpol0 ..
// jpol0 + nout - 1.  layout is the raw bytes' Layout (see
// mega_common.cuh).  Scratch buffers are sized by the wrapper: psum
// float[nchan, npart, 2], cbuf float2[nchan * nseq, npart, R1, row_len]
// (complex input: nseq npolf, row_len R2; real: 1 and 2*R2), ybuf
// float2[nchan*nstore, npart, R1*R2]; out float[nchan*nsub, nplane,
// npart*nkeep], or with voltage float2[nchan*nsub, nout, npart*nkeep]
// (flip: the sign rule of megafil_invvolt; nplane and det are not read); pb
// null or float[nchan, npolf, R1*R2].  ta > 0 runs the multi-pass inverse
// (nsub 1; tiles ta, tb; tw2 the table buffer of (R1, R2, M); cbuf is its
// zbuf), else the one-CTA inverse.  code, window, levels, nlow, wblk and
// wwin are megastep_launch's; wwin gets the JA98 window weights.
int megafil_launch(const void* raw, const void* gr, const void* gi,
                   const void* tw, const void* tw2, const void* jones,
                   void* out, void* psum, void* cbuf, void* ybuf, void* pb,
                   const void* window, const void* levels, void* nlow,
                   void* wblk, void* wwin,
                   int nchan, int npol, int pol0, int npolf, int store,
                   int nout, int jpol0, int npart, int R1, int R2, int nsub,
                   int M, int nfilt_pos, int nkeep, int nplane, int det,
                   int voltage, int flip, int twos, float scale,
                   float offset, int nsamp_step, int tc, int tk, int ta,
                   int tb, int layout, int code, int npw, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  cudaError_t err;
  const int row_len = layout == kComplexTfp ? R2 : 2 * R2;
  const Unpack u = make_unpack(
      twos, scale, offset, window, levels, nlow, npw,
      (long long)(npart - 1) * nsamp_step + (long long)R1 * row_len);
  const int nstore = (store & 1) + (store >> 1);
  if (nout < 1 || nout > 2 || (jones ? store != 3 : nout != nstore) ||
      (ta > 0 && (nsub != 1 || tb < 1)))
    return (int)cudaErrorInvalidValue;
  // the function types do not depend on the Jones flag
  const auto det_k = jones ? invdet_kernel<true>(M, nout)
                           : invdet_kernel<false>(M, nout);
  const auto volt_k = jones ? invvolt_kernel<true>(M, nout)
                            : invvolt_kernel<false>(M, nout);
  const void* inv = voltage ? (const void*)volt_k : (const void*)det_k;
  const int smem3 = megafil_resources(0, 2, R1, row_len, M, nout, 0, layout);
  if (ta == 0 && (err = cudaFuncSetAttribute(inv,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem3)) != cudaSuccess)
    return (int)err;
  if ((err = launch_forward(raw, gr, gi, tw, psum, cbuf, ybuf, pb, nchan,
                            npol, pol0, npolf, store, npart, R1, R2, M, code,
                            u, wblk, wwin, nsamp_step, tc, tk, layout,
                            stream)) != cudaSuccess)
    return (int)err;
  if (ta > 0)
    return (int)launch_multipass(ybuf, cbuf, out, jones, tw2, nchan, nout,
                                 jpol0, npart, R1, R2, nfilt_pos, nkeep,
                                 nplane, det, voltage, flip, ta, tb, stream);
  const dim3 grid(nsub, npart, nchan);
  const int threads = transform_threads(2, R1, row_len, M, 0);
  const float2* itw = tables(tw, R1, row_len, M).inv;
  const float2* jn = (const float2*)jones;
  if (voltage)
    volt_k<<<grid, threads, smem3, stream>>>(
        (const float2*)ybuf, (float2*)out, itw, jn, jpol0, npart, nsub, M,
        nfilt_pos, nkeep, flip);
  else
    det_k<<<grid, threads, smem3, stream>>>(
        (const float2*)ybuf, (float*)out, itw, jn, jpol0, npart, nsub, M,
        nfilt_pos, nkeep, nplane, det);
  return (int)cudaGetLastError();
}

}  // extern "C"
