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
// Four kernels (five with the multi-pass inverse, six with the long row
// pass, below) run in order on the caller's stream:
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
// Past one CTA (freq_res M above 8192 points, or its shared memory over
// the card's: the nsub == 1 convolution of hybrid_conv32, 2^19 points, and
// -F nsub:D at a DM above about 5 at the flagship band, 16384-131072
// points) the wrapper runs the multi-pass inverse instead of
// megafil_invdet/megafil_invvolt: mega_inva (mega_common.cuh) and
// megafil_invb, two passes through device memory like the forward's, over
// the scratch the forward's cbuf leaves free.  The TPU kernel ran the same
// two-stage split as dense DFT matmuls in VMEM (megakernel.py:1302-1310);
// here each stage is the register-resident FFT.  A hybrid_conv32 block (4
// windows) moves about 6.9 GB: 245 MB of codes, 2 x 1.07 GB of stage-1
// columns, spectra and inverse scratch each, 237 MB of Intensity out:
// 2.1 ms at the device-memory rate.  Real input at R2 = 8192 (freq_res
// 131072 at nsub 64) runs the long row pass of mega_common.cuh in place of
// mega_fwd2.
//
// The Jones 2x2 mix (matrix convolution, polarization calibration; see
// jones_mix in mega_common.cuh) goes where both pols' spectra of a bin first
// meet: the load of mega_inva, or of the one-CTA inverse.  The forward
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

// Pass B of the multi-pass inverse (see mega_inva in mega_common.cuh), for
// build_megafil's multi-pass inverse: per (tile of S consecutive rows r =
// s*q + n2, window, input channel), the length-R1 inverse over k1 of every
// output pol's rows, 1/M; sample t = n2 + q*n1 of output channel c*nsub +
// s is kept for nfilt_pos <= t < nfilt_pos + nkeep and detected, or stored
// as voltage with the (-1)^t sign of megafil_invvolt, straight to time
// order (runs of S consecutive samples while S <= q).
//
// It reads zbuf once and writes the output once, 5 R1 log2 R1 operations a
// point: bound by bytes (hybrid_conv32: 1.31 GB, 0.39 ms at 3.35 TB/s).
// Its rows are contiguous (8 KB at R1 = 1024), loaded coalesced as the
// transform's first pass.  With 4 rows (256 threads, 70 KB) two CTAs share
// an SM, so one's loads run while the other transforms and stores.  Four
// detected planes take 8 rows (kernels/megafil.py::INVB_ROWS: one CTA an
// SM), so that each plane is stored in runs of 8 samples, 32 bytes, where
// 4 rows stored half sectors: conv32_jones 1.82 ms against 2.41 (H100, 700
// W).  With the radix-8 bit reversal in registers (mega_common.cuh item 9)
// it takes 0.73-0.75 ms at hybrid_conv32 (1.16 before).  Measured and not
// kept (hybrid_conv32, conv32_jones, search_j0613): both pols' rows brought
// in at once by bulk copies (cp.async.bulk) on one mbarrier a pol, each
// row's threads exchanging through their own named barrier, the first pol
// transformed while the second lands: 0.84, 1.84-1.88, 0.80-0.81 ms against
// this form's 0.75, 1.82, 0.75 (before the bit-reversal fix 1.13, 1.91,
// 1.13 against 1.16, 1.67, 1.17); a persistent CTA an SM walking the tiles
// through a ring of 3 such stages (1.26-1.46, 3.23-3.29, 1.27-1.48 before
// the fix): one CTA's transforms, detection and stores alternate with
// nothing beside them.
template <int P, int NS>
__global__ void __launch_bounds__(kMaxThreads)
megafil_invb(const float2* __restrict__ zbuf, void* __restrict__ out,
             Tables tb, int npart, int R1, int R2, int q, int nfilt_pos,
             int nkeep, int nplane, int det, int voltage, int flip, int S) {
  extern __shared__ float2 sm[];
  const int ld = seq_ld(R1);
  const int a = blockIdx.x * S;  // the tile's first row
  const int w = blockIdx.y;
  const int c = blockIdx.z;
  const long long n = (long long)R1 * R2;
  const int nsub = R2 / q;
  // pol q of row i at slot q*S + i, in natural order after
  inverse_rows<P, NS>(zbuf, sm, tb.r1, npart, R1, n, a, w, c, S);

  const float inv_m = 1.0f / (float)(R1 * q);
  const long long ntime = (long long)npart * nkeep;
  const int lg = __ffs(S) - 1;
  const int lgq = __ffs(q) - 1;
  // consecutive threads on consecutive rows: runs of S consecutive samples
  for (int idx = threadIdx.x; idx < S * R1; idx += blockDim.x) {
    const int n1 = idx >> lg;
    const int r = idx & (S - 1);
    const int row = a + r;
    const int t = (row & (q - 1)) + q * n1;
    const int o = t - nfilt_pos;
    if (o < 0 || o >= nkeep) continue;
    const long long ch = (long long)c * nsub + (row >> lgq);
    const long long dst = (long long)w * nkeep + o;
    const float2 va = sm[r * ld + sidx(n1)];
    const float2 vb =
        NS > 1 ? sm[(S + r) * ld + sidx(n1)] : make_float2(0.f, 0.f);
    if (voltage) {
      const float g = (flip & t & 1) ? -inv_m : inv_m;
      float2* vo = (float2*)out + ch * NS * ntime + dst;
      vo[0] = make_float2(va.x * g, va.y * g);
      if (NS > 1) vo[ntime] = make_float2(vb.x * g, vb.y * g);
    } else {
      float pl[kMaxPlanes];
      detect(make_float2(va.x * inv_m, va.y * inv_m),
             make_float2(vb.x * inv_m, vb.y * inv_m), det, 0, pl);
      float* po = (float*)out + ch * nplane * ntime + dst;
#pragma unroll
      for (int p = 0; p < 4; ++p)
        if (p < nplane) po[p * ntime] = pl[p];
    }
  }
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

// megafil_invb for R1 and nout pols.
decltype(&megafil_invb<16, 2>) invb_kernel(int R1, int nout) {
  if (R1 >= 16) return nout == 2 ? &megafil_invb<16, 2> : &megafil_invb<16, 1>;
  return nout == 2 ? &megafil_invb<8, 2> : &megafil_invb<8, 1>;
}

}  // namespace

extern "C" {

const char* megafil_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Shared-memory bytes (kind 0) or threads (kind 1) of pass `which` (Pass
// in mega_common.cuh): the forward passes (tile of `tile` columns, or of
// row pairs for real input and rows for complex input, layout kComplexTfp;
// the long row pass), the one-CTA inverse, and the multi-pass inverse's
// passes A and B.  npolf is the pols the inverse transforms.  The Python
// wrapper checks them against the card's limits before launching.
int megafil_resources(int kind, int which, int R1, int row_len, int M,
                      int npolf, int tile, int layout) {
  return pass_resources(kind, which, R1, row_len, M, npolf, tile,
                        layout == kComplexTfp);
}

// The registers, local (spill) bytes and most threads a block of the
// multi-pass inverse's pass `which` (kInvA: mega_inva for length q, with
// the Jones mix when jones; kInvB: megafil_invb for R1 and nout pols),
// into out[0..2].
int megafil_attributes(int which, int R1, int q, int nout, int jones,
                       int* out) {
  if (which == kInvA)
    return (int)kernel_attributes(
        jones ? inva_kernel<true>(q) : inva_kernel<false>(q), out);
  if (which == kInvB)
    return (int)kernel_attributes(invb_kernel(R1, nout), out);
  return (int)cudaErrorInvalidValue;
}

// The multi-pass inverse on the caller's stream (see mega_inva): ybuf ->
// zbuf -> out.  tw2 is the table buffer of (R1, q, M); ta and tb are the
// passes' tiles.
static cudaError_t launch_multipass(
    const void* ybuf, void* zbuf, void* out, const void* jones,
    const void* tw2, int nchan, int nout, int jpol0, int npart, int R1,
    int R2, int M, int nfilt_pos, int nkeep, int nplane, int det,
    int voltage, int flip, int ta, int tb, cudaStream_t stream) {
  cudaError_t err;
  const int q = M / R1;
  if (tb < 1 || (tb & (tb - 1)) || R2 % tb) return cudaErrorInvalidValue;
  if ((err = launch_inva(ybuf, zbuf, jones, tw2, nchan, nout, jpol0, npart,
                         R1, R2, M, ta, stream)) != cudaSuccess)
    return err;
  return launch(invb_kernel(R1, nout), dim3(R2 / tb, npart, nchan),
                pass_resources(1, kInvB, R1, R2, M, nout, tb, 1),
                pass_resources(0, kInvB, R1, R2, M, nout, tb, 1), stream,
                (const float2*)zbuf, out, tables(tw2, R1, q, M), npart, R1,
                R2, q, nfilt_pos, nkeep, nplane, det, voltage, flip, tb);
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
// (tiles ta, tb; tw2 the table buffer of (R1, q, M); cbuf is its zbuf),
// else the one-CTA inverse; tk == 0 (real input) runs the long row pass
// in place of mega_fwd2.  code, window, levels, nlow, wblk, wwin, ftp and
// the cluster form of tk are megastep_launch's; wwin gets the JA98 window
// weights.
int megafil_launch(const void* raw, const void* gr, const void* gi,
                   const void* tw, const void* tw2, const void* jones,
                   void* out, void* psum, void* cbuf, void* ybuf, void* pb,
                   const void* window, const void* levels, void* nlow,
                   void* wblk, void* wwin, void* ftp,
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
      (ta > 0 && tb < 1))
    return (int)cudaErrorInvalidValue;
  // the function types do not depend on the Jones flag
  const auto det_k = jones ? invdet_kernel<true>(M, nout)
                           : invdet_kernel<false>(M, nout);
  const auto volt_k = jones ? invvolt_kernel<true>(M, nout)
                            : invvolt_kernel<false>(M, nout);
  const void* inv = voltage ? (const void*)volt_k : (const void*)det_k;
  const int smem3 = megafil_resources(0, kInv, R1, row_len, M, nout, 0, layout);
  if (ta == 0 && (err = cudaFuncSetAttribute(inv,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem3)) != cudaSuccess)
    return (int)err;
  if ((err = launch_forward(raw, gr, gi, tw, psum, cbuf, ybuf, pb, ftp, nchan,
                            npol, pol0, npolf, store, npart, R1, R2, M, code,
                            u, wblk, wwin, nsamp_step, tc, tk, layout,
                            stream)) != cudaSuccess)
    return (int)err;
  if (ta > 0)
    return (int)launch_multipass(ybuf, cbuf, out, jones, tw2, nchan, nout,
                                 jpol0, npart, R1, R2, M, nfilt_pos, nkeep,
                                 nplane, det, voltage, flip, ta, tb, stream);
  const dim3 grid(nsub, npart, nchan);
  const int threads = megafil_resources(1, kInv, R1, row_len, M, nout, 0,
                                        layout);
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
