// Fused search front end for Hopper (sm_90a): unpack -> forward FFT ->
// chirp -> per-subband inverse FFT -> detect, stored in time order, for
// real-sampled 8-bit TFP input.
//
// Replaces the Pallas kernel dspsr_tpu/ops/megakernel.py::build_megafil in
// its detected, scalar-chirp form, together with the XLA de-permute that
// followed it: the digifil path, and the hybrid fold engine's front end,
// which adds the pre-response passband tap (see item 5 of mega_common.cuh)
// and hands in the chirp (times an RFI mask) on every call.  The tap adds
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
// Four kernels run in order on the caller's stream:
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
//
// Every output sample is written exactly once and nothing is summed across
// blocks, so the detected output does not depend on scheduling order (the
// passband does, in its last bits).  The kernels
// allocate nothing and do not synchronise.  Each C entry point returns
// cudaGetLastError() (or the first error met).

#include "mega_common.cuh"

namespace {

template <int P, int NS>
__global__ void __launch_bounds__(kMaxThreads)
megafil_invdet(const float2* __restrict__ ybuf, float* __restrict__ out,
               const float2* __restrict__ tw, int npart, int nsub, int M,
               int nfilt_pos, int nkeep, int nplane, int det) {
  extern __shared__ float2 sm[];
  const int ld = seq_ld(M);
  const int s = blockIdx.x;
  const int w = blockIdx.y;
  const int c = blockIdx.z;
  inverse_subband<P, NS>(ybuf, sm, tw, npart, nsub, M, s, w, c);

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

// The inverse-and-detect kernel for freq_res M and npolf pols.
decltype(&megafil_invdet<16, 2>) invdet_kernel(int M, int npolf) {
  if (M >= 16) return npolf == 2 ? &megafil_invdet<16, 2> : &megafil_invdet<16, 1>;
  return npolf == 2 ? &megafil_invdet<8, 2> : &megafil_invdet<8, 1>;
}

}  // namespace

extern "C" {

const char* megafil_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Shared-memory bytes (kind 0) or threads (kind 1) of the three transform
// kernels: which 0 and 1 are the forward passes (tile of `tile` columns or
// row pairs), 2 the inverse.  The Python wrapper checks them against the
// card's limits before launching.
int megafil_resources(int kind, int which, int R1, int row_len, int M,
                      int npolf, int tile) {
  if (kind == 1) return transform_threads(which, R1, row_len, M, tile);
  if (which < 2) return fwd_smem_bytes(which, R1, row_len, tile);
  return inv_smem_bytes(M, npolf);
}

// One fused search front-end step.  Pointers are device pointers; tw is the
// wrapper's twiddle-table buffer (see Tables in mega_common.cuh); the
// forward transforms npolf pols from pol0 and keeps those in `store` (bit 0
// the first, bit 1 the second) for the inverse; gr/gi are float[nchan,
// R1*R2] in natural bin order.  Scratch buffers are sized by the wrapper:
// psum float[nchan, npart, 2], cbuf float2[nchan, npart, R1, row_len],
// ybuf float2[nchan*nstore, npart, R1*R2]; out float[nchan*nsub, nplane,
// npart*nkeep]; pb null or float[nchan, npolf, R1*R2].
int megafil_launch(const void* raw, const void* gr, const void* gi,
                   const void* tw, void* out, void* psum, void* cbuf,
                   void* ybuf, void* pb, int nchan, int npol, int pol0,
                   int npolf, int store, int npart, int R1, int R2, int nsub,
                   int M, int nfilt_pos, int nkeep, int nplane, int det,
                   int twos, float scale, float offset, int nsamp_step,
                   int tc, int tk, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  cudaError_t err;
  const int row_len = 2 * R2;
  const int nstore = (store & 1) + (store >> 1);
  auto inv = invdet_kernel(M, nstore);
  const int smem3 = megafil_resources(0, 2, R1, row_len, M, nstore, 0);
  if ((err = cudaFuncSetAttribute(inv,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem3)) != cudaSuccess)
    return (int)err;
  if ((err = launch_forward(raw, gr, gi, tw, psum, cbuf, ybuf, pb, nchan,
                            npol, pol0, npolf, store, npart, R1, R2, M, twos,
                            scale, offset, nsamp_step, tc, tk,
                            stream)) != cudaSuccess)
    return (int)err;
  inv<<<dim3(nsub, npart, nchan), transform_threads(2, R1, row_len, M, 0),
        smem3, stream>>>(
      (const float2*)ybuf, (float*)out, tables(tw, R1, row_len, M).inv, npart,
      nsub, M, nfilt_pos, nkeep, nplane, det);
  return (int)cudaGetLastError();
}

}  // extern "C"
