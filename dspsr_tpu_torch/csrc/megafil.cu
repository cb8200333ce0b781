// Fused search front end for Hopper (sm_90a): unpack -> forward FFT ->
// chirp -> per-subband inverse FFT -> detect, stored in time order, for
// real-sampled 8-bit TFP input.
//
// Replaces the Pallas kernel dspsr_tpu/ops/megakernel.py::build_megafil in
// its detected, scalar-chirp form (the digifil path), together with the XLA
// de-permute that followed it.  The TPU kernel ran every transform as dense
// DFT matmuls and wrote [R2, R1] time planes that a second XLA pass put back
// in time order; here the transforms are radix-2 FFTs in shared memory and
// the inverse pass stores each detected sample straight to its place in
// time order.  What bounds it on this card is the bytes of its
// intermediates: a flagship search block (R1 = R2 = 512, 75 windows, 2 pols)
// moves 68 MB of codes, 630 MB of stage-1 columns and 315 MB of spectra
// through device memory twice each, and writes 68 MB of detected output.
// What the design does about it: the inverse, detection and the
// time-order store are one kernel, so the subband voltages never reach
// device memory and no de-permute pass exists.
//
// Three kernels run in order on the caller's stream:
//   mega_fwd1,     the forward passes shared with megastep.cu (see
//   mega_fwd2      mega_common.cuh): unpack, columns, twiddle; rows, chirp.
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
// blocks, so the result does not depend on scheduling order.  The kernels
// allocate nothing and do not synchronise.  Each C entry point returns
// cudaGetLastError() (or the first error met).

#include "mega_common.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
megafil_invdet(const float2* __restrict__ ybuf, float* __restrict__ out,
               int npolf, int npart, int nsub, int M, int logM,
               int nfilt_pos, int nkeep, int nplane, int det) {
  extern __shared__ float2 sm[];
  float2* tw = sm;
  float2* a = tw + M / 2;
  const int s = blockIdx.x;
  const int w = blockIdx.y;
  const int c = blockIdx.z;
  make_twiddles(tw, M, +1.0);
  const long long n = (long long)nsub * M;
  for (int pf = 0; pf < npolf; ++pf) {
    const float2* src =
        ybuf + ((long long)(c * npolf + pf) * npart + w) * n + (long long)s * M;
    for (int j = threadIdx.x; j < M; j += blockDim.x)
      a[pf * M + bitrev(j, logM)] = src[j];
  }
  fft_smem(a, npolf, logM, M, tw);

  const float inv_m = 1.0f / (float)M;
  const long long ntime = (long long)npart * nkeep;
  float* dst = out + (long long)(c * nsub + s) * nplane * ntime +
               (long long)w * nkeep;
  for (int i = threadIdx.x; i < nkeep; i += blockDim.x) {
    const int t = nfilt_pos + i;
    const float2 va = a[t];
    const float2 xa = make_float2(va.x * inv_m, va.y * inv_m);
    float2 xb = make_float2(0.f, 0.f);
    if (npolf > 1) {
      const float2 vb = a[M + t];
      xb = make_float2(vb.x * inv_m, vb.y * inv_m);
    }
    float pl[kMaxPlanes];
    detect(xa, xb, det, 0, pl);
    for (int p = 0; p < nplane; ++p) dst[p * ntime + i] = pl[p];
  }
}

}  // namespace

extern "C" {

const char* megafil_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Shared-memory bytes of the three transform kernels: which 0 and 1 are the
// forward passes (see fwd_smem_bytes), 2 the inverse (the Python wrapper
// checks the same sums against the card's limit before launching).
int megafil_smem_bytes(int which, int R1, int row_len, int M, int npolf,
                       int tile) {
  if (which < 2) return fwd_smem_bytes(which, R1, row_len, tile);
  return (M / 2 + npolf * M) * (int)sizeof(float2);
}

// One fused search front-end step.  Pointers are device pointers; scratch
// buffers are sized by the wrapper: cbuf float2[nchan*npolf, npart, R1,
// row_len], ybuf float2[nchan*npolf, npart, R1*R2]; out float[nchan*nsub,
// nplane, npart*nkeep].
int megafil_launch(const void* raw, const void* gr, const void* gi,
                   void* out, void* cbuf, void* ybuf, int nchan, int npol,
                   int pol0, int npolf, int npart, int R1, int R2, int nsub,
                   int M, int nfilt_pos, int nkeep, int nplane, int det,
                   int twos, float scale, float offset, int nsamp_step,
                   int tc, int tk, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  cudaError_t err;
  const int smem3 = megafil_smem_bytes(2, R1, 2 * R2, M, npolf, 0);
  if ((err = cudaFuncSetAttribute(megafil_invdet,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem3)) != cudaSuccess)
    return (int)err;
  if ((err = launch_forward(raw, gr, gi, cbuf, ybuf, nchan, npol, pol0, npolf,
                            npart, R1, R2, twos, scale, offset, nsamp_step,
                            tc, tk, stream)) != cudaSuccess)
    return (int)err;
  dim3 g3(nsub, npart, nchan);
  megafil_invdet<<<g3, kThreads, smem3, stream>>>(
      (const float2*)ybuf, (float*)out, npolf, npart, nsub, M, ilog2(M),
      nfilt_pos, nkeep, nplane, det);
  return (int)cudaGetLastError();
}

}  // extern "C"
