// Device code shared by the fused fold step (megastep.cu) and the fused
// search front end (megafil.cu): radix-2 FFTs in shared memory, the two
// forward passes of the four-step transform, and detection.
//
// The forward transform of one overlap-save window of 2N real samples
// (N = nsub * freq_res = R1 * R2) runs in two passes through device memory:
//   mega_fwd1  per (input channel x pol, window, tile of columns m):
//              unpack codes, view the window as W[n1, m] with
//              n = n1*row_len + m; radix-R1 FFT over n1, twiddle
//              exp(-2 pi i m k1 / 2N); store C[k1, m].
//   mega_fwd2  per (input channel x pol, window, tile of rows k1): FFT of
//              length row_len = 2*R2 over m, keep k2 < R2 (Nyquist dropped),
//              multiply the chirp, store the spectrum in natural bin order
//              k = k2*R1 + k1.
// launch_forward() sets their shared-memory limits and launches both.
//
// Each library that includes this header is its own translation unit and
// shared object, so everything here has internal linkage.

#pragma once

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
// of the first and second transformed pol (reference detection order, plus
// the 10 unique S_i * S_j products after the Stokes planes when fourth != 0).
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

int ilog2(int x) {
  int r = 0;
  while ((1 << r) < x) ++r;
  return r;
}

// Shared-memory bytes of the forward passes: which 0 = mega_fwd1 (tile of
// tc columns), 1 = mega_fwd2 (tile of tk rows).
int fwd_smem_bytes(int which, int R1, int row_len, int tile) {
  if (which == 0) return (R1 / 2 + tile * (R1 + 1)) * (int)sizeof(float2);
  return (row_len / 2 + tile * (row_len + 1)) * (int)sizeof(float2);
}

// Both forward passes on the caller's stream: raw codes -> cbuf
// float2[nchan*npolf, npart, R1, row_len] -> ybuf float2[nchan*npolf, npart,
// R1*R2], the chirped spectrum in natural bin order.
cudaError_t launch_forward(const void* raw, const void* gr, const void* gi,
                           void* cbuf, void* ybuf, int nchan, int npol,
                           int pol0, int npolf, int npart, int R1, int R2,
                           int twos, float scale, float offset,
                           int nsamp_step, int tc, int tk,
                           cudaStream_t stream) {
  const int row_len = 2 * R2;
  const int smem1 = fwd_smem_bytes(0, R1, row_len, tc);
  const int smem2 = fwd_smem_bytes(1, R1, row_len, tk);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(mega_fwd1,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem1)) != cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(mega_fwd2,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem2)) != cudaSuccess)
    return err;
  dim3 g1(row_len / tc, npart, nchan * npolf);
  mega_fwd1<<<g1, kThreads, smem1, stream>>>(
      (const uint8_t*)raw, (float2*)cbuf, nchan, npol, pol0, npolf, npart, R1,
      ilog2(R1), row_len, nsamp_step, tc, twos, scale, offset);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dim3 g2(R1 / tk, npart, nchan * npolf);
  mega_fwd2<<<g2, kThreads, smem2, stream>>>(
      (const float2*)cbuf, (float2*)ybuf, (const float*)gr, (const float*)gi,
      npolf, npart, R1, R2, row_len, ilog2(row_len), tk);
  return cudaGetLastError();
}

}  // namespace
