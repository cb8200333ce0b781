// Device code shared by the fused fold step (megastep.cu) and the fused
// search front end (megafil.cu): register-resident FFTs, the forward half of
// the four-step transform, and detection.
//
// The forward transform of one overlap-save window of 2N real samples
// (N = nsub * freq_res = R1 * R2, row_len = 2 * R2) is a four-step FFT with
// n = n1*row_len + m and k = k2*R1 + k1.  It runs in two passes through
// device memory, once per (input channel, window):
//   mega_polpow  (two pols only) per-window energy of each pol, from which
//                both passes derive a power-of-two scale for pol b.
//   mega_fwd1    per (input channel, window, tile of S columns m): unpack
//                the codes of both pols as ONE complex sequence
//                z = x_a + i 2^e x_b, length-R1 FFT over n1, twiddle
//                exp(-2 pi i m k1 / 2N), store C[k1, m].
//   mega_fwd2    per (input channel, window, tile of row pairs {k1, R1-k1}):
//                length-row_len FFT of both rows, separate the two pols'
//                spectra from Z[k] and conj Z[2N-k], keep k2 < R2 (Nyquist
//                dropped), optionally add |X|^2 of each pol into the
//                passband, multiply the chirp, store the spectrum of each
//                pol the caller keeps in natural bin order k = k2*R1 + k1.
// launch_forward() sets their shared-memory limits and launches them.
//
// Bytes and bounds.  A flagship block (R1 = R2 = 512, 75 windows of 2N =
// 2^19 samples, two pols, one input channel) reads 79 MB of codes twice
// (mega_polpow, mega_fwd1), writes and reads 315 MB of stage-1 columns
// (cbuf) and 315 MB of spectra (ybuf), and the search path writes 68 MB
// of detected output: about 1.4 GB, 0.42 ms at 3.35 TB/s.  Measured on an
// H100 (700 W), a block takes about 1.2 ms: mega_polpow 0.03 ms, mega_fwd1
// 0.40 ms (1.0 TB/s), mega_fwd2 0.45 ms (1.4 TB/s), the inverse 0.20 ms
// (search, 1.9 TB/s) or 0.28 ms (fold).  No pass reaches the device-memory
// rate; what holds them back is per SM: shared-memory exchanges and the
// CTAs that registers and shared memory let run at once (mega_fwd2 gained
// 10-15% from a third CTA per SM).
//
// The design, item by item:
// 1. One complex transform for both pols.  The input is real, so two pols
//    packed as z = x_a + i x_b share one transform.  Both forward passes run
//    once per (channel, window) instead of once per pol, and the stage-1
//    scratch halves (630 -> 315 MB a flagship block).  Partner of (row k1,
//    column k2) is 2N - k: row R1-k1, column row_len-1-k2 for k1 > 0, and
//    row 0, column (row_len-k2) mod row_len for k1 = 0; for every kept
//    column it lies in the half that is computed and dropped, so a CTA that
//    holds the row pair separates both rows in shared memory.  Rows 0 and
//    R1/2 pair with themselves and share a CTA.  The float32 rounding of a
//    packed transform is relative to |z|, so a pol much weaker than the
//    other would lose bits in the separation: pol b is scaled by 2^e per
//    window (e from the two pols' energies, exact in float) and unscaled
//    after the separation, which keeps each pol's error relative to its own
//    power.  npolf == 1 runs the same code with x_b = 0.
// 2. Register-resident Stockham FFTs (fft_seqs).  Each thread holds P = 16
//    (P = 8 for L = 8) points j + T*i (T = L/P) of a sequence and runs
//    radix-16/8/4/2 butterflies in registers; shared memory is touched only
//    between passes.  512 = 16*8*4, 1024 = 16*8*8, 4096 = 16*16*16: three
//    passes and three barriers where radix-2 took 9-12 passes.  The
//    self-sorting order keeps input and output in natural order, so tiles
//    load from and store to device memory in coalesced runs.  P = 8 was
//    no faster in mega_fwd1 and slower in mega_fwd2 (0.68 against 0.57 ms)
//    and in the inverse (0.56 against 0.26 ms).
// 3. Twiddles from tables built once per plan by the wrapper in float64 and
//    rounded to float32: one table per FFT length, and the inter-stage
//    exp(-2 pi i m k1 / 2N) as the product of three small ones: with m0 =
//    m - col the tile's first column and e = (m0*k1) & (2N-1),
//    hi[e >> lo_bits] * lo[e & lo_mask] * col[k1][col] (12 KB + 64 KB at
//    the flagship; within 4e-7 of the exact factor).  One 4 MB table of
//    2N entries, read from L2, made mega_fwd1 0.58 ms instead of 0.48.  No
//    sincos and no 64-bit remainder is left in the kernels.
// 4. Stores.  mega_fwd1 stores runs of S = 8 columns (64 bytes); mega_fwd2
//    separates from its row tile in shared memory and stores runs of
//    consecutive k1 (tiles of 4 + 4 rows: 32-byte sectors).  Tiles of 8 + 8
//    rows (64-byte runs) need twice the shared memory and measured slower
//    (0.65 against 0.52 ms).  The inverse kernels read each subband slice
//    with plain coalesced loads: a bulk asynchronous copy (cp.async.bulk
//    with an mbarrier) measured 0.25 against 0.20 ms, and walking the
//    windows in groups whose cbuf stays in L2 measured 1.2 against 1.0 ms
//    for the two forward passes, so neither is used.
//
// 5. The passband tap (hybrid fold engine: passband integration and the
//    spectral RFI filter).  |X_a|^2 and |X_b|^2 are taken in mega_fwd2 right
//    after the pol separation, before the chirp: with an RFI mask the
//    response has zeros, so they cannot be recovered from the chirped
//    spectra.  Every window's CTA adds into one float[nchan, npolf, N] sum
//    with atomicAdd, so the order of the additions, and the last bits of
//    the passband, change from run to run.  With the tap, PP or QQ
//    detection transforms both pols (the passband has both) and stores
//    only the detected pol's spectrum.
//
// Each library that includes this header is its own translation unit and
// shared object, so everything here has internal linkage.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // mega_polpow, mega_finish
constexpr int kMaxThreads = 512;  // the transform kernels
constexpr int kMaxPlanes = 14;
// Registers of mega_fwd2: at 80 (a few spills) three 256-thread tiles fit
// on an SM instead of two, and the pass runs 0.47 ms a flagship block
// instead of 0.52-0.55 (H100, 700 W).  Capping mega_fwd1 or the inverse
// the same way made them slower or no faster.
constexpr int kFwd2Regs = 80;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// Shared-memory layout of one sequence of length L: element i at sidx(i)
// (one pad slot every 16 float2, so the strided stores of the early passes
// do not collide on a bank), sequences seq_ld(L) apart (odd, so threads on
// the same element of different sequences do not collide either).
__host__ __device__ constexpr int sidx(int i) { return i + (i >> 4); }
__host__ __device__ constexpr int seq_ld(int L) { return L + (L >> 4) + 1; }

// Points each thread holds in a length-L transform.
__host__ __device__ constexpr int fft_points(int L) { return L >= 16 ? 16 : 8; }

__host__ __device__ constexpr int ilog2c(int x) {
  return x <= 1 ? 0 : 1 + ilog2c(x >> 1);
}

// Bit reversal of a compile-time index (no recursion, so that the renaming
// of registers in dft() folds away).
__host__ __device__ __forceinline__ constexpr int brev(int i, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((i >> b) & 1) << (bits - 1 - b);
  return r;
}

// x * exp(DIR * 2 pi i j / 16) for j known at compile time once unrolled.
template <int DIR>
__device__ __forceinline__ float2 rot16(float2 x, int j) {
  constexpr float C1 = 0.92387953251128674f;  // cos(pi/8)
  constexpr float S1 = 0.38268343236508978f;  // sin(pi/8)
  constexpr float H = 0.70710678118654752f;   // cos(pi/4)
  float c, s;
  switch (j & 15) {
    case 0: return x;
    case 4: return make_float2(-DIR * x.y, DIR * x.x);
    case 8: return make_float2(-x.x, -x.y);
    case 12: return make_float2(DIR * x.y, -DIR * x.x);
    case 1: c = C1; s = S1; break;
    case 2: c = H; s = H; break;
    case 3: c = S1; s = C1; break;
    case 5: c = -S1; s = C1; break;
    case 6: c = -H; s = H; break;
    case 7: c = -C1; s = S1; break;
    case 9: c = -C1; s = -S1; break;
    case 10: c = -H; s = -H; break;
    case 11: c = -S1; s = -C1; break;
    case 13: c = S1; s = -C1; break;
    case 14: c = H; s = -H; break;
    default: c = C1; s = -S1; break;
  }
  s *= (float)DIR;
  return make_float2(x.x * c - x.y * s, x.x * s + x.y * c);
}

// One radix-2 DIF stage of span H on R registers, then the next: every
// bound and index is a template constant, so x stays in registers.
template <int R, int H, int DIR>
__device__ __forceinline__ void dif_stages(float2 (&x)[R]) {
#pragma unroll
  for (int g = 0; g < R; g += 2 * H) {
#pragma unroll
    for (int k = 0; k < H; ++k) {
      const float2 a = x[g + k];
      const float2 b = x[g + k + H];
      x[g + k] = cadd(a, b);
      x[g + k + H] = rot16<DIR>(csub(a, b), k * (8 / H));
    }
  }
  if constexpr (H > 1) dif_stages<R, H / 2, DIR>(x);
}

// In-register DFT of R points (R = 2, 4, 8, 16), natural order in and out,
// sign DIR of the exponent: radix-2 decimation in frequency, then the
// bit-reversal as a renaming of registers.
template <int R, int DIR>
__device__ __forceinline__ void dft(float2 (&x)[R]) {
  constexpr int LOG = ilog2c(R);
  dif_stages<R, R / 2, DIR>(x);
  float2 y[R];
#pragma unroll
  for (int i = 0; i < R; ++i) y[brev(i, LOG)] = x[i];
#pragma unroll
  for (int i = 0; i < R; ++i) x[i] = y[i];
}

// Bits of pass s of a length-2^logL transform with P points a thread: the
// first pass is radix P, the rest split the remaining bits as evenly as
// possible, larger first (512 = 16*8*4, 1024 = 16*8*8, 4096 = 16*16*16).
__host__ __device__ inline int pass_bits(int s, int logL, int lgP) {
  if (s == 0) return lgP;
  const int rem = logL - lgP;
  const int n = (rem + lgP - 1) / lgP;
  return rem / n + (s - 1 < rem % n ? 1 : 0);
}

__host__ __device__ inline int num_passes(int logL, int lgP) {
  return 1 + (logL - lgP + lgP - 1) / lgP;
}

// One Stockham pass of radix R over one sequence: thread j runs the P/R
// butterflies b = j + u*T on its registers, whose v[i] holds element
// j + T*i of the pass input.  A butterfly reads b + r*L/R, applies
// exp(DIR 2 pi i k r / (Ns R)) with k = b mod Ns, transforms, and writes
// (b/Ns)*Ns*R + k + r*Ns to shared memory (on the last pass that is the
// natural position b + r*L/R), or, when to_regs, back into the registers it
// came from.  The twiddle of (k, r) is tw[(r-1)*Ns + k] of this pass's
// table, so the lanes of a warp (consecutive k) read consecutive entries.
template <int P, int R, int DIR>
__device__ __forceinline__ void fft_pass(float2 (&v)[P], float2* seq, int j,
                                         int T, int Ns, bool to_regs,
                                         const float2* __restrict__ tw) {
  constexpr int B = P / R;
#pragma unroll
  for (int u = 0; u < B; ++u) {
    const int b = j + u * T;
    const int k = b & (Ns - 1);
    const int base = (b - k) * R + k;
    float2 x[R];
#pragma unroll
    for (int r = 0; r < R; ++r) x[r] = v[u + r * B];
    if (Ns > 1) {
#pragma unroll
      for (int r = 1; r < R; ++r) {
        const float2 t = __ldg(tw + (r - 1) * Ns + k);
        x[r] = cmul(x[r], make_float2(t.x, DIR < 0 ? t.y : -t.y));
      }
    }
    dft<R, DIR>(x);
    if (to_regs) {
#pragma unroll
      for (int r = 0; r < R; ++r) v[u + r * B] = x[r];
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) seq[sidx(base + r * Ns)] = x[r];
    }
  }
}

// NS length-L FFTs (L = 2^logL, sign DIR, unscaled), P points a thread, T =
// L/P threads j = 0..T-1 on each.  load(q, v) fills v[i] with element
// j + T*i of sequence q.  Sequence q exchanges through shared memory at
// seq + q*seq_stride (seq_ld(L) float2) and, unless KEEP, ends there in
// natural order, X[t] at sidx(t), after a closing barrier.  With KEEP (one
// sequence) the result stays in v: v[i] = X[j + T*i].  The sequences are
// walked in turn within each pass, so a thread holds P points at a time;
// the barrier after one sequence's reads also orders the previous one's
// writes.  tw is the length-L table: for each pass s >= 1 in turn,
// (R_s - 1)*Ns_s entries exp(-2 pi i k r / (Ns_s R_s)) at (r-1)*Ns_s + k
// (L - P entries in all).  Every thread of the block calls it.
template <int P, int NS, int DIR, bool KEEP, class Load>
__device__ __forceinline__ void fft_seqs(float2 (&v)[P], Load load,
                                         float2* seq, int seq_stride, int j,
                                         int L, int logL,
                                         const float2* __restrict__ tw) {
  static_assert(!KEEP || NS == 1, "KEEP holds one sequence");
  constexpr int lgP = ilog2c(P);
  const int T = L / P;
  const int np = num_passes(logL, lgP);
  int Ns = 1;
  for (int s = 0; s < np; ++s) {
    const bool to_regs = KEEP && s == np - 1;
    const int bits = pass_bits(s, logL, lgP);
#pragma unroll
    for (int q = 0; q < NS; ++q) {
      float2* sq = seq + q * seq_stride;
      if (s == 0) {
        load(q, v);
      } else {
        if (q == 0 && (NS == 1 || s == 1)) __syncthreads();
#pragma unroll
        for (int i = 0; i < P; ++i) v[i] = sq[sidx(j + T * i)];
        __syncthreads();
      }
      switch (bits) {
        case 1: fft_pass<P, 2, DIR>(v, sq, j, T, Ns, to_regs, tw); break;
        case 2: fft_pass<P, 4, DIR>(v, sq, j, T, Ns, to_regs, tw); break;
        case 3: fft_pass<P, 8, DIR>(v, sq, j, T, Ns, to_regs, tw); break;
        default:
          if constexpr (P >= 16)
            fft_pass<P, 16, DIR>(v, sq, j, T, Ns, to_regs, tw);
          break;
      }
    }
    if (s > 0) tw += ((1 << bits) - 1) * Ns;
    Ns <<= bits;
  }
  if (!KEEP) __syncthreads();
}

__device__ __forceinline__ float unpack(uint8_t byte, int twos, float scale,
                                        float offset) {
  const float code = twos ? (float)(int8_t)byte : (float)byte;
  return code * scale + offset;
}

// Exponent e of pol b's scale 2^e in a window, from the two pols' energies
// (psum[0], psum[1]): the power of two nearest to |x_a| / |x_b|, 0 when
// either pol is silent.  fwd1 and fwd2 read the same sums, so they agree.
__device__ __forceinline__ int pol_exponent(const float* psum) {
  const float ea = psum[0];
  const float eb = psum[1];
  if (!(ea > 0.f) || !(eb > 0.f)) return 0;
  const float d = 0.5f * (log2f(ea) - log2f(eb));
  return (int)rintf(fminf(fmaxf(d, -60.f), 60.f));
}

// Energy of both pols over each window (grid: chunks of the window, window,
// input channel), added into psum[c, w, 2] (zeroed by the caller).
__global__ void __launch_bounds__(kThreads)
mega_polpow(const uint8_t* __restrict__ raw, float* __restrict__ psum,
            int nchan, int npol, int npart, int nsamp_step, int two_n,
            int twos, float scale, float offset) {
  __shared__ float red[2][kThreads / 32];
  const int w = blockIdx.y;
  const int c = blockIdx.z;
  const int chunk = two_n / gridDim.x;
  const long long t0 = (long long)w * nsamp_step + (long long)blockIdx.x * chunk;
  float sa = 0.f, sb = 0.f;
  if (nchan == 1 && chunk % 8 == 0 && (t0 & 7) == 0 &&
      ((uintptr_t)raw & 15) == 0) {
    // one input channel: 8 samples of both pols in one 16-byte load
    const uint4* src = (const uint4*)(raw + 2 * t0);
    for (int i = threadIdx.x; i < chunk / 8; i += blockDim.x) {
      const uint4 q = src[i];
      const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float a = unpack((uint8_t)(words[k] >> (16 * h)), twos, scale, offset);
          const float b = unpack((uint8_t)(words[k] >> (16 * h + 8)), twos, scale, offset);
          sa += a * a;
          sb += b * b;
        }
    }
  } else {
    for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
      const long long off = ((t0 + i) * nchan + c) * npol;
      const float a = unpack(raw[off], twos, scale, offset);
      const float b = unpack(raw[off + 1], twos, scale, offset);
      sa += a * a;
      sb += b * b;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sa += __shfl_xor_sync(0xffffffffu, sa, o);
    sb += __shfl_xor_sync(0xffffffffu, sb, o);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[0][warp] = sa;
    red[1][warp] = sb;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ta = 0.f, tb = 0.f;
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) {
      ta += red[0][i];
      tb += red[1][i];
    }
    float* dst = psum + 2 * ((long long)c * npart + w);
    atomicAdd(dst, ta);
    atomicAdd(dst + 1, tb);
  }
}

// Columns of a mega_fwd1 tile at most (the width of the column table).
constexpr int kMaxCols = 16;

// Offsets of the wrapper's twiddle tables (float2, one buffer): the
// length-R1, length-row_len and length-M FFT tables (L entries each, laid
// out per pass as fft_seqs reads them), then the inter-stage lo[e] =
// exp(-2 pi i e / 2N), e < 2^lo_bits, hi[e] = exp(-2 pi i e 2^lo_bits / 2N),
// and col[k1*kMaxCols + c] = exp(-2 pi i c k1 / 2N), c < kMaxCols.
struct Tables {
  const float2* r1;
  const float2* row;
  const float2* inv;
  const float2* lo;
  const float2* hi;
  const float2* col;
  int log2n;
  int lo_bits;
};

Tables tables(const void* base, int R1, int row_len, int M) {
  Tables t;
  t.r1 = (const float2*)base;
  t.row = t.r1 + R1;
  t.inv = t.row + row_len;
  t.lo = t.inv + M;
  t.log2n = ilog2c(R1 * row_len);
  t.lo_bits = (t.log2n + 1) / 2;
  t.hi = t.lo + (1 << t.lo_bits);
  t.col = t.hi + (1 << (t.log2n - t.lo_bits));
  return t;
}

template <int P>
__global__ void __launch_bounds__(kMaxThreads)
mega_fwd1(const uint8_t* __restrict__ raw, float2* __restrict__ cbuf,
          const float* __restrict__ psum, Tables tb, int nchan, int npol,
          int pol0, int npolf, int npart, int R1, int row_len,
          int nsamp_step, int S, int twos, float scale, float offset) {
  extern __shared__ float2 sm[];
  const int T = R1 / P;
  const int col = threadIdx.x & (S - 1);
  const int j = threadIdx.x / S;
  const int m = blockIdx.x * S + col;
  const int w = blockIdx.y;
  const int c = blockIdx.z;
  const float sb =
      npolf == 2 ? ldexpf(1.f, pol_exponent(psum + 2 * ((long long)c * npart + w)))
                 : 0.f;
  const long long t0 = (long long)w * nsamp_step + m;
  float2 v[P];
  // both pols' bytes of a sample in one 16-bit load (pol 0 at an even
  // offset) when the buffer allows it
  const bool pairs = npolf == 2 && ((uintptr_t)raw & 1) == 0;
  const long long row_bytes = (long long)row_len * nchan * npol;
  const uint8_t* src = raw + (t0 * nchan + c) * npol + pol0 + j * row_bytes;
  auto load = [&](int, float2(&x)[P]) {
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const uint8_t* p = src + i * T * row_bytes;
      uint8_t ca, cb = 0;
      if (pairs) {
        const unsigned short both = *(const unsigned short*)p;
        ca = (uint8_t)both;
        cb = (uint8_t)(both >> 8);
      } else {
        ca = p[0];
        if (npolf == 2) cb = p[1];
      }
      const float a = unpack(ca, twos, scale, offset);
      const float b = npolf == 2 ? unpack(cb, twos, scale, offset) : 0.f;
      x[i] = make_float2(a, b * sb);
    }
  };
  fft_seqs<P, 1, -1, true>(v, load, sm + col * seq_ld(R1), 0, j, R1,
                           __ffs(R1) - 1, tb.r1);
  // exp(-2 pi i m k1 / 2N) = exp(-2 pi i m0 k1 / 2N) exp(-2 pi i col k1 / 2N):
  // the first factor is the same across a half-warp (one k1, all columns),
  // the second is read from the column table in 128-byte lines
  const int m0 = m - col;
  const int mask = (1 << tb.log2n) - 1;
  const int lo_mask = (1 << tb.lo_bits) - 1;
  float2* dst = cbuf + ((long long)c * npart + w) * R1 * row_len + m;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int k1 = j + T * i;
    const int e = (m0 * k1) & mask;
    const float2 t0 = cmul(__ldg(tb.hi + (e >> tb.lo_bits)), __ldg(tb.lo + (e & lo_mask)));
    const float2 t = cmul(t0, __ldg(tb.col + k1 * kMaxCols + col));
    dst[(long long)k1 * row_len] = cmul(v[i], t);
  }
}

// store: bit 0 keeps pol a's spectrum, bit 1 pol b's, in that order in
// ybuf; pb, when not null, is the zeroed passband float[nchan, npolf, N].
template <int P>
__global__ void __maxnreg__(kFwd2Regs)
mega_fwd2(const float2* __restrict__ cbuf, float2* __restrict__ ybuf,
          const float* __restrict__ gr, const float* __restrict__ gi,
          const float* __restrict__ psum, float* __restrict__ pb, Tables tb,
          int npolf, int store, int npart, int R1, int R2, int row_len,
          int tp) {
  extern __shared__ float2 sm[];
  const int T = row_len / P;
  const int ld = seq_ld(row_len);
  const int i = threadIdx.x / T;  // row pair of the tile
  const int j = threadIdx.x - i * T;
  const int a = blockIdx.x * tp;
  const int w = blockIdx.y;
  const int c = blockIdx.z;
  const int klo = a + i;
  const int khi = klo == 0 ? R1 / 2 : R1 - klo;
  const float2* lo = cbuf + (((long long)c * npart + w) * R1 + klo) * row_len;
  const float2* hi = cbuf + (((long long)c * npart + w) * R1 + khi) * row_len;
  float2 v[P];
  auto load = [&](int q, float2(&x)[P]) {
    const float2* src = q ? hi : lo;
#pragma unroll
    for (int ii = 0; ii < P; ++ii) x[ii] = src[j + T * ii];
  };
  // slot i holds row klo, slot tp + i row khi, both in natural order after
  fft_seqs<P, 2, -1, false>(v, load, sm + i * ld, tp * ld, j, row_len,
                            __ffs(row_len) - 1, tb.row);

  const long long n = (long long)R1 * R2;
  const float unscale =
      npolf == 2 ? ldexpf(1.f, -pol_exponent(psum + 2 * ((long long)c * npart + w)))
                 : 0.f;
  const int nstore = (store & 1) + (store >> 1);
  float2* ya = ybuf + ((long long)c * nstore * npart + w) * n;
  float2* yb = ya + ((store & 1) ? (long long)npart * n : 0LL);
  float* pbc = pb ? pb + (long long)c * npolf * n : nullptr;
  const float* grc = gr + (long long)c * n;
  const float* gic = gi + (long long)c * n;
  const int nslot = 2 * tp;
  const int lg_slot = __ffs(nslot) - 1;
  // consecutive threads on consecutive k1: tp low rows a.., then the tp
  // high rows in increasing k1
  for (int q = threadIdx.x; q < nslot * R2; q += blockDim.x) {
    const int k2 = q >> lg_slot;
    const int r = q & (nslot - 1);
    int slot, k1, pslot, pcol;
    if (r < tp) {
      slot = r;
      k1 = a + r;
      pslot = k1 == 0 ? slot : tp + r;
      pcol = k1 == 0 ? (row_len - k2) & (row_len - 1) : row_len - 1 - k2;
    } else {
      const int ii = nslot - 1 - r;
      slot = tp + ii;
      k1 = a + ii == 0 ? R1 / 2 : R1 - a - ii;
      pslot = a + ii == 0 ? slot : ii;
      pcol = row_len - 1 - k2;
    }
    const float2 z = sm[slot * ld + sidx(k2)];
    const float2 p = sm[pslot * ld + sidx(pcol)];
    const long long k = (long long)k2 * R1 + k1;
    const float2 g = make_float2(grc[k], gic[k]);
    // X_a = (Z + conj P) / 2, X_b = (Z - conj P) / 2i
    const float2 xa = make_float2(0.5f * (z.x + p.x), 0.5f * (z.y - p.y));
    const float2 xb = make_float2(0.5f * (z.y + p.y) * unscale,
                                  -0.5f * (z.x - p.x) * unscale);
    if (pbc) {
      atomicAdd(pbc + k, xa.x * xa.x + xa.y * xa.y);
      if (npolf == 2) atomicAdd(pbc + n + k, xb.x * xb.x + xb.y * xb.y);
    }
    if (store & 1) ya[k] = cmul(xa, g);
    if (npolf == 2 && (store & 2)) yb[k] = cmul(xb, g);
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

// The inverse kernels' first half: load the NS pols' freq_res-point slices
// of subband s, window w, input channel c from ybuf, inverse-FFT them
// (unscaled) and leave pol q's sample t at sm[q*seq_ld(M) + sidx(t)].
// Ends with a barrier.
template <int P, int NS>
__device__ __forceinline__ void inverse_subband(
    const float2* __restrict__ ybuf, float2* sm, const float2* __restrict__ tw,
    int npart, int nsub, int M, int s, int w, int c) {
  const int T = M / P;
  const int ld = seq_ld(M);
  const long long n = (long long)nsub * M;
  const int j = threadIdx.x;
  float2 v[P];
  auto load = [&](int q, float2(&x)[P]) {
    const float2* src =
        ybuf + ((long long)(c * NS + q) * npart + w) * n + (long long)s * M;
#pragma unroll
    for (int i = 0; i < P; ++i) x[i] = src[j + T * i];
  };
  fft_seqs<P, NS, +1, false>(v, load, sm, ld, j, M, __ffs(M) - 1, tw);
}

// Threads of each transform kernel: which 0 = mega_fwd1 (tile of `tile`
// columns), 1 = mega_fwd2 (tile of `tile` row pairs), 2 = the inverse.
int transform_threads(int which, int R1, int row_len, int M, int tile) {
  if (which == 0) return tile * (R1 / fft_points(R1));
  if (which == 1) return tile * (row_len / fft_points(row_len));
  return M / fft_points(M);
}

// Shared-memory bytes of the inverse's transform (npolf sequences of M).
int inv_smem_bytes(int M, int npolf) {
  return npolf * seq_ld(M) * (int)sizeof(float2);
}

// Shared-memory bytes of the forward passes (which as above).
int fwd_smem_bytes(int which, int R1, int row_len, int tile) {
  if (which == 0) return tile * seq_ld(R1) * (int)sizeof(float2);
  return 2 * tile * seq_ld(row_len) * (int)sizeof(float2);
}

// The forward half on the caller's stream: raw codes -> (psum) -> cbuf
// float2[nchan, npart, R1, row_len] -> ybuf float2[nchan*nstore, npart,
// R1*R2], the chirped spectrum of each pol in `store` (bit 0 pol a, bit 1
// pol b; nstore of them) in natural bin order.  psum is float[nchan, npart,
// 2]; tw is the wrapper's table buffer (Tables); pb, when not null, gets
// the passband float[nchan, npolf, R1*R2] (zeroed here).
cudaError_t launch_forward(const void* raw, const void* gr, const void* gi,
                           const void* tw, void* psum, void* cbuf, void* ybuf,
                           void* pb, int nchan, int npol, int pol0, int npolf,
                           int store, int npart, int R1, int R2, int M,
                           int twos, float scale, float offset,
                           int nsamp_step, int tc, int tk,
                           cudaStream_t stream) {
  const int row_len = 2 * R2;
  const Tables tb = tables(tw, R1, row_len, M);
  cudaError_t err;
  if (tc > kMaxCols) return cudaErrorInvalidValue;
  if (store < 1 || store > 3 || (npolf == 1 && store != 1))
    return cudaErrorInvalidValue;
  if (pb && (err = cudaMemsetAsync(
                 pb, 0, (size_t)nchan * npolf * R1 * R2 * sizeof(float),
                 stream)) != cudaSuccess)
    return err;
  if (npolf == 2) {
    if ((err = cudaMemsetAsync(psum, 0, (size_t)nchan * npart * 2 * sizeof(float),
                               stream)) != cudaSuccess)
      return err;
    const int two_n = R1 * row_len;
    const int chunks = two_n >= 8192 ? two_n / 8192 : 1;
    mega_polpow<<<dim3(chunks, npart, nchan), kThreads, 0, stream>>>(
        (const uint8_t*)raw, (float*)psum, nchan, npol, npart, nsamp_step,
        two_n, twos, scale, offset);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  auto fwd1 = R1 >= 16 ? &mega_fwd1<16> : &mega_fwd1<8>;
  auto fwd2 = row_len >= 16 ? &mega_fwd2<16> : &mega_fwd2<8>;
  const int smem1 = fwd_smem_bytes(0, R1, row_len, tc);
  const int smem2 = fwd_smem_bytes(1, R1, row_len, tk);
  if ((err = cudaFuncSetAttribute(fwd1,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem1)) != cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(fwd2,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem2)) != cudaSuccess)
    return err;
  fwd1<<<dim3(row_len / tc, npart, nchan),
         transform_threads(0, R1, row_len, M, tc), smem1, stream>>>(
      (const uint8_t*)raw, (float2*)cbuf, (const float*)psum, tb, nchan, npol,
      pol0, npolf, npart, R1, row_len, nsamp_step, tc, twos, scale, offset);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  fwd2<<<dim3(R1 / (2 * tk), npart, nchan),
         transform_threads(1, R1, row_len, M, tk), smem2, stream>>>(
      (const float2*)cbuf, (float2*)ybuf, (const float*)gr, (const float*)gi,
      (const float*)psum, (float*)pb, tb, npolf, store, npart, R1, R2,
      row_len, tk);
  return cudaGetLastError();
}

}  // namespace
