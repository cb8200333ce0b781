// Device code shared by the fused fold step (megastep.cu) and the fused
// search front end (megafil.cu): register-resident FFTs, the forward half of
// the four-step transform, and detection.
//
// Real-sampled input.  The forward transform of one overlap-save window of
// 2N real samples (N = nsub * freq_res = R1 * R2, row_len = 2 * R2) is a
// four-step FFT with n = n1*row_len + m and k = k2*R1 + k1.  It runs in two
// passes through device memory, once per (input channel, window):
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
//                At R2 = 8192 (rows of 16384 points) a row pair fits no
//                CTA: the long row pass (mega_rowfft, mega_rowpair, see
//                there) replaces it.
//
// Complex (analytic) input.  Each pol is already a complex sequence of N
// samples, so nothing is packed and there is no mega_polpow: row_len = R2,
// and the passes run once per (input channel, pol, window):
//   mega_fwd1<P, kComplexTfp>  per (channel, pol, window, tile of columns
//                m < R2):
//                load each sample's (re, im) byte pair (2 bytes per pol, 4
//                per time sample with two pols), length-R1 FFT over n1,
//                twiddle exp(-2 pi i m k1 / N), store C[k1, m].
//   mega_fwd2c   per (channel, pol, window, tile of rows k1): length-R2 FFT
//                of each row, every column kept; bin k = k2*R1 + k1 goes to
//                the centred natural index j = ((k2 + R2/2) mod R2)*R1 + k1
//                (fftshift: natural bin j is FFT bin (j + N/2) mod N, the
//                JAX package's order), where the passband tap and the chirp
//                are read too.  Subband s is then the slice [s*M, (s+1)*M)
//                of the stored spectrum, as for real input, so the inverse
//                kernels read it unchanged.  From R2 = kClusterR2 the same
//                pass runs as mega_fwd2cc, one row a CTA in clusters (item
//                7).
// Both forms compute the inter-stage twiddle exp(-2 pi i m k1 / (R1 *
// row_len)) from the same tables: R1 * row_len is 2N for real input and N
// for complex input.
//
// Byte layouts (real input).  TFP: sample (t, c, pol) at (t*nchan + c)*npol
// + pol.  CASPSR (one channel): four consecutive samples of each pol
// together, sample (t, pol) at (t/4)*npol*4 + pol*4 + t%4; mega_polpow and
// mega_fwd1<P, kRealCaspsr> read that index directly, so the layout costs
// no pass.  TFP input with nchan > 1 first goes through the pre-pass
// mega_ftp (item 6), after which every channel is a one-channel TFP stream
// of its own.
// launch_forward() sets the shared-memory limits and launches the passes.
//
// Code kinds (Code, a template parameter of mega_polpow and mega_fwd1, as
// Layout is, so that the unrolled loads carry no branch on it): 8-bit
// bytes (the loads above); fixed-level 1/2/4-bit fields, code i of the
// TFP stream in byte i / (8/nbit) at shift (8/nbit - 1 - i mod
// (8/nbit))*nbit (most significant first), two's-complement fields wrapped
// to the signed value, then code * scale + offset; float32 samples; and
// JA98 2-bit (Jenet & Anderson 1998 dynamic levels), value sign * (code is
// 1 or 2 ? lo : hi)[nlow] with sign + for codes 2 and 3.  nlow, the count
// of codes 1 and 2 in the sample's npw-sample block of its digitizer
// (channel, pol, dim), comes from the pre-pass mega_ja98, which reads the
// codes once (a byte's fields are low exactly where ((b >> 1) ^ b) & 0x55
// has their low bit), writes nlow as uint16 [nchan*npol*ndim, nweights]
// and each channel's block weight (the least of weight[nlow] over its
// digitizers); mega_ja98_windows then gives each window the least block
// weight over its span (any excised block zeroes the window).  The
// weights are 0 or 1, so they equal the plain version's exactly.  The lo,
// hi and weight tables (npw + 1 floats each) are read with __ldg.  A
// mega_guppi_2bit block (32 complex dual-pol channels, 16 windows of
// 131,072 samples) holds 66 MB of codes: mega_ja98 reads them once.
//
// Apodization: the taper, float[nsamp_fft] in sample order, multiplies the
// unpacked samples of each window in mega_fwd1 (sample n = n1*row_len + m
// of the window; both pols of a packed real sequence, both parts of a
// complex sample).  mega_polpow's energies are of the unwindowed samples;
// both forward passes read the same ones, so they only set pol b's
// power-of-two scale.
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
// 6. Multi-channel TFP codes (mega_ftp, mega_ftpw; for JA98 codes
//    mega_ja98), for build_megastep's and build_megafil's forward half.  A
//    TFP time row holds every channel's codes (128 bytes for hybrid_conv32's
//    32 complex dual-pol 8-bit channels, 32 for mega_guppi_2bit's 2-bit
//    ones), and mega_fwd1 transforms one (channel, pol) sequence a CTA, so
//    reading TFP in place put each 2-byte (or sub-byte) load alone in its
//    32-byte sector, and the 64 CTAs that wanted the same sectors ran far
//    apart: mega_fwd1 took 3.29 ms a hybrid_conv32 block for 1.3 GB (0.40
//    TB/s) and 3.43 ms a mega_guppi_2bit one (H100, 700 W).  The JAX
//    package first transposes [T, ndig] -> [ndig, T] (_prepare_input); so
//    does the pre-pass, as a tile transpose in shared memory with 16-byte
//    loads and stores (a tile of up to 256 samples and 512 bytes of
//    channels; lane pairs store the two halves of each 32-byte sector),
//    into a copy [nchan, tp, unit] in which every channel is a one-channel
//    TFP stream (sub-byte units widened to a byte a code), which
//    mega_polpow and mega_fwd1 read as they read one channel.  For JA98
//    codes mega_ja98, which reads every byte of the block into shared
//    memory anyway, stores the same copy.  mega_fwd1's grid runs the
//    sequences of a channel next to each other, so its pols share their
//    sectors in L2, and for JA98 it reads each (row, block)'s levels from a
//    table it fills in shared memory (the per-sample nlow and level
//    lookups spilled 240 bytes a thread at the 128-register cap).
//    Measured (H100, 700 W): hybrid_conv32 mega_ftp 0.17 ms (2.9 TB/s) +
//    mega_fwd1 1.56 ms (0.84 TB/s, the one-channel rate at R1 = 1024);
//    mega_guppi_2bit mega_ja98 0.09 ms + mega_fwd1 1.38 ms.  Not kept: the
//    sequence-first grid alone on the TFP bytes, 2.01 and 1.93 ms.
// 7. Long complex rows (mega_fwd2cc).  At R2 >= 4096 a mega_fwd2c tile
//    holds fewer than 4 rows (a row is 256-512 threads), so its stores of
//    the centred bin index, which runs over consecutive k1, came in runs of
//    1-2 bins.  Clusters of 4 one-row CTAs exchange their rows through
//    distributed shared memory and store runs of 4 k1 (32 bytes), reading
//    the chirp and adding the passband in the same runs; two CTAs an SM by
//    registers (64 a thread) instead of one.  Measured at
//    mega_analytic_j0613 (R2 = 8192, H100, 700 W): 2.40 ms against 4.49 for
//    mega_fwd2c; without the stores (a measurement only) 1.91 ms: the
//    load, the 4-pass FFT of a 64 KB row and the exchange now take most of
//    it.  Not kept: clusters of 8 (2.56 ms) or 16 (4.6 ms, one CTA an SM),
//    and the cluster form at R2 <= 2048 (hybrid_conv32 3.12 ms, guppi 4.57,
//    against the row tile's 1.55 and 1.11).
// 8. The multi-pass inverse's pass A (mega_inva, both kernels) and
//    build_megafil's pass B (megafil_invb, megafil.cu), for freq_res past
//    one CTA.  Both move 1-2 GB a block and ran at 1.0-1.6 TB/s with
//    nothing in flight during their FFTs.  Pass A walks 16-column (and
//    wider) boxes with one persistent CTA an SM and a ring of 3 cp.async
//    stages, transforms in place and twiddles by recurrence.  Pass B keeps
//    its form (two CTAs an SM overlap one's loads with the other's
//    transform; its bulk-copy form measured slower) and takes 8 rows for
//    four detected planes.  The notes above mega_inva and megafil_invb give
//    the times and what was not kept.
// 9. The bit reversal of the radix-8 butterflies (dft<8>) is a renaming of
//    registers at compile-time indices (bitrev_regs).  Written as a loop
//    over brev, which was left unrolled for R = 8, it put the 8 points in a
//    64-byte local array, stored and reloaded in every radix-8 butterfly
//    (SASS: STL.64 and LDL.64 in each pass that has radix 8: 512 =
//    16*8*4, 1024 = 16*8*8).  Removing it (H100, 700 W, per block):
//    mega_fwd1 0.40 -> 0.28 ms on the flagship, 1.56 -> 1.11 at
//    hybrid_conv32; mega_rowfft 1.87 -> 1.02; mega_invbfold 1.48 -> 1.01
//    at J0613; megafil_invb 1.16 -> 0.75; mega_invfold 1.44 -> 1.23 on
//    mega_guppi_2bit, but 0.272 -> 0.278-0.282 on the flagship; the
//    flagship fold step 1.23 -> 1.07-1.08.
// 10. The long row pass's row FFT (mega_rowfft) over a cluster of two
//    CTAs, half a row each: a 16384-point row in one CTA took 139 KB and
//    ran one CTA an SM, its load, transform and store one after another
//    (1.02 ms a J0613-0200 block against torch.fft.fft's 0.81).  Two
//    69 KB half-row CTAs an SM overlap one's loads with the other's
//    transform; the first radix-2 stage is exchanged through distributed
//    shared memory, and the half length is a template parameter, so that
//    the passes unroll and nothing spills (0.87 ms; the note above
//    mega_rowfft gives the split and what was not kept).
// 11. mega_ja98's counts and copy (see the note above it): at
//    mega_guppi_2bit's 32 channels of one byte a sample, 128-thread CTAs of
//    4 blocks transpose 4x4 byte blocks in registers from word loads of a
//    padded tile and count the low codes in nibble lanes of the
//    transposed words (0.058 ms a block against 0.086 for byte loads and
//    a count a byte; H100 80GB HBM3, 700 W).
//
// The multi-pass inverse's pass A (mega_inva, for a subband inverse past
// one CTA), which both kernels run, lives here too; see item 8 and the note
// above it.
//
// Each library that includes this header is its own translation unit and
// shared object, so everything here has internal linkage.

#pragma once

#include <cooperative_groups.h>
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

// Points each thread holds in a length-L transform: 16, or below 16 points
// the whole sequence (one pass, no shared memory).  Pass A of the
// multi-pass inverse has lengths q down to 1, the complex row pass R2 = 4.
__host__ __device__ constexpr int fft_points(int L) { return L >= 16 ? 16 : L; }

// Points each thread holds in the long row pass (mega_rowfft): 32, so that
// half a row of 8192 points takes 256 threads, or at half rows of 16
// points (the shortest) all 16.
constexpr int kRowPoints = 32;
__host__ __device__ constexpr int row_points(int H) {
  return H >= kRowPoints ? kRowPoints : H;
}

__host__ __device__ constexpr int ilog2c(int x) {
  return x <= 1 ? 0 : 1 + ilog2c(x >> 1);
}

// Bit reversal of i over `bits` bits.
__host__ __device__ __forceinline__ constexpr int brev(int i, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((i >> b) & 1) << (bits - 1 - b);
  return r;
}

// x[i] = y[brev(i)] for i = I .. R-1.  Each index is a constant expression,
// so the renaming is of registers: called as a loop, brev's own loop was
// left in the code for R = 8, and y went to a 64-byte local array, stored
// and reloaded in every radix-8 butterfly.
template <int R, int I = 0>
__device__ __forceinline__ void bitrev_regs(float2 (&x)[R],
                                            const float2 (&y)[R]) {
  if constexpr (I < R) {
    constexpr int b = brev(I, ilog2c(R));
    x[I] = y[b];
    bitrev_regs<R, I + 1>(x, y);
  }
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
// bit-reversal as a renaming of registers (bitrev_regs).
template <int R, int DIR>
__device__ __forceinline__ void dft(float2 (&x)[R]) {
  dif_stages<R, R / 2, DIR>(x);
  float2 y[R];
#pragma unroll
  for (int i = 0; i < R; ++i) y[i] = x[i];
  bitrev_regs(x, y);
}

// Bits of pass s of a length-2^logL transform whose radix is at most 2^lgP
// (lgP = log2 of the points a thread holds, capped at 4): the first pass is
// radix 2^lgP, the rest split the remaining bits as evenly as possible,
// larger first (512 = 16*8*4, 1024 = 16*8*8, 4096 = 16*16*16).
__host__ __device__ constexpr int pass_bits(int s, int logL, int lgP) {
  if (s == 0) return lgP;
  const int rem = logL - lgP;
  const int n = (rem + lgP - 1) / lgP;
  return rem / n + (s - 1 < rem % n ? 1 : 0);
}

__host__ __device__ constexpr int num_passes(int logL, int lgP) {
  return 1 + (logL - lgP + lgP - 1) / lgP;
}

// Where element i of a sequence lies in shared memory, from the sequence's
// start: the padded layout (PadIdx), or a column of a row-major tile of S
// columns (ColIdx: element i at i*S, as mega_inva lands its boxes).
struct PadIdx {
  __device__ __forceinline__ int operator()(int i) const { return sidx(i); }
};
struct ColIdx {
  int S;
  __device__ __forceinline__ int operator()(int i) const { return i * S; }
};

// One Stockham pass of radix R over one sequence: thread j runs the P/R
// butterflies b = j + u*T on its registers, whose v[i] holds element
// j + T*i of the pass input.  A butterfly reads b + r*L/R, applies
// exp(DIR 2 pi i k r / (Ns R)) with k = b mod Ns, transforms, and writes
// (b/Ns)*Ns*R + k + r*Ns to shared memory at seq + idx(position) (on the
// last pass that is the natural position b + r*L/R), or, when to_regs, back
// into the registers it came from.  The twiddle of (k, r) is
// tw[(r-1)*Ns + k] of this pass's table, so the lanes of a warp
// (consecutive k) read consecutive entries.
template <int P, int R, int DIR, class Idx = PadIdx>
__device__ __forceinline__ void fft_pass(float2 (&v)[P], float2* seq, int j,
                                         int T, int Ns, bool to_regs,
                                         const float2* __restrict__ tw,
                                         Idx idx = Idx()) {
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
      for (int r = 0; r < R; ++r) seq[idx(base + r * Ns)] = x[r];
    }
  }
}

// NS length-L FFTs (L = 2^logL, sign DIR, unscaled), P points a thread, T =
// L/P threads j = 0..T-1 on each.  load(q, v) fills v[i] with element
// j + T*i of sequence q.  Sequence q exchanges through shared memory at
// seq + q*seq_stride (seq_ld(L) float2) and, unless KEEP, ends there in
// natural order, X[t] at idx(t), after a closing barrier.  With KEEP (one
// sequence) the result stays in v: v[i] = X[j + T*i].  The sequences are
// walked in turn within each pass, so a thread holds P points at a time;
// the barrier after one sequence's reads also orders the previous one's
// writes.  tw is the length-L table: for each pass s >= 1 in turn,
// (R_s - 1)*Ns_s entries exp(-2 pi i k r / (Ns_s R_s)) at (r-1)*Ns_s + k
// (L - P entries in all).  Every thread of the block calls it.  With P = 32
// (as the long row pass's fft_keep runs) no pass is wider than radix 16: a
// thread runs two butterflies a pass, and the passes (and so the tables)
// are those of P = 16.  idx places an element of a sequence (PadIdx, or
// ColIdx for a column of a tile).
template <int P, int NS, int DIR, bool KEEP, class Load, class Idx = PadIdx>
__device__ __forceinline__ void fft_seqs(float2 (&v)[P], Load load,
                                         float2* seq, int seq_stride, int j,
                                         int L, int logL,
                                         const float2* __restrict__ tw,
                                         Idx idx = Idx()) {
  static_assert(!KEEP || NS == 1, "KEEP holds one sequence");
  constexpr int lgP = ilog2c(P) > 4 ? 4 : ilog2c(P);
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
        for (int i = 0; i < P; ++i) v[i] = sq[idx(j + T * i)];
        __syncthreads();
      }
      switch (bits) {
        case 1: fft_pass<P, 2, DIR>(v, sq, j, T, Ns, to_regs, tw, idx); break;
        case 2: fft_pass<P, 4, DIR>(v, sq, j, T, Ns, to_regs, tw, idx); break;
        case 3: fft_pass<P, 8, DIR>(v, sq, j, T, Ns, to_regs, tw, idx); break;
        default:
          if constexpr (P >= 16)
            fft_pass<P, 16, DIR>(v, sq, j, T, Ns, to_regs, tw, idx);
          break;
      }
    }
    if (s > 0) tw += ((1 << bits) - 1) * Ns;
    Ns <<= bits;
  }
  if (!KEEP) __syncthreads();
}

// fft_seqs for one sequence of a length L known at compile time, the
// result kept in registers (v[i] = X[j + T*i] on return, T = L/P), v
// holding the input already: the passes unrolled, so that every radix,
// span and table offset is a constant, and the barriers those of fft_seqs.
template <int P, int DIR, int L, int S = 0, int NSP = 1>
__device__ __forceinline__ void fft_keep(float2 (&v)[P], float2* seq, int j,
                                         const float2* __restrict__ tw) {
  constexpr int lgP = ilog2c(P) > 4 ? 4 : ilog2c(P);
  constexpr int np = num_passes(ilog2c(L), lgP);
  constexpr int bits = pass_bits(S, ilog2c(L), lgP);
  constexpr int T = L / P;
  if constexpr (S > 0) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < P; ++i) v[i] = seq[sidx(j + T * i)];
    __syncthreads();
  }
  fft_pass<P, (1 << bits), DIR>(v, seq, j, T, NSP, S == np - 1, tw);
  if constexpr (S + 1 < np)
    fft_keep<P, DIR, L, S + 1, NSP * (1 << bits)>(
        v, seq, j, S > 0 ? tw + ((1 << bits) - 1) * NSP : tw);
}

__device__ __forceinline__ float unpack(uint8_t byte, int twos, float scale,
                                        float offset) {
  const float code = twos ? (float)(int8_t)byte : (float)byte;
  return code * scale + offset;
}

// Byte layouts of the raw codes: real TFP, real CASPSR, complex TFP (the
// wrappers' layout codes, and a template parameter of mega_fwd1, so that
// its unrolled loads carry no branch).
enum Layout { kRealTfp = 0, kRealCaspsr = 1, kComplexTfp = 2 };

// Code kinds of the raw input (the wrappers' code_kind; see the note at the
// top): 8-bit, fixed-level 1-, 2- and 4-bit, JA98 2-bit, float32; and, read
// only from the channel-transposed copy (mega_ftp), JA98 2-bit codes widened
// to one byte each.
enum Code {
  kCode8 = 0, kCode1 = 1, kCode2 = 2, kCode4 = 3, kCodeJA98 = 4, kCodeF32 = 5,
  kCodeJA98W = 6
};

// Bits of a code of kind `code`.
__host__ __device__ inline int code_bits(int code) {
  switch (code) {
    case kCode1: return 1;
    case kCode2: case kCodeJA98: return 2;
    case kCode4: return 4;
    case kCodeF32: return 32;
    default: return 8;
  }
}

// How the first pass turns codes into samples.
struct Unpack {
  int twos;              // two's-complement codes (8, 4 or 2 bits)
  float scale, offset;   // fixed levels: value = code * scale + offset
  const float* window;   // the apodization taper float[nsamp_fft], or null
  const float* tables;   // JA98: lo[npw + 1], hi[npw + 1], weight[npw + 1]
  const uint16_t* nlow;  // JA98: low-state counts [nchan*npol*ndim, nweights]
  int npw1;              // npw + 1
  int lg_npw;            // log2(npw)
  int nweights;          // npw-sample blocks in the block of raw input
};

// Field of code i of a stream of NBIT-bit codes, the most significant first.
template <int NBIT>
__device__ __forceinline__ int code_field(const uint8_t* __restrict__ raw,
                                          long long i) {
  constexpr int lg = NBIT == 1 ? 3 : (NBIT == 2 ? 2 : 1);  // log2(8 / NBIT)
  constexpr int per = 1 << lg;
  const int b = __ldg(raw + (i >> lg));
  return (b >> ((per - 1 - (int)(i & (per - 1))) * NBIT)) & ((1 << NBIT) - 1);
}

// Sample value of code i (digitizer dig, time sample t of the block) for
// code kind CODE.
template <int CODE>
__device__ __forceinline__ float load_code(const uint8_t* __restrict__ raw,
                                           long long i, long long dig,
                                           long long t, const Unpack& u) {
  if constexpr (CODE == kCode8) {
    return unpack(raw[i], u.twos, u.scale, u.offset);
  } else if constexpr (CODE == kCodeF32) {
    return __ldg(reinterpret_cast<const float*>(raw) + i);
  } else if constexpr (CODE == kCodeJA98 || CODE == kCodeJA98W) {
    const int code = CODE == kCodeJA98 ? code_field<2>(raw, i) : raw[i];
    const int nl = __ldg(u.nlow + dig * u.nweights + (t >> u.lg_npw));
    const float mag =
        __ldg(u.tables + ((code == 1 || code == 2) ? 0 : u.npw1) + nl);
    return code >= 2 ? mag : -mag;
  } else {
    constexpr int NBIT = CODE == kCode1 ? 1 : (CODE == kCode2 ? 2 : 4);
    int v = code_field<NBIT>(raw, i);
    if (u.twos && v >= (1 << (NBIT - 1))) v -= 1 << NBIT;
    return (float)v * u.scale + u.offset;
  }
}

// Greatest common divisor of n and 4.
__host__ __device__ inline int gcd4(int n) {
  return (n & 3) == 0 ? 4 : ((n & 1) == 0 ? 2 : 1);
}

// The channel-transposing pre-pass (see item 6 at the top).  A TFP block
// with nchan > 1 is [T, nchan, unit] with unit one channel's npd = npol *
// ndim codes of a time sample; the copy is [nchan, tp, unit], channel c's
// stream at (c * tp) units, tp = T rounded up to kFtpAlign samples so that
// every stream starts on a 16-byte boundary.  Where a unit is less than a
// byte (npd * nbit < 8) each code is widened to a byte.  mega_polpow and
// mega_fwd1 then read channel c as a one-channel TFP stream.
constexpr int kFtpAlign = 16;      // samples: a channel stream's alignment
constexpr int kFtpTile = 32768;    // bytes of a pre-pass tile at most
constexpr int kFtpRow = 512;       // bytes of a tile's row segment at most

__host__ __device__ inline long long ftp_stride(long long T) {
  return (T + kFtpAlign - 1) / kFtpAlign * kFtpAlign;
}

// Row stride in shared memory of a tile whose rows hold `seg` bytes:
// rounded up to 16 bytes, plus 16, so that the two lanes that assemble the
// halves of one 32-byte output sector read rows 16 bytes of banks apart.
__host__ __device__ inline int ftp_ld(int seg) {
  return ((seg + 15) & ~15) + 16;
}

// Copy `rows` rows of `seg` bytes, `stride` bytes apart in device memory,
// to shared memory `ld` bytes apart: 16-byte loads where the source allows
// them, else bytes.
__device__ __forceinline__ void load_rows(uint8_t* dst, int ld,
                                          const uint8_t* __restrict__ src,
                                          long long stride, int rows,
                                          int seg) {
  if ((((uintptr_t)src | (uintptr_t)stride | (uintptr_t)seg) & 15) == 0) {
    const int nq = seg >> 4;
    for (int i = threadIdx.x; i < rows * nq; i += blockDim.x) {
      const int r = i / nq;
      const int q = i - r * nq;
      *reinterpret_cast<uint4*>(dst + r * ld + 16 * q) =
          __ldg(reinterpret_cast<const uint4*>(src + r * stride) + q);
    }
  } else {
    for (int i = threadIdx.x; i < rows * seg; i += blockDim.x) {
      const int r = i / seg;
      const int b = i - r * seg;
      dst[r * ld + b] = __ldg(src + r * stride + b);
    }
  }
}

// Copy n contiguous bytes to shared memory: 16-byte loads for the body
// when the source is aligned, bytes for the rest.
__device__ __forceinline__ void load_span(uint8_t* dst,
                                          const uint8_t* __restrict__ src,
                                          int n) {
  const int nq = ((uintptr_t)src & 15) == 0 ? n >> 4 : 0;
  for (int i = threadIdx.x; i < nq; i += blockDim.x)
    reinterpret_cast<uint4*>(dst)[i] =
        __ldg(reinterpret_cast<const uint4*>(src) + i);
  for (int i = 16 * nq + threadIdx.x; i < n; i += blockDim.x)
    dst[i] = __ldg(src + i);
}

template <int E> struct UnitType;
template <> struct UnitType<1> { using T = uint8_t; };
template <> struct UnitType<2> { using T = uint16_t; };
template <> struct UnitType<4> { using T = uint32_t; };
template <> struct UnitType<8> { using T = uint2; };
template <> struct UnitType<16> { using T = uint4; };

// Output vector v of channel c for thread item i: lane pairs take the two
// 16-byte halves of one 32-byte sector, consecutive pairs consecutive
// channels.
__device__ __forceinline__ void ftp_item(int i, int cc, int* c, int* v) {
  *c = (i >> 1) % cc;
  *v = 2 * ((i >> 1) / cc) + (i & 1);
}

// Store a tile of E-byte units to the copy: tile row r (time sample t0 + r,
// r < tt) holds channels c0 .. c0 + cc - 1 at (c - c0) * E, rows ld bytes
// apart; channel c's unit of time t goes to ftp + (c * tp + t) * E.  Each
// thread assembles 16 bytes (16 / E samples of one channel) and stores them
// with one 16-byte store.
template <int E>
__device__ __forceinline__ void store_units(const uint8_t* tile, int ld,
                                            uint8_t* __restrict__ ftp,
                                            long long tp, long long t0,
                                            int tt, int c0, int cc) {
  using U = typename UnitType<E>::T;
  constexpr int per = 16 / E;
  const int nv = (tt + per - 1) / per;
  const int nitems = cc * 2 * ((nv + 1) >> 1);
  for (int i = threadIdx.x; i < nitems; i += blockDim.x) {
    int c, v;
    ftp_item(i, cc, &c, &v);
    if (v >= nv) continue;
    const int r0 = v * per;
    uint8_t* dst = ftp + ((long long)(c0 + c) * tp + t0 + r0) * E;
    const uint8_t* src = tile + r0 * ld + c * E;
    if (r0 + per <= tt && ((uintptr_t)dst & 15) == 0) {
      union { uint4 q; U u[per]; } x;
#pragma unroll
      for (int k = 0; k < per; ++k)
        x.u[k] = *reinterpret_cast<const U*>(src + k * ld);
      *reinterpret_cast<uint4*>(dst) = x.q;
    } else {
      const int n = (tt - r0 < per ? tt - r0 : per) * E;
      for (int b = 0; b < n; ++b) dst[b] = src[(b / E) * ld + b % E];
    }
  }
}

// Store a tile of NBIT-bit codes widened to a byte each: the tile holds
// time samples t0 .. t0 + tt - 1 of all nchan channels as one span of
// codes, the most significant first, code ((r * nchan + c) * npd + d) for
// row r; channel c's code d of time t goes to byte (c * tp + t) * npd + d.
// Two's-complement fields (twos) are stored sign-extended, so that the
// kernels read them as 8-bit codes; JA98 fields (twos 0) as they are.
template <int NBIT>
__device__ __forceinline__ void store_widened(const uint8_t* span, int nchan,
                                              int npd, int twos,
                                              uint8_t* __restrict__ ftp,
                                              long long tp, long long t0,
                                              int tt) {
  constexpr int lg = NBIT == 1 ? 3 : (NBIT == 2 ? 2 : 1);  // log2(8 / NBIT)
  constexpr int per = 1 << lg;
  const int nb = tt * npd;  // bytes of a channel in this tile
  const int nv = (nb + 15) >> 4;
  const int nitems = nchan * 2 * ((nv + 1) >> 1);
  for (int i = threadIdx.x; i < nitems; i += blockDim.x) {
    int c, v;
    ftp_item(i, nchan, &c, &v);
    if (v >= nv) continue;
    const int b0 = 16 * v;
    const int n = nb - b0 < 16 ? nb - b0 : 16;
    uint8_t* dst = ftp + ((long long)c * tp + t0) * npd + b0;
    union { uint4 q; uint8_t b[16]; } x;
    for (int k = 0; k < n; ++k) {
      const int r = (b0 + k) / npd;
      const int idx = (r * nchan + c) * npd + (b0 + k - r * npd);
      int f = (span[idx >> lg] >> ((per - 1 - (idx & (per - 1))) * NBIT)) &
              ((1 << NBIT) - 1);
      if (twos && f >= (1 << (NBIT - 1))) f -= 1 << NBIT;
      x.b[k] = (uint8_t)f;
    }
    if (n == 16 && ((uintptr_t)dst & 15) == 0) {
      *reinterpret_cast<uint4*>(dst) = x.q;
    } else {
      for (int k = 0; k < n; ++k) dst[k] = x.b[k];
    }
  }
}

// The pre-pass for units of E whole bytes: one CTA per tile of TT time
// samples and CC channels (grid: time tiles, channel tiles).
template <int E>
__global__ void __launch_bounds__(kThreads)
mega_ftp(const uint8_t* __restrict__ raw, uint8_t* __restrict__ ftp,
         long long T, int nchan, long long tp, int TT, int CC) {
  extern __shared__ uint4 ftp_sm[];
  uint8_t* tile = reinterpret_cast<uint8_t*>(ftp_sm);
  const long long t0 = (long long)blockIdx.x * TT;
  const int c0 = blockIdx.y * CC;
  const int tt = T - t0 < TT ? (int)(T - t0) : TT;
  const int cc = nchan - c0 < CC ? nchan - c0 : CC;
  const int ld = ftp_ld(CC * E);
  const long long rb = (long long)nchan * E;
  load_rows(tile, ld, raw + t0 * rb + (long long)c0 * E, rb, tt, cc * E);
  __syncthreads();
  store_units<E>(tile, ld, ftp, tp, t0, tt, c0, cc);
}

// The pre-pass for units of less than a byte (NBIT-bit codes, npd * NBIT <
// 8): one CTA per tile of TT time samples of every channel, a whole number
// of bytes (TT a multiple of 8).
template <int NBIT>
__global__ void __launch_bounds__(kThreads)
mega_ftpw(const uint8_t* __restrict__ raw, uint8_t* __restrict__ ftp,
          long long T, int nchan, int npd, int twos, long long tp, int TT) {
  extern __shared__ uint4 ftp_sm[];
  uint8_t* span = reinterpret_cast<uint8_t*>(ftp_sm);
  const long long t0 = (long long)blockIdx.x * TT;
  const int tt = T - t0 < TT ? (int)(T - t0) : TT;
  const long long rowbits = (long long)nchan * npd * NBIT;
  load_span(span, raw + t0 * rowbits / 8, (int)((tt * rowbits + 7) / 8));
  __syncthreads();
  store_widened<NBIT>(span, nchan, npd, twos, ftp, tp, t0, tt);
}

// Shared-memory address of a generic pointer to shared memory.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Asynchronous copies global -> shared of 16 bytes (L2 only) or 8 bytes,
// committed as one group a call of cp_commit; cp_wait(n) returns once at
// most n of this thread's groups are pending (n < 3).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait(int n) {
  if (n <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
}

// The JA98 pre-pass (see the note at the top): one CTA per kJa98Blocks
// consecutive npw-sample blocks, streamed in chunks of TT samples (cb =
// TT*ndig/4 bytes, TT dividing npw): each chunk is staged in shared memory
// with 16-byte cp.async copies while the chunk before it is counted (two
// buffers, one barrier a chunk).  The counts come from 32-bit words of one
// channel's code stream, in which every field of a word belongs to a
// digitizer known from its position alone: with nchan > 1 the
// channel-transposed copy's words as the chunk is stored to it (mega_ftp's
// layout: whole bytes when a channel's codes of a sample fill one, else
// widened), with one channel the staged words themselves.  Where channels
// of one byte a sample come in a power of two of 16 to 128 (ja98_group;
// mega_guppi_2bit's 32) the word path ja98_rows4 transposes 4x4 byte
// blocks in registers and counts in nibble lanes; elsewhere a popc a
// digitizer and word counts (ja98_count) and lane pairs that hold one
// channel add their counts with a shuffle.  The counts of the CTA's blocks
// stay in shared memory ([kJa98Blocks][ndig | 1] words) until the end,
// when nlow[dig, blk] and wblk[c, blk] (the least of weight[nlow] over
// channel c's nd_chan digitizers) go out as runs of the CTA's blocks.
// Counts, weights and copy are integers and bytes, equal to the plain
// version's.  Measured a mega_guppi_2bit block (H100 80GB HBM3, 700 W):
// 0.058 ms (2.31 TB/s for its 135 MB) against the parent's 0.086 (one
// 256-thread CTA a block, the count a byte at a time from shared memory,
// the copy gathered a byte at a time); without the count 0.058, the
// parent's without its count 0.063.  Not kept: the copy gathered a byte at
// a time with a popc count (0.086-0.100 at 2-4 stages, 2-8 blocks a CTA,
// 4-8 CTAs an SM); one block a CTA (0.064); 8 blocks and 3 stages (0.063).
constexpr int kJa98Blocks = 4;
constexpr int kJa98Stages = 2;  // chunks in shared memory (1 in flight)
constexpr int kJa98Threads = 128;
constexpr int kJa98MinBlocks = 8;  // CTAs an SM (the register cap)

// Low-state bits of the 16 two-bit fields of a word: bit 2f is set where
// field f holds code 1 or 2.  Widened codes (a byte a code, 0..3) leave
// their bit in bit 0 of each byte.
__device__ __forceinline__ unsigned ja98_low(unsigned w) {
  return ((w >> 1) ^ w) & 0x55555555u;
}

// The low-bit mask of digitizer d (d < nd, else 0) in a word of one
// channel's stream: packed units (4 codes a byte, field f of every byte of
// digitizer f mod nd, the most significant field first) or widened ones
// (byte p of the word of digitizer p mod nd).
__device__ __forceinline__ unsigned ja98_mask(int d, int nd, bool widened) {
  unsigned m = 0u;
  if (d < nd) {
    if (widened)
      for (int p = d; p < 4; p += nd) m |= 1u << (8 * p);
    else
      for (int f = d; f < 4; f += nd) m |= 0x01010101u << (6 - 2 * f);
  }
  return m;
}

__device__ __forceinline__ void ja98_count(unsigned w,
                                           const unsigned (&mask)[4],
                                           unsigned (&n)[4]) {
  const unsigned low = ja98_low(w);
#pragma unroll
  for (int d = 0; d < 4; ++d) n[d] += __popc(low & mask[d]);
}

// Add the counts n of one channel (nd digitizers at cnt) held by a lane
// pair: the pair's sum by one shuffle, then digitizer d from the lane of
// its parity.  Both lanes of the pair call it.
__device__ __forceinline__ void ja98_add(unsigned* cnt, int nd,
                                         unsigned (&n)[4]) {
  const int lane = threadIdx.x & 31;
  const unsigned pair = 3u << (lane & 30);
  const int h = lane & 1;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    n[d] += __shfl_xor_sync(pair, n[d], 1);
    if (d < nd && (d & 1) == h) atomicAdd(cnt + d, n[d]);
  }
}

// The word path of the copy (ja98_rows4): channels of one byte a sample
// (nd_chan == 4), 4 ncw of them with ncw a power of two from 4 to 32, and
// chunks of whole 16-sample vectors.  Its chunks are staged with kJa98Pad
// bytes after every 16 rows (gsize = 16*nchan bytes), so that the lanes of
// a warp that read one word column of 4 consecutive row groups fall in
// other banks.  ja98_group gives gsize, or 0 for no pad.
constexpr int kJa98Pad = 32;
__host__ __device__ inline int ja98_group(int nchan, int nd_chan, int TT,
                                          bool copy) {
  const int ncw = nchan >> 2;
  return copy && nd_chan == 4 && (nchan & 3) == 0 && ncw >= 4 &&
                 ncw <= 32 && (ncw & (ncw - 1)) == 0 && TT % 16 == 0
             ? 16 * nchan
             : 0;
}

// Bytes of one staged chunk of cb bytes (gsize as ja98_group), a multiple
// of 16.
__host__ __device__ inline int ja98_chunk_bytes(int cb, int gsize) {
  return ((cb + 15) & ~15) + (gsize ? cb / gsize * kJa98Pad : 0);
}

// Stage n contiguous bytes in shared memory (a pad of kJa98Pad bytes after
// every gsize, when gsize is not 0): 16-byte cp.async copies when the
// source allows them, else plain byte copies; one commit either way.
__device__ __forceinline__ void ja98_stage(uint8_t* dst,
                                           const uint8_t* __restrict__ src,
                                           int n, int gsize) {
  if ((((uintptr_t)src | (uintptr_t)n) & 15) == 0) {
    for (int i = threadIdx.x; i < (n >> 4); i += blockDim.x) {
      const int o = 16 * i;
      cp_async16(dst + o + (gsize ? o / gsize * kJa98Pad : 0), src + o);
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      dst[i + (gsize ? i / gsize * kJa98Pad : 0)] = __ldg(src + i);
  }
  cp_commit();
}

// Sum of the 4 bytes of x.
__device__ __forceinline__ unsigned hsum4(unsigned x) {
  return (x * 0x01010101u) >> 24;
}

// One chunk of tt time samples of the word path (see ja98_group), staged
// with the pad: item (word column cw, 16-sample vector v), cw fastest,
// reads the 16 words of column cw in rows 16v .. 16v + 15 (4 channels a
// word), transposes each 4x4 block of bytes in registers (__byte_perm)
// into 4 samples of each of the column's 4 channels, and stores each
// channel's 16 samples with one 16-byte store.  Its low codes are counted
// in nibble lanes (a packed byte holds digitizer 3 in its low field's low
// bit and 1 in the next but one: masks 0x11111111 of the low bits and of
// them shifted by 2 keep each digitizer in its own nibble), summed over
// the item's bytes (hsum4), packed a byte a digitizer and added over the
// lanes of one column by shuffles; each lane then adds one channel's 4
// counts to shared memory.  Every thread of the block calls it.
__device__ __forceinline__ void ja98_rows4(const uint8_t* tile, int nchan,
                                           uint8_t* __restrict__ ftp,
                                           long long tp, long long t0,
                                           int tt, unsigned* cnt) {
  const int ncw = nchan >> 2;
  const int nv = tt >> 4;
  const int gw = 4 * nchan + kJa98Pad / 4;  // words of a 16-row group
  const unsigned* words = reinterpret_cast<const unsigned*>(tile);
  const int lane = threadIdx.x & 31;
  const int g = lane / ncw;  // this lane's place among its column's lanes
  for (int i0 = threadIdx.x - lane; i0 < ncw * nv; i0 += blockDim.x) {
    const int i = i0 + lane;
    const int cw = i & (ncw - 1);
    const int v = i / ncw;
    unsigned pk[4] = {0u, 0u, 0u, 0u};  // channel m: digitizer d in byte d
    if (v < nv) {
      const unsigned* src = words + v * gw + cw;
      unsigned out[4][4];  // [channel m][word q]: samples 4q .. 4q + 3
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const unsigned a0 = src[(4 * q) * ncw];
        const unsigned a1 = src[(4 * q + 1) * ncw];
        const unsigned a2 = src[(4 * q + 2) * ncw];
        const unsigned a3 = src[(4 * q + 3) * ncw];
        const unsigned b0 = __byte_perm(a0, a1, 0x5140);
        const unsigned b1 = __byte_perm(a2, a3, 0x5140);
        const unsigned b2 = __byte_perm(a0, a1, 0x7362);
        const unsigned b3 = __byte_perm(a2, a3, 0x7362);
        out[0][q] = __byte_perm(b0, b1, 0x5410);
        out[1][q] = __byte_perm(b0, b1, 0x7632);
        out[2][q] = __byte_perm(b2, b3, 0x5410);
        out[3][q] = __byte_perm(b2, b3, 0x7632);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        unsigned lo = 0u, hi = 0u;  // digitizers 3, 1 and 2, 0 in nibbles
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const unsigned low = ja98_low(out[m][q]);
          lo += low & 0x11111111u;
          hi += (low >> 2) & 0x11111111u;
        }
        pk[m] = hsum4((hi >> 4) & 0x0F0F0F0Fu) |
                hsum4((lo >> 4) & 0x0F0F0F0Fu) << 8 |
                hsum4(hi & 0x0F0F0F0Fu) << 16 |
                hsum4(lo & 0x0F0F0F0Fu) << 24;
        *reinterpret_cast<uint4*>(ftp + (long long)(4 * cw + m) * tp + t0 +
                                  16 * v) =
            make_uint4(out[m][0], out[m][1], out[m][2], out[m][3]);
      }
    }
    // the sums over the lanes of one column (lane mod ncw), 16 samples
    // each: at most 16 * 32 / ncw <= 128 a byte ...
#pragma unroll
    for (int m = 0; m < 4; ++m)
      for (int o = ncw; o < 32; o <<= 1)
        pk[m] += __shfl_xor_sync(0xffffffffu, pk[m], o);
    // ... and lane g of the column adds the channels m = g mod (32 / ncw)
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      if (m % (32 / ncw) == g) {
        unsigned* c = cnt + 4 * (4 * cw + m);
#pragma unroll
        for (int d = 0; d < 4; ++d)
          atomicAdd(c + d, (pk[m] >> (8 * d)) & 0xFFu);
      }
    }
  }
}

// One chunk of tt time samples of nchan channels of one byte a sample (4
// codes: nd_chan == 4), rows of nchan bytes, to the copy (store_units<1>'s
// items: 16 samples of one channel an item) and counted.
__device__ __forceinline__ void ja98_units(const uint8_t* tile, int nchan,
                                           uint8_t* __restrict__ ftp,
                                           long long tp, long long t0,
                                           int tt, unsigned* cnt) {
  unsigned mask[4];
#pragma unroll
  for (int d = 0; d < 4; ++d) mask[d] = ja98_mask(d, 4, false);
  const int nv = (tt + 15) >> 4;
  const int nitems = nchan * 2 * ((nv + 1) >> 1);
  for (int i = threadIdx.x; i < nitems; i += blockDim.x) {
    int c, v;
    ftp_item(i, nchan, &c, &v);
    unsigned n[4] = {0u, 0u, 0u, 0u};
    if (v < nv) {
      const int r0 = 16 * v;
      const uint8_t* s = tile + r0 * nchan + c;
      uint8_t* dst = ftp + (long long)c * tp + t0 + r0;
      if (r0 + 16 <= tt && ((uintptr_t)dst & 15) == 0) {
        unsigned w[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          w[q] = (unsigned)s[(4 * q) * nchan] |
                 (unsigned)s[(4 * q + 1) * nchan] << 8 |
                 (unsigned)s[(4 * q + 2) * nchan] << 16 |
                 (unsigned)s[(4 * q + 3) * nchan] << 24;
          ja98_count(w[q], mask, n);
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      } else {
        const int m = tt - r0 < 16 ? tt - r0 : 16;
        for (int b = 0; b < m; ++b) {
          const unsigned x = s[b * nchan];
          dst[b] = (uint8_t)x;
          ja98_count(x, mask, n);
        }
      }
    }
    ja98_add(cnt + 4 * c, 4, n);
  }
}

// One chunk of tt time samples of nchan channels of npd < 4 two-bit codes
// a sample (one span, the most significant field first), widened to a
// byte a code in the copy (store_widened<2>'s items) and counted.
__device__ __forceinline__ void ja98_widened(const uint8_t* span, int nchan,
                                             int npd,
                                             uint8_t* __restrict__ ftp,
                                             long long tp, long long t0,
                                             int tt, unsigned* cnt) {
  unsigned mask[4];
#pragma unroll
  for (int d = 0; d < 4; ++d) mask[d] = ja98_mask(d, npd, true);
  const int nb = tt * npd;  // bytes of a channel in this chunk
  const int nv = (nb + 15) >> 4;
  const int nitems = nchan * 2 * ((nv + 1) >> 1);
  for (int i = threadIdx.x; i < nitems; i += blockDim.x) {
    int c, v;
    ftp_item(i, nchan, &c, &v);
    unsigned n[4] = {0u, 0u, 0u, 0u};
    if (v < nv) {
      const int b0 = 16 * v;
      const int m = nb - b0 < 16 ? nb - b0 : 16;
      uint8_t* dst = ftp + ((long long)c * tp + t0) * npd + b0;
      unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        if (k < m) {
          const int r = (b0 + k) / npd;
          const int idx = (r * nchan + c) * npd + (b0 + k - r * npd);
          const unsigned f = (span[idx >> 2] >> ((3 - (idx & 3)) * 2)) & 3u;
          w[k >> 2] |= f << (8 * (k & 3));
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) ja98_count(w[q], mask, n);
      if (m == 16 && ((uintptr_t)dst & 15) == 0) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      } else {
#pragma unroll
        for (int k = 0; k < 16; ++k)
          if (k < m) dst[k] = (uint8_t)(w[k >> 2] >> (8 * (k & 3)));
      }
    }
    ja98_add(cnt + npd * c, npd, n);
  }
}

// One chunk of cb bytes of one channel's nd digitizers (no copy), counted
// from its words; each warp's sums go to shared memory in one add a
// digitizer.  Every thread of the block calls it.
__device__ __forceinline__ void ja98_words(const uint8_t* tile, int cb,
                                           int nd, unsigned* cnt) {
  unsigned mask[4];
#pragma unroll
  for (int d = 0; d < 4; ++d) mask[d] = ja98_mask(d, nd, false);
  unsigned n[4] = {0u, 0u, 0u, 0u};
  for (int i = threadIdx.x; 4 * i < cb; i += blockDim.x) {
    unsigned w = reinterpret_cast<const unsigned*>(tile)[i];
    if (cb - 4 * i < 4) w &= (1u << (8 * (cb - 4 * i))) - 1u;
    ja98_count(w, mask, n);
  }
#pragma unroll
  for (int d = 0; d < 4; ++d) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      n[d] += __shfl_xor_sync(0xffffffffu, n[d], o);
    if ((threadIdx.x & 31) == 0 && d < nd) atomicAdd(cnt + d, n[d]);
  }
}

// Shared-memory words between two blocks' counts: odd, so that the
// write-out's reads of one digitizer over the blocks fall in other banks.
__host__ __device__ inline int ja98_cstride(int ndig) { return ndig | 1; }

__global__ void __launch_bounds__(kJa98Threads, kJa98MinBlocks)
mega_ja98(const uint8_t* __restrict__ raw, uint16_t* __restrict__ nlow,
          float* __restrict__ wblk, const float* __restrict__ weight,
          uint8_t* __restrict__ ftp, int ndig, int nd_chan, int npw,
          int nweights, long long tp, int TT) {
  extern __shared__ uint4 ja98_sm[];
  const int cs = ja98_cstride(ndig);
  unsigned* cnt = reinterpret_cast<unsigned*>(ja98_sm);
  const int cb = TT * ndig / 4;
  const int nchan = ndig / nd_chan;
  const int gsize = ja98_group(nchan, nd_chan, TT, ftp != nullptr);
  const int cb16 = ja98_chunk_bytes(cb, gsize);
  uint8_t* buf = reinterpret_cast<uint8_t*>(ja98_sm) +
                 ((kJa98Blocks * cs * 4 + 15) & ~15);
  const int b0 = blockIdx.x * kJa98Blocks;
  const int G = nweights - b0 < kJa98Blocks ? nweights - b0 : kJa98Blocks;
  const int nq = npw / TT;  // chunks a block
  const int nchunks = G * nq;
  const uint8_t* src = raw + (long long)b0 * npw * ndig / 4;
  for (int e = threadIdx.x; e < kJa98Blocks * cs; e += blockDim.x) cnt[e] = 0u;
  for (int k = 0; k < kJa98Stages - 1; ++k) {
    if (k < nchunks)
      ja98_stage(buf + k * cb16, src + (long long)k * cb, cb, gsize);
    else
      cp_commit();
  }
  for (int s = 0; s < nchunks; ++s) {
    // one group a chunk (empty past the last): chunk s has landed
    cp_wait(kJa98Stages - 2);
    // ... from every thread; chunk s - 1 is counted, so its buffer takes
    // chunk s + kJa98Stages - 1 (and the counts are zeroed)
    __syncthreads();
    const int nx = s + kJa98Stages - 1;
    if (nx < nchunks)
      ja98_stage(buf + (nx % kJa98Stages) * cb16, src + (long long)nx * cb,
                 cb, gsize);
    else
      cp_commit();
    const uint8_t* tile = buf + (s % kJa98Stages) * cb16;
    unsigned* c = cnt + (s / nq) * cs;
    const long long t0 = (long long)b0 * npw + (long long)s * TT;
    if (!ftp)
      ja98_words(tile, cb, ndig, c);
    else if (gsize)
      ja98_rows4(tile, nchan, ftp, tp, t0, TT, c);
    else if (nd_chan == 4)
      ja98_units(tile, nchan, ftp, tp, t0, TT, c);
    else
      ja98_widened(tile, nchan, nd_chan, ftp, tp, t0, TT, c);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < ndig * G; e += blockDim.x) {
    const int d = e / G;
    const int b = e - d * G;
    nlow[(long long)d * nweights + b0 + b] = (uint16_t)cnt[b * cs + d];
  }
  for (int e = threadIdx.x; e < nchan * G; e += blockDim.x) {
    const int ch = e / G;
    const int b = e - ch * G;
    const unsigned* cc = cnt + b * cs + ch * nd_chan;
    float w = __ldg(weight + cc[0]);
    for (int d = 1; d < nd_chan; ++d) w = fminf(w, __ldg(weight + cc[d]));
    wblk[(long long)ch * nweights + b0 + b] = w;
  }
}

// Each window's weight: the least block weight over its span of
// span_blocks blocks from w * step_blocks (window_weight_spans).
__global__ void __launch_bounds__(kThreads)
mega_ja98_windows(const float* __restrict__ wblk, float* __restrict__ wwin,
                  int nchan, int npart, int nweights, int step_blocks,
                  int span_blocks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nchan * npart) return;
  const int c = i / npart;
  const int w = i - c * npart;
  const float* src =
      wblk + (long long)c * nweights + (long long)w * step_blocks;
  float v = src[0];
  for (int b = 1; b < span_blocks; ++b) v = fminf(v, src[b]);
  wwin[i] = v;
}

// Set a kernel's dynamic shared-memory limit and launch it (grid, threads
// and shared memory from the caller) on `stream`.
template <class K, class... A>
cudaError_t launch(K kernel, dim3 grid, int threads, int smem,
                   cudaStream_t stream, A... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// The JA98 pre-pass on the caller's stream: nlow (u.nlow), the block
// weights wblk float[nchan, nweights] and the window weights wwin
// float[nchan, npart]; ftp, the channel-transposed copy of the codes
// (streams tp samples apart), exactly when nchan > 1.
cudaError_t launch_ja98(const void* raw, const Unpack& u, void* wblk,
                        void* wwin, int nchan, int npol, int ndim, int npart,
                        int nsamp_step, int nsamp_fft, void* ftp,
                        long long tp, cudaStream_t stream) {
  const int npw = 1 << u.lg_npw;
  const int ndig = nchan * npol * ndim;
  // mega_ja98 counts a stream of several channels from its copy
  if ((npw * ndig) % 4 || nsamp_step % npw || nsamp_fft % npw ||
      (ftp != nullptr) != (nchan > 1))
    return cudaErrorInvalidValue;
  // chunks of TT samples: a power of two dividing npw, 16 or more where
  // npw allows, within kFtpTile bytes where that allows
  int TT = npw;
  while (TT > 16 && TT * ndig / 4 > kFtpTile) TT >>= 1;
  if ((TT * ndig) % 4) return cudaErrorInvalidValue;
  const int smem =
      ((kJa98Blocks * ja98_cstride(ndig) * 4 + 15) & ~15) +
      kJa98Stages *
          ja98_chunk_bytes(TT * ndig / 4,
                           ja98_group(nchan, npol * ndim, TT, ftp != nullptr));
  cudaError_t err = launch(
      &mega_ja98, dim3((u.nweights + kJa98Blocks - 1) / kJa98Blocks),
      kJa98Threads, smem, stream,
      (const uint8_t*)raw, (uint16_t*)u.nlow, (float*)wblk,
      u.tables + 2 * u.npw1, (uint8_t*)ftp, ndig, npol * ndim, npw,
      u.nweights, tp, TT);
  if (err != cudaSuccess) return err;
  mega_ja98_windows<<<(nchan * npart + kThreads - 1) / kThreads, kThreads, 0,
                      stream>>>((const float*)wblk, (float*)wwin, nchan,
                                npart, u.nweights, nsamp_step / npw,
                                nsamp_fft / npw);
  return cudaGetLastError();
}

// The pre-pass for every code kind but JA98 on the caller's stream: T time
// samples of nchan channels of npd codes of nbit bits -> the
// channel-transposed copy ftp (streams tp samples apart).
cudaError_t launch_ftp(const void* raw, void* ftp, long long T, int nchan,
                       int npd, int nbit, int twos, long long tp,
                       cudaStream_t stream) {
  const uint8_t* src = (const uint8_t*)raw;
  uint8_t* dst = (uint8_t*)ftp;
  if (npd * nbit < 8) {
    const long long rowbits = (long long)nchan * npd * nbit;
    int TT = 256;
    while (TT > 8 && TT * rowbits > 8LL * kFtpTile) TT >>= 1;
    if (TT * rowbits > 8LL * kFtpTile) return cudaErrorInvalidValue;
    const int smem = (int)(((TT * rowbits + 7) / 8 + 15) & ~15LL);
    const dim3 grid((unsigned)((T + TT - 1) / TT));
    switch (nbit) {
      case 1:
        return launch(&mega_ftpw<1>, grid, kThreads, smem, stream, src, dst,
                      T, nchan, npd, twos, tp, TT);
      case 2:
        return launch(&mega_ftpw<2>, grid, kThreads, smem, stream, src, dst,
                      T, nchan, npd, twos, tp, TT);
      case 4:
        return launch(&mega_ftpw<4>, grid, kThreads, smem, stream, src, dst,
                      T, nchan, npd, twos, tp, TT);
      default:
        return cudaErrorInvalidValue;
    }
  }
  const int E = npd * nbit / 8;
  const int CC = nchan * E > kFtpRow ? kFtpRow / E : nchan;
  const int ld = ftp_ld(CC * E);
  int TT = 256;
  while (TT > 16 && TT * ld > kFtpTile) TT >>= 1;
  const dim3 grid((unsigned)((T + TT - 1) / TT), (nchan + CC - 1) / CC);
  const int smem = TT * ld;
  switch (E) {
    case 1:
      return launch(&mega_ftp<1>, grid, kThreads, smem, stream, src, dst, T,
                    nchan, tp, TT, CC);
    case 2:
      return launch(&mega_ftp<2>, grid, kThreads, smem, stream, src, dst, T,
                    nchan, tp, TT, CC);
    case 4:
      return launch(&mega_ftp<4>, grid, kThreads, smem, stream, src, dst, T,
                    nchan, tp, TT, CC);
    case 8:
      return launch(&mega_ftp<8>, grid, kThreads, smem, stream, src, dst, T,
                    nchan, tp, TT, CC);
    case 16:
      return launch(&mega_ftp<16>, grid, kThreads, smem, stream, src, dst, T,
                    nchan, tp, TT, CC);
    default:
      return cudaErrorInvalidValue;
  }
}

// The Unpack of a C entry point's arguments: nsamp_block time samples a
// block; tables, nlow and npw are read only for JA98 codes.
Unpack make_unpack(int twos, float scale, float offset, const void* window,
                   const void* tables, void* nlow, int npw,
                   long long nsamp_block) {
  Unpack u;
  u.twos = twos;
  u.scale = scale;
  u.offset = offset;
  u.window = (const float*)window;
  u.tables = (const float*)tables;
  u.nlow = (const uint16_t*)nlow;
  u.npw1 = npw + 1;
  u.lg_npw = npw > 0 ? ilog2c(npw) : 0;
  u.nweights = npw > 0 ? (int)(nsamp_block / npw) : 0;
  return u;
}

// Byte of real sample (t, pol) in the CASPSR layout (one input channel).
__device__ __forceinline__ long long caspsr_byte(long long t, int pol,
                                                 int npol) {
  return (t >> 2) * npol * 4 + pol * 4 + (t & 3);
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
// input channel), added into psum[c, w, 2] (zeroed by the caller).  Real
// input, pols 0 and 1, one-channel TFP streams cs codes apart (the raw
// block, or with nchan > 1 the pre-pass's copy) or (caspsr != 0, 8-bit
// codes, one channel) CASPSR bytes.
template <int CODE>
__global__ void __launch_bounds__(kThreads)
mega_polpow(const uint8_t* __restrict__ raw, float* __restrict__ psum,
            long long cs, int npol, int npart, int nsamp_step, int two_n,
            Unpack u, int caspsr) {
  __shared__ float red[2][kThreads / 32];
  const int w = blockIdx.y;
  const int c = blockIdx.z;
  const int chunk = two_n / gridDim.x;
  const long long t0 = (long long)w * nsamp_step + (long long)blockIdx.x * chunk;
  const int twos = u.twos;
  const float scale = u.scale, offset = u.offset;
  float sa = 0.f, sb = 0.f;
  const uint8_t* chan = raw + (CODE == kCode8 ? c * cs : 0);
  if (CODE == kCode8 && chunk % 8 == 0 && (t0 & 7) == 0 &&
      ((uintptr_t)chan & 15) == 0) {
    // 8 samples of both pols in one 16-byte load (the same 16 bytes in both
    // layouts: TFP words hold a b a b, CASPSR words a a a a, b b b b, a a a
    // a, b b b b)
    const uint4* src = (const uint4*)(chan + 2 * t0);
    for (int i = threadIdx.x; i < chunk / 8; i += blockDim.x) {
      const uint4 q = src[i];
      const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const float v = unpack((uint8_t)(words[k] >> (8 * h)), twos, scale, offset);
          if (caspsr ? (k & 1) : (h & 1))
            sb += v * v;
          else
            sa += v * v;
        }
    }
  } else {
    for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
      const long long t = t0 + i;
      float a, b;
      if (CODE == kCode8 && caspsr) {
        const long long off = caspsr_byte(t, 0, npol);
        a = unpack(raw[off], twos, scale, offset);
        b = unpack(raw[off + 4], twos, scale, offset);
      } else {
        const long long k = c * cs + t * npol;
        a = load_code<CODE>(raw, k, (long long)c * npol, t, u);
        b = load_code<CODE>(raw, k + 1, (long long)c * npol + 1, t, u);
      }
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
// out per pass as fft_seqs reads them), then the inter-stage factors over
// the window length W = R1 * row_len (2N real, N complex): lo[e] =
// exp(-2 pi i e / W), e < 2^lo_bits, hi[e] = exp(-2 pi i e 2^lo_bits / W),
// and col[k1*kMaxCols + c] = exp(-2 pi i c k1 / W), c < kMaxCols; last
// the long row pass's (mega_rowfft) row_len entries: its first stage's
// factors half[n] = exp(-2 pi i n / row_len), n < row_len / 2, then the
// length-row_len/2 FFT table.
struct Tables {
  const float2* r1;
  const float2* row;
  const float2* inv;
  const float2* lo;
  const float2* hi;
  const float2* col;
  const float2* half;
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
  t.half = t.col + R1 * kMaxCols;
  return t;
}

// Grid: (sequence, tile of S columns, window), the sequence first, so that
// the CTAs of the pols of one channel, which read the same sectors, run
// together.  Real input: the sequence is the input channel c, and pols pol0
// (and pol0 + 1 when npolf == 2) are packed.  Complex input: sequence c *
// npolf + q is pol pol0 + q.  cbuf is float2[nchan * (complex ? npolf : 1),
// npart, R1, row_len].  Channel c is a one-channel TFP stream at code c *
// cs of raw (the raw block, or with nchan > 1 the pre-pass's copy).  CODE
// is the Code of that stream (the CASPSR layout is 8-bit only).
template <int P, int LAYOUT, int CODE>
__global__ void __launch_bounds__(kMaxThreads)
mega_fwd1(const uint8_t* __restrict__ raw, float2* __restrict__ cbuf,
          const float* __restrict__ psum, Tables tb, long long cs, int npol,
          int pol0, int npolf, int npart, int R1, int row_len,
          int nsamp_step, int S, Unpack u) {
  constexpr bool CPLX = LAYOUT == kComplexTfp;
  constexpr int ndim = CPLX ? 2 : 1;
  const int twos = u.twos;
  const float scale = u.scale, offset = u.offset;
  extern __shared__ float2 sm[];
  const int T = R1 / P;
  const int col = threadIdx.x & (S - 1);
  const int j = threadIdx.x / S;
  const int seq = blockIdx.x;
  const int m = blockIdx.y * S + col;
  const int w = blockIdx.z;
  const int c = CPLX ? seq / npolf : seq;
  const int pol = pol0 + (CPLX ? seq - c * npolf : 0);
  const float sb =
      !CPLX && npolf == 2
          ? ldexpf(1.f, pol_exponent(psum + 2 * ((long long)c * npart + w)))
          : 0.f;
  // this thread's first sample; its samples are T rows (T * row_len
  // samples) apart
  const long long t0 = (long long)w * nsamp_step + m + (long long)j * row_len;
  float2 v[P];
  // two bytes in one 16-bit load (at an even offset) when the buffer
  // allows it: a complex sample's (re, im), or both pols of a real TFP
  // sample
  const bool pairs = (CPLX || npolf == 2) && ((uintptr_t)raw & 1) == 0;
  const long long stride = (long long)T * row_len * npol * ndim;
  // code index of this thread's first sample, and its digitizer
  const long long k0 = c * cs + (t0 * npol + pol) * ndim;
  const long long dig0 = ((long long)c * npol + pol) * ndim;
  const uint8_t* src = raw + k0;
  // JA98: this thread's first byte and the shift of its first code (the
  // second code, when read, is the next field of the same byte, or with
  // widened codes the next byte); sample i is i * jb bytes further, so the
  // unrolled loads need no 64-bit index each.  The levels come from a
  // table in shared memory, filled here from nlow and the lo/hi tables:
  // jlev[(n1 * nb + b) * 4 + {0, 1, 2, 3}] = lo and hi of the first code's
  // digitizer, lo and hi of the second's, for row n1 of the window and the
  // tile's b-th npw-sample block of that row (a row of row_len samples
  // holds whole blocks; a tile's columns lie in nb = max(1, S / npw) of
  // them, block col >> lg_npw).  It sits in the exchange area, which the
  // first pass overwrites only after the barrier that ends the loads.
  constexpr bool JA98 = CODE == kCodeJA98 || CODE == kCodeJA98W;
  constexpr int lgc = CODE == kCodeJA98 ? 2 : 0;  // log2(codes a byte)
  const uint8_t* jbyte = raw + (k0 >> lgc);
  const int jsh = CODE == kCodeJA98 ? (3 - (int)(k0 & 3)) * 2 : 0;
  const int jb = (int)(stride >> lgc);
  const int lgb = S > (1 << u.lg_npw) ? __ffs(S) - 1 - u.lg_npw : 0;
  const float* jlev = reinterpret_cast<const float*>(sm);
  if constexpr (JA98) {
    float* lev = reinterpret_cast<float*>(sm);
    const long long tw = (long long)w * nsamp_step + (m - col);
    const uint16_t* nla = u.nlow + dig0 * u.nweights;
    const uint16_t* nlb = nla + u.nweights;
    for (int e = threadIdx.x; e < (R1 << lgb); e += blockDim.x) {
      const long long blk =
          ((tw + (long long)(e >> lgb) * row_len) >> u.lg_npw) +
          (e & ((1 << lgb) - 1));
      const int na = __ldg(nla + blk);
      const int nb = CPLX || npolf == 2 ? __ldg(nlb + blk) : 0;
      lev[4 * e] = __ldg(u.tables + na);
      lev[4 * e + 1] = __ldg(u.tables + u.npw1 + na);
      lev[4 * e + 2] = __ldg(u.tables + nb);
      lev[4 * e + 3] = __ldg(u.tables + u.npw1 + nb);
    }
    __syncthreads();
  }
  auto load = [&](int, float2(&x)[P]) {
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if constexpr (CODE == kCode8) {
        uint8_t ca, cb = 0;
        if constexpr (LAYOUT == kRealCaspsr) {
          const long long t = t0 + (long long)i * T * row_len;
          ca = raw[caspsr_byte(t, pol, npol)];
          if (npolf == 2) cb = raw[caspsr_byte(t, pol + 1, npol)];
        } else {
          const uint8_t* p = src + i * stride;
          if (pairs) {
            const unsigned short both = *(const unsigned short*)p;
            ca = (uint8_t)both;
            cb = (uint8_t)(both >> 8);
          } else {
            ca = p[0];
            if (CPLX || npolf == 2) cb = p[1];
          }
        }
        const float a = unpack(ca, twos, scale, offset);
        if constexpr (CPLX) {
          x[i] = make_float2(a, unpack(cb, twos, scale, offset));
        } else {
          const float b = npolf == 2 ? unpack(cb, twos, scale, offset) : 0.f;
          x[i] = make_float2(a, b * sb);
        }
      } else if constexpr (JA98) {
        // sign * (code is 1 or 2 ? lo : hi), sign + for codes 2 and 3
        const float* lv =
            jlev + 4 * (((j + T * i) << lgb) + (col >> u.lg_npw));
        const int byte = __ldg(jbyte + i * jb);
        const int ca = CODE == kCodeJA98 ? (byte >> jsh) & 3 : byte;
        const float ma = lv[(ca == 1 || ca == 2) ? 0 : 1];
        float b = 0.f;
        if (CPLX || npolf == 2) {
          const int cb =
              CODE == kCodeJA98 ? (byte >> (jsh - 2)) & 3
                                : __ldg(jbyte + i * jb + 1);
          const float mb = lv[(cb == 1 || cb == 2) ? 2 : 3];
          b = cb >= 2 ? mb : -mb;
        }
        x[i] = make_float2(ca >= 2 ? ma : -ma, CPLX ? b : b * sb);
      } else {
        // the second code (the imaginary part, or pol b) follows the first
        const long long t = t0 + (long long)i * T * row_len;
        const long long k = k0 + i * stride;
        const float a = load_code<CODE>(raw, k, dig0, t, u);
        const float b = (CPLX || npolf == 2)
                            ? load_code<CODE>(raw, k + 1, dig0 + 1, t, u)
                            : 0.f;
        x[i] = make_float2(a, CPLX ? b : b * sb);
      }
    }
    if (u.window) {
      // sample n1*row_len + m of the window, n1 = j + T*i
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const float g = __ldg(u.window + (long long)(j + T * i) * row_len + m);
        x[i] = make_float2(x[i].x * g, x[i].y * g);
      }
    }
    // the level table is read: the first pass may overwrite it
    if constexpr (JA98) __syncthreads();
  };
  fft_seqs<P, 1, -1, true>(v, load, sm + col * seq_ld(R1), 0, j, R1,
                           __ffs(R1) - 1, tb.r1);
  // exp(-2 pi i m k1 / (R1 row_len)) = exp(-2 pi i m0 k1 / (R1 row_len))
  // exp(-2 pi i col k1 / (R1 row_len)): the first factor is the same across
  // a half-warp (one k1, all columns), the second is read from the column
  // table in 128-byte lines
  const int m0 = m - col;
  const int mask = (1 << tb.log2n) - 1;
  const int lo_mask = (1 << tb.lo_bits) - 1;
  float2* dst = cbuf + ((long long)seq * npart + w) * R1 * row_len + m;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int k1 = j + T * i;
    const int e = (m0 * k1) & mask;
    const float2 t0 = cmul(__ldg(tb.hi + (e >> tb.lo_bits)), __ldg(tb.lo + (e & lo_mask)));
    const float2 t = cmul(t0, __ldg(tb.col + k1 * kMaxCols + col));
    dst[(long long)k1 * row_len] = cmul(v[i], t);
  }
}

// Where the real-input row passes (mega_fwd2, mega_rowpair) put the
// separated spectra of one (input channel, window): ya and yb the kept
// pols' slots of ybuf, pbc the channel's passband or null, grc/gic its
// chirp; unscale undoes pol b's power-of-two scale.
struct Sep {
  float2* ya;
  float2* yb;
  float* pbc;
  const float* grc;
  const float* gic;
  long long n;
  float unscale;
  int npolf;
  int store;
};

__device__ __forceinline__ Sep make_sep(float2* __restrict__ ybuf,
                                        const float* __restrict__ gr,
                                        const float* __restrict__ gi,
                                        const float* __restrict__ psum,
                                        float* __restrict__ pb, int npolf,
                                        int store, int npart, int c, int w,
                                        long long n) {
  Sep o;
  o.n = n;
  o.npolf = npolf;
  o.store = store;
  o.unscale =
      npolf == 2
          ? ldexpf(1.f, -pol_exponent(psum + 2 * ((long long)c * npart + w)))
          : 0.f;
  const int nstore = (store & 1) + (store >> 1);
  o.ya = ybuf + ((long long)c * nstore * npart + w) * n;
  o.yb = o.ya + ((store & 1) ? (long long)npart * n : 0LL);
  o.pbc = pb ? pb + (long long)c * npolf * n : nullptr;
  o.grc = gr + (long long)c * n;
  o.gic = gi + (long long)c * n;
  return o;
}

// Bin k of both pols from the packed spectrum's Z[k] (z) and Z[2N - k] (p):
// X_a = (Z + conj P) / 2, X_b = (Z - conj P) / 2i; passband, chirp, store.
__device__ __forceinline__ void separate_store(float2 z, float2 p,
                                               long long k, const Sep& o) {
  const float2 g = make_float2(o.grc[k], o.gic[k]);
  const float2 xa = make_float2(0.5f * (z.x + p.x), 0.5f * (z.y - p.y));
  const float2 xb = make_float2(0.5f * (z.y + p.y) * o.unscale,
                                -0.5f * (z.x - p.x) * o.unscale);
  if (o.pbc) {
    atomicAdd(o.pbc + k, xa.x * xa.x + xa.y * xa.y);
    if (o.npolf == 2) atomicAdd(o.pbc + o.n + k, xb.x * xb.x + xb.y * xb.y);
  }
  if (o.store & 1) o.ya[k] = cmul(xa, g);
  if (o.npolf == 2 && (o.store & 2)) o.yb[k] = cmul(xb, g);
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

  const Sep o = make_sep(ybuf, gr, gi, psum, pb, npolf, store, npart, c, w,
                         (long long)R1 * R2);
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
    separate_store(sm[slot * ld + sidx(k2)], sm[pslot * ld + sidx(pcol)],
                   (long long)k2 * R1 + k1, o);
  }
}

// The long row pass (real input whose rows of row_len = 2*R2 points are too
// long for mega_fwd2, which holds a row pair in one CTA: at R2 = 8192 a pair
// needs 278 KB of shared memory).  Two kernels through device memory:
//   mega_rowfft   the length-row_len FFT of each row (k1, window, input
//                 channel), split over a cluster of two CTAs (see below) and
//                 written back over the row in cbuf as its even bins, then
//                 its odd bins (rowpos).
//   mega_rowpair  per (tile of 8 consecutive k1 and 32 consecutive k2,
//                 window, input channel): bin k = k2*R1 + k1 from Z[k] and
//                 its partner Z[2N - k] (row R1 - k1, column
//                 row_len-1-k2; rows 0 and R1/2 pair with themselves, row 0
//                 at column (row_len - k2) mod row_len), read from cbuf
//                 through rowpos, then separate_store.  A warp reads 4
//                 consecutive k2 of 8 rows (two 16-byte halves of sectors
//                 that the tile's other warps read too) and stores runs of
//                 8 k1.
// Against mega_fwd2 it writes and reads the stage-2 rows once more: 4.3 GB
// a J0613-0200 block where the function needs 2.21 (0.661 ms at the
// device-memory rate).
//
// mega_rowfft: one row over a cluster of two CTAs, half a row (H =
// row_len/2 points, 32 a thread: 256 threads, 69 KB of shared memory, 128
// registers, no local memory) each, so that two row CTAs share an SM and
// one's loads are in flight while the other transforms.  CTA `rank` loads
// its half x[rank*H + n] (n < H) into registers, writes it into its
// partner's shared memory (distributed shared memory, after a cluster
// barrier that every CTA of the cluster has reached: split in two around
// the loads) and, after a second cluster barrier, takes the partner's half
// from its own: the first radix-2 stage, decimation in frequency, gives
// rank 0 the sequence x[n] + x[n + H] whose H-point FFT is the even bins
// X[2m], and rank 1 (x[n] - x[n + H]) exp(-2 pi i n / row_len), the odd
// bins X[2m + 1].  Each then runs the H-point FFT (fft_keep, the half
// tables of Tables) and stores its H bins as one contiguous half of the
// row, so bin k lies at rowpos(k) = (k & 1) * H + (k >> 1).
// Measured a J0613-0200 block (H100 80GB HBM3, 700 W): 0.868-0.872 ms
// against the parent's 1.023-1.030 (one 512-thread CTA a row, 139 KB, one
// CTA an SM, 40 B of spills a thread), torch.fft.fft over the same rows
// 0.81-0.82; split: the loads alone 0.341 (the parent's too), with the
// exchange 0.434, with the transform 0.712.  mega_rowpair reading through
// rowpos 0.955 against 0.938 (walking k2 in stored order, 0.967).  Not
// kept: 16 points a thread (512 threads, 64 registers: 0.98-0.99, 64 B of
// spills); a run-time half length (192-536 B of spills, 1.2-2.1 ms); the
// partner's half read from L2 in place of distributed shared memory (0.893
// against 0.872).
// Also not kept: one kernel in clusters of 8 one-row CTAs (4 row pairs) that
// separated each rank's slice of k2 from the cluster's distributed shared
// memory took 2.39-2.51 ms a block: its transform (1.00 ms alone) and its
// stores (0.94 more) ran one after the other at one CTA an SM.

// threads of a mega_rowfft CTA at most: half of the longest row (R2 =
// 8192 points) at kRowPoints a thread
constexpr int kRowThreads = 8192 / kRowPoints;

// Where bin k of a row of row_len = 2H points lies after mega_rowfft.
__host__ __device__ __forceinline__ int rowpos(int k, int H) {
  return (k & 1) * H + (k >> 1);
}

// The cluster's barrier and distributed shared memory in PTX (the
// cooperative-groups calls kept the 16 points of every thread live across
// a call, 120-536 bytes of stack a thread): this CTA's rank; the barrier
// in two halves (every thread of each CTA calls both: the arrival with no
// memory ordering, and the wait for every CTA's), or whole, releasing this
// CTA's writes and acquiring every other's; the address of p's element in
// CTA `rank`'s shared memory, and an 8-byte store there.
__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync_all() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_addr(p)), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_cluster(uint32_t addr, float2 v) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(addr),
               "f"(v.x), "f"(v.y)
               : "memory");
}

// Grid (2*R1, npart, nchan) in clusters of 2 along x: blockIdx.x = 2*k1 +
// rank.  The half row's length H is a template parameter (16 .. 8192,
// row_kernel), so that every index of a thread's points is an immediate
// offset from one base and the FFT's passes unroll: at a length known only
// at run time the points' 16-32 addresses and indices stayed live through
// the FFT and spilled 192-536 bytes a thread (H100 80GB HBM3, ptxas).
template <int H>
__global__ void __launch_bounds__(kRowThreads, 2)
mega_rowfft(float2* __restrict__ cbuf, Tables tb, int npart, int R1) {
  constexpr int P = row_points(H);
  constexpr int row_len = 2 * H;
  extern __shared__ float2 sm[];
  const int rank = cluster_rank();
  constexpr int T = H / P;
  const int j = threadIdx.x;
  float2* half = cbuf + (((long long)blockIdx.z * npart + blockIdx.y) * R1 +
                         (blockIdx.x >> 1)) * row_len + rank * H;
  cluster_arrive_relaxed();
  float2 v[P];
#pragma unroll
  for (int i = 0; i < P; ++i) v[i] = half[j + T * i];
  // the partner has started: its shared memory takes this half
  cluster_wait();
  const uint32_t peer = cluster_addr(sm, rank ^ 1);
#pragma unroll
  for (int i = 0; i < P; ++i)
    st_cluster(peer + 8u * sidx(j + T * i), v[i]);
  cluster_sync_all();
  // v holds this CTA's half, the partner's lies in shared memory: the first
  // stage, then the H-point FFT of the result (already in v)
  const float2* hw = tb.half;
  if (rank) {
#pragma unroll
    for (int i = 0; i < P; ++i)
      v[i] = cmul(csub(sm[sidx(j + T * i)], v[i]), __ldg(hw + j + T * i));
  } else {
#pragma unroll
    for (int i = 0; i < P; ++i) v[i] = cadd(v[i], sm[sidx(j + T * i)]);
  }
  // read: the first pass may overwrite it
  __syncthreads();
  fft_keep<P, -1, H>(v, sm, j, hw + H);
#pragma unroll
  for (int i = 0; i < P; ++i) half[j + T * i] = v[i];
}

constexpr int kPairRows = 8;   // k1 of a mega_rowpair tile
constexpr int kPairCols = 32;  // k2 of a mega_rowpair tile (at most)

__global__ void __launch_bounds__(kPairRows * kPairCols)
mega_rowpair(const float2* __restrict__ cbuf, float2* __restrict__ ybuf,
             const float* __restrict__ gr, const float* __restrict__ gi,
             const float* __restrict__ psum, float* __restrict__ pb,
             int npolf, int store, int npart, int R1, int R2, int row_len,
             int kc) {
  const int w = blockIdx.y;
  const int c = blockIdx.z;
  const int ntile = R1 / kPairRows;
  const int H = row_len >> 1;
  const int k1 = (blockIdx.x % ntile) * kPairRows + (threadIdx.x & (kPairRows - 1));
  const int k2 = (blockIdx.x / ntile) * kc + threadIdx.x / kPairRows;
  const Sep o = make_sep(ybuf, gr, gi, psum, pb, npolf, store, npart, c, w,
                         (long long)R1 * R2);
  const float2* win = cbuf + ((long long)c * npart + w) * R1 * row_len;
  const int pk1 = (k1 == 0 || 2 * k1 == R1) ? k1 : R1 - k1;
  const int pcol = k1 == 0 ? (row_len - k2) & (row_len - 1) : row_len - 1 - k2;
  separate_store(win[(long long)k1 * row_len + rowpos(k2, H)],
                 win[(long long)pk1 * row_len + rowpos(pcol, H)],
                 (long long)k2 * R1 + k1, o);
}

// The complex-input row pass: blockIdx.z = c * npolf + q (the sequence of
// mega_fwd1<P, kComplexTfp>), a tile of tr rows k1 = a .. a + tr - 1, one row a
// slot.  store bit q keeps sequence q's chirped spectrum (in that order in
// ybuf); pb, when not null, is the zeroed passband float[nchan, npolf, N].
// Every index into ybuf, the chirp and the passband is the centred natural
// bin j.
template <int P>
__global__ void __launch_bounds__(kMaxThreads)
mega_fwd2c(const float2* __restrict__ cbuf, float2* __restrict__ ybuf,
           const float* __restrict__ gr, const float* __restrict__ gi,
           float* __restrict__ pb, Tables tb, int npolf, int store, int npart,
           int R1, int R2, int tr) {
  extern __shared__ float2 sm[];
  const int T = R2 / P;
  const int ld = seq_ld(R2);
  const int i = threadIdx.x / T;  // row of the tile
  const int j = threadIdx.x - i * T;
  const int a = blockIdx.x * tr;
  const int w = blockIdx.y;
  const int c = blockIdx.z / npolf;
  const int q = blockIdx.z - c * npolf;
  const float2* src =
      cbuf + (((long long)blockIdx.z * npart + w) * R1 + a + i) * R2;
  float2 v[P];
  auto load = [&](int, float2(&x)[P]) {
#pragma unroll
    for (int ii = 0; ii < P; ++ii) x[ii] = src[j + T * ii];
  };
  // slot i holds row a + i in natural order after
  fft_seqs<P, 1, -1, false>(v, load, sm + i * ld, 0, j, R2, __ffs(R2) - 1,
                            tb.row);

  const long long n = (long long)R1 * R2;
  const bool keep = (store >> q) & 1;
  const int nstore = (store & 1) + (store >> 1);
  const int slot = (q == 1 && (store & 1)) ? 1 : 0;
  float2* y = ybuf + ((long long)(c * nstore + slot) * npart + w) * n;
  float* pbc = pb ? pb + ((long long)c * npolf + q) * n : nullptr;
  const float* grc = gr + (long long)c * n;
  const float* gic = gi + (long long)c * n;
  const int lg = __ffs(tr) - 1;
  const int half = R2 / 2;
  // consecutive threads on consecutive k1 (runs of tr bins)
  for (int t = threadIdx.x; t < tr * R2; t += blockDim.x) {
    const int k2 = t >> lg;
    const int r = t & (tr - 1);
    const float2 x = sm[r * ld + sidx(k2)];
    const long long k = (long long)((k2 + half) & (R2 - 1)) * R1 + a + r;
    if (pbc) atomicAdd(pbc + k, x.x * x.x + x.y * x.y);
    if (keep) y[k] = cmul(x, make_float2(grc[k], gic[k]));
  }
}

// The complex-input row pass at long rows (R2 >= kClusterR2, where a tile
// of mega_fwd2c holds fewer than 4 rows and its stores come in runs of 1
// or 2 bins): a thread-block cluster of CR CTAs (cluster dimension x, CR
// consecutive blockIdx.x) transforms rows k1 = a + rank, one row a CTA in
// its own shared memory; after cluster.sync() CTA `rank` stores k2 in
// [rank * R2 / CR, (rank + 1) * R2 / CR) of all CR rows, reading its
// partners' rows through distributed shared memory, so every store, chirp
// read and passband atomic comes in runs of CR consecutive k1.  The second
// cluster.sync() keeps each CTA's shared memory alive until its partners
// have read it.  Arguments as mega_fwd2c's.
constexpr int kClusterR2 = 4096;  // the cluster form from this R2
constexpr int kClusterRows = 4;   // CTAs (rows) of a cluster at most

template <int P>
__global__ void __launch_bounds__(kMaxThreads, 2)
mega_fwd2cc(const float2* __restrict__ cbuf, float2* __restrict__ ybuf,
            const float* __restrict__ gr, const float* __restrict__ gi,
            float* __restrict__ pb, Tables tb, int npolf, int store,
            int npart, int R1, int R2) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float2 sm[];
  const int CR = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int T = R2 / P;
  const int j = threadIdx.x;
  const int a = blockIdx.x - rank;  // the cluster's first row
  const int w = blockIdx.y;
  const int c = blockIdx.z / npolf;
  const int q = blockIdx.z - c * npolf;
  const float2* src =
      cbuf + (((long long)blockIdx.z * npart + w) * R1 + blockIdx.x) * R2;
  float2 v[P];
  auto load = [&](int, float2(&x)[P]) {
#pragma unroll
    for (int ii = 0; ii < P; ++ii) x[ii] = src[j + T * ii];
  };
  // this CTA's row a + rank in natural order after
  fft_seqs<P, 1, -1, false>(v, load, sm, 0, j, R2, __ffs(R2) - 1, tb.row);
  cluster.sync();

  const long long n = (long long)R1 * R2;
  const bool keep = (store >> q) & 1;
  const int nstore = (store & 1) + (store >> 1);
  const int slot = (q == 1 && (store & 1)) ? 1 : 0;
  float2* y = ybuf + ((long long)(c * nstore + slot) * npart + w) * n;
  float* pbc = pb ? pb + ((long long)c * npolf + q) * n : nullptr;
  const float* grc = gr + (long long)c * n;
  const float* gic = gi + (long long)c * n;
  const int lg = __ffs(CR) - 1;
  const int half = R2 / 2;
  const int k2lo = rank * (R2 / CR);
  // consecutive threads on consecutive k1 (runs of CR bins), each read
  // from the CTA of that row: item t = threadIdx.x + T * ii (R2 = P * T
  // items), all P remote reads issued before the first is used
  float2 x[P];
  int k[P];  // bins of the window: N <= 2^23
#pragma unroll
  for (int ii = 0; ii < P; ++ii) {
    const int t = threadIdx.x + T * ii;
    const int r = t & (CR - 1);
    const int k2 = k2lo + (t >> lg);
    x[ii] = cluster.map_shared_rank(sm, r)[sidx(k2)];
    k[ii] = ((k2 + half) & (R2 - 1)) * R1 + a + r;
  }
#pragma unroll
  for (int ii = 0; ii < P; ++ii) {
    if (pbc) atomicAdd(pbc + k[ii], x[ii].x * x[ii].x + x[ii].y * x[ii].y);
    if (keep)
      y[k[ii]] = cmul(x[ii], make_float2(__ldg(grc + k[ii]), __ldg(gic + k[ii])));
  }
  cluster.sync();
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

// The Jones 2x2 mix (matrix convolution, the search front end only): where
// both pols' spectra of a bin first meet, in the inverse's load, output pol
// p is Y_p = J[p,0] X_0 + J[p,1] X_1.  mega_fwd2 and mega_fwd2c have already
// multiplied the scalar slot (ones, or an RFI mask) into X_0 and X_1: it is
// one factor a bin for both pols, so it commutes with the mix.  jones is
// float2[nchan, 4, N] (plane 2a + b, natural bin order as ybuf); with it
// every input pol is stored (store = 3).
//
// Output pol p's spectrum at bin offset k: y is X_0's ybuf slot (X_1's is
// pstride further on), jp is J[c, 2p] (J[c, 2p+1] is N further on,
// n_jones).  The kernels that mix are template instances of their own
// (JONES), so the unmixed loads keep their registers.
__device__ __forceinline__ float2 jones_mix(const float2* __restrict__ y,
                                            const float2* __restrict__ jp,
                                            long long pstride,
                                            long long n_jones, long long k) {
  return cadd(cmul(__ldg(jp + k), y[k]),
              cmul(__ldg(jp + n_jones + k), y[pstride + k]));
}

// The inverse kernels' first half: load the NS pols' freq_res-point slices
// of subband s, window w, input channel c from ybuf, inverse-FFT them
// (unscaled) and leave pol q's sample t at sm[q*seq_ld(M) + sidx(t)].
// With JONES, pol q is the mix of output pol jpol0 + q from the two stored
// input pols (jones_mix).  Ends with a barrier.
template <int P, int NS, bool JONES = false>
__device__ __forceinline__ void inverse_subband(
    const float2* __restrict__ ybuf, float2* sm, const float2* __restrict__ tw,
    int npart, int nsub, int M, int s, int w, int c,
    const float2* __restrict__ jones = nullptr, int jpol0 = 0) {
  const int T = M / P;
  const int ld = seq_ld(M);
  const long long n = (long long)nsub * M;
  const int j = threadIdx.x;
  float2 v[P];
  auto load = [&](int q, float2(&x)[P]) {
    if constexpr (JONES) {
      const float2* y =
          ybuf + ((long long)(c * 2) * npart + w) * n + (long long)s * M;
      const float2* jp =
          jones + ((long long)c * 4 + 2 * (jpol0 + q)) * n + (long long)s * M;
#pragma unroll
      for (int i = 0; i < P; ++i)
        x[i] = jones_mix(y, jp, (long long)npart * n, n, j + T * i);
    } else {
      const float2* src =
          ybuf + ((long long)(c * NS + q) * npart + w) * n + (long long)s * M;
#pragma unroll
      for (int i = 0; i < P; ++i) x[i] = src[j + T * i];
    }
  };
  fft_seqs<P, NS, +1, false>(v, load, sm, ld, j, M, __ffs(M) - 1, tw);
}

// The multi-pass inverse, for freq_res M past one CTA's shared memory or
// threads (M = q*R1, q = M / R1 = R2 / nsub).  With the spectrum in natural
// order k = k2*R1 + k1 (centred for complex input, as mega_fwd2c stores it,
// so that the complex input's column shift is already made), subband s
// holds rows k2 = s*q + k2l (k2l < q), and its sample t = n2 + q*n1 (n2 < q,
// n1 < R1) is, with X_s[k2l*R1 + k1] its bins,
//   x[t] = 1/M sum_{k1} exp(2 pi i k1 n1 / R1) exp(2 pi i k1 n2 / M)
//          sum_{k2l} exp(2 pi i k2l n2 / q) X_s[k2l*R1 + k1],
// so the inverse runs as two passes through device memory, as the forward
// does, with zbuf between (the forward's cbuf, free by then and as large):
//   mega_inva  (pass A) per (window, tile of S consecutive k1, subband,
//              input channel, output pol): the [q, S] box of the pol's
//              spectrum (rows s*q + k2l, R1 apart), the length-q inverse
//              over k2l of each column (the Jones mix before it), times
//              exp(+2 pi i k1 n2 / M), stored as the [q, S] box Z[s*M +
//              n2*R1 + k1] of the same offsets.
//   pass B     per (tile of S consecutive rows r = s*q + n2, window, input
//              channel): the length-R1 inverse over k1 of each row of every
//              output pol, then 1/M, and sample t of output channel
//              c*nsub + s: megafil_invb (megafil.cu) detects it or stores
//              its voltage, mega_invbfold (megastep.cu, through
//              inverse_rows) folds it.
// At nsub == 1, q = R2 and M = N: the hybrid_conv32 convolution.  The TPU
// kernel ran the same split as dense DFT matmuls in VMEM (the
// block-diagonal radix-q matrix, the twiddle and the radix-R1 matrix,
// dspsr_tpu/ops/megakernel.py:385-406); here each stage is the
// register-resident FFT.  tb is the table buffer of (R1, q, M): tb.row the
// length-q FFT table, tb.r1 the length-R1 one, the inter-stage factors
// lo/hi over M.  zbuf is float2[nchan*nout, npart, N].
//
// mega_inva (build_megastep's and build_megafil's multi-pass inverse, pass
// A) moves the spectra in and zbuf out once and does 5 q log2 q operations
// a point: bound by bytes (hybrid_conv32: 2.15 GB, 0.64 ms at 3.35 TB/s).
// The first form gathered tiles of 8 columns (64-byte runs, half of each
// 128-byte line left to another CTA), held its 16 points a thread in
// registers with nothing in flight during the FFT, spilled 72-208 bytes a
// thread under the 128-register cap of its 512-thread launch bound, read
// two twiddle tables a point, and reloaded both input pols and two Jones
// planes for each output pol: 1.6 TB/s at best (hybrid_conv32 1.345 ms,
// conv32_jones 2.59, J0613 1.36; H100, 700 W).  Now:
// - a tile is S >= 16 consecutive k1 where R1 allows (INVA_COLS in
//   kernels/megastep.py; more where q is short, up to S*T = 512 threads),
//   so every row of the box is a run of 128 bytes or more, loaded and
//   stored whole;
// - one persistent CTA an SM (kPassStages stages of q*S points each, 192 KB
//   at q = 512) walks the tiles in order (window fastest, so the CTAs that
//   run together read one column tile of every window, and its Jones rows
//   from L2), with the next stages' boxes in flight (cp.async, 16 bytes a
//   thread) while one is transformed and stored;
// - the FFT runs in place in the landed box (ColIdx: the half-warp on 16
//   consecutive columns of one element, so no bank conflicts), the result
//   in registers (KEEP), twiddled by a recurrence from two table reads a
//   thread (the per-point reads scattered over the lo table, a line a
//   lane) and stored in runs of S;
// - with Jones, a tile's two input pols are two stages: both output pols
//   are mixed from them in place (each input and Jones value read once),
//   then transformed in turn.
// No spills and no local memory at 101-127 registers.  Measured (H100, 700
// W, with item 9's bit reversal in registers): 0.86-0.89 ms hybrid_conv32,
// 1.84 conv32_jones, 0.75-0.76 at J0613, 0.22 at J1713, where the first
// form with the same fix took 0.98-0.99, 1.86-1.87, 0.91, 0.26.  Not kept
// (measured before that fix, when this form took 1.24, 2.21, 0.92, 0.22):
// the launch bound alone (256 threads: no spills, one CTA an SM by
// registers; hybrid_conv32 1.869, conv32_jones 2.125); the tables read a
// point (1.342, 2.788, J0613 1.03); the box column by column with each
// column's threads a warp exchanging by __syncwarp (8-byte copies, a
// twiddled store from shared memory: 1.605, 3.186, 1.34).  What holds it
// at q = 512 is the FFT's three passes of block barriers in one CTA an SM
// (two passes at J0613's q = 128: 0.75 ms for the same bytes), and with
// Jones the mix's Jones reads, two planes of every bin.
constexpr int kPassStages = 3;  // ring stages of mega_inva

// The tile walk of both passes: items blockIdx.x, blockIdx.x + gridDim.x,
// ... of `nitems`; how many this CTA takes.
__device__ __forceinline__ int local_items(int nitems) {
  return (int)blockIdx.x < nitems
             ? (nitems - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
             : 0;
}

// Item it of pass A's walk (window fastest, then column tile, subband,
// channel, output pol): window w, first column k0, subband s, channel c,
// output pol p.
__device__ __forceinline__ void inva_item(int it, int npart, int ntile,
                                          int S, int nsub, int nchan, int& w,
                                          int& k0, int& s, int& c, int& p) {
  w = it % npart;
  it /= npart;
  k0 = (it % ntile) * S;
  it /= ntile;
  s = it % nsub;
  it /= nsub;
  c = it % nchan;
  p = it / nchan;
}

// The [q, S] box at src (rows R1 apart) into dst row-major, by every
// thread of the block with cp.async (16-byte pieces, or 8 where S is 1),
// committed as one group.
__device__ __forceinline__ void inva_copy(float2* dst,
                                          const float2* __restrict__ src,
                                          int q, int S, int R1) {
  if (S >= 2) {
    const int lgh = __ffs(S) - 2;  // 16-byte pieces a row: S / 2
    for (int x = threadIdx.x; x < (q * S) >> 1; x += blockDim.x) {
      const int r = x >> lgh;
      const int h = 2 * (x - (r << lgh));
      cp_async16(dst + r * S + h, src + (long long)r * R1 + h);
    }
  } else {
    for (int r = threadIdx.x; r < q; r += blockDim.x)
      cp_async8(dst + r, src + (long long)r * R1);
  }
  cp_commit();
}

// exp(+2 pi i e / M) from the lo/hi tables of M (e mod M).
__device__ __forceinline__ float2 inv_turn(const Tables& tb, int e) {
  e &= (1 << tb.log2n) - 1;
  const float2 t = cmul(__ldg(tb.hi + (e >> tb.lo_bits)),
                        __ldg(tb.lo + (e & ((1 << tb.lo_bits) - 1))));
  return make_float2(t.x, -t.y);
}

// Pass A (see above): S*T threads, thread (col, j) = (tid mod S, tid / S)
// on column k0 + col of the tile, T = q/P threads a column.  Item i of the
// walk is (window, column tile, subband, channel[, output pol]); its units
// (one input pol each: the pol itself, or under JONES both input pols)
// land in consecutive stages, the box row-major (element (e, col) at e*S +
// col, where the transform runs in place: ColIdx).  The twiddle of element
// n2 = j + T*i of column k1 is exp(+2 pi i k1 n2 / M) = f g^i, f and g
// from the tables once a thread (exp(+2 pi i k1 j / M), exp(+2 pi i k1 T /
// M)), the powers by recurrence (within 3e-6 after 15 steps).
template <int P, bool JONES>
__global__ void __launch_bounds__(kMaxThreads, 1)
mega_inva(const float2* __restrict__ ybuf, float2* __restrict__ zbuf,
          const float2* __restrict__ jones, Tables tb, int nchan, int nout,
          int jpol0, int npart, int R1, int R2, int q, int S) {
  extern __shared__ float2 sm[];
  constexpr int NU = JONES ? 2 : 1;
  const int T = q / P;
  const int col = threadIdx.x & (S - 1);
  const int j = threadIdx.x / S;
  const int ntile = R1 / S;
  const int nsub = R2 / q;
  const long long n = (long long)R1 * R2;
  const int stage = q * S;
  const int nlocal =
      local_items(npart * ntile * nsub * nchan * (JONES ? 1 : nout));
  const int nunits = nlocal * NU;
  // issue units up to `upto` (unit u: input pol u % NU of item u / NU, to
  // stage u % kPassStages)
  int issued = 0;
  auto refill = [&](int upto) {
    for (upto = min(nunits, upto); issued < upto; ++issued) {
      int w, k0, s, c, p;
      inva_item(blockIdx.x + (issued / NU) * gridDim.x, npart, ntile, S, nsub,
                nchan, w, k0, s, c, p);
      const int slot = JONES ? c * 2 + issued % NU : c * nout + p;
      inva_copy(sm + (issued % kPassStages) * stage,
                ybuf + ((long long)slot * npart + w) * n +
                    (long long)s * q * R1 + k0,
                q, S, R1);
    }
  };
  refill(kPassStages);
  float2 v[P];
  for (int k = 0; k < nlocal; ++k) {
    int w, k0, s, c, p;
    inva_item(blockIdx.x + k * gridDim.x, npart, ntile, S, nsub, nchan, w, k0,
              s, c, p);
    cp_wait(issued - (k + 1) * NU);  // this item's units, this thread's part
    __syncthreads();                 // ... and every thread's
    float2* st0 = sm + ((k * NU) % kPassStages) * stage;
    float2* st1 = sm + ((k * NU + NU - 1) % kPassStages) * stage;
    const int k1 = k0 + col;
    const long long off = (long long)s * q * R1 + k1;
    if constexpr (JONES) {
      // output pols jpol0 (, jpol0 + 1) from both input pols, in place, on
      // the elements this thread transforms
      const float2* jp = jones + ((long long)c * 4 + 2 * jpol0) * n + off;
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int e = (j + T * i) * S + col;
        const long long kk = (long long)(j + T * i) * R1;
        const float2 a = st0[e];
        const float2 b = st1[e];
        st0[e] = cadd(cmul(__ldg(jp + kk), a), cmul(__ldg(jp + n + kk), b));
        if (nout > 1)
          st1[e] = cadd(cmul(__ldg(jp + 2 * n + kk), a),
                        cmul(__ldg(jp + 3 * n + kk), b));
      }
    }
    for (int po = 0; po < (JONES ? nout : 1); ++po) {
      float2* st = po ? st1 : st0;
      auto load = [&](int, float2(&x)[P]) {
#pragma unroll
        for (int i = 0; i < P; ++i) x[i] = st[(j + T * i) * S + col];
        __syncthreads();  // every read before the first pass writes the box
      };
      if constexpr (P == 1)
        load(0, v);  // q == 1: nothing to transform
      else
        fft_seqs<P, 1, +1, true>(v, load, st + col, 0, j, q, __ffs(q) - 1,
                                 tb.row, ColIdx{S});
      // the item's stages are read out (the transform's last reads end at a
      // barrier): refill them while this pol is stored
      if (po == (JONES ? nout : 1) - 1) refill((k + 1) * NU + kPassStages);
      float2* dst = zbuf +
                    ((long long)(c * nout + (JONES ? po : p)) * npart + w) *
                        n +
                    off;
      float2 f = inv_turn(tb, k1 * j);
      const float2 g = inv_turn(tb, k1 * T);
#pragma unroll
      for (int i = 0; i < P; ++i) {
        dst[(long long)(j + T * i) * R1] = cmul(v[i], f);
        f = cmul(f, g);
      }
    }
  }
}

// mega_invbfold's transform (pass B of the fold; megafil_invb copies its
// rows in first): rows a .. a + S - 1 of zbuf (R1 points each, row r
// at r*R1) of each of NS output pols, window w, input channel c,
// inverse-FFT'd (unscaled): pol q's row a + i ends at sm[(q*S + i) *
// seq_ld(R1) + sidx(n1)].  Ends with a barrier.
template <int P, int NS>
__device__ __forceinline__ void inverse_rows(
    const float2* __restrict__ zbuf, float2* sm, const float2* __restrict__ tw,
    int npart, int R1, long long n, int a, int w, int c, int S) {
  const int T = R1 / P;
  const int ld = seq_ld(R1);
  const int i = threadIdx.x / T;  // row of the tile
  const int j = threadIdx.x - i * T;
  const float2* src =
      zbuf + ((long long)(c * NS) * npart + w) * n + (long long)(a + i) * R1;
  float2 v[P];
  auto load = [&](int q, float2(&x)[P]) {
    const float2* z = src + (long long)q * npart * n;
#pragma unroll
    for (int ii = 0; ii < P; ++ii) x[ii] = z[j + T * ii];
  };
  fft_seqs<P, NS, +1, false>(v, load, sm + i * ld, S * ld, j, R1,
                             __ffs(R1) - 1, tw);
}

// The passes a resource query names (the wrappers' `which`).
enum Pass {
  kFwd1 = 0,        // mega_fwd1, tile of `tile` columns
  kFwd2 = 1,        // mega_fwd2 (`tile` row pairs) or mega_fwd2c (`tile` rows)
  kInv = 2,         // the one-CTA inverse (megafil_invdet/invvolt, mega_invfold)
  kInvA = 3,        // mega_inva, tile of `tile` (k1, subband) sequences
  kInvB = 4,        // pass B, tile of `tile` rows
  kRowFft = 5,      // mega_rowfft
  kRowPair = 6,     // mega_rowpair
  kFwd2Cluster = 7, // mega_fwd2cc, one row a CTA (`tile` CTAs a cluster)
};

// Columns of a mega_rowpair tile.
__host__ __device__ inline int pair_cols(int R2) {
  return R2 < kPairCols ? R2 : kPairCols;
}

// Shared-memory bytes (kind 0) or threads (kind 1) of pass `which` (Pass):
// nout pols inverted, cplx the complex input's layout.
int pass_resources(int kind, int which, int R1, int row_len, int M, int nout,
                   int tile, int cplx) {
  const int F2 = (int)sizeof(float2);
  const int R2 = cplx ? row_len : row_len / 2;
  switch (which) {
    case kFwd1:
      return kind ? tile * (R1 / fft_points(R1)) : tile * seq_ld(R1) * F2;
    case kFwd2:
      return kind ? tile * (row_len / fft_points(row_len))
                  : (cplx ? 1 : 2) * tile * seq_ld(row_len) * F2;
    case kInv:
      return kind ? M / fft_points(M) : nout * seq_ld(M) * F2;
    case kInvA: {
      const int q = M / R1;
      return kind ? tile * (q / fft_points(q)) : kPassStages * q * tile * F2;
    }
    case kInvB:
      return kind ? tile * (R1 / fft_points(R1))
                  : nout * tile * seq_ld(R1) * F2;
    case kRowFft:
      return kind ? (row_len / 2) / row_points(row_len / 2)
                  : seq_ld(row_len / 2) * F2;
    case kRowPair:
      return kind ? kPairRows * pair_cols(R2) : 0;
    case kFwd2Cluster:
      return kind ? R2 / fft_points(R2) : seq_ld(R2) * F2;
    default:
      return -1;
  }
}

// The mega_inva instance for length q and the Jones mix (J) or not.
template <bool J>
decltype(&mega_inva<16, J>) inva_kernel(int q) {
  switch (fft_points(q)) {
    case 16: return &mega_inva<16, J>;
    case 8: return &mega_inva<8, J>;
    case 4: return &mega_inva<4, J>;
    case 2: return &mega_inva<2, J>;
    default: return &mega_inva<1, J>;
  }
}

// Registers, local (spill) bytes and the most threads a block of `kernel`
// may have, into out[0..2].
template <class K>
cudaError_t kernel_attributes(K kernel, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = a.maxThreadsPerBlock;
  return cudaSuccess;
}

// The mega_rowfft instance for rows of row_len points (32 .. 16384, a
// power of two), or null.
decltype(&mega_rowfft<16>) row_kernel(int row_len) {
  switch (row_len) {
    case 32: return &mega_rowfft<16>;
    case 64: return &mega_rowfft<32>;
    case 128: return &mega_rowfft<64>;
    case 256: return &mega_rowfft<128>;
    case 512: return &mega_rowfft<256>;
    case 1024: return &mega_rowfft<512>;
    case 2048: return &mega_rowfft<1024>;
    case 4096: return &mega_rowfft<2048>;
    case 8192: return &mega_rowfft<4096>;
    case 16384: return &mega_rowfft<8192>;
    default: return nullptr;
  }
}

// The long row pass's mega_rowfft for rows of row_len points, R1 rows a
// window: its registers, local (spill) bytes and most threads a block
// (kernel_attributes), the CTAs of its cluster, and how many such clusters
// the card holds at once (cudaOccupancyMaxActiveClusters), into
// out[0..4].
cudaError_t row_attributes(int R1, int row_len, int* out) {
  const auto k = row_kernel(row_len);
  if (!k) return cudaErrorInvalidValue;
  cudaError_t err = kernel_attributes(k, out);
  if (err != cudaSuccess) return err;
  const int smem = pass_resources(0, kRowFft, R1, row_len, 0, 0, 0, 0);
  if ((err = cudaFuncSetAttribute(
           k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
      cudaSuccess)
    return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * R1);
  cfg.blockDim = dim3(pass_resources(1, kRowFft, R1, row_len, 0, 0, 0, 0));
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 2;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  out[3] = 2;
  return cudaOccupancyMaxActiveClusters(&out[4], k, &cfg);
}

// The persistent grid of a walk over `items`: as many CTAs of `kernel`
// (threads, smem) as the card holds at once, at most one an item.
template <class K>
cudaError_t persistent_grid(K kernel, int threads, int smem, long long items,
                            int* grid) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev, sms, per_sm;
  if (err != cudaSuccess || (err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long most = (long long)sms * per_sm;
  *grid = (int)(items < most ? (items > 0 ? items : 1) : most);
  return cudaSuccess;
}

// Pass A on the caller's stream: ybuf -> zbuf (see mega_inva); tw2 is the
// table buffer of (R1, q, M), ta the columns S of a tile.
cudaError_t launch_inva(const void* ybuf, void* zbuf, const void* jones,
                        const void* tw2, int nchan, int nout, int jpol0,
                        int npart, int R1, int R2, int M, int ta,
                        cudaStream_t stream) {
  const int q = M / R1;
  if (ta < 1 || (ta & (ta - 1)) || R1 % ta || (jones && jpol0 + nout > 2))
    return cudaErrorInvalidValue;
  const int threads = pass_resources(1, kInvA, R1, R2, M, nout, ta, 1);
  const int smem = pass_resources(0, kInvA, R1, R2, M, nout, ta, 1);
  const auto k = jones ? inva_kernel<true>(q) : inva_kernel<false>(q);
  int grid;
  const cudaError_t err = persistent_grid(
      k, threads, smem,
      (long long)npart * (R1 / ta) * (R2 / q) * nchan * (jones ? 1 : nout),
      &grid);
  if (err != cudaSuccess) return err;
  return launch(k, dim3(grid), threads, smem, stream, (const float2*)ybuf,
                (float2*)zbuf, (const float2*)jones, tables(tw2, R1, q, M),
                nchan, nout, jpol0, npart, R1, R2, q, ta);
}

// The mega_polpow instance of code kind `code`.
decltype(&mega_polpow<kCode8>) polpow_kernel(int code) {
  switch (code) {
    case kCode1: return &mega_polpow<kCode1>;
    case kCode2: return &mega_polpow<kCode2>;
    case kCode4: return &mega_polpow<kCode4>;
    case kCodeJA98: return &mega_polpow<kCodeJA98>;
    case kCodeF32: return &mega_polpow<kCodeF32>;
    case kCodeJA98W: return &mega_polpow<kCodeJA98W>;
    default: return &mega_polpow<kCode8>;
  }
}

// The mega_fwd1 instance of code kind `code` (the CASPSR layout is 8-bit
// only).
template <int P, int LAYOUT>
decltype(&mega_fwd1<P, LAYOUT, kCode8>) fwd1_kernel(int code) {
  if constexpr (LAYOUT == kRealCaspsr) {
    return &mega_fwd1<P, LAYOUT, kCode8>;
  } else {
    switch (code) {
      case kCode1: return &mega_fwd1<P, LAYOUT, kCode1>;
      case kCode2: return &mega_fwd1<P, LAYOUT, kCode2>;
      case kCode4: return &mega_fwd1<P, LAYOUT, kCode4>;
      case kCodeJA98: return &mega_fwd1<P, LAYOUT, kCodeJA98>;
      case kCodeF32: return &mega_fwd1<P, LAYOUT, kCodeF32>;
      case kCodeJA98W: return &mega_fwd1<P, LAYOUT, kCodeJA98W>;
      default: return &mega_fwd1<P, LAYOUT, kCode8>;
    }
  }
}

// Launch a kernel as clusters of `cluster` CTAs along x (grid, threads
// and shared memory from the caller) on `stream`.
template <class... KP, class... A>
cudaError_t launch_cluster(void (*kernel)(KP...), dim3 grid, int threads,
                           int smem, int cluster, cudaStream_t stream,
                           A... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if ((err = cudaLaunchKernelEx(&cfg, kernel, args...)) != cudaSuccess)
    return err;
  return cudaGetLastError();
}

// The forward half on the caller's stream: raw codes -> (the
// channel-transposed copy ftp) -> (psum) -> cbuf float2[nchan * nseq,
// npart, R1, row_len] (nseq 1 for real input, npolf for complex) -> ybuf
// float2[nchan*nstore, npart, R1*R2], the chirped spectrum of each pol in
// `store` (bit 0 the first transformed pol, bit 1 the second; nstore of
// them) in natural bin order (centred for complex input).  psum is
// float[nchan, npart, 2]; tw is the wrapper's table buffer (Tables); pb,
// when not null, gets the passband float[nchan, npolf, R1*R2] (zeroed
// here).  layout is a Layout (row_len = R2 for kComplexTfp), code a Code;
// for JA98 codes the pre-pass runs first and writes u.nlow, wblk
// float[nchan, nweights] and the window weights wwin float[nchan, npart].
// ftp is the copy's buffer (nchan streams of ftp_stride(T) samples, a
// unit of npd codes in whole bytes or, where they fill less than one, a
// byte a code: kernels/megastep.py::ftp_nbytes) exactly when nchan > 1
// (TFP; CASPSR is one channel), else null.  For complex input tk is the
// rows of a mega_fwd2c tile, or from R2 = kClusterR2 the CTAs of a
// mega_fwd2cc cluster.
cudaError_t launch_forward(const void* raw, const void* gr, const void* gi,
                           const void* tw, void* psum, void* cbuf, void* ybuf,
                           void* pb, void* ftp, int nchan, int npol, int pol0,
                           int npolf, int store, int npart, int R1, int R2,
                           int M, int code, const Unpack& u, void* wblk,
                           void* wwin, int nsamp_step, int tc, int tk,
                           int layout, cudaStream_t stream) {
  const bool cplx = layout == kComplexTfp;
  const int row_len = cplx ? R2 : 2 * R2;
  const int two_n = R1 * row_len;
  const int npd = npol * (cplx ? 2 : 1);
  const long long T = (long long)(npart - 1) * nsamp_step + two_n;
  const long long tp = ftp_stride(T);
  const Tables tb = tables(tw, R1, row_len, M);
  cudaError_t err;
  if (tc > kMaxCols) return cudaErrorInvalidValue;
  if (store < 1 || store > 3 || (npolf == 1 && store != 1))
    return cudaErrorInvalidValue;
  if (layout < kRealTfp || layout > kComplexTfp) return cudaErrorInvalidValue;
  if (code < kCode8 || code > kCodeF32 ||
      (layout == kRealCaspsr && (code != kCode8 || nchan != 1)))
    return cudaErrorInvalidValue;
  if ((ftp != nullptr) != (nchan > 1)) return cudaErrorInvalidValue;
  // mega_fwd1's JA98 level table (16 bytes a row and npw-sample block of
  // its tile) lives in its exchange area
  if (code == kCodeJA98 &&
      16 * R1 * (tc > (1 << u.lg_npw) ? tc >> u.lg_npw : 1) >
          pass_resources(0, kFwd1, R1, row_len, M, 0, tc, cplx))
    return cudaErrorInvalidValue;
  if (cplx && R2 >= kClusterR2 &&
      (tk < 1 || tk > kClusterRows || (tk & (tk - 1)) || R1 % tk))
    return cudaErrorInvalidValue;
  // what mega_polpow and mega_fwd1 read: channel c's one-channel stream at
  // code c * cs of src, codes of kind kcode (sub-byte units widened)
  const uint8_t* src = (const uint8_t*)(ftp ? ftp : raw);
  const long long cs = tp * npd;
  int kcode = code;
  if (ftp && npd * code_bits(code) < 8)
    kcode = code == kCodeJA98 ? kCodeJA98W : kCode8;
  if (code == kCodeJA98) {
    if ((err = launch_ja98(raw, u, wblk, wwin, nchan, npol, cplx ? 2 : 1,
                           npart, nsamp_step, two_n, ftp, tp, stream)) !=
        cudaSuccess)
      return err;
  } else if (ftp &&
             (err = launch_ftp(raw, ftp, T, nchan, npd, code_bits(code),
                               u.twos, tp, stream)) != cudaSuccess) {
    return err;
  }
  if (pb && (err = cudaMemsetAsync(
                 pb, 0, (size_t)nchan * npolf * R1 * R2 * sizeof(float),
                 stream)) != cudaSuccess)
    return err;
  if (!cplx && npolf == 2) {
    if ((err = cudaMemsetAsync(psum, 0, (size_t)nchan * npart * 2 * sizeof(float),
                               stream)) != cudaSuccess)
      return err;
    const int chunks = two_n >= 8192 ? two_n / 8192 : 1;
    const auto polpow = polpow_kernel(kcode);
    polpow<<<dim3(chunks, npart, nchan), kThreads, 0, stream>>>(
        src, (float*)psum, cs, npol, npart, nsamp_step, two_n, u,
        layout == kRealCaspsr);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  auto fwd1 = R1 >= 16 ? fwd1_kernel<16, kRealTfp>(kcode)
                       : fwd1_kernel<8, kRealTfp>(kcode);
  if (cplx)
    fwd1 = R1 >= 16 ? fwd1_kernel<16, kComplexTfp>(kcode)
                    : fwd1_kernel<8, kComplexTfp>(kcode);
  else if (layout == kRealCaspsr)
    fwd1 = R1 >= 16 ? fwd1_kernel<16, kRealCaspsr>(kcode)
                    : fwd1_kernel<8, kRealCaspsr>(kcode);
  const int nseq = cplx ? npolf : 1;
  const int smem1 = pass_resources(0, kFwd1, R1, row_len, M, 0, tc, cplx);
  if ((err = launch(fwd1, dim3(nchan * nseq, row_len / tc, npart),
                    pass_resources(1, kFwd1, R1, row_len, M, 0, tc, cplx),
                    smem1, stream, src, (float2*)cbuf, (const float*)psum,
                    tb, cs, npol, pol0, npolf, npart, R1, row_len,
                    nsamp_step, tc, u)) != cudaSuccess)
    return err;
  if (cplx && R2 >= kClusterR2)
    return launch_cluster(
        &mega_fwd2cc<16>, dim3(R1, npart, nchan * npolf),
        pass_resources(1, kFwd2Cluster, R1, row_len, M, 0, tk, 1),
        pass_resources(0, kFwd2Cluster, R1, row_len, M, 0, tk, 1), tk,
        stream, (const float2*)cbuf, (float2*)ybuf, (const float*)gr,
        (const float*)gi, (float*)pb, tb, npolf, store, npart, R1, R2);
  const int threads2 = pass_resources(1, kFwd2, R1, row_len, M, 0, tk, cplx);
  const int smem2 = pass_resources(0, kFwd2, R1, row_len, M, 0, tk, cplx);
  if (cplx) {
    auto fwd2 = row_len >= 16 ? &mega_fwd2c<16>
                : (row_len == 8 ? &mega_fwd2c<8> : &mega_fwd2c<4>);
    return launch(fwd2, dim3(R1 / tk, npart, nchan * npolf), threads2, smem2,
                  stream, (const float2*)cbuf, (float2*)ybuf,
                  (const float*)gr, (const float*)gi, (float*)pb, tb, npolf,
                  store, npart, R1, R2, tk);
  }
  if (tk == 0) {
    // the long row pass (see mega_rowfft): a cluster of two CTAs a row
    const auto rowfft = row_kernel(row_len);
    if (!rowfft) return cudaErrorInvalidValue;
    if ((err = launch_cluster(
             rowfft, dim3(2 * R1, npart, nchan),
             pass_resources(1, kRowFft, R1, row_len, M, 0, 0, 0),
             pass_resources(0, kRowFft, R1, row_len, M, 0, 0, 0), 2, stream,
             (float2*)cbuf, tb, npart, R1)) != cudaSuccess)
      return err;
    const int kc = pair_cols(R2);
    return launch(&mega_rowpair, dim3((R1 / kPairRows) * (R2 / kc), npart,
                                      nchan),
                  kPairRows * kc, 0, stream, (const float2*)cbuf,
                  (float2*)ybuf, (const float*)gr, (const float*)gi,
                  (const float*)psum, (float*)pb, npolf, store, npart, R1, R2,
                  row_len, kc);
  }
  auto fwd2 = row_len >= 16 ? &mega_fwd2<16> : &mega_fwd2<8>;
  return launch(fwd2, dim3(R1 / (2 * tk), npart, nchan), threads2, smem2,
                stream, (const float2*)cbuf, (float2*)ybuf, (const float*)gr,
                (const float*)gi, (const float*)psum, (float*)pb, tb, npolf,
                store, npart, R1, R2, row_len, tk);
}

}  // namespace
