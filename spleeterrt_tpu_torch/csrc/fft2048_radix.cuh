// A register-resident, mixed-radix 2048-point complex inverse FFT for one
// group of 128 threads (four warps), and the masked Hermitian merge that
// feeds it: the core of every FFT kernel, the inverse ones istft.cu (K7)
// and irfft.cu (K8, K9), and the forward STFT (stft.cu, K1), which runs it
// as forward(z) = conj(inverse(conj z)).
//
// 2048 = 16 * 16 * 8, in three self-sorting (Stockham) passes. Pass p
// with radix R after passes whose radices multiply to Ns computes, for each
// work item j < 2048 / R, with k = j mod Ns:
//   v[r] = in[j + r * 2048 / R] * exp(+2 pi i r k / (Ns R)),  r < R
//   v    = unnormalised inverse DFT_R(v)
//   out[(j / Ns) * Ns * R + k + r * Ns] = v[r]
// which leaves the transform in natural order, with no bit-reversal. Thread
// t is work item t of passes 1 and 2 (radix 16) and items t and t + 128 of
// pass 3 (radix 8); its values live in registers, where the radix-16 and
// radix-8 butterflies run, and only the two exchanges between passes go
// through shared memory: two round trips and three group barriers in place
// of a radix-2 core's eleven synchronised stages. The exchange buffer
// holds one float2 of padding after every 16, which makes every read and
// write of the three passes free of bank conflicts.
//
// Twiddles: the merge (and K1's split) reads tw[k] = exp(-2 pi i k /
// 4096) (the table of fft2048.cuh); passes 2 and 3 read their own tables,
// appended to it by the host, in [r][k] order so that neighbouring
// threads read neighbouring entries: exp(+2 pi i r k / 256) for r, k < 16
// at kPassTw2, and exp(+2 pi i r j / 2048) for r < 8, j < 256 at
// kPassTw3. All are float64
// values rounded once to float32 (kernels/__init__.py::irfft_twiddles).
#pragma once

#include "fft2048.cuh"

namespace spleeterrt {

constexpr int kRadixThreads = 128;             // threads per transform
constexpr int kRadixPad = kHalf + kHalf / 16;  // padded exchange buffer, float2
constexpr int kPassTw2 = kHalf;                // pass-2 table offset
constexpr int kPassTw3 = kHalf + 256;          // pass-3 table offset

static __device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
static __device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
static __device__ __forceinline__ float2 times_i(float2 a) {
  return make_float2(-a.y, a.x);
}

static __device__ __forceinline__ int radix_pad(int i) { return i + (i >> 4); }

// Bin k of the masked spectrum: X[k] times m[k] below bin_limit and
// out_band from it on, with the imaginary parts of DC and Nyquist dropped
// (irfft semantics). bin_limit 0 with out_band 1 gives X unmasked, exactly.
static __device__ __forceinline__ float2 masked_bin(const float2* __restrict__ X,
                                                    const float* __restrict__ m,
                                                    float out_band,
                                                    int bin_limit, int k) {
  float2 v = X[k];
  const float g = k < bin_limit ? m[k] : out_band;
  v.x *= g;
  v.y = (k == 0 || k == kHalf) ? 0.f : v.y * g;
  return v;
}

// Bin k < 2048 of the 2048-point complex input merged from the masked
// Hermitian half-spectrum Y (masked_bin of X):
// Z[k] = (Y[k] + conj Y[2048-k]) + i conj(W^k) (Y[k] - conj Y[2048-k]),
// whose unnormalised inverse FFT is N (y[2n] + i y[2n+1]).
static __device__ __forceinline__ float2 merged_bin(
    const float2* __restrict__ X, const float* __restrict__ m, float out_band,
    int bin_limit, const float2* __restrict__ tw, int k) {
  const float2 a = masked_bin(X, m, out_band, bin_limit, k);
  const float2 c = masked_bin(X, m, out_band, bin_limit, kHalf - k);
  const float2 b = make_float2(c.x, -c.y);
  float2 w = __ldg(&tw[k]);
  w.y = -w.y;
  const float2 t = cmul(w, make_float2(a.x - b.x, a.y - b.y));
  return make_float2(a.x + b.x - t.y, a.y + b.y + t.x);
}

// exp(+2 pi i p / 16); p is a constant once the callers' loops unroll.
static __device__ __forceinline__ float2 w16(int p) {
  constexpr float kCos[16] = {
      1.f, 0.92387953251128674f, 0.70710678118654752f, 0.38268343236508977f,
      0.f, -0.38268343236508977f, -0.70710678118654752f, -0.92387953251128674f,
      -1.f, -0.92387953251128674f, -0.70710678118654752f, -0.38268343236508977f,
      0.f, 0.38268343236508977f, 0.70710678118654752f, 0.92387953251128674f};
  return make_float2(kCos[p & 15], kCos[(p + 12) & 15]);
}

// Unnormalised inverse DFT of 4 values in place, natural order.
static __device__ __forceinline__ void idft4(float2& a0, float2& a1, float2& a2,
                                             float2& a3) {
  const float2 t0 = cadd(a0, a2), t1 = csub(a0, a2);
  const float2 t2 = cadd(a1, a3), t3 = times_i(csub(a1, a3));
  a0 = cadd(t0, t2);
  a2 = csub(t0, t2);
  a1 = cadd(t1, t3);
  a3 = csub(t1, t3);
}

// Unnormalised inverse DFT of 8 values in place (two radix-4 halves).
static __device__ __forceinline__ void idft8(float2 (&v)[8]) {
  idft4(v[0], v[2], v[4], v[6]);
  idft4(v[1], v[3], v[5], v[7]);
  const float2 o[4] = {v[1], cmul(v[3], w16(2)), times_i(v[5]),
                       cmul(v[7], w16(6))};
  const float2 e[4] = {v[0], v[2], v[4], v[6]};
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    v[m] = cadd(e[m], o[m]);
    v[m + 4] = csub(e[m], o[m]);
  }
}

// Unnormalised inverse DFT of 16 values in place (4 x 4).
static __device__ __forceinline__ void idft16(float2 (&v)[16]) {
#pragma unroll
  for (int r2 = 0; r2 < 4; ++r2) idft4(v[r2], v[r2 + 4], v[r2 + 8], v[r2 + 12]);
  // v[r2 + 4 m1] holds sub-transform r2 at m1; twiddle by w16^(r2 m1).
#pragma unroll
  for (int r2 = 1; r2 < 4; ++r2)
#pragma unroll
    for (int m1 = 1; m1 < 4; ++m1)
      v[r2 + 4 * m1] = cmul(v[r2 + 4 * m1], w16(r2 * m1));
#pragma unroll
  for (int m1 = 0; m1 < 4; ++m1)
    idft4(v[4 * m1], v[4 * m1 + 1], v[4 * m1 + 2], v[4 * m1 + 3]);
  // Output m1 + 4 m2 sits at v[4 m1 + m2]: transpose (register renaming).
  float2 u[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) u[i] = v[i];
#pragma unroll
  for (int m1 = 0; m1 < 4; ++m1)
#pragma unroll
    for (int m2 = 0; m2 < 4; ++m2) v[m1 + 4 * m2] = u[4 * m1 + m2];
}

// The 128 threads of one group, numbered by `bar` (a named barrier id in
// 1..15), wait for each other.
static __device__ __forceinline__ void group_sync(int bar) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "n"(kRadixThreads) : "memory");
}

// Inverse FFT of Z, where thread t (< 128) holds v[r] = Z[t + 128 r]; on
// return v[q] = z[t + 128 q], z = unnormalised inverse FFT of Z. `buf` is
// the group's kRadixPad-float2 exchange buffer, `ptw` the table with the
// pass twiddles, `bar` the group's barrier.
static __device__ __forceinline__ void ifft2048_regs(float2 (&v)[16], float2* buf,
                                                     const float2* __restrict__ ptw,
                                                     int t, int bar) {
  // Pass 1: radix 16, Ns = 1 (no twiddles).
  idft16(v);
#pragma unroll
  for (int r = 0; r < 16; ++r) buf[radix_pad(16 * t + r)] = v[r];
  group_sync(bar);

  // Pass 2: radix 16, Ns = 16.
  const int k2 = t & 15;
#pragma unroll
  for (int r = 0; r < 16; ++r) v[r] = buf[radix_pad(t + 128 * r)];
#pragma unroll
  for (int r = 1; r < 16; ++r) v[r] = cmul(v[r], __ldg(&ptw[kPassTw2 + 16 * r + k2]));
  group_sync(bar);  // every read of pass 1's output is done
  idft16(v);
  const int base = (t >> 4) * 256 + k2;
#pragma unroll
  for (int r = 0; r < 16; ++r) buf[radix_pad(base + 16 * r)] = v[r];
  group_sync(bar);

  // Pass 3: radix 8, Ns = 256, items t and t + 128 (k = j, idxD = j).
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = t + 128 * h;
    float2 u[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) u[r] = buf[radix_pad(j + 256 * r)];
#pragma unroll
    for (int r = 1; r < 8; ++r) u[r] = cmul(u[r], __ldg(&ptw[kPassTw3 + 256 * r + j]));
    idft8(u);
#pragma unroll
    for (int r = 0; r < 8; ++r) v[2 * r + h] = u[r];  // z[j + 256 r]
  }
}

}  // namespace spleeterrt
