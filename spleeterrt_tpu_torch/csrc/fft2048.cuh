// Shared pieces of the fused STFT (stft.cu), masked iSTFT (istft.cu) and
// frames-out inverse FFT (irfft.cu) kernels: constants, complex helpers, a
// radix-2 2048-point complex FFT in shared memory (K1 and K7; irfft.cu
// runs the register-radix core of fft2048_radix.cuh) and the masked
// Hermitian merge that feeds the inverse.
//
// A real 4096-point transform runs as one 2048-point complex FFT of the
// even/odd sample pairs z[n] = x[2n] + i x[2n+1], plus an O(N) split step
// (stft.cu) or merge step (merge_hermitian). Twiddles come from one table,
// tw[j] = exp(-2 pi i j / 4096) for j in [0, 2048), computed in float64 on
// the host and rounded once to float32, so no on-card sin/cos is used.
#pragma once

#include <cuda_runtime.h>

namespace spleeterrt {

constexpr int kN = 4096;          // frame length (FFTSIZE)
constexpr int kHop = 1024;        // hop (HOPSIZE)
constexpr int kBins = kN / 2 + 1; // 2049 bins of the real transform
constexpr int kHalf = kN / 2;     // complex FFT length
constexpr int kLog2Half = 11;
constexpr int kThreads = 512;     // threads per block in every FFT kernel
constexpr float kInvN = 1.0f / kN;  // irfft scale, exact

static __device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

static __device__ __forceinline__ int bitrev11(int i) {
  return static_cast<int>(__brev(static_cast<unsigned>(i)) >> (32 - kLog2Half));
}

// In-place radix-2 decimation-in-time FFT of buf[0, 2048), which the caller
// filled in bit-reversed order and synchronised. kInverse selects the
// conjugate twiddles (unnormalised inverse). Ends synchronised.
template <bool kInverse>
static __device__ __forceinline__ void fft2048(float2* buf,
                                               const float2* __restrict__ tw) {
  for (int half = 1; half < kHalf; half <<= 1) {
    const int stride = kHalf / half;  // W_{2 half}^j = tw[j * stride]
    for (int b = threadIdx.x; b < kHalf / 2; b += blockDim.x) {
      const int j = b & (half - 1);
      const int i0 = ((b - j) << 1) + j;
      const int i1 = i0 + half;
      float2 w = __ldg(&tw[j * stride]);
      if (kInverse) w.y = -w.y;
      const float2 a = buf[i0];
      const float2 c = cmul(w, buf[i1]);
      buf[i0] = make_float2(a.x + c.x, a.y + c.y);
      buf[i1] = make_float2(a.x - c.x, a.y - c.y);
    }
    __syncthreads();
  }
}

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

// merged_bin for every k into buf, in bit-reversed order. Ends
// synchronised, ready for fft2048<true>.
static __device__ __forceinline__ void merge_hermitian(
    float2* buf, const float2* __restrict__ X, const float* __restrict__ m,
    float out_band, int bin_limit, const float2* __restrict__ tw) {
  for (int k = threadIdx.x; k < kHalf; k += blockDim.x)
    buf[bitrev11(k)] = merged_bin(X, m, out_band, bin_limit, tw, k);
  __syncthreads();
}

}  // namespace spleeterrt
