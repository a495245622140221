// Shared pieces of the FFT kernels (stft.cu K1, istft.cu K7, irfft.cu K8
// and K9): the transform's constants and complex multiplication. Their
// 2048-point core is fft2048_radix.cuh.
//
// A real 4096-point transform runs as one 2048-point complex FFT of the
// even/odd sample pairs z[n] = x[2n] + i x[2n+1], plus an O(N) split step
// (stft.cu) or merge step (fft2048_radix.cuh::merged_bin). Twiddles come
// from one table, tw[j] = exp(-2 pi i j / 4096) for j in [0, 2048),
// computed in float64 on the host and rounded once to float32, so no
// on-card sin/cos is used.
#pragma once

#include <cuda_runtime.h>

namespace spleeterrt {

constexpr int kN = 4096;          // frame length (FFTSIZE)
constexpr int kHop = 1024;        // hop (HOPSIZE)
constexpr int kBins = kN / 2 + 1; // 2049 bins of the real transform
constexpr int kHalf = kN / 2;     // complex FFT length
constexpr float kInvN = 1.0f / kN;  // irfft scale, exact

static __device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

}  // namespace spleeterrt
