// Shared pieces of the FFT kernels: constants, complex helpers, and the
// radix-2 2048-point complex forward FFT in shared memory that the fused
// STFT (stft.cu, K1) runs. The inverse kernels (istft.cu K7, irfft.cu K8
// and K9) run the register-radix core of fft2048_radix.cuh instead.
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
constexpr int kLog2Half = 11;
constexpr int kThreads = 512;     // threads per block of the radix-2 core
constexpr float kInvN = 1.0f / kN;  // irfft scale, exact

static __device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

static __device__ __forceinline__ int bitrev11(int i) {
  return static_cast<int>(__brev(static_cast<unsigned>(i)) >> (32 - kLog2Half));
}

// In-place radix-2 decimation-in-time forward FFT of buf[0, 2048), which
// the caller filled in bit-reversed order and synchronised. Ends
// synchronised.
static __device__ __forceinline__ void fft2048(float2* buf, const float2* __restrict__ tw) {
  for (int half = 1; half < kHalf; half <<= 1) {
    const int stride = kHalf / half;  // W_{2 half}^j = tw[j * stride]
    for (int b = threadIdx.x; b < kHalf / 2; b += blockDim.x) {
      const int j = b & (half - 1);
      const int i0 = ((b - j) << 1) + j;
      const int i1 = i0 + half;
      const float2 w = __ldg(&tw[j * stride]);
      const float2 a = buf[i0];
      const float2 c = cmul(w, buf[i1]);
      buf[i0] = make_float2(a.x + c.x, a.y + c.y);
      buf[i1] = make_float2(a.x - c.x, a.y - c.y);
    }
    __syncthreads();
  }
}

}  // namespace spleeterrt
