// Helpers shared by the packed U-Net kernels (encoder.cu, tail.cu, head.cu).
//
// Activations travel between the kernels as NHWC (channels-last) tensors
// in the compute dtype: float or __nv_bfloat16. Every kernel reads its
// operands in that dtype, stages them in shared memory as float, sums in
// float and runs its epilogue in float; stores round to the dtype once
// (round to nearest even, as torch's .to(torch.bfloat16)). This is what
// the reference package's Pallas kernels do: bf16 operands, float32
// accumulation (preferred_element_type), a float32 epilogue table, stores
// in the compute dtype.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace spleeterrt {

constexpr int kUnetThreads = 256;

// Activation codes, as the Python wrappers pass them.
enum Act : int { kElu = 0, kLeaky = 1, kRelu = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and back: the value a store in T would keep.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// ELU with the reference's denormal guard (inputs below -15 give exactly
// -1, Executable/spleeter.c:51-56), leakyReLU(0.2), ReLU. The ELU uses
// expm1f like the plain version's F.elu; the TPU kernels use exp(x) - 1,
// about 1e-7 apart.
__device__ __forceinline__ float activate(float z, int act) {
  if (act == kElu) return z > 0.f ? z : (z < -15.f ? -1.f : expm1f(z));
  if (act == kLeaky) return z >= 0.f ? z : 0.2f * z;
  return fmaxf(z, 0.f);
}

// Stores N consecutive values, rounded to T, as 16-byte vectors; `dst`
// must be 16-byte aligned.
template <typename T, int N>
__device__ __forceinline__ void store_vec(T* dst, const float (&v)[N]) {
  constexpr int kPer = 16 / sizeof(T);
  static_assert(N % kPer == 0, "store_vec: N must fill whole 16-byte vectors");
#pragma unroll
  for (int i = 0; i < N; i += kPer) {
    alignas(16) T pack[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) pack[j] = from_f32<T>(v[i + j]);
    *reinterpret_cast<uint4*>(dst + i) = *reinterpret_cast<const uint4*>(pack);
  }
}

// Lets `kernel` take more than 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace spleeterrt
