// BS-RoFormer's rotary embedding in one pass: q and k from the to_qkvg
// product straight to the attention's operands.
//
// For row r of the product (r = n L + l, a sequence n of L positions) and
// its first 2 * inner columns, q's and k's heads side by side, each
// interleaved pair (x0, x1) = columns (2i, 2i + 1) of a head is turned by
// the table's (c, s) at position l = r mod L and pair i:
//   out[r, 2i] = x0 c - x1 s,   out[r, 2i + 1] = x0 s + x1 c
// in float32, each product rounded before the sum as in a complex64
// product (no fused multiply-add), then rounded once to the element type.
// `out` is (rows, 2 * inner), the (N, L, 2, heads, dim_head) layout the
// attention reads q and k from.
//
// It replaces no TPU kernel: the JAX package has no BS-RoFormer. It
// replaces the chain core/roformer.py::attention ran in torch: a float32
// copy of q and k, their complex64 product with the table and the cast
// back, 20 bytes of traffic for each bf16 element that needs 4.
//
// What bounds it on an H100: bytes. A batch-layer of the benchmark's cell
// (16 chunks, 801 frames x 62 bands = 794,592 rows, 8 heads of 64) reads
// 2 KB of q and k a row and writes 2 KB, 3.25 GB, 0.97 ms at 3.35 TB/s;
// 4 multiplies and 2 adds an element are far below the card's rate.
//
// The design:
// * A thread owns one 16-byte vector of one row (8 bf16 or 4 float32, one
//   head's pairs i..i+3 or i..i+1): one vector load, one vector store. A
//   row's vectors are neighbouring threads (threadIdx.x), so a warp reads
//   and writes 512 contiguous bytes; a block of 256 threads covers as many
//   rows as it holds (two at the cell's widths). At every SM's 2048
//   threads that is 32 KB of loads in flight an SM, enough to stream: 1.09
//   ms for the cell's batch-layer on an NVIDIA H100 80GB HBM3 at 700 W,
//   89% of the bound (chip_smoke.py). Two to eight rows a thread,
//   their loads issued before any was used, measured 0.3-1.0% slower.
// * The table ((L, dim_head / 2) float32 pairs, 205 KB at L = 801) is read
//   through L1 as 16-byte vectors: a row of it serves every one of q's and
//   k's heads at that position, and the whole table stays in L2.
// * The pair's position in its head is fixed for a thread, the position in
//   the sequence is one remainder; no shared memory, no barrier.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace spleeterrt {

constexpr int kRopeThreads = 256;  // threads a block, at most
constexpr int kRopeVecBytes = 16;

// One vector of the element type as float32 pairs, and back.
template <typename T> struct RopeVec;

template <> struct RopeVec<__nv_bfloat16> {
  static constexpr int kPairs = 4;
  static __device__ __forceinline__ float2 get(const uint4& u, int i) {
    return __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(&u)[i]);
  }
  static __device__ __forceinline__ void set(uint4& u, int i, float2 y) {
    reinterpret_cast<__nv_bfloat162*>(&u)[i] = __floats2bfloat162_rn(y.x, y.y);
  }
};

template <> struct RopeVec<float> {
  static constexpr int kPairs = 2;
  static __device__ __forceinline__ float2 get(const uint4& u, int i) {
    return reinterpret_cast<const float2*>(&u)[i];
  }
  static __device__ __forceinline__ void set(uint4& u, int i, float2 y) {
    reinterpret_cast<float2*>(&u)[i] = y;
  }
};

template <typename T>
static __global__ void __launch_bounds__(kRopeThreads)
rope_qk_kernel(const T* __restrict__ qkvg, const float2* __restrict__ rot, int rows,
               int length, long long row_stride, int cols, int half_head,
               T* __restrict__ out) {
  using V = RopeVec<T>;
  constexpr int kPerVec = kRopeVecBytes / static_cast<int>(sizeof(T));
  const int v = blockIdx.y * blockDim.x + threadIdx.x;  // the vector of a row
  const int r = blockIdx.x * blockDim.y + threadIdx.y;
  if (v * kPerVec >= cols || r >= rows) return;
  const uint4 x = __ldg(reinterpret_cast<const uint4*>(qkvg + r * row_stride) + v);
  // The vector's pairs at the row's position: kPairs float2, read as float4s.
  const float2* t =
      rot + static_cast<long long>(r % length) * half_head + v * V::kPairs % half_head;
  float2 cs[V::kPairs];
#pragma unroll
  for (int i = 0; i < V::kPairs; i += 2) {
    const float4 two = __ldg(reinterpret_cast<const float4*>(t + i));
    cs[i] = make_float2(two.x, two.y);
    cs[i + 1] = make_float2(two.z, two.w);
  }
  uint4 y;
#pragma unroll
  for (int i = 0; i < V::kPairs; ++i) {
    const float2 a = V::get(x, i);
    V::set(y, i, make_float2(__fsub_rn(__fmul_rn(a.x, cs[i].x), __fmul_rn(a.y, cs[i].y)),
                             __fadd_rn(__fmul_rn(a.x, cs[i].y), __fmul_rn(a.y, cs[i].x))));
  }
  reinterpret_cast<uint4*>(out + static_cast<long long>(r) * cols)[v] = y;
}

// A block is min(vectors a row, 256) threads across a row by as many rows
// as make 256 threads; grid y covers the rest of a row wider than 256
// vectors.
template <typename T>
static cudaError_t launch_rope(const void* qkvg, const void* rot, int rows, int length,
                               int row_stride, int cols, int half_head, void* out,
                               cudaStream_t stream) {
  const int vecs = cols / (kRopeVecBytes / static_cast<int>(sizeof(T)));
  const int bx = vecs < kRopeThreads ? vecs : kRopeThreads;
  const int by = kRopeThreads / bx;
  const dim3 grid((rows + by - 1) / by, (vecs + bx - 1) / bx);
  rope_qk_kernel<T><<<grid, dim3(bx, by), 0, stream>>>(
      static_cast<const T*>(qkvg), static_cast<const float2*>(rot), rows, length, row_stride,
      cols, half_head, static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace spleeterrt

// qkvg (rows, row_stride) of bf16 (bf16 = 1) or float32 (bf16 = 0), its
// first `cols` columns q and k, rows = N * length; rot (length, half_head)
// float32 pairs; out (rows, cols) of the same element type. cols a multiple
// of 2 * half_head, a head a whole number of 16-byte vectors; qkvg, rot
// and out 16-byte aligned, as is a row of qkvg (row_stride elements).
// Launches on `stream`; returns the cudaError_t of the launch.
extern "C" int spleeterrt_rope_qk(const void* qkvg, const void* rot, int rows, int length,
                                  int row_stride, int cols, int half_head, int bf16,
                                  void* out, void* stream) {
  using namespace spleeterrt;
  const int elem = bf16 ? 2 : 4;
  const int per_vec = kRopeVecBytes / elem;
  if (rows < 1 || length < 1 || half_head < 1 || cols < 1 || (2 * half_head) % per_vec ||
      cols % (2 * half_head) || row_stride < cols ||
      (static_cast<long long>(row_stride) * elem) % kRopeVecBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? launch_rope<__nv_bfloat16>(qkvg, rot, rows, length, row_stride, cols, half_head,
                                        out, s)
           : launch_rope<float>(qkvg, rot, rows, length, row_stride, cols, half_head, out, s));
}
