// Fused forward STFT (K1): audio -> complex spectrum + U-Net magnitude tiles.
//
// Replaces spleeterrt_tpu/kernels/stft_fused.py::_stft_kernel (reached
// through stft4096_packed). Per (row, frame): 4096 samples at 1024 * frame,
// times the analysis window, real FFT, then
//   spec[row, frame, k] = X[k]                 for k in [0, 2048]
//   mag[tile, row, t, k] = |X[k]|              for k < bin_limit
// with frame = tile * time_step + t: the magnitude lands directly in the
// U-Net's NCHW tile layout, so no separate magnitude or tiling pass runs.
// Frames in [n_comp, n_req) are exact zeros (the reference computes
// n_comp frames and leaves the rest zero, Executable/stftFix.c:377,460).
//
// What bounds it on an H100: bytes written. Each frame reads 16 KB of audio
// (4 KB new per hop, the rest shared with its neighbours through L1/L2) and
// writes 16 KB of spectrum plus 4 * bin_limit bytes of magnitude; the FFT
// is ~0.25 MFLOP per frame, far below the card's compute.
//
// The design: the register-radix core of the inverse kernels
// (fft2048_radix.cuh), run forward as conj(inverse(conj z)). A frame is a
// group of 128 threads with its own named barrier; a block holds `groups`
// groups on consecutive frames of one row, whose audio overlaps in L1.
// * Load: thread t takes z[n] = x[2n] w[2n] + i x[2n+1] w[2n+1] at n = t +
//   128 r (r < 16) as coalesced float2 pairs (scalar loads where the row
//   start is not 8-byte aligned, or the frame runs past the row's end),
//   conjugated, straight into the registers the core transforms.
// * FFT: three Stockham passes (radix 16, 16, 8) in registers, two padded
//   shared-memory exchanges; thread t ends holding Z[t + 128 q], q < 16.
// * Split: X[k] = E[k] + W^k O[k] needs Z[k] and Z[2048 - k], which sit in
//   threads t and (128 - t) mod 128. Z goes through the group's exchange
//   buffer once more, and thread t forms bins t + 128 q, storing spec as
//   coalesced float2 and |X| below bin_limit as coalesced floats into the
//   tile row. Each value is written once in a fixed order of operations,
//   so two runs are bit-identical.
// The TPU kernel's [c, d] packing and per-frame matmul tables exist for its
// matrix unit and are not carried over.
#include "fft2048_radix.cuh"

namespace spleeterrt {

constexpr int kMaxStftGroups = 4;  // 128-thread groups a block, at most

// At most 64 registers a thread: four blocks of two groups an SM (the 16
// named barriers a block allow no more), where 72 registers held three.
static __global__ void __launch_bounds__(kMaxStftGroups * kRadixThreads, 2)
stft4096_kernel(const float* __restrict__ audio, long long data_size,
                const float* __restrict__ window,
                const float2* __restrict__ tw, int n_comp, int n_req,
                int rows, int bin_limit, int time_step,
                float2* __restrict__ spec, float* __restrict__ mag) {
  extern __shared__ float2 bufs[];  // [groups a block][kRadixPad]
  const int group = threadIdx.x / kRadixThreads;
  const int t = threadIdx.x % kRadixThreads;
  const int f = blockIdx.x * (blockDim.x / kRadixThreads) + group;
  if (f >= n_req) return;  // the whole group: its barrier is its own
  const int r = blockIdx.y;
  float2* out = spec + (static_cast<long long>(r) * n_req + f) * kBins;
  float* mrow =
      mag + ((static_cast<long long>(f / time_step) * rows + r) * time_step +
             f % time_step) *
                bin_limit;
  if (f >= n_comp) {
    for (int k = t; k < kBins; k += kRadixThreads) out[k] = make_float2(0.f, 0.f);
    for (int k = t; k < bin_limit; k += kRadixThreads) mrow[k] = 0.f;
    return;
  }

  // v[r] = conj z[t + 128 r]; samples past data_size are zero.
  const float* x = audio + static_cast<long long>(r) * data_size +
                   static_cast<long long>(f) * kHop;
  const long long avail = data_size - static_cast<long long>(f) * kHop;
  const float2* w2 = reinterpret_cast<const float2*>(window);
  float2 v[16];
  if (avail >= kN && (reinterpret_cast<unsigned long long>(x) & 7) == 0) {
    const float2* x2 = reinterpret_cast<const float2*>(x);
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const float2 a = __ldg(x2 + t + 128 * q), w = __ldg(w2 + t + 128 * q);
      v[q] = make_float2(a.x * w.x, -(a.y * w.y));
    }
  } else {
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int i = 2 * (t + 128 * q);
      const float2 w = __ldg(w2 + t + 128 * q);
      const float a = i < avail ? __ldg(x + i) : 0.f;
      const float b = i + 1 < avail ? __ldg(x + i + 1) : 0.f;
      v[q] = make_float2(a * w.x, -(b * w.y));
    }
  }
  float2* buf = bufs + group * kRadixPad;
  const int bar = 1 + group;
  ifft2048_regs(v, buf, tw, t, bar);  // v[q] = conj Z[t + 128 q]

  group_sync(bar);  // every read of the core's last exchange is done
#pragma unroll
  for (int q = 0; q < 16; ++q) buf[radix_pad(t + 128 * q)] = v[q];
  group_sync(bar);

  // Split Z = FFT(x_even + i x_odd) into X[k] = E[k] + W^k O[k], with
  // E[k] = (Z[k] + conj Z[2048-k]) / 2 and O[k] = (Z[k] - conj Z[2048-k]) / 2i.
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const int k = t + 128 * q;
    const float2 zk = make_float2(v[q].x, -v[q].y);
    float2 X;
    if (k == 0) {  // DC and Nyquist are real: E[0] +- O[0]
      X = make_float2(zk.x + zk.y, 0.f);
      const float2 ny = make_float2(zk.x - zk.y, 0.f);
      out[kHalf] = ny;
      if (kHalf < bin_limit) mrow[kHalf] = fabsf(ny.x);
    } else {
      const float2 c = buf[radix_pad(kHalf - k)];
      const float2 zc = make_float2(c.x, -c.y);  // Z[2048 - k], conjugated below
      const float2 e = make_float2(0.5f * (zk.x + zc.x), 0.5f * (zk.y - zc.y));
      const float2 o = make_float2(0.5f * (zk.y + zc.y), -0.5f * (zk.x - zc.x));
      const float2 tk = cmul(__ldg(&tw[k]), o);
      X = make_float2(e.x + tk.x, e.y + tk.y);
    }
    out[k] = X;
    if (k < bin_limit) mrow[k] = sqrtf(X.x * X.x + X.y * X.y);
  }
}

static cudaError_t allow_stft_smem(int groups) {
  return cudaFuncSetAttribute(stft4096_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(groups * kRadixPad * sizeof(float2)));
}

}  // namespace spleeterrt

// K1: audio (rows, data_size), window (4096,) 8-byte aligned, spec (rows,
// n_req, 2049) complex, mag (n_req / time_step, rows, time_step,
// bin_limit); `twiddles` is the table of fft2048_radix.cuh. A block holds
// `groups` 128-thread groups (1 to 4), one frame each. Launches on
// `stream`; returns the cudaError_t of the launch.
extern "C" int spleeterrt_stft4096(const void* audio, long long rows,
                                   long long data_size, const void* window,
                                   const void* twiddles, int n_comp, int n_req,
                                   int bin_limit, int time_step, int groups,
                                   void* spec, void* mag, void* stream) {
  using namespace spleeterrt;
  if (groups < 1 || groups > kMaxStftGroups) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_stft_smem(groups);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((n_req + groups - 1) / groups),
                  static_cast<unsigned>(rows));
  stft4096_kernel<<<grid, groups * kRadixThreads, groups * kRadixPad * sizeof(float2),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(audio), data_size,
      static_cast<const float*>(window), static_cast<const float2*>(twiddles),
      n_comp, n_req, static_cast<int>(rows), bin_limit, time_step,
      static_cast<float2*>(spec), static_cast<float*>(mag));
  return static_cast<int>(cudaGetLastError());
}

// attrs[0..3] of K1 with `groups` groups a block: registers a thread,
// dynamic shared memory a block (bytes), threads a block, resident blocks
// an SM. Returns a cudaError_t.
extern "C" int spleeterrt_stft4096_attrs(int groups, int* attrs) {
  using namespace spleeterrt;
  if (groups < 1 || groups > kMaxStftGroups) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(groups * kRadixPad * sizeof(float2));
  cudaError_t err = allow_stft_smem(groups);
  cudaFuncAttributes fa{};
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, stft4096_kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &attrs[3], stft4096_kernel, groups * kRadixThreads, smem);
  attrs[0] = fa.numRegs;
  attrs[1] = smem;
  attrs[2] = groups * kRadixThreads;
  return static_cast<int>(err);
}
