// Fused forward STFT: audio -> complex spectrum + U-Net magnitude tiles.
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
// (4 KB new per hop, the rest shared with its neighbours through L2) and
// writes 16 KB of spectrum plus 4 * bin_limit bytes of magnitude; the FFT
// is ~0.2 MFLOP per frame, far below the card's compute. The design keeps
// the whole transform in shared memory (one 16 KB buffer per block) so
// device memory sees only the coalesced audio reads and the two coalesced
// output streams, and the magnitude is written once, already tiled.
#include "fft2048.cuh"

namespace spleeterrt {

static __global__ void __launch_bounds__(kThreads)
stft4096_kernel(const float* __restrict__ audio, long long data_size,
                const float* __restrict__ window,
                const float2* __restrict__ tw, int n_comp, int n_req,
                int rows, int bin_limit, int time_step,
                float2* __restrict__ spec, float* __restrict__ mag) {
  __shared__ float2 buf[kHalf];
  const int f = blockIdx.x;
  const int r = blockIdx.y;
  float2* out = spec + (static_cast<long long>(r) * n_req + f) * kBins;
  float* mrow =
      mag + ((static_cast<long long>(f / time_step) * rows + r) * time_step +
             f % time_step) *
                bin_limit;
  if (f >= n_comp) {
    for (int k = threadIdx.x; k < kBins; k += blockDim.x)
      out[k] = make_float2(0.f, 0.f);
    for (int k = threadIdx.x; k < bin_limit; k += blockDim.x) mrow[k] = 0.f;
    return;
  }

  const float* x = audio + static_cast<long long>(r) * data_size;
  const long long start = static_cast<long long>(f) * kHop;
  for (int n = threadIdx.x; n < kHalf; n += blockDim.x) {
    const long long i = start + 2 * n;  // samples past data_size are zero
    const float a = i < data_size ? x[i] * window[2 * n] : 0.f;
    const float b = i + 1 < data_size ? x[i + 1] * window[2 * n + 1] : 0.f;
    buf[bitrev11(n)] = make_float2(a, b);
  }
  __syncthreads();
  fft2048(buf, tw);

  // Split Z = FFT(x_even + i x_odd) into X[k] = E[k] + W^k O[k], with
  // E[k] = (Z[k] + conj Z[2048-k]) / 2 and O[k] = (Z[k] - conj Z[2048-k]) / 2i.
  for (int k = threadIdx.x; k <= kHalf; k += blockDim.x) {
    float2 X;
    if (k == 0 || k == kHalf) {  // DC and Nyquist are real: E[0] +- O[0]
      const float2 z0 = buf[0];
      X = make_float2(k == 0 ? z0.x + z0.y : z0.x - z0.y, 0.f);
    } else {
      const float2 zk = buf[k];
      const float2 zc = buf[kHalf - k];  // conjugated below
      const float2 e = make_float2(0.5f * (zk.x + zc.x), 0.5f * (zk.y - zc.y));
      const float2 o = make_float2(0.5f * (zk.y + zc.y), -0.5f * (zk.x - zc.x));
      const float2 t = cmul(__ldg(&tw[k]), o);
      X = make_float2(e.x + t.x, e.y + t.y);
    }
    out[k] = X;
    if (k < bin_limit) mrow[k] = sqrtf(X.x * X.x + X.y * X.y);
  }
}

}  // namespace spleeterrt

// Launches on `stream`; returns the cudaError_t of the launch.
extern "C" int spleeterrt_stft4096(const void* audio, long long rows,
                                   long long data_size, const void* window,
                                   const void* twiddles, int n_comp, int n_req,
                                   int bin_limit, int time_step, void* spec,
                                   void* mag, void* stream) {
  using namespace spleeterrt;
  const dim3 grid(static_cast<unsigned>(n_req), static_cast<unsigned>(rows));
  stft4096_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(audio), data_size,
      static_cast<const float*>(window), static_cast<const float2*>(twiddles),
      n_comp, n_req, static_cast<int>(rows), bin_limit, time_step,
      static_cast<float2*>(spec), static_cast<float*>(mag));
  return static_cast<int>(cudaGetLastError());
}
