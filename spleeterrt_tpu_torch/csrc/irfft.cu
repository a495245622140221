// 4096-point inverse real FFT with frames out (K8), and its masked form (K9).
//
// Replaces spleeterrt_tpu/kernels/pallas_fft.py::_irfft_kernel (K8, reached
// through irfft4096_pallas) and ::_masked_irfft_kernel (K9, reached through
// masked_irfft4096_pallas). For frame f of spec (n_frames, 2049) and, in the
// masked form, stem s:
//   Y[k] = X[f, k] * masks[s, f, k]   for k < bin_limit
//   Y[k] = X[f, k] * out_band[s]      for bin_limit <= k <= 2048
// (unmasked: Y = X), with the imaginary parts of DC and Nyquist dropped
// (irfft semantics); then out[s, f, n] = irfft_4096(Y)[n] * window[n], or
// irfft_4096(Y)[n] where there is no window.
//
// What bounds it on an H100: bytes. A frame reads 16.4 KB of spectrum (and
// 4 * bin_limit bytes of mask in the masked form) and writes 16 KB of
// samples; the FFT is ~0.25 MFLOP a frame, far below the card's compute. At
// 3.35 TB/s that is about 10 ns a frame.
//
// The design keeps a frame in registers. A block runs kFramesPerBlock
// frames, 128 threads each, with a named barrier per frame so frames never
// wait for each other. Thread t of a frame merges bins t + 128 r (r < 16)
// straight from the spectrum (merged_bin: X[k] and X[2048 - k], both
// coalesced float2 loads in natural order), runs the register-radix core
// (fft2048_radix.cuh: three Stockham passes, two shared-memory exchanges),
// and ends holding samples 2(t + 128 q) and 2(t + 128 q) + 1. Neighbouring
// threads swap half of them with one shuffle each, so every thread stores
// four consecutive samples, scaled by 1/N and the window, as one 16-byte
// vector. Each sample is written once with a fixed order of operations and
// no atomics, so two runs are bit-identical. The TPU kernel's 64 x 64
// [d, c] layout, complex-as-real matmul tables and 32-frame padding exist
// for its matrix unit and are not carried over.
#include "fft2048_radix.cuh"

namespace spleeterrt {

constexpr int kFramesPerBlock = 2;

template <bool kMasked>
static __global__ void __launch_bounds__(kFramesPerBlock * kRadixThreads)
irfft4096_kernel(const float2* __restrict__ spec,
                 const float* __restrict__ masks,
                 const float* __restrict__ out_band,
                 const float* __restrict__ window,
                 const float2* __restrict__ tw, int n_frames, int bin_limit,
                 float* __restrict__ out) {
  __shared__ float2 bufs[kFramesPerBlock][kRadixPad];
  const int group = threadIdx.x / kRadixThreads;
  const int t = threadIdx.x % kRadixThreads;
  const int f = blockIdx.x * kFramesPerBlock + group;
  if (f >= n_frames) return;  // the whole group: its barrier is its own
  const int s = blockIdx.y;
  const float2* X = spec + static_cast<long long>(f) * kBins;
  const long long row = static_cast<long long>(s) * n_frames + f;
  const float* m = kMasked ? masks + row * bin_limit : nullptr;
  const float gain = kMasked ? out_band[s] : 1.f;
  const int limit = kMasked ? bin_limit : 0;

  float2 v[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) v[r] = merged_bin(X, m, gain, limit, tw, t + 128 * r);
  ifft2048_regs(v, bufs[group], tw, t, 1 + group);

  // v[q] = N (y[2n] + i y[2n+1]) at n = t + 128 q. Lanes 2i and 2i + 1
  // swap: the even lane takes the odd lane's value at even q, the odd lane
  // the even lane's at odd q, so each holds complex samples n and n + 1.
  const bool odd = t & 1;
  float* o = out + row * kN;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const float2 send = odd ? v[2 * p] : v[2 * p + 1];
    const float2 recv = make_float2(__shfl_xor_sync(0xffffffffu, send.x, 1),
                                    __shfl_xor_sync(0xffffffffu, send.y, 1));
    const float2 lo = odd ? recv : v[2 * p];
    const float2 hi = odd ? v[2 * p + 1] : recv;
    const int n2 = 2 * ((t & ~1) + 128 * (2 * p + odd));  // first sample
    float4 y = make_float4(lo.x, lo.y, hi.x, hi.y);
    if (window) {
      const float4 w = __ldg(reinterpret_cast<const float4*>(window + n2));
      y = make_float4(y.x * (w.x * kInvN), y.y * (w.y * kInvN),
                      y.z * (w.z * kInvN), y.w * (w.w * kInvN));
    } else {
      y = make_float4(y.x * kInvN, y.y * kInvN, y.z * kInvN, y.w * kInvN);
    }
    *reinterpret_cast<float4*>(o + n2) = y;
  }
}

template <bool kMasked>
static int launch_irfft(const void* spec, const void* masks, const void* out_band,
                        const void* window, const void* twiddles, int n_stems,
                        int n_frames, int bin_limit, void* out, void* stream) {
  const unsigned blocks = static_cast<unsigned>(n_frames - 1) / kFramesPerBlock + 1;
  irfft4096_kernel<kMasked><<<dim3(blocks, static_cast<unsigned>(n_stems)),
                              kFramesPerBlock * kRadixThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(spec), static_cast<const float*>(masks),
      static_cast<const float*>(out_band), static_cast<const float*>(window),
      static_cast<const float2*>(twiddles), n_frames, bin_limit,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace spleeterrt

// K8. `window` may be null; it and `out` must be 16-byte aligned.
// `twiddles` is the table of fft2048_radix.cuh. Launches on `stream`;
// returns the cudaError_t of the launch.
extern "C" int spleeterrt_irfft4096(const void* spec, const void* window,
                                    const void* twiddles, int n_frames,
                                    void* out, void* stream) {
  return spleeterrt::launch_irfft<false>(spec, nullptr, nullptr, window, twiddles,
                                         1, n_frames, 0, out, stream);
}

// K9: masks (n_stems, n_frames, bin_limit), out_band (n_stems,), out
// (n_stems, n_frames, 4096). `window` may be null.
extern "C" int spleeterrt_masked_irfft4096(const void* spec, const void* masks,
                                           const void* out_band,
                                           const void* window,
                                           const void* twiddles, int n_stems,
                                           int n_frames, int bin_limit,
                                           void* out, void* stream) {
  return spleeterrt::launch_irfft<true>(spec, masks, out_band, window, twiddles,
                                        n_stems, n_frames, bin_limit, out, stream);
}
