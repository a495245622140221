// Fused masked iSTFT: spectrum + per-stem masks -> overlap-added audio.
//
// Replaces spleeterrt_tpu/kernels/stft_fused.py::_mistft_kernel (reached
// through masked_istft4096_cd / masked_istft4096_packed). For each stem s,
// row r and frame f < n_frames:
//   Y[k] = X[k] * mask[s, f // T, r, f % T, k]   for k < bin_limit
//   Y[k] = X[k] * out_band[s]                    for bin_limit <= k <= 2048
// with the imaginary parts of DC and Nyquist dropped (irfft semantics), then
// y = irfft_4096(Y) * window and out[s, r, :] = overlap-add of the frames at
// hop 1024, length n_frames * 1024 + 3072. The mask index map is the U-Net's
// NCHW tile layout, so masks are read as the network wrote them.
//
// Overlap-add without ordering or atomics: a block owns a span of
// kSpanHops output hops of one (stem, row) and recomputes every frame that
// overlaps the span (kSpanHops + 3 of them), adding each frame's share into
// per-thread registers in frame order. Each output sample is written once,
// by one thread, with a fixed summation order, so two runs are
// bit-identical. The price is (kSpanHops + 3) / kSpanHops = 1.375x the
// inverse FFTs and spectrum/mask reads of a frames-then-gather scheme, and
// no frame scratch buffer in device memory.
//
// What bounds it on an H100: bytes read. Each recomputed frame reads 16 KB
// of spectrum and 4 * bin_limit bytes of mask and the block writes 4 KB of
// audio per hop; the spectrum of a frame is shared by the stems and its
// neighbours in L2. The inverse FFT lives in one 16 KB shared buffer and
// the overlap-add accumulator in registers, so device memory sees only the
// coalesced spectrum and mask reads and one coalesced audio write.
#include "fft2048.cuh"

namespace spleeterrt {

constexpr int kSpanHops = 8;                             // output hops per block
constexpr int kPerThread = kSpanHops * kHop / kThreads;  // 16 samples a thread

static __global__ void __launch_bounds__(kThreads)
masked_istft4096_kernel(const float2* __restrict__ spec,
                        const float* __restrict__ masks,
                        const float* __restrict__ out_band,
                        const float* __restrict__ window,
                        const float2* __restrict__ tw, int n_frames,
                        int n_spec, int rows, int n_tiles, int time_step,
                        int bin_limit, long long out_len,
                        float* __restrict__ out) {
  __shared__ float2 buf[kHalf];
  const int h0 = blockIdx.x * kSpanHops;
  const int r = blockIdx.y;
  const int s = blockIdx.z;
  const float ob = out_band[s];
  const float2* spec_row = spec + static_cast<long long>(r) * n_spec * kBins;

  float acc[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) acc[j] = 0.f;

  const int f_lo = max(0, h0 - 3);
  const int f_hi = min(n_frames, h0 + kSpanHops);
  for (int f = f_lo; f < f_hi; ++f) {
    const float2* X = spec_row + static_cast<long long>(f) * kBins;
    const float* m =
        masks + (((static_cast<long long>(s) * n_tiles + f / time_step) * rows +
                  r) * time_step + f % time_step) * bin_limit;
    // The inverse FFT gives N times the frame; the 1/N is folded into the
    // window product below.
    merge_hermitian(buf, X, m, ob, bin_limit, tw);
    fft2048<true>(buf, tw);

    // buf now holds the frame's time samples in order, as floats.
    const float* y = reinterpret_cast<const float*>(buf);
    const int frame_start = (f - h0) * kHop;  // relative to the span start
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int local = static_cast<int>(threadIdx.x) + j * kThreads - frame_start;
      if (local >= 0 && local < kN) acc[j] += y[local] * (window[local] * kInvN);
    }
    __syncthreads();  // buf is refilled by the next frame
  }

  float* o = out + (static_cast<long long>(s) * rows + r) * out_len;
  const long long base = static_cast<long long>(h0) * kHop;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const long long i = base + threadIdx.x + j * kThreads;
    if (i < out_len) o[i] = acc[j];
  }
}

}  // namespace spleeterrt

// Launches on `stream`; returns the cudaError_t of the launch.
extern "C" int spleeterrt_masked_istft4096(
    const void* spec, const void* masks, const void* out_band,
    const void* window, const void* twiddles, int n_stems, long long rows,
    int n_frames, int n_spec, int n_tiles, int time_step, int bin_limit,
    void* out, void* stream) {
  using namespace spleeterrt;
  const long long out_len = static_cast<long long>(n_frames) * kHop + (kN - kHop);
  const int n_hops = n_frames + kN / kHop - 1;
  const dim3 grid(static_cast<unsigned>((n_hops + kSpanHops - 1) / kSpanHops),
                  static_cast<unsigned>(rows), static_cast<unsigned>(n_stems));
  masked_istft4096_kernel<<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(spec), static_cast<const float*>(masks),
      static_cast<const float*>(out_band), static_cast<const float*>(window),
      static_cast<const float2*>(twiddles), n_frames, n_spec,
      static_cast<int>(rows), n_tiles, time_step, bin_limit, out_len,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
