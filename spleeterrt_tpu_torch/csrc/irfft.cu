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
// One block per (frame, stem): the masked Hermitian merge and the
// 2048-point complex inverse FFT that the masked iSTFT (istft.cu) uses, in
// one 16 KB shared buffer, then 4096 coalesced stores of the frame. Each
// sample is written once with a fixed order of operations and no atomics,
// so two runs are bit-identical. The TPU kernel's 64 x 64 [d, c] layout,
// complex-as-real matmul tables and 32-frame padding exist for its matrix
// unit and are not carried over.
//
// What bounds it on an H100: bytes. A frame reads 16.4 KB of spectrum (and
// 4 * bin_limit bytes of mask in the masked form) and writes 16 KB of
// samples; the FFT is ~0.2 MFLOP a frame, far below the card's compute. At
// 3.35 TB/s that is about 10 ns a frame; the radix-2 FFT's eleven
// synchronised stages hold it well above that, as they hold istft.cu.
#include "fft2048.cuh"

namespace spleeterrt {

template <bool kMasked>
static __global__ void __launch_bounds__(kThreads)
irfft4096_kernel(const float2* __restrict__ spec,
                 const float* __restrict__ masks,
                 const float* __restrict__ out_band,
                 const float* __restrict__ window,
                 const float2* __restrict__ tw, int n_frames, int bin_limit,
                 float* __restrict__ out) {
  __shared__ float2 buf[kHalf];
  const int f = blockIdx.x;
  const int s = blockIdx.y;
  const float2* X = spec + static_cast<long long>(f) * kBins;
  const long long row = static_cast<long long>(s) * n_frames + f;
  if (kMasked)
    merge_hermitian(buf, X, masks + row * bin_limit, out_band[s], bin_limit, tw);
  else
    merge_hermitian(buf, X, nullptr, 1.f, 0, tw);
  fft2048<true>(buf, tw);

  // buf holds N times the frame's samples in order, as floats.
  const float* y = reinterpret_cast<const float*>(buf);
  float* o = out + row * kN;
  if (window) {
    for (int n = threadIdx.x; n < kN; n += blockDim.x)
      o[n] = y[n] * (window[n] * kInvN);
  } else {
    for (int n = threadIdx.x; n < kN; n += blockDim.x) o[n] = y[n] * kInvN;
  }
}

}  // namespace spleeterrt

// K8. `window` may be null. Launches on `stream`; returns the cudaError_t
// of the launch.
extern "C" int spleeterrt_irfft4096(const void* spec, const void* window,
                                    const void* twiddles, int n_frames,
                                    void* out, void* stream) {
  using namespace spleeterrt;
  irfft4096_kernel<false><<<dim3(static_cast<unsigned>(n_frames)), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(spec), nullptr, nullptr,
      static_cast<const float*>(window), static_cast<const float2*>(twiddles),
      n_frames, 0, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// K9: masks (n_stems, n_frames, bin_limit), out_band (n_stems,), out
// (n_stems, n_frames, 4096). `window` may be null.
extern "C" int spleeterrt_masked_irfft4096(const void* spec, const void* masks,
                                           const void* out_band,
                                           const void* window,
                                           const void* twiddles, int n_stems,
                                           int n_frames, int bin_limit,
                                           void* out, void* stream) {
  using namespace spleeterrt;
  const dim3 grid(static_cast<unsigned>(n_frames), static_cast<unsigned>(n_stems));
  irfft4096_kernel<true><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(spec), static_cast<const float*>(masks),
      static_cast<const float*>(out_band), static_cast<const float*>(window),
      static_cast<const float2*>(twiddles), n_frames, bin_limit,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
