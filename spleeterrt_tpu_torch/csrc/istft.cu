// Fused masked iSTFT (K7): spectrum + per-stem masks -> overlap-added audio.
//
// Replaces spleeterrt_tpu/kernels/stft_fused.py::_mistft_kernel (reached
// through masked_istft4096_cd / masked_istft4096_packed). For each stem s,
// row r and frame f < n_frames:
//   Y[k] = X[k] * mask[s, track * n_tiles + f // T, ch, f % T, k]  for k < bin_limit
//   Y[k] = X[k] * out_band[s]                    for bin_limit <= k <= 2048
// with the imaginary parts of DC and Nyquist dropped (irfft semantics), then
// y = irfft_4096(Y) * window and out[s, r, :] = overlap-add of the frames at
// hop 1024, length n_frames * 1024 + 3072. The rows are tracks of `chans`
// channels, track-major (row = track * chans + ch), and the mask index map
// is the U-Net's NCHW tile layout over (track, tile) images, so masks are
// read as the network wrote them for a batch of tracks. With one track the
// image is the tile.
//
// What bounds it on an H100: bytes, then the FFT's instructions. A frame
// reads 16 KB of spectrum (shared by the stems) and 4 * bin_limit bytes of
// mask per stem and writes 4 KB of audio per stem; at 300 s of the 4-stem
// graph that is 1.49 GB, 0.44 ms at 3.35 TB/s. The inverse FFT is ~0.25
// MFLOP a frame and stem, which at that rate the card can only just keep up
// with if nothing else stalls it, so the design keeps every sample in
// registers between the spectrum read and the audio write.
//
// The design. A group of 128 threads (four warps, its own named barrier)
// walks a run of run_hops output hops of one (stem, row), frame by frame:
// * Per frame, K9's path: thread t merges bins t + 128 r (r < 16) straight
//   from the spectrum and the mask row (merged_bin: natural order,
//   coalesced), runs the register-radix core (fft2048_radix.cuh: radix 16 ·
//   16 · 8, two padded shared-memory exchanges) and ends holding samples
//   2(t + 128 q) and 2(t + 128 q) + 1, q < 16.
// * Overlap-add in registers. A frame starts at a multiple of 1024 = 4 x
//   256, so thread t's samples of every frame fall on the output positions
//   2t + e + 256 j (e < 2): frame f adds its q-th pair to j = 4f + q. Each
//   thread keeps a ring of 16 such pairs; frame f lands in slots (4 (f mod
//   4) + q) mod 16, a compile-time index because the frame loop is unrolled
//   by 4. After frame f no later frame reaches hop f, so its four pairs
//   (slots 4 (f mod 4) + q', q' < 4) are final: they are scaled already,
//   stored as coalesced float2 and cleared for hop f + 4. The window and
//   1/N are applied as each frame is added, from one __ldg float2 a pair.
//   While a frame loads and transforms, the next frame's spectrum and mask
//   rows are prefetched into L2, which hides part of the load latency that
//   four groups an SM leave exposed (PERF.md).
// * Carry in place of recompute. A run starts with the three frames before
//   it (their hops belong to the run before), as the TPU kernel's carry
//   does, so a run of H hops computes H + 3 frames; hops past the last
//   frame (the 3072-sample tail) are virtual frames that add nothing and
//   only store. Each sample is written once, by one thread, with the frames
//   added in order: no atomics, and two runs are bit-identical.
// * The spectrum once for all stems: groups are numbered stem fastest, so
//   the groups of one (row, run) sit in one block or in neighbouring blocks
//   and read the same spectrum rows together; it comes from device memory
//   once and from L1/L2 for the other stems. S = 1 (the 2-stem graph)
//   gives every group its own run, and no group idles.
// The TPU kernel's [c, d] packing, per-frame matmul tables and sequential
// grid are not carried over.
#include "fft2048_radix.cuh"

namespace spleeterrt {

constexpr int kMaxGroups = 4;  // 128-thread groups a block, at most

static __device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

static __global__ void __launch_bounds__(kMaxGroups * kRadixThreads)
masked_istft4096_kernel(const float2* __restrict__ spec,
                        const float* __restrict__ masks,
                        const float* __restrict__ out_band,
                        const float* __restrict__ window,
                        const float2* __restrict__ tw, int n_stems, int rows,
                        int chans, int n_frames, int n_spec, int n_tiles,
                        int time_step,
                        int bin_limit, int run_hops, int n_runs,
                        long long out_len, float* __restrict__ out) {
  extern __shared__ float2 bufs[];  // [groups a block][kRadixPad]
  const int group = threadIdx.x / kRadixThreads;
  const int t = threadIdx.x % kRadixThreads;
  const int g = blockIdx.x * (blockDim.x / kRadixThreads) + group;
  if (g >= n_stems * rows * n_runs) return;  // the whole group: its barrier is its own
  const int s = g % n_stems;
  const int r = g / n_stems / n_runs;
  const int h0 = g / n_stems % n_runs * run_hops;  // a multiple of 4
  const int h1 = min(h0 + run_hops, n_frames + kN / kHop - 1);
  float2* buf = bufs + group * kRadixPad;
  const int bar = 1 + group;
  const float gain = out_band[s];
  const float2* spec_row = spec + static_cast<long long>(r) * n_spec * kBins;
  const float2* win = reinterpret_cast<const float2*>(window) + t;
  float* o = out + (static_cast<long long>(s) * rows + r) * out_len + 2 * t;

  // Frame f's mask row: masks[s, track * n_tiles + f / time_step, ch,
  // f % time_step, :] for row r = track * chans + ch.
  const long long image0 =
      (static_cast<long long>(s) * (rows / chans) + r / chans) * n_tiles;
  auto mask_row = [&](int f) {
    return masks + (((image0 + f / time_step) * chans + r % chans) * time_step +
                    f % time_step) * bin_limit;
  };
  float2 acc[16];  // samples 2t + e + 256 j at slot j mod 16
#pragma unroll
  for (int q = 0; q < 16; ++q) acc[q] = make_float2(0.f, 0.f);

#pragma unroll 1
  for (int base = h0 - 4; base < h1; base += 4) {
#pragma unroll
    for (int ph = 0; ph < 4; ++ph) {
      const int f = base + ph;  // f mod 4 = ph
      if (f >= h0 - 3 && f >= 0 && f < n_frames) {
        const float2* X = spec_row + static_cast<long long>(f) * kBins;
        const float* m = mask_row(f);
        // The next frame's spectrum and mask rows go to L2 while this one
        // loads and transforms: one 128-byte line a thread (the
        // spectrum's last 8 bytes come with the frame after).
        if (f + 1 < n_frames && f + 1 < h1) {
          prefetch_l2(reinterpret_cast<const char*>(X + kBins) + 128 * t);
          if (128 * t < 4 * bin_limit)
            prefetch_l2(reinterpret_cast<const char*>(mask_row(f + 1)) + 128 * t);
        }
        float2 v[16];
#pragma unroll
        for (int k = 0; k < 16; ++k) v[k] = merged_bin(X, m, gain, bin_limit, tw, t + 128 * k);
        group_sync(bar);  // the previous frame's reads of buf are done
        ifft2048_regs(v, buf, tw, t, bar);
        // v[q] = N (y[n] + i y[n + 1]) at n = 2t + 256 q: output j = 4f + q.
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const float2 w = __ldg(win + 128 * q);
          float2& a = acc[(4 * ph + q) & 15];
          a.x = fmaf(v[q].x, w.x * kInvN, a.x);
          a.y = fmaf(v[q].y, w.y * kInvN, a.y);
        }
      }
      // Hop f is final: no later frame reaches it.
      if (f >= h0 && f < h1) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          *reinterpret_cast<float2*>(o + static_cast<long long>(f) * kHop + 256 * q) =
              acc[4 * ph + q];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[4 * ph + q] = make_float2(0.f, 0.f);
    }
  }
}

static int istft_groups(int n_stems, int rows, int n_frames, int run_hops,
                        int* n_runs) {
  const int n_hops = n_frames + kN / kHop - 1;
  *n_runs = (n_hops + run_hops - 1) / run_hops;
  return n_stems * rows * *n_runs;
}

static cudaError_t allow_istft_smem(int groups) {
  return cudaFuncSetAttribute(masked_istft4096_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(groups * kRadixPad * sizeof(float2)));
}

}  // namespace spleeterrt

// K7: spec (rows, n_spec, 2049) complex, masks (n_stems, tracks * n_tiles,
// rows / tracks, time_step, bin_limit), out_band (n_stems,), window
// (4096,), out (n_stems, rows, n_frames * 1024 + 3072); `twiddles` is the
// table of fft2048_radix.cuh; `tracks` divides rows. A group walks
// run_hops output hops (a positive multiple of 4), a block holds `groups`
// groups (1 to 4). Launches on `stream`; returns the cudaError_t of the
// launch.
extern "C" int spleeterrt_masked_istft4096(
    const void* spec, const void* masks, const void* out_band,
    const void* window, const void* twiddles, int n_stems, long long rows,
    int tracks, int n_frames, int n_spec, int n_tiles, int time_step,
    int bin_limit, int run_hops, int groups, void* out, void* stream) {
  using namespace spleeterrt;
  if (run_hops <= 0 || run_hops % 4 || groups < 1 || groups > kMaxGroups ||
      tracks < 1 || rows % tracks)
    return static_cast<int>(cudaErrorInvalidValue);
  int n_runs = 0;
  const int n_groups = istft_groups(n_stems, static_cast<int>(rows), n_frames,
                                    run_hops, &n_runs);
  cudaError_t err = allow_istft_smem(groups);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long out_len = static_cast<long long>(n_frames) * kHop + (kN - kHop);
  masked_istft4096_kernel<<<(n_groups + groups - 1) / groups, groups * kRadixThreads,
                            groups * kRadixPad * sizeof(float2),
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(spec), static_cast<const float*>(masks),
      static_cast<const float*>(out_band), static_cast<const float*>(window),
      static_cast<const float2*>(twiddles), n_stems, static_cast<int>(rows),
      static_cast<int>(rows / tracks), n_frames, n_spec, n_tiles, time_step,
      bin_limit, run_hops, n_runs, out_len,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// attrs[0..3] of K7 with `groups` groups a block: registers a thread,
// dynamic shared memory a block (bytes), threads a block, resident blocks
// an SM. Returns a cudaError_t.
extern "C" int spleeterrt_masked_istft4096_attrs(int groups, int* attrs) {
  using namespace spleeterrt;
  if (groups < 1 || groups > kMaxGroups) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(groups * kRadixPad * sizeof(float2));
  cudaError_t err = allow_istft_smem(groups);
  cudaFuncAttributes fa{};
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, masked_istft4096_kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &attrs[3], masked_istft4096_kernel, groups * kRadixThreads, smem);
  attrs[0] = fa.numRegs;
  attrs[1] = smem;
  attrs[2] = groups * kRadixThreads;
  return static_cast<int>(err);
}
