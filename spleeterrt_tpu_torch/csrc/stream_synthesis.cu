// The streaming engine's synthesis in one kernel: the masked spectra of a
// block, their inverse FFTs, the synthesis window and the overlap-add with
// the carry, straight to the block's output audio.
//
// Replaces the chain runtime/stream.py ran around K8: the mask multiply
// (masked_spectrum), K8's 4096-sample frames and the windowed tails'
// overlap-add in torch (synthesize). It replaces no TPU kernel. For stream
// k, stem s, channel c (row r = 2k + c) and frame f < T:
//   Y[b] = X[r, f, b] * masks[s, k, c, f, b]   for b < bin_limit
//   Y[b] = X[r, f, b] * out_band[s]            for bin_limit <= b <= 2048
// with the imaginary parts of DC and Nyquist dropped (irfft semantics);
// tail_f = irfft_4096(Y)[2048:] * ws (the synthesis window is zero on the
// first 2048 samples of a frame, so only the last 2048 are kept); then
//   out[k, s, c, 1024 f + i] = tail_f[i] + tail_{f-1}[1024 + i],  i < 1024
// with tail_{-1}[1024:] = tail_in[k, s, c, :], and tail_out[k, s, c, :] =
// tail_{T-1}[1024:], the carry into the next block.
//
// What bounds it on an H100: bytes. A block step of the VST cell (K 64,
// S 4, T 256, bin limit 1536) reads 537 MB of spectrum once for all stems
// and 805 MB of masks and writes 537 MB of audio, 0.56 ms at 3.35 TB/s;
// its 131,072 inverse FFTs are ~16 GFLOP, 0.25 ms at 67 TFLOP/s.
//
// The design is K7's (istft.cu) on the engine's simpler geometry:
// * A group of 128 threads (four warps, its own named barrier) walks a run
//   of run_hops output hops of one (stem, row), frame by frame. Per frame,
//   thread t merges bins t + 128 j (j < 16) straight from the spectrum and
//   the mask row (merged_bin, natural order, coalesced), runs the
//   register-radix core (fft2048_radix.cuh) and ends holding samples
//   2t + 256 q and 2t + 256 q + 1 (q < 16). Every frame is transformed
//   whole.
// * Overlap-add in registers. Samples q >= 8 are the tail: q = 8..11 fall
//   in the frame's own hop, q = 12..15 in the next one. Each output hop
//   sums exactly two frames, so a thread carries four pairs, the previous
//   frame's q = 12..15 already windowed and scaled; after frame f it adds
//   them to its q = 8..11 and stores hop f as coalesced float2, then keeps
//   its own q = 12..15 as the next carry. The window and 1/N are applied
//   as a pair is added, from one __ldg float2.
// * Carry in place of recompute: a run that does not start the block
//   first computes the frame before it, one frame for a run of H hops; the
//   run at hop 0 reads tail_in, and the run that ends the block writes
//   tail_out. Each sample is written once, by one thread, in a fixed order
//   of operations, with no atomics: two runs are bit-identical.
// * The spectrum once for all stems: groups are numbered stem fastest, so
//   the S groups of one (row, run) sit in one block or neighbouring blocks
//   and read the same spectrum rows together; it comes from device memory
//   once and from L1/L2 for the other stems. While a frame transforms, the
//   next frame's spectrum and mask rows are prefetched into L2.
// * Occupancy over registers: at most two groups a block and three blocks
//   an SM (__launch_bounds__) hold a thread to 80 registers (68 bytes of
//   spills), six groups an SM. Left free the core takes 128 registers and
//   four groups an SM, 17% slower; at 64 registers it spills 172 bytes and
//   is 74% slower. In the 128-register form, no prefetch into L2 was 37%
//   slower, a prefetch two frames ahead 8%.
// The run length and the groups a block are launch arguments
// (kernels/stream_synthesis.py: SYNTH_RUN_HOPS, SYNTH_GROUPS), measured
// with kernels/sweep_ends.py at the VST cell's block step (K 64): runs of
// 16 to 32 hops at two groups a block are fastest, 1.12-1.15 ms on an
// NVIDIA H100 80GB HBM3 at 700 W; 48 to 64 hops 1.23-1.25 ms, one group
// a block 1.30 ms (its stems no longer share a block's L1).
#include "fft2048_radix.cuh"

namespace spleeterrt {

constexpr int kSynthMaxGroups = 2;  // 128-thread groups a block, at most
constexpr int kSynthBlocksPerSm = 3;  // resident blocks an SM the registers allow

static __device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

static __global__ void __launch_bounds__(kSynthMaxGroups * kRadixThreads, kSynthBlocksPerSm)
stream_synthesis4096_kernel(const float2* __restrict__ spec,
                            const float* __restrict__ masks,
                            const float* __restrict__ out_band,
                            const float* __restrict__ ws,
                            const float* __restrict__ tail_in,
                            const float2* __restrict__ tw, int n_stems,
                            int rows, int n_frames, int bin_limit, int run_hops,
                            int n_runs, float* __restrict__ out,
                            float* __restrict__ tail_out) {
  extern __shared__ float2 bufs[];  // [groups a block][kRadixPad]
  const int group = threadIdx.x / kRadixThreads;
  const int t = threadIdx.x % kRadixThreads;
  const int g = blockIdx.x * (blockDim.x / kRadixThreads) + group;
  if (g >= n_stems * rows * n_runs) return;  // the whole group: its barrier is its own
  const int s = g % n_stems;
  const int r = g / n_stems / n_runs;  // row 2k + c
  const int h0 = g / n_stems % n_runs * run_hops;
  const int h1 = min(h0 + run_hops, n_frames);
  float2* buf = bufs + group * kRadixPad;
  const int bar = 1 + group;
  const float gain = out_band[s];
  // Output row (k, s, c) of (K, S, 2, T * 1024); the carry's the same.
  const long long orow = (static_cast<long long>(r / 2) * n_stems + s) * 2 + r % 2;
  const float2* spec_row = spec + static_cast<long long>(r) * n_frames * kBins;
  const float* mask_rows =
      masks + (static_cast<long long>(s) * rows + r) * n_frames * bin_limit;
  const float2* win = reinterpret_cast<const float2*>(ws) + t;
  float* o = out + orow * n_frames * kHop + 2 * t;

  float2 carry[4];  // tail_{f-1}[1024 + 2t + 256 p + e], windowed and scaled
  if (h0 == 0) {
#pragma unroll
    for (int p = 0; p < 4; ++p)
      carry[p] = *reinterpret_cast<const float2*>(tail_in + orow * kHop + 2 * t + 256 * p);
  }

#pragma unroll 1
  for (int f = h0 > 0 ? h0 - 1 : 0; f < h1; ++f) {
    const float2* X = spec_row + static_cast<long long>(f) * kBins;
    const float* m = mask_rows + static_cast<long long>(f) * bin_limit;
    // The next frame's spectrum and mask rows go to L2 while this one
    // loads and transforms: one 128-byte line a thread.
    if (f + 1 < h1) {
      prefetch_l2(reinterpret_cast<const char*>(X + kBins) + 128 * t);
      if (128 * t < 4 * bin_limit)
        prefetch_l2(reinterpret_cast<const char*>(m + bin_limit) + 128 * t);
    }
    float2 v[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = merged_bin(X, m, gain, bin_limit, tw, t + 128 * j);
    group_sync(bar);  // the previous frame's reads of buf are done
    ifft2048_regs(v, buf, tw, t, bar);
    // v[q] = N (y[n] + i y[n + 1]) at n = 2t + 256 q; the tail's sample
    // n - 2048 takes ws[n - 2048].
    if (f >= h0) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float2 w = __ldg(win + 128 * p);
        const float2 y = make_float2(fmaf(v[8 + p].x, w.x * kInvN, carry[p].x),
                                     fmaf(v[8 + p].y, w.y * kInvN, carry[p].y));
        *reinterpret_cast<float2*>(o + static_cast<long long>(f) * kHop + 256 * p) = y;
      }
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float2 w = __ldg(win + 128 * (4 + p));
      carry[p] = make_float2(v[12 + p].x * (w.x * kInvN), v[12 + p].y * (w.y * kInvN));
    }
  }
  if (h1 == n_frames) {
#pragma unroll
    for (int p = 0; p < 4; ++p)
      *reinterpret_cast<float2*>(tail_out + orow * kHop + 2 * t + 256 * p) = carry[p];
  }
}

static cudaError_t allow_synthesis_smem(int groups) {
  return cudaFuncSetAttribute(stream_synthesis4096_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(groups * kRadixPad * sizeof(float2)));
}

}  // namespace spleeterrt

// spec (rows, n_frames, 2049) complex with rows = 2K, masks (n_stems, rows,
// n_frames, bin_limit), out_band (n_stems,), ws (2048,), tail_in and
// tail_out (K, n_stems, 2, 1024), out (K, n_stems, 2, n_frames * 1024);
// ws, tail_in, tail_out and out 8-byte aligned. `twiddles` is the table of
// fft2048_radix.cuh. A group walks run_hops output hops (at least 1), a
// block holds `groups` groups (1 or 2). Launches on `stream`; returns the
// cudaError_t of the launch.
extern "C" int spleeterrt_stream_synthesis4096(
    const void* spec, const void* masks, const void* out_band, const void* ws,
    const void* tail_in, const void* twiddles, int n_stems, int rows,
    int n_frames, int bin_limit, int run_hops, int groups, void* out,
    void* tail_out, void* stream) {
  using namespace spleeterrt;
  if (run_hops < 1 || groups < 1 || groups > kSynthMaxGroups || rows % 2 ||
      n_stems < 1 || rows < 2 || n_frames < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_runs = (n_frames + run_hops - 1) / run_hops;
  const long long n_groups = static_cast<long long>(n_stems) * rows * n_runs;
  if (n_groups >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_synthesis_smem(groups);
  if (err != cudaSuccess) return static_cast<int>(err);
  stream_synthesis4096_kernel<<<static_cast<unsigned>((n_groups + groups - 1) / groups),
                                groups * kRadixThreads,
                                groups * kRadixPad * sizeof(float2),
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(spec), static_cast<const float*>(masks),
      static_cast<const float*>(out_band), static_cast<const float*>(ws),
      static_cast<const float*>(tail_in), static_cast<const float2*>(twiddles),
      n_stems, rows, n_frames, bin_limit, run_hops, n_runs,
      static_cast<float*>(out), static_cast<float*>(tail_out));
  return static_cast<int>(cudaGetLastError());
}

// attrs[0..3] with `groups` groups a block: registers a thread, dynamic
// shared memory a block (bytes), threads a block, resident blocks an SM.
// Returns a cudaError_t.
extern "C" int spleeterrt_stream_synthesis4096_attrs(int groups, int* attrs) {
  using namespace spleeterrt;
  if (groups < 1 || groups > kSynthMaxGroups) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(groups * kRadixPad * sizeof(float2));
  cudaError_t err = allow_synthesis_smem(groups);
  cudaFuncAttributes fa{};
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, stream_synthesis4096_kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &attrs[3], stream_synthesis4096_kernel, groups * kRadixThreads, smem);
  attrs[0] = fa.numRegs;
  attrs[1] = smem;
  attrs[2] = groups * kRadixThreads;
  return static_cast<int>(err);
}
