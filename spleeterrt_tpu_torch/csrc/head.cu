// U-Net head: up6 + up7 + sigmoid, writing the masks straight into the
// masked iSTFT's input layout. Two kernel templates, two entry points:
// K6 (spleeterrt_head) reads its 32 input channels from two NHWC tensors of
// 16 channels each, skip1 and up5out; K10 (spleeterrt_mask_head) reads them
// from one NHWC tensor of 32, x = [skip1 | up5out], as channel-stride-32
// sources at x and x + 16, so x is never split into two copies.
//   y6   = bn_scale * act(tconv5x5_s2([skip1, up5out], w6) + b6) + bn_shift
//          (32 -> 1 channel, TF-SAME, decoder epilogue), zero outside the
//          image, rounded to the compute dtype;
//   mask = sigmoid(conv4x4_dil2_pad3(y6, w7) + b7)   (1 -> 2 channels).
//
// Replaces spleeterrt_tpu/kernels/tail.py::_head_kernel (K6, reached through
// head_packed) and spleeterrt_tpu/kernels/mask_head.py::_head_kernel (K10,
// the round-3 head, reached through mask_head_pallas). Same values, not the
// TPU's packed lanes or parity-mix matrices: the sources are NHWC in the
// compute dtype; the output is float32 (S, B, 2, T, F) = [n_img][2][T][F]
// (K10's (S * B, 2, T, F) is the same memory), the layout
// kernels/stft_fused.py::masked_istft4096 reads, so nothing sits between
// the U-Net and the iSTFT. Output image n uses stem n / bper's weights.
//
// The domain mask: up7 zero-pads y6, but the epilogue of a zero input,
// bn_scale * act(b6) + bn_shift, is not zero, so y6 is zeroed outside
// [0, T) x [0, F) before up7 reads it (the TPU kernel's rowm / qm masks).
// Without it the masks miss tail.head_error_bound by ~1e6 times.
//
// Subpixel form of up6: y6 at (2h' + dp, 2w' + dq) sums input (h' + dh,
// w' + dw), (dh, dw) in {-1, 0, 1}^2, through tap (1 - 2 dh + dp, 1 - 2 dw +
// dq) where that lies in [0, 5): 25 of the 36 (shift, parity) pairs. up7
// reads y6 at offsets -3, -1, +1, +3 in both axes, so a mask tile of TY x TX
// needs y6 on a halo of 4 each side, (TY/2 + 4) x (TX/2 + 4) groups of 2 x 2.
//
// What bounds it on an H100: bytes. At 300 s of the 4-stem graph (204
// images of 128 x 768) it reads 2 x 642 MB of bf16 sources and writes
// 642 MB of float32 masks, 0.575 ms at 3.35 TB/s. up6 is 20.1 G multiply-
// adds there (1.33x with the halo), which fp32 FMA on the CUDA cores cannot
// do under that bound (0.67 ms at 67 TFLOP/s with no halo and nothing
// else); as a GEMM padded to mma.sync's shape it is about 92 GFLOP, a tenth
// of a millisecond at mma.sync rates, so the bf16 path runs up6 on the
// tensor cores and leaves the card to its memory. wgmma's 64-row tiles and
// asynchrony buy nothing more for a kernel bound by bytes. Two templates,
// chosen by a fixed rule on dtype (tail._head_tensor_cores):
//
// * bf16: head_mma_kernel, up6 as an implicit GEMM on mma.sync m16n8k16
//   with bf16 operands and float32 sums, as the TPU kernel ran it on its
//   matrix unit. M = the tile's y6 groups, halo included; K = 9 shifts x
//   32 channels = 18 k16 steps, one source's 16 channels at one shift each
//   (skip1's 9, then up5's 9); N = the 4 parities, padded to 8 with zero
//   weight columns. Each source's half-resolution patch, (TY/2 + 6) x
//   (TX/2 + 6) pixels x 16 channels, is staged by 16-byte cp.async (a
//   pixel's channels are two chunks; zeros outside the image; K3's
//   swizzle), skip1's and up5's as two commit groups, so up5's load
//   overlaps skip1's MMAs; the A operand of a shift is the patch shifted by
//   (dh, dw), gathered by ldmatrix through per-lane pixel addresses (K4/
//   K5's scheme). Loads and compute of different tiles overlap across the
//   four blocks an SM holds at the launched tile; a persistent variant
//   that staged the next tile through a ring of two held only two blocks
//   an SM and measured slower (PERF.md). Shared memory, not the tensor cores, is what the GEMM
//   spends: an A fragment costs as much to load as its mma costs to run.
//   So each warp owns a strip of 16 group columns over a band of group
//   rows and walks the patch rows down it: the fragment of patch row p at
//   column shift dw is loaded once and feeds the three output rows p - 1 -
//   dh that read it, a third of the ldmatrix traffic of loading every
//   (row, shift) fragment on its own. The weights, [S][18][8][16] from
//   tail._head_weights, sit in shared memory (4.6 KB a stem), a source's
//   nine B fragments in registers. The epilogue runs on the accumulators,
//   zeroes y6 outside the image, rounds it to bf16 and writes it as float
//   into a shared tile that reuses the patches; up7 and the sigmoid then
//   run in fp32 FMA, a thread taking outputs x to x + 3 of rows y and y + 2
//   (which share three of their four row taps, as x and x + 2 share three
//   column taps) from three 16-byte loads of each of five y6 rows, and
//   store 16-byte rows of float32 masks. Every sum runs in one fixed order
//   (k step, then mma's own), so reruns are bit-identical, and K10, the
//   same template with the same k order, gives K6's masks bit for bit.
// * float32 (the parity path): head_kernel, fp32 FMA on the CUDA cores;
//   TF32 tensor cores would not hold its 1e-5 bound. A block owns a 32 x 64
//   tile and computes y6 on a 40 x 72 halo from a 22 x 38 patch staged 8
//   channels at a time.
#include "mma.cuh"
#include "unet.cuh"

namespace spleeterrt {

namespace {

// ---------------------------------------------------------------------------
// float32 on CUDA cores
// ---------------------------------------------------------------------------

constexpr int kTY = 32, kTX = 64;                   // mask tile
constexpr int kLH = kTY / 2 + 4, kLW = kTX / 2 + 4;  // y6 groups (2 x 2 each)
constexpr int kIH = kLH + 2, kIW = kLW + 2;         // staged input patch
constexpr int kYH = 2 * kLH, kYW = 2 * kLW;         // y6 tile with halo
constexpr int kChunk = 8;                           // input channels per round
constexpr int kGroups = kLH * kLW;
constexpr int kGroupsPerThread = (kGroups + kUnetThreads - 1) / kUnetThreads;

// skip1, up5: [n_img][H2][W2][kCS] float, channels [0, 16) of each pixel
// read (kCS = 16: two tensors; kCS = 32: up5 = skip1 + 16 in one tensor).
// w6k: [S][32][25] float. w7k: [S][2][16] float. scal: [S][5] float (b6,
// bn_scale6, bn_shift6, b7[0], b7[1]). masks: [n_img][2][2 * H2][2 * W2]
// float.
template <int kCS>
__global__ void __launch_bounds__(kUnetThreads)
head_kernel(const float* __restrict__ skip1, const float* __restrict__ up5,
            const float* __restrict__ w6k, const float* __restrict__ w7k,
            const float* __restrict__ scal, int bper, int H2, int W2, int act,
            float* __restrict__ masks) {
  __shared__ float xs[kChunk][kIH][kIW];
  __shared__ float y6s[kYH][kYW];
  __shared__ float w6s[kChunk][25];

  const int n = blockIdx.z;
  const int s = n / bper;
  const int H = 2 * H2, W = 2 * W2;
  const int Y0 = blockIdx.y * kTY, X0 = blockIdx.x * kTX;
  const int g0h = Y0 / 2 - 2, g0w = X0 / 2 - 2;  // first y6 group
  const int tid = threadIdx.x;

  float acc[kGroupsPerThread][4];  // [group][dp * 2 + dq]
#pragma unroll
  for (int k = 0; k < kGroupsPerThread; ++k)
#pragma unroll
    for (int p = 0; p < 4; ++p) acc[k][p] = 0.f;

  for (int c0 = 0; c0 < 32; c0 += kChunk) {
    const float* x = (c0 < 16 ? skip1 : up5) +
                     static_cast<long long>(n) * H2 * W2 * kCS + c0 % 16;
    for (int idx = tid; idx < kChunk * kIH * kIW; idx += kUnetThreads) {
      const int ci = idx % kChunk;
      const int lc = (idx / kChunk) % kIW;
      const int lr = idx / (kChunk * kIW);
      const int h = g0h - 1 + lr, w = g0w - 1 + lc;
      float v = 0.f;
      if (h >= 0 && h < H2 && w >= 0 && w < W2)
        v = x[(static_cast<long long>(h) * W2 + w) * kCS + ci];
      xs[ci][lr][lc] = v;
    }
    for (int idx = tid; idx < kChunk * 25; idx += kUnetThreads)
      w6s[idx / 25][idx % 25] = w6k[(static_cast<long long>(s) * 32 + c0) * 25 + idx];
    __syncthreads();

#pragma unroll 1
    for (int ci = 0; ci < kChunk; ++ci) {
      float wv[25];
#pragma unroll
      for (int t = 0; t < 25; ++t) wv[t] = w6s[ci][t];
#pragma unroll
      for (int k = 0; k < kGroupsPerThread; ++k) {
        const int g = tid + k * kUnetThreads;
        if (g >= kGroups) continue;
        const int r = g / kLW, c = g % kLW;
        float xin[3][3];  // x[g0h + r - 1 + a][g0w + c - 1 + b]
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int b = 0; b < 3; ++b) xin[a][b] = xs[ci][r + a][c + b];
#pragma unroll
        for (int kh = 0; kh < 5; ++kh) {
          const int dp = (kh & 1) ? 0 : 1;
          const int dh = (kh & 1) ? (1 - kh) / 2 : (2 - kh) / 2;
#pragma unroll
          for (int kw = 0; kw < 5; ++kw) {
            const int dq = (kw & 1) ? 0 : 1;
            const int dw = (kw & 1) ? (1 - kw) / 2 : (2 - kw) / 2;
            acc[k][dp * 2 + dq] =
                fmaf(xin[1 + dh][1 + dw], wv[kh * 5 + kw], acc[k][dp * 2 + dq]);
          }
        }
      }
    }
    __syncthreads();
  }

  // Epilogue of up6 into shared memory, zero outside the image.
  const float* sc = scal + static_cast<long long>(s) * 5;
  const float b6 = sc[0], bns = sc[1], bnh = sc[2];
#pragma unroll
  for (int k = 0; k < kGroupsPerThread; ++k) {
    const int g = tid + k * kUnetThreads;
    if (g >= kGroups) continue;
    const int r = g / kLW, c = g % kLW;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int yy = 2 * r + (p >> 1), xx = 2 * c + (p & 1);
      const int gy = Y0 - 4 + yy, gx = X0 - 4 + xx;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      y6s[yy][xx] = inside ? bns * activate(acc[k][p] + b6, act) + bnh : 0.f;
    }
  }
  __syncthreads();

  // up7 (taps at -3, -1, +1, +3 in both axes) and the sigmoid.
  float w7[2][16];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int t = 0; t < 16; ++t) w7[c][t] = w7k[(static_cast<long long>(s) * 2 + c) * 16 + t];
  const float b70 = sc[3], b71 = sc[4];
  float* out = masks + static_cast<long long>(n) * 2 * H * W;
  for (int p = tid; p < kTY * kTX; p += kUnetThreads) {
    const int oy = p / kTX, ox = p % kTX;
    const int gy = Y0 + oy, gx = X0 + ox;
    if (gy >= H || gx >= W) continue;
    float l0 = b70, l1 = b71;
#pragma unroll
    for (int ky = 0; ky < 4; ++ky)
#pragma unroll
      for (int kx = 0; kx < 4; ++kx) {
        const float v = y6s[oy + 1 + 2 * ky][ox + 1 + 2 * kx];
        l0 = fmaf(v, w7[0][ky * 4 + kx], l0);
        l1 = fmaf(v, w7[1][ky * 4 + kx], l1);
      }
    const long long off = static_cast<long long>(gy) * W + gx;
    out[off] = 1.f / (1.f + expf(-l0));
    out[static_cast<long long>(H) * W + off] = 1.f / (1.f + expf(-l1));
  }
}

template <int kCS>
int launch_head(const void* skip1, const void* up5, const void* w6k,
                const void* w7k, const void* scal, int n_img, int bper, int H2,
                int W2, int act, void* masks, cudaStream_t stream) {
  const dim3 grid((2 * W2 + kTX - 1) / kTX, (2 * H2 + kTY - 1) / kTY, n_img);
  head_kernel<kCS><<<grid, kUnetThreads, 0, stream>>>(
      static_cast<const float*>(skip1), static_cast<const float*>(up5),
      static_cast<const float*>(w6k), static_cast<const float*>(w7k),
      static_cast<const float*>(scal), bper, H2, W2, act,
      static_cast<float*>(masks));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kHeadSteps = 18;                     // k16 steps: 2 sources x 9 shifts
constexpr int kHeadWChunks = kHeadSteps * 8 * 2;   // [18][8 columns][16 k] bf16

// A block of 8 warps owns a TY x TX tile of the masks, whose y6 halo is
// LH x LW groups. Warp w takes the 16-group column strip w % STRIPS and
// the ROWS group rows of row band w / STRIPS, and walks the patch rows
// down that band: the A fragment of patch row p at column shift dw is
// loaded once and serves the three output rows p - 1 - dh, dh in {-1, 0,
// 1}, that read it.
template <int TY, int TX>
struct HeadMma {
  static constexpr int kThreads = 256;
  static constexpr int LH = TY / 2 + 4, LW = TX / 2 + 4;  // y6 groups, halo included
  static constexpr int PH = LH + 2, PW = LW + 2;          // patch pixels a source
  static constexpr int PATCH = PH * PW * 2;               // 16-byte chunks a source
  static constexpr int STRIPS = LW / 16;                   // 16-group column strips
  static constexpr int BANDS = 8 / STRIPS;                 // row bands
  static constexpr int ROWS = LH / BANDS;                  // group rows a warp
  static constexpr int YH = 2 * LH, YW = 2 * LW;           // y6 tile, floats
  static constexpr size_t PATCH_BYTES = 16 * static_cast<size_t>(2 * PATCH);
  static constexpr size_t Y6_BYTES = 4 * static_cast<size_t>(YH * YW);
  static constexpr size_t SMEM =
      16 * kHeadWChunks + (PATCH_BYTES > Y6_BYTES ? PATCH_BYTES : Y6_BYTES);
  // As many blocks an SM as its 233,472 bytes of shared memory hold (1 KB a
  // block reserved), at most 4: the launch bounds cap the registers to fit.
  static constexpr int kMinBlocks =
      233472 / (SMEM + 1024) < 4 ? static_cast<int>(233472 / (SMEM + 1024)) : 4;
  static_assert(TY % 4 == 0 && TX % 4 == 0 && LW % 16 == 0 && 8 % STRIPS == 0 &&
                    LH % BANDS == 0, "tile shape");
};

// skip1, up5: NHWC bf16 [n_img][H2][W2][kCS] (16-byte aligned), channels
// [0, 16) of each pixel read. w6k: [S][18][8][16] bf16 (tail._head_weights:
// step 9 src + 3 (dh + 1) + dw + 1, column 2 dp + dq, k the source's
// channel; columns 4-7 and taps outside the kernel zero). w7k: [S][2][16]
// bf16. scal: [S][5] float. masks: [n_img][2][2 H2][2 W2] float.
template <int kCS, int TY, int TX>
__global__ void __launch_bounds__(HeadMma<TY, TX>::kThreads, HeadMma<TY, TX>::kMinBlocks)
head_mma_kernel(const bf16* __restrict__ skip1, const bf16* __restrict__ up5,
                const bf16* __restrict__ w6k, const bf16* __restrict__ w7k,
                const float* __restrict__ scal, int bper, int H2, int W2, int act,
                float* __restrict__ masks) {
  using Tile = HeadMma<TY, TX>;
  constexpr int PW = Tile::PW, ROWS = Tile::ROWS, YW = Tile::YW;
  constexpr int kThreads = Tile::kThreads;
  extern __shared__ __align__(128) uint4 smem4[];
  uint4* wsm = smem4;                                 // the stem's weights
  uint4* patch = smem4 + kHeadWChunks;                // [2 sources][PH][PW][2 chunks]
  float* y6s = reinterpret_cast<float*>(patch);       // [YH][YW], after the MMAs

  const int n = blockIdx.z;
  const int s = n / bper;
  const int H = 2 * H2, W = 2 * W2;
  const int Y0 = blockIdx.y * TY, X0 = blockIdx.x * TX;
  const int g0h = Y0 / 2 - 2, g0w = X0 / 2 - 2;  // first y6 group
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // Group 0: the weights and skip1's patch; group 1: up5's patch. Staged
  // (lr, lc) is input (g0h - 1 + lr, g0w - 1 + lc); src-size 0 fills zeros
  // outside the image.
  {
    const uint4* wsrc = reinterpret_cast<const uint4*>(w6k) +
                        static_cast<long long>(s) * kHeadWChunks;
    for (int i = threadIdx.x; i < kHeadWChunks; i += kThreads) cp_async16(wsm + i, wsrc + i, true);
  }
#pragma unroll
  for (int src = 0; src < 2; ++src) {
    const bf16* x = (src ? up5 : skip1) + static_cast<long long>(n) * H2 * W2 * kCS;
    uint4* dst = patch + src * Tile::PATCH;
    for (int idx = threadIdx.x; idx < Tile::PATCH; idx += kThreads) {
      const int lc = (idx >> 1) % PW;
      const int lr = (idx >> 1) / PW;
      const int h = g0h - 1 + lr, w = g0w - 1 + lc;
      const bool in = h >= 0 && h < H2 && w >= 0 && w < W2;
      const bf16* p = in ? x + (static_cast<long long>(h) * W2 + w) * kCS + 8 * (idx & 1) : x;
      cp_async16(dst + swz<2>(idx), p, in);
    }
    cp_async_commit();
  }

  // This warp's rows are y6 group rows r0 + i (i < ROWS), columns c0 +
  // [0, 16); GEMM row lane & 15 of a fragment is column c0 + (lane & 15),
  // ldmatrix lane l gives row l & 15 and k half l >> 4.
  const int c0 = 16 * (warp % Tile::STRIPS), r0 = ROWS * (warp / Tile::STRIPS);
  const int a_pix = r0 * PW + c0 + (lane & 15) + 1;  // patch row r0, shift dw = 0
  float acc[ROWS][4];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int src = 0; src < 2; ++src) {
    if (src == 0) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();
    const uint4* x = patch + src * Tile::PATCH;
    // B of shift sh: column lane / 4, k 2 (lane % 4) + {0, 1} and + 8.
    unsigned b[9][2];
#pragma unroll
    for (int sh = 0; sh < 9; ++sh) {
      const unsigned* wb = reinterpret_cast<const unsigned*>(wsm) + (9 * src + sh) * 64 +
                           (lane >> 2) * 8 + (lane & 3);
      b[sh][0] = wb[0];
      b[sh][1] = wb[4];
    }
    // Patch row r0 + p feeds output row r0 + p - 1 - dh through shift (dh,
    // dw): each output row takes its shifts in order, (dh, dw) row-major.
#pragma unroll
    for (int p = 0; p < ROWS + 2; ++p) {
#pragma unroll
      for (int dw = -1; dw <= 1; ++dw) {
        unsigned a[4];
        ldmatrix_x4(a, x + swz<2>((a_pix + p * PW + dw) * 2 + (lane >> 4)));
#pragma unroll
        for (int dh = -1; dh <= 1; ++dh) {
          const int i = p - 1 - dh;
          if (i >= 0 && i < ROWS) mma_bf16(acc[i], a, b[3 * (dh + 1) + dw + 1][0],
                                           b[3 * (dh + 1) + dw + 1][1]);
        }
      }
    }
  }
  __syncthreads();  // every warp is done with the patches: y6 takes their place

  // Accumulator j of row i: group column c0 + lane / 4 + 8 (j / 2), GEMM
  // column 2 (lane % 4) + j % 2 = parity 2 dp + dq; lanes with lane % 4 < 2
  // hold the four parities, dp = lane % 4, and write y6 (2 gr + dp, 2 gc +
  // dq).
  const float* sc = scal + static_cast<long long>(s) * 5;
  const float b6 = sc[0], bns = sc[1], bnh = sc[2];
  if ((lane & 3) < 2) {
    const int dp = lane & 1;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int yy = 2 * (r0 + i) + dp, xx = 2 * (c0 + (lane >> 2) + 8 * hf);
        const int gy = Y0 - 4 + yy, gx = X0 - 4 + xx;  // gx even, W even: gx + 1 alike
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
        float2 y = make_float2(0.f, 0.f);
        if (inside)
          y = make_float2(round_to<bf16>(bns * activate(acc[i][2 * hf] + b6, act) + bnh),
                          round_to<bf16>(bns * activate(acc[i][2 * hf + 1] + b6, act) + bnh));
        *reinterpret_cast<float2*>(y6s + yy * YW + xx) = y;
      }
    }
  }
  __syncthreads();

  // up7 (taps at -3, -1, +1, +3 in both axes) and the sigmoid. A thread
  // takes outputs x to x + 3 of rows y and y + 2: they read y6 rows y - 3
  // + 2 k (k < 5; row y the first four, row y + 2 the last four), columns
  // x - 3 .. x + 6, three 16-byte loads a row (local column 0 of y6 is
  // X0 - 4, local row 0 is Y0 - 4).
  float w7[2][16];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int t = 0; t < 16; ++t) w7[c][t] = to_f32(w7k[(static_cast<long long>(s) * 2 + c) * 16 + t]);
  const float b70 = sc[3], b71 = sc[4];
  float* out = masks + static_cast<long long>(n) * 2 * H * W;
  const long long plane = static_cast<long long>(H) * W;
  for (int item = threadIdx.x; item < TY / 2 * (TX / 4); item += kThreads) {
    const int pr = item / (TX / 4);                  // row pair: rows oy, oy + 2
    const int oy = 4 * (pr >> 1) + (pr & 1), ox = 4 * (item % (TX / 4));
    const int gy = Y0 + oy, gx = X0 + ox;
    if (gy >= H || gx >= W) continue;
    float l[2][2][4];  // [row][channel][column]
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r][0][e] = b70, l[r][1][e] = b71;
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const float4* row = reinterpret_cast<const float4*>(y6s + (oy + 1 + 2 * k) * YW + ox);
      const float4 q0 = row[0], q1 = row[1], q2 = row[2];
      const float v[12] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w,
                           q2.x, q2.y, q2.z, q2.w};  // columns x - 4 .. x + 7
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int ky = k - r;  // row y + 2 r reads this y6 row through tap ky
        if (ky < 0 || ky > 3) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int kx = 0; kx < 4; ++kx) {
            l[r][0][e] = fmaf(v[e + 1 + 2 * kx], w7[0][ky * 4 + kx], l[r][0][e]);
            l[r][1][e] = fmaf(v[e + 1 + 2 * kx], w7[1][ky * 4 + kx], l[r][1][e]);
          }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (gy + 2 * r >= H) continue;
      float m[2][4];
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) m[c][e] = 1.f / (1.f + expf(-l[r][c][e]));
      float* o = out + static_cast<long long>(gy + 2 * r) * W + gx;
      if (W % 4 == 0 && gx + 3 < W) {
        *reinterpret_cast<float4*>(o) = make_float4(m[0][0], m[0][1], m[0][2], m[0][3]);
        *reinterpret_cast<float4*>(o + plane) = make_float4(m[1][0], m[1][1], m[1][2], m[1][3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (gx + e < W) o[e] = m[0][e], o[plane + e] = m[1][e];
      }
    }
  }
}

template <int kCS, int TY, int TX>
int launch_head_mma(const void* skip1, const void* up5, const void* w6k,
                    const void* w7k, const void* scal, int n_img, int bper, int H2,
                    int W2, int act, void* masks, cudaStream_t stream) {
  using Tile = HeadMma<TY, TX>;
  auto kernel = head_mma_kernel<kCS, TY, TX>;
  cudaError_t err = allow_smem(kernel, Tile::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((2 * W2 + TX - 1) / TX, (2 * H2 + TY - 1) / TY, n_img);
  kernel<<<grid, Tile::kThreads, Tile::SMEM, stream>>>(
      static_cast<const bf16*>(skip1), static_cast<const bf16*>(up5),
      static_cast<const bf16*>(w6k), static_cast<const bf16*>(w7k),
      static_cast<const float*>(scal), bper, H2, W2, act, static_cast<float*>(masks));
  return static_cast<int>(cudaGetLastError());
}

// Registers a thread, dynamic shared memory a block, threads a block and
// resident blocks an SM of one tile shape.
template <int kCS, int TY, int TX>
int head_mma_attrs(int* attrs) {
  using Tile = HeadMma<TY, TX>;
  auto kernel = head_mma_kernel<kCS, TY, TX>;
  cudaError_t err = allow_smem(kernel, Tile::SMEM);
  cudaFuncAttributes fa{};
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&attrs[3], kernel, Tile::kThreads,
                                                        Tile::SMEM);
  attrs[0] = fa.numRegs;
  attrs[1] = static_cast<int>(Tile::SMEM);
  attrs[2] = Tile::kThreads;
  return static_cast<int>(err);
}

// The mask tile of the tensor-core template, chosen by a sweep on the card
// (kernels/sweep_ends.py, PERF.md): TY, TX.
#define HEAD_MMA 32, 56

// The fixed rule: bf16 on the tensor cores, float32 on the FMA template.
template <int kCS>
int dispatch_head(int bf16_io, const void* skip1, const void* up5, const void* w6k,
                  const void* w7k, const void* scal, int n_img, int bper, int H2,
                  int W2, int act, void* masks, cudaStream_t st) {
  if (bf16_io)
    return launch_head_mma<kCS, HEAD_MMA>(skip1, up5, w6k, w7k, scal, n_img, bper, H2, W2,
                                          act, masks, st);
  return launch_head<kCS>(skip1, up5, w6k, w7k, scal, n_img, bper, H2, W2, act, masks, st);
}

}  // namespace

}  // namespace spleeterrt

// K6 over n_img images whose sources are H2 x W2 (half the mask's
// resolution). Weights: [S][32][25] float (fp32), [S][18][8][16] bf16 from
// tail._head_weights (bf16, whose sources must be 16-byte aligned).
// Launches on `stream`; returns the cudaError_t of the launch.
extern "C" int spleeterrt_head(int bf16, const void* skip1, const void* up5,
                               const void* w6k, const void* w7k,
                               const void* scal, int n_img, int bper, int H2,
                               int W2, int act, void* masks, void* stream) {
  return spleeterrt::dispatch_head<16>(bf16, skip1, up5, w6k, w7k, scal, n_img, bper, H2,
                                       W2, act, masks, static_cast<cudaStream_t>(stream));
}

// K10: the same head from one source x, [n_img][H2][W2][32].
extern "C" int spleeterrt_mask_head(int bf16, const void* x, const void* w6k,
                                    const void* w7k, const void* scal,
                                    int n_img, int bper, int H2, int W2,
                                    int act, void* masks, void* stream) {
  const size_t half = bf16 ? 16 * sizeof(__nv_bfloat16) : 16 * sizeof(float);
  const void* up5 = static_cast<const char*>(x) + half;
  return spleeterrt::dispatch_head<32>(bf16, x, up5, w6k, w7k, scal, n_img, bper, H2, W2,
                                       act, masks, static_cast<cudaStream_t>(stream));
}

// attrs[0..3] of the bf16 template of K6: registers a thread, dynamic
// shared memory a block (bytes), threads a block, resident blocks an SM.
// Returns a cudaError_t.
extern "C" int spleeterrt_head_mma_attrs(int* attrs) {
  return spleeterrt::head_mma_attrs<16, HEAD_MMA>(attrs);
}
