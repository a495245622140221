// Packed U-Net encoder layers enc1..enc4: one 5x5 stride-2 convolution
// with its epilogue fused,
//   skip = conv5x5_s2(x, w) + b                  (the decoder's skip tensor)
//   act  = act(bn_scale * skip + bn_shift)       (the next layer's input)
// for Cin -> Cout in {2 -> 16, 16 -> 32, 32 -> 64, 64 -> 128}.
//
// Replaces spleeterrt_tpu/kernels/encoder.py::_enc1_kernel (enc1, reached
// through _enc1_call) and ::_s2_kernel (enc2-enc4, through _s2_call). They
// compute the same values, not in the TPU's quad-packed 128-lane layout:
// activations are NHWC in the compute dtype, and enc1 reads the fused
// STFT's magnitude tiles (B, 2, T, F) float32 directly. Images are the
// (stem, tile) pairs: output image n uses stem n / bper's weights, and
// reads input image n % in_batch, so enc1 (in_batch = bper) reads the one
// stem-shared magnitude for every stem instead of a copy per stem. Each
// image is padded on its own (TF-SAME: input index 2 * out + k - 1, zeros
// outside), so tiles never see each other's edges.
//
// What bounds it on an H100: enc2-enc4 take 314.6 M multiply-adds per
// image against 0.32-1.28 GB per layer at 300 s, 50-200 multiply-adds per
// byte: arithmetic on the fp32 FMA units (67 TFLOP/s against 3.35 TB/s is
// 10 per byte), bytes for enc2 and enc3 and arithmetic for enc4 on the
// bf16 tensor cores (989 TFLOP/s, 148 per byte).
//
// Three templates, chosen by a fixed rule on dtype and Cin:
//
// * bf16 enc1 (Cin 2): implicit GEMM on the tensor cores, all stems in
//   one block (enc1_mma_kernel). enc1 is bound by the bytes it writes: at
//   300 s of the 4-stem graph it reads 160 MB of magnitude and writes 1.28
//   GB of bf16 skip and act, while its 16 GFLOP take ~0.02 ms of the bf16
//   tensor cores (and 0.48 ms of the fp32 FMA units). M is output pixels
//   (16 consecutive columns of one output row a warp tile), N is every
//   stem's 16 channels (16 S: the stems share the one magnitude, so a
//   block stages its fp32 patch once, rounds it to bf16 once and feeds it
//   to all stems), K is (kh, kw, ci) with ci innermost, 50 padded to 64
//   with zero weights (4 k16 steps of mma.sync m16n8k16). With ci
//   innermost an A register (two consecutive k) is one staged pixel's two
//   channels, so the patch is staged as bf16x2 pixels, its columns split
//   by parity so that a tap's stride-2 pixels are consecutive words, and
//   an A register is one 32-bit shared load. The weights, [S][16][64],
//   and the epilogue table sit in shared memory for the whole block. The
//   design is the stores: a warp runs one stem at a time (8 float32
//   accumulators a thread), applies bias, batch norm and activation in
//   float32 (the ELU as exp(z) - 1 on the hardware's exp2, as the TPU
//   kernel computes it), rounds to bf16 and transposes each quad's
//   fragments with four shuffles, so that every lane holds 8 consecutive
//   channels of one pixel and every warp store writes 16 whole pixels (512
//   contiguous bytes) with 16-byte vectors.
// * bf16 enc2-enc4 (Cin 16, 32, 64): implicit GEMM on the tensor cores
//   (enc_mma_kernel), as the TPU kernel ran them on its matrix unit with
//   bf16 operands and float32 sums. M is output pixels (TH rows x 32
//   columns a block), N is Cout, split over WN warps, so that every warp
//   of the eight computes 32 pixels x 32 channels (enc2 8 x 1 warps, enc3
//   4 x 2, enc4 2 x 4: the fastest of the shapes measured), K is the 25
//   taps walked one at a time, each Cin deep (1, 2 or 4 k16 steps of
//   mma.sync m16n8k16, float32 accumulators). mma.sync, not wgmma: it
//   takes A from registers loaded by ldmatrix with per-lane row addresses,
//   which gives the stride-2 gather for free, and it already runs each
//   layer at 300 s in about half the fp32 FMA floor or less. The input
//   patch, (2 TH + 3) x 67 pixels x Cin, is
//   staged once per block with 16-byte cp.async copies (zeros outside the
//   image), its columns split by parity so that a tap's stride-2 pixels
//   are consecutive, and its 16-byte chunks XOR-swizzled so that every
//   ldmatrix (eight consecutive pixels, one chunk each) is free of bank
//   conflicts. The weights, [S][25][Cout][Cin], stream tap by tap through
//   a three-stage cp.async ring (enc4's 410 KB do not fit in shared
//   memory), with the same swizzle. The epilogue runs on the accumulators
//   in float32 and stores both outputs per fragment as bf16x2.
// * fp32 enc1-enc4 (the fp32 parity path): fp32 FMA on CUDA cores
//   (enc_conv_kernel). A block computes 32 output columns x TH rows x all
//   Cout; each thread holds 4 rows x 16 output channels in registers (64
//   accumulators) at one column, so per (input channel, tap) it does 64
//   FMAs for 4 conflict-free shared loads of the input (columns are stored
//   split by parity, so the stride-2 taps of 32 neighbouring lanes are 32
//   consecutive words) and 4 broadcast 16-byte loads of the weights. Input
//   channels are staged CC at a time.
#include "mma.cuh"
#include "unet.cuh"

namespace spleeterrt {

namespace {

constexpr int kRows = 4;   // output rows per thread
constexpr int kCols = 16;  // output channels per thread
constexpr int kTileW = 32; // output columns per block: one per lane

template <int COUT>
struct EncTile {
  static constexpr int WC = COUT / kCols;           // warps along channels
  static constexpr int WR = 8 / WC;                 // warps along rows
  static constexpr int TH = WR * kRows;             // output rows per block
  static constexpr int PR = 2 * TH + 3;             // input rows staged
  static constexpr int PC = 2 * kTileW + 3;         // input columns staged
  static constexpr int HS = kTileW + 2;             // columns per parity
  static constexpr int RS = 2 * HS;                 // staged row stride
};

// x: NCHW (enc1's magnitude) when kNCHW, else NHWC. wk: [S][5][5][CIN][COUT].
// epi: [S][3][COUT] (b, scale, shift). skip, actv: [n_img][H/2][W/2][COUT].
// All float.
template <int CIN, int COUT, bool kNCHW, int CC>
__global__ void __launch_bounds__(kUnetThreads, 2)
enc_conv_kernel(const float* __restrict__ x, const float* __restrict__ wk,
                const float* __restrict__ epi, int bper, int in_batch, int H,
                int W, int act, float* __restrict__ skip, float* __restrict__ actv) {
  using Tile = EncTile<COUT>;
  constexpr int PR = Tile::PR, PC = Tile::PC, HS = Tile::HS, RS = Tile::RS;
  static_assert(CIN % CC == 0 && Tile::WR * Tile::WC == 8, "tile shape");
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                 // [CC][PR][2 parities][HS]
  float* ws = smem + CC * PR * RS;  // [25 taps][CC][COUT]

  const int Ho = H / 2, Wo = W / 2;
  const int n = blockIdx.z;
  const int s = n / bper;
  const long long in_img = n % in_batch;
  const int ho0 = blockIdx.y * Tile::TH, wo0 = blockIdx.x * kTileW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = warp / Tile::WC, wc = warp % Tile::WC;
  const int hi0 = 2 * ho0 - 1, wi0 = 2 * wo0 - 1;  // staged row/col 0
  const float* wstem = wk + static_cast<long long>(s) * 25 * CIN * COUT;

  float acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < CIN; c0 += CC) {
    for (int idx = threadIdx.x; idx < CC * PR * PC; idx += kUnetThreads) {
      int ci, lr, lc;  // coalesced order: columns (NCHW) or channels (NHWC)
      if (kNCHW) {
        lc = idx % PC;
        lr = (idx / PC) % PR;
        ci = idx / (PC * PR);
      } else {
        ci = idx % CC;
        lc = (idx / CC) % PC;
        lr = idx / (CC * PC);
      }
      const int hi = hi0 + lr, wi = wi0 + lc;
      float v = 0.f;
      if (hi >= 0 && hi < H && wi >= 0 && wi < W)
        v = x[kNCHW ? ((in_img * CIN + c0 + ci) * H + hi) * W + wi
                    : ((in_img * H + hi) * W + wi) * CIN + c0 + ci];
      xs[(ci * PR + lr) * RS + (lc & 1) * HS + (lc >> 1)] = v;
    }
    for (int idx = threadIdx.x; idx < 25 * CC * COUT; idx += kUnetThreads) {
      const int co = idx % COUT;
      const int ci = (idx / COUT) % CC;
      const int tap = idx / (COUT * CC);
      ws[idx] = wstem[(tap * CIN + c0 + ci) * COUT + co];
    }
    __syncthreads();

#pragma unroll 1
    for (int ci = 0; ci < CC; ++ci) {
      // Row of this thread's first output row at tap kh = 0.
      const float* xrow = xs + (ci * PR + 2 * wr * kRows) * RS + lane;
#pragma unroll
      for (int kh = 0; kh < 5; ++kh) {
#pragma unroll
        for (int kw = 0; kw < 5; ++kw) {
          // Staged column 2 * lane + kw: parity kw & 1, entry lane + kw / 2.
          float a[kRows];
#pragma unroll
          for (int i = 0; i < kRows; ++i)
            a[i] = xrow[(2 * i + kh) * RS + (kw & 1) * HS + (kw >> 1)];
          const float4* wp = reinterpret_cast<const float4*>(
              ws + ((kh * 5 + kw) * CC + ci) * COUT + wc * kCols);
#pragma unroll
          for (int q = 0; q < kCols / 4; ++q) {
            const float4 w4 = wp[q];
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
              acc[i][4 * q + 0] = fmaf(a[i], w4.x, acc[i][4 * q + 0]);
              acc[i][4 * q + 1] = fmaf(a[i], w4.y, acc[i][4 * q + 1]);
              acc[i][4 * q + 2] = fmaf(a[i], w4.z, acc[i][4 * q + 2]);
              acc[i][4 * q + 3] = fmaf(a[i], w4.w, acc[i][4 * q + 3]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  const float* e = epi + static_cast<long long>(s) * 3 * COUT + wc * kCols;
  const int wo = wo0 + lane;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int ho = ho0 + wr * kRows + i;
    if (ho >= Ho || wo >= Wo) continue;
    float sk[kCols], ac[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      sk[j] = acc[i][j] + e[j];
      ac[j] = activate(e[COUT + j] * sk[j] + e[2 * COUT + j], act);
    }
    const long long off =
        ((static_cast<long long>(n) * Ho + ho) * Wo + wo) * COUT + wc * kCols;
    store_vec(skip + off, sk);
    store_vec(actv + off, ac);
  }
}

template <int CIN, int COUT, bool kNCHW, int CC>
int launch_enc(const void* x, const void* wk, const void* epi, int n_img,
               int bper, int in_batch, int H, int W, int act, void* skip,
               void* actv, cudaStream_t stream) {
  using Tile = EncTile<COUT>;
  auto kernel = enc_conv_kernel<CIN, COUT, kNCHW, CC>;
  const size_t smem =
      sizeof(float) * (CC * Tile::PR * Tile::RS + 25 * CC * COUT);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W / 2 + kTileW - 1) / kTileW, (H / 2 + Tile::TH - 1) / Tile::TH,
                  n_img);
  kernel<<<grid, kUnetThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(wk),
      static_cast<const float*>(epi), bper, in_batch, H, W, act,
      static_cast<float*>(skip), static_cast<float*>(actv));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 enc2-enc4 on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// A block of TH x WN warps computes TH output rows x 32 columns x COUT:
// warp (wm, wn) takes row wm's 32 pixels (two m16 tiles) and channels
// [wn NW, (wn + 1) NW). The weights stream through a ring of kStages taps.
template <int CIN, int COUT, int TH_, int WN_>
struct MmaTile {
  static constexpr int TH = TH_;                  // output rows: one a warp
  static constexpr int WN = WN_;                  // warps along channels
  static constexpr int kThreads = 32 * TH * WN;
  static constexpr int NW = COUT / WN;            // channels a warp
  static constexpr int NT = NW / 8;               // n8 tiles a warp
  static constexpr int KS = CIN / 16;             // k16 steps a tap
  static constexpr int CPP = CIN / 8;             // 16-byte chunks a pixel
  static constexpr int PR = 2 * TH + 3;           // input rows staged
  static constexpr int PC = 2 * kTileW + 3;       // input columns staged
  static constexpr int HS = kTileW + 2;           // pixels per parity row
  static constexpr int PATCH = PR * 2 * HS * CPP; // chunks
  static constexpr int TAP = COUT * CPP;          // chunks of one tap
  static constexpr int kStages = 3;               // weight ring, in taps
  static constexpr size_t SMEM = 16 * static_cast<size_t>(PATCH + kStages * TAP);
  static_assert(NT % 2 == 0 && KS >= 1, "tile shape");
};

// x: NHWC bf16 (16-byte aligned). wk: [S][25][COUT][CIN] bf16. epi:
// [S][3][COUT] float. skip, actv: [n_img][H/2][W/2][COUT] bf16.
template <int CIN, int COUT, int TH, int WN>
__global__ void __launch_bounds__(MmaTile<CIN, COUT, TH, WN>::kThreads)
enc_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wk,
               const float* __restrict__ epi, int bper, int in_batch, int H,
               int W, int act, bf16* __restrict__ skip, bf16* __restrict__ actv) {
  using Tile = MmaTile<CIN, COUT, TH, WN>;
  constexpr int CPP = Tile::CPP, HS = Tile::HS, TAP = Tile::TAP;
  constexpr int kThreads = Tile::kThreads;
  extern __shared__ __align__(128) uint4 smem4[];
  uint4* patch = smem4;                 // [PR][2 parities][HS] pixels
  uint4* ring = smem4 + Tile::PATCH;    // [kStages][COUT] rows of CIN

  const int Ho = H / 2, Wo = W / 2;
  const int n = blockIdx.z;
  const int s = n / bper;
  const long long in_img = n % in_batch;
  const int ho0 = blockIdx.y * Tile::TH, wo0 = blockIdx.x * kTileW;
  const int hi0 = 2 * ho0 - 1, wi0 = 2 * wo0 - 1;  // staged row/col 0
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / Tile::WN, wn = warp % Tile::WN;
  const uint4* xg = reinterpret_cast<const uint4*>(x);
  const uint4* wg =
      reinterpret_cast<const uint4*>(wk) + static_cast<long long>(s) * 25 * TAP;

  // The patch, in the input's order (coalesced): staged (lr, lc) is input
  // (hi0 + lr, wi0 + lc); src-size 0 fills zeros outside the image.
  for (int idx = threadIdx.x; idx < Tile::PR * Tile::PC * CPP; idx += kThreads) {
    const int c = idx % CPP;
    const int lc = (idx / CPP) % Tile::PC;
    const int lr = idx / (CPP * Tile::PC);
    const int hi = hi0 + lr, wi = wi0 + lc;
    const bool in = hi >= 0 && hi < H && wi >= 0 && wi < W;
    const uint4* src = in ? xg + ((in_img * H + hi) * W + wi) * CPP + c : xg;
    const int pix = (lr * 2 + (lc & 1)) * HS + (lc >> 1);
    cp_async16(patch + swz<CPP>(pix * CPP + c), src, in);
  }
  auto load_tap = [&](int tap) {
    const uint4* src = wg + tap * TAP;
    uint4* dst = ring + (tap % Tile::kStages) * TAP;
    for (int i = threadIdx.x; i < TAP; i += kThreads)
      cp_async16(dst + swz<CPP>(i), src + i, true);
  };
  load_tap(0);
  cp_async_commit();  // group 0: the patch and tap 0
  load_tap(1);
  cp_async_commit();

  float acc[2][Tile::NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < Tile::NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  // ldmatrix rows: A row (output column) lane & 15 of an m16 tile, k half
  // lane >> 4; B row (output channel) lane & 7 of n8 tile lane >> 4, k
  // half (lane >> 3) & 1.
  const int a_col = lane & 15, a_half = lane >> 4;
  const int b_row = wn * Tile::NW + ((lane >> 4) << 3) + (lane & 7);
  const int b_half = (lane >> 3) & 1;

#pragma unroll 1
  for (int tap = 0; tap < 25; ++tap) {
    cp_async_wait<1>();  // groups up to this tap's have landed
    __syncthreads();     // ... for every thread; tap - 1's slot is free
    if (tap + 2 < 25) load_tap(tap + 2);
    cp_async_commit();   // possibly empty: one group per iteration
    const int kh = tap / 5, kw = tap % 5;
    // Output (wm, w) at tap (kh, kw) reads staged row 2 wm + kh, column
    // 2 w + kw: parity kw & 1, entry w + kw / 2.
    const int pix = ((2 * wm + kh) * 2 + (kw & 1)) * HS + (kw >> 1) + a_col;
    const uint4* wt = ring + (tap % Tile::kStages) * TAP;
#pragma unroll
    for (int ks = 0; ks < Tile::KS; ++ks) {
      unsigned a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(a[mt], patch + swz<CPP>((pix + 16 * mt) * CPP + 2 * ks + a_half));
#pragma unroll
      for (int np = 0; np < Tile::NT / 2; ++np) {
        unsigned b[4];
        ldmatrix_x4(b, wt + swz<CPP>((b_row + 16 * np) * CPP + 2 * ks + b_half));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }

  // Accumulator i of (mt, nt): output column 16 mt + lane / 4 + 8 (i / 2),
  // channel 8 nt + 2 (lane % 4) + i % 2.
  const int ho = ho0 + wm;
  if (ho >= Ho) return;
  const float* e = epi + static_cast<long long>(s) * 3 * COUT;
#pragma unroll
  for (int nt = 0; nt < Tile::NT; ++nt) {
    const int co = wn * Tile::NW + nt * 8 + 2 * (lane & 3);
    const float2 b = *reinterpret_cast<const float2*>(e + co);
    const float2 sc = *reinterpret_cast<const float2*>(e + COUT + co);
    const float2 sh = *reinterpret_cast<const float2*>(e + 2 * COUT + co);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int wo = wo0 + 16 * mt + (lane >> 2) + 8 * h;
        if (wo >= Wo) continue;
        const float sk0 = acc[mt][nt][2 * h] + b.x;
        const float sk1 = acc[mt][nt][2 * h + 1] + b.y;
        const float ac0 = activate(sc.x * sk0 + sh.x, act);
        const float ac1 = activate(sc.y * sk1 + sh.y, act);
        const long long off =
            ((static_cast<long long>(n) * Ho + ho) * Wo + wo) * COUT + co;
        *reinterpret_cast<__nv_bfloat162*>(skip + off) = __floats2bfloat162_rn(sk0, sk1);
        *reinterpret_cast<__nv_bfloat162*>(actv + off) = __floats2bfloat162_rn(ac0, ac1);
      }
  }
}

template <int CIN, int COUT, int TH, int WN>
int launch_enc_mma(const void* x, const void* wk, const void* epi, int n_img,
                   int bper, int in_batch, int H, int W, int act, void* skip,
                   void* actv, cudaStream_t stream) {
  using Tile = MmaTile<CIN, COUT, TH, WN>;
  auto kernel = enc_mma_kernel<CIN, COUT, TH, WN>;
  cudaError_t err = allow_smem(kernel, Tile::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W / 2 + kTileW - 1) / kTileW, (H / 2 + Tile::TH - 1) / Tile::TH,
                  n_img);
  kernel<<<grid, Tile::kThreads, Tile::SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wk),
      static_cast<const float*>(epi), bper, in_batch, H, W, act,
      static_cast<bf16*>(skip), static_cast<bf16*>(actv));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 enc1 on the tensor cores, every stem in one block
// ---------------------------------------------------------------------------

// A block of kWarps warps computes TH output rows x TW columns x 16 S
// channels; warp w takes the block's m16 tiles (16 consecutive columns of
// one row) w, w + kWarps, ...
template <int TH_, int TW_, int WARPS_>
struct Enc1Mma {
  static constexpr int TH = TH_;                   // output rows a block
  static constexpr int TW = TW_;                   // output columns a block
  static constexpr int kWarps = WARPS_;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kMinBlocks = 768 / kThreads;  // at most 85 registers
  static constexpr int CT = TW / 16;               // m16 tiles a row
  static constexpr int MT = TH * CT;               // m16 tiles a block
  static constexpr int PR = 2 * TH + 3;            // input rows staged
  static constexpr int PP = TW + 2;                // input column pairs staged
  // Words (bf16x2 pixels) of a parity row, 16 mod 32, so that the two
  // parities of one row fall in different banks; of a staged row.
  static constexpr int HS = PP + (48 - PP % 32) % 32;
  static constexpr int RS = 2 * HS + 8;
  static constexpr int kLoads = (PR * PP + kThreads - 1) / kThreads;  // a thread
  static constexpr int kWRow = 36;  // words of a weight row: 32 + 4 of padding
  static size_t smem(int n_stems) {
    return 4u * (static_cast<size_t>(n_stems) * (16 * kWRow + 48) + PR * RS);
  }
  static_assert(TW % 16 == 0 && MT % kWarps == 0, "tile shape");
};

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// The activation of bf16 enc1's epilogue. Its ELU is exp(z) - 1, as the
// TPU kernel computes it, on the hardware's exp2 (__expf): within ~1e-6
// of expm1f for z <= 0, far below the bf16 rounding of the stored value,
// where expm1f (activate, unet.cuh) took a third of the kernel's time.
__device__ __forceinline__ float activate_bf16(float z, int act) {
  if (act == kElu) return z > 0.f ? z : (z < -15.f ? -1.f : __expf(z) - 1.f);
  return activate(z, act);
}

// Lane q of each quad holds a[2 r + n], the bf16x2 channel pair q of pixel
// row r and n8 tile n of an m16n8 fragment pair; returns what lane q needs
// to store pixel row q >> 1, channels 8 (q & 1) .. + 7: word j is lane j's
// a[q]. A 4 x 4 transpose in two rounds of two shuffles.
__device__ __forceinline__ uint4 quad_transpose(const unsigned (&a)[4], int q) {
  const bool q0 = q & 1, q1 = q & 2;
  // Round 1, with lane q ^ 1: keep the words whose bit 0 is q0, swap the
  // others. Then c[j0 + 2 i] is word 2 i + q0 of the lane (j0, q1).
  const unsigned r0 = __shfl_xor_sync(0xffffffffu, q0 ? a[0] : a[1], 1);
  const unsigned r1 = __shfl_xor_sync(0xffffffffu, q0 ? a[2] : a[3], 1);
  const unsigned k0 = q0 ? a[1] : a[0], k1 = q0 ? a[3] : a[2];
  const unsigned c0 = q0 ? r0 : k0, c1 = q0 ? k0 : r0;
  const unsigned c2 = q0 ? r1 : k1, c3 = q0 ? k1 : r1;
  // Round 2, with lane q ^ 2: keep the words of row q1, swap the others.
  const unsigned u0 = __shfl_xor_sync(0xffffffffu, q1 ? c0 : c2, 2);
  const unsigned u1 = __shfl_xor_sync(0xffffffffu, q1 ? c1 : c3, 2);
  return make_uint4(q1 ? u0 : c0, q1 ? u1 : c1, q1 ? c2 : u0, q1 ? c3 : u1);
}

// mag: (n_tiles, 2, H, W) float, 8-byte aligned. wk: [S][16][64] bf16, k =
// 2 (5 kh + kw) + ci, zero from 50 on. epi: [S][3][16] float. skip, actv:
// [S * n_tiles][H/2][W/2][16] bf16, image s * n_tiles + b for stem s.
template <int TH, int TW, int WARPS>
__global__ void __launch_bounds__(Enc1Mma<TH, TW, WARPS>::kThreads,
                                  Enc1Mma<TH, TW, WARPS>::kMinBlocks)
enc1_mma_kernel(const float* __restrict__ mag, const bf16* __restrict__ wk,
                const float* __restrict__ epi, int n_stems, int n_tiles, int H, int W,
                int act, bf16* __restrict__ skip, bf16* __restrict__ actv) {
  using Tile = Enc1Mma<TH, TW, WARPS>;
  constexpr int PP = Tile::PP, HS = Tile::HS, RS = Tile::RS, kWRow = Tile::kWRow;
  constexpr int kThreads = Tile::kThreads, kLoads = Tile::kLoads;
  extern __shared__ __align__(16) unsigned smem_u[];
  unsigned* wsm = smem_u;                                   // [S * 16][kWRow]
  float* esm = reinterpret_cast<float*>(smem_u + n_stems * 16 * kWRow);  // [S][3][16]
  unsigned* patch = smem_u + n_stems * (16 * kWRow + 48);   // [PR][2 parities][HS]

  const int Ho = H / 2, Wo = W / 2;
  const int b = blockIdx.z;
  const int ho0 = blockIdx.y * TH, wo0 = blockIdx.x * TW;
  // Staged row lr is input row hi0 + lr; staged column c = 2 k + parity is
  // input column wi0 + c, so output column w at tap kw reads c = 2 w + kw +
  // 1: parity (kw + 1) & 1, word w + (kw + 1) / 2.
  const int hi0 = 2 * ho0 - 1, wi0 = 2 * wo0 - 2;
  const long long plane = static_cast<long long>(H) * W;
  const float* x0 = mag + 2 * static_cast<long long>(b) * plane;

  // The patch: every load in flight before the first store. A pair of
  // columns is in or out of the image as a whole (W and wi0 even).
  float2 c0[kLoads], c1[kLoads];
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int lr = idx / PP, hi = hi0 + lr, wi = wi0 + 2 * (idx % PP);
    c0[i] = c1[i] = make_float2(0.f, 0.f);
    if (idx < Tile::PR * PP && hi >= 0 && hi < H && wi >= 0 && wi < W) {
      const float* p = x0 + static_cast<long long>(hi) * W + wi;
      c0[i] = __ldg(reinterpret_cast<const float2*>(p));
      c1[i] = __ldg(reinterpret_cast<const float2*>(p + plane));
    }
  }
  const uint4* wg = reinterpret_cast<const uint4*>(wk);
  for (int i = threadIdx.x; i < n_stems * 16 * 8; i += kThreads)
    *reinterpret_cast<uint4*>(wsm + (i >> 3) * kWRow + (i & 7) * 4) = __ldg(wg + i);
  for (int i = threadIdx.x; i < n_stems * 48; i += kThreads) esm[i] = __ldg(epi + i);
  // The float32 magnitude is an operand like any other: rounded to bf16
  // once, as the TPU kernel and enc1_plain do.
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    if (idx < Tile::PR * PP) {
      unsigned* row = patch + (idx / PP) * RS + idx % PP;
      row[0] = pack_bf16x2(c0[i].x, c1[i].x);
      row[HS] = pack_bf16x2(c0[i].y, c1[i].y);
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  // This lane's A words: k pair 8 ks + 4 h + q is tap 8 ks + 4 h + q; the
  // padding taps (25..31, zero weights) read tap 0's pixel.
  int off[4][2];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tap = 8 * ks + 4 * h + q, kh = tap / 5, kw = tap % 5;
      off[ks][h] = tap < 25 ? kh * RS + ((kw + 1) & 1) * HS + ((kw + 1) >> 1) : HS;
    }
  // ldmatrix rows of B: channel 8 (lane >> 4) + (lane & 7) of the stem, k
  // half (lane >> 3) & 1 of each k16 step.
  const unsigned* wlane =
      wsm + (((lane >> 4) << 3) + (lane & 7)) * kWRow + ((lane >> 3) & 1) * 4;
  const long long img_px = static_cast<long long>(Ho) * Wo * 16;  // an image's values

#pragma unroll 1
  for (int mt = warp; mt < Tile::MT; mt += WARPS) {
    const int r = mt / Tile::CT, ho = ho0 + r, wo = wo0 + 16 * (mt % Tile::CT);
    if (ho >= Ho || wo >= Wo) continue;  // the whole warp
    const unsigned* pa = patch + 2 * r * RS + (wo - wo0) + g;
    unsigned a[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      a[ks][0] = pa[off[ks][0]];
      a[ks][1] = pa[off[ks][0] + 8];
      a[ks][2] = pa[off[ks][1]];
      a[ks][3] = pa[off[ks][1] + 8];
    }
    // After the transpose this lane stores pixel wo + g + 8 (q >> 1),
    // channels 8 (q & 1) .. + 7.
    const int wpx = wo + g + 8 * (q >> 1);
    const long long pix = static_cast<long long>(b) * img_px +
                          (static_cast<long long>(ho) * Wo + wpx) * 16 + 8 * (q & 1);
#pragma unroll 1
    for (int s = 0; s < n_stems; ++s) {
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        unsigned bf[4];
        ldmatrix_x4(bf, wlane + s * 16 * kWRow + 8 * ks);
        mma_bf16(acc[0], a[ks], bf[0], bf[1]);
        mma_bf16(acc[1], a[ks], bf[2], bf[3]);
      }
      // Accumulator i of n8 tile n: pixel g + 8 (i / 2), channel 8 n + 2 q
      // + i % 2.
      const float* e = esm + s * 48 + 2 * q;
      unsigned ws[4], wa[4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const float2 bb = *reinterpret_cast<const float2*>(e + 8 * n);
        const float2 sc = *reinterpret_cast<const float2*>(e + 16 + 8 * n);
        const float2 sh = *reinterpret_cast<const float2*>(e + 32 + 8 * n);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float s0 = acc[n][2 * h] + bb.x, s1 = acc[n][2 * h + 1] + bb.y;
          ws[2 * h + n] = pack_bf16x2(s0, s1);
          wa[2 * h + n] = pack_bf16x2(activate_bf16(sc.x * s0 + sh.x, act),
                                      activate_bf16(sc.y * s1 + sh.y, act));
        }
      }
      const uint4 vs = quad_transpose(ws, q), va = quad_transpose(wa, q);
      if (wpx < Wo) {
        const long long o = pix + static_cast<long long>(s) * n_tiles * img_px;
        *reinterpret_cast<uint4*>(skip + o) = vs;
        *reinterpret_cast<uint4*>(actv + o) = va;
      }
    }
  }
}

template <int TH, int TW, int WARPS>
int launch_enc1_mma(const void* mag, const void* wk, const void* epi, int n_stems,
                    int n_tiles, int H, int W, int act, void* skip, void* actv,
                    cudaStream_t stream) {
  using Tile = Enc1Mma<TH, TW, WARPS>;
  auto kernel = enc1_mma_kernel<TH, TW, WARPS>;
  if (n_stems < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = Tile::smem(n_stems);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W / 2 + TW - 1) / TW, (H / 2 + TH - 1) / TH, n_tiles);
  kernel<<<grid, Tile::kThreads, smem, stream>>>(
      static_cast<const float*>(mag), static_cast<const bf16*>(wk),
      static_cast<const float*>(epi), n_stems, n_tiles, H, W, act,
      static_cast<bf16*>(skip), static_cast<bf16*>(actv));
  return static_cast<int>(cudaGetLastError());
}

// Registers a thread, dynamic shared memory a block, threads a block and
// resident blocks an SM of one tile shape at n_stems stems.
template <int TH, int TW, int WARPS>
int enc1_mma_attrs(int n_stems, int* attrs) {
  using Tile = Enc1Mma<TH, TW, WARPS>;
  auto kernel = enc1_mma_kernel<TH, TW, WARPS>;
  const size_t smem = Tile::smem(n_stems);
  cudaError_t err = allow_smem(kernel, smem);
  cudaFuncAttributes fa{};
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&attrs[3], kernel, Tile::kThreads,
                                                        smem);
  attrs[0] = fa.numRegs;
  attrs[1] = static_cast<int>(smem);
  attrs[2] = Tile::kThreads;
  return static_cast<int>(err);
}

// The pixel tile of bf16 enc1, chosen by a sweep on the card
// (kernels/sweep_front.py, PERF.md): TH, TW, warps.
#define ENC1_MMA 8, 128, 8

int dispatch_enc(int cin, int bf16_io, const void* x, const void* wk,
                 const void* epi, int n_img, int bper, int in_batch, int H,
                 int W, int act, void* skip, void* actv, cudaStream_t st) {
  const int key = cin * 2 + (bf16_io ? 1 : 0);
  switch (key) {
    case 2 * 2:
      return launch_enc<2, 16, true, 2>(
          x, wk, epi, n_img, bper, in_batch, H, W, act, skip, actv, st);
    case 2 * 2 + 1:  // enc1 reads the one stem-shared magnitude: in_batch = bper
      return launch_enc1_mma<ENC1_MMA>(x, wk, epi, n_img / bper, bper, H, W, act, skip,
                                       actv, st);
    case 16 * 2:
      return launch_enc<16, 32, false, 4>(
          x, wk, epi, n_img, bper, in_batch, H, W, act, skip, actv, st);
    case 32 * 2:
      return launch_enc<32, 64, false, 4>(
          x, wk, epi, n_img, bper, in_batch, H, W, act, skip, actv, st);
    case 64 * 2:
      return launch_enc<64, 128, false, 4>(
          x, wk, epi, n_img, bper, in_batch, H, W, act, skip, actv, st);
    case 16 * 2 + 1:
      return launch_enc_mma<16, 32, 8, 1>(
          x, wk, epi, n_img, bper, in_batch, H, W, act, skip, actv, st);
    case 32 * 2 + 1:
      return launch_enc_mma<32, 64, 4, 2>(
          x, wk, epi, n_img, bper, in_batch, H, W, act, skip, actv, st);
    case 64 * 2 + 1:
      return launch_enc_mma<64, 128, 2, 4>(
          x, wk, epi, n_img, bper, in_batch, H, W, act, skip, actv, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

}  // namespace spleeterrt

// One encoder layer over n_img images of H x W (both even). cin 2 reads
// float NCHW input (enc1); cin 16/32/64 read NHWC input in the compute
// dtype (bf16 when `bf16`, else float). Weights: [S][5][5][Cin][Cout] for
// the FMA template (float), [S][16][64] for bf16 enc1 (whose magnitude
// must be 8-byte aligned) and [S][25][Cout][Cin] for bf16 enc2-enc4 (whose
// input must be 16-byte aligned) on the tensor cores. Launches on
// `stream`; returns the cudaError_t of the launch.
extern "C" int spleeterrt_enc_conv(int cin, int bf16, const void* x,
                                   const void* wk, const void* epi, int n_img,
                                   int bper, int in_batch, int H, int W,
                                   int act, void* skip, void* actv,
                                   void* stream) {
  return spleeterrt::dispatch_enc(cin, bf16, x, wk, epi, n_img, bper, in_batch,
                                  H, W, act, skip, actv,
                                  static_cast<cudaStream_t>(stream));
}

// attrs[0..3] of bf16 enc1 at n_stems stems: registers a thread, dynamic
// shared memory a block (bytes), threads a block, resident blocks an SM.
// Returns a cudaError_t.
extern "C" int spleeterrt_enc1_mma_attrs(int n_stems, int* attrs) {
  return spleeterrt::enc1_mma_attrs<ENC1_MMA>(n_stems, attrs);
}
