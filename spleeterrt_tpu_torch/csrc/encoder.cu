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
// Two templates, chosen by a fixed rule on dtype and Cin:
//
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
// * fp32 enc2-enc4 (the fp32 parity path) and enc1 in either dtype (Cin =
//   2, too shallow for k16 tiles): fp32 FMA on CUDA cores
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

// x: NCHW float (enc1's magnitude) when kNCHW, else NHWC T.
// wk: [S][5][5][CIN][COUT] in T. epi: [S][3][COUT] float (b, scale, shift).
// skip, actv: [n_img][H/2][W/2][COUT] in T.
template <typename TIn, typename T, int CIN, int COUT, bool kNCHW, int CC>
__global__ void __launch_bounds__(kUnetThreads, 2)
enc_conv_kernel(const TIn* __restrict__ x, const T* __restrict__ wk,
                const float* __restrict__ epi, int bper, int in_batch, int H,
                int W, int act, T* __restrict__ skip, T* __restrict__ actv) {
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
  const T* wstem = wk + static_cast<long long>(s) * 25 * CIN * COUT;

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
      if (hi >= 0 && hi < H && wi >= 0 && wi < W) {
        const long long off =
            kNCHW ? ((in_img * CIN + c0 + ci) * H + hi) * W + wi
                  : ((in_img * H + hi) * W + wi) * CIN + c0 + ci;
        // enc1's float32 magnitude is an operand like any other: rounded
        // to the compute dtype first, as the TPU kernel and enc1_plain do.
        v = kNCHW ? round_to<T>(to_f32(x[off])) : to_f32(x[off]);
      }
      xs[(ci * PR + lr) * RS + (lc & 1) * HS + (lc >> 1)] = v;
    }
    for (int idx = threadIdx.x; idx < 25 * CC * COUT; idx += kUnetThreads) {
      const int co = idx % COUT;
      const int ci = (idx / COUT) % CC;
      const int tap = idx / (COUT * CC);
      ws[idx] = to_f32(wstem[(tap * CIN + c0 + ci) * COUT + co]);
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

template <typename TIn, typename T, int CIN, int COUT, bool kNCHW, int CC>
int launch_enc(const void* x, const void* wk, const void* epi, int n_img,
               int bper, int in_batch, int H, int W, int act, void* skip,
               void* actv, cudaStream_t stream) {
  using Tile = EncTile<COUT>;
  auto kernel = enc_conv_kernel<TIn, T, CIN, COUT, kNCHW, CC>;
  const size_t smem =
      sizeof(float) * (CC * Tile::PR * Tile::RS + 25 * CC * COUT);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W / 2 + kTileW - 1) / kTileW, (H / 2 + Tile::TH - 1) / Tile::TH,
                  n_img);
  kernel<<<grid, kUnetThreads, smem, stream>>>(
      static_cast<const TIn*>(x), static_cast<const T*>(wk),
      static_cast<const float*>(epi), bper, in_batch, H, W, act,
      static_cast<T*>(skip), static_cast<T*>(actv));
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

int dispatch_enc(int cin, int bf16_io, const void* x, const void* wk,
                 const void* epi, int n_img, int bper, int in_batch, int H,
                 int W, int act, void* skip, void* actv, cudaStream_t st) {
  const int key = cin * 2 + (bf16_io ? 1 : 0);
  switch (key) {
    case 2 * 2:
      return launch_enc<float, float, 2, 16, true, 2>(
          x, wk, epi, n_img, bper, in_batch, H, W, act, skip, actv, st);
    case 2 * 2 + 1:
      return launch_enc<float, bf16, 2, 16, true, 2>(
          x, wk, epi, n_img, bper, in_batch, H, W, act, skip, actv, st);
    case 16 * 2:
      return launch_enc<float, float, 16, 32, false, 4>(
          x, wk, epi, n_img, bper, in_batch, H, W, act, skip, actv, st);
    case 32 * 2:
      return launch_enc<float, float, 32, 64, false, 4>(
          x, wk, epi, n_img, bper, in_batch, H, W, act, skip, actv, st);
    case 64 * 2:
      return launch_enc<float, float, 64, 128, false, 4>(
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
// the FMA template (float, and enc1 in either dtype), [S][25][Cout][Cin]
// for bf16 enc2-enc4 on the tensor cores, whose input must be 16-byte
// aligned. Launches on `stream`; returns the cudaError_t of the launch.
extern "C" int spleeterrt_enc_conv(int cin, int bf16, const void* x,
                                   const void* wk, const void* epi, int n_img,
                                   int bper, int in_batch, int H, int W,
                                   int act, void* skip, void* actv,
                                   void* stream) {
  return spleeterrt::dispatch_enc(cin, bf16, x, wk, epi, n_img, bper, in_batch,
                                  H, W, act, skip, actv,
                                  static_cast<cudaStream_t>(stream));
}
