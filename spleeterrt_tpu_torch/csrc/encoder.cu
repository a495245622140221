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
// What bounds it on an H100: arithmetic. enc2-enc4 take 314.6 M
// multiply-adds per image against 0.6-1.3 GB per layer at 300 s, about 40
// multiply-adds per byte, far above the card's fp32 FMA balance (67 TFLOP/s
// against 3.35 TB/s is 10 per byte). The design keeps the FMA units fed
// from shared memory: a block computes 32 output columns x TH rows x all
// Cout; each thread holds 4 rows x 16 output channels in registers (64
// accumulators) at one column, so per (input channel, tap) it does 64
// FMAs for 4 conflict-free shared loads of the input (columns are stored
// split by parity, so the stride-2 taps of 32 neighbouring lanes are 32
// consecutive words) and 4 broadcast 16-byte loads of the weights. Input
// channels are staged CC at a time. fp32 FMA on CUDA cores, no tensor
// cores yet.
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

template <typename T>
int dispatch_enc(int cin, const void* x, const void* wk, const void* epi,
                 int n_img, int bper, int in_batch, int H, int W, int act,
                 void* skip, void* actv, cudaStream_t st) {
  switch (cin) {
    case 2:
      return launch_enc<float, T, 2, 16, true, 2>(x, wk, epi, n_img, bper,
                                                  in_batch, H, W, act, skip,
                                                  actv, st);
    case 16:
      return launch_enc<T, T, 16, 32, false, 4>(x, wk, epi, n_img, bper,
                                                in_batch, H, W, act, skip,
                                                actv, st);
    case 32:
      return launch_enc<T, T, 32, 64, false, 4>(x, wk, epi, n_img, bper,
                                                in_batch, H, W, act, skip,
                                                actv, st);
    case 64:
      return launch_enc<T, T, 64, 128, false, 4>(x, wk, epi, n_img, bper,
                                                 in_batch, H, W, act, skip,
                                                 actv, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

}  // namespace spleeterrt

// One encoder layer over n_img images of H x W (both even). cin 2 reads
// float NCHW input (enc1); cin 16/32/64 read NHWC input in the compute
// dtype (bf16 when `bf16`, else float). Launches on `stream`; returns the
// cudaError_t of the launch.
extern "C" int spleeterrt_enc_conv(int cin, int bf16, const void* x,
                                   const void* wk, const void* epi, int n_img,
                                   int bper, int in_batch, int H, int W,
                                   int act, void* skip, void* actv,
                                   void* stream) {
  using namespace spleeterrt;
  auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_enc<__nv_bfloat16>(cin, x, wk, epi, n_img, bper,
                                            in_batch, H, W, act, skip, actv, st)
              : dispatch_enc<float>(cin, x, wk, epi, n_img, bper, in_batch, H,
                                    W, act, skip, actv, st);
}
