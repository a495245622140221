// Packed U-Net decoder layers up4 and up5: a 5x5 stride-2 TF-SAME
// transposed convolution over the concat [skip, prev] with the decoder
// epilogue fused (activation BEFORE batch norm, Executable/spleeter.c:
// 244-245):
//   z   = tconv5x5_s2([skip, prev], w) + b,   out[2h + k - 1] += x[h] w[k]
//   out = bn_scale * act(z) + bn_shift
// for (Cs + Cs) -> Cout in {(64 + 64) -> 32 (up4), (32 + 32) -> 16 (up5)}.
//
// Replaces spleeterrt_tpu/kernels/tail.py::_up_kernel_pair (up4) and
// ::_up_kernel_quad (up5), both reached through up_shallow. Same values,
// not the TPU's quad-packed layout or selection-matrix weights: sources and
// output are NHWC in the compute dtype. The concat is split-K and never
// materialised: the kernel walks the skip's channels with weight rows
// [0, Cs) and then prev's with rows [Cs, 2Cs). Output image n uses stem
// n / bper's weights.
//
// Subpixel form: output row 2h' + dp takes input rows h' + dh with taps
// kh = 1 (dh 0), 3 (dh -1) for dp = 0 and kh = 0 (+1), 2 (0), 4 (-1) for
// dp = 1; columns the same. A thread owns one input-resolution column w'
// and 2 rows h', and accumulates all four output parities of each, for 8
// output channels: 64 accumulators.
//
// What bounds it on an H100: arithmetic. 629 M multiply-adds per image
// against 0.64 GB (up4) / 1.28 GB (up5) moved at 300 s, about 100 per byte.
// Per (input channel): 12 conflict-free shared loads of the 4 x 3 input
// neighbourhood, then 25 taps x 2 broadcast 16-byte weight loads feeding
// 400 FMAs. fp32 FMA on CUDA cores, no tensor cores yet.
#include "unet.cuh"

namespace spleeterrt {

namespace {

constexpr int kRows = 2;    // input-resolution rows per thread
constexpr int kCols = 8;    // output channels per thread
constexpr int kTileW = 32;  // input-resolution columns per block
constexpr int kChunk = 8;   // input channels staged per round

template <int COUT>
struct UpTile {
  static constexpr int WC = COUT / kCols;
  static constexpr int WR = 8 / WC;
  static constexpr int TH = WR * kRows;  // input-resolution rows per block
  static constexpr int PR = TH + 2;      // staged rows (1 halo each side)
  static constexpr int PC = kTileW + 2;  // staged columns
  static constexpr int XS = (kChunk * PR * PC + 3) / 4 * 4;  // floats
};

// skip, prev: [n_img][H][W][CS] in T. wk: [S][2 * CS][5][5][COUT] in T.
// epi: [S][3][COUT] float. out: [n_img][2H][2W][COUT] in T.
template <typename T, int CS, int COUT>
__global__ void __launch_bounds__(kUnetThreads, 2)
up_tconv_kernel(const T* __restrict__ skip, const T* __restrict__ prev,
                const T* __restrict__ wk, const float* __restrict__ epi,
                int bper, int H, int W, int act, T* __restrict__ out) {
  using Tile = UpTile<COUT>;
  constexpr int PR = Tile::PR, PC = Tile::PC, CC = kChunk;
  static_assert(CS % CC == 0 && Tile::WR * Tile::WC == 8, "tile shape");
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;             // [CC][PR][PC]
  float* ws = smem + Tile::XS;  // [CC][25 taps][COUT]

  const int n = blockIdx.z;
  const int s = n / bper;
  const int h0 = blockIdx.y * Tile::TH, w0 = blockIdx.x * kTileW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = warp / Tile::WC, wc = warp % Tile::WC;

  float acc[kRows][4][kCols];  // [row][dp * 2 + dq][channel]
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][p][j] = 0.f;

  for (int src = 0; src < 2; ++src) {
    const T* x = (src ? prev : skip) + static_cast<long long>(n) * H * W * CS;
    for (int c0 = 0; c0 < CS; c0 += CC) {
      for (int idx = threadIdx.x; idx < CC * PR * PC; idx += kUnetThreads) {
        const int ci = idx % CC;
        const int lc = (idx / CC) % PC;
        const int lr = idx / (CC * PC);
        const int h = h0 - 1 + lr, w = w0 - 1 + lc;
        float v = 0.f;
        if (h >= 0 && h < H && w >= 0 && w < W)
          v = to_f32(x[(static_cast<long long>(h) * W + w) * CS + c0 + ci]);
        xs[(ci * PR + lr) * PC + lc] = v;
      }
      // This chunk's weight rows are contiguous in wk.
      const T* wsrc =
          wk + (static_cast<long long>(s) * 2 * CS + src * CS + c0) * 25 * COUT;
      for (int idx = threadIdx.x; idx < CC * 25 * COUT; idx += kUnetThreads)
        ws[idx] = to_f32(wsrc[idx]);
      __syncthreads();

#pragma unroll 1
      for (int ci = 0; ci < CC; ++ci) {
        // xin[r][c] = x[h0 + wr * kRows + r - 1][w0 + lane + c - 1]
        float xin[kRows + 2][3];
#pragma unroll
        for (int r = 0; r < kRows + 2; ++r)
#pragma unroll
          for (int c = 0; c < 3; ++c)
            xin[r][c] = xs[(ci * PR + wr * kRows + r) * PC + lane + c];
#pragma unroll
        for (int kh = 0; kh < 5; ++kh) {
          const int dp = (kh & 1) ? 0 : 1;
          const int dh = (kh & 1) ? (1 - kh) / 2 : (2 - kh) / 2;
#pragma unroll
          for (int kw = 0; kw < 5; ++kw) {
            const int dq = (kw & 1) ? 0 : 1;
            const int dw = (kw & 1) ? (1 - kw) / 2 : (2 - kw) / 2;
            const float4* wp = reinterpret_cast<const float4*>(
                ws + (ci * 25 + kh * 5 + kw) * COUT + wc * kCols);
            const float4 wa = wp[0], wb = wp[1];
            const float wv[kCols] = {wa.x, wa.y, wa.z, wa.w,
                                     wb.x, wb.y, wb.z, wb.w};
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
              const float a = xin[i + 1 + dh][1 + dw];
#pragma unroll
              for (int j = 0; j < kCols; ++j)
                acc[i][dp * 2 + dq][j] = fmaf(a, wv[j], acc[i][dp * 2 + dq][j]);
            }
          }
        }
      }
      __syncthreads();
    }
  }

  const float* e = epi + static_cast<long long>(s) * 3 * COUT + wc * kCols;
  const int w = w0 + lane;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int h = h0 + wr * kRows + i;
    if (h >= H || w >= W) continue;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      float y[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        y[j] = e[COUT + j] * activate(acc[i][p][j] + e[j], act) + e[2 * COUT + j];
      const long long oy = 2 * h + (p >> 1), ox = 2 * w + (p & 1);
      store_vec(out + ((static_cast<long long>(n) * 2 * H + oy) * 2 * W + ox) *
                          COUT + wc * kCols,
                y);
    }
  }
}

template <typename T, int CS, int COUT>
int launch_up(const void* skip, const void* prev, const void* wk,
              const void* epi, int n_img, int bper, int H, int W, int act,
              void* out, cudaStream_t stream) {
  using Tile = UpTile<COUT>;
  auto kernel = up_tconv_kernel<T, CS, COUT>;
  const size_t smem = sizeof(float) * (Tile::XS + kChunk * 25 * COUT);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + kTileW - 1) / kTileW, (H + Tile::TH - 1) / Tile::TH, n_img);
  kernel<<<grid, kUnetThreads, smem, stream>>>(
      static_cast<const T*>(skip), static_cast<const T*>(prev),
      static_cast<const T*>(wk), static_cast<const float*>(epi), bper, H, W,
      act, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_up(int cs, const void* skip, const void* prev, const void* wk,
                const void* epi, int n_img, int bper, int H, int W, int act,
                void* out, cudaStream_t st) {
  switch (cs) {
    case 64:
      return launch_up<T, 64, 32>(skip, prev, wk, epi, n_img, bper, H, W, act,
                                  out, st);
    case 32:
      return launch_up<T, 32, 16>(skip, prev, wk, epi, n_img, bper, H, W, act,
                                  out, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

}  // namespace spleeterrt

// up4 (cs 64) or up5 (cs 32) over n_img images of H x W at input
// resolution. Launches on `stream`; returns the cudaError_t of the launch.
extern "C" int spleeterrt_up_tconv(int cs, int bf16, const void* skip,
                                   const void* prev, const void* wk,
                                   const void* epi, int n_img, int bper, int H,
                                   int W, int act, void* out, void* stream) {
  using namespace spleeterrt;
  auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_up<__nv_bfloat16>(cs, skip, prev, wk, epi, n_img,
                                           bper, H, W, act, out, st)
              : dispatch_up<float>(cs, skip, prev, wk, epi, n_img, bper, H, W,
                                   act, out, st);
}
