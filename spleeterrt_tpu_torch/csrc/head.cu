// U-Net head: up6 + up7 + sigmoid, writing the masks straight into the
// masked iSTFT's input layout. One kernel template, two entry points:
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
//
// A block owns a 32 x 64 tile of the masks. It computes y6 on the tile plus
// a 4-pixel halo (40 x 72, 1.4x the tile: up7 reaches 3 pixels out, and the
// subpixel form makes y6 in 2 x 2 groups) into shared memory, from a
// 22 x 38 half-resolution patch of the 32 input channels staged 8 at a
// time, then runs up7 and the sigmoid from shared memory and stores
// coalesced rows of float32.
//
// What bounds it on an H100: bytes. 91 M multiply-adds per image (1.4x
// that with the halo) against 1.93 GB moved at 300 s, about 10 per byte,
// near the card's fp32 FMA balance; the masks (float32, 4 bytes per
// channel and pixel) are the largest stream. fp32 FMA on CUDA cores. K10
// stages the same channels in the same rounds as K6; only the stride from
// one pixel to the next doubles.
#include "unet.cuh"

namespace spleeterrt {

namespace {

constexpr int kTY = 32, kTX = 64;                   // mask tile
constexpr int kLH = kTY / 2 + 4, kLW = kTX / 2 + 4;  // y6 groups (2 x 2 each)
constexpr int kIH = kLH + 2, kIW = kLW + 2;         // staged input patch
constexpr int kYH = 2 * kLH, kYW = 2 * kLW;         // y6 tile with halo
constexpr int kChunk = 8;                           // input channels per round
constexpr int kGroups = kLH * kLW;
constexpr int kGroupsPerThread = (kGroups + kUnetThreads - 1) / kUnetThreads;

// skip1, up5: [n_img][H2][W2][kCS] in T, channels [0, 16) of each pixel
// read (kCS = 16: two tensors; kCS = 32: up5 = skip1 + 16 in one tensor).
// w6k: [S][32][25] in T. w7k: [S][2][16] in T. scal: [S][5] float (b6,
// bn_scale6, bn_shift6, b7[0], b7[1]). masks: [n_img][2][2 * H2][2 * W2]
// float.
template <typename T, int kCS>
__global__ void __launch_bounds__(kUnetThreads)
head_kernel(const T* __restrict__ skip1, const T* __restrict__ up5,
            const T* __restrict__ w6k, const T* __restrict__ w7k,
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
    const T* x = (c0 < 16 ? skip1 : up5) +
                 static_cast<long long>(n) * H2 * W2 * kCS + c0 % 16;
    for (int idx = tid; idx < kChunk * kIH * kIW; idx += kUnetThreads) {
      const int ci = idx % kChunk;
      const int lc = (idx / kChunk) % kIW;
      const int lr = idx / (kChunk * kIW);
      const int h = g0h - 1 + lr, w = g0w - 1 + lc;
      float v = 0.f;
      if (h >= 0 && h < H2 && w >= 0 && w < W2)
        v = to_f32(x[(static_cast<long long>(h) * W2 + w) * kCS + ci]);
      xs[ci][lr][lc] = v;
    }
    for (int idx = tid; idx < kChunk * 25; idx += kUnetThreads)
      w6s[idx / 25][idx % 25] =
          to_f32(w6k[(static_cast<long long>(s) * 32 + c0) * 25 + idx]);
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
      const float v = bns * activate(acc[k][p] + b6, act) + bnh;
      y6s[yy][xx] = inside ? round_to<T>(v) : 0.f;
    }
  }
  __syncthreads();

  // up7 (taps at -3, -1, +1, +3 in both axes) and the sigmoid.
  float w7[2][16];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int t = 0; t < 16; ++t)
      w7[c][t] = to_f32(w7k[(static_cast<long long>(s) * 2 + c) * 16 + t]);
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

template <typename T, int kCS>
int launch_head(const void* skip1, const void* up5, const void* w6k,
                const void* w7k, const void* scal, int n_img, int bper, int H2,
                int W2, int act, void* masks, cudaStream_t stream) {
  const dim3 grid((2 * W2 + kTX - 1) / kTX, (2 * H2 + kTY - 1) / kTY, n_img);
  head_kernel<T, kCS><<<grid, kUnetThreads, 0, stream>>>(
      static_cast<const T*>(skip1), static_cast<const T*>(up5),
      static_cast<const T*>(w6k), static_cast<const T*>(w7k),
      static_cast<const float*>(scal), bper, H2, W2, act,
      static_cast<float*>(masks));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

}  // namespace spleeterrt

// K6 over n_img images whose sources are H2 x W2 (half the mask's
// resolution). Launches on `stream`; returns the cudaError_t of the launch.
extern "C" int spleeterrt_head(int bf16, const void* skip1, const void* up5,
                               const void* w6k, const void* w7k,
                               const void* scal, int n_img, int bper, int H2,
                               int W2, int act, void* masks, void* stream) {
  using namespace spleeterrt;
  auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_head<__nv_bfloat16, 16>(skip1, up5, w6k, w7k, scal,
                                               n_img, bper, H2, W2, act, masks,
                                               st)
              : launch_head<float, 16>(skip1, up5, w6k, w7k, scal, n_img, bper,
                                       H2, W2, act, masks, st);
}

// K10: the same head from one source x, [n_img][H2][W2][32].
extern "C" int spleeterrt_mask_head(int bf16, const void* x, const void* w6k,
                                    const void* w7k, const void* scal,
                                    int n_img, int bper, int H2, int W2,
                                    int act, void* masks, void* stream) {
  using namespace spleeterrt;
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    return launch_head<__nv_bfloat16, 32>(xb, xb + 16, w6k, w7k, scal, n_img,
                                          bper, H2, W2, act, masks, st);
  }
  const auto* xf = static_cast<const float*>(x);
  return launch_head<float, 32>(xf, xf + 16, w6k, w7k, scal, n_img, bper, H2,
                                W2, act, masks, st);
}
