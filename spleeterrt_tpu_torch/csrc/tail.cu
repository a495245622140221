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
// materialised: K walks the skip's channels with weight rows [0, Cs) and
// then prev's with rows [Cs, 2Cs). Output image n uses stem n / bper's
// weights.
//
// Subpixel form: output row 2h' + dp takes input rows h' + dh with taps
// kh = 1 (dh 0), 3 (dh -1) for dp = 0 and kh = 0 (+1), 2 (0), 4 (-1) for
// dp = 1, i.e. kh = 1 - 2 dh + dp; columns the same. Each output parity
// (dp, dq) is a GEMM: M = input-resolution pixels, N = Cout, K = its 4, 6,
// 6 or 9 taps x 2Cs (25 taps in all).
//
// What bounds it on an H100: at 300 s (204 images) each layer does 2.57e11
// operations (629 M multiply-adds an image) and moves 0.64 GB (up4) or
// 1.28 GB (up5): on the bf16 tensor cores (989 TFLOP/s, 3.35 TB/s) up4 is
// bound by operations (0.26 ms) and up5 by bytes (0.38 ms); on the fp32 FMA
// units (67 TFLOP/s) both by operations (3.83 ms). On mma.sync m16n8k16
// no tile shape tried ran these GEMMs at even a quarter of the bf16 peak
// (PERF.md, PR 6), so bf16 takes Hopper's warpgroup MMA. Two templates,
// chosen by a fixed rule on dtype (tail._tensor_cores):
//
// * bf16: an implicit GEMM on wgmma (up_mma_kernel), as the TPU kernel ran
//   it on its matrix unit with bf16 operands and float32 sums. A block
//   takes TH input rows x 32 columns and computes all four parities x
//   Cout. Each source's patch, (TH + 2) x 34 pixels x Cs, is staged once
//   by 16-byte cp.async copies (zeros outside the image, K3's swizzle) and
//   serves every tap: the A operand of a tap that reads input (h' + dh,
//   w' + dw) is the patch shifted by (dh, dw), which ldmatrix gathers into
//   registers through its per-lane row addresses (wgmma's shared-memory
//   descriptors cannot express a one-pixel shift of the window). The 25
//   taps are walked shift by shift: the accumulators hold the parities in
//   the order 0, 1, 3, 2, in which the parities that read one shift are a
//   single run, and the weights, [S][25 taps in that order][Cout][2Cs],
//   hold each shift's taps as consecutive rows, so one wgmma m64nNk16 with
//   N = (parities) x Cout (up to 128) does a shift's whole k16 step: 9 A
//   loads and 9 wgmmas for the 25 taps. The weights stream through a
//   cp.async ring one K chunk (KC channels of all 25 taps) at a time, laid
//   out as wgmma's K-major core matrices. The epilogue runs on the
//   accumulators in float32 and stores bf16x2 straight to out[n][2h + dp]
//   [2w + dq] (staging the tile in shared memory for whole 16-byte stores
//   measured no faster). Every output sums in one fixed order (K chunk,
//   shift): no atomics, reruns bit-identical.
// * fp32 (the parity path): fp32 FMA on CUDA cores (up_tconv_kernel); TF32
//   tensor cores would not hold its 1e-5 bound. A thread owns one input
//   column and 2 rows and accumulates all four parities of each for 8
//   output channels (64 accumulators); per input channel, 12 conflict-free
//   shared loads of the 4 x 3 neighbourhood and 25 taps x 2 broadcast
//   16-byte weight loads feed 400 FMAs.
#include "mma.cuh"
#include "unet.cuh"

namespace spleeterrt {

namespace {

constexpr int kTileW = 32;  // input-resolution columns per block

// ---------------------------------------------------------------------------
// fp32 up4/up5 on CUDA cores
// ---------------------------------------------------------------------------

constexpr int kRows = 2;    // input-resolution rows per thread
constexpr int kCols = 8;    // output channels per thread
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

// skip, prev: [n_img][H][W][CS] float. wk: [S][2 * CS][5][5][COUT] float.
// epi: [S][3][COUT] float. out: [n_img][2H][2W][COUT] float.
template <int CS, int COUT>
__global__ void __launch_bounds__(kUnetThreads, 2)
up_tconv_kernel(const float* __restrict__ skip, const float* __restrict__ prev,
                const float* __restrict__ wk, const float* __restrict__ epi,
                int bper, int H, int W, int act, float* __restrict__ out) {
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
    const float* x = (src ? prev : skip) + static_cast<long long>(n) * H * W * CS;
    for (int c0 = 0; c0 < CS; c0 += CC) {
      for (int idx = threadIdx.x; idx < CC * PR * PC; idx += kUnetThreads) {
        const int ci = idx % CC;
        const int lc = (idx / CC) % PC;
        const int lr = idx / (CC * PC);
        const int h = h0 - 1 + lr, w = w0 - 1 + lc;
        float v = 0.f;
        if (h >= 0 && h < H && w >= 0 && w < W)
          v = x[(static_cast<long long>(h) * W + w) * CS + c0 + ci];
        xs[(ci * PR + lr) * PC + lc] = v;
      }
      // This chunk's weight rows are contiguous in wk.
      const float* wsrc =
          wk + (static_cast<long long>(s) * 2 * CS + src * CS + c0) * 25 * COUT;
      for (int idx = threadIdx.x; idx < CC * 25 * COUT; idx += kUnetThreads)
        ws[idx] = wsrc[idx];
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

template <int CS, int COUT>
int launch_up(const void* skip, const void* prev, const void* wk,
              const void* epi, int n_img, int bper, int H, int W, int act,
              void* out, cudaStream_t stream) {
  using Tile = UpTile<COUT>;
  auto kernel = up_tconv_kernel<CS, COUT>;
  const size_t smem = sizeof(float) * (Tile::XS + kChunk * 25 * COUT);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + kTileW - 1) / kTileW, (H + Tile::TH - 1) / Tile::TH, n_img);
  kernel<<<grid, kUnetThreads, smem, stream>>>(
      static_cast<const float*>(skip), static_cast<const float*>(prev),
      static_cast<const float*>(wk), static_cast<const float*>(epi), bper, H, W,
      act, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 up4/up5 on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// Shift sh = 3 (dh + 1) + (dw + 1) feeds parity p = 2 dp + dq unless dh = +1
// with dp = 0 or dw = +1 with dq = 0 (no tap 1 - 2 dh + dp in [0, 5)).
__host__ __device__ constexpr bool up_reads(int sh, int p) {
  return !(sh / 3 == 2 && p < 2) && !(sh % 3 == 2 && (p & 1) == 0);
}

// Accumulator slot -> parity: 0, 1, 3, 2. In this order the parities that
// read any one shift ({0, 1, 2, 3}, {1, 3}, {2, 3} or {3}) are one run of
// slots, so one wgmma covers them all.
__host__ __device__ constexpr int up_parity(int slot) { return slot ^ (slot >> 1); }

// Index of (sh, slot) in the weights' tap order: shifts in order, and within
// a shift the slots that read it in order (tail._UP_TAPS in Python).
__host__ __device__ constexpr int up_tap(int sh, int slot) {
  int t = 0;
  for (int i = 0; i < 4 * sh + slot; ++i) t += up_reads(i / 4, up_parity(i % 4)) ? 1 : 0;
  return t;
}
static_assert(up_tap(8, 2) == 24 && up_reads(8, up_parity(2)), "25 taps");

// The first slot that reads shift sh, and how many do.
__host__ __device__ constexpr int up_slot0(int sh) {
  return up_reads(sh, up_parity(0)) ? 0 : up_reads(sh, up_parity(1)) ? 1 : 2;
}
__host__ __device__ constexpr int up_slots(int sh) {
  return up_tap(sh + 1, 0) - up_tap(sh, 0);
}

// A block of WG warpgroups computes TH = 2 WG input rows x 32 columns x 4
// parities x COUT: warpgroup g takes rows 2g, 2g + 1 (M = 64 pixels; warp
// q of it the 16 pixels of row q / 2, columns 16 (q & 1) + [0, 16)). For
// each shift and k16 step one wgmma m64nNk16 takes A (the shifted patch)
// from registers, loaded by ldmatrix, and B from the ring: the shift's
// taps are consecutive weight rows, so N = (slots reading it) x COUT and
// the accumulators are those slots' run. The weights stream through a ring
// of NSTAGE stages, each KC channels of K for all 25 taps, held as wgmma's
// K-major core matrices: row r, chunk c at ((r / 8) KCC + c) 8 + r % 8
// (16-byte chunks).
template <int CS, int COUT, int WG, int KC, int NSTAGE>
struct UpMma {
  static constexpr int kThreads = 128 * WG;
  static constexpr int TH = 2 * WG;             // input rows a block
  static constexpr int PR = TH + 2;             // patch rows (1 halo each side)
  static constexpr int PC = kTileW + 2;         // patch columns
  static constexpr int CPP = CS / 8;            // 16-byte chunks a pixel
  static constexpr int PATCH = PR * PC * CPP;   // chunks, per source
  static constexpr int KCC = KC / 8;            // chunks of a weight row a stage
  static constexpr int STAGE = 25 * COUT * KCC; // chunks
  static constexpr int NK = 2 * CS / KC;        // K chunks: skip's, then prev's
  static constexpr int RING = NSTAGE < NK ? NSTAGE : NK;
  static constexpr int CH = COUT / 2;           // accumulators a thread, per slot
  static constexpr size_t SMEM = 16 * static_cast<size_t>(2 * PATCH + RING * STAGE);
  static_assert(COUT % 16 == 0 && CS % KC == 0 && KC % 16 == 0 && NSTAGE >= 2,
                "tile shape");
};

template <int COUT>
__device__ __forceinline__ void wgmma_slots(float* d, int slots, const unsigned (&a)[4],
                                            unsigned long long desc) {
  if (slots == 4) wgmma_bf16<4 * COUT>(d, a, desc);
  else if (slots == 2) wgmma_bf16<2 * COUT>(d, a, desc);
  else wgmma_bf16<COUT>(d, a, desc);
}

// skip, prev: NHWC bf16 [n_img][H][W][CS] (16-byte aligned). wk: [S][25]
// [COUT][2 CS] bf16, taps in up_tap order. epi: [S][3][COUT] float. out:
// [n_img][2H][2W][COUT] bf16.
template <int CS, int COUT, int WG, int KC, int NSTAGE>
__global__ void __launch_bounds__(UpMma<CS, COUT, WG, KC, NSTAGE>::kThreads)
up_mma_kernel(const bf16* __restrict__ skip, const bf16* __restrict__ prev,
              const bf16* __restrict__ wk, const float* __restrict__ epi,
              int bper, int H, int W, int act, bf16* __restrict__ out) {
  using Tile = UpMma<CS, COUT, WG, KC, NSTAGE>;
  constexpr int CPP = Tile::CPP, KCC = Tile::KCC, PC = Tile::PC, CH = Tile::CH;
  constexpr int STAGE = Tile::STAGE, kThreads = Tile::kThreads;
  constexpr int KS = KC / 16, STEPS = 9 * KS;
  extern __shared__ __align__(128) uint4 smem4[];
  uint4* patch = smem4;                    // [2 sources][PR][PC] pixels
  uint4* ring = smem4 + 2 * Tile::PATCH;   // [RING][25 COUT / 8][KCC][8 rows]

  const int n = blockIdx.z;
  const int s = n / bper;
  const int h0 = blockIdx.y * Tile::TH, w0 = blockIdx.x * kTileW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = warp >> 2, q = warp & 3;  // warpgroup, warp in it
  const uint4* wg =
      reinterpret_cast<const uint4*>(wk) + static_cast<long long>(s) * 25 * COUT * 2 * CPP;

  // The patches, in the input's order (coalesced): staged (lr, lc) is
  // input (h0 - 1 + lr, w0 - 1 + lc); src-size 0 fills zeros outside. The
  // K3 swizzle keeps every ldmatrix free of bank conflicts.
  {
    const long long img = static_cast<long long>(n) * H * W * CPP;
    const uint4* xs = reinterpret_cast<const uint4*>(skip) + img;
    const uint4* xp = reinterpret_cast<const uint4*>(prev) + img;
    for (int idx = threadIdx.x; idx < Tile::PATCH; idx += kThreads) {
      const int c = idx % CPP;
      const int lc = (idx / CPP) % PC;
      const int lr = idx / (CPP * PC);
      const int h = h0 - 1 + lr, w = w0 - 1 + lc;
      const bool in = h >= 0 && h < H && w >= 0 && w < W;
      const int off = in ? (h * W + w) * CPP + c : 0;
      cp_async16(patch + swz<CPP>(idx), xs + off, in);
      cp_async16(patch + Tile::PATCH + swz<CPP>(idx), xp + off, in);
    }
  }
  // Stage kc: chunks [kc KCC, (kc + 1) KCC) of every weight row.
  auto load_stage = [&](int kc) {
    const uint4* src = wg + kc * KCC;
    uint4* dst = ring + (kc % NSTAGE) * STAGE;
    for (int i = threadIdx.x; i < STAGE; i += kThreads) {
      const int r = i / KCC, c = i % KCC;
      cp_async16(dst + ((r >> 3) * KCC + c) * 8 + (r & 7), src + r * (2 * CPP) + c, true);
    }
  };
  load_stage(0);
  cp_async_commit();  // group 0: the patches and stage 0
#pragma unroll
  for (int j = 1; j < NSTAGE - 1; ++j) {
    if (j < Tile::NK) load_stage(j);
    cp_async_commit();
  }

  float acc[4 * CH];  // [slot][n8 block][fragment]
#pragma unroll
  for (int i = 0; i < 4 * CH; ++i) acc[i] = 0.f;
  // ldmatrix rows: pixel lane & 15 of this warp's 16, k half lane >> 4.
  const int a_pix = (2 * g + q / 2 + 1) * PC + 16 * (q & 1) + (lane & 15) + 1;
  const int a_half = lane >> 4;

#pragma unroll 1
  for (int kc = 0; kc < Tile::NK; ++kc) {
    cp_async_wait<NSTAGE - 2>();  // this thread's copies of stage kc landed
    fence_proxy_async();          // ... visible to wgmma's reads
    __syncthreads();              // ... for every thread; kc - 1's slot is free
    if (kc + NSTAGE - 1 < Tile::NK) load_stage(kc + NSTAGE - 1);
    cp_async_commit();            // possibly empty: one group per iteration
    const uint4* x = patch + (kc * KC >= CS ? Tile::PATCH : 0);
    const int c0 = (kc * KCC) % CPP;  // this chunk's first 16 bytes of a pixel
    const uint4* wt = ring + (kc % NSTAGE) * STAGE;
    unsigned a[STEPS][4];  // step u = (shift u / KS, k16 step u % KS)
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {
      const int sh = u / KS, ks = u % KS;
      const int shift = (sh / 3 - 1) * PC + sh % 3 - 1;  // dh PC + dw
      ldmatrix_x4(a[u], x + swz<CPP>((a_pix + shift) * CPP + c0 + 2 * ks + a_half));
    }
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {
      const int sh = u / KS, ks = u % KS;
      const uint4* b = wt + ((up_tap(sh, 0) * COUT / 8) * KCC + 2 * ks) * 8;
      wgmma_slots<COUT>(acc + up_slot0(sh) * CH, up_slots(sh), a[u],
                        wgmma_desc(b, 128, 128 * KCC));
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int u = 0; u < STEPS; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i) pin(a[u][i]);  // live until the wgmmas read them
  }
#pragma unroll
  for (int i = 0; i < 4 * CH; ++i) pin(acc[i]);

  // Accumulator 4 j + i of a slot: pixel lane / 4 + 8 (i / 2) of this
  // warp's 16, channel 8 j + 2 (lane % 4) + i % 2.
  const float* e = epi + static_cast<long long>(s) * 3 * COUT;
  const int h = h0 + 2 * g + q / 2;
#pragma unroll
  for (int j = 0; j < COUT / 8; ++j) {
    const int co = 8 * j + 2 * (lane & 3);
    const float2 b = *reinterpret_cast<const float2*>(e + co);
    const float2 sc = *reinterpret_cast<const float2*>(e + COUT + co);
    const float2 sf = *reinterpret_cast<const float2*>(e + 2 * COUT + co);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int w = w0 + 16 * (q & 1) + (lane >> 2) + 8 * hf;
      if (h >= H || w >= W) continue;
#pragma unroll
      for (int slot = 0; slot < 4; ++slot) {
        const int p = up_parity(slot);
        const float* d = acc + slot * CH + 4 * j + 2 * hf;
        const float y0 = sc.x * activate(d[0] + b.x, act) + sf.x;
        const float y1 = sc.y * activate(d[1] + b.y, act) + sf.y;
        const long long off =
            ((static_cast<long long>(n) * 2 * H + 2 * h + (p >> 1)) * 2 * W + 2 * w +
             (p & 1)) * COUT + co;
        *reinterpret_cast<__nv_bfloat162*>(out + off) = __floats2bfloat162_rn(y0, y1);
      }
    }
  }
}

template <int CS, int COUT, int WG, int KC, int NSTAGE>
int launch_up_mma(const void* skip, const void* prev, const void* wk,
                  const void* epi, int n_img, int bper, int H, int W, int act,
                  void* out, cudaStream_t stream) {
  using Tile = UpMma<CS, COUT, WG, KC, NSTAGE>;
  auto kernel = up_mma_kernel<CS, COUT, WG, KC, NSTAGE>;
  cudaError_t err = allow_smem(kernel, Tile::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + kTileW - 1) / kTileW, (H + Tile::TH - 1) / Tile::TH, n_img);
  kernel<<<grid, Tile::kThreads, Tile::SMEM, stream>>>(
      static_cast<const bf16*>(skip), static_cast<const bf16*>(prev),
      static_cast<const bf16*>(wk), static_cast<const float*>(epi), bper, H, W,
      act, static_cast<bf16*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Registers a thread, dynamic shared memory a block, threads a block and
// resident blocks an SM of one tile shape.
template <int CS, int COUT, int WG, int KC, int NSTAGE>
int up_mma_attrs(int* attrs) {
  using Tile = UpMma<CS, COUT, WG, KC, NSTAGE>;
  auto kernel = up_mma_kernel<CS, COUT, WG, KC, NSTAGE>;
  cudaError_t err = allow_smem(kernel, Tile::SMEM);
  cudaFuncAttributes fa{};
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&attrs[3], kernel,
                                                        Tile::kThreads, Tile::SMEM);
  attrs[0] = fa.numRegs;
  attrs[1] = static_cast<int>(Tile::SMEM);
  attrs[2] = Tile::kThreads;
  return static_cast<int>(err);
}

// The tile shapes of the tensor-core template, chosen by a sweep on the
// card (kernels/sweep_up.py, PERF.md): CS, COUT, WG, KC, NSTAGE.
#define UP4_MMA 64, 32, 4, 16, 2
#define UP5_MMA 32, 16, 4, 16, 3

// The fixed rule: bf16 on the tensor cores, fp32 on the FMA template.
int dispatch_up(int cs, int bf16_io, const void* skip, const void* prev,
                const void* wk, const void* epi, int n_img, int bper, int H,
                int W, int act, void* out, cudaStream_t st) {
  switch (cs * 2 + (bf16_io ? 1 : 0)) {
    case 64 * 2:
      return launch_up<64, 32>(skip, prev, wk, epi, n_img, bper, H, W, act, out, st);
    case 32 * 2:
      return launch_up<32, 16>(skip, prev, wk, epi, n_img, bper, H, W, act, out, st);
    case 64 * 2 + 1:
      return launch_up_mma<UP4_MMA>(skip, prev, wk, epi, n_img, bper, H, W, act, out, st);
    case 32 * 2 + 1:
      return launch_up_mma<UP5_MMA>(skip, prev, wk, epi, n_img, bper, H, W, act, out, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

}  // namespace spleeterrt

// up4 (cs 64) or up5 (cs 32) over n_img images of H x W at input
// resolution. Weights: [S][2 cs][5][5][Cout] float for the FMA template
// (fp32), [S][25][Cout][2 cs] bf16 in up_tap order for the tensor cores
// (bf16), whose sources must be 16-byte aligned. Launches on
// `stream`; returns the cudaError_t of the launch.
extern "C" int spleeterrt_up_tconv(int cs, int bf16, const void* skip,
                                   const void* prev, const void* wk,
                                   const void* epi, int n_img, int bper, int H,
                                   int W, int act, void* out, void* stream) {
  return spleeterrt::dispatch_up(cs, bf16, skip, prev, wk, epi, n_img, bper, H, W,
                                 act, out, static_cast<cudaStream_t>(stream));
}

// attrs[0..3] of the bf16 template for cs 64 (up4) or 32 (up5): registers a
// thread, dynamic shared memory a block (bytes), threads a block, resident
// blocks an SM. Returns a cudaError_t.
extern "C" int spleeterrt_up_mma_attrs(int cs, int* attrs) {
  using namespace spleeterrt;
  if (cs == 64) return up_mma_attrs<UP4_MMA>(attrs);
  if (cs == 32) return up_mma_attrs<UP5_MMA>(attrs);
  return static_cast<int>(cudaErrorInvalidValue);
}
