// K8 — the window-rotation probe: three ways to produce and fold the 9
// stencil-shifted [R, BLK] views of one staged [R, W] window.
//
// Replaces tools/mxu_rotation_probe.py `_call` (the Pallas probe over
// `_k_slice`, `_k_mxu` and `_k_base`).  The question is the staging of the
// pre-shifted pass A (K4, which launches csrc/pass_a_2d.cu): is a shift
// cheaper as shifted loads, or as a product with a 0/1 matrix on the
// matrix units?
// Each of the g output blocks reads the same window x (f32 [R, W], W = BLK +
// 2H) and writes out[:, b*BLK:(b+1)*BLK] (f32 [R, BLK*g]):
//
//   slice — 9 shifted loads: acc = 0, then acc += CS[o] * x[r, H + OFFS[o]
//           + l] over the offsets in order;
//   mma   — y = x @ S on the tensor cores, S the 0/1 [W, 9*BLK] matrix with
//           S[H + OFFS[o] + l, o*BLK + l] = 1 (`ops/rotation_probe.py`
//           `shift_matrix`), then the same fold over y's 256-wide aligned
//           column blocks: acc += CS[o] * y[r, o*BLK + l];
//   base  — one aligned view x[r, H + l], folded 9 times with CS: the
//           floor, everything but the shifts.
//
// Every fold step is one fused multiply-add, acc = fma(CS[o], view, acc),
// rounded once, over the offsets in the TPU kernels' order: what XLA makes of
// the JAX probe's `acc + c * view` (the JAX package's tests run it on the
// CPU, in interpret mode), and what the plain PyTorch version computes in
// f64 before its one rounding to f32 (`ops/rotation_probe.py` `plain`), so
// each variant is bitwise both.
//
// The product is exact.  One TF32 pass would round x to 10 mantissa bits,
// so each A fragment is split into three TF32 parts by truncation, hi = x
// with its low 13 mantissa bits cleared, mid = (x - hi) likewise and lo =
// x - hi - mid (at most 2 significant bits), and the three products are
// accumulated in f32 (mma.sync m16n8k8 TF32).
// Each column of S holds one 1, so every sum adds hi, mid and lo of one
// element to exact zeros: hi, then hi + mid (x truncated to 22 bits), then
// x, each exactly representable.  So y == x's shifted views bit for bit,
// and `mma` is bitwise `slice`, as Precision.HIGHEST makes it on the TPU.
//
// What bounds it on an H100: `slice` and `base` the bytes (one read of x
// and the [R, BLK*g] write over 3.35 TB/s); `mma` the operations, 3 x R x W
// x 9*BLK multiply-adds a block at the dense TF32 rate of 495 TFLOP/s (the
// dense product's cost, which the TPU probe pays too: 0.096 ms at g = 19).
// Design: `slice` and `base` a thread per output element, a block per
// output row and block, so neighbouring threads read and write
// neighbouring addresses.  `mma` is a tensor-core GEMM whose A operand
// costs four more instructions an element (the split) and whose B operand
// is read from L2 once per row tile: a block of 8 warps takes 64 rows x 128
// columns of one output block, stages its 64 rows of x in shared memory
// once (cp.async), and runs the 9 offsets in 3 passes of 3, holding the 3
// views y of 32 x 32 per warp in registers over the full depth W, so each
// A fragment is loaded and split once a pass and feeds 3 x 4 x 3 mma.sync;
// S's k-tiles for the pass stream through a 3-deep cp.async ring; each
// view is folded into the lane's accumulators at the pass's end.  What
// holds it back now (PERF.md: 0.31-0.32 ms on an H100, ~30% of that rate):
// mma.sync issue with the split's ALU work beside it, and the grid's 228
// blocks of one an SM in two waves (the last row tile half empty); wgmma
// and TMA are the next step.
//
// Layouts: x f32 [R, W] row-major, S f32 [W, 9*BLK] row-major, out f32
// [R, BLK*g] row-major.

#include <cuda_runtime.h>

namespace {

constexpr int R = 22 * 16;
constexpr int BLK = 256;
constexpr int H = 128;
constexpr int W = BLK + 2 * H;
constexpr int S_STRIDE = 70;  // the flat x-stride of the probe's offsets
constexpr int NOFF = 9;
constexpr int SCOLS = NOFF * BLK;

// OFFS[o] = dx * S_STRIDE + dy over dx, dy in (-1, 0, 1); CS[o] = 1 + o / 8
__device__ __forceinline__ int offs(int o) {
  return (o / 3 - 1) * S_STRIDE + (o % 3 - 1);
}
__device__ __forceinline__ float cs(int o) { return 1.0f + 0.125f * o; }

__global__ void __launch_bounds__(BLK) slice_kernel(const float* __restrict__ x,
                                                    float* __restrict__ out,
                                                    int g) {
  const int l = threadIdx.x, r = blockIdx.x, b = blockIdx.y;
  const float* xr = x + (long long)r * W + H + l;
  float acc = 0.f;
#pragma unroll
  for (int o = 0; o < NOFF; ++o)
    acc = __fmaf_rn(cs(o), __ldg(xr + offs(o)), acc);
  out[(long long)r * BLK * g + (long long)b * BLK + l] = acc;
}

__global__ void __launch_bounds__(BLK) base_kernel(const float* __restrict__ x,
                                                   float* __restrict__ out,
                                                   int g) {
  const int l = threadIdx.x, r = blockIdx.x, b = blockIdx.y;
  const float mid = __ldg(x + (long long)r * W + H + l);
  float acc = 0.f;
#pragma unroll
  for (int o = 0; o < NOFF; ++o) acc = __fmaf_rn(cs(o), mid, acc);
  out[(long long)r * BLK * g + (long long)b * BLK + l] = acc;
}

// the TF32 part of v: its low 13 mantissa bits cleared (truncation)
__device__ __forceinline__ unsigned tf32_trunc(float v) {
  return __float_as_uint(v) & 0xffffe000u;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += a b, one m16n8k8 TF32 product (a: 16x8 row-major fragment, b: 8x8
// column fragment, d: 16x8 f32)
__device__ __forceinline__ void mma_tf32(float* d, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// mma's tiling: a block computes rows [r0, r0 + kBM) x columns [l0, l0 +
// kBN) of one output block, kWarpsM x kWarpsN warps of 32 x 32 (2 x 4
// m16n8 tiles).  x's kBM rows are staged once (kXS floats a row, padded so
// the fragment loads hit 32 distinct banks).  The 9 offsets go in passes
// of G: a pass holds the G views y in registers over the full depth W, so
// each split A fragment feeds 3 G products per B column, and folds them in
// order at its end; S's k-tiles (KC rows x the block's columns of the
// pass's G offsets) stream through a ring of STAGES cp.async copies
// (padded rows).  The whole takes 210 KB of shared memory: one block of 8
// warps an SM.
constexpr int kBM = 64, kWarpsM = 2, kWarpsN = 4, G = 3, KC = 16, STAGES = 3;
constexpr int kXS = W + 4;
static_assert(R % 32 == 0, "the warps' 32-row tiles cover R");

struct Tile {
  static constexpr int kBN = 32 * kWarpsN, kThreads = 32 * kWarpsM * kWarpsN;
  static constexpr int kSS = kBN + 8;               // a staged S row
  static constexpr int kStage = G * KC * kSS;       // floats a ring slot
  static constexpr int kKSteps = W / KC;            // k-tiles a pass
  static constexpr int kTiles = (NOFF / G) * kKSteps;
  static constexpr int kBytes = (kBM * kXS + STAGES * kStage) * 4;
  static_assert(NOFF % G == 0 && W % KC == 0 && KC % 8 == 0, "tiling");
};

__global__ void __launch_bounds__(Tile::kThreads, 1) mma_kernel(
    const float* __restrict__ x, const float* __restrict__ S,
    float* __restrict__ out, int g) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                // [kBM][kXS]
  float* ring = smem + kBM * kXS;  // [STAGES][G][KC][kSS]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;  // fragment row group, thread in group
  const int l0 = blockIdx.x * Tile::kBN, r0 = blockIdx.y * kBM, b = blockIdx.z;
  const int rows = min(kBM, R - r0);        // the last row tile is ragged
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int rb = wm * 32, cb = wn * 32;     // the warp's tile in the block
  const bool has_rows = rb < rows;          // R % 32 == 0: all 32 or none

  // x's rows, once (commit group 0, with the first k-tile)
  for (int i = tid; i < rows * (W / 4); i += Tile::kThreads) {
    const int r = i / (W / 4), c = i % (W / 4);
    cp_async16(xs + r * kXS + 4 * c, x + (long long)(r0 + r) * W + 4 * c);
  }
  // k-tile st: rows k0 + [0, KC) of S at the pass's G offsets' columns
  auto load_tile = [&](int st) {
    const int o0 = (st / Tile::kKSteps) * G, k0 = (st % Tile::kKSteps) * KC;
    float* dst = ring + (st % STAGES) * Tile::kStage;
    for (int i = tid; i < G * KC * (Tile::kBN / 4); i += Tile::kThreads) {
      const int c = i % (Tile::kBN / 4), kk = (i / (Tile::kBN / 4)) % KC,
                gi = i / (Tile::kBN / 4) / KC;
      cp_async16(dst + (gi * KC + kk) * Tile::kSS + 4 * c,
                 S + (long long)(k0 + kk) * SCOLS + (o0 + gi) * BLK + l0 + 4 * c);
    }
  };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    load_tile(st);
    cp_async_commit();
  }

  float y[G][2][4][4], acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[mi][ni][e] = 0.f;
#pragma unroll
        for (int gi = 0; gi < G; ++gi) y[gi][mi][ni][e] = 0.f;
      }

  for (int st = 0; st < Tile::kTiles; ++st) {
    cp_async_wait<STAGES - 2>();  // k-tile st (and x) has landed
    __syncthreads();              // ... for every thread; slot st - 1 is free
    if (st + STAGES - 1 < Tile::kTiles) load_tile(st + STAGES - 1);
    cp_async_commit();
    const float* sb = ring + (st % STAGES) * Tile::kStage;
    const int k0 = (st % Tile::kKSteps) * KC;
    if (has_rows) {
#pragma unroll
      for (int kk = 0; kk < KC; kk += 8) {
        // x's A fragments, split into three TF32 parts: hi, mid = (x - hi)
        // truncated, lo = the rest (at most 2 significant bits)
        unsigned ah[2][4], am[2][4], al[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float v = xs[(rb + mi * 16 + gq + 8 * (q & 1)) * kXS + k0 +
                               kk + tq + 4 * (q >> 1)];
            ah[mi][q] = tf32_trunc(v);
            const float rest = __fsub_rn(v, __uint_as_float(ah[mi][q]));
            am[mi][q] = tf32_trunc(rest);
            al[mi][q] =
                __float_as_uint(__fsub_rn(rest, __uint_as_float(am[mi][q])));
          }
#pragma unroll
        for (int gi = 0; gi < G; ++gi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            const float* col = sb + (gi * KC + kk + tq) * Tile::kSS + cb + ni * 8 + gq;
            const unsigned b0 = __float_as_uint(col[0]),
                           b1 = __float_as_uint(col[4 * Tile::kSS]);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              mma_tf32(y[gi][mi][ni], ah[mi], b0, b1);
              mma_tf32(y[gi][mi][ni], am[mi], b0, b1);
              mma_tf32(y[gi][mi][ni], al[mi], b0, b1);
            }
          }
      }
      if (st % Tile::kKSteps == Tile::kKSteps - 1) {  // the pass's views: fold them
        const int o0 = (st / Tile::kKSteps) * G;
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          const float c = cs(o0 + gi);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int ni = 0; ni < 4; ++ni)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                acc[mi][ni][e] = __fmaf_rn(c, y[gi][mi][ni][e], acc[mi][ni][e]);
                y[gi][mi][ni][e] = 0.f;
              }
        }
      }
    }
  }
  if (!has_rows) return;
  // fragment element e: row gq (+8 for e >= 2), column 2 tq + (e & 1)
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + rb + mi * 16 + gq + 8 * h;
        const int colm = l0 + cb + ni * 8 + 2 * tq;
        *reinterpret_cast<float2*>(out + (long long)row * BLK * g +
                                   (long long)b * BLK + colm) =
            make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
}

int launch_mma(const float* x, const float* S, float* out, int g,
               cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::kBytes);
  if (err != cudaSuccess) return (int)err;
  mma_kernel<<<dim3(BLK / Tile::kBN, (R + kBM - 1) / kBM, g), Tile::kThreads,
               Tile::kBytes, stream>>>(x, S, out, g);
  return (int)cudaGetLastError();
}

}  // namespace

// variant: 0 slice, 1 mma (reads S), 2 base
extern "C" int rotation_probe(const float* x, const float* S, float* out,
                              int variant, int g, cudaStream_t stream) {
  if (g <= 0) return (int)cudaErrorInvalidValue;
  if (variant == 0) {
    slice_kernel<<<dim3(R, g), BLK, 0, stream>>>(x, out, g);
  } else if (variant == 1) {
    return launch_mma(x, S, out, g, stream);
  } else if (variant == 2) {
    base_kernel<<<dim3(R, g), BLK, 0, stream>>>(x, out, g);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* sph_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
