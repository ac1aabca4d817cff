// K8 — the window-rotation probe: three ways to produce and fold the 9
// stencil-shifted [R, BLK] views of one staged [R, W] window.
//
// Replaces tools/mxu_rotation_probe.py `_call` (the Pallas probe over
// `_k_slice`, `_k_mxu` and `_k_base`).  The question is the staging of the
// pre-shifted pass A (K4, csrc/pass_a_2d_preshift.cu): is a shift cheaper
// as shifted loads, or as a product with a 0/1 matrix on the matrix units?
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
// accumulated in f32 (wmma m16n16k8 TF32 fragments, mma.sync underneath).
// Each column of S holds one 1, so every sum adds hi, mid and lo of one
// element to exact zeros: hi, then hi + mid (x truncated to 22 bits), then
// x, each exactly representable.  So y == x's shifted views bit for bit,
// and `mma` is bitwise `slice`, as Precision.HIGHEST makes it on the TPU.
//
// What bounds it on an H100: `slice` and `base` the bytes (one read of x
// and the [R, BLK*g] write over 3.35 TB/s); `mma` the operations, 3 x R x W
// x 9*BLK multiply-adds a block at the dense TF32 rate of 495 TFLOP/s (the
// dense product's cost, which the TPU probe pays too).  Design: `slice` and
// `base` a thread per output element, a block per output row and block, so
// neighbouring threads read and write neighbouring addresses; `mma` a warp
// per 16x16 output tile, which walks the 9 column blocks of y in turn, each
// over the full depth W (S read from L2, where its 4.7 MB stays), stores the
// 16x16 product to shared memory and folds it into the lane's 8 elements.
//
// Layouts: x f32 [R, W] row-major, S f32 [W, 9*BLK] row-major, out f32
// [R, BLK*g] row-major.

#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int R = 22 * 16;
constexpr int BLK = 256;
constexpr int H = 128;
constexpr int W = BLK + 2 * H;
constexpr int S_STRIDE = 70;  // the flat x-stride of the probe's offsets
constexpr int NOFF = 9;
constexpr int SCOLS = NOFF * BLK;
constexpr int kWarps = 4;  // mma: 16x16 tiles a block

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
__device__ __forceinline__ float tf32_trunc(float v) {
  return __uint_as_float(__float_as_uint(v) & 0xffffe000u);
}

__global__ void __launch_bounds__(32 * kWarps) mma_kernel(
    const float* __restrict__ x, const float* __restrict__ S,
    float* __restrict__ out, int g) {
  __shared__ __align__(128) float tile[kWarps][16 * 16];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int l0 = (blockIdx.x * kWarps + warp) * 16;  // output column in block
  const int r0 = blockIdx.y * 16;
  const int b = blockIdx.z;
  float* ty = tile[warp];

  float acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;

  wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32,
                 wmma::row_major> a, a_hi, a_mid, a_lo;
  wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32,
                 wmma::row_major> s;
  wmma::fragment<wmma::accumulator, 16, 16, 8, float> y;
  for (int o = 0; o < NOFF; ++o) {
    wmma::fill_fragment(y, 0.f);
    for (int k0 = 0; k0 < W; k0 += 8) {
      wmma::load_matrix_sync(a, x + (long long)r0 * W + k0, W);
#pragma unroll
      for (int i = 0; i < a.num_elements; ++i) {
        const float v = a.x[i];
        const float hi = tf32_trunc(v);
        const float rest = __fsub_rn(v, hi);
        const float mid = tf32_trunc(rest);
        a_hi.x[i] = hi;
        a_mid.x[i] = mid;
        a_lo.x[i] = __fsub_rn(rest, mid);
      }
      wmma::load_matrix_sync(s, S + (long long)k0 * SCOLS + o * BLK + l0,
                             SCOLS);
      wmma::mma_sync(y, a_hi, s, y);
      wmma::mma_sync(y, a_mid, s, y);
      wmma::mma_sync(y, a_lo, s, y);
    }
    wmma::store_matrix_sync(ty, y, 16, wmma::mem_row_major);
    __syncwarp();
    const float c = cs(o);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      acc[e] = __fmaf_rn(c, ty[e * 32 + lane], acc[e]);
    __syncwarp();
  }
  // element e * 32 + lane of the tile: row (e * 32 + lane) / 16, column % 16
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int i = e * 32 + lane;
    out[(long long)(r0 + i / 16) * BLK * g + (long long)b * BLK + l0 + i % 16] =
        acc[e];
  }
}

}  // namespace

// variant: 0 slice, 1 mma (reads S), 2 base
extern "C" int rotation_probe(const float* x, const float* S, float* out,
                              int variant, int g, cudaStream_t stream) {
  if (g <= 0) return (int)cudaErrorInvalidValue;
  if (variant == 0) {
    slice_kernel<<<dim3(R, g), BLK, 0, stream>>>(x, out, g);
  } else if (variant == 1) {
    mma_kernel<<<dim3(BLK / (16 * kWarps), R / 16, g), 32 * kWarps, 0,
                 stream>>>(x, S, out, g);
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
