// K4 — 2D pass A over the 3x3 window of a tile of cells, staged once per
// block in shared memory; one thread per (slot i, cell c) of the tile.
//
// Replaces sph_bvf_tpu/ops/pair_pallas.py `_call_preshift` (the TPU kernel
// PairConfig.preshift_window selects for the grouped 2D shape: XLA
// materialises 9 shifted views of the padded field buffer once per call,
// pair_pallas.py:911-921, and the kernel reads each stencil offset as its
// own lane-aligned block, with no in-kernel rotation and no bounds test).
// What the TPU got from the pre-shifted views is neighbour reads with no
// rotation and no bounds test; here a block takes a tile of TX x TY cells
// and copies the (TX + 2) x (TY + 2) cells of its window, every row and
// every slot of the one pack [F, cap, nx * ny], into shared memory with
// cp.async: zero past a walled edge (as the pre-shifted copies' zero
// rows), wrapped by index on a periodic axis (as `shift_cells`).  After
// one barrier its threads sum from the window: i's rows from the pack at
// the thread's own slot, j's from shared memory (tv::Shared), with K1's
// bodies (the transport-velocity pair of csrc/pass_a_tv.cuh, FILTER, NS,
// THERMAL: 20 instantiations; the full body of csrc/pass_a_mech.cuh,
// FILTER, ELASTIC, NS, THERMAL: 40) over K1's j order: offsets (-1, -1),
// (-1, 0), ..., (1, 1), then slots 0..cap-1, an invalid j skipped, not
// taken as the end of its cell (the grouped grids need not be compacted).
// The same bodies sum the same pairs in the same order with the same j
// values, so the result is bitwise K1's (csrc/pass_a_2d.cu), as the JAX
// package holds its pre-shifted kernel to the window kernel.  The plain
// PyTorch version is sph_bvf_tpu_torch/ops/pair.py `_pass_a_plain`.
//
// What bounds it on an H100: the pair work is K1's (issue rate, ~130 flops
// a pair inside the support).  K1 reads its j rows through L1/L2: the
// blocks of one slot row reread the same neighbour cells for every slot,
// ~26x the pack's bytes from L2 at the flagship.  Here a block reads its
// window once, ~1.9x the pack (the halo of a 4 x 8 tile), and its loads
// hit shared memory.  Design: a warp takes 32 consecutive (slot, tile
// cell) pairs, slot-major, so with a 32-cell tile its lanes are one slot
// row of the tile (neighbouring cells, near-equal offsets on a lattice, as
// K1's lanes); a warp whose lanes are all empty slots writes zeros and
// moves on; accumulators stay in registers.  The tile is the wrapper's
// choice per body (ops/pair_cuda.py `k4_tile`): the window of F rows x cap
// slots x (TX + 2)(TY + 2) cells must fit the 227 KB a block can hold
// (dynamic shared memory past 48 KB), and its size sets how many blocks
// share an SM.  Ragged edge tiles (nx, ny not multiples of the tile) leave
// the lanes past the grid idle.
//
// Flat cell c = cx * ny + cy; the grid has one cell along z.

#include <cuda_runtime.h>

#include "pass_a_mech.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxShared = 232448;  // bytes a block may hold on the H100

// one float from device memory into shared memory, without registers;
// zero-filled when !in (no byte is read)
__device__ __forceinline__ void stage_float(float* dst, const float* src,
                                            bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0));
}

// The grid cell a window index g (tile origin - 1 + window position) holds
// on an axis of n cells, -1 where the window holds zeros: past a walled
// edge, and past the last cell a lane of the tile reads (a ragged tile).
// On a periodic axis (n >= 3) -1 and n wrap by index.
__device__ __forceinline__ int window_cell(int g, int n, bool periodic) {
  if (periodic) {
    if (g == -1) return n - 1;
    if (g == n) return 0;
  }
  return g >= 0 && g < n ? g : -1;
}

// The tile of this block and its window: TX x TY cells from (cx0, cy0);
// the window's WY = TY + 2 cells along y, WC = (TX + 2) WY cells in all,
// window cell (wx, wy) at wx * WY + wy; row r, slot j, window cell w at
// win[(r * cap + j) * WC + w] (ms = cap * WC floats a row).
struct Tile {
  int tx, ty, cx0, cy0, wy, wc, ms;
};

__device__ __forceinline__ Tile tile_of_block(int cap, int ny, int tx,
                                              int ty) {
  const int nty = (ny + ty - 1) / ty;
  const int bx = (int)blockIdx.x / nty, by = (int)blockIdx.x - bx * nty;
  Tile T;
  T.tx = tx;
  T.ty = ty;
  T.cx0 = bx * tx;
  T.cy0 = by * ty;
  T.wy = ty + 2;
  T.wc = (tx + 2) * T.wy;
  T.ms = cap * T.wc;
  return T;
}

// Stage the window of tile T: the `planes` = F cap rows of the pack (plane
// p = row * cap + slot), each over the WC window cells.  Thread t < G WC
// (G = the whole windows kThreads threads cover) keeps window cell t % WC
// and copies it for the planes t / WC, + G, ...; then one barrier.
__device__ __forceinline__ void stage(float* win, const float* __restrict__ pf,
                                      int planes, int nx, int ny, int wrap,
                                      const Tile& T) {
  const int groups = kThreads / T.wc;
  const int t = threadIdx.x;
  if (t < groups * T.wc) {
    const int w = t % T.wc, p0 = t / T.wc;
    const int wx = w / T.wy, wy = w - wx * T.wy;
    const int gx = window_cell(T.cx0 - 1 + wx, nx, wrap & 1);
    const int gy = window_cell(T.cy0 - 1 + wy, ny, wrap & 2);
    const bool in = gx >= 0 && gy >= 0;
    const long long nc = (long long)nx * ny;
    const float* src = pf + (long long)p0 * nc + (in ? gx * ny + gy : 0);
    float* dst = win + p0 * T.wc + w;
    for (int p = p0; p < planes; p += groups) {
      stage_float(dst, src, in);
      src += groups * nc;
      dst += groups * T.wc;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// Call slot(i, w, s) for every (slot i, cell) of tile T inside the grid: w
// the cell's window index, s its flat slot i * nx * ny + c.  A warp takes
// 32 consecutive (slot, tile cell) pairs, slot-major.
template <class Slot>
__device__ __forceinline__ void for_each_slot(const Tile& T, int cap, int nx,
                                              int ny, Slot&& slot) {
  const int cells = T.tx * T.ty;
  const int items = (cap * cells + 31) / 32;
  for (int it = threadIdx.x / 32; it < items; it += kThreads / 32) {
    const int q = it * 32 + threadIdx.x % 32;
    const int i = q / cells, cell = q - i * cells;
    const int tx = cell / T.ty, ty = cell - tx * T.ty;
    const int cx = T.cx0 + tx, cy = T.cy0 + ty;
    if (i < cap && cx < nx && cy < ny)
      slot(i, (tx + 1) * T.wy + ty + 1, (long long)i * nx * ny + cx * ny + cy);
  }
}

// Call pair(k) for every valid j != i of the 3x3 window cells around window
// cell w, k = j * WC + the window cell, in K1's order: offsets (-1, -1),
// (-1, 0), ..., (1, 1), then slots 0..cap-1.  A window cell past a walled
// edge holds zeros, so its j are invalid, as K1 skips that offset.
template <class Pair>
__device__ __forceinline__ void for_each_j(const float* win, const Tile& T,
                                           int cap, int i, int w,
                                           Pair&& pair) {
  for (int ox = -1; ox <= 1; ++ox) {
    for (int oy = -1; oy <= 1; ++oy) {
      const int wj = w + ox * T.wy + oy;
      for (int j = 0; j < cap; ++j) {
        if (ox == 0 && oy == 0 && j == i) continue;  // the self pair
        const int k = j * T.wc + wj;
        if (win[tv::R_VALID * T.ms + k] == 0.f) continue;
        pair(k);
      }
    }
  }
}

// the transport-velocity pair (walls only): pack PF_ROWS, accumulators
// ACC_ROWS (the kernels' names hold "preshift_", which the profiler's
// tallies match)
template <bool FILTER, int NS, bool THERMAL>
__global__ void __launch_bounds__(kThreads) preshift_tv_kernel(
    const float* __restrict__ pf, const float* __restrict__ tab,
    const float* __restrict__ stab, float* __restrict__ out,
    const float* __restrict__ dt, const int* __restrict__ step,
    const long long* __restrict__ key, unsigned rng_seed, float neg4kb,
    int ntypes, int advect, int cap, int nx, int ny, int rows, int tx,
    int ty) {
  extern __shared__ float win[];
  constexpr int A = tv::kAccs<FILTER, NS>;
  const long long m = (long long)cap * nx * ny;  // slots per field row
  const Tile T = tile_of_block(cap, ny, tx, ty);
  stage(win, pf, rows * cap, nx, ny, 0, T);
  const int tt = ntypes * ntypes;
  tv::Noise noise{};
  if constexpr (THERMAL) noise = tv::load_noise(dt, step, key, rng_seed, neg4kb);
  const tv::Wrap nowrap{};  // no periodic axis
  for_each_slot(T, cap, nx, ny, [&](int i, int w, long long s) {
    float acc[A];
#pragma unroll
    for (int a = 0; a < A; ++a) acc[a] = 0.f;
    if (tv::ld(pf, m, tv::R_VALID, s) != 0.f) {
      const tv::ISide<NS> I =
          tv::load_i<FILTER, NS, THERMAL>(pf, m, s, ntypes);
      for_each_j(win, T, cap, i, w, [&](int k) {
        tv::add_pair<FILTER, NS, THERMAL, 2, tv::Shared>(
            win, T.ms, k, tab, stab, advect, tt, noise, nowrap, I, acc);
      });
    }
#pragma unroll
    for (int a = 0; a < A; ++a) out[(long long)a * m + s] = acc[a];
  });
}

// the full body: pack MECH_PF_ROWS, accumulators MECH_ACC_ROWS; flags:
// mech::F_*; wrap: the periodic axes and their extents
template <bool FILTER, bool ELASTIC, int NS, bool THERMAL>
__global__ void __launch_bounds__(kThreads) preshift_mech_kernel(
    const float* __restrict__ pf, const float* __restrict__ tab,
    const float* __restrict__ stab, float* __restrict__ out,
    const float* __restrict__ dt, const int* __restrict__ step,
    const long long* __restrict__ key, unsigned rng_seed, float neg4kb,
    int ntypes, int cap, int nx, int ny, int rows, int tx, int ty, int flags,
    int advect, tv::Wrap wrap, float ampl) {
  extern __shared__ float win[];
  constexpr int A = mech::Rows<FILTER, ELASTIC, NS>::A;
  const long long m = (long long)cap * nx * ny;  // slots per field row
  const Tile T = tile_of_block(cap, ny, tx, ty);
  stage(win, pf, rows * cap, nx, ny, wrap.axes, T);
  mech::Ctx ctx = mech::make_ctx(ntypes, flags, advect, ampl, wrap);
  if constexpr (THERMAL) ctx.noise = tv::load_noise(dt, step, key, rng_seed, neg4kb);
  for_each_slot(T, cap, nx, ny, [&](int i, int w, long long s) {
    float acc[A];
#pragma unroll
    for (int a = 0; a < A; ++a) acc[a] = 0.f;
    if (tv::ld(pf, m, mech::R_VALID, s) != 0.f) {
      const auto I = mech::load_i<FILTER, ELASTIC, NS, THERMAL>(pf, m, s, ctx);
      for_each_j(win, T, cap, i, w, [&](int k) {
        mech::add_pair<FILTER, ELASTIC, NS, THERMAL, 2, tv::Shared>(
            win, T.ms, k, tab, stab, ctx, I, acc);
      });
    }
#pragma unroll
    for (int a = 0; a < A; ++a) out[(long long)a * m + s] = acc[a];
  });
}

// launch `kernel` with `shared` bytes of dynamic shared memory (allowed
// past the 48 KB default first)
template <typename... P, typename... Args>
int run(void (*kernel)(P...), unsigned blocks, int shared, cudaStream_t stream,
        Args... args) {
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<blocks, kThreads, shared, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// rows: the pack's row count F; tx, ty: the tile (ops/pair_cuda.py
// `k4_tile`: (tx + 2)(ty + 2) <= 128 window cells, F cap of them within
// 227 KB); every other argument as csrc/pass_a_2d.cu's `pass_a_2d`
extern "C" int pass_a_2d_preshift(const float* pf, const float* tab,
                                  const float* stab, float* out, int ntypes,
                                  int ns, int advect, int cap, int nx, int ny,
                                  int rows, int tx, int ty, int body,
                                  int filter, int elastic, int flags, int wrap,
                                  float lx, float ly, float lz, float ampl,
                                  int thermal, const float* dt,
                                  const int* step, const long long* key,
                                  unsigned rng_seed, float neg4kb,
                                  cudaStream_t stream) {
  // a wrapping axis of fewer than 3 cells would reach one cell twice
  if (((wrap & 1) && nx < 3) || ((wrap & 2) && ny < 3) || (wrap & 4))
    return (int)cudaErrorInvalidValue;
  if (body == 0 && (elastic || wrap)) return (int)cudaErrorInvalidValue;
  const long long window = (long long)(tx + 2) * (ty + 2);
  const long long shared = window * rows * cap * (long long)sizeof(float);
  if (tx < 1 || ty < 1 || window > kThreads || shared > kMaxShared)
    return (int)cudaErrorInvalidValue;
  if ((long long)cap * nx * ny == 0) return 0;
  const unsigned blocks =
      (unsigned)(((nx + tx - 1) / tx) * (long long)((ny + ty - 1) / ty));
  if (body == 0) {
    switch (tv::variant_key(filter != 0, ns, thermal != 0)) {
#define X(F, N, T)                                                       \
  case tv::variant_key(F, N, T):                                         \
    return run(preshift_tv_kernel<F, N, T>, blocks, (int)shared, stream, \
               pf, tab, stab, out, dt, step, key, rng_seed, neg4kb,      \
               ntypes, advect, cap, nx, ny, rows, tx, ty);
      TV_FOR_EACH_VARIANT(X)
#undef X
      default:
        return (int)cudaErrorInvalidValue;  // ns beyond tv::kMaxSpecies
    }
  }
  const tv::Wrap w{wrap, {lx, ly, lz}};
  switch (mech::variant_key(filter != 0, elastic != 0, ns, thermal != 0)) {
#define X(F, E, N, T)                                                     \
  case mech::variant_key(F, E, N, T):                                     \
    return run(preshift_mech_kernel<F, E, N, T>, blocks, (int)shared,     \
               stream, pf, tab, stab, out, dt, step, key, rng_seed,       \
               neg4kb, ntypes, cap, nx, ny, rows, tx, ty, flags, advect, \
               w, ampl);
    MECH_FOR_EACH_VARIANT(X)
#undef X
    default:
      return (int)cudaErrorInvalidValue;  // ns beyond tv::kMaxSpecies
  }
}

// registers per thread and local-memory (spill) bytes per thread of the
// (body, filter, elastic, ns, thermal) instantiation
extern "C" int pass_a_2d_preshift_attributes(int body, int filter, int elastic,
                                             int ns, int thermal, int* regs,
                                             int* local_bytes) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaErrorInvalidValue;
  if (body == 0 && !elastic) {
    switch (tv::variant_key(filter != 0, ns, thermal != 0)) {
#define X(F, N, T)                                                   \
  case tv::variant_key(F, N, T):                                     \
    err = cudaFuncGetAttributes(&attr, preshift_tv_kernel<F, N, T>); \
    break;
      TV_FOR_EACH_VARIANT(X)
#undef X
      default:
        break;
    }
  } else if (body == 1) {
    switch (mech::variant_key(filter != 0, elastic != 0, ns, thermal != 0)) {
#define X(F, E, N, T)                                                     \
  case mech::variant_key(F, E, N, T):                                     \
    err = cudaFuncGetAttributes(&attr, preshift_mech_kernel<F, E, N, T>); \
    break;
      MECH_FOR_EACH_VARIANT(X)
#undef X
      default:
        break;
    }
  }
  if (err == cudaSuccess) {
    *regs = attr.numRegs;
    *local_bytes = (int)attr.localSizeBytes;
  }
  return (int)err;
}

extern "C" const char* sph_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
