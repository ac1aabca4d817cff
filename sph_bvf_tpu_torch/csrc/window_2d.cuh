// The 3x3 window of a tile of cells that a block of the grouped 2D pass A
// stages in shared memory (csrc/pass_a_2d.cuh; K1 and K4 launch it), and
// the walks over it.
//
// A block takes a tile of TX x TY cells and copies the (TX + 2) x (TY + 2)
// cells of its window, every row of the one pack [F, cap, nx * ny], into
// shared memory with cp.async: zero cells past a walled edge (as the
// pre-shifted copies' zero rows of the TPU kernel), wrapped by index on a
// periodic axis (as `shift_cells`).  Each window cell is staged only up to
// its tail, one past its last valid slot (ops/pair_cuda.py `tail_index`):
// no walk reads a slot at or past it.  The window's rows are BT slots deep,
// BT the largest tail of the window's cells, so a sparse window holds fewer
// bytes.  Window cell (wx, wy) sits at wx * WY + wy (WY = TY + 2, WC = (TX +
// 2) WY cells); row r, slot j, window cell w at win[(r * BT + j) * WC + w].
//
// Flat cell c = cx * ny + cy; the grid has one cell along z.

#pragma once

#include <cuda_runtime.h>

#include "pass_a_mech.cuh"

namespace win2d {

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;
// A block may hold 232,448 bytes of shared memory on the H100, static and
// dynamic together; a window kernel's static shared memory is `stage`'s
// tail_s[kThreads] and warp_max[kThreads / 32], so a window, its dynamic
// shared memory, may take the rest (ops/pair_cuda.py K4_SHARED)
constexpr int kStaticShared = (kThreads + kThreads / 32) * (int)sizeof(int);
constexpr int kMaxShared = 232448 - kStaticShared;

// one float from device memory into shared memory, without registers
__device__ __forceinline__ void stage_float(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

// Allow `kernel` `shared` bytes of dynamic shared memory where they pass
// its default, 48 KB less its static shared memory (the launch fails
// otherwise, also between that default and 48 KB).  A kernel whose static
// shared memory passes kStaticShared is refused: kMaxShared would not
// leave it room.
template <typename K>
cudaError_t allow_shared(K* kernel, int shared) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess && attr.sharedSizeBytes > (size_t)kStaticShared)
    err = cudaErrorInvalidValue;
  if (err == cudaSuccess && shared > attr.maxDynamicSharedSizeBytes)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  return err;
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

// The tile of this block and its window: TX x TY cells from (cx0, cy0),
// WY and WC as above, BT the window's largest tail, MS = BT * WC floats a
// row.
struct Tile {
  int tx, ty, cx0, cy0, wy, wc, bt, ms;
};

__device__ __forceinline__ Tile tile_of_block(int ny, int tx, int ty) {
  const int nty = (ny + ty - 1) / ty;
  const int bx = (int)blockIdx.x / nty, by = (int)blockIdx.x - bx * nty;
  Tile T;
  T.tx = tx;
  T.ty = ty;
  T.cx0 = bx * tx;
  T.cy0 = by * ty;
  T.wy = ty + 2;
  T.wc = (tx + 2) * T.wy;
  T.bt = 0;
  T.ms = 0;
  return T;
}

// the flat grid cell window cell w holds, -1 for a zero cell
__device__ __forceinline__ int grid_cell(const Tile& T, int w, int nx, int ny,
                                         int wrap) {
  const int wx = w / T.wy, wy = w - wx * T.wy;
  const int gx = window_cell(T.cx0 - 1 + wx, nx, wrap & 1);
  const int gy = window_cell(T.cy0 - 1 + wy, ny, wrap & 2);
  return gx >= 0 && gy >= 0 ? gx * ny + gy : -1;
}

// Stage the window of tile T: tail_s[w] the tail of window cell w (0 for a
// zero cell), T.bt their largest, then every one of the `rows` rows of
// window cell w up to tail_s[w].  Thread t < G WC (G = the whole windows
// kThreads threads cover) keeps window cell t % WC and copies its slots
// t / WC, + G, ...; then one barrier.
__device__ __forceinline__ void stage(float* win, int* tail_s,
                                      const float* __restrict__ pf,
                                      const int* __restrict__ tails, int rows,
                                      int cap, int nx, int ny, int wrap,
                                      Tile& T) {
  __shared__ int warp_max[kThreads / 32];
  const int t = threadIdx.x;
  int tail = 0;
  if (t < T.wc) {
    const int g = grid_cell(T, t, nx, ny, wrap);
    tail = g >= 0 ? __ldg(tails + g) : 0;
    tail_s[t] = tail;
  }
  const int most = __reduce_max_sync(kFull, tail);
  if (t % 32 == 0) warp_max[t / 32] = most;
  __syncthreads();
  T.bt = warp_max[0];
#pragma unroll
  for (int q = 1; q < kThreads / 32; ++q) T.bt = max(T.bt, warp_max[q]);
  T.ms = T.bt * T.wc;
  const int groups = kThreads / T.wc;
  if (t < groups * T.wc) {
    const int w = t % T.wc, j0 = t / T.wc;
    const int g = grid_cell(T, w, nx, ny, wrap);
    const int tw = tail_s[w];
    const long long nc = (long long)nx * ny;
    for (int r = 0; r < rows; ++r)
      for (int j = j0; j < tw; j += groups)
        stage_float(win + (r * T.bt + j) * T.wc + w,
                    pf + ((long long)r * cap + j) * nc + g);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// Call slot(i, w, s, live) for 32 consecutive (slot i, tile cell) pairs a
// warp, slot-major, over every pair of tile T, each lane of the warp
// together: w the cell's window index, s its flat slot i * nx * ny + c;
// live false for a lane past cap or past the grid's end (a ragged tile),
// whose other arguments are not a slot.
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
    slot(i, (tx + 1) * T.wy + ty + 1, (long long)i * nx * ny + cx * ny + cy,
         i < cap && cx < nx && cy < ny);
  }
}

// Call pair(k) for every valid j != i of the 3x3 window cells around window
// cell w, k = j * WC + the window cell: offsets (-1, -1), (-1, 0), ...,
// (1, 1), then slots 0 up to the cell's tail; an invalid slot below the
// tail is skipped.  A zero window cell has tail 0.
template <class Pair>
__device__ __forceinline__ void for_each_j(const float* win, const int* tail_s,
                                           const Tile& T, int i, int w,
                                           Pair&& pair) {
  for (int ox = -1; ox <= 1; ++ox) {
    for (int oy = -1; oy <= 1; ++oy) {
      const int wj = w + ox * T.wy + oy;
      const int tj = tail_s[wj];
      for (int j = 0; j < tj; ++j) {
        if (ox == 0 && oy == 0 && j == i) continue;  // the self pair
        const int k = j * T.wc + wj;
        if (win[tv::R_VALID * T.ms + k] == 0.f) continue;
        pair(k);
      }
    }
  }
}

}  // namespace win2d
