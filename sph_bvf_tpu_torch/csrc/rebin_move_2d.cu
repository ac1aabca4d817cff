// K5 and K6 — 2D locality rebin move (K5: cap <= 16, K6: 16 < cap <= 1807;
// walls or periodic axes, uniform or non-uniform x columns), K7's walk on a
// plane: a warp per target cell ranking its matches, a block per run of
// target cells copying.
//
// Replaces sph_bvf_tpu/core/rebin_pallas.py `_move_call`: its static branch
// (rebin_pallas.py:370-376, the cap <= 16 TPU kernel of the flagship's
// rebin; K5) and its gated branch (:346-369, the cap > 16 kernel with 8-row
// slot tiles and window-occupancy trip counts; K6), each with the `edges`
// variant (:176-199, 328-333) and on periodic grids (:90-92: the wrapped
// halo on x, the ghost columns on y, :239-253, 305-321).  Between rebins a
// particle moves at most one cell (the drift contract that rebin's drift
// check enforces), so the particles that belong in cell c are the matching
// candidates among the slots of its 3x3 stencil cells.  A warp walks them
// slot-major, then by ascending source flat index after the periodic wraps
// — the order of the sort rebin's stable (cell, old flat slot) key, so the
// slot assignment is bit-identical to sph_bvf_tpu_torch/core/state.py
// `rebin` with use_kernel=False — recomputes each candidate's cell from its
// f32 position exactly as `cell_index_of` does (csrc/rebin_move.cuh: the
// binning, the floored modulo on a periodic axis, the x columns with x
// wrapped by the edges' span xspan on a periodic x), and keeps the first
// cap matches.  A match of rank >= cap, or a particle that moved beyond one
// ring, is dropped; the caller counts the loss as overflow.  The plain
// PyTorch version is sph_bvf_tpu_torch/core/rebin_cuda.py
// `rebin_move_plain`.
//
// What bounds it on an H100: the bytes of the packs (about 40 f32 and 6 i32
// rows of cap * NC slots, every output slot written once and every valid
// one read once: 0.45 GB at the 1M-particle flagship cavity).  One thread
// per target cell, as this move was first ported, is bound by latency
// instead: each candidate's loads walked serially, (ff + fi) x cap serial
// copies per cell, its slot list in local memory, and on the small grids
// users run (4,800 cells at the cavity N=200, 1,000 at the FSI beam nx=60)
// too few threads for 132 SMs.  Design: K7's (csrc/rebin_move.cuh
// `rank_matches` and `move_cells`) with PLANE set — the window is the 9
// cells of the plane, ranked by lanes 0-8, and the candidates bin on x and y
// only — a block of kCells consecutive target cells holding their slot
// lists in shared memory (cap <= 64: 8 KB at most), the walk stopping after
// the first slot row in which no source cell holds a valid slot (every
// rebin compacts each cell's valid slots to 0..occ-1, so that row ends
// every source cell), and each thread of the copy loading kRows rows of its
// source slot before it stores them (kRows loads in flight a thread).
//
// Layouts: pf f32 [ff, cap, NC], pi i32 [fi, cap, NC] with row 0 = valid,
// x at f32 rows xr, xr+1 (and z at xr+2, unread); outputs [ff, cap, nt] and
// [fi, cap, nt] (on one device nt = NC; on a slab the slab's cells, its
// halo planes left out).  Flat cell c = cx * ny + cy; the grid has one
// cell along z.

#include <cuda_runtime.h>

#include "rebin_move.cuh"

namespace {

using rebin::Walk;

constexpr int kWarps = 8, kThreads = 32 * kWarps;
// target cells a block, rows a thread of the copy loads before it stores
// them (csrc/rebin_move.cuh `move_cells`) and blocks an SM holds at once
// (at 6, 40 registers a thread; at 8, 32, the walk spills): the fastest of
// tools/torch_move_timing.py --cells over the 2D main paths on the H100
// (PERF.md)
constexpr int kCells = 32, kRows = 8, kBlocks = 6;
// the kernel's static shared memory (srcs, kept), and the largest cap whose
// slot lists, i32 [cap, kCells] of dynamic shared memory, fit beside it in
// the 232,448 bytes an H100 block may opt in to (core/rebin_cuda.py
// GATED_MAX_CAP mirrors it: a 2D grid of a larger cap takes the sort)
constexpr int kStaticShared = (kWarps * 32 + kCells) * (int)sizeof(int);
constexpr int kMaxCap =
    (232448 - kStaticShared) / ((int)sizeof(int) * kCells);

// SLAB: the move of a mesh's slab (csrc/rebin_move.cuh)
template <bool SLAB>
__global__ void __launch_bounds__(kThreads, kBlocks) rebin_move_2d_kernel(
    const float* __restrict__ pf, const int* __restrict__ pi,
    float* __restrict__ outf, int* __restrict__ outi, int ff, int fi,
    Walk W, int xr) {
  extern __shared__ int list_s[];
  __shared__ int srcs[kWarps][32];
  __shared__ int kept[kCells];
  rebin::move_cells<true, true, SLAB, kCells, kWarps, kRows>(
      pf, pi, outf, outi, ff, fi, W, xr, nullptr, list_s, srcs, kept);
}

// Allow `kernel` `shared` bytes of dynamic shared memory where they pass
// its current limit (by default 48 KB less its static shared memory).
template <typename K>
cudaError_t allow_shared(K* kernel, size_t shared) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess && shared > (size_t)attr.maxDynamicSharedSizeBytes)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
  return err;
}

}  // namespace

// wrapx / wrapy: x / y periodic with more than one cell (x: wrapping by
// index); xspan: the x edges' span (read only with xb and a periodic x);
// x0, gnx, gwrapx: the global plane of plane 0, the global plane count and
// whether the global x is periodic; t0, nt: the target cells, the outputs'
// nt cells (csrc/rebin_move.cuh: on one device 0, nx, wrapx, 0, nx * ny)
extern "C" int rebin_move_2d(const float* pf, const int* pi, float* outf,
                             int* outi, int ff, int fi, int cap, int nx, int ny,
                             int xr, float lo0, float lo1, float inv0,
                             float inv1, int wrapx, int wrapy, float xspan,
                             const int* xb, float inv_q, int n_fine, int x0,
                             int gnx, int gwrapx, int t0, int nt,
                             cudaStream_t stream) {
  if (cap > kMaxCap) return (int)cudaErrorInvalidValue;
  if ((wrapx && nx < 3) || (wrapy && ny < 3) || (gwrapx && gnx < 3))
    return (int)cudaErrorInvalidValue;
  const int nc = nx * ny;
  if (t0 < 0 || nt < 0 || t0 + nt > nc) return (int)cudaErrorInvalidValue;
  if (nt == 0 || cap == 0) return 0;
  const Walk W{pi, nullptr, nullptr, nullptr, cap, nx, ny, 1, nc,
               (wrapx ? 1 : 0) | (wrapy ? 2 : 0), lo0, lo1, 0.f, inv0, inv1,
               0.f, xspan, xb, inv_q, n_fine, x0, gnx, gwrapx, t0, nt};
  const unsigned blocks = (unsigned)((nt + kCells - 1) / kCells);
  // the slot lists, i32 [cap, kCells]: within the default 48 KB a block up
  // to cap 375, opted in past it
  const size_t shared = sizeof(int) * cap * kCells;
  const bool whole =
      x0 == 0 && gnx == nx && gwrapx == wrapx && t0 == 0 && nt == nc;
  auto* kernel =
      whole ? rebin_move_2d_kernel<false> : rebin_move_2d_kernel<true>;
  if (shared + kStaticShared > 48 * 1024) {
    const cudaError_t err = allow_shared(kernel, shared);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<blocks, kThreads, shared, stream>>>(pf, pi, outf, outi, ff, fi, W,
                                               xr);
  return (int)cudaGetLastError();
}

// registers per thread and local-memory (spill) bytes per thread of the
// kernel (its one-device instantiation), its target cells a block and the
// rows a thread of its copy loads before it stores them
extern "C" int rebin_move_2d_attributes(int* regs, int* local_bytes,
                                        int* cells, int* rows) {
  cudaFuncAttributes attr;
  const cudaError_t err =
      cudaFuncGetAttributes(&attr, rebin_move_2d_kernel<false>);
  if (err == cudaSuccess) {
    *regs = attr.numRegs;
    *local_bytes = (int)attr.localSizeBytes;
    *cells = kCells;
    *rows = kRows;
  }
  return (int)err;
}

extern "C" const char* sph_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
