// K7 — 3D locality rebin move (any cap; walls or periodic axes), a warp per
// target cell ranking its matches, a block per run of target cells copying.
//
// Replaces sph_bvf_tpu/core/rebin_pallas.py `_move_call_tiled3d`
// (rebin_pallas.py:441; the TPU kernel on the (x-plane, yz-block) grid
// with 27 staged offsets and window-occupancy trip counts).  Between
// rebins a particle moves at most one cell (the drift contract that
// rebin's drift check enforces), so the particles that belong in cell c
// are the matching candidates among the slots of its 27 stencil cells.  A
// warp walks them slot-major, then by ascending source flat index after
// the periodic wraps — the order of the sort rebin's stable (cell, old
// flat slot) key, so the slot assignment is bit-identical to
// sph_bvf_tpu_torch/core/state.py `rebin` with use_kernel=False on wall
// and periodic grids alike — recomputes each candidate's cell from its f32
// position exactly as `cell_index_of` does (round-to-nearest subtract and
// multiply, never fused, with the same f32 lo and 1/cell_size; clamped on
// a wall axis, a floored modulo on a periodic one), and keeps the first
// cap matches.  A match of rank >= cap, or a
// particle that moved beyond one ring, is dropped; the caller counts the loss
// as overflow.  The plain PyTorch version is
// sph_bvf_tpu_torch/core/rebin_cuda.py `rebin_move_plain`.
//
// What bounds it on an H100: the bytes of the packs (about 40 f32 and 6 i32
// rows of cap * NC slots, read once and written once: 0.6 GB at the 1.19M
// particle cavity) and the candidate checks, ~27 x the occupancy of a
// window per target cell (the vortex N=100: ~34 slot rows x 27 cells).
// One thread per target cell would be bound by latency and occupancy
// instead (7 warps an SM at the vortex N=100, 25 blocks for 132 SMs at the
// 3D FSI beam nx=60, each candidate's loads walked serially, (ff + fi) x
// cap serial copies per cell).  Design (csrc/rebin_move.cuh `rank_matches`
// and `move_cells`, which K5 and K6 run on a plane, rebin_move_2d.cu):
// - phase 1, a warp per target cell: lanes 0-26 take one source cell each
//   and sort the window by rank (each lane counts the smaller flat
//   indices); the warp then walks the candidates in the sort's order,
//   slot-major, 32 a step, one per lane, binning each with
//   csrc/rebin_move.cuh; __ballot_sync and __popc of the lower lanes give
//   each match its rank, the first cap matches are kept, and the walk stops
//   after the first slot row in which no source cell holds a valid slot
//   (every rebin compacts each cell's valid slots to 0..occ-1, so that row
//   ends every source cell: the GPU form of the TPU kernel's trip count,
//   with no prepass);
// - a block takes kCells = 16 consecutive target cells (flat index, z
//   minor; 16 was the fastest of 8, 16 and 32 over the main paths' launches
//   on the H100, PERF.md), its warps one cell after another, and holds their
//   slot lists, i32 [cap, kCells], in shared memory, or, for a cap whose lists do not fit
//   (core/rebin_cuda.py `k7_list`), in a caller-provided i32 [cap, NC]
//   scratch in global memory (entry (s, c) at s * NC + c);
// - phase 2, the block copies: a thread takes (output slot, cell), the cell
//   minor, so that neighbouring threads write neighbouring addresses of
//   every row of [F, cap, NC], one row after another (K5's and K6's
//   batches of rows in flight slowed these 3D moves by up to 6%, PERF.md);
//   a slot past its cell's match count is written as zeros without
//   reading anything.

// Non-uniform x columns (Geometry.x_edges, load balancing; replaces the TPU
// kernel's `edges` variant, rebin_pallas.py:487-492, 595-600, 641, whose
// per-plane column bounds are scalars): a candidate lies in plane cx when its
// fine bin lies in the plane's bounds [xb[cx], xb[cx+1]) (`in_column`,
// rebin_move.cuh).  On a periodic grid x wraps by the
// edges' own span xspan before the fine bin, as `cell_index_of` does (the
// TPU kernel skips x's uniform bin under `edges`, :582, and tests the fine
// bin against the plane's bounds, :595-600); y and z bin as without edges.
// xb == nullptr means uniform planes.
//
// Periodic axes (replaces the TPU kernel's periodic binning,
// rebin_pallas.py:573-600, and its wrapped halo planes and ghost columns): a
// runtime bit per axis (`wrap`), as on a plane.  A source cell
// wraps by index, a candidate's bin on that axis is the floored modulo of
// its f32 bin (the position is already wrapped into the box by `wrap_pbc`),
// and the 27 source cells are ranked by flat index after the wrap, so the
// walk keeps the sort rebin's order.  Every wrapping axis has at least 3
// cells, so no source cell sits in a window twice.  The TPU kernel may order
// a cell's slots differently on a periodic grid (rebin_pallas.py:28-31); the
// cells' contents are the same.
//
// Layouts: pf f32 [ff, cap, NC], pi i32 [fi, cap, NC] with row 0 = valid,
// x at f32 rows xr, xr+1, xr+2; outputs [ff, cap, nt] and [fi, cap, nt]
// (on one device nt = NC; on a slab the slab's cells).  Flat cell
// c = (cx * ny + cy) * nz + cz.

#include <cuda_runtime.h>

#include "rebin_move.cuh"

namespace {

using rebin::Walk;

constexpr int kWarps = 8, kThreads = 32 * kWarps;
// target cells a block (core/rebin_cuda.py K7_CELLS)
constexpr int kCells = 16;

// kCells target cells from blockIdx.x * kCells (csrc/rebin_move.cuh
// `move_cells`); SHARED_LIST: their slot lists in dynamic shared memory, i32
// [cap, kCells], else in `list`, i32 [cap, NC] in global memory; SLAB: the
// move of a mesh's slab.
template <bool SHARED_LIST, bool SLAB>
__global__ void __launch_bounds__(kThreads) rebin_move_3d_kernel(
    const float* __restrict__ pf, const int* __restrict__ pi,
    float* __restrict__ outf, int* __restrict__ outi, int ff, int fi, Walk W,
    int xr, int* __restrict__ list) {
  extern __shared__ int list_s[];
  __shared__ int srcs[kWarps][32];
  __shared__ int kept[kCells];
  rebin::move_cells<SHARED_LIST, false, SLAB, kCells, kWarps, 0>(
      pf, pi, outf, outi, ff, fi, W, xr, list, list_s, srcs, kept);
}

template <bool SHARED_LIST, bool SLAB>
int run(unsigned blocks, int shared, cudaStream_t stream, const float* pf,
        const int* pi, float* outf, int* outi, int ff, int fi, const Walk& W,
        int xr, int* list) {
  auto kernel = rebin_move_3d_kernel<SHARED_LIST, SLAB>;
  // the default is 48 KB less the kernel's static shared memory
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess && shared > attr.maxDynamicSharedSizeBytes)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, kThreads, shared, stream>>>(pf, pi, outf, outi, ff, fi, W,
                                               xr, list);
  return (int)cudaGetLastError();
}

}  // namespace

// wrap: bit a set when axis a is periodic with more than one cell (x:
// wrapping by index); xspan: the x edges' span (read only with xb and a
// periodic x); x0, gnx, gwrapx, t0, nt: the slab, as rebin_move_2d.cu's
// (on one device 0, nx, wrap & 1, 0, nx * ny * nz); list: nullptr for the
// slot lists in shared memory (cap * kCells i32 of it), else i32 scratch
// of cap * nx * ny * nz entries (its contents are not read before this
// call writes them)
extern "C" int rebin_move_3d(const float* pf, const int* pi, float* outf,
                             int* outi, int ff, int fi, int cap, int nx, int ny,
                             int nz, int xr, float lo0, float lo1, float lo2,
                             float inv0, float inv1, float inv2, int wrap,
                             float xspan, const int* xb, float inv_q,
                             int n_fine, int x0, int gnx, int gwrapx, int t0,
                             int nt, int* list, cudaStream_t stream) {
  if (((wrap & 1) && nx < 3) || ((wrap & 2) && ny < 3) ||
      ((wrap & 4) && nz < 3) || (gwrapx && gnx < 3))
    return (int)cudaErrorInvalidValue;
  const int nc = nx * ny * nz;
  if (t0 < 0 || nt < 0 || t0 + nt > nc) return (int)cudaErrorInvalidValue;
  if (nt == 0 || cap == 0) return 0;
  const Walk W{pi, nullptr, nullptr, nullptr, cap, nx, ny, nz, nc, wrap,
               lo0, lo1, lo2, inv0, inv1, inv2, xspan, xb, inv_q, n_fine,
               x0, gnx, gwrapx, t0, nt};
  const unsigned blocks = (unsigned)((nt + kCells - 1) / kCells);
  const int shared = (int)(sizeof(int) * (long long)cap * kCells);
  if (x0 == 0 && gnx == nx && gwrapx == (wrap & 1) && t0 == 0 && nt == nc)
    return list ? run<false, false>(blocks, 0, stream, pf, pi, outf, outi, ff,
                                    fi, W, xr, list)
                : run<true, false>(blocks, shared, stream, pf, pi, outf, outi,
                                   ff, fi, W, xr, nullptr);
  return list ? run<false, true>(blocks, 0, stream, pf, pi, outf, outi, ff, fi,
                                 W, xr, list)
              : run<true, true>(blocks, shared, stream, pf, pi, outf, outi, ff,
                                fi, W, xr, nullptr);
}

// registers per thread and local-memory (spill) bytes per thread of the
// one-device instantiation with the slot lists in shared memory (shared) or
// global
extern "C" int rebin_move_3d_attributes(int shared, int* regs,
                                        int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err =
      shared ? cudaFuncGetAttributes(&attr, rebin_move_3d_kernel<true, false>)
             : cudaFuncGetAttributes(&attr, rebin_move_3d_kernel<false, false>);
  if (err == cudaSuccess) {
    *regs = attr.numRegs;
    *local_bytes = (int)attr.localSizeBytes;
  }
  return (int)err;
}

extern "C" const char* sph_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
