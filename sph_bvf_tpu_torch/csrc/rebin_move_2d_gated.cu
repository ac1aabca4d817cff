// K6 — 2D locality rebin move for crowded cells (16 < cap <= 64), one thread
// per target cell, walking source slots only up to the window's occupancy.
//
// Replaces sph_bvf_tpu/core/rebin_pallas.py `_move_call`, gated branch, for
// uniform columns (the cap > 16 TPU kernel: 8-row slot tiles with i32
// window-occupancy trip counts).  Between rebins a particle moves at most one
// cell (the drift contract that rebin's drift check enforces), so the
// particles that belong in cell c are the matching candidates among the slots
// of its 3x3 stencil cells.  The thread walks them slot-major, then by the
// source cell's flat index after the periodic wraps of x and y — the order of
// the sort rebin's stable (cell, old flat slot) key, so the slot assignment is
// bit-identical to sph_bvf_tpu_torch/core/state.py `rebin` with
// use_kernel=False on wall, periodic-x and doubly periodic grids alike —
// recomputes each candidate's cell from its f32 position exactly as
// `cell_index_of` does (round-to-nearest subtract and multiply, never fused,
// with the same f32 lo and 1/cell_size; a floored modulo on a periodic axis;
// the TPU kernel builds ghost columns for a periodic y, rebin_pallas.py:239-253,
// 305-321, where this one wraps the source row by index), and keeps the
// first cap matches.  A match of rank >= cap, or a particle that moved beyond
// one ring, is dropped; the caller counts the loss as overflow.  The plain
// PyTorch version is sph_bvf_tpu_torch/core/rebin_cuda.py
// `rebin_move_plain`.
//
// What bounds it on an H100: at cap 47 a full walk is 9 x 47 = 423 candidate
// checks per cell, of which only the ~9 x 9-16 occupied ones can match.
// Design: every rebin compacts each cell's valid slots to 0..occ-1, so the
// window's occupancy is the first slot at which all nine source cells are
// empty — the walk stops there, exactly (the GPU form of the TPU kernel's
// `occw` trip count, with no prepass).  Phase 1 records the source slot of
// each output slot in a cap-long list; phase 2 copies row by row, output
// slot by output slot, so neighbouring threads write neighbouring addresses.
//
// Non-uniform x columns (Geometry.x_edges, load balancing; replaces the same
// TPU kernel's `edges` variant, rebin_pallas.py:176-199, 328-333 — the main
// path of the load-balance slice): each candidate's fine bin against its
// target column's bounds, on a periodic x axis after the wrap by the edges'
// own span xspan (`in_column`; the binning, the wrap and the column test
// are K5's and K7's too, in rebin_move.cuh).  The candidate order is the
// order after the wrap, as with uniform columns.
//
// Layouts: pf f32 [ff, cap, NC], pi i32 [fi, cap, NC] with row 0 = valid,
// x at f32 rows xr, xr+1; outputs of the same shapes.  Flat cell
// c = cx * ny + cy; the grid has one cell along z; x and y may each be
// periodic (with at least 3 cells, so no source cell sits in a window twice).

#include <cuda_runtime.h>

#include "rebin_move.cuh"

namespace {

using rebin::bin;
using rebin::in_column;
using rebin::wrap_cell;

constexpr int kMaxCap = 64;
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) rebin_move_2d_gated_kernel(
    const float* __restrict__ pf, const int* __restrict__ pi,
    float* __restrict__ outf, int* __restrict__ outi, int ff, int fi, int cap,
    int nx, int ny, int xr, float lo0, float lo1, float inv0, float inv1,
    int wrapx, int wrapy, float xspan, const int* __restrict__ xb, float inv_q,
    int n_fine) {
  const int nc = nx * ny;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nc) return;
  const int m = cap * nc;
  const int cx = c / ny, cy = c - cx * ny;
  const int xb0 = xb ? __ldg(xb + cx) : 0, xb1 = xb ? __ldg(xb + cx + 1) : 0;
  const float* px = pf + (long long)xr * m;
  const float* py = px + m;

  // the window's source cells, in ascending flat index after both wraps
  int src[9];
  int ns = 0;
  for (int ox = -1; ox <= 1; ++ox) {
    int cxs = cx + ox;
    if (wrapx) {
      cxs = wrap_cell(cxs, nx);
    } else if (cxs < 0 || cxs >= nx) {
      continue;
    }
    for (int oy = -1; oy <= 1; ++oy) {
      int cys = cy + oy;
      if (wrapy) {
        cys = wrap_cell(cys, ny);
      } else if (cys < 0 || cys >= ny) {
        continue;
      }
      int v = cxs * ny + cys;
      int q = ns++;
      for (; q > 0 && src[q - 1] > v; --q) src[q] = src[q - 1];
      src[q] = v;
    }
  }

  int list[kMaxCap];
  int n = 0;
  for (int s = 0; s < cap; ++s) {
    bool occupied = false;
    for (int q = 0; q < ns; ++q) {
      const int k = s * nc + src[q];
      if (__ldg(pi + k) == 0) continue;  // row 0: valid
      occupied = true;
      const int by = ny > 1 ? bin(__ldg(py + k), lo1, inv1, ny, wrapy) : 0;
      if (by != cy || !in_column(__ldg(px + k), cx, nx, lo0, inv0, wrapx, xspan,
                                 xb, xb0, xb1, inv_q, n_fine))
        continue;
      if (n < cap) list[n] = k;
      ++n;
    }
    // compacted slots: an all-empty slot row ends every source cell
    if (!occupied) break;
  }
  const int kept = n < cap ? n : cap;
  for (int r = 0; r < ff; ++r) {
    const float* in = pf + (long long)r * m;
    float* o = outf + (long long)r * m + c;
    for (int s = 0; s < cap; ++s) o[(long long)s * nc] = s < kept ? __ldg(in + list[s]) : 0.f;
  }
  for (int r = 0; r < fi; ++r) {
    const int* in = pi + (long long)r * m;
    int* o = outi + (long long)r * m + c;
    for (int s = 0; s < cap; ++s) o[(long long)s * nc] = s < kept ? __ldg(in + list[s]) : 0;
  }
}

}  // namespace

extern "C" int rebin_move_2d_gated(const float* pf, const int* pi, float* outf,
                                   int* outi, int ff, int fi, int cap, int nx,
                                   int ny, int xr, float lo0, float lo1,
                                   float inv0, float inv1, int wrapx,
                                   int wrapy, float xspan, const int* xb,
                                   float inv_q, int n_fine,
                                   cudaStream_t stream) {
  if (cap > kMaxCap) return (int)cudaErrorInvalidValue;
  if ((wrapx && nx < 3) || (wrapy && ny < 3)) return (int)cudaErrorInvalidValue;
  const int nc = nx * ny;
  if (nc == 0) return 0;
  const unsigned blocks = (unsigned)((nc + kThreads - 1) / kThreads);
  rebin_move_2d_gated_kernel<<<blocks, kThreads, 0, stream>>>(
      pf, pi, outf, outi, ff, fi, cap, nx, ny, xr, lo0, lo1, inv0, inv1, wrapx,
      wrapy, xspan, xb, inv_q, n_fine);
  return (int)cudaGetLastError();
}

extern "C" const char* sph_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
