// K7 — 3D locality rebin move (any cap; walls or periodic axes), one thread
// per target cell, walking source slots only up to the window's occupancy.
//
// Replaces sph_bvf_tpu/core/rebin_pallas.py `_move_call_tiled3d` (the TPU
// kernel on the (x-plane, yz-block) grid with 27 staged offsets and
// window-occupancy trip counts).  Between rebins a particle moves at most one
// cell (the drift contract that rebin's drift check enforces), so the
// particles that belong in cell c are the matching candidates among the slots
// of its 27 stencil cells.  The thread walks them slot-major, then by
// ascending source flat index after the periodic wraps — the order of the
// sort rebin's stable (cell, old flat slot) key, so the slot assignment is
// bit-identical to sph_bvf_tpu_torch/core/state.py `rebin` with
// use_kernel=False on wall and periodic grids alike — recomputes each
// candidate's cell from its f32 position exactly as `cell_index_of` does
// (round-to-nearest subtract and multiply, never fused, with the same f32 lo
// and 1/cell_size; clamped on a wall axis, a floored modulo on a periodic
// one), and keeps the first cap matches.  A match of rank >= cap, or a
// particle that moved beyond one ring, is dropped; the caller counts the loss
// as overflow.  The plain PyTorch version is
// sph_bvf_tpu_torch/core/rebin_cuda.py `rebin_move_plain`.
//
// What bounds it on an H100: the bytes of the packs (about 40 f32 and 6 i32
// rows of cap * NC slots, read once and written once), 0.6 GB at the 1.19M
// particle cavity.  The candidate checks are the other cost: the cavity's
// cells hold 27 of 38 slots, so a full walk is 27 x 38 = 1,026 checks per
// cell of which 27 x 27 are occupied.  Design: every rebin compacts each
// cell's valid slots to 0..occ-1, so the window's occupancy is the first slot
// at which all 27 source cells are empty — the walk stops there, exactly (the
// GPU form of the TPU kernel's trip count, with no prepass).  Phase 1 records
// the source slot of each output slot in a list; phase 2 copies row by row,
// output slot by output slot, so neighbouring threads write neighbouring
// addresses.  The list is a caller-provided i32 [cap, NC] scratch in global
// memory (entry (s, c) at s * NC + c, so neighbouring threads' entries are
// neighbours too), not a thread-local array, whose size would be fixed at
// compile time: the TPU kernel has no cap limit but VMEM, and the 3D FSI
// beam's finer lattice needs cap 119-296.
//
// Non-uniform x columns (Geometry.x_edges, load balancing; replaces the TPU
// kernel's `edges` variant, rebin_pallas.py:487-492, 595-600, 641, whose
// per-plane column bounds are scalars): a candidate lies in plane cx when its
// fine bin lies in the plane's bounds [xb[cx], xb[cx+1]) (`in_column`,
// rebin_move.cuh, K5's and K6's test).  On a periodic grid x wraps by the
// edges' own span xspan before the fine bin, as `cell_index_of` does (the
// TPU kernel skips x's uniform bin under `edges`, :582, and tests the fine
// bin against the plane's bounds, :595-600); y and z bin as without edges.
// xb == nullptr means uniform planes.
//
// Periodic axes (replaces the TPU kernel's periodic binning,
// rebin_pallas.py:573-600, and its wrapped halo planes and ghost columns): a
// runtime bit per axis (`wrap`), as K6's wrapx / wrapy.  A source cell
// wraps by index, a candidate's bin on that axis is the floored modulo of
// its f32 bin (the position is already wrapped into the box by `wrap_pbc`),
// and the 27 source cells are sorted by flat index after the wrap, so the
// walk keeps the sort rebin's order.  Every wrapping axis has at least 3
// cells, so no source cell sits in a window twice.  The TPU kernel may order
// a cell's slots differently on a periodic grid (rebin_pallas.py:28-31); the
// cells' contents are the same.
//
// Layouts: pf f32 [ff, cap, NC], pi i32 [fi, cap, NC] with row 0 = valid,
// x at f32 rows xr, xr+1, xr+2; outputs of the same shapes.  Flat cell
// c = (cx * ny + cy) * nz + cz.

#include <cuda_runtime.h>

#include "rebin_move.cuh"

namespace {

using rebin::bin;
using rebin::in_column;
using rebin::wrap_cell;

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) rebin_move_3d_kernel(
    const float* __restrict__ pf, const int* __restrict__ pi,
    float* __restrict__ outf, int* __restrict__ outi, int ff, int fi, int cap,
    int nx, int ny, int nz, int xr, float lo0, float lo1, float lo2,
    float inv0, float inv1, float inv2, int wrap, float xspan,
    const int* __restrict__ xb, float inv_q, int n_fine,
    int* __restrict__ list) {
  const int nc = nx * ny * nz;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nc) return;
  const long long m = (long long)cap * nc;
  const int cz = c % nz, cxy = c / nz;
  const int cy = cxy % ny, cx = cxy / ny;
  const int xb0 = xb ? __ldg(xb + cx) : 0, xb1 = xb ? __ldg(xb + cx + 1) : 0;
  const float* px = pf + (long long)xr * m;
  const float* py = px + m;
  const float* pz = py + m;

  // the window's source cells, in ascending flat index after the wraps
  const bool wx = wrap & 1, wy = wrap & 2, wz = wrap & 4;
  int src[27];
  int ns = 0;
  for (int ox = -1; ox <= 1; ++ox) {
    int sx = cx + ox;
    if (wx) {
      sx = wrap_cell(sx, nx);
    } else if (sx < 0 || sx >= nx) {
      continue;
    }
    for (int oy = -1; oy <= 1; ++oy) {
      int sy = cy + oy;
      if (wy) {
        sy = wrap_cell(sy, ny);
      } else if (sy < 0 || sy >= ny) {
        continue;
      }
      for (int oz = -1; oz <= 1; ++oz) {
        int sz = cz + oz;
        if (wz) {
          sz = wrap_cell(sz, nz);
        } else if (sz < 0 || sz >= nz) {
          continue;
        }
        const int v = (sx * ny + sy) * nz + sz;
        int q = ns++;
        for (; q > 0 && src[q - 1] > v; --q) src[q] = src[q - 1];
        src[q] = v;
      }
    }
  }

  // list[r * nc + c]: the source slot of output slot r of this cell
  int n = 0;
  for (int s = 0; s < cap; ++s) {
    bool occupied = false;
    for (int q = 0; q < ns; ++q) {
      const int k = s * nc + src[q];
      if (__ldg(pi + k) == 0) continue;  // row 0: valid
      occupied = true;
      const int by = ny > 1 ? bin(__ldg(py + k), lo1, inv1, ny, wy) : 0;
      const int bz = nz > 1 ? bin(__ldg(pz + k), lo2, inv2, nz, wz) : 0;
      if (by != cy || bz != cz ||
          !in_column(__ldg(px + k), cx, nx, lo0, inv0, wx, xspan, xb, xb0, xb1,
                     inv_q, n_fine))
        continue;
      if (n < cap) list[(long long)n * nc + c] = k;
      ++n;
    }
    // compacted slots: an all-empty slot row ends every source cell
    if (!occupied) break;
  }
  const int kept = n < cap ? n : cap;
  const int* lc = list + c;
  for (int r = 0; r < ff; ++r) {
    const float* in = pf + (long long)r * m;
    float* o = outf + (long long)r * m + c;
    for (int s = 0; s < cap; ++s)
      o[(long long)s * nc] = s < kept ? __ldg(in + lc[(long long)s * nc]) : 0.f;
  }
  for (int r = 0; r < fi; ++r) {
    const int* in = pi + (long long)r * m;
    int* o = outi + (long long)r * m + c;
    for (int s = 0; s < cap; ++s)
      o[(long long)s * nc] = s < kept ? __ldg(in + lc[(long long)s * nc]) : 0;
  }
}

}  // namespace

// wrap: bit a set when axis a is periodic with more than one cell; xspan:
// the x edges' span (read only with xb and a periodic x); list: i32 scratch
// of cap * nx * ny * nz entries (its contents are not read before this call
// writes them)
extern "C" int rebin_move_3d(const float* pf, const int* pi, float* outf,
                             int* outi, int ff, int fi, int cap, int nx, int ny,
                             int nz, int xr, float lo0, float lo1, float lo2,
                             float inv0, float inv1, float inv2, int wrap,
                             float xspan, const int* xb, float inv_q,
                             int n_fine, int* list, cudaStream_t stream) {
  if (((wrap & 1) && nx < 3) || ((wrap & 2) && ny < 3) || ((wrap & 4) && nz < 3))
    return (int)cudaErrorInvalidValue;
  const int nc = nx * ny * nz;
  if (nc == 0) return 0;
  const unsigned blocks = (unsigned)((nc + kThreads - 1) / kThreads);
  rebin_move_3d_kernel<<<blocks, kThreads, 0, stream>>>(
      pf, pi, outf, outi, ff, fi, cap, nx, ny, nz, xr, lo0, lo1, lo2, inv0,
      inv1, inv2, wrap, xspan, xb, inv_q, n_fine, list);
  return (int)cudaGetLastError();
}

extern "C" const char* sph_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
