// K5 — 2D locality rebin move, one thread per target cell.
//
// Replaces sph_bvf_tpu/core/rebin_pallas.py `_move_call`, static branch (the
// cap <= 16 TPU kernel of the flagship's rebin).  Between rebins a particle
// moves at most one cell (the drift contract that rebin's drift check
// enforces), so the particles that belong in cell c are the matching
// candidates among the slots of its 3x3 stencil cells.  The thread walks
// them slot-major (s_old = 0..cap-1), then by ascending flat offset — the
// order of the sort rebin's stable (cell, old flat slot) key, so the slot
// assignment is bit-identical to sph_bvf_tpu_torch/core/state.py `rebin`
// with use_kernel=False — recomputes each candidate's cell from its f32
// position exactly as `cell_index_of` does (round-to-nearest subtract and
// multiply, never fused, with the same f32 lo and 1/cell_size), and keeps
// the first cap matches.  A match of rank >= cap, or a particle that moved
// beyond one ring, is dropped; the caller counts the loss as overflow.  The
// plain PyTorch version is sph_bvf_tpu_torch/core/rebin_cuda.py
// `rebin_move_plain`.
//
// What bounds it on an H100: HBM traffic — each packed row is read about
// once (the 3x3 windows of neighbouring threads overlap in L1/L2) and
// written once, 43 rows x cap x NC x 4 bytes each way on the flagship; the
// walk itself reads only the valid and two position rows.  Design: phase 1
// walks the candidates and records the source slot of each output slot in a
// cap-long list; phase 2 copies row by row, output slot by output slot, so
// neighbouring threads write neighbouring addresses.
//
// Non-uniform x columns (Geometry.x_edges, load balancing; replaces the same
// TPU kernel's `edges` variant, rebin_pallas.py:176-199, 328-333): each
// candidate's fine bin against its target column's bounds (`in_column`,
// rebin_move.cuh).
//
// Periodic axes (replaces the same TPU kernel on a grid with a periodic
// axis, rebin_pallas.py:90-92: its wrapped halo on x, assemble_padded, and
// its ghost columns on y with the target binned by the floored modulo,
// :305-321): two runtime bits, wrapx and wrapy, select the periodic
// instantiation, which follows K6 (rebin_move_2d_gated.cu) and bins through
// the same rebin_move.cuh.  A source cell wraps by index, and the 9 source
// cells are sorted by flat index after the wrap, so the walk keeps the
// sort rebin's order; a candidate's bin on a periodic axis is the floored
// modulo of its f32 bin, and with x_edges x wraps by the edges' span xspan,
// not by hi - lo.  Every wrapping axis has at least 3 cells (the wrapper
// refuses 2), so no source cell sits in a window twice.  The TPU kernel may order
// a cell's slots differently on a periodic grid (rebin_pallas.py:28-31);
// this one keeps the sort's order.  The wall instantiation (kPeriodic
// false) is the walk it always was.
//
// Layouts: pf f32 [ff, cap, NC], pi i32 [fi, cap, NC] with row 0 = valid,
// x at f32 rows xr, xr+1; outputs of the same shapes.  Flat cell
// c = cx * ny + cy; the grid has one cell along z.

#include <cuda_runtime.h>

#include "rebin_move.cuh"

namespace {

using rebin::bin;
using rebin::in_column;
using rebin::wrap_cell;

constexpr int kMaxCap = 16;
constexpr int kThreads = 128;

template <bool kPeriodic>
__global__ void __launch_bounds__(kThreads) rebin_move_2d_kernel(
    const float* __restrict__ pf, const int* __restrict__ pi,
    float* __restrict__ outf, int* __restrict__ outi, int ff, int fi, int cap,
    int nx, int ny, int xr, float lo0, float lo1, float inv0, float inv1,
    int wrapx, int wrapy, float xspan, const int* __restrict__ xb, float inv_q,
    int n_fine) {
  const int nc = nx * ny;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nc) return;
  const long long m = (long long)cap * nc;
  const int cx = c / ny, cy = c - cx * ny;
  const int xb0 = xb ? __ldg(xb + cx) : 0, xb1 = xb ? __ldg(xb + cx + 1) : 0;
  const float* px = pf + (long long)xr * m;
  const float* py = px + m;

  long long src[kMaxCap];
  int n = 0;
  if (!kPeriodic) {
    for (int s = 0; s < cap; ++s) {
      for (int ox = -1; ox <= 1; ++ox) {
        const int cxs = cx + ox;
        if (cxs < 0 || cxs >= nx) continue;
        for (int oy = -1; oy <= 1; ++oy) {
          const int cys = cy + oy;
          if (cys < 0 || cys >= ny) continue;
          const long long k = (long long)s * nc + cxs * ny + cys;
          if (__ldg(pi + k) == 0) continue;  // row 0: valid
          const int by = ny > 1 ? bin(__ldg(py + k), lo1, inv1, ny, false) : 0;
          if (by != cy || !in_column(__ldg(px + k), cx, nx, lo0, inv0, false,
                                     0.f, xb, xb0, xb1, inv_q, n_fine))
            continue;
          if (n < cap) src[n] = k;
          ++n;
        }
      }
    }
  } else {
    // the window's source cells, in ascending flat index after both wraps
    int cell[9];
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
        const int v = cxs * ny + cys;
        int q = ns++;
        for (; q > 0 && cell[q - 1] > v; --q) cell[q] = cell[q - 1];
        cell[q] = v;
      }
    }
    for (int s = 0; s < cap; ++s) {
      for (int q = 0; q < ns; ++q) {
        const long long k = (long long)s * nc + cell[q];
        if (__ldg(pi + k) == 0) continue;  // row 0: valid
        const int by = ny > 1 ? bin(__ldg(py + k), lo1, inv1, ny, wrapy) : 0;
        if (by != cy || !in_column(__ldg(px + k), cx, nx, lo0, inv0, wrapx,
                                   xspan, xb, xb0, xb1, inv_q, n_fine))
          continue;
        if (n < cap) src[n] = k;
        ++n;
      }
    }
  }
  const int kept = n < cap ? n : cap;
  for (int r = 0; r < ff; ++r) {
    const float* in = pf + (long long)r * m;
    float* o = outf + (long long)r * m + c;
    for (int s = 0; s < cap; ++s) o[(long long)s * nc] = s < kept ? __ldg(in + src[s]) : 0.f;
  }
  for (int r = 0; r < fi; ++r) {
    const int* in = pi + (long long)r * m;
    int* o = outi + (long long)r * m + c;
    for (int s = 0; s < cap; ++s) o[(long long)s * nc] = s < kept ? __ldg(in + src[s]) : 0;
  }
}

}  // namespace

// wrapx / wrapy: x / y periodic with more than one cell; xspan: the x
// edges' span (read only with xb and wrapx)
extern "C" int rebin_move_2d(const float* pf, const int* pi, float* outf,
                             int* outi, int ff, int fi, int cap, int nx, int ny,
                             int xr, float lo0, float lo1, float inv0,
                             float inv1, int wrapx, int wrapy, float xspan,
                             const int* xb, float inv_q, int n_fine,
                             cudaStream_t stream) {
  if (cap > kMaxCap) return (int)cudaErrorInvalidValue;
  if ((wrapx && nx < 3) || (wrapy && ny < 3)) return (int)cudaErrorInvalidValue;
  const int nc = nx * ny;
  if (nc == 0) return 0;
  const unsigned blocks = (unsigned)((nc + kThreads - 1) / kThreads);
  if (wrapx || wrapy) {
    rebin_move_2d_kernel<true><<<blocks, kThreads, 0, stream>>>(
        pf, pi, outf, outi, ff, fi, cap, nx, ny, xr, lo0, lo1, inv0, inv1,
        wrapx, wrapy, xspan, xb, inv_q, n_fine);
  } else {
    rebin_move_2d_kernel<false><<<blocks, kThreads, 0, stream>>>(
        pf, pi, outf, outi, ff, fi, cap, nx, ny, xr, lo0, lo1, inv0, inv1,
        0, 0, 0.f, xb, inv_q, n_fine);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* sph_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
