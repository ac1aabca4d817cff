// The binning the three locality rebin moves share (K5
// rebin_move_2d.cu, K6 rebin_move_2d_gated.cu, K7 rebin_move_3d.cu): each
// candidate's cell recomputed from its f32 position exactly as
// sph_bvf_tpu_torch/core/state.py `cell_index_of` computes it, and the
// wrap of a source cell on a periodic axis.
//
// A bin is floor((x - lo) * inv) with round-to-nearest subtract and
// multiply, never fused, with the f32 lo and 1/cell_size the wrapper
// passes (`_bin_constants`): clamped to [0, n) on a wall axis, the floored
// modulo on a periodic one (`core/state.py` `_mod`; the position is
// already wrapped into the box by `wrap_pbc`, but in f32 a position a hair
// below lo wraps to hi, whose bin is n and lands in cell 0 as it does
// there).
//
// Non-uniform x columns (Geometry.x_edges): xb holds each column's
// fine-bin bounds, i32 [nx+1] = round((edge - edge0) / x_quantum).  A
// candidate lies in column cx when its fine bin clamp(floor((x - lo0) *
// inv_q), 0, n_fine - 1) lies in [xb[cx], xb[cx+1]): the columns partition
// the fine grid, so this is `cell_index_of`'s table gather bit for bit.  On
// a periodic x axis `cell_index_of` first wraps the (already wrap_pbc'd)
// position once more by the edges' own span xspan = edge[nx] - edge0 (lo0
// + the floored mod of x - lo0), which `in_column` repeats with the same
// f32 rounding.  xb == nullptr means uniform columns.

#pragma once

#include <cuda_runtime.h>

namespace rebin {

__device__ __forceinline__ int bin(float x, float lo, float inv, int n,
                                   bool periodic) {
  const int b = (int)floorf(__fmul_rn(__fsub_rn(x, lo), inv));
  if (periodic) return ((b % n) + n) % n;  // floored modulo, as _mod
  return min(max(b, 0), n - 1);
}

// a source cell index one step outside [0, n) wrapped back into it
__device__ __forceinline__ int wrap_cell(int c, int n) {
  return c < 0 ? c + n : (c >= n ? c - n : c);
}

// x column membership: with edges, the fine bin of the position (wrapped by
// the edges' span on a periodic axis) against [xb0, xb1); else the uniform
// bin against cx
__device__ __forceinline__ bool in_column(float x, int cx, int nx, float lo0,
                                          float inv0, bool wrapx, float xspan,
                                          const int* xb, int xb0, int xb1,
                                          float inv_q, int n_fine) {
  if (nx == 1) return true;
  if (xb == nullptr) return bin(x, lo0, inv0, nx, wrapx) == cx;
  if (wrapx) {  // lo0 + _mod(x - lo0, xspan): fmod, then shift the sign
    float r = fmodf(__fsub_rn(x, lo0), xspan);
    if (r != 0.f && ((r < 0.f) != (xspan < 0.f))) r = __fadd_rn(r, xspan);
    x = __fadd_rn(r, lo0);
  }
  const int f = bin(x, lo0, inv_q, n_fine, false);
  return f >= xb0 && f < xb1;
}

}  // namespace rebin
