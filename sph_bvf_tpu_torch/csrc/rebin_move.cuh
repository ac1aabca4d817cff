// What the locality rebin moves share (K5 and K6, rebin_move_2d.cu; K7,
// rebin_move_3d.cu): each candidate's cell recomputed from its f32 position
// exactly as sph_bvf_tpu_torch/core/state.py `cell_index_of` computes it,
// the wrap of a source cell on a periodic axis, and the walk itself — a
// warp per target cell ranking its matches (`rank_matches`), a block of
// target cells copying from their slot lists (`move_cells`), on a 3D grid
// or on a plane (a 2D grid, one z cell).
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
//
// An x-slab of a mesh (parallel/mesh.py): the packs hold the slab's planes
// with one halo plane on each side, the grid the kernel indexes is that
// ghosted slab (nx planes, plane 0 being global plane x0), and the targets
// are the slab's own cells, t0 .. t0 + nt - 1 (the output holds nt cells).
// Binning stays global: a candidate's x bin is taken on the global grid of
// gnx planes (a periodic one when `gwrapx`), against the target's global
// plane; and the window ranks its source cells by their global flat index,
// so that the candidates keep the single grid's order (the halo plane left
// of rank 0 on a ring is global plane gnx - 1, last in that order).  The
// walk and the copy take that form when instantiated with SLAB; without
// it (one device: x0 = 0, gnx = nx, gwrapx = the x wrap, t0 = 0, nt = nc)
// they compile as before the mesh, so a one-device move pays nothing for
// it: the slab form alone on one device gives the same slots but costs
// 0.4-0.7% of the 2D moves' device time and 4.8% of the 3D cavity's
// (H100, tools/torch_move_timing.py, PERF.md).

#pragma once

#include <climits>

#include <cuda_runtime.h>

namespace rebin {

// FAST: skip the modulo for a bin already in [0, n) (the same value)
template <bool FAST = false>
__device__ __forceinline__ int bin(float x, float lo, float inv, int n,
                                   bool periodic) {
  const int b = (int)floorf(__fmul_rn(__fsub_rn(x, lo), inv));
  if (periodic) {  // floored modulo, as _mod; b is in [0, n) but at a seam
    if (FAST && (unsigned)b < (unsigned)n) return b;
    return ((b % n) + n) % n;
  }
  return min(max(b, 0), n - 1);
}

// a source cell index one step outside [0, n) wrapped back into it
__device__ __forceinline__ int wrap_cell(int c, int n) {
  return c < 0 ? c + n : (c >= n ? c - n : c);
}

// x column membership: with edges, the fine bin of the position (wrapped by
// the edges' span on a periodic axis) against [xb0, xb1); else the uniform
// bin against cx.  FAST: `bin`'s, and no fmodf for an x - lo0 already in
// [0, xspan) (fmodf returns it unchanged)
template <bool FAST = false>
__device__ __forceinline__ bool in_column(float x, int cx, int nx, float lo0,
                                          float inv0, bool wrapx, float xspan,
                                          const int* xb, int xb0, int xb1,
                                          float inv_q, int n_fine) {
  if (nx == 1) return true;
  if (xb == nullptr) return bin<FAST>(x, lo0, inv0, nx, wrapx) == cx;
  if (wrapx) {  // lo0 + _mod(x - lo0, xspan): fmod, then shift the sign
    float r = __fsub_rn(x, lo0);
    if (!(FAST && r >= 0.f && r < xspan)) {
      r = fmodf(r, xspan);
      if (r != 0.f && ((r < 0.f) != (xspan < 0.f))) r = __fadd_rn(r, xspan);
    }
    x = __fadd_rn(r, lo0);
  }
  const int f = bin(x, lo0, inv_q, n_fine, false);
  return f >= xb0 && f < xb1;
}

constexpr unsigned kFull = 0xffffffffu;

// What phase 1 of one target cell reads: the packs' valid row and x rows,
// the grid, the binning constants and the x columns.
struct Walk {
  const int* pi;
  const float *px, *py, *pz;
  int cap, nx, ny, nz, nc, wrap;
  float lo0, lo1, lo2, inv0, inv1, inv2, xspan;
  const int* xb;
  float inv_q;
  int n_fine;
  // the slab: x0, gnx, the global x wrap, the targets t0 .. t0 + nt - 1
  int x0, gnx, gwrapx, t0, nt;
};

// Phase 1 of target cell c, by the 32 lanes of a warp together: the source
// slot of output slot r goes to lst[r * stride] for r < cap; returns the
// count of matches (overflow included).  srcs: this warp's 32 ints of
// shared memory.  PLANE: a 2D grid (nz == 1), whose window is the 9 cells
// of one z plane and whose candidates bin on x and y only; else the 27
// cells of a 3D window.  On a plane the walk is also trimmed (no modulo
// or fmodf where the value is already in range, t / ns as a
// multiply-high, the row stop without a loop); in 3D the same trims raised
// K7's registers and slowed its 3D vortex (PERF.md), so K7 walks as
// before.
template <bool PLANE, bool SLAB>
__device__ __forceinline__ int rank_matches(const Walk& W, int c, int* srcs,
                                            int* lst, int stride) {
  constexpr int kWindow = PLANE ? 9 : 27;
  const int lane = threadIdx.x & 31;
  const int cz = PLANE ? 0 : c % W.nz, cxy = PLANE ? c : c / W.nz;
  const int cy = cxy % W.ny, cx = cxy / W.ny;
  const int gcx = SLAB ? cx + W.x0 : cx;  // the target's global plane
  const bool wx = W.wrap & 1, wy = W.wrap & 2, wz = W.wrap & 4;
  // lane o < kWindow: the source cell at offset (o / 9 - 1, o / 3 % 3 - 1,
  // o % 3 - 1), on a plane (o / 3 - 1, o % 3 - 1, 0), after the wraps: its
  // global flat index v, INT_MAX off the global grid, and its index a in
  // the packs
  int v = INT_MAX, a = 0;
  if (lane < kWindow) {
    const int ox = (PLANE ? lane / 3 : lane / 9) - 1;
    int sx = cx + ox, gx = gcx + ox,
        sy = cy + (PLANE ? lane : lane / 3) % 3 - 1,
        sz = PLANE ? 0 : cz + lane % 3 - 1;
    bool on = true;
    if (wx) sx = wrap_cell(sx, W.nx); else on = on && sx >= 0 && sx < W.nx;
    if (SLAB) {
      if (W.gwrapx) gx = wrap_cell(gx, W.gnx);
      else on = on && gx >= 0 && gx < W.gnx;
    }
    if (wy) sy = wrap_cell(sy, W.ny); else on = on && sy >= 0 && sy < W.ny;
    if (!PLANE) {
      if (wz) sz = wrap_cell(sz, W.nz); else on = on && sz >= 0 && sz < W.nz;
    }
    if (on) {
      a = PLANE ? sx * W.ny + sy : (sx * W.ny + sy) * W.nz + sz;
      v = !SLAB ? a : PLANE ? gx * W.ny + sy : (gx * W.ny + sy) * W.nz + sz;
    }
  }
  // the window in ascending flat index: each lane's rank among the lanes
  // (no source cell is on the grid twice: a wrapping axis has >= 3 cells;
  // the off-grid ties go by lane); on a plane the window's 9 lanes rank
  // among themselves and only they write
  int rank = 0;
#pragma unroll
  for (int q = 0; q < (PLANE ? kWindow : 32); ++q) {
    const int u = __shfl_sync(kFull, v, q);
    rank += u < v || (u == v && q < lane);
  }
  __syncwarp();
  if (!PLANE || lane < kWindow) srcs[rank] = a;
  const int ns = __popc(__ballot_sync(kFull, v != INT_MAX));
  __syncwarp();

  const int xb0 = W.xb ? __ldg(W.xb + gcx) : 0;
  const int xb1 = W.xb ? __ldg(W.xb + gcx + 1) : 0;
  const unsigned lower = (1u << lane) - 1u;
  const int total = W.cap * ns;  // the candidates: cap slot rows of ns cells
  // candidate t = slot t / ns of the (t % ns)-th source cell; on a plane
  // t / ns as a multiply-high by 2^32 / ns rounded up (exact while t < 2^32
  // / ns), and the row stop from each lane's own row
  const unsigned ns_inv = 0xffffffffu / (unsigned)ns + 1u;
  int n = 0;
  bool carried = false;  // a valid slot in the row this step continues
  for (int base = 0; base < total; base += 32) {
    const int t = base + lane;
    bool valid = false, match = false;
    int k = 0, col = 0;  // col: on a plane, the row stop reads it
    if constexpr (PLANE) {
      const int slot = ns == 1 ? t : (int)__umulhi((unsigned)t, ns_inv);
      col = t - slot * ns;
      k = slot * W.nc + srcs[col];
    }
    if (t < total) {
      if constexpr (!PLANE) {
        const int s = t / ns, q = t - s * ns;
        k = s * W.nc + srcs[q];
      }
      const float x = __ldg(W.px + k), y = __ldg(W.py + k),
                  z = PLANE ? 0.f : __ldg(W.pz + k);
      valid = __ldg(W.pi + k) != 0;  // row 0: valid
      match = valid &&
              (W.ny > 1 ? bin<PLANE>(y, W.lo1, W.inv1, W.ny, wy) : 0) == cy &&
              (PLANE ||
               (W.nz > 1 ? bin(z, W.lo2, W.inv2, W.nz, wz) : 0) == cz) &&
              in_column<PLANE>(x, gcx, SLAB ? W.gnx : W.nx, W.lo0, W.inv0,
                               SLAB ? W.gwrapx != 0 : wx, W.xspan, W.xb, xb0,
                               xb1, W.inv_q, W.n_fine);
    }
    const unsigned any_valid = __ballot_sync(kFull, valid);
    // the first slot row this step ends with no valid slot: lanes past it
    // are not walked (compacted slots: that row ends every source cell)
    int end = 32;
    if constexpr (PLANE) {
      // this lane's slot row in this step: lanes [first, past), first < 0
      // where the row began in the step before (whether it held a valid
      // slot there is carried), past > 32 where it goes on in the next step
      const int first = lane - col, past = first + ns;
      const unsigned in_row = (past >= 32 ? kFull : (1u << past) - 1u) &
                              ~((1u << max(first, 0)) - 1u);
      const bool occupied =
          (any_valid & in_row) != 0 || (first < 0 && carried);
      const unsigned empty =
          __ballot_sync(kFull, t < total && past <= 32 && !occupied);
      if (empty) end = __shfl_sync(kFull, past, __ffs(empty) - 1);
      carried = __shfl_sync(kFull, occupied && past > 32, 31);
    } else {
      for (int s = base / ns; s * ns < base + 32 && s < W.cap; ++s) {
        const int lo = max(s * ns - base, 0),
                  hi = min((s + 1) * ns - base, 32);
        const unsigned in_row =
            (hi == 32 ? kFull : (1u << hi) - 1u) & ~((1u << lo) - 1u);
        const bool occupied =
            (any_valid & in_row) != 0 || (s * ns < base && carried);
        if ((s + 1) * ns > base + 32) {  // the row goes on in the next step
          carried = occupied;
          break;
        }
        carried = false;
        if (!occupied) {
          end = hi;
          break;
        }
      }
    }
    const bool kept = match && lane < end;
    const unsigned matches = __ballot_sync(kFull, kept);
    if (kept) {
      const int r = n + __popc(matches & lower);
      if (r < W.cap) lst[r * stride] = k;
    }
    n += __popc(matches);
    if (end < 32) break;
  }
  return n;
}

// A thread's copy of `rows` rows of its source slot (in, the first row's
// word; rows m words apart) to its output slot (out; rows mo words apart),
// ROWS loads in flight: each batch of ROWS rows is loaded before it is
// stored.
template <int ROWS>
__device__ __forceinline__ void copy_rows(const unsigned* __restrict__ in,
                                          unsigned* __restrict__ out, int rows,
                                          long long m, long long mo) {
  for (int r0 = 0; r0 < rows; r0 += ROWS, in += ROWS * m, out += ROWS * mo) {
    unsigned v[ROWS];
#pragma unroll
    for (int b = 0; b < ROWS; ++b)
      if (r0 + b < rows) v[b] = __ldg(in + b * m);
#pragma unroll
    for (int b = 0; b < ROWS; ++b)
      if (r0 + b < rows) out[b * mo] = v[b];
  }
}

// One block's move of CELLS target cells from t0 + blockIdx.x * CELLS (of
// the outputs' nt cells: output cell c - t0), by WARPS
// warps: phase 1, each warp ranks one cell after another (`rank_matches`)
// into their slot lists, in shared memory (SHARED_LIST: list_s, i32 [cap,
// CELLS]) or in `list` (i32 [cap, NC] in global memory); phase 2, the block
// copies, a thread per (output slot, cell), the cell minor, so that
// neighbouring threads write neighbouring addresses of every row of [F, cap,
// NC], in batches of ROWS rows (`copy_rows`; the plane's: one row after
// another ran it 6-10% slower), or with ROWS = 0 one row after another,
// unrolled by 4 (K7's: in batches of 8 or 4 rows its 3D moves ran up to 6%
// slower; H100, PERF.md); a slot past its cell's match count is
// written as zeros without reading anything.  srcs: WARPS x 32 ints, kept:
// CELLS ints of shared memory.
template <bool SHARED_LIST, bool PLANE, bool SLAB, int CELLS, int WARPS,
          int ROWS>
__device__ __forceinline__ void move_cells(
    const float* __restrict__ pf, const int* __restrict__ pi,
    float* __restrict__ outf, int* __restrict__ outi, int ff, int fi, Walk W,
    int xr, int* __restrict__ list, int* list_s, int (*srcs)[32], int* kept) {
  const int t0 = SLAB ? W.t0 : 0, nt = SLAB ? W.nt : W.nc;
  const long long m = (long long)W.cap * W.nc, mo = (long long)W.cap * nt;
  const int c0 = t0 + blockIdx.x * CELLS;
  const int cells = min(CELLS, t0 + nt - c0);
  int* lst = SHARED_LIST ? list_s : list + c0;
  const int stride = SHARED_LIST ? CELLS : W.nc;
  W.px = pf + (long long)xr * m;
  W.py = W.px + m;
  W.pz = W.py + m;

  const int warp = threadIdx.x / 32;
  for (int cell = warp; cell < cells; cell += WARPS) {
    const int n =
        rank_matches<PLANE, SLAB>(W, c0 + cell, srcs[warp], lst + cell,
                                  stride);
    if (threadIdx.x % 32 == 0) kept[cell] = min(n, W.cap);
  }
  __syncthreads();

  // phase 2: output slot s of cell c0 + cell, every row
  for (int it = threadIdx.x; it < W.cap * CELLS; it += 32 * WARPS) {
    const int s = it / CELLS, cell = it % CELLS;
    if (cell >= cells) continue;
    const long long o = (long long)s * nt + c0 - t0 + cell;
    if (s < kept[cell]) {
      const long long k = lst[s * stride + cell];
      if constexpr (ROWS > 0) {
        copy_rows<ROWS>(reinterpret_cast<const unsigned*>(pf) + k,
                        reinterpret_cast<unsigned*>(outf) + o, ff, m, mo);
        copy_rows<ROWS>(reinterpret_cast<const unsigned*>(pi) + k,
                        reinterpret_cast<unsigned*>(outi) + o, fi, m, mo);
      } else {
#pragma unroll 4
        for (int r = 0; r < ff; ++r)
          outf[(long long)r * mo + o] = __ldg(pf + (long long)r * m + k);
#pragma unroll 4
        for (int r = 0; r < fi; ++r)
          outi[(long long)r * mo + o] = __ldg(pi + (long long)r * m + k);
      }
    } else {
#pragma unroll 4
      for (int r = 0; r < ff; ++r) outf[(long long)r * mo + o] = 0.f;
#pragma unroll 4
      for (int r = 0; r < fi; ++r) outi[(long long)r * mo + o] = 0;
    }
  }
}

}  // namespace rebin
