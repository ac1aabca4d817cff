// The neighbour walk K3 (csrc/pass_a_3d.cu) and K2
// (csrc/pass_a_2d_rowloop.cu) share: one thread per valid slot i, the lanes
// of a warp on the slots of one cell, the support test apart from the pair
// body.  DIM is the stencil's: 27 cells in 3D, 9 in 2D (a 2D grid has one
// cell along z and no z offset).
//
// Two choices keep a warp's 32 lanes doing the same work:
//   - the lanes share a cell.  Thread t takes the valid slot order[t]
//     (ops/pair_cuda.py `walk_index`: the valid slots cell by cell, then
//     -1), so a warp's lanes are the particles of one or two cells (a cell
//     of more than 32 takes two warps, each walking the whole
//     neighbourhood), walk the same candidates in lockstep and read each
//     candidate's position as one broadcast load; no thread sits on an
//     empty slot.  A cell's j loop stops at its first empty slot (lead, the
//     count of its leading valid slots: every rebin leaves the valid slots
//     compacted at 0..occ-1 and validity does not change until the next
//     rebin).  An empty slot's accumulators are written as zeros by the
//     thread of its own index.
//   - the support test is apart from the body.  With 32 lanes testing 32
//     different i, nearly every candidate has some lane inside the
//     support, so a warp that ran the body per candidate would issue the
//     whole body for nearly every candidate.  A lane tests r^2 against the
//     largest support (h, or with species the larger of h and cutc), kStep
//     candidates a step with their loads issued together, and appends a
//     passing j to its list of kChunk slots in shared memory; whenever some
//     lane's list could not take another step, and at the end, the warp
//     runs the body over every lane's list in lockstep, so no list
//     overflows.  The lists keep the walk's order, so each accumulator adds
//     the same non-zero terms in the same order as a walk that runs the
//     body on every candidate.
//
// Flat cell c = (cx * ny + cy) * nz + cz (Geometry.strides, z minor).

#pragma once

#include <cuda_runtime.h>

#include "pass_a_mech.cuh"

namespace walk {

constexpr int kThreads = 128;
// the in-support j a lane collects (in shared memory) before its warp runs
// the pair body over them, and the candidates a lane tests in one step
constexpr int kChunk = 32, kStep = 4;
constexpr unsigned kFull = 0xffffffffu;

// The square of the largest support over the type pairs, h or, with
// species, the larger of h and cutc (1 / the tables' inverses), with a
// margin far above the rounding of r, r^2 and the inverses: every pair a
// body sums from passes the test; a pair just outside passes too and its
// body skips it, as the body skipped every candidate outside its support.
__device__ __forceinline__ float support_cut2(const float* __restrict__ tab,
                                              const float* __restrict__ stab,
                                              int ns, int tt) {
  float cut = 0.f;
  for (int p = 0; p < tt; ++p) {
    cut = fmaxf(cut, 1.f / __ldg(tab + tv::T_INVH * tt + p));
    if (ns > 0) cut = fmaxf(cut, 1.f / __ldg(stab + tv::S_INVHC * tt + p));
  }
  return cut * cut * 1.001f;
}

// The walk of the lane on slot s (s < 0: no slot; such a lane takes no
// step but keeps its warp's votes) over the candidates j != s of the 3^DIM
// stencil cells of its cell in the order (ox, oy, oz, slot) — a wrapping
// axis (bit a of wrap.axes) taken modulo its cell count, any other skipped
// past its ends, a cell's slots up to its first empty one (lead) — in two
// phases a warp runs in lockstep: the support test (the pair offset with
// its minimum image against cut2), which appends a passing j to the lane's
// list in shared memory (buf, stride kThreads), and, whenever a lane's
// list could not take another step and once at the end, pair(k) over
// every lane's list in order.  So pair sees the j a body sums, in the
// walk's order.  In 2D, nz is 1.
template <int DIM, class Pair>
__device__ __forceinline__ void walk(const float* __restrict__ pf, long long m,
                                     long long s, const int* __restrict__ lead,
                                     int nx, int ny, int nz,
                                     const tv::Wrap& wrap, float cut2,
                                     const float* xi, int* buf, Pair&& pair) {
  static_assert(DIM == 2 || DIM == 3, "a 2D or 3D stencil");
  constexpr int kCells = DIM == 3 ? 27 : 9;
  const int nc = nx * ny * nz;
  int cx = 0, cy = 0, cz = 0;
  if (s >= 0) {
    const int c = (int)(s % nc);
    cz = c % nz;
    cy = (c / nz) % ny;
    cx = c / nz / ny;
  }
  int nb = 0, cj = 0, j = 0, jend = 0;
  // step to the next stencil cell that holds a slot; false past the last
  auto next_cell = [&]() {
    while (nb < kCells) {
      const int o = nb++;
      int sx, sy, sz = cz;
      if constexpr (DIM == 3) {
        sx = cx + o / 9 - 1, sy = cy + (o / 3) % 3 - 1, sz = cz + o % 3 - 1;
      } else {
        sx = cx + o / 3 - 1, sy = cy + o % 3 - 1;
      }
      if (wrap.axes & 1) {
        sx = tv::wrap_cell(sx, nx);
      } else if (sx < 0 || sx >= nx) {
        continue;
      }
      if (wrap.axes & 2) {
        sy = tv::wrap_cell(sy, ny);
      } else if (sy < 0 || sy >= ny) {
        continue;
      }
      if constexpr (DIM == 3) {
        if (wrap.axes & 4) {
          sz = tv::wrap_cell(sz, nz);
        } else if (sz < 0 || sz >= nz) {
          continue;
        }
      }
      cj = (sx * ny + sy) * nz + sz;
      jend = __ldg(lead + cj);
      j = 0;
      if (jend > 0) return true;
    }
    return false;
  };
  int n = 0;  // entries in this lane's list
  auto flush = [&]() {
    const int most = __reduce_max_sync(kFull, n);
    for (int q = 0; q < most; ++q)
      if (q < n) pair((long long)buf[q * kThreads]);
    n = 0;
  };
  bool live = s >= 0 && next_cell();
  while (__any_sync(kFull, live)) {
    if (live) {
      // up to kStep candidates of this cell: their loads first, then tests
      const int cnt = min(kStep, jend - j);
      float xj[kStep][3];
#pragma unroll
      for (int u = 0; u < kStep; ++u)
#pragma unroll
        for (int a = 0; a < 3; ++a)
          xj[u][a] = u < cnt ? tv::ld(pf, m, tv::R_X + a,
                                      (long long)(j + u) * nc + cj)
                             : 0.f;
#pragma unroll
      for (int u = 0; u < kStep; ++u) {
        const long long k = (long long)(j + u) * nc + cj;
        if (u < cnt && k != s) {  // k == s: the self pair (j == i)
          float d[3];
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            d[a] = xi[a] - xj[u][a];
            if (wrap.axes & (1 << a)) d[a] = tv::min_image(d[a], wrap.l[a]);
          }
          if (d[0] * d[0] + d[1] * d[1] + d[2] * d[2] < cut2)
            buf[(n++) * kThreads] = (int)k;
        }
      }
      j += cnt;
      if (j == jend) live = next_cell();
    }
    // a list never passes kChunk: a step adds at most kStep entries
    if (__any_sync(kFull, n > kChunk - kStep)) flush();
  }
  flush();
}

// the accumulators of slot t, zero where the slot is empty: every slot of
// out is written, an empty one by the thread of its own index
template <int A>
__device__ __forceinline__ void zero_if_empty(const float* __restrict__ pf,
                                              float* __restrict__ out,
                                              long long m, long long t) {
  if (t < m && tv::ld(pf, m, tv::R_VALID, t) == 0.f) {
#pragma unroll
    for (int a = 0; a < A; ++a) out[(long long)a * m + t] = 0.f;
  }
}

}  // namespace walk
