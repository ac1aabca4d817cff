// The 2D pass-A kernel template of K1 (csrc/pass_a_2d.cu), one thread per
// (slot i, cell c).
//
// It replaces the grouped branch of sph_bvf_tpu/ops/pair_pallas.py
// (`_call_padded`).  For every valid slot i a thread sums ops/pair.py
// `_pass_a_offset` over the valid j of the 3x3 stencil cells, j != i,
// offsets in the order (ox, oy) = (-1, -1), (-1, 0), ..., (1, 1) and slots
// j = 0..cap-1 within each, with one of two pair bodies:
// - the transport-velocity pair of csrc/pass_a_tv.cuh (`tv_kernel`): the
//   pressure switch, fixed BVF walls, no periodic axis; template FILTER,
//   NS, THERMAL (20 instantiations);
// - the full body of csrc/pass_a_mech.cuh (`mech_kernel`, K2's and K3's):
//   every pair style, XSPH, free and elastic solids, `ampl_damp` and the
//   per-particle G0, solid-free scenes, periodic x and y of at least 3
//   cells (the neighbour cell wraps by index, the offset takes the minimum
//   image); template FILTER, ELASTIC, NS, THERMAL (40).
// The j rows come from the template's `Src`, `Neighbour`: the one pack, at
// the neighbour cell c + (ox, oy); an offset past a walled edge is skipped,
// one past a periodic edge wraps.  K4 (csrc/pass_a_2d_preshift.cu) sums
// the same pairs in the same order with the same bodies from a window it
// stages in shared memory, bitwise this result.  The plain PyTorch version
// of both is sph_bvf_tpu_torch/ops/pair.py `_pass_a_plain`.
//
// Flat cell c = cx * ny + cy; the grid has one cell along z.  An invalid
// slot j is skipped, not taken as the end of its cell: the grouped grids
// need not hold their slots compacted.

#pragma once

#include <cuda_runtime.h>

#include "pass_a_mech.cuh"

namespace pa2d {

constexpr int kThreads = 128;

// K1's j rows: the neighbour cell of i's own pack.  WRAP: the periodic axes
// of `wrap` (bit 0 x, bit 1 y) wrap by index; without it every axis is
// walled.
template <bool WRAP>
struct Neighbour {
  int wrap;

  __device__ __forceinline__ bool axis(int c, int o, int n, int bit,
                                       int& cj) const {
    cj = c + o;
    if constexpr (WRAP) {
      if (wrap & bit) {
        cj = tv::wrap_cell(cj, n);
        return true;
      }
    }
    return cj >= 0 && cj < n;
  }
  __device__ __forceinline__ const float* pack(const float* pf, int,
                                               int) const {
    return pf;
  }
  // k == s only at the zero offset: a wrapping axis has at least 3 cells
  __device__ __forceinline__ bool self(int, int, long long k,
                                       long long s) const {
    return k == s;
  }
};

// Call pair(pj, k) for every valid slot k != s of the 3x3 stencil cells of
// cell (cx, cy), pj the rows slot k is read from (pf: i's pack).
template <class Src, class Pair>
__device__ __forceinline__ void for_each_j(const Src& src,
                                           const float* __restrict__ pf,
                                           long long m, long long s, int cap,
                                           int nx, int ny, int cx, int cy,
                                           Pair&& pair) {
  const int nc = nx * ny;
  for (int ox = -1; ox <= 1; ++ox) {
    int cxj;
    if (!src.axis(cx, ox, nx, 1, cxj)) continue;
    for (int oy = -1; oy <= 1; ++oy) {
      int cyj;
      if (!src.axis(cy, oy, ny, 2, cyj)) continue;
      const float* __restrict__ pj = src.pack(pf, ox, oy);
      const int cj = cxj * ny + cyj;
      for (int j = 0; j < cap; ++j) {
        const long long k = (long long)j * nc + cj;
        if (src.self(ox, oy, k, s)) continue;  // the self pair (j == i)
        if (tv::ld(pj, m, tv::R_VALID, k) == 0.f) continue;
        pair(pj, k);
      }
    }
  }
}

// the transport-velocity pair: pack PF_ROWS (pf: i's rows), accumulators
// ACC_ROWS
template <class Src, bool FILTER, int NS, bool THERMAL>
__global__ void __launch_bounds__(kThreads) tv_kernel(
    const float* __restrict__ pf, Src src, const float* __restrict__ tab,
    const float* __restrict__ stab, float* __restrict__ out,
    const float* __restrict__ dt, const int* __restrict__ step,
    const long long* __restrict__ key, unsigned rng_seed, float neg4kb,
    int ntypes, int advect, int cap, int nx, int ny) {
  constexpr int A = tv::kAccs<FILTER, NS>;
  const int nc = nx * ny;
  const long long m = (long long)cap * nc;  // slots per field row
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= m) return;
  const int c = (int)(s % nc);
  const int cx = c / ny, cy = c - cx * ny;
  const int tt = ntypes * ntypes;

  float acc[A];
#pragma unroll
  for (int a = 0; a < A; ++a) acc[a] = 0.f;

  if (tv::ld(pf, m, tv::R_VALID, s) != 0.f) {
    const tv::ISide<NS> I = tv::load_i<FILTER, NS, THERMAL>(pf, m, s, ntypes);
    tv::Noise noise{};
    if constexpr (THERMAL) noise = tv::load_noise(dt, step, key, rng_seed, neg4kb);
    const tv::Wrap nowrap{};  // no periodic axis
    for_each_j(src, pf, m, s, cap, nx, ny, cx, cy,
               [&](const float* __restrict__ pj, long long k) {
                 tv::add_pair<FILTER, NS, THERMAL, 2>(pj, m, k, tab, stab,
                                                      advect, tt, noise, nowrap,
                                                      I, acc);
               });
  }
#pragma unroll
  for (int a = 0; a < A; ++a) out[(long long)a * m + s] = acc[a];
}

// the full body: pack MECH_PF_ROWS, accumulators MECH_ACC_ROWS; flags:
// mech::F_*; wrap: the periodic axes and their extents
template <class Src, bool FILTER, bool ELASTIC, int NS, bool THERMAL>
__global__ void __launch_bounds__(kThreads) mech_kernel(
    const float* __restrict__ pf, Src src, const float* __restrict__ tab,
    const float* __restrict__ stab, float* __restrict__ out,
    const float* __restrict__ dt, const int* __restrict__ step,
    const long long* __restrict__ key, unsigned rng_seed, float neg4kb,
    int ntypes, int cap, int nx, int ny, int flags, int advect, tv::Wrap wrap,
    float ampl) {
  constexpr int A = mech::Rows<FILTER, ELASTIC, NS>::A;
  const int nc = nx * ny;
  const long long m = (long long)cap * nc;  // slots per field row
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= m) return;
  const int c = (int)(s % nc);
  const int cx = c / ny, cy = c - cx * ny;

  float acc[A];
#pragma unroll
  for (int a = 0; a < A; ++a) acc[a] = 0.f;

  if (tv::ld(pf, m, mech::R_VALID, s) != 0.f) {
    mech::Ctx ctx = mech::make_ctx(ntypes, flags, advect, ampl, wrap);
    if constexpr (THERMAL) ctx.noise = tv::load_noise(dt, step, key, rng_seed, neg4kb);
    const auto I = mech::load_i<FILTER, ELASTIC, NS, THERMAL>(pf, m, s, ctx);
    for_each_j(src, pf, m, s, cap, nx, ny, cx, cy,
               [&](const float* __restrict__ pj, long long k) {
                 mech::add_pair<FILTER, ELASTIC, NS, THERMAL, 2>(
                     pj, m, k, tab, stab, ctx, I, acc);
               });
  }
#pragma unroll
  for (int a = 0; a < A; ++a) out[(long long)a * m + s] = acc[a];
}

// Launch the instantiation of (body, filter, elastic, ns, thermal) over a
// [cap, nx * ny] grid with i's rows at `pf` and j's from `src`: body 0 the
// transport-velocity pair (elastic 0, no periodic axis; flags and ampl
// unread), 1 the full body.  Returns the launch's cudaError_t.
template <class TvSrc, class MechSrc>
int launch(const float* pf, TvSrc tv_src, MechSrc mech_src, const float* tab,
           const float* stab, float* out, int ntypes, int ns, int advect,
           int cap, int nx, int ny, int body, int filter, int elastic,
           int flags, int wrap, float lx, float ly, float lz, float ampl,
           int thermal, const float* dt, const int* step, const long long* key,
           unsigned rng_seed, float neg4kb, cudaStream_t stream) {
  // a wrapping axis of fewer than 3 cells would reach one cell twice
  if (((wrap & 1) && nx < 3) || ((wrap & 2) && ny < 3) || (wrap & 4))
    return (int)cudaErrorInvalidValue;
  if (body == 0 && (elastic || wrap)) return (int)cudaErrorInvalidValue;
  const long long m = (long long)cap * nx * ny;
  if (m == 0) return 0;
  const unsigned blocks = (unsigned)((m + kThreads - 1) / kThreads);
  if (body == 0) {
    switch (tv::variant_key(filter != 0, ns, thermal != 0)) {
#define X(F, N, T)                                                         \
  case tv::variant_key(F, N, T):                                           \
    tv_kernel<TvSrc, F, N, T><<<blocks, kThreads, 0, stream>>>(            \
        pf, tv_src, tab, stab, out, dt, step, key, rng_seed, neg4kb,       \
        ntypes, advect, cap, nx, ny);                                      \
    break;
      TV_FOR_EACH_VARIANT(X)
#undef X
      default:
        return (int)cudaErrorInvalidValue;  // ns beyond tv::kMaxSpecies
    }
    return (int)cudaGetLastError();
  }
  const tv::Wrap w{wrap, {lx, ly, lz}};
  switch (mech::variant_key(filter != 0, elastic != 0, ns, thermal != 0)) {
#define X(F, E, N, T)                                                       \
  case mech::variant_key(F, E, N, T):                                       \
    mech_kernel<MechSrc, F, E, N, T><<<blocks, kThreads, 0, stream>>>(      \
        pf, mech_src, tab, stab, out, dt, step, key, rng_seed, neg4kb,      \
        ntypes, cap, nx, ny, flags, advect, w, ampl);                       \
    break;
    MECH_FOR_EACH_VARIANT(X)
#undef X
    default:
      return (int)cudaErrorInvalidValue;  // ns beyond tv::kMaxSpecies
  }
  return (int)cudaGetLastError();
}

// registers per thread and local-memory (spill) bytes per thread of the
// (body, filter, elastic, ns, thermal) instantiation, as the runtime
// reports them
template <class TvSrc, class MechSrc>
int attributes(int body, int filter, int elastic, int ns, int thermal,
               int* regs, int* local_bytes) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaErrorInvalidValue;
  if (body == 0 && !elastic) {
    switch (tv::variant_key(filter != 0, ns, thermal != 0)) {
#define X(F, N, T)                                                         \
  case tv::variant_key(F, N, T):                                           \
    err = cudaFuncGetAttributes(&attr, tv_kernel<TvSrc, F, N, T>);         \
    break;
      TV_FOR_EACH_VARIANT(X)
#undef X
      default:
        break;
    }
  } else if (body == 1) {
    switch (mech::variant_key(filter != 0, elastic != 0, ns, thermal != 0)) {
#define X(F, E, N, T)                                                      \
  case mech::variant_key(F, E, N, T):                                      \
    err = cudaFuncGetAttributes(&attr, mech_kernel<MechSrc, F, E, N, T>);  \
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

}  // namespace pa2d
