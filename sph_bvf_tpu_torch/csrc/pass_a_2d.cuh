// The grouped 2D pass-A kernels of K1 (csrc/pass_a_2d.cu; K4, the entry
// point PairConfig.preshift_window routes to, launches them too), one
// thread per (slot i, cell c) of a tile of cells whose 3x3 window a block
// stages in shared memory (csrc/window_2d.cuh).
//
// They replace the grouped branch of sph_bvf_tpu/ops/pair_pallas.py
// (`_call_padded`, pair_pallas.py:308) and its pre-shifted variant
// (`_call_preshift`).  For every valid slot i a thread sums ops/pair.py
// `_pass_a_offset` over the valid j of the 3x3 stencil cells, j != i,
// offsets in the order (ox, oy) = (-1, -1), (-1, 0), ..., (1, 1) and slots
// j = 0 up to the cell's tail within each, with one of two pair bodies:
// - the transport-velocity pair of csrc/pass_a_tv.cuh
//   (`window_tv_kernel`): the pressure switch, fixed BVF walls, no
//   periodic axis; template FILTER, NS, THERMAL (20 instantiations);
// - the full body of csrc/pass_a_mech.cuh (`window_mech_kernel`, K2's
//   and K3's): every pair style, XSPH, free and elastic solids,
//   `ampl_damp` and the per-particle G0, solid-free scenes, periodic x and
//   y of at least 3 cells (the window wraps by index, the offset takes the
//   minimum image); template FILTER, ELASTIC, NS, THERMAL (40).
// i's rows come from the pack at the thread's own slot, j's from the window
// (tv::Shared).  The plain PyTorch version is sph_bvf_tpu_torch/ops/pair.py
// `_pass_a_plain`.
//
// What bounds it on an H100: instruction throughput.  A pair inside the
// support costs ~130 flops and ~15 loads from shared memory; the thermal
// noise adds ~180 integer operations (the hash) and three Box-Muller
// normals.  HBM carries the pack about twice (the window's halo of a 4 x 8
// tile is 1.9x its cells).  Design:
// - the window in shared memory: read from the pack through L1/L2, the
//   blocks of one slot row would reread the same neighbour cells for every
//   slot (~26x the pack's bytes from L2 at the flagship); a block reads its
//   window once, with cp.async, and its loads hit shared memory;
// - each neighbour cell walked to its tail (one past its last valid slot,
//   ops/pair_cuda.py `tail_index`), not to cap: the flagship holds 9
//   particles in cells of cap 14, so a walk to cap would test ~45 empty
//   slots of an i's 126 candidates.  An invalid slot below the tail is
//   still skipped, so the terms and their order are a walk to cap's on any
//   layout, compacted or not, and so are the sums.  The window is staged
//   only to each cell's tail and is BT slots deep, BT its largest tail;
//   the wrapper sizes the shared memory by the grid's largest tail, so a
//   sparse grid fits more blocks on an SM;
// - a warp takes 32 consecutive (slot, tile cell) pairs, slot-major: with a
//   32-cell tile its lanes are one slot row of neighbouring cells, with
//   near-equal offsets on a lattice, so they pass and fail the support test
//   together and the body runs per candidate.  The support test apart from
//   the body (as K2's and K3's walk, csrc/walk.cuh: the lanes collect their
//   in-support j first) was 27-33% slower on the flagship and the
//   mechanics cavity (PERF.md);
// - the tile (ops/pair_cuda.py `k4_tile`, 4 x 8 cells for both bodies):
//   the window of F rows x BT slots x (TX + 2)(TY + 2) cells must fit the
//   227 KB a block can hold less the kernel's static shared memory
//   (win2d::kMaxShared), and its size sets how many blocks share an SM.
//   Ragged edge tiles (nx, ny not multiples of the tile) leave the lanes
//   past the grid idle;
// - an empty slot (past its cell's tail, or invalid) writes zeros.

#pragma once

#include <cuda_runtime.h>

#include "window_2d.cuh"

namespace pa2d {

using win2d::kThreads;

// the transport-velocity pair (walls only): pack PF_ROWS (pf), accumulators
// ACC_ROWS; tails: i32 [nx * ny]
template <bool FILTER, int NS, bool THERMAL>
__global__ void __launch_bounds__(kThreads) window_tv_kernel(
    const float* __restrict__ pf, const int* __restrict__ tails,
    const float* __restrict__ tab, const float* __restrict__ stab,
    float* __restrict__ out, const float* __restrict__ dt,
    const int* __restrict__ step, const long long* __restrict__ key,
    unsigned rng_seed, float neg4kb, int ntypes, int advect, int cap, int nx,
    int ny, int rows, int tx, int ty) {
  extern __shared__ float win[];
  __shared__ int tail_s[kThreads];
  constexpr int A = tv::kAccs<FILTER, NS>;
  const long long m = (long long)cap * nx * ny;  // slots per field row
  win2d::Tile T = win2d::tile_of_block(ny, tx, ty);
  win2d::stage(win, tail_s, pf, tails, rows, cap, nx, ny, 0, T);
  const int tt = ntypes * ntypes;
  tv::Noise noise{};
  if constexpr (THERMAL) noise = tv::load_noise(dt, step, key, rng_seed, neg4kb);
  const tv::Wrap nowrap{};  // no periodic axis
  win2d::for_each_slot(T, cap, nx, ny, [&](int i, int w, long long s, bool live) {
    float acc[A];
#pragma unroll
    for (int a = 0; a < A; ++a) acc[a] = 0.f;
    const bool have =
        live && i < tail_s[w] && tv::ld(pf, m, tv::R_VALID, s) != 0.f;
    tv::ISide<NS> I;
    auto pair = [&](int k) {
      tv::add_pair<FILTER, NS, THERMAL, 2, tv::Shared>(
          win, T.ms, k, tab, stab, advect, tt, noise, nowrap, I, acc);
    };
    if (have) {
      I = tv::load_i<FILTER, NS, THERMAL>(pf, m, s, ntypes);
      win2d::for_each_j(win, tail_s, T, i, w, pair);
    }
    if (live) {
#pragma unroll
      for (int a = 0; a < A; ++a) out[(long long)a * m + s] = acc[a];
    }
  });
}

// the full body: pack MECH_PF_ROWS, accumulators MECH_ACC_ROWS; flags:
// mech::F_*; wrap: the periodic axes and their extents
template <bool FILTER, bool ELASTIC, int NS, bool THERMAL>
__global__ void __launch_bounds__(kThreads) window_mech_kernel(
    const float* __restrict__ pf, const int* __restrict__ tails,
    const float* __restrict__ tab, const float* __restrict__ stab,
    float* __restrict__ out, const float* __restrict__ dt,
    const int* __restrict__ step, const long long* __restrict__ key,
    unsigned rng_seed, float neg4kb, int ntypes, int cap, int nx, int ny,
    int rows, int tx, int ty, int flags, int advect, tv::Wrap wrap,
    float ampl) {
  extern __shared__ float win[];
  __shared__ int tail_s[kThreads];
  constexpr int A = mech::Rows<FILTER, ELASTIC, NS>::A;
  const long long m = (long long)cap * nx * ny;  // slots per field row
  win2d::Tile T = win2d::tile_of_block(ny, tx, ty);
  win2d::stage(win, tail_s, pf, tails, rows, cap, nx, ny, wrap.axes, T);
  mech::Ctx ctx = mech::make_ctx(ntypes, flags, advect, ampl, wrap);
  if constexpr (THERMAL) ctx.noise = tv::load_noise(dt, step, key, rng_seed, neg4kb);
  win2d::for_each_slot(T, cap, nx, ny, [&](int i, int w, long long s, bool live) {
    float acc[A];
#pragma unroll
    for (int a = 0; a < A; ++a) acc[a] = 0.f;
    const bool have =
        live && i < tail_s[w] && tv::ld(pf, m, mech::R_VALID, s) != 0.f;
    mech::ISide<ELASTIC, NS> I;
    auto pair = [&](int k) {
      mech::add_pair<FILTER, ELASTIC, NS, THERMAL, 2, tv::Shared>(
          win, T.ms, k, tab, stab, ctx, I, acc);
    };
    if (have) {
      I = mech::load_i<FILTER, ELASTIC, NS, THERMAL>(pf, m, s, ctx);
      win2d::for_each_j(win, tail_s, T, i, w, pair);
    }
    if (live) {
#pragma unroll
      for (int a = 0; a < A; ++a) out[(long long)a * m + s] = acc[a];
    }
  });
}

// launch `kernel` with `shared` bytes of dynamic shared memory, allowed
// first where they pass the kernel's default (48 KB less its static shared
// memory)
template <typename... P, typename... Args>
int run(void (*kernel)(P...), unsigned blocks, int shared, cudaStream_t stream,
        Args... args) {
  const cudaError_t err = win2d::allow_shared(kernel, shared);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, kThreads, shared, stream>>>(args...);
  return (int)cudaGetLastError();
}

// Launch the instantiation of (body, filter, elastic, ns, thermal)
// over a [cap, nx * ny] grid in tiles of tx x ty cells: body 0 the
// transport-velocity pair (elastic 0, no periodic axis; flags and ampl
// unread), 1 the full body; tails: each cell's tail, bound: their largest
// (the window's depth the shared memory is sized for); rows: the pack's
// row count.  Returns the launch's cudaError_t.
inline int launch(const float* pf, const int* tails, const float* tab,
                  const float* stab, float* out, int ntypes, int ns,
                  int advect, int cap, int nx, int ny, int rows, int tx,
                  int ty, int bound, int body, int filter,
                  int elastic, int flags, int wrap, float lx, float ly,
                  float lz, float ampl, int thermal, const float* dt,
                  const int* step, const long long* key, unsigned rng_seed,
                  float neg4kb, cudaStream_t stream) {
  // a wrapping axis of fewer than 3 cells would reach one cell twice
  if (((wrap & 1) && nx < 3) || ((wrap & 2) && ny < 3) || (wrap & 4))
    return (int)cudaErrorInvalidValue;
  if (body == 0 && (elastic || wrap)) return (int)cudaErrorInvalidValue;
  const long long window = (long long)(tx + 2) * (ty + 2);
  const long long shared = window * rows * bound * (long long)sizeof(float);
  if (tx < 1 || ty < 1 || window > kThreads || bound < 0 || bound > cap ||
      shared > win2d::kMaxShared)
    return (int)cudaErrorInvalidValue;
  if ((long long)cap * nx * ny == 0) return 0;
  const unsigned blocks =
      (unsigned)(((nx + tx - 1) / tx) * (long long)((ny + ty - 1) / ty));
  if (body == 0) {
    switch (tv::variant_key(filter != 0, ns, thermal != 0)) {
#define X(F, N, T)                                                          \
  case tv::variant_key(F, N, T):                                            \
    return run(window_tv_kernel<F, N, T>, blocks, (int)shared,              \
               stream, pf, tails, tab, stab, out, dt, step, key, rng_seed,  \
               neg4kb, ntypes, advect, cap, nx, ny, rows, tx, ty);
      TV_FOR_EACH_VARIANT(X)
#undef X
      default:
        return (int)cudaErrorInvalidValue;  // ns beyond tv::kMaxSpecies
    }
  }
  const tv::Wrap w{wrap, {lx, ly, lz}};
  switch (mech::variant_key(filter != 0, elastic != 0, ns, thermal != 0)) {
#define X(F, E, N, T)                                                        \
  case mech::variant_key(F, E, N, T):                                        \
    return run(window_mech_kernel<F, E, N, T>, blocks, (int)shared,          \
               stream, pf, tails, tab, stab, out, dt, step, key, rng_seed,   \
               neg4kb, ntypes, cap, nx, ny, rows, tx, ty, flags, advect, w, \
               ampl);
    MECH_FOR_EACH_VARIANT(X)
#undef X
    default:
      return (int)cudaErrorInvalidValue;  // ns beyond tv::kMaxSpecies
  }
}

// registers per thread and local-memory (spill) bytes per thread of the
// (body, filter, elastic, ns, thermal) instantiation, as the runtime
// reports them
inline int attributes(int body, int filter, int elastic, int ns, int thermal,
                      int* regs, int* local_bytes) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaErrorInvalidValue;
  if (body == 0 && !elastic) {
    switch (tv::variant_key(filter != 0, ns, thermal != 0)) {
#define X(F, N, T)                                                          \
  case tv::variant_key(F, N, T):                                            \
    err = cudaFuncGetAttributes(&attr, window_tv_kernel<F, N, T>);          \
    break;
      TV_FOR_EACH_VARIANT(X)
#undef X
      default:
        break;
    }
  } else if (body == 1) {
    switch (mech::variant_key(filter != 0, elastic != 0, ns, thermal != 0)) {
#define X(F, E, N, T)                                                        \
  case mech::variant_key(F, E, N, T):                                        \
    err = cudaFuncGetAttributes(&attr, window_mech_kernel<F, E, N, T>);      \
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
