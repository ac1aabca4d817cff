// K3 — 3D pass A of the SPH-BVF pair physics, one thread per (slot i, cell c).
//
// Replaces sph_bvf_tpu/ops/pair_pallas.py `_call_tiled3d` (the TPU kernel that
// carries every 3D grid: a (x-plane, yz-block) grid over halo planes, with
// i/j tiles gated by block and neighbourhood occupancy, evaluating the shared
// pair body `_pass_a_offset` per offset).  For every valid slot i it sums
// ops/pair.py `_pass_a_offset` over the valid j of the 27 stencil cells,
// j != i, with one of two pair bodies.  The full one, with its packed rows
// and accumulator rows, is csrc/pass_a_mech.cuh, which K2 shares: the
// transport-velocity (pressure switch) or mechanics (symmetric pressure)
// force, XSPH, BVF walls, free solids with the Pereira viscosity, elastic
// solids (AS, f_dev and the Jaumann dS), solid-free scenes, the fsi pair
// style (density diffusion, G0 softened per particle).  The configurations
// K1's transport-velocity pair serves (fixed walls, none of the above; the
// 3D cavities) run that pair instead (csrc/pass_a_tv.cuh, with K1's rows):
// it holds fewer values live across the j loop, so more warps fit an SM,
// and the walled cavity's pass A took 1.3x as long through the full body
// (PERF.md).  Both take the Shepard-filter accumulators (FILTER), NS
// continuum species (the C rows in, the flux Q out) and the SDPD thermal
// noise (THERMAL; six normals per pair in 3D), on walls or periodic axes
// (x, y, z in any combination, at least 3 cells each).  The plain PyTorch
// version is sph_bvf_tpu_torch/ops/pair.py `_pass_a_plain`.
//
// What bounds it on an H100: at the 1.19M-particle cavity (N=100: cap 38,
// 27 particles per cell, 46,656 cells) each valid i walks 27 cells x ~27
// occupied slots = ~729 candidates, of which ~65 lie inside the support
// (h = 2.5 lattice spacings) and cost ~130 flops each.  The state is read
// from HBM about once per call (neighbouring threads' 27-cell windows
// overlap, so the repeated loads hit L1/L2), so the bound is the issue rate
// of the candidate checks, not HBM bandwidth.  The elastic terms (dS ~110
// flops a pair, f_art and f_dev ~40 more) run only for the solid pairs
// their exact gates let through.  Design: the TPU kernel's structure (VMEM
// windows over halo planes, occupancy scalars) has no counterpart here.
// Every rebin leaves each cell's valid slots compacted at 0..occ-1 and
// validity does not change until the next rebin, so a thread on an empty
// slot writes zeros and stops and the j loop over a neighbour cell stops at
// its first empty slot — the occupancy gates as exact loop bounds, on a
// mixed lattice too (the FSI beam's finer lattice fills its cells more).
// Neighbouring threads take neighbouring cells of one slot row, so every
// load of the [F, cap, NC] pack is coalesced; walls are bounds checks on
// each axis (no halo buffer); accumulators stay in registers.  The f32 sums
// run in another order than the plain path's per-offset sums.  In the full
// body ELASTIC, NS (0..4) and THERMAL are template parameters (40
// instantiations, as K2) and the pressure switch, XSPH, free solids,
// solid-free scenes and the per-particle G0 runtime bits (mech::F_*); the
// transport-velocity body has FILTER, NS and THERMAL (20, as K1).
//
// Periodic axes (replaces the TPU kernel's wrapped halo plane for x and its
// ghost columns for y and z, pair_pallas.py:1147-1152, 1253-1261): a
// runtime bit per axis (`wrap`, tv::Wrap), so no template variant is added.
// On a wrapping axis the neighbour cell index is taken modulo n instead of
// skipped — with n >= 3 the three offsets reach three distinct cells, so no
// pair is counted twice (the wrapper refuses fewer) — and every pair offset
// on that axis takes the minimum image d - L rint(d / L) (tv::min_image:
// unfused, rounded half to even, with L = hi - lo rounded to f32, as
// ops/pair.py `_pair_delta`).  The noise is keyed by the tags, so a pair
// across the seam draws what it draws elsewhere.
//
// Flat cell c = (cx * ny + cy) * nz + cz (Geometry.strides, z minor).

#include <cuda_runtime.h>

#include "pass_a_mech.cuh"

namespace {

constexpr int kThreads = 128;

// Call pair(k) for every valid slot k != s of the 27 stencil cells of cell
// (cx, cy, cz), a wrapping axis (bit a of wrap) taken modulo its cell count
// and any other skipped past its ends.
template <class Pair>
__device__ __forceinline__ void for_each_neighbour(const float* __restrict__ pf,
                                                   long long m, long long s,
                                                   int cap, int nx, int ny,
                                                   int nz, int cx, int cy,
                                                   int cz, int wrap, Pair&& pair) {
  const int nc = nx * ny * nz;
  const bool wx = wrap & 1, wy = wrap & 2, wz = wrap & 4;
  for (int ox = -1; ox <= 1; ++ox) {
    int sx = cx + ox;
    if (wx) {
      sx = tv::wrap_cell(sx, nx);
    } else if (sx < 0 || sx >= nx) {
      continue;
    }
    for (int oy = -1; oy <= 1; ++oy) {
      int sy = cy + oy;
      if (wy) {
        sy = tv::wrap_cell(sy, ny);
      } else if (sy < 0 || sy >= ny) {
        continue;
      }
      for (int oz = -1; oz <= 1; ++oz) {
        int sz = cz + oz;
        if (wz) {
          sz = tv::wrap_cell(sz, nz);
        } else if (sz < 0 || sz >= nz) {
          continue;
        }
        const int cj = (sx * ny + sy) * nz + sz;
        for (int j = 0; j < cap; ++j) {
          const long long k = (long long)j * nc + cj;
          // compacted slots: the first empty one ends the cell
          if (tv::ld(pf, m, tv::R_VALID, k) == 0.f) break;
          if (k == s) continue;  // the self pair (zero offset, j == i)
          pair(k);
        }
      }
    }
  }
}

// the transport-velocity pair of csrc/pass_a_tv.cuh (K1's), for the
// configurations it serves: pack PF_ROWS, accumulators ACC_ROWS
template <bool FILTER, int NS, bool THERMAL>
__global__ void __launch_bounds__(kThreads) pass_a_3d_tv_kernel(
    const float* __restrict__ pf, const float* __restrict__ tab,
    const float* __restrict__ stab, float* __restrict__ out,
    const float* __restrict__ dt, const int* __restrict__ step,
    const long long* __restrict__ key, unsigned rng_seed, float neg4kb,
    int ntypes, int advect, int cap, int nx, int ny, int nz, tv::Wrap wrap) {
  constexpr int A = tv::kAccs<FILTER, NS>;
  const int nc = nx * ny * nz;
  const long long m = (long long)cap * nc;  // slots per field row
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= m) return;
  const int c = (int)(s % nc);
  const int cz = c % nz, cxy = c / nz;
  const int cy = cxy % ny, cx = cxy / ny;
  const int tt = ntypes * ntypes;

  float acc[A];
#pragma unroll
  for (int a = 0; a < A; ++a) acc[a] = 0.f;

  // slots at or above the cell's occupancy are invalid: nothing to sum
  if (tv::ld(pf, m, tv::R_VALID, s) != 0.f) {
    const tv::ISide<NS> I = tv::load_i<FILTER, NS, THERMAL>(pf, m, s, ntypes);
    tv::Noise noise{};
    if constexpr (THERMAL) noise = tv::load_noise(dt, step, key, rng_seed, neg4kb);
    for_each_neighbour(pf, m, s, cap, nx, ny, nz, cx, cy, cz, wrap.axes,
                       [&](long long k) {
                         tv::add_pair<FILTER, NS, THERMAL, 3>(
                             pf, m, k, tab, stab, advect, tt, noise, wrap, I, acc);
                       });
  }
#pragma unroll
  for (int a = 0; a < A; ++a) out[(long long)a * m + s] = acc[a];
}

// the full pair body of csrc/pass_a_mech.cuh (K2's): pack MECH_PF_ROWS,
// accumulators MECH_ACC_ROWS
template <bool FILTER, bool ELASTIC, int NS, bool THERMAL>
__global__ void __launch_bounds__(kThreads) pass_a_3d_kernel(
    const float* __restrict__ pf, const float* __restrict__ tab,
    const float* __restrict__ stab, float* __restrict__ out,
    const float* __restrict__ dt, const int* __restrict__ step,
    const long long* __restrict__ key, unsigned rng_seed, float neg4kb,
    int ntypes, int cap, int nx, int ny, int nz, int flags, int advect,
    tv::Wrap wrap, float ampl) {
  constexpr int A = mech::Rows<FILTER, ELASTIC, NS>::A;
  const int nc = nx * ny * nz;
  const long long m = (long long)cap * nc;  // slots per field row
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= m) return;
  const int c = (int)(s % nc);
  const int cz = c % nz, cxy = c / nz;
  const int cy = cxy % ny, cx = cxy / ny;

  float acc[A];
#pragma unroll
  for (int a = 0; a < A; ++a) acc[a] = 0.f;

  // slots at or above the cell's occupancy are invalid: nothing to sum
  if (tv::ld(pf, m, mech::R_VALID, s) != 0.f) {
    mech::Ctx ctx = mech::make_ctx(ntypes, flags, advect, ampl, wrap);
    if constexpr (THERMAL) ctx.noise = tv::load_noise(dt, step, key, rng_seed, neg4kb);
    const auto I = mech::load_i<FILTER, ELASTIC, NS, THERMAL>(pf, m, s, ctx);
    for_each_neighbour(pf, m, s, cap, nx, ny, nz, cx, cy, cz, wrap.axes,
                       [&](long long k) {
                         mech::add_pair<FILTER, ELASTIC, NS, THERMAL, 3>(
                             pf, m, k, tab, stab, ctx, I, acc);
                       });
  }
#pragma unroll
  for (int a = 0; a < A; ++a) out[(long long)a * m + s] = acc[a];
}

}  // namespace

// body: 0 the transport-velocity pair of csrc/pass_a_tv.cuh (elastic 0;
// flags and ampl unread), 1 the full body of csrc/pass_a_mech.cuh; filter,
// elastic, thermal: the template switches; ns: the species count (stab is
// read only when ns > 0); flags: mech::F_*; advect:
// PairConfig.species_advection; wrap: bit a set when axis a is periodic
// (with more than one cell), lx, ly, lz the extents hi - lo in f32 (read on
// the wrapping axes only); ampl: PairConfig.ampl_damp; the noise's inputs:
// as csrc/pass_a_2d.cu
extern "C" int pass_a_3d(const float* pf, const float* tab, const float* stab,
                        float* out, int ntypes, int ns, int advect, int cap,
                        int nx, int ny, int nz, int body, int filter,
                        int elastic, int flags, int wrap, float lx, float ly,
                        float lz, float ampl, int thermal, const float* dt,
                        const int* step, const long long* key,
                        unsigned rng_seed, float neg4kb, cudaStream_t stream) {
  // a wrapping axis of fewer than 3 cells would reach one cell twice
  if (((wrap & 1) && nx < 3) || ((wrap & 2) && ny < 3) || ((wrap & 4) && nz < 3))
    return (int)cudaErrorInvalidValue;
  if (body == 0 && elastic) return (int)cudaErrorInvalidValue;
  const long long m = (long long)cap * nx * ny * nz;
  if (m == 0) return 0;
  const tv::Wrap w{wrap, {lx, ly, lz}};
  const unsigned blocks = (unsigned)((m + kThreads - 1) / kThreads);
  if (body == 0) {
    switch (tv::variant_key(filter != 0, ns, thermal != 0)) {
#define X(F, N, T)                                                         \
  case tv::variant_key(F, N, T):                                           \
    pass_a_3d_tv_kernel<F, N, T><<<blocks, kThreads, 0, stream>>>(         \
        pf, tab, stab, out, dt, step, key, rng_seed, neg4kb, ntypes,       \
        advect, cap, nx, ny, nz, w);                                       \
    break;
      TV_FOR_EACH_VARIANT(X)
#undef X
      default:
        return (int)cudaErrorInvalidValue;  // ns beyond tv::kMaxSpecies
    }
    return (int)cudaGetLastError();
  }
  switch (mech::variant_key(filter != 0, elastic != 0, ns, thermal != 0)) {
#define X(F, E, N, T)                                                     \
  case mech::variant_key(F, E, N, T):                                     \
    pass_a_3d_kernel<F, E, N, T><<<blocks, kThreads, 0, stream>>>(        \
        pf, tab, stab, out, dt, step, key, rng_seed, neg4kb, ntypes, cap, \
        nx, ny, nz, flags, advect, w, ampl);                              \
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
extern "C" int pass_a_3d_attributes(int body, int filter, int elastic, int ns,
                                    int thermal, int* regs, int* local_bytes) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaErrorInvalidValue;
  if (body == 0 && !elastic) {
    switch (tv::variant_key(filter != 0, ns, thermal != 0)) {
#define X(F, N, T)                                                      \
  case tv::variant_key(F, N, T):                                        \
    err = cudaFuncGetAttributes(&attr, pass_a_3d_tv_kernel<F, N, T>);   \
    break;
      TV_FOR_EACH_VARIANT(X)
#undef X
      default:
        break;
    }
  } else if (body == 1) {
    switch (mech::variant_key(filter != 0, elastic != 0, ns, thermal != 0)) {
#define X(F, E, N, T)                                                  \
  case mech::variant_key(F, E, N, T):                                  \
    err = cudaFuncGetAttributes(&attr, pass_a_3d_kernel<F, E, N, T>);  \
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

extern "C" const char* sph_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
