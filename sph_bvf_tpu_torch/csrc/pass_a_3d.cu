// K3 — 3D pass A of the SPH-BVF pair physics, one thread per valid slot i,
// the lanes of a warp on the slots of one cell.
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
// 3D cavities) and the solid-free scenes (the 3D vortex and blob: with no
// solid its artificial stress and BVF terms add exact zeros) run that pair
// instead (csrc/pass_a_tv.cuh, with K1's rows): it holds fewer values live
// across the j loop, so more warps fit an SM (the walled cavity's pass A
// took 1.3x as long through the full body; on the solid-free scenes the
// two bodies now take about the same time; PERF.md).  Both take the
// Shepard-filter accumulators (FILTER), NS continuum species (the C rows
// in, the flux Q out) and the SDPD thermal noise (THERMAL; six normals per
// pair in 3D), on walls or periodic axes (x, y, z in any combination, at
// least 3 cells each).  The plain PyTorch
// version is sph_bvf_tpu_torch/ops/pair.py `_pass_a_plain`.
//
// What bounds it on an H100: at the 1.19M-particle cavity (N=100: cap 38,
// 27 particles per cell, 46,656 cells) each valid i walks 27 cells x ~27
// occupied slots = ~729 candidates, of which ~65 lie inside the support
// (h = 2.5 lattice spacings) and cost ~130 flops each (the vortex: ~910
// and ~77).  The state is read from HBM about once per call (the j loads
// of one cell's neighbourhood hit L1/L2), so the bound is the issue rate
// of the candidate tests and of the pair bodies, not HBM bandwidth.  The
// elastic terms (dS ~110 flops a pair, f_art and f_dev ~40 more) run only
// for the solid pairs their exact gates let through.
//
// Design: the TPU kernel's structure (VMEM windows over halo planes,
// occupancy scalars) has no counterpart here.  The walk of csrc/walk.cuh
// (K2 shares it, over the 9-cell 2D stencil) keeps a warp's 32 lanes doing
// the same work: the lanes share a cell (ops/pair_cuda.py `walk_index`; no
// thread sits on an empty slot, 61% of the slots on the vortex), and the
// support test is apart from the body (only ~9-15% of the candidates lie
// inside the support: a lane queues the j inside the largest support, and
// the warp runs the body over every lane's queue in lockstep, in the walk's
// order).  The full body's output is bitwise a walk's that runs the body on
// every candidate (the 3D FSI beam, vortex and blob); the tv body's differs
// in drho and f by one rounding (nvcc contracts a multiply-add of them the
// other way; PERF.md).
// Walls are bounds checks on each axis (no halo buffer); accumulators stay
// in registers.  The f32 sums run in another order than the plain path's
// per-offset sums.  In the full body ELASTIC, NS (0..4) and THERMAL are
// template parameters (40 instantiations, as K2) and the pressure switch,
// XSPH, free solids, solid-free scenes and the per-particle G0 runtime bits
// (mech::F_*); the transport-velocity body has FILTER, NS and THERMAL (20,
// as K1).
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

#include "walk.cuh"

namespace {

using walk::kChunk;
using walk::kFull;
using walk::kThreads;

// the transport-velocity pair of csrc/pass_a_tv.cuh (K1's), for the
// configurations it serves: pack PF_ROWS, accumulators ACC_ROWS
template <bool FILTER, int NS, bool THERMAL>
__global__ void __launch_bounds__(kThreads) pass_a_3d_tv_kernel(
    const float* __restrict__ pf, const float* __restrict__ tab,
    const float* __restrict__ stab, float* __restrict__ out,
    const int* __restrict__ order, const int* __restrict__ lead,
    const float* __restrict__ dt, const int* __restrict__ step,
    const long long* __restrict__ key, unsigned rng_seed, float neg4kb,
    int ntypes, int advect, int cap, int nx, int ny, int nz, tv::Wrap wrap) {
  __shared__ int lists[kChunk * kThreads];
  constexpr int A = tv::kAccs<FILTER, NS>;
  const long long m = (long long)cap * nx * ny * nz;  // slots per field row
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  walk::zero_if_empty<A>(pf, out, m, t);
  const long long s = t < m ? __ldg(order + t) : -1;
  if (__all_sync(kFull, s < 0)) return;
  const int tt = ntypes * ntypes;

  float acc[A];
#pragma unroll
  for (int a = 0; a < A; ++a) acc[a] = 0.f;
  const tv::ISide<NS> I =
      tv::load_i<FILTER, NS, THERMAL>(pf, m, s < 0 ? 0 : s, ntypes);
  tv::Noise noise{};
  if constexpr (THERMAL) noise = tv::load_noise(dt, step, key, rng_seed, neg4kb);
  walk::walk<3>(pf, m, s, lead, nx, ny, nz, wrap,
                walk::support_cut2(tab, stab, NS, tt), I.x,
                lists + threadIdx.x, [&](long long k) {
                  tv::add_pair<FILTER, NS, THERMAL, 3>(
                      pf, m, k, tab, stab, advect, tt, noise, wrap, I, acc);
                });
  if (s < 0) return;
#pragma unroll
  for (int a = 0; a < A; ++a) out[(long long)a * m + s] = acc[a];
}

// the full pair body of csrc/pass_a_mech.cuh (K2's): pack MECH_PF_ROWS,
// accumulators MECH_ACC_ROWS
template <bool FILTER, bool ELASTIC, int NS, bool THERMAL>
__global__ void __launch_bounds__(kThreads) pass_a_3d_kernel(
    const float* __restrict__ pf, const float* __restrict__ tab,
    const float* __restrict__ stab, float* __restrict__ out,
    const int* __restrict__ order, const int* __restrict__ lead,
    const float* __restrict__ dt, const int* __restrict__ step,
    const long long* __restrict__ key, unsigned rng_seed, float neg4kb,
    int ntypes, int cap, int nx, int ny, int nz, int flags, int advect,
    tv::Wrap wrap, float ampl) {
  __shared__ int lists[kChunk * kThreads];
  constexpr int A = mech::Rows<FILTER, ELASTIC, NS>::A;
  const long long m = (long long)cap * nx * ny * nz;  // slots per field row
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  walk::zero_if_empty<A>(pf, out, m, t);
  const long long s = t < m ? __ldg(order + t) : -1;
  if (__all_sync(kFull, s < 0)) return;

  float acc[A];
#pragma unroll
  for (int a = 0; a < A; ++a) acc[a] = 0.f;
  mech::Ctx ctx = mech::make_ctx(ntypes, flags, advect, ampl, wrap);
  if constexpr (THERMAL) ctx.noise = tv::load_noise(dt, step, key, rng_seed, neg4kb);
  const auto I =
      mech::load_i<FILTER, ELASTIC, NS, THERMAL>(pf, m, s < 0 ? 0 : s, ctx);
  walk::walk<3>(pf, m, s, lead, nx, ny, nz, wrap,
                walk::support_cut2(tab, stab, NS, ctx.tt), I.x,
                lists + threadIdx.x, [&](long long k) {
                  mech::add_pair<FILTER, ELASTIC, NS, THERMAL, 3>(
                      pf, m, k, tab, stab, ctx, I, acc);
                });
  if (s < 0) return;
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
                        int nx, int ny, int nz, const int* order,
                        const int* lead, int body, int filter,
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
        pf, tab, stab, out, order, lead, dt, step, key, rng_seed, neg4kb,  \
        ntypes, advect, cap, nx, ny, nz, w);                               \
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
        pf, tab, stab, out, order, lead, dt, step, key, rng_seed, neg4kb, \
        ntypes, cap, nx, ny, nz, flags, advect, w, ampl);                 \
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
