// K2 — 2D pass A of the SPH-BVF pair physics for crowded and mixed-lattice
// grids, one thread per valid slot i, the lanes of a warp on one cell.
//
// Replaces sph_bvf_tpu/ops/pair_pallas.py `_call_padded`, rowloop branch (the
// TPU kernel that carries the FSI beam: occupancy-gated i/j tiles, an
// elastic-gated dS pass and a window-gated pass for the elastic forces).  For
// every valid slot i it sums ops/pair.py `_pass_a_offset` over the valid j of
// the 3x3 stencil cells, j != i.  The pair body, its packed rows and its
// accumulator rows are csrc/pass_a_mech.cuh, which K3 shares: the
// transport-velocity or mechanics force, XSPH, BVF walls, free and elastic
// solids, solid-free scenes (the load-balance blob), the fsi pair style of
// cell polarization, NS continuum species and the SDPD thermal noise, with
// (FILTER) or without the Shepard-filter accumulators.  The plain PyTorch
// version is sph_bvf_tpu_torch/ops/pair.py `_pass_a_plain`.
//
// What bounds it on an H100: FSI cells hold cap = 47 slots but ~9-16
// particles (72% of the slots empty on the beam, 56% on polarization, 37%
// on the 2D vortex and the blob), about a quarter of the ~80 candidates of
// a vortex particle lie inside the support, and the elastic terms (dS alone
// is ~110 flops per pair, f_art and f_dev ~40 more) are needed by a few
// percent of the particles.  The bound is the issue rate of the useful
// pairs.  Design: the walk of csrc/walk.cuh over the 9 stencil cells, as K3
// walks its 27: thread t takes the valid slot order[t] (ops/pair_cuda.py
// `walk_index`), so a warp's lanes are the particles of one or two cells
// (no lane on an empty slot; the lanes of beam cells take the elastic
// branches together; a cell past 32 particles takes two warps, each walking
// the whole neighbourhood); every rebin leaves each cell's valid slots
// compacted at 0..occ-1 and validity does not change until the next rebin,
// so a cell's j loop stops at its lead; a lane tests the support apart from
// the body and queues the j inside it, and the warp runs the body over the
// queues in lockstep, in the walk's order (offsets (-1, -1) ... (1, 1), then
// slots), so every output is bitwise a walk's that runs the body on every
// candidate.  The TPU kernel's elastic gates are the body's exact
// per-thread branches (csrc/pass_a_mech.cuh).  A periodic axis (x, y or
// both; the TPU kernel builds ghost columns for y, pair_pallas.py:359-365)
// wraps the neighbour cell by index, and the body takes the minimum image.
// ELASTIC, NS (0..4) and THERMAL are template parameters; the other
// switches are runtime bits.
//
// Flat cell c = cx * ny + cy; the grid has one cell along z.

#include <cuda_runtime.h>

#include "walk.cuh"

namespace {

using walk::kChunk;
using walk::kFull;
using walk::kThreads;

// flags: mech::F_*; advect, ampl: see mech::Ctx; wrap: the periodic axes
// (bit 0 x, bit 1 y) and their extents; order, lead: the walk's index
// (csrc/walk.cuh); dt, step, key, rng_seed, neg4kb: the thermal noise's
// inputs (THERMAL), as csrc/pass_a_2d.cu takes them
template <bool FILTER, bool ELASTIC, int NS, bool THERMAL>
__global__ void __launch_bounds__(kThreads) pass_a_2d_rowloop_kernel(
    const float* __restrict__ pf, const float* __restrict__ tab,
    const float* __restrict__ stab, float* __restrict__ out,
    const int* __restrict__ order, const int* __restrict__ lead,
    const float* __restrict__ dt, const int* __restrict__ step,
    const long long* __restrict__ key, unsigned rng_seed, float neg4kb,
    int ntypes, int cap, int nx, int ny, int flags, int advect, tv::Wrap wrap,
    float ampl) {
  __shared__ int lists[kChunk * kThreads];
  constexpr int A = mech::Rows<FILTER, ELASTIC, NS>::A;
  const long long m = (long long)cap * nx * ny;  // slots per field row
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
  walk::walk<2>(pf, m, s, lead, nx, ny, 1, wrap,
                walk::support_cut2(tab, stab, NS, ctx.tt), I.x,
                lists + threadIdx.x, [&](long long k) {
                  mech::add_pair<FILTER, ELASTIC, NS, THERMAL, 2>(
                      pf, m, k, tab, stab, ctx, I, acc);
                });
  if (s < 0) return;
#pragma unroll
  for (int a = 0; a < A; ++a) out[(long long)a * m + s] = acc[a];
}

}  // namespace

// order, lead: the walk's index (ops/pair_cuda.py `walk_index`); filter,
// elastic, thermal: the template switches; ns: the species count
// (stab is read only when ns > 0); flags: mech::F_*; wrap: bit a set when
// axis a is periodic (with more than one cell), lx, ly, lz the extents hi -
// lo in f32 (read on the wrapping axes only; the grid has one cell along z);
// advect, ampl and the noise's inputs: see the kernel
extern "C" int pass_a_2d_rowloop(const float* pf, const float* tab,
                                 const float* stab, float* out, int ntypes,
                                 int ns, int advect, int cap, int nx, int ny,
                                 const int* order, const int* lead,
                                 int filter, int elastic, int flags, int wrap,
                                 float lx, float ly, float lz, float ampl,
                                 int thermal, const float* dt, const int* step,
                                 const long long* key, unsigned rng_seed,
                                 float neg4kb, cudaStream_t stream) {
  // a wrapping axis of fewer than 3 cells would reach one cell twice
  if (((wrap & 1) && nx < 3) || ((wrap & 2) && ny < 3) || (wrap & 4))
    return (int)cudaErrorInvalidValue;
  const long long m = (long long)cap * nx * ny;
  if (m == 0) return 0;
  const tv::Wrap w{wrap, {lx, ly, lz}};
  const unsigned blocks = (unsigned)((m + kThreads - 1) / kThreads);
  switch (mech::variant_key(filter != 0, elastic != 0, ns, thermal != 0)) {
#define X(F, E, N, T)                                                      \
  case mech::variant_key(F, E, N, T):                                      \
    pass_a_2d_rowloop_kernel<F, E, N, T><<<blocks, kThreads, 0, stream>>>( \
        pf, tab, stab, out, order, lead, dt, step, key, rng_seed, neg4kb,  \
        ntypes, cap, nx, ny, flags, advect, w, ampl);                      \
    break;
    MECH_FOR_EACH_VARIANT(X)
#undef X
    default:
      return (int)cudaErrorInvalidValue;  // ns beyond tv::kMaxSpecies
  }
  return (int)cudaGetLastError();
}

// registers per thread and local-memory (spill) bytes per thread of the
// (filter, elastic, ns, thermal) instantiation, as the runtime reports them
extern "C" int pass_a_2d_rowloop_attributes(int filter, int elastic, int ns,
                                            int thermal, int* regs,
                                            int* local_bytes) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaErrorInvalidValue;
  switch (mech::variant_key(filter != 0, elastic != 0, ns, thermal != 0)) {
#define X(F, E, N, T)                                                          \
  case mech::variant_key(F, E, N, T):                                          \
    err = cudaFuncGetAttributes(&attr, pass_a_2d_rowloop_kernel<F, E, N, T>);  \
    break;
    MECH_FOR_EACH_VARIANT(X)
#undef X
    default:
      break;
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
