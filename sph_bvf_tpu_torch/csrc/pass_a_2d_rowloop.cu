// K2 — 2D pass A of the SPH-BVF pair physics for crowded and mixed-lattice
// grids, one thread per (slot i, cell c).
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
// particles, so a walk over every slot of the 3x3 window would spend two
// thirds of its time on empty slots, and the elastic terms (dS alone is ~110
// flops per pair, f_art and f_dev ~40 more) are needed by a few percent of
// the particles.  The bound is the issue rate of the useful pairs.  Design:
// every rebin leaves each cell's valid slots compacted at 0..occ-1 and
// validity does not change until the next rebin, so the TPU kernel's
// occupancy gates become exact loop bounds here — a thread whose slot is
// empty writes zeros and stops, and the j loop over a neighbour cell stops at
// its first empty slot.  The TPU kernel's elastic gates become the body's
// exact per-thread branches (csrc/pass_a_mech.cuh).  Accumulators stay in
// registers, neighbouring threads take neighbouring cells of one slot row so
// every load of the [F, cap, NC] pack is coalesced.  A periodic axis (x, y
// or both; the TPU kernel builds ghost columns for y, pair_pallas.py:359-365)
// wraps the neighbour cell by index, and the body takes the minimum image.
// ELASTIC, NS (0..4) and THERMAL are template parameters; the other
// switches are runtime bits.
//
// Flat cell c = cx * ny + cy; the grid has one cell along z.

#include <cuda_runtime.h>

#include "pass_a_mech.cuh"

namespace {

constexpr int kThreads = 128;

// flags: mech::F_*; advect, ampl: see mech::Ctx; wrap: the periodic axes
// (bit 0 x, bit 1 y) and their extents; dt, step, key, rng_seed, neg4kb:
// the thermal noise's inputs (THERMAL), as csrc/pass_a_2d.cu takes them
template <bool FILTER, bool ELASTIC, int NS, bool THERMAL>
__global__ void __launch_bounds__(kThreads) pass_a_2d_rowloop_kernel(
    const float* __restrict__ pf, const float* __restrict__ tab,
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

  // slots at or above the cell's occupancy are invalid: nothing to sum
  if (tv::ld(pf, m, mech::R_VALID, s) != 0.f) {
    mech::Ctx ctx = mech::make_ctx(ntypes, flags, advect, ampl, wrap);
    if constexpr (THERMAL) ctx.noise = tv::load_noise(dt, step, key, rng_seed, neg4kb);
    const auto I = mech::load_i<FILTER, ELASTIC, NS, THERMAL>(pf, m, s, ctx);
    const bool wrapx = wrap.axes & 1, wrapy = wrap.axes & 2;
    for (int ox = -1; ox <= 1; ++ox) {
      int cxj = cx + ox;
      if (wrapx) {
        cxj = tv::wrap_cell(cxj, nx);
      } else if (cxj < 0 || cxj >= nx) {
        continue;
      }
      for (int oy = -1; oy <= 1; ++oy) {
        int cyj = cy + oy;
        if (wrapy) {
          cyj = tv::wrap_cell(cyj, ny);
        } else if (cyj < 0 || cyj >= ny) {
          continue;
        }
        const int cj = cxj * ny + cyj;
        for (int j = 0; j < cap; ++j) {
          const long long k = (long long)j * nc + cj;
          // compacted slots: the first empty one ends the cell
          if (tv::ld(pf, m, mech::R_VALID, k) == 0.f) break;
          if (k == s) continue;  // the self pair (zero offset, j == i)
          mech::add_pair<FILTER, ELASTIC, NS, THERMAL, 2>(pf, m, k, tab, stab,
                                                          ctx, I, acc);
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < A; ++a) out[(long long)a * m + s] = acc[a];
}

}  // namespace

// filter, elastic, thermal: the template switches; ns: the species count
// (stab is read only when ns > 0); flags: mech::F_*; wrap: bit a set when
// axis a is periodic (with more than one cell), lx, ly, lz the extents hi -
// lo in f32 (read on the wrapping axes only; the grid has one cell along z);
// advect, ampl and the noise's inputs: see the kernel
extern "C" int pass_a_2d_rowloop(const float* pf, const float* tab,
                                 const float* stab, float* out, int ntypes,
                                 int ns, int advect, int cap, int nx, int ny,
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
        pf, tab, stab, out, dt, step, key, rng_seed, neg4kb, ntypes, cap,  \
        nx, ny, flags, advect, w, ampl);                                   \
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
