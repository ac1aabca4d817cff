// K1 — 2D pass A of the SPH-BVF pair physics, one thread per (slot i, cell c).
//
// Replaces sph_bvf_tpu/ops/pair_pallas.py `_call_padded`, grouped branch (the
// TPU kernel that carries the flagship lid-driven cavity).  For every valid
// slot i it sums ops/pair.py `_pass_a_offset` over the valid j of the 3x3
// stencil cells, j != i, for the configuration K1 serves: the
// transport-velocity pressure switch, fixed BVF wall solids, the diagonal
// artificial stress of non-elastic solids, with (FILTER) or without the
// Shepard-filter accumulators rhoAux1/rhoAux2, with NS continuum species
// (the C rows in, the flux Q out; natural convection runs NS = 1), and with
// (THERMAL) or without the SDPD thermal noise (the e and tag rows in; dt,
// step and the PRNG key read from the state's device tensors).  The plain
// PyTorch version is sph_bvf_tpu_torch/ops/pair.py `_pass_a_plain`.
//
// What bounds it on an H100: each i-thread walks up to 9*cap candidates,
// reads about 15 f32 fields of each (the 3x3 windows of neighbouring threads
// overlap, so these loads hit L1/L2 and the state is read from HBM about
// once per call) and spends ~130 flops on each candidate inside the kernel
// support; the thermal noise adds ~180 integer operations (the hash) and
// three Box-Muller normals there.  The bound is issue rate and L1 traffic,
// not HBM bandwidth.
// Design: accumulators stay in registers; neighbouring threads take
// neighbouring cells of one slot row, so every load of the [F, cap, NC]
// matrix is coalesced; walls are bounds checks on cx+-1 and cy+-1 (no halo
// buffer); a candidate outside the kernel support skips all arithmetic.
//
// The pair term, the packed rows and the accumulator rows are
// csrc/pass_a_tv.cuh's.  Flat cell c = cx * ny + cy; the grid has one
// cell along z.

#include <cuda_runtime.h>

#include "pass_a_tv.cuh"

namespace {

constexpr int kThreads = 128;

template <bool FILTER, int NS, bool THERMAL>
__global__ void __launch_bounds__(kThreads) pass_a_2d_kernel(
    const float* __restrict__ pf, const float* __restrict__ tab,
    const float* __restrict__ stab, float* __restrict__ out,
    const float* __restrict__ dt, const int* __restrict__ step,
    const long long* __restrict__ key, unsigned rng_seed, float neg4kb,
    int ntypes,
    int advect, int cap, int nx, int ny) {
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
    for (int ox = -1; ox <= 1; ++ox) {
      const int cxj = cx + ox;
      if (cxj < 0 || cxj >= nx) continue;
      for (int oy = -1; oy <= 1; ++oy) {
        const int cyj = cy + oy;
        if (cyj < 0 || cyj >= ny) continue;
        const int cj = cxj * ny + cyj;
        for (int j = 0; j < cap; ++j) {
          const long long k = (long long)j * nc + cj;
          if (k == s) continue;  // the self pair (zero offset, j == i)
          if (tv::ld(pf, m, tv::R_VALID, k) == 0.f) continue;
          tv::add_pair<FILTER, NS, THERMAL, 2>(pf, m, k, tab, stab, advect, tt,
                                                 noise, nowrap, I, acc);
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < A; ++a) out[(long long)a * m + s] = acc[a];
}

}  // namespace

// filter: with the Shepard-filter rows; ns: the species count (stab is read
// only when ns > 0); advect: PairConfig.species_advection; thermal: with the
// SDPD noise, whose inputs are the state's dt (f32), step (i32) and PRNG key
// (two words in i64) on the device, PairConfig.rng_seed and -4 kB in f32
extern "C" int pass_a_2d(const float* pf, const float* tab, const float* stab,
                        float* out, int ntypes, int ns, int advect, int cap,
                        int nx, int ny, int filter, int thermal, const float* dt,
                        const int* step, const long long* key, unsigned rng_seed,
                        float neg4kb, cudaStream_t stream) {
  const long long m = (long long)cap * nx * ny;
  if (m == 0) return 0;
  const unsigned blocks = (unsigned)((m + kThreads - 1) / kThreads);
  switch (tv::variant_key(filter != 0, ns, thermal != 0)) {
#define X(F, N, T)                                                         \
  case tv::variant_key(F, N, T):                                           \
    pass_a_2d_kernel<F, N, T><<<blocks, kThreads, 0, stream>>>(            \
        pf, tab, stab, out, dt, step, key, rng_seed, neg4kb, ntypes,       \
        advect, cap, nx, ny);                                              \
    break;
    TV_FOR_EACH_VARIANT(X)
#undef X
    default:
      return (int)cudaErrorInvalidValue;  // ns beyond tv::kMaxSpecies
  }
  return (int)cudaGetLastError();
}

// registers per thread and local-memory (spill) bytes per thread of the
// (filter, ns, thermal) instantiation, as the runtime reports them
extern "C" int pass_a_2d_attributes(int filter, int ns, int thermal, int* regs,
                                    int* local_bytes) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaErrorInvalidValue;
  switch (tv::variant_key(filter != 0, ns, thermal != 0)) {
#define X(F, N, T)                                                   \
  case tv::variant_key(F, N, T):                                     \
    err = cudaFuncGetAttributes(&attr, pass_a_2d_kernel<F, N, T>);   \
    break;
    TV_FOR_EACH_VARIANT(X)
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
