// K1 — 2D pass A of the SPH-BVF pair physics, one thread per (slot i, cell c).
//
// Replaces sph_bvf_tpu/ops/pair_pallas.py `_call_padded`, grouped branch (the
// TPU kernel that carries the flagship lid-driven cavity and every
// lattice-aligned 2D grid of cap <= 24).  For every valid slot i it sums
// ops/pair.py `_pass_a_offset` over the valid j of the 3x3 stencil cells,
// j != i, reading j at the neighbour cell of the one packed matrix: the
// kernel template of csrc/pass_a_2d.cuh with its `Neighbour` source (K4,
// csrc/pass_a_2d_preshift.cu, sums the same pairs from a window staged in
// shared memory).  Two pair bodies, as K3 has them:
// - the transport-velocity pair of csrc/pass_a_tv.cuh, for the
//   configurations it serves (pair_cuda.tv_lacks empty and no periodic
//   axis: the flagship, natural convection), with (FILTER) or without the
//   Shepard-filter accumulators, NS continuum species (the C rows in, the
//   flux Q out) and (THERMAL) or without the SDPD thermal noise (the e and
//   tag rows in; dt, step and the PRNG key read from the state's device
//   tensors);
// - the full body of csrc/pass_a_mech.cuh (K2's and K3's) for every other
//   configuration of the grouped branch: the mechanics and fsi pair styles,
//   the symmetric pressure and XSPH, fixed, free and elastic solids,
//   `ampl_damp` and the per-particle G0, solid-free scenes, periodic x and
//   y of at least 3 cells, the thermal rows and 0-4 species.
// The plain PyTorch version is sph_bvf_tpu_torch/ops/pair.py
// `_pass_a_plain`.
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
// buffer), a periodic axis wraps the neighbour index; a candidate outside
// the kernel support skips all arithmetic.  The transport-velocity body
// holds fewer values live across the j loop than the full one (72-94
// registers against 111-168 in K3), so the flagship keeps it.

#include <cuda_runtime.h>

#include "pass_a_2d.cuh"

// body: 0 the transport-velocity pair (elastic 0, no periodic axis; flags
// and ampl unread), 1 the full body; filter, elastic, thermal: the template
// switches; ns: the species count (stab is read only when ns > 0); advect:
// PairConfig.species_advection; flags: mech::F_*; wrap: bit a set when axis
// a is periodic (with more than one cell), lx, ly, lz the extents hi - lo
// in f32 (read on the wrapping axes only); ampl: PairConfig.ampl_damp; the
// noise's inputs: the state's dt (f32), step (i32) and PRNG key (two words
// in i64) on the device, PairConfig.rng_seed and -4 kB in f32
extern "C" int pass_a_2d(const float* pf, const float* tab, const float* stab,
                        float* out, int ntypes, int ns, int advect, int cap,
                        int nx, int ny, int body, int filter, int elastic,
                        int flags, int wrap, float lx, float ly, float lz,
                        float ampl, int thermal, const float* dt,
                        const int* step, const long long* key,
                        unsigned rng_seed, float neg4kb, cudaStream_t stream) {
  return pa2d::launch(pf, pa2d::Neighbour<false>{0},
                      pa2d::Neighbour<true>{wrap}, tab, stab, out, ntypes,
                      ns, advect, cap, nx, ny, body, filter, elastic, flags,
                      wrap, lx, ly, lz, ampl, thermal, dt, step, key, rng_seed,
                      neg4kb, stream);
}

// registers per thread and local-memory (spill) bytes per thread of the
// (body, filter, elastic, ns, thermal) instantiation
extern "C" int pass_a_2d_attributes(int body, int filter, int elastic, int ns,
                                    int thermal, int* regs, int* local_bytes) {
  return pa2d::attributes<pa2d::Neighbour<false>, pa2d::Neighbour<true>>(
      body, filter, elastic, ns, thermal, regs, local_bytes);
}

extern "C" const char* sph_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
