// K1 — 2D pass A of the SPH-BVF pair physics, one thread per (slot i, cell
// c) of a tile of cells whose 3x3 window a block stages in shared memory.
//
// Replaces sph_bvf_tpu/ops/pair_pallas.py `_call_padded`, grouped branch
// (pair_pallas.py:308; the TPU kernel that carries the flagship
// lid-driven cavity and every lattice-aligned 2D grid of cap <= 24).  For
// every valid slot i it sums ops/pair.py `_pass_a_offset` over the valid j
// of the 3x3 stencil cells, j != i, with the kernels of
// csrc/pass_a_2d.cuh.
// Two pair bodies, as K3 has them:
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
// K4, the entry point PairConfig.preshift_window routes K1's grids to
// (ops/pair_cuda.py `pass_a_2d_preshift`), calls this library's
// `pass_a_2d` too, so its result is K1's, bitwise.  It replaces
// sph_bvf_tpu/ops/pair_pallas.py `_call_preshift` (pair_pallas.py:848: XLA
// materialises 9 shifted views of the padded field buffer once per call,
// pair_pallas.py:911-921, and the kernel reads each stencil offset as its
// own lane-aligned block, with no in-kernel rotation and no bounds test).
// A block's window in shared memory gives the same on the H100 (zero cells
// past a walled edge, as the pre-shifted copies' zero rows; wrapped by
// index on a periodic axis, as `shift_cells`), and K1 reads its j that way,
// so the two routes are one kernel.
//
// What bounds it on an H100: instruction throughput, ~130 flops and ~15
// shared-memory loads a pair inside the support (the thermal noise adds
// the hash's ~180 integer operations); HBM carries the pack about twice.
// Design
// (csrc/pass_a_2d.cuh): a block stages its tile's 3x3 window in shared
// memory with cp.async, each cell only to its tail (one past its last
// valid slot); a thread walks each neighbour cell to its tail, skipping the
// invalid slots below it, so the terms and their order are the same on any
// layout; accumulators stay in registers.

#include <cuda_runtime.h>

#include "pass_a_2d.cuh"

// tails: i32 [nx * ny], each cell's tail (ops/pair_cuda.py `tail_index`);
// rows: the pack's row count F; tx, ty: the tile (ops/pair_cuda.py
// `k4_tile`); bound: the largest tail, the window's depth (at most cap);
// body: 0 the transport-velocity pair (elastic 0, no periodic axis; flags
// and ampl unread), 1 the full body; filter, elastic,
// thermal: the template switches; ns: the species count (stab is read only
// when ns > 0); advect: PairConfig.species_advection; flags: mech::F_*;
// wrap: bit a set when axis a is periodic (with more than one cell), lx,
// ly, lz the extents hi - lo in f32 (read on the wrapping axes only); ampl:
// PairConfig.ampl_damp; the noise's inputs: the state's dt (f32), step
// (i32) and PRNG key (two words in i64) on the device, PairConfig.rng_seed
// and -4 kB in f32
extern "C" int pass_a_2d(const float* pf, const float* tab, const float* stab,
                        float* out, int ntypes, int ns, int advect, int cap,
                        int nx, int ny, const int* tails, int rows, int tx,
                        int ty, int bound, int body, int filter,
                        int elastic, int flags, int wrap, float lx, float ly,
                        float lz, float ampl, int thermal, const float* dt,
                        const int* step, const long long* key,
                        unsigned rng_seed, float neg4kb, cudaStream_t stream) {
  return pa2d::launch(pf, tails, tab, stab, out, ntypes, ns, advect, cap, nx,
                      ny, rows, tx, ty, bound, body, filter, elastic,
                      flags, wrap, lx, ly, lz, ampl, thermal, dt, step, key,
                      rng_seed, neg4kb, stream);
}

// registers per thread and local-memory (spill) bytes per thread of the
// (body, filter, elastic, ns, thermal) instantiation
extern "C" int pass_a_2d_attributes(int body, int filter, int elastic, int ns,
                                    int thermal, int* regs, int* local_bytes) {
  return pa2d::attributes(body, filter, elastic, ns, thermal, regs,
                          local_bytes);
}

extern "C" const char* sph_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
