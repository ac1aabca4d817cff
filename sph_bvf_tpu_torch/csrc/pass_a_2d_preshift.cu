// K4 — 2D pass A over 9 pre-shifted copies of the packed fields, one thread
// per (slot i, cell c).
//
// Replaces sph_bvf_tpu/ops/pair_pallas.py `_call_preshift` (the TPU kernel
// PairConfig.preshift_window selects for the grouped 2D shape: XLA
// materialises 9 shifted views of the padded field buffer once per call,
// pair_pallas.py:911-921, and the kernel reads each stencil offset as its
// own lane-aligned block, with no in-kernel rotation).  The wrapper
// (ops/pair_cuda.py `preshift_views`) stages the same copies with torch
// ops: copy o = 3 (ox + 1) + (oy + 1) holds at (row, slot j, cell c) the
// pack at the neighbour cell c + (ox, oy), wrapped by index on a periodic
// axis, all rows zero off a walled edge.  This kernel is K1's template
// (csrc/pass_a_2d.cuh) with its `Preshift` source: it reads copy o at the
// thread's own cell, with no neighbour-cell arithmetic and no bounds test,
// and takes i's rows from the centre copy.  The offsets, the j order and
// the two pair bodies (with every FILTER, ELASTIC, NS and THERMAL
// instantiation) are K1's, so its result is bitwise K1's, as the JAX
// package holds its pre-shifted kernel to the window kernel.
//
// What bounds it on an H100: the pair work is K1's; the staging adds 9 x F
// rows x cap x NC x 4 bytes written and then read (1.14 GB each way for
// the flagship at N=1000, F = 20).  The TPU measured the same design slower
// than its window kernel (sph_bvf_tpu/ops/pair.py:122-131); here it trades
// K1's L1-resident neighbour windows for streamed copies, so it is
// expected slower too, and its time is recorded beside K1's (PERF.md).

#include <cuda_runtime.h>

#include "pass_a_2d.cuh"

// views: the [9, rows, cap, nx * ny] f32 copies (rows: the pack's); every
// other argument as csrc/pass_a_2d.cu's `pass_a_2d`
extern "C" int pass_a_2d_preshift(const float* views, const float* tab,
                                  const float* stab, float* out, int ntypes,
                                  int ns, int advect, int cap, int nx, int ny,
                                  int rows, int body, int filter, int elastic,
                                  int flags, int wrap, float lx, float ly,
                                  float lz, float ampl, int thermal,
                                  const float* dt, const int* step,
                                  const long long* key, unsigned rng_seed,
                                  float neg4kb, cudaStream_t stream) {
  const long long stride = (long long)rows * cap * nx * ny;
  const pa2d::Preshift src{views, stride};
  return pa2d::launch(views + 4 * stride, src, src, tab, stab, out, ntypes,
                      ns, advect, cap, nx, ny, body, filter, elastic, flags,
                      wrap, lx, ly, lz, ampl, thermal, dt, step, key, rng_seed,
                      neg4kb, stream);
}

// registers per thread and local-memory (spill) bytes per thread of the
// (body, filter, elastic, ns, thermal) instantiation
extern "C" int pass_a_2d_preshift_attributes(int body, int filter, int elastic,
                                             int ns, int thermal, int* regs,
                                             int* local_bytes) {
  return pa2d::attributes<pa2d::Preshift, pa2d::Preshift>(
      body, filter, elastic, ns, thermal, regs, local_bytes);
}

extern "C" const char* sph_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
