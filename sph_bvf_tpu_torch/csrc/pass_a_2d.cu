// K1 — 2D pass A of the SPH-BVF pair physics, one thread per (slot i, cell c).
//
// Replaces sph_bvf_tpu/ops/pair_pallas.py `_call_padded`, grouped branch (the
// TPU kernel that carries the flagship lid-driven cavity).  For every valid
// slot i it sums ops/pair.py `_pass_a_offset` over the valid j of the 3x3
// stencil cells, j != i, for the configuration the port supports: the
// transport-velocity pressure switch, fixed BVF wall solids, the diagonal
// artificial stress of non-elastic solids, with (FILTER) or without the
// Shepard-filter accumulators rhoAux1/rhoAux2.  The plain PyTorch version is
// sph_bvf_tpu_torch/ops/pair.py `_pass_a_plain`.
//
// What bounds it on an H100: each i-thread walks up to 9*cap candidates,
// reads about 15 f32 fields of each (the 3x3 windows of neighbouring threads
// overlap, so these loads hit L1/L2 and the state is read from HBM about
// once per call) and spends ~130 flops on each candidate inside the kernel
// support.  The bound is issue rate and L1 traffic, not HBM bandwidth.
// Design: accumulators stay in registers; neighbouring threads take
// neighbouring cells of one slot row, so every load of the [F, cap, NC]
// matrix is coalesced; walls are bounds checks on cx+-1 and cy+-1 (no halo
// buffer); a candidate outside the kernel support skips all arithmetic,
// which changes no sum because every term carries a factor W or dW/dr that
// is exactly zero there.
//
// Layouts (kept in step with sph_bvf_tpu_torch/ops/pair_cuda.py):
//   pf  f32 [F, cap, NC], F = 20 (FILTER) or 19: rows PF_ROWS
//   tab f32 [5, T*T]: inv_h, eta, inv_wdelta, W' factor, W factor per type pair
//   out f32 [A, cap, NC], A = 15 (FILTER) or 13: rows ACC_ROWS
// Flat cell c = cx * ny + cy; the grid has one cell along z.

#include <cuda_runtime.h>

namespace {

constexpr int R_VALID = 0, R_PTYPE = 1, R_SOLID = 2, R_X = 3, R_V = 6,
              R_VEST = 9, R_RHO = 12, R_M = 13, R_B = 14, R_PRHO2 = 15,
              R_MRHO = 16, R_V2 = 17, R_ASD = 18, R_RHOI = 19;
constexpr int O_NUMDEN = 0, O_DDV = 1, O_F = 4, O_DRHO = 7, O_DE = 8,
              O_PHI = 9, O_NW = 10, O_RHOAUX1 = 13, O_RHOAUX2 = 14;
constexpr int T_INVH = 0, T_ETA = 1, T_INVWD = 2, T_CWFD = 3, T_CWF = 4;
constexpr int kThreads = 128;

template <bool FILTER>
__global__ void __launch_bounds__(kThreads) pass_a_2d_kernel(
    const float* __restrict__ pf, const float* __restrict__ tab,
    float* __restrict__ out, int ntypes, int cap, int nx, int ny) {
  constexpr int A = FILTER ? 15 : 13;
  const int nc = nx * ny;
  const long long m = (long long)cap * nc;  // slots per field row
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= m) return;
  const int c = (int)(s % nc);
  const int cx = c / ny, cy = c - cx * ny;
  const int tt = ntypes * ntypes;
  auto ld = [&](int row, long long slot) {
    return __ldg(pf + (long long)row * m + slot);
  };

  float acc[A];
#pragma unroll
  for (int a = 0; a < A; ++a) acc[a] = 0.f;

  if (ld(R_VALID, s) != 0.f) {
    const int ti = (int)ld(R_PTYPE, s);
    const bool solid_i = ld(R_SOLID, s) != 0.f;
    const float xi0 = ld(R_X, s), xi1 = ld(R_X + 1, s), xi2 = ld(R_X + 2, s);
    const float vi0 = ld(R_V, s), vi1 = ld(R_V + 1, s), vi2 = ld(R_V + 2, s);
    const float ei0 = ld(R_VEST, s), ei1 = ld(R_VEST + 1, s),
                ei2 = ld(R_VEST + 2, s);
    const float rhoi = ld(R_RHO, s), mi = ld(R_M, s), Bi = ld(R_B, s);
    const float Pi = ld(R_PRHO2, s), Vi2 = ld(R_V2, s), ASi = ld(R_ASD, s);
    // v - vest of i (transport-tensor and density-correction terms)
    const float bi0 = vi0 - ei0, bi1 = vi1 - ei1, bi2 = vi2 - ei2;

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
          if (ld(R_VALID, k) == 0.f) continue;
          const float dx0 = xi0 - ld(R_X, k), dx1 = xi1 - ld(R_X + 1, k),
                      dx2 = xi2 - ld(R_X + 2, k);
          const float rsq = dx0 * dx0 + dx1 * dx1 + dx2 * dx2;
          const float r = sqrtf(rsq);
          const int tp = ti * ntypes + (int)ld(R_PTYPE, k);
          const float q = r * __ldg(tab + T_INVH * tt + tp);
          const float t = fmaxf(1.f - q, 0.f);
          if (t == 0.f) continue;  // outside the support: every term is 0
          const float wfd = __ldg(tab + T_CWFD * tt + tp) * t * t;
          const float wf = __ldg(tab + T_CWF * tt + tp) * t * t * t *
                           (1.f + 3.f * q);

          const float mj = ld(R_M, k), rhoj = ld(R_RHO, k), Vj2 = ld(R_V2, k);
          const bool solid_j = ld(R_SOLID, k) != 0.f;

          // ---- sweep 1
          acc[O_NUMDEN] += Vj2 * wf;
          if constexpr (FILTER) {
            acc[O_RHOAUX1] += ld(R_RHOI, k) * wf;
            acc[O_RHOAUX2] += wf;
          }
          const float vsum = Vi2 + Vj2;
          const float ddv_coef = 70.f * Bi * vsum * wfd;
          acc[O_DDV + 0] += ddv_coef * dx0;
          acc[O_DDV + 1] += ddv_coef * dx1;
          acc[O_DDV + 2] += ddv_coef * dx2;

          // ---- sweep 2
          const float vj0 = ld(R_V, k), vj1 = ld(R_V + 1, k),
                      vj2 = ld(R_V + 2, k);
          const float ej0 = ld(R_VEST, k), ej1 = ld(R_VEST + 1, k),
                      ej2 = ld(R_VEST + 2, k);
          const float vv0 = ei0 - ej0, vv1 = ei1 - ej1, vv2 = ei2 - ej2;
          const float delVdotDelR = dx0 * vv0 + dx1 * vv1 + dx2 * vv2;
          const float ti_s = rhoi * (bi0 * dx0 + bi1 * dx1 + bi2 * dx2);
          const float tj_s = rhoj * ((vj0 - ej0) * dx0 + (vj1 - ej1) * dx1 +
                                     (vj2 - ej2) * dx2);
          const float vw = vsum * wfd;
          const float fvisc = vsum * __ldg(tab + T_ETA * tt + tp) * wfd;
          const float Pj = ld(R_PRHO2, k);
          const float sgn = (Pj + Pi >= 0.f || (solid_i && solid_j)) ? 1.f : -1.f;
          const float fpair = mi * mj * (Pj + sgn * Pi) * wfd;
          const float w = wf * __ldg(tab + T_INVWD * tt + tp);
          const float w2 = w * w;
          const float fart = mi * mj * wfd * (w2 * w2) * (ASi + ld(R_ASD, k));
          const float fdx = fart - fpair;  // coefficient of dx
          acc[O_F + 0] += fdx * dx0 + fvisc * vv0 + vw * (0.5f * (ti_s * ei0 + tj_s * ej0));
          acc[O_F + 1] += fdx * dx1 + fvisc * vv1 + vw * (0.5f * (ti_s * ei1 + tj_s * ej1));
          acc[O_F + 2] += fdx * dx2 + fvisc * vv2 + vw * (0.5f * (ti_s * ei2 + tj_s * ej2));

          // density evolution: corr = rho (vest - v).dx = -ti_s / -tj_s
          const float mrhoj = ld(R_MRHO, k);
          const float delVt = dx0 * (vi0 - vj0) + dx1 * (vi1 - vj1) +
                              dx2 * (vi2 - vj2);
          acc[O_DRHO] += rhoi * delVt * wfd * mrhoj + mrhoj * (ti_s + tj_s) * wfd;

          acc[O_DE] += -0.5f * (fpair * delVdotDelR +
                                fvisc * (vv0 * vv0 + vv1 * vv1 + vv2 * vv2));

          // BVF volume fraction and wall normal: fluid i, solid j
          if (!solid_i && solid_j) {
            acc[O_PHI] += Vj2 * wf;
            const float nwc = wfd * Vj2;
            acc[O_NW + 0] += nwc * dx0;
            acc[O_NW + 1] += nwc * dx1;
            acc[O_NW + 2] += nwc * dx2;
          }
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < A; ++a) out[(long long)a * m + s] = acc[a];
}

}  // namespace

extern "C" int pass_a_2d(const float* pf, const float* tab, float* out,
                         int ntypes, int cap, int nx, int ny, int filter,
                         cudaStream_t stream) {
  const long long m = (long long)cap * nx * ny;
  if (m == 0) return 0;
  const unsigned blocks = (unsigned)((m + kThreads - 1) / kThreads);
  if (filter)
    pass_a_2d_kernel<true><<<blocks, kThreads, 0, stream>>>(pf, tab, out, ntypes,
                                                             cap, nx, ny);
  else
    pass_a_2d_kernel<false><<<blocks, kThreads, 0, stream>>>(pf, tab, out, ntypes,
                                                              cap, nx, ny);
  return (int)cudaGetLastError();
}

extern "C" const char* sph_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
