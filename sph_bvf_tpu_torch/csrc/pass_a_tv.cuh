// The transport-velocity pass-A pair term shared by K1 (csrc/pass_a_2d.cu) and
// K3 (csrc/pass_a_3d.cu): the packed-row layout, the i-side values a thread
// loads once, and the accumulation of one (i, j) pair.
//
// It is ops/pair.py `_pass_a_offset` for one pair under the configuration
// both kernels serve: the transport-velocity pressure switch, fixed BVF wall
// solids, the diagonal artificial stress of non-elastic solids, with (FILTER)
// or without the Shepard-filter accumulators rhoAux1/rhoAux2.  A candidate
// outside the kernel support skips all arithmetic, which changes no sum
// because every term carries a factor W or dW/dr that is exactly zero there.
//
// Layouts (kept in step with sph_bvf_tpu_torch/ops/pair_cuda.py):
//   pf  f32 [F, cap, NC], F = 20 (FILTER) or 19: rows PF_ROWS
//   tab f32 [5, T*T]: inv_h, eta, inv_wdelta, W' factor, W factor per type pair
//   acc f32 [A], A = 15 (FILTER) or 13: rows ACC_ROWS

#pragma once

#include <cuda_runtime.h>

namespace tv {

constexpr int R_VALID = 0, R_PTYPE = 1, R_SOLID = 2, R_X = 3, R_V = 6,
              R_VEST = 9, R_RHO = 12, R_M = 13, R_B = 14, R_PRHO2 = 15,
              R_MRHO = 16, R_V2 = 17, R_ASD = 18, R_RHOI = 19;
constexpr int O_NUMDEN = 0, O_DDV = 1, O_F = 4, O_DRHO = 7, O_DE = 8,
              O_PHI = 9, O_NW = 10, O_RHOAUX1 = 13, O_RHOAUX2 = 14;
constexpr int T_INVH = 0, T_ETA = 1, T_INVWD = 2, T_CWFD = 3, T_CWF = 4;

template <bool FILTER>
constexpr int kAccs = FILTER ? 15 : 13;

// one field of one slot; m is the slot count of a field row (cap * NC)
__device__ __forceinline__ float ld(const float* __restrict__ pf, long long m,
                                    int row, long long slot) {
  return __ldg(pf + (long long)row * m + slot);
}

// the i-side values every pair of a thread reads
struct ISide {
  int tp0;  // ti * ntypes: the row of i's type in the [T, T] tables
  bool solid;
  float x[3], v[3], e[3], b[3];  // b = v - vest
  float rho, m, B, P, V2, AS;
};

__device__ __forceinline__ ISide load_i(const float* __restrict__ pf,
                                        long long m, long long s, int ntypes) {
  ISide I;
  I.tp0 = (int)ld(pf, m, R_PTYPE, s) * ntypes;
  I.solid = ld(pf, m, R_SOLID, s) != 0.f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    I.x[a] = ld(pf, m, R_X + a, s);
    I.v[a] = ld(pf, m, R_V + a, s);
    I.e[a] = ld(pf, m, R_VEST + a, s);
    I.b[a] = I.v[a] - I.e[a];
  }
  I.rho = ld(pf, m, R_RHO, s);
  I.m = ld(pf, m, R_M, s);
  I.B = ld(pf, m, R_B, s);
  I.P = ld(pf, m, R_PRHO2, s);
  I.V2 = ld(pf, m, R_V2, s);
  I.AS = ld(pf, m, R_ASD, s);
  return I;
}

// add the pair (i, j = slot k) to acc; the caller has checked that j is valid
// and not i
template <bool FILTER>
__device__ __forceinline__ void add_pair(const float* __restrict__ pf,
                                         long long m, long long k,
                                         const float* __restrict__ tab, int tt,
                                         const ISide& I, float* acc) {
  const float dx0 = I.x[0] - ld(pf, m, R_X, k), dx1 = I.x[1] - ld(pf, m, R_X + 1, k),
              dx2 = I.x[2] - ld(pf, m, R_X + 2, k);
  const float rsq = dx0 * dx0 + dx1 * dx1 + dx2 * dx2;
  const float r = sqrtf(rsq);
  const int tp = I.tp0 + (int)ld(pf, m, R_PTYPE, k);
  const float q = r * __ldg(tab + T_INVH * tt + tp);
  const float t = fmaxf(1.f - q, 0.f);
  if (t == 0.f) return;  // outside the support: every term is 0
  const float wfd = __ldg(tab + T_CWFD * tt + tp) * t * t;
  const float wf = __ldg(tab + T_CWF * tt + tp) * t * t * t * (1.f + 3.f * q);

  const float mj = ld(pf, m, R_M, k), rhoj = ld(pf, m, R_RHO, k),
              Vj2 = ld(pf, m, R_V2, k);
  const bool solid_j = ld(pf, m, R_SOLID, k) != 0.f;

  // ---- sweep 1
  acc[O_NUMDEN] += Vj2 * wf;
  if constexpr (FILTER) {
    acc[O_RHOAUX1] += ld(pf, m, R_RHOI, k) * wf;
    acc[O_RHOAUX2] += wf;
  }
  const float vsum = I.V2 + Vj2;
  const float ddv_coef = 70.f * I.B * vsum * wfd;
  acc[O_DDV + 0] += ddv_coef * dx0;
  acc[O_DDV + 1] += ddv_coef * dx1;
  acc[O_DDV + 2] += ddv_coef * dx2;

  // ---- sweep 2
  const float vj0 = ld(pf, m, R_V, k), vj1 = ld(pf, m, R_V + 1, k),
              vj2 = ld(pf, m, R_V + 2, k);
  const float ej0 = ld(pf, m, R_VEST, k), ej1 = ld(pf, m, R_VEST + 1, k),
              ej2 = ld(pf, m, R_VEST + 2, k);
  const float vv0 = I.e[0] - ej0, vv1 = I.e[1] - ej1, vv2 = I.e[2] - ej2;
  const float delVdotDelR = dx0 * vv0 + dx1 * vv1 + dx2 * vv2;
  const float ti_s = I.rho * (I.b[0] * dx0 + I.b[1] * dx1 + I.b[2] * dx2);
  const float tj_s = rhoj * ((vj0 - ej0) * dx0 + (vj1 - ej1) * dx1 +
                             (vj2 - ej2) * dx2);
  const float vw = vsum * wfd;
  const float fvisc = vsum * __ldg(tab + T_ETA * tt + tp) * wfd;
  const float Pj = ld(pf, m, R_PRHO2, k);
  const float sgn = (Pj + I.P >= 0.f || (I.solid && solid_j)) ? 1.f : -1.f;
  const float fpair = I.m * mj * (Pj + sgn * I.P) * wfd;
  const float w = wf * __ldg(tab + T_INVWD * tt + tp);
  const float w2 = w * w;
  const float fart = I.m * mj * wfd * (w2 * w2) * (I.AS + ld(pf, m, R_ASD, k));
  const float fdx = fart - fpair;  // coefficient of dx
  acc[O_F + 0] += fdx * dx0 + fvisc * vv0 + vw * (0.5f * (ti_s * I.e[0] + tj_s * ej0));
  acc[O_F + 1] += fdx * dx1 + fvisc * vv1 + vw * (0.5f * (ti_s * I.e[1] + tj_s * ej1));
  acc[O_F + 2] += fdx * dx2 + fvisc * vv2 + vw * (0.5f * (ti_s * I.e[2] + tj_s * ej2));

  // density evolution: corr = rho (vest - v).dx = -ti_s / -tj_s
  const float mrhoj = ld(pf, m, R_MRHO, k);
  const float delVt = dx0 * (I.v[0] - vj0) + dx1 * (I.v[1] - vj1) +
                      dx2 * (I.v[2] - vj2);
  acc[O_DRHO] += I.rho * delVt * wfd * mrhoj + mrhoj * (ti_s + tj_s) * wfd;

  acc[O_DE] += -0.5f * (fpair * delVdotDelR +
                        fvisc * (vv0 * vv0 + vv1 * vv1 + vv2 * vv2));

  // BVF volume fraction and wall normal: fluid i, solid j
  if (!I.solid && solid_j) {
    acc[O_PHI] += Vj2 * wf;
    const float nwc = wfd * Vj2;
    acc[O_NW + 0] += nwc * dx0;
    acc[O_NW + 1] += nwc * dx1;
    acc[O_NW + 2] += nwc * dx2;
  }
}

}  // namespace tv
