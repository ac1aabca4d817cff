// The full pass-A pair body shared by K2 (csrc/pass_a_2d_rowloop.cu), K3
// (csrc/pass_a_3d.cu) and K1 (csrc/pass_a_2d.cuh, which K4 launches too):
// the packed-row layout, the i-side values a thread loads once, and the
// accumulation of one (i, j) pair.
//
// It is ops/pair.py `_pass_a_offset` (with `_pass_a_dS`) for one pair under
// every configuration the JAX package's pass-A kernels serve:
// the transport-velocity (pressure switch) or mechanics (symmetric pressure)
// force, XSPH (ddx), BVF walls, free solids with the Pereira artificial
// viscosity, elastic solids (the 9-component artificial stress f_art, the
// deviatoric solid force f_dev and the Jaumann rate dS), solid-free scenes
// (F_NOSOLIDS: no f_art, no BVF phi/nw, no inv_wdelta), periodic axes (the
// minimum image of the pair offset, csrc/pass_a_tv.cuh `min_image`), the
// fsi pair style's density-diffusion term of drho (ampl) and shear modulus
// softened per particle (F_G0PAIR: geff of a pair from the packed G0 rows
// of i and j, not from the type table), NS continuum species (the tSDPD
// flux Q, csrc/pass_a_tv.cuh `add_species_flux`, inside its own support
// cutc and so before the test against h) and (THERMAL) the SDPD thermal
// noise on the fluid branch (csrc/pass_a_tv.cuh `add_thermal`).  The
// tensor algebra is full 3x3 in 2D and 3D alike, with the deviatoric factor
// 1 - 1/3 of the plain path in any dimension; in 2D every z offset is 0.
//
// The elastic gates are exact per-thread branches: dS only for a solid i
// with G0 != 0 or S != 0 (it is exactly 0 otherwise: geff carries G0_i, the
// rotation terms carry S_i), f_art's 9-component sum only when a side is
// solid and some AS entry is nonzero (AS is 0 on fluids), f_dev only in the
// solid branch.  Under F_G0PAIR the G0 row holds G0 (1 - 0.99 C): positive
// while C < 1/0.99, exactly 0 at a type without shear modulus and negative
// beyond (the plain path then sums a negative geff, and so does this body:
// the gate is != 0, not > 0).  A candidate outside the kernel support h
// skips every remaining term, each of which carries W or dW/dr, exactly 0
// there.
//
// ELASTIC and NS and THERMAL are template parameters (the AS/S rows and the
// dS sums, the Q sums and the noise code exist only where instantiated);
// the rest are runtime bits of `flags`, uniform over a launch.
//
// Layouts (kept in step with sph_bvf_tpu_torch/ops/pair_cuda.py):
//   pf   f32 [F, cap, NC]: MECH_PF_ROWS (R_*), then AS(9), S(9) (ELASTIC) or
//        ASd, then rhoI (FILTER), then C (NS), then e and tag (THERMAL; tag
//        as the int32 bits)
//   tab  f32 [7, T*T]: inv_h, eta, inv_wdelta, W' factor, W factor, h, geff
//   stab f32 [4 + NS, T*T] (NS > 0): the species table of csrc/pass_a_tv.cuh
//   out  f32 [A, cap, NC]: MECH_ACC_ROWS (O_*), then dS(9) (ELASTIC), then
//        rhoAux1, rhoAux2 (FILTER), then Q (NS)

#pragma once

#include <cuda_runtime.h>

#include "pass_a_tv.cuh"

namespace mech {

constexpr int R_VALID = 0, R_PTYPE = 1, R_SOLID = 2, R_X = 3, R_V = 6,
              R_VEST = 9, R_RHO = 12, R_M = 13, R_B = 14, R_PRHO2 = 15,
              R_MRHO = 16, R_V2 = 17, R_C0 = 18, R_INVRHO = 19, R_G0 = 20,
              R_STRESS = 21;
constexpr int O_NUMDEN = 0, O_DDV = 1, O_F = 4, O_DRHO = 7, O_DE = 8,
              O_PHI = 9, O_NW = 10, O_DDX = 13, O_DS = 16;
constexpr int T_INVH = 0, T_ETA = 1, T_INVWD = 2, T_CWFD = 3, T_CWF = 4,
              T_H = 5, T_GEFF = 6;
// F_NOSOLIDS: a solid-free scene (PairConfig.solids_present False) — the
// plain path has no artificial-stress force and no BVF phi/nw there, and
// its tables no inv_wdelta, so the body skips both and leaves phi/nw 0
constexpr int F_PSWITCH = 1, F_XSPH = 2, F_FREE = 4, F_NOSOLIDS = 8,
              F_G0PAIR = 16;
// the rows add_species_flux reads by tv's names
static_assert(R_V == tv::R_V && R_VEST == tv::R_VEST && R_RHO == tv::R_RHO &&
                  R_MRHO == tv::R_MRHO && T_H == tv::T_H,
              "the mechanics pack must match csrc/pass_a_tv.cuh");
// the diagonal factor (1 - 1/3) of the deviatoric strain, rounded to f32
// before the multiply as the plain path does
constexpr float kTwoThirds = (float)(1.0 - 1.0 / 3.0);

// the rows after MECH_PF_ROWS and after MECH_ACC_ROWS of one instantiation
template <bool FILTER, bool ELASTIC, int NS>
struct Rows {
  static constexpr int S = R_STRESS + 9;                      // ELASTIC only
  static constexpr int RHOI = R_STRESS + (ELASTIC ? 18 : 1);  // FILTER only
  static constexpr int C = RHOI + (FILTER ? 1 : 0);           // NS > 0 only
  static constexpr int E = C + NS;            // THERMAL only; the tag next
  static constexpr int AUX = O_DS + (ELASTIC ? 9 : 0);        // FILTER only
  static constexpr int Q = AUX + (FILTER ? 2 : 0);            // NS > 0 only
  static constexpr int A = Q + NS;                            // accumulators
};

// every (FILTER, ELASTIC, NS, THERMAL) instantiation, for the C entry
// points' dispatch
#define MECH_FOR_EACH_NS(X, F, E, T) \
  X(F, E, 0, T) X(F, E, 1, T) X(F, E, 2, T) X(F, E, 3, T) X(F, E, 4, T)
#define MECH_FOR_EACH_FE(X, T)                                            \
  MECH_FOR_EACH_NS(X, false, false, T) MECH_FOR_EACH_NS(X, false, true, T) \
  MECH_FOR_EACH_NS(X, true, false, T) MECH_FOR_EACH_NS(X, true, true, T)
#define MECH_FOR_EACH_VARIANT(X) MECH_FOR_EACH_FE(X, false) MECH_FOR_EACH_FE(X, true)
static_assert(tv::kMaxSpecies == 4, "MECH_FOR_EACH_NS lists NS = 0..4");
constexpr int variant_key(bool filter, bool elastic, int ns, bool thermal) {
  return 4 * ns + (filter ? 2 : 0) + (elastic ? 1 : 0) + (thermal ? 20 : 0);
}

// What a launch holds fixed: the runtime switches, the type-pair count,
// the density-diffusion amplitude (PairConfig.ampl_damp; 0: no such
// term), the species advection correction (PairConfig.species_advection),
// the periodic axes and the thermal noise's per-launch inputs.
struct Ctx {
  int ntypes, tt, advect;
  bool pswitch, xsph, free_solids, g0pair, solids;
  float ampl;
  tv::Wrap wrap;
  tv::Noise noise;
};

__device__ __forceinline__ Ctx make_ctx(int ntypes, int flags, int advect,
                                        float ampl, const tv::Wrap& wrap) {
  Ctx x;
  x.ntypes = ntypes;
  x.tt = ntypes * ntypes;
  x.advect = advect;
  x.pswitch = flags & F_PSWITCH;
  x.xsph = flags & F_XSPH;
  x.free_solids = flags & F_FREE;
  x.g0pair = flags & F_G0PAIR;
  x.solids = !(flags & F_NOSOLIDS);
  x.ampl = ampl;
  x.wrap = wrap;
  x.noise = tv::Noise{};
  return x;
}

// the i-side values every pair of a thread reads
template <bool ELASTIC, int NS>
struct ISide {
  int ti;
  bool solid, solid_branch;
  float x[3], v[3], e[3], b[3];  // b = v - vest
  float rho, m, B, P, V2, c0, inv_rho, inv2;
  float C[NS > 0 ? NS : 1];
  float energy;  // thermal noise only
  int tag;       // thermal noise only
  // the artificial-stress tensor (ASd alone without ELASTIC), the
  // deviatoric tensor, G0, and the exact gates
  float AS[ELASTIC ? 9 : 1], S[ELASTIC ? 9 : 1];
  float G0;
  bool as_nz, elastic;
};

template <bool FILTER, bool ELASTIC, int NS, bool THERMAL>
__device__ __forceinline__ ISide<ELASTIC, NS> load_i(const float* __restrict__ pf,
                                                     long long m, long long s,
                                                     const Ctx& ctx) {
  using R = Rows<FILTER, ELASTIC, NS>;
  auto ld = [&](int row) { return tv::ld(pf, m, row, s); };
  ISide<ELASTIC, NS> I;
  I.ti = (int)ld(R_PTYPE);
  I.solid = ld(R_SOLID) != 0.f;
  I.solid_branch = ctx.free_solids && I.solid;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    I.x[a] = ld(R_X + a);
    I.v[a] = ld(R_V + a);
    I.e[a] = ld(R_VEST + a);
    I.b[a] = I.v[a] - I.e[a];
  }
  I.rho = ld(R_RHO);
  I.m = ld(R_M);
  I.B = ld(R_B);
  I.P = ld(R_PRHO2);
  I.V2 = ld(R_V2);
  I.c0 = ld(R_C0);
  I.inv_rho = ld(R_INVRHO);
  I.inv2 = I.inv_rho * I.inv_rho;
  if constexpr (NS > 0) {
#pragma unroll
    for (int c = 0; c < NS; ++c) I.C[c] = ld(R::C + c);
  }
  I.energy = 0.f;
  I.tag = 0;
  if constexpr (THERMAL) {
    I.energy = ld(R::E);
    I.tag = __float_as_int(ld(R::E + 1));
  }
  I.G0 = 0.f;
  I.as_nz = false;
  I.elastic = false;
  if constexpr (ELASTIC) {
    bool s_nz = false;
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      I.AS[q] = ld(R_STRESS + q);
      I.S[q] = ld(R::S + q);
      I.as_nz |= I.AS[q] != 0.f;
      s_nz |= I.S[q] != 0.f;
    }
    // dS is exactly 0 unless i is a solid with G0 != 0 or S != 0
    I.G0 = ld(R_G0);
    I.elastic = I.solid && (I.G0 != 0.f || s_nz);
  } else {
    I.AS[0] = ld(R_STRESS);
  }
  return I;
}

// add the pair (i, j = slot k) to acc; the caller has checked that j is
// valid and not i.  DIM: the grid's, for the thermal noise (THERMAL) only;
// L: where j's rows are read (tv::Global or, in K4, tv::Shared).
template <bool FILTER, bool ELASTIC, int NS, bool THERMAL, int DIM,
          class L = tv::Global>
__device__ __forceinline__ void add_pair(const float* __restrict__ pf,
                                         long long m, long long k,
                                         const float* __restrict__ tab,
                                         const float* __restrict__ stab,
                                         const Ctx& ctx,
                                         const ISide<ELASTIC, NS>& I,
                                         float* acc) {
  using R = Rows<FILTER, ELASTIC, NS>;
  auto ld = [&](int row) { return L::ld(pf, m, row, k); };
  const int tt = ctx.tt;
  auto tb = [&](int row, int tp) { return __ldg(tab + row * tt + tp); };

  float dx[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) dx[a] = I.x[a] - ld(R_X + a);
  if (ctx.wrap.axes) {  // the minimum image on the periodic axes (unfused)
#pragma unroll
    for (int a = 0; a < 3; ++a)
      if (ctx.wrap.axes & (1 << a)) dx[a] = tv::min_image(dx[a], ctx.wrap.l[a]);
  }
  const float rsq = dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2];
  const float r = sqrtf(rsq);
  const int tp = I.ti * ctx.ntypes + (int)ld(R_PTYPE);
  // the species flux has its own support: before the test against h
  if constexpr (NS > 0)
    tv::add_species_flux<NS, L>(pf, m, k, stab, ctx.advect, tt, tp, R::C,
                                dx[0], dx[1], dx[2], rsq, r, I.inv_rho, I.C,
                                I.b, acc + R::Q);
  const float q = r * tb(T_INVH, tp);
  const float t = fmaxf(1.f - q, 0.f);
  if (t == 0.f) return;  // outside the support: every term is 0
  const float wfd = tb(T_CWFD, tp) * t * t;
  const float wf = tb(T_CWF, tp) * t * t * t * (1.f + 3.f * q);

  const float mj = ld(R_M), rhoj = ld(R_RHO), Vj2 = ld(R_V2);
  const bool solid_j = ld(R_SOLID) != 0.f;
  float vj[3], ej[3], vv[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    vj[a] = ld(R_V + a);
    ej[a] = ld(R_VEST + a);
    vv[a] = I.e[a] - ej[a];  // momentum-velocity difference
  }

  // ---- sweep 1
  acc[O_NUMDEN] += Vj2 * wf;
  if constexpr (FILTER) {
    acc[R::AUX] += ld(R::RHOI) * wf;
    acc[R::AUX + 1] += wf;
  }
  const float vsum = I.V2 + Vj2;
  const float ddv_coef = 70.f * I.B * vsum * wfd;
#pragma unroll
  for (int a = 0; a < 3; ++a) acc[O_DDV + a] += ddv_coef * dx[a];
  if (ctx.xsph) {
    const float xw = Vj2 * wf;
#pragma unroll
    for (int a = 0; a < 3; ++a) acc[O_DDX + a] += xw * (ej[a] - I.e[a]);
  }

  // ---- sweep 2
  const float delVdotDelR = dx[0] * vv[0] + dx[1] * vv[1] + dx[2] * vv[2];
  const float ti_s = I.rho * (I.b[0] * dx[0] + I.b[1] * dx[1] + I.b[2] * dx[2]);
  const float tj_s = rhoj * ((vj[0] - ej[0]) * dx[0] + (vj[1] - ej[1]) * dx[1] +
                             (vj[2] - ej[2]) * dx[2]);
  const float fvisc = vsum * tb(T_ETA, tp) * wfd;
  const float Pj = ld(R_PRHO2);
  float fpair;
  if (ctx.pswitch) {
    const float sgn = (Pj + I.P >= 0.f || (I.solid && solid_j)) ? 1.f : -1.f;
    fpair = I.m * mj * (Pj + sgn * I.P) * wfd;
  } else {
    fpair = I.m * mj * (Pj + I.P) * wfd;
  }

  // artificial-stress force: mi mj wfd (wf/wdelta)^4 dx.(AS_i + AS_j)
  // (a solid-free scene has no such term)
  float fart[3] = {0.f, 0.f, 0.f};
  if (ctx.solids) {
    const float w = wf * tb(T_INVWD, tp);
    const float w2 = w * w;
    const float as_coef = I.m * mj * wfd * (w2 * w2);
    if constexpr (ELASTIC) {
      if (I.solid || solid_j) {  // AS is 0 on fluids
        float ASs[9];
        bool nz = I.as_nz;
#pragma unroll
        for (int e = 0; e < 9; ++e) {
          const float asj = ld(R_STRESS + e);
          nz |= asj != 0.f;
          ASs[e] = I.AS[e] + asj;
        }
        if (nz) {
#pragma unroll
          for (int a = 0; a < 3; ++a)
            fart[a] = as_coef * (dx[0] * ASs[a] + dx[1] * ASs[3 + a] +
                                 dx[2] * ASs[6 + a]);
        }
      }
    } else {
      const float asum = as_coef * (I.AS[0] + ld(R_STRESS));
#pragma unroll
      for (int a = 0; a < 3; ++a) fart[a] = asum * dx[a];
    }
  }

  if (I.solid_branch) {
    // solid-branch force: pressure, Pereira viscosity, deviatoric
    float fdev[3] = {0.f, 0.f, 0.f};
    if constexpr (ELASTIC) {
      const float inv_rhoj = ld(R_INVRHO);
      const float inv_j2 = inv_rhoj * inv_rhoj;
      const float mmw = I.m * mj * wfd;
      float Ss[9];
#pragma unroll
      for (int e = 0; e < 9; ++e) Ss[e] = I.S[e] * I.inv2 + ld(R::S + e) * inv_j2;
#pragma unroll
      for (int a = 0; a < 3; ++a)
        fdev[a] = mmw * (dx[0] * Ss[a] + dx[1] * Ss[3 + a] + dx[2] * Ss[6 + a]);
    }
    float fviscs = 0.f;
    if (delVdotDelR < 0.f) {
      const float h = tb(T_H, tp);
      const float mu = h * delVdotDelR / (rsq + 0.01f * h * h);
      fviscs = I.m * mj * wfd * (-(I.c0 + ld(R_C0)) * mu + 2.f * mu * mu) /
               (I.rho + rhoj);
    }
    const float fdx = -fpair - fviscs;
#pragma unroll
    for (int a = 0; a < 3; ++a) acc[O_F + a] += fdx * dx[a] + fdev[a] + fart[a];
  } else {
    const float vw = vsum * wfd;
#pragma unroll
    for (int a = 0; a < 3; ++a)
      acc[O_F + a] += -fpair * dx[a] + fvisc * vv[a] +
                      vw * (0.5f * (ti_s * I.e[a] + tj_s * ej[a])) + fart[a];
    if constexpr (THERMAL)
      tv::add_thermal<DIM>(ctx.noise, I.tag, __float_as_int(ld(R::E + 1)),
                           I.energy, I.m, mj, wfd, I.inv_rho, ld(R_INVRHO), r,
                           tb(T_H, tp), dx, acc + O_F);
  }

  // Jaumann deviatoric stress rate (solid i with G0 != 0 or S != 0)
  if constexpr (ELASTIC) {
    if (I.elastic) {
      const float pref = 0.5f * ld(R_MRHO) * wfd;
      float two_geff;
      if (ctx.g0pair) {  // harmonic mean of the softened moduli of i, j
        const float G0j = ld(R_G0);
        two_geff = 2.f * (2.f * I.G0 * G0j / (I.G0 + G0j + 1e-12f));
      } else {
        two_geff = 2.f * tb(T_GEFF, tp);
      }
      float dv[3], strain[9], rot[9];
#pragma unroll
      for (int a = 0; a < 3; ++a) dv[a] = ej[a] - I.e[a];
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          const float ab = dv[a] * dx[b], ba = dv[b] * dx[a];
          strain[3 * a + b] = pref * (ab + ba);
          rot[3 * a + b] = pref * (ab - ba);
        }
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          const float el = a == b ? two_geff * strain[3 * a + b] * kTwoThirds
                                  : two_geff * strain[3 * a + b];
          float sdr = 0.f, rds = 0.f;
#pragma unroll
          for (int e = 0; e < 3; ++e) {
            sdr += I.S[3 * a + e] * rot[3 * b + e];
            rds += rot[3 * a + e] * I.S[3 * e + b];
          }
          acc[O_DS + 3 * a + b] += el + sdr + rds;
        }
    }
  }

  // density evolution: corr = rho (vest - v).dx = -ti_s / -tj_s
  const float mrhoj = ld(R_MRHO);
  const float delVt = dx[0] * (I.v[0] - vj[0]) + dx[1] * (I.v[1] - vj[1]) +
                      dx[2] * (I.v[2] - vj[2]);
  acc[O_DRHO] += I.rho * delVt * wfd * mrhoj + mrhoj * (ti_s + tj_s) * wfd;
  if (ctx.ampl != 0.f) {  // density diffusion of the fsi pair style
    const float h = tb(T_H, tp);
    acc[O_DRHO] -= ctx.ampl * h * I.c0 * 2.f * (rhoj - I.rho) *
                   (rsq / (rsq + 0.01f * h * h)) * wfd * mrhoj;
  }

  acc[O_DE] += -0.5f * (fpair * delVdotDelR +
                        fvisc * (vv[0] * vv[0] + vv[1] * vv[1] + vv[2] * vv[2]));

  // BVF volume fraction and wall normal: fluid i, solid j (0 in a
  // solid-free scene)
  if (ctx.solids && !I.solid && solid_j) {
    acc[O_PHI] += Vj2 * wf;
    const float nwc = wfd * Vj2;
#pragma unroll
    for (int a = 0; a < 3; ++a) acc[O_NW + a] += nwc * dx[a];
  }
}

}  // namespace mech
