// K2 — 2D pass A of the SPH-BVF pair physics for crowded and mixed-lattice
// grids, one thread per (slot i, cell c).
//
// Replaces sph_bvf_tpu/ops/pair_pallas.py `_call_padded`, rowloop branch (the
// TPU kernel that carries the FSI beam: occupancy-gated i/j tiles, an
// elastic-gated dS pass and a window-gated pass for the elastic forces).  For
// every valid slot i it sums ops/pair.py `_pass_a_offset` over the valid j of
// the 3x3 stencil cells, j != i: the transport-velocity (pressure switch) or
// mechanics (symmetric pressure) force, XSPH, BVF walls, free solids with the
// Pereira artificial viscosity, elastic solids (the 9-component artificial
// stress, the deviatoric solid force and the Jaumann rate dS), solid-free
// scenes (F_NOSOLIDS: the load-balance blob), periodic x and y axes, with
// (FILTER) or without the Shepard-filter accumulators; and the fsi pair
// style of cell polarization: the density-diffusion term of drho (ampl), the
// shear modulus softened per particle (F_G0PAIR: geff of a pair from the
// packed G0 row of i and j, not from the type table) and NS continuum
// species (the tSDPD flux Q of the C rows, csrc/pass_a_tv.cuh
// `add_species_flux`, inside its own support cutc and so before the test
// against h), and (THERMAL) the SDPD thermal noise on the fluid branch
// (csrc/pass_a_tv.cuh `add_thermal`).  The plain PyTorch version is
// sph_bvf_tpu_torch/ops/pair.py `_pass_a_plain`.
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
// its first empty slot.  The elastic gates become per-thread branches that
// are exact too: dS only for a solid i with G0 > 0 or S != 0 (it is exactly
// 0 otherwise: geff carries G0_i, the rotation terms carry S_i), f_art only
// when a side is solid and AS_i + AS_j != 0 (AS is 0 on fluids), f_dev only
// in the solid branch.  Accumulators stay in registers, neighbouring threads
// take neighbouring cells of one slot row so every load of the [F, cap, NC]
// pack is coalesced, and a candidate outside the kernel support skips all
// arithmetic (every term carries W or dW/dr, exactly 0 there).  A periodic
// axis (x, y or both; the TPU kernel builds ghost columns for y,
// pair_pallas.py:359-365) wraps the neighbour cell by index and takes the
// minimum image dx - L * rint(dx / L) with round-to-nearest-even and unfused
// arithmetic, as torch.round does (csrc/pass_a_tv.cuh `min_image`).  NS is a
// template parameter (0..4, as in K1 and K3): the Q sums stay in registers
// and the NS = 0 code has no species.
// THERMAL is one too: the instantiations without noise carry no hash code.
//
// Layouts (kept in step with sph_bvf_tpu_torch/ops/pair_cuda.py):
//   pf   f32 [F, cap, NC]: K2_PF_ROWS, then AS(9), S(9) (ELASTIC) or ASd,
//        then rhoI (FILTER), then C (NS), then e and tag (THERMAL; tag as the
//        int32 bits)
//   tab  f32 [7, T*T]: inv_h, eta, inv_wdelta, W' factor, W factor, h, geff
//   stab f32 [4 + NS, T*T] (NS > 0): the species table of csrc/pass_a_tv.cuh
//   out  f32 [A, cap, NC]: K2_ACC_ROWS, then dS(9) (ELASTIC), then rhoAux1,
//        rhoAux2 (FILTER), then Q (NS)
// Flat cell c = cx * ny + cy; the grid has one cell along z.

#include <cuda_runtime.h>

#include "pass_a_tv.cuh"

namespace {

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
// its tables no inv_wdelta, so the kernel skips both and leaves phi/nw 0
constexpr int F_PSWITCH = 1, F_XSPH = 2, F_FREE = 4, F_WRAPX = 8,
              F_NOSOLIDS = 16, F_WRAPY = 32, F_G0PAIR = 64;
// the rows add_species_flux reads by tv's names
static_assert(R_V == tv::R_V && R_VEST == tv::R_VEST && R_RHO == tv::R_RHO &&
                  R_MRHO == tv::R_MRHO && T_H == tv::T_H,
              "K2's packed rows must match csrc/pass_a_tv.cuh");
constexpr int kThreads = 128;
// the diagonal factor (1 - 1/3) of the deviatoric strain, rounded to f32
// before the multiply as the plain path does
constexpr float kTwoThirds = (float)(1.0 - 1.0 / 3.0);

// ampl: PairConfig.ampl_damp, the density-diffusion amplitude (0: no such
// term); advect: PairConfig.species_advection; lx, ly: the periodic extents;
// dt, step, key, rng_seed, neg4kb: the thermal noise's inputs (THERMAL), as
// csrc/pass_a_2d.cu takes them
template <bool FILTER, bool ELASTIC, int NS, bool THERMAL>
__global__ void __launch_bounds__(kThreads) pass_a_2d_rowloop_kernel(
    const float* __restrict__ pf, const float* __restrict__ tab,
    const float* __restrict__ stab, float* __restrict__ out,
    const float* __restrict__ dt, const int* __restrict__ step,
    const long long* __restrict__ key, unsigned rng_seed, float neg4kb,
    int ntypes, int cap, int nx, int ny, int flags, int advect, float lx,
    float ly, float ampl) {
  constexpr int R_S = R_STRESS + 9;                      // ELASTIC only
  constexpr int R_RHOI = R_STRESS + (ELASTIC ? 18 : 1);  // FILTER only
  constexpr int R_C = R_RHOI + (FILTER ? 1 : 0);         // NS > 0 only
  constexpr int R_E = R_C + NS;                          // THERMAL only; tag next
  constexpr int O_AUX = O_DS + (ELASTIC ? 9 : 0);        // FILTER only
  constexpr int O_Q = O_AUX + (FILTER ? 2 : 0);          // NS > 0 only
  constexpr int A = O_Q + NS;
  const int nc = nx * ny;
  const int m = cap * nc;  // slots per field row
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= m) return;
  const int c = s % nc;
  const int cx = c / ny, cy = c - cx * ny;
  const int tt = ntypes * ntypes;
  const bool pswitch = flags & F_PSWITCH, xsph = flags & F_XSPH,
             free_solids = flags & F_FREE, wrapx = flags & F_WRAPX,
             wrapy = flags & F_WRAPY, g0pair = flags & F_G0PAIR,
             solids = !(flags & F_NOSOLIDS);
  auto ld = [&](int row, int slot) { return __ldg(pf + (long long)row * m + slot); };
  auto tb = [&](int row, int tp) { return __ldg(tab + row * tt + tp); };

  float acc[A];
#pragma unroll
  for (int a = 0; a < A; ++a) acc[a] = 0.f;

  // slots at or above the cell's occupancy are invalid: nothing to sum
  if (ld(R_VALID, s) != 0.f) {
    const int ti = (int)ld(R_PTYPE, s);
    const bool solid_i = ld(R_SOLID, s) != 0.f;
    const bool solid_branch = free_solids && solid_i;
    float xi[3], vi[3], ei[3], bi[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      xi[a] = ld(R_X + a, s);
      vi[a] = ld(R_V + a, s);
      ei[a] = ld(R_VEST + a, s);
      bi[a] = vi[a] - ei[a];  // v - vest of i
    }
    const float rhoi = ld(R_RHO, s), mi = ld(R_M, s), Bi = ld(R_B, s);
    const float Pi = ld(R_PRHO2, s), Vi2 = ld(R_V2, s), c0i = ld(R_C0, s);
    const float inv_rhoi = ld(R_INVRHO, s);
    const float inv_i2 = inv_rhoi * inv_rhoi;
    float Ci[NS > 0 ? NS : 1];
    if constexpr (NS > 0) {
#pragma unroll
      for (int c = 0; c < NS; ++c) Ci[c] = ld(R_C + c, s);
    }
    tv::Noise noise{};
    float energy_i = 0.f;
    int tagi = 0;
    if constexpr (THERMAL) {
      noise = tv::load_noise(dt, step, key, rng_seed, neg4kb);
      energy_i = ld(R_E, s);
      tagi = __float_as_int(ld(R_E + 1, s));
    }

    // i-side stress: the artificial-stress tensor, the deviatoric tensor
    float ASi[ELASTIC ? 9 : 1], Si[ELASTIC ? 9 : 1];
    float G0i = 0.f;
    bool as_i = false, elastic_i = false;
    if constexpr (ELASTIC) {
      bool s_nz = false;
#pragma unroll
      for (int q = 0; q < 9; ++q) {
        ASi[q] = ld(R_STRESS + q, s);
        Si[q] = ld(R_S + q, s);
        as_i |= ASi[q] != 0.f;
        s_nz |= Si[q] != 0.f;
      }
      // dS is exactly 0 unless i is a solid with G0 != 0 or S != 0.  With
      // F_G0PAIR the row holds G0 (1 - 0.99 C): positive while C < 1/0.99,
      // exactly 0 at a type without shear modulus, and negative beyond
      // (an unphysical concentration; the plain path then sums a negative
      // geff, and so does this kernel: the gate is != 0, not > 0)
      G0i = ld(R_G0, s);
      elastic_i = solid_i && (G0i != 0.f || s_nz);
    } else {
      ASi[0] = ld(R_STRESS, s);
    }

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
          const int k = j * nc + cj;
          // compacted slots: the first empty one ends the cell
          if (ld(R_VALID, k) == 0.f) break;
          if (k == s) continue;  // the self pair (zero offset, j == i)
          float dx[3];
#pragma unroll
          for (int a = 0; a < 3; ++a) dx[a] = xi[a] - ld(R_X + a, k);
          if (wrapx) dx[0] = tv::min_image(dx[0], lx);  // unfused, as the plain path
          if (wrapy) dx[1] = tv::min_image(dx[1], ly);
          const float rsq = dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2];
          const float r = sqrtf(rsq);
          const int tp = ti * ntypes + (int)ld(R_PTYPE, k);
          // the species flux has its own support: before the test against h
          if constexpr (NS > 0)
            tv::add_species_flux<NS>(pf, m, k, stab, advect, tt, tp, R_C, dx[0],
                                     dx[1], dx[2], rsq, r, inv_rhoi, Ci, bi,
                                     acc + O_Q);
          const float q = r * tb(T_INVH, tp);
          const float t = fmaxf(1.f - q, 0.f);
          if (t == 0.f) continue;  // outside the support: every term is 0
          const float wfd = tb(T_CWFD, tp) * t * t;
          const float wf = tb(T_CWF, tp) * t * t * t * (1.f + 3.f * q);

          const float mj = ld(R_M, k), rhoj = ld(R_RHO, k), Vj2 = ld(R_V2, k);
          const bool solid_j = ld(R_SOLID, k) != 0.f;
          float vj[3], ej[3], vv[3];
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            vj[a] = ld(R_V + a, k);
            ej[a] = ld(R_VEST + a, k);
            vv[a] = ei[a] - ej[a];  // momentum-velocity difference
          }

          // ---- sweep 1
          acc[O_NUMDEN] += Vj2 * wf;
          if constexpr (FILTER) {
            acc[O_AUX] += ld(R_RHOI, k) * wf;
            acc[O_AUX + 1] += wf;
          }
          const float vsum = Vi2 + Vj2;
          const float ddv_coef = 70.f * Bi * vsum * wfd;
#pragma unroll
          for (int a = 0; a < 3; ++a) acc[O_DDV + a] += ddv_coef * dx[a];
          if (xsph) {
            const float xw = Vj2 * wf;
#pragma unroll
            for (int a = 0; a < 3; ++a) acc[O_DDX + a] += xw * (ej[a] - ei[a]);
          }

          // ---- sweep 2
          const float delVdotDelR = dx[0] * vv[0] + dx[1] * vv[1] + dx[2] * vv[2];
          const float ti_s = rhoi * (bi[0] * dx[0] + bi[1] * dx[1] + bi[2] * dx[2]);
          const float tj_s = rhoj * ((vj[0] - ej[0]) * dx[0] + (vj[1] - ej[1]) * dx[1] +
                                     (vj[2] - ej[2]) * dx[2]);
          const float fvisc = vsum * tb(T_ETA, tp) * wfd;
          const float Pj = ld(R_PRHO2, k);
          float fpair;
          if (pswitch) {
            const float sgn = (Pj + Pi >= 0.f || (solid_i && solid_j)) ? 1.f : -1.f;
            fpair = mi * mj * (Pj + sgn * Pi) * wfd;
          } else {
            fpair = mi * mj * (Pj + Pi) * wfd;
          }

          // artificial-stress force: mi mj wfd (wf/wdelta)^4 dx.(AS_i + AS_j)
          // (a solid-free scene has no such term)
          float fart[3] = {0.f, 0.f, 0.f};
          if (solids) {
            const float w = wf * tb(T_INVWD, tp);
            const float w2 = w * w;
            const float as_coef = mi * mj * wfd * (w2 * w2);
            if constexpr (ELASTIC) {
              if (solid_i || solid_j) {  // AS is 0 on fluids
                float ASs[9];
                bool nz = as_i;
#pragma unroll
                for (int e = 0; e < 9; ++e) {
                  const float asj = ld(R_STRESS + e, k);
                  nz |= asj != 0.f;
                  ASs[e] = ASi[e] + asj;
                }
                if (nz) {
#pragma unroll
                  for (int a = 0; a < 3; ++a)
                    fart[a] = as_coef * (dx[0] * ASs[a] + dx[1] * ASs[3 + a] +
                                         dx[2] * ASs[6 + a]);
                }
              }
            } else {
              const float asum = as_coef * (ASi[0] + ld(R_STRESS, k));
#pragma unroll
              for (int a = 0; a < 3; ++a) fart[a] = asum * dx[a];
            }
          }

          if (solid_branch) {
            // solid-branch force: pressure, Pereira viscosity, deviatoric
            float fdev[3] = {0.f, 0.f, 0.f};
            if constexpr (ELASTIC) {
              const float inv_rhoj = ld(R_INVRHO, k);
              const float inv_j2 = inv_rhoj * inv_rhoj;
              const float mmw = mi * mj * wfd;
              float Ss[9];
#pragma unroll
              for (int e = 0; e < 9; ++e)
                Ss[e] = Si[e] * inv_i2 + ld(R_S + e, k) * inv_j2;
#pragma unroll
              for (int a = 0; a < 3; ++a)
                fdev[a] = mmw * (dx[0] * Ss[a] + dx[1] * Ss[3 + a] + dx[2] * Ss[6 + a]);
            }
            float fviscs = 0.f;
            if (delVdotDelR < 0.f) {
              const float h = tb(T_H, tp);
              const float mu = h * delVdotDelR / (rsq + 0.01f * h * h);
              fviscs = mi * mj * wfd * (-(c0i + ld(R_C0, k)) * mu + 2.f * mu * mu) /
                       (rhoi + rhoj);
            }
            const float fdx = -fpair - fviscs;
#pragma unroll
            for (int a = 0; a < 3; ++a) acc[O_F + a] += fdx * dx[a] + fdev[a] + fart[a];
          } else {
            const float vw = vsum * wfd;
#pragma unroll
            for (int a = 0; a < 3; ++a)
              acc[O_F + a] += -fpair * dx[a] + fvisc * vv[a] +
                              vw * (0.5f * (ti_s * ei[a] + tj_s * ej[a])) + fart[a];
            if constexpr (THERMAL)
              tv::add_thermal<2>(noise, tagi, __float_as_int(ld(R_E + 1, k)),
                                 energy_i, mi, mj, wfd, inv_rhoi, ld(R_INVRHO, k),
                                 r, tb(T_H, tp), dx, acc + O_F);
          }

          // Jaumann deviatoric stress rate (solid i with G0 > 0 or S != 0)
          if constexpr (ELASTIC) {
            if (elastic_i) {
              const float pref = 0.5f * ld(R_MRHO, k) * wfd;
              float two_geff;
              if (g0pair) {  // harmonic mean of the softened moduli of i, j
                const float G0j = ld(R_G0, k);
                two_geff = 2.f * (2.f * G0i * G0j / (G0i + G0j + 1e-12f));
              } else {
                two_geff = 2.f * tb(T_GEFF, tp);
              }
              float dv[3], strain[9], rot[9];
#pragma unroll
              for (int a = 0; a < 3; ++a) dv[a] = ej[a] - ei[a];
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
                    sdr += Si[3 * a + e] * rot[3 * b + e];
                    rds += rot[3 * a + e] * Si[3 * e + b];
                  }
                  acc[O_DS + 3 * a + b] += el + sdr + rds;
                }
            }
          }

          // density evolution: corr = rho (vest - v).dx = -ti_s / -tj_s
          const float mrhoj = ld(R_MRHO, k);
          const float delVt = dx[0] * (vi[0] - vj[0]) + dx[1] * (vi[1] - vj[1]) +
                              dx[2] * (vi[2] - vj[2]);
          acc[O_DRHO] += rhoi * delVt * wfd * mrhoj + mrhoj * (ti_s + tj_s) * wfd;
          if (ampl != 0.f) {  // density diffusion of the fsi pair style
            const float h = tb(T_H, tp);
            acc[O_DRHO] -= ampl * h * c0i * 2.f * (rhoj - rhoi) *
                           (rsq / (rsq + 0.01f * h * h)) * wfd * mrhoj;
          }

          acc[O_DE] += -0.5f * (fpair * delVdotDelR +
                                fvisc * (vv[0] * vv[0] + vv[1] * vv[1] + vv[2] * vv[2]));

          // BVF volume fraction and wall normal: fluid i, solid j (0 in a
          // solid-free scene)
          if (solids && !solid_i && solid_j) {
            acc[O_PHI] += Vj2 * wf;
            const float nwc = wfd * Vj2;
#pragma unroll
            for (int a = 0; a < 3; ++a) acc[O_NW + a] += nwc * dx[a];
          }
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < A; ++a) out[(long long)a * m + s] = acc[a];
}

// every (FILTER, ELASTIC, NS, THERMAL) instantiation, for the C entry points'
// dispatch
#define K2_FOR_EACH_NS(X, F, E, T) \
  X(F, E, 0, T) X(F, E, 1, T) X(F, E, 2, T) X(F, E, 3, T) X(F, E, 4, T)
#define K2_FOR_EACH_FE(X, T)                                          \
  K2_FOR_EACH_NS(X, false, false, T) K2_FOR_EACH_NS(X, false, true, T) \
  K2_FOR_EACH_NS(X, true, false, T) K2_FOR_EACH_NS(X, true, true, T)
#define K2_FOR_EACH_VARIANT(X) K2_FOR_EACH_FE(X, false) K2_FOR_EACH_FE(X, true)
static_assert(tv::kMaxSpecies == 4, "K2_FOR_EACH_NS lists NS = 0..4");
constexpr int variant_key(bool filter, bool elastic, int ns, bool thermal) {
  return 4 * ns + (filter ? 2 : 0) + (elastic ? 1 : 0) + (thermal ? 20 : 0);
}

}  // namespace

// filter, elastic, thermal: the template switches; ns: the species count
// (stab is read only when ns > 0); flags: F_*; advect, lx, ly, ampl and the
// noise's inputs: see the kernel
extern "C" int pass_a_2d_rowloop(const float* pf, const float* tab,
                                 const float* stab, float* out, int ntypes,
                                 int ns, int advect, int cap, int nx, int ny,
                                 int filter, int elastic, int flags, float lx,
                                 float ly, float ampl, int thermal,
                                 const float* dt, const int* step,
                                 const long long* key, unsigned rng_seed,
                                 float neg4kb, cudaStream_t stream) {
  const long long m = (long long)cap * nx * ny;
  if (m == 0) return 0;
  const unsigned blocks = (unsigned)((m + kThreads - 1) / kThreads);
  switch (variant_key(filter != 0, elastic != 0, ns, thermal != 0)) {
#define X(F, E, N, T)                                                      \
  case variant_key(F, E, N, T):                                            \
    pass_a_2d_rowloop_kernel<F, E, N, T><<<blocks, kThreads, 0, stream>>>( \
        pf, tab, stab, out, dt, step, key, rng_seed, neg4kb, ntypes, cap,  \
        nx, ny, flags, advect, lx, ly, ampl);                              \
    break;
    K2_FOR_EACH_VARIANT(X)
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
  switch (variant_key(filter != 0, elastic != 0, ns, thermal != 0)) {
#define X(F, E, N, T)                                                          \
  case variant_key(F, E, N, T):                                                \
    err = cudaFuncGetAttributes(&attr, pass_a_2d_rowloop_kernel<F, E, N, T>);  \
    break;
    K2_FOR_EACH_VARIANT(X)
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
