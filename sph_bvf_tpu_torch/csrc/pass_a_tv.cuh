// The transport-velocity pass-A pair term, the leaner body of K1, K4 and K3
// (csrc/pass_a_2d.cuh, K4 launching K1's, csrc/pass_a_3d.cu): the
// packed-row layout, the i-side values a thread loads once, and the
// accumulation of one (i, j) pair.  Its species flux (`add_species_flux`,
// the species table and kMaxSpecies), its thermal noise (`Noise`,
// `load_noise`, `add_thermal`), its minimum image (`min_image`, `Wrap`) and
// its cell wrap (`wrap_cell`) also serve the pair body K2 and K3 share
// (csrc/pass_a_mech.cuh).
//
// It is ops/pair.py `_pass_a_offset` for one pair under the configuration
// this body serves: the transport-velocity pressure switch, fixed BVF wall
// solids, the diagonal artificial stress of non-elastic solids, with
// (FILTER) or without the Shepard-filter accumulators rhoAux1/rhoAux2, with
// NS continuum species (the tSDPD flux Q of the concentrations C), and with
// (THERMAL) or without the SDPD thermal noise; `add_pair` also takes the
// minimum image on periodic axes (K3's; in 2D none).  A candidate
// outside the kernel support h skips the mechanics arithmetic, which changes
// no sum because every term carries a factor W or dW/dr that is exactly zero
// there.  The species flux has its own support cutc (a separate per-pair
// table, larger or smaller than h): it is tested and summed on its own,
// before the test against h.
//
// NS is a template parameter, instantiated for 0..kMaxSpecies: the Q sums
// stay in registers beside the others (a runtime species count would index
// the accumulator array dynamically and push it to local memory), and the
// NS = 0 instantiation carries no species code at all.  Beyond kMaxSpecies
// the C entry points return cudaErrorInvalidValue and the Python wrapper
// raises before launching.
//
// THERMAL is a template parameter too, so the instantiations without noise
// carry no hash code.  The random force (`add_thermal`, which K2 shares) is
// ops/pair.py `_thermal_force` for one pair: the traceless symmetric matrix
// of dim (dim + 1) / 2 pair-symmetric normals (csrc/rand.cuh) times dx,
// scaled by sqrt(max(-4 kB e_i mi mj wfd / (rho_i rho_j) / dt, 0)) /
// (r + 0.01 h) in the plain path's order of operations.  It is drawn only
// inside the support h: outside it wfd, and so the prefactor, is exactly 0.
// dt, step and the PRNG key are read from the state's device tensors, so a
// step needs no host readback; tags travel as the int32 bits of an f32 row.
//
// Layouts (kept in step with sph_bvf_tpu_torch/ops/pair_cuda.py):
//   pf   f32 [F, cap, NC], F = 19 + FILTER + NS + 2 THERMAL: rows PF_ROWS, rhoI
//        (FILTER), then C, then e and tag (THERMAL)
//   tab  f32 [6, T*T]: inv_h, eta, inv_wdelta, W' factor, W factor, h per type
//        pair
//   stab f32 [4 + NS, T*T] (NS > 0): 1/cutc, the W' factor of cutc, twice the
//        harmonic mass, 0.01 cutc^2, then kappa of each species per type pair
//   acc  f32 [A], A = 13 + 2 FILTER + NS: rows ACC_ROWS, the filter rows
//        (FILTER), then Q

#pragma once

#include <cuda_runtime.h>

#include "rand.cuh"

namespace tv {

constexpr int R_VALID = 0, R_PTYPE = 1, R_SOLID = 2, R_X = 3, R_V = 6,
              R_VEST = 9, R_RHO = 12, R_M = 13, R_B = 14, R_PRHO2 = 15,
              R_MRHO = 16, R_V2 = 17, R_ASD = 18, R_RHOI = 19;
constexpr int O_NUMDEN = 0, O_DDV = 1, O_F = 4, O_DRHO = 7, O_DE = 8,
              O_PHI = 9, O_NW = 10, O_RHOAUX1 = 13, O_RHOAUX2 = 14;
constexpr int T_INVH = 0, T_ETA = 1, T_INVWD = 2, T_CWFD = 3, T_CWF = 4,
              T_H = 5;

constexpr int S_INVHC = 0, S_CWFD = 1, S_M2 = 2, S_HC2 = 3, S_KAPPA = 4;
constexpr int kMaxSpecies = 4;

// accumulator rows, and the first C row of pf and Q row of acc
template <bool FILTER, int NS>
constexpr int kAccs = (FILTER ? 15 : 13) + NS;
template <bool FILTER>
constexpr int kRowC = FILTER ? 20 : 19;
template <bool FILTER>
constexpr int kRowQ = FILTER ? 15 : 13;
// the e row of pf (THERMAL); the tag row follows it
template <bool FILTER, int NS>
constexpr int kRowE = kRowC<FILTER> + NS;

// every (FILTER, NS, THERMAL) instantiation, for the C entry points' dispatch
#define TV_FOR_EACH_NS(X, F, T) X(F, 0, T) X(F, 1, T) X(F, 2, T) X(F, 3, T) X(F, 4, T)
#define TV_FOR_EACH_VARIANT(X)                                             \
  TV_FOR_EACH_NS(X, false, false) TV_FOR_EACH_NS(X, true, false)           \
  TV_FOR_EACH_NS(X, false, true) TV_FOR_EACH_NS(X, true, true)
static_assert(kMaxSpecies == 4, "TV_FOR_EACH_NS lists NS = 0..4");
constexpr int variant_key(bool filter, int ns, bool thermal) {
  return 2 * ns + (filter ? 1 : 0) + (thermal ? 2 * (kMaxSpecies + 1) : 0);
}

// The thermal noise's per-launch inputs: the hash state after the words
// (seed, step), dt, and -4 kB rounded to f32 as the plain path rounds it.
struct Noise {
  uint32_t h;
  float dt, neg4kb;
};

// seed = rng_seed ^ key[0] ^ key[1] (the key holds two 32-bit words in int64)
__device__ __forceinline__ Noise load_noise(const float* __restrict__ dt,
                                            const int* __restrict__ step,
                                            const long long* __restrict__ key,
                                            unsigned rng_seed, float neg4kb) {
  Noise n;
  const uint32_t seed = rng_seed ^ (uint32_t)(__ldg(key) ^ __ldg(key + 1));
  n.h = rnd::absorb(rnd::absorb(rnd::kInit, seed), (uint32_t)__ldg(step));
  n.dt = __ldg(dt);
  n.neg4kb = neg4kb;
  return n;
}

// The SDPD random force of the pair (i, j) inside the support, added to
// f[0..DIM): pref W dx with W the traceless symmetric matrix of the normals
// of salts 0, 1, ... over its upper triangle, row by row.
template <int DIM>
__device__ __forceinline__ void add_thermal(const Noise& noise, int tag_i, int tag_j,
                                            float e_i, float mi, float mj,
                                            float wfd, float inv_rho_i,
                                            float inv_rho_j, float r, float h,
                                            const float* dx, float* f) {
  const float pref =
      sqrtf(fmaxf(noise.neg4kb * e_i * (mi * mj * wfd * inv_rho_i * inv_rho_j) / noise.dt,
                  0.f)) /
      (r + 0.01f * h);
  const uint32_t hp = rnd::absorb(rnd::absorb(noise.h, (uint32_t)min(tag_i, tag_j)),
                                  (uint32_t)max(tag_i, tag_j));
  float w[DIM][DIM];
  float tr = 0.f;
  uint32_t salt = 0;
#pragma unroll
  for (int a = 0; a < DIM; ++a)
#pragma unroll
    for (int b = a; b < DIM; ++b) w[a][b] = w[b][a] = rnd::normal(rnd::absorb(hp, salt++));
#pragma unroll
  for (int a = 0; a < DIM; ++a) tr += w[a][a];
  tr /= (float)DIM;
#pragma unroll
  for (int a = 0; a < DIM; ++a) w[a][a] -= tr;
#pragma unroll
  for (int l = 0; l < DIM; ++l) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < DIM; ++k) s += w[l][k] * dx[k];
    f[l] += pref * s;
  }
}

// The minimum image of the offset d along a periodic axis of extent l:
// d - l rint(d / l), as ops/pair.py `_pair_delta` computes it.  Unfused
// (an FMA would round once where the plain path rounds twice), and rintf
// rounds half to even, as torch.round does.  An offset with |d| <= l / 2
// is its own image (d / l rounds to at most 1/2 in magnitude, which rintf
// takes to 0), so only the pairs across the seam pay for the division.
// K2 and K3 share it.
__device__ __forceinline__ float min_image(float d, float l) {
  if (fabsf(d) <= 0.5f * l) return d;
  return __fsub_rn(d, __fmul_rn(l, rintf(__fdiv_rn(d, l))));
}

// The periodic axes a pair offset wraps on (bit a: axis a; the axes with
// more than one cell that Geometry.periodic marks) and their extents hi -
// lo, rounded to f32 as the plain path rounds them.  K1 passes none.
struct Wrap {
  int axes;
  float l[3];
};

// wrap a neighbour cell index that left [0, n) by one step back into it
__device__ __forceinline__ int wrap_cell(int c, int n) {
  return c < 0 ? c + n : (c >= n ? c - n : c);
}

// one field of one slot; m is the slot count of a field row (cap * NC)
__device__ __forceinline__ float ld(const float* __restrict__ pf, long long m,
                                    int row, long long slot) {
  return __ldg(pf + (long long)row * m + slot);
}

// Where a pair body reads j's rows (its template parameter L): `Global`, a
// pack in device memory through the read-only cache (K1, K2, K3); `Shared`,
// the window of the pack a block of K4 staged in shared memory (m: the
// window's slots per row, at most 227 KB of floats, so int arithmetic).
struct Global {
  static __device__ __forceinline__ float ld(const float* __restrict__ pf,
                                             long long m, int row,
                                             long long slot) {
    return tv::ld(pf, m, row, slot);
  }
};
struct Shared {
  static __device__ __forceinline__ float ld(const float* __restrict__ pf,
                                             long long m, int row,
                                             long long slot) {
    return pf[row * (int)m + (int)slot];
  }
};

// the i-side values every pair of a thread reads
template <int NS>
struct ISide {
  int tp0;  // ti * ntypes: the row of i's type in the [T, T] tables
  bool solid;
  float x[3], v[3], e[3], b[3];  // b = v - vest
  float rho, m, B, P, V2, AS;
  float inv_rho, C[NS > 0 ? NS : 1];  // species or thermal noise only
  int tag;                            // thermal noise only
  float energy;
};

template <bool FILTER, int NS, bool THERMAL>
__device__ __forceinline__ ISide<NS> load_i(const float* __restrict__ pf,
                                            long long m, long long s,
                                            int ntypes) {
  ISide<NS> I;
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
  // 1/rho is not a packed row: IEEE division rounds it exactly as the plain
  // path's per-particle reciprocal
  if constexpr (NS > 0 || THERMAL) I.inv_rho = 1.f / I.rho;
  if constexpr (NS > 0) {
#pragma unroll
    for (int c = 0; c < NS; ++c) I.C[c] = ld(pf, m, kRowC<FILTER> + c, s);
  }
  if constexpr (THERMAL) {
    I.energy = ld(pf, m, kRowE<FILTER, NS>, s);
    I.tag = __float_as_int(ld(pf, m, kRowE<FILTER, NS> + 1, s));
  }
  return I;
}

// The tSDPD flux of NS species for the pair (i, j = slot k), summed into q[0..NS)
// when r lies inside the pair's species support cutc:
//   kappa (C_i - C_j) 2 m_harm (1/rho_i + 1/rho_j) rsq W'_c / (rsq + 0.01 cutc^2)
//   - advect (m_j/rho_j) W'_c (C_i (vest_i - v_i).dx + C_j (vest_j - v_j).dx).
// K2 (csrc/pass_a_2d_rowloop.cu) shares it: its rows R_V, R_VEST, R_RHO and
// R_MRHO are the ones above.  row_c is the first C row of pf, dx the pair
// separation (after any minimum image), Ci the C of i and bi its v - vest.
template <int NS, class L = Global>
__device__ __forceinline__ void add_species_flux(
    const float* __restrict__ pf, long long m, long long k,
    const float* __restrict__ stab, int advect, int tt, int tp, int row_c,
    float dx0, float dx1, float dx2, float rsq, float r, float inv_rho_i,
    const float* Ci, const float* bi, float* q) {
  const float qc = r * __ldg(stab + S_INVHC * tt + tp);
  const float tc = fmaxf(1.f - qc, 0.f);
  if (tc == 0.f) return;
  const float wfd_c = __ldg(stab + S_CWFD * tt + tp) * tc * tc;
  const float base = __ldg(stab + S_M2 * tt + tp) *
                     (inv_rho_i + 1.f / L::ld(pf, m, R_RHO, k)) * rsq *
                     wfd_c / (rsq + __ldg(stab + S_HC2 * tt + tp));
  // (vest - v).dx of i and of j; bi is v - vest, hence the sign
  float corr_i = 0.f, corr_j = 0.f, mw = 0.f;
  if (advect) {
    corr_i = -(bi[0] * dx0 + bi[1] * dx1 + bi[2] * dx2);
    corr_j = (L::ld(pf, m, R_VEST, k) - L::ld(pf, m, R_V, k)) * dx0 +
             (L::ld(pf, m, R_VEST + 1, k) - L::ld(pf, m, R_V + 1, k)) * dx1 +
             (L::ld(pf, m, R_VEST + 2, k) - L::ld(pf, m, R_V + 2, k)) * dx2;
    mw = L::ld(pf, m, R_MRHO, k) * wfd_c;
  }
#pragma unroll
  for (int c = 0; c < NS; ++c) {
    const float Cj = L::ld(pf, m, row_c + c, k);
    q[c] += __ldg(stab + (S_KAPPA + c) * tt + tp) * (Ci[c] - Cj) * base -
            mw * (Ci[c] * corr_i + Cj * corr_j);
  }
}

// add the pair (i, j = slot k) to acc; the caller has checked that j is valid
// and not i.  advect: the transport-velocity advection correction of the
// species flux (PairConfig.species_advection); wrap: the periodic axes the
// offset x_i - x_j takes the minimum image on; DIM: the grid's, for the
// thermal noise (THERMAL) only; L: where j's rows are read (Global or, in
// K4, Shared).
template <bool FILTER, int NS, bool THERMAL, int DIM, class L = Global>
__device__ __forceinline__ void add_pair(const float* __restrict__ pf,
                                         long long m, long long k,
                                         const float* __restrict__ tab,
                                         const float* __restrict__ stab,
                                         int advect, int tt, const Noise& noise,
                                         const Wrap& wrap, const ISide<NS>& I,
                                         float* acc) {
  float dx0 = I.x[0] - L::ld(pf, m, R_X, k),
        dx1 = I.x[1] - L::ld(pf, m, R_X + 1, k),
        dx2 = I.x[2] - L::ld(pf, m, R_X + 2, k);
  if (wrap.axes) {  // the minimum image on the periodic axes
    if (wrap.axes & 1) dx0 = min_image(dx0, wrap.l[0]);
    if (wrap.axes & 2) dx1 = min_image(dx1, wrap.l[1]);
    if (wrap.axes & 4) dx2 = min_image(dx2, wrap.l[2]);
  }
  const float rsq = dx0 * dx0 + dx1 * dx1 + dx2 * dx2;
  const float r = sqrtf(rsq);
  const int tp = I.tp0 + (int)L::ld(pf, m, R_PTYPE, k);

  // ---- species flux, inside its own support cutc
  if constexpr (NS > 0)
    add_species_flux<NS, L>(pf, m, k, stab, advect, tt, tp, kRowC<FILTER>, dx0, dx1,
                         dx2, rsq, r, I.inv_rho, I.C, I.b, acc + kRowQ<FILTER>);

  const float q = r * __ldg(tab + T_INVH * tt + tp);
  const float t = fmaxf(1.f - q, 0.f);
  if (t == 0.f) return;  // outside the support h: every remaining term is 0
  const float wfd = __ldg(tab + T_CWFD * tt + tp) * t * t;
  const float wf = __ldg(tab + T_CWF * tt + tp) * t * t * t * (1.f + 3.f * q);

  const float mj = L::ld(pf, m, R_M, k), rhoj = L::ld(pf, m, R_RHO, k),
              Vj2 = L::ld(pf, m, R_V2, k);
  const bool solid_j = L::ld(pf, m, R_SOLID, k) != 0.f;

  // ---- sweep 1
  acc[O_NUMDEN] += Vj2 * wf;
  if constexpr (FILTER) {
    acc[O_RHOAUX1] += L::ld(pf, m, R_RHOI, k) * wf;
    acc[O_RHOAUX2] += wf;
  }
  const float vsum = I.V2 + Vj2;
  const float ddv_coef = 70.f * I.B * vsum * wfd;
  acc[O_DDV + 0] += ddv_coef * dx0;
  acc[O_DDV + 1] += ddv_coef * dx1;
  acc[O_DDV + 2] += ddv_coef * dx2;

  // ---- sweep 2
  const float vj0 = L::ld(pf, m, R_V, k), vj1 = L::ld(pf, m, R_V + 1, k),
              vj2 = L::ld(pf, m, R_V + 2, k);
  const float ej0 = L::ld(pf, m, R_VEST, k),
              ej1 = L::ld(pf, m, R_VEST + 1, k),
              ej2 = L::ld(pf, m, R_VEST + 2, k);
  const float vv0 = I.e[0] - ej0, vv1 = I.e[1] - ej1, vv2 = I.e[2] - ej2;
  const float delVdotDelR = dx0 * vv0 + dx1 * vv1 + dx2 * vv2;
  const float ti_s = I.rho * (I.b[0] * dx0 + I.b[1] * dx1 + I.b[2] * dx2);
  const float tj_s = rhoj * ((vj0 - ej0) * dx0 + (vj1 - ej1) * dx1 +
                             (vj2 - ej2) * dx2);
  const float vw = vsum * wfd;
  const float fvisc = vsum * __ldg(tab + T_ETA * tt + tp) * wfd;
  const float Pj = L::ld(pf, m, R_PRHO2, k);
  const float sgn = (Pj + I.P >= 0.f || (I.solid && solid_j)) ? 1.f : -1.f;
  const float fpair = I.m * mj * (Pj + sgn * I.P) * wfd;
  const float w = wf * __ldg(tab + T_INVWD * tt + tp);
  const float w2 = w * w;
  const float fart =
      I.m * mj * wfd * (w2 * w2) * (I.AS + L::ld(pf, m, R_ASD, k));
  const float fdx = fart - fpair;  // coefficient of dx
  acc[O_F + 0] += fdx * dx0 + fvisc * vv0 + vw * (0.5f * (ti_s * I.e[0] + tj_s * ej0));
  acc[O_F + 1] += fdx * dx1 + fvisc * vv1 + vw * (0.5f * (ti_s * I.e[1] + tj_s * ej1));
  acc[O_F + 2] += fdx * dx2 + fvisc * vv2 + vw * (0.5f * (ti_s * I.e[2] + tj_s * ej2));
  if constexpr (THERMAL) {
    const float dx[3] = {dx0, dx1, dx2};
    add_thermal<DIM>(noise, I.tag,
                     __float_as_int(L::ld(pf, m, kRowE<FILTER, NS> + 1, k)),
                     I.energy, I.m, mj, wfd, I.inv_rho, 1.f / rhoj, r,
                     __ldg(tab + T_H * tt + tp), dx, acc + O_F);
  }

  // density evolution: corr = rho (vest - v).dx = -ti_s / -tj_s
  const float mrhoj = L::ld(pf, m, R_MRHO, k);
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
