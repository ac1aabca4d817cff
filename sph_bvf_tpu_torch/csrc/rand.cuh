// The counter-based random numbers of the SDPD thermal noise, the device copy
// of sph_bvf_tpu_torch/ops/rand.py (itself a port of sph_bvf_tpu/ops/rand.py):
// a normal deviate is a pure function of the words (seed, step, tag_lo,
// tag_hi, salt), so the pairs (i, j) and (j, i) draw the same one.
//
// hash_u32(w0..wn) = mix(absorb(...absorb(kInit, w0)..., wn)): the words are
// absorbed in order, so a caller that draws many normals with a common first
// few words absorbs those once and continues from the state (`absorb` below);
// every normal is still the same function of its words, bit for bit.  The
// uniforms keep the hash's top 24 bits, exact in the f32 mantissa, and
// Box-Muller runs in f32 with logf, sqrtf and cosf (this file must not be built
// with --use_fast_math: the approximate intrinsics would change the draws).

#pragma once

#include <cstdint>

namespace rnd {

constexpr uint32_t kInit = 0x811C9DC5u, kGolden = 0x9E3779B9u,
                   kM1 = 0x85EBCA6Bu, kM2 = 0xC2B2AE35u;
// the last word of the two uniforms of a normal
constexpr uint32_t kSaltU1 = 0x1234ABCDu, kSaltU2 = 0x77F0551u;
// 2 pi as the plain path forms it: 2 times pi rounded to f32
constexpr float kTwoPi = 2.f * 3.14159265358979323846f;

__device__ __forceinline__ uint32_t mix(uint32_t h) {
  h ^= h >> 16;
  h *= kM1;
  h ^= h >> 13;
  h *= kM2;
  h ^= h >> 16;
  return h;
}

// the hash state after one more word
__device__ __forceinline__ uint32_t absorb(uint32_t h, uint32_t w) {
  return mix((h ^ w) * kGolden + 1u);
}

// U(0, 1) from the state after every word but the uniform's own last one
__device__ __forceinline__ float uniform_01(uint32_t h, uint32_t last) {
  const uint32_t bits = mix(absorb(h, last)) >> 8;
  return ((float)bits + 0.5f) * 0x1p-24f;
}

// the standard normal whose words ahead of its two uniforms' last words have
// left the hash state h (for the thermal noise: seed, step, lo, hi, salt)
__device__ __forceinline__ float normal(uint32_t h) {
  const float u1 = uniform_01(h, kSaltU1), u2 = uniform_01(h, kSaltU2);
  const float r = sqrtf(-2.f * logf(u1));
  return r * cosf(kTwoPi * u2);
}

}  // namespace rnd
