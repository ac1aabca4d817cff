"""Counter-based, order-independent random numbers for pairwise physics
(port of ``sph_bvf_tpu/ops/rand.py``).

Per-pair noise is a pure function hash(seed, step, tag_lo, tag_hi, salt), so
runs are reproducible given a seed, the pairs (i, j) and (j, i) see the same
noise (Newton's third law for the random force) and no RNG state is carried.
The hash is two rounds of a murmur3/xxhash-style 32-bit mix.

Torch has little unsigned 32-bit arithmetic, so the words are int64 tensors
holding values in [0, 2^32): every multiply and add is masked back to 32 bits
(a product that wraps int64 keeps its low 32 bits), which makes ``hash_u32``
and the 24 bits of ``uniform_01`` bitwise equal to the JAX package's.
``normal`` is float32, as in the JAX package whatever the run's dtype: the
caller promotes it.  ``csrc/rand.cuh`` is the kernels' copy.
"""

from __future__ import annotations

import math

import torch

_MASK = 0xFFFFFFFF
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9
_INIT = 0x811C9DC5
# the last word of the two uniforms of a normal
_SALT_U1, _SALT_U2 = 0x1234ABCD, 0x77F0551
# 2 pi as the JAX package forms it: 2.0 * float32(pi), in float32
_TWO_PI_F32 = 2.0 * float(torch.tensor(math.pi, dtype=torch.float32))


def _u32(w) -> torch.Tensor:
    """A word as an int64 tensor in [0, 2^32) (the uint32 cast: negative
    int32 values wrap)."""
    return torch.as_tensor(w).to(torch.int64) & _MASK


def _mix(h):
    h = h ^ (h >> 16)
    h = (h * _M1) & _MASK
    h = h ^ (h >> 13)
    h = (h * _M2) & _MASK
    h = h ^ (h >> 16)
    return h


def hash_u32(*words) -> torch.Tensor:
    """Combine uint32 words into one well-mixed uint32, as int64 in [0, 2^32)
    (shape-broadcasting)."""
    h = _INIT
    for w in words:
        h = _mix(((h ^ _u32(w)) * _GOLDEN + 1) & _MASK)
    return _mix(torch.as_tensor(h))


def uniform_01(*words) -> torch.Tensor:
    """U(0,1) in (0, 1), float32, from the top 24 bits of the hash: exact in
    the float32 mantissa, so never exactly 0 or 1."""
    bits = hash_u32(*words) >> 8
    return (bits.to(torch.float32) + 0.5) * 2.0**-24


def normal(*words) -> torch.Tensor:
    """Standard normal via Box-Muller from two decorrelated uniforms,
    computed in float32."""
    u1 = uniform_01(*words, _SALT_U1)
    u2 = uniform_01(*words, _SALT_U2)
    r = torch.sqrt(-2.0 * torch.log(u1))
    return r * torch.cos(_TWO_PI_F32 * u2)


def seed_word(key) -> torch.Tensor:
    """The per-run seed word of the counter draws: the key's first and last
    words (the JAX package's uint32 key words) xor-ed, in [0, 2^32)."""
    key = key.reshape(-1) & _MASK
    return key[0] ^ key[-1]


def pair_symmetric_normal(seed, step, tag_a, tag_b, salt) -> torch.Tensor:
    """Normal deviate identical under (a, b) <-> (b, a) exchange."""
    tag_a, tag_b = torch.as_tensor(tag_a), torch.as_tensor(tag_b)
    lo = torch.minimum(tag_a, tag_b)
    hi = torch.maximum(tag_a, tag_b)
    return normal(seed, step, lo, hi, salt)
