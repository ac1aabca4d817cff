"""The counter-based random numbers that key the SSA hop draws and the
reactions, written from their specification (plain PyTorch).

A draw is a pure function of its words: hash(seed, step, tag, tag or event,
salt).  Each word is a uint32; the state starts at 0x811C9DC5 and absorbs a
word w as ``mix(((h ^ w) * 0x9E3779B9 + 1) mod 2^32)``; a final ``mix``
ends it, where ``mix`` is murmur3's finalizer (shifts 16, 13, 16 and the
multipliers 0x85EBCA6B, 0xC2B2AE35).  A uniform in (0, 1) is the top 24
bits of the hash plus one half, times 2^-24, in float32.

The words are held in int64 tensors in [0, 2^32): a product that wraps
int64 keeps its low 32 bits, so masking after each multiply is exact.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_M1, _M2 = 0x85EBCA6B, 0xC2B2AE35
_GOLDEN, _INIT = 0x9E3779B9, 0x811C9DC5
# the word a species index is offset by in the hop draws
HOP_SALT = 0xD1F


def _word(w) -> torch.Tensor:
    return torch.as_tensor(w).to(torch.int64) & MASK


def _mix(h):
    h = h ^ (h >> 16)
    h = (h * _M1) & MASK
    h = h ^ (h >> 13)
    h = (h * _M2) & MASK
    return h ^ (h >> 16)


def hash_words(*words) -> torch.Tensor:
    """The uint32 hash of ``words`` (broadcast), as int64."""
    h = torch.as_tensor(_INIT, dtype=torch.int64)
    for w in words:
        h = _mix(((h ^ _word(w)) * _GOLDEN + 1) & MASK)
    return _mix(h)


def uniform(*words) -> torch.Tensor:
    """U(0, 1), float32, never 0 or 1."""
    return ((hash_words(*words) >> 8).to(torch.float32) + 0.5) * 2.0 ** -24


def seed_words(seed: int) -> tuple:
    """The two uint32 words a run's seed is held in (high, low)."""
    return (seed >> 32) & MASK, seed & MASK


def seed_word(seed: int) -> int:
    """The one word every draw of a run starts from: the two words xor-ed."""
    hi, lo = seed_words(seed)
    return hi ^ lo
