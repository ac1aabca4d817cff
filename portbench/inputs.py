"""The inputs a run makes from its seed, handed alike to the program and to
the reference: the jitter of the fluid's lattice positions and the words
of the counter RNG's key.  Plain PyTorch."""

from __future__ import annotations

import torch

from portbench.reference.counter_rng import seed_words

JITTER = 0.1  # the largest step, as a fraction of the lattice spacing


def jitter(seed: int, n: int, dim: int, spacing: float,
           device) -> torch.Tensor:
    """[n, 3] float32, row t-1 for tag t: a uniform step of up to
    ``JITTER`` of the lattice ``spacing`` along each of the first ``dim``
    axes, drawn by one generator on ``device`` seeded with ``seed``.  A perfect
    lattice cancels the background-pressure correction; the jitter makes
    every pair term live."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    d = torch.rand((n, 3), generator=g, device=device, dtype=torch.float32)
    d = (2.0 * d - 1.0) * (JITTER * spacing)
    d[:, dim:] = 0.0
    return d


def key_words(seed: int, device) -> torch.Tensor:
    """The run's key as the program holds it: two uint32 words in int64."""
    return torch.tensor(seed_words(seed), dtype=torch.int64, device=device)
