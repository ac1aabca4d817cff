"""Lucy smoothing kernels in 1/2/3D (port of ``sph_bvf_tpu/ops/kernels.py``).

    W(r, h) = A_d * (1 + 3 r/h) * (1 - r/h)^3        for r < h, else 0

with A_1 = 5/(4h), A_2 = 5/(pi h^2), A_3 = 105/(16 pi h^3); the radial
derivative factors as (1/r) dW/dr = -12 A_d (1 - q)^2 / h^(dim+2) ("wfd").
Every function accepts tensors or 0-dim tensors broadcastable to any shape
and returns 0 beyond the support radius.
"""

from __future__ import annotations

import math

import torch


def ipow(x, n: int):
    """x**n for a positive int n by repeated squaring — the multiplication
    sequence of JAX's ``lax.integer_pow``, so f32 powers round exactly as in
    the reference (``torch.pow`` rounds x**4 differently)."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


# Normalization constants A_d for the Lucy kernel per dimension.
_A = {
    1: 5.0 / 4.0,  # * 1/h
    2: 5.0 / math.pi,  # * 1/h^2
    3: 105.0 / (16.0 * math.pi),  # * 1/h^3
}


def lucy_w(r, h, dim: int):
    """Kernel value W(r, h); zero for r >= h."""
    ih = 1.0 / h
    q = r * ih
    t = torch.clamp_min(1.0 - q, 0.0)
    return (_A[dim] * ipow(ih, dim)) * t * t * t * (1.0 + 3.0 * q)


def lucy_wfd(r, h, dim: int):
    """(1/r) dW/dr = -12 A_d (1-q)^2 / h^(dim+2); zero for r >= h."""
    ih = 1.0 / h
    q = r * ih
    t = torch.clamp_min(1.0 - q, 0.0)
    return (-12.0 * _A[dim] * ipow(ih, dim + 2)) * t * t


def lucy_w_rsq(rsq, h, dim: int):
    """W from squared distance."""
    return lucy_w(torch.sqrt(rsq), h, dim)


def lucy_wfd_rsq(rsq, h, dim: int):
    return lucy_wfd(torch.sqrt(rsq), h, dim)


def lucy_self_w(h, dim: int):
    """W(0, h) — the self-contribution used by Shepard-style density sums."""
    return _A[dim] / h**dim


def lucy_w_coef(ih, dim: int):
    """The r-independent factor of ``lucy_w_ih``: A_d / h^dim."""
    return _A[dim] * ipow(ih, dim)


def lucy_wfd_coef(ih, dim: int):
    """The r-independent factor of ``lucy_wfd_ih``: -12 A_d / h^(dim+2)."""
    return -12.0 * _A[dim] * ipow(ih, dim + 2)


def lucy_w_ih(r, ih, dim: int):
    """W(r) given the precomputed inverse support 1/h (no division)."""
    q = r * ih
    t = torch.clamp_min(1.0 - q, 0.0)
    return lucy_w_coef(ih, dim) * t * t * t * (1.0 + 3.0 * q)


def lucy_wfd_ih(r, ih, dim: int):
    """(1/r) dW/dr given 1/h (no division)."""
    q = r * ih
    t = torch.clamp_min(1.0 - q, 0.0)
    return lucy_wfd_coef(ih, dim) * t * t
