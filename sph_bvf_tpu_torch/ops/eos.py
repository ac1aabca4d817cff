"""Equation of state (port of ``sph_bvf_tpu/ops/eos.py``).

Linearized Tait EOS, as the reference uses everywhere:

    P = 7 B (rho/rho0 - 1),   with  B = c0^2 rho0 / 7
"""

from __future__ import annotations


def tait_b(c0, rho0):
    """B = c0^2 rho0 / 7 (reference coeff(), pair...transport_velocity.cpp:981)."""
    return c0 * c0 * rho0 / 7.0


def tait_pressure(rho, rho0, b):
    """P = 7 B (rho/rho0 - 1)."""
    return 7.0 * b * (rho / rho0 - 1.0)
