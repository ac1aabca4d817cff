"""The doubly periodic 2D Taylor-Green vortex (PyTorch).

The transport-velocity formulation's own validation case (Adami, Hu &
Adams 2013, J. Comput. Phys. 241, section 4.1): a periodic box [0, 2 pi)^2
of one fluid, no solids, started from

    v = U0 (sin x cos y, -cos x sin y)

at Re = U0 / (nu k) with k = 1.  The flow decays viscously: the kinetic
energy falls as E(t) / E0 = exp(-4 nu t) (the mode has |k|^2 = 2).  Here it
runs with the transport-velocity pair and integrator on N x N lattice
sites, h = 2.5 spacings, rho0 = 1 and c0 = 10 U0, as a ``Scene`` of either
package's classes (in neither registry; the JAX package's ``Scene`` builds
it too), the 2D form of ``taylor_green3d``.  With no solid the pair takes
its solid-free branch (``solids_present`` False).

The cell margin is 0.19 cutoffs (``margin_frac``), not the default 0.25.
Periodic axes are never lattice-aligned, so the grid has no ``base_occ``
and its cap comes from the densest possible cell.  At 0.25 a cell is at
least 3.125 spacings wide and may hold 16 particles: cap 23, which routes
the rebin to the gated kernel (K6).  At 0.19 the cells are under 3
spacings wide (336 x 336 at N=1000), a cell holds at most 9 particles, the
cap is 14 and the rebin takes the static kernel (K5) on both periodic
axes, with 1.48x fewer slots; the drift budget is 0.238 spacings.  Pass A
takes the rowloop kernel (K2): ``base_occ`` 0.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from sph_bvf_tpu_torch.api.scene import Region, Scene

L = 2.0 * math.pi  # the box's side
U0 = 1.0  # the velocity scale
MARGIN_FRAC = 0.19  # cells under 3 spacings: cap 14, the rebin on K5


def scene(Scene, Region, N: int = 1000, Re: float = 100.0,
          margin_frac: float = MARGIN_FRAC):
    """The vortex's box as an unbuilt scene of the given package's classes:
    N^2 sites of a square lattice (origin at half a spacing) in the doubly
    periodic [0, 2 pi)^2, one fluid type of mass rho0 spacing^2, the
    transport-velocity pair with h = 2.5 spacings, c0 = 10 U0 and nu = U0 /
    Re, and dt = 0.1 h / c0.  Rebin every 5 steps: a particle carried at
    U0 crosses the drift budget (0.238 spacings at the default margin) in
    about 10 steps of 0.01 h / U0.  The velocity is set after the build
    (``taylor_green_velocity``).  Build it with ``.build(device=...)`` (the
    port) or ``.build()`` (the JAX package)."""
    delta = L / N
    h = 2.5 * delta
    rho0, c0, nu = 1.0, 10.0 * U0, U0 / Re

    sc = Scene(dim=2, boundary=("p", "p", "p"))
    sc.rebin_every = 5
    sc.margin_frac = margin_frac
    box = Region.block(0.0, L, 0.0, L, 0.0, delta)
    sc.create_box(1, box)
    sc.lattice("sq", delta)
    sc.create_atoms(1, box)
    sc.mass(1, rho0 * delta ** 2)
    sc.set("all", rho=rho0, e=0.0)
    sc.pair_style("transport_velocity")
    sc.pair_coeff(1, 1, rho0, c0, nu, h, h, 0.0)
    sc.integrator("transport_velocity")
    sc.timestep(timestep(N))
    return sc


def timestep(N: int) -> float:
    """The vortex's dt at N: 0.1 h / c0, with h = 2.5 spacings and c0 = 10
    U0."""
    return 0.1 * (2.5 * L / N) / (10.0 * U0)


def taylor_green_velocity(state):
    """``state`` with v = U0 (sin x cos y, -cos x sin y, 0) on its valid
    slots (0 elsewhere)."""
    x, y, _ = state.x
    v = U0 * torch.stack([torch.sin(x) * torch.cos(y),
                          -torch.cos(x) * torch.sin(y), torch.zeros_like(x)])
    return dataclasses.replace(state, v=torch.where(state.valid, v, 0.0))


def kinetic_energy(state, params) -> float:
    """0.5 sum m |v|^2 over the valid particles, summed in f64."""
    vsq = (state.v * state.v).sum(0)
    mv2 = 0.5 * params.mass[state.ptype.long()] * vsq
    return float(mv2[state.valid].double().sum())


def build(N: int = 1000, Re: float = 100.0, device=None):
    """``scene`` with the port's classes, built, with the vortex's velocity:
    (state, params, spec, scene) on ``device`` (default: the card)."""
    sc = scene(Scene, Region, N=N, Re=Re)
    state, params, spec = sc.build(device=device)
    return taylor_green_velocity(state), params, spec, sc
