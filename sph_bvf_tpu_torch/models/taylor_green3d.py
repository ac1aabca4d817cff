"""The triply periodic 3D Taylor-Green vortex (PyTorch).

The standard 3D validation case of incompressible-flow solvers (Brachet et
al. 1983; the TGV case of the International Workshop on High-Order CFD
Methods): a periodic box [0, 2 pi)^3 of one fluid, no solids, started from

    v = U0 (sin x cos y cos z, -cos x sin y cos z, 0)

at Re = U0 / (nu k) with k = 1.  Its early decay is viscous: the kinetic
energy falls as E(t) / E0 = exp(-6 nu t) (each mode has |k|^2 = 3) until
the vortex stretching of the 3D flow sets in.  Here it runs with the
transport-velocity pair and integrator on N lattice sites a side, h = 2.5
spacings, rho0 = 1 and c0 = 10 U0, as a ``Scene`` of either package's
classes (in neither registry; the JAX package's ``Scene`` builds it too).
With no solid the pair takes its solid-free branch (``solids_present``
False).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from sph_bvf_tpu_torch.api.scene import Region, Scene

L = 2.0 * math.pi  # the box's side
U0 = 1.0  # the velocity scale


def scene(Scene, Region, N: int = 100, Re: float = 100.0):
    """The vortex's box as an unbuilt scene of the given package's classes:
    N^3 sites of a simple-cubic lattice (origin at half a spacing) in the
    fully periodic [0, 2 pi)^3, one fluid type of mass rho0 spacing^3, the
    transport-velocity pair with h = 2.5 spacings, c0 = 10 U0 and nu = U0 /
    Re, and dt = 0.1 h / c0 (0.4 of the acoustic limit 0.25 h / c0).  Rebin
    every 5 steps: at N=100 the cells are 1.29 h wide (31 a side), a drift
    budget of 0.145 h, and a particle carried at 1.45 U0 crosses it in 10
    steps of 0.01 h / U0.  The velocity is set after the build
    (``taylor_green_velocity``).  Build it with ``.build(device=...)`` (the
    port) or ``.build()`` (the JAX package)."""
    delta = L / N
    h = 2.5 * delta
    rho0, c0, nu = 1.0, 10.0 * U0, U0 / Re

    sc = Scene(dim=3, boundary=("p", "p", "p"))
    sc.rebin_every = 5
    box = Region.block(0.0, L, 0.0, L, 0.0, L)
    sc.create_box(1, box)
    sc.lattice("sc", delta, origin=(0.5, 0.5, 0.5))
    sc.create_atoms(1, box)
    sc.mass(1, rho0 * delta ** 3)
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
    """``state`` with v = U0 (sin x cos y cos z, -cos x sin y cos z, 0) on
    its valid slots (0 elsewhere)."""
    x, y, z = state.x
    v = U0 * torch.stack([torch.sin(x) * torch.cos(y) * torch.cos(z),
                          -torch.cos(x) * torch.sin(y) * torch.cos(z),
                          torch.zeros_like(x)])
    return dataclasses.replace(state, v=torch.where(state.valid, v, 0.0))


def kinetic_energy(state, params) -> float:
    """0.5 sum m |v|^2 over the valid particles, summed in f64."""
    vsq = (state.v * state.v).sum(0)
    mv2 = 0.5 * params.mass[state.ptype.long()] * vsq
    return float(mv2[state.valid].double().sum())


def build(N: int = 100, Re: float = 100.0, device=None):
    """``scene`` with the port's classes, built, with the vortex's velocity:
    (state, params, spec, scene) on ``device`` (default: the card)."""
    sc = scene(Scene, Region, N=N, Re=Re)
    state, params, spec = sc.build(device=device)
    return taylor_green_velocity(state), params, spec, sc
