"""Auxiliary fixes registered for one Verlet stage (PyTorch).

Port of ``sph_bvf_tpu/core/fixes.py``: each fix is a frozen dataclass with
an ``apply(state, params) -> state`` method and a ``stage``; the stepper
runs each stage's fixes in the order given.  Group selection uses the
LAMMPS-style bitmask in ``state.groupmask``.

Every fix of the JAX package is here: ``SetForce`` (the lid cavities),
``Buffer`` (the FSI inlet sponges), ``Forcing`` and ``Buoyancy`` (natural
convection), ``ChemRxnMassAction`` and ``DtAdaptive``.  Step gates
(``state.step > after_step``) compare on the device: no fix reads a value
back to the host.

``mesh`` (``parallel/mesh.Mesh``, the x-slab mesh of a sharded run; None on
one device): a fix reads only its own rank's slab, and a value reduced over
particles (``DtAdaptive``'s largest speed) is reduced over every rank, so
every rank keeps the same value.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from sph_bvf_tpu_torch.core.state import Params, State
from sph_bvf_tpu_torch.parallel.mesh import all_reduce

# stages
POST_INTEGRATE = "post_integrate"
POST_FORCE = "post_force"
END_OF_STEP = "end_of_step"


def _in_group(state: State, groupbit: int):
    return (state.groupmask & groupbit) != 0


def _region_mask(state: State, shape: str, center, length, width, radius):
    drx = state.x[0] - center[0]
    dry = state.x[1] - center[1]
    if shape == "circle":
        return drx * drx + dry * dry < radius * radius
    return (torch.abs(drx) < length) & (torch.abs(dry) < width)


def _with_row(a: torch.Tensor, index: int, row: torch.Tensor) -> torch.Tensor:
    """A copy of ``a`` with ``a[index]`` replaced by ``row``."""
    out = a.clone()
    out[index] = row
    return out


@dataclasses.dataclass(frozen=True)
class Forcing:
    """Dirichlet clamp of C / Cd / vest inside a circle or rectangle after a
    given step — `fix ssa_tsdpd/forcing` (fix_ssa_tsdpd_forcing.cpp:133-174).

    POST_INTEGRATE.  ``field`` is "tsdpd" (C), "ssa" (Cd), or "velocity"
    (clamps a component of the *momentum* velocity vest — the reference
    aliases ``v = atom->vest`` at :138).
    """

    groupbit: int
    field: str  # "tsdpd" | "ssa" | "velocity"
    index: int  # species index or velocity component
    shape: str  # "circle" | "rectangle"
    center: Tuple[float, float] = (0.0, 0.0)
    length: float = 0.0
    width: float = 0.0
    radius: float = 0.0
    value: float = 0.0
    after_step: int = 0

    stage = POST_INTEGRATE

    def __post_init__(self):
        if self.field not in ("tsdpd", "ssa", "velocity"):
            raise ValueError(f"forcing field {self.field!r}: "
                             "choose tsdpd, ssa, or velocity")
        if self.shape not in ("circle", "rectangle"):
            raise ValueError(f"forcing shape {self.shape!r}")

    def apply(self, state: State, params: Params, mesh=None) -> State:
        sel = (
            _in_group(state, self.groupbit)
            & _region_mask(state, self.shape, self.center, self.length,
                           self.width, self.radius)
            & (state.step > self.after_step)
        )
        if self.field == "tsdpd":
            row = torch.where(sel, self.value, state.C[self.index])
            return dataclasses.replace(
                state, C=_with_row(state.C, self.index, row))
        if self.field == "ssa":
            row = torch.where(sel, int(self.value), state.Cd[self.index])
            return dataclasses.replace(
                state, Cd=_with_row(state.Cd, self.index, row))
        row = torch.where(sel, self.value, state.vest[self.index])
        return dataclasses.replace(
            state, vest=_with_row(state.vest, self.index, row))


@dataclasses.dataclass(frozen=True)
class Buoyancy:
    """Boussinesq buoyancy or plain gravity — `fix ssa_tsdpd/buoyancy`
    (fix_ssa_tsdpd_buoyancy.cpp:113-140).  POST_FORCE.

    boussinesq: f[dim] += m a (C[:, species] - C_ref);  gravity: f[dim] += m a.
    """

    groupbit: int
    mode: str  # "boussinesq" | "gravity"
    acceleration: float
    dim: int  # force component (0/1/2)
    species: int = 0
    c_ref: float = 0.0

    stage = POST_FORCE

    def apply(self, state: State, params: Params, mesh=None) -> State:
        sel = _in_group(state, self.groupbit) & state.valid
        m = params.mass[state.ptype.long()]
        if self.mode == "boussinesq":
            df = m * self.acceleration * (state.C[self.species] - self.c_ref)
        else:
            df = m * self.acceleration
        row = state.f[self.dim] + torch.where(sel, df, 0.0)
        return dataclasses.replace(state, f=_with_row(state.f, self.dim, row))


@dataclasses.dataclass(frozen=True)
class ChemRxnMassAction:
    """Deterministic mass-action source — `fix ssa_tsdpd/chem_rxn_mass_action`
    (fix_ssa_tsdpd_chem_rxn_mass_action.cpp:76-112).  POST_FORCE.

    flux = k * prod(C[reactants]); Q[reactants] -= flux; Q[products] += flux.
    """

    groupbit: int
    k_rate: float
    reactants: Tuple[int, ...] = ()
    products: Tuple[int, ...] = ()

    stage = POST_FORCE

    def apply(self, state: State, params: Params, mesh=None) -> State:
        sel = _in_group(state, self.groupbit) & state.valid
        flux = torch.full_like(state.rho, self.k_rate)
        for r in self.reactants:
            flux = flux * state.C[r]
        flux = torch.where(sel, flux, 0.0)
        Q = state.Q.clone()
        for r in self.reactants:
            Q[r] = Q[r] - flux
        for p in self.products:
            Q[p] = Q[p] + flux
        return dataclasses.replace(state, Q=Q)


@dataclasses.dataclass(frozen=True)
class SetForce:
    """Clamp force components — `fix setforce` (fix_setforce.cpp:222).

    POST_FORCE; a value of None leaves the component untouched.
    """

    groupbit: int
    fx: float | None = 0.0
    fy: float | None = 0.0
    fz: float | None = 0.0

    stage = POST_FORCE

    def apply(self, state: State, params: Params, mesh=None) -> State:
        sel = _in_group(state, self.groupbit)
        comps = [
            state.f[d] if val is None else torch.where(sel, float(val), state.f[d])
            for d, val in enumerate((self.fx, self.fy, self.fz))
        ]
        return dataclasses.replace(state, f=torch.stack(comps))


@dataclasses.dataclass(frozen=True)
class Buffer:
    """Sponge / non-reflective zone — `fix ssa_tsdpd/buffer`
    (fix_ssa_tsdpd_buffer.cpp:124-245).

    Blends C / vest (POST_INTEGRATE) or rho (END_OF_STEP) toward ``value``
    with a cubic ramp along x or a tanh ramp along y.
    """

    groupbit: int
    field: str  # "tsdpd" | "velocity" | "density"
    direction: str  # "x" | "y"
    index: int = 0  # species index or velocity component
    center: Tuple[float, float] = (0.0, 0.0)
    length: float = 0.0
    width: float = 0.0
    value: float = 0.0
    after_step: int = 0

    def __post_init__(self):
        if self.field not in ("tsdpd", "velocity", "density"):
            raise ValueError(f"buffer field {self.field!r}: "
                             "choose tsdpd, velocity, or density")
        if self.direction not in ("x", "y"):
            raise ValueError(f"buffer direction {self.direction!r}")

    @property
    def stage(self):
        return END_OF_STEP if self.field == "density" else POST_INTEGRATE

    def _ramp(self, state: State):
        drx = state.x[0] - self.center[0]
        dry = state.x[1] - self.center[1]
        inside = (torch.abs(drx) < self.length) & (torch.abs(dry) < self.width)
        if self.direction == "x":
            xo = self.center[0] - self.length
            xl = self.center[0] + self.length
            phi = (state.x[0] - xo) / (xl - xo)
            phi = phi * phi * phi  # cubic stretching (:154-155)
        else:
            yo = self.center[1] - self.width
            yl = self.center[1] + self.width
            phi = (state.x[1] - yo) / (yl - yo)
            phi = 0.5 * (1.0 - torch.tanh(8.0 - 16.0 * phi))  # tanh (:173)
        return torch.where(inside, phi, 0.0)

    def apply(self, state: State, params: Params, mesh=None) -> State:
        sel = _in_group(state, self.groupbit) & (state.step > self.after_step)
        phi = torch.where(sel, self._ramp(state), 0.0)
        if self.field == "tsdpd":
            c = state.C[self.index]
            return dataclasses.replace(state, C=_with_row(
                state.C, self.index, c - phi * (c - self.value)))
        if self.field == "velocity":
            v = state.vest[self.index]
            return dataclasses.replace(state, vest=_with_row(
                state.vest, self.index, v - phi * (v - self.value)))
        rho = state.rho - phi * (state.rho - self.value)
        return dataclasses.replace(state, rho=rho)


@dataclasses.dataclass(frozen=True)
class DtAdaptive:
    """CFL timestep controller — `fix dt/adaptive`
    (fix_dt_adaptive.cpp:118-163).  END_OF_STEP.

    dt = clamp(CFL * dx_ave / max|v|, tmin, tmax), computed and kept on the
    device.
    """

    groupbit: int
    cfl: float
    dx_ave: float
    tmin: float
    tmax: float

    stage = END_OF_STEP

    def apply(self, state: State, params: Params, mesh=None) -> State:
        vsq = torch.sum(state.v * state.v, dim=0)
        vsq = torch.where(state.valid & _in_group(state, self.groupbit), vsq, 0.0)
        vsq_max = torch.max(vsq)
        if mesh is not None:
            vsq_max = all_reduce(vsq_max, mesh, "max")
        vmax = torch.sqrt(vsq_max)
        dt = self.cfl * self.dx_ave / torch.clamp_min(vmax, 1e-30)
        dt = torch.clamp(dt, self.tmin, self.tmax)
        return dataclasses.replace(state, dt=dt.to(state.dt.dtype))


def apply_stage(state: State, params: Params, fixes, stage: str,
                mesh=None) -> State:
    for fx in fixes:
        if fx.stage == stage:
            state = fx.apply(state, params, mesh)
    return state
