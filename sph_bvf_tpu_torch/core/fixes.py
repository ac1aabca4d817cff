"""Auxiliary fixes registered for one Verlet stage (PyTorch).

Port of ``sph_bvf_tpu/core/fixes.py``: each fix is a frozen dataclass with
an ``apply(state, params) -> state`` method and a ``stage``; the stepper
runs each stage's fixes in the order given.  Group selection uses the
LAMMPS-style bitmask in ``state.groupmask``.

Ported: ``SetForce`` (the lid cavity's only fix) and ``Buffer`` (the FSI
inlet sponges).  The JAX package's ``Forcing``, ``Buoyancy``,
``ChemRxnMassAction`` and ``DtAdaptive`` are ported in a later PR.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from sph_bvf_tpu_torch.core.state import Params, State

# stages
POST_INTEGRATE = "post_integrate"
POST_FORCE = "post_force"
END_OF_STEP = "end_of_step"


def _in_group(state: State, groupbit: int):
    return (state.groupmask & groupbit) != 0


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

    def apply(self, state: State, params: Params) -> State:
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

    def apply(self, state: State, params: Params) -> State:
        sel = _in_group(state, self.groupbit) & (state.step > self.after_step)
        phi = torch.where(sel, self._ramp(state), 0.0)
        if self.field == "tsdpd":
            C = state.C.clone()
            c = state.C[self.index]
            C[self.index] = c - phi * (c - self.value)
            return dataclasses.replace(state, C=C)
        if self.field == "velocity":
            vest = state.vest.clone()
            v = state.vest[self.index]
            vest[self.index] = v - phi * (v - self.value)
            return dataclasses.replace(state, vest=vest)
        rho = state.rho - phi * (state.rho - self.value)
        return dataclasses.replace(state, rho=rho)


def apply_stage(state: State, params: Params, fixes, stage: str) -> State:
    for fx in fixes:
        if fx.stage == stage:
            state = fx.apply(state, params)
    return state
