"""Auxiliary fixes registered for one Verlet stage (PyTorch).

Port of ``sph_bvf_tpu/core/fixes.py``: each fix is a frozen dataclass with
an ``apply(state, params) -> state`` method and a ``stage``; the stepper
runs each stage's fixes in the order given.  Group selection uses the
LAMMPS-style bitmask in ``state.groupmask``.

Ported: ``SetForce`` (the lid cavity's only fix).  The JAX package's
``Forcing``, ``Buffer``, ``Buoyancy``, ``ChemRxnMassAction`` and
``DtAdaptive`` are ported in a later PR.
"""

from __future__ import annotations

import dataclasses

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


def apply_stage(state: State, params: Params, fixes, stage: str) -> State:
    for fx in fixes:
        if fx.stage == stage:
            state = fx.apply(state, params)
    return state
