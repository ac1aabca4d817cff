"""Per-atom computes — the observables the reference exposes for dumps.

Port of ``sph_bvf_tpu/core/computes.py``: the USER-SSA-TSDPD compute styles
(each ~100 LoC of C++ copying an atom array into vector_atom;
compute_ssa_tsdpd_*_atom.cpp):

    ssa_tsdpd/rho/atom        -> rho
    ssa_tsdpd/phi/atom        -> phi            (compute_ssa_tsdpd_phi_atom.cpp:61-82)
    ssa_tsdpd/solid_tag/atom  -> solid_tag
    ssa_tsdpd/C/atom k        -> C[k]
    ssa_tsdpd/Cd/atom k       -> Cd[k]
    ssa_tsdpd/e/atom          -> e
    ssa_tsdpd/p/atom          -> Pnew           (populated by mechanics/fsi pair
                                 styles, compute_ssa_tsdpd_p_atom.cpp:77-88)
    ssa_tsdpd/stress/atom m n -> -Pnew*d_mn + S[m][n]
                                 (compute_ssa_tsdpd_stress_atom.cpp:90-94)
    ssa_tsdpd/numberDensity   -> num_den (BVF Eq. 2 denominator)

Each compute returns a tensor on the state's device in cell-slot layout
[cap, NC]; ``gather_compute`` gives tag-sorted host numpy (the dump path),
under an x-slab mesh (``mesh=``) the whole grid's on every rank.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from sph_bvf_tpu_torch.core.state import State


def rho_atom(state: State):
    return state.rho


def phi_atom(state: State):
    return state.phi


def solid_tag_atom(state: State):
    return state.solid_tag


def c_atom(state: State, k: int):
    return state.C[k]


def cd_atom(state: State, k: int):
    return state.Cd[k]


def e_atom(state: State):
    return state.e


def p_atom(state: State):
    """Per-particle pressure.

    Like the reference, reads the stored ``Pnew`` — only the mechanics/fsi
    pair variants populate it (store_pnew); under transportVelocity it stays
    zero, matching compute_ssa_tsdpd_p_atom.cpp semantics.
    """
    return state.Pnew


def stress_atom(state: State, m: int, n: int):
    """sigma_mn = -Pnew * delta_mn + deviatoric S[m][n]."""
    s = state.S[m, n]
    if m == n:
        s = s - state.Pnew
    return s


def number_density_atom(state: State):
    return state.num_den


# name -> (fn, takes_indices)
REGISTRY = {
    "rho": (rho_atom, 0),
    "phi": (phi_atom, 0),
    "solid_tag": (solid_tag_atom, 0),
    "C": (c_atom, 1),
    "Cd": (cd_atom, 1),
    "e": (e_atom, 0),
    "p": (p_atom, 0),
    "stress": (stress_atom, 2),
    "number_density": (number_density_atom, 0),
}


def compute(state: State, name: str, *idx):
    """Evaluate a compute by reference-style name ("C", 0) etc."""
    fn, nidx = REGISTRY[name]
    if len(idx) != nidx:
        raise ValueError(f"compute {name} takes {nidx} indices, got {len(idx)}")
    return fn(state, *idx)


def gather_compute(state: State, geom, name: str, *idx, mesh=None) -> np.ndarray:
    """Tag-sorted host values of a compute (the dump/diagnostic path).
    ``mesh`` (``parallel/mesh.Mesh``): ``state`` is this rank's slab, and
    every rank of the mesh calls this and gets the whole grid's values."""
    from sph_bvf_tpu_torch.parallel.mesh import gather_particles

    val = compute(state, name, *idx)
    tmp = dataclasses.replace(state, Pnew=val)  # any scalar slot works
    return gather_particles(tmp, geom, mesh, fields=("Pnew",))["Pnew"]
