"""Replica ensembles of one scene (PyTorch).

Port of ``sph_bvf_tpu/parallel/ensemble.py``, the answer to the reference's
``-partition`` flag (lammps.cpp:112): R replicas of the same scene that
differ only in their random streams, the ensembles SSA runs are averaged
over.  ``stack_replicas`` stacks R copies of a state along a new leading
axis with replica r's key the JAX package's ``jax.random.PRNGKey(seed0 +
r)`` (the words ``[0, seed0 + r]`` for a seed below 2^32);
``run_chunk_ensemble`` runs a rebin and n steps for every replica.  The
pass-A and move kernels take one state, so the replicas run one after the
other; they share the density-filter phase, as they share the step
counter.
"""

from __future__ import annotations

import dataclasses

import torch

from sph_bvf_tpu_torch.core.state import State
from sph_bvf_tpu_torch.core.stepper import ModelSpec, run_chunk


def stack_replicas(state: State, n_replicas: int, seed0: int = 0) -> State:
    """R copies of ``state`` stacked along a new leading axis, replica r
    keyed ``[0, seed0 + r]``."""
    stacked = {
        f.name: getattr(state, f.name).unsqueeze(0).expand(
            (n_replicas,) + tuple(getattr(state, f.name).shape)).clone()
        for f in dataclasses.fields(state)
    }
    r = torch.arange(n_replicas, dtype=torch.int64, device=state.key.device)
    stacked["key"] = torch.stack([torch.zeros_like(r), seed0 + r], dim=1)
    return State(**stacked)


def replica(state: State, r: int) -> State:
    """Replica ``r`` of a stacked state, as a state of its own."""
    return State(**{f.name: getattr(state, f.name)[r]
                    for f in dataclasses.fields(state)})


def run_chunk_ensemble(state: State, params, spec: ModelSpec, n: int,
                       phase=None) -> State:
    """rebin + n steps for every replica of a stacked state (``phase`` as
    in ``run_chunk``: the chunk's starting step modulo ``freq_filter``,
    shared by the replicas)."""
    runs = [run_chunk(replica(state, r), params, spec, n, phase)
            for r in range(state.key.shape[0])]
    return State(**{f.name: torch.stack([getattr(s, f.name) for s in runs])
                    for f in dataclasses.fields(State)})
