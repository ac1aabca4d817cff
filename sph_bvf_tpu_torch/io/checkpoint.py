"""Checkpoint / resume — the analog of write_restart / read_restart.

Port of ``sph_bvf_tpu/io/checkpoint.py``, in its file format: one ``.npz``
per checkpoint holding every State field under its own name (the JAX
package's keys) and the geometry fingerprint under ``__meta__``, so a file
written by either package loads in the other.  The reference packs x, v,
tag, type, mask, image, rho, e, cv, vest, C, Cd and the SSA matrices per
atom (atom_vec_ssa_tsdpd_atomic.cpp:1668 pack_restart) but does NOT save
RNG state — its pair styles seed from wall clock (srand(clock()),
pair_ssa_tsdpd_bvf_transport_velocity.cpp:957), so a reference resume is
not reproducible.  Here the checkpoint is the full State (every
per-particle field plus step, dt, the PRNG key and the overflow and drift
counters), so a resume is bitwise identical to an uninterrupted run.

The one dtype that differs between the packages is the PRNG key: the file
holds the JAX package's uint32 key words, the port's State an int64 pair
of the same values; ``save`` and ``load`` convert, word for word.

Under an x-slab mesh (``parallel/mesh.py``) ``save`` and ``Restart`` take
``mesh=``: every rank gathers the whole grid, rank 0 writes the file a
single device would, and every rank waits until it is whole.  A resume is
the JAX package's: every rank ``load``s the file, then ``shard_state``.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from sph_bvf_tpu_torch.core.state import Geometry, State, check_whole, resolve_device
from sph_bvf_tpu_torch.parallel.mesh import barrier, gather_state

_FORMAT_VERSION = 1


def _geom_meta(geom: Geometry) -> dict:
    return dict(
        version=_FORMAT_VERSION,
        dim=geom.dim,
        lo=list(geom.lo),
        hi=list(geom.hi),
        ncells=list(geom.ncells),
        cell_size=list(geom.cell_size),
        cap=geom.cap,
        periodic=list(geom.periodic),
        drift_budget=geom.drift_budget,
        base_occ=geom.base_occ,
        x_edges=list(geom.x_edges) if geom.x_edges is not None else None,
        x_quantum=geom.x_quantum,
        cutoff=geom.cutoff,
    )


def _to_host(name: str, a: torch.Tensor) -> np.ndarray:
    a = a.detach().cpu().numpy()
    # the key's two words, as the JAX package's uint32 PRNGKey holds them
    return a.astype(np.uint32) if name == "key" else a


def save(path: str, state: State, geom: Geometry, mesh=None) -> None:
    """Write the full state (incl. step, dt, RNG key) to ``path`` (.npz).
    ``state`` holds the whole grid (``core/state.check_whole``), or with
    ``mesh`` (``parallel/mesh.Mesh``) this rank's slab: every rank of the
    mesh calls this, rank 0 writes the whole grid's file and every rank
    returns once it is written."""
    if mesh is not None:
        state = gather_state(state, mesh)
    check_whole(state, geom, "checkpoint.save")
    if mesh is None or mesh.rank == 0:
        arrays = {
            f.name: _to_host(f.name, getattr(state, f.name))
            for f in dataclasses.fields(state)
        }
        arrays["__meta__"] = np.frombuffer(
            json.dumps(_geom_meta(geom)).encode(), dtype=np.uint8
        )
        np.savez_compressed(path, **arrays)
    barrier(mesh)


def _read_meta(z) -> dict:
    meta = json.loads(bytes(z["__meta__"]).decode())
    if meta["version"] != _FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version {meta['version']}")
    return meta


def _state(z, device) -> State:
    """The State in the open file ``z`` on ``device``; the key's uint32
    words become the port's int64 pair of the same values."""
    kwargs = {}
    for f in dataclasses.fields(State):
        a = z[f.name]
        if f.name == "key":
            a = a.astype(np.int64)
        kwargs[f.name] = torch.as_tensor(a, device=device)
    return State(**kwargs)


def load(path: str, geom: Geometry, device=None) -> State:
    """Read a checkpoint onto ``device`` (default: the card); validates the
    geometry fingerprint."""
    device = resolve_device(device)
    with np.load(path) as z:
        meta = _read_meta(z)
        want = _geom_meta(geom)
        for k in ("dim", "ncells", "cap"):
            if meta[k] != want[k]:
                raise ValueError(
                    f"checkpoint geometry mismatch: {k}={meta[k]} vs {want[k]}"
                )
        return _state(z, device)


def load_with_geometry(path: str, device=None):
    """read_restart analog (read_restart.cpp): rebuild the Geometry from the
    checkpoint's own metadata, so a resume needs no scene re-construction.
    Returns (state on ``device``, default the card; geom)."""
    device = resolve_device(device)
    with np.load(path) as z:
        meta = _read_meta(z)
        geom = Geometry(
            dim=meta["dim"],
            lo=tuple(meta["lo"]),
            hi=tuple(meta["hi"]),
            ncells=tuple(meta["ncells"]),
            cell_size=tuple(meta["cell_size"]),
            cap=meta["cap"],
            periodic=tuple(meta["periodic"]),
            drift_budget=meta.get("drift_budget", 0.0),
            base_occ=int(meta.get("base_occ", 0)),
            x_edges=(
                tuple(meta["x_edges"])
                if meta.get("x_edges") is not None
                else None
            ),
            x_quantum=float(meta.get("x_quantum", 0.0)),
            cutoff=float(meta.get("cutoff", 0.0)),
        )
        return _state(z, device), geom


class Restart:
    """Periodic checkpointing, like the `restart N file` command
    (output.cpp:86-91).  Call from the simulate() callback; under a mesh
    every rank calls it with the mesh (``save``'s ``mesh``): ``state.step``
    is the same on every rank, so they all save together."""

    def __init__(self, every: int, path_template: str, geom: Geometry,
                 mesh=None):
        self.every = every
        self.path_template = path_template
        self.geom = geom
        self.mesh = mesh

    def __call__(self, state: State):
        step = int(state.step)
        if step % self.every == 0:
            save(self.path_template.format(step=step), state, self.geom,
                 self.mesh)
