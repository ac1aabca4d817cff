"""Device-mesh spatial decomposition (PyTorch, ``torch.distributed``).

Port of ``sph_bvf_tpu/parallel/mesh.py``.  The decomposition is the JAX
package's: 1-D x-slabs of the cell grid (its docstring argues for slabs
over the reference's 3-D brick).  Here every rank is one process that owns
one device and holds the ``State`` of its own slab, ``nx / n_ranks`` whole
x-planes, ``[..., cap, NC / n_ranks]``: the flat cell index is x-major, so
a contiguous block of the cell axis is a slab.  The program is SPMD, the
LAMMPS/MPI layout the reference itself uses:

- stages that touch one particle at a time (the integrators, the fixes,
  the Shepard filter, the drift count) run on the slab unchanged;
- a stencil stage (pass A, the rebin move) runs on the slab with one
  x-plane of halo on each side (``core/halo.ghost_slabs``: one exchange of
  edge planes with the two neighbours, the counterpart of ``lax.ppermute``)
  and keeps only the slab's own cells;
- a particle whose new cell lies in the neighbour's slab is taken by the
  neighbour's move from its halo and dropped here: migration with no
  communication beyond the halo;
- every value the host decides on (overflow, drift, a re-cut's acceptance,
  a halt, ``DtAdaptive``'s dt, a thermo row) is reduced over the ranks
  first, so every rank takes the same branch and the next collective
  finds them all.

The backend is the caller's: NCCL where each rank has a GPU of its own;
gloo on the CPU and where ranks share one GPU (NCCL refuses two ranks on
one device).  Under gloo a slab on the card goes through host memory,
explicitly (``halo._stage``, which refuses a host tensor under NCCL).

Pass B (``vws``/``aws``) reads f/m of the halo particles, which only the
neighbour's pass A gives, so it exchanges those 3 rows once more
(``ops/pair.compute_forces``).  The outputs gather the whole grid over the
mesh (``gather_state``) and rank 0 writes the file, the other ranks
waiting at a ``barrier``: ``io/checkpoint.save``, ``Restart``,
``io/vtk.dump_state`` and ``core/computes.gather_compute``, each with
``mesh=``.  A resume is every rank's ``checkpoint.load``, then
``shard_state``.

Refused (``ValueError``): ``nx`` that is not a multiple of the ranks, or a
slab of fewer than 2 planes; and an output given a slab without ``mesh=``
(``gather_particles``, ``checkpoint.save``, a dump, a compute:
``core/state.check_whole``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from sph_bvf_tpu_torch.core import halo
from sph_bvf_tpu_torch.core.state import (_SCALAR_LEAVES, Geometry, State,
                                          gather_particles as _gather_local,
                                          particle_fields)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of a 1-D mesh of ranks along x.

    ``group``: the ``torch.distributed`` process group (None: the default
    group); ``ranks``: the global rank of each position on the axis;
    ``rank``: this process's position; ``device``: the device its slab
    lives on; ``stats``: the halo exchange's counts (``halo._edges``)."""

    group: Any
    backend: str
    rank: int
    size: int
    device: torch.device
    ranks: Tuple[int, ...] = ()
    stats: dict = dataclasses.field(default_factory=dict)

    def peer(self, i: int) -> int:
        """The global rank at position ``i`` of the axis (modulo its size)."""
        return self.ranks[i % self.size]


def make_mesh(n_devices: Optional[int] = None, axis: str = "x",
              backend: Optional[str] = None, device=None) -> Optional[Mesh]:
    """The mesh of the first ``n_devices`` ranks (default: all) of the
    initialized default process group (``parallel/launch.spawn``).

    ``backend`` defaults to the group's; ``device`` to
    ``cuda:(rank % device_count)``.  Every rank of the group must call it
    (a smaller mesh makes a new group); a rank outside the mesh gets None.
    The slabs are cut along x only: any other ``axis`` raises."""
    if axis != "x":
        raise ValueError(f"a mesh along {axis!r}: the slabs are cut along x")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(sph_bvf_tpu_torch.parallel.launch.spawn)")
    world = dist.get_world_size()
    n = n_devices or world
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a group of {world}")
    ranks = tuple(range(n))
    group = None if n == world else dist.new_group(list(ranks))
    me = dist.get_rank()
    if me >= n:
        return None
    backend = backend or dist.get_backend(group)
    if device is None:
        device = torch.device("cuda", me % torch.cuda.device_count())
    device = torch.device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the NCCL backend needs a CUDA device per rank")
    return Mesh(group=group, backend=backend, rank=me, size=n, device=device,
                ranks=ranks)


def slab_planes(geom: Geometry, mesh: Mesh) -> int:
    """x-planes per rank.  Raises for an ``nx`` that is not a multiple of
    the ranks (``Scene.ncx_multiple_of``) and for a slab of fewer than 2
    planes (as the JAX package's ``sharded_eligible``)."""
    nx = geom.ncells[0]
    if nx % mesh.size:
        raise ValueError(
            f"{nx} x cells are not a multiple of the mesh's {mesh.size} "
            f"ranks: build with Scene.ncx_multiple_of({mesh.size})")
    planes = nx // mesh.size
    if planes < 2:
        raise ValueError(
            f"a slab of {planes} x plane(s) ({nx} over {mesh.size} ranks): "
            f"a mesh needs at least 2 planes a rank")
    return planes


def slab_of(geom: Geometry, mesh: Mesh) -> halo.SlabGeometry:
    """This rank's ghosted slab of ``geom`` (``halo.slab_geometry``)."""
    planes = slab_planes(geom, mesh)
    return halo.slab_geometry(geom, mesh.rank * planes, planes)


def plane_cells(geom: Geometry) -> int:
    """Cells of one x-plane: the halo's lane width."""
    return geom.ncells[1] * geom.ncells[2]


def all_reduce(t: torch.Tensor, mesh: Mesh, op: str = "sum") -> torch.Tensor:
    """``t`` reduced over the mesh (``op`` "sum" or "max"), on ``t``'s
    device; a one-rank mesh returns ``t``."""
    if mesh.size == 1:
        return t
    buf = halo._stage(t, mesh).clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX,
                    group=mesh.group)
    return buf.to(t.device)


def all_gather(tensors, mesh: Mesh) -> list:
    """Every rank's copy of each tensor [..., n], joined in rank order
    along the last axis: [..., size * n].  Tensors of any dtype, in one
    collective."""
    tensors = list(tensors)
    if mesh.size == 1:
        return tensors
    buf = halo._to_wire(tensors, mesh)
    bufs = [torch.empty_like(buf) for _ in range(mesh.size)]
    dist.all_gather(bufs, buf, group=mesh.group)
    parts = [halo._from_wire(b, tensors) for b in bufs]
    return [torch.cat([p[k] for p in parts], dim=-1)
            for k in range(len(tensors))]


def shard_state(state: State, mesh: Mesh, geom: Optional[Geometry] = None) -> State:
    """This rank's slab of ``state``, a state that every rank built the
    same way, on the mesh's device: every per-particle leaf's block of
    ``NC / size`` cells along its trailing cell axis; the bookkeeping
    scalars whole.  With ``geom`` the slab is checked to be whole x-planes
    (``slab_planes``)."""
    NC = state.valid.shape[-1]
    if geom is not None:
        slab_planes(geom, mesh)
    if NC % mesh.size:
        raise ValueError(f"{NC} cells over {mesh.size} ranks")
    n = NC // mesh.size
    lo = mesh.rank * n
    new = {k: v[..., lo:lo + n].contiguous().to(mesh.device)
           for k, v in particle_fields(state).items()}
    new.update({k: getattr(state, k).to(mesh.device) for k in _SCALAR_LEAVES})
    return dataclasses.replace(state, **new)


def replicate(tree, mesh: Mesh):
    """``tree`` (a dataclass of tensors, as ``Params``, or a tensor) on the
    mesh's device, every tensor rank 0's (a broadcast), so every rank runs
    the same coefficients."""
    def put(t):
        t = t.to(mesh.device)
        if mesh.size == 1:
            return t
        buf = halo._stage(t, mesh).clone()
        dist.broadcast(buf, src=mesh.peer(0), group=mesh.group)
        return buf.to(mesh.device)

    if isinstance(tree, torch.Tensor):
        return put(tree)
    return dataclasses.replace(tree, **{
        f.name: put(getattr(tree, f.name)) for f in dataclasses.fields(tree)
        if isinstance(getattr(tree, f.name), torch.Tensor)})


def gather_state(state: State, mesh: Mesh, names=None) -> State:
    """The whole grid's state on every rank: each per-particle leaf (of
    ``names``, by default every one; the others left as this rank's)
    joined over the ranks in slab order; the bookkeeping scalars (the same
    on every rank) this rank's."""
    fields = particle_fields(state)
    names = list(fields) if names is None else list(names)
    joined = all_gather([fields[k] for k in names], mesh)
    return dataclasses.replace(state, **dict(zip(names, joined)))


def gather_particles(state: State, geom: Geometry, mesh: Optional[Mesh] = None,
                     fields=("x", "v", "rho")) -> dict:
    """``core/state.gather_particles`` of the whole grid: every rank's
    valid particles by tag (host numpy, on every rank), to hold a sharded
    run against a single-device one."""
    if mesh is not None:
        state = gather_state(state, mesh, ("valid", "tag") + tuple(fields))
    return _gather_local(state, geom, fields)


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait for every rank of the mesh (none without one): after rank 0
    wrote a file, so that no rank reads it before it is whole."""
    if mesh is not None and mesh.size > 1:
        dist.barrier(group=mesh.group)


def global_n_valid(state: State, mesh: Optional[Mesh]) -> int:
    """Valid particles over every rank's slab."""
    n = state.n_valid
    return int(n if mesh is None else all_reduce(n, mesh))

