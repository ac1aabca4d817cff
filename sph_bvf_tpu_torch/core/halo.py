"""Cell-grid geometry helpers shared with the JAX package's halo module,
and the x-slab halo of a multi-device run.

Only the geometry half of ``sph_bvf_tpu/core/halo.py`` is ported, plus
``exchange_slabs``.  The CUDA kernels index neighbour cells directly, with
a bounds mask on a wall axis and a wrap by index on a periodic one, so the
padded halo buffers and ghost columns the TPU kernels stream through
(``assemble_padded``, ``assemble_tiled``, ``add_ghosts``) have no
counterpart here: K1 and K4 stage each tile's 3x3 window of the 2D pack in
shared memory (``csrc/window_2d.cuh``).

Under a mesh (``parallel/mesh.py``) each rank holds an x-slab of the grid.
A stencil stage runs on the slab with one x-plane of halo on each side
(``ghost_slabs``: one ``exchange_slabs`` of every field it reads), on the
grid ``SlabGeometry`` describes, and keeps its own cells' results.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from sph_bvf_tpu_torch.core.state import Geometry


@dataclasses.dataclass(frozen=True)
class SlabGeometry(Geometry):
    """The grid one rank's stencil stages index: its x-slab of ``whole``
    (global planes ``x0`` .. ``x0 + ncells[0] - 3``) with one halo plane on
    each side, so ``ncells[0]`` is the slab's planes plus 2.  Everything
    else is the whole grid's, its periodic flags included: a pair offset
    takes the minimum image as there, and a cell of the slab never steps
    past the halo planes, so an x wrap by index (the kernels wrap a
    periodic axis's neighbour cells) reaches only the halo planes' own
    cells, whose sums are dropped.  No x columns: a slab never bins."""

    whole: Optional[Geometry] = None
    x0: int = 0


def slab_geometry(geom: Geometry, x0: int, planes: int) -> SlabGeometry:
    """The ghosted grid of the slab of ``planes`` x-planes of ``geom`` from
    global plane ``x0``."""
    fields = {f.name: getattr(geom, f.name) for f in dataclasses.fields(Geometry)}
    fields.update(ncells=(planes + 2,) + tuple(geom.ncells[1:]), x_edges=None)
    return SlabGeometry(**fields, whole=geom, x0=x0)


def ghost_axes(geom) -> Tuple[int, ...]:
    """Inner axes (y=1, z=2) that need ghost columns: periodic, multi-cell."""
    return tuple(
        ax for ax in (1, 2) if geom.periodic[ax] and geom.ncells[ax] > 1
    )


def ghosted_ncells(geom) -> Tuple[int, int, int]:
    ga = ghost_axes(geom)
    nx, ny, nz = geom.ncells
    return (nx, ny + 2 * (1 in ga), nz + 2 * (2 in ga))


def ghosted_strides(geom) -> Tuple[int, int, int]:
    nx, ny, nz = ghosted_ncells(geom)
    return (ny * nz, nz, 1)


def wrap_x(geom) -> bool:
    """Leading-axis wrap needed: periodic x with more than one cell."""
    return bool(geom.periodic[0]) and geom.ncells[0] > 1


def wrap_y(geom) -> bool:
    """y wrap needed (the JAX package's ghost columns on y): periodic y with
    more than one cell."""
    return 1 in ghost_axes(geom)


def periodic_multicell(geom) -> bool:
    """Any periodic axis with more than one cell (an x wrap or ghost
    columns): the 2D grids on which K1 and K4 take their full pair body."""
    return wrap_x(geom) or bool(ghost_axes(geom))


def wrap_axes(geom) -> Tuple[bool, bool, bool]:
    """Per axis: periodic with more than one cell, so a neighbour cell wraps
    by index and a pair offset takes the minimum image (the axes of
    ``ops/pair._pbc``)."""
    return tuple(bool(geom.periodic[ax]) and geom.ncells[ax] > 1
                 for ax in range(3))


def wrap_bits(geom) -> int:
    """``wrap_axes`` as the kernels' bit mask: bit a for axis a."""
    return sum(1 << ax for ax, w in enumerate(wrap_axes(geom)) if w)


def narrow_wrap_axes(geom) -> Tuple[str, ...]:
    """The wrapping axes ("x", "y", "z") with fewer than 3 cells, which the
    kernels refuse: a stencil would reach one neighbour cell twice."""
    return tuple("xyz"[ax] for ax, w in enumerate(wrap_axes(geom))
                 if w and geom.ncells[ax] < 3)


def grid_3d(geom) -> bool:
    """A grid the 3D kernels (K3, K7) take: 27-cell stencils, or any grid
    with more than one cell along z."""
    return geom.dim != 2 or geom.ncells[2] != 1


def max_flat_offset(geom) -> int:
    """Largest |flat offset| of any stencil step, on the ghosted grid."""
    st = ghosted_strides(geom)
    return sum(s for s, n in zip(st, geom.ncells) if n > 1)


# ---------------------------------------------------------------------------
# the halo of an x-slab
# ---------------------------------------------------------------------------


def _stage(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` where the mesh's backend can read it: on the host under gloo;
    NCCL reads only CUDA tensors, and any other raises here."""
    if mesh.backend == "gloo":
        return t.cpu()
    if mesh.backend == "nccl" and not t.is_cuda:
        raise ValueError(f"a {t.device} tensor in an NCCL collective: "
                         "put it on the mesh's device")
    return t


def _to_wire(tensors: Sequence[torch.Tensor], mesh) -> torch.Tensor:
    """The tensors' bytes, one after another, as one uint8 vector, staged
    for the mesh's backend (``_stage``)."""
    parts = [t.contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    buf = torch.cat(parts) if parts else torch.zeros(0, dtype=torch.uint8)
    return _stage(buf, mesh)


def _from_wire(buf: torch.Tensor, likes: Sequence[torch.Tensor]) -> list:
    """``_to_wire``'s inverse: tensors of the shapes, dtypes and device of
    ``likes`` from the bytes in ``buf``."""
    out, at = [], 0
    for t in likes:
        n = t.numel() * t.element_size()
        # a copy of its own starts at offset 0, so any dtype may view it
        part = buf[at:at + n].to(t.device, copy=True).view(t.dtype)
        part = part.reshape(t.shape)
        out.append(part)
        at += n
    return out


def _edges(tensors, width: int, mesh, periodic: bool, label=None):
    """(left halos, right halos) of ``tensors``: each the left neighbour's
    last ``width`` lanes and the right neighbour's first, in one send each
    way (``dist.batch_isend_irecv``: blocking sends around a ring would
    deadlock).  A chain's ends get zeros; one rank gets its own far edges
    on a ring and zeros on walls.  Counts its exchanges, the bytes it sends
    and its host time in ``mesh.stats``, and with ``label`` also in
    ``mesh.stats[label]``, a dict of the same counts."""
    t0 = time.perf_counter()
    last = [t[..., -width:] for t in tensors]
    first = [t[..., :width] for t in tensors]
    n, i = mesh.size, mesh.rank
    has_left = periodic or i > 0
    has_right = periodic or i < n - 1
    if n == 1:
        left = last if periodic else [torch.zeros_like(t) for t in last]
        right = first if periodic else [torch.zeros_like(t) for t in first]
        return left, right
    send_r, send_l = _to_wire(last, mesh), _to_wire(first, mesh)
    recv_l, recv_r = torch.empty_like(send_r), torch.empty_like(send_l)
    # tags keep the two directions apart when both neighbours are one rank
    # (two ranks on a ring); NCCL, which ignores tags, matches each peer's
    # sends and receives in this order
    ops = []
    if has_right:
        ops.append(dist.P2POp(dist.isend, send_r, mesh.peer(i + 1),
                              mesh.group, tag=0))
    if has_left:
        ops.append(dist.P2POp(dist.isend, send_l, mesh.peer(i - 1),
                              mesh.group, tag=1))
        ops.append(dist.P2POp(dist.irecv, recv_l, mesh.peer(i - 1),
                              mesh.group, tag=0))
    if has_right:
        ops.append(dist.P2POp(dist.irecv, recv_r, mesh.peer(i + 1),
                              mesh.group, tag=1))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    left = (_from_wire(recv_l, last) if has_left
            else [torch.zeros_like(t) for t in last])
    right = (_from_wire(recv_r, first) if has_right
             else [torch.zeros_like(t) for t in first])
    sent = ((send_r.numel() if has_right else 0)
            + (send_l.numel() if has_left else 0))
    seconds = time.perf_counter() - t0
    for stats in ((mesh.stats,) if label is None
                  else (mesh.stats, mesh.stats.setdefault(label, {}))):
        stats["exchanges"] = stats.get("exchanges", 0) + 1
        stats["bytes"] = stats.get("bytes", 0) + sent
        stats["seconds"] = stats.get("seconds", 0.0) + seconds
    return left, right


def exchange_slabs(M: torch.Tensor, width: int, mesh,
                   periodic: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fetch the neighbouring ranks' edge slabs of ``M`` [..., NC_loc]:
    ``(halo_left, halo_right)`` of lane width ``width``, the left
    neighbour's last ``width`` lanes and the right neighbour's first.  With
    ``periodic`` the ranks form a ring; otherwise the chain's ends receive
    zeros.  A one-rank mesh degenerates as the JAX package's
    ``exchange_slabs``: on a ring the halos are its own far edges, on walls
    nothing is exchanged.  ``mesh``: ``parallel/mesh.Mesh``."""
    (left,), (right,) = _edges([M], width, mesh, periodic)
    return left, right


def ghost_slabs(tensors: Sequence[torch.Tensor], width: int, mesh,
                periodic: bool, label=None) -> List[torch.Tensor]:
    """Every tensor [..., NC_loc] with its halos, [..., width + NC_loc +
    width]: one exchange for them all, whatever their dtypes (``label``:
    ``_edges``')."""
    left, right = _edges(list(tensors), width, mesh, periodic, label)
    return [torch.cat([a, t, b], dim=-1)
            for a, t, b in zip(left, tensors, right)]
