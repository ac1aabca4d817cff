"""Cell-grid geometry helpers shared with the JAX package's halo module.

Only the geometry half of ``sph_bvf_tpu/core/halo.py`` is ported.  The CUDA
kernels index neighbour cells directly, with a bounds mask on a wall axis
and a wrap by index on a periodic one, so the padded halo buffers and ghost
columns the TPU kernels stream through (``assemble_padded``,
``assemble_tiled``, ``add_ghosts``) have no counterpart here: K1 and K4
stage each tile's 3x3 window of the 2D pack in shared memory
(``csrc/window_2d.cuh``).
"""

from __future__ import annotations

from typing import Tuple


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
