"""The locality rebin moves and their wrappers: K5 and K6
(``csrc/rebin_move_2d.cu``, one kernel) and K7 (``csrc/rebin_move_3d.cu``).

Ports of ``sph_bvf_tpu/core/rebin_pallas.py``: K5 for the 2D static branch
(cap <= 16), K6 for the 2D gated branch (16 < cap <= ``GATED_MAX_CAP``,
1807: its slot lists' shared memory; a 2D grid past it takes the sort
rebin, as the JAX package's grid past its VMEM budget), K7 for the 3D
tiled kernel (any cap); each with walls or periodic axes (of at least 3
cells; x, y and, in 3D, z alike) and with uniform or non-uniform x columns
(``Geometry.x_edges``, the load-balance lever).  The three share their
binning, wrap and walk (``csrc/rebin_move.cuh``: a warp per target cell
ranks its matches, a block of target cells copies from their slot lists in
shared memory); K5 and K6 launch it on a plane, from one library, each
counting its own launches (``_library``).  Between rebins a particle
moves at most one cell (the drift contract ``core/state.rebin`` checks), so
the particles that belong in cell c are the matching candidates among the
slots of its 3^dim stencil cells.  Walking them slot-major, then by the
source cell's flat index after the periodic wrap, visits them in the sort
rebin's stable (cell, old flat slot) order, so the slot assignment is
bit-identical to the sort.

``move`` packs the per-particle fields into one f32 and one i32 matrix,
launches the kernel the grid routes to on a CUDA tensor or runs
``rebin_move_plain`` (the same ordered walk in vectorized PyTorch) on a
CPU tensor, and unpacks.  A CUDA call no kernel serves raises; it never
falls back.

Under a mesh (``parallel/mesh.py``) the packs of a rank's x-slab get one
halo plane on each side (``core/halo.ghost_slabs``) and the same kernels
move them (``slab``: ``halo.SlabGeometry``): the targets are the slab's own
cells, the sources the ghosted slab, every bin is taken on the global grid
against a global cell id, and each window's source cells are ranked by
their global flat index, so the slots are bitwise the single grid's.  A
particle bound for the neighbour's slab is taken there, from its halo.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from sph_bvf_tpu_torch import _build
from sph_bvf_tpu_torch.core.halo import (SlabGeometry, ghost_slabs, grid_3d,
                                         narrow_wrap_axes, wrap_axes, wrap_bits,
                                         wrap_x, wrap_y)
from sph_bvf_tpu_torch.core.state import Geometry, cell_index_of, x_columns
from sph_bvf_tpu_torch.utils.profiler import span

MAX_CAP = 16  # K5's, the JAX package's static branch's
# K6's: kMaxCap in csrc/rebin_move_2d.cu, the largest cap whose slot lists,
# i32 [cap, K6_CELLS], fit beside the kernel's K6_STATIC bytes of static
# shared memory in the 232,448 bytes an H100 block may opt in to (past
# DEFAULT_SHARED, 48 KB, the kernel opts in)
K6_CELLS = 32
K6_STATIC = 4 * (8 * 32 + K6_CELLS)
DEFAULT_SHARED = 48 * 1024
GATED_MAX_CAP = (232448 - K6_STATIC) // (4 * K6_CELLS)
# K7's target cells per block (kCells in csrc/rebin_move_3d.cu: 16 was the
# fastest of 8, 16 and 32 over the main paths' launches on the H100,
# PERF.md), and the most bytes of shared memory their slot lists, i32 [cap,
# K7_CELLS], may take (within the 48 KB a block holds without opting in):
# past it the lists go to an i32 [cap, NC] scratch in global memory
# (``k7_list``)
K7_CELLS = 16
K7_LIST_BYTES = 40 * 1024


def k7_list(cap: int) -> bool:
    """Whether K7's slot lists at ``cap`` live in shared memory: while their
    ``4 * cap * K7_CELLS`` bytes fit ``K7_LIST_BYTES`` (up to cap 640; the
    3D FSI beam's at nx=60 is 296), else in the global scratch."""
    return 4 * cap * K7_CELLS <= K7_LIST_BYTES


def k7_attributes(shared: bool) -> tuple:
    """(registers per thread, local-memory bytes per thread: its spills) of
    K7's instantiation with its slot lists in shared memory (``shared``) or
    in the global scratch, from ``cudaFuncGetAttributes``."""
    lib = _build.load("rebin_move_3d")
    fn = lib.rebin_move_3d_attributes
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 2
    regs, local = ctypes.c_int(0), ctypes.c_int(0)
    _build.check(lib, fn(int(shared), ctypes.byref(regs),
                         ctypes.byref(local)), "rebin_move_3d_attributes")
    return regs.value, local.value


MOVE_2D_ATTRIBUTES = ("registers", "local_bytes", "cells", "rows")


def move_2d_attributes(lib=None) -> dict:
    """The 2D move's kernel (K5's and K6's; of ``lib`` if given, else of the
    package's build), from ``cudaFuncGetAttributes`` and its build:
    registers per thread, local-memory bytes per thread (its spills and
    stack), target cells a block and the rows a thread of its copy loads
    before it stores them."""
    lib = lib or _build.load("rebin_move_2d")
    fn = lib.rebin_move_2d_attributes
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * len(MOVE_2D_ATTRIBUTES)
    out = [ctypes.c_int(0) for _ in MOVE_2D_ATTRIBUTES]
    _build.check(lib, fn(*(ctypes.byref(v) for v in out)),
                 "rebin_move_2d_attributes")
    return dict(zip(MOVE_2D_ATTRIBUTES, (v.value for v in out)))


def move_unsupported(geom: Geometry, kernel) -> list:
    """What keeps the move wrapper ``kernel`` from serving this grid.

    K7 takes a 3D grid of any cap (its slot lists live in shared memory,
    or past ``K7_LIST_BYTES`` in a scratch in global memory); K5 a 2D grid
    of cap <= 16; K6 a 2D grid of 16 < cap <= ``GATED_MAX_CAP`` (one
    kernel, whose slot lists live in shared memory; ``sort_route`` takes
    a larger cap).
    Each takes walls or periodic axes (x, y and, in 3D, z alike), and
    uniform or non-uniform x columns (``x_edges``) alike.  A periodic axis
    needs at least 3 cells (with 2, the same source cell would sit in a
    target's window twice)."""
    is3d = kernel is rebin_move_3d
    limit = {rebin_move_2d: MAX_CAP, rebin_move_2d_gated: GATED_MAX_CAP}.get(kernel)
    checks = [("a 2D grid" if is3d else "a 3D grid", grid_3d(geom) != is3d),
              (f"cap {geom.cap} above {limit}",
               limit is not None and geom.cap > limit)]
    checks += [(f"a periodic {a} axis with fewer than 3 cells", True)
               for a in narrow_wrap_axes(geom)]
    if kernel is rebin_move_2d_gated:
        checks.append((f"cap {geom.cap} of at most {MAX_CAP} (K5's)",
                       geom.cap <= MAX_CAP))
    return [what for what, bad in checks if bad]


def _move_kernels(geom: Geometry) -> tuple:
    """The move wrappers that may serve this grid, in the order tried."""
    return ((rebin_move_3d,) if grid_3d(geom)
            else (rebin_move_2d, rebin_move_2d_gated))


def move_route(geom: Geometry):
    """The kernel wrapper that serves this grid's rebin move
    (``move_unsupported`` lists the rules), or None."""
    for kernel in _move_kernels(geom):
        if not move_unsupported(geom, kernel):
            return kernel
    return None


def move_supported(geom: Geometry) -> bool:
    """Does a locality-walk kernel serve this grid (see ``move_route``)?"""
    return move_route(geom) is not None


def sort_route(geom: Geometry) -> bool:
    """Does this grid's rebin on the card take the sort: a 2D grid whose
    cap passes K6's shared memory (``GATED_MAX_CAP``), as the JAX
    package's gated move routes a grid past its VMEM budget to the sort
    (``rebin_pallas.py:103-112``).  Chosen from the geometry alone, before
    any launch."""
    return (not grid_3d(geom) and geom.cap > GATED_MAX_CAP
            and not narrow_wrap_axes(geom))


def move_refusal(geom: Geometry) -> str:
    """Why no move kernel serves this grid: each candidate's reasons."""
    return "; ".join(f"{k.__name__}: " + ", ".join(move_unsupported(geom, k))
                     for k in _move_kernels(geom))


def _pack_fields(fields: Dict[str, torch.Tensor], cap: int, NC: int):
    """One f32 and one i32 matrix [rows, cap, NC]; i32 row 0 is ``valid``."""
    fmeta, imeta = [], []  # (name, nrows, lead_shape, dtype)
    fmats = []
    imats = [fields["valid"].to(torch.int32).reshape(1, cap, NC)]
    for name, a in fields.items():
        if name == "valid" or a.numel() == 0:
            continue
        r = a.reshape(-1, cap, NC)
        if a.dtype.is_floating_point:
            fmeta.append((name, r.shape[0], a.shape[:-2], a.dtype))
            fmats.append(r)
        else:
            imeta.append((name, r.shape[0], a.shape[:-2], a.dtype))
            imats.append(r.to(torch.int32))
    return torch.cat(fmats), torch.cat(imats), fmeta, imeta


def _unpack_fields(outf, outi, fmeta, imeta, fields, cap, NC):
    new_fields = {"valid": outi[0] != 0}
    r = 0
    for name, nrows, lead, dtype in fmeta:
        new_fields[name] = outf[r: r + nrows].reshape(tuple(lead) + (cap, NC))
        r += nrows
    r = 1
    for name, nrows, lead, dtype in imeta:
        new_fields[name] = outi[r: r + nrows].to(dtype).reshape(
            tuple(lead) + (cap, NC))
        r += nrows
    for name, a in fields.items():
        if name not in new_fields:  # size-0 species arrays pass through
            new_fields[name] = a
    return new_fields


def _x_row(fmeta) -> int:
    r = 0
    for name, nrows, _, _ in fmeta:
        if name == "x":
            return r
        r += nrows
    raise KeyError("x")


def _walk_sources(geom: Geometry, device, slab: SlabGeometry = None):
    """The candidate source cells of every target cell, [3^dim, nt] each:
    the source cell's index in the packs (0 where off the grid) and whether
    it is on the grid, ordered per target by ascending global flat index
    after the periodic wraps (off-grid candidates last); and the targets'
    global flat indices [nt].  The targets are every cell of ``geom``, or
    with ``slab`` the slab's own cells, whose sources lie in the ghosted
    slab (one halo plane each side)."""
    nx, ny, nz = geom.ncells
    NC = geom.ncells_total
    x0, planes = (0, nx) if slab is None else (slab.x0, slab.ncells[0] - 2)
    c = torch.arange(x0 * ny * nz, (x0 + planes) * ny * nz, dtype=torch.int64,
                     device=device)
    cx, cy, cz = c // (ny * nz), (c // nz) % ny, c % nz
    wx, wy, wz = wrap_axes(geom)
    keys, addrs, ons = [], [], []
    for ox, oy, oz in geom.stencil_offsets():
        sx, sy, sz = cx + ox, cy + oy, cz + oz
        # the source's plane in the packs: on a slab, its halo plane for a
        # step past the slab's ends, before any wrap
        lx = sx if slab is None else sx - x0 + 1
        if wx:
            sx = sx % nx
            lx = lx % nx if slab is None else lx
        if wy:
            sy = sy % ny
        if wz:
            sz = sz % nz
        keys.append((sx * ny + sy) * nz + sz)
        addrs.append((lx * ny + sy) * nz + sz)
        ons.append((sx >= 0) & (sx < nx) & (sy >= 0) & (sy < ny)
                   & (sz >= 0) & (sz < nz))
    on_grid = torch.stack(ons)
    _, order = torch.sort(torch.where(on_grid, torch.stack(keys), NC),
                          dim=0, stable=True)
    on_grid = torch.gather(on_grid, 0, order)
    src = torch.gather(torch.stack(addrs), 0, order)
    return torch.where(on_grid, src, 0), on_grid, c


def rebin_move_plain(PF: torch.Tensor, PI: torch.Tensor, geom: Geometry,
                     xr: int, slab: SlabGeometry = None):
    """The K5/K6/K7 walk in vectorized PyTorch: the kernels' plain version.

    For every target cell the candidates are taken slot-major, then by
    ascending source-cell global flat index after the periodic wrap; a
    candidate matches when it is valid, its source cell lies on the grid
    and ``cell_index_of`` of its position (on the global grid ``geom``) is
    the target.  The first ``cap`` matches fill output slots 0.. in order.
    With ``slab`` the packs hold the ghosted slab and the outputs its own
    cells, [rows, cap, NC of the slab].
    """
    _, cap, NC_in = PF.shape
    dev = PF.device
    src_cell, on_grid, c = _walk_sources(geom, dev, slab)
    nt = c.shape[0]
    # flat source slot of every candidate, slot-major: [cap, 3^dim, nt]
    slots = torch.arange(cap, dtype=torch.int64, device=dev)[:, None, None]
    k = (slots * NC_in + src_cell[None]).reshape(cap * src_cell.shape[0], nt)
    valid = PI[0].reshape(-1) != 0
    newcell = cell_index_of(PF[xr: xr + 3].reshape(3, -1), geom).to(torch.int64)
    match = (on_grid.repeat(cap, 1) & valid[k] & (newcell[k] == c[None]))
    rank = torch.cumsum(match.to(torch.int64), dim=0) - 1
    keep = match & (rank < cap)
    # output slot (rank, target) takes candidate k; one spare slot for the
    # rest
    M = cap * nt
    dest = torch.where(keep, rank * nt + torch.arange(nt, device=dev)[None], M)
    src = torch.full((M + 1,), -1, dtype=torch.int64, device=dev)
    src.scatter_(0, dest.reshape(-1), k.reshape(-1))
    src = src[:M]
    got = src >= 0
    src = torch.clamp(src, min=0)
    outf = torch.where(got, PF.reshape(PF.shape[0], cap * NC_in)[:, src],
                       torch.zeros((), dtype=PF.dtype, device=dev))
    outi = torch.where(got, PI.reshape(PI.shape[0], cap * NC_in)[:, src],
                       torch.zeros((), dtype=PI.dtype, device=dev))
    return (outf.reshape(PF.shape[0], cap, nt),
            outi.reshape(PI.shape[0], cap, nt))


def _check_packs(PF: torch.Tensor, PI: torch.Tensor, geom: Geometry, wrapper,
                 slab: SlabGeometry = None):
    missing = move_unsupported(geom, wrapper)
    if missing:
        raise NotImplementedError(
            f"rebin move kernel {wrapper.__name__} for " + ", ".join(missing)
            + f" (dim={geom.dim}, ncells={geom.ncells}, periodic="
            f"{geom.periodic}) is ported in a later PR")
    if PF.dtype != torch.float32 or PI.dtype != torch.int32:
        raise TypeError(f"rebin move kernel takes f32/i32 packs, got "
                        f"{PF.dtype}/{PI.dtype}")
    _, cap, NC = PF.shape
    grid = slab or geom
    if (cap, NC) != (geom.cap, grid.ncells_total) or PI.shape[1:] != PF.shape[1:]:
        raise ValueError(f"packs {tuple(PF.shape)}/{tuple(PI.shape)} do not "
                         f"match the geometry [{geom.cap}, {grid.ncells_total}]")
    if not (PF.is_contiguous() and PI.is_contiguous()) or PI.device != PF.device:
        raise ValueError("rebin move kernel packs must be contiguous on one device")
    if cap * NC >= 2**31:
        raise ValueError(f"{cap * NC} slots overflow the kernels' 32-bit index")


def _bin_constants(geom: Geometry, naxes: int):
    """f32 lo and 1/cell_size of the first ``naxes`` axes (all lo, then all
    inverses), exactly the constants ``cell_index_of`` rounds to."""
    lo = [float(np.float32(v)) for v in geom.lo[:naxes]]
    inv = [float(np.float32(1.0 / cs)) for cs in geom.cell_size[:naxes]]
    return lo + inv


def _column_bounds(geom: Geometry, device):
    """(xb, f32 1/x_quantum, n_fine): the x-edges arguments of every move
    kernel.  ``xb`` is the i32 [nx+1] tensor of each column's fine-bin
    bounds, None (a null pointer: uniform columns) without edges or with
    one column, where ``cell_index_of`` ignores the edges."""
    if geom.x_edges is None or geom.ncells[0] == 1:
        return None, 0.0, 0
    cols = x_columns(geom, device, torch.float32)
    return (cols.bounds, float(np.float32(1.0 / geom.x_quantum)),
            cols.table.shape[0])


def _x_span(geom: Geometry) -> float:
    """The f32 span ``x_edges[-1] - x_edges[0]`` that the x-edges binning
    wraps a periodic x by (0 without edges, unread)."""
    span = geom.x_edges[-1] - geom.x_edges[0] if geom.x_edges else 0.0
    return float(np.float32(span))


def _wrap_2d(geom: Geometry) -> tuple:
    """The periodic arguments of the 2D move: wrapx, wrapy and the x span."""
    return ((ctypes.c_int, int(wrap_x(geom))), (ctypes.c_int, int(wrap_y(geom))),
            (ctypes.c_float, _x_span(geom)))


def _slab_args(geom: Geometry, slab: SlabGeometry = None) -> tuple:
    """The move kernels' slab arguments (csrc/rebin_move.cuh): the global
    plane of the packs' plane 0, the global plane count, whether the global
    x is periodic, the first target cell and the target count."""
    nx = geom.ncells[0]
    if slab is None:
        return 0, nx, int(wrap_x(geom)), 0, geom.ncells_total
    plane = geom.ncells[1] * geom.ncells[2]
    return (slab.x0 - 1, nx, int(wrap_x(geom)), plane,
            (slab.ncells[0] - 2) * plane)


def _library(wrapper) -> str:
    """The library (``csrc/<name>.cu``) and C entry point ``wrapper``
    launches: its own name, but K5's for K6."""
    return ("rebin_move_2d" if wrapper is rebin_move_2d_gated
            else wrapper.__name__)


def _launch(wrapper, PF: torch.Tensor, PI: torch.Tensor, geom: Geometry,
            xr: int, naxes: int, extra=(), lists: bool = None,
            slab: SlabGeometry = None):
    """Launch ``wrapper``'s kernel (``csrc/<name>.cu``, ``_library``) on the
    packs and count the launch on ``wrapper``.

    Every move kernel's C entry point takes the four packs, their row
    counts and cap, the cell counts of the first ``naxes`` axes, the x row,
    those axes' f32 binning constants, then ``extra`` (``(ctypes type,
    value)`` pairs), the x columns' fine-bin bounds (``_column_bounds``),
    the slab's arguments (``_slab_args``), with ``lists`` =
    ``k7_list(cap)`` K7's slot lists' scratch (null for lists in shared
    memory, else an i32 [cap, NC] one), and the stream.  The cell counts
    are the packs' grid's: the ghosted slab's with ``slab``.  Returns
    (outF, outI), [rows, cap, the target cells]."""
    _check_packs(PF, PI, geom, wrapper, slab)
    sa = _slab_args(geom, slab)
    outf = torch.empty((PF.shape[0], geom.cap, sa[-1]), dtype=PF.dtype,
                       device=PF.device)
    outi = torch.empty((PI.shape[0], geom.cap, sa[-1]), dtype=PI.dtype,
                       device=PI.device)
    tail = ()
    if lists is not None:
        scratch = (None if lists else torch.empty(
            PI.shape[1:], dtype=torch.int32, device=PI.device))
        tail = (None if scratch is None else scratch.data_ptr(),)
    xb, inv_q, n_fine = _column_bounds(geom, PF.device)
    name = _library(wrapper)
    lib = _build.load(name)
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * (4 + naxes)
                   + [ctypes.c_float] * (2 * naxes) + [t for t, _ in extra]
                   + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int]
                   + [ctypes.c_int] * len(sa)
                   + [ctypes.c_void_p] * (len(tail) + 1))
    code = fn(PF.data_ptr(), PI.data_ptr(), outf.data_ptr(), outi.data_ptr(),
              PF.shape[0], PI.shape[0], geom.cap,
              *(slab or geom).ncells[:naxes], xr,
              *_bin_constants(geom, naxes), *(v for _, v in extra),
              None if xb is None else xb.data_ptr(), inv_q, n_fine, *sa,
              *tail,
              _build.current_stream(PF.device))
    _build.check(lib, code, name)
    wrapper.launches += 1
    return outf, outi


def rebin_move_2d(PF: torch.Tensor, PI: torch.Tensor, geom: Geometry,
                  xr: int, slab: SlabGeometry = None):
    """K5 on packed matrices (of the ghosted ``slab`` when given): the CUDA
    kernel on a CUDA tensor, the plain walk on a CPU tensor.  Returns
    (outF, outI), [rows, cap, the grid's or the slab's cells]."""
    if not PF.is_cuda:
        return rebin_move_plain(PF, PI, geom, xr, slab)
    return _launch(rebin_move_2d, PF, PI, geom, xr, 2, _wrap_2d(geom),
                   slab=slab)


rebin_move_2d.launches = 0  # K5 launches in this process


def rebin_move_2d_gated(PF: torch.Tensor, PI: torch.Tensor, geom: Geometry,
                        xr: int, slab: SlabGeometry = None):
    """K6 on packed matrices (of the ghosted ``slab`` when given): the CUDA
    kernel on a CUDA tensor (K5's, from K5's library: ``_library``; this
    wrapper counts its own launches), the plain walk on a CPU tensor.
    Returns (outF, outI) as ``rebin_move_2d``."""
    if not PF.is_cuda:
        return rebin_move_plain(PF, PI, geom, xr, slab)
    return _launch(rebin_move_2d_gated, PF, PI, geom, xr, 2, _wrap_2d(geom),
                   slab=slab)


rebin_move_2d_gated.launches = 0  # K6 launches in this process


def rebin_move_3d(PF: torch.Tensor, PI: torch.Tensor, geom: Geometry,
                  xr: int, slab: SlabGeometry = None):
    """K7 on packed matrices (of the ghosted ``slab`` when given): the CUDA
    kernel on a CUDA tensor, the plain walk on a CPU tensor; its slot lists
    where ``k7_list`` puts them.  Returns (outF, outI) as
    ``rebin_move_2d``."""
    if not PF.is_cuda:
        return rebin_move_plain(PF, PI, geom, xr, slab)
    return _launch(rebin_move_3d, PF, PI, geom, xr, 3,
                   ((ctypes.c_int, wrap_bits(geom)),
                    (ctypes.c_float, _x_span(geom))),
                   lists=k7_list(geom.cap), slab=slab)


rebin_move_3d.launches = 0  # K7 launches in this process


def move(fields: Dict[str, torch.Tensor], geom: Geometry,
         mesh=None) -> Dict[str, torch.Tensor]:
    """Move every particle leaf to its new cell slot; returns the new dict.

    ``fields`` must already be position-wrapped and hold ``x`` and
    ``valid``.  Particles landing in a full cell (rank >= cap) or outside
    the one-cell ring come back invalid; the caller counts them.  Under
    ``mesh`` (``parallel/mesh.Mesh``) ``fields`` are this rank's slab:
    its packs get their halo planes, and the particles bound for a
    neighbour's slab leave it (the neighbour takes them).
    """
    cap = geom.cap
    NC = fields["valid"].shape[-1]
    PF, PI, fmeta, imeta = _pack_fields(fields, cap, NC)
    slab = None
    if mesh is not None:
        from sph_bvf_tpu_torch.parallel.mesh import plane_cells, slab_of

        slab = slab_of(geom, mesh)
        PF, PI = ghost_slabs([PF, PI], plane_cells(geom), mesh, wrap_x(geom))
    kernel = move_route(geom)
    with span("rebin.move", PF):
        outf, outi = (kernel(PF, PI, geom, _x_row(fmeta)) if slab is None
                      else kernel(PF, PI, geom, _x_row(fmeta), slab))
    return _unpack_fields(outf, outi, fmeta, imeta, fields, cap, NC)
