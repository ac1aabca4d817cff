"""K5: the 2D locality rebin move (``csrc/rebin_move_2d.cu``) and its wrapper.

Port of ``sph_bvf_tpu/core/rebin_pallas.py`` for the static (cap <= 16)
2D branch.  Between rebins a particle moves at most one cell (the drift
contract ``core/state.rebin`` checks), so the particles that belong in cell
c are the matching candidates among the slots of its 3x3 stencil cells.
Walking them slot-major, then by ascending flat offset, visits them in the
sort rebin's stable (cell, old flat slot) order, so on a grid without
periodic multi-cell axes the slot assignment is bit-identical to the sort.

``move`` packs the per-particle fields into one f32 and one i32 matrix,
launches the kernel on a CUDA tensor or runs ``rebin_move_2d_plain`` (the
same ordered walk in vectorized PyTorch) on a CPU tensor, and unpacks.  A
CUDA call the kernel cannot serve raises; it never falls back.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from sph_bvf_tpu_torch import _build
from sph_bvf_tpu_torch.core.halo import periodic_multicell
from sph_bvf_tpu_torch.core.state import Geometry, cell_index_of

MAX_CAP = 16  # kMaxCap in csrc/rebin_move_2d.cu


def move_supported(geom: Geometry) -> bool:
    """Grids the locality walk serves: 2D, cap <= 16, uniform columns and
    no periodic axis with more than one cell (the walk bounds-checks its
    neighbours instead of wrapping them)."""
    return (
        geom.dim == 2
        and geom.ncells[2] == 1
        and geom.cap <= MAX_CAP
        and geom.x_edges is None
        and not periodic_multicell(geom)
    )


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


def _walk_offsets(geom: Geometry):
    """The stencil offsets in ascending flat-offset order (the candidate
    order inside one source slot)."""
    sx, sy, sz = geom.strides
    return sorted(geom.stencil_offsets(),
                  key=lambda o: o[0] * sx + o[1] * sy + o[2] * sz)


def rebin_move_2d_plain(PF: torch.Tensor, PI: torch.Tensor, geom: Geometry,
                        xr: int):
    """The K5 walk in vectorized PyTorch: the kernel's plain version.

    For every target cell the candidates are taken slot-major, then by
    ascending flat offset; a candidate matches when it is valid, its
    stencil cell lies on the grid and ``cell_index_of`` of its position is
    the target.  The first ``cap`` matches fill output slots 0.. in order.
    """
    _, cap, NC = PF.shape
    nx, ny, _ = geom.ncells
    dev = PF.device
    c = torch.arange(NC, dtype=torch.int64, device=dev)
    cx, cy = c // ny, c % ny
    offs = _walk_offsets(geom)
    # source cell and on-grid mask per (offset, target cell): [9, NC]
    src_cell = torch.stack([(cx + ox) * ny + (cy + oy) for ox, oy, _ in offs])
    on_grid = torch.stack([
        (cx + ox >= 0) & (cx + ox < nx) & (cy + oy >= 0) & (cy + oy < ny)
        for ox, oy, _ in offs
    ])
    src_cell = torch.where(on_grid, src_cell, 0)
    # flat source slot of every candidate, slot-major: [cap, 9, NC]
    slots = torch.arange(cap, dtype=torch.int64, device=dev)[:, None, None]
    k = (slots * NC + src_cell[None]).reshape(cap * len(offs), NC)
    valid = PI[0].reshape(-1) != 0
    newcell = cell_index_of(PF[xr: xr + 3].reshape(3, -1), geom).to(torch.int64)
    match = (on_grid.repeat(cap, 1) & valid[k] & (newcell[k] == c[None]))
    rank = torch.cumsum(match.to(torch.int64), dim=0) - 1
    keep = match & (rank < cap)
    # output slot (rank, c) takes candidate k; one spare slot for the rest
    M = cap * NC
    dest = torch.where(keep, rank * NC + c[None], M)
    src = torch.full((M + 1,), -1, dtype=torch.int64, device=dev)
    src.scatter_(0, dest.reshape(-1), k.reshape(-1))
    src = src[:M]
    got = src >= 0
    src = torch.clamp(src, min=0)
    outf = torch.where(got, PF.reshape(PF.shape[0], M)[:, src],
                       torch.zeros((), dtype=PF.dtype, device=dev))
    outi = torch.where(got, PI.reshape(PI.shape[0], M)[:, src],
                       torch.zeros((), dtype=PI.dtype, device=dev))
    return outf.reshape(PF.shape), outi.reshape(PI.shape)


def rebin_move_2d(PF: torch.Tensor, PI: torch.Tensor, geom: Geometry,
                  xr: int):
    """K5 on packed matrices: the CUDA kernel on a CUDA tensor, the plain
    walk on a CPU tensor.  Returns (outF, outI) of the input shapes."""
    if not PF.is_cuda:
        return rebin_move_2d_plain(PF, PI, geom, xr)
    if not move_supported(geom):
        raise NotImplementedError(
            f"rebin move kernel for this grid (dim={geom.dim}, cap={geom.cap}, "
            f"periodic={geom.periodic}, x_edges={geom.x_edges is not None}) "
            "is ported in a later PR")
    if PF.dtype != torch.float32 or PI.dtype != torch.int32:
        raise TypeError(f"rebin move kernel takes f32/i32 packs, got "
                        f"{PF.dtype}/{PI.dtype}")
    ff, cap, NC = PF.shape
    fi = PI.shape[0]
    if (cap, NC) != (geom.cap, geom.ncells_total) or PI.shape[1:] != PF.shape[1:]:
        raise ValueError(f"packs {tuple(PF.shape)}/{tuple(PI.shape)} do not "
                         f"match the geometry [{geom.cap}, {geom.ncells_total}]")
    if not (PF.is_contiguous() and PI.is_contiguous()) or PI.device != PF.device:
        raise ValueError("rebin move kernel packs must be contiguous on one device")
    outf = torch.empty_like(PF)
    outi = torch.empty_like(PI)

    lib = _build.load("rebin_move_2d")
    fn = lib.rebin_move_2d
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_float] * 4 + [ctypes.c_void_p])
    # f32 lo and 1/cell_size, exactly the constants cell_index_of rounds to
    lo = [float(np.float32(v)) for v in geom.lo[:2]]
    inv = [float(np.float32(1.0 / cs)) for cs in geom.cell_size[:2]]
    with torch.cuda.device(PF.device):
        stream = torch.cuda.current_stream().cuda_stream
    code = fn(PF.data_ptr(), PI.data_ptr(), outf.data_ptr(), outi.data_ptr(),
              ff, fi, cap, geom.ncells[0], geom.ncells[1], xr,
              lo[0], lo[1], inv[0], inv[1], stream)
    _build.check(lib, code, "rebin_move_2d")
    rebin_move_2d.launches += 1
    return outf, outi


rebin_move_2d.launches = 0  # kernel launches in this process


def move(fields: Dict[str, torch.Tensor], geom: Geometry) -> Dict[str, torch.Tensor]:
    """Move every particle leaf to its new cell slot; returns the new dict.

    ``fields`` must already be position-wrapped and hold ``x`` and
    ``valid``.  Particles landing in a full cell (rank >= cap) or outside
    the one-cell ring come back invalid; the caller counts them.
    """
    NC, cap = geom.ncells_total, geom.cap
    PF, PI, fmeta, imeta = _pack_fields(fields, cap, NC)
    outf, outi = rebin_move_2d(PF, PI, geom, _x_row(fmeta))
    return _unpack_fields(outf, outi, fmeta, imeta, fields, cap, NC)
