"""Non-uniform x columns and seeded drifts for the port's tests, without
load balancing.

``with_synthetic_edges`` is ``tests/test_halo_kernels.py``'s construction:
x columns of alternating widths 7 and 9 on the cell/8 quantum.
``seeded_drift`` moves a state's particles as far as a rebin period may,
with some of them exactly on a column edge; ``corner_drift`` does so on a
doubly periodic grid, across every face and corner, ``seam_drift`` on a 3D
grid across the x and z seams; ``seam_hairs`` puts particles a hair below
and at the ends of a doubly periodic box.  Torch and numpy only (the
kernel tests import this on a machine without JAX).
"""

import dataclasses

import numpy as np
import torch

from sph_bvf_tpu_torch.core import state as TS


def with_synthetic_edges(geom, pattern=(7, 9)):
    """``geom`` with x columns of alternating widths 7 and 9 on the cell/8
    quantum."""
    nx = geom.ncells[0]
    q = geom.cell_size[0] / 8.0
    widths = [pattern[i % len(pattern)] for i in range(nx)]
    if nx % len(pattern):  # keep total coverage exact
        widths[-1] = 8 * nx - sum(widths[:-1])
    bins = np.concatenate([[0], np.cumsum(widths)])
    return dataclasses.replace(
        geom, x_edges=tuple(float(geom.lo[0] + b * q) for b in bins),
        x_quantum=float(q), base_occ=0,
        cell_size=(float(min(widths) * q),) + tuple(geom.cell_size[1:]))


def seeded_drift(state, geom, seed=11):
    """``state`` (binned in ``geom``) with every valid particle moved by a
    seeded step of up to 0.9 of the narrowest cell per axis (within one
    ring), a seeded tenth snapped onto an edge of its x column."""
    rng = np.random.default_rng(seed)
    x = state.x.cpu().numpy()
    valid = state.valid.cpu().numpy()
    d = rng.uniform(-0.9, 0.9, x.shape) * np.asarray(geom.cell_size)[:, None, None]
    d[geom.dim:] = 0.0
    x = x + np.where(valid, d, 0.0)
    col = (TS.cell_index_of(state.x, geom).cpu().numpy()
           // int(np.prod(geom.ncells[1:])))
    snap = valid & (rng.uniform(size=valid.shape) < 0.1)
    side = rng.integers(0, 2, valid.shape)
    x[0] = np.where(snap, np.asarray(geom.x_edges)[col + side], x[0])
    x = torch.as_tensor(x.astype(np.float32), device=state.x.device)
    return dataclasses.replace(state, x=x)


def corner_drift(x, valid, geom, seed=4):
    """Positions ``x`` [3, cap, NC] (numpy, binned in ``geom``) with every
    valid particle moved by a seeded step of up to 0.9 cells per axis
    (one-ring moves), outward along both axes in the four corner cells, as
    f32: on a doubly periodic box particles cross every face and corner and
    stay unwrapped, as between two rebins (asserted)."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(-0.9, 0.9, x.shape) * np.asarray(geom.cell_size)[:, None, None]
    nx, ny = geom.ncells[:2]
    c = np.broadcast_to(np.arange(geom.ncells_total), valid.shape)
    cx, cy = c // ny, c % ny
    corner = ((cx == 0) | (cx == nx - 1)) & ((cy == 0) | (cy == ny - 1))
    d[0] = np.where(corner, np.where(cx == 0, -1.0, 1.0) * np.abs(d[0]), d[0])
    d[1] = np.where(corner, np.where(cy == 0, -1.0, 1.0) * np.abs(d[1]), d[1])
    d[2] = 0.0
    x = (x + np.where(valid, d, 0.0)).astype(np.float32)
    for out_x in (x[0] < geom.lo[0], x[0] >= geom.hi[0]):
        for out_y in (x[1] < geom.lo[1], x[1] >= geom.hi[1]):
            assert int((valid & out_x).sum()) > 3 and int((valid & out_y).sum()) > 3
            assert int((valid & out_x & out_y).sum()) > 0
    return x


def any_corner_drift(x, valid, geom, first_seed=4):
    """``corner_drift`` with the first seed from ``first_seed`` whose drift
    crosses every face and corner of the box."""
    for seed in range(first_seed, first_seed + 64):
        try:
            return corner_drift(x, valid, geom, seed=seed)
        except AssertionError:
            continue
    raise AssertionError("no seeded drift crosses every face and corner")


def seam_hairs(x, valid, geom, seed=9):
    """Positions ``x`` (numpy, binned in the 2D ``geom``) with a seeded
    share of the particles of the first and last cell along x and along y
    put a hair below the box's low end, at its high end or a hair below it,
    in f32: the positions whose wrap and bin the seam decides.  (Not a
    subnormal: the JAX package's wrap flushes those to zero on the CPU.)"""
    rng = np.random.default_rng(seed)
    c = np.broadcast_to(np.arange(geom.ncells_total), valid.shape)
    x = x.astype(np.float32)
    for ax, ci in ((0, c // geom.ncells[1]), (1, c % geom.ncells[1])):
        L = np.float32(geom.hi[ax])
        hairs = np.array([-1e-7, -1e-30, np.nextafter(L, np.float32(0)), L,
                          L + np.float32(1e-6)], np.float32)
        edge = (ci == 0) | (ci == geom.ncells[ax] - 1)
        sel = valid & edge & (rng.uniform(size=valid.shape) < 0.3)
        x[ax] = np.where(sel, hairs[rng.integers(0, len(hairs), valid.shape)],
                         x[ax])
    return x


def seam_drift(x, valid, geom, seed=3):
    """Positions ``x`` [3, cap, NC] (numpy, binned in ``geom``) with every
    valid particle moved by a seeded step of up to 0.9 of the narrowest
    cell per axis, outward along z in the first and last z layer (on a 2D
    grid, one z cell, not along z), and a seeded half of the first and
    last x column's particles put past the x seam by up to 0.9 of the
    narrowest column (into the column across it: a wide end column's
    particles may sit far from its edge), as f32: on a grid periodic in x
    (and in 3D z) particles cross the seams and stay unwrapped, as between
    two rebins (asserted)."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(-0.9, 0.9, x.shape) * np.asarray(geom.cell_size)[:, None, None]
    nx, ny, nz = geom.ncells
    c = np.broadcast_to(np.arange(geom.ncells_total), valid.shape)
    cx, cz = c // (ny * nz), c % nz
    plane = nz == 1
    d[2] = 0.0 if plane else np.where(
        cz == 0, -np.abs(d[2]), np.where(cz == nz - 1, np.abs(d[2]), d[2]))
    x = (x + np.where(valid, d, 0.0)).astype(np.float32)
    past = np.abs(d[0]) * (rng.uniform(size=valid.shape) < 0.5)
    x[0] = np.where(cx == 0, np.where(past > 0, geom.lo[0] - past, x[0]),
                    np.where((cx == nx - 1) & (past > 0), geom.hi[0] + past,
                             x[0])).astype(np.float32)
    for ax in (0,) if plane else (0, 2):
        assert int((valid & (x[ax] < geom.lo[ax])).sum()) > 0
        assert int((valid & (x[ax] >= geom.hi[ax])).sum()) > 0
    return x
