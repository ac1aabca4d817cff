"""A numpy emulation of the rebin moves' warp walk (``csrc/rebin_move.cuh``
``rank_matches`` and ``move_cells``), which K7 runs on 3D grids and K5 and
K6 on a plane, for the CPU tests: no JAX, no card.

On a plane it follows the plane's own formulation: t / ns as a
multiply-high, the candidates binned as the kernel bins them in f32 (the
modulo skipped for a bin already in range, ``fmodf`` skipped for an x
already inside the edges' span) and the row stop from each lane's own slot
row (``plane_row_stop``); in 3D, K7's loop over the step's slot rows
(``loop_row_stop``) and ``cell_index_of``'s binning."""

import numpy as np
import torch

from sph_bvf_tpu_torch.core import rebin_cuda
from sph_bvf_tpu_torch.core import state as TS
from sph_bvf_tpu_torch.core.halo import grid_3d, wrap_axes

INT_MAX = 2**31 - 1
FULL = (1 << 32) - 1
LANES = np.arange(32)


def _window(c, geom, wrap, plane, slab=None):
    """Lane o's source cell of target cell ``c`` of the packs' grid (the
    ghosted ``slab`` when given): its global flat index (INT_MAX off the
    global grid) and its index in the packs; offset (o // 9 - 1, o // 3 %
    3 - 1, o % 3 - 1) for o < 27 in 3D, on a plane (o // 3 - 1, o % 3 - 1,
    0) for o < 9."""
    grid = slab or geom
    nx, ny, nz = grid.ncells
    gnx = geom.ncells[0]
    x0 = slab.x0 - 1 if slab is not None else 0
    local_wrap = wrap_axes(grid)
    cx, cy, cz = c // (ny * nz), (c // nz) % ny, c % nz
    v = np.full(32, INT_MAX, np.int64)
    a = np.zeros(32, np.int64)
    for o in range(9 if plane else 27):
        if plane:
            s = [cx + o // 3 - 1, cy + o % 3 - 1, cz]
        else:
            s = [cx + o // 9 - 1, cy + (o // 3) % 3 - 1, cz + o % 3 - 1]
        g = s[0] + x0
        on = True
        for ax, n in enumerate((nx, ny, nz)):
            if local_wrap[ax]:
                s[ax] %= n
            else:
                on = on and 0 <= s[ax] < n
        if wrap[0]:
            g %= gnx
        else:
            on = on and 0 <= g < gnx
        if on:
            v[o] = (g * ny + s[1]) * nz + s[2]
            a[o] = (s[0] * ny + s[1]) * nz + s[2]
    return v, a


def slot_of(t, ns):
    """The plane's t / ns: t times 2^32 / ns rounded up, the high word (a
    u32 multiply-high), or t itself for ns == 1."""
    if ns == 1:
        return np.asarray(t, np.int64)
    inv = (FULL // ns + 1) & FULL
    return (np.asarray(t, np.uint64) * np.uint64(inv)) >> np.uint64(32)


def loop_row_stop(any_valid, base, ns, cap, carried):
    """K7's row stop of the step from candidate ``base``: (end, carried).
    It walks the step's slot rows in order; the first row that ends in this
    step with no valid slot (``any_valid``, the step's ballot; a row begun
    in the step before counts ``carried``) ends the walk at its last lane
    + 1; a row that goes on in the next step carries whether it held one."""
    end = 32
    row = base // ns
    while row * ns < base + 32 and row < cap:
        lo, hi = max(row * ns - base, 0), min((row + 1) * ns - base, 32)
        in_row = ((1 << hi) - 1) & ~((1 << lo) - 1)
        occupied = bool(any_valid & in_row) or (row * ns < base and carried)
        if (row + 1) * ns > base + 32:
            return end, occupied
        carried = False
        if not occupied:
            return hi, carried
        row += 1
    return end, carried


def plane_row_stop(any_valid, col, live, ns, carried):
    """The plane's row stop of one step, lane by lane: lane l's slot row
    spans lanes [first, past) = [l - col, l - col + ns) (first < 0: the row
    began in the step before, whose ``carried`` says whether it held a
    valid slot; past > 32: it goes on in the next step); ``empty`` is the
    ballot of the live lanes whose row ends in this step with no valid
    slot, ``end`` the ``past`` of its lowest lane, and the next ``carried``
    lane 31's (its row goes on and holds a valid slot).  (end, carried)."""
    first = LANES - col
    past = first + ns
    occupied = np.zeros(32, bool)
    for lane in LANES:
        p, f = int(past[lane]), int(first[lane])
        in_row = (FULL if p >= 32 else (1 << p) - 1) & ~((1 << max(f, 0)) - 1)
        occupied[lane] = bool(any_valid & in_row) or (f < 0 and carried)
    empty = live & (past <= 32) & ~occupied
    end = int(past[np.flatnonzero(empty)[0]]) if empty.any() else 32
    return end, bool(occupied[31] and past[31] > 32)


def _f32(a):
    return np.asarray(a, np.float32)


def _kernel_bin(x, lo, inv, n, periodic):
    """``rebin::bin<true>``: floor((x - lo) * inv), each operation rounded
    to f32; on a periodic axis C's ((b % n) + n) % n, skipped for a b
    already in [0, n); else clamped."""
    b = np.floor(_f32(_f32(x - np.float32(lo)) * np.float32(inv))).astype(
        np.int64)
    if periodic:
        return np.where((b >= 0) & (b < n), b,
                        np.fmod(np.fmod(b, n) + n, n))
    return np.clip(b, 0, n - 1)


def plane_cells(PF, geom, xr):
    """The cell each slot's position lies in as the plane's walk bins it
    (``bin<true>`` on y, ``in_column<true>`` on x: with edges, x wrapped by
    the edges' span only where x - lo0 lies outside [0, span), then its
    fine bin against each column's bounds), from the constants the wrapper
    hands the kernel."""
    nx, ny, _ = geom.ncells
    lo0, lo1, inv0, inv1 = rebin_cuda._bin_constants(geom, 2)
    wx, wy = wrap_axes(geom)[:2]
    x = PF[xr].reshape(-1).numpy()
    y = PF[xr + 1].reshape(-1).numpy()
    cy = _kernel_bin(y, lo1, inv1, ny, wy) if ny > 1 else np.zeros_like(x, np.int64)
    xb, inv_q, n_fine = rebin_cuda._column_bounds(geom, "cpu")
    if nx == 1:
        cx = np.zeros_like(cy)
    elif xb is None:
        cx = _kernel_bin(x, lo0, inv0, nx, wx)
    else:
        if wx:
            span = np.float32(rebin_cuda._x_span(geom))
            r = _f32(x - np.float32(lo0))
            away = ~((r >= 0) & (r < span))
            m = np.fmod(r, span)
            m = np.where((m != 0) & ((m < 0) != (span < 0)), _f32(m + span), m)
            x = _f32(np.where(away, m, r) + np.float32(lo0))
        f = _kernel_bin(x, lo0, inv_q, n_fine, False)
        cx = np.searchsorted(xb.numpy(), f, side="right") - 1
    return cx * ny + cy


def warp_walk(PF, PI, geom, xr, slab=None):
    """The move as its warps and blocks run it: per target cell, the window's
    lanes (0-26 in 3D; 0-8 on a 2D grid, one z plane) take the source cells
    (INT_MAX off the grid), rank them by global flat index (ties by lane)
    and write their indices in the packs into ``srcs`` (on a plane only the
    window's lanes rank and write); the warp takes 32
    candidates a step (candidate t = slot t / ns of source cell srcs[t %
    ns]), finds the first slot row the step ends with no valid slot (a
    row's earlier part carried from the step before), ranks the matches
    before it by the popcount of the lower lanes' ballot, keeps ranks below
    cap; then each output slot copies its source's rows, zeros past the
    match count.  With ``slab`` (``halo.SlabGeometry``) the packs hold the
    ghosted slab, the targets are the slab's cells and the outputs theirs,
    as the kernels' slab arguments make them (``rebin_cuda._slab_args``)."""
    F, cap, NC = PF.shape
    plane = not grid_3d(geom)
    wrap = wrap_axes(geom)
    _, _, _, t0, nt = rebin_cuda._slab_args(geom, slab)
    # a cell of the packs' grid plus this is its global flat index
    to_global = 0 if slab is None else (slab.x0 - 1) * geom.strides[0]
    valid = (PI[0].reshape(-1) != 0).numpy()
    newcell = (plane_cells(PF, geom, xr) if plane else TS.cell_index_of(
        PF[xr:xr + 3].reshape(3, -1), geom).numpy())
    window = 9 if plane else 32
    lower = [(1 << lane) - 1 for lane in LANES]
    src = np.full((cap, nt), -1, np.int64)
    for c in range(t0, t0 + nt):
        v, a = _window(c, geom, wrap, plane, slab)
        rank = ((v[None, :window] < v[:, None])
                | ((v[None, :window] == v[:, None])
                   & (LANES[None, :window] < LANES[:, None]))).sum(1)
        srcs = np.full(32, -1, np.int64)
        srcs[rank[:window]] = a[:window]
        ns = int((v != INT_MAX).sum())
        total, n, carried = cap * ns, 0, False
        for base in range(0, total, 32):
            t = base + LANES
            live = t < total
            s = slot_of(t, ns).astype(np.int64) if plane else t // ns
            q = t - s * ns
            k = np.where(live, s * NC + srcs[np.minimum(q, 31)], 0)
            ok = live & valid[k]
            match = ok & (newcell[k] == c + to_global)
            any_valid = sum(1 << int(lane) for lane in LANES[ok])
            if plane:
                end, carried = plane_row_stop(any_valid, q, live, ns, carried)
            else:
                end, carried = loop_row_stop(any_valid, base, ns, cap, carried)
            kept = match & (LANES < end)
            matches = sum(1 << int(lane) for lane in LANES[kept])
            for lane in LANES[kept]:
                r = n + bin(matches & lower[lane]).count("1")
                if r < cap:
                    src[r, c - t0] = k[lane]
            n += int(kept.sum())
            if end < 32:
                break
    got = src >= 0
    take = np.clip(src, 0, None).reshape(-1)
    g = torch.as_tensor(got.reshape(-1))
    outf = torch.where(g, PF.reshape(F, -1)[:, take], torch.zeros((), dtype=PF.dtype))
    outi = torch.where(g, PI.reshape(PI.shape[0], -1)[:, take],
                       torch.zeros((), dtype=PI.dtype))
    return outf.reshape(F, cap, nt), outi.reshape(PI.shape[0], cap, nt)
