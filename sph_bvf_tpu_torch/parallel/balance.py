"""Load balance: slab imbalance, the build-time cut and the in-run re-cut
(PyTorch).

Port of ``sph_bvf_tpu/parallel/balance.py`` (the balance.cpp /
fix_balance.cpp analog; the reasoning behind each rule is there).  The
lever is non-uniform x columns (``Geometry.x_edges``): every slab of
``nx / n_shards`` columns keeps its cell count, and the column widths move
so each slab holds a near-equal particle share, every width staying above
the kernel cutoff.

The particle counts run on the state's device; the edge search is host
numpy, as in the JAX package.  A re-cut changes only the geometry: the
state's shapes stay, and in eager PyTorch nothing is recompiled, so an
accepted re-cut costs one host readback of the positions, this module's
host cut and one sort rebin (``stepper.simulate``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sph_bvf_tpu_torch.parallel.mesh import gather_state


def slab_counts(valid: torch.Tensor, geom, n_shards: int) -> torch.Tensor:
    """Per-slab particle counts for equal-column-count x-slabs of the grid.

    ``valid``: [cap, NC] occupancy mask.  Requires ncells[0] divisible by
    ``n_shards``."""
    nx = geom.ncells[0]
    if nx % n_shards:
        raise ValueError(f"nx={nx} not divisible by {n_shards} shards")
    per_cell = torch.sum(valid.to(torch.int32), dim=0)  # [NC]
    per_col = per_cell.reshape(nx, -1).sum(dim=1)  # [nx]
    return per_col.reshape(n_shards, nx // n_shards).sum(dim=1)


def imbalance(counts) -> float:
    """LAMMPS's imbalance factor: max over mean (balance.cpp), in f32."""
    counts = torch.as_tensor(counts).to(torch.float32)
    return float(torch.max(counts) / torch.clamp(torch.mean(counts), min=1.0))


def balanced_x_edges(
    x0: np.ndarray,
    lo: float,
    quantum: float,
    n_fine: int,
    nx: int,
    k_min: int,
) -> list:
    """Equal-count x-column edges on the fine-quantum grid, in fine-bin
    units: ``nx + 1`` ints from 0 to ``n_fine``.

    Greedy sweep: each column takes fine bins until it holds its fair share
    of the remaining particles, keeping at least ``k_min`` bins (the
    stencil-coverage minimum, ``k_min * quantum > cutoff``) and leaving
    enough bins for the columns after it."""
    if n_fine < nx * k_min:
        raise ValueError(
            f"cannot balance: {n_fine} fine bins < {nx} columns x {k_min}"
        )
    f = np.clip(((x0 - lo) / quantum).astype(np.int64), 0, n_fine - 1)
    cum = np.concatenate(
        [[0], np.cumsum(np.bincount(f, minlength=n_fine))]
    )  # cum[b] = particles strictly below fine-bin b
    edges = [0]
    for c in range(nx):
        cols_left = nx - c - 1
        if cols_left == 0:
            edges.append(n_fine)
            break
        target = cum[edges[-1]] + (cum[-1] - cum[edges[-1]]) / (nx - c)
        end = int(np.searchsorted(cum, target, side="left"))
        end = max(end, edges[-1] + k_min)
        end = min(end, n_fine - cols_left * k_min)
        edges.append(end)
    assert edges[-1] == n_fine
    assert all(b - a >= k_min for a, b in zip(edges, edges[1:]))
    return edges


@dataclasses.dataclass(frozen=True)
class BalanceFix:
    """In-run load rebalancing, the ``fix balance`` analog (shift style).

    Attach with ``ModelSpec(balance=BalanceFix(...))`` or
    ``Scene.fix_balance``.  ``stepper.simulate`` checks every ``every``
    steps, at a chunk boundary, and re-cuts ``Geometry.x_edges`` from the
    current positions when the slab imbalance exceeds ``threshold`` or the
    fullest cell holds ``occ_frac * cap`` particles (0 disables that
    trigger), provided the new edges improve the firing metric by
    ``min_gain``.  ``min_budget``: the least drift budget a re-cut may
    leave (at least ``max|v| * dt * rebin_every`` for the run)."""

    n_shards: int
    every: int = 1000
    threshold: float = 1.5
    min_gain: float = 1.2
    min_budget: float = 0.0
    occ_frac: float = 0.85


def rebalance(state, geom, fix: BalanceFix, mesh=None):
    """Propose re-cut x_edges for the current particle distribution.

    Returns ``(new_geom | None, info)`` exactly as the JAX package does:
    None when neither trigger fires, when the geometry cannot be re-cut
    (unknown cutoff, nx not divisible) or when the best new edge set does
    not improve the firing metric by ``fix.min_gain``.  The caller rebins
    into ``new_geom`` with ``rebin(..., use_kernel=False,
    drift_check=False)`` and keeps the old geometry if that overflows.

    ``mesh`` (``parallel/mesh.Mesh``): ``state`` is this rank's slab; the
    counts and positions are read from every rank's (``mesh.gather_state``,
    one collective), so every rank proposes the same cut."""
    if mesh is not None:
        state = gather_state(state, mesh, ("valid", "x"))
    ns = fix.n_shards
    f = imbalance(slab_counts(state.valid, geom, ns))
    occ_now = int(torch.max(torch.sum(state.valid.to(torch.int32), dim=0)))
    occ_fire = fix.occ_frac > 0 and occ_now >= fix.occ_frac * geom.cap
    info = dict(imbalance=round(f, 3), max_occ=occ_now)
    if f <= fix.threshold and not occ_fire:
        return None, info
    nx = geom.ncells[0]
    if geom.cutoff <= 0.0:
        info["reason"] = "geometry records no cutoff (pre-round-5 build)"
        return None, info
    if nx % ns:
        info["reason"] = f"nx={nx} not divisible by {ns} shards"
        return None, info
    q = geom.x_quantum if geom.x_quantum > 0 else geom.cell_size[0] / 8.0
    cov = (
        geom.x_edges[-1] - geom.lo[0]
        if geom.x_edges is not None
        else nx * geom.cell_size[0]
    )
    n_fine = int(round(cov / q))
    # minimum column width: strictly above cutoff + twice the requested
    # drift budget
    wmin = geom.cutoff + 2.0 * fix.min_budget
    k_min = max(int(np.ceil(wmin / q)), 1)
    while k_min * q - wmin < 1e-6 * q:
        k_min += 1
    if n_fine < nx * k_min:
        info["reason"] = (
            f"{n_fine} fine bins < {nx} columns x k_min={k_min}"
        )
        return None, info
    # the one host readback of a re-cut
    v = state.valid.cpu().numpy()
    xv = state.x.cpu().numpy()[:, v]
    if geom.periodic[0]:
        x0 = geom.lo[0] + np.mod(xv[0] - geom.lo[0], cov)
    else:
        x0 = xv[0]
    edges_f = balanced_x_edges(x0, geom.lo[0], q, n_fine, nx, k_min)
    e = np.asarray([geom.lo[0] + b * q for b in edges_f])
    col = np.clip(np.searchsorted(e, x0, side="right") - 1, 0, nx - 1)
    s = np.bincount(col // (nx // ns), minlength=ns)
    fb = float(s.max() / max(s.mean(), 1.0))
    info["new_imbalance"] = round(fb, 3)
    # projected max cell occupancy under the new edges: the occupancy
    # trigger's accept metric, and a hard feasibility bound either way
    inner = np.zeros_like(col)
    scale = 1
    for ax in range(1, geom.dim):
        c = np.floor(
            (xv[ax] - geom.lo[ax]) / geom.cell_size[ax]
        ).astype(np.int64)
        if geom.periodic[ax]:
            c = np.mod(c, geom.ncells[ax])
        else:
            c = np.clip(c, 0, geom.ncells[ax] - 1)
        inner = inner * geom.ncells[ax] + c
        scale *= geom.ncells[ax]
    occ_new = int(np.bincount(col * scale + inner).max())
    info["new_max_occ"] = occ_new
    if occ_new > geom.cap:
        info["reason"] = f"new binning would overflow cap ({occ_new})"
        return None, info
    improves = fb * fix.min_gain < f or (
        occ_fire and occ_new * fix.min_gain < occ_now
    )
    if not improves:
        info["reason"] = "no improving edge set under the width constraint"
        return None, info
    widths = np.diff(e)
    budget = min(
        [(float(widths.min()) - geom.cutoff) / 2.0]
        + [
            (geom.cell_size[ax] - geom.cutoff) / 2.0
            for ax in range(1, geom.dim)
        ]
    )
    new_geom = dataclasses.replace(
        geom,
        x_edges=tuple(float(b) for b in e),
        x_quantum=q,
        cell_size=(float(widths.min()),) + tuple(geom.cell_size[1:]),
        drift_budget=max(float(budget), 0.0),
        # variable widths break the uniform-lattice occupancy behind K1's
        # i-row gate: pass A goes to K2
        base_occ=0,
    )
    return new_geom, info


def report(state, geom, n_shards: int, warn_factor: float = 2.0) -> dict:
    """Imbalance summary for a (prospective) n-shard run; warns past the
    threshold where cut-plane balancing would be worth building."""
    counts = slab_counts(state.valid, geom, n_shards)
    f = imbalance(counts)
    out = dict(
        n_shards=n_shards,
        counts=[int(c) for c in counts.cpu()],
        imbalance=round(f, 3),
    )
    if f > warn_factor:
        out["warning"] = (
            f"slab imbalance {f:.2f}x exceeds {warn_factor}x — equal-width "
            f"x-slabs will leave devices idle; rebuild the scene with "
            f"Scene.balance(n_shards) to get non-uniform column widths "
            f"(balanced_x_edges below)"
        )
    return out
