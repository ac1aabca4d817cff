"""Particle state, coefficient tables, and the cell-slot layout (PyTorch).

Port of ``sph_bvf_tpu/core/state.py``.  The layout is unchanged:
component-leading and cell-minor,

    scalar field  [cap, NC]          NC = ncx * ncy * ncz flat cells
    vector field  [3, cap, NC]
    tensor field  [3, 3, cap, NC]
    species field [Ns, cap, NC]

so a CUDA thread per (slot, cell) reads neighbouring cells at neighbouring
addresses.  ``State`` and ``Params`` are dataclasses of tensors with the
JAX package's field names and dtypes; ``Geometry`` is the same numpy-only
frozen dataclass.

The sort rebin below is the executable spec of the rebin move: on CUDA it
runs only for the initial binning at build and for the cross-geometry
rebin of an in-run re-cut (``stepper.simulate`` with ``spec.balance``);
every other rebin of a supported grid goes through the move kernel
(``core/rebin_cuda.py``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

# Group bit 0 is the "all" group, like LAMMPS group.cpp.
GROUP_ALL = 1


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Static simulation-box and cell-grid geometry (hashable)."""

    dim: int
    lo: Tuple[float, float, float]
    hi: Tuple[float, float, float]
    ncells: Tuple[int, int, int]  # cells per axis; 1 on unused axes
    cell_size: Tuple[float, float, float]
    cap: int
    periodic: Tuple[bool, bool, bool] = (False, False, False)
    # Half the slack between cell size and the kernel cutoff: a particle may
    # drift this far from its assigned cell between rebins before stencil
    # pair coverage can be violated (see rebin's drift check).  0 disables.
    drift_budget: float = 0.0
    # Initial per-cell particle count under lattice-aligned sizing (k^dim).
    base_occ: int = 0
    # Non-uniform x-column edges (load balancing, parallel/balance.py): the
    # ncells[0]+1 cell edges along x, each an integer multiple of x_quantum
    # above lo[0]; None means uniform columns of cell_size[0], which then
    # records the minimum width.
    x_edges: Tuple[float, ...] | None = None
    x_quantum: float = 0.0
    # The kernel cutoff the grid was sized for.
    cutoff: float = 0.0

    @property
    def ncells_total(self) -> int:
        return self.ncells[0] * self.ncells[1] * self.ncells[2]

    @property
    def nslots(self) -> int:
        return self.ncells_total * self.cap

    # Flat cell index is x-major, z-minor: c = (cx * ncy + cy) * ncz + cz.
    @property
    def strides(self) -> Tuple[int, int, int]:
        nx, ny, nz = self.ncells
        return (ny * nz, nz, 1)

    def stencil_offsets(self):
        """All 3^dim cell offsets (including self)."""
        rng = lambda ax: ((-1, 0, 1) if self.ncells[ax] > 1 else (0,))
        return [
            (dx, dy, dz)
            for dx in rng(0)
            for dy in rng(1)
            for dz in rng(2)
        ]

    @staticmethod
    def build(dim, lo, hi, cutoff, cap, periodic=(False, False, False), margin=0.0,
              multiple_of=(1, 1, 1), quantum=0.0):
        """Choose the cell grid for a box: cell_size >= cutoff + margin per axis.

        Identical to the JAX package's ``Geometry.build``: ``multiple_of``
        rounds the cell count per axis, ``quantum`` > 0 sizes non-periodic
        cells as an integer multiple of the lattice spacing (padding the grid
        past ``hi``) so every cell starts with exactly ``k^dim`` particles.
        """
        lo = tuple(float(v) for v in lo)
        hi = tuple(float(v) for v in hi)
        nc, cs, ks = [], [], []
        for ax in range(3):
            if ax >= dim:
                nc.append(1)
                cs.append(max(hi[ax] - lo[ax], 1.0))
                continue
            ext = hi[ax] - lo[ax]
            m = multiple_of[ax]
            if quantum > 0.0 and not periodic[ax]:
                k = max(int(round((cutoff + margin) / quantum)), 1)
                # the cell must exceed the cutoff strictly, or drift_budget
                # is 0.0 and the drift check is silently disabled
                while k * quantum - cutoff < 1e-6 * quantum:
                    k += 1
                cell = k * quantum
                n = max(int(np.ceil(ext / cell - 1e-9)), 1)
                if m > 1:
                    n = -(-n // m) * m  # round UP: extra cells are empty
                nc.append(n)
                cs.append(cell)
                ks.append(k)
                continue
            n = max(int(ext / (cutoff + margin)), 1)
            if m > 1:
                n = max((n // m) * m, m)
            nc.append(n)
            cs.append(ext / n)
        for ax in range(dim):
            if periodic[ax] and nc[ax] < 3:
                raise ValueError(
                    f"periodic axis {ax} has only {nc[ax]} cells: with fewer "
                    f"than 3, the +1/-1 stencil offsets alias the same "
                    f"neighbor (double-counting pairs) or miss images "
                    f"entirely — enlarge the box or shrink the cutoff"
                )
        budget = min(
            (cs[ax] - cutoff) / 2.0 for ax in range(dim)
        ) if cutoff > 0 else 0.0
        base_occ = int(np.prod(ks)) if len(ks) == dim else 0
        return Geometry(
            dim=dim,
            lo=lo,
            hi=hi,
            ncells=tuple(nc),
            cell_size=tuple(cs),
            cap=cap,
            periodic=tuple(periodic),
            drift_budget=max(budget, 0.0),
            base_occ=base_occ,
            cutoff=float(cutoff),
        )


@dataclasses.dataclass
class Params:
    """Per-type / per-type-pair coefficient tables (pair_coeff surface)."""

    mass: torch.Tensor  # [T]
    rho0: torch.Tensor  # [T]
    c0: torch.Tensor  # [T]
    B: torch.Tensor  # [T]   Tait B = c0^2 rho0 / 7
    G0: torch.Tensor  # [T]   shear modulus
    cut: torch.Tensor  # [T, T]  kernel support h
    cutc: torch.Tensor  # [T, T]  species-transport cutoff
    visc: torch.Tensor  # [T, T]  eta
    kappa: torch.Tensor  # [T, T, Ns]
    kappa_ssa: torch.Tensor  # [T, T, Nssa]
    boltz: float = 1.3806504e-23
    ftm2v: float = 1.0
    mvv2e: float = 1.0

    @property
    def ntypes(self) -> int:
        return self.mass.shape[0]

    @property
    def n_sdpd(self) -> int:
        return self.kappa.shape[-1]

    @property
    def n_ssa(self) -> int:
        return self.kappa_ssa.shape[-1]

    @property
    def max_cut(self) -> float:
        return float(torch.max(self.cut))


@dataclasses.dataclass
class State:
    """All per-particle state, component-leading cell-slot layout.

    Trailing two axes are always [cap, NC].  ``key`` holds the JAX
    package's PRNG key words ([2] int64) so a state round-trips through
    ``bridge.py``; nothing on the ported path draws random numbers.
    """

    # -- identity / tags ---------------------------------------------------
    tag: torch.Tensor  # i32 [cap, NC] global particle id (>=1); 0 for empty slots
    ptype: torch.Tensor  # i32 [cap, NC] 0-based particle type
    valid: torch.Tensor  # bool [cap, NC]
    groupmask: torch.Tensor  # i32 [cap, NC] group bitmask (bit 0 == "all")
    solid_tag: torch.Tensor  # i32 [cap, NC]
    fixed_tag: torch.Tensor  # i32 [cap, NC]
    # -- integrated fields --------------------------------------------------
    x: torch.Tensor  # f [3, cap, NC]
    v: torch.Tensor  # f [3, cap, NC] transport velocity
    vest: torch.Tensor  # f [3, cap, NC] momentum velocity
    rho: torch.Tensor  # f [cap, NC]
    rhoI: torch.Tensor  # f [cap, NC] half-step density
    e: torch.Tensor  # f [cap, NC]
    C: torch.Tensor  # f [Ns, cap, NC]
    Cd: torch.Tensor  # i32 [Nssa, cap, NC]
    S: torch.Tensor  # f [3, 3, cap, NC]
    # -- force-eval outputs (persist across the step boundary) --------------
    f: torch.Tensor  # f [3, cap, NC]
    drho: torch.Tensor  # f [cap, NC]
    de: torch.Tensor  # f [cap, NC]
    Q: torch.Tensor  # f [Ns, cap, NC]
    Qd: torch.Tensor  # i32 [Nssa, cap, NC]
    ddv: torch.Tensor  # f [3, cap, NC]
    ddx: torch.Tensor  # f [3, cap, NC]
    dS: torch.Tensor  # f [3, 3, cap, NC]
    phi: torch.Tensor  # f [cap, NC]
    num_den: torch.Tensor  # f [cap, NC]
    nw: torch.Tensor  # f [3, cap, NC]
    vws: torch.Tensor  # f [3, cap, NC]
    aws: torch.Tensor  # f [3, cap, NC]
    rhoAux1: torch.Tensor  # f [cap, NC]
    rhoAux2: torch.Tensor  # f [cap, NC]
    Pnew: torch.Tensor  # f [cap, NC]
    # -- bookkeeping (0-dim tensors, kept on the device) ---------------------
    step: torch.Tensor  # i32
    dt: torch.Tensor  # f
    key: torch.Tensor  # i64 [2]
    overflow: torch.Tensor  # i32: particles dropped at rebin (must stay 0)
    drift_violation: torch.Tensor = None  # i32

    @property
    def n_valid(self):
        return torch.sum(self.valid.to(torch.int32))

    @staticmethod
    def zeros(geom: Geometry, n_sdpd: int = 0, n_ssa: int = 0,
              dtype=torch.float32, seed: int = 0, device=None):
        """An empty state on ``device`` (default: the card)."""
        device = resolve_device(device)
        NC, cap = geom.ncells_total, geom.cap
        i32 = torch.int32

        def z(*lead, dt=dtype):
            return torch.zeros(lead + (cap, NC), dtype=dt, device=device)

        def one(*lead):
            return torch.ones(lead + (cap, NC), dtype=dtype, device=device)

        def scalar(dt):
            return torch.zeros((), dtype=dt, device=device)

        return State(
            tag=z(dt=i32), ptype=z(dt=i32), valid=z(dt=torch.bool),
            groupmask=z(dt=i32), solid_tag=z(dt=i32), fixed_tag=z(dt=i32),
            x=z(3), v=z(3), vest=z(3), rho=one(), rhoI=one(), e=z(),
            C=z(n_sdpd), Cd=z(n_ssa, dt=i32), S=z(3, 3),
            f=z(3), drho=z(), de=z(), Q=z(n_sdpd), Qd=z(n_ssa, dt=i32),
            ddv=z(3), ddx=z(3), dS=z(3, 3), phi=z(), num_den=one(), nw=z(3),
            vws=z(3), aws=z(3), rhoAux1=z(), rhoAux2=one(), Pnew=z(),
            step=scalar(i32), dt=scalar(dtype),
            # jax.random.PRNGKey(seed) is the word pair (0, seed)
            key=torch.tensor([0, seed], dtype=torch.int64, device=device),
            overflow=scalar(i32), drift_violation=scalar(i32),
        )


# ---------------------------------------------------------------------------
# Cell indexing & rebinning
# ---------------------------------------------------------------------------

# Bookkeeping leaves that carry no trailing [cap, NC] axes.
_SCALAR_LEAVES = ("step", "dt", "key", "overflow", "drift_violation")

# Per-step accumulators that force_clear fully rewrites before anything on
# the far side of a chunk boundary reads them: rebin zeroes them instead of
# moving them (see the JAX module for the reasoning per field).
_REBIN_DROPPABLE = ("phi", "nw", "vws", "aws", "rhoAux1", "rhoAux2", "Pnew",
                    "de", "Qd")
# num_den/ddx feed the next step only under XSPH.
_REBIN_DROPPABLE_NO_XSPH = ("num_den", "ddx")


def rebin_droppable(uses_xsph: bool) -> tuple:
    """Accumulator leaves a rebin at the chunk boundary may zero, not move."""
    return _REBIN_DROPPABLE + (() if uses_xsph else _REBIN_DROPPABLE_NO_XSPH)


def particle_fields(state: State) -> dict:
    """All per-particle leaves (trailing [cap, NC]) as a dict."""
    return {
        f.name: getattr(state, f.name)
        for f in dataclasses.fields(state)
        if f.name not in _SCALAR_LEAVES
    }


def _mod(a, n):
    """Floored modulo with jnp.mod's rounding: fmod, then shift the sign."""
    r = torch.fmod(a, n)
    return torch.where((r != 0) & ((r < 0) != (n < 0)), r + n, r)


class XColumns(NamedTuple):
    """A geometry's non-uniform x columns as tensors on one device."""

    bounds: torch.Tensor  # i32 [nx+1]: each column's first fine bin, then n_fine
    table: torch.Tensor  # i32 [n_fine]: fine bin -> x column
    edges: torch.Tensor  # [nx+1] x_edges in the state's dtype
    span: torch.Tensor  # 0-dim x_edges[-1] - x_edges[0], the periodic wrap


@functools.lru_cache(maxsize=16)
def x_columns(geom: Geometry, device, dtype: torch.dtype) -> XColumns:
    """``geom.x_edges`` as the tensors the binning, the drift count and the
    move kernels read, made on ``device`` once per geometry: the host
    copies happen at a build or a re-cut, not at every rebin.  Every
    caller gets the same tensors, so none may write to them.

    The edges are integer multiples of ``x_quantum`` above the first, so a
    column is a run of fine bins: binning is one uniform floor at quantum
    resolution plus a gather of ``table``."""
    e = np.asarray(geom.x_edges, np.float64)
    bins = np.round((e - e[0]) / geom.x_quantum).astype(np.int64)
    table = np.repeat(np.arange(len(bins) - 1, dtype=np.int32), np.diff(bins))
    return XColumns(
        bounds=torch.as_tensor(bins.astype(np.int32), device=device),
        table=torch.as_tensor(table, device=device),
        edges=torch.as_tensor(e, dtype=dtype, device=device),
        span=torch.tensor(geom.x_edges[-1] - geom.x_edges[0], dtype=dtype,
                          device=device))


def _x_column_of(x0, geom: Geometry):
    """Non-uniform x binning: positions -> column index via the fine table.

    A periodic x axis first wraps by the edges' own span
    ``x_edges[-1] - x_edges[0]`` (not ``wrap_pbc``'s ``hi - lo``), and
    ``1 / x_quantum`` is a Python constant rounded to the tensor's dtype, as
    in the JAX package."""
    cols = x_columns(geom, x0.device, x0.dtype)
    n_fine = cols.table.shape[0]
    lo = geom.lo[0]
    if geom.periodic[0]:
        x0 = _mod(x0 - lo, cols.span) + lo
    f = torch.floor((x0 - lo) * (1.0 / geom.x_quantum)).to(torch.int32)
    return cols.table[torch.clamp(f, 0, n_fine - 1).long()]


def cell_index_of(x, geom: Geometry):
    """Map positions [3, ...] -> flat cell index [...] (i32). Clamps open boundaries.

    ``(x - lo) * inv`` with Python-float ``lo`` and ``inv``: PyTorch, like
    JAX, rounds both scalars to the tensor's dtype first, which the move
    kernels reproduce bit for bit.  Non-uniform x columns bin through
    ``_x_column_of``.
    """
    out = None
    for ax in range(3):
        n = geom.ncells[ax]
        if n == 1:
            c = torch.zeros(x.shape[1:], dtype=torch.int32, device=x.device)
        elif ax == 0 and geom.x_edges is not None:
            c = _x_column_of(x[0], geom)
        else:
            inv = 1.0 / geom.cell_size[ax]
            c = torch.floor((x[ax] - geom.lo[ax]) * inv).to(torch.int32)
            c = _mod(c, n) if geom.periodic[ax] else torch.clamp(c, 0, n - 1)
        out = c if out is None else out * n + c
    return out


def wrap_pbc(x, geom: Geometry):
    """Wrap positions into the box on periodic axes (reference domain->pbc)."""
    comps = []
    for ax in range(3):
        if geom.periodic[ax]:
            lo, hi = geom.lo[ax], geom.hi[ax]
            comps.append(lo + _mod(x[ax] - lo, torch.tensor(
                hi - lo, dtype=x.dtype, device=x.device)))
        else:
            comps.append(x[ax])
    return torch.stack(comps, dim=0)


def _coord_of_cells(geom: Geometry, ax: int, device):
    """Per-cell coordinate along ``ax`` as an i32 [NC] vector."""
    c = torch.arange(geom.ncells_total, dtype=torch.int32, device=device)
    return (c // geom.strides[ax]) % geom.ncells[ax]


def shift_cells(a, offset, geom: Geometry):
    """Neighbor-cell view: out[..., c] = a[..., c + offset] on the cell grid.

    Non-periodic axes produce zeros (an all-invalid ghost cell); periodic
    axes wrap within the axis.
    """
    for ax, off in enumerate(offset):
        if off == 0:
            continue
        n = geom.ncells[ax]
        stride = geom.strides[ax]
        coord = _coord_of_cells(geom, ax, a.device)
        inbounds = (coord + off >= 0) & (coord + off < n)
        main = torch.roll(a, -off * stride, dims=-1)
        if geom.periodic[ax]:
            wrap_off = off - n if off > 0 else off + n
            alt = torch.roll(a, -wrap_off * stride, dims=-1)
            a = torch.where(inbounds, main, alt)
        else:
            a = torch.where(inbounds, main, torch.zeros((), dtype=a.dtype,
                                                        device=a.device))
    return a


def _flat_slots(a):
    """[..., cap, NC] -> [..., cap * NC] (slot-major flat particle axis)."""
    return a.reshape(a.shape[:-2] + (a.shape[-2] * a.shape[-1],))


def _drift_count(fields, geom: Geometry, x0: int = 0):
    """Valid particles farther than drift_budget outside their assigned cell.
    ``x0``: the global x plane of the fields' first cell (a mesh's slab).

    On a periodic axis of more than one cell the position's image nearest
    its cell is measured.  ``wrap_pbc`` can return hi itself (a position a
    hair below lo, plus the f32 extent, rounds to hi), which
    ``cell_index_of`` bins into cell 0: the particle sits at cell 0's lower
    face, one period away, and pairs see it there (the minimum image).  The
    JAX package's count measures the raw position and counts it as a drift
    past the whole box (``sph_bvf_tpu/core/state.py`` ``rebin``); any other
    position has the same count in both."""
    x = fields["x"]  # [3, cap, NC]
    first = x0 * geom.strides[0]
    cell_ids = torch.arange(first, first + x.shape[-1], dtype=torch.int32,
                            device=x.device)
    excess = torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    for ax in range(geom.dim):
        coord = (cell_ids // geom.strides[ax]) % geom.ncells[ax]
        if ax == 0 and geom.x_edges is not None:
            e = x_columns(geom, x.device, x.dtype).edges
            ax_lo, ax_hi = e[:-1][coord.long()], e[1:][coord.long()]
        else:
            ax_lo = geom.lo[ax] + coord.to(x.dtype) * geom.cell_size[ax]
            ax_hi = ax_lo + geom.cell_size[ax]
        xa = x[ax]
        if geom.periodic[ax] and geom.ncells[ax] > 1:
            span = geom.hi[ax] - geom.lo[ax]
            centre = 0.5 * (ax_lo + ax_hi)
            xa = xa - span * torch.round((xa - centre[None, :]) / span)
        below = ax_lo[None, :] - xa
        above = xa - ax_hi[None, :]
        excess = torch.maximum(excess, torch.maximum(below, above))
    bad = fields["valid"] & (excess > geom.drift_budget)
    return torch.sum(bad.to(torch.int32))


def rebin(state: State, geom: Geometry, drop: tuple = (),
          use_kernel: bool = True, drift_check: bool = True,
          mesh=None) -> State:
    """Re-scatter every particle into the cell slot owned by its position.

    Deterministic: rows are ordered by (cell, current flat slot).  Particles
    beyond a cell's capacity are dropped and counted in ``state.overflow``.

    ``use_kernel``: route the move through ``core/rebin_cuda.move`` (the
    locality walk; the kernel on a CUDA tensor, its plain version on a CPU
    tensor) — identical slot assignments to the sort below whenever every
    particle stayed within one cell ring.  ``False`` runs the global sort,
    which also places particles from arbitrary slots: the initial binning.
    On the card a 2D grid whose cap passes K6's shared memory takes the
    sort too (``rebin_cuda.sort_route``), chosen from the geometry.

    ``drift_check=False``: a cross-geometry rebin (an in-run re-cut of the
    x columns).  The slots still hold the old geometry's cells, so neither
    the drift count nor the locality walk applies: the count is skipped and
    the global sort runs.

    ``drop``: leaf names (see ``rebin_droppable``) to zero instead of move.

    ``mesh`` (``parallel/mesh.Mesh``): ``state`` is this rank's x-slab of
    ``geom``.  The move runs on the slab with its halo planes
    (``rebin_cuda.move``); the sort gathers every rank's particles, sorts
    them as one grid and keeps this rank's slab.  The overflow and drift
    counts are sums over the ranks, the same on every rank.
    """
    reduce = _reducer(mesh)
    fields = particle_fields(state)
    zeroed = {n: torch.zeros_like(fields.pop(n)) for n in drop}

    drift_violation = state.drift_violation
    if geom.drift_budget > 0 and drift_check:
        x0 = 0
        if mesh is not None:
            from sph_bvf_tpu_torch.parallel.mesh import slab_of

            x0 = slab_of(geom, mesh).x0
        # the counters stay i32 (the JAX package's, and its checkpoints')
        drift_violation = drift_violation + reduce(
            _drift_count(fields, geom, x0)).to(drift_violation.dtype)

    fields["x"] = wrap_pbc(fields["x"], geom)

    if use_kernel and drift_check:
        from sph_bvf_tpu_torch.core.rebin_cuda import move, move_supported

        if move_supported(geom):
            n_before = torch.sum(fields["valid"].to(torch.int32))
            new_fields = move(fields, geom, mesh)
            # every particle not re-placed (cell over capacity, or a move
            # beyond the one-cell ring) is a loss; under a mesh the
            # particles that crossed to a neighbour's slab are counted
            # there, so the loss is the sum over the ranks
            lost = reduce(n_before - torch.sum(
                new_fields["valid"].to(torch.int32)))
            new_state = dataclasses.replace(
                state, overflow=state.overflow + lost.to(state.overflow.dtype),
                drift_violation=drift_violation, **new_fields, **zeroed,
            )
            return _neutralize_invalid(new_state)
        from sph_bvf_tpu_torch.core.rebin_cuda import move_refusal, sort_route

        if state.x.is_cuda and not sort_route(geom):
            # what is left: a periodic axis of 2 cells (a 2D grid past
            # K6's shared memory takes the sort below)
            raise NotImplementedError(
                f"rebin move for this grid (dim={geom.dim}, cap={geom.cap}, "
                f"ncells={geom.ncells}, periodic={geom.periodic}, x_edges "
                f"{'set' if geom.x_edges is not None else 'unset'}) is ported "
                f"in a later PR: {move_refusal(geom)}"
            )

    if mesh is not None:
        from sph_bvf_tpu_torch.parallel.mesh import all_gather

        NC_loc = fields["valid"].shape[-1]
        names = list(fields)
        fields = dict(zip(names, all_gather(fields.values(), mesh)))
        new_fields, dropped = _sort_move(fields, geom, state.x.dtype)
        lo = mesh.rank * NC_loc
        new_fields = {k: v[..., lo:lo + NC_loc].contiguous()
                      for k, v in new_fields.items()}
    else:
        new_fields, dropped = _sort_move(fields, geom, state.x.dtype)
    new_state = dataclasses.replace(
        state,
        overflow=state.overflow + dropped,
        drift_violation=drift_violation,
        **new_fields,
        **zeroed,
    )
    # empty slots must hold neutral denominators
    return _neutralize_invalid(new_state)


def _reducer(mesh):
    """A sum over the mesh's ranks (``parallel/mesh.all_reduce``), or the
    identity without a mesh."""
    if mesh is None:
        return lambda t: t
    from sph_bvf_tpu_torch.parallel.mesh import all_reduce

    return lambda t: all_reduce(t, mesh)


def _sort_move(fields: dict, geom: Geometry, fdt) -> tuple:
    """The global sort of every particle leaf in ``fields`` (wrapped
    positions) into ``geom``'s slots: (the new leaves, the count dropped
    past cap)."""
    NC, cap = geom.ncells_total, geom.cap
    M = NC * cap
    dev = fields["x"].device
    valid = _flat_slots(fields["valid"])
    cell = torch.where(valid, _flat_slots(cell_index_of(fields["x"], geom)),
                       torch.tensor(NC, dtype=torch.int32, device=dev))
    cell_sorted, order = torch.sort(cell, stable=True)
    # rank within cell: position minus the (cummax-propagated) segment start
    i = torch.arange(M, dtype=torch.int64, device=dev)
    is_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          cell_sorted[1:] != cell_sorted[:-1]])
    seg_start = torch.cummax(torch.where(is_start, i, 0), dim=0).values
    rank = i - seg_start
    keep = (cell_sorted < NC) & (rank < cap)
    # slot-major destination: dest = rank * NC + cell; M -> dropped
    dest = torch.where(keep, rank * NC + cell_sorted, M)
    dropped = torch.sum((cell_sorted < NC) & ~keep).to(torch.int32)

    # invert the permutation once: src[dest] = order (one spare drop slot)
    src = torch.full((M + 1,), M, dtype=torch.int64, device=dev)
    src.scatter_(0, dest, order)
    src = src[:M]
    got = src < M
    src = torch.clamp(src, max=M - 1)

    # pack all leaves into two dtype-homogeneous matrices, move, unpack
    packs = {fdt: [], torch.int32: []}
    meta = []  # (name, kind, nrows, lead-shape, dtype)
    for name, a in fields.items():
        flat = _flat_slots(a).reshape(-1, M)
        kind = fdt if a.dtype.is_floating_point else torch.int32
        packs[kind].append(flat.to(kind))
        meta.append((name, kind, flat.shape[0], a.shape[:-2], a.dtype))

    moved = {}
    for kind, mats in packs.items():
        if not mats:
            continue
        mat = torch.cat(mats, dim=0)
        moved[kind] = torch.where(got, mat[:, src],
                                  torch.zeros((), dtype=kind, device=dev))

    new_fields = {}
    rows = {fdt: 0, torch.int32: 0}
    for name, kind, nrows, lead, dtype in meta:
        r = rows[kind]
        rows[kind] = r + nrows
        block = moved[kind][r: r + nrows]
        new_fields[name] = block.to(dtype).reshape(lead + (cap, NC))
    return new_fields, dropped


def _neutralize_invalid(state: State) -> State:
    """Give padded slots safe values for fields used as denominators."""
    v = state.valid
    one = torch.ones((), dtype=state.rho.dtype, device=v.device)
    return dataclasses.replace(
        state,
        rho=torch.where(v, state.rho, one),
        rhoI=torch.where(v, state.rhoI, one),
        num_den=torch.where(v, state.num_den, one),
        rhoAux2=torch.where(v, state.rhoAux2, one),
    )


# ---------------------------------------------------------------------------
# Construction from flat host arrays
# ---------------------------------------------------------------------------


def resolve_device(device) -> torch.device:
    """The device an entry point builds on: the card (``cuda``) unless the
    caller names another.  Without a card, the first tensor made on it
    raises torch's own CUDA error; nothing falls back to the CPU."""
    return torch.device("cuda" if device is None else device)


def _to_internal(host: np.ndarray) -> np.ndarray:
    """Host [n, comps...] (component-trailing) -> internal [comps..., n]."""
    if host.ndim == 1:
        return host
    return np.moveaxis(host, 0, -1)


_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64,
             torch.int32: np.int32, torch.bool: np.bool_}


def state_from_particles(
    geom: Geometry,
    x: np.ndarray,
    ptype: np.ndarray,
    n_sdpd: int = 0,
    n_ssa: int = 0,
    dtype=torch.float32,
    seed: int = 0,
    device=None,
) -> State:
    """Build a binned State on ``device`` (default: the card) from flat host
    arrays."""
    device = resolve_device(device)
    n = x.shape[0]
    if x.shape[1] == 2:
        x = np.concatenate([x, np.zeros((n, 1))], axis=1)
    st = State.zeros(geom, n_sdpd=n_sdpd, n_ssa=n_ssa, dtype=dtype, seed=seed,
                     device=device)
    NC, cap = geom.ncells_total, geom.cap
    M = NC * cap
    if n > M:
        raise ValueError(f"{n} particles exceed slot capacity {M}")

    def put(field, valsrc):
        lead = tuple(field.shape[:-2])
        flat = np.zeros(lead + (M,), _NP_DTYPE[field.dtype])
        flat[..., :n] = _to_internal(np.asarray(valsrc))
        return torch.as_tensor(flat.reshape(field.shape), device=device)

    st = dataclasses.replace(
        st,
        x=put(st.x, x),
        tag=put(st.tag, np.arange(1, n + 1, dtype=np.int32)),
        ptype=put(st.ptype, ptype.astype(np.int32)),
        valid=put(st.valid, np.ones(n, bool)),
        groupmask=put(st.groupmask, np.full(n, GROUP_ALL, np.int32)),
    )
    # the pre-binning slot packing is arbitrary (first n flat slots), so only
    # the global sort can place the particles
    st = rebin(st, geom, use_kernel=False)
    # only drift AFTER the first real binning is meaningful
    return dataclasses.replace(st, drift_violation=torch.zeros_like(st.overflow))


def scatter_by_tag(state: State, **host_arrays) -> State:
    """Overwrite per-particle fields from tag-ordered host arrays.

    ``host_arrays[name]`` is [n, comps...] indexed by ``tag - 1``; slots are
    filled through the current binning.
    """
    order = state.tag.reshape(-1).cpu().numpy().astype(np.int64) - 1
    valid = state.valid.reshape(-1).cpu().numpy()
    repl = {}
    for name, arr in host_arrays.items():
        field = getattr(state, name)
        arr = np.asarray(arr)
        flat = np.zeros((order.shape[0],) + arr.shape[1:], arr.dtype)
        flat[valid] = arr[order[valid]]
        internal = _to_internal(flat)  # [comps..., M]
        repl[name] = torch.as_tensor(
            internal.reshape(field.shape).astype(_NP_DTYPE[field.dtype]),
            device=field.device,
        )
    return dataclasses.replace(state, **repl)


def check_whole(state: State, geom: Geometry, what: str) -> None:
    """Raise unless ``state`` holds every cell of ``geom``: a mesh's slab
    must be gathered first (``parallel/mesh.gather_particles``,
    ``gather_state``), or ``what`` would see one rank's particles only."""
    NC = state.valid.shape[-1]
    if NC != geom.ncells_total:
        raise ValueError(
            f"{what} of a state of {NC} cells on a grid of "
            f"{geom.ncells_total}: a mesh's slab is gathered over the mesh "
            f"first (parallel/mesh.gather_state)")


def gather_particles(state: State, geom: Geometry, fields=("x", "v", "rho")):
    """Host-side: extract valid particles sorted by tag -> dict of np arrays
    (component-trailing, [n, comps...]).  ``state`` holds the whole grid
    (``check_whole``)."""
    check_whole(state, geom, "gather_particles")
    valid = state.valid.reshape(-1).cpu().numpy()
    tags = state.tag.reshape(-1).cpu().numpy()[valid]
    order = np.argsort(tags, kind="stable")
    out = {"tag": tags[order]}
    for name in fields:
        a = getattr(state, name).cpu().numpy()
        a = a.reshape(a.shape[:-2] + (a.shape[-2] * a.shape[-1],))
        a = np.moveaxis(a, -1, 0)[valid]
        out[name] = a[order]
    return out
