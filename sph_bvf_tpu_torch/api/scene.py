"""Scene builder: the input-script surface as a Python API (PyTorch).

Port of ``sph_bvf_tpu/api/scene.py``: every region (block, sphere, circle,
cylinder, cone, plane, prism) with union/intersect/subtract/complement,
square and simple-cubic lattice filling (the lattice may change between
``create_atoms`` calls), ``delete_atoms``, groups by region, type or mask,
per-atom setters, pair/integrator/fix selection and ``build``.  Scene state is
host-side numpy arrays in creation (tag) order, filled and grouped by
whole-array numpy operations (no per-site Python loop);
``build(device=...)`` bins everything into the cell-slot ``State`` on that
device (the card by default) and assembles the static ``ModelSpec``.

Lattice filling follows create_atoms (create_atoms.cpp:362-364): sites at
``(i + origin) * a`` per axis, kept when inside both the target region and
the simulation box; region containment is inclusive like Region::match.

Load balancing: ``balance`` cuts non-uniform x columns at build,
``fix_balance`` attaches the in-run re-cut (``parallel/balance.py``).

Not ported yet: SSA configs (``Scene.ssa``).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from sph_bvf_tpu_torch.core import fixes as fixes_mod
from sph_bvf_tpu_torch.core.integrate import IntegratorConfig
from sph_bvf_tpu_torch.core.state import (
    GROUP_ALL,
    Geometry,
    Params,
    resolve_device,
    scatter_by_tag,
    state_from_particles,
)
from sph_bvf_tpu_torch.core.stepper import ModelSpec
from sph_bvf_tpu_torch.ops.eos import tait_b
from sph_bvf_tpu_torch.ops.pair import PairConfig


# ---------------------------------------------------------------------------
# Regions (region_block.cpp, region_sphere.cpp, region_union.cpp ...)
# ---------------------------------------------------------------------------


class Region:
    def contains(self, x: np.ndarray) -> np.ndarray:  # [n, 3] -> [n] bool
        raise NotImplementedError

    # set algebra, like region union/intersect/subtract
    def __or__(self, other):
        return _Combine(np.logical_or, self, other)

    def __and__(self, other):
        return _Combine(np.logical_and, self, other)

    def __sub__(self, other):
        return _Combine(lambda a, b: a & ~b, self, other)

    def __invert__(self):
        return _Not(self)

    @staticmethod
    def block(xlo=-np.inf, xhi=np.inf, ylo=-np.inf, yhi=np.inf,
              zlo=-np.inf, zhi=np.inf):
        return _Block((xlo, ylo, zlo), (xhi, yhi, zhi))

    @staticmethod
    def sphere(cx, cy, cz, r):
        return _Sphere((cx, cy, cz), r)

    @staticmethod
    def circle(cx, cy, r):
        """2D disk (z ignored)."""
        return _Circle((cx, cy), r)

    @staticmethod
    def cylinder(axis, c1, c2, r, lo, hi):
        """region_cylinder.cpp: axis in 'xyz'; (c1, c2) are the center
        coordinates in the two remaining dims (x: y,z; y: x,z; z: x,y)."""
        return _Cylinder(axis, c1, c2, r, lo, hi)

    @staticmethod
    def cone(axis, c1, c2, radlo, radhi, lo, hi):
        """region_cone.cpp: radius varies linearly radlo@lo -> radhi@hi."""
        return _Cone(axis, c1, c2, radlo, radhi, lo, hi)

    @staticmethod
    def plane(px, py, pz, nx, ny, nz):
        """region_plane.cpp: inside = the half-space the normal points into."""
        return _Plane((px, py, pz), (nx, ny, nz))

    @staticmethod
    def prism(xlo, xhi, ylo, yhi, zlo, zhi, xy, xz, yz):
        """region_prism.cpp: parallelepiped with tilt factors xy/xz/yz."""
        return _Prism((xlo, ylo, zlo), (xhi, yhi, zhi), (xy, xz, yz))

    @staticmethod
    def union(*regions):
        """region_union.cpp: point is inside any sub-region."""
        out = regions[0]
        for r in regions[1:]:
            out = out | r
        return out

    @staticmethod
    def intersect(*regions):
        """region_intersect.cpp: point is inside every sub-region."""
        out = regions[0]
        for r in regions[1:]:
            out = out & r
        return out


_AXIS = {"x": 0, "y": 1, "z": 2}
# the two "other" dims for a cylinder/cone axis, in LAMMPS's c1/c2 order
# (region_cylinder.cpp: x -> (y, z), y -> (x, z), z -> (x, y))
_OTHER = {0: (1, 2), 1: (0, 2), 2: (0, 1)}


@dataclasses.dataclass
class _Block(Region):
    lo: Tuple[float, float, float]
    hi: Tuple[float, float, float]

    def contains(self, x):
        lo = np.asarray(self.lo)
        hi = np.asarray(self.hi)
        return np.all((x >= lo) & (x <= hi), axis=-1)


@dataclasses.dataclass
class _Sphere(Region):
    c: Tuple[float, float, float]
    r: float

    def contains(self, x):
        d = x - np.asarray(self.c)
        return np.sum(d * d, axis=-1) <= self.r * self.r


@dataclasses.dataclass
class _Circle(Region):
    c: Tuple[float, float]
    r: float

    def contains(self, x):
        d = x[..., :2] - np.asarray(self.c)
        return np.sum(d * d, axis=-1) <= self.r * self.r


def _in_axial(x, axis, c1, c2, r, lo, hi):
    """Within radius ``r`` (scalar or per point) of the axis line through
    (c1, c2) and between ``lo`` and ``hi`` along it."""
    a = _AXIS[axis]
    o1, o2 = _OTHER[a]
    d1 = x[..., o1] - c1
    d2 = x[..., o2] - c2
    return (d1 * d1 + d2 * d2 <= r * r) & (x[..., a] >= lo) & (x[..., a] <= hi)


@dataclasses.dataclass
class _Cylinder(Region):
    axis: str
    c1: float
    c2: float
    r: float
    lo: float
    hi: float

    def contains(self, x):
        return _in_axial(x, self.axis, self.c1, self.c2, self.r, self.lo, self.hi)


@dataclasses.dataclass
class _Cone(Region):
    axis: str
    c1: float
    c2: float
    radlo: float
    radhi: float
    lo: float
    hi: float

    def __post_init__(self):
        # region_cone.cpp rejects a degenerate axis extent; without this the
        # interpolation below divides by zero and the region is silently empty
        if not self.hi > self.lo:
            raise ValueError(
                f"cone axis extent must satisfy hi > lo (got {self.lo}, {self.hi})"
            )

    def contains(self, x):
        t = (x[..., _AXIS[self.axis]] - self.lo) / (self.hi - self.lo)
        r = self.radlo + t * (self.radhi - self.radlo)
        return _in_axial(x, self.axis, self.c1, self.c2, r, self.lo, self.hi)


@dataclasses.dataclass
class _Plane(Region):
    p: Tuple[float, float, float]
    n: Tuple[float, float, float]

    def __post_init__(self):
        if not np.linalg.norm(np.asarray(self.n, dtype=float)) > 0.0:
            raise ValueError("plane normal must be nonzero (region_plane.cpp)")

    def contains(self, x):
        n = np.asarray(self.n, dtype=float)
        n = n / np.linalg.norm(n)
        return np.sum((x - np.asarray(self.p)) * n, axis=-1) >= 0.0


@dataclasses.dataclass
class _Prism(Region):
    lo: Tuple[float, float, float]
    hi: Tuple[float, float, float]
    tilt: Tuple[float, float, float]  # xy, xz, yz

    def contains(self, x):
        # fractional coordinates of the upper-triangular edge vectors
        # (region_prism.cpp), solved back to front
        (xlo, ylo, zlo), (xhi, yhi, zhi) = self.lo, self.hi
        xy, xz, yz = self.tilt
        eps = 1e-12
        if zhi == zlo:  # degenerate z extent (2D scene): only z == zlo inside
            sz = np.where(np.abs(x[..., 2] - zlo) <= eps, 0.0, 2.0)
        else:
            sz = (x[..., 2] - zlo) / (zhi - zlo)
        sy = (x[..., 1] - ylo - sz * yz) / (yhi - ylo)
        sx = (x[..., 0] - xlo - sy * xy - sz * xz) / (xhi - xlo)
        ok = np.ones(x.shape[:-1], bool)
        for s in (sx, sy, sz):
            ok &= (s >= -eps) & (s <= 1.0 + eps)
        return ok


@dataclasses.dataclass
class _Combine(Region):
    op: object
    a: Region
    b: Region

    def contains(self, x):
        return self.op(self.a.contains(x), self.b.contains(x))


@dataclasses.dataclass
class _Not(Region):
    a: Region

    def contains(self, x):
        return ~self.a.contains(x)


# ---------------------------------------------------------------------------
# Scene
# ---------------------------------------------------------------------------


class Scene:
    def __init__(
        self,
        dim: int = 2,
        n_sdpd: int = 0,
        n_ssa: int = 0,
        n_rxn: int = 0,
        boundary: Tuple[str, str, str] = ("f", "f", "p"),
        dtype=torch.float32,
        seed: int = 0,
    ):
        self.dim = dim
        self.n_sdpd = n_sdpd
        self.n_ssa = n_ssa
        self.n_rxn = n_rxn
        self.periodic = tuple(b == "p" for b in boundary)
        self.dtype = dtype
        self.seed = seed

        self.box_lo = None
        self.box_hi = None
        self.ntypes = 0
        self._lattice = None  # (spacing, origin)
        # per-atom host arrays in creation order (the tag order)
        self._x = np.zeros((0, 3))
        self._type = np.zeros(0, np.int64)
        self._groups: Dict[str, int] = {"all": GROUP_ALL}
        self._next_groupbit = 2
        self._groupmask = np.zeros(0, np.int64)
        self._masses: Dict[int, float] = {}
        self._per_atom: Dict[str, np.ndarray] = {}
        self._pair_variant = None
        self._pair_kwargs = {}
        self._coeff = {}
        self._integ: Optional[IntegratorConfig] = None
        self._fixes: List[object] = []
        self._dt = None
        self.rebin_every = 10
        self.cap: Optional[int] = None
        self.margin_frac = 0.25
        # lattice-aligned cell sizing (see Geometry.build quantum)
        self.align_cells = True
        # round the x cell count to a multiple (for even sharding)
        self.ncx_multiple_of = 1
        # load balancing (parallel/balance.py): balance() sets the build-time
        # cut, fix_balance() the in-run re-cut
        self.balance_shards = 0
        self.balance_threshold = 2.0
        self._balance_fix = None

    def balance(self, n_shards: int, threshold: float = 2.0):
        """Non-uniform x columns for an ``n_shards``-slab run (the
        balance.cpp:1354 analog): when the uniform-width slab imbalance
        (max/mean particle count) exceeds ``threshold`` at build, the x
        edges are recut so each slab holds a near-equal particle share,
        every column staying wider than the cutoff.  Implies
        ``ncx_multiple_of=n_shards``."""
        self.balance_shards = int(n_shards)
        self.balance_threshold = float(threshold)
        self.ncx_multiple_of = max(self.ncx_multiple_of, int(n_shards))
        # set by _maybe_balance: True when non-uniform edges were applied,
        # False when requested but not applied (a warning says why), None
        # until build()
        self.balance_applied = None
        return self

    def fix_balance(self, n_shards: int, every: int = 1000,
                    threshold: float = 1.5, min_budget: float = 0.0,
                    occ_frac: float = 0.85):
        """In-run rebalancing (the ``fix balance`` command): ``simulate``
        re-cuts the x edges at a chunk boundary every ``every`` steps when a
        trigger fires (``parallel/balance.BalanceFix``).  Composes with
        ``balance``; implies ``ncx_multiple_of=n_shards``."""
        from sph_bvf_tpu_torch.parallel.balance import BalanceFix

        self._balance_fix = BalanceFix(
            n_shards=int(n_shards), every=int(every),
            threshold=float(threshold), min_budget=float(min_budget),
            occ_frac=float(occ_frac),
        )
        self.ncx_multiple_of = max(self.ncx_multiple_of, int(n_shards))
        return self

    # -- domain -------------------------------------------------------------
    def create_box(self, ntypes: int, region: _Block):
        self.ntypes = ntypes
        self.box_lo = tuple(region.lo)
        self.box_hi = tuple(region.hi)
        return self

    def lattice(self, style: str, spacing: float, origin=(0.5, 0.5, 0.0)):
        if style not in ("sq", "sc"):
            raise ValueError("square/simple-cubic lattices supported")
        self._lattice = (float(spacing), tuple(origin))
        return self

    def _lattice_sites(self) -> np.ndarray:
        a, origin = self._lattice
        lo, hi = np.asarray(self.box_lo), np.asarray(self.box_hi)
        axes = []
        for ax in range(3):
            if ax >= self.dim:
                axes.append(np.array([0.0]))
                continue
            i0 = int(np.floor((lo[ax]) / a - origin[ax])) - 1
            i1 = int(np.ceil((hi[ax]) / a - origin[ax])) + 1
            coords = (np.arange(i0, i1 + 1) + origin[ax]) * a
            coords = coords[(coords >= lo[ax]) & (coords <= hi[ax])]
            axes.append(coords)
        g = np.meshgrid(*axes, indexing="ij")
        return np.stack([c.ravel() for c in g], axis=-1)

    # -- atoms --------------------------------------------------------------
    def _current_x(self) -> np.ndarray:
        """Positions of the atoms made so far, [n, 3] in creation order."""
        return self._x

    def create_atoms(self, ptype: int, region: Region):
        sites = self._lattice_sites()
        new = sites[region.contains(sites)]
        self._x = np.concatenate([self._x, new])
        # 1-indexed like LAMMPS
        self._type = np.concatenate([self._type, np.full(len(new), ptype - 1)])
        self._groupmask = np.concatenate(
            [self._groupmask, np.full(len(new), GROUP_ALL)])
        return self

    def delete_atoms(self, region: Region):
        keep = ~region.contains(self._x)
        for key, arr in list(self._per_atom.items()):
            if arr.shape[0] == keep.shape[0]:
                self._per_atom[key] = arr[keep]
        self._x = self._x[keep]
        self._type = self._type[keep]
        self._groupmask = self._groupmask[keep]
        return self

    def set_type(self, group: str, ptype: int):
        """set group G type T (set.cpp type keyword)."""
        self._type[self.in_group(group)] = ptype - 1
        return self

    # -- groups -------------------------------------------------------------
    def _groupbit(self, name: str) -> int:
        if name not in self._groups:
            self._groups[name] = self._next_groupbit
            self._next_groupbit <<= 1
        return self._groups[name]

    def group_region(self, name: str, region: Region):
        return self.group_expr(name, region.contains(self._x))

    def group_type(self, name: str, ptype: int):
        return self.group_expr(name, self._type == ptype - 1)

    def group_expr(self, name: str, members: np.ndarray):
        """Assign a group from a boolean per-atom mask (group subtract etc.)."""
        bit = self._groupbit(name)
        self._groupmask[np.asarray(members, bool)] |= bit
        return self

    def in_group(self, name: str) -> np.ndarray:
        bit = self._groups[name]
        return (self._groupmask & bit) != 0

    def groupbit(self, name: str) -> int:
        return self._groups[name]

    # -- per-atom setters (set.cpp:547-613 ssa keywords) ---------------------
    def _ensure(self, key, default, shape=()):
        n = len(self._x)
        if key not in self._per_atom or self._per_atom[key].shape[0] != n:
            old = self._per_atom.get(key)
            arr = np.full((n,) + shape, default, dtype=float)
            if old is not None:
                arr[: old.shape[0]] = old
            self._per_atom[key] = arr
        return self._per_atom[key]

    def set(self, group: str, *, rho=None, e=None, C=None, Cd=None,
            solid_tag=None, fixed=None):
        sel = self.in_group(group)
        if rho is not None:
            self._ensure("rho", 1.0)[sel] = rho
        if e is not None:
            self._ensure("e", 0.0)[sel] = e
        if C is not None:
            k, val = C
            self._ensure("C", 0.0, (self.n_sdpd,))[sel, k] = val
        if Cd is not None:
            k, val = Cd
            self._ensure("Cd", 0.0, (self.n_ssa,))[sel, k] = val
        if solid_tag is not None:
            self._ensure("solid_tag", 0.0)[sel] = solid_tag
        if fixed is not None:
            self._ensure("fixed_tag", 0.0)[sel] = 1.0 if fixed else 0.0
        return self

    def velocity(self, group: str, vx=0.0, vy=0.0, vz=0.0):
        sel = self.in_group(group)
        v = self._ensure("v", 0.0, (3,))
        v[sel] = (vx, vy, vz)
        return self

    def mass(self, ptype: int, m: float):
        self._masses[ptype - 1] = m
        return self

    # -- physics ------------------------------------------------------------
    def pair_style(self, variant: str, **kwargs):
        self._pair_variant = variant
        self._pair_kwargs = kwargs
        return self

    def pair_coeff(self, i: int, j: int, rho0, c0, eta, h, cutc, G0,
                   kappa=(), kappa_ssa=()):
        """pair_coeff i j rho0 c0 eta h cutc G0 kappa... kappaSSA...
        (pair_ssa_tsdpd_bvf_transport_velocity.cpp:967-1026)."""
        self._coeff[(i - 1, j - 1)] = dict(
            rho0=rho0, c0=c0, eta=eta, h=h, cutc=cutc, G0=G0,
            kappa=tuple(kappa), kappa_ssa=tuple(kappa_ssa),
        )
        return self

    def integrator(self, variant: str, **kwargs):
        self._integ = getattr(IntegratorConfig, variant)(**kwargs)
        return self

    def fix(self, obj):
        self._fixes.append(obj)
        return self

    def timestep(self, dt: float):
        self._dt = dt
        return self

    # -- build --------------------------------------------------------------
    def _build_params(self) -> dict:
        """The Params tables as f32 numpy arrays (host side); ``build``
        makes the tensors once, on the target device."""
        T = self.ntypes
        f = np.float32
        mass = np.zeros(T, f)
        for t, m in self._masses.items():
            mass[t] = m
        rho0 = np.ones(T, f)
        c0 = np.ones(T, f)
        G0 = np.zeros(T, f)
        cut = np.zeros((T, T), f)
        cutc = np.zeros((T, T), f)
        visc = np.zeros((T, T), f)
        kappa = np.zeros((T, T, self.n_sdpd), f)
        kappa_ssa = np.zeros((T, T, self.n_ssa), f)
        for (i, j), c in self._coeff.items():
            rho0[i] = c["rho0"]
            c0[i] = c["c0"]
            G0[i] = c["G0"]
            for a, b in ((i, j), (j, i)):
                cut[a, b] = c["h"]
                cutc[a, b] = c["cutc"]
                visc[a, b] = c["eta"]
                if self.n_sdpd:
                    kappa[a, b] = c["kappa"]
                if self.n_ssa:
                    kappa_ssa[a, b] = c["kappa_ssa"]
        return dict(mass=mass, rho0=rho0, c0=c0, B=tait_b(c0, rho0), G0=G0,
                    cut=cut, cutc=cutc, visc=visc, kappa=kappa,
                    kappa_ssa=kappa_ssa)

    def _maybe_balance(self, geom, x, lo, idx, cutoff):
        """Swap in non-uniform x-column edges when the uniform-width slab
        imbalance for a ``balance_shards``-way run exceeds the threshold
        (see ``balance``).  Returns the (possibly rebuilt) geometry and the
        per-particle cell coordinates under it; host numpy, the JAX
        package's search step for step."""
        from sph_bvf_tpu_torch.parallel.balance import balanced_x_edges

        ns = self.balance_shards
        nx = geom.ncells[0]
        if nx % ns or nx < ns:
            return geom, idx

        def slab_imbalance(col_of_particle, ncols):
            s = np.bincount(col_of_particle // (ncols // ns), minlength=ns)
            return s.max() / max(s.mean(), 1.0)

        f = slab_imbalance(idx[:, 0], nx)
        if f <= self.balance_threshold:
            return geom, idx
        # fine quantum: the lattice spacing when cells are lattice-aligned
        # (edges stay lattice multiples), else a 1/8-cell subdivision
        if self.align_cells and self._lattice is not None \
                and not self.periodic[0]:
            q = float(self._lattice[0])
        else:
            q = geom.cell_size[0] / 8.0
        n_fine = int(round(nx * geom.cell_size[0] / q))
        # minimum column width: strictly above the cutoff (a zero margin
        # would disable the drift check)
        k_min = max(int(np.ceil(cutoff / q)), 1)
        while k_min * q - cutoff < 1e-6 * q:
            k_min += 1
        # column-count search: lattice-aligned columns may all sit at the
        # minimum width already, so equal-count edges need fewer, wider
        # columns; descend nx in multiples of ns, keep the best imbalance,
        # stop once balanced or after three tries that do not help
        x0 = x[:, 0]
        best = (f, None, nx)
        tried_worse = 0
        for nxb in range(nx, ns - 1, -ns):
            if nxb * k_min > n_fine:
                continue
            edges_f = balanced_x_edges(x0, lo[0], q, n_fine, nxb, k_min)
            e = np.asarray([lo[0] + b * q for b in edges_f])
            col = np.clip(np.searchsorted(e, x0, side="right") - 1, 0, nxb - 1)
            fb = slab_imbalance(col, nxb)
            if fb < best[0] - 1e-9:
                best = (fb, e, nxb)
                tried_worse = 0
            else:
                tried_worse += 1
            if best[0] <= 1.05 or tried_worse >= 3:
                break
        fb, e, nxb = best
        if e is None:
            warnings.warn(
                f"Scene.balance({ns}): uniform-slab imbalance {f:.2f}x "
                f"exceeds the {self.balance_threshold:.2f}x threshold but "
                "the column-width search found no improving edge set "
                "(every candidate column would violate the cutoff-width "
                "minimum); running with the uniform grid.",
                stacklevel=3,
            )
            self.balance_applied = False
            return geom, idx
        self.balance_applied = True
        widths = np.diff(e)
        budget = min(
            [(float(widths.min()) - cutoff) / 2.0]
            + [(geom.cell_size[ax] - cutoff) / 2.0 for ax in range(1, self.dim)]
        )
        geom = dataclasses.replace(
            geom,
            ncells=(nxb,) + tuple(geom.ncells[1:]),
            x_edges=tuple(float(v) for v in e),
            x_quantum=q,
            # cell_size[0] records the minimum width
            cell_size=(float(widths.min()),) + tuple(geom.cell_size[1:]),
            drift_budget=max(float(budget), 0.0),
            # variable widths break the uniform-lattice occupancy behind
            # K1's i-row gate: pass A goes to K2
            base_occ=0,
        )
        idx = idx.copy()
        idx[:, 0] = np.clip(np.searchsorted(e, x0, side="right") - 1, 0, nxb - 1)
        return geom, idx

    def build(self, device=None):
        """-> (state, params, spec), the state and params on ``device``
        (default: the card)."""
        if self._dt is None:
            raise ValueError("call timestep(dt) before build()")
        device = resolve_device(device)
        pnp = self._build_params()
        params = Params(**{k: torch.as_tensor(v, device=device)
                           for k, v in pnp.items()})
        cutoff = float(np.max(pnp["cut"]))
        x = self._x
        n = x.shape[0]

        # choose cell capacity from the densest initial cell, with slack
        margin = self.margin_frac * cutoff
        quantum = (
            self._lattice[0]
            if (self.align_cells and self._lattice is not None)
            else 0.0
        )
        geom_probe = Geometry.build(
            self.dim, self.box_lo, self.box_hi, cutoff,
            cap=1, periodic=self.periodic, margin=margin,
            multiple_of=(self.ncx_multiple_of, 1, 1), quantum=quantum,
        )
        cell_sz = np.asarray(geom_probe.cell_size)
        lo = np.asarray(self.box_lo)
        idx = np.floor((x - lo) / cell_sz).astype(int)
        nc = np.asarray(geom_probe.ncells)
        idx = np.clip(idx, 0, nc - 1)
        if self.balance_shards > 1 and n:
            geom_probe, idx = self._maybe_balance(geom_probe, x, lo, idx, cutoff)
        flat = (idx[:, 0] * nc[1] + idx[:, 1]) * nc[2] + idx[:, 2]
        dens = np.bincount(flat).max() if n else 1
        cap = self.cap or int(np.ceil(dens * 1.3)) + 2
        geom = dataclasses.replace(geom_probe, cap=cap)

        state = state_from_particles(
            geom, x, np.asarray(self._type), n_sdpd=self.n_sdpd,
            n_ssa=self.n_ssa, dtype=self.dtype, seed=self.seed, device=device,
        )
        if int(state.overflow):
            raise RuntimeError("initial binning overflow; raise Scene.cap")

        # scatter per-atom fields through the tag permutation
        pa = self._per_atom
        host = dict(groupmask=np.asarray(self._groupmask, np.int32))
        for name in ("rho", "e", "C", "Cd", "solid_tag", "fixed_tag", "v"):
            if name in pa:
                host[name] = pa[name]
        state = scatter_by_tag(state, **host)
        if "rho" in pa:
            rho = torch.where(state.valid, state.rho, 1.0)
            state = dataclasses.replace(state, rho=rho, rhoI=rho)

        sol = np.asarray(pa.get("solid_tag", np.zeros(1))) != 0
        fx = np.asarray(pa.get("fixed_tag", np.zeros(1))) != 0
        if fx.shape != sol.shape:
            fx = np.zeros(sol.shape, bool)
        solids = bool(np.any(sol))
        # force on a FIXED solid is never integrated: if every solid is
        # fixed the solid force branch is statically dead
        free_solids = bool(np.any(sol & ~fx))
        elastic = bool(np.any(pnp["G0"] > 0))
        integ = self._integ or getattr(IntegratorConfig, self._pair_variant)()
        pair_kwargs = dict(self._pair_kwargs)
        # sweep 3 (vws/aws) is consumed only by the plain-bvf-family and
        # zhang integrators' moving-wall reflections
        pair_kwargs.setdefault(
            "weighted_solid",
            integ.variant in ("bvf", "artificial_stress", "zhang"),
        )
        pair_kwargs.setdefault("free_solids_present", free_solids)
        # Shepard-filter accumulators only for integrators that filter; the
        # stepper gates them per step (run_chunk's phase)
        pair_kwargs.setdefault("density_filter_accs", integ.reads_rhoaux())
        # coefficient tables whose entries are all equal (a derived table is
        # uniform iff its source pair_coeff array is)
        ptp0 = lambda a: float(np.ptp(a)) == 0.0
        uniform = []
        for names, arr in (
            (("h", "inv_h", "inv_wdelta"), pnp["cut"]),
            (("eta",), pnp["visc"]),
            (("hc", "inv_hc"), pnp["cutc"]),
            (("m_harm",), pnp["mass"]),
            (("geff",), pnp["G0"]),
        ):
            if ptp0(arr):
                uniform.extend(names)
        pair_kwargs.setdefault("uniform_tables", tuple(sorted(uniform)))
        pair_cfg = getattr(PairConfig, self._pair_variant)(
            dim=self.dim,
            solids_present=solids,
            elastic_present=elastic,
            **pair_kwargs,
        )
        # fix ssa_tsdpd/buoyancy rejects a body force along a periodic
        # dimension (fix_ssa_tsdpd_buoyancy.cpp:63-68)
        for fobj in self._fixes:
            if isinstance(fobj, fixes_mod.Buoyancy) and self.periodic[fobj.dim]:
                raise ValueError(
                    f"buoyancy along periodic dimension {fobj.dim} "
                    "(fix_ssa_tsdpd_buoyancy.cpp:63-68)"
                )
        spec = ModelSpec(
            geom=geom,
            pair=pair_cfg,
            integ=integ,
            fixes=tuple(self._fixes),
            rebin_every=self.rebin_every,
            balance=self._balance_fix,
        )
        return state, params, spec
