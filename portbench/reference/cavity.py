"""The lid-driven cavity, rebuilt from its published script (plain NumPy and
PyTorch): the particles in tag order, their types, walls and lid, masses
and fields, and the cell grid the particles are binned on.

A configuration names this module as its ``reference``; the harness calls
``spacing``, ``scene`` and ``model`` with the configuration (and its
traffic) and nothing else.

2D: the SPH-BVF cavity script
(examples/ssa-tsdpd/lid_driven_cavity/Re100_N*/lid_driven_cavity.lmp): an
N x N square lattice of fluid in [0,1]^2 (spacing dx = 1/N, origin half a
spacing in), 3 layers of wall sites around it, the row above y = 1 the
lid, moving at (U0, 0).  3D: the same extruded to a
simple-cubic lattice in [0,1]^3, the slab above z = 1 the lid.  Sites are
made wall first, then fluid, each in lattice order (x slowest): a tag is
its 1-based index in that order.  Every region is a closed box.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from portbench.reference import physics


@dataclasses.dataclass
class Scene:
    """Per-tag arrays (index = tag - 1) of a built cavity and its constants."""

    dim: int
    x: np.ndarray  # f64 [n, 3]
    ptype: np.ndarray  # i64 [n]: 0 fluid, 1 wall or lid
    lid: np.ndarray  # bool [n]
    mass: tuple  # (fluid, wall) f64
    dx: float
    h: float
    nu: float
    c0: float
    rho0: float
    U0: float
    dt: float
    rebin_every: int
    freq_filter: int
    cell: float  # the cell grid: cell size, lower corner, cells per axis
    lo: float
    ncells: tuple

    @property
    def n(self) -> int:
        return self.x.shape[0]

    @property
    def solid(self) -> np.ndarray:
        return self.ptype == 1

    def cell_of(self, x: torch.Tensor) -> torch.Tensor:
        """The flat cell (x slowest) of positions ``x`` [n, 3] in their
        dtype: floor((x - lo) / cell), the two constants rounded to that
        dtype first, clamped into the grid."""
        out = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
        for ax in range(3):
            n = self.ncells[ax]
            c = (torch.zeros_like(out) if n == 1 else torch.clamp(
                torch.floor((x[:, ax] - self.lo) * (1.0 / self.cell)).long(),
                0, n - 1))
            out = out * n + c
        return out


def _sites(dim, lo, hi, a, origin):
    axes = []
    for ax in range(3):
        if ax >= dim:
            axes.append(np.array([0.0]))
            continue
        i0 = int(np.floor(lo[ax] / a - origin[ax])) - 1
        i1 = int(np.ceil(hi[ax] / a - origin[ax])) + 1
        c = (np.arange(i0, i1 + 1) + origin[ax]) * a
        axes.append(c[(c >= lo[ax]) & (c <= hi[ax])])
    g = np.meshgrid(*axes, indexing="ij")
    return np.stack([c.ravel() for c in g], axis=-1)


def _inside(x, lo, hi):
    return np.all((x >= np.asarray(lo)) & (x <= np.asarray(hi)), axis=-1)


def build(dim: int, N: int, Re: float = 100.0, U0: float = 1.0,
          c0: float = 10.0, dt: float | None = None, rebin_every: int = 10,
          wall_layers: int = 3, freq_filter: int = 20) -> Scene:
    """The ``dim``-dimensional cavity at N sites per axis of fluid."""
    if dt is None:
        dt = 1e-4 if N <= 200 else 5e-3 / N
    L = 1.0
    d = L / N
    wall = wall_layers * d
    lo, hi = -wall, L + wall
    if dim == 2:
        blo, bhi = (lo, lo, 0.0), (hi, hi, d)
        sites = _sites(2, blo, bhi, d, (0.5, 0.5, 0.0))
        boxes = [((lo, lo, 0), (0.0, hi, d)), ((L, lo, 0), (hi, hi, d)),
                 ((lo, lo, 0), (hi, 0.0, d))]
        lid_box = ((lo, L, 0), (hi, hi, d))
        fluid_box = ((1e-3, 1e-3, 0), (L, L, d))
    else:
        blo, bhi = (lo,) * 3, (hi,) * 3
        sites = _sites(3, blo, bhi, d, (0.5, 0.5, 0.5))
        boxes = [((lo, lo, lo), (0.0, hi, hi)), ((L, lo, lo), (hi, hi, hi)),
                 ((lo, lo, lo), (hi, 0.0, hi)), ((lo, L, lo), (hi, hi, hi)),
                 ((lo, lo, lo), (hi, hi, 0.0))]
        lid_box = ((lo, lo, L), (hi, hi, hi))
        eps = 1e-3 * d
        fluid_box = ((eps, eps, eps), (L, L, L))
    in_lid = _inside(sites, *lid_box)
    in_wall = in_lid.copy()
    for b in boxes:
        in_wall |= _inside(sites, *b)
    walls = sites[in_wall]
    fluid = sites[_inside(sites, *fluid_box)]
    x = np.concatenate([walls, fluid])
    n_wall, n_fluid = len(walls), len(fluid)
    lid = np.concatenate([in_lid[in_wall], np.zeros(n_fluid, bool)])
    ptype = np.concatenate([np.ones(n_wall, np.int64),
                            np.zeros(n_fluid, np.int64)])
    v_tot = (hi - lo) ** dim
    v_fluid = L ** dim
    # 2D divides the walls' volume over the walls without the lid, 3D over
    # every solid site, as the two scripts do
    n_share = n_wall - int(lid.sum()) if dim == 2 else n_wall
    mass = (v_fluid / n_fluid, (v_tot - v_fluid) / n_share)
    # cells: a whole number k of spacings, the least with k dx > h + h/4
    # past h, and enough of them to cover the box
    h = 2.5 * d
    k = max(int(round((h + 0.25 * h) / d)), 1)
    while k * d - h < 1e-6 * d:
        k += 1
    cell = k * d
    n_ax = max(int(np.ceil((hi - lo) / cell - 1e-9)), 1)
    ncells = tuple(n_ax if ax < dim else 1 for ax in range(3))
    return Scene(dim=dim, x=x, ptype=ptype, lid=lid, mass=mass, dx=d, h=h,
                 nu=U0 * L / Re, c0=c0, rho0=1.0, U0=U0, dt=dt,
                 rebin_every=rebin_every, freq_filter=freq_filter, cell=cell,
                 lo=lo, ncells=ncells)


def spacing(config: dict) -> float:
    """The lattice spacing of a configuration (the seed's jitter is a
    fraction of it)."""
    return 1.0 / config["N"]


def scene(config: dict) -> Scene:
    """The configuration's scene."""
    c = config
    return build(c["dim"], c["N"], Re=c["Re"], U0=c["U0"], c0=c["c0"],
                 dt=c["dt"], rebin_every=c["rebin_every"],
                 wall_layers=c["wall_layers"], freq_filter=c["freq_filter"])


def model(config: dict, traffic: dict, device, compute=torch.float32,
          drop=()) -> physics.Model:
    """The configuration's scene under its traffic's stochastic species
    (``species``: ``Cd0`` counts on the fluid sites with x at most
    ``x_max``, hop rates ``kss``, a decay of half-life
    ``decay_half_life_steps`` steps), as ``physics.Model``."""
    sc = scene(config)
    s = traffic.get("species")
    if not s:
        return physics.Model(sc, device, None,
                             torch.zeros((sc.n, 0), dtype=torch.int32,
                                         device=device), compute, drop)
    k = np.log(2.0) / (s["decay_half_life_steps"] * config["dt"])
    species = physics.Species(kss=tuple(s["kss"]), decay=(float(k),))
    on = (sc.ptype == 0) & (sc.x[:, 0] <= s["x_max"])
    cd0 = np.where(on, s["Cd0"], 0).astype(np.int32)[:, None]
    return physics.Model(sc, device, species,
                         torch.as_tensor(cd0, device=device), compute, drop)
