"""FSI: elastic beam in a channel flow — paper example 3 (PyTorch).

Port of ``sph_bvf_tpu/models/fsi.py``, line for line: a periodic-x channel
(300um x 100um plus a 50um inlet sponge) with 3-layer fixed walls, an
elastic beam (rho 7850, E=2e5, nu=0.33) rooted in the bottom wall on a
0.6x finer lattice, `ssa_tsdpd/bvf/mechanics` pair + integrator, and buffer
sponges that drive the inlet velocity toward (vo, 0).  dt = 1e-8.

The mechanics integrator's solid release gate keeps the beam frozen until
step 1e6 (fix_ssa_tsdpd_bvf_mechanics.cpp:151); pass ``tdamp_solid`` to
shorten it.

``scene`` builds the channel and beam from either package's classes, in
2D or extruded along a periodic z axis (``build_spanwise``; in neither
registry).
"""

from __future__ import annotations

import math

from sph_bvf_tpu_torch.api.scene import Region, Scene
from sph_bvf_tpu_torch.core.fixes import Buffer


def scene(Scene, Region, Buffer, nx: int = 60, nz_cells: int | None = None,
          dt: float = 1e-8, vo: float = 0.0333, nu: float = 1e-3,
          E: float = 2e5, Pratio: float = 0.33, rebin_every: int = 100,
          tdamp_solid: float = 1e6, ncx_multiple_of: int = 1,
          pair_style: str = "mechanics", kappa: float | None = None):
    """The channel and beam as an unbuilt scene of the given package's
    classes.  With ``nz_cells`` None, the 2D model: square lattices, one
    beam spacing of depth.  Otherwise extruded along a periodic z axis:
    ``Scene(dim=3, boundary=("p", "f", "p"))``, simple-cubic lattices
    (origin at half a spacing) for the fluid and walls and for the beam on
    its 0.6x finer lattice, the box and the beam spanning z in [0, Lz] with
    Lz = nz_cells x 1.34 h (the default cell margin makes that ``nz_cells``
    cells), and the volumes in the masses multiplied by Lz.
    ``pair_style``: "mechanics" (the model's) or "fsi" (cell polarization's:
    density diffusion, G0 softened by the first species); ``kappa``: one
    continuum species with this diffusivity on every type pair (none by
    default).  Build it with ``.build(device=...)`` (the port) or
    ``.build()`` (the JAX package)."""
    Lx, Ly = 300e-6, 100e-6
    Lbz = -50e-6  # buffer-zone extent (inlet sponge)
    n_wall = 3
    deltaf = Ly / nx
    deltab = 0.6 * deltaf
    rho_f, rho_b = 1000.0, 7850.0

    wallT = n_wall * deltaf
    yB0, yB1, yT0, yT1 = -wallT, 0.0, Ly, Ly + wallT
    bx0, bx1, by0, by1 = 100e-6, 105e-6, yB0, 50e-6
    cy = Ly / 2

    G = E / (2.0 * (1.0 + Pratio))
    K = E / (3.0 * (1.0 - 2.0 * Pratio))
    c0b = math.sqrt(K / rho_b)
    c0f = 10.0 * vo
    h = 3.0 * deltaf

    # the 2D model's volumes are areas; the extruded scene's span Lz
    if nz_cells is None:
        Lz, depth = deltab, 1.0
        dim, lat, origin = 2, "sq", {}
    else:
        Lz = depth = nz_cells * 1.34 * h
        dim, lat, origin = 3, "sc", {"origin": (0.5, 0.5, 0.5)}

    Ltotx = Lx - Lbz
    vtot = Ltotx * (Ly + 2 * wallT) * depth
    vwall = 2.0 * wallT * Ltotx * depth
    vbeam = (bx1 - bx0) * (by1 - by0) * depth
    vfluid = vtot - vwall - vbeam

    sc = Scene(dim=dim, n_sdpd=0 if kappa is None else 1,
               boundary=("p", "f", "p"))
    sc.rebin_every = rebin_every
    sc.ncx_multiple_of = ncx_multiple_of
    sc.create_box(3, Region.block(Lbz, Lx, yB0, yT1, 0, Lz))
    sc.lattice(lat, deltaf, **origin)

    beam_reg = Region.block(bx0, bx1, by0, by1, 0, Lz)
    fluid_reg = Region.block(Lbz, Lx, yB1, yT0, 0, Lz)
    upper = Region.block(Lbz, Lx, yB0, yB1, 0, Lz)
    lower = Region.block(Lbz, Lx, yT0, yT1, 0, Lz)

    # fluid + walls on the coarse lattice, with the beam region carved out
    sc.create_atoms(1, fluid_reg - upper - lower - beam_reg)
    sc.create_atoms(3, (upper | lower) - beam_reg)
    # beam on its finer lattice (script :98-101)
    sc.lattice(lat, deltab, **origin)
    sc.create_atoms(2, beam_reg)

    sc.group_region("walls", upper | lower)
    sc.group_region("beam", beam_reg)
    sc.group_expr("fluid", ~(sc.in_group("walls") | sc.in_group("beam")))

    n_beam = int(sc.in_group("beam").sum())
    n_fluid = int(sc.in_group("fluid").sum())
    m_fluid = vfluid * rho_f / n_fluid
    m_beam = vbeam * rho_b / n_beam
    sc.mass(1, m_fluid).mass(2, m_beam).mass(3, m_fluid)

    sc.set("fluid", rho=rho_f)
    sc.set("walls", rho=rho_f)
    sc.set("beam", rho=rho_b)
    sc.set("all", e=0.0)
    sc.set("beam", solid_tag=1, fixed=False)
    sc.set("walls", solid_tag=1, fixed=True)

    sc.pair_style(pair_style)
    k = () if kappa is None else (kappa,)
    sc.pair_coeff(1, 1, rho_f, c0f, nu, h, h, 0.0, kappa=k)
    sc.pair_coeff(1, 2, rho_f, c0f, nu, h, h, 0.0, kappa=k)
    sc.pair_coeff(1, 3, rho_f, c0f, nu, h, h, 0.0, kappa=k)
    sc.pair_coeff(2, 2, rho_b, c0b, nu, h, h, G, kappa=k)
    sc.pair_coeff(2, 3, rho_b, c0b, nu, h, h, G, kappa=k)
    sc.pair_coeff(3, 3, rho_f, c0f, nu, h, h, 0.0, kappa=k)
    sc.integrator("mechanics", tdamp_solid=tdamp_solid)

    # inlet sponges (script :229-230): blend vest toward (vo, 0) in the
    # buffer zone x in [-50um, 0], y in [0, Ly]
    for comp, val in ((0, vo), (1, 0.0)):
        sc.fix(Buffer(groupbit=sc.groupbit("fluid"), field="velocity",
                      direction="x", index=comp, center=(-25e-6, cy),
                      length=25e-6, width=50e-6, value=val, after_step=1))

    sc.timestep(dt)
    return sc


def build(nx: int = 60, dt: float = 1e-8, vo: float = 0.0333, nu: float = 1e-3,
          E: float = 2e5, Pratio: float = 0.33, rebin_every: int = 100,
          tdamp_solid: float = 1e6, ncx_multiple_of: int = 1, device=None):
    """The 2D model: (state, params, spec, scene), the state and params on
    ``device`` (default: the card)."""
    sc = scene(Scene, Region, Buffer, nx=nx, dt=dt, vo=vo, nu=nu, E=E,
               Pratio=Pratio, rebin_every=rebin_every, tdamp_solid=tdamp_solid,
               ncx_multiple_of=ncx_multiple_of)
    state, params, spec = sc.build(device=device)
    return state, params, spec, sc


def build_spanwise(nx: int = 60, nz_cells: int = 3, device=None, **kw):
    """``scene`` extruded over ``nz_cells`` periodic z cells with the port's
    classes, built: (state, params, spec, scene) on ``device`` (default: the
    card)."""
    sc = scene(Scene, Region, Buffer, nx=nx, nz_cells=nz_cells, **kw)
    state, params, spec = sc.build(device=device)
    return state, params, spec, sc
