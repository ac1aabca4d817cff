"""Cell polarization — paper example 4 (yeast mating projection; PyTorch).

Port of ``sph_bvf_tpu/models/cell_polarization.py``, line for line: a
re-expression of
examples/ssa-tsdpd/cell_polarization/case_2/cell_polarization.lmp: a fully
periodic 50um box of fluid containing a ring-shaped elastic cell wall
(types 2 upper / 4 lower) around a denser cytoplasm (type 3).  The pair
style is `ssa_tsdpd/bvf/fsi`, whose chemo-mechanical coupling softens the
wall shear modulus as G0 (1 - 0.99 C[:,0]) (pair_ssa_tsdpd_bvf_fsi.cpp:441);
a Dirichlet forcing clamps C=1 on the lower half of the wall, so the wall
softens there and the cell polarizes.  The shipped examples run the
deterministic (tsdpd) species path: atom_style declares 0 SSA species
(cell_polarization.lmp:13).

dt = 1e-10, nt = 4e4.
"""

from __future__ import annotations

import math

from sph_bvf_tpu_torch.api.scene import Region, Scene
from sph_bvf_tpu_torch.core.fixes import Forcing


def build(nx: int = 100, dt: float = 1e-10, nu: float = 1e-3,
          rebin_every: int = 100, ncx_multiple_of: int = 1, device=None):
    """Returns (state, params, spec, scene), the state and params on
    ``device`` (default: the card).

    rebin_every=100: at dt=1e-10 the per-period drift is ~1e-9 of the
    drift budget, and the rebin checks it at run time.
    """
    Lx = Ly = 50e-6
    r_ext = 0.20 * Lx
    r_int = 0.15 * Lx
    deltaf = Ly / nx
    deltac = 0.8 * deltaf
    rho_f, rho_c, rho_i = 1000.0, 1100.0, 1500.0
    Lz = deltac
    cx, cy, cz = Lx / 2, Ly / 2, Lz / 2

    E, Pratio = 1e6, 0.3975
    Gmax = E / (2.0 * (1.0 + Pratio))
    Kw = 2.0 * Gmax * (1 + Pratio) / (3.0 * (1.0 - 2.0 * Pratio))
    c0w = math.sqrt(Kw / rho_f)   # script uses densityf here (:183)
    Kc, Kf = 5e5, 1e6
    c0c = math.sqrt(Kc / rho_c)
    c0f = math.sqrt(Kf / rho_f)
    h = 3.0 * deltaf

    v_tot = Lx * Ly
    v_cell_tot = math.pi * r_ext**2
    v_cell_int = math.pi * r_int**2
    v_cell = v_cell_tot - v_cell_int
    v_fluid = v_tot - v_cell_tot

    sc = Scene(dim=2, n_sdpd=1, boundary=("p", "p", "p"))
    sc.rebin_every = rebin_every
    sc.ncx_multiple_of = ncx_multiple_of
    sc.create_box(4, Region.block(0, Lx, 0, Ly, 0, Lz))

    ext = Region.sphere(cx, cy, cz, r_ext)
    inner = Region.sphere(cx, cy, cz, r_int)

    # fluid outside the cell (coarse lattice)
    sc.lattice("sq", deltaf)
    sc.create_atoms(1, Region.block(0, Lx, 0, Ly, 0, Lz) - ext)
    # cell wall ring (fine lattice, script :85-88)
    sc.lattice("sq", deltac)
    sc.create_atoms(2, ext - inner)
    # cytoplasm interior (coarse lattice, :92-95)
    sc.lattice("sq", deltaf)
    sc.create_atoms(3, inner)

    sc.group_type("fluid", 1)
    sc.group_type("cell", 2)
    sc.group_type("interior", 3)

    n_cell = int(sc.in_group("cell").sum())
    n_fluid = int(sc.in_group("fluid").sum())
    n_int = int(sc.in_group("interior").sum())
    m_fluid = v_fluid * rho_f / n_fluid
    m_cell = v_cell * rho_c / n_cell
    m_int = v_cell_int * rho_i / n_int

    sc.set("fluid", rho=rho_f)
    sc.set("cell", rho=rho_c)
    sc.set("interior", rho=rho_i)
    sc.set("all", e=0.0)

    # split the wall: lower half -> type 4 (script :143-155); the split line
    # sits just below the ring top: y > cy - (r_int + 0.05 Lx - H), H = 0.025Lx/2
    H = 1.0 * (0.05 * Lx) / 2.0
    height = cy - (r_int + 0.05 * Lx - H)
    x = sc._current_x()
    lower = sc.in_group("cell") & ~(x[:, 1] > height)
    upper = sc.in_group("cell") & (x[:, 1] > height)
    sc.group_expr("lowerhalfcircle", lower)
    sc.group_expr("upperhalfcircle", upper)
    sc._type[lower] = 3  # type 4 (0-based 3)
    sc.mass(1, m_fluid).mass(2, m_cell).mass(3, m_int).mass(4, m_cell)

    sc.set("upperhalfcircle", solid_tag=1, fixed=False)
    sc.set("lowerhalfcircle", solid_tag=1, fixed=False)

    sc.pair_style("fsi")
    k15 = 1e-5
    sc.pair_coeff(1, 1, rho_f, c0f, nu, h, h, 0.0, kappa=(0.0,))
    sc.pair_coeff(1, 2, rho_f, c0f, nu, h, h, 0.0, kappa=(0.0,))
    sc.pair_coeff(1, 3, rho_f, c0f, nu, h, h, 0.0, kappa=(0.0,))
    sc.pair_coeff(1, 4, rho_f, c0f, nu, h, h, 0.0, kappa=(0.0,))
    sc.pair_coeff(2, 2, rho_c, c0w, nu, h, h, Gmax, kappa=(k15,))
    sc.pair_coeff(2, 3, rho_c, c0w, nu, h, h, Gmax, kappa=(0.0,))
    sc.pair_coeff(2, 4, rho_c, c0w, nu, h, h, Gmax, kappa=(k15,))
    sc.pair_coeff(3, 3, rho_i, c0c, nu, h, h, 0.0, kappa=(0.0,))
    sc.pair_coeff(3, 4, rho_i, c0c, nu, h, h, 0.0, kappa=(0.0,))
    sc.pair_coeff(4, 4, rho_c, c0w, nu, h, h, Gmax, kappa=(k15,))
    sc.integrator("fsi")

    # C = 1 source on the lower wall (script :171; the huge rectangle covers
    # the whole domain, the group does the selection)
    sc.fix(Forcing(groupbit=sc.groupbit("lowerhalfcircle"), field="tsdpd",
                   index=0, shape="rectangle", center=(1e-3, 1e-3),
                   length=1e-3, width=1e-3, value=1.0, after_step=1))

    sc.timestep(dt)
    state, params, spec = sc.build(device=device)
    return state, params, spec, sc
