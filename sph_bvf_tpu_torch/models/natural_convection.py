"""Natural convection around a hot cylinder (Boussinesq) — the reference's
second example (PyTorch).

Port of ``sph_bvf_tpu/models/natural_convection.py``, line for line: a
[-1/2,1/2]^2 box of N x N fluid particles with 3 wall layers, a fixed hot
cylinder (r=0.1) at the center, one continuum species C (temperature),
Boussinesq buoyancy f_y = -a m (C - C_ref) with a = -1, Dirichlet forcing
C=0 on walls and C=C0 on the cylinder.  eta* = sqrt(Sc/Ra),
kappa* = 1/sqrt(Sc Ra), c0 = 5, h = cutc = 2.5 dx, dt = 1e-4.

The reference script also sets e = 1e-6, which only feeds the SDPD thermal
force; the state carries it and the force stays off, as in the JAX package.
The reference's own configuration turns it on:
``dataclasses.replace(spec, pair=dataclasses.replace(spec.pair,
thermal=True))`` at the SI ``params.boltz`` (an O(1e-13) force).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sph_bvf_tpu_torch.api.scene import Region, Scene
from sph_bvf_tpu_torch.core.fixes import Buoyancy, Forcing


def build(N: int = 200, Ra: float = 1e4, Sc: float = 0.7, C0: float = 1.0,
          dt: float = 1e-4, c0: float = 5.0, n_wall_layers: int = 3,
          rebin_every: int = 50, ncx_multiple_of: int = 1, device=None):
    """Returns (state, params, spec, scene), the state and params on
    ``device`` (default: the card).

    rebin_every=50: developed-convection drift per period (|v|~0.1,
    dt=1e-4) is ~5e-4 against a 1.56e-3 drift budget at N=200, and the
    rebin checks it at run time.
    """
    L = 1.0
    dx = L / N
    wall = n_wall_layers * dx
    h = 2.5 * dx
    Lz = dx
    eta = math.sqrt(Sc / Ra)
    kappa = 1.0 / math.sqrt(Sc * Ra)
    r_cyl = 0.1

    xmin, xmax = -L / 2 - wall, L / 2 + wall
    ymin, ymax = -L / 2 - wall, L / 2 + wall

    sc = Scene(dim=2, n_sdpd=1, boundary=("f", "f", "p"))
    sc.rebin_every = rebin_every
    sc.ncx_multiple_of = ncx_multiple_of
    sc.create_box(2, Region.block(xmin, xmax, ymin, ymax, 0, Lz))
    sc.lattice("sq", dx)

    interior = Region.block(-L / 2, L / 2, -L / 2, L / 2, -np.inf, np.inf)
    # cylinder: a 3D sphere with cz = Lz/2, exactly as the script
    cyl = Region.sphere(0.0, 0.0, Lz / 2, r_cyl)

    sc.create_atoms(1, interior - cyl)
    sc.group_region("fluid", interior - cyl)
    sc.create_atoms(2, cyl)
    sc.group_region("sphere", cyl)

    walls_reg = (
        Region.block(-np.inf, np.inf, ymin, -L / 2)
        | Region.block(-np.inf, np.inf, L / 2, ymax)
        | Region.block(xmin, -L / 2, -np.inf, np.inf)
        | Region.block(L / 2, xmax, -np.inf, np.inf)
    )
    sc.create_atoms(2, walls_reg - interior - cyl)
    sc.group_region("walls", walls_reg - interior)

    npx = N + 2 * n_wall_layers
    m_i = (xmax - xmin) * (ymax - ymin) / (npx * npx)  # script vtot/Np
    sc.mass(1, m_i).mass(2, m_i)

    sc.set("all", rho=1.0, e=1e-6)
    sc.set("all", C=(0, 0.0))
    sc.set("sphere", C=(0, C0))
    sc.set("walls", solid_tag=1, fixed=True)
    sc.set("sphere", solid_tag=1, fixed=True)

    sc.pair_style("transport_velocity")
    for (i, j) in ((1, 1), (1, 2), (2, 2)):
        sc.pair_coeff(i, j, 1.0, c0, eta, h, h, 0.0, kappa=(kappa,))
    sc.integrator("transport_velocity")

    # buoyancy: acceleration -1.0 along y on C[0]
    sc.fix(Buoyancy(groupbit=1, mode="boussinesq", acceleration=-1.0,
                    dim=1, species=0, c_ref=0.0))
    # Dirichlet C: walls -> 0, cylinder -> C0; active after step 1
    sc.fix(Forcing(groupbit=sc.groupbit("walls"), field="tsdpd", index=0,
                   shape="rectangle", center=(0.0, 0.0), length=2.0,
                   width=2.0, value=0.0, after_step=1))
    sc.fix(Forcing(groupbit=sc.groupbit("sphere"), field="tsdpd", index=0,
                   shape="rectangle", center=(0.0, 0.0), length=2.0,
                   width=2.0, value=C0, after_step=1))

    sc.timestep(dt)
    state, params, spec = sc.build(device=device)
    return state, params, spec, sc


def qdot(state, params, groupbit: int) -> float:
    """The heat the group (the cylinder) supplies per unit time,
    -sum m_i Q_i[0] over its particles: the Dirichlet forcing holds C = C0
    there, so the tSDPD flux Q it would otherwise integrate is what it
    feeds the fluid.  Nu is its ratio to the same scene's conduction run."""
    sel = state.valid & ((state.groupmask & groupbit) != 0)
    m = params.mass[state.ptype.long()]
    zero = torch.zeros((), dtype=state.Q.dtype, device=state.Q.device)
    return float(-torch.sum(torch.where(sel, m * state.Q[0], zero)))
