"""Lid-driven cavity — the reference's flagship example (PyTorch).

Port of ``sph_bvf_tpu/models/lid_cavity.py``, line for line: a [0,1]^2
cavity of N x N fluid particles surrounded by 3 layers of fixed BVF wall
particles; the lid row is a fixed solid "conveyor belt" with velocity
(U0, 0) and its forces frozen by setforce.  Pair/integrator:
ssa_tsdpd/bvf/transportVelocity.  Re = U0 L / nu, c0 = 10, h = 2.5 dx.

``scene`` builds the cavity from either package's classes, with the
model's pair style or the mechanics one and any ``Scene.pair_style``
keyword (``preshift_window=True``, say); it is in neither registry.
"""

from __future__ import annotations

from sph_bvf_tpu_torch.api.scene import Region, Scene
from sph_bvf_tpu_torch.core.fixes import SetForce


def scene(Scene, Region, SetForce, N: int = 50, Re: float = 100.0,
          U0: float = 1.0, dt: float | None = None, c0: float = 10.0,
          n_wall_layers: int = 3, rebin_every: int = 10,
          ncx_multiple_of: int = 1, cap: int | None = None,
          pair_style: str = "transport_velocity", **pair_kwargs):
    """The cavity as an unbuilt scene of the given package's classes.
    ``pair_style``: "transport_velocity" (the model's) or "mechanics" (the
    mechanics pair style and integrator: the symmetric pressure force and
    XSPH); ``pair_kwargs`` pass on to ``Scene.pair_style``.  Build it with
    ``.build(device=...)`` (the port) or ``.build()`` (the JAX package)."""
    if dt is None:
        # dt = 1e-4 is the reference's value for its N <= 200 configs;
        # finer grids need CFL-scaled steps
        dt = 1e-4 if N <= 200 else 5e-3 / N
    L = 1.0
    nu = U0 * L / Re
    delta = L / N
    wall = n_wall_layers * delta
    h = 2.5 * delta
    rho_f = 1.0
    Lz = delta

    xL0, xL1, xR0, xR1 = -wall, 0.0, L, L + wall
    yB0, yB1, yT0, yT1 = -wall, 0.0, L, L + wall

    sc = Scene(dim=2, boundary=("f", "f", "p"))
    sc.rebin_every = rebin_every
    sc.ncx_multiple_of = ncx_multiple_of
    sc.cap = cap
    sc.create_box(2, Region.block(xL0, xR1, yB0, yT1, 0, Lz))
    sc.lattice("sq", delta)

    # walls: the union of the script's wall regions is everything outside
    # the open cavity
    left = Region.block(xL0, xL1, yB0, yT1, 0, Lz)
    right = Region.block(xR0, xR1, yB0, yT1, 0, Lz)
    bottom = Region.block(xL0, xR1, yB0, yB1, 0, Lz)
    lid = Region.block(xL0, xR1, yT0, yT1, 0, Lz)
    sc.create_atoms(2, left | (right - left) | (bottom - left - right)
                    | (lid - left - right - bottom))
    sc.group_region("lid", lid)

    # fluid (eps offset exactly as the script)
    fluid_region = Region.block(xL1 + 1e-3, xR0, yB1 + 1e-3, yT0, 0, Lz)
    sc.create_atoms(1, fluid_region)
    sc.group_region("fluid", fluid_region)

    # group wall = all - fluid - lid
    wall_members = ~(sc.in_group("fluid") | sc.in_group("lid"))
    sc.group_expr("wall", wall_members)

    n_fluid = int(sc.in_group("fluid").sum())
    n_wall = int(wall_members.sum())
    v_tot = (xR1 - xL0) * (yT1 - yB0)
    v_fluid = xR0 * yT0
    v_wall = v_tot - v_fluid
    m_fluid = v_fluid * rho_f / n_fluid
    m_wall = v_wall * rho_f / n_wall

    sc.mass(1, m_fluid).mass(2, m_wall)
    sc.set("all", rho=rho_f, e=0.0)
    sc.set("wall", solid_tag=1, fixed=True)
    sc.set("lid", solid_tag=1, fixed=True)

    sc.pair_style(pair_style, **pair_kwargs)
    for (i, j) in ((1, 1), (1, 2), (2, 2)):
        sc.pair_coeff(i, j, rho_f, c0, nu, h, h, 0.0)
    sc.integrator(pair_style)

    sc.velocity("lid", vx=U0)
    sc.fix(SetForce(groupbit=sc.groupbit("lid"), fx=0.0, fy=0.0, fz=0.0))

    sc.timestep(dt)
    return sc


def build(N: int = 50, Re: float = 100.0, U0: float = 1.0, dt: float | None = None,
          c0: float = 10.0, n_wall_layers: int = 3, rebin_every: int = 10,
          ncx_multiple_of: int = 1, cap: int | None = None, device=None):
    """Returns (state, params, spec, scene), the state and params on ``device``
    (default: the card).

    ``cap`` overrides the slot capacity (default: density-derived, 14 at
    this lattice)."""
    sc = scene(Scene, Region, SetForce, N=N, Re=Re, U0=U0, dt=dt, c0=c0,
               n_wall_layers=n_wall_layers, rebin_every=rebin_every,
               ncx_multiple_of=ncx_multiple_of, cap=cap)
    state, params, spec = sc.build(device=device)
    return state, params, spec, sc
