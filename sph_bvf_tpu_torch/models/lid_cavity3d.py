"""3D lid-driven cavity — the 2D flagship example extruded to [0,1]^3 (PyTorch).

Port of ``sph_bvf_tpu/models/lid_cavity3d.py``, line for line: the same
construction as ``models/lid_cavity.py`` with a simple-cubic lattice, six
face-inclusive wall slabs, and the top slab (z > L) driven at (U0, 0, 0).
It is the scale demonstrator for 3D: 27-cell stencils in the pass-A kernel
(K3, ``csrc/pass_a_3d.cu``) and the locality rebin (K7,
``csrc/rebin_move_3d.cu``); N=100 holds 1.19M particles.

``spanwise_scene`` is the same cavity with its spanwise axis (y) periodic:
the textbook spanwise-periodic cavity, in the Scene calls of either
package (it takes their ``Scene``, ``Region`` and ``SetForce`` classes, so
the JAX package builds the very same scene; neither package lists it in
its model registry).  It carries K3's and K7's periodic branches; N=100
holds 1,123,600 particles.
"""

from __future__ import annotations

from sph_bvf_tpu_torch.api.scene import Region, Scene
from sph_bvf_tpu_torch.core.fixes import SetForce


def build(N: int = 50, Re: float = 100.0, U0: float = 1.0,
          dt: float | None = None, c0: float = 10.0, n_wall_layers: int = 3,
          rebin_every: int = 10, device=None):
    """Returns (state, params, spec, scene), the state and params on ``device``
    (default: the card).  N is particles per axis."""
    if dt is None:
        dt = 1e-4 if N <= 200 else 5e-3 / N
    L = 1.0
    nu = U0 * L / Re
    delta = L / N
    wall = n_wall_layers * delta
    h = 2.5 * delta
    rho_f = 1.0

    lo, hi = -wall, L + wall

    sc = Scene(dim=3, boundary=("f", "f", "f"))
    sc.rebin_every = rebin_every
    sc.create_box(2, Region.block(lo, hi, lo, hi, lo, hi))
    # half-spacing origin on all axes: a z origin of 0 would put lattice
    # planes exactly on the cavity faces z = 0, L
    sc.lattice("sc", delta, origin=(0.5, 0.5, 0.5))

    # six face-inclusive wall slabs; the union selects each site once
    left = Region.block(lo, 0.0, lo, hi, lo, hi)
    right = Region.block(L, hi, lo, hi, lo, hi)
    front = Region.block(lo, hi, lo, 0.0, lo, hi)
    back = Region.block(lo, hi, L, hi, lo, hi)
    bottom = Region.block(lo, hi, lo, hi, lo, 0.0)
    lid = Region.block(lo, hi, lo, hi, L, hi)  # top slab (z > L) drives
    sc.create_atoms(2, left | right | front | back | bottom | lid)
    sc.group_region("lid", lid)

    eps = 1e-3 * delta
    fluid_region = Region.block(eps, L, eps, L, eps, L)
    sc.create_atoms(1, fluid_region)
    sc.group_region("fluid", fluid_region)

    wall_members = ~(sc.in_group("fluid") | sc.in_group("lid"))
    sc.group_expr("wall", wall_members)

    n_fluid = int(sc.in_group("fluid").sum())
    n_walls = int((~sc.in_group("fluid")).sum())
    v_tot = (hi - lo) ** 3
    v_fluid = L ** 3
    m_fluid = v_fluid * rho_f / n_fluid
    m_wall = (v_tot - v_fluid) * rho_f / n_walls

    sc.mass(1, m_fluid).mass(2, m_wall)
    sc.set("all", rho=rho_f, e=0.0)
    sc.set("wall", solid_tag=1, fixed=True)
    sc.set("lid", solid_tag=1, fixed=True)

    sc.pair_style("transport_velocity")
    for (i, j) in ((1, 1), (1, 2), (2, 2)):
        sc.pair_coeff(i, j, rho_f, c0, nu, h, h, 0.0)
    sc.integrator("transport_velocity")

    sc.velocity("lid", vx=U0)
    sc.fix(SetForce(groupbit=sc.groupbit("lid"), fx=0.0, fy=0.0, fz=0.0))

    sc.timestep(dt)
    state, params, spec = sc.build(device=device)
    return state, params, spec, sc


def spanwise_scene(Scene, Region, SetForce, N: int = 50, Re: float = 100.0,
                   U0: float = 1.0, dt: float | None = None, c0: float = 10.0,
                   n_wall_layers: int = 3, rebin_every: int = 10):
    """The cavity of ``build`` with a periodic y axis, as an unbuilt scene
    of the given package's classes: the box is [lo, hi] x [0, L] x [lo, hi],
    the front and back wall slabs are gone, and the other three slabs, the
    driven top slab, Re, c0 and the dt rule are ``build``'s.  Build it with
    ``.build(device=...)`` (the port) or ``.build()`` (the JAX package)."""
    if dt is None:
        dt = 1e-4 if N <= 200 else 5e-3 / N
    L = 1.0
    nu = U0 * L / Re
    delta = L / N
    wall = n_wall_layers * delta
    h = 2.5 * delta
    rho_f = 1.0

    lo, hi = -wall, L + wall

    sc = Scene(dim=3, boundary=("f", "p", "f"))
    sc.rebin_every = rebin_every
    sc.create_box(2, Region.block(lo, hi, 0.0, L, lo, hi))
    # the half-spacing origin puts N lattice planes in [0, L) along y, one
    # spacing apart across the seam too
    sc.lattice("sc", delta, origin=(0.5, 0.5, 0.5))

    left = Region.block(lo, 0.0, lo, hi, lo, hi)
    right = Region.block(L, hi, lo, hi, lo, hi)
    bottom = Region.block(lo, hi, lo, hi, lo, 0.0)
    lid = Region.block(lo, hi, lo, hi, L, hi)
    sc.create_atoms(2, left | right | bottom | lid)
    sc.group_region("lid", lid)

    eps = 1e-3 * delta
    fluid_region = Region.block(eps, L, eps, L, eps, L)
    sc.create_atoms(1, fluid_region)
    sc.group_region("fluid", fluid_region)

    wall_members = ~(sc.in_group("fluid") | sc.in_group("lid"))
    sc.group_expr("wall", wall_members)

    n_fluid = int(sc.in_group("fluid").sum())
    n_walls = int((~sc.in_group("fluid")).sum())
    v_tot = (hi - lo) ** 2 * L
    v_fluid = L ** 3
    m_fluid = v_fluid * rho_f / n_fluid
    m_wall = (v_tot - v_fluid) * rho_f / n_walls

    sc.mass(1, m_fluid).mass(2, m_wall)
    sc.set("all", rho=rho_f, e=0.0)
    sc.set("wall", solid_tag=1, fixed=True)
    sc.set("lid", solid_tag=1, fixed=True)

    sc.pair_style("transport_velocity")
    for (i, j) in ((1, 1), (1, 2), (2, 2)):
        sc.pair_coeff(i, j, rho_f, c0, nu, h, h, 0.0)
    sc.integrator("transport_velocity")

    sc.velocity("lid", vx=U0)
    sc.fix(SetForce(groupbit=sc.groupbit("lid"), fx=0.0, fy=0.0, fz=0.0))

    sc.timestep(dt)
    return sc


def build_spanwise(N: int = 50, device=None, **kw):
    """``spanwise_scene`` with the port's classes, built: (state, params,
    spec, scene) on ``device`` (default: the card)."""
    sc = spanwise_scene(Scene, Region, SetForce, N=N, **kw)
    state, params, spec = sc.build(device=device)
    return state, params, spec, sc
