"""The PyTorch port's periodic 3D grids against the JAX package.

The spanwise-periodic lid-driven cavity (``models/lid_cavity3d.
spanwise_scene``: the 3D cavity with its y axis periodic) is built by both
packages' ``Scene`` from one scene function at N=12 (6 x 3 x 6 cells, cap
49, a mixed lattice) and held to the JAX package on the CPU: the scene
bitwise; pass A (the plain 27-offset loop, K3's plain version) at f64 to
rtol 1e-9 on three grids (the spanwise cavity, a channel periodic in x and
z, and a fully periodic box around a fixed solid sphere, with one seeded
species and with the thermal rows); the plain 3D walk (K7's plain
version) against both sorts after seeded drifts across every periodic seam
and corner; and 20 steps at f64 and f32.  The refusals that remain raise
by name.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_bvf_tpu.api import scene as jscene
from sph_bvf_tpu.core import fixes as jfixes
from sph_bvf_tpu.core import state as JS
from sph_bvf_tpu.core import stepper as jstepper
from sph_bvf_tpu.ops import pair as jpair
from sph_bvf_tpu_torch import bridge
from sph_bvf_tpu_torch.api import scene as tscene
from sph_bvf_tpu_torch.core import fixes as tfixes
from sph_bvf_tpu_torch.core import rebin_cuda
from sph_bvf_tpu_torch.core import state as TS
from sph_bvf_tpu_torch.core import stepper as tstepper
from sph_bvf_tpu_torch.core.halo import wrap_axes
from sph_bvf_tpu_torch.models import lid_cavity3d as tlid3
from sph_bvf_tpu_torch.ops import pair as tpair
from sph_bvf_tpu_torch.ops import pair_cuda

FIELDS = ("f", "drho", "de", "ddv", "phi", "nw", "num_den", "rhoAux1",
          "rhoAux2", "Q")
# the thermal case's step and PRNG key words (nonzero, so the noise reads
# them from the state), kB and e
STEP, KEY, BOLTZ = 12345, (0xDEADBEEF, 0x12345), 1e-4
# Box-Muller runs in float32 in both packages, and torch's CPU log/cos may
# round up to ULP_BOUND ulps from XLA's: the bound on f that follows
# (tests/test_torch_thermal.py derives it)
ULP_BOUND = 4
G_MAX = math.sqrt(-2.0 * math.log(2.0**-25))
# the cell margin of the channel and the box: with 0.1 h (not the default
# 0.25 h) a periodic axis of 9 spacings takes 3 cells of exactly 3
# spacings, so every cell holds 27 lattice sites and cap is 38; at 0.25 h
# a cell spans 4 spacings on a periodic axis and the box's cap is 86, past
# K7's 64
MARGIN_FRAC = 0.1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (the suite's parallel
    workers' OpenMP pools otherwise starve one another)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax(cls, arrays):
    return cls(**{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                  for k, v in arrays.items()})


def _cast(arrays, dtype):
    return {k: (v.astype(dtype) if isinstance(v, np.ndarray)
                and v.dtype.kind == "f" else v) for k, v in arrays.items()}


def _spanwise(pkg, N=12):
    """The spanwise cavity's scene in ``pkg`` ("jax" or "torch")."""
    if pkg == "jax":
        return tlid3.spanwise_scene(jscene.Scene, jscene.Region,
                                    jfixes.SetForce, N=N)
    return tlid3.spanwise_scene(tscene.Scene, tscene.Region, tfixes.SetForce,
                                N=N)


def _channel_xz(Scene, Region, N=9):
    """A channel periodic in x and z between two fixed walls of three
    layers normal to y, a unit cube of fluid on a simple-cubic lattice of
    N sites per axis; cells of three spacings (27 particles, cap 38)."""
    d = 1.0 / N
    wall = 3 * d
    sc = Scene(dim=3, boundary=("p", "f", "p"))
    sc.margin_frac = MARGIN_FRAC
    sc.create_box(2, Region.block(0.0, 1.0, -wall, 1.0 + wall, 0.0, 1.0))
    sc.lattice("sc", d, origin=(0.5, 0.5, 0.5))
    fluid = Region.block(-np.inf, np.inf, 0.0, 1.0, -np.inf, np.inf)
    sc.create_atoms(1, fluid)
    sc.group_region("fluid", fluid)
    sc.create_atoms(2, ~fluid)
    sc.group_region("walls", ~fluid)
    sc.mass(1, d**3).mass(2, d**3)
    sc.set("all", rho=1.0, e=0.0)
    sc.set("walls", solid_tag=1, fixed=True)
    sc.pair_style("transport_velocity")
    for (i, j) in ((1, 1), (1, 2), (2, 2)):
        sc.pair_coeff(i, j, 1.0, 10.0, 0.01, 2.5 * d, 2.5 * d, 0.0)
    sc.integrator("transport_velocity")
    sc.timestep(1e-4)
    return sc


def _periodic_box(Scene, Region, N=9, ns=0, thermal=False):
    """A fully periodic unit box of fluid around a fixed solid sphere of
    radius 0.25 at its centre, on a simple-cubic lattice of N sites per
    axis (cells of three spacings: 27 particles, cap 38): ``ns`` continuum
    species (kappa 0.012, support cutc = h), the thermal noise on with
    ``thermal`` (e = 1 on every particle)."""
    d = 1.0 / N
    h = 2.5 * d
    sc = Scene(dim=3, n_sdpd=ns, boundary=("p", "p", "p"))
    sc.margin_frac = MARGIN_FRAC
    sc.create_box(2, Region.block(0.0, 1.0, 0.0, 1.0, 0.0, 1.0))
    sc.lattice("sc", d, origin=(0.5, 0.5, 0.5))
    sphere = Region.sphere(0.5, 0.5, 0.5, 0.25)
    sc.create_atoms(1, ~sphere)
    sc.group_region("fluid", ~sphere)
    sc.create_atoms(2, sphere)
    sc.group_region("sphere", sphere)
    sc.mass(1, d**3).mass(2, d**3)
    sc.set("all", rho=1.0, e=1.0 if thermal else 0.0)
    sc.set("sphere", solid_tag=1, fixed=True)
    sc.pair_style("transport_velocity", thermal=thermal)
    for (i, j) in ((1, 1), (1, 2), (2, 2)):
        sc.pair_coeff(i, j, 1.0, 10.0, 0.01, h, h, 0.0, kappa=(0.012,) * ns)
    sc.integrator("transport_velocity")
    sc.timestep(1e-4)
    return sc


GRIDS = {
    "spanwise": lambda pkg: _spanwise(pkg),
    "channel_xz": lambda pkg: _channel_xz(*_classes(pkg)),
    "box_species": lambda pkg: _periodic_box(*_classes(pkg), ns=1),
    "box_thermal": lambda pkg: _periodic_box(*_classes(pkg), thermal=True),
}


def _classes(pkg):
    mod = jscene if pkg == "jax" else tscene
    return mod.Scene, mod.Region


def _built(grid):
    """(JAX state, params, spec) of ``grid`` built by the JAX package,
    with the port's build of the same scene checked equal to it."""
    js, jp, jspec = GRIDS[grid]("jax").build()
    ts, tp, tspec = GRIDS[grid]("torch").build(device="cpu")
    assert dataclasses.asdict(tspec.geom) == dataclasses.asdict(jspec.geom)
    a, b = bridge.to_numpy(js), bridge.state_from_port(ts)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    return js, jp, jspec


def test_spanwise_scene_matches_jax():
    """The spanwise cavity built from one scene function by both packages'
    Scene: geometry, configs, params and every state leaf bitwise; y
    periodic with 3 cells, a mixed lattice (base_occ 0), cap 49, 3,888
    particles, and the grid routes to K3 and K7."""
    js, jp, jspec = _spanwise("jax").build()
    ts, tp, tspec = _spanwise("torch").build(device="cpu")
    g = tspec.geom
    assert dataclasses.asdict(g) == dataclasses.asdict(jspec.geom)
    assert g.periodic == (False, True, False) and g.ncells == (6, 3, 6)
    assert g.cap == 49 and g.base_occ == 0
    assert wrap_axes(g) == (False, True, False)
    for part in ("pair", "integ"):
        assert (dataclasses.asdict(getattr(tspec, part))
                == dataclasses.asdict(getattr(jspec, part)))
    assert [dataclasses.asdict(f) for f in tspec.fixes] == \
        [dataclasses.asdict(f) for f in jspec.fixes]
    assert int(ts.n_valid) == int(js.n_valid) == 3888
    a, b = bridge.to_numpy(js), bridge.state_from_port(ts)
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    pa, pb = bridge.to_numpy(jp), bridge.to_numpy(tp)
    for name in pa:
        np.testing.assert_array_equal(pa[name], pb[name], err_msg=name)
    # the bridge carries the periodic geometry unchanged
    assert bridge.spec_to_port(jspec).geom == g
    assert pair_cuda.route(g, tspec.pair) is pair_cuda.pass_a_3d
    assert pair_cuda.kernel_unsupported(g, tspec.pair) == []
    assert rebin_cuda.move_route(g) is rebin_cuda.rebin_move_3d
    # the same scene through the port's entry point
    bs, _, bspec, _ = tlid3.build_spanwise(12, device="cpu")
    assert bspec.geom == g and torch.equal(bs.x, ts.x)


def _perturbed(grid, dtype):
    """``grid`` built by the JAX package, with seeded noise
    on x (a tenth of a spacing), v, vest and rho (and rhoI), one species'
    C drawn from [0, 1) and, for the thermal box, the step and key of the
    parity state: numpy in ``dtype``, with the JAX params and spec."""
    js, jp, jspec = _built(grid)
    s = bridge.to_numpy(js)
    rng = np.random.default_rng(7)
    valid = s["valid"]
    d = jspec.geom.cell_size[0] / 3.0  # the lattice spacing (3 per cell here)
    s["x"] = s["x"] + np.where(valid, rng.uniform(-0.1, 0.1, s["x"].shape) * d, 0.0)
    s["v"] = s["v"] + np.where(valid, rng.normal(0, 0.05, s["v"].shape), 0.0)
    s["vest"] = s["v"] + np.where(valid, rng.normal(0, 0.01, s["v"].shape), 0.0)
    s["rho"] = np.where(valid, rng.uniform(0.99, 1.01, valid.shape), 1.0)
    s["rhoI"] = np.where(valid, s["rho"] + rng.normal(0, 1e-3, valid.shape), 1.0)
    if s["C"].shape[0]:
        s["C"] = np.where(valid, rng.uniform(0.0, 1.0, s["C"].shape), 0.0)
    s["dt"] = np.asarray(1e-4, s["dt"].dtype)  # what setup would set
    s["step"] = np.asarray(STEP, np.int32)
    s["key"] = np.asarray(KEY, np.uint32)
    p = bridge.to_numpy(jp)
    if jspec.pair.thermal:
        p["boltz"] = BOLTZ
    return _cast(s, dtype), _cast(p, dtype), jspec


def _l1_scale(state, params, geom, cfg):
    """T_i = sum_j pref_ij |dx_ij|_1 over the pairs whose random force i
    sums, as [cap, NC]: the port's pass A with the random force replaced by
    pref |dx|_1, less the pass A without it."""
    def l1(I, J, dx, r, h, wfd, params, cfg, dt, step, seed):
        pref = tpair._thermal_prefactor(I, J, r, h, wfd, params, dt)
        return (pref * sum(dx[k].abs() for k in range(cfg.dim)))[None].expand(
            (3,) + tuple(r.shape))

    off = tpair.compute_forces(state, params, geom,
                               dataclasses.replace(cfg, thermal=False)).f
    real = tpair._thermal_force
    tpair._thermal_force = l1
    try:
        on = tpair.compute_forces(state, params, geom, cfg).f
    finally:
        tpair._thermal_force = real
    return (on - off)[0].abs()


@pytest.mark.parametrize("grid, filt", [
    ("spanwise", True), ("channel_xz", False), ("box_species", True),
    ("box_thermal", False)], ids=["spanwise-filter", "channel_xz-nofilter",
                                  "box_species-filter", "box_thermal-nofilter"])
def test_pass_a_matches_jax(grid, filt):
    """One force evaluation at f64, the port's plain 27-offset pass A
    against the JAX jnp path on the same inputs: every field to rtol 1e-9
    (f, with the thermal rows, within that plus the bound the normals'
    float32 ulps imply).  The grid routes to K3, which serves it; pairs
    across the seams are live (the wrapped cells' forces differ from the
    same pass with the axes made walls)."""
    s, p, jspec = _perturbed(grid, np.float64)
    cfg = dataclasses.replace(jspec.pair, density_filter_accs=filt,
                              use_pallas=False)
    jparams = _jax(JS.Params, p)
    ref = bridge.to_numpy(jpair.compute_forces(_jax(JS.State, s), jparams,
                                               jspec.geom, cfg))
    tspec = bridge.spec_to_port(jspec)
    tcfg = bridge._plain(tpair.PairConfig, cfg)
    st = bridge.state_to_port(s, device="cpu")
    tp = bridge.params_to_port(jparams, device="cpu")
    assert pair_cuda.route(tspec.geom, tcfg) is pair_cuda.pass_a_3d
    assert pair_cuda.kernel_unsupported(tspec.geom, tcfg,
                                        n_sdpd=tp.n_sdpd) == []
    got = bridge.state_from_port(tpair.compute_forces(st, tp, tspec.geom, tcfg))
    bound = 0.0
    if cfg.thermal:
        l1 = _l1_scale(st, tp, tspec.geom, tcfg).numpy()
        bound = (2 * ULP_BOUND + 8) * 2.0**-23 * G_MAX * l1
    for name in FIELDS:
        a, b = ref[name], got[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        scale = max(float(np.abs(a).max(initial=0.0)), 1e-30)
        tol = 1e-9 * np.abs(a) + 1e-11 * scale + (bound if name == "f" else 0.0)
        assert (np.abs(b - a) <= tol).all(), (name, float(np.abs(b - a).max()))
    if tp.n_sdpd:
        assert float(np.abs(got["Q"]).max()) > 0
    walls = dataclasses.replace(tspec.geom, periodic=(False, False, False))
    shut = tpair.compute_forces(st, tp, walls, tcfg).f.numpy()
    assert float(np.abs(shut - got["f"]).max()) > 1e-3 * float(
        np.abs(got["f"]).max())


def _seam_drift(s, g, seed):
    """``s`` (numpy) with every valid particle moved by a seeded step of up
    to 0.9 cells per axis, and outward along every periodic axis in the
    corner cells (those at an end of each periodic axis), so particles
    cross every periodic face and corner; positions beyond the box stay
    unwrapped, as between two rebins.  Returns the state and the count of
    particles beyond each periodic face and beyond a corner."""
    rng = np.random.default_rng(seed)
    x, valid = s["x"], s["valid"]
    d = rng.uniform(-0.9, 0.9, x.shape) * np.asarray(g.cell_size)[:, None, None]
    c = np.broadcast_to(np.arange(g.ncells_total), valid.shape)
    coord = [(c // g.strides[ax]) % g.ncells[ax] for ax in range(3)]
    axes = [ax for ax in range(3) if g.periodic[ax]]
    corner = np.ones(valid.shape, bool)
    for ax in axes:
        corner &= (coord[ax] == 0) | (coord[ax] == g.ncells[ax] - 1)
    for ax in axes:
        out = np.where(coord[ax] == 0, -1.0, 1.0) * np.abs(d[ax])
        d[ax] = np.where(corner, out, d[ax])
    s = dict(s, x=x + np.where(valid, d, 0.0))
    beyond = {}
    for ax in axes:
        lo, hi = s["x"][ax] < g.lo[ax], s["x"][ax] >= g.hi[ax]
        beyond["xyz"[ax] + "-"] = int((valid & lo).sum())
        beyond["xyz"[ax] + "+"] = int((valid & hi).sum())
    past = np.ones(valid.shape, bool)
    for ax in axes:
        past &= (s["x"][ax] < g.lo[ax]) | (s["x"][ax] >= g.hi[ax])
    beyond["corner"] = int((valid & past).sum())
    return s, beyond


@pytest.mark.parametrize("grid", ["spanwise", "channel_xz", "box_species"])
def test_walk_matches_both_sorts(grid):
    """The port's plain 3D walk (``state.rebin(use_kernel=True)`` on the
    CPU, K7's plain version) after a seeded drift across every periodic
    seam and corner, against the port's sort rebin and the JAX package's:
    every leaf bitwise, the drift count included."""
    js, jp, jspec = _built(grid)
    g = jspec.geom
    s, beyond = _seam_drift(bridge.to_numpy(js), g, seed=3)
    assert min(beyond.values()) > 0, beyond
    s = _cast(s, np.float32)
    tg = TS.Geometry(**dataclasses.asdict(g))
    assert rebin_cuda.move_route(tg) is rebin_cuda.rebin_move_3d
    ref = bridge.to_numpy(JS.rebin(_jax(JS.State, s), g, use_pallas=False))
    walk = bridge.state_from_port(
        TS.rebin(bridge.state_to_port(s, device="cpu"), tg, use_kernel=True))
    sort = bridge.state_from_port(
        TS.rebin(bridge.state_to_port(s, device="cpu"), tg, use_kernel=False))
    for name in ref:
        np.testing.assert_array_equal(walk[name], ref[name], err_msg=name)
        np.testing.assert_array_equal(sort[name], ref[name], err_msg=name)
    # every particle is placed or counted: the corner pushes crowd some
    # cells past cap
    assert int(walk["drift_violation"]) > 100
    assert (int(walk["valid"].sum()) + int(walk["overflow"])
            == int(s["valid"].sum()))
    # every position is back in the box on the periodic axes
    for ax in range(3):
        if g.periodic[ax]:
            xs = walk["x"][ax][walk["valid"]]
            assert xs.min() >= g.lo[ax] and xs.max() <= g.hi[ax]


def _v_y_ratio(state) -> float:
    """max|v_y| / max|v| over the valid particles (numpy state)."""
    v = state["v"][:, state["valid"]]
    return float(np.abs(v[1]).max() / np.sqrt((v * v).sum(0)).max())


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_spanwise_steps_match_jax(dt):
    """20 steps of the N=12 spanwise cavity from identical inputs (a rebin
    at setup and before each of two chunks, the Shepard filter at step 20).
    At f64: x, v and rho within 1e-8 of the JAX package's, the slot
    assignment (tag, valid) bitwise.  At f32: the flow stays spanwise-
    invariant as in JAX, max|v_y| / max|v| within 10x JAX's own value."""
    dtype = np.float64 if dt == "f64" else np.float32
    js, jp, jspec = _spanwise("jax").build()
    sa = _cast(bridge.to_numpy(js), dtype)
    pa = _cast(bridge.to_numpy(jp), dtype)
    js, jp = _jax(type(js), sa), _jax(type(jp), pa)
    ts = bridge.state_to_port(sa, device="cpu")
    tp = bridge.params_to_port(jp, device="cpu")
    tspec = bridge.spec_to_port(jspec)
    assert tspec.integ.freq_filter == 20 and tspec.rebin_every == 10

    js = jstepper.simulate(jstepper.setup(js, jp, jspec, dt=1e-4), jp, jspec, 20)
    ts = tstepper.simulate(tstepper.setup(ts, tp, tspec, dt=1e-4), tp, tspec, 20)
    a, b = bridge.to_numpy(js), bridge.state_from_port(ts)
    assert int(a["step"]) == int(b["step"]) == 20
    assert int(b["overflow"]) == 0 and int(b["drift_violation"]) == 0
    fluid = b["valid"] & (b["solid_tag"] == 0)
    assert float(np.abs(b["v"][:, fluid]).max()) > 1e-3  # the lid drives
    if dt == "f64":
        np.testing.assert_array_equal(a["tag"], b["tag"])
        np.testing.assert_array_equal(a["valid"], b["valid"])
        for name in ("x", "v", "rho"):
            np.testing.assert_allclose(b[name], a[name], rtol=0, atol=1e-8,
                                       err_msg=name)
    else:
        ours, theirs = _v_y_ratio(b), _v_y_ratio(a)
        assert ours <= 10 * theirs, (ours, theirs)


def test_remaining_refusals_raise_by_name():
    """What K1, K3 and K7 still refuse raises NotImplementedError at the
    launch check and names it: a periodic axis of two cells on K1 (which
    serves the flattened grid itself), a periodic 3D axis of two cells on K3
    and K7, with or without non-uniform x columns (and the rebin on a CUDA
    state says which); K7 serves x columns with a periodic axis, and K3 a
    solid-free scene, on the same grid."""
    s, p, jspec = _perturbed("spanwise", np.float32)
    tspec = bridge.spec_to_port(jspec)
    st = bridge.state_to_port(s, device="cpu")
    tp = bridge.params_to_port(_jax(JS.Params, p), device="cpu")
    g, cfg = tspec.geom, tspec.pair
    pf = tpair._per_particle(st, tp, cfg)
    pair_cuda._check_launch(pf, tp, g, cfg, pair_cuda.pass_a_3d)
    flat = dataclasses.replace(g, dim=2, ncells=(g.ncells[0], g.ncells[1] * g.ncells[2], 1))
    cfg2 = dataclasses.replace(cfg, dim=2)
    pair_cuda._check_launch(pf, tp, flat, cfg2, pair_cuda.pass_a_2d)
    narrow = dataclasses.replace(flat, ncells=(g.ncells_total // 2, 2, 1))
    with pytest.raises(NotImplementedError,
                       match="a periodic y axis with fewer than 3 cells"):
        pair_cuda._check_launch(pf, tp, narrow, cfg2, pair_cuda.pass_a_2d)
    pair_cuda._check_launch(
        pf, tp, g, dataclasses.replace(cfg, solids_present=False),
        pair_cuda.pass_a_3d)
    two = dataclasses.replace(g, periodic=(True, True, False),
                              ncells=(2, g.ncells[1], g.ncells[2] * 3))
    assert pair_cuda.kernel_unsupported(two, cfg) == [
        "a periodic x axis with fewer than 3 cells"]
    assert rebin_cuda.move_unsupported(two, rebin_cuda.rebin_move_3d) == [
        "a periodic x axis with fewer than 3 cells"]
    assert rebin_cuda.move_route(two) is None

    fields = TS.particle_fields(st)
    PF, PI, _, _ = rebin_cuda._pack_fields(fields, g.cap, g.ncells_total)
    rebin_cuda._check_packs(PF, PI, g, rebin_cuda.rebin_move_3d)
    nx = g.ncells[0]
    edges = tuple(g.lo[0] + i * g.cell_size[0] for i in range(nx + 1))
    edged = dataclasses.replace(g, x_edges=edges, x_quantum=g.cell_size[0])
    assert rebin_cuda.move_route(edged) is rebin_cuda.rebin_move_3d
    rebin_cuda._check_packs(PF, PI, edged, rebin_cuda.rebin_move_3d)
    narrow_y = dataclasses.replace(edged, ncells=(nx, 2, g.ncells_total // (2 * nx)))
    assert rebin_cuda.move_route(narrow_y) is None
    with pytest.raises(NotImplementedError,
                       match="a periodic y axis with fewer than 3 cells"):
        rebin_cuda._check_packs(PF, PI, narrow_y, rebin_cuda.rebin_move_3d)
    assert "a periodic y axis" in rebin_cuda.move_refusal(narrow_y)
    # walls on every axis keep the edged K7
    assert rebin_cuda.move_route(dataclasses.replace(
        edged, periodic=(False, False, False))) is rebin_cuda.rebin_move_3d
