"""The rest of K3's physics in the PyTorch port, against the JAX package.

Two 3D scenes that no model of either registry builds, each a ``Scene``
function that both packages run: the spanwise-periodic 3D FSI beam
(``models/fsi.scene`` with ``nz_cells``: the paper's beam in a channel extruded
along a periodic z axis; the mechanics pair style, XSPH, a free elastic
beam on a 0.6x finer lattice, fixed walls, the two sponges) and the triply
periodic 3D Taylor-Green vortex (``models/taylor_green3d.scene``:
solid-free, transport-velocity).  K3 (``csrc/pass_a_3d.cu``) serves both
and K7 (``csrc/rebin_move_3d.cu``) takes their caps past 64; the kernels
run on a card only, so here their plain versions (the port's 27-offset
pass A and its 3D rebin walk) are held to the JAX package on the CPU:

- the scenes built bitwise by both packages, and the routes (K3 serves
  the 3D FSI, its fsi-style variant with a species and the vortex; K1
  still refuses each by name);
- pass A at f64 to rtol 1e-9 on every accumulator, dS, ddx and phi/nw
  included, against JAX's jnp path;
- steps at f64 within 1e-8 across the beam's release, and of the vortex;
- the walk against both sorts at caps 86 and 119, bitwise.

The plain pass A walks [cap, cap, NC] blocks per offset, ~100 s a call at
the 3D FSI's nx=12 (cap 119) on one thread, so the numerics run on a
miniature of the same scene (``_mini_beam``: the channel shrunk, h = 2
fluid spacings; the same pair, integrator, fixes and mixed lattice, a beam
of two columns, 3 periodic z cells) and on the vortex at N=12 with cells of
three spacings (cap 38).
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
from sph_bvf_tpu_torch.models import fsi as tfsi
from sph_bvf_tpu_torch.models import taylor_green3d as ttg
from sph_bvf_tpu_torch.ops import pair as tpair
from sph_bvf_tpu_torch.ops import pair_cuda

FIELDS = ("f", "drho", "de", "ddv", "ddx", "dS", "phi", "nw", "num_den",
          "rhoAux1", "rhoAux2", "Q")


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


def _classes(pkg):
    """(Scene, Region, Buffer) of ``pkg`` ("jax" or "torch")."""
    if pkg == "jax":
        return jscene.Scene, jscene.Region, jfixes.Buffer
    return tscene.Scene, tscene.Region, tfixes.Buffer


def _mini_beam(Scene, Region, Buffer, pair_style="mechanics", kappa=None,
               tdamp_solid=2):
    """A miniature of ``fsi.scene`` extruded: the same materials, pair
    style, integrator and sponges in a channel of 8 x 4 fluid spacings
    (10 um; periodic x, three wall layers on y), h = 2 spacings, cells of at
    least 1.1 h (the cell margin 0.1 h), z periodic over 3 cells of 1.15 h,
    a free elastic beam of two columns on a 0.6x finer lattice rooted in
    the bottom wall, and the release at step ``tdamp_solid``.  3 x 4 x 3
    cells."""
    df = 10e-6
    db = 0.6 * df
    rho_f, rho_b, vo, nu, E, Pratio = 1000.0, 7850.0, 0.0333, 1e-3, 2e5, 0.33
    h = 2.0 * df
    Lx0, Lx1, Ly = -2 * df, 6 * df, 4 * df
    wallT = 3 * df
    yB0, yT1 = -wallT, Ly + wallT
    Lz = 3 * 1.15 * h
    bx0, bx1, by1 = 2 * df, 2 * df + 2 * db, Ly / 2
    G = E / (2.0 * (1.0 + Pratio))
    K = E / (3.0 * (1.0 - 2.0 * Pratio))
    c0b, c0f = math.sqrt(K / rho_b), 10.0 * vo

    sc = Scene(dim=3, n_sdpd=0 if kappa is None else 1,
               boundary=("p", "f", "p"))
    sc.rebin_every = 4
    sc.margin_frac = 0.1
    sc.create_box(3, Region.block(Lx0, Lx1, yB0, yT1, 0, Lz))
    sc.lattice("sc", df, origin=(0.5, 0.5, 0.5))
    beam = Region.block(bx0, bx1, yB0, by1, 0, Lz)
    fluid = Region.block(Lx0, Lx1, 0.0, Ly, 0, Lz)
    walls = (Region.block(Lx0, Lx1, yB0, 0.0, 0, Lz)
             | Region.block(Lx0, Lx1, Ly, yT1, 0, Lz))
    sc.create_atoms(1, fluid - walls - beam)
    sc.create_atoms(3, walls - beam)
    sc.lattice("sc", db, origin=(0.5, 0.5, 0.5))
    sc.create_atoms(2, beam)
    sc.group_region("walls", walls)
    sc.group_region("beam", beam)
    sc.group_expr("fluid", ~(sc.in_group("walls") | sc.in_group("beam")))
    sc.mass(1, rho_f * df**3).mass(2, rho_b * db**3).mass(3, rho_f * df**3)
    sc.set("fluid", rho=rho_f)
    sc.set("walls", rho=rho_f)
    sc.set("beam", rho=rho_b)
    sc.set("all", e=0.0)
    sc.set("beam", solid_tag=1, fixed=False)
    sc.set("walls", solid_tag=1, fixed=True)
    sc.pair_style(pair_style)
    k = () if kappa is None else (kappa,)
    for (i, j, rho, c0, g) in ((1, 1, rho_f, c0f, 0.0), (1, 2, rho_f, c0f, 0.0),
                               (1, 3, rho_f, c0f, 0.0), (2, 2, rho_b, c0b, G),
                               (2, 3, rho_b, c0b, G), (3, 3, rho_f, c0f, 0.0)):
        sc.pair_coeff(i, j, rho, c0, nu, h, h, g, kappa=k)
    sc.integrator("mechanics", tdamp_solid=tdamp_solid)
    for comp, val in ((0, vo), (1, 0.0)):
        sc.fix(Buffer(groupbit=sc.groupbit("fluid"), field="velocity",
                      direction="x", index=comp, center=(-df, Ly / 2),
                      length=df, width=Ly / 2, value=val, after_step=1))
    sc.timestep(1e-8)
    return sc


def _vortex(Scene, Region, N=12, margin_frac=0.1):
    """The Taylor-Green vortex's scene at N, with cells of three spacings
    at the cell margin 0.1 h (cap 38) or of four at the default 0.25 h
    (cap 86)."""
    sc = ttg.scene(Scene, Region, N=N)
    sc.margin_frac = margin_frac
    return sc


SCENES = {
    "beam": lambda pkg: _mini_beam(*_classes(pkg)),
    "beam_fsi": lambda pkg: _mini_beam(*_classes(pkg), pair_style="fsi",
                                       kappa=1e-5),
    "vortex": lambda pkg: _vortex(*_classes(pkg)[:2]),
}
# their time steps: the FSI's, and the vortex's default 0.1 h / c0
DT = {"beam": 1e-8, "beam_fsi": 1e-8, "vortex": 0.1 * 2.5 * (ttg.L / 12) / 10.0}


def _tg_velocity(s):
    """``ttg.taylor_green_velocity`` in numpy on a numpy state."""
    x, y, z = s["x"]
    v = np.stack([np.sin(x) * np.cos(y) * np.cos(z),
                  -np.cos(x) * np.sin(y) * np.cos(z), np.zeros_like(x)])
    return dict(s, v=np.where(s["valid"], v, 0.0).astype(s["x"].dtype))


def _built(name):
    """(JAX state, params, spec) of scene ``name`` built by the JAX package,
    with the port's build of the same scene checked equal to it (the
    vortex with its velocity, set in numpy on the JAX state)."""
    js, jp, jspec = SCENES[name]("jax").build()
    ts, tp, tspec = SCENES[name]("torch").build(device="cpu")
    assert dataclasses.asdict(tspec.geom) == dataclasses.asdict(jspec.geom)
    for part in ("pair", "integ"):
        assert (dataclasses.asdict(getattr(tspec, part))
                == dataclasses.asdict(getattr(jspec, part)))
    a, b = bridge.to_numpy(js), bridge.state_from_port(ts)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    if name == "vortex":
        a = _tg_velocity(a)
        np.testing.assert_allclose(
            bridge.state_from_port(ttg.taylor_green_velocity(ts))["v"], a["v"],
            rtol=0, atol=1e-6)
        js = _jax(JS.State, a)
    return js, jp, jspec


def test_spanwise_fsi_scene_matches_jax_and_routes_to_k3():
    """The 3D FSI beam at nx=12 built from one scene function by both
    packages' Scene, bitwise: (11, 5, 3) cells, x and z periodic, cap 119
    (past K7's former 64), a mixed lattice, 9,264 particles; K3 serves it
    and its fsi-style variant with one species (K7 moves both), and K1
    serves the same physics on a 2D grid of these cells."""
    for kw in ({}, dict(pair_style="fsi", kappa=1e-5)):
        js, jp, jspec = tfsi.scene(*_classes("jax"), nx=12, nz_cells=3,
                                       **kw).build()
        ts, tp, tspec = tfsi.scene(*_classes("torch"), nx=12, nz_cells=3,
                                    **kw).build(device="cpu")
        g = tspec.geom
        assert dataclasses.asdict(g) == dataclasses.asdict(jspec.geom)
        assert (dataclasses.asdict(tspec.pair)
                == dataclasses.asdict(jspec.pair))
        assert g.ncells == (11, 5, 3) and g.cap == 119 and g.base_occ == 0
        assert g.periodic == (True, False, True)
        assert int(ts.n_valid) == int(js.n_valid) == 9264
        a, b = bridge.to_numpy(js), bridge.state_from_port(ts)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        cfg = tspec.pair
        assert (cfg.elastic_present and cfg.free_solids_present and cfg.xsph
                and not cfg.pressure_switch)
        assert pair_cuda.route(g, cfg) is pair_cuda.pass_a_3d
        assert pair_cuda.kernel_unsupported(g, cfg, pair_cuda.pass_a_3d,
                                            n_sdpd=tp.n_sdpd) == []
        assert rebin_cuda.move_route(g) is rebin_cuda.rebin_move_3d
        flat = dataclasses.replace(g, dim=2, ncells=(11, 15, 1))
        refused = pair_cuda.kernel_unsupported(
            flat, dataclasses.replace(cfg, dim=2), pair_cuda.pass_a_2d,
            n_sdpd=tp.n_sdpd)
        if kw:
            assert tp.n_sdpd == 1 and cfg.g0_chem_coupling
        assert refused == []
    bs, _, bspec, _ = tfsi.build_spanwise(12, device="cpu")
    assert bspec.geom == g and torch.equal(bs.x, ts.x)


def test_taylor_green_scene_matches_jax_and_routes_to_k3():
    """The vortex at N=12 built by both packages, bitwise (1,728 particles,
    3 x 3 x 3 cells of cap 86 at the default margin), solid-free, the
    velocity field set on the valid slots; K3 and K7 serve it, and K1
    serves its periodic axes and its solid-free pair on a 2D grid."""
    js, jp, jspec = ttg.scene(*_classes("jax")[:2], N=12).build()
    ts, tp, tspec, _ = ttg.build(12, device="cpu")
    g, cfg = tspec.geom, tspec.pair
    assert dataclasses.asdict(g) == dataclasses.asdict(jspec.geom)
    assert g.ncells == (3, 3, 3) and g.cap == 86 and g.base_occ == 0
    assert g.periodic == (True, True, True) and not cfg.solids_present
    a, b = _tg_velocity(bridge.to_numpy(js)), bridge.state_from_port(ts)
    for key in a:
        if key != "v":
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    np.testing.assert_allclose(b["v"], a["v"], rtol=0, atol=1e-6)
    assert float(np.abs(b["v"][:, ~b["valid"]]).max(initial=0.0)) == 0.0
    # E0 = rho0 (2 pi)^3 / 8 with U0 = 1, to the lattice's quadrature
    assert abs(ttg.kinetic_energy(ts, tp) / (math.pi**3) - 1.0) < 1e-5
    assert pair_cuda.route(g, cfg) is pair_cuda.pass_a_3d
    assert pair_cuda.kernel_unsupported(g, cfg, pair_cuda.pass_a_3d) == []
    assert rebin_cuda.move_route(g) is rebin_cuda.rebin_move_3d
    flat = dataclasses.replace(g, dim=2, ncells=(3, 9, 1))
    assert pair_cuda.kernel_unsupported(
        flat, dataclasses.replace(cfg, dim=2), pair_cuda.pass_a_2d) == []


def _live(name, dtype):
    """Scene ``name`` built by the JAX package, with every pair term live:
    seeded noise (numpy) on x (a tenth of a fluid spacing), v, vest, rho
    and rhoI; on the beam a symmetric S (up to ~3e3) and, with a species,
    C up to 1.5 (a softened modulus below zero) and a tenth of that
    elsewhere.  Numpy in ``dtype``, with the JAX params and spec."""
    js, jp, jspec = _built(name)
    s = bridge.to_numpy(js)
    rng = np.random.default_rng(11)
    valid = s["valid"]
    g = jspec.geom
    d = g.cell_size[2] / (2.3 if name != "vortex" else 3.0)  # a spacing
    s["x"] = s["x"] + np.where(valid, rng.uniform(-0.1, 0.1, s["x"].shape) * d, 0.0)
    vs = 0.05 if name == "vortex" else 0.01
    rho0 = np.where(s["rho"] > 0, s["rho"], 1.0)
    s["v"] = s["v"] + np.where(valid, rng.normal(0, vs, s["v"].shape), 0.0)
    s["vest"] = s["v"] + np.where(valid, rng.normal(0, vs / 5, s["v"].shape), 0.0)
    s["rho"] = np.where(valid, rho0 * rng.uniform(0.99, 1.01, valid.shape), rho0)
    s["rhoI"] = np.where(valid, s["rho"] * (1 + rng.normal(0, 1e-3, valid.shape)),
                         s["rho"])
    beam = valid & (s["solid_tag"] == 1) & (s["fixed_tag"] == 0)
    S = rng.normal(0.0, 1e3, s["S"].shape)
    s["S"] = np.where(beam, S + np.swapaxes(S, 0, 1), 0.0)
    if s["C"].shape[0]:
        C = rng.uniform(0.0, 1.5, s["C"].shape)
        s["C"] = np.where(valid, np.where(beam, C, 0.1 * C), 0.0)
    s["dt"] = np.asarray(DT[name], s["dt"].dtype)
    return _cast(s, dtype), _cast(bridge.to_numpy(jp), dtype), jspec


@pytest.mark.parametrize("name, filt", [
    ("beam", True), ("beam_fsi", False), ("vortex", True)],
    ids=["beam-mechanics-filter", "beam-fsi-species-nofilter", "vortex-filter"])
def test_pass_a_matches_jax(name, filt):
    """One force evaluation at f64, the port's plain 27-offset pass A (K3's
    plain version) against the JAX jnp path on the same inputs: every
    accumulator to rtol 1e-9, dS, ddx and phi/nw included; dS, ddx and (with
    the species) Q live, phi and nw live only with solids.  K3 serves the
    configuration."""
    s, p, jspec = _live(name, np.float64)
    cfg = dataclasses.replace(jspec.pair, density_filter_accs=filt,
                              use_pallas=False)
    jparams = _jax(JS.Params, p)
    ref = bridge.to_numpy(jpair.compute_forces(_jax(JS.State, s), jparams,
                                               jspec.geom, cfg))
    tspec = bridge.spec_to_port(jspec)
    tcfg = bridge._plain(tpair.PairConfig, cfg)
    st = bridge.state_to_port(s, device="cpu")
    tp = bridge.params_to_port(jparams, device="cpu")
    assert pair_cuda.kernel_unsupported(tspec.geom, tcfg, pair_cuda.pass_a_3d,
                                        n_sdpd=tp.n_sdpd) == []
    got = bridge.state_from_port(tpair.compute_forces(st, tp, tspec.geom, tcfg))
    for key in FIELDS:
        a, b = ref[key], got[key]
        assert a.dtype == b.dtype and a.shape == b.shape, key
        scale = max(float(np.abs(a).max(initial=0.0)), 1e-300)
        tol = 1e-9 * np.abs(a) + 1e-11 * scale
        assert (np.abs(b - a) <= tol).all(), (key, float(np.abs(b - a).max()))
    solids = name != "vortex"
    live = {"ddx": solids, "dS": solids, "phi": solids, "nw": solids,
            "Q": name == "beam_fsi", "f": True, "drho": True}
    for key, want in live.items():
        assert (float(np.abs(got[key]).max(initial=0.0)) > 0) == want, key


@pytest.mark.parametrize("name", ["beam_fsi", "vortex"])
def test_plain_pass_a_in_pieces_equals_whole(name):
    """The plain pass A evaluated over a few target cells at a time (the
    memory bound the card's checks use at full size) equals the whole
    evaluation at f64 to rtol 1e-12, every accumulator, with the virial."""
    s, p, jspec = _live(name, np.float64)
    tcfg = bridge._plain(tpair.PairConfig,
                         dataclasses.replace(jspec.pair, use_pallas=False))
    geom = bridge.spec_to_port(jspec).geom
    st = bridge.state_to_port(s, device="cpu")
    tp = bridge.params_to_port(_jax(JS.Params, p), device="cpu")
    pf = tpair._per_particle(st, tp, tcfg)
    whole = tpair._pass_a_plain(pf, tp, geom, tcfg, virial=True)
    piece = max(1, geom.ncells_total // 3 - 1)  # pieces of unequal size
    got = tpair._pass_a_plain(pf, tp, geom, tcfg, virial=True,
                              cells_per_piece=piece)
    assert geom.ncells_total % piece != 0
    for key in FIELDS + ("vir",):
        a, b = whole[key], got[key]
        assert a.shape == b.shape, key
        if not a.numel():  # Q without species
            continue
        tol = 1e-12 * float(a.abs().max()) + 1e-300
        assert float((b - a).abs().max()) <= tol, key
    assert float(whole["f"].abs().max()) > 0


def _steps(name, n):
    """``n`` steps of scene ``name`` at f64 from identical inputs in both
    packages (setup's rebin, then chunks of ``rebin_every``): (JAX state,
    port state) as numpy."""
    js, jp, jspec = _built(name)
    sa = _cast(bridge.to_numpy(js), np.float64)
    pa = _cast(bridge.to_numpy(jp), np.float64)
    js, jp = _jax(type(js), sa), _jax(type(jp), pa)
    ts = bridge.state_to_port(sa, device="cpu")
    tp = bridge.params_to_port(jp, device="cpu")
    tspec = bridge.spec_to_port(jspec)
    js = jstepper.simulate(jstepper.setup(js, jp, jspec, dt=DT[name]), jp,
                           jspec, n)
    ts = tstepper.simulate(tstepper.setup(ts, tp, tspec, dt=DT[name]), tp,
                           tspec, n)
    return bridge.to_numpy(js), bridge.state_from_port(ts)


@pytest.mark.parametrize("name, n", [("beam", 4), ("vortex", 10)])
def test_steps_match_jax(name, n):
    """Steps at f64 from identical inputs, one chunk each (one compiled
    program on the JAX side): the beam over its release at step 2 (the
    sponges after step 1; the beam moves and its S grows from 0), the
    vortex through its rebin_every: slots (tag, valid) bitwise, x, v, rho
    and S within 1e-8 of the JAX package's (S relative to its max), no
    overflow or drift."""
    a, b = _steps(name, n)
    assert int(a["step"]) == int(b["step"]) == n
    assert int(b["overflow"]) == 0 and int(b["drift_violation"]) == 0
    np.testing.assert_array_equal(a["tag"], b["tag"])
    np.testing.assert_array_equal(a["valid"], b["valid"])
    for key in ("x", "v", "rho"):
        np.testing.assert_allclose(b[key], a[key], rtol=0, atol=1e-8,
                                   err_msg=key)
    s_max = float(np.abs(a["S"]).max())
    np.testing.assert_allclose(b["S"], a["S"], rtol=0,
                               atol=1e-8 * max(s_max, 1.0), err_msg="S")
    if name == "beam":
        beam = b["valid"] & (b["solid_tag"] == 1) & (b["fixed_tag"] == 0)
        assert s_max > 0 and float(np.abs(b["v"][:, beam]).max()) > 0


def _drift(s, g, seed):
    """``s`` (numpy) with every valid particle moved by a seeded step of up
    to 0.9 cells per axis, positions beyond a periodic end unwrapped."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(-0.9, 0.9, s["x"].shape) * np.asarray(g.cell_size)[:, None, None]
    return dict(s, x=s["x"] + np.where(s["valid"], d, 0.0))


@pytest.mark.parametrize("which", ["vortex-cap86", "fsi-cap119-walls",
                                   "fsi-cap119-periodic"])
def test_walk_matches_both_sorts_past_cap_64(which):
    """K7's candidate order at caps past its former limit of 64: the port's
    plain 3D walk (``state.rebin(use_kernel=True)`` on the CPU) after a
    seeded drift, against the port's sort rebin and the JAX package's,
    every leaf bitwise; the vortex at the default margin (cap 86, every
    axis periodic) and the 3D FSI at nx=12 (cap 119) as built (x and z
    periodic) and with every axis walled."""
    if which == "vortex-cap86":
        js, _, jspec = ttg.scene(*_classes("jax")[:2], N=12).build()
        g = jspec.geom
    else:
        js, _, jspec = tfsi.scene(*_classes("jax"), nx=12, nz_cells=3).build()
        g = jspec.geom
        if which.endswith("walls"):
            g = dataclasses.replace(g, periodic=(False, False, False))
            js = JS.rebin(js, g, use_pallas=False)
    assert g.cap > 64
    s = _cast(_drift(bridge.to_numpy(js), g, seed=5), np.float32)
    tg = TS.Geometry(**dataclasses.asdict(g))
    assert rebin_cuda.move_route(tg) is rebin_cuda.rebin_move_3d
    ref = bridge.to_numpy(JS.rebin(_jax(JS.State, s), g, use_pallas=False))
    walk = bridge.state_from_port(
        TS.rebin(bridge.state_to_port(s, device="cpu"), tg, use_kernel=True))
    sort = bridge.state_from_port(
        TS.rebin(bridge.state_to_port(s, device="cpu"), tg, use_kernel=False))
    for key in ref:
        np.testing.assert_array_equal(walk[key], ref[key], err_msg=key)
        np.testing.assert_array_equal(sort[key], ref[key], err_msg=key)
    assert int(walk["valid"].sum()) + int(walk["overflow"]) == int(s["valid"].sum())
    assert int(walk["valid"].sum(0).max()) > 64  # a cell past the former cap


def test_drift_count_takes_the_periodic_image():
    """A position a hair below lo wraps to hi itself in f32 (lo + the f32
    extent) and bins into cell 0 (``cell_index_of``'s floored modulo), in
    both packages alike: the state after the rebin is bitwise JAX's.  At
    the next rebin the JAX package counts that particle as a drift past its
    cell (its raw position is a whole box away from cell 0); the port
    measures the image nearest the cell and counts none, while a real drift
    past the budget still counts in both."""
    js, _, jspec = ttg.scene(*_classes("jax")[:2], N=12).build()
    g = jspec.geom
    s = {key: np.array(v) for key, v in bridge.to_numpy(js).items()}
    k = 0  # slot 0 of cell 0, the corner cell at lo on every axis
    assert s["valid"][0, k]
    s["x"][0, 0, k] = np.float32(-1e-8)  # a hair across the seam
    tg = TS.Geometry(**dataclasses.asdict(g))
    ja = JS.rebin(_jax(JS.State, s), g, use_pallas=False)
    ta = TS.rebin(bridge.state_to_port(s, device="cpu"), tg, use_kernel=True)
    a, b = bridge.to_numpy(ja), bridge.state_from_port(ta)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    at_hi = b["valid"] & (b["x"][0] == np.float32(g.hi[0]))
    assert int(at_hi.sum()) == 1
    cell = np.broadcast_to(np.arange(g.ncells_total), at_hi.shape)[at_hi][0]
    assert cell // (g.ncells[1] * g.ncells[2]) == 0  # binned into cell 0
    # the next rebin: JAX counts a drift, the port none
    jb = bridge.to_numpy(JS.rebin(ja, g, use_pallas=False))
    tb = bridge.state_from_port(TS.rebin(ta, tg, use_kernel=True))
    assert int(jb["drift_violation"]) == 1 and int(tb["drift_violation"]) == 0
    for key in ("x", "tag", "valid"):
        np.testing.assert_array_equal(jb[key], tb[key], err_msg=key)
    # a real drift past the budget counts in both
    far = {key: np.array(v) for key, v in b.items()}
    far["x"][0][at_hi] -= np.float32(g.hi[0] - 1.5 * g.cell_size[0])
    jc = JS.rebin(_jax(JS.State, far), g, use_pallas=False)
    tc = TS.rebin(bridge.state_to_port(far, device="cpu"), tg, use_kernel=True)
    assert int(jc.drift_violation) == int(tc.drift_violation) == 1
