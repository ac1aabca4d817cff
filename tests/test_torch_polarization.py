"""The PyTorch port's cell-polarization slice against the JAX package.

``models/cell_polarization`` (a doubly periodic box, an elastic free cell
wall of two types on a finer lattice, one continuum species that softens
the wall's shear modulus, the ``fsi`` pair style and integrator, a
Dirichlet ``Forcing`` on the lower wall) is built by both packages at test
size (nx=24: 596 particles on 6 x 6 cells; nx=40: 1,648 on 10 x 10; cap 30) and held to the JAX package on
the CPU from identical inputs carried across by
``sph_bvf_tpu_torch.bridge``: the scene bitwise; one force evaluation (the
plain pass A, K2's plain version) against JAX's jnp path at f64 and f32
and against JAX's rowloop Pallas kernel in interpret mode, with the
density diffusion and the modulus coupling each on and off; the solid
release gate of both integrator variants; the plain rebin walk (K6's plain
version) against both sort rebins with particles across every face and
corner; 30 steps at f64.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_bvf_tpu import models as jmodels
from sph_bvf_tpu.core import fixes as jfixes
from sph_bvf_tpu.core import integrate as jinteg
from sph_bvf_tpu.core import state as JS
from sph_bvf_tpu.core import stepper as jstepper
from sph_bvf_tpu.models import cell_polarization as jpolar
from sph_bvf_tpu.ops import pair as jpair
from sph_bvf_tpu.ops import pair_pallas as jpallas
from sph_bvf_tpu_torch import bridge
from sph_bvf_tpu_torch import models as tmodels
from sph_bvf_tpu_torch.core import fixes as tfixes
from sph_bvf_tpu_torch.core import integrate as tinteg
from sph_bvf_tpu_torch.core import rebin_cuda
from sph_bvf_tpu_torch.core import state as TS
from sph_bvf_tpu_torch.core import stepper as tstepper
from sph_bvf_tpu_torch.models import cell_polarization as tpolar
from sph_bvf_tpu_torch.ops import pair as tpair
from sph_bvf_tpu_torch.ops import pair_cuda

from synthetic_edges import corner_drift

FIELDS = ("f", "drho", "de", "ddv", "ddx", "dS", "phi", "nw", "num_den",
          "rhoAux1", "rhoAux2", "Pnew", "Q")


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


def _close(got, ref, f64, name):
    """rtol 1e-9 at f64; 5e-6 of the field's max at f32 (sums in another
    order)."""
    assert got.dtype == ref.dtype and got.shape == ref.shape, name
    scale = max(float(np.abs(ref).max(initial=0.0)), 1e-30)
    if f64:
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-11 * scale,
                                   err_msg=name)
    else:
        assert float(np.abs(got - ref).max(initial=0.0)) <= 5e-6 * scale, name


def test_registry_matches_jax():
    """The port's model registry has the JAX package's names, each a
    ``build`` of the module of that name."""
    assert sorted(tmodels.REGISTRY) == sorted(jmodels.REGISTRY)
    for name, build in tmodels.REGISTRY.items():
        assert build is getattr(tmodels, name).build


@pytest.mark.parametrize("nx,ncells,n", [(24, (6, 6, 1), 596),
                                         (40, (10, 10, 1), 1648)])
def test_scene_build_matches_jax(nx, ncells, n):
    """Port-built polarization == JAX-built: geometry (doubly periodic, a
    mixed lattice), configs (``uniform_tables`` included), the Forcing fix,
    groups, params (four types, kappa) and every state leaf bitwise."""
    js, jp, jspec, jsc = jpolar.build(nx=nx)
    ts, tp, tspec, tsc = tpolar.build(nx=nx, device="cpu")
    assert dataclasses.asdict(tspec.geom) == dataclasses.asdict(jspec.geom)
    assert tspec.geom.ncells == ncells and tspec.geom.base_occ == 0
    assert tspec.geom.periodic == (True, True, True)
    assert dataclasses.asdict(tspec.pair) == dataclasses.asdict(jspec.pair)
    assert tspec.pair.variant == "fsi" and tspec.pair.g0_chem_coupling
    assert tspec.pair.ampl_damp == 0.1 and not tspec.pair.density_filter_accs
    assert "geff" not in tspec.pair.uniform_tables
    assert tspec.pair.uniform_tables == jspec.pair.uniform_tables != ()
    assert dataclasses.asdict(tspec.integ) == dataclasses.asdict(jspec.integ)
    assert tspec.integ.variant == "fsi" and not tspec.integ.reads_rhoaux()
    assert [type(f).__name__ for f in tspec.fixes] == ["Forcing"]
    assert [dataclasses.asdict(f) for f in tspec.fixes] == \
        [dataclasses.asdict(f) for f in jspec.fixes]
    assert tspec.rebin_every == jspec.rebin_every == 100
    assert bridge.spec_to_port(jspec) == tspec
    assert tsc._groups == jsc._groups
    np.testing.assert_array_equal(tsc._current_x(), jsc._current_x())
    assert int(ts.n_valid) == int(js.n_valid) == n
    a, b = bridge.to_numpy(js), bridge.state_from_port(ts)
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    assert sorted(np.unique(b["ptype"][b["valid"]])) == [0, 1, 2, 3]
    pa, pb = bridge.to_numpy(jp), bridge.to_numpy(tp)
    for name in pa:
        np.testing.assert_array_equal(pa[name], pb[name], err_msg=name)
    assert pb["kappa"].shape == (4, 4, 1) and float(pb["kappa"].max()) > 0


def _seeded_polar(dtype, ns=1, cutc_scale=1.0, c_hi=1.0):
    s, p, jspec = _seeded_polar_once(dtype, ns, cutc_scale, c_hi)
    copy = lambda d: {k: np.array(v) if isinstance(v, np.ndarray) else v
                      for k, v in d.items()}
    return copy(s), copy(p), jspec


@functools.lru_cache(maxsize=None)
def _seeded_polar_once(dtype, ns, cutc_scale, c_hi):
    """The JAX-built nx=24 polarization scene after setup as numpy in
    ``dtype``: seeded noise on v, vest and rho, a seeded symmetric S on the
    wall (the artificial-stress tensor tensile somewhere), ``ns`` species
    with C uniform in [0, ``c_hi``) on the wall and a tenth of that
    elsewhere, a distinct symmetric kappa per type pair and species and
    ``cutc = cutc_scale * h``."""
    js, jp, jspec, _ = jpolar.build(nx=24)
    js = jstepper.setup(js, jp, jspec, dt=1e-10)
    s, p = bridge.to_numpy(js), bridge.to_numpy(jp)
    rng = np.random.default_rng(11)
    valid = s["valid"]
    wall = valid & (s["solid_tag"] == 1)
    S = rng.normal(0.0, 2e3, s["S"].shape)
    s["S"] = np.where(wall, S + np.swapaxes(S, 0, 1), 0.0)
    s["v"] = np.where(valid, rng.normal(0, 0.5, s["v"].shape), 0.0)
    s["vest"] = s["v"] + np.where(valid, rng.normal(0, 0.1, s["v"].shape), 0.0)
    s["v"][2] = s["vest"][2] = 0.0
    s["rho"] = np.where(valid, s["rho"] * rng.uniform(0.99, 1.01, valid.shape),
                        1.0)
    s["rhoI"] = s["rho"].copy()
    C = rng.uniform(0, c_hi, (ns,) + valid.shape)
    s["C"] = np.where(wall, C, np.where(valid, 0.1 * C, 0.0))
    s["Q"] = np.zeros_like(s["C"])
    T = p["cut"].shape[0]
    kappa = rng.uniform(0.5, 1.5, (T, T, ns))
    p["kappa"] = 1e-5 * 0.5 * (kappa + kappa.transpose(1, 0, 2))
    p["kappa_ssa"] = np.zeros((T, T, 0), p["kappa_ssa"].dtype)
    p["cutc"] = cutc_scale * p["cut"]
    return _cast(s, dtype), _cast(p, dtype), jspec


# (ampl_damp, g0_chem_coupling, species_advection, ns, cutc / h, C's upper
# bound on the wall): the model's own pair style, each fsi term off, the
# species options K1 and K3 honour, and a concentration past 1/0.99 (a
# negative softened modulus)
PAIR_CASES = [
    (0.1, True, False, 1, 1.0, 1.0),
    (0.0, True, False, 1, 1.0, 1.0),
    (0.1, False, False, 1, 1.0, 1.0),
    (0.1, True, True, 2, 1.2, 1.0),
    (0.1, True, False, 2, 0.8, 1.0),
    (0.1, True, False, 1, 1.0, 1.5),
]
PAIR_IDS = ["model", "no-ampl_damp", "no-coupling", "ns2-cutc1.2h-adv",
            "ns2-cutc0.8h", "C-past-1/0.99"]


def _case_cfg(jspec, ampl, coupling, advect, **kw):
    return dataclasses.replace(jspec.pair, ampl_damp=ampl,
                               g0_chem_coupling=coupling,
                               species_advection=advect, **kw)


@pytest.mark.parametrize("ampl,coupling,advect,ns,cutc_scale,c_hi", PAIR_CASES,
                         ids=PAIR_IDS)
@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_compute_forces_matches_jax(dt, ampl, coupling, advect, ns, cutc_scale,
                                    c_hi):
    """One force evaluation on the seeded nx=24 polarization state (fsi pair
    style, doubly periodic, elastic free wall, species), port plain path vs
    JAX jnp path: every returned field, dS and Q included, to rtol 1e-9 at
    f64 and 5e-6 of the field's max at f32."""
    dtype = np.float64 if dt == "f64" else np.float32
    s, p, jspec = _seeded_polar(dtype, ns, cutc_scale, c_hi)
    cfg = _case_cfg(jspec, ampl, coupling, advect, use_pallas=False)
    jparams = _jax(JS.Params, p)
    jstate = _jax(JS.State, s)
    jpf = jpair._per_particle(jstate, jparams, cfg)
    assert float(jnp.abs(jpf["AS"]).max()) > 0  # the tensor term is live
    if c_hi > 1.0:
        assert float(jpf["G0"].min()) < 0
    ref = bridge.to_numpy(jpair.compute_forces(jstate, jparams, jspec.geom, cfg))
    assert float(np.abs(ref["dS"]).max()) > 0
    assert float(np.abs(ref["Q"]).max(axis=(1, 2)).min()) > 0

    tspec = bridge.spec_to_port(jspec)
    got = bridge.state_from_port(tpair.compute_forces(
        bridge.state_to_port(s, device="cpu"),
        bridge.params_to_port(jparams, device="cpu"), tspec.geom,
        bridge._plain(tpair.PairConfig, cfg)))
    for name in FIELDS + ("Qd", "vws", "aws"):
        _close(got[name], ref[name], dt == "f64", name)


def test_fsi_terms_change_the_sums():
    """``ampl_damp`` moves drho and nothing else; ``g0_chem_coupling`` moves
    dS and nothing else (port plain path, f64, seeded nx=24 state)."""
    s, p, jspec = _seeded_polar(np.float64)
    tspec = bridge.spec_to_port(jspec)
    state = bridge.state_to_port(s, device="cpu")
    params = bridge.params_to_port(_jax(JS.Params, p), device="cpu")
    run = lambda **kw: bridge.state_from_port(tpair.compute_forces(
        state, params, tspec.geom, dataclasses.replace(tspec.pair, **kw)))
    base = run()
    for kw, moved in ((dict(ampl_damp=0.0), "drho"),
                      (dict(g0_chem_coupling=False), "dS")):
        other = run(**kw)
        for name in FIELDS:
            same = np.array_equal(base[name], other[name])
            assert same == (name != moved), (kw, name)


def test_plain_pass_a_matches_jax_kernel_interpreted():
    """The port's plain pass A (what K2 is held to on the card) vs the JAX
    package's rowloop Pallas kernel in interpret mode on the doubly
    periodic grid (ghost columns on y, wrapped x), f32: every accumulator
    of the kernel's layout, dS and Q included, within 5e-6 of the field's
    max."""
    s, p, jspec = _seeded_polar(np.float32)
    cfg = jspec.pair
    jstate, jparams = _jax(JS.State, s), _jax(JS.Params, p)
    jpf = jpair._per_particle(jstate, jparams, cfg)
    ref = jpallas.pass_a_pallas(jpf, jparams, jspec.geom, cfg, block=128,
                                interpret=True)
    tspec = bridge.spec_to_port(jspec)
    tparams = bridge.params_to_port(jparams, device="cpu")
    tcfg = bridge._plain(tpair.PairConfig, cfg)
    assert pair_cuda.route(tspec.geom, tcfg) is pair_cuda.pass_a_2d_rowloop
    got = tpair._pass_a_plain(
        tpair._per_particle(bridge.state_to_port(s, device="cpu"), tparams, tcfg),
        tparams, tspec.geom, tcfg)
    names = [name for name, _ in jpallas._acc_layout(jparams, cfg)]
    assert {"f", "drho", "dS", "Q", "ddx"} <= set(names)
    for name in names:
        a, b = np.asarray(ref[name]), got[name].numpy()
        scale = max(float(np.abs(a).max()), 1e-30)
        assert float(np.abs(b - a).max()) <= 5e-6 * scale, name


@pytest.mark.parametrize("variant", ["mechanics", "fsi"])
def test_release_gate_matches_jax(variant):
    """``_damps`` at steps 0-3 with ``tdamp_solid = 1``: mechanics frees the
    solids from step 1 (``tnow < tdamp_solid``), fsi from step 2
    (``tnow <= tdamp_solid``); the fluid ramp is the same; port == JAX."""
    s, _, _ = _seeded_polar(np.float64)
    jcfg = getattr(jinteg.IntegratorConfig, variant)(tdamp_solid=1.0)
    tcfg = bridge._plain(tinteg.IntegratorConfig, jcfg)
    gates = []
    for step in range(4):
        s["step"] = np.asarray(step, np.int32)
        jd = jinteg._damps(_jax(JS.State, s), jcfg, jnp.float64)
        td = tinteg._damps(bridge.state_to_port(s, device="cpu"), tcfg,
                           torch.float64)
        assert [float(v) for v in td] == [float(v) for v in jd]
        gates.append(float(td[1]))
    assert gates == ([0.0, 1.0, 1.0, 1.0] if variant == "mechanics"
                     else [0.0, 0.0, 1.0, 1.0])


@pytest.mark.parametrize("step", [1, 2], ids=["frozen", "released"])
def test_fsi_integrate_and_forcing_match_jax(step):
    """initial_integrate, the post-integrate Forcing and final_integrate of
    the fsi variant, port vs JAX at f64, at the last frozen step and the
    first released one: every leaf to rtol 1e-12; the wall moves only once
    released; the clamp holds C = 1 on the lower wall between the half
    steps."""
    s, p, jspec = _seeded_polar(np.float64)
    jparams = _jax(JS.Params, p)
    jcfg = dataclasses.replace(jspec.pair, use_pallas=False)
    js = jpair.compute_forces(_jax(JS.State, s), jparams, jspec.geom, jcfg)
    js = dataclasses.replace(js, step=jnp.asarray(step, jnp.int32))
    ts = bridge.state_to_port(bridge.to_numpy(js), device="cpu")
    tparams = bridge.params_to_port(jparams, device="cpu")
    tspec = bridge.spec_to_port(jspec)
    stages = (
        (lambda st: jinteg.initial_integrate(st, jparams, jspec.integ),
         lambda st: tinteg.initial_integrate(st, tparams, tspec.integ)),
        (lambda st: jfixes.apply_stage(st, jparams, jspec.fixes,
                                       jfixes.POST_INTEGRATE),
         lambda st: tfixes.apply_stage(st, tparams, tspec.fixes,
                                       tfixes.POST_INTEGRATE)),
        (lambda st: jinteg.final_integrate(st, jparams, jspec.integ),
         lambda st: tinteg.final_integrate(st, tparams, tspec.integ)),
    )
    wall = (s["solid_tag"] == 1) & s["valid"]
    lower = (s["ptype"] == 3) & s["valid"]
    for i, (jfn, tfn) in enumerate(stages):
        js, ts = jfn(js), tfn(ts)
        a, b = bridge.to_numpy(js), bridge.state_from_port(ts)
        for name in a:
            if name == "key":
                continue
            scale = max(float(np.abs(a[name]).max(initial=0.0)), 1e-300)
            np.testing.assert_allclose(b[name], a[name], rtol=1e-12,
                                       atol=1e-14 * scale,
                                       err_msg=f"stage {i}: {name}")
        if i == 0:
            frozen = float(np.abs(b["v"][:, wall]).max()) == 0.0
            assert frozen == (step == 1)
        if i == 1:  # Forcing acts after step 1
            assert lower.sum() > 0
            assert bool((b["C"][0][lower] == 1.0).all()) == (step == 2)


def _drifted_polar(nx=24):
    """The polarization state after ``synthetic_edges.corner_drift`` (one-
    ring moves across every face and corner of the doubly periodic box),
    with seeded v and C, as f32 numpy with its geometry."""
    js, _, jspec, _ = jpolar.build(nx=nx)
    g = jspec.geom
    s = bridge.to_numpy(js)
    s["x"] = corner_drift(s["x"], s["valid"], g)
    rng = np.random.default_rng(4)
    s["v"] = rng.normal(0, 1, s["v"].shape).astype(np.float32)
    s["C"] = np.where(s["valid"], rng.uniform(0, 1, s["C"].shape), 0.0).astype(
        np.float32)
    return s, g


@pytest.mark.parametrize("nx", [24, 40])
def test_plain_walk_matches_both_sorts_doubly_periodic(nx):
    """The plain walk (K6's plain version) on the doubly periodic grid ==
    the port's sort rebin == the JAX package's sort rebin, every leaf
    bitwise (the C row rides along): the candidate order must follow the
    source cell's index after both wraps."""
    s, g = _drifted_polar(nx)
    tg = TS.Geometry(**dataclasses.asdict(g))
    assert rebin_cuda.move_route(tg) is rebin_cuda.rebin_move_2d_gated
    ref = bridge.to_numpy(JS.rebin(_jax(JS.State, s), g, use_pallas=False))
    walk = TS.rebin(bridge.state_to_port(s, device="cpu"), tg, use_kernel=True)
    sort = TS.rebin(bridge.state_to_port(s, device="cpu"), tg, use_kernel=False)
    assert int(walk.overflow) == int(ref["overflow"])
    for got in (walk, sort):
        b = bridge.state_from_port(got)
        for name in ref:
            if name != "key":
                np.testing.assert_array_equal(b[name], ref[name], err_msg=name)
    v = walk.valid.to(torch.int32)
    assert bool((v[1:] <= v[:-1]).all())  # compacted: K2's and K6's loop bounds


def test_steps_f64_match_jax(monkeypatch):
    """30 steps of cell_polarization.build(nx=40, rebin_every=5) at f64 from
    identical inputs (the wall released at step 2, the Forcing from step 2,
    a rebin at setup and before each chunk): x, v, rho, C and S within
    1e-8, slot assignment (tag, valid) bitwise; and no step asks pass A for the
    Shepard-filter variant (``freq_filter = 1e16`` never filters)."""
    js, jp, jspec, _ = jpolar.build(nx=40, rebin_every=5)
    sa = _cast(bridge.to_numpy(js), np.float64)
    pa = _cast(bridge.to_numpy(jp), np.float64)
    js, jp = _jax(type(js), sa), _jax(type(jp), pa)
    ts = bridge.state_to_port(sa, device="cpu")
    tp = bridge.params_to_port(jp, device="cpu")
    tspec = bridge.spec_to_port(jspec)
    assert ts.x.dtype == torch.float64 and tp.mass.dtype == torch.float64

    asked = []
    plain = pair_cuda.pass_a

    def spy(pf, params, geom, cfg, noise=None):
        asked.append(cfg.density_filter_accs)
        return plain(pf, params, geom, cfg, noise)

    monkeypatch.setattr(pair_cuda, "pass_a", spy)
    jspec = dataclasses.replace(
        jspec, pair=dataclasses.replace(jspec.pair, use_pallas=False))
    js = jstepper.simulate(jstepper.setup(js, jp, jspec, dt=1e-10), jp, jspec, 30)
    ts = tstepper.simulate(tstepper.setup(ts, tp, tspec, dt=1e-10), tp, tspec, 30)
    assert asked == [False] * 31
    a, b = bridge.to_numpy(js), bridge.state_from_port(ts)
    assert int(a["step"]) == int(b["step"]) == 30
    np.testing.assert_array_equal(a["tag"], b["tag"])
    np.testing.assert_array_equal(a["valid"], b["valid"])
    assert int(b["overflow"]) == 0 and int(b["drift_violation"]) == 0
    wall = (b["solid_tag"] == 1) & b["valid"]
    lower = (b["ptype"] == 3) & b["valid"]
    assert float(np.abs(b["v"][:, wall]).max()) > 0  # released
    assert float(np.abs(b["S"]).max()) > 0
    # the clamp, one half step later; species reached the neighbours
    np.testing.assert_array_equal(
        b["C"][0][lower],
        np.maximum(1.0 + b["Q"][0][lower] * (0.5 * float(b["dt"])), 0.0))
    assert float(b["C"][0][b["valid"] & ~lower].max()) > 0
    for name in ("x", "v", "rho", "C", "S"):
        np.testing.assert_allclose(b[name], a[name], rtol=0, atol=1e-8,
                                   err_msg=name)


def test_bridge_round_trip():
    """spec_to_port / spec_from_port and the state and params carriers keep
    the fsi configs, the kappa table, the species row and the Forcing fix."""
    js, jp, jspec, _ = jpolar.build(nx=24)
    tspec = bridge.spec_to_port(jspec)
    assert tspec.pair.variant == tspec.integ.variant == "fsi"
    back = bridge.spec_from_port(tspec, {
        "ModelSpec": jstepper.ModelSpec, "Geometry": JS.Geometry,
        "PairConfig": jpair.PairConfig,
        "IntegratorConfig": jinteg.IntegratorConfig,
        "Forcing": jfixes.Forcing})
    assert back == jspec
    a = bridge.to_numpy(js)
    b = bridge.state_from_port(bridge.state_to_port(a, device="cpu"))
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    tp = bridge.params_to_port(jp, device="cpu")
    assert tp.n_sdpd == 1 and tp.n_ssa == 0 and tp.ntypes == 4
    np.testing.assert_array_equal(tp.kappa.numpy(), np.asarray(jp.kappa))


def test_polarization_routes_to_k2_and_k6():
    """The polarization grid takes K2 (mixed lattice, cap > 24) and K6 (cap
    > 16, both axes periodic); K2 serves every switch the model sets."""
    _, params, spec, _ = tpolar.build(nx=40, device="cpu")
    assert pair_cuda.route(spec.geom, spec.pair) is pair_cuda.pass_a_2d_rowloop
    assert pair_cuda.kernel_unsupported(spec.geom, spec.pair,
                                        n_sdpd=params.n_sdpd) == []
    assert rebin_cuda.move_route(spec.geom) is rebin_cuda.rebin_move_2d_gated


def test_build_defaults_to_the_card():
    """``cell_polarization.build()`` with no device builds on the card: CUDA
    tensors where there is one, torch's CUDA error where there is none
    (never a quiet build on the CPU)."""
    build = tmodels.REGISTRY["cell_polarization"]
    if torch.cuda.is_available():
        state, params, _, _ = build(nx=24)
        assert state.x.is_cuda and params.mass.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            build(nx=24)
