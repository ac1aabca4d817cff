"""The PyTorch port's FSI slice against the JAX package.

The FSI beam in a periodic-x channel (``models/fsi.py``, the mechanics pair
style and integrator, elastic free solids, XSPH, the inlet ``Buffer``
sponges) is built by both packages at test size (nx=24: 2,555 particles,
cap 34, 22 x 9 cells, a mixed lattice) and held against the JAX run from
identical inputs carried across by ``sph_bvf_tpu_torch.bridge``.  Both run
on the CPU: JAX through its jnp path and sort rebin, the port through its
plain pass A (the K2 kernel's plain version) and its plain rebin walk (K6's).
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_bvf_tpu.core import fixes as jfixes
from sph_bvf_tpu.core import integrate as jinteg
from sph_bvf_tpu.core import state as JS
from sph_bvf_tpu.core import stepper as jstepper
from sph_bvf_tpu.models import fsi as jfsi
from sph_bvf_tpu.models import lid_cavity as jlid
from sph_bvf_tpu.ops import pair as jpair
from sph_bvf_tpu_torch import bridge
from sph_bvf_tpu_torch.core import fixes as tfixes
from sph_bvf_tpu_torch.core import integrate as tinteg
from sph_bvf_tpu_torch.core import rebin_cuda
from sph_bvf_tpu_torch.core import state as TS
from sph_bvf_tpu_torch.core import stepper as tstepper
from sph_bvf_tpu_torch.models import fsi as tfsi
from sph_bvf_tpu_torch.ops import pair as tpair
from sph_bvf_tpu_torch.ops import pair_cuda
from sph_bvf_tpu_torch.ops.eos import tait_b

from ref_pair import compute_reference

PASS_A_FIELDS = ("f", "drho", "de", "ddv", "ddx", "dS", "phi", "nw",
                 "num_den", "rhoAux1", "rhoAux2", "Pnew")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the plain paths issue
    thousands of small ops, and with the suite's parallel workers each
    running a full OpenMP pool the spinning pools starve one another
    (a run of the port's tests went from ~3 to over 20 minutes)."""
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


def _seeded_fsi(dtype, tdamp_solid=1e6):
    """The JAX-built nx=24 FSI scene after setup, with seeded noise on v,
    vest and rho and a seeded symmetric deviatoric stress S on the solids
    (so the artificial-stress tensor is tensile somewhere), as numpy in
    ``dtype`` (fresh copies the caller may change), with its spec."""
    s, p, jspec = _seeded_fsi_once(dtype, tdamp_solid)
    copy = lambda d: {k: np.array(v) if isinstance(v, np.ndarray) else v
                      for k, v in d.items()}
    return copy(s), copy(p), jspec


@functools.lru_cache(maxsize=None)
def _seeded_fsi_once(dtype, tdamp_solid):
    js, jp, jspec, _ = jfsi.build(nx=24, tdamp_solid=tdamp_solid)
    js = jstepper.setup(js, jp, jspec, dt=1e-8)
    s = bridge.to_numpy(js)
    rng = np.random.default_rng(0)
    valid = s["valid"]
    solid = valid & (s["solid_tag"] == 1)
    S = rng.normal(0.0, 50.0, s["S"].shape)
    s["S"] = np.where(solid, S + np.swapaxes(S, 0, 1), 0.0)
    s["v"] = s["v"] + np.where(valid, rng.normal(0, 0.01, s["v"].shape), 0.0)
    s["vest"] = s["v"] + np.where(valid, rng.normal(0, 0.002, s["v"].shape), 0.0)
    s["v"][2] = s["vest"][2] = 0.0
    s["rho"] = np.where(valid, s["rho"] * rng.uniform(0.999, 1.001, valid.shape),
                        1.0)
    return _cast(s, dtype), _cast(bridge.to_numpy(jp), dtype), jspec


def test_scene_build_matches_jax():
    """Port-built nx=24 FSI == JAX-built: geometry, configs, the Buffer
    fixes, params and every state leaf bitwise."""
    js, jp, jspec, _ = jfsi.build(nx=24)
    ts, tp, tspec, _ = tfsi.build(nx=24, device="cpu")
    assert dataclasses.asdict(tspec.geom) == dataclasses.asdict(jspec.geom)
    assert tspec.geom.cap == 34 and tspec.geom.base_occ == 0
    assert tspec.geom.ncells == (22, 9, 1)
    assert tspec.geom.periodic == (True, False, True)
    assert dataclasses.asdict(tspec.pair) == dataclasses.asdict(jspec.pair)
    assert dataclasses.asdict(tspec.integ) == dataclasses.asdict(jspec.integ)
    assert tspec.rebin_every == jspec.rebin_every == 100
    assert [type(f).__name__ for f in tspec.fixes] == ["Buffer", "Buffer"]
    assert [dataclasses.asdict(f) for f in tspec.fixes] == \
        [dataclasses.asdict(f) for f in jspec.fixes]
    assert bridge.spec_to_port(jspec) == tspec
    assert int(ts.n_valid) == int(js.n_valid) == 2555
    a, b = bridge.to_numpy(js), bridge.state_from_port(ts)
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    pa, pb = bridge.to_numpy(jp), bridge.to_numpy(tp)
    for name in pa:
        np.testing.assert_array_equal(pa[name], pb[name], err_msg=name)


@pytest.mark.parametrize("filt", [True, False], ids=["filter", "nofilter"])
@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_compute_forces_matches_jax(dt, filt):
    """One force evaluation on the seeded nx=24 FSI state (mechanics,
    elastic free beam, fixed walls, XSPH, periodic x), port vs JAX jnp
    path: every returned field to rtol 1e-9 at f64 and to 5e-6 of the
    field's max at f32 (sums in another order)."""
    dtype = np.float64 if dt == "f64" else np.float32
    s, p, jspec = _seeded_fsi(dtype)
    jparams = _jax(JS.Params, p)
    cfg = dataclasses.replace(jspec.pair, density_filter_accs=filt,
                              use_pallas=False)
    jpf = jpair._per_particle(_jax(JS.State, s), jparams, cfg)
    assert float(jnp.abs(jpf["AS"]).max()) > 0  # the tensor term is live
    ref = bridge.to_numpy(jpair.compute_forces(_jax(JS.State, s), jparams,
                                               jspec.geom, cfg))
    assert float(np.abs(ref["dS"]).max()) > 0 and float(np.abs(ref["ddx"]).max()) > 0

    tspec = bridge.spec_to_port(jspec)
    got = bridge.state_from_port(tpair.compute_forces(
        bridge.state_to_port(s, device="cpu"),
        bridge.params_to_port(jparams, device="cpu"), tspec.geom,
        bridge._plain(tpair.PairConfig, cfg)))
    for name in PASS_A_FIELDS + ("Q", "Qd", "vws", "aws"):
        a, b = ref[name], got[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        scale = max(float(np.abs(a).max(initial=0.0)), 1e-30)
        if dt == "f64":
            np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-11 * scale,
                                       err_msg=name)
        else:
            assert float(np.abs(b - a).max(initial=0.0)) <= 5e-6 * scale, name


def test_compute_forces_matches_bruteforce():
    """Port pass A at f64 vs the O(N^2) transcription of the reference's
    mechanics pair style (tests/ref_pair.py), rtol 1e-9: fluid, fixed and
    free solids of an elastic type, a seeded symmetric S."""
    rng = np.random.default_rng(3)
    n = 60
    x = rng.uniform(0.05, 0.95, size=(n, 2))
    ptype = rng.integers(0, 2, size=n)
    solid = rng.random(n) < 0.4
    fixed = solid & (rng.random(n) < 0.5)
    v = rng.normal(0, 0.1, size=(n, 3))
    vest = v + rng.normal(0, 0.02, size=(n, 3))
    v[:, 2] = vest[:, 2] = 0.0
    rho = rng.uniform(0.97, 1.05, size=n)
    rhoI = rho + rng.normal(0, 0.005, size=n)
    S = rng.normal(0, 0.01, size=(n, 3, 3))
    S = S + np.swapaxes(S, 1, 2)
    S[~solid] = 0.0
    h = 0.22
    mass, rho0, c0 = np.array([0.01, 0.012]), np.ones(2), np.full(2, 10.0)
    G0 = np.array([0.0, 0.3])
    cut = np.full((2, 2), h)
    visc = np.array([[0.1, 0.12], [0.12, 0.15]])

    geom = TS.Geometry.build(dim=2, lo=(0, 0, 0), hi=(1, 1, 0.1), cutoff=h, cap=32)
    st = TS.state_from_particles(geom, x, ptype, dtype=torch.float64,
                                 device="cpu")
    st = TS.scatter_by_tag(st, v=v, vest=vest, rho=rho, rhoI=rhoI, S=S,
                           solid_tag=solid.astype(np.int32),
                           fixed_tag=fixed.astype(np.int32))
    st = TS._neutralize_invalid(st)
    t64 = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    params = TS.Params(
        mass=t64(mass), rho0=t64(rho0), c0=t64(c0), B=t64(tait_b(c0, rho0)),
        G0=t64(G0), cut=t64(cut), cutc=t64(cut), visc=t64(visc),
        kappa=torch.zeros((2, 2, 0), dtype=torch.float64),
        kappa_ssa=torch.zeros((2, 2, 0), dtype=torch.float64))
    cfg = tpair.PairConfig.mechanics(dim=2, weighted_solid=False)
    fields = ("num_den", "rhoAux1", "rhoAux2", "ddv", "ddx", "f", "drho",
              "de", "phi", "nw", "dS")
    got = TS.gather_particles(tpair.compute_forces(st, params, geom, cfg), geom,
                              fields=fields)
    x3 = np.concatenate([x, np.zeros((n, 1))], axis=1)
    ref = compute_reference(
        x3, v, vest, rho, rhoI, np.zeros((n, 0)), S, ptype, solid, fixed,
        mass, tait_b(c0, rho0), rho0, c0, G0, cut, cut, visc,
        np.zeros((2, 2, 0)), dim=2, variant="mechanics")
    assert float(np.abs(ref["dS"]).max()) > 0
    for name in fields:
        scale = max(float(np.abs(ref[name]).max()), 1e-10)
        np.testing.assert_allclose(got[name], ref[name], rtol=1e-9,
                                   atol=1e-11 * scale, err_msg=name)


@pytest.mark.parametrize("offset", [-1, 0, 1], ids=["before", "at", "after"])
def test_mechanics_integrate_and_buffer_match_jax(offset):
    """initial_integrate, the post-integrate Buffer sponges and
    final_integrate of the mechanics variant, port vs JAX at f64, one step
    before, at and after the solid release ``tnow < tdamp_solid``: every
    leaf to rtol 1e-12; the beam stays frozen only before the release."""
    tdamp_solid = 5
    s, p, jspec = _seeded_fsi(np.float64, tdamp_solid=tdamp_solid)
    jparams = _jax(JS.Params, p)
    jcfg = dataclasses.replace(jspec.pair, use_pallas=False)
    js = jpair.compute_forces(_jax(JS.State, s), jparams, jspec.geom, jcfg)
    js = dataclasses.replace(js, step=jnp.asarray(tdamp_solid + offset, jnp.int32))
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
    beam = (s["solid_tag"] == 1) & (s["fixed_tag"] == 0) & s["valid"]
    for i, (jfn, tfn) in enumerate(stages):
        vest_before = bridge.to_numpy(js)["vest"]
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
            frozen = float(np.abs(b["v"][:, beam]).max()) == 0.0
            assert frozen == (offset < 0)
        if i == 1:  # the sponge acts on the fluid in the inlet zone
            assert not np.array_equal(a["vest"], vest_before)


@pytest.mark.parametrize("direction", ["x", "y"])
@pytest.mark.parametrize("field", ["tsdpd", "velocity", "density"])
def test_buffer_matches_jax(field, direction):
    """Every Buffer variant (species C, momentum velocity, density; cubic
    x ramp, tanh y ramp), port vs JAX at f64 on the seeded nx=24 state
    with one seeded species row: the blended leaf to rtol 1e-12, the sponge
    live, and nothing before ``after_step``."""
    s, p, jspec = _seeded_fsi(np.float64)
    rng = np.random.default_rng(7)
    s["C"] = np.where(s["valid"], rng.uniform(0, 1, (1,) + s["rho"].shape), 0.0)
    leaf = {"tsdpd": "C", "velocity": "vest", "density": "rho"}[field]
    kw = dict(field=field, direction=direction, index=0, center=(-25e-6, 5e-5),
              length=25e-6, width=30e-6, value=0.5, after_step=3)
    jfix = jfixes.Buffer(groupbit=1, **kw)
    tfix = tfixes.Buffer(groupbit=1, **kw)
    jparams = _jax(JS.Params, p)
    for step, live in ((3, False), (4, True)):
        s["step"] = np.asarray(step, np.int32)
        ref = bridge.to_numpy(jfix.apply(_jax(JS.State, s), jparams))
        got = bridge.state_from_port(tfix.apply(
            bridge.state_to_port(s, device="cpu"),
            bridge.params_to_port(jparams, device="cpu")))
        np.testing.assert_allclose(got[leaf], ref[leaf], rtol=1e-12, atol=0,
                                   err_msg=leaf)
        assert (not np.array_equal(ref[leaf], s[leaf])) == live


def _drifted_fsi():
    """The nx=24 FSI state with every valid particle moved by seeded noise
    of up to 0.9 cells per axis (one-ring moves, dozens across the
    periodic x face), as numpy, with its geometry."""
    js, _, jspec, _ = jfsi.build(nx=24)
    g = jspec.geom
    s = bridge.to_numpy(js)
    rng = np.random.default_rng(4)
    d = rng.uniform(-0.9, 0.9, s["x"].shape) * np.asarray(g.cell_size)[:, None, None]
    d[2] = 0.0
    s["x"] = (s["x"] + np.where(s["valid"], d, 0.0)).astype(np.float32)
    s["v"] = rng.normal(0, 1, s["v"].shape).astype(np.float32)
    crossed = (s["x"][0] < g.lo[0]) | (s["x"][0] >= g.hi[0])
    assert int(crossed[s["valid"]].sum()) > 10
    return s, g


def _drifted_cavity():
    js, _, jspec, _ = jlid.build(N=50)
    g = jspec.geom
    s = bridge.to_numpy(js)
    rng = np.random.default_rng(5)
    d = rng.uniform(-0.9, 0.9, s["x"].shape) * g.drift_budget
    d[2] = 0.0
    s["x"] = (s["x"] + np.where(s["valid"], d, 0.0)).astype(np.float32)
    return s, g


@pytest.mark.parametrize("grid", ["fsi_periodic_x", "cavity_n50"])
def test_plain_walk_matches_jax_sort(grid):
    """The generalized plain walk (K5's and K6's plain version) == the JAX
    package's sort rebin, every leaf bitwise: on the periodic-x FSI grid,
    where the candidate order must follow the source cell's index after
    the wrap, and on the N=50 cavity."""
    s, g = _drifted_fsi() if grid == "fsi_periodic_x" else _drifted_cavity()
    tg = TS.Geometry(**dataclasses.asdict(g))
    want = (rebin_cuda.rebin_move_2d_gated if grid == "fsi_periodic_x"
            else rebin_cuda.rebin_move_2d)
    assert rebin_cuda.move_route(tg) is want
    ref = bridge.to_numpy(JS.rebin(_jax(JS.State, s), g, use_pallas=False))
    got = bridge.state_from_port(TS.rebin(bridge.state_to_port(s, device="cpu"), tg,
                                          use_kernel=True))
    for name in ref:
        if name != "key":
            np.testing.assert_array_equal(got[name], ref[name], err_msg=name)


def _compacted(valid: torch.Tensor) -> bool:
    """Every cell's valid slots are 0..occ-1 (slot-major [cap, NC])."""
    v = valid.to(torch.int32)
    return bool((v[1:] <= v[:-1]).all())


def test_slots_stay_compacted_across_rebins():
    """The invariant K2's and K6's loop bounds rest on: after the build and
    after every rebin of a run, each cell's valid slots are 0..occ-1."""
    state, params, spec, _ = tfsi.build(nx=24, rebin_every=2, device="cpu")
    assert _compacted(state.valid)
    state = tstepper.setup(state, params, spec, dt=1e-8)
    for _ in range(3):
        state = tstepper.run_chunk(state, params, spec, spec.rebin_every)
        assert _compacted(state.valid)
    # also after the seeded one-ring drift of the walk test
    s, g = _drifted_fsi()
    moved = TS.rebin(bridge.state_to_port(s, device="cpu"),
                     TS.Geometry(**dataclasses.asdict(g)))
    assert _compacted(moved.valid) and int(moved.overflow) == 0


def test_steps_f64_match_jax():
    """10 steps of fsi.build(nx=24, rebin_every=5, tdamp_solid=5) at f64
    from identical inputs (the beam released at step 5, a rebin at setup
    and before each chunk): x, v, rho and S within 1e-8, slot assignment
    (tag, valid) bitwise."""
    js, jp, jspec, _ = jfsi.build(nx=24, rebin_every=5, tdamp_solid=5)
    sa = _cast(bridge.to_numpy(js), np.float64)
    pa = _cast(bridge.to_numpy(jp), np.float64)
    js, jp = _jax(type(js), sa), _jax(type(jp), pa)
    ts = bridge.state_to_port(sa, device="cpu")
    tp = bridge.params_to_port(jp, device="cpu")
    tspec = bridge.spec_to_port(jspec)
    assert ts.x.dtype == torch.float64 and tp.mass.dtype == torch.float64

    js = jstepper.simulate(jstepper.setup(js, jp, jspec, dt=1e-8), jp, jspec, 10)
    ts = tstepper.simulate(tstepper.setup(ts, tp, tspec, dt=1e-8), tp, tspec, 10)
    a, b = bridge.to_numpy(js), bridge.state_from_port(ts)
    assert int(a["step"]) == int(b["step"]) == 10
    np.testing.assert_array_equal(a["tag"], b["tag"])
    np.testing.assert_array_equal(a["valid"], b["valid"])
    assert int(b["overflow"]) == 0 and int(b["drift_violation"]) == 0
    beam = (b["solid_tag"] == 1) & (b["fixed_tag"] == 0) & b["valid"]
    assert float(np.abs(b["v"][:, beam]).max()) > 0  # released
    assert float(np.abs(b["S"]).max()) > 0
    for name in ("x", "v", "rho", "S"):
        np.testing.assert_allclose(b[name], a[name], rtol=0, atol=1e-8,
                                   err_msg=name)


def test_fsi_routes_to_k2_and_k6():
    """The FSI grid takes K2 (mixed lattice, cap > 24) and K6 (cap > 16,
    periodic x); every physics switch FSI needs is one K2 serves."""
    _, _, spec, _ = tfsi.build(nx=24, device="cpu")
    assert pair_cuda.uses_rowloop(spec.geom)
    assert pair_cuda.kernel_unsupported(spec.geom, spec.pair) == []
    assert rebin_cuda.move_route(spec.geom) is rebin_cuda.rebin_move_2d_gated
