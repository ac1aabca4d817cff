"""The PyTorch port's SDPD thermal noise against the JAX package.

The noise is a pure function of (seed, step, tag_lo, tag_hi, salt)
(``ops/rand.py``), so the port draws the JAX package's own stream: the
hash and the uniforms' 24 bits bitwise.  The normals go through Box-Muller
in float32, and torch's CPU ``log``/``cos`` need not round as XLA's do:
``test_rand_streams_match_jax`` measures the difference on the streams
these tests draw and holds it to ``ULP_BOUND`` units in the last place.

The tolerance on the force follows from that bound.  With u = ULP_BOUND *
2^-23 each normal g has |dg| <= u |g| <= u G, G = ``G_MAX`` (the largest
|normal|: u1 >= 2^-25, so sqrt(-2 log u1) <= 5.887).  An off-diagonal
entry of the Wiener matrix is one normal; a diagonal entry g_a - tr/dim
moves by at most 2 u G, plus at most 8 * 2^-23 G for the float32 rounding
of the trace and the subtraction, which two different inputs may round
apart.  Every entry therefore moves by at most (2 ULP_BOUND + 8) 2^-23 G,
and the random force of particle i, sum_j pref_ij (W_ij dx_ij), by at most
that times T_i = sum_j pref_ij |dx_ij|_1 per component.  ``_l1_scale``
computes T_i with the port's own prefactor (``pair._thermal_prefactor``);
every other field, and f away from the noise, keeps the rtol 1e-9 (f64)
and 5e-6 * max (f32) of the port's other pass-A tests.

Pass A with the noise is held to the JAX package's jnp path on the three
kernel routes (the plain path is what K1, K2 and K3 are checked against on
the card): the N=14 cavity made all-fluid as in ``tests/test_thermal.py``
(K1), the nx=24 FSI beam with seeded velocities, densities and stress
(K2, elastic) and the N=6 3D cavity (K3).  The invariants of
``tests/test_thermal.py`` are held on the port; 20 steps of natural
convection at N=40 with a raised kB, the thermo row (virial press
included) and a ``Halt`` that ends ``simulate`` are held to the JAX
package.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_bvf_tpu.core import fixes as jfixes
from sph_bvf_tpu.core import integrate as jinteg
from sph_bvf_tpu.core import state as JS
from sph_bvf_tpu.core import stepper as jstepper
from sph_bvf_tpu.ops import pair as jpair
from sph_bvf_tpu.ops import rand as jrand
from sph_bvf_tpu.utils import thermo as jthermo
from sph_bvf_tpu_torch import bridge
from sph_bvf_tpu_torch.core import stepper as tstepper
from sph_bvf_tpu_torch.models import fsi as tfsi
from sph_bvf_tpu_torch.models import lid_cavity as tlid
from sph_bvf_tpu_torch.models import lid_cavity3d as tlid3
from sph_bvf_tpu_torch.models import natural_convection as tconv
from sph_bvf_tpu_torch.ops import pair as tpair
from sph_bvf_tpu_torch.ops import pair_cuda
from sph_bvf_tpu_torch.ops import rand as trand
from sph_bvf_tpu_torch.utils import thermo as tthermo

# the most float32 units in the last place a port normal may differ from
# the JAX package's (3 measured on these streams)
ULP_BOUND = 4
G_MAX = math.sqrt(-2.0 * math.log(2.0**-25))
# the step and PRNG key words of the parity states: nonzero, so the noise's
# words round-trip through the state
STEP, KEY = 12345, (0xDEADBEEF, 0x12345)
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


def _ulps(a, b):
    """|a - b| in float32 units in the last place (a, b of one sign)."""
    assert (np.sign(a) == np.sign(b)).all()
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


# ---------------------------------------------------------------------------
# the counter RNG
# ---------------------------------------------------------------------------


def test_rand_streams_match_jax():
    """The streams the tests below draw: every tag pair lo < hi up to 400
    under the parity states' seed and steps (and the convection's seed 0 at
    steps 1..3), salts 0..5.  hash_u32 and the uniforms bitwise equal to
    JAX's; the port's draws pair-symmetric bitwise; the normals within
    ULP_BOUND units in the last place of JAX's, and bitwise for most."""
    lo, hi = np.triu_indices(401, k=1)
    keep = lo > 0
    lo, hi = lo[keep].astype(np.int32), hi[keep].astype(np.int32)
    tlo, thi = torch.as_tensor(lo), torch.as_tensor(hi)
    worst, same, total = 0, 0, 0
    for seed, step in ((KEY[0] ^ KEY[1], STEP), (KEY[0] ^ KEY[1], STEP + 1),
                       (0, 1), (0, 3)):
        for salt in range(6):
            words = (seed, step, lo, hi, salt)
            h_j = np.asarray(jrand.hash_u32(*(jnp.asarray(w, jnp.uint32)
                                              for w in words)))
            h_t = trand.hash_u32(seed, step, tlo, thi, salt).numpy()
            np.testing.assert_array_equal(h_t, h_j.astype(np.int64))
            u_j = np.asarray(jrand.uniform_01(*(jnp.asarray(w, jnp.uint32)
                                                for w in words)))
            u_t = trand.uniform_01(seed, step, tlo, thi, salt).numpy()
            assert u_t.dtype == np.float32
            np.testing.assert_array_equal(u_t, u_j)
            g_j = np.asarray(jrand.pair_symmetric_normal(
                seed, step, jnp.asarray(hi), jnp.asarray(lo), salt))
            g_t = trand.pair_symmetric_normal(seed, step, thi, tlo, salt).numpy()
            g_sym = trand.pair_symmetric_normal(seed, step, tlo, thi, salt).numpy()
            np.testing.assert_array_equal(g_sym, g_t)
            assert g_t.dtype == np.float32 and np.abs(g_t).max() <= G_MAX
            d = _ulps(g_t, g_j)
            worst, same, total = max(worst, int(d.max())), same + int(
                (d == 0).sum()), total + d.size
    assert worst <= ULP_BOUND, worst
    assert same > 0.8 * total, same / total


# ---------------------------------------------------------------------------
# pass A with the noise, on the three kernel routes
# ---------------------------------------------------------------------------


def _jax_spec(tspec, **classes):
    """The JAX package's ModelSpec of the port's ``tspec`` (its fixes'
    classes by name in ``classes``)."""
    return bridge.spec_from_port(tspec, dict(
        ModelSpec=jstepper.ModelSpec, Geometry=JS.Geometry,
        PairConfig=jpair.PairConfig, IntegratorConfig=jinteg.IntegratorConfig,
        **classes))


@functools.lru_cache(maxsize=None)
def _route_state_once(route):
    """The set-up state of a kernel route (numpy, f64; built and set up by
    the port, whose scenes equal the JAX package's bitwise), with e = 1 on
    the valid slots, the parity step and key, the JAX spec with the noise
    on, and the kB that makes the noise dominate its forces."""
    if route == "K1":  # tests/test_thermal.py's all-fluid N=14 cavity
        ts, tp, tspec, _ = tlid.build(N=14, Re=100.0, device="cpu")
        s = bridge.state_from_port(tstepper.setup(ts, tp, tspec, dt=1e-4))
        s["solid_tag"] = np.zeros_like(s["solid_tag"])
        s["fixed_tag"] = np.zeros_like(s["fixed_tag"])
        boltz, fixes = 1e-4, dict(SetForce=jfixes.SetForce)
    elif route == "K2":  # the elastic FSI beam, every pair term live
        ts, tp, tspec, _ = tfsi.build(nx=24, device="cpu")
        s = bridge.state_from_port(tstepper.setup(ts, tp, tspec, dt=1e-8))
        rng = np.random.default_rng(0)
        valid = s["valid"]
        S = rng.normal(0.0, 50.0, s["S"].shape)
        s["S"] = np.where(valid & (s["solid_tag"] == 1),
                          S + np.swapaxes(S, 0, 1), 0.0)
        s["v"] = s["v"] + np.where(valid, rng.normal(0, 0.01, s["v"].shape), 0.0)
        s["vest"] = s["v"] + np.where(valid, rng.normal(0, 0.002, s["v"].shape),
                                      0.0)
        s["v"][2] = s["vest"][2] = 0.0
        s["rho"] = np.where(valid, s["rho"] * rng.uniform(0.999, 1.001,
                                                          valid.shape), 1.0)
        boltz, fixes = 1e-13, dict(Buffer=jfixes.Buffer)
    else:  # the 3D cavity
        ts, tp, tspec, _ = tlid3.build(N=6, device="cpu")
        s = bridge.state_from_port(tstepper.setup(ts, tp, tspec, dt=1e-4))
        boltz, fixes = 1e-4, dict(SetForce=jfixes.SetForce)
    s["e"] = np.where(s["valid"], 1.0, 0.0)
    s["step"] = np.asarray(STEP, s["step"].dtype)
    s["key"] = np.asarray(KEY, np.uint32)
    jspec = _jax_spec(tspec, **fixes)
    cfg = dataclasses.replace(jspec.pair, thermal=True, use_pallas=False)
    return (_cast(s, np.float64), _cast(bridge.to_numpy(tp), np.float64),
            dataclasses.replace(jspec, pair=cfg), boltz)


_jforces = jax.jit(jpair.compute_forces,
                   static_argnames=("geom", "cfg", "mesh", "mesh_axis"))


def _l1_scale(state, params, geom, cfg):
    """(T_i = sum_j pref_ij |dx_ij|_1 over the pairs whose random force i
    sums (the fluid branch), as [cap, NC]; f without the noise): the port's
    pass A with the random force replaced by pref |dx|_1, less the pass A
    without it."""
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
    return (on - off)[0].abs(), off


def _thermal_parity(s, p, jspec, boltz, f64):
    """Port vs JAX pass A with the noise on the same numpy inputs: every
    field but f to rtol 1e-9 (f64) or 5e-6 * max (f32), f within that plus
    the bound the normals' ulps imply (module docstring).  Returns the
    port's state, params, spec and the max |noise| / max |f without it|."""
    jp = dataclasses.replace(_jax(JS.Params, p), boltz=boltz)
    # jitted in 2D; op by op in 3D, where XLA takes longer to compile the
    # 27 offsets' hashes as one program than to run them one by one
    forces = jpair.compute_forces if jspec.geom.dim == 3 else _jforces
    ref = bridge.to_numpy(forces(_jax(JS.State, s), jp, jspec.geom, jspec.pair))
    tspec = bridge.spec_to_port(jspec)
    st = bridge.state_to_port(s, device="cpu")
    params = bridge.params_to_port(jp, device="cpu")
    got = bridge.state_from_port(tpair.compute_forces(st, params, tspec.geom,
                                                      tspec.pair))
    l1, off = _l1_scale(st, params, tspec.geom, tspec.pair)
    bound = (2 * ULP_BOUND + 8) * 2.0**-23 * G_MAX * l1.numpy()
    for name in FIELDS:
        a, b = ref[name], got[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        scale = max(float(np.abs(a).max(initial=0.0)), 1e-30)
        extra = bound if name == "f" else 0.0
        if f64:
            tol = 1e-9 * np.abs(a) + 1e-11 * scale + extra
        else:
            tol = 5e-6 * scale + extra
        assert (np.abs(b - a) <= tol).all(), (name, float(np.abs(b - a).max()))
    noise = float((torch.as_tensor(got["f"]) - off).abs().max())
    return st, params, tspec, noise / max(float(off.abs().max()), 1e-30)


ROUTES = {"K1": pair_cuda.pass_a_2d, "K2": pair_cuda.pass_a_2d_rowloop,
          "K3": pair_cuda.pass_a_3d}


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_thermal_pass_a_matches_jax(route, dt):
    """compute_forces with thermal on, port vs the JAX jnp path, on each
    kernel route at f64 and f32 (tolerances in the module docstring); the
    grid routes to the kernel named, which takes the configuration, and
    the noise dominates the force (so f is held on the noise itself)."""
    s, p, jspec, boltz = _route_state_once(route)
    dtype = np.float64 if dt == "f64" else np.float32
    s, p = _cast(s, dtype), _cast(p, dtype)
    st, params, tspec, ratio = _thermal_parity(s, p, jspec, boltz, dt == "f64")
    assert pair_cuda.route(tspec.geom, tspec.pair) is ROUTES[route]
    assert pair_cuda.kernel_unsupported(tspec.geom, tspec.pair,
                                        n_sdpd=params.n_sdpd) == []
    assert ratio > 10.0, ratio


def _all_fluid(e=1.0):
    """tests/test_thermal.py's state: the N=14 cavity all-fluid, e on the
    valid slots, kB 1e-4, on the port (f32)."""
    s, p, jspec, boltz = _route_state_once("K1")
    s = _cast(dict(s, e=np.where(s["valid"], e, 0.0)), np.float32)
    params = dataclasses.replace(
        bridge.params_to_port(_jax(JS.Params, _cast(p, np.float32)),
                              device="cpu"), boltz=boltz)
    tspec = bridge.spec_to_port(jspec)
    return bridge.state_to_port(s, device="cpu"), params, tspec


def test_thermal_force_momentum_conserving():
    """The random force is pair-symmetric: its sum over the particles is 0
    to rounding (tests/test_thermal.py, on the port)."""
    state, params, spec = _all_fluid()
    out = tpair.compute_forces(state, params, spec.geom, spec.pair)
    f = torch.where(out.valid[None], out.f, 0.0).numpy()
    ftot = np.abs(f.sum(axis=(1, 2)))
    fscale = np.abs(f).max()
    assert fscale > 0
    assert ftot.max() < 1e-6 * fscale * f[0].size ** 0.5, (ftot, fscale)


def test_thermal_force_zero_at_zero_energy():
    """e = 0 switches the noise off exactly."""
    state, params, spec = _all_fluid(e=0.0)
    cold = tpair.compute_forces(state, params, spec.geom, spec.pair)
    off = tpair.compute_forces(state, params, spec.geom,
                               dataclasses.replace(spec.pair, thermal=False))
    np.testing.assert_allclose(cold.f.numpy(), off.f.numpy(), atol=1e-12)


def test_thermal_force_changes_with_step():
    """The step is a word of every draw: the next step draws other noise."""
    state, params, spec = _all_fluid()
    a = tpair.compute_forces(state, params, spec.geom, spec.pair)
    b = tpair.compute_forces(dataclasses.replace(state, step=state.step + 1),
                             params, spec.geom, spec.pair)
    assert not np.allclose(a.f.numpy(), b.f.numpy())


# ---------------------------------------------------------------------------
# natural convection with the noise: steps, the thermo row, Halt
# ---------------------------------------------------------------------------

# kB for the steps: with the model's e = 1e-6 the noise moves the N=40 fluid
# by ~1e-5 a step, well above the 1e-8 the runs are held to and far below
# the flow's own 1e-3 (the SI kB's is 1e-13)
CONV_BOLTZ = 1e-4


@functools.lru_cache(maxsize=None)
def _convection_once():
    """The N=40 convection with the noise on and a rebin every 20 steps (one
    compiled JAX chunk for every test here), set up at dt 1e-4 by the port
    at f64 (numpy), with its JAX spec and the scene."""
    ts, tp, tspec, sc = tconv.build(N=40, rebin_every=20, device="cpu")
    tspec = dataclasses.replace(tspec, pair=dataclasses.replace(
        tspec.pair, thermal=True))
    s = _cast(bridge.state_from_port(ts), np.float64)
    tp = dataclasses.replace(tp, **{
        f.name: getattr(tp, f.name).double() for f in dataclasses.fields(tp)
        if isinstance(getattr(tp, f.name), torch.Tensor)})
    ts = tstepper.setup(bridge.state_to_port(s, device="cpu"),
                        dataclasses.replace(tp, boltz=CONV_BOLTZ), tspec, dt=1e-4)
    jspec = _jax_spec(tspec, Buoyancy=jfixes.Buoyancy, Forcing=jfixes.Forcing)
    jspec = dataclasses.replace(jspec, pair=dataclasses.replace(
        jspec.pair, use_pallas=False))
    return bridge.state_from_port(ts), bridge.to_numpy(tp), jspec, sc


def _convection(boltz=CONV_BOLTZ):
    """(JAX state, params, spec, port state, params, spec, scene) from the
    same set-up inputs, with kB ``boltz``."""
    s, p, jspec, sc = _convection_once()
    jp = dataclasses.replace(_jax(JS.Params, p), boltz=boltz)
    return (_jax(JS.State, s), jp, jspec, bridge.state_to_port(s, device="cpu"),
            bridge.params_to_port(jp, device="cpu"), bridge.spec_to_port(jspec),
            sc)


@functools.lru_cache(maxsize=None)
def _convection_steps():
    js, jp, jspec, ts, tp, tspec, _ = _convection()
    js = jstepper.simulate(js, jp, jspec, 20)
    ts = tstepper.simulate(ts, tp, tspec, 20)
    return bridge.to_numpy(js), bridge.state_from_port(ts)


def test_convection_steps_f64_match_jax():
    """20 steps of the N=40 convection at f64 with the noise (kB 1e-4, the
    model's e 1e-6): slots bitwise, x, v, rho, C and Q within 1e-8 of the
    JAX package's run, and the noise moved the fluid by far more than that
    (the same steps without it end 1e-6 or more away)."""
    a, b = _convection_steps()
    assert int(a["step"]) == int(b["step"]) == 20
    np.testing.assert_array_equal(a["tag"], b["tag"])
    np.testing.assert_array_equal(a["valid"], b["valid"])
    assert int(b["overflow"]) == 0 and int(b["drift_violation"]) == 0
    for name in ("x", "v", "rho", "C", "Q"):
        np.testing.assert_allclose(b[name], a[name], rtol=0, atol=1e-8,
                                   err_msg=name)
    _, _, _, ts, tp, tspec, _ = _convection()
    quiet = dataclasses.replace(tspec, pair=dataclasses.replace(
        tspec.pair, thermal=False))
    c = bridge.state_from_port(tstepper.simulate(ts, tp, quiet, 20))
    assert float(np.abs(c["v"] - b["v"]).max()) > 1e-6


@pytest.mark.parametrize("thermal", [True, False], ids=["SI_kB", "off"])
def test_thermo_row_matches_jax(thermal):
    """thermo_row on the stepped convection state, port vs JAX on the same
    inputs, with the virial press of the reference's own pair style (the
    noise on at the SI kB: a force 1e-8 of the rest, so the normals' ulps
    move no column) and without the noise: every column to rtol 1e-9,
    step, n and overflow equal."""
    a, _ = _convection_steps()
    _, jp, jspec, _, tp, tspec, _ = _convection(JS.Params.boltz)
    if not thermal:
        jspec = dataclasses.replace(jspec, pair=dataclasses.replace(
            jspec.pair, thermal=False))
        tspec = bridge.spec_to_port(jspec)
    js = _jax(JS.State, a)
    ts = bridge.state_to_port(a, device="cpu")
    want = jthermo.thermo_row(js, jp, dim=2, geom=jspec.geom,
                              pair_cfg=jspec.pair)
    got = tthermo.thermo_row(ts, tp, dim=2, geom=tspec.geom,
                             pair_cfg=tspec.pair)
    assert set(got) == set(want)
    for k in ("step", "n", "overflow"):
        assert got[k] == want[k], k
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-9, abs=1e-300), k
    assert got["temp"] > 0 and got["press"] != got["press_tait"]


def test_halt_ends_simulate_where_jax_does():
    """simulate with a Halt callback (thermo's StopSimulation) returns the
    state of the chunk where the JAX package's returns, prints, raises
    nothing, and the state agrees with JAX's run."""
    js, jp, jspec, ts, tp, tspec, _ = _convection()
    halt_at = lambda row: row["step"] >= 40
    js = jstepper.simulate(js, jp, jspec, 100,
                           callback=jthermo.Halt(halt_at, jp))
    ts = tstepper.simulate(ts, tp, tspec, 100,
                           callback=tthermo.Halt(halt_at, tp))
    a, b = bridge.to_numpy(js), bridge.state_from_port(ts)
    assert int(a["step"]) == int(b["step"]) == 40
    np.testing.assert_array_equal(a["tag"], b["tag"])
    for name in ("x", "v", "rho", "C"):
        np.testing.assert_allclose(b[name], a[name], rtol=0, atol=1e-8,
                                   err_msg=name)
    with pytest.raises(tthermo.StopSimulation):
        tthermo.Halt(lambda row: True, tp)(ts)
    logger = tthermo.ThermoLogger(tp, columns="step dt press temp etotal".split(),
                                  geom=tspec.geom, pair_cfg=tspec.pair)
    row = logger(ts)
    assert row["step"] == 40 and logger.history == [row]
    with pytest.raises(ValueError):
        tthermo.ThermoLogger(tp, columns=["nope"])
