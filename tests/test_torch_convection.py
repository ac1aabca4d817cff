"""The PyTorch port's natural convection (continuum species transport)
against the JAX package.

``models/natural_convection`` is built by both packages at N=40 (16 x 16
cells, cap 14, one species) and held to the JAX package on the CPU: the
scene bitwise; one force evaluation with species (the plain pass A, the
plain version of K1 and K3 with their species rows) against JAX's jnp
path at f64 and f32, against JAX's K1 in interpret mode and against the
brute-force f64 transcription (``tests/ref_pair.py``), for one and two
species, with the species support ``cutc`` equal to, above and below the
kernel support ``h``, with and without the advection correction; the 3D
pass A with species; each newly ported fix against its JAX counterpart;
both species half-steps of the integrator; 60 steps at f64 across three
filter steps and a rebin; the new regions and scene commands; the rebins
carrying the C rows; and the bridge with two species.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_bvf_tpu.api import scene as jscene
from sph_bvf_tpu.core import fixes as jfixes
from sph_bvf_tpu.core import integrate as jinteg
from sph_bvf_tpu.core import state as JS
from sph_bvf_tpu.core import stepper as jstepper
from sph_bvf_tpu.models import natural_convection as jconv
from sph_bvf_tpu.ops import pair as jpair
from sph_bvf_tpu.ops import pair_pallas as jpallas
from sph_bvf_tpu_torch import bridge
from sph_bvf_tpu_torch.api import scene as tscene
from sph_bvf_tpu_torch.core import fixes as tfixes
from sph_bvf_tpu_torch.core import integrate as tinteg
from sph_bvf_tpu_torch.core import rebin_cuda
from sph_bvf_tpu_torch.core import state as TS
from sph_bvf_tpu_torch.core import stepper as tstepper
from sph_bvf_tpu_torch.models import natural_convection as tconv
from sph_bvf_tpu_torch.ops import pair as tpair
from sph_bvf_tpu_torch.ops import pair_cuda
from sph_bvf_tpu_torch.ops.eos import tait_b

from ref_pair import compute_reference
from synthetic_edges import with_synthetic_edges

FIELDS = ("f", "drho", "de", "ddv", "phi", "nw", "num_den", "rhoAux1",
          "rhoAux2", "Q")


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
    """rtol 1e-9 at f64 (the ref_pair standard); 5e-6 of the field's max at
    f32 (sums in another order)."""
    assert got.dtype == ref.dtype and got.shape == ref.shape, name
    scale = max(float(np.abs(ref).max(initial=0.0)), 1e-30)
    if f64:
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-11 * scale,
                                   err_msg=name)
    else:
        assert float(np.abs(got - ref).max(initial=0.0)) <= 5e-6 * scale, name


def test_scene_build_matches_jax():
    """Port-built N=40 convection == JAX-built: geometry, configs, fixes,
    groups, params (kappa, cutc) and every state leaf (x, tag, type, group
    mask, C, solid/fixed tags, slots) bitwise."""
    js, jp, jspec, jsc = jconv.build(N=40)
    ts, tp, tspec, tsc = tconv.build(N=40, device="cpu")
    assert dataclasses.asdict(tspec.geom) == dataclasses.asdict(jspec.geom)
    assert tspec.geom.ncells == (16, 16, 1) and tspec.geom.cap == 14
    assert tspec.geom.base_occ == 9 and not pair_cuda.uses_rowloop(tspec.geom)
    assert dataclasses.asdict(tspec.pair) == dataclasses.asdict(jspec.pair)
    assert tspec.pair.species_advection and tspec.pair.density_filter_accs
    assert dataclasses.asdict(tspec.integ) == dataclasses.asdict(jspec.integ)
    assert [type(f).__name__ for f in tspec.fixes] == \
        ["Buoyancy", "Forcing", "Forcing"]
    assert [dataclasses.asdict(f) for f in tspec.fixes] == \
        [dataclasses.asdict(f) for f in jspec.fixes]
    assert tspec.rebin_every == jspec.rebin_every == 50
    assert tsc._groups == jsc._groups
    assert int(ts.n_valid) == int(js.n_valid) == 46 * 46
    a, b = bridge.to_numpy(js), bridge.state_from_port(ts)
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    assert a["C"].shape[0] == 1 and float(a["C"].max()) == 1.0
    pa, pb = bridge.to_numpy(jp), bridge.to_numpy(tp)
    for name in pa:
        np.testing.assert_array_equal(pa[name], pb[name], err_msg=name)
    assert pb["kappa"].shape == (2, 2, 1) and float(pb["kappa"].min()) > 0


def _seeded_convection(dtype, ns, cutc_scale, N=20):
    """The JAX-built convection after setup as numpy in ``dtype``, with
    seeded noise on v, vest and rho (every term live), ``ns`` species (C
    uniform in [0, 1) beyond the scene's own), a distinct symmetric kappa
    per type pair and species, and ``cutc = cutc_scale * h``."""
    js, jp, jspec, _ = jconv.build(N=N)
    js = jstepper.setup(js, jp, jspec, dt=1e-4)
    s, p = bridge.to_numpy(js), bridge.to_numpy(jp)
    rng = np.random.default_rng(7)
    valid = s["valid"]
    shape3 = s["v"].shape
    s["v"] = np.where(valid, rng.normal(0, 0.05, shape3), 0.0)
    s["vest"] = s["v"] + np.where(valid, rng.normal(0, 0.01, shape3), 0.0)
    s["v"][2] = s["vest"][2] = 0.0
    s["rho"] = np.where(valid, rng.uniform(0.99, 1.01, valid.shape), 1.0)
    s["rhoI"] = np.where(valid, s["rho"] + rng.normal(0, 1e-3, valid.shape), 1.0)
    C = np.where(valid, rng.uniform(0, 1, (ns,) + valid.shape), 0.0)
    C[0] = np.where(s["C"][0] > 0, s["C"][0], C[0])
    s["C"], s["Q"] = C, np.zeros_like(C)
    kappa = rng.uniform(0.5, 1.5, (2, 2, ns))
    p["kappa"] = 0.012 * 0.5 * (kappa + kappa.transpose(1, 0, 2))
    p["cutc"] = cutc_scale * p["cut"]
    return _cast(s, dtype), _cast(p, dtype), jspec


SPECIES_CASES = [(1, 1.0, True), (2, 1.2, True), (2, 0.8, False)]
SPECIES_IDS = ["ns1-cutc1.0h-adv", "ns2-cutc1.2h-adv", "ns2-cutc0.8h-noadv"]


@pytest.mark.parametrize("ns,cutc_scale,advect", SPECIES_CASES, ids=SPECIES_IDS)
@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_compute_forces_with_species_matches_jax(dt, ns, cutc_scale, advect):
    """One force evaluation with species, port plain path vs JAX jnp path:
    every returned field, Q included, to rtol 1e-9 at f64 and 5e-6 of the
    field's max at f32.  Q is nonzero for every species."""
    dtype = np.float64 if dt == "f64" else np.float32
    s, p, jspec = _seeded_convection(dtype, ns, cutc_scale)
    cfg = dataclasses.replace(jspec.pair, species_advection=advect,
                              use_pallas=False)
    jparams = _jax(JS.Params, p)
    ref = bridge.to_numpy(jpair.compute_forces(_jax(JS.State, s), jparams,
                                               jspec.geom, cfg))
    tspec = bridge.spec_to_port(jspec)
    got = bridge.state_from_port(tpair.compute_forces(
        bridge.state_to_port(s, device="cpu"),
        bridge.params_to_port(jparams, device="cpu"), tspec.geom,
        bridge._plain(tpair.PairConfig, cfg)))
    assert ref["Q"].shape[0] == ns
    assert float(np.abs(ref["Q"]).max(axis=(1, 2)).min()) > 0
    for name in FIELDS + ("Qd", "ddx", "dS", "vws", "aws"):
        _close(got[name], ref[name], dt == "f64", name)


@pytest.mark.parametrize("ns,cutc_scale,advect", SPECIES_CASES, ids=SPECIES_IDS)
def test_plain_pass_a_matches_jax_kernel_interpreted(ns, cutc_scale, advect):
    """The port's plain pass A (what K1 is held to on the card) vs the JAX
    package's K1 Pallas kernel in interpret mode, f32: every accumulator of
    the kernel's layout, Q included, within 5e-6 of the field's max."""
    s, p, jspec = _seeded_convection(np.float32, ns, cutc_scale, N=12)
    cfg = dataclasses.replace(jspec.pair, species_advection=advect)
    jstate, jparams = _jax(JS.State, s), _jax(JS.Params, p)
    jpf = jpair._per_particle(jstate, jparams, cfg)
    ref = jpallas.pass_a_pallas(jpf, jparams, jspec.geom, cfg, block=128,
                                interpret=True, rowloop=False)
    tspec = bridge.spec_to_port(jspec)
    tparams = bridge.params_to_port(jparams, device="cpu")
    tcfg = bridge._plain(tpair.PairConfig, cfg)
    got = tpair._pass_a_plain(
        tpair._per_particle(bridge.state_to_port(s, device="cpu"), tparams, tcfg),
        tparams, tspec.geom, tcfg)
    names = [name for name, _ in jpallas._acc_layout(jparams, cfg)]
    assert "Q" in names
    for name in names:
        _close(got[name].numpy(), np.asarray(ref[name]), False, name)


@pytest.mark.parametrize("cutc_scale", [1.0, 0.8])
def test_species_flux_matches_bruteforce(cutc_scale):
    """Port pass A with two species at f64 vs the O(N^2) transcription of
    the reference pair style (Q with its own support and the advection
    correction), rtol 1e-9.  The transcription skips a pair beyond h before
    it reaches the species term, so it gives Q only for cutc <= h; cutc
    above h is held to the JAX package in the tests above."""
    rng = np.random.default_rng(3)
    n, ns, h = 60, 2, 0.2
    x = rng.uniform(0.05, 0.95, size=(n, 2))
    ptype = rng.integers(0, 2, size=n)
    solid = rng.random(n) < 0.4
    v = rng.normal(0, 0.1, size=(n, 3))
    vest = v + rng.normal(0, 0.02, size=(n, 3))
    v[:, 2] = vest[:, 2] = 0.0
    rho = rng.uniform(0.97, 1.05, size=n)
    rhoI = rho + rng.normal(0, 0.005, size=n)
    C = rng.uniform(0, 1, size=(n, ns))
    mass, rho0, c0 = np.array([0.01, 0.012]), np.ones(2), np.full(2, 10.0)
    cut, cutc = np.full((2, 2), h), np.full((2, 2), cutc_scale * h)
    visc = np.array([[0.1, 0.12], [0.12, 0.15]])
    kappa = rng.uniform(0.02, 0.08, (2, 2, ns))
    kappa = 0.5 * (kappa + kappa.transpose(1, 0, 2))

    geom = TS.Geometry.build(dim=2, lo=(0, 0, 0), hi=(1, 1, 0.1), cutoff=h,
                             cap=32)
    st = TS.state_from_particles(geom, x, ptype, n_sdpd=ns,
                                 dtype=torch.float64, device="cpu")
    st = TS._neutralize_invalid(TS.scatter_by_tag(
        st, v=v, vest=vest, rho=rho, rhoI=rhoI, C=C,
        solid_tag=solid.astype(np.int32), fixed_tag=solid.astype(np.int32)))
    t64 = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    params = TS.Params(
        mass=t64(mass), rho0=t64(rho0), c0=t64(c0), B=t64(tait_b(c0, rho0)),
        G0=torch.zeros(2, dtype=torch.float64), cut=t64(cut), cutc=t64(cutc),
        visc=t64(visc), kappa=t64(kappa),
        kappa_ssa=torch.zeros((2, 2, 0), dtype=torch.float64))
    cfg = tpair.PairConfig.transport_velocity(
        dim=2, elastic_present=False, free_solids_present=False,
        weighted_solid=False)
    got = TS.gather_particles(tpair.compute_forces(st, params, geom, cfg), geom,
                              fields=("Q", "drho", "num_den"))
    x3 = np.concatenate([x, np.zeros((n, 1))], axis=1)
    ref = compute_reference(
        x3, v, vest, rho, rhoI, C, np.zeros((n, 3, 3)), ptype, solid, solid,
        mass, tait_b(c0, rho0), rho0, c0, np.zeros(2), cut, cutc, visc, kappa,
        dim=2, variant="transport_velocity")
    assert float(np.abs(ref["Q"]).max(axis=0).min()) > 0
    for name in ("Q", "drho", "num_den"):
        scale = float(np.abs(ref[name]).max())
        np.testing.assert_allclose(got[name], ref[name], rtol=1e-9,
                                   atol=1e-11 * scale, err_msg=name)


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_pass_a_3d_with_species_matches_jax(dt):
    """3D pass A (27 offsets, K3's plain version) with two species and
    cutc = 0.8 h on a seeded particle cloud of fixed solids and fluid
    (``tests/test_pair_3d.py``'s construction), port vs JAX jnp path."""
    dtype = np.float64 if dt == "f64" else np.float32
    rng = np.random.default_rng(11)
    n, ns, h = 160, 2, 0.3
    x = rng.uniform(0.05, 0.95, size=(n, 3))
    ptype = rng.integers(0, 2, size=n)
    solid = (rng.random(n) < 0.3).astype(np.int32)
    v = rng.normal(0, 0.1, size=(n, 3))
    geom = JS.Geometry.build(dim=3, lo=(0, 0, 0), hi=(1, 1, 1), cutoff=h, cap=48)
    assert len(geom.stencil_offsets()) == 27
    st = JS.state_from_particles(geom, x, ptype, n_sdpd=ns, dtype=jnp.float64)
    st = JS.scatter_by_tag(
        st, v=v, vest=v + rng.normal(0, 0.02, size=(n, 3)),
        rho=rng.uniform(1.0, 1.1, size=n), rhoI=rng.uniform(1.0, 1.1, size=n),
        C=rng.uniform(0, 1, size=(n, ns)), solid_tag=solid, fixed_tag=solid)
    s = bridge.to_numpy(st)
    s["rho"] = np.where(s["valid"], s["rho"], 1.0)
    s["rhoI"] = np.where(s["valid"], s["rhoI"], 1.0)
    kappa = rng.uniform(0.02, 0.08, (2, 2, ns))
    p = dict(mass=np.array([0.01, 0.012]), rho0=np.ones(2), c0=np.full(2, 10.0),
             B=np.asarray(tait_b(np.full(2, 10.0), np.ones(2))), G0=np.zeros(2),
             cut=np.full((2, 2), h), cutc=np.full((2, 2), 0.8 * h),
             visc=np.array([[0.1, 0.12], [0.12, 0.15]]),
             kappa=0.5 * (kappa + kappa.transpose(1, 0, 2)),
             kappa_ssa=np.zeros((2, 2, 0)))
    s, p = _cast(s, dtype), _cast(p, dtype)
    cfg = jpair.PairConfig.transport_velocity(
        dim=3, elastic_present=False, free_solids_present=False,
        weighted_solid=False, use_pallas=False)
    jparams = _jax(JS.Params, p)
    ref = bridge.to_numpy(jpair.compute_forces(_jax(JS.State, s), jparams,
                                               geom, cfg))
    tgeom = TS.Geometry(**dataclasses.asdict(geom))
    assert pair_cuda.route(tgeom, cfg) is pair_cuda.pass_a_3d
    got = bridge.state_from_port(tpair.compute_forces(
        bridge.state_to_port(s, device="cpu"),
        bridge.params_to_port(jparams, device="cpu"), tgeom,
        bridge._plain(tpair.PairConfig, cfg)))
    assert float(np.abs(ref["Q"]).max(axis=(1, 2)).min()) > 0
    for name in FIELDS:
        _close(got[name], ref[name], dt == "f64", name)


# ---------------------------------------------------------------------------
# fixes and the integrator's species half-steps
# ---------------------------------------------------------------------------


def _fix_state(step):
    """A seeded f64 N=12 convection state with two continuum and one SSA
    species, nonzero f, Q and v, at ``step``; and its params."""
    js, jp, _, jsc = jconv.build(N=12)
    s, p = bridge.to_numpy(js), bridge.to_numpy(jp)
    rng = np.random.default_rng(step + 1)
    valid = s["valid"]
    for name in ("v", "vest", "f"):
        s[name] = np.where(valid, rng.normal(0, 0.1, s[name].shape), 0.0)
    s["C"] = np.where(valid, rng.uniform(0, 1, (2,) + valid.shape), 0.0)
    s["Q"] = np.where(valid, rng.normal(0, 1.0, (2,) + valid.shape), 0.0)
    s["Cd"] = np.where(valid, rng.integers(0, 50, (1,) + valid.shape), 0
                       ).astype(np.int32)
    s["Qd"] = np.zeros_like(s["Cd"])
    s["step"] = np.asarray(step, np.int32)
    s["dt"] = np.asarray(1e-4)
    p["kappa"] = np.full((2, 2, 2), 0.01)
    p["kappa_ssa"] = np.full((2, 2, 1), 0.01)
    return _cast(s, np.float64), _cast(p, np.float64), jsc


_GB_ALL, _GB_SPHERE = 1, 4  # group bits of "all" and the cylinder
FIX_CASES = {
    "forcing-tsdpd-rect": ("Forcing", dict(
        groupbit=_GB_SPHERE, field="tsdpd", index=1, shape="rectangle",
        center=(0.0, 0.0), length=2.0, width=2.0, value=0.75, after_step=1)),
    "forcing-tsdpd-circle": ("Forcing", dict(
        groupbit=_GB_ALL, field="tsdpd", index=0, shape="circle",
        center=(0.1, -0.05), radius=0.3, value=0.25, after_step=1)),
    "forcing-ssa": ("Forcing", dict(
        groupbit=_GB_ALL, field="ssa", index=0, shape="rectangle",
        center=(0.2, 0.2), length=0.2, width=0.3, value=7.0, after_step=1)),
    "forcing-velocity": ("Forcing", dict(
        groupbit=_GB_ALL, field="velocity", index=1, shape="circle",
        center=(0.0, 0.0), radius=0.25, value=-0.5, after_step=1)),
    "buoyancy-boussinesq": ("Buoyancy", dict(
        groupbit=_GB_ALL, mode="boussinesq", acceleration=-1.0, dim=1,
        species=1, c_ref=0.2)),
    "buoyancy-gravity": ("Buoyancy", dict(
        groupbit=_GB_SPHERE, mode="gravity", acceleration=-9.81, dim=0)),
    "chem-a-to-b": ("ChemRxnMassAction", dict(
        groupbit=_GB_ALL, k_rate=3.0, reactants=(0,), products=(1,))),
    "chem-a-plus-b": ("ChemRxnMassAction", dict(
        groupbit=_GB_SPHERE, k_rate=0.5, reactants=(0, 1), products=())),
    "dt-adaptive": ("DtAdaptive", dict(
        groupbit=_GB_ALL, cfl=0.25, dx_ave=0.01, tmin=1e-6, tmax=1e-2)),
    "dt-adaptive-clipped": ("DtAdaptive", dict(
        groupbit=_GB_SPHERE, cfl=0.25, dx_ave=0.01, tmin=1e-6, tmax=1e-3)),
}


@pytest.mark.parametrize("step", [1, 2], ids=["at-after_step", "past-after_step"])
@pytest.mark.parametrize("case", list(FIX_CASES))
def test_fix_matches_jax(case, step):
    """Each newly ported fix vs its JAX counterpart on a seeded f64 state:
    every leaf equal (atol 1e-15), the stage equal.  ``Forcing`` changes
    nothing at ``step == after_step`` and clamps its region one step later;
    ``ChemRxnMassAction`` A -> B leaves the sum of Q over species as it
    was."""
    name, kw = FIX_CASES[case]
    s, p, jsc = _fix_state(step)
    assert jsc.groupbit("sphere") == _GB_SPHERE
    jfix, tfix = getattr(jfixes, name)(**kw), getattr(tfixes, name)(**kw)
    assert tfix.stage == jfix.stage
    assert bridge._FIXES[name] is getattr(tfixes, name)
    jparams = _jax(JS.Params, p)
    ref = bridge.to_numpy(jfix.apply(_jax(JS.State, s), jparams))
    got = bridge.state_from_port(tfix.apply(
        bridge.state_to_port(s, device="cpu"),
        bridge.params_to_port(jparams, device="cpu")))
    for leaf in ref:
        assert got[leaf].dtype == ref[leaf].dtype, leaf
        np.testing.assert_allclose(got[leaf], ref[leaf], rtol=0, atol=1e-15,
                                   err_msg=leaf)
    changed = [leaf for leaf in ref if not np.array_equal(ref[leaf], s[leaf])]
    if name == "Forcing":
        leaf = {"tsdpd": "C", "ssa": "Cd", "velocity": "vest"}[kw["field"]]
        assert changed == ([] if step == 1 else [leaf])
        if step == 2:
            hit = got[leaf][kw["index"]] != s[leaf][kw["index"]]
            assert hit.sum() > 3
            assert np.all(got[leaf][kw["index"]][hit] == kw["value"])
    elif name == "Buoyancy":
        assert changed == ["f"]
    elif name == "ChemRxnMassAction":
        assert changed == ["Q"]
        if kw["products"]:
            np.testing.assert_allclose(got["Q"].sum(0), s["Q"].sum(0), rtol=0,
                                       atol=1e-12)
    else:
        assert changed == ["dt"] and kw["tmin"] <= float(got["dt"]) <= kw["tmax"]


def test_forcing_rejects_unknown_field_and_shape():
    with pytest.raises(ValueError, match="forcing field"):
        tfixes.Forcing(groupbit=1, field="density", index=0, shape="circle")
    with pytest.raises(ValueError, match="forcing shape"):
        tfixes.Forcing(groupbit=1, field="tsdpd", index=0, shape="sphere")


@pytest.mark.parametrize("half", ["initial", "final"])
def test_species_halfsteps_match_jax(half):
    """initial_integrate and final_integrate with nonzero Q at f64: C within
    1e-15 of JAX's, the >= 0 clamp active on some particle."""
    s, p, _ = _fix_state(5)
    s["Q"] = s["Q"] * 2e4  # C + Q dt/2 crosses zero on part of the particles
    jparams = _jax(JS.Params, p)
    jcfg = jinteg.IntegratorConfig.transport_velocity()
    tcfg = tinteg.IntegratorConfig.transport_velocity()
    jfn = getattr(jinteg, f"{half}_integrate")
    tfn = getattr(tinteg, f"{half}_integrate")
    ref = bridge.to_numpy(jfn(_jax(JS.State, s), jparams, jcfg))
    got = bridge.state_from_port(tfn(bridge.state_to_port(s, device="cpu"),
                                     bridge.params_to_port(jparams, device="cpu"),
                                     tcfg))
    clamped = s["valid"][None] & (s["C"] + s["Q"] * 0.5e-4 < 0)
    assert clamped.sum() > 10 and np.all(got["C"][clamped] == 0.0)
    assert float(got["C"].min()) == 0.0
    for name in ("C", "x", "v", "vest", "rho"):
        np.testing.assert_allclose(got[name], ref[name], rtol=0, atol=1e-15,
                                   err_msg=name)


def test_steps_f64_match_jax():
    """60 steps of the N=40 convection at f64 from identical inputs (a
    rebin at setup and at steps 0 and 50, Shepard-filter steps at 20, 40
    and 60, the Dirichlet forcing from step 2): x, v, rho, C and Q within
    1e-8, slot assignment (tag, valid) bitwise; heat has left the cylinder
    and qdot agrees."""
    js, jp, jspec, jsc = jconv.build(N=40)
    sa = _cast(bridge.to_numpy(js), np.float64)
    pa = _cast(bridge.to_numpy(jp), np.float64)
    js, jp = _jax(type(js), sa), _jax(type(jp), pa)
    ts = bridge.state_to_port(sa, device="cpu")
    tp = bridge.params_to_port(jp, device="cpu")
    tspec = bridge.spec_to_port(jspec)
    assert ts.C.dtype == torch.float64 and tp.kappa.dtype == torch.float64
    assert tspec.integ.freq_filter == 20 and tspec.rebin_every == 50

    js = jstepper.simulate(jstepper.setup(js, jp, jspec, dt=1e-4), jp, jspec, 60)
    ts = tstepper.simulate(tstepper.setup(ts, tp, tspec, dt=1e-4), tp, tspec, 60)
    a, b = bridge.to_numpy(js), bridge.state_from_port(ts)
    assert int(a["step"]) == int(b["step"]) == 60
    np.testing.assert_array_equal(a["tag"], b["tag"])
    np.testing.assert_array_equal(a["valid"], b["valid"])
    assert int(b["overflow"]) == 0 and int(b["drift_violation"]) == 0
    fluid = b["valid"] & (b["solid_tag"] == 0)
    assert float(b["C"][0][fluid].max()) > 0.05  # heat reached the fluid
    assert float(np.abs(b["v"][:, fluid]).max()) > 1e-6  # and it moves
    for name in ("x", "v", "rho", "C", "Q"):
        np.testing.assert_allclose(b[name], a[name], rtol=0, atol=1e-8,
                                   err_msg=name)
    gb = jsc.groupbit("sphere")
    sel = a["valid"] & ((a["groupmask"] & gb) != 0)
    jq = float(-np.sum(np.where(sel, pa["mass"][a["ptype"]] * a["Q"][0], 0.0)))
    tq = tconv.qdot(ts, tp, gb)
    assert tq > 0 and abs(tq - jq) <= 1e-8 * abs(jq)


# ---------------------------------------------------------------------------
# rebins with the C rows, the scene's regions and commands, the bridge
# ---------------------------------------------------------------------------


def test_rebins_carry_species_rows():
    """The plain walk (K5's plain version), the port's sort rebin and the
    JAX sort rebin on a drifted N=20 convection state with two species and
    nonzero Q: every leaf bitwise; a cross-geometry sort rebin into
    non-uniform x columns (an in-run re-cut) keeps each tag's C and Q;
    invalid slots stay neutral."""
    s, _, jspec = _seeded_convection(np.float32, 2, 1.0)
    rng = np.random.default_rng(2)
    s["Q"] = np.where(s["valid"], rng.normal(0, 1, s["Q"].shape), 0.0
                      ).astype(np.float32)
    binned = bridge.state_to_port(s, device="cpu")  # before the drift
    d = rng.uniform(-0.9, 0.9, s["x"].shape) * jspec.geom.cell_size[0]
    d[2] = 0.0
    s["x"] = (s["x"] + np.where(s["valid"], d, 0.0)).astype(np.float32)
    g = jspec.geom
    tg = TS.Geometry(**dataclasses.asdict(g))
    assert rebin_cuda.move_route(tg) is rebin_cuda.rebin_move_2d
    ref = bridge.to_numpy(JS.rebin(_jax(JS.State, s), g, use_pallas=False))
    walk = TS.rebin(bridge.state_to_port(s, device="cpu"), tg, use_kernel=True)
    sort = TS.rebin(bridge.state_to_port(s, device="cpu"), tg, use_kernel=False)
    for name in ref:
        if name != "key":
            for got in (walk, sort):
                np.testing.assert_array_equal(
                    bridge.state_from_port(got)[name], ref[name], err_msg=name)
    assert int((ref["tag"] != s["tag"]).sum()) > 100
    assert float(np.abs(ref["Q"]).max()) > 0
    for name in ("rho", "rhoI", "num_den", "rhoAux2"):
        assert np.all(ref[name][~ref["valid"]] == 1.0), name

    recut = with_synthetic_edges(tg)
    moved = TS.rebin(binned, recut, use_kernel=False, drift_check=False)
    assert int(moved.overflow) == 0 and int(moved.n_valid) == int(binned.n_valid)
    cells = torch.arange(recut.ncells_total).expand_as(moved.valid)
    assert (TS.cell_index_of(moved.x, recut) == cells)[moved.valid].all()
    before = TS.gather_particles(binned, tg, ("C", "Q", "x"))
    after = TS.gather_particles(moved, recut, ("C", "Q", "x"))
    for name in ("tag", "C", "Q", "x"):
        np.testing.assert_array_equal(after[name], before[name], err_msg=name)


def _regions(mod):
    R = mod.Region
    return {
        "sphere": R.sphere(0.1, -0.2, 0.05, 0.6),
        "circle": R.circle(-0.2, 0.3, 0.5),
        "cylinder-z": R.cylinder("z", 0.1, 0.1, 0.5, -0.3, 0.4),
        "cylinder-x": R.cylinder("x", 0.0, 0.2, 0.4, -0.5, 0.5),
        "cone-y": R.cone("y", 0.0, 0.0, 0.2, 0.7, -0.8, 0.8),
        "plane": R.plane(0.1, 0.0, 0.0, 1.0, 2.0, -0.5),
        "prism": R.prism(-0.5, 0.5, -0.4, 0.6, -0.3, 0.3, 0.2, -0.1, 0.15),
        "prism-flat": R.prism(-0.5, 0.5, -0.4, 0.6, 0.0, 0.0, 0.3, 0.0, 0.0),
        "union": R.union(R.sphere(0.5, 0.5, 0.0, 0.4), R.circle(-0.5, -0.5, 0.3),
                         R.block(-0.1, 0.1, -1, 1, -1, 1)),
        "intersect": R.intersect(R.sphere(0.0, 0.0, 0.0, 0.8),
                                 R.plane(0, 0, 0, 0, 1, 0),
                                 ~R.cylinder("z", 0, 0, 0.2, -1, 1)),
    }


@pytest.mark.parametrize("name", list(_regions(tscene)))
def test_region_matches_jax(name):
    """Each region the port gained vs the JAX package's on 4,000 seeded
    points (a tenth with z = 0, for the flat prism): the same membership,
    neither empty nor everything."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (4000, 3))
    x[::10, 2] = 0.0
    got = _regions(tscene)[name].contains(x)
    np.testing.assert_array_equal(got, _regions(jscene)[name].contains(x))
    assert 0 < got.sum() < len(x)


def test_degenerate_regions_raise():
    with pytest.raises(ValueError, match="hi > lo"):
        tscene.Region.cone("z", 0, 0, 0.1, 0.2, 1.0, 1.0)
    with pytest.raises(ValueError, match="nonzero"):
        tscene.Region.plane(0, 0, 0, 0, 0, 0)


def test_scene_commands_match_jax():
    """``delete_atoms`` (per-atom arrays set before it included),
    ``set_type`` and ``group_type`` vs the JAX scene on a small lattice:
    positions, types, group masks and per-atom values equal; and a
    buoyancy along a periodic axis is refused at build."""
    scenes = []
    for mod in (jscene, tscene):
        R = mod.Region
        sc = mod.Scene(dim=2, n_sdpd=1)
        sc.create_box(3, R.block(0, 1, 0, 1, 0, 0.1))
        sc.lattice("sq", 0.05)
        sc.create_atoms(1, R.block(0, 1, 0, 1))
        sc.group_region("left", R.block(0, 0.5, 0, 1))
        sc.set("left", C=(0, 0.5), rho=2.0)
        sc.delete_atoms(R.circle(0.5, 0.5, 0.2))
        sc.create_atoms(2, R.circle(0.5, 0.5, 0.1))
        sc.group_type("disk", 2)
        sc.group_region("top", R.block(0, 1, 0.8, 1))
        sc.set_type("top", 3)
        sc.group_type("lid", 3)
        scenes.append(sc)
    j, t = scenes
    np.testing.assert_array_equal(np.asarray(j._x), t._x)
    np.testing.assert_array_equal(np.asarray(j._type), t._type)
    np.testing.assert_array_equal(np.asarray(j._groupmask), t._groupmask)
    assert j._groups == t._groups
    for name in ("disk", "lid", "left"):
        np.testing.assert_array_equal(j.in_group(name), t.in_group(name))
    assert 0 < t.in_group("disk").sum() < t.in_group("lid").sum() < len(t._x)
    for key in ("C", "rho"):
        np.testing.assert_array_equal(j._per_atom[key], t._per_atom[key])

    sc = tscene.Scene(dim=2, boundary=("f", "p", "p"))
    sc.create_box(1, tscene.Region.block(0, 1, 0, 1, 0, 0.1)).lattice("sq", 0.05)
    sc.create_atoms(1, tscene.Region.block(0, 1, 0, 1)).mass(1, 1.0)
    sc.pair_style("transport_velocity").pair_coeff(1, 1, 1.0, 10.0, 0.1, 0.125,
                                                   0.125, 0.0)
    sc.fix(tfixes.Buoyancy(groupbit=1, mode="gravity", acceleration=-1.0, dim=1))
    sc.timestep(1e-4)
    with pytest.raises(ValueError, match="periodic dimension 1"):
        sc.build(device="cpu")


def test_bridge_round_trip_with_two_species():
    """State, Params and ModelSpec with two species and the convection's
    fixes through the bridge and back: every leaf, table and config
    field unchanged."""
    s, p, jspec = _seeded_convection(np.float32, 2, 1.2)
    tstate = bridge.state_to_port(s, device="cpu")
    assert tuple(tstate.C.shape) == (2,) + s["valid"].shape
    back = bridge.state_from_port(tstate)
    for name in s:
        assert back[name].dtype == s[name].dtype, name
        np.testing.assert_array_equal(back[name], s[name], err_msg=name)
    tparams = bridge.params_to_port(_jax(JS.Params, p), device="cpu")
    assert tparams.n_sdpd == 2 and tuple(tparams.kappa.shape) == (2, 2, 2)
    for name, a in bridge.to_numpy(tparams).items():
        np.testing.assert_array_equal(a, p[name], err_msg=name)
    tspec = bridge.spec_to_port(jspec)
    assert [type(f) for f in tspec.fixes] == \
        [tfixes.Buoyancy, tfixes.Forcing, tfixes.Forcing]
    classes = dict(ModelSpec=jstepper.ModelSpec, Geometry=JS.Geometry,
                   PairConfig=jpair.PairConfig,
                   IntegratorConfig=jinteg.IntegratorConfig,
                   Buoyancy=jfixes.Buoyancy, Forcing=jfixes.Forcing)
    assert bridge.spec_from_port(tspec, classes) == jspec


def test_species_limit_and_routes():
    """K1, K2 and K3 take up to ``MAX_SPECIES`` species and say so beyond;
    the convection grid routes to K1 and K5."""
    _, _, spec, _ = tconv.build(N=12, device="cpu")
    assert pair_cuda.route(spec.geom, spec.pair) is pair_cuda.pass_a_2d
    assert rebin_cuda.move_route(spec.geom) is rebin_cuda.rebin_move_2d
    assert pair_cuda.kernel_unsupported(spec.geom, spec.pair, n_sdpd=1) == []
    assert pair_cuda.kernel_unsupported(
        spec.geom, spec.pair, n_sdpd=pair_cuda.MAX_SPECIES) == []
    over = pair_cuda.kernel_unsupported(spec.geom, spec.pair,
                                        n_sdpd=pair_cuda.MAX_SPECIES + 1)
    assert len(over) == 1 and "continuum species" in over[0]
    for n_sdpd, refused in ((1, []), (pair_cuda.MAX_SPECIES, []),
                            (pair_cuda.MAX_SPECIES + 1, over)):
        assert pair_cuda.kernel_unsupported(
            spec.geom, spec.pair, pair_cuda.pass_a_2d_rowloop,
            n_sdpd=n_sdpd) == refused


def test_species_tables_and_packed_rows():
    """The species table K1, K2 and K3 read ([4 + Ns, T*T]: 1/cutc, the W'
    factor of cutc, twice the harmonic mass, 0.01 cutc^2, kappa) against
    the plain path's coefficient tables, and the launcher's check on a
    two-species state (K1 and K2 take it; one species past the limit is
    refused)."""
    s, p, jspec = _seeded_convection(np.float32, 2, 1.2)
    tspec = bridge.spec_to_port(jspec)
    params = bridge.params_to_port(_jax(JS.Params, p), device="cpu")
    stab = pair_cuda._species_tables(params, tspec.pair).numpy()
    tabs = {k: v.numpy().reshape(-1)
            for k, v in tpair.coeff_tables(params, tspec.pair).items()}
    assert stab.shape == (6, 4) and stab.dtype == np.float32
    np.testing.assert_array_equal(stab[0], tabs["inv_hc"])
    np.testing.assert_allclose(stab[1], -12 * (5 / np.pi) * tabs["inv_hc"] ** 4,
                               rtol=1e-6)
    np.testing.assert_array_equal(stab[2], 2 * tabs["m_harm"])
    np.testing.assert_allclose(stab[3], 0.01 * tabs["hc"] ** 2, rtol=1e-6)
    np.testing.assert_array_equal(
        stab[4:], np.moveaxis(p["kappa"], -1, 0).reshape(2, 4))
    state = bridge.state_to_port(s, device="cpu")
    pf = tpair._per_particle(state, params, tspec.pair)
    pair_cuda._check_launch(pf, params, tspec.geom, tspec.pair,
                            pair_cuda.pass_a_2d)
    assert tuple(pf["C"].shape) == (2, tspec.geom.cap, tspec.geom.ncells_total)
    pair_cuda._check_launch(pf, params, tspec.geom, tspec.pair,
                            pair_cuda.pass_a_2d_rowloop)
    five = pair_cuda.MAX_SPECIES + 1
    over = dataclasses.replace(params, kappa=torch.zeros((2, 2, five)))
    for kernel in (pair_cuda.pass_a_2d, pair_cuda.pass_a_2d_rowloop):
        with pytest.raises(NotImplementedError, match="continuum species"):
            pair_cuda._check_launch(pf, over, tspec.geom, tspec.pair, kernel)


def test_build_defaults_to_the_card():
    """``natural_convection.build()`` with no device builds on the card:
    CUDA tensors where there is one, torch's CUDA error where there is
    none (never a quiet build on the CPU)."""
    if torch.cuda.is_available():
        state, params, _, _ = tconv.build(N=12)
        assert state.C.is_cuda and params.kappa.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            tconv.build(N=12)
