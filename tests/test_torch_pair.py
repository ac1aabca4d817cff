"""The PyTorch port's pair physics (plain pass A) against the JAX package
and the brute-force f64 reference (``tests/ref_pair.py``).

``compute_forces`` on a CPU tensor runs the plain stencil loop
(``ops/pair._pass_a_plain``), which is also the reference the K1 kernel is
held to on the card.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_bvf_tpu.core import stepper as jstepper
from sph_bvf_tpu.core.state import Params as JParams, State as JState
from sph_bvf_tpu.models import lid_cavity as jlid
from sph_bvf_tpu.ops import pair as jpair
from sph_bvf_tpu_torch import bridge
from sph_bvf_tpu_torch.core import state as TS
from sph_bvf_tpu_torch.ops import pair as tpair
from sph_bvf_tpu_torch.ops.eos import tait_b

from ref_pair import compute_reference

FIELDS = ("f", "drho", "de", "ddv", "phi", "nw", "num_den", "rhoAux1",
          "rhoAux2")


def _jax(cls, arrays):
    return cls(**{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                  for k, v in arrays.items()})


def _perturbed_cavity(dtype):
    """The JAX-built N=50 cavity after setup, with seeded noise on v, vest
    and rho (both pressure signs, every term live), as numpy in ``dtype``."""
    js, jp, jspec, _ = jlid.build(N=50)
    js = jstepper.setup(js, jp, jspec, dt=1e-4)
    s = bridge.to_numpy(js)
    rng = np.random.default_rng(5)
    valid = s["valid"]
    shape3 = s["v"].shape
    s["v"] = s["v"] + np.where(valid, rng.normal(0, 0.05, shape3), 0.0)
    s["vest"] = s["v"] + np.where(valid, rng.normal(0, 0.01, shape3), 0.0)
    s["v"][2] = s["vest"][2] = 0.0
    s["rho"] = np.where(valid, rng.uniform(0.99, 1.01, valid.shape), 1.0)
    s["rhoI"] = np.where(valid, s["rho"] + rng.normal(0, 1e-3, valid.shape), 1.0)
    p = bridge.to_numpy(jp)
    cast = lambda d: {k: (v.astype(dtype) if isinstance(v, np.ndarray)
                          and v.dtype.kind == "f" else v) for k, v in d.items()}
    return cast(s), cast(p), jspec


@pytest.mark.parametrize("filt", [True, False], ids=["filter", "nofilter"])
@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_compute_forces_matches_jax(dt, filt):
    """One force evaluation on the N=50 cavity, port vs JAX jnp path: every
    returned field to rtol 1e-9 at f64 (the ref_pair standard) and to
    5e-6 of the field's max at f32 (sums in another order)."""
    dtype = np.float64 if dt == "f64" else np.float32
    s, p, jspec = _perturbed_cavity(dtype)
    cfg = dataclasses.replace(jspec.pair, density_filter_accs=filt,
                              use_pallas=False)
    jstate, jparams = _jax(JState, s), _jax(JParams, p)
    ref = bridge.to_numpy(jpair.compute_forces(jstate, jparams, jspec.geom, cfg))

    tspec = bridge.spec_to_port(jspec)
    tcfg = bridge._plain(tpair.PairConfig, cfg)
    got = tpair.compute_forces(bridge.state_to_port(s, device="cpu"),
                               bridge.params_to_port(jparams, device="cpu"),
                               tspec.geom, tcfg)
    got = bridge.state_from_port(got)
    for name in FIELDS + ("Q", "Qd", "ddx", "dS", "vws", "aws"):
        a, b = ref[name], got[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        scale = max(float(np.abs(a).max(initial=0.0)), 1e-30)
        if dt == "f64":
            np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-11 * scale,
                                       err_msg=name)
        else:
            assert float(np.abs(b - a).max(initial=0.0)) <= 5e-6 * scale, name
    if not filt:
        assert float(np.abs(got["rhoAux1"]).max()) == 0.0


def _random_system(seed=3, n=60):
    """Fluid and fixed wall particles of two types, f64 (no elastic solid,
    no species: the configuration the port carries)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.05, 0.95, size=(n, 2))
    ptype = rng.integers(0, 2, size=n)
    solid = rng.random(n) < 0.4
    v = rng.normal(0, 0.1, size=(n, 3))
    vest = v + rng.normal(0, 0.02, size=(n, 3))
    v[:, 2] = vest[:, 2] = 0.0
    rho = rng.uniform(0.97, 1.05, size=n)
    rhoI = rho + rng.normal(0, 0.005, size=n)
    h = 0.22
    return dict(
        x=x, v=v, vest=vest, rho=rho, rhoI=rhoI, ptype=ptype, solid=solid,
        mass=np.array([0.01, 0.012]), rho0=np.array([1.0, 1.0]),
        c0=np.array([10.0, 10.0]), G0=np.zeros(2), cut=np.full((2, 2), h),
        cutc=np.full((2, 2), h), visc=np.array([[0.1, 0.12], [0.12, 0.15]]),
        h=h,
    )


@pytest.mark.parametrize("filt", [True, False], ids=["filter", "nofilter"])
def test_compute_forces_matches_bruteforce(filt):
    """Port pass A at f64 vs the O(N^2) transcription of the reference pair
    style, rtol 1e-9.  Every solid is fixed, so only fluid i's force is
    integrated (and compared)."""
    sysd = _random_system()
    n = sysd["x"].shape[0]
    geom = TS.Geometry.build(dim=2, lo=(0, 0, 0), hi=(1, 1, 0.1),
                             cutoff=sysd["h"], cap=32)
    st = TS.state_from_particles(geom, sysd["x"], sysd["ptype"],
                                 dtype=torch.float64, device="cpu")
    st = TS.scatter_by_tag(
        st, v=sysd["v"], vest=sysd["vest"], rho=sysd["rho"], rhoI=sysd["rhoI"],
        solid_tag=sysd["solid"].astype(np.int32),
        fixed_tag=sysd["solid"].astype(np.int32))
    st = TS._neutralize_invalid(st)
    t64 = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    params = TS.Params(
        mass=t64(sysd["mass"]), rho0=t64(sysd["rho0"]), c0=t64(sysd["c0"]),
        B=t64(tait_b(sysd["c0"], sysd["rho0"])), G0=t64(sysd["G0"]),
        cut=t64(sysd["cut"]), cutc=t64(sysd["cutc"]), visc=t64(sysd["visc"]),
        kappa=torch.zeros((2, 2, 0), dtype=torch.float64),
        kappa_ssa=torch.zeros((2, 2, 0), dtype=torch.float64))
    cfg = tpair.PairConfig.transport_velocity(
        dim=2, elastic_present=False, free_solids_present=False,
        weighted_solid=False, density_filter_accs=filt)
    out = tpair.compute_forces(st, params, geom, cfg)
    got = TS.gather_particles(out, geom, fields=FIELDS)

    x3 = np.concatenate([sysd["x"], np.zeros((n, 1))], axis=1)
    ref = compute_reference(
        x3, sysd["v"], sysd["vest"], sysd["rho"], sysd["rhoI"],
        np.zeros((n, 0)), np.zeros((n, 3, 3)), sysd["ptype"], sysd["solid"],
        sysd["solid"], sysd["mass"], tait_b(sysd["c0"], sysd["rho0"]),
        sysd["rho0"], sysd["c0"], sysd["G0"], sysd["cut"], sysd["cutc"],
        sysd["visc"], np.zeros((2, 2, 0)), dim=2, variant="transport_velocity")
    fluid = ~sysd["solid"]
    for name in FIELDS:
        if name in ("rhoAux1", "rhoAux2") and not filt:
            continue
        a, b = ref[name], got[name]
        if name == "f":
            a, b = a[fluid], b[fluid]
        scale = max(float(np.abs(a).max()), 1e-10)
        np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-11 * scale,
                                   err_msg=name)


def test_unported_branches_raise():
    """What the port still lacks raises instead of running other code: a
    multi-device mesh.  The weighted-solid pass B and SSA species (ported)
    run; density diffusion (ported on the plain path and in every pass-A
    kernel) passes K1's launch check; so does the thermal noise (ported),
    and a kernel launch refuses it without the state's dt, step and key."""
    s, p, jspec = _perturbed_cavity(np.float32)
    tspec = bridge.spec_to_port(jspec)
    st = bridge.state_to_port(s, device="cpu")
    params = bridge.params_to_port(_jax(JParams, p), device="cpu")
    with pytest.raises(NotImplementedError, match="multi-device"):
        tpair.compute_forces(st, params, tspec.geom, tspec.pair, mesh=object())
    out = tpair.compute_forces(st, params, tspec.geom,
                               dataclasses.replace(tspec.pair, weighted_solid=True))
    assert float(out.vws.abs().max()) > 0
    ssa = dataclasses.replace(params, kappa_ssa=torch.ones(
        tuple(params.kappa.shape[:2]) + (1,), dtype=params.kappa.dtype))
    st_ssa = dataclasses.replace(st, Cd=torch.zeros((1,) + tuple(st.rho.shape),
                                                    dtype=torch.int32))
    assert tpair.compute_forces(st_ssa, ssa, tspec.geom, tspec.pair).Qd.shape == \
        st_ssa.Cd.shape
    thermal = dataclasses.replace(tspec.pair, thermal=True)
    from sph_bvf_tpu_torch.ops import pair_cuda

    with pytest.raises(ValueError, match="dt, step, key"):
        pair_cuda._check_launch(tpair._per_particle(st, params, thermal), params,
                                tspec.geom, thermal, pair_cuda.pass_a_2d)

    cfg = dataclasses.replace(tspec.pair, ampl_damp=0.1)
    pair_cuda._check_launch(tpair._per_particle(st, params, cfg), params,
                            tspec.geom, cfg, pair_cuda.pass_a_2d)
