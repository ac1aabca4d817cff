"""The PyTorch port's 3D lid-driven cavity against the JAX package.

``models/lid_cavity3d`` is built by both packages at N=6 and N=8 (64 and
125 cells, cap 38, 27 particles a cell) and held to the JAX package on the
CPU: the scene bitwise, one force evaluation (the plain 27-offset pass A,
K3's plain version) at f64 and f32, the rebin (the plain 3D walk, K7's
plain version, against both sorts) under drift and capacity overflow, and
40 steps at f64.  It also holds the repair that the port's entry points
build on the card unless the caller names the CPU.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_bvf_tpu.core import state as JS
from sph_bvf_tpu.core import stepper as jstepper
from sph_bvf_tpu.core.state import Params as JParams
from sph_bvf_tpu.models import lid_cavity3d as jlid3
from sph_bvf_tpu.ops import pair as jpair
from sph_bvf_tpu_torch import bridge
from sph_bvf_tpu_torch.core import rebin_cuda
from sph_bvf_tpu_torch.core import state as TS
from sph_bvf_tpu_torch.core import stepper as tstepper
from sph_bvf_tpu_torch.models import fsi as tfsi
from sph_bvf_tpu_torch.models import lid_cavity as tlid
from sph_bvf_tpu_torch.models import lid_cavity3d as tlid3
from sph_bvf_tpu_torch.ops import pair as tpair
from sph_bvf_tpu_torch.ops import pair_cuda

FIELDS = ("f", "drho", "de", "ddv", "phi", "nw", "num_den", "rhoAux1",
          "rhoAux2")


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


def test_scene_build_matches_jax():
    """Port-built N=8 cavity == JAX-built: geometry, configs, params and
    every state leaf (x, tag, type, group mask, solid/fixed tags, slots)
    bitwise."""
    js, jp, jspec, _ = jlid3.build(N=8)
    ts, tp, tspec, _ = tlid3.build(N=8, device="cpu")
    assert dataclasses.asdict(tspec.geom) == dataclasses.asdict(jspec.geom)
    assert tspec.geom.ncells == (5, 5, 5) and tspec.geom.cap == 38
    assert tspec.geom.base_occ == 27
    assert dataclasses.asdict(tspec.pair) == dataclasses.asdict(jspec.pair)
    assert dataclasses.asdict(tspec.integ) == dataclasses.asdict(jspec.integ)
    assert [dataclasses.asdict(f) for f in tspec.fixes] == \
        [dataclasses.asdict(f) for f in jspec.fixes]
    assert tspec.rebin_every == jspec.rebin_every
    assert int(ts.n_valid) == int(js.n_valid) == 2744
    a, b = bridge.to_numpy(js), bridge.state_from_port(ts)
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    pa, pb = bridge.to_numpy(jp), bridge.to_numpy(tp)
    for name in pa:
        np.testing.assert_array_equal(pa[name], pb[name], err_msg=name)


def _perturbed(dtype):
    """The JAX-built N=6 cavity after setup, with seeded noise on v, vest
    and rho in all three axes (both pressure signs, every term live), as
    numpy in ``dtype``."""
    js, jp, jspec, _ = jlid3.build(N=6)
    js = jstepper.setup(js, jp, jspec, dt=1e-4)
    s = bridge.to_numpy(js)
    rng = np.random.default_rng(5)
    valid = s["valid"]
    s["v"] = s["v"] + np.where(valid, rng.normal(0, 0.05, s["v"].shape), 0.0)
    s["vest"] = s["v"] + np.where(valid, rng.normal(0, 0.01, s["v"].shape), 0.0)
    s["rho"] = np.where(valid, rng.uniform(0.99, 1.01, valid.shape), 1.0)
    s["rhoI"] = np.where(valid, s["rho"] + rng.normal(0, 1e-3, valid.shape), 1.0)
    return _cast(s, dtype), _cast(bridge.to_numpy(jp), dtype), jspec


@pytest.mark.parametrize("filt", [True, False], ids=["filter", "nofilter"])
@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_compute_forces_matches_jax(dt, filt):
    """One force evaluation on the N=6 cavity, port (the plain 27-offset
    pass A) vs the JAX jnp path: every field to rtol 1e-9 at f64 (the
    ref_pair standard) and to 5e-6 of the field's max at f32."""
    dtype = np.float64 if dt == "f64" else np.float32
    s, p, jspec = _perturbed(dtype)
    cfg = dataclasses.replace(jspec.pair, density_filter_accs=filt,
                              use_pallas=False)
    jparams = _jax(JParams, p)
    ref = bridge.to_numpy(jpair.compute_forces(_jax(JS.State, s), jparams,
                                               jspec.geom, cfg))
    tspec = bridge.spec_to_port(jspec)
    assert pair_cuda.route(tspec.geom, tspec.pair) is pair_cuda.pass_a_3d
    got = bridge.state_from_port(tpair.compute_forces(
        bridge.state_to_port(s, device="cpu"),
        bridge.params_to_port(jparams, device="cpu"), tspec.geom,
        bridge._plain(tpair.PairConfig, cfg)))
    for name in FIELDS:
        a, b = ref[name], got[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        scale = max(float(np.abs(a).max(initial=0.0)), 1e-30)
        if dt == "f64":
            np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-11 * scale,
                                       err_msg=name)
        else:
            assert float(np.abs(b - a).max(initial=0.0)) <= 5e-6 * scale, name
    assert float(np.abs(got["f"][2]).max()) > 0  # the z terms are live
    if not filt:
        assert float(np.abs(got["rhoAux1"]).max()) == 0.0


def _drifted(kind):
    """The N=8 cavity after setup as numpy, every valid particle moved in
    all three axes: by seeded noise of up to 0.9 x drift_budget ("budget",
    numpy seed 5), by up to 0.9 cells ("one_ring", seed 4: particles change
    cell, past the drift budget), or the x-plane of cells 1 shifted one
    cell to -x onto plane 0 ("overflow": 54 particles for 38 slots)."""
    js, jp, jspec, _ = jlid3.build(N=8)
    g = jspec.geom
    s = bridge.to_numpy(jstepper.setup(js, jp, jspec, dt=1e-4))
    valid = s["valid"]
    if kind == "overflow":
        cx = (np.arange(g.ncells_total) // g.strides[0])[None, :]
        d = np.zeros_like(s["x"])
        d[0] = np.where(cx == 1, -g.cell_size[0], 0.0)
    else:
        rng = np.random.default_rng(5 if kind == "budget" else 4)
        scale = (g.drift_budget if kind == "budget"
                 else np.asarray(g.cell_size)[:, None, None])
        d = rng.uniform(-0.9, 0.9, s["x"].shape) * scale
        s["v"] = rng.normal(0, 1e-3, s["v"].shape)
    s["x"] = s["x"] + np.where(valid, d, 0.0)
    return _cast(s, np.float32), g


@pytest.mark.parametrize("kind", ["budget", "one_ring", "overflow"])
def test_walk_matches_both_sorts(kind):
    """The port's plain 3D walk (``state.rebin(use_kernel=True)`` on the
    CPU, K7's plain version), the port's sort rebin and the JAX package's
    sort rebin: every leaf bitwise, the overflow and drift counts
    included."""
    s, g = _drifted(kind)
    tg = TS.Geometry(**dataclasses.asdict(g))
    assert rebin_cuda.move_route(tg) is rebin_cuda.rebin_move_3d
    ref = bridge.to_numpy(JS.rebin(_jax(JS.State, s), g, use_pallas=False))
    walk = bridge.state_from_port(
        TS.rebin(bridge.state_to_port(s, device="cpu"), tg, use_kernel=True))
    sort = bridge.state_from_port(
        TS.rebin(bridge.state_to_port(s, device="cpu"), tg, use_kernel=False))
    for name in ref:
        if name != "key":
            np.testing.assert_array_equal(walk[name], ref[name], err_msg=name)
            np.testing.assert_array_equal(sort[name], ref[name], err_msg=name)
    moved = int((ref["tag"] != s["tag"]).sum())
    if kind == "budget":
        assert int(walk["overflow"]) == 0 and int(walk["drift_violation"]) == 0
    else:
        assert moved > 100 and int(walk["drift_violation"]) > 100
    if kind == "overflow":
        # every cell of plane 0 keeps cap of its own and plane 1's particles
        occ = s["valid"].sum(0).reshape(g.ncells[0], -1)
        lost = np.maximum(occ[0] + occ[1] - g.cap, 0).sum()
        assert lost > 0 and int(walk["overflow"]) == lost


def test_steps_f64_match_jax():
    """40 steps of the N=6 cavity at f64 from identical inputs (a rebin at
    setup and before each of four chunks, Shepard-filter steps at 20 and
    40): x, v and rho within 1e-8, slot assignment (tag, valid) bitwise."""
    js, jp, jspec, _ = jlid3.build(N=6)
    sa = _cast(bridge.to_numpy(js), np.float64)
    pa = _cast(bridge.to_numpy(jp), np.float64)
    js, jp = _jax(type(js), sa), _jax(type(jp), pa)
    ts = bridge.state_to_port(sa, device="cpu")
    tp = bridge.params_to_port(jp, device="cpu")
    tspec = bridge.spec_to_port(jspec)
    assert ts.x.dtype == torch.float64 and tp.mass.dtype == torch.float64
    assert tspec.integ.freq_filter == 20 and tspec.rebin_every == 10

    js = jstepper.simulate(jstepper.setup(js, jp, jspec, dt=1e-4), jp, jspec, 40)
    ts = tstepper.simulate(tstepper.setup(ts, tp, tspec, dt=1e-4), tp, tspec, 40)
    a, b = bridge.to_numpy(js), bridge.state_from_port(ts)
    assert int(a["step"]) == int(b["step"]) == 40
    np.testing.assert_array_equal(a["tag"], b["tag"])
    np.testing.assert_array_equal(a["valid"], b["valid"])
    assert int(b["overflow"]) == 0 and int(b["drift_violation"]) == 0
    fluid = b["valid"] & (b["solid_tag"] == 0)
    assert float(np.abs(b["v"][:, fluid]).max()) > 1e-3  # the lid drives
    for name in ("x", "v", "rho"):
        np.testing.assert_allclose(b[name], a[name], rtol=0, atol=1e-8,
                                   err_msg=name)


@pytest.mark.parametrize("model", ["lid_cavity", "fsi", "lid_cavity3d"])
def test_build_defaults_to_the_card(model):
    """``build()`` with no device builds on the card: CUDA tensors where
    there is one, torch's CUDA error where there is none (never a quiet
    build on the CPU)."""
    build = {"lid_cavity": lambda: tlid.build(N=8),
             "fsi": lambda: tfsi.build(nx=8),
             "lid_cavity3d": lambda: tlid3.build(N=6)}[model]
    if torch.cuda.is_available():
        state, params, _, _ = build()
        assert state.x.is_cuda and params.mass.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            build()
