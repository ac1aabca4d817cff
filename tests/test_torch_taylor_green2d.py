"""The doubly periodic 2D Taylor-Green vortex and K5 on periodic grids, in the
PyTorch port against the JAX package.

``models/taylor_green2d.scene`` is a ``Scene`` function that both packages
run: [0, 2 pi)^2 periodic, one fluid, no solids, the transport-velocity pair
and integrator, cells of under 3 spacings (``margin_frac`` 0.19, cap 14).
Pass A takes K2 (``base_occ`` 0) and the rebin K5 (``csrc/rebin_move_2d.cu``)
on both periodic axes.  The kernels run on a card only, so here their plain
versions are held to the JAX package on the CPU:

- the scene built bitwise by both packages at N=60, and its routes;
- 100 steps at f64 from identical inputs: slots bitwise, fields within
  1e-8, the kinetic energy decaying as the JAX package's;
- K5's plain walk against the port's sort rebin and the JAX package's on
  the doubly periodic grid, with uniform and non-uniform x columns, after
  seeded drifts across every face and corner and with positions a hair
  below and at the box's ends (the f32 seam), bitwise.

K5 itself is held to the plain walk and the sort on the card by the
``gpu``-marked tests of ``tests/test_torch_kernels.py``, which import no
JAX.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_bvf_tpu.api import scene as jscene
from sph_bvf_tpu.core import state as JS
from sph_bvf_tpu.core import stepper as jstepper
from sph_bvf_tpu_torch import bridge
from sph_bvf_tpu_torch.api import scene as tscene
from sph_bvf_tpu_torch.core import rebin_cuda
from sph_bvf_tpu_torch.core import state as TS
from sph_bvf_tpu_torch.core import stepper as tstepper
from sph_bvf_tpu_torch.models import taylor_green2d as ttg
from sph_bvf_tpu_torch.ops import pair_cuda
from synthetic_edges import any_corner_drift, seam_hairs, with_synthetic_edges

N, STEPS = 60, 100


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


def _tg_velocity(s):
    """``ttg.taylor_green_velocity`` in numpy on a numpy state."""
    x, y = s["x"][0], s["x"][1]
    v = np.stack([np.sin(x) * np.cos(y), -np.cos(x) * np.sin(y),
                  np.zeros_like(x)])
    return dict(s, v=np.where(s["valid"], v, 0.0).astype(s["x"].dtype))


def _built():
    """(JAX state numpy with the vortex's velocity, JAX params, JAX spec),
    the port's build of the same scene checked equal to it."""
    js, jp, jspec = ttg.scene(jscene.Scene, jscene.Region, N=N).build()
    ts, tp, tspec, _ = ttg.build(N, device="cpu")
    assert dataclasses.asdict(tspec.geom) == dataclasses.asdict(jspec.geom)
    for part in ("pair", "integ"):
        assert (dataclasses.asdict(getattr(tspec, part))
                == dataclasses.asdict(getattr(jspec, part)))
    a, b = _tg_velocity(bridge.to_numpy(js)), bridge.state_from_port(ts)
    for key in a:
        if key != "v":
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    np.testing.assert_allclose(b["v"], a["v"], rtol=0, atol=1e-6)
    return a, jp, jspec


def test_scene_matches_jax_and_routes_to_k2_and_k5():
    """The vortex at N=60 built by both packages, bitwise (3,600 particles
    in 20 x 20 doubly periodic cells of cap 14, ``base_occ`` 0, no solids,
    the velocity set on the valid slots): K2 serves its pass A and K5 its
    rebin, and the kinetic energy starts at pi^2 (rho0 L^2 / 4)."""
    _built()
    ts, tp, tspec, _ = ttg.build(N, device="cpu")
    g, cfg = tspec.geom, tspec.pair
    assert g.ncells == (20, 20, 1) and g.cap == 14 and g.base_occ == 0
    assert g.periodic[:2] == (True, True) and not cfg.solids_present
    assert int(ts.n_valid) == N * N
    assert pair_cuda.route(g, cfg) is pair_cuda.pass_a_2d_rowloop
    assert pair_cuda.kernel_unsupported(g, cfg) == []
    assert rebin_cuda.move_route(g) is rebin_cuda.rebin_move_2d
    assert rebin_cuda.move_unsupported(g, rebin_cuda.rebin_move_2d) == []
    assert abs(ttg.kinetic_energy(ts, tp) / math.pi ** 2 - 1.0) < 1e-6
    # at the default margin the cells hold 16 and the rebin takes K6
    wide = ttg.scene(tscene.Scene, tscene.Region, N=N, margin_frac=0.25)
    assert rebin_cuda.move_route(wide.build(device="cpu")[2].geom) is \
        rebin_cuda.rebin_move_2d_gated


def test_steps_match_jax():
    """100 steps at f64 from identical inputs (setup's rebin, then 20
    chunks of 5, each ending in the rebin K5 serves on the card): slots
    (tag, valid) bitwise, x, v and rho within 1e-8 of the JAX package's,
    no overflow or drift, and the kinetic energy ratio the JAX package's,
    inside [0.97, 1.01 x exp(-4 nu t)]."""
    a0, jp, jspec = _built()
    sa = _cast(a0, np.float64)
    pa = _cast(bridge.to_numpy(jp), np.float64)
    js, jp = _jax(JS.State, sa), _jax(JS.Params, pa)
    ts = bridge.state_to_port(sa, device="cpu")
    tp = bridge.params_to_port(jp, device="cpu")
    tspec = bridge.spec_to_port(jspec)
    dt = ttg.timestep(N)
    e0 = ttg.kinetic_energy(ts, tp)
    js = jstepper.simulate(jstepper.setup(js, jp, jspec, dt=dt), jp, jspec, STEPS)
    ts = tstepper.simulate(tstepper.setup(ts, tp, tspec, dt=dt), tp, tspec, STEPS)
    a, b = bridge.to_numpy(js), bridge.state_from_port(ts)
    assert int(a["step"]) == int(b["step"]) == STEPS
    assert int(b["overflow"]) == 0 and int(b["drift_violation"]) == 0
    np.testing.assert_array_equal(a["tag"], b["tag"])
    np.testing.assert_array_equal(a["valid"], b["valid"])
    for key in ("x", "v", "rho"):
        np.testing.assert_allclose(b[key], a[key], rtol=0, atol=1e-8,
                                   err_msg=key)
    ratio = ttg.kinetic_energy(ts, tp) / e0
    decay = math.exp(-4.0 * (ttg.U0 / 100.0) * STEPS * dt)
    assert 0.97 <= ratio <= 1.01 * decay, (ratio, decay)
    rho = b["rho"][b["valid"]]
    assert abs(float(rho.mean()) - 1.0) < 1e-2


@pytest.mark.parametrize("edges", [False, True], ids=["uniform", "x_edges"])
@pytest.mark.parametrize("drift", ["corner", "seam"])
def test_walk_matches_both_sorts_on_the_periodic_grid(edges, drift):
    """K5's candidate order on the doubly periodic grid of cap 14: the
    port's plain walk (``state.rebin(use_kernel=True)`` on the CPU) against
    the port's sort rebin and the JAX package's, every leaf bitwise, after
    a seeded drift across every face and corner (some particles past a
    full cell: overflow) and with positions a hair below and at the box's
    ends, with uniform x columns and with columns of widths 7/8 and 9/8 of
    a cell (x wraps by the edges' span).  At the seam the drift count is
    the port's own (the periodic image, a recorded deviation), not
    JAX's."""
    js, _, jspec = ttg.scene(jscene.Scene, jscene.Region, N=N).build()
    g = jspec.geom
    if edges:
        g = JS.Geometry(**dataclasses.asdict(with_synthetic_edges(
            TS.Geometry(**dataclasses.asdict(g)))))
        js = JS.rebin(js, g, use_pallas=False, drift_check=False)
    tg = TS.Geometry(**dataclasses.asdict(g))
    assert rebin_cuda.move_route(tg) is rebin_cuda.rebin_move_2d
    s = bridge.to_numpy(js)
    if drift == "corner":
        x = any_corner_drift(s["x"], s["valid"], tg)
    else:
        x = seam_hairs(s["x"], s["valid"], tg)
    s = dict(s, x=x)
    ref = bridge.to_numpy(JS.rebin(_jax(JS.State, s), g, use_pallas=False))
    walk = bridge.state_from_port(
        TS.rebin(bridge.state_to_port(s, device="cpu"), tg, use_kernel=True))
    sort = bridge.state_from_port(
        TS.rebin(bridge.state_to_port(s, device="cpu"), tg, use_kernel=False))
    for key in ref:
        np.testing.assert_array_equal(walk[key], sort[key], err_msg=key)
        # the drift count of a position a hair below lo differs by design
        # (ROADMAP, "Drift count on a periodic axis"); every slot is JAX's
        if key != "drift_violation" or drift != "seam":
            np.testing.assert_array_equal(walk[key], ref[key], err_msg=key)
    assert int(walk["valid"].sum()) + int(walk["overflow"]) == N * N
    if drift == "corner":
        assert int(walk["overflow"]) > 0  # cells past cap 14: the drop kept
