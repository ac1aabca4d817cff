"""The 3D drifting blob and K7 with ``x_edges`` on a periodic grid, in the
PyTorch port against the JAX package.

``models/drift_blob.scene(..., nz_cells=3)`` is a ``Scene`` function that
both packages run: the load-balance scene extruded over 3 periodic z cells
(x and z periodic, no solids, pure advection at v = 2), cut into
non-uniform x columns by ``Scene.balance(8)`` and re-cut in the run by
``Scene.fix_balance(8)``.  Pass A takes K3 (``csrc/pass_a_3d.cu``) and every
in-place rebin K7 (``csrc/rebin_move_3d.cu``) with ``x_edges`` on the
periodic grid.  The kernels run on a card only, so here their plain
versions are held to the JAX package on the CPU:

- the s=1 builds, balanced and uniform, bitwise (``x_edges`` included),
  and their routes;
- a setup and one step at f64 from identical inputs, its rebin through the
  walk on the balanced grid: slots bitwise, fields within 1e-8;
- the re-cuts of the blob under pure advection (numpy), the JAX package's
  binning and ``rebalance`` against the port's: equal logs, the accepted
  edges included;
- K7's plain walk against both sorts after a drift across the x and z
  seams of the balanced grid, bitwise.

The plain pass A walks [cap, cap, NC] blocks (cap 86), ~16 s an f64 call
here on one thread over pieces of 16 target cells, so the run is one step.
K7 itself is held to the plain walk and the sort on the card by the
``gpu``-marked tests of ``tests/test_torch_kernels.py``, which import no
JAX.
"""

import dataclasses
import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_bvf_tpu.api import scene as jscene
from sph_bvf_tpu.core import state as JS
from sph_bvf_tpu.core import stepper as jstepper
from sph_bvf_tpu.parallel import balance as jbal
from sph_bvf_tpu_torch import bridge
from sph_bvf_tpu_torch.core import rebin_cuda
from sph_bvf_tpu_torch.core import state as TS
from sph_bvf_tpu_torch.core import stepper as tstepper
from sph_bvf_tpu_torch.models import drift_blob
from sph_bvf_tpu_torch.ops import pair as tpair
from sph_bvf_tpu_torch.ops import pair_cuda
from sph_bvf_tpu_torch.parallel import balance as tbal
from synthetic_edges import seam_drift

NZ = 3  # periodic z cells


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


@functools.lru_cache(maxsize=None)
def _jax_build(s, balance):
    """The JAX package's build of the 3D blob at scale ``s``: (state numpy,
    params numpy, spec)."""
    js, jp, jspec = drift_blob.scene(s, balance, balance, NZ, jscene.Scene,
                                     jscene.Region).build()
    return bridge.to_numpy(js), bridge.to_numpy(jp), jspec


@pytest.mark.parametrize("balance", [True, False], ids=["balanced", "uniform"])
def test_scene_builds_match_jax_and_route_to_k3_and_k7(balance):
    """The 3D blob at s=1 built by both packages (20,790 particles; x and z
    periodic; balanced: 16 x 8 x 3 cells of cap 86 with ``x_edges``,
    uniform: 32 x 8 x 3): the same spec, ``BalanceFix`` included, and every
    state leaf bitwise.  K3 serves its pass A (solid-free) and K7 its
    rebin, ``x_edges`` on the periodic grid included."""
    ref, _, jspec = _jax_build(1, balance)
    ts, _, tspec, sc = drift_blob.build(1, balance, balance, device="cpu",
                                        nz_cells=NZ)
    g, cfg = tspec.geom, tspec.pair
    assert dataclasses.asdict(g) == dataclasses.asdict(jspec.geom)
    assert (dataclasses.asdict(tspec.integ) == dataclasses.asdict(jspec.integ)
            and dataclasses.asdict(cfg) == dataclasses.asdict(jspec.pair))
    if balance:
        assert sc.balance_applied and g.x_edges is not None
        assert tspec.balance == tbal.BalanceFix(**dataclasses.asdict(jspec.balance))
    got = bridge.state_from_port(ts)
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    assert int(ts.n_valid) == 20_790 and g.cap == drift_blob.CAP3D
    assert g.ncells == ((16 if balance else 32), 8, NZ)
    assert g.periodic == (True, False, True) and not cfg.solids_present
    assert pair_cuda.route(g, cfg) is pair_cuda.pass_a_3d
    assert pair_cuda.kernel_unsupported(g, cfg) == []
    assert rebin_cuda.move_route(g) is rebin_cuda.rebin_move_3d
    assert rebin_cuda.move_unsupported(g, rebin_cuda.rebin_move_3d) == []


def test_setup_and_step_match_jax(monkeypatch):
    """Setup and one step at f64 from identical inputs on the balanced s=1
    blob, rebinning after the step (``rebin_every`` 1 in both packages):
    its in-place rebin is the walk K7 runs on the card, with ``x_edges`` on
    the periodic grid.  Slots (tag, valid) bitwise, x, v and rho within
    1e-8 of the JAX package's, no overflow or drift."""
    # the plain pass A over pieces of 16 target cells: the same sums, in a
    # quarter of the time at cap 86
    plain = tpair._pass_a_plain
    monkeypatch.setattr(tpair, "_pass_a_plain", lambda *a, **k: plain(
        *a, **dict(k, cells_per_piece=k.get("cells_per_piece") or 16)))
    ref, pref, jspec = _jax_build(1, True)
    jspec = dataclasses.replace(jspec, rebin_every=1)
    sa, pa = _cast(ref, np.float64), _cast(pref, np.float64)
    js, jp = _jax(JS.State, sa), _jax(JS.Params, pa)
    ts = bridge.state_to_port(sa, device="cpu")
    tp = bridge.params_to_port(jp, device="cpu")
    tspec = bridge.spec_to_port(jspec)
    assert tspec.geom.x_edges is not None and tspec.rebin_every == 1
    dt = drift_blob.timestep(1)
    js = jstepper.simulate(jstepper.setup(js, jp, jspec, dt=dt), jp, jspec, 1)
    ts = tstepper.simulate(tstepper.setup(ts, tp, tspec, dt=dt), tp, tspec, 1)
    a, b = bridge.to_numpy(js), bridge.state_from_port(ts)
    assert int(a["step"]) == int(b["step"]) == 1
    assert int(b["overflow"]) == 0 and int(b["drift_violation"]) == 0
    np.testing.assert_array_equal(a["tag"], b["tag"])
    np.testing.assert_array_equal(a["valid"], b["valid"])
    for key in ("x", "v", "rho"):
        np.testing.assert_allclose(b[key], a[key], rtol=0, atol=1e-8,
                                   err_msg=key)
    assert float(np.abs(b["x"] - bridge.state_from_port(
        bridge.state_to_port(sa, device="cpu"))["x"]).max()) > 0  # it moved


def _sort_binned(cells, x, geom):
    """A sort binning of positions ``x`` [3, n] whose flat cells are
    ``cells``: (valid [cap, NC], x [3, cap, NC], particles past the cap)."""
    cap, NC = geom.cap, geom.ncells_total
    order = np.argsort(cells, kind="stable")
    c = cells[order]
    rank = np.arange(c.size) - np.searchsorted(c, c)
    keep = rank < cap
    valid = np.zeros((cap, NC), bool)
    valid[rank[keep], c[keep]] = True
    xs = np.zeros((3, cap, NC), x.dtype)
    xs[:, rank[keep], c[keep]] = x[:, order[keep]]
    return valid, xs, int((~keep).sum())


ADVECTION_PKGS = {
    "jax": (lambda x, g: np.asarray(JS.cell_index_of(jnp.asarray(x), g)),
            lambda v, x: types.SimpleNamespace(valid=jnp.asarray(v),
                                               x=jnp.asarray(x)),
            jbal.rebalance, JS.Geometry, jbal.BalanceFix),
    "torch": (lambda x, g: TS.cell_index_of(torch.as_tensor(x), g).numpy(),
              lambda v, x: types.SimpleNamespace(valid=torch.as_tensor(v),
                                                 x=torch.as_tensor(x)),
              tbal.rebalance, TS.Geometry, tbal.BalanceFix),
}


def _advected_recuts(pkg, geom, fix, x0, s, steps):
    """``simulate``'s balance checks on the 3D blob replayed under pure
    advection with package ``pkg``'s binning and ``rebalance``: positions
    ``x0`` [3, n] moved 2.0 * dt per step along x, binned and offered to
    ``rebalance`` every ``fix.every`` steps, a cut accepted when its
    binning loses nothing.  Returns one entry per check."""
    cell_of, as_state, rebalance, Geometry, Fix = ADVECTION_PKGS[pkg]
    geom = Geometry(**dataclasses.asdict(geom))
    fix = Fix(**dataclasses.asdict(fix))
    lo, span = geom.lo[0], geom.hi[0] - geom.lo[0]
    log = []
    for step in range(fix.every, steps + 1, fix.every):
        x = x0.copy()
        x[0] = lo + np.mod(x0[0] + 2.0 * drift_blob.timestep(s) * step - lo, span)
        x = x.astype(np.float32)
        valid, xs, lost = _sort_binned(cell_of(x, geom), x, geom)
        new, info = rebalance(as_state(valid, xs), geom, fix)
        ok = new is not None and not _sort_binned(cell_of(x, new), x, new)[2]
        log.append(dict(step=step, lost=lost,
                        edges=new.x_edges if ok else None, **info))
        geom = new if ok else geom
    return log


def test_recuts_under_advection_match_jax():
    """The 3D blob's balance checks under pure advection at s=2 (166,320
    particles) over 200 steps, the JAX package's binning and ``rebalance``
    against the port's on the JAX package's own build: equal logs (every
    ``info``, the accepted edges, the particles past the cap).  Both
    re-cut at step 100 (the fullest cell 80 of cap 86 to 64) and refuse
    at step 200 (no improving edge set under the width constraint)."""
    ref, _, jspec = _jax_build(2, True)
    x0 = ref["x"][:, ref["valid"]].astype(np.float64)
    tspec = drift_blob.build(2, True, True, device="cpu", nz_cells=NZ)[2]
    assert dataclasses.asdict(tspec.geom) == dataclasses.asdict(jspec.geom)
    want = _advected_recuts("jax", jspec.geom, jspec.balance, x0, 2, 200)
    got = _advected_recuts("torch", jspec.geom, jspec.balance, x0, 2, 200)
    assert got == want
    assert [c["step"] for c in want if c["edges"]] == [100]
    assert not any(c["lost"] for c in want)
    assert want[-1].get("reason") == ("no improving edge set under the "
                                      "width constraint")


def test_walk_matches_both_sorts_across_the_seams():
    """K7's candidate order with ``x_edges`` on the periodic grid: the
    port's plain 3D walk (``state.rebin(use_kernel=True)`` on the CPU) on
    the balanced s=1 blob after a seeded drift across the x and z seams,
    against the port's sort rebin and the JAX package's, every leaf
    bitwise (x wraps by the edges' span before its fine bin)."""
    ref, _, jspec = _jax_build(1, True)
    g = jspec.geom
    s = dict(ref, x=seam_drift(ref["x"], ref["valid"], g))
    tg = TS.Geometry(**dataclasses.asdict(g))
    want = bridge.to_numpy(JS.rebin(_jax(JS.State, s), g, use_pallas=False))
    walk = bridge.state_from_port(
        TS.rebin(bridge.state_to_port(s, device="cpu"), tg, use_kernel=True))
    sort = bridge.state_from_port(
        TS.rebin(bridge.state_to_port(s, device="cpu"), tg, use_kernel=False))
    for key in want:
        np.testing.assert_array_equal(walk[key], want[key], err_msg=key)
        np.testing.assert_array_equal(sort[key], want[key], err_msg=key)
    assert int(walk["valid"].sum()) + int(walk["overflow"]) == 20_790
