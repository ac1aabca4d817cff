"""The PyTorch port's cell-slot state and rebins against the JAX package.

The sort rebin is the executable spec of the rebin-move kernel (K5): its
slot assignment must equal the JAX package's bit for bit, and the plain
K5 walk (``core/rebin_cuda.rebin_move_plain``, what ``rebin`` runs on a
CPU tensor) must equal the sort whenever the drift contract holds.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_bvf_tpu.core import halo as JH
from sph_bvf_tpu.core import state as JS
from sph_bvf_tpu_torch import bridge
from sph_bvf_tpu_torch.core import halo as TH
from sph_bvf_tpu_torch.core import rebin_cuda
from sph_bvf_tpu_torch.core import state as TS
from sph_bvf_tpu_torch.models import lid_cavity as tlid

DTYPES = {"f32": (jnp.float32, torch.float32, np.float32),
          "f64": (jnp.float64, torch.float64, np.float64)}


def _geom_pair(**kw):
    return JS.Geometry.build(**kw), TS.Geometry.build(**kw)


def _assert_same(jstate, tstate, names=None):
    a, b = bridge.to_numpy(jstate), bridge.state_from_port(tstate)
    for name in names or a:
        if name == "key":
            continue
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_sort_rebin_matches_jax(dt):
    """Initial binning and a rebin after a drift: every leaf bitwise."""
    jdt, tdt, ndt = DTYPES[dt]
    jg, tg = _geom_pair(dim=2, lo=(0.0, 0.0, 0.0), hi=(1.0, 1.0, 0.1),
                        cutoff=0.1, cap=20, margin=0.02)
    rng = np.random.default_rng(11)
    n = 400
    x = rng.uniform(0.0, 1.0, size=(n, 2))
    ptype = rng.integers(0, 2, size=n)
    js = JS.state_from_particles(jg, x, ptype, dtype=jdt)
    ts = TS.state_from_particles(tg, x, ptype, dtype=tdt, device="cpu")
    _assert_same(js, ts)
    assert int(ts.overflow) == 0

    # drift every particle inside the budget, then rebin through the sort
    d = (rng.uniform(-1, 1, size=tuple(ts.x.shape))
         * 0.9 * tg.drift_budget).astype(ndt)
    d[2] = 0.0
    js = dataclasses.replace(js, x=js.x + jnp.where(js.valid, d, 0.0))
    ts = dataclasses.replace(ts, x=ts.x + torch.where(ts.valid, torch.from_numpy(d), 0.0))
    jr = JS.rebin(js, jg, use_pallas=False)
    tr = TS.rebin(ts, tg, use_kernel=False)
    _assert_same(jr, tr)
    # and the cell index of every position agrees
    np.testing.assert_array_equal(
        np.asarray(JS.cell_index_of(js.x, jg)),
        TS.cell_index_of(ts.x, tg).numpy())


def _drifted_n200(seed, scale):
    """The N=200 flagship grid with every valid particle moved by seeded
    noise of ``scale`` drift budgets, and a recognizable v pattern."""
    state, params, spec, _ = tlid.build(N=200, device="cpu")
    geom = spec.geom
    assert geom.ncells_total == 4761 and geom.cap == 14
    rng = np.random.default_rng(seed)
    d = rng.uniform(-1.0, 1.0, size=tuple(state.x.shape)).astype(np.float32)
    d[2] = 0.0
    d = torch.from_numpy(d) * float(scale * geom.drift_budget)
    v = torch.from_numpy(rng.normal(0, 1e-3, size=tuple(state.v.shape))
                         .astype(np.float32))
    state = dataclasses.replace(
        state, x=state.x + torch.where(state.valid, d, 0.0), v=state.v + v)
    return state, spec


@pytest.mark.parametrize("drop", [False, True])
def test_plain_walk_matches_sort_on_n200_grid(drop):
    """The plain K5 walk == the sort rebin, every leaf bitwise, on the
    N=200 cavity grid after a drift inside the budget."""
    state, spec = _drifted_n200(seed=3, scale=0.9)
    geom = spec.geom
    assert rebin_cuda.move_supported(geom)
    dropped = TS.rebin_droppable(False) if drop else ()
    ref = TS.rebin(state, geom, drop=dropped, use_kernel=False)
    got = TS.rebin(state, geom, drop=dropped, use_kernel=True)
    assert int(ref.overflow) == 0 and int(ref.drift_violation) == 0
    for f in dataclasses.fields(ref):
        assert torch.equal(getattr(ref, f.name), getattr(got, f.name)), f.name


@pytest.mark.parametrize("cap, periodic", [
    (96, (False, False, True)),  # K6's lists within the default 48 KB
    (400, (True, True, True)),  # past it: the opt-in shared memory
])
def test_k6_walk_past_cap_64_matches_jax_sort(cap, periodic):
    """K6 past cap 64: on a seeded 2D state of 4 x 4 cells holding more
    than 64 particles each, each moved by up to 0.45 of a cell an axis
    (many across a cell face, past the drift budget), the plain walk
    (what ``rebin`` runs through K6's wrapper on a CPU tensor) gives JAX's
    sort rebin, every leaf bitwise, and equals the numpy emulation of the
    kernels' warp walk (``tests/warp_walk.py``) on the same packs."""
    from warp_walk import warp_walk

    jg, tg = _geom_pair(dim=2, lo=(0.0, 0.0, 0.0), hi=(1.0, 1.0, 0.1),
                        cutoff=0.22, cap=cap, margin=0.02, periodic=periodic)
    assert tg.ncells[:2] == (4, 4)
    assert rebin_cuda.move_route(tg) is rebin_cuda.rebin_move_2d_gated
    assert not rebin_cuda.sort_route(tg)
    rng = np.random.default_rng(cap)
    n = int(0.7 * cap * 16)
    x = rng.uniform(0.0, 1.0, size=(n, 2))
    ptype = rng.integers(0, 2, size=n)
    js = JS.state_from_particles(jg, x, ptype, dtype=jnp.float32)
    ts = TS.state_from_particles(tg, x, ptype, dtype=torch.float32, device="cpu")
    assert int(ts.overflow) == 0 and int(ts.valid.sum(0).max()) > 64
    d = (rng.uniform(-0.45, 0.45, size=tuple(ts.x.shape))
         * tg.cell_size[0]).astype(np.float32)
    d[2] = 0.0
    js = dataclasses.replace(js, x=js.x + jnp.where(js.valid, d, 0.0))
    ts = dataclasses.replace(ts, x=ts.x + torch.where(ts.valid, torch.from_numpy(d), 0.0))
    before = rebin_cuda.rebin_move_2d_gated.launches
    tr = TS.rebin(ts, tg, use_kernel=True)
    assert rebin_cuda.rebin_move_2d_gated.launches == before  # the plain walk
    jr = JS.rebin(js, jg, use_pallas=False)
    _assert_same(jr, tr)
    assert int(tr.overflow) == 0 and int(tr.valid.sum(0).max()) > 64
    assert int(tr.drift_violation) > 0  # the moves passed the budget
    fields = TS.particle_fields(ts)
    fields["x"] = TS.wrap_pbc(fields["x"], tg)
    PF, PI, fmeta, _ = rebin_cuda._pack_fields(fields, cap, tg.ncells_total)
    xr = rebin_cuda._x_row(fmeta)
    plain_f, plain_i = rebin_cuda.rebin_move_plain(PF, PI, tg, xr)
    emu_f, emu_i = warp_walk(PF, PI, tg, xr)
    assert torch.equal(emu_f, plain_f) and torch.equal(emu_i, plain_i)


def test_overflow_count_matches():
    """An over-full cell: JAX's sort, the port's sort and the port's plain
    walk all drop and count the same particles."""
    jg, tg = _geom_pair(dim=2, lo=(0, 0, 0), hi=(1, 1, 0.1), cutoff=0.5, cap=2)
    x = np.full((5, 2), 0.1)  # 5 particles in one cell, cap 2
    js = JS.state_from_particles(jg, x, np.zeros(5, int))
    ts = TS.state_from_particles(tg, x, np.zeros(5, int), device="cpu")
    assert int(js.overflow) == int(ts.overflow) == 3
    _assert_same(js, ts)

    # crowd the N=200 grid: odd x-columns move one cell left (a one-ring
    # move), so even columns end above cap
    state, spec = _drifted_n200(seed=2, scale=0.2)
    geom = spec.geom
    cs = geom.cell_size[0]
    cx = torch.floor((state.x[0] - geom.lo[0]) / cs).to(torch.int32)
    odd = (cx % 2 == 1) & state.valid
    x = state.x.clone()
    x[0] = x[0] + torch.where(odd, -cs, 0.0)
    state = dataclasses.replace(state, x=x)
    ref = TS.rebin(state, geom, use_kernel=False)
    got = TS.rebin(state, geom, use_kernel=True)
    assert int(ref.overflow) > 0
    for f in dataclasses.fields(ref):
        assert torch.equal(getattr(ref, f.name), getattr(got, f.name)), f.name


@pytest.mark.parametrize("periodic", [(False, False, False), (True, False, False)])
def test_shift_cells_matches_jax(periodic):
    jg, tg = _geom_pair(dim=2, lo=(0, 0, 0), hi=(1, 1, 0.1), cutoff=0.2,
                        cap=3, periodic=periodic)
    a = np.arange(tg.cap * tg.ncells_total, dtype=np.float32).reshape(
        tg.cap, tg.ncells_total)
    for off in tg.stencil_offsets():
        np.testing.assert_array_equal(
            np.asarray(JS.shift_cells(jnp.asarray(a), off, jg)),
            TS.shift_cells(torch.from_numpy(a), off, tg).numpy(),
            err_msg=str(off))


@pytest.mark.parametrize("periodic", [(False, False, True), (True, False, False),
                                      (False, True, False), (True, True, False)])
def test_halo_geometry_helpers_match_jax(periodic):
    """The ghost-column geometry the kernels' eligibility reads."""
    jg, tg = _geom_pair(dim=2, lo=(0, 0, 0), hi=(1, 1, 0.1), cutoff=0.2,
                        cap=4, periodic=periodic)
    for fn in ("ghost_axes", "ghosted_ncells", "ghosted_strides", "wrap_x",
               "max_flat_offset"):
        assert getattr(TH, fn)(tg) == getattr(JH, fn)(jg), fn
    assert TH.periodic_multicell(tg) == any(p and n > 1 for p, n in
                                            zip(periodic, tg.ncells))
