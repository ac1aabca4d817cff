"""The PyTorch port's load balancing against the JAX package.

Non-uniform x columns (``Geometry.x_edges``), the build-time cut
``Scene.balance``, the in-run re-cut ``Scene.fix_balance`` through
``simulate`` and the rebin's plain walk on an ``x_edges`` grid (the plain
version of the K5, K6 and K7 ``x_edges`` variants), held to the JAX package
on the CPU from identical inputs.  The scenes are the JAX package's own
load-balance scenes (``tests/test_sharding.py``): the dense blob beside a
sparse fluid between walls, and the blob drifting at speed 2.0 through a
periodic-x channel (2,115 particles).
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
from sph_bvf_tpu.models import fsi as jfsi
from sph_bvf_tpu.models import lid_cavity as jlid
from sph_bvf_tpu.models import lid_cavity3d as jlid3
from sph_bvf_tpu.parallel import balance as jbal
from sph_bvf_tpu_torch import bridge
from sph_bvf_tpu_torch.api import scene as tscene
from sph_bvf_tpu_torch.core import rebin_cuda
from sph_bvf_tpu_torch.core import state as TS
from sph_bvf_tpu_torch.core import stepper as tstepper
from sph_bvf_tpu_torch.parallel import balance as tbal
from synthetic_edges import seeded_drift, with_synthetic_edges

# the in-run re-cut of the JAX package's drifting-blob test
FIX = dict(every=50, threshold=1.5, min_budget=2.5e-3, occ_frac=0.8)


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


def _blob(mod, balance=False):
    """``tests/test_sharding.py``'s ``_blob_scene`` in package ``mod``: a
    dense blob (lattice 0.02) left, a sparse fluid (0.08) right, walls."""
    sc = mod.Scene(dim=2, boundary=("f", "f", "p"))
    sc.ncx_multiple_of = 8
    sc.create_box(1, mod.Region.block(0, 1, 0, 1, 0, 0.02))
    sc.lattice("sq", 0.02)
    sc.create_atoms(1, mod.Region.block(0, 0.48, 0, 1, -1, 1))
    sc.lattice("sq", 0.08)
    sc.create_atoms(1, mod.Region.block(0.5, 1, 0, 1, -1, 1))
    sc.mass(1, 4e-4)
    sc.set("all", rho=1.0, e=0.0)
    sc.pair_style("transport_velocity")
    sc.pair_coeff(1, 1, 1.0, 10.0, 1e-2, 0.05, 0.05, 0.0)
    sc.integrator("transport_velocity")
    sc.timestep(1e-5)
    if balance:
        sc.balance(8)
    return sc


def _drift_blob(mod, balance=False, inrun=False, s=1, margin_frac=None):
    """``tests/test_sharding.py``'s ``_drift_blob_scene`` in package
    ``mod``: a dense blob drifting +x at 2.0 through a periodic channel;
    ``s`` divides every particle-scale length by s (``models/drift_blob``'s
    scaling), ``margin_frac`` overrides the scene's cell margin."""
    sc = mod.Scene(dim=2, boundary=("p", "f", "p"))
    sc.ncx_multiple_of = 8
    if margin_frac is not None:
        sc.margin_frac = margin_frac
    sc.create_box(1, mod.Region.block(0, 2.4, 0, 0.6, 0, 0.02 / s))
    sc.lattice("sq", 0.02 / s)
    sc.create_atoms(1, mod.Region.block(0, 1.08, 0, 1, -1, 1))
    sc.lattice("sq", 0.04 / s)
    sc.create_atoms(1, mod.Region.block(1.1, 2.38, 0, 1, -1, 1))
    sc.mass(1, 4e-4 / s ** 2)
    sc.set("all", rho=1.0, e=0.0)
    sc.velocity("all", 2.0)
    sc.pair_style("transport_velocity")
    sc.pair_coeff(1, 1, 1.0, 1e-3, 0.0, 0.05 / s, 0.05 / s, 0.0)
    sc.integrator("transport_velocity")
    sc.rebin_every = 5
    sc.timestep(2e-4 / s)
    if balance:
        sc.balance(8, threshold=1.2)
    if inrun:
        sc.fix_balance(8, **dict(FIX, min_budget=FIX["min_budget"] / s))
    return sc


SCENES = {"blob": _blob, "drift_blob": _drift_blob}


@functools.lru_cache(maxsize=None)
def _jax_build(scene, balance):
    """The JAX-built scene as (state numpy, spec)."""
    js, _, jspec = SCENES[scene](jscene, balance=balance).build()
    return bridge.to_numpy(js), jspec


def _tgeom(g):
    return TS.Geometry(**dataclasses.asdict(g))


@pytest.mark.parametrize("scene", list(SCENES))
def test_scene_balance_build_matches_jax(scene):
    """``Scene.balance(8).build`` of both load-balance scenes: the same
    non-uniform geometry (every field, the edges and quantum included) and
    every state leaf bitwise."""
    ref, jspec = _jax_build(scene, True)
    sc = SCENES[scene](tscene, balance=True)
    ts, _, tspec = sc.build(device="cpu")
    assert sc.balance_applied is True
    assert jspec.geom.x_edges is not None
    assert dataclasses.asdict(tspec.geom) == dataclasses.asdict(jspec.geom)
    assert tspec.pair.solids_present is False
    got = bridge.state_from_port(ts)
    for name in ref:
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)


@pytest.mark.parametrize("scene", list(SCENES))
def test_balance_functions_match_jax(scene):
    """``report``, ``balanced_x_edges`` and ``rebalance`` on the uniform and
    the balanced build of both scenes: equal counts, edges, geometries and
    ``info`` dicts (keys, values and rounding)."""
    for balanced in (False, True):
        s, jspec = _jax_build(scene, balanced)
        g = jspec.geom
        js, ts = _jax(JS.State, s), bridge.state_to_port(s, device="cpu")
        assert tbal.report(ts, _tgeom(g), 8) == jbal.report(js, g, 8)
        for fix in (dict(n_shards=8), dict(n_shards=8, **FIX)):
            jg, jinfo = jbal.rebalance(js, g, jbal.BalanceFix(**fix))
            tg, tinfo = tbal.rebalance(ts, _tgeom(g), tbal.BalanceFix(**fix))
            assert tinfo == jinfo, (balanced, fix)
            assert (tg is None) == (jg is None), (balanced, fix, jinfo)
            if jg is not None:
                assert dataclasses.asdict(tg) == dataclasses.asdict(jg)
    # the uniform build is imbalanced enough to be re-cut
    s, jspec = _jax_build(scene, False)
    g = jspec.geom
    jg, _ = jbal.rebalance(_jax(JS.State, s), g, jbal.BalanceFix(8))
    assert jg is not None and jg.x_edges is not None
    # the greedy sweep itself, on the cell/8 quantum, for a few column
    # counts and minimum widths
    x0 = s["x"][0][s["valid"]].astype(np.float64)
    nx = g.ncells[0]
    for nxb, k_min in ((nx, 7), (nx, 8), (nx - 8, 9)):
        args = (x0, g.lo[0], g.cell_size[0] / 8.0, 8 * nx, nxb, k_min)
        assert tbal.balanced_x_edges(*args) == jbal.balanced_x_edges(*args)


def _edge_probe_positions(g, dtype, seed):
    """[3, n] positions probing ``g``'s x columns in ``dtype``: every edge,
    its neighbours one ulp either side, random points across the whole box
    and 0.3 beyond each end (across the seam of a periodic axis)."""
    e = np.asarray(g.x_edges, dtype)
    up, down = np.nextafter(e, e + 1), np.nextafter(e, e - 1)
    rng = np.random.default_rng(seed)
    rand = rng.uniform(g.lo[0] - 0.3, g.hi[0] + 0.3, 4000).astype(dtype)
    x0 = np.concatenate([e, up, down, rand, e + dtype(g.hi[0] - g.lo[0])])
    # no subnormals (the ulp below an edge at 0): XLA on the CPU flushes
    # them to zero, PyTorch keeps them
    x0 = x0[(x0 == 0) | (np.abs(x0) >= np.finfo(dtype).tiny)]
    y = rng.uniform(g.lo[1], g.hi[1], x0.shape).astype(dtype)
    return np.stack([x0, y, np.zeros_like(x0)])


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("scene", ["drift_blob", "blob"],
                         ids=["periodic_x", "wall_x"])
def test_cell_index_of_x_edges_matches_jax(scene, dtype):
    """``cell_index_of`` on a balanced grid == the JAX package's, bitwise:
    the fine-quantum table gather, the Python ``1 / x_quantum`` rounded to
    the dtype and, on the periodic axis, the wrap by the edges' own span."""
    _, jspec = _jax_build(scene, True)
    g = jspec.geom
    assert g.periodic[0] == (scene == "drift_blob")
    x = _edge_probe_positions(g, dtype, seed=7)
    want = np.asarray(JS.cell_index_of(jnp.asarray(x), g))
    got = TS.cell_index_of(torch.as_tensor(x), _tgeom(g)).numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want // g.ncells[1])) == g.ncells[0]


def _edged_drifted(grid):
    """A JAX-built scene rebinned by the JAX sort into its synthetic-edge
    geometry, then drifted by ``synthetic_edges.seeded_drift``: (state
    numpy, geometry)."""
    if grid == "2d_walls_cap16":
        js, _, jspec, _ = jlid.build(N=30)
    elif grid == "2d_periodic_gated":
        js, _, jspec, _ = jfsi.build(nx=24)
    else:
        js, _, jspec, _ = jlid3.build(N=8)
    g = with_synthetic_edges(jspec.geom)
    js = JS.rebin(js, g, use_pallas=False, drift_check=False)
    assert int(js.overflow) == 0
    ts = bridge.state_to_port(bridge.to_numpy(js), device="cpu")
    return bridge.state_from_port(seeded_drift(ts, _tgeom(g))), g


@pytest.mark.parametrize("grid", ["2d_walls_cap16", "2d_periodic_gated", "3d"])
def test_plain_walk_on_x_edges_matches_sorts(grid):
    """On an ``x_edges`` grid after a drift, the plain walk (the K5, K6 or
    K7 ``x_edges`` variant's plain version, by the grid's route) == the
    port's sort rebin == the JAX package's sort rebin, every leaf bitwise:
    the 2D cavity (walls, cap <= 16: K5), the FSI beam (periodic x, cap 34:
    K6, positions across the seam) and the 3D cavity (K7)."""
    s, g = _edged_drifted(grid)
    tg = _tgeom(g)
    want = {"2d_walls_cap16": rebin_cuda.rebin_move_2d,
            "2d_periodic_gated": rebin_cuda.rebin_move_2d_gated,
            "3d": rebin_cuda.rebin_move_3d}[grid]
    assert rebin_cuda.move_route(tg) is want
    if g.periodic[0]:
        v = s["valid"]
        assert int(((s["x"][0] < g.lo[0]) | (s["x"][0] >= g.hi[0]))[v].sum()) > 10
    ref = bridge.to_numpy(JS.rebin(_jax(JS.State, s), g, use_pallas=False))
    ts = bridge.state_to_port(s, device="cpu")
    walk = bridge.state_from_port(TS.rebin(ts, tg, use_kernel=True))
    sort = bridge.state_from_port(TS.rebin(ts, tg, use_kernel=False))
    assert int(ref["valid"].sum()) > 0
    for name in ref:
        if name != "key":
            np.testing.assert_array_equal(sort[name], ref[name], err_msg=name)
            np.testing.assert_array_equal(walk[name], ref[name], err_msg=name)


def _by_tag(a, name):
    """Valid entries of a field, ordered by tag (comparable across
    geometries)."""
    v = a["valid"].reshape(-1)
    tag = a["tag"].reshape(-1)[v]
    f = a[name]
    f = f.reshape(f.shape[:-2] + (-1,))[..., v]
    return f[..., np.argsort(tag)]


def test_simulate_fix_balance_f64_matches_jax():
    """205 steps of the balanced drifting blob with ``fix_balance`` at f64,
    from identical inputs: the re-cuts at steps 100 and 200 (occupancy
    trigger) equal the JAX package's (step, geometry and ``info``), every
    accepted re-cut improves its metric, and x, v, vest and rho match tag
    by tag within 1e-8."""
    js, jp, jspec = _drift_blob(jscene, balance=True, inrun=True).build()
    sa = _cast(bridge.to_numpy(js), np.float64)
    pa = _cast(bridge.to_numpy(jp), np.float64)
    js, jp = _jax(type(js), sa), _jax(type(jp), pa)
    ts = bridge.state_to_port(sa, device="cpu")
    tp = bridge.params_to_port(jp, device="cpu")
    tspec = bridge.spec_to_port(jspec)
    assert ts.x.dtype == torch.float64 and tp.mass.dtype == torch.float64
    assert tspec.balance == tbal.BalanceFix(n_shards=8, **FIX)

    jlog, tlog = [], []
    js = jstepper.simulate(jstepper.setup(js, jp, jspec, dt=2e-4), jp, jspec,
                           205, balance_log=jlog)
    ts = tstepper.simulate(tstepper.setup(ts, tp, tspec, dt=2e-4), tp, tspec,
                           205, balance_log=tlog)
    assert len(tlog) == len(jlog)
    for a, b in zip(jlog, tlog):
        assert {k: v for k, v in b.items() if k != "geom"} == {
            k: v for k, v in a.items() if k != "geom"}
        assert (a["geom"] is None) == (b["geom"] is None)
        if a["geom"] is not None:
            assert dataclasses.asdict(b["geom"]) == dataclasses.asdict(a["geom"])
    cuts = [c for c in tlog if c["geom"] is not None]
    assert [c["step"] for c in cuts] == [100, 200]
    assert len({c["geom"].x_edges for c in cuts}) == 2
    cap = tspec.geom.cap
    for c in cuts:
        assert c["max_occ"] >= FIX["occ_frac"] * cap
        assert c["new_max_occ"] < c["max_occ"] and c["new_imbalance"] < 1.5

    a, b = bridge.to_numpy(js), bridge.state_from_port(ts)
    assert int(b["step"]) == 205
    assert int(b["overflow"]) == 0 and int(b["drift_violation"]) == 0
    np.testing.assert_array_equal(a["tag"], b["tag"])
    np.testing.assert_array_equal(a["valid"], b["valid"])
    for name in ("x", "v", "vest", "rho"):
        np.testing.assert_allclose(_by_tag(b, name), _by_tag(a, name), rtol=0,
                                   atol=1e-8, err_msg=name)


def test_drift_blob_model_is_the_jax_scene():
    """``models/drift_blob`` at s=1 with both balance commands builds the
    JAX package's drifting blob: the same spec (geometry, pair, integrator
    and ``BalanceFix``) and every state leaf bitwise."""
    from sph_bvf_tpu_torch.models import drift_blob

    js, _, jspec = _drift_blob(jscene, balance=True, inrun=True).build()
    ts, _, tspec, sc = drift_blob.build(1, balance=True, inrun=True,
                                        device="cpu")
    assert sc.balance_applied is True
    classes = {"ModelSpec": jstepper.ModelSpec, "Geometry": JS.Geometry,
               "PairConfig": type(jspec.pair),
               "IntegratorConfig": type(jspec.integ),
               "BalanceFix": jbal.BalanceFix}
    assert bridge.spec_from_port(tspec, classes) == jspec
    ref, got = bridge.to_numpy(js), bridge.state_from_port(ts)
    for name in ref:
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)


def _sort_binned(cells, x, geom):
    """A sort binning of positions ``x`` [3, n] whose flat cells are
    ``cells``: (valid [cap, NC], x [3, cap, NC], particles past the cap),
    each cell's first ``cap`` particles in index order."""
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


# each package's binning and rebalance, on numpy positions
ADVECTION_PKGS = {
    "jax": (lambda x, g: np.asarray(JS.cell_index_of(jnp.asarray(x), g)),
            lambda v, x: types.SimpleNamespace(valid=jnp.asarray(v),
                                               x=jnp.asarray(x)),
            jbal.rebalance),
    "torch": (lambda x, g: TS.cell_index_of(torch.as_tensor(x), g).numpy(),
              lambda v, x: types.SimpleNamespace(valid=torch.as_tensor(v),
                                                 x=torch.as_tensor(x)),
              tbal.rebalance),
}


def _advected_recuts(pkg, geom, fix, x0, s, steps):
    """``simulate``'s balance loop on the drifting blob replayed under pure
    advection with package ``pkg``'s binning and ``rebalance``: positions
    ``x0`` [3, n] moved 2.0 * dt per step (the blob's pair terms vanish),
    binned every chunk, ``rebalance`` every ``fix.every`` steps, a cut
    accepted when its binning loses nothing.  Returns the log: one entry
    per check (``info``, whether accepted, the new edges) and the first
    chunk that loses particles."""
    cell_of, as_state, rebalance = ADVECTION_PKGS[pkg]
    lo, span = geom.lo[0], geom.hi[0] - geom.lo[0]
    log = []
    for step in range(0, steps + 1, 5):
        x = x0.copy()
        x[0] = lo + np.mod(x0[0] + 2.0 * (2e-4 / s) * step - lo, span)
        x = x.astype(np.float32)
        valid, xs, lost = _sort_binned(cell_of(x, geom), x, geom)
        if lost:
            log.append(dict(step=step, lost=lost))
            break
        if step and step % fix.every == 0:
            new, info = rebalance(as_state(valid, xs), geom, fix)
            ok = new is not None and not _sort_binned(cell_of(x, new), x, new)[2]
            log.append(dict(step=step, edges=new.x_edges if ok else None,
                            **info))
            geom = new if ok else geom
    return log


@pytest.mark.parametrize("s, margin_frac, steps", [
    (1, 0.25, 400), (20, 0.25, 200), (20, 0.49, 200)],
    ids=["s1", "s20", "s20_model_margin"])
def test_drift_blob_recuts_under_advection_match_jax(s, margin_frac, steps):
    """The drifting blob's re-cuts under pure advection, the JAX package's
    binning and ``rebalance`` against the port's on the JAX package's own
    build: equal logs (every ``info``, the accepted edges, the step that
    first loses particles).  At s=1 both re-cut at steps 100, 200, 300 and
    350 and keep every particle.  At s=20 with the JAX scene's cell margin
    (0.25) no edge set improves the occupancy metric (the JAX package's
    own refusal) and the blob loses particles before step 200; with the
    ``models/drift_blob`` margin (0.49) both re-cut at steps 100 and 150
    and keep every particle."""
    js, _, jspec = _drift_blob(jscene, True, True, s, margin_frac).build()
    a = bridge.to_numpy(js)
    x0 = a["x"][:, a["valid"]].astype(np.float64)
    del js, a
    g, fix = jspec.geom, jspec.balance
    tspec = _drift_blob(tscene, True, True, s, margin_frac).build(device="cpu")[2]
    assert dataclasses.asdict(tspec.geom) == dataclasses.asdict(g)
    assert tspec.balance == tbal.BalanceFix(**dataclasses.asdict(fix))
    want = _advected_recuts("jax", g, fix, x0, s, steps)
    got = _advected_recuts("torch", _tgeom(g), tspec.balance, x0, s, steps)
    assert got == want
    cuts = [c["step"] for c in want if c.get("edges")]
    if margin_frac == 0.25 and s == 20:
        assert cuts == [] and want[-1]["step"] < 200 and "lost" in want[-1]
        assert any(c.get("reason") == "no improving edge set under the "
                   "width constraint" for c in want)
    else:
        assert cuts == ([100, 200, 300, 350] if s == 1 else [100, 150])
        assert not any("lost" in c for c in want)


def test_bridge_carries_balance_fix_and_edges():
    """``spec_to_port`` / ``spec_from_port`` round-trip a spec with a
    ``BalanceFix`` and an ``x_edges`` geometry to an equal JAX spec."""
    _, jspec = _jax_build("drift_blob", True)
    jspec = dataclasses.replace(jspec, balance=jbal.BalanceFix(8, **FIX))
    tspec = bridge.spec_to_port(jspec)
    assert tspec.balance == tbal.BalanceFix(8, **FIX)
    assert tspec.geom.x_edges == jspec.geom.x_edges
    classes = {"ModelSpec": jstepper.ModelSpec, "Geometry": JS.Geometry,
               "PairConfig": type(jspec.pair),
               "IntegratorConfig": type(jspec.integ),
               "BalanceFix": jbal.BalanceFix}
    assert bridge.spec_from_port(tspec, classes) == jspec
    back = bridge.spec_from_port(dataclasses.replace(tspec, balance=None),
                                 classes)
    assert back.balance is None and back.geom == jspec.geom
