"""The rest of the grouped 2D pass-A kernel in the PyTorch port: K1's full
body and K4 (the window staged in shared memory), against the JAX
package.

The cavity under the mechanics pair style (``models/lid_cavity.scene`` with
``pair_style="mechanics"``: the symmetric pressure, XSPH, the mechanics
integrator) is the path that takes K1's full body by JAX's own routing
(lattice-aligned, cap 14 <= 24); the flagship with ``preshift_window``
takes K4.  The kernels run on a card only (``tests/test_torch_kernels.py``
holds them there), so here:

- the scene of both packages' ``Scene``, bitwise, and the routes;
- 40 steps of the mechanics cavity at f64, the port's plain path against
  the JAX package's jnp path;
- K1's and K4's window (a torch emulation of the cells each tile's block
  stages in shared memory, each to its tail) against ``shift_cells``,
  bitwise, per offset, on walls, a periodic x axis, periodic x and y,
  three-cell periodic axes, ragged tiles and cells with holes below their
  tails; the tile ``pair_cuda.k4_tile`` picks fits a block;
- what K1 and K4 serve (every configuration JAX's grouped kernel takes)
  and refuse (a periodic axis of two cells, a fifth species);
- ``preshift_window`` changes no route but K1's, as in JAX.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_bvf_tpu.api import scene as jscene
from sph_bvf_tpu.core import fixes as jfixes
from sph_bvf_tpu.core import stepper as jstepper
from sph_bvf_tpu.models import lid_cavity as jlid
from sph_bvf_tpu.ops.pair_pallas import _default_rowloop
from sph_bvf_tpu_torch import bridge
from sph_bvf_tpu_torch.api import scene as tscene
from sph_bvf_tpu_torch.core import fixes as tfixes
from sph_bvf_tpu_torch.core import stepper as tstepper
from sph_bvf_tpu_torch.core.integrate import IntegratorConfig
from sph_bvf_tpu_torch.core.halo import wrap_axes
from sph_bvf_tpu_torch.core.state import shift_cells
from sph_bvf_tpu_torch.models import (cell_polarization, fsi, lid_cavity3d,
                                      taylor_green2d)
from sph_bvf_tpu_torch.models import lid_cavity as tlid
from sph_bvf_tpu_torch.ops import pair as tpair
from sph_bvf_tpu_torch.ops import pair_cuda

GROUPED = (pair_cuda.pass_a_2d, pair_cuda.pass_a_2d_preshift)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (the suite's parallel
    workers' OpenMP pools otherwise starve one another)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _classes(pkg):
    """(Scene, Region, SetForce) of ``pkg`` ("jax" or "torch")."""
    if pkg == "jax":
        return jscene.Scene, jscene.Region, jfixes.SetForce
    return tscene.Scene, tscene.Region, tfixes.SetForce


def _both(N, **kw):
    """The cavity scene ``kw`` built by both packages: (JAX state, params,
    spec), (port state, params, spec), the port's on the CPU."""
    return (tlid.scene(*_classes("jax"), N=N, **kw).build(),
            tlid.scene(*_classes("torch"), N=N, **kw).build(device="cpu"))


def _same_build(jax_built, port_built):
    (js, jp, jspec), (ts, tp, tspec) = jax_built, port_built
    assert dataclasses.asdict(tspec.geom) == dataclasses.asdict(jspec.geom)
    for part in ("pair", "integ"):
        assert (dataclasses.asdict(getattr(tspec, part))
                == dataclasses.asdict(getattr(jspec, part))), part
    a, b = bridge.to_numpy(js), bridge.state_from_port(ts)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    a, b = bridge.to_numpy(jp), bridge.to_numpy(tp)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_cavity_scene_matches_jax_and_routes_to_k1_and_k4():
    """``lid_cavity.scene`` run by both packages' classes at N=20, bitwise:
    with the model's pair style it is the JAX package's own
    ``lid_cavity.build``; under ``pair_style="mechanics"`` the scene,
    ``PairConfig`` and ``IntegratorConfig`` equal (XSPH, the symmetric
    pressure, no free or elastic solid); the grid takes the grouped shape
    in JAX (``_default_rowloop`` False) and K1 in the port, K4 under
    ``preshift_window``, with nothing missing for either."""
    js, jp, jspec, _ = jlid.build(N=20)
    jax_built, port_built = _both(20)
    _same_build((js, jp, jspec), jax_built)
    _same_build(jax_built, port_built)
    for kw, kernel in ((dict(pair_style="mechanics"), pair_cuda.pass_a_2d),
                       (dict(preshift_window=True), pair_cuda.pass_a_2d_preshift),
                       (dict(pair_style="mechanics", preshift_window=True),
                        pair_cuda.pass_a_2d_preshift)):
        jax_built, port_built = _both(20, **kw)
        _same_build(jax_built, port_built)
        _, tp, tspec = port_built
        g, cfg = tspec.geom, tspec.pair
        assert g.cap == 14 and g.base_occ == 9
        assert not _default_rowloop(jax_built[2].geom)
        assert cfg.preshift_window == bool(kw.get("preshift_window"))
        assert pair_cuda.route(g, cfg) is kernel
        assert pair_cuda.kernel_unsupported(g, cfg, n_sdpd=tp.n_sdpd) == []
        if kw.get("pair_style") == "mechanics":
            assert cfg.xsph and not cfg.pressure_switch
            assert not (cfg.free_solids_present or cfg.elastic_present
                        or cfg.weighted_solid)
            assert tspec.integ == IntegratorConfig.mechanics()
            assert not pair_cuda.tv_body(g, cfg)
        else:
            assert pair_cuda.tv_body(g, cfg)


def test_mechanics_cavity_steps_match_jax():
    """40 steps of the mechanics cavity at N=24 in f64 from identical
    inputs (four rebins): the port's plain path against the JAX package's
    jnp path (``use_pallas=False``), slots bitwise, x, v and rho within
    1e-8, with the lid driving the fluid and ddx live."""
    (js, jp, jspec), _ = _both(24, pair_style="mechanics")
    cast = lambda d: {k: (v.astype(np.float64) if isinstance(v, np.ndarray)
                          and v.dtype.kind == "f" else v) for k, v in d.items()}
    sa, pa = cast(bridge.to_numpy(js)), cast(bridge.to_numpy(jp))
    jspec = dataclasses.replace(
        jspec, pair=dataclasses.replace(jspec.pair, use_pallas=False))
    jx = lambda cls, d: cls(**{k: jnp.asarray(v) if isinstance(v, np.ndarray)
                               else v for k, v in d.items()})
    js, jp = jx(type(js), sa), jx(type(jp), pa)
    ts = bridge.state_to_port(sa, device="cpu")
    tp = bridge.params_to_port(jp, device="cpu")
    tspec = bridge.spec_to_port(jspec)
    js = jstepper.simulate(jstepper.setup(js, jp, jspec, dt=1e-4), jp, jspec, 40)
    ts = tstepper.simulate(tstepper.setup(ts, tp, tspec, dt=1e-4), tp, tspec, 40)
    a, b = bridge.to_numpy(js), bridge.state_from_port(ts)
    assert int(a["step"]) == int(b["step"]) == 40
    assert int(b["overflow"]) == 0 and int(b["drift_violation"]) == 0
    np.testing.assert_array_equal(a["tag"], b["tag"])
    np.testing.assert_array_equal(a["valid"], b["valid"])
    for key in ("x", "v", "rho"):
        np.testing.assert_allclose(b[key], a[key], rtol=0, atol=1e-8,
                                   err_msg=key)
    fluid = b["valid"] & (b["solid_tag"] == 0)
    assert float(np.abs(b["v"][:, fluid]).max()) > 1e-3
    assert float(np.abs(b["ddx"]).max()) > 0


GRIDS = {
    "cavity": lambda: tlid.scene(*_classes("torch"), N=30).build(device="cpu"),
    "fsi nx=12": lambda: fsi.build(nx=12, device="cpu")[:3],
    "polarization nx=20": lambda: cell_polarization.build(nx=20, device="cpu")[:3],
    # 3 x 3 cells, both axes periodic
    "vortex N=9": lambda: taylor_green2d.build(9, device="cpu")[:3],
}


def _k4_window(PF, tails, geom, tile, origin):
    """The window a block of K1 and K4 stages for the tile ``tile`` = (tx,
    ty) at the cell ``origin`` (``stage`` in csrc/window_2d.cuh), with the
    tail of each window cell: window index g = origin - 1 + position holds
    grid cell g, or on a periodic axis n - 1 at g = -1 and 0 at g = n; a
    zero cell (tail 0) past a walled edge and past the grid's end.  The
    window is BT slots deep, BT the largest of its tails, and a cell's slots
    at or past its tail hold zeros here (the kernel leaves them unstaged:
    no walk reads them).  Returns ([F, BT, tx + 2, ty + 2], [tx + 2, ty +
    2])."""
    F, cap, NC = PF.shape
    nx, ny = geom.ncells[:2]
    wrap = wrap_axes(geom)

    def cells(o, size, n, periodic):
        g = torch.arange(o - 1, o + size + 1)
        if periodic:
            g = torch.where(g == -1, n - 1, torch.where(g == n, 0, g))
        return torch.where((g >= 0) & (g < n), g, -1)

    gx = cells(origin[0], tile[0], nx, wrap[0])
    gy = cells(origin[1], tile[1], ny, wrap[1])
    on = (gx[:, None] >= 0) & (gy[None, :] >= 0)
    flat = torch.clamp(gx, min=0)[:, None] * ny + torch.clamp(gy, min=0)[None, :]
    tail = torch.where(on, tails[flat], 0)
    depth = int(tail.max())
    slots = torch.arange(depth)[:, None, None]
    win = torch.where(slots < tail, PF[:, :depth, flat.reshape(-1)].reshape(
        F, depth, *flat.shape), torch.zeros((), dtype=PF.dtype))
    return win, tail


@pytest.mark.parametrize("grid, periodic, tile", [
    ("cavity", (False, False), (4, 8)), ("fsi nx=12", (True, False), None),
    ("polarization nx=20", (True, True), None),
    ("polarization nx=20", (True, True), (2, 4)),
    ("vortex N=9", (True, True), (4, 8))])
def test_k4_window_matches_shift_cells(grid, periodic, tile):
    """Every tile's window (``_k4_window``), read around each of the tile's
    cells inside the grid at offset (ox, oy), holds the pack at the
    neighbour cell exactly as the plain path's ``shift_cells`` gives it,
    up to that cell's tail, and the neighbour holds no valid slot past its
    tail: so a walk to the tail reads every valid j.  Bitwise, on walls
    (zero cells past an edge), a periodic x axis, periodic x and y, three
    cells per periodic axis under a tile wider than the grid, ragged tiles
    (the grids' cells are not multiples of the tile) and cells with holes
    below their tails (a seeded fifth of the valid slots emptied); the
    tile by default is the one ``k4_tile`` picks for the full body's pack
    (the cavity's: the tv body's 4 x 8)."""
    state, params, spec = GRIDS[grid]()
    rng = np.random.default_rng(1)
    drop = torch.as_tensor(rng.uniform(size=tuple(state.valid.shape)) < 0.2)
    state = dataclasses.replace(state, valid=state.valid & ~drop)
    g, cfg = spec.geom, spec.pair
    nx, ny = g.ncells[:2]
    assert tuple(g.periodic[:2]) == periodic and min(nx, ny) >= 3
    pf = tpair._per_particle(state, params, cfg)
    rows = pair_cuda.MECH_PF_ROWS + (("AS", "S") if cfg.elastic_present
                                     else ("ASd",))
    PF = pair_cuda._pack(pf, rows, g.cap, g.ncells_total)
    tails, depth = pair_cuda.tail_index(state.valid)
    assert not torch.equal(tails.long(), state.valid.sum(0))
    tile = tile or pair_cuda.k4_tile(PF.shape[0], depth, False)
    assert nx % tile[0] or ny % tile[1]  # a ragged tile
    shifted = {(ox, oy): shift_cells(PF, (ox, oy, 0), g).reshape(
        PF.shape[:2] + (nx, ny)) for ox in (-1, 0, 1) for oy in (-1, 0, 1)}
    for cx0 in range(0, nx, tile[0]):
        for cy0 in range(0, ny, tile[1]):
            win, tail = _k4_window(PF, tails, g, tile, (cx0, cy0))
            assert win.shape[1] <= depth
            for cx in range(cx0, min(cx0 + tile[0], nx)):
                for cy in range(cy0, min(cy0 + tile[1], ny)):
                    for (ox, oy), want in shifted.items():
                        wx, wy = cx - cx0 + 1 + ox, cy - cy0 + 1 + oy
                        t = int(tail[wx, wy])
                        got = win[:, :t, wx, wy]
                        assert torch.equal(got, want[:, :t, cx, cy]), (
                            cx, cy, ox, oy)
                        assert not bool(want[0, t:, cx, cy].any())


def test_k4_tile_fits_a_block():
    """``k4_tile`` gives the flagship's and the mechanics cavity's packs
    their body's tile, and every pack a K4 instantiation reads (up to 46
    rows: the full body with AS, S, the filter row, four species and the
    thermal rows) at every cap of the grouped shape (<= 24) a tile whose
    window fits a block: at most 128 cells and ``K4_SHARED`` bytes (a
    window is at most cap slots deep: the grid's largest tail)."""
    filt = ("rhoI",)
    assert pair_cuda.k4_tile(len(pair_cuda.PF_ROWS + filt), 14, True) == \
        pair_cuda.K4_TILE[True]
    assert pair_cuda.k4_tile(len(pair_cuda.MECH_PF_ROWS) + 2, 14, False) == \
        pair_cuda.K4_TILE[False]
    for rows in range(1, 47):
        for cap in range(1, 25):
            for tv in (True, False):
                tx, ty = pair_cuda.k4_tile(rows, cap, tv)
                window = (tx + 2) * (ty + 2)
                assert window <= 128
                assert 4 * rows * cap * window <= pair_cuda.K4_SHARED


def _configs():
    """The pair configurations JAX's grouped kernel takes: the model's,
    mechanics and fsi, XSPH and the symmetric pressure on their own,
    elastic and free solids, a solid-free scene, the thermal rows."""
    tv = tpair.PairConfig.transport_velocity(dim=2, weighted_solid=False)
    yield tv
    yield tpair.PairConfig.mechanics(dim=2, weighted_solid=False)
    yield tpair.PairConfig.fsi(dim=2, weighted_solid=False)
    yield dataclasses.replace(tv, xsph=True)
    yield dataclasses.replace(tv, pressure_switch=False)
    yield dataclasses.replace(tv, elastic_present=True, free_solids_present=True)
    yield dataclasses.replace(tv, free_solids_present=True)
    yield dataclasses.replace(tv, solids_present=False, elastic_present=False,
                              free_solids_present=False)
    yield dataclasses.replace(tv, thermal=True)
    yield dataclasses.replace(tv, ampl_damp=0.1)


def test_grouped_kernels_serve_every_configuration():
    """K1 and K4 serve every pair configuration of the grouped kernel on
    walls and on periodic x, y or both of at least 3 cells, for 0-4
    species; they name a periodic axis of two cells and a fifth species.
    The transport-velocity body runs only where it serves (no physics it
    lacks, no periodic axis)."""
    _, _, spec = tlid.scene(*_classes("torch"), N=16).build(device="cpu")
    walls = spec.geom
    nx, ny = walls.ncells[:2]
    grids = [walls] + [dataclasses.replace(walls, periodic=p) for p in
                       ((True, False, True), (False, True, True),
                        (True, True, True))]
    grids.append(dataclasses.replace(grids[-1], ncells=(3, 3, 1)))
    for g in grids:
        for cfg in _configs():
            for ns in range(pair_cuda.MAX_SPECIES + 1):
                for kernel in GROUPED:
                    assert pair_cuda.kernel_unsupported(
                        g, cfg, kernel, n_sdpd=ns) == [], (g.periodic, cfg, ns)
            assert pair_cuda.tv_body(g, cfg) == (
                g is walls and not pair_cuda.tv_lacks(cfg))
    five = pair_cuda.MAX_SPECIES + 1
    for kernel in GROUPED:
        for ax, ncells in ((0, (2, 9, 1)), (1, (9, 2, 1))):
            periodic = (ax == 0, ax == 1, True)
            narrow = dataclasses.replace(walls, periodic=periodic, ncells=ncells)
            assert pair_cuda.kernel_unsupported(narrow, spec.pair, kernel) == [
                f"a periodic {'xy'[ax]} axis with fewer than 3 cells"]
        assert pair_cuda.kernel_unsupported(walls, spec.pair, kernel,
                                            n_sdpd=five) == [
            f"more than {pair_cuda.MAX_SPECIES} continuum species "
            f"(n_sdpd = {five})"]
        assert pair_cuda.kernel_unsupported(
            dataclasses.replace(walls, dim=3, ncells=(4, 4, 3)),
            spec.pair, kernel) == ["a 3D grid"]


def test_preshift_window_changes_only_k1s_route():
    """As in JAX (``pass_a_pallas`` takes K4 only for a grid that is not
    rowloop), the flag sends the grouped grid to K4 and leaves the FSI
    beam's (mixed lattice: K2) and the 3D cavity's (K3) routes alone; on
    CPU tensors every route runs the plain loop, so the flag changes no
    force."""
    _, _, fspec, _ = fsi.build(nx=12, device="cpu")
    _, _, cspec, _ = lid_cavity3d.build(N=6, device="cpu")
    for spec, kernel in ((fspec, pair_cuda.pass_a_2d_rowloop),
                         (cspec, pair_cuda.pass_a_3d)):
        on = dataclasses.replace(spec.pair, preshift_window=True)
        assert pair_cuda.route(spec.geom, on) is kernel
        assert pair_cuda.route(spec.geom, spec.pair) is kernel
        assert pair_cuda.kernel_unsupported(spec.geom, on) == []
    state, params, spec = tlid.scene(*_classes("torch"), N=12).build(device="cpu")
    state = tstepper.setup(state, params, spec, dt=1e-4)
    on = dataclasses.replace(spec.pair, preshift_window=True)
    before = (pair_cuda.pass_a_2d.launches, pair_cuda.pass_a_2d_preshift.launches)
    a = tpair.compute_forces(state, params, spec.geom, spec.pair)
    b = tpair.compute_forces(state, params, spec.geom, on)
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name
    assert (pair_cuda.pass_a_2d.launches,
            pair_cuda.pass_a_2d_preshift.launches) == before
