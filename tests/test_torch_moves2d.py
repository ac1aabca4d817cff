"""K5's and K6's walk, off the card.

K5 and K6 (``csrc/rebin_move_2d.cu``) run K7's walk on a plane
(``csrc/rebin_move.cuh``): a warp ranks a target cell's matches among the 9
cells of its window, 32 candidates a step, and stops after the first slot
row in which no source cell holds a valid slot; a block of target cells
copies from their slot lists in shared memory.  These tests hold a numpy
emulation of that walk (``tests/warp_walk.py``, lane by lane, ballot by
ballot, in the plane's own formulation) against the plain walk and the sort rebin on drifted 2D states of
every 2D branch (walls, periodic x and y, ``x_edges`` on a periodic x, K5's
caps and K6's), the plane's row stop against K7's loop form, the invariant the row stop rests on (every rebin of a run
leaves each cell's valid slots at 0..occ-1) on the flagship's and the 2D
vortex's runs, and the launcher's plumbing (both wrappers launch the one
2D library and each counts its own launches).  No JAX; the kernel itself
is held on the card by the ``gpu`` tests of ``test_torch_kernels.py``.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from sph_bvf_tpu_torch import _build
from sph_bvf_tpu_torch.core import rebin_cuda
from sph_bvf_tpu_torch.core import state as TS
from sph_bvf_tpu_torch.core.stepper import run_chunk, setup
from sph_bvf_tpu_torch.models import (cell_polarization, drift_blob, fsi,
                                      lid_cavity, taylor_green2d)
from synthetic_edges import seam_drift, seam_hairs, with_synthetic_edges
from warp_walk import loop_row_stop, plane_row_stop, slot_of, warp_walk


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (the suite's workers
    share the machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# case -> (build on the CPU, the wrapper its grid routes to)
CASES = {
    "flagship walls": (lambda: lid_cavity.build(N=40, device="cpu"),
                       "rebin_move_2d"),
    "vortex periodic x and y": (lambda: taylor_green2d.build(36, device="cpu"),
                                "rebin_move_2d"),
    "vortex seam hairs": (lambda: taylor_green2d.build(36, device="cpu"),
                          "rebin_move_2d"),
    "vortex x_edges seam hairs": (
        lambda: taylor_green2d.build(36, device="cpu"), "rebin_move_2d"),
    "blob x_edges periodic x": (
        lambda: drift_blob.build(1, True, True, device="cpu"),
        "rebin_move_2d_gated"),
    "fsi periodic x": (lambda: fsi.build(nx=24, device="cpu"),
                       "rebin_move_2d_gated"),
    "polarization periodic x and y": (
        lambda: cell_polarization.build(nx=40, device="cpu"),
        "rebin_move_2d_gated"),
}


def _drifted(case):
    """The case's state between two rebins: every valid particle moved by a
    seeded step of up to 0.9 cells an axis (``seam_drift`` across the x
    seam for the blob, whose x columns have edges), or a seeded share of
    the end cells' particles put a hair below, at or a hair below the box's
    ends (``seam_hairs``: the bins the seam decides; with x columns of
    widths 7/8 and 9/8 of a cell, an x at the edges' span), and its
    geometry."""
    build, _ = CASES[case]
    state, _, spec, _ = build()
    geom = spec.geom
    if "x_edges seam" in case:
        geom = with_synthetic_edges(geom)
        state = TS.rebin(state, geom, use_kernel=False, drift_check=False)
    if "seam hairs" in case:
        x = seam_hairs(state.x.numpy(), state.valid.numpy(), geom)
    elif geom.x_edges is not None:
        x = seam_drift(state.x.numpy(), state.valid.numpy(), geom)
    else:
        rng = np.random.default_rng(7)
        d = rng.uniform(-0.9, 0.9, tuple(state.x.shape)) * np.asarray(
            geom.cell_size)[:, None, None]
        d[2] = 0.0
        x = (state.x.numpy() + np.where(state.valid.numpy(), d, 0.0)).astype(
            np.float32)
    return dataclasses.replace(state, x=torch.as_tensor(x)), geom


def _packs(state, geom):
    fields = TS.particle_fields(state)
    fields["x"] = TS.wrap_pbc(fields["x"], geom)
    PF, PI, fmeta, _ = rebin_cuda._pack_fields(fields, geom.cap,
                                               geom.ncells_total)
    return PF, PI, rebin_cuda._x_row(fmeta)


def _emulated(name):
    def move(PF, PI, geom, xr):
        move.launches += 1
        return warp_walk(PF, PI, geom, xr)

    move.__name__ = name
    move.launches = 0
    return move


@pytest.mark.parametrize("case", list(CASES))
def test_plane_warp_walk_matches_plain_walk_and_sort(case, monkeypatch):
    """The emulation of the walk on a plane on the packs of each drifted 2D
    state equals the plain walk (``rebin_move_plain``), every row bitwise,
    and a rebin through it, routed as the grid routes (K5 at cap <= 16, K6
    above), equals the sort rebin, every leaf bitwise, the overflow and
    drift counts included."""
    state, geom = _drifted(case)
    want = CASES[case][1]
    assert rebin_cuda.move_route(geom).__name__ == want
    if case.startswith("blob"):
        assert geom.x_edges is not None and geom.periodic[0]
    PF, PI, xr = _packs(state, geom)
    ef, ei = warp_walk(PF, PI, geom, xr)
    wf, wi = rebin_cuda.rebin_move_plain(PF, PI, geom, xr)
    assert torch.equal(ef, wf) and torch.equal(ei, wi)

    k5, k6 = _emulated("rebin_move_2d"), _emulated("rebin_move_2d_gated")
    monkeypatch.setattr(rebin_cuda, "rebin_move_2d", k5)
    monkeypatch.setattr(rebin_cuda, "rebin_move_2d_gated", k6)
    ref = TS.rebin(state, geom, use_kernel=False)
    got = TS.rebin(state, geom, use_kernel=True)
    assert (k5.launches, k6.launches) == ((1, 0) if want == "rebin_move_2d"
                                          else (0, 1))
    for f in dataclasses.fields(ref):
        assert torch.equal(getattr(ref, f.name), getattr(got, f.name)), f.name
    assert int(got.n_valid) > 0


@pytest.mark.parametrize("ns", [1, 4, 6, 9])
def test_plane_row_stop_and_slot_match_the_loop_form(ns):
    """The plane's row stop (each lane's [first, past) row, the ballot of
    empty rows, ``carried`` from lane 31) ends every step where K7's loop
    over the step's slot rows ends it, and carries the same bit into the
    next step where the walk goes on, on seeded valid masks (rows of ``ns``
    lanes that straddle the 32-lane steps, a row left empty with
    probability 1/4 or 1/50), and the multiply-high slot equals t // ns for every candidate of up to 64 slot
    rows."""
    t = np.arange(64 * ns + 32)
    assert np.array_equal(slot_of(t, ns), t // ns)
    rng = np.random.default_rng(ns)
    lanes = np.arange(32)
    for trial in range(200):
        cap = int(rng.integers(1, 40))
        total = cap * ns
        rows = rng.random((cap, ns)) < rng.uniform(0.1, 0.9)
        rows[rng.random(cap) < (0.25 if trial % 2 else 0.02)] = False
        valid = rows.reshape(-1)
        carried_loop = carried_plane = False
        for base in range(0, total, 32):
            tt = base + lanes
            live = tt < total
            any_valid = sum(1 << int(lane) for lane in lanes[live]
                            if valid[base + lane])
            col = tt - slot_of(tt, ns).astype(np.int64) * ns
            end_l, carried_loop = loop_row_stop(any_valid, base, ns, cap,
                                                carried_loop)
            end_p, carried_plane = plane_row_stop(any_valid, col, live, ns,
                                                  carried_plane)
            assert end_p == end_l, (trial, base)
            if end_l < 32:  # the walk ends; nothing is carried on
                break
            assert carried_plane == carried_loop, (trial, base)


def _compacted(valid: torch.Tensor) -> bool:
    """Every cell's valid slots are 0..occ-1 (slot-major [cap, NC])."""
    v = valid.to(torch.int32)
    return bool((v[1:] <= v[:-1]).all())


@pytest.mark.parametrize("case", ["flagship", "vortex"])
def test_slots_stay_compacted_on_k5_runs(case):
    """The invariant K5's row stop rests on: after the build and after every
    rebin of a run (setup's and each chunk's), each cell's valid slots are
    0..occ-1, and the walk with the row stop equals the plain walk, which
    walks every slot row, on the packs each rebin is handed: the flagship
    cavity at N=30 (walls; 3 chunks of 10 steps) and the 2D vortex at N=30
    (periodic x and y; 24 chunks of 5 steps, over which particles cross
    cells), each cap 14, K5's grids."""
    if case == "flagship":
        state, params, spec, _ = lid_cavity.build(N=30, device="cpu")
        dt, chunks = 1e-3, 3
    else:
        state, params, spec, _ = taylor_green2d.build(30, device="cpu")
        dt, chunks = taylor_green2d.timestep(30), 24
    geom = spec.geom
    assert rebin_cuda.move_route(geom) is rebin_cuda.rebin_move_2d
    assert _compacted(state.valid)
    state = setup(state, params, spec, dt=dt)
    assert _compacted(state.valid)
    crossed = 0
    for _ in range(chunks):
        PF, PI, xr = _packs(state, geom)
        ef, ei = warp_walk(PF, PI, geom, xr)
        wf, wi = rebin_cuda.rebin_move_plain(PF, PI, geom, xr)
        assert torch.equal(ef, wf) and torch.equal(ei, wi)
        tags = state.tag
        state = run_chunk(state, params, spec, spec.rebin_every)
        assert _compacted(state.valid)
        crossed += int((state.tag != tags).sum())
    assert int(state.overflow) == 0 and int(state.drift_violation) == 0
    if case == "vortex":
        assert crossed > 0


@pytest.mark.parametrize("wrapper", ["rebin_move_2d", "rebin_move_2d_gated"])
def test_k5_and_k6_launch_the_2d_move_and_count_their_own(wrapper,
                                                          monkeypatch):
    """K5 and K6 launch the entry point ``rebin_move_2d`` of the one 2D
    library (``rebin_cuda._library``), with the packs, cap, the grid's x and
    y, the x row, the binning constants, the wrap bits and span, the x
    columns, the slab's five (one device: x0 0, the global nx and x wrap,
    the targets 0 and NC) and the stream (26 arguments); each launch
    counts on the
    wrapper that made it and on no other (through a stub library)."""
    loaded, calls = [], []

    def launch(*args):
        calls.append(args)
        return 0

    def load(name):
        loaded.append(name)
        return types.SimpleNamespace(rebin_move_2d=launch)

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(_build, "current_stream", lambda device: 0)
    state, _, spec, _ = (fsi.build(nx=24, device="cpu")
                         if wrapper == "rebin_move_2d_gated"
                         else taylor_green2d.build(30, device="cpu"))
    geom = spec.geom
    kernel = getattr(rebin_cuda, wrapper)
    assert rebin_cuda.move_route(geom) is kernel
    counters = (rebin_cuda.rebin_move_2d, rebin_cuda.rebin_move_2d_gated,
                rebin_cuda.rebin_move_3d)
    before = [c.launches for c in counters]
    PF, PI, xr = _packs(state, geom)
    rebin_cuda._launch(kernel, PF, PI, geom, xr, 2, rebin_cuda._wrap_2d(geom))
    assert loaded == ["rebin_move_2d"]
    args = calls[-1]
    assert len(args) == 26
    assert args[6:10] == (geom.cap, geom.ncells[0], geom.ncells[1], xr)
    assert args[14:16] == (int(geom.periodic[0]), int(geom.periodic[1]))
    assert args[20:25] == (0, geom.ncells[0], int(geom.periodic[0]), 0,
                           geom.ncells_total)
    assert [c.launches - b for c, b in zip(counters, before)] == [
        int(c is kernel) for c in counters]
