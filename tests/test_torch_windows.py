"""K1's tails and K7's slot lists, off the card.

K1 and K4 (``csrc/pass_a_2d.cuh``) walk each neighbour cell to its tail,
one past its last valid slot (``pair_cuda.tail_index``, kept once a rebin
by ``tail_index_of``); K7 (``csrc/rebin_move_3d.cu``) ranks a target cell's
matches with a warp, 32 candidates a step, and keeps its slot lists in
shared memory or, past ``rebin_cuda.K7_LIST_BYTES``, in a global scratch
(``rebin_cuda.k7_list``).  These tests hold the tails against a brute
force, the cache against its rule, the list's route against the cap, and
a numpy emulation of K7's warp walk (lane by lane, ballot by ballot;
``tests/warp_walk.py``, which ``test_torch_moves2d.py`` runs on a plane)
against the plain walk and the sort rebin.  No JAX; the kernels themselves
are held on the card by the ``gpu`` tests of ``test_torch_kernels.py``.
"""

import ctypes
import dataclasses
import types

import numpy as np
import pytest
import torch

from sph_bvf_tpu_torch import _build
from sph_bvf_tpu_torch.core import rebin_cuda
from sph_bvf_tpu_torch.core import state as TS
from sph_bvf_tpu_torch.models import (cell_polarization, drift_blob, fsi,
                                      lid_cavity, lid_cavity3d, taylor_green3d)
from sph_bvf_tpu_torch.ops import pair_cuda
from synthetic_edges import seam_drift
from warp_walk import warp_walk


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (the suite's workers
    share the machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# K1's tails
# ---------------------------------------------------------------------------


def _tails_brute_force(valid: np.ndarray) -> list:
    cap, NC = valid.shape
    return [max([j + 1 for j in range(cap) if valid[j, c]], default=0)
            for c in range(NC)]


def _holes(seed=5):
    """A [14, 40] validity with holes below each cell's last valid slot:
    empty cells, full cells, a cell holding only its last slot, the rest
    seeded."""
    rng = np.random.default_rng(seed)
    valid = rng.uniform(size=(14, 40)) < 0.6
    valid[:, 0] = False
    valid[:, 1] = True
    valid[:, 2] = False
    valid[-1, 2] = True
    return torch.as_tensor(valid)


def _rebinned_2d(case):
    if case == "flagship":
        state, _, spec, _ = lid_cavity.build(N=30, device="cpu")
    elif case == "fsi":
        state, _, spec, _ = fsi.build(nx=24, device="cpu")
    else:
        state, _, spec, _ = cell_polarization.build(nx=24, device="cpu")
    return TS.rebin(state, spec.geom).valid


@pytest.mark.parametrize("case", ["flagship", "fsi", "polarization", "holes"])
def test_tail_index_matches_brute_force(case):
    """``tail_index`` on rebinned 2D states (compacted: the tail is the
    occupancy) and on a grid with holes below the last valid slot: each
    cell's tail is one past its last valid slot, 0 for an empty cell, and
    the depth is their largest."""
    valid = _holes() if case == "holes" else _rebinned_2d(case)
    tails, depth = pair_cuda.tail_index(valid)
    want = _tails_brute_force(valid.numpy())
    assert tails.dtype == torch.int32 and tails.tolist() == want
    assert depth == max(want)
    if case == "holes":
        assert not torch.equal(tails.long(), valid.sum(0))
    else:
        assert torch.equal(tails.long(), valid.sum(0))


def test_tail_index_is_kept_between_rebins():
    """``tail_index_of`` returns the same tensor while a state's validity
    is the same tensor and unedited (the steps between two rebins keep
    it), and builds the tails anew after a rebin (a new tensor) and after
    an in-place edit of the validity (its version); each time they equal
    the tails built from scratch."""
    from sph_bvf_tpu_torch.core.stepper import setup, step

    state, params, spec, _ = lid_cavity.build(N=30, device="cpu")
    state = setup(state, params, spec, dt=1e-4)
    first = pair_cuda.tail_index_of(state.valid)
    state = step(state, params, spec)
    again = pair_cuda.tail_index_of(state.valid)
    assert again[0] is first[0] and again[1] == first[1]
    rebinned = TS.rebin(state, spec.geom)
    assert rebinned.valid is not state.valid
    after = pair_cuda.tail_index_of(rebinned.valid)
    assert after[0] is not first[0]
    assert torch.equal(after[0], pair_cuda.tail_index(rebinned.valid)[0])
    valid = rebinned.valid.clone()
    kept = pair_cuda.tail_index_of(valid)
    c = int(valid.sum(0).argmax())
    valid[int(valid[:, c].sum()) - 1, c] = False  # the cell's last particle
    edited = pair_cuda.tail_index_of(valid)
    assert edited[0] is not kept[0]
    assert int(edited[0][c]) == int(kept[0][c]) - 1
    assert torch.equal(edited[0], pair_cuda.tail_index(valid)[0])


def test_k1_tile_leaves_room_for_the_static_shared_memory(monkeypatch):
    """A window may take ``K4_SHARED`` bytes, the H100's 232,448 a block
    less the window kernels' 528 static bytes (``tail_s`` and
    ``warp_max``): a window between the two, which the card would refuse,
    takes the next tile of ``K4_FALLBACK``.  44 rows 22 slots deep in the
    full body's 4 x 8 tile (60 cells) is 232,320 bytes and falls back to 4
    x 4; 40 rows 23 deep in a 7 x 5 tile (63 cells), 231,840 bytes, keeps
    it."""
    assert pair_cuda.K4_SHARED + 4 * (128 + 128 // 32) == 232_448
    assert pair_cuda.K4_TILE[False] == (4, 8)
    assert pair_cuda.k4_tile(44, 22, False) == (4, 4)
    monkeypatch.setattr(pair_cuda, "K4_TILE", {True: (7, 5), False: (7, 5)})
    assert pair_cuda.k4_tile(40, 23, False) == (7, 5)
    assert pair_cuda.k4_tile(40, 24, False) == (4, 4)


# ---------------------------------------------------------------------------
# K7's slot lists and its warp walk
# ---------------------------------------------------------------------------


def test_k7_keeps_its_lists_in_shared_memory_up_to_the_limit(monkeypatch):
    """``k7_list``: the slot lists of a block live in shared memory while
    ``4 * cap * K7_CELLS`` bytes fit ``K7_LIST_BYTES`` (the 3D FSI beam's
    cap 296 among them), in the global scratch past it; the launch passes
    the kernel a null scratch for the one and an i32 [cap, NC] one for the
    other."""
    limit = rebin_cuda.K7_LIST_BYTES // (4 * rebin_cuda.K7_CELLS)
    assert limit >= 296
    assert rebin_cuda.k7_list(limit) is True
    assert rebin_cuda.k7_list(limit + 1) is False

    calls = []

    def launch(*args):
        calls.append(args)
        return 0

    lib = types.SimpleNamespace(rebin_move_3d=launch)
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(_build, "current_stream", lambda device: 0)
    state, _, spec, _ = taylor_green3d.build(12, device="cpu")
    geom = spec.geom
    fields = TS.particle_fields(state)
    PF, PI, fmeta, _ = rebin_cuda._pack_fields(fields, geom.cap,
                                               geom.ncells_total)
    xr = rebin_cuda._x_row(fmeta)
    cells = rebin_cuda.K7_CELLS
    for bytes_, shared in ((4 * geom.cap * cells, True),
                           (4 * geom.cap * cells - 4, False)):
        monkeypatch.setattr(rebin_cuda, "K7_LIST_BYTES", bytes_)
        rebin_cuda._launch(rebin_cuda.rebin_move_3d, PF, PI, geom, xr, 3,
                           ((ctypes.c_int, 7), (ctypes.c_float, 0.0)),
                           lists=rebin_cuda.k7_list(geom.cap))
        # csrc/rebin_move_3d.cu's 29 arguments: ..., n_fine, the slab's
        # five (one device: 0, nx, the x wrap, 0, NC), list, stream
        assert len(calls[-1]) == 29
        assert calls[-1][-7:-2] == (0, geom.ncells[0], 1, 0, geom.ncells_total)
        assert isinstance(calls[-1][-3], int)
        assert (calls[-1][-2] is None) == shared


def _move_state(case):
    """A 3D state between two rebins, every valid particle moved by a
    seeded step of up to 0.9 cells an axis (``seam_drift`` across the x
    and z seams for the blob): walls (the 3D cavity N=8, cap 38), a
    periodic y (the spanwise cavity N=20, cap 49), x_edges on a grid
    periodic in x and z (the balanced 3D blob s=1, cap 86), every axis
    periodic past cap 64 (the 3D vortex N=12, cap 86)."""
    if case == "walls":
        state, _, spec, _ = lid_cavity3d.build(N=8, device="cpu")
    elif case == "periodic":
        state, _, spec, _ = lid_cavity3d.build_spanwise(20, device="cpu")
    elif case == "x_edges periodic":
        state, _, spec, _ = drift_blob.build(1, True, True, device="cpu",
                                             nz_cells=3)
    else:
        state, _, spec, _ = taylor_green3d.build(12, device="cpu")
    geom = spec.geom
    if case == "x_edges periodic":
        x = seam_drift(state.x.numpy(), state.valid.numpy(), geom)
    else:
        rng = np.random.default_rng(7)
        d = rng.uniform(-0.9, 0.9, tuple(state.x.shape)) * np.asarray(
            geom.cell_size)[:, None, None]
        x = (state.x.numpy() + np.where(state.valid.numpy(), d, 0.0)).astype(
            np.float32)
    return dataclasses.replace(state, x=torch.as_tensor(x)), geom


@pytest.mark.parametrize("case", ["walls", "periodic", "x_edges periodic",
                                  "cap 86"])
def test_k7_warp_walk_matches_plain_walk_and_sort(case, monkeypatch):
    """The emulation of K7's warp walk (``warp_walk.warp_walk``) on the packs of
    drifted 3D states equals the plain walk (``rebin_move_plain``), every
    row bitwise, and a rebin through it equals the sort rebin, every leaf
    bitwise, the overflow and drift counts included."""
    state, geom = _move_state(case)
    assert rebin_cuda.move_route(geom) is rebin_cuda.rebin_move_3d
    if case == "x_edges periodic":
        assert geom.x_edges is not None
    fields = TS.particle_fields(state)
    fields["x"] = TS.wrap_pbc(fields["x"], geom)
    PF, PI, fmeta, _ = rebin_cuda._pack_fields(fields, geom.cap,
                                               geom.ncells_total)
    xr = rebin_cuda._x_row(fmeta)
    ef, ei = warp_walk(PF, PI, geom, xr)
    wf, wi = rebin_cuda.rebin_move_plain(PF, PI, geom, xr)
    assert torch.equal(ef, wf) and torch.equal(ei, wi)

    def emulated(PF, PI, geom, xr):
        return warp_walk(PF, PI, geom, xr)

    emulated.launches = 0
    monkeypatch.setattr(rebin_cuda, "rebin_move_3d", emulated)
    ref = TS.rebin(state, geom, use_kernel=False)
    got = TS.rebin(state, geom, use_kernel=True)
    for f in dataclasses.fields(ref):
        assert torch.equal(getattr(ref, f.name), getattr(got, f.name)), f.name
    assert int(got.n_valid) > 0
