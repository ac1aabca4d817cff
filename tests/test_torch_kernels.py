"""The port's hand-written CUDA kernels (K1, K2 and K3 pass A, K5, K6 and
K7 rebin move), with K2's solid-free variant, the non-uniform x-column
(``x_edges``) variants of K5, K6 and K7, K1, K2 and K3 with the species
rows (C in, the flux Q out), K2's fsi pair style and K2 and K6 on a doubly
periodic grid (cell polarization), the thermal rows of K1, K2 and K3
(the SDPD random force), K3's mechanics, fsi and solid-free paths
with K7 past cap 64 (the 3D FSI beam and the Taylor-Green vortex), K6 past
cap 64 (seeded 2D grids of caps 96 and 400), K5 on
periodic grids (the 2D Taylor-Green vortex), K7 with x_edges on a periodic
grid (the 3D drifting blob) and K8, the window-rotation probe.

The kernel-vs-plain checks need a CUDA card and are marked ``gpu``: they
skip on a machine without one (run them there with
``python -m pytest tests/test_torch_kernels.py -m gpu``).  The CPU checks
hold what the wrappers promise off the card: a CPU tensor runs the plain
version and never counts a launch, the kernels' eligibility covers the
flagship, the FSI beam, the 3D cavity, the load-balanced drifting blob and
cell polarization, and a configuration no kernel serves raises.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sph_bvf_tpu_torch.core import rebin_cuda
from sph_bvf_tpu_torch.core import state as TS
from sph_bvf_tpu_torch.core.stepper import _rebin_drop, run_chunk, setup
from sph_bvf_tpu_torch.models import (cell_polarization, drift_blob, fsi,
                                      lid_cavity, lid_cavity3d,
                                      natural_convection, taylor_green2d)
from sph_bvf_tpu_torch.ops import pair, pair_cuda
from sph_bvf_tpu_torch.ops import rotation_probe as rp
from synthetic_edges import (any_corner_drift, corner_drift, seam_drift,
                             seam_hairs, seeded_drift, with_synthetic_edges)

K1_FIELDS = ("f", "drho", "num_den", "phi", "nw", "ddv", "de", "rhoAux1",
             "rhoAux2")
K2_FIELDS = K1_FIELDS + ("ddx", "dS")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the plain paths issue
    thousands of small ops, and with the suite's parallel workers each
    running a full OpenMP pool the spinning pools starve one another
    (a run of the port's tests went from ~3 to over 20 minutes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _cavity(N, device, steps=0):
    state, params, spec, _ = lid_cavity.build(N=N, device=device)
    state = setup(state, params, spec, dt=1e-4)
    if steps:
        state = run_chunk(state, params, spec, steps)
    return state, params, spec


@pytest.mark.gpu
@pytest.mark.parametrize("filt", [True, False], ids=["filter", "nofilter"])
def test_k1_matches_plain_on_card(cuda, filt):
    """K1 vs the plain stencil loop on the same CUDA tensors: each field
    within 5e-6 of its max (f32 sums in another order, with FMA)."""
    state, params, spec = _cavity(50, cuda, steps=20)
    cfg = dataclasses.replace(spec.pair, density_filter_accs=filt)
    pf = pair._per_particle(state, params, cfg)
    ref = pair._pass_a_plain(pf, params, spec.geom, cfg)
    got = pair_cuda.pass_a_2d(pf, params, spec.geom, cfg)
    torch.cuda.synchronize()
    for name in K1_FIELDS:
        scale = max(float(ref[name].abs().max()), 1e-30)
        err = float((got[name] - ref[name]).abs().max())
        assert err <= 5e-6 * scale, (name, err / scale)


@pytest.mark.gpu
def test_k5_matches_plain_walk_and_sort_on_card(cuda):
    """K5 vs the plain walk and the sort rebin on the same CUDA state:
    every leaf bitwise."""
    state, params, spec = _cavity(50, cuda, steps=9)
    geom = spec.geom
    fields = TS.particle_fields(state)
    PF, PI, fmeta, _ = rebin_cuda._pack_fields(fields, geom.cap, geom.ncells_total)
    xr = rebin_cuda._x_row(fmeta)
    kf, ki = rebin_cuda.rebin_move_2d(PF, PI, geom, xr)
    pf_, pi_ = rebin_cuda.rebin_move_plain(PF, PI, geom, xr)
    assert torch.equal(kf, pf_) and torch.equal(ki, pi_)
    ref = TS.rebin(state, geom, use_kernel=False)
    got = TS.rebin(state, geom, use_kernel=True)
    for f in dataclasses.fields(ref):
        assert torch.equal(getattr(ref, f.name), getattr(got, f.name)), f.name


def _fsi(device, seed_S=False):
    """fsi.build(nx=24) after setup and one 4-step chunk; with ``seed_S``
    the solids get a seeded symmetric deviatoric stress (numpy, seed 0),
    large enough that the artificial-stress tensor is tensile somewhere."""
    state, params, spec, _ = fsi.build(nx=24, rebin_every=4, device=device)
    state = setup(state, params, spec, dt=1e-8)
    state = run_chunk(state, params, spec, spec.rebin_every)
    if seed_S:
        rng = np.random.default_rng(0)
        S = rng.normal(0.0, 50.0, tuple(state.S.shape))
        S = torch.as_tensor(S + np.swapaxes(S, 0, 1), dtype=state.S.dtype,
                            device=state.S.device)
        solid = state.valid & (state.solid_tag == 1)
        state = dataclasses.replace(state, S=torch.where(solid, S, 0.0))
    return state, params, spec


@pytest.mark.gpu
@pytest.mark.parametrize("seed_S", [False, True], ids=["run", "seeded_S"])
@pytest.mark.parametrize("filt", [True, False], ids=["filter", "nofilter"])
def test_k2_matches_plain_on_card(cuda, filt, seed_S):
    """K2 vs the plain stencil loop on the same CUDA tensors of the nx=24
    FSI state: each field within 5e-6 of its max (f32 sums in another
    order, with FMA)."""
    state, params, spec = _fsi(cuda, seed_S)
    cfg = dataclasses.replace(spec.pair, density_filter_accs=filt)
    pf = pair._per_particle(state, params, cfg)
    ref = pair._pass_a_plain(pf, params, spec.geom, cfg)
    got = pair_cuda.pass_a_2d_rowloop(pf, params, spec.geom, cfg)
    torch.cuda.synchronize()
    if seed_S:  # the elastic terms are live (the frozen beam's own dS is 0)
        assert float(pf["AS"].abs().max()) > 0
        assert float(ref["dS"].abs().max()) > 0
    for name in K2_FIELDS:
        scale = max(float(ref[name].abs().max()), 1e-30)
        err = float((got[name] - ref[name]).abs().max())
        assert err <= 5e-6 * scale, (name, err / scale)


@pytest.mark.gpu
def test_k6_matches_plain_walk_and_sort_on_card(cuda):
    """K6 vs the plain walk and the sort rebin on the nx=24 FSI state after
    a chunk (periodic x, cap 34): every leaf bitwise."""
    state, params, spec = _fsi(cuda)
    state = run_chunk(state, params, spec, 3)  # drifted since its rebin
    geom = spec.geom
    fields = TS.particle_fields(state)
    PF, PI, fmeta, _ = rebin_cuda._pack_fields(fields, geom.cap, geom.ncells_total)
    xr = rebin_cuda._x_row(fmeta)
    kf, ki = rebin_cuda.rebin_move_2d_gated(PF, PI, geom, xr)
    pf_, pi_ = rebin_cuda.rebin_move_plain(PF, PI, geom, xr)
    assert torch.equal(kf, pf_) and torch.equal(ki, pi_)
    ref = TS.rebin(state, geom, use_kernel=False)
    got = TS.rebin(state, geom, use_kernel=True)
    for f in dataclasses.fields(ref):
        assert torch.equal(getattr(ref, f.name), getattr(got, f.name)), f.name


def _cavity3d(N, device, steps=0):
    state, params, spec, _ = lid_cavity3d.build(N=N, device=device)
    state = setup(state, params, spec, dt=1e-4)
    if steps:
        state = run_chunk(state, params, spec, steps)
    return state, params, spec


@pytest.mark.gpu
@pytest.mark.parametrize("filt", [True, False], ids=["filter", "nofilter"])
def test_k3_matches_plain_on_card(cuda, filt):
    """K3 vs the plain 27-offset loop on the same CUDA tensors of the N=20
    3D cavity (9^3 cells, cap 38): each field within 5e-6 of its max (f32
    sums in another order, with FMA); the filter-free variant writes no
    rhoAux1."""
    state, params, spec = _cavity3d(20, cuda, steps=9)
    cfg = dataclasses.replace(spec.pair, density_filter_accs=filt)
    pf = pair._per_particle(state, params, cfg)
    ref = pair._pass_a_plain(pf, params, spec.geom, cfg)
    got = pair_cuda.pass_a_3d(pf, params, spec.geom, cfg)
    torch.cuda.synchronize()
    for name in K1_FIELDS if filt else K1_FIELDS[:-2]:
        scale = max(float(ref[name].abs().max()), 1e-30)
        err = float((got[name] - ref[name]).abs().max())
        assert err <= 5e-6 * scale, (name, err / scale)
    if not filt:
        assert float(got["rhoAux1"].abs().max()) == 0.0


@pytest.mark.gpu
def test_k7_matches_plain_walk_and_sort_on_card(cuda):
    """K7 vs the plain 3D walk and the sort rebin on the N=20 3D cavity 9
    steps after a rebin: every leaf bitwise."""
    state, params, spec = _cavity3d(20, cuda, steps=9)
    geom = spec.geom
    fields = TS.particle_fields(state)
    PF, PI, fmeta, _ = rebin_cuda._pack_fields(fields, geom.cap, geom.ncells_total)
    xr = rebin_cuda._x_row(fmeta)
    kf, ki = rebin_cuda.rebin_move_3d(PF, PI, geom, xr)
    pf_, pi_ = rebin_cuda.rebin_move_plain(PF, PI, geom, xr)
    assert torch.equal(kf, pf_) and torch.equal(ki, pi_)
    ref = TS.rebin(state, geom, use_kernel=False)
    got = TS.rebin(state, geom, use_kernel=True)
    for f in dataclasses.fields(ref):
        assert torch.equal(getattr(ref, f.name), getattr(got, f.name)), f.name


def _with_species(state, params, ns, cutc_scale, seed=0):
    """(state, params) with ``ns`` continuum species: the state's own kept,
    the others' C uniform in [0, 1) on the valid slots, a distinct symmetric
    kappa per type pair and species, ``cutc = cutc_scale * h`` (numpy,
    ``seed``)."""
    rng = np.random.default_rng(seed)
    dev, fdt = state.x.device, state.x.dtype
    T, have = params.ntypes, min(params.n_sdpd, ns)
    C = torch.as_tensor(rng.uniform(0, 1, (ns,) + tuple(state.valid.shape)),
                        dtype=fdt, device=dev) * state.valid
    C[:have] = state.C[:have]
    kappa = rng.uniform(0.5, 1.5, (T, T, ns))
    kappa = 0.012 * 0.5 * (kappa + kappa.transpose(1, 0, 2))
    return (dataclasses.replace(state, C=C, Q=torch.zeros_like(C)),
            dataclasses.replace(params, cutc=cutc_scale * params.cut,
                                kappa=torch.as_tensor(kappa, dtype=fdt,
                                                      device=dev)))


def _species_parity(kernel, state, params, spec):
    """``kernel`` vs the plain loop, both filter variants: every field and Q
    within 5e-6 of its max, every species' Q nonzero."""
    for filt in (True, False):
        cfg = dataclasses.replace(spec.pair, density_filter_accs=filt)
        pf = pair._per_particle(state, params, cfg)
        ref = pair._pass_a_plain(pf, params, spec.geom, cfg)
        got = kernel(pf, params, spec.geom, cfg)
        torch.cuda.synchronize()
        assert got["Q"].shape == ref["Q"].shape
        assert float(ref["Q"].abs().amax(dim=(1, 2)).min()) > 0
        for name in (K1_FIELDS if filt else K1_FIELDS[:-2]) + ("Q",):
            scale = max(float(ref[name].abs().max()), 1e-30)
            err = float((got[name] - ref[name]).abs().max())
            assert err <= 5e-6 * scale, (name, filt, err / scale)


@pytest.mark.gpu
@pytest.mark.parametrize("cutc_scale", [1.0, 1.2, 0.8])
@pytest.mark.parametrize("ns", [1, 2, 3, 4])
def test_k1_with_species_matches_plain_on_card(cuda, ns, cutc_scale):
    """K1 with the species rows vs the plain loop on the N=40 natural
    convection 20 steps in (heat around the cylinder), for every species
    count it is instantiated for and with the species support at, above
    and below the kernel support."""
    state, params, spec, _ = natural_convection.build(N=40, device=cuda)
    state = run_chunk(setup(state, params, spec, dt=1e-4), params, spec, 20)
    state, params = _with_species(state, params, ns, cutc_scale)
    _species_parity(pair_cuda.pass_a_2d, state, params, spec)


@pytest.mark.gpu
@pytest.mark.parametrize("ns,cutc_scale", [(1, 1.0), (2, 1.2), (4, 0.8)])
def test_k3_with_species_matches_plain_on_card(cuda, ns, cutc_scale):
    """K3 with the species rows vs the plain 27-offset loop on the N=20 3D
    cavity with C seeded."""
    state, params, spec = _cavity3d(20, cuda, steps=9)
    state, params = _with_species(state, params, ns, cutc_scale)
    _species_parity(pair_cuda.pass_a_3d, state, params, spec)


@pytest.mark.gpu
def test_species_beyond_the_limit_raise_on_card(cuda):
    """One species more than K1 is instantiated for raises before the
    launch; nothing falls back to the plain loop."""
    state, params, spec, _ = natural_convection.build(N=20, device=cuda)
    state = setup(state, params, spec, dt=1e-4)
    state, params = _with_species(state, params, pair_cuda.MAX_SPECIES + 1, 1.0)
    pf = pair._per_particle(state, params, spec.pair)
    before = pair_cuda.pass_a_2d.launches
    with pytest.raises(NotImplementedError, match="continuum species"):
        pair_cuda.pass_a_2d(pf, params, spec.geom, spec.pair)
    assert pair_cuda.pass_a_2d.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("dim", [2, 3])
def test_moves_carry_species_rows_on_card(cuda, dim):
    """K5 (the N=40 convection) and K7 (the N=20 3D cavity) moving two
    species' C and Q rows after a chunk with them: bitwise to the plain
    walk and the sort rebin."""
    if dim == 2:
        state, params, spec, _ = natural_convection.build(N=40, device=cuda)
        state, kernel = setup(state, params, spec, dt=1e-4), rebin_cuda.rebin_move_2d
    else:
        state, params, spec = _cavity3d(20, cuda)
        kernel = rebin_cuda.rebin_move_3d
    state, params = _with_species(state, params, 2, 1.0)
    state = run_chunk(state, params, spec, 9)
    assert float(state.Q.abs().amax(dim=(1, 2)).min()) > 0
    geom = spec.geom
    fields = TS.particle_fields(state)
    PF, PI, fmeta, _ = rebin_cuda._pack_fields(fields, geom.cap, geom.ncells_total)
    xr = rebin_cuda._x_row(fmeta)
    kf, ki = kernel(PF, PI, geom, xr)
    pf_, pi_ = rebin_cuda.rebin_move_plain(PF, PI, geom, xr)
    assert torch.equal(kf, pf_) and torch.equal(ki, pi_)
    ref = TS.rebin(state, geom, use_kernel=False)
    got = TS.rebin(state, geom, use_kernel=True)
    for f in dataclasses.fields(ref):
        assert torch.equal(getattr(ref, f.name), getattr(got, f.name)), f.name


@pytest.mark.gpu
@pytest.mark.parametrize("filt", [True, False], ids=["filter", "nofilter"])
def test_k2_and_k6_serve_a_crowded_cavity_on_card(cuda, filt):
    """The N=50 cavity with cap 30 routes to K2 (transport-velocity
    pressure switch, fixed walls, no periodic axis) and K6 (walls): K2
    within 5e-6 of the plain loop, K6 bitwise to the plain walk and the
    sort rebin."""
    state, params, spec, _ = lid_cavity.build(N=50, cap=30, device=cuda)
    state = setup(state, params, spec, dt=1e-4)
    state = run_chunk(state, params, spec, 9)
    geom = spec.geom
    assert pair_cuda.uses_rowloop(geom)
    assert rebin_cuda.move_route(geom) is rebin_cuda.rebin_move_2d_gated
    cfg = dataclasses.replace(spec.pair, density_filter_accs=filt)
    pf = pair._per_particle(state, params, cfg)
    ref = pair._pass_a_plain(pf, params, geom, cfg)
    got = pair_cuda.pass_a(pf, params, geom, cfg)
    torch.cuda.synchronize()
    for name in K1_FIELDS:
        scale = max(float(ref[name].abs().max()), 1e-30)
        err = float((got[name] - ref[name]).abs().max())
        assert err <= 5e-6 * scale, (name, err / scale)
    ref = TS.rebin(state, geom, use_kernel=False)
    got = TS.rebin(state, geom, use_kernel=True)
    for f in dataclasses.fields(ref):
        assert torch.equal(getattr(ref, f.name), getattr(got, f.name)), f.name


def test_no_launch_on_cpu_tensors():
    """On CPU tensors the wrappers run the plain versions: setups and
    chunks of the cavity (K1/K5 grid), the FSI beam (K2/K6 grid), the 3D
    cavity (K3/K7 grid), the balanced drifting blob (solid-free K2, K6
    with x_edges) and cell polarization (K2 with species, K2 and K6 doubly
    periodic) move no launch counter."""
    counters = (pair_cuda.pass_a_2d, pair_cuda.pass_a_2d_rowloop,
                pair_cuda.pass_a_3d, rebin_cuda.rebin_move_2d,
                rebin_cuda.rebin_move_2d_gated, rebin_cuda.rebin_move_3d)
    before = [c.launches for c in counters]
    state, params, spec = _cavity(16, "cpu", steps=3)
    assert int(state.step) == 3
    state, params, spec = _fsi("cpu")
    assert int(state.step) == 4
    state, params, spec = _cavity3d(6, "cpu", steps=1)
    assert int(state.step) == 1
    state, params, spec = _blob("cpu", steps=5)
    assert int(state.step) == 5 and spec.geom.x_edges is not None
    state, params, spec = _polar("cpu", steps=3)
    assert int(state.step) == 3 and float(state.Q.abs().max()) > 0
    assert [c.launches for c in counters] == before


def test_kernels_serve_the_flagship_grid():
    """The flagship geometry and pair configuration are what K1 and K5
    serve; a crowded grid (cap 17..64) moves through K6; a grid with more
    than one cell along z takes K3 and K7, periodic axes of at least 3
    cells included; a periodic grid of cap <= 16 moves through K5 (K1
    serves its pass A); cap 65 moves through K6, and a cap past K6's
    shared memory takes the sort; a 3D grid periodic along an axis of two
    cells has no kernel (it raises on a CUDA tensor)."""
    state, params, spec, _ = lid_cavity.build(N=50, device="cpu")
    assert not pair_cuda.uses_rowloop(spec.geom)
    assert pair_cuda.kernel_unsupported(spec.geom, spec.pair) == []
    assert rebin_cuda.move_route(spec.geom) is rebin_cuda.rebin_move_2d
    periodic = dataclasses.replace(spec.geom, periodic=(True, False, True))
    assert rebin_cuda.move_route(periodic) is rebin_cuda.rebin_move_2d
    assert pair_cuda.kernel_unsupported(periodic, spec.pair) == []
    crowded = dataclasses.replace(spec.geom, cap=rebin_cuda.MAX_CAP + 1)
    assert rebin_cuda.move_route(crowded) is rebin_cuda.rebin_move_2d_gated
    cap65 = dataclasses.replace(spec.geom, cap=65)
    assert rebin_cuda.move_route(cap65) is rebin_cuda.rebin_move_2d_gated
    assert not rebin_cuda.sort_route(cap65)
    big_cap = dataclasses.replace(spec.geom, cap=rebin_cuda.GATED_MAX_CAP + 1)
    assert not rebin_cuda.move_supported(big_cap)
    assert rebin_cuda.sort_route(big_cap)
    flat3d = dataclasses.replace(spec.geom, dim=3, ncells=(19, 19, 4),
                                 periodic=(False, False, False))
    cfg3d = dataclasses.replace(spec.pair, dim=3)
    assert rebin_cuda.move_route(flat3d) is rebin_cuda.rebin_move_3d
    assert pair_cuda.route(flat3d, cfg3d) is pair_cuda.pass_a_3d
    assert pair_cuda.kernel_unsupported(flat3d, cfg3d) == []
    periodic3d = dataclasses.replace(flat3d, periodic=(False, False, True))
    assert rebin_cuda.move_route(periodic3d) is rebin_cuda.rebin_move_3d
    assert pair_cuda.kernel_unsupported(periodic3d, cfg3d) == []
    two_z = dataclasses.replace(periodic3d, ncells=(19, 38, 2))
    assert not rebin_cuda.move_supported(two_z)
    assert pair_cuda.kernel_unsupported(two_z, cfg3d) == [
        "a periodic z axis with fewer than 3 cells"]


def test_unsupported_configurations_raise():
    """The checks each wrapper runs before a launch raise
    NotImplementedError and name what is missing: a periodic axis of two
    cells on a K1 or K4 grid (the grouped kernel's physics all pass), a
    periodic y axis of two cells or a fifth species on a K2 grid, and
    rebin grids a move kernel does not serve (K5 on a periodic axis of two
    cells, K6 below cap 17); K5 takes a periodic axis of 3 or more."""
    state, params, spec, _ = lid_cavity.build(N=16, device="cpu")
    pf = pair._per_particle(state, params, spec.pair)
    for ok in (dict(xsph=True), dict(pressure_switch=False),
               dict(free_solids_present=True)):
        cfg = dataclasses.replace(spec.pair, **ok)
        for kernel in (pair_cuda.pass_a_2d, pair_cuda.pass_a_2d_preshift):
            pair_cuda._check_launch(pf, params, spec.geom, cfg, kernel)
    narrow = dataclasses.replace(spec.geom, periodic=(True, False, True),
                                 ncells=(2, spec.geom.ncells_total // 2, 1))
    for kernel in (pair_cuda.pass_a_2d, pair_cuda.pass_a_2d_preshift):
        with pytest.raises(NotImplementedError,
                           match="a periodic x axis with fewer than 3 cells"):
            pair_cuda._check_launch(pf, params, narrow, spec.pair, kernel)
    fstate, fparams, fspec, _ = fsi.build(nx=24, device="cpu")
    pf = pair._per_particle(fstate, fparams, fspec.pair)
    pair_cuda._check_launch(pf, fparams, fspec.geom, fspec.pair,
                            pair_cuda.pass_a_2d_rowloop)
    periodic_y = dataclasses.replace(fspec.geom, periodic=(True, True, True))
    pair_cuda._check_launch(pf, fparams, periodic_y, fspec.pair,
                            pair_cuda.pass_a_2d_rowloop)
    two_rows = dataclasses.replace(periodic_y, ncells=(99, 2, 1))
    for cfg in (fspec.pair,
                dataclasses.replace(fspec.pair, elastic_present=False)):
        assert pair_cuda.kernel_unsupported(two_rows, cfg) == [
            "a periodic y axis with fewer than 3 cells"]
    five = pair_cuda.MAX_SPECIES + 1
    assert pair_cuda.kernel_unsupported(fspec.geom, fspec.pair, n_sdpd=five) == [
        f"more than {pair_cuda.MAX_SPECIES} continuum species (n_sdpd = {five})"]
    fparams5 = dataclasses.replace(
        fparams, kappa=torch.zeros((fparams.ntypes,) * 2 + (five,)))
    with pytest.raises(NotImplementedError, match="continuum species"):
        pair_cuda._check_launch(pf, fparams5, fspec.geom, fspec.pair,
                                pair_cuda.pass_a_2d_rowloop)

    geom = spec.geom
    fields = TS.particle_fields(state)
    PF, PI, _, _ = rebin_cuda._pack_fields(fields, geom.cap, geom.ncells_total)
    rebin_cuda._check_packs(PF, PI, geom, rebin_cuda.rebin_move_2d)
    periodic = dataclasses.replace(geom, periodic=(True, False, True))
    rebin_cuda._check_packs(PF, PI, periodic, rebin_cuda.rebin_move_2d)
    with pytest.raises(NotImplementedError,
                       match="a periodic x axis with fewer than 3 cells"):
        rebin_cuda._check_packs(PF, PI, dataclasses.replace(
            periodic, ncells=(2, geom.ncells_total // 2, 1)),
            rebin_cuda.rebin_move_2d)
    with pytest.raises(NotImplementedError):  # K6 takes cap > 16 only
        rebin_cuda._check_packs(PF, PI, geom, rebin_cuda.rebin_move_2d_gated)


def test_k2_tables_match_plain_coefficients():
    """K2 and K3 read K1's six rows (h the last), then geff, flattened
    [T*T]; under ``g0_chem_coupling`` the geff row is 0 (the kernel takes
    the modulus from the packed G0 rows)."""
    _, params, spec, _ = fsi.build(nx=24, device="cpu")
    tabs = pair.coeff_tables(params, spec.pair)
    tab = pair_cuda._mech_tables(params, spec.pair, tabs)
    T = params.ntypes
    assert tab.shape == (7, T * T) and tab.dtype == torch.float32
    np.testing.assert_array_equal(tab[:6].numpy(),
                                  pair_cuda._tables(params, spec.pair).numpy())
    np.testing.assert_array_equal(tab[5].numpy(), tabs["h"].reshape(-1).numpy())
    np.testing.assert_array_equal(tab[6].numpy(), tabs["geff"].reshape(-1).numpy())
    assert float(tab[6].max()) > 0
    coupled = dataclasses.replace(spec.pair, g0_chem_coupling=True)
    tabs = pair.coeff_tables(params, coupled)
    assert "geff" not in tabs
    assert float(pair_cuda._mech_tables(params, coupled, tabs)[6].abs().max()) == 0


def test_k1_tables_match_plain_coefficients():
    """The per-type-pair rows K1 reads are the plain path's coefficients:
    1/h, eta, 1/wdelta, the two Lucy factors and h (the thermal noise's
    prefactor), flattened [T*T]."""
    from sph_bvf_tpu_torch.ops.kernels import lucy_w_coef, lucy_wfd_coef

    _, params, spec, _ = lid_cavity.build(N=50, device="cpu")
    tab = pair_cuda._tables(params, spec.pair)
    tabs = pair.coeff_tables(params, spec.pair)
    T = params.ntypes
    assert tab.shape == (6, T * T) and tab.dtype == torch.float32
    ih = tabs["inv_h"].reshape(-1)
    np.testing.assert_array_equal(tab[0].numpy(), ih.numpy())
    np.testing.assert_array_equal(tab[1].numpy(), tabs["eta"].reshape(-1).numpy())
    np.testing.assert_array_equal(tab[2].numpy(),
                                  tabs["inv_wdelta"].reshape(-1).numpy())
    np.testing.assert_array_equal(tab[3].numpy(), lucy_wfd_coef(ih, 2).numpy())
    np.testing.assert_array_equal(tab[4].numpy(), lucy_w_coef(ih, 2).numpy())
    np.testing.assert_array_equal(tab[5].numpy(), tabs["h"].reshape(-1).numpy())


def test_3d_cavity_routes_to_k3_and_k7():
    """The 3D cavity's grid and pair configuration are what K3 and K7
    serve; ``pass_a`` and ``move_route`` send it there."""
    _, _, spec, _ = lid_cavity3d.build(N=6, device="cpu")
    geom = spec.geom
    assert pair_cuda.route(geom, spec.pair) is pair_cuda.pass_a_3d
    assert pair_cuda.kernel_unsupported(geom, spec.pair) == []
    assert rebin_cuda.move_route(geom) is rebin_cuda.rebin_move_3d


def _walk_index_reference(valid):
    """``pair_cuda.walk_index`` by plain Python loops: the valid slots cell
    by cell, each cell's in slot order, then -1; each cell's count of
    leading valid slots."""
    cap, NC = valid.shape
    order = [slot * NC + c for c in range(NC) for slot in range(cap)
             if valid[slot, c]]
    lead = []
    for c in range(NC):
        n = 0
        while n < cap and valid[n, c]:
            n += 1
        lead.append(n)
    return order + [-1] * (cap * NC - len(order)), lead


@pytest.mark.parametrize("case", ["compacted", "holes", "empty", "full"])
def test_k3_walk_index_orders_valid_slots_by_cell(case):
    """K3's thread and walk index (torch ops, run on every call before the
    kernel): ``order`` lists every valid slot once, cell-major, then -1;
    ``lead`` stops each cell's j walk at its first empty slot: on seeded
    occupancies (compacted, as every rebin leaves them), with holes, all
    empty and all full."""
    rng = np.random.default_rng(7)
    cap, NC = 11, 37
    if case == "compacted":
        occ = rng.integers(0, cap + 1, NC)
        valid = np.arange(cap)[:, None] < occ[None, :]
    elif case == "holes":
        valid = rng.random((cap, NC)) < 0.6
    else:
        valid = np.full((cap, NC), case == "full")
    order, lead = pair_cuda.walk_index(torch.as_tensor(valid))
    want_order, want_lead = _walk_index_reference(valid)
    assert order.dtype == torch.int32 and lead.dtype == torch.int32
    assert order.tolist() == want_order and lead.tolist() == want_lead


def test_k3_walk_index_on_a_rebinned_3d_state():
    """On the 3D cavity after setup's rebin, the index lists exactly the
    state's particles and each cell's walk bound is its occupancy."""
    state, _, spec = _cavity3d(6, "cpu")
    order, lead = pair_cuda.walk_index(state.valid)
    n = int(state.valid.sum())
    assert (order[n:] == -1).all() and (order[:n] >= 0).all()
    slots = state.valid.reshape(-1).nonzero().reshape(-1)
    assert torch.equal(order[:n].long().sort().values, slots)
    assert torch.equal(lead.long(), state.valid.sum(0))


def test_k3_takes_the_tv_body_for_solid_free_scenes():
    """K3 runs the transport-velocity body (body 0) for the solid-free 3D
    scenes, the vortex and the blob, as for the 3D cavity, and the full
    body where the tv body lacks more than solids (the 3D FSI beam); the
    2D routes keep their bodies: the same solid-free configurations on 2D
    grids, walled or periodic, take the full body."""
    from sph_bvf_tpu_torch.models import taylor_green3d

    _, _, tgv = taylor_green3d.build(12, device="cpu")[:3]
    _, _, blob = drift_blob.build(1, True, True, device="cpu", nz_cells=3)[:3]
    _, _, cav = lid_cavity3d.build(N=6, device="cpu")[:3]
    _, _, beam = fsi.build_spanwise(12, device="cpu")[:3]
    for spec, tv in ((tgv, True), (blob, True), (cav, True), (beam, False)):
        assert pair_cuda.route(spec.geom, spec.pair) is pair_cuda.pass_a_3d
        assert pair_cuda.tv_body(spec.geom, spec.pair) == tv
    assert pair_cuda.tv_lacks(tgv.pair) == pair_cuda.tv_lacks(blob.pair) == [
        "a solid-free scene (solids_present=False)"]
    _, _, cav2d = lid_cavity.build(N=16, device="cpu")[:3]
    _, _, tgv2d = taylor_green2d.build(60, device="cpu")[:3]
    _, _, blob2d = drift_blob.build(1, True, True, device="cpu")[:3]
    for spec in (tgv2d, blob2d):
        assert not pair_cuda.tv_body(spec.geom, spec.pair)
    assert not pair_cuda.tv_body(cav2d.geom, tgv.pair)
    assert pair_cuda.tv_body(cav2d.geom, cav2d.pair)


@pytest.mark.gpu
def test_k3_lists_flush_and_never_truncate_on_card(cuda):
    """K3's per-lane lists of in-support candidates hold kChunk entries
    and are run and emptied whenever one could not take another step, so
    none overflows: with every support widened 5x (past the 27 cells'
    diagonal), every candidate passes the test (the lists fill every few
    steps), and K3 still matches the plain 27-offset loop field by field
    within 5e-6 of its max."""
    state, params, spec = _cavity3d(12, cuda, steps=3)
    wide = dataclasses.replace(params, cut=params.cut * 5.0)
    cfg = dataclasses.replace(spec.pair, density_filter_accs=True)
    pf = pair._per_particle(state, wide, cfg)
    ref = pair._pass_a_plain(pf, wide, spec.geom, cfg)
    got = pair_cuda.pass_a_3d(pf, wide, spec.geom, cfg)
    torch.cuda.synchronize()
    for name in K1_FIELDS:
        scale = max(float(ref[name].abs().max()), 1e-30)
        err = float((got[name] - ref[name]).abs().max())
        assert err <= 5e-6 * scale, (name, err / scale)


def test_3d_kernels_refuse_what_they_do_not_serve():
    """K3 names the grids it lacks (a periodic axis of fewer than 3 cells, a
    2D grid) and serves every pair configuration (mechanics, XSPH, free and
    elastic solids, solid-free scenes, density diffusion), K1 refuses a 3D
    grid, and K7 refuses a periodic axis of fewer than 3 cells, with or
    without x_edges: each raises NotImplementedError before a launch.  A
    periodic axis of 3 or more cells (with x_edges too) and any cap (past
    64 too) are served by both."""
    state, params, spec, _ = lid_cavity3d.build(N=6, device="cpu")
    geom = spec.geom
    pf = pair._per_particle(state, params, spec.pair)
    pair_cuda._check_launch(pf, params, geom, spec.pair, pair_cuda.pass_a_3d)
    for good in (dict(xsph=True), dict(pressure_switch=False),
                 dict(elastic_present=True), dict(free_solids_present=True),
                 dict(solids_present=False), dict(ampl_damp=0.1)):
        cfg = dataclasses.replace(spec.pair, **good)
        pair_cuda._check_launch(pair._per_particle(state, params, cfg), params,
                                geom, cfg, pair_cuda.pass_a_3d)
    for ax in range(3):
        periodic = tuple(a == ax for a in range(3))
        pgeom = dataclasses.replace(geom, periodic=periodic)
        pair_cuda._check_launch(pf, params, pgeom, spec.pair,
                                pair_cuda.pass_a_3d)
        assert rebin_cuda.move_route(pgeom) is rebin_cuda.rebin_move_3d
        # with two cells along it (64 in all), a stencil would reach one
        # cell twice
        ncells = tuple(2 if a == ax else (4 if a == (ax + 1) % 3 else 8)
                       for a in range(3))
        narrow = dataclasses.replace(pgeom, ncells=ncells)
        with pytest.raises(NotImplementedError,
                           match=f"a periodic {'xyz'[ax]} axis with fewer"):
            pair_cuda._check_launch(pf, params, narrow, spec.pair,
                                    pair_cuda.pass_a_3d)
        assert rebin_cuda.move_route(narrow) is None
    with pytest.raises(NotImplementedError, match="a 3D grid"):
        pair_cuda._check_launch(pf, params, geom, spec.pair,
                                pair_cuda.pass_a_2d)
    _, _, spec2d, _ = lid_cavity.build(N=16, device="cpu")
    assert pair_cuda.kernel_unsupported(spec2d.geom, spec2d.pair,
                                         pair_cuda.pass_a_3d) == [
        "a 2D grid"]

    fields = TS.particle_fields(state)
    PF, PI, _, _ = rebin_cuda._pack_fields(fields, geom.cap, geom.ncells_total)
    rebin_cuda._check_packs(PF, PI, geom, rebin_cuda.rebin_move_3d)
    edged = with_synthetic_edges(geom)
    rebin_cuda._check_packs(PF, PI, edged, rebin_cuda.rebin_move_3d)
    assert rebin_cuda.move_unsupported(dataclasses.replace(geom, cap=296),
                                       rebin_cuda.rebin_move_3d) == []
    periodic_edged = dataclasses.replace(edged, periodic=(True, False, False))
    rebin_cuda._check_packs(PF, PI, periodic_edged, rebin_cuda.rebin_move_3d)
    for bad in (dict(periodic=(True, False, False), ncells=(2, 8, 4)),
                dict(x_edges=edged.x_edges[:3], x_quantum=edged.x_quantum,
                     periodic=(True, False, False), ncells=(2, 8, 4))):
        with pytest.raises(NotImplementedError):
            rebin_cuda._check_packs(PF, PI, dataclasses.replace(geom, **bad),
                                    rebin_cuda.rebin_move_3d)
    with pytest.raises(NotImplementedError):  # K6 takes 2D grids only
        rebin_cuda._check_packs(PF, PI, geom, rebin_cuda.rebin_move_2d_gated)


def _blob(device, steps=0):
    """The load-balanced drifting blob at s=1 (2,115 particles, x_edges,
    periodic x, no solids) after setup and ``steps`` steps."""
    state, params, spec, _ = drift_blob.build(1, balance=True, device=device)
    state = setup(state, params, spec, dt=drift_blob.timestep(1))
    if steps:
        state = run_chunk(state, params, spec, steps)
    return state, params, spec


def _edged_drifted(state, geom):
    """``state`` sort-rebinned into ``geom`` with synthetic x edges, then
    drifted (``synthetic_edges.seeded_drift``): (state, edged geometry)."""
    g = with_synthetic_edges(geom)
    state = TS.rebin(state, g, use_kernel=False, drift_check=False)
    assert int(state.overflow) == 0
    return seeded_drift(state, g), g


EDGED = {"k5_cavity": (lambda d: _cavity(30, d, steps=9), rebin_cuda.rebin_move_2d),
         "k6_fsi": (lambda d: _fsi(d), rebin_cuda.rebin_move_2d_gated),
         "k7_cavity3d": (lambda d: _cavity3d(8, d, steps=9),
                         rebin_cuda.rebin_move_3d)}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(EDGED))
def test_x_edges_moves_match_plain_walk_and_sort_on_card(cuda, case):
    """K5 (2D cavity, walls, cap <= 16), K6 (FSI beam, periodic x, positions
    across the seam) and K7 (3D cavity) with synthetic x edges after a
    seeded drift: the kernel == the plain walk == the sort rebin, every
    leaf bitwise."""
    make, kernel = EDGED[case]
    state, params, spec = make(cuda)
    state, geom = _edged_drifted(state, spec.geom)
    assert rebin_cuda.move_route(geom) is kernel
    fields = TS.particle_fields(state)
    PF, PI, fmeta, _ = rebin_cuda._pack_fields(fields, geom.cap, geom.ncells_total)
    xr = rebin_cuda._x_row(fmeta)
    before = kernel.launches
    kf, ki = kernel(PF, PI, geom, xr)
    assert kernel.launches == before + 1
    pf_, pi_ = rebin_cuda.rebin_move_plain(PF, PI, geom, xr)
    assert torch.equal(kf, pf_) and torch.equal(ki, pi_)
    ref = TS.rebin(state, geom, use_kernel=False)
    got = TS.rebin(state, geom, use_kernel=True)
    for f in dataclasses.fields(ref):
        assert torch.equal(getattr(ref, f.name), getattr(got, f.name)), f.name


@pytest.mark.gpu
@pytest.mark.parametrize("live", [False, True], ids=["run", "seeded_rho_v"])
@pytest.mark.parametrize("filt", [True, False], ids=["filter", "nofilter"])
def test_k2_solid_free_matches_plain_on_card(cuda, filt, live):
    """Solid-free K2 vs the plain loop on the balanced drifting blob (s=1,
    x_edges, periodic x), as run and with a seeded density and velocity
    that make its force and drho terms live: each field within 5e-6 of
    its max; phi, nw and dS, which a solid-free scene never accumulates,
    exactly 0."""
    state, params, spec = _blob(cuda, steps=5)
    assert not spec.pair.solids_present
    if live:
        rng = np.random.default_rng(0)
        rho = 1.0 + 0.01 * rng.standard_normal(tuple(state.rho.shape))
        dv = 0.01 * rng.standard_normal(tuple(state.v.shape))
        state = dataclasses.replace(
            state, rho=state.rho * torch.as_tensor(rho, dtype=state.rho.dtype,
                                                   device=cuda),
            v=state.v + torch.as_tensor(dv, dtype=state.v.dtype, device=cuda))
    cfg = dataclasses.replace(spec.pair, density_filter_accs=filt)
    pf = pair._per_particle(state, params, cfg)
    ref = pair._pass_a_plain(pf, params, spec.geom, cfg)
    got = pair_cuda.pass_a_2d_rowloop(pf, params, spec.geom, cfg)
    torch.cuda.synchronize()
    for name in (n for n in K2_FIELDS if filt or not n.startswith("rhoAux")):
        scale = max(float(ref[name].abs().max()), 1e-30)
        err = float((got[name] - ref[name]).abs().max())
        assert err <= 5e-6 * scale, (name, err / scale)
    for name in ("phi", "nw", "dS"):
        assert float(got[name].abs().max()) == 0.0, name
    if live:
        for name in ("f", "drho", "ddv"):
            assert float(ref[name].abs().max()) > 0, name


def test_balanced_and_edged_grids_route_to_kernels():
    """The balanced drifting blob (x_edges, periodic x, cap 18, no solids)
    goes to solid-free K2 and K6; synthetic x edges keep the cavity on K5,
    the FSI beam on K6 and the 3D cavity on K7; the kernels get each
    column's fine-bin bounds round((e - e0) / q), the f32 1/q and the
    fine-bin count."""
    state, params, spec, _ = drift_blob.build(1, balance=True, device="cpu")
    geom = spec.geom
    assert geom.x_edges is not None and geom.cap == 18 and geom.base_occ == 0
    assert not spec.pair.solids_present
    assert pair_cuda.route(geom, spec.pair) is pair_cuda.pass_a_2d_rowloop
    assert pair_cuda.kernel_unsupported(geom, spec.pair) == []
    pf = pair._per_particle(state, params, spec.pair)
    pair_cuda._check_launch(pf, params, geom, spec.pair,
                            pair_cuda.pass_a_2d_rowloop)
    assert rebin_cuda.move_route(geom) is rebin_cuda.rebin_move_2d_gated
    xb, inv_q, n_fine = rebin_cuda._column_bounds(geom, "cpu")
    e = np.asarray(geom.x_edges)
    np.testing.assert_array_equal(
        xb.numpy(), np.round((e - e[0]) / geom.x_quantum).astype(np.int32))
    assert xb.dtype == torch.int32 and n_fine == int(xb[-1])
    assert inv_q == float(np.float32(1.0 / geom.x_quantum))
    uniform = dataclasses.replace(geom, x_edges=None)
    assert rebin_cuda._column_bounds(uniform, "cpu") == (None, 0.0, 0)
    for build, kernel in (
            (lambda: lid_cavity.build(N=16, device="cpu"), rebin_cuda.rebin_move_2d),
            (lambda: fsi.build(nx=24, device="cpu"), rebin_cuda.rebin_move_2d_gated),
            (lambda: lid_cavity3d.build(N=6, device="cpu"), rebin_cuda.rebin_move_3d)):
        g = with_synthetic_edges(build()[2].geom)
        assert rebin_cuda.move_route(g) is kernel
        assert rebin_cuda._column_bounds(g, "cpu")[2] == 8 * g.ncells[0]


def test_what_x_edges_and_solid_free_still_lack():
    """K5 with a periodic x axis and K7 with a periodic axis on an x_edges
    grid are served; what the x_edges variants still do not cover, a
    periodic axis of two cells, raises before a launch; K1 serves a
    solid-free scene, as K2 does."""
    state, params, spec, _ = lid_cavity.build(N=16, device="cpu")
    geom = with_synthetic_edges(spec.geom)
    fields = TS.particle_fields(state)
    PF, PI, _, _ = rebin_cuda._pack_fields(fields, geom.cap, geom.ncells_total)
    rebin_cuda._check_packs(PF, PI, geom, rebin_cuda.rebin_move_2d)
    for g in (geom, spec.geom):
        periodic = dataclasses.replace(g, periodic=(True, False, True))
        assert rebin_cuda.move_route(periodic) is rebin_cuda.rebin_move_2d
        rebin_cuda._check_packs(PF, PI, periodic, rebin_cuda.rebin_move_2d)
        narrow = dataclasses.replace(periodic, ncells=(2, g.ncells_total // 2, 1))
        assert rebin_cuda.move_route(narrow) is None
        with pytest.raises(NotImplementedError, match="later PR"):
            rebin_cuda._check_packs(PF, PI, narrow, rebin_cuda.rebin_move_2d)
    free = dataclasses.replace(spec.pair, solids_present=False)
    assert pair_cuda.kernel_unsupported(spec.geom, free) == []
    pf = pair._per_particle(state, params, free)
    pair_cuda._check_launch(pf, params, spec.geom, free, pair_cuda.pass_a_2d)
    assert pair_cuda.kernel_unsupported(spec.geom, free,
                                        pair_cuda.pass_a_2d_rowloop) == []
    _, _, spec3, _ = lid_cavity3d.build(N=6, device="cpu")
    g3 = with_synthetic_edges(spec3.geom)
    for ax in range(3):
        pg = dataclasses.replace(g3, periodic=tuple(a == ax for a in range(3)))
        assert rebin_cuda.move_route(pg) is rebin_cuda.rebin_move_3d
        ncells = tuple(2 if a == ax else g3.ncells[a] for a in range(3))
        assert rebin_cuda.move_route(dataclasses.replace(pg, ncells=ncells)) is None


def _polar(device, steps=0, nx=24):
    """cell_polarization.build(nx) (doubly periodic, an elastic free wall,
    one species, the fsi pair style) after setup and ``steps`` steps."""
    state, params, spec, _ = cell_polarization.build(nx=nx, rebin_every=5,
                                                     device=device)
    state = setup(state, params, spec, dt=1e-10)
    if steps:
        state = run_chunk(state, params, spec, steps)
    return state, params, spec


def _seeded_polar(state, params, ns, cutc_scale, c_hi=1.0, seed=0):
    """(state, params) of a polarization state with a seeded symmetric S on
    the wall (the artificial-stress tensor tensile somewhere), seeded noise
    on v, vest and rho, ``ns`` species with C uniform in [0, ``c_hi``) on
    the wall and a tenth of that elsewhere, a distinct symmetric kappa per
    type pair and species and ``cutc = cutc_scale * h`` (numpy, ``seed``)."""
    rng = np.random.default_rng(seed)
    dev, fdt = state.x.device, state.x.dtype
    t = lambda a: torch.as_tensor(a, dtype=fdt, device=dev)
    shape = tuple(state.valid.shape)
    valid = state.valid
    wall = valid & (state.solid_tag == 1)
    S = rng.normal(0.0, 2e3, (3, 3) + shape)
    v = state.v + t(rng.normal(0, 0.5, (3,) + shape)) * valid
    vest = v + t(rng.normal(0, 0.1, (3,) + shape)) * valid
    v[2] = 0.0
    vest[2] = 0.0
    C = t(rng.uniform(0, c_hi, (ns,) + shape))
    C = torch.where(wall, C, 0.1 * C) * valid
    T = params.ntypes
    kappa = rng.uniform(0.5, 1.5, (T, T, ns))
    return (dataclasses.replace(
                state, S=torch.where(wall, t(S + np.swapaxes(S, 0, 1)), 0.0),
                v=v, vest=vest, C=C, Q=torch.zeros_like(C),
                rho=torch.where(valid, state.rho * t(rng.uniform(0.99, 1.01, shape)),
                                1.0)),
            dataclasses.replace(
                params, cutc=cutc_scale * params.cut,
                kappa=t(1e-5 * 0.5 * (kappa + kappa.transpose(1, 0, 2)))))


# (ampl_damp, g0_chem_coupling, species_advection, ns, cutc / h, C's upper
# bound on the wall)
POLAR_CASES = {
    "model": (0.1, True, False, 1, 1.0, 1.0),
    "no-ampl_damp": (0.0, True, False, 1, 1.0, 1.0),
    "no-coupling": (0.1, False, False, 1, 1.0, 1.0),
    "ns2-cutc1.2h-adv": (0.1, True, True, 2, 1.2, 1.0),
    "ns4-cutc0.8h": (0.1, True, False, 4, 0.8, 1.0),
    "C-past-1/0.99": (0.1, True, False, 1, 1.0, 1.5),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(POLAR_CASES))
@pytest.mark.parametrize("filt", [True, False], ids=["filter", "nofilter"])
def test_k2_polarization_matches_plain_on_card(cuda, filt, case):
    """K2 vs the plain loop on the seeded nx=24 polarization state (doubly
    periodic, fsi pair style, species): every field, dS and Q included,
    within 5e-6 of its max, with the density diffusion and the modulus
    coupling each off, two and four species, cutc above and below h, the
    advection correction on, and a softened modulus below zero."""
    ampl, coupling, advect, ns, cutc_scale, c_hi = POLAR_CASES[case]
    state, params, spec = _polar(cuda, steps=3)
    state, params = _seeded_polar(state, params, ns, cutc_scale, c_hi)
    cfg = dataclasses.replace(spec.pair, density_filter_accs=filt,
                              ampl_damp=ampl, g0_chem_coupling=coupling,
                              species_advection=advect)
    pf = pair._per_particle(state, params, cfg)
    ref = pair._pass_a_plain(pf, params, spec.geom, cfg)
    before = pair_cuda.pass_a_2d_rowloop.launches
    got = pair_cuda.pass_a(pf, params, spec.geom, cfg)
    torch.cuda.synchronize()
    assert pair_cuda.pass_a_2d_rowloop.launches == before + 1
    assert float(pf["AS"].abs().max()) > 0 and float(ref["dS"].abs().max()) > 0
    assert float(ref["Q"].abs().amax(dim=(1, 2)).min()) > 0
    assert (float(pf["G0"].min()) < 0) == (c_hi > 1.0)
    for name in (n for n in K2_FIELDS + ("Q",)
                 if filt or not n.startswith("rhoAux")):
        scale = max(float(ref[name].abs().max()), 1e-30)
        err = float((got[name] - ref[name]).abs().max())
        assert err <= 5e-6 * scale, (name, err / scale)


@pytest.mark.gpu
def test_k6_periodic_y_matches_plain_walk_and_sort_on_card(cuda):
    """K6 vs the plain walk and the sort rebin on the nx=40 polarization
    state (both axes periodic, cap 30, the C, Q and S rows riding along)
    after a seeded drift across all four faces and corners: every leaf
    bitwise."""
    state, params, spec = _polar(cuda, steps=3, nx=40)
    geom = spec.geom
    x = corner_drift(state.x.cpu().numpy(), state.valid.cpu().numpy(), geom)
    state = dataclasses.replace(state, x=torch.as_tensor(x, device=cuda))
    assert rebin_cuda.move_route(geom) is rebin_cuda.rebin_move_2d_gated
    fields = TS.particle_fields(state)
    PF, PI, fmeta, _ = rebin_cuda._pack_fields(fields, geom.cap, geom.ncells_total)
    xr = rebin_cuda._x_row(fmeta)
    kf, ki = rebin_cuda.rebin_move_2d_gated(PF, PI, geom, xr)
    pf_, pi_ = rebin_cuda.rebin_move_plain(PF, PI, geom, xr)
    assert torch.equal(kf, pf_) and torch.equal(ki, pi_)
    ref = TS.rebin(state, geom, use_kernel=False)
    got = TS.rebin(state, geom, use_kernel=True)
    for f in dataclasses.fields(ref):
        assert torch.equal(getattr(ref, f.name), getattr(got, f.name)), f.name


def test_polarization_routes_and_what_is_still_refused():
    """Cell polarization's grid goes to K2 and K6 with nothing missing; a
    periodic y axis of two cells has no pass-A and no move kernel, a fifth
    species none either, K5 (cap <= 16) takes the periodic axes, x, y or
    both, and K1 serves the density diffusion on this grid too."""
    state, params, spec = _polar("cpu")
    geom = spec.geom
    assert geom.periodic == (True, True, True) and geom.cap > rebin_cuda.MAX_CAP
    assert pair_cuda.route(geom, spec.pair) is pair_cuda.pass_a_2d_rowloop
    assert pair_cuda.kernel_unsupported(geom, spec.pair, n_sdpd=1) == []
    pf = pair._per_particle(state, params, spec.pair)
    pair_cuda._check_launch(pf, params, geom, spec.pair,
                            pair_cuda.pass_a_2d_rowloop)
    assert rebin_cuda.move_route(geom) is rebin_cuda.rebin_move_2d_gated
    fields = TS.particle_fields(state)
    PF, PI, _, _ = rebin_cuda._pack_fields(fields, geom.cap, geom.ncells_total)
    rebin_cuda._check_packs(PF, PI, geom, rebin_cuda.rebin_move_2d_gated)

    two_rows = dataclasses.replace(geom, ncells=(18, 2, 1))
    assert pair_cuda.kernel_unsupported(two_rows, spec.pair, n_sdpd=1) == [
        "a periodic y axis with fewer than 3 cells"]
    assert rebin_cuda.move_route(two_rows) is None
    assert rebin_cuda.move_route(
        dataclasses.replace(geom, ncells=(2, 18, 1))) is None
    assert pair_cuda.kernel_unsupported(
        geom, spec.pair, n_sdpd=pair_cuda.MAX_SPECIES + 1) != []
    for periodic in ((True, False, True), (False, True, True),
                     (True, True, True)):
        sparse = dataclasses.replace(geom, cap=rebin_cuda.MAX_CAP,
                                     periodic=periodic)
        assert rebin_cuda.move_route(sparse) is rebin_cuda.rebin_move_2d
        assert rebin_cuda.move_unsupported(sparse, rebin_cuda.rebin_move_2d) == []
    assert pair_cuda.kernel_unsupported(
        geom, spec.pair, pair_cuda.pass_a_2d, n_sdpd=1) == []


# ---------------------------------------------------------------------------
# the thermal rows of K1, K2 and K3
# ---------------------------------------------------------------------------


def _thermal_state(kernel, ns, device):
    """A set-up state of ``kernel``'s route with ``ns`` (0 or 1) species:
    K1 the N=40 convection (its species stripped for Ns=0), K2 cell
    polarization at nx=24 (Ns=1) or the nx=24 FSI beam with seeded S (Ns=0),
    K3 the N=8 3D cavity (one seeded species for Ns=1)."""
    if kernel is pair_cuda.pass_a_2d:
        state, params, spec, _ = natural_convection.build(N=40, device=device)
        state = run_chunk(setup(state, params, spec, dt=1e-4), params, spec, 20)
        if not ns:
            state = dataclasses.replace(state, C=state.C[:0], Q=state.Q[:0])
            params = dataclasses.replace(params, kappa=params.kappa[..., :0])
        return state, params, spec
    if kernel is pair_cuda.pass_a_2d_rowloop:
        return _polar(device, steps=5) if ns else _fsi(device, seed_S=True)
    state, params, spec = _cavity3d(8, device, steps=9)
    if ns:
        state, params = _with_species(state, params, 1, 1.0)
    return state, params, spec


def _thermal_rows_parity(kernel, state, params, spec, case, names):
    """``kernel`` vs the plain loop with the thermal noise, both filter
    variants, at a nonzero step and key with e = 1e-6 where the model sets
    none (natural convection's value): every field of ``names`` (Q with
    species) within 5e-6 of its max.  Case "a": the state's kB (SI);
    case "b": kB raised until the noise is 20x the largest force without it,
    which the check then requires to be at least 10x."""
    dev = state.x.device
    state = dataclasses.replace(
        state, e=torch.where(state.valid, torch.where(state.e != 0, state.e,
                                                      1e-6), 0.0),
        step=torch.full_like(state.step, 12345),
        key=torch.tensor([0xDEADBEEF, 0x12345], dtype=torch.int64, device=dev))
    noise = pair.noise_inputs(state)
    names = names + (("Q",) if params.n_sdpd else ())
    for filt in (True, False):
        cfg = dataclasses.replace(spec.pair, density_filter_accs=filt,
                                  thermal=True)
        pf = pair._per_particle(state, params, cfg)
        p = params
        off = pair._pass_a_plain(pf, params, spec.geom,
                                 dataclasses.replace(cfg, thermal=False))["f"]
        if case == "b":
            one = pair._pass_a_plain(pf, dataclasses.replace(params, boltz=1.0),
                                     spec.geom, cfg, noise)["f"]
            p = dataclasses.replace(params, boltz=float(
                (20 * off.abs().max() / (one - off).abs().max()) ** 2))
        ref = pair._pass_a_plain(pf, p, spec.geom, cfg, noise)
        got = kernel(pf, p, spec.geom, cfg, noise)
        torch.cuda.synchronize()
        if case == "b":
            assert float((ref["f"] - off).abs().max()) >= 10 * float(
                off.abs().max())
        for name in names if filt else tuple(
                n for n in names if n not in ("rhoAux1", "rhoAux2")):
            scale = max(float(ref[name].abs().max()), 1e-30)
            err = float((got[name] - ref[name]).abs().max())
            assert err <= 5e-6 * scale, (name, filt, err / scale)


THERMAL_KERNELS = {"K1": (pair_cuda.pass_a_2d, K1_FIELDS),
                   "K2": (pair_cuda.pass_a_2d_rowloop, K2_FIELDS),
                   "K3": (pair_cuda.pass_a_3d, K1_FIELDS)}


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["a", "b"], ids=["as_run", "raised_kB"])
@pytest.mark.parametrize("ns", [0, 1], ids=["Ns0", "Ns1"])
@pytest.mark.parametrize("which", list(THERMAL_KERNELS))
def test_thermal_rows_match_plain_on_card(cuda, which, ns, case):
    """The thermal rows of K1, K2 (elastic) and K3 vs the plain loop on the
    same CUDA tensors, with and without a species, as run and with the
    noise dominating the force (``_thermal_rows_parity``)."""
    kernel, names = THERMAL_KERNELS[which]
    state, params, spec = _thermal_state(kernel, ns, cuda)
    assert pair_cuda.route(spec.geom, spec.pair) is kernel and params.n_sdpd == ns
    _thermal_rows_parity(kernel, state, params, spec, case, names)


def test_thermal_noise_is_routed_and_staged():
    """With the noise on, every route's launch check takes the state's dt,
    step and key and refuses them when absent or of another dtype; the
    kernels' pack ends with e and the int32 bits of the tags (the K2 and
    K1 tables carry h, which the prefactor reads)."""
    for build in (lambda: _cavity(16, "cpu"), lambda: _fsi("cpu"),
                  lambda: _cavity3d(6, "cpu"), lambda: _polar("cpu")):
        state, params, spec = build()
        cfg = dataclasses.replace(spec.pair, thermal=True)
        kernel = pair_cuda.route(spec.geom, cfg)
        pf = pair._per_particle(state, params, cfg)
        noise = pair.noise_inputs(state)
        pair_cuda._check_launch(pf, params, spec.geom, cfg, kernel, noise)
        with pytest.raises(ValueError, match="dt, step, key"):
            pair_cuda._check_launch(pf, params, spec.geom, cfg, kernel)
        bad = (state.dt, state.step.long(), state.key)
        with pytest.raises(TypeError, match="step"):
            pair_cuda._check_launch(pf, params, spec.geom, cfg, kernel, bad)
        cap, NC = pf["rho"].shape
        packed = pair_cuda._pack(pf, ("rho",) + pair_cuda.THERMAL_ROWS, cap, NC)
        assert torch.equal(packed[1], state.e.float())
        assert torch.equal(packed[2].view(torch.int32), state.tag)


# ---------------------------------------------------------------------------
# periodic 3D grids: K3 and K7 on periodic axes
# ---------------------------------------------------------------------------


def _periodic_grid(grid, device):
    """A periodic 3D grid on ``device``, after setup: the spanwise cavity
    at N=20 (y periodic, 9 x 6 x 9 cells, cap 49) after a 9-step chunk
    with seeded jitter on x (a tenth of a spacing); a channel periodic in x
    and z and a fully periodic box around a fixed solid sphere (9 sites an
    axis, 3 cells an axis of 3 spacings, cap 38: the cell margin 0.1 h),
    the box with one seeded species or with the thermal noise on (e = 1)."""
    from sph_bvf_tpu_torch.api.scene import Region, Scene

    if grid == "spanwise":
        state, params, spec, _ = lid_cavity3d.build_spanwise(20, device=device)
        state = run_chunk(setup(state, params, spec, dt=1e-4), params, spec, 9)
        rng = np.random.default_rng(3)
        jitter = rng.uniform(-0.1, 0.1, tuple(state.x.shape)) / 20
        state = dataclasses.replace(state, x=state.x + torch.as_tensor(
            jitter, dtype=state.x.dtype, device=device) * state.valid)
        return state, params, spec
    d = 1.0 / 9
    sc = Scene(dim=3, boundary=("p", "f", "p") if grid == "channel_xz"
               else ("p", "p", "p"))
    sc.margin_frac = 0.1
    if grid == "channel_xz":
        sc.create_box(2, Region.block(0.0, 1.0, -3 * d, 1.0 + 3 * d, 0.0, 1.0))
        solid = ~Region.block(-np.inf, np.inf, 0.0, 1.0, -np.inf, np.inf)
    else:
        sc.create_box(2, Region.block(0.0, 1.0, 0.0, 1.0, 0.0, 1.0))
        solid = Region.sphere(0.5, 0.5, 0.5, 0.25)
    sc.lattice("sc", d, origin=(0.5, 0.5, 0.5))
    sc.create_atoms(1, ~solid)
    sc.create_atoms(2, solid)
    sc.group_region("solid", solid)
    sc.mass(1, d**3).mass(2, d**3)
    sc.set("all", rho=1.0, e=1.0)
    sc.set("solid", solid_tag=1, fixed=True)
    sc.pair_style("transport_velocity", thermal=grid == "box_thermal")
    for (i, j) in ((1, 1), (1, 2), (2, 2)):
        sc.pair_coeff(i, j, 1.0, 10.0, 0.01, 2.5 * d, 2.5 * d, 0.0)
    sc.integrator("transport_velocity")
    sc.timestep(1e-4)
    state, params, spec = sc.build(device=device)
    rng = np.random.default_rng(5)
    t = lambda a: torch.as_tensor(a, dtype=state.x.dtype, device=device)
    state = dataclasses.replace(
        state, v=t(rng.normal(0, 0.05, tuple(state.v.shape))) * state.valid,
        x=state.x + t(rng.uniform(-0.1, 0.1, tuple(state.x.shape)) * d)
        * state.valid)
    state = setup(state, params, spec, dt=1e-4)
    if grid == "box_species":
        state, params = _with_species(state, params, 1, 1.0)
    return state, params, spec


@pytest.mark.gpu
@pytest.mark.parametrize("grid", ["spanwise", "channel_xz", "box_species",
                                  "box_thermal"])
def test_k3_periodic_matches_plain_on_card(cuda, grid):
    """K3 on periodic axes vs the plain 27-offset loop on the same CUDA
    tensors, both filter variants: every field (Q with the species) within
    5e-6 of its max; the thermal box at the state's kB and with the noise
    dominating (``_thermal_rows_parity``)."""
    state, params, spec = _periodic_grid(grid, cuda)
    geom = spec.geom
    assert any(geom.periodic) and pair_cuda.route(geom, spec.pair) is pair_cuda.pass_a_3d
    if grid == "box_thermal":
        for case in ("a", "b"):
            _thermal_rows_parity(pair_cuda.pass_a_3d, state, params, spec,
                                 case, K1_FIELDS)
        return
    if grid == "box_species":
        _species_parity(pair_cuda.pass_a_3d, state, params, spec)
        return
    for filt in (True, False):
        cfg = dataclasses.replace(spec.pair, density_filter_accs=filt)
        pf = pair._per_particle(state, params, cfg)
        ref = pair._pass_a_plain(pf, params, geom, cfg)
        got = pair_cuda.pass_a_3d(pf, params, geom, cfg)
        torch.cuda.synchronize()
        for name in K1_FIELDS if filt else K1_FIELDS[:-2]:
            scale = max(float(ref[name].abs().max()), 1e-30)
            err = float((got[name] - ref[name]).abs().max())
            assert err <= 5e-6 * scale, (name, filt, err / scale)


def _seam_drift(state, geom, seed):
    """``state`` with every valid particle moved by a seeded step of up to
    0.9 cells per axis, outward along every periodic axis in the corner
    cells (those at an end of each periodic axis), so particles cross every
    periodic face and corner; positions beyond the box stay unwrapped."""
    rng = np.random.default_rng(seed)
    x = state.x.cpu().numpy()
    valid = state.valid.cpu().numpy()
    d = rng.uniform(-0.9, 0.9, x.shape) * np.asarray(geom.cell_size)[:, None, None]
    c = np.broadcast_to(np.arange(geom.ncells_total), valid.shape)
    coord = [(c // geom.strides[ax]) % geom.ncells[ax] for ax in range(3)]
    axes = [ax for ax in range(3) if geom.periodic[ax]]
    corner = np.ones(valid.shape, bool)
    for ax in axes:
        corner &= (coord[ax] == 0) | (coord[ax] == geom.ncells[ax] - 1)
    for ax in axes:
        d[ax] = np.where(corner, np.where(coord[ax] == 0, -1.0, 1.0)
                         * np.abs(d[ax]), d[ax])
    x = (x + np.where(valid, d, 0.0)).astype(np.float32)
    past = np.ones(valid.shape, bool)
    for ax in axes:
        past &= (x[ax] < geom.lo[ax]) | (x[ax] >= geom.hi[ax])
    assert int((valid & past).sum()) > 0  # a corner is crossed
    return dataclasses.replace(state, x=torch.as_tensor(x, device=state.x.device))


@pytest.mark.gpu
@pytest.mark.parametrize("grid", ["spanwise", "channel_xz", "box_species"])
def test_k7_periodic_matches_plain_walk_and_sort_on_card(cuda, grid):
    """K7 on periodic axes vs the plain 3D walk and the sort rebin on the
    same CUDA state after a seeded drift across every periodic seam and
    corner (the C rows riding along on the box): every leaf bitwise."""
    state, params, spec = _periodic_grid(grid, cuda)
    geom = spec.geom
    state = _seam_drift(state, geom, seed=4)
    fields = TS.particle_fields(state)
    fields["x"] = TS.wrap_pbc(fields["x"], geom)
    PF, PI, fmeta, _ = rebin_cuda._pack_fields(fields, geom.cap, geom.ncells_total)
    xr = rebin_cuda._x_row(fmeta)
    kf, ki = rebin_cuda.rebin_move_3d(PF, PI, geom, xr)
    pf_, pi_ = rebin_cuda.rebin_move_plain(PF, PI, geom, xr)
    assert torch.equal(kf, pf_) and torch.equal(ki, pi_)
    ref = TS.rebin(state, geom, use_kernel=False)
    got = TS.rebin(state, geom, use_kernel=True)
    for f in dataclasses.fields(ref):
        assert torch.equal(getattr(ref, f.name), getattr(got, f.name)), f.name
    assert int(got.drift_violation) > 0


def test_periodic_grids_route_to_k3_and_k7():
    """The periodic test grids route to K3 and K7 with nothing missing (the
    seeded species and the thermal rows included), and their plain walk
    equals the sort rebin after a drift across every seam."""
    _, _, spec, _ = lid_cavity3d.build_spanwise(20, device="cpu")
    assert spec.geom.ncells == (9, 6, 9) and spec.geom.cap == 49
    assert pair_cuda.kernel_unsupported(spec.geom, spec.pair) == []
    assert rebin_cuda.move_route(spec.geom) is rebin_cuda.rebin_move_3d
    for grid in ("channel_xz", "box_species", "box_thermal"):
        state, params, spec = _periodic_grid(grid, "cpu")
        geom = spec.geom
        assert geom.cap == 38 and geom.ncells[0] == geom.ncells[2] == 3
        assert pair_cuda.route(geom, spec.pair) is pair_cuda.pass_a_3d
        assert pair_cuda.kernel_unsupported(geom, spec.pair,
                                            n_sdpd=params.n_sdpd) == []
        assert rebin_cuda.move_route(geom) is rebin_cuda.rebin_move_3d
        drifted = _seam_drift(state, geom, seed=4)
        ref = TS.rebin(drifted, geom, use_kernel=False)
        got = TS.rebin(drifted, geom, use_kernel=True)
        for f in dataclasses.fields(ref):
            assert torch.equal(getattr(ref, f.name), getattr(got, f.name)), f.name


def _k3_physics(case, device):
    """(state, params, spec) of K3's mechanics, fsi and solid-free paths:
    "fsi3d", the spanwise 3D FSI beam at nx=12 (cap 119) released at step
    2 and run 4 steps, with the beam's S seeded (numpy, seed 0); "fsi3d
    style", its fsi-style variant with one species, C on the beam seeded up
    to 1.5 (a softened modulus below zero) and a tenth of that elsewhere;
    "vortex", the Taylor-Green vortex at N=12 (cap 86) after 3 steps with x
    jittered by up to a tenth of a spacing (seed 1), so that ddv is not a
    cancellation of a perfect lattice."""
    from sph_bvf_tpu_torch.models import taylor_green3d

    rng = np.random.default_rng(0)
    t = lambda a, like: torch.as_tensor(a, dtype=like.dtype, device=device)
    if case == "vortex":
        state, params, spec, _ = taylor_green3d.build(12, device=device)
        state = run_chunk(setup(state, params, spec, dt=0.0131), params, spec, 3)
        d = rng.uniform(-0.1, 0.1, tuple(state.x.shape)) * (taylor_green3d.L / 12)
        return (dataclasses.replace(state, x=state.x + t(d, state.x) * state.valid),
                params, spec)
    kw = dict(pair_style="fsi", kappa=1e-5) if case == "fsi3d style" else {}
    state, params, spec, _ = fsi.build_spanwise(12, tdamp_solid=2, device=device,
                                                **kw)
    state = run_chunk(setup(state, params, spec, dt=1e-8), params, spec, 4)
    beam = state.valid & (state.solid_tag == 1) & (state.fixed_tag == 0)
    S = rng.normal(0.0, 1e3, tuple(state.S.shape))
    state = dataclasses.replace(state, S=torch.where(
        beam, t(S + np.swapaxes(S, 0, 1), state.S), state.S))
    if kw:
        C = t(rng.uniform(0.0, 1.5, tuple(state.C.shape)), state.C)
        state = dataclasses.replace(state, C=torch.where(beam, C, 0.1 * C) * state.valid)
    return state, params, spec


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["fsi3d", "fsi3d style", "vortex"])
@pytest.mark.parametrize("filt", [True, False], ids=["filter", "nofilter"])
def test_k3_mechanics_fsi_and_solid_free_match_plain_on_card(cuda, filt, case):
    """K3's elastic and solid-free instantiations against the plain
    27-offset loop: the 3D FSI beam (mechanics, XSPH, free elastic solids,
    a mixed lattice at cap 119), its fsi-style variant with a species and
    the Taylor-Green vortex (no solids, every axis periodic, cap 86): each
    field within 5e-6 of its max; dS, ddx and Q live where the physics has
    them, phi, nw and dS exactly 0 without solids."""
    state, params, spec = _k3_physics(case, cuda)
    cfg = dataclasses.replace(spec.pair, density_filter_accs=filt)
    pf = pair._per_particle(state, params, cfg)
    ref = pair._pass_a_plain(pf, params, spec.geom, cfg)
    before = pair_cuda.pass_a_3d.launches
    got = pair_cuda.pass_a_3d(pf, params, spec.geom, cfg)
    torch.cuda.synchronize()
    assert pair_cuda.pass_a_3d.launches == before + 1
    names = K2_FIELDS + (("Q",) if params.n_sdpd else ())
    for name in (n for n in names if filt or not n.startswith("rhoAux")):
        scale = max(float(ref[name].abs().max()), 1e-30)
        err = float((got[name] - ref[name]).abs().max())
        assert err <= 5e-6 * scale, (name, err / scale)
    if case == "vortex":
        for name in ("phi", "nw", "dS"):
            assert float(got[name].abs().max()) == 0.0, name
    else:
        for name in ("dS", "ddx", "phi") + (("Q",) if params.n_sdpd else ()):
            assert float(ref[name].abs().max()) > 0, name


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["vortex cap 86", "fsi3d cap 119",
                                  "fsi3d cap 208"])
def test_k7_past_cap_64_matches_plain_walk_and_sort_on_card(cuda, case):
    """K7 on 3D grids past its former cap of 64, after a seeded drift of up
    to 0.9 cells (``synthetic_edges.seeded_drift``'s steps without the
    edge snap): the kernel == the plain walk == the sort rebin, every leaf
    bitwise, on the vortex (every axis periodic) and the 3D FSI beam at
    nx=12 and nx=30 (x and z periodic, a mixed lattice)."""
    from sph_bvf_tpu_torch.models import taylor_green3d

    if case.startswith("vortex"):
        state, params, spec, _ = taylor_green3d.build(12, device=cuda)
    else:
        nx = 12 if case.endswith("119") else 30
        state, params, spec, _ = fsi.build_spanwise(nx, device=cuda)
    geom = spec.geom
    assert geom.cap == int(case.split()[-1])
    rng = np.random.default_rng(2)
    d = rng.uniform(-0.9, 0.9, tuple(state.x.shape)) * np.asarray(
        geom.cell_size)[:, None, None]
    state = dataclasses.replace(state, x=state.x + torch.as_tensor(
        d, dtype=state.x.dtype, device=cuda) * state.valid)
    assert rebin_cuda.move_route(geom) is rebin_cuda.rebin_move_3d
    fields = TS.particle_fields(state)
    fields["x"] = TS.wrap_pbc(fields["x"], geom)
    PF, PI, fmeta, _ = rebin_cuda._pack_fields(fields, geom.cap, geom.ncells_total)
    xr = rebin_cuda._x_row(fmeta)
    before = rebin_cuda.rebin_move_3d.launches
    kf, ki = rebin_cuda.rebin_move_3d(PF, PI, geom, xr)
    assert rebin_cuda.rebin_move_3d.launches == before + 1
    pf_, pi_ = rebin_cuda.rebin_move_plain(PF, PI, geom, xr)
    assert torch.equal(kf, pf_) and torch.equal(ki, pi_)
    ref = TS.rebin(state, geom, use_kernel=False)
    got = TS.rebin(state, geom, use_kernel=True)
    for f in dataclasses.fields(ref):
        assert torch.equal(getattr(ref, f.name), getattr(got, f.name)), f.name
    assert int(got.valid.sum(0).max()) > 64


@pytest.mark.gpu
@pytest.mark.parametrize("cap, side", [(96, 32), (400, 16)])
def test_k6_past_cap_64_matches_plain_walk_and_sort_on_card(cuda, cap, side):
    """K6 past cap 64 on seeded periodic 2D grids of cells fuller than 64
    (cap 96: its slot lists within the default 48 KB a block; cap 400:
    past it, opted in), each particle moved by up to 0.45 cells an axis:
    the kernel == the plain walk == the sort rebin, every leaf bitwise,
    and the rebin launches K6."""
    geom = TS.Geometry.build(dim=2, lo=(0.0, 0.0, 0.0), hi=(1.0, 1.0, 0.1),
                             cutoff=0.96 / side, cap=cap, margin=0.039 / side,
                             periodic=(True, True, True))
    assert geom.ncells[:2] == (side, side)
    assert rebin_cuda.move_route(geom) is rebin_cuda.rebin_move_2d_gated
    rng = np.random.default_rng(cap)
    n = int(0.55 * cap * side * side)
    state = TS.state_from_particles(geom, rng.uniform(0.0, 1.0, (n, 2)),
                                    np.zeros(n, np.int64), device=cuda)
    d = rng.uniform(-0.45, 0.45, tuple(state.x.shape)) / side
    d[2] = 0.0
    state = dataclasses.replace(state, x=state.x + torch.as_tensor(
        d, dtype=state.x.dtype, device=cuda) * state.valid)
    assert int(state.overflow) == 0 and int(state.valid.sum(0).max()) > 64
    fields = TS.particle_fields(state)
    fields["x"] = TS.wrap_pbc(fields["x"], geom)
    PF, PI, fmeta, _ = rebin_cuda._pack_fields(fields, cap, geom.ncells_total)
    xr = rebin_cuda._x_row(fmeta)
    kf, ki = rebin_cuda.rebin_move_2d_gated(PF, PI, geom, xr)
    pf_, pi_ = rebin_cuda.rebin_move_plain(PF, PI, geom, xr)
    assert torch.equal(kf, pf_) and torch.equal(ki, pi_)
    before = rebin_cuda.rebin_move_2d_gated.launches
    got = TS.rebin(state, geom, use_kernel=True)
    assert rebin_cuda.rebin_move_2d_gated.launches == before + 1
    ref = TS.rebin(state, geom, use_kernel=False)
    for f in dataclasses.fields(ref):
        assert torch.equal(getattr(ref, f.name), getattr(got, f.name)), f.name


# ---------------------------------------------------------------------------
# the rest of K1 (its full body) and K4 (the window in shared memory)
# ---------------------------------------------------------------------------


def _grouped_case(case, device):
    """(state, params, spec) of a K1 branch: "flagship", the N=30 cavity
    (the transport-velocity body); "mechanics", the N=30 cavity under the
    mechanics pair style (symmetric pressure, XSPH); "fsi", the nx=24 FSI
    beam released at step 2 with its S seeded (periodic x, free elastic
    solids, a mixed lattice forced through the grouped shape); "fsi
    thermal", that state with e = 1 and kB 1e-13 under the thermal rows;
    "polarization", the nx=24 polarization state (the fsi pair style,
    ``ampl_damp``, the G0 row, one species, periodic x and y); "blob", the
    s=1 balanced blob with rho and v seeded (solid-free)."""
    from sph_bvf_tpu_torch.api.scene import Region, Scene
    from sph_bvf_tpu_torch.core.fixes import SetForce

    if case in ("flagship", "mechanics"):
        style = "mechanics" if case == "mechanics" else "transport_velocity"
        state, params, spec = lid_cavity.scene(
            Scene, Region, SetForce, N=30, pair_style=style).build(device=device)
        state = run_chunk(setup(state, params, spec, dt=1e-4), params, spec, 9)
        return state, params, spec
    if case.startswith("fsi"):
        state, params, spec, _ = fsi.build(nx=24, rebin_every=4, tdamp_solid=2,
                                           device=device)
        state = run_chunk(setup(state, params, spec, dt=1e-8), params, spec, 4)
        rng = np.random.default_rng(0)
        S = rng.normal(0.0, 50.0, tuple(state.S.shape))
        S = torch.as_tensor(S + np.swapaxes(S, 0, 1), dtype=state.S.dtype,
                            device=device)
        solid = state.valid & (state.solid_tag == 1)
        state = dataclasses.replace(state, S=torch.where(solid, S, 0.0))
        if case == "fsi thermal":
            state = dataclasses.replace(state, e=state.valid.to(state.e.dtype))
            params = dataclasses.replace(params, boltz=1e-13)
            spec = dataclasses.replace(
                spec, pair=dataclasses.replace(spec.pair, thermal=True))
        return state, params, spec
    if case == "polarization":
        return _polar(device, steps=3)
    state, params, spec = _blob(device, steps=5)
    rng = np.random.default_rng(0)
    t = lambda a: torch.as_tensor(a, dtype=state.rho.dtype, device=device)
    return (dataclasses.replace(
        state, rho=state.rho * t(1.0 + 0.01 * rng.standard_normal(
            tuple(state.rho.shape))),
        v=state.v + t(0.01 * rng.standard_normal(tuple(state.v.shape)))),
        params, spec)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["flagship", "mechanics", "fsi", "fsi thermal",
                                  "polarization", "blob"])
@pytest.mark.parametrize("filt", [True, False], ids=["filter", "nofilter"])
def test_k1_branches_and_k4_match_on_card(cuda, filt, case):
    """K1 with each branch of the grouped kernel against the plain loop on
    the same CUDA tensors, each field within 5e-6 of its max (the full
    body's dS, ddx and Q included), and K4 on the same inputs bitwise K1:
    K4's entry point launches K1's kernel with K1's tile."""
    state, params, spec = _grouped_case(case, cuda)
    geom = spec.geom
    cfg = dataclasses.replace(spec.pair, density_filter_accs=filt)
    assert pair_cuda.kernel_unsupported(geom, cfg, pair_cuda.pass_a_2d,
                                        n_sdpd=params.n_sdpd) == []
    assert pair_cuda.tv_body(geom, cfg) == (case == "flagship")
    pf = pair._per_particle(state, params, cfg)
    noise = pair.noise_inputs(state)
    ref = pair._pass_a_plain(pf, params, geom, cfg, noise)
    before = (pair_cuda.pass_a_2d.launches, pair_cuda.pass_a_2d_preshift.launches)
    got = pair_cuda.pass_a_2d(pf, params, geom, cfg, noise)
    pre = pair_cuda.pass_a_2d_preshift(pf, params, geom, cfg, noise)
    torch.cuda.synchronize()
    assert (pair_cuda.pass_a_2d.launches,
            pair_cuda.pass_a_2d_preshift.launches) == (before[0] + 1,
                                                       before[1] + 1)
    names = K2_FIELDS + (("Q",) if params.n_sdpd else ())
    for name in (n for n in names if filt or not n.startswith("rhoAux")):
        scale = max(float(ref[name].abs().max()), 1e-30)
        err = float((got[name] - ref[name]).abs().max())
        assert err <= 5e-6 * scale, (name, err / scale)
    for name in pair.PASS_A_ACCS:
        assert torch.equal(pre[name], got[name]), name
    if case in ("mechanics", "fsi", "polarization"):
        assert float(ref["ddx"].abs().max()) > 0
    if case.startswith("fsi") or case == "polarization":
        assert float(ref["dS"].abs().max()) > 0
    if case == "blob":
        for name in ("phi", "nw", "dS"):
            assert float(got[name].abs().max()) == 0.0, name


@pytest.mark.gpu
def test_preshift_window_routes_the_flagship_to_k4_on_card(cuda):
    """With ``preshift_window`` the flagship's steps launch K4 and never
    K1, and end bitwise where K1's do."""
    from sph_bvf_tpu_torch.api.scene import Region, Scene
    from sph_bvf_tpu_torch.core.fixes import SetForce

    runs = {}
    for flag in (False, True):
        state, params, spec = lid_cavity.scene(
            Scene, Region, SetForce, N=30,
            preshift_window=flag).build(device=cuda)
        before = (pair_cuda.pass_a_2d.launches,
                  pair_cuda.pass_a_2d_preshift.launches)
        state = run_chunk(setup(state, params, spec, dt=1e-4), params, spec, 10)
        torch.cuda.synchronize()
        got = (pair_cuda.pass_a_2d.launches - before[0],
               pair_cuda.pass_a_2d_preshift.launches - before[1])
        assert got == ((0, 11) if flag else (11, 0))
        runs[flag] = state
    for f in dataclasses.fields(runs[False]):
        assert torch.equal(getattr(runs[False], f.name),
                           getattr(runs[True], f.name)), f.name


# ---------------------------------------------------------------------------
# K5 on periodic grids, K7 with x_edges on a periodic grid, K8
# ---------------------------------------------------------------------------


def _move_parity_on_card(wrapper, state, geom):
    """``wrapper`` on the state's packs against the plain walk, and the
    rebin through it against the sort rebin: every leaf bitwise, one
    launch."""
    fields = TS.particle_fields(state)
    fields["x"] = TS.wrap_pbc(fields["x"], geom)
    PF, PI, fmeta, _ = rebin_cuda._pack_fields(fields, geom.cap,
                                               geom.ncells_total)
    xr = rebin_cuda._x_row(fmeta)
    before = wrapper.launches
    kf, ki = wrapper(PF, PI, geom, xr)
    wf, wi = rebin_cuda.rebin_move_plain(PF, PI, geom, xr)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert torch.equal(kf, wf) and torch.equal(ki, wi)
    ref = TS.rebin(state, geom, use_kernel=False)
    got = TS.rebin(state, geom, use_kernel=True)
    for f in dataclasses.fields(ref):
        assert torch.equal(getattr(ref, f.name), getattr(got, f.name)), f.name


@pytest.mark.gpu
@pytest.mark.parametrize("edges", [False, True], ids=["uniform", "x_edges"])
def test_k5_periodic_matches_plain_walk_and_sort_on_card(cuda, edges):
    """K5 on the 2D vortex's doubly periodic grid (N=60, cap 14) on the
    card, after setup and 10 steps, after a seeded drift across every face
    and corner and with positions a hair below and at the box's ends, with
    uniform x columns and with columns of widths 7/8 and 9/8 of a cell:
    bitwise the plain walk and the sort."""
    N = 60
    state, params, spec, _ = taylor_green2d.build(N, device=cuda)
    state = run_chunk(setup(state, params, spec,
                            dt=taylor_green2d.timestep(N)), params, spec, 10)
    geom = spec.geom
    if edges:
        geom = with_synthetic_edges(geom)
        state = TS.rebin(state, geom, use_kernel=False, drift_check=False)
    assert rebin_cuda.move_route(geom) is rebin_cuda.rebin_move_2d
    _move_parity_on_card(rebin_cuda.rebin_move_2d, state, geom)
    x, valid = state.x.cpu().numpy(), state.valid.cpu().numpy()
    for moved in (any_corner_drift(x, valid, geom),
                  seam_hairs(x, valid, geom)):
        _move_parity_on_card(rebin_cuda.rebin_move_2d, dataclasses.replace(
            state, x=torch.as_tensor(moved, device=cuda)), geom)


@pytest.mark.gpu
def test_2d_move_keeps_its_lists_out_of_local_memory_on_card(cuda):
    """The 2D move's kernel (K5's and K6's, ``csrc/rebin_move_2d.cu``) keeps
    its slot lists and window in shared memory: the runtime reports 0 bytes
    of local memory a thread (no stack frame, no spill)."""
    attrs = rebin_cuda.move_2d_attributes()
    assert attrs["local_bytes"] == 0, attrs
    assert 0 < attrs["registers"] <= 255, attrs


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["k5 cavity", "k6 fsi"])
def test_2d_rebin_counts_its_own_wrapper_on_card(cuda, case):
    """A rebin of a 2D state on the card launches the move its grid routes
    to once, counted on that wrapper (K5's or K6's, which share one
    kernel) and on no other launch counter, and equals the sort rebin,
    every leaf bitwise."""
    if case == "k5 cavity":
        state, params, spec = _cavity(30, cuda, steps=9)
        want = rebin_cuda.rebin_move_2d
    else:
        state, params, spec = _fsi(cuda)
        state = run_chunk(state, params, spec, 3)
        want = rebin_cuda.rebin_move_2d_gated
    geom = spec.geom
    assert rebin_cuda.move_route(geom) is want
    counters = (pair_cuda.pass_a_2d, pair_cuda.pass_a_2d_preshift,
                pair_cuda.pass_a_2d_rowloop, pair_cuda.pass_a_3d,
                rebin_cuda.rebin_move_2d, rebin_cuda.rebin_move_2d_gated,
                rebin_cuda.rebin_move_3d)
    before = [c.launches for c in counters]
    got = TS.rebin(state, geom, drop=_rebin_drop(spec))
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [
        int(c is want) for c in counters]
    ref = TS.rebin(state, geom, drop=_rebin_drop(spec), use_kernel=False)
    for f in dataclasses.fields(ref):
        assert torch.equal(getattr(ref, f.name), getattr(got, f.name)), f.name


@pytest.mark.gpu
def test_k7_edges_periodic_matches_plain_walk_and_sort_on_card(cuda):
    """K7 with x_edges on the periodic grid of the balanced 3D blob at s=1
    on the card, after setup and after a seeded drift across the x and z
    seams: bitwise the plain walk and the sort."""
    state, params, spec, _ = drift_blob.build(1, True, True, device=cuda,
                                              nz_cells=3)
    geom = spec.geom
    assert geom.x_edges is not None and geom.periodic == (True, False, True)
    state = setup(state, params, spec, dt=drift_blob.timestep(1))
    _move_parity_on_card(rebin_cuda.rebin_move_3d, state, geom)
    x = seam_drift(state.x.cpu().numpy(), state.valid.cpu().numpy(), geom)
    _move_parity_on_card(rebin_cuda.rebin_move_3d, dataclasses.replace(
        state, x=torch.as_tensor(x, device=cuda)), geom)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", rp.VARIANTS)
def test_k8_matches_plain_on_card(cuda, variant):
    """Each K8 kernel on the card against its plain version on the same
    CUDA tensors at the JAX tool's default grid (19 blocks), bitwise, with
    mma bitwise slice: one launch each."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((rp.R, rp.W)).astype(np.float32),
                        device=cuda)
    S = rp.shift_matrix(cuda)
    wrapper = {"slice": rp.probe_slice, "mma": rp.probe_mma,
               "base": rp.probe_base}[variant]
    before = wrapper.launches
    got = rp.probe(variant, x, rp.BLOCKS, S)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert torch.equal(got, rp.plain(variant, x, rp.BLOCKS, S))
    if variant == "mma":
        assert torch.equal(got, rp.probe_slice(x, rp.BLOCKS))


# ---------------------------------------------------------------------------
# K4's window in shared memory, K2 over K3's walk, the walk index kept
# between rebins
# ---------------------------------------------------------------------------


def _crowded_validity(seed=3):
    """A compacted [47, 61] validity, as a rebin leaves the FSI beam's cap
    47, with cells of every occupancy from empty to full (a cell past 32
    valid slots takes two warps of K2)."""
    rng = np.random.default_rng(seed)
    occ = rng.integers(0, 48, 61)
    occ[:3] = (0, 33, 47)
    return torch.as_tensor(np.arange(47)[:, None] < occ[None, :])


@pytest.mark.parametrize("case", ["fsi", "polarization", "crowded"])
def test_walk_index_on_rebinned_2d_states(case):
    """K2's index on its own 2D states after a rebin (the FSI beam at
    nx=24, polarization at nx=24, both periodic in x, polarization in y
    too) and on a compacted validity with cells past 32 slots: ``order``
    lists every valid slot once, cell by cell, then -1, and ``lead`` is
    each cell's occupancy (the rebin leaves the slots compacted)."""
    if case == "fsi":
        valid = _fsi("cpu")[0].valid
    elif case == "polarization":
        valid = _polar("cpu", steps=5)[0].valid
    else:
        valid = _crowded_validity()
    assert int(valid.sum(0).max()) > (32 if case == "crowded" else 9)
    order, lead = pair_cuda.walk_index(valid)
    want_order, want_lead = _walk_index_reference(valid.numpy())
    assert order.tolist() == want_order and lead.tolist() == want_lead
    assert torch.equal(lead.long(), valid.sum(0))


def test_walk_index_is_kept_between_rebins():
    """``walk_index_of`` returns the same tensors while a state's
    validity is the same tensor and unedited (the steps between two
    rebins keep it), and builds the index anew after a rebin (a new
    tensor) and after an in-place edit of the validity (its version)."""
    from sph_bvf_tpu_torch.core.stepper import step

    state, params, spec = _fsi("cpu")
    first = pair_cuda.walk_index_of(state.valid)
    state = step(state, params, spec)
    again = pair_cuda.walk_index_of(state.valid)
    assert again[0] is first[0] and again[1] is first[1]
    rebinned = TS.rebin(state, spec.geom)
    assert rebinned.valid is not state.valid
    after = pair_cuda.walk_index_of(rebinned.valid)
    assert after[0] is not first[0]
    for got, want in zip(after, pair_cuda.walk_index(rebinned.valid)):
        assert torch.equal(got, want)
    valid = rebinned.valid.clone()
    kept = pair_cuda.walk_index_of(valid)
    c = int(valid.sum(0).argmax())
    valid[int(valid[:, c].sum()) - 1, c] = False  # the cell's last particle
    edited = pair_cuda.walk_index_of(valid)
    assert edited[0] is not kept[0]
    assert int(edited[1][c]) == int(kept[1][c]) - 1
    for got, want in zip(edited, pair_cuda.walk_index(valid)):
        assert torch.equal(got, want)


def test_kernel_tables_are_kept_until_params_change():
    """``kernel_tables`` returns the same coefficient tables while the
    params hold the same field values, unedited, and builds them anew
    after a field is replaced or edited in place; each time they equal
    the tables built from scratch (the species table too)."""
    _, params, spec, _ = natural_convection.build(N=40, device="cpu")
    cfg, dev = spec.pair, torch.device("cpu")
    assert params.n_sdpd > 0

    def fresh(p):
        tabs = pair.coeff_tables(p, cfg)
        return (pair_cuda._mech_tables(p, cfg, tabs),
                pair_cuda._species_tables(p, cfg, tabs))

    first = pair_cuda.kernel_tables(params, cfg, pair_cuda._mech_tables, dev)
    again = pair_cuda.kernel_tables(params, cfg, pair_cuda._mech_tables, dev)
    assert again[0] is first[0] and again[1] is first[1]
    for got, want in zip(first, fresh(params)):
        assert torch.equal(got, want)
    tv = pair_cuda.kernel_tables(params, cfg, pair_cuda._tables, dev)
    assert torch.equal(tv[0], pair_cuda._tables(params, cfg))
    wider = dataclasses.replace(params, cut=params.cut * 1.1)
    replaced = pair_cuda.kernel_tables(wider, cfg, pair_cuda._mech_tables, dev)
    assert not torch.equal(replaced[0], first[0])
    for got, want in zip(replaced, fresh(wider)):
        assert torch.equal(got, want)
    wider.cut.mul_(1.2)  # an in-place edit of a field
    edited = pair_cuda.kernel_tables(wider, cfg, pair_cuda._mech_tables, dev)
    assert edited[0] is not replaced[0]
    for got, want in zip(edited, fresh(wider)):
        assert torch.equal(got, want)


K4_TILES = [(4, 8), (8, 8), (3, 5), (1, 1)]


def _k4_case(case, device):
    """A K1/K4 state: "flagship" the N=30 cavity (12 x 12 cells, walls,
    the tv body), "vortex N=9" the 2D vortex on 3 x 3 cells (both axes
    periodic, solid-free, the full body), "polarization" the nx=24 state
    (6 x 6 periodic cells, cap 30, elastic, one species, the full body)."""
    if case == "vortex N=9":
        state, params, spec, _ = taylor_green2d.build(9, device=device)
        state = run_chunk(setup(state, params, spec,
                                dt=taylor_green2d.timestep(9)), params, spec, 3)
        return state, params, spec
    return _grouped_case(case, device)


@pytest.mark.gpu
@pytest.mark.parametrize("tile", K4_TILES, ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("case", ["flagship", "vortex N=9", "polarization"])
def test_k4_matches_k1_bitwise_on_ragged_tiles_on_card(cuda, case, tile,
                                                       monkeypatch):
    """K4 with each tile as its first choice (every one but 1 x 1 ragged on
    every grid here: the cells are not multiples of the tile; a window past
    the block's shared memory falls back to a smaller tile) bitwise K1 with
    its own tile on the same inputs, every accumulator, on walls,
    three-cell periodic axes and the elastic, species and periodic
    polarization state: the tile changes no term and no order."""
    state, params, spec = _k4_case(case, cuda)
    geom = spec.geom
    nx, ny = geom.ncells[:2]
    assert tile == (1, 1) or nx % tile[0] or ny % tile[1]
    for filt in (False, True):
        cfg = dataclasses.replace(spec.pair, density_filter_accs=filt)
        pf = pair._per_particle(state, params, cfg)
        noise = pair.noise_inputs(state)
        want = pair_cuda.pass_a_2d(pf, params, geom, cfg, noise)
        with monkeypatch.context() as m:
            m.setattr(pair_cuda, "K4_TILE", {True: tile, False: tile})
            got = pair_cuda.pass_a_2d_preshift(pf, params, geom, cfg, noise)
        torch.cuda.synchronize()
        for name in pair.PASS_A_ACCS:
            assert torch.equal(got[name], want[name]), (name, filt)
        assert float(want["f"].abs().max()) > 0


def _with_holes(state, seed=1):
    """``state`` with a seeded fifth of its valid slots emptied (the slot
    left as it was, its valid flag off), so cells hold invalid slots below
    their last valid one."""
    rng = np.random.default_rng(seed)
    drop = torch.as_tensor(rng.uniform(size=tuple(state.valid.shape)) < 0.2,
                           device=state.valid.device)
    return dataclasses.replace(state, valid=state.valid & ~drop)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["flagship", "mechanics", "polarization"])
def test_k1_walks_to_the_tail_on_a_grid_with_holes_on_card(cuda, case):
    """K1 on a grid whose cells hold invalid slots below their tails
    (``_with_holes``) within 5e-6 of the plain loop's max, field by field,
    and K4 on the same inputs bitwise K1."""
    state, params, spec = _grouped_case(case, cuda)
    state = _with_holes(state)
    tails, depth = pair_cuda.tail_index(state.valid)
    assert not torch.equal(tails.long(), state.valid.sum(0))
    for filt in (False, True):
        cfg = dataclasses.replace(spec.pair, density_filter_accs=filt)
        pf = pair._per_particle(state, params, cfg)
        noise = pair.noise_inputs(state)
        ref = pair._pass_a_plain(pf, params, spec.geom, cfg, noise)
        got = pair_cuda.pass_a_2d(pf, params, spec.geom, cfg, noise)
        pre = pair_cuda.pass_a_2d_preshift(pf, params, spec.geom, cfg, noise)
        torch.cuda.synchronize()
        names = K2_FIELDS + (("Q",) if params.n_sdpd else ())
        for name in (n for n in names if filt or not n.startswith("rhoAux")):
            scale = max(float(ref[name].abs().max()), 1e-30)
            err = float((got[name] - ref[name]).abs().max())
            assert err <= 5e-6 * scale, (name, err / scale)
        for name in pair.PASS_A_ACCS:
            assert torch.equal(pre[name], got[name]), name


@pytest.mark.gpu
def test_k1_window_just_under_48_kb_launches_on_card(cuda, monkeypatch):
    """K1 and K4 whose window's dynamic shared memory lies between the
    kernel's default (48 KB less its static shared memory) and 48 KB, where
    a launch fails unless the kernel is allowed more first: the flagship
    N=30 state cut to 8 slots deep (every slot from 8 emptied), its 19 rows
    in a 6 x 8 tile's 80-cell window, 48,640 bytes.  K1 within 5e-6 of the
    plain loop's max, K4 bitwise K1."""
    state, params, spec = _grouped_case("flagship", cuda)
    slot = torch.arange(state.valid.shape[0], device=cuda)[:, None]
    state = dataclasses.replace(state, valid=state.valid & (slot < 8))
    assert pair_cuda.tail_index(state.valid)[1] == 8
    monkeypatch.setattr(pair_cuda, "K4_TILE", {True: (6, 8), False: (6, 8)})
    cfg = dataclasses.replace(spec.pair, density_filter_accs=False)
    pf = pair._per_particle(state, params, cfg)
    cap, NC = state.valid.shape
    rows = pair_cuda._pack(pf, pair_cuda.PF_ROWS, cap, NC).shape[0]
    assert 48 * 1024 - 1024 < 4 * rows * 8 * (6 + 2) * (8 + 2) <= 48 * 1024
    ref = pair._pass_a_plain(pf, params, spec.geom, cfg)
    got = pair_cuda.pass_a_2d(pf, params, spec.geom, cfg)
    pre = pair_cuda.pass_a_2d_preshift(pf, params, spec.geom, cfg)
    torch.cuda.synchronize()
    for name in (n for n in K1_FIELDS if not n.startswith("rhoAux")):
        scale = max(float(ref[name].abs().max()), 1e-30)
        err = float((got[name] - ref[name]).abs().max())
        assert err <= 5e-6 * scale, (name, err / scale)
    for name in pair.PASS_A_ACCS:
        assert torch.equal(pre[name], got[name]), name


@pytest.mark.gpu
def test_k1_window_at_the_shared_memory_ceiling_launches_on_card(
        cuda, monkeypatch):
    """K1 and K4 whose window's dynamic shared memory lies within 80 bytes
    of ``K4_SHARED``, the 227 KB a block may hold less the kernel's static
    shared memory: the fsi state's 40 rows (the full body with the filter
    row) cut to 23 slots deep (every slot from 23 emptied) in a 7 x 5
    tile's 63-cell window, 231,840 bytes.  With the static bytes the block
    holds at most the H100's 232,448, so the launch takes the tile; K1
    within 5e-6 of the plain loop's max, K4 bitwise K1."""
    state, params, spec = _grouped_case("fsi", cuda)
    slot = torch.arange(state.valid.shape[0], device=cuda)[:, None]
    state = dataclasses.replace(state, valid=state.valid & (slot < 23))
    assert pair_cuda.tail_index(state.valid)[1] == 23
    monkeypatch.setattr(pair_cuda, "K4_TILE", {True: (7, 5), False: (7, 5)})
    cfg = dataclasses.replace(spec.pair, density_filter_accs=True)
    pf = pair._per_particle(state, params, cfg)
    noise = pair.noise_inputs(state)
    cap, NC = state.valid.shape
    rows = pair_cuda._pack(pf, pair_cuda.MECH_PF_ROWS + ("AS", "S", "rhoI"),
                           cap, NC).shape[0]
    assert rows == 40
    window = 4 * rows * 23 * (7 + 2) * (5 + 2)
    assert pair_cuda.K4_SHARED - 80 <= window <= pair_cuda.K4_SHARED
    assert pair_cuda.k4_tile(rows, 23, False) == (7, 5)
    ref = pair._pass_a_plain(pf, params, spec.geom, cfg, noise)
    got = pair_cuda.pass_a_2d(pf, params, spec.geom, cfg, noise)
    pre = pair_cuda.pass_a_2d_preshift(pf, params, spec.geom, cfg, noise)
    torch.cuda.synchronize()
    for name in K2_FIELDS:
        scale = max(float(ref[name].abs().max()), 1e-30)
        err = float((got[name] - ref[name]).abs().max())
        assert err <= 5e-6 * scale, (name, err / scale)
    for name in pair.PASS_A_ACCS:
        assert torch.equal(pre[name], got[name]), name


@pytest.mark.gpu
@pytest.mark.parametrize("lists", ["shared", "global"])
@pytest.mark.parametrize("case", ["vortex cap 86", "fsi3d cap 119"])
def test_k7_lists_in_shared_and_global_memory_on_card(cuda, case, lists,
                                                      monkeypatch):
    """K7 with its slot lists in shared memory and, past a lowered
    ``K7_LIST_BYTES``, in the global scratch (the grids' cell counts are no
    multiple of the 16 target cells a block: the last block is cut short at
    the grid's end), after a seeded drift of up to 0.9 cells: the kernel ==
    the plain walk == the sort rebin, every leaf bitwise, one launch."""
    from sph_bvf_tpu_torch.models import taylor_green3d

    if case.startswith("vortex"):
        state, params, spec, _ = taylor_green3d.build(12, device=cuda)
    else:
        state, params, spec, _ = fsi.build_spanwise(12, device=cuda)
    geom = spec.geom
    assert geom.ncells_total % rebin_cuda.K7_CELLS
    monkeypatch.setattr(rebin_cuda, "K7_LIST_BYTES", 4 * geom.cap
                        * rebin_cuda.K7_CELLS - (lists == "global"))
    assert rebin_cuda.k7_list(geom.cap) == (lists == "shared")
    rng = np.random.default_rng(5)
    d = rng.uniform(-0.9, 0.9, tuple(state.x.shape)) * np.asarray(
        geom.cell_size)[:, None, None]
    state = dataclasses.replace(state, x=state.x + torch.as_tensor(
        d, dtype=state.x.dtype, device=cuda) * state.valid)
    _move_parity_on_card(rebin_cuda.rebin_move_3d, state, geom)


@pytest.mark.gpu
def test_k2_lists_flush_and_never_truncate_on_card(cuda):
    """K2's per-lane lists of in-support candidates (K3's walk) are run and
    emptied whenever one could not take another step, so none overflows:
    with every support widened 5x (past the 9 cells' diagonal), every
    candidate passes the test, and K2 still matches the plain 9-offset
    loop field by field within 5e-6 of its max on the FSI beam (its elastic
    terms live: S seeded)."""
    state, params, spec = _fsi(cuda, seed_S=True)
    wide = dataclasses.replace(params, cut=params.cut * 5.0)
    cfg = dataclasses.replace(spec.pair, density_filter_accs=True)
    pf = pair._per_particle(state, wide, cfg)
    ref = pair._pass_a_plain(pf, wide, spec.geom, cfg)
    got = pair_cuda.pass_a_2d_rowloop(pf, wide, spec.geom, cfg)
    torch.cuda.synchronize()
    for name in K2_FIELDS:
        scale = max(float(ref[name].abs().max()), 1e-30)
        err = float((got[name] - ref[name]).abs().max())
        assert err <= 5e-6 * scale, (name, err / scale)


@pytest.mark.gpu
@pytest.mark.parametrize("filt", [True, False], ids=["filter", "nofilter"])
def test_k2_vortex_matches_plain_on_card(cuda, filt):
    """K2 on the 2D vortex at N=60 (solid-free, both axes periodic) after
    10 steps with its positions jittered by up to a tenth of a spacing per
    axis (seeded, as chip_smoke's main tgv2d holds K2: on whole lattice
    patches ddv cancels to a small part of its terms, where K2 and the
    plain f32 loop differ by their roundings) within 5e-6 of the plain
    loop's max, field by field; phi, nw and dS exactly 0."""
    N = 60
    state, params, spec, _ = taylor_green2d.build(N, device=cuda)
    state = run_chunk(setup(state, params, spec,
                            dt=taylor_green2d.timestep(N)), params, spec, 10)
    rng = np.random.default_rng(0)
    dx = rng.uniform(-0.1, 0.1, tuple(state.x.shape)) * (taylor_green2d.L / N)
    dx[2] = 0.0
    state = dataclasses.replace(state, x=state.x + torch.as_tensor(
        dx, dtype=state.x.dtype, device=cuda) * state.valid)
    assert pair_cuda.route(spec.geom, spec.pair) is pair_cuda.pass_a_2d_rowloop
    cfg = dataclasses.replace(spec.pair, density_filter_accs=filt)
    pf = pair._per_particle(state, params, cfg)
    ref = pair._pass_a_plain(pf, params, spec.geom, cfg)
    got = pair_cuda.pass_a(pf, params, spec.geom, cfg)
    torch.cuda.synchronize()
    for name in (n for n in K2_FIELDS if filt or not n.startswith("rhoAux")):
        scale = max(float(ref[name].abs().max()), 1e-30)
        err = float((got[name] - ref[name]).abs().max())
        assert err <= 5e-6 * scale, (name, err / scale)
    for name in ("phi", "nw", "dS"):
        assert float(got[name].abs().max()) == 0.0, name
