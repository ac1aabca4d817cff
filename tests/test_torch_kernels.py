"""The port's hand-written CUDA kernels (K1 pass A, K5 rebin move).

The kernel-vs-plain checks need a CUDA card and are marked ``gpu``: they
skip on a machine without one (run them there with
``python -m pytest tests/test_torch_kernels.py -m gpu``).  The CPU checks
hold what the wrappers promise off the card: a CPU tensor runs the plain
version and never counts a launch, and the kernels' eligibility covers
the flagship.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sph_bvf_tpu_torch.core import rebin_cuda
from sph_bvf_tpu_torch.core import state as TS
from sph_bvf_tpu_torch.core.stepper import run_chunk, setup
from sph_bvf_tpu_torch.models import lid_cavity
from sph_bvf_tpu_torch.ops import pair, pair_cuda

K1_FIELDS = ("f", "drho", "num_den", "phi", "nw", "ddv", "de", "rhoAux1",
             "rhoAux2")


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
    pf_, pi_ = rebin_cuda.rebin_move_2d_plain(PF, PI, geom, xr)
    assert torch.equal(kf, pf_) and torch.equal(ki, pi_)
    ref = TS.rebin(state, geom, use_kernel=False)
    got = TS.rebin(state, geom, use_kernel=True)
    for f in dataclasses.fields(ref):
        assert torch.equal(getattr(ref, f.name), getattr(got, f.name)), f.name


def test_no_launch_on_cpu_tensors():
    """On CPU tensors the wrappers run the plain versions: a setup and a
    chunk move neither launch counter."""
    k1, k5 = pair_cuda.pass_a_2d.launches, rebin_cuda.rebin_move_2d.launches
    state, params, spec = _cavity(16, "cpu", steps=3)
    assert int(state.step) == 3
    assert pair_cuda.pass_a_2d.launches == k1
    assert rebin_cuda.rebin_move_2d.launches == k5


def test_kernels_serve_the_flagship_grid():
    """The flagship geometry and pair configuration are what K1 and K5
    serve; a periodic or 3D grid is not (it raises on a CUDA tensor)."""
    state, params, spec, _ = lid_cavity.build(N=50)
    assert pair_cuda.kernel_unsupported(spec.geom, spec.pair) == []
    assert rebin_cuda.move_supported(spec.geom)
    periodic = dataclasses.replace(spec.geom, periodic=(True, False, True))
    assert not rebin_cuda.move_supported(periodic)
    assert pair_cuda.kernel_unsupported(periodic, spec.pair)
    big_cap = dataclasses.replace(spec.geom, cap=rebin_cuda.MAX_CAP + 1)
    assert not rebin_cuda.move_supported(big_cap)
    flat3d = dataclasses.replace(spec.geom, dim=3, ncells=(19, 19, 4))
    assert not rebin_cuda.move_supported(flat3d)
    assert pair_cuda.kernel_unsupported(flat3d, spec.pair)


def test_k1_tables_match_plain_coefficients():
    """The per-type-pair rows K1 reads are the plain path's coefficients:
    1/h, eta, 1/wdelta and the two Lucy factors, flattened [T*T]."""
    from sph_bvf_tpu_torch.ops.kernels import lucy_w_coef, lucy_wfd_coef

    _, params, spec, _ = lid_cavity.build(N=50)
    tab = pair_cuda._tables(params, spec.pair)
    tabs = pair.coeff_tables(params, spec.pair)
    T = params.ntypes
    assert tab.shape == (5, T * T) and tab.dtype == torch.float32
    ih = tabs["inv_h"].reshape(-1)
    np.testing.assert_array_equal(tab[0].numpy(), ih.numpy())
    np.testing.assert_array_equal(tab[1].numpy(), tabs["eta"].reshape(-1).numpy())
    np.testing.assert_array_equal(tab[2].numpy(),
                                  tabs["inv_wdelta"].reshape(-1).numpy())
    np.testing.assert_array_equal(tab[3].numpy(), lucy_wfd_coef(ih, 2).numpy())
    np.testing.assert_array_equal(tab[4].numpy(), lucy_w_coef(ih, 2).numpy())
