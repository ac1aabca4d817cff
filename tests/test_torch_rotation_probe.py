"""K8, the window-rotation probe, in the PyTorch port against the JAX probe.

``ops/rotation_probe.py`` ports ``tools/mxu_rotation_probe.py``: three ways
to produce and fold the 9 stencil-shifted views of one [352, 512] window,
``slice`` (shifted loads), ``mma`` (a product with the 0/1 shift matrix)
and ``base`` (one aligned view, the floor).  The CUDA kernels
(``csrc/rotation_probe.cu``) run on a card only; here the plain versions
are held bitwise to the JAX tool's own Pallas kernels, run through its
``_call`` in interpret mode on the CPU (``pl.pallas_call`` wrapped with
``interpret=True``; the tool itself is not edited).  The kernels are held
to the plain versions on the card by the ``gpu``-marked tests of
``tests/test_torch_kernels.py``, which import no JAX.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_bvf_tpu_torch.ops import rotation_probe as rp

TOOL = Path(__file__).resolve().parent.parent / "tools" / "mxu_rotation_probe.py"


@pytest.fixture(scope="module")
def jax_probe():
    """The JAX tool as a module.  Importing it points JAX's compilation
    cache at the tool's own directory; the suite's settings are put back
    at once."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    spec = importlib.util.spec_from_file_location("mxu_rotation_probe", TOOL)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


def _window(seed=0):
    return np.random.default_rng(seed).standard_normal((rp.R, rp.W)).astype(
        np.float32)


def test_shapes_and_shift_matrix_are_the_jax_probes(jax_probe):
    """The port's shapes, offsets and fold constants are the tool's, and
    ``shift_matrix`` is its ``_shift_matrix`` bitwise: one 1 in every
    column, at row H + OFFS[o] + l of column o BLK + l."""
    assert (rp.R, rp.BLK, rp.H, rp.W) == (jax_probe.R, jax_probe.BLK,
                                          jax_probe.H, jax_probe.W)
    assert list(rp.OFFS) == jax_probe.OFFS and list(rp.CS) == jax_probe.CS
    S = rp.shift_matrix()
    np.testing.assert_array_equal(S.numpy(), jax_probe._shift_matrix())
    assert S.dtype == torch.float32 and (S.sum(0) == 1).all()


@pytest.mark.parametrize("variant", rp.VARIANTS)
def test_plain_versions_are_the_jax_kernels_bitwise(jax_probe, monkeypatch,
                                                    variant):
    """Each plain version against the JAX probe's kernel of the same name
    (``_k_slice``, ``_k_mxu``, ``_k_base``) through ``_call`` in interpret
    mode, on a seeded window over 3 blocks: bitwise, every block the same;
    the wrapper on a CPU tensor runs the plain version and counts no
    launch."""
    monkeypatch.setattr(jax_probe.pl, "pallas_call", functools.partial(
        jax_probe.pl.pallas_call, interpret=True))
    g = 3
    x = _window()
    kernel = {"slice": jax_probe._k_slice, "mma": jax_probe._k_mxu,
              "base": jax_probe._k_base}[variant]
    extra = (jnp.asarray(jax_probe._shift_matrix()),) if variant == "mma" else ()
    want = np.asarray(jax_probe._call(kernel, jnp.asarray(x), g, extra=extra))
    S = rp.shift_matrix()
    got = rp.plain(variant, torch.as_tensor(x), g, S).numpy()
    assert got.shape == (rp.R, rp.BLK * g) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    launches = (rp.probe_slice.launches, rp.probe_mma.launches,
                rp.probe_base.launches)
    np.testing.assert_array_equal(rp.probe(variant, torch.as_tensor(x), g, S)
                                  .numpy(), want)
    assert (rp.probe_slice.launches, rp.probe_mma.launches,
            rp.probe_base.launches) == launches
    blocks = got.reshape(rp.R, g, rp.BLK)
    assert (blocks == blocks[:, :1]).all()


def test_mma_is_slice_bitwise_and_the_variants_differ():
    """The product's views are the shifted views exactly, so ``mma`` is
    ``slice`` bitwise; ``base`` (no shift) is another function; a window
    of the wrong shape or type is refused."""
    x = torch.as_tensor(_window(1))
    S = rp.shift_matrix()
    a, b, c = (rp.plain(v, x, 2, S) for v in rp.VARIANTS)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="window"):
        rp._check(x[:, :-1], 2, None)
    with pytest.raises(ValueError, match="shift matrix"):
        rp._check(x, 2, S[:-1])


def test_library_yardstick_folds_to_the_mma_variant():
    """K8 mma's library time is one PyTorch call of its g products,
    ``tools/torch_rotation_probe.library_product`` (torch.matmul of x
    expanded to g windows with S): [g, R, 9 BLK], each product folded as
    the probe folds is the plain mma version's block, bitwise."""
    path = TOOL.parent / "torch_rotation_probe.py"
    spec = importlib.util.spec_from_file_location("torch_rotation_probe", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    g = 3
    x = torch.as_tensor(_window(2))
    S = rp.shift_matrix()
    y = tool.library_product(x, S, g)
    assert y.shape == (g, rp.R, 9 * rp.BLK) and y.dtype == torch.float32
    folded = torch.cat([rp._fold([y[b, :, o * rp.BLK:(o + 1) * rp.BLK]
                                  for o in range(len(rp.OFFS))])
                        for b in range(g)], dim=1)
    assert torch.equal(folded, rp.plain("mma", x, g, S))
