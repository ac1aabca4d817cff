"""K8, the window-rotation probe (``csrc/rotation_probe.cu``): its shapes,
its shift matrix, its launchers and their plain versions.

Port of ``tools/mxu_rotation_probe.py`` (the Pallas probe `_call` over
`_k_slice`, `_k_mxu` and `_k_base`).  It isolates the staging of the
pre-shifted pass A (K4): producing the 9 stencil-shifted [R, BLK] views of
one [R, W] window (W = BLK + 2 H) and folding them with distinct constants
``CS`` into one [R, BLK] block, g times over the same window:

- ``slice``: 9 shifted loads;
- ``mma``: one product ``x @ S`` with the 0/1 matrix ``shift_matrix`` on
  the tensor cores, then the fold over aligned 256-wide column blocks;
- ``base``: one aligned view folded 9 times, the floor.

Each fold runs ``acc = 0``, then ``acc = acc + c * view`` over ``OFFS`` in
order, the TPU kernels' order, each step a fused multiply-add rounded once
to f32: what XLA makes of the JAX probe's kernels, which the JAX package's
tests run on the CPU in interpret mode.  So the three plain versions here
are bitwise the JAX probe's kernels, and the CUDA kernels bitwise these.  On a
CUDA tensor each wrapper launches its kernel (and counts the launch); the
plain version runs only on a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from sph_bvf_tpu_torch import _build

# the cavity N=200 working shape: F=22 field rows x capk=16 slot rows,
# BLK=256 lanes, H=128 side halos, 9 offsets at flat shifts of the cavity's
# x-stride (70) and y-stride (1)
R, BLK, H = 22 * 16, 256, 128
W = BLK + 2 * H
S_STRIDE = 70
OFFS = tuple(dx * S_STRIDE + dy for dx in (-1, 0, 1) for dy in (-1, 0, 1))
CS = tuple(1.0 + 0.125 * i for i in range(9))  # distinct fold constants
BLOCKS = 19  # the grid of the JAX tool's default: the cavity N=200's blocks
VARIANTS = ("slice", "mma", "base")


def shift_matrix(device=None) -> torch.Tensor:
    """S, f32 [W, 9 BLK]: S[H + OFFS[o] + l, o BLK + l] = 1, else 0, so
    ``(x @ S)[:, o BLK:(o+1) BLK]`` is the view shifted by ``OFFS[o]``."""
    S = torch.zeros((W, 9 * BLK), dtype=torch.float32, device=device)
    lanes = torch.arange(BLK, device=device)
    for o, off in enumerate(OFFS):
        S[H + off + lanes, o * BLK + lanes] = 1.0
    return S


def _fold(views) -> torch.Tensor:
    """acc = fma(c, view, acc) over ``CS`` and ``views`` in order, from 0:
    each step in f64, where c * view is exact and so, for these operands,
    is the sum, then rounded once to f32."""
    acc = torch.zeros_like(views[0])
    for c, view in zip(CS, views):
        acc = (acc.double() + c * view.double()).float()
    return acc


def plain(variant: str, x: torch.Tensor, g: int, S: torch.Tensor = None):
    """The probe ``variant`` in PyTorch: out f32 [R, BLK g], each of the g
    blocks the fold of the same window ``x`` [R, W] (``S``: the shift
    matrix, read by ``mma``)."""
    if variant == "slice":
        block = _fold([x[:, H + off:H + off + BLK] for off in OFFS])
    elif variant == "mma":
        y = torch.matmul(x, S)
        block = _fold([y[:, o * BLK:(o + 1) * BLK] for o in range(len(OFFS))])
    elif variant == "base":
        block = _fold([x[:, H:H + BLK]] * len(CS))
    else:
        raise ValueError(f"unknown probe variant {variant!r}")
    return block.repeat(1, g)


def _check(x: torch.Tensor, g: int, S):
    if x.dtype != torch.float32 or tuple(x.shape) != (R, W) or not x.is_contiguous():
        raise ValueError(f"the probe takes a contiguous f32 [{R}, {W}] window, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if g < 1:
        raise ValueError(f"the probe needs at least one block, got g={g}")
    if S is not None and (S.dtype != torch.float32 or tuple(S.shape) != (W, 9 * BLK)
                          or not S.is_contiguous() or S.device != x.device):
        raise ValueError(f"the shift matrix must be a contiguous f32 "
                         f"[{W}, {9 * BLK}] on x's device")


def _launch(wrapper, variant: int, x: torch.Tensor, g: int, S=None):
    _check(x, g, S)
    out = torch.empty((R, BLK * g), dtype=torch.float32, device=x.device)
    lib = _build.load("rotation_probe")
    fn = lib.rotation_probe
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    code = fn(x.data_ptr(), None if S is None else S.data_ptr(), out.data_ptr(),
              variant, g, _build.current_stream(x.device))
    _build.check(lib, code, f"rotation_probe {wrapper.__name__}")
    wrapper.launches += 1
    return out


def probe_slice(x: torch.Tensor, g: int = BLOCKS) -> torch.Tensor:
    """K8's slice variant: the CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if not x.is_cuda:
        return plain("slice", x, g)
    return _launch(probe_slice, 0, x, g)


probe_slice.launches = 0  # K8 slice launches in this process


def probe_mma(x: torch.Tensor, S: torch.Tensor, g: int = BLOCKS) -> torch.Tensor:
    """K8's mma variant (``S`` from ``shift_matrix``): the CUDA kernel on a
    CUDA tensor, the plain version on a CPU tensor."""
    if not x.is_cuda:
        return plain("mma", x, g, S)
    return _launch(probe_mma, 1, x, g, S)


probe_mma.launches = 0  # K8 mma launches in this process


def probe_base(x: torch.Tensor, g: int = BLOCKS) -> torch.Tensor:
    """K8's base variant: the CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if not x.is_cuda:
        return plain("base", x, g)
    return _launch(probe_base, 2, x, g)


probe_base.launches = 0  # K8 base launches in this process


def probe(variant: str, x: torch.Tensor, g: int = BLOCKS, S=None) -> torch.Tensor:
    """The wrapper of ``variant`` ("slice", "mma" or "base") on ``x``."""
    if variant == "mma":
        return probe_mma(x, S, g)
    return {"slice": probe_slice, "base": probe_base}[variant](x, g)
