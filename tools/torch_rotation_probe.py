#!/usr/bin/env python3
"""K8, the window-rotation probe, on one CUDA card: the three ways to stage
the 9 stencil-shifted views of a window (``ops/rotation_probe.py``), the
PyTorch counterpart of ``tools/mxu_rotation_probe.py``.

    python3 tools/torch_rotation_probe.py [--blocks 19] [--repeats 200]

from the root of a checkout.  On a seeded window x (f32 [352, 512], numpy
seed 0) it first checks that ``mma`` (the shifts as a product with the 0/1
shift matrix on the tensor cores, in three TF32 parts) is bitwise
``slice`` (9 shifted loads), then times each variant (``slice``, ``mma``,
``base``: one aligned view, the floor) and ``library_product`` at f32
with TF32 off, the one PyTorch call that computes ``mma``'s ``blocks``
products (``torch.matmul(x.expand(blocks, R, W), S)``; the mma kernel
computes one product per output block): the least of 7 runs of
``repeats`` launches each, by CUDA events, after a warm-up.  It prints
one JSON line per step, as the JAX tool does, and a summary with the
rotation's cost (slice - base) and the product's (mma - base).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

from sph_bvf_tpu_torch.ops import rotation_probe as rp  # noqa: E402


def time_ms(fn, repeats: int = 200, outer: int = 7):
    """(least ms per call, spread of the median over it) over ``outer`` runs
    of ``repeats`` calls of ``fn``, by CUDA events, after two warm-up
    calls."""
    fn()
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(outer):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(repeats):
            fn()
        e1.record()
        torch.cuda.synchronize()
        ts.append(e0.elapsed_time(e1) / repeats)
    ts.sort()
    return ts[0], (ts[len(ts) // 2] - ts[0]) / max(ts[0], 1e-12)


def window(device, seed: int = 0) -> torch.Tensor:
    """The probe's window: f32 [R, W] standard normals from numpy."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal((rp.R, rp.W)).astype(np.float32),
                           device=device)


def library_product(x: torch.Tensor, S: torch.Tensor, g: int) -> torch.Tensor:
    """The ``g`` products x @ S that the mma kernel computes, one per output
    block, in one PyTorch call: f32 [g, R, 9 BLK].  A yardstick only; the
    port never calls it."""
    return torch.matmul(x.expand(g, rp.R, rp.W), S)


def run(blocks: int = rp.BLOCKS, repeats: int = 200, device=None) -> dict:
    """The probe on ``device`` (default: the card): prints its JSON lines
    and returns the summary."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        raise RuntimeError("the probe times CUDA kernels: it needs a card")
    torch.backends.cuda.matmul.allow_tf32 = False  # the reference product
    x, S = window(device), rp.shift_matrix(device)
    a = rp.probe_slice(x, blocks)
    b = rp.probe_mma(x, S, blocks)
    exact = {"mma_bit_identical": bool(torch.equal(a, b)),
             "max_abs_diff": float((a - b).abs().max())}
    print(json.dumps(exact), flush=True)
    out = {"R": rp.R, "W": rp.W, "BLK": rp.BLK, "blocks": blocks,
           "device": torch.cuda.get_device_name(device), **exact}
    calls = {"slice": lambda: rp.probe_slice(x, blocks),
             "mma": lambda: rp.probe_mma(x, S, blocks),
             "base": lambda: rp.probe_base(x, blocks),
             "matmul": lambda: library_product(x, S, blocks)}
    for name, fn in calls.items():
        ms, spread = time_ms(fn, repeats)
        out[f"{name}_ms"] = ms
        print(json.dumps({f"{name}_ms": ms, "spread": spread}), flush=True)
    out["rotation_cost_ms"] = out["slice_ms"] - out["base_ms"]
    out["mma_cost_ms"] = out["mma_ms"] - out["base_ms"]
    out["mma_vs_slice"] = out["mma_cost_ms"] / max(out["rotation_cost_ms"], 1e-9)
    print(json.dumps(out), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks", type=int, default=rp.BLOCKS,
                    help="grid length (cavity N=200 has 19 blocks)")
    ap.add_argument("--repeats", type=int, default=200)
    args = ap.parse_args()
    run(args.blocks, args.repeats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
