#!/usr/bin/env python3
"""Steady-state lid cavity vs Ghia, Ghia & Shin (1982) on the PyTorch port:
the counterpart of ``tools/ghia_benchmark.py``, with its environment
variables and its output.

    GHIA_STEPS=250000 GHIA_N=100 GHIA_RE=100 python3 tools/torch_ghia_benchmark.py

from the root of a checkout runs the cavity (``lid_cavity.build(N, Re,
rebin_every=10)``, ``setup``, then ``run_chunk(..., 10)``) on the card,
through K1 and K5, in blocks of 25,000 steps (the last one shorter when
``GHIA_STEPS`` is not a multiple), printing steps, wall and overflow after
each block and, every ``GHIA_PROFILE_EVERY`` steps, the u-velocity along
the vertical centerline against Ghia's Table I.  It ends with one JSON
line: the last profile, its max|u - Ghia|, the overflow and drift counts,
the particles at the start and the end, the wall seconds, the
particle-steps/s and the launches of K1 and K5.  ``--device cpu`` runs the
plain paths (small N only).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sph_bvf_tpu_torch.core import rebin_cuda  # noqa: E402
from sph_bvf_tpu_torch.core.state import gather_particles  # noqa: E402
from sph_bvf_tpu_torch.core.stepper import run_chunk, setup  # noqa: E402
from sph_bvf_tpu_torch.models import lid_cavity  # noqa: E402
from sph_bvf_tpu_torch.ops import pair_cuda  # noqa: E402

# Ghia, Ghia & Shin (1982), Table I: u through the vertical centerline.
ys = np.array([0.9766, 0.8516, 0.7344, 0.5000, 0.2813, 0.1016, 0.0547])
GHIA_U = {
    100: [0.84123, 0.23151, 0.00332, -0.20581, -0.15662, -0.06434, -0.03717],
    1000: [0.65928, 0.33304, 0.18719, -0.06080, -0.27805, -0.29730, -0.18109],
}
# dt per the reference's own example scripts (1e-4 at Re100, 8e-5 at Re1000)
DT = {100: 1e-4, 1000: 8e-5}
BLOCK = 25_000  # steps between progress lines
CHUNK = 10  # steps between rebins
KERNELS = (pair_cuda.pass_a_2d, rebin_cuda.rebin_move_2d)  # K1, K5


def profile(x, v, solid_tag, N: int) -> np.ndarray:
    """The seven u values at (0.5, y) for ``ys``: the fluid's v_x under a
    Gaussian weight of width 1.5 dx, from gathered [n, 3] ``x`` and ``v``
    and [n] ``solid_tag`` (``core/state.gather_particles``)."""
    fl = solid_tag == 0
    x, v = x[fl], v[fl]
    dx = 1.0 / N
    u = []
    for y in ys:
        r2 = (x[:, 0] - 0.5) ** 2 + (x[:, 1] - y) ** 2
        w = np.exp(-(r2 / (1.5 * dx) ** 2))
        u.append((w * v[:, 0]).sum() / w.sum())
    return np.array(u)


def state_profile(state, geom, N: int) -> np.ndarray:
    out = gather_particles(state, geom, fields=("x", "v", "solid_tag"))
    return profile(out["x"], out["v"], out["solid_tag"], N)


def run(N: int = 100, Re: int = 100, steps: int = 250_000,
        profile_every: int = 250_000, device=None, log=print) -> dict:
    """The cavity for ``steps`` steps on ``device`` (default: the card),
    logging as ``tools/ghia_benchmark.py`` prints; returns the summary."""
    device = torch.device("cuda" if device is None else device)
    before = [k.launches for k in KERNELS]
    ghia = np.array(GHIA_U[Re])
    state, params, spec, _ = lid_cavity.build(N=N, Re=float(Re),
                                              rebin_every=CHUNK, device=device)
    state = setup(state, params, spec, dt=DT[Re])
    n0 = int(state.n_valid)
    t0 = time.perf_counter()
    done = 0
    u = None
    while done < steps:
        block = min(BLOCK, steps - done)
        for k in range(0, block, CHUNK):
            state = run_chunk(state, params, spec, min(CHUNK, block - k))
        done += block
        _ = float(torch.sum(state.rho))
        log(f"steps={int(state.step)} wall={time.perf_counter() - t0:.0f}s "
            f"overflow={int(state.overflow)}")
        if done % profile_every == 0:
            u = state_profile(state, spec.geom, N)
            for y, ui, g in zip(ys, u, ghia):
                log(f"y={y:.4f}  u_ours={ui:+.5f}  u_ghia={g:+.5f}  "
                    f"diff={ui - g:+.4f}")
            log(f"steps={int(state.step)}: max|diff| = "
                f"{np.abs(u - ghia).max():.4f} of U0=1")
    wall = time.perf_counter() - t0
    if u is None or done % profile_every:
        u = state_profile(state, spec.geom, N)
    return {"N": N, "Re": Re, "steps": int(state.step),
            "u": [float(a) for a in u], "u_ghia": ghia.tolist(),
            "max_diff": float(np.abs(u - ghia).max()),
            "overflow": int(state.overflow),
            "drift": int(state.drift_violation),
            "particles": [n0, int(state.n_valid)], "wall_s": wall,
            "particle_steps_per_s": n0 * done / wall,
            "launches": {k.__name__: k.launches - b
                         for k, b in zip(KERNELS, before)},
            "device": str(device)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    env = os.environ.get
    out = run(N=int(env("GHIA_N", "100")), Re=int(env("GHIA_RE", "100")),
              steps=int(env("GHIA_STEPS", "250000")),
              profile_every=int(env("GHIA_PROFILE_EVERY", "250000")),
              device=args.device, log=lambda s: print(s, flush=True))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
