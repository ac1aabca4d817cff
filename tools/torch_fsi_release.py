#!/usr/bin/env python3
"""The FSI release run on the PyTorch port: the counterpart of
``tools/fsi_release_ours.py``, with its arguments.

    python3 tools/torch_fsi_release.py [--steps 120000] [--every 10000]
        [--nx 30] [--tdamp-solid 2e4] [--out build/fsi_release_torch.npz]

from the root of a checkout runs the FSI channel (``fsi.build(nx,
tdamp_solid)``, dt 1e-8; K2 and K6) on the card: the beam is held until
step ``--tdamp-solid``, then free.  After every ``--every`` steps it writes
the snapshot to the npz (keys ``{step}_tag``, ``{step}_x``, ``{step}_v``,
as the JAX tool writes them, so a partial run still yields rows) and
prints the beam tip's x: the mean x of the beam particles (type 2) whose
step-0 y lies within 3e-6 of the beam's top, the observable
``tools/fsi_release_compare.py`` reads.  It ends with one JSON line: the
tip x by step, the overflow, the particles, the wall seconds, the
particle-steps/s and the launches of K2 and K6.  ``--device cpu`` runs the
plain paths (small nx only).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from sph_bvf_tpu_torch.core import rebin_cuda  # noqa: E402
from sph_bvf_tpu_torch.core.state import gather_particles  # noqa: E402
from sph_bvf_tpu_torch.core.stepper import run_chunk, setup  # noqa: E402
from sph_bvf_tpu_torch.models import fsi  # noqa: E402
from sph_bvf_tpu_torch.ops import pair_cuda  # noqa: E402

DT = 1e-8
BEAM = 1  # ptype of the beam: LAMMPS type 2
TIP_DEPTH = 3e-6  # the tip: beam particles this close to its top at step 0
# K2, K6
KERNELS = (pair_cuda.pass_a_2d_rowloop, rebin_cuda.rebin_move_2d_gated)


def run(nx: int = 30, steps: int = 120_000, every: int = 10_000,
        tdamp_solid: float = 2e4, out: str | None = None, device=None,
        log=print) -> dict:
    """The release run on ``device`` (default: the card); writes ``out``
    after every snapshot when given and returns the summary."""
    device = torch.device("cuda" if device is None else device)
    before = [k.launches for k in KERNELS]
    state, params, spec, _ = fsi.build(nx=nx, tdamp_solid=tdamp_solid,
                                       device=device)
    state = setup(state, params, spec, dt=DT)
    n0 = int(state.n_valid)
    log(f"backend={device.type} n={n0} steps={steps} every={every}")

    snaps, tip_x = {}, {}
    tip_tags = None

    def snap(s):
        nonlocal tip_tags
        g = gather_particles(state, spec.geom, fields=("x", "v", "ptype"))
        if tip_tags is None:
            beam = g["ptype"] == BEAM
            ytop = g["x"][beam, 1].max()
            tip_tags = g["tag"][beam & (g["x"][:, 1] > ytop - TIP_DEPTH)]
        tip_x[s] = float(g["x"][np.isin(g["tag"], tip_tags), 0].mean())
        snaps[f"{s}_tag"] = g["tag"]
        snaps[f"{s}_x"] = g["x"]
        snaps[f"{s}_v"] = g["v"]
        if out is not None:
            np.savez(out, **snaps)

    snap(0)
    t0 = time.time()
    done = 0
    chunk = spec.rebin_every
    while done < steps:
        target = min(done + every, steps)
        while done < target:
            n = min(chunk, target - done)
            state = run_chunk(state, params, spec, n)
            done += n
        assert int(state.overflow) == 0, f"overflow at step {done}"
        snap(done)
        rate = done / max(time.time() - t0, 1e-9)
        log(f"step {done} tip_x {tip_x[done]!r} (moved "
            f"{tip_x[done] - tip_x[0]:+.4e}) ({rate:,.0f} steps/s, eta "
            f"{(steps - done) / max(rate, 1e-9):,.0f}s)")
    wall = time.time() - t0
    return {"nx": nx, "steps": int(state.step), "tip_x": tip_x,
            "tip_particles": int(len(tip_tags)),
            "overflow": int(state.overflow),
            "drift": int(state.drift_violation),
            "particles": [n0, int(state.n_valid)],
            "finite": bool(all(np.isfinite(a).all() for a in snaps.values())),
            "wall_s": wall, "particle_steps_per_s": n0 * done / wall,
            "launches": {k.__name__: k.launches - b
                         for k, b in zip(KERNELS, before)},
            "cap": spec.geom.cap, "device": str(device)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=120_000)
    ap.add_argument("--every", type=int, default=10_000)
    ap.add_argument("--nx", type=int, default=30)
    ap.add_argument("--tdamp-solid", type=float, default=2e4)
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "fsi_release_torch.npz"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    res = run(args.nx, args.steps, args.every, args.tdamp_solid, args.out,
              args.device, log=lambda s: print(s, flush=True))
    print(f"done -> {args.out}")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
