#!/usr/bin/env python3
"""Steady-state natural convection on the PyTorch port: the Nusselt number
at the heated cylinder, the counterpart of ``tools/nusselt.py`` with its
arguments.

    python3 tools/torch_nusselt.py --N 100 --Ra 1e4 --max-steps 300000

from the root of a checkout runs the scene twice on the card (K1 with the
species rows, K5 moving the C and Q rows): with buoyancy (convection) and
with the ``Buoyancy`` fix's acceleration set to 0 (conduction).  Each leg
steps until the windowed relative drift of the cylinder's heat output

    Qdot = -sum_{i in cylinder} m_i Q_i[0]

(``models/natural_convection.qdot``) falls below ``--tol`` over the last 5
checks, every ``--check-every`` steps, or until ``--max-steps``.  It prints
Qdot(t) rows and Nu = Qdot_conv / Qdot_cond, then one JSON line with both
legs (Qdot, steps, steady, wall seconds, launches of K1 and K5).
``--leg cond`` or ``--leg conv`` runs one leg alone (so that the two can
run as processes of their own), ``--device cpu`` the plain paths (small N
only).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sph_bvf_tpu_torch.core import rebin_cuda  # noqa: E402
from sph_bvf_tpu_torch.core.fixes import Buoyancy  # noqa: E402
from sph_bvf_tpu_torch.core.stepper import run_chunk, setup  # noqa: E402
from sph_bvf_tpu_torch.models import natural_convection  # noqa: E402
from sph_bvf_tpu_torch.models.natural_convection import qdot  # noqa: E402
from sph_bvf_tpu_torch.ops import pair_cuda  # noqa: E402

DT = 1e-4
KERNELS = (pair_cuda.pass_a_2d, rebin_cuda.rebin_move_2d)  # K1, K5


def run_to_steady(N, Ra, buoyancy, max_steps, check_every, tol, window=5,
                  device=None, log=print):
    """One leg on ``device`` (default: the card): (Qdot at the last check,
    steps run, whether the drift fell below ``tol``)."""
    device = torch.device("cuda" if device is None else device)
    state, params, spec, sc = natural_convection.build(N=N, Ra=Ra,
                                                       device=device)
    if not buoyancy:
        # conduction reference: same scene, buoyancy acceleration 0
        spec = dataclasses.replace(spec, fixes=tuple(
            dataclasses.replace(f, acceleration=0.0)
            if isinstance(f, Buoyancy) else f for f in spec.fixes))
    gb = sc.groupbit("sphere")
    state = setup(state, params, spec, dt=DT)
    label = "conv" if buoyancy else "cond"
    log(f"[{label}] N={N} Ra={Ra:g}: {int(state.n_valid)} particles on "
        f"{device}")
    hist = []
    t0 = time.time()
    done = 0
    while done < max_steps:
        target = min(done + check_every, max_steps)
        while done < target:
            n = min(spec.rebin_every, target - done)
            state = run_chunk(state, params, spec, n)
            done += n
        q = qdot(state, params, gb)
        hist.append(q)
        rate = done / max(time.time() - t0, 1e-9)
        log(f"[{label}] step {done} Qdot {q:.6e} ({rate:,.0f} steps/s)")
        assert int(state.overflow) == 0, f"overflow at step {done}"
        if len(hist) > window:
            w = np.asarray(hist[-window:])
            drift = (w.max() - w.min()) / max(abs(w.mean()), 1e-30)
            if drift < tol:
                log(f"[{label}] steady at step {done} (drift {drift:.2e})")
                return q, done, True
    return hist[-1], done, False


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--N", type=int, default=100)
    ap.add_argument("--Ra", type=float, default=1e4)
    ap.add_argument("--max-steps", type=int, default=300_000)
    ap.add_argument("--check-every", type=int, default=2_000)
    ap.add_argument("--tol", type=float, default=2e-3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--leg", choices=("both", "cond", "conv"), default="both",
                    help="run one leg alone (no Nu), e.g. one a process")
    args = ap.parse_args()

    def log(s):
        print(s, flush=True)

    legs = {}
    for name, buoyancy in (("cond", False), ("conv", True)):
        if args.leg not in ("both", name):
            continue
        t0 = time.perf_counter()
        before = [k.launches for k in KERNELS]
        q, steps, steady = run_to_steady(
            args.N, args.Ra, buoyancy, args.max_steps, args.check_every,
            args.tol, device=args.device, log=log)
        legs[name] = {"qdot": q, "steps": steps, "steady": steady,
                      "wall_s": time.perf_counter() - t0,
                      "launches": {k.__name__: k.launches - b
                                   for k, b in zip(KERNELS, before)}}
    nu = None
    if len(legs) == 2:
        nu = legs["conv"]["qdot"] / legs["cond"]["qdot"]
        print(f"N={args.N} Ra={args.Ra:g}: "
              f"Qdot_cond={legs['cond']['qdot']:.6e} "
              f"(steady={legs['cond']['steady']}) "
              f"Qdot_conv={legs['conv']['qdot']:.6e} "
              f"(steady={legs['conv']['steady']})")
        print(f"Nu = {nu:.4f}")
    print(json.dumps({"N": args.N, "Ra": args.Ra, "legs": legs, "Nu": nu}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
