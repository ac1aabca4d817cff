#!/usr/bin/env python3
"""The readings the comparison's limits are set from, for one cell at its
own size, on many seeds in one process (the build is made once).  Each
side stands in the program's place and is judged by ``run.compare``
against the float32 reference, as a run judges the program:

- sound: the program's set-up state and the judged chunk of its run;
- control: the reference with its pair pass computed in bfloat16, the
  precision below the configuration's float32 (state and sums stay
  float32).  It has to come out as not correct;
- one side per planted fault (``--faults``): the float32 reference with
  one pair term left out (``physics.DROPPABLE``).

The control and the faults start their chunk from the program's state
before the judged chunk, as the reference does.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--device cpu]
        [--faults transport_tensor,artificial_stress]

Prints one JSON line per seed and side, then for each side and compared
number the largest and the smallest reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import cell as cell_mod  # noqa: E402
from portbench import run  # noqa: E402


def readings(c, seeds, dev, faults=()) -> list:
    """[(seed, side, {number: reading})]: for each seed the sides "sound",
    "control" and one per fault in ``faults``."""
    from sph_bvf_tpu_torch.core.stepper import simulate
    from sph_bvf_tpu_torch.utils.thermo import StopSimulation

    base, params, spec = cell_mod.build_program(c, dev)
    n = int(base.n_valid)
    chunk = spec.rebin_every
    md = c.model(dev)
    others = [("control", c.model(dev, compute=torch.bfloat16))]
    others += [(f"fault:{f}", c.model(dev, drop=(f,))) for f in faults]
    flags = {"ptype": md.ptype, "solid_tag": md.solid, "fixed_tag": md.solid}
    out = []
    for seed in seeds:
        state, d = run.start(c, cell_mod.clone_state(base), params, spec,
                             seed, dev)
        snap0 = cell_mod.snapshot(state)
        win = run.Window(0.0, run.snap_chunk(seed), None, StopSimulation)
        win.t0 = time.perf_counter()
        simulate(state, params, spec, chunk * 10 ** 8, callback=win,
                 callback_every=chunk)
        del state
        prog_start, before, prog_after = run.program_sides(snap0, win, n)
        ref = run.reference(md, seed, d, before, chunk)
        out.append((seed, "sound", run.compare(md, ref, prog_start,
                                               params.mass, before,
                                               prog_after)))
        for side, m in others:
            s0, s1 = run.reference(m, seed, d, before, chunk)
            out.append((seed, side, run.compare(
                md, ref, (s0, flags, 0), m.mass, before,
                (s1,) + prog_after[1:])))
            del s0, s1
        del snap0, win, ref, prog_start, before, prog_after
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--faults", default="")
    a = ap.parse_args(argv)
    c = cell_mod.load(a.workload)
    seeds = [int(s) for s in a.seeds.split(",")]
    faults = [f for f in a.faults.split(",") if f]
    rows = readings(c, seeds, torch.device(a.device), faults)
    for seed, side, r in rows:
        print(json.dumps({"workload": a.workload, "seed": seed, "side": side,
                          **r}), flush=True)
    summary = {}
    for side in dict.fromkeys(s for _, s, _ in rows):
        got = [r for _, s, r in rows if s == side]
        summary[side] = {k: [min(r[k] for r in got), max(r[k] for r in got)]
                         for k in got[0]}
    print(json.dumps({"workload": a.workload, "seeds": len(seeds),
                      "min_max": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
