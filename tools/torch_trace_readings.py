#!/usr/bin/env python3
"""One benchmark run (``portbench/run.py``) with the program's span and
counter recorder (``utils/profiler.py``) read beside it.

    python3 tools/torch_trace_readings.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1> [--recorder on|off]

``--recorder on`` turns the recorder on (``profiler.enable()``) just before
the window's ``simulate`` call, so a ``--trace 0`` run measures what the
recorder costs when on against a run with it off (the default, as the
benchmark runs).  After the run's own result line it prints one JSON line,
``{"readings": ...}``: the recorder's spans as device and host ms a
recorded step (and self ms), its counters, the steps and chunks recorded,
and, in a traced run, how much of the chunks' device time (CUDA events at
the chunk boundaries, the chunks after the profiled span) the step's stage
spans and the rebin cover.  Run from the root of a checkout on a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path.cwd()
sys.path.insert(0, str(ROOT))

from portbench import run as bench_run  # noqa: E402
from portbench import trace  # noqa: E402

from sph_bvf_tpu_torch.core import stepper  # noqa: E402
from sph_bvf_tpu_torch.utils import profiler  # noqa: E402

STAGES = ("integrate.initial", "fixes.post_integrate", "forces",
          "fixes.post_force", "integrate.final", "reactions",
          "fixes.end_of_step")

seen = {}


def _patch(recorder_on: bool):
    simulate = stepper.simulate

    def window_simulate(*args, callback=None, **kw):
        if callback is not None and recorder_on:
            profiler.reset()
            profiler.enable()
        return simulate(*args, callback=callback, **kw)

    stepper.simulate = window_simulate
    record = trace.Tracer.record

    def kept_record(self):
        rec = record(self)
        seen.update(tracer=self, rec=rec)
        return rec

    trace.Tracer.record = kept_record


def readings() -> dict:
    rep = profiler.report()
    c = rep["counters"]
    steps, chunks = c.get("steps", 0), c.get("chunks", 0)
    out = {"steps": steps, "chunks": chunks, "counters": c}
    if not steps:
        return out
    out["spans"] = {name: {"device_ms_step": s["device_ms"] / steps,
                           "self_ms_step": s["self_ms"] / steps,
                           "host_ms_step": s["host_ms"] / steps,
                           "calls": s["calls"], "parent": s["parent"]}
                    for name, s in rep["spans"].items()}
    stage = sum(rep["spans"][n]["device_ms"] for n in STAGES
                if n in rep["spans"])
    rebin = rep["spans"].get("rebin", {}).get("device_ms", 0.0)
    out["stages_and_rebin_ms_chunk"] = (stage + rebin) / max(chunks, 1)
    tracer, rec = seen.get("tracer"), seen.get("rec")
    if tracer is not None and rec and rec.get("chunk_ms"):
        # chunk_ms keeps the chunks outside the span and the one after it;
        # its entries after the span are the chunks last + 2 onwards
        after = len(tracer.events) - tracer.last - 1
        ms = rec["chunk_ms"][-after:] if after > 0 else []
        if ms:
            out["chunk_ms_after_span"] = statistics.mean(ms)
            out["coverage"] = out["stages_and_rebin_ms_chunk"] / out[
                "chunk_ms_after_span"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--recorder", choices=("on", "off"), default="off")
    ap.add_argument("--root", default=None,
                    help="the checkout holding BENCHMARK.json (default: .)")
    ap.add_argument("--device", default=None,
                    help="cpu: the program's CPU path (default: the card)")
    args, rest = ap.parse_known_args()
    _patch(args.recorder == "on")
    rc = bench_run.run(rest, device=args.device,
                       root=Path(args.root) if args.root else ROOT)
    print(json.dumps({"readings": readings(), "recorder": args.recorder}),
          flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
