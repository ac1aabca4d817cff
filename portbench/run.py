#!/usr/bin/env python3
"""The benchmark of the PyTorch + CUDA port (``sph_bvf_tpu_torch``): one
cell, one run, one fresh process on one card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The run builds the cell's scene through the program, moves the fluid by
the seed's jitter, sets up, warms two chunks up on a copy, then makes one
call of ``core.stepper.simulate`` whose callback ends it after ``--seconds``
(``utils.thermo.StopSimulation``, the ``fix halt`` route).  It prints the
end-to-end metrics (``--trace 0``) or the per-layer ones (``--trace 1``)
in one JSON line, last on standard output, after it has judged two
snapshots taken inside the window against the plain reference
(``reference/``).  No card, no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# every build and kernel cache at a fixed path inside the checkout (the
# port's own nvcc builds go to build/sph_bvf_tpu_torch/, also inside)
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = str(ROOT / "build" / "portbench" / _sub)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import cell as cell_mod  # noqa: E402
from portbench import inputs, trace  # noqa: E402
from portbench.reference import judge, physics  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "sph_bvf_tpu"}
SNAP_CHUNKS = (1, 2)  # the judged chunk is chunk k -> k + 1, k drawn from these
PROFILE_AFTER = 4  # a traced run's profiled span starts after this chunk
COUNTERS = {"pass_a": ("sph_bvf_tpu_torch.ops.pair_cuda",
                       ("pass_a_2d", "pass_a_2d_preshift", "pass_a_2d_rowloop",
                        "pass_a_3d")),
            "move": ("sph_bvf_tpu_torch.core.rebin_cuda",
                     ("rebin_move_2d", "rebin_move_2d_gated",
                      "rebin_move_3d"))}


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _counters(reset: bool = False) -> dict:
    out = {}
    for mod_name, names in COUNTERS.values():
        mod = importlib.import_module(mod_name)
        for n in names:
            if reset:
                getattr(mod, n).launches = 0
            out[n] = getattr(mod, n).launches
    return out


class Window:
    """The callback of the window's ``simulate``: counts chunks, takes the
    two snapshots the judge compares, drives the tracer, and ends the run
    once ``seconds`` have passed and all of that is done.  A traced run's
    profiled span does not count against the seconds: the rest of its
    window is as long as an untraced run's."""

    def __init__(self, seconds: float, snap: int, tracer, stop_exc):
        self.seconds, self.snap, self.tracer = seconds, snap, tracer
        self.stop_exc = stop_exc
        self.chunks, self.snaps, self.t0 = 0, {}, None
        self.marks = []  # the host clock at each chunk boundary
        self.need = max(snap + 1, tracer.last if tracer else 0)

    def __call__(self, state):
        self.marks.append(time.perf_counter())
        self.chunks += 1
        if self.chunks in (self.snap, self.snap + 1):
            self.snaps[self.chunks] = cell_mod.snapshot(state)
        if self.tracer is not None:
            self.tracer.chunk(self.chunks, state)
        spent = time.perf_counter() - self.t0
        if self.tracer is not None:
            spent -= self.tracer.stretch
        if self.chunks >= self.need and spent >= self.seconds:
            raise self.stop_exc("window closed")


def _smi(query: str) -> str:
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run(argv=None, device=None, root=ROOT) -> int:
    """One run.  ``device``: None for the card (the benchmark); the tests
    pass "cpu" to drive the same run on the port's CPU path.  ``root``: the
    checkout holding ``BENCHMARK.json`` and ``portbench/``."""
    a = _args(argv)
    c = cell_mod.load(a.workload, root)
    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < c.chips):
            print(f"portbench: the cell needs {c.chips} CUDA card(s); "
                  f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
            return 2
        device = "cuda"
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    from sph_bvf_tpu_torch.core.stepper import simulate
    from sph_bvf_tpu_torch.utils.thermo import StopSimulation

    cfg, spec_c = c.config, c.spec
    t0 = time.perf_counter()
    state, params, spec = cell_mod.build_program(c, dev)
    sync()
    scene_build_s = time.perf_counter() - t0
    built = (int(state.n_valid), spec.geom.ncells_total, spec.geom.cap)
    want = (cfg["particles"], cfg["cells"], cfg["cap"])
    if built != want:
        print(f"portbench: the build gives (particles, cells, cap) {built}, "
              f"the configuration states {want}", file=sys.stderr)
        return 1
    n = built[0]
    state, d = start(c, state, params, spec, a.seed, dev)
    chunk = spec.rebin_every
    simulate(cell_mod.clone_state(state), params, spec, 2 * chunk)
    snap0 = cell_mod.snapshot(state)
    mass_prog = params.mass.clone()
    tracer = (trace.Tracer(PROFILE_AFTER, spec_c["profile_chunks"], dev)
              if a.trace else None)
    win = Window(a.seconds, snap_chunk(a.seed), tracer, StopSimulation)
    _counters(reset=True)
    step0 = int(state.step)
    sync()
    win.t0 = t_window = time.perf_counter()
    setup_s = t_window - T_START
    failure = None
    try:
        state = simulate(state, params, spec, chunk * 10 ** 8, callback=win,
                         callback_every=chunk)
    except RuntimeError as e:  # the simulator's own gates
        failure = str(e)
    sync()
    window_s = time.perf_counter() - t_window
    steps = int(state.step) - step0
    n_species = int(state.Cd.shape[0])
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    launches = _counters()
    lost = judge.tags(state.tag, state.valid, n)[2]
    rec = tracer.record() if tracer else {}
    del state
    if cuda:
        torch.cuda.empty_cache()

    # ---- judge: the plain reference after the window ---------------------
    checks, pairs = {}, None
    if failure is None and win.snap + 1 in win.snaps:
        md = c.model(dev)
        prog_start, before, prog_after = program_sides(snap0, win, n)
        ref = reference(md, a.seed, d, before, chunk)
        checks = compare(md, ref, prog_start, mass_prog, before, prog_after)
        if a.trace and rec.get("span_steps"):
            pairs = len(physics.pair_list(prog_after[0].x, md.sc.h)[0])
        del md, ref, prog_start, before, prog_after
    checks["lost"] = lost if failure is None else n
    if cuda:
        expect = spec_c["kernels"]
        route = 0
        for role, (_, names) in COUNTERS.items():
            for name in names:
                due = ({"pass_a": steps, "move": steps // chunk}[role]
                       if name == expect[role] else 0)
                route += abs(launches[name] - due)
        checks["route"] = route
    limits = spec_c["limits"]
    over = [k for k, v in checks.items() if not v <= limits[k]]
    correct = failure is None and not over

    # ---- metrics -------------------------------------------------------------
    if a.trace:
        rec.update(scene_build_s=scene_build_s, n_valid=n, dim=c.dim,
                   n_species=n_species, pairs=pairs,
                   span_filter_steps=_filter_steps(rec, cfg, win, chunk,
                                                   step0))
        metrics = {}
        for m in c.per_layer:
            v = c.metric_reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {"particle_steps_per_s": n * steps / window_s,
                  "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in c.end_to_end}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": c.chips, "memory_peak_bytes": memory_peak}
    if cuda:
        device_info["power_limit"] = _smi("power.limit")
    if a.trace:
        device_info.update(busy_s=rec.get("busy_s", 0.0),
                           window_s=rec.get("window_s", window_s))

    loaded = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if loaded:
        print(f"portbench: modules loaded that the benchmark may not load: "
              f"{loaded}", file=sys.stderr)
        return 3
    if failure:
        print(f"portbench: the window failed: {failure}", file=sys.stderr)
    print(f"portbench: {c.name} seed {a.seed}: {steps} steps in "
          f"{window_s:.3f} s, {win.chunks} chunks, set-up {setup_s:.3f} s, "
          f"{device_info['kind']} {device_info.get('power_limit', '')}",
          file=sys.stderr)
    if len(win.marks) > 4:
        q = statistics.quantiles(1e3 * np.diff(win.marks), n=20)
        print(f"portbench: host ms a chunk: p5 {q[0]:.3f} median {q[9]:.3f} "
              f"p95 {q[18]:.3f}", file=sys.stderr)
    for k, v in checks.items():
        print(f"check {k} {v!r} limit {limits[k]!r} "
              f"{'ok' if v <= limits[k] else 'FAIL'}", file=sys.stderr)
    line = {"correct": correct, "attempted": win.chunks,
            "failed": 0 if correct else 1, "metrics": metrics,
            "device": device_info}
    if a.trace:
        line["breakdown"] = trace.breakdown(rec)
    line["checks"] = {k: {"value": v, "limit": limits[k]}
                      for k, v in checks.items()}
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0


def _filter_steps(rec, cfg, win, chunk, step0) -> int:
    """Shepard-filter steps inside the profiled span."""
    if not rec.get("span_steps"):
        return 0
    first = step0 + chunk * win.tracer.first + 1
    return sum(1 for s in range(first, first + rec["span_steps"])
               if s % cfg["freq_filter"] == 0)


def snap_chunk(seed: int) -> int:
    """k of the judged chunk k -> k + 1, drawn from ``SNAP_CHUNKS``."""
    lo, hi = SNAP_CHUNKS
    return lo + seed % (hi - lo + 1)


def start(c, state, params, spec, seed: int, dev):
    """A built program state with the seed's inputs (the fluid's jitter,
    the counter RNG's key), set up: (the state, the jitter)."""
    from sph_bvf_tpu_torch.core.stepper import setup

    d = inputs.jitter(seed, int(state.n_valid), c.dim,
                      c.reference.spacing(c.config), dev)
    state = cell_mod.apply_inputs(state, d, inputs.key_words(seed, dev))
    return setup(state, params, spec, dt=c.config["dt"]), d


def program_sides(snap0: dict, win: Window, n: int):
    """The program's outputs, per tag: (its set-up state with its flags and
    bad tags, its state before the judged chunk, its state after it with
    each tag's cell and the bad tags)."""
    prog0, _, flags, bad0 = judge.per_tag(snap0, n)
    before = judge.per_tag(win.snaps[win.snap], n)[0]
    after, cells, _, bad = judge.per_tag(win.snaps[win.snap + 1], n)
    return (prog0, flags, bad0), before, (after, cells, bad)


def reference(md, seed: int, d, before, steps: int) -> tuple:
    """The reference's own set-up state, built and jittered from the same
    inputs, and its chunk of ``steps`` steps from ``before``."""
    return md.setup(md.initial(d), seed), md.chunk(before, steps, seed)


def compare(md, ref: tuple, side_start: tuple, mass, before,
            side_after: tuple) -> dict:
    """The compared numbers of whatever stands in the program's place:
    ``side_start`` its set-up state (Particles, flags, bad tags) and
    ``mass`` its masses, ``side_after`` its chunk from ``before``
    (Particles, each tag's cell, bad tags), against ``reference``'s
    ``ref``."""
    out = judge.start(*side_start, mass, ref[0], md)
    out.update(judge.chunk(before, *side_after, ref[1], md))
    return out


if __name__ == "__main__":
    sys.exit(run())
