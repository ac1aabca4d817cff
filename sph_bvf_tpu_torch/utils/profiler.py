"""Per-stage timing, the analog of the reference's Timer categories and
Finish::end (PyTorch).

Port of ``sph_bvf_tpu/utils/profiler.py``.  The reference stamps each
Verlet stage (PAIR/NEIGH/COMM/MODIFY/OUTPUT, timer.h:25-28) and prints a
breakdown at the end of the run (finish.cpp:64).  Here each stage is timed
apart, a profiling mode and not run-loop instrumentation: on the card with
CUDA events around ``repeats`` calls after a warm-up call, on the CPU with
``time.perf_counter``.
"""

from __future__ import annotations

import time

import torch

from sph_bvf_tpu_torch.core import fixes as fixes_mod
from sph_bvf_tpu_torch.core.integrate import final_integrate, initial_integrate
from sph_bvf_tpu_torch.core.state import rebin
from sph_bvf_tpu_torch.ops.pair import compute_forces

PAIR, NEIGH, MODIFY = ("PAIR(force kernels)", "NEIGH(rebin)",
                       "MODIFY(integrate+fixes)")


def _ms_per_call(fn, state, repeats: int) -> float:
    """ms per call of ``fn(state)``: CUDA events on a card, the host clock
    on the CPU, after one warm-up call."""
    fn(state)
    if state.x.is_cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(repeats):
            fn(state)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / repeats
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn(state)
    return (time.perf_counter() - t0) * 1e3 / repeats


def profile_step(state, params, spec, repeats: int = 20) -> dict:
    """Per-stage ms breakdown: PAIR (forces), NEIGH (rebin), MODIFY
    (integrate + fixes).  Returns {stage: ms per call}."""
    stages = {
        PAIR: lambda s: compute_forces(s, params, spec.geom, spec.pair),
        NEIGH: lambda s: rebin(s, spec.geom),
        MODIFY: lambda s: fixes_mod.apply_stage(
            final_integrate(initial_integrate(s, params, spec.integ), params,
                            spec.integ),
            params, spec.fixes, fixes_mod.POST_FORCE),
    }
    return {name: _ms_per_call(fn, state, repeats) for name, fn in stages.items()}


def print_breakdown(state, params, spec, repeats: int = 20, nsteps_hint=None):
    """Finish::end-style table; returns ``profile_step``'s dict."""
    ms = profile_step(state, params, spec, repeats)
    neigh_amort = ms[NEIGH] / max(spec.rebin_every, 1)
    total = ms[PAIR] + ms[MODIFY] + neigh_amort
    print(f"{'stage':<28s} {'ms/call':>9s} {'%step':>7s}")
    rows = [
        (PAIR, ms[PAIR], ms[PAIR]),
        ("NEIGH(rebin, amortized)", ms[NEIGH], neigh_amort),
        (MODIFY, ms[MODIFY], ms[MODIFY]),
    ]
    for name, per_call, per_step in rows:
        print(f"{name:<28s} {per_call:9.3f} {100.0 * per_step / total:6.1f}%")
    n = int(state.n_valid)
    where = "CUDA events" if state.x.is_cuda else "host clock"
    print(f"~{total:.3f} ms/step -> {n / total * 1e3 / 1e6:.2f}M particle-steps/s "
          f"({n} particles; {where})")
    return ms
