"""The port's span and counter recorder (``utils/profiler.py``) inside the
run loop: off, it records no step and leaves the run bitwise as it was;
on, it records the span tree of every step and the host readbacks; under
a ``torch.profiler`` session it names the stages in the trace as host
events and starts timing at the first chunk boundary after the session.
A small cavity on the CPU for a few chunks; no JAX.  The ``gpu`` test
checks on the card that no program event reaches the device timeline."""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import pytest
import torch

from sph_bvf_tpu_torch.api.lmp import parse_script
from sph_bvf_tpu_torch.core.stepper import setup, simulate
from sph_bvf_tpu_torch.models import lid_cavity
from sph_bvf_tpu_torch.ops import pair, pair_cuda
from sph_bvf_tpu_torch.utils import profiler

ROOT = Path(__file__).resolve().parent.parent
STEP_CHILDREN = {"integrate.initial": "step", "forces": "step",
                 "fixes.post_force": "step", "integrate.final": "step",
                 "pass_a.kernel": "forces", "rebin.move": "rebin"}
PROGRAM_SPANS = ("step", "integrate.initial", "integrate.final", "forces",
                 "pass_a.kernel", "rebin", "rebin.move", "fixes.post_force",
                 "callback", "check")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _recorder_off():
    profiler.disable()
    profiler.reset()
    yield
    profiler.disable()
    profiler.reset()


@pytest.fixture(scope="module")
def cavity():
    """The N=16 cavity (484 particles), set up, rebinning every 2 steps."""
    state, params, spec, _ = lid_cavity.build(N=16, device="cpu")
    spec = dataclasses.replace(spec, rebin_every=2)
    return setup(state, params, spec, dt=1e-4), params, spec


def _fields(state) -> dict:
    return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)
            if isinstance(getattr(state, f.name), torch.Tensor)}


def test_off_records_no_step_and_on_leaves_the_run_bitwise(cavity):
    state, params, spec = cavity
    off = simulate(state, params, spec, 4)
    rep = profiler.report()
    assert rep["spans"] == {}
    assert rep["counters"]["steps"] == 4 and rep["counters"]["chunks"] == 2
    profiler.enable()
    on = simulate(state, params, spec, 4)
    assert profiler.report()["spans"]["step"]["calls"] == 4
    a, b = _fields(off), _fields(on)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_on_records_the_span_tree_and_the_readbacks(cavity):
    state, params, spec = cavity
    profiler.enable()
    calls = []
    simulate(state, params, spec, 22, callback=calls.append)
    rep = profiler.report()
    spans, counters = rep["spans"], rep["counters"]
    assert len(calls) == 11
    assert spans["step"]["calls"] == counters["steps"] == 22
    assert spans["step"]["steps"] == 22 and spans["step"]["chunks"] == 11
    assert spans["rebin"]["calls"] == counters["chunks"] == 11
    assert spans["callback"]["calls"] == 11
    for name, parent in STEP_CHILDREN.items():
        assert spans[name]["parent"] == parent, name
        assert spans[name]["calls"] == spans[parent]["calls"], name
    for name in ("step", "rebin", "callback", "check"):
        assert spans[name]["parent"] is None
    # no stage without a fix, no SSA, no pass B on this cavity
    assert not {"fixes.post_integrate", "fixes.end_of_step", "reactions",
                "qd", "pass_b"} & set(spans)
    # the counters are read at chunk 10 and at the end, the periodic axis's
    # length is copied at every rebin; the CPU route reads no tail back
    assert {k: v for k, v in counters.items() if k.startswith("host_sync.")} \
        == {"host_sync.simulate.step0": 1, "host_sync.check.overflow": 1,
            "host_sync.check.drift": 1, "host_sync.final.overflow": 1,
            "host_sync.final.drift": 1, "host_sync.wrap_pbc": 11}
    assert spans["check"]["calls"] == 2
    for name, s in spans.items():
        assert 0.0 <= s["self_ms"] <= s["device_ms"] + 1e-9, name
        assert 0.0 <= s["wait_ms"] <= s["host_ms"], name
        # on the CPU the device ms are the host clock's
        assert s["device_ms"] == pytest.approx(s["host_ms"]), name
    kids = sum(spans[k]["device_ms"] for k, p in STEP_CHILDREN.items()
               if p == "step")
    assert spans["step"]["self_ms"] == pytest.approx(
        spans["step"]["device_ms"] - kids)


def test_counts_before_timing_are_not_reported(cavity):
    """``report`` gives the counts since the recorder was first on: the
    chunks run before it are left out."""
    state, params, spec = cavity
    state = simulate(state, params, spec, 4)
    profiler.enable()
    simulate(state, params, spec, 2)
    counters = profiler.report()["counters"]
    assert counters["steps"] == 2 and counters["chunks"] == 1
    assert counters["host_sync.simulate.step0"] == 1


def test_tail_readback_is_counted():
    valid = torch.zeros((4, 6), dtype=torch.bool)
    valid[:2, 1] = True
    tails, depth = pair_cuda.tail_index(valid)
    assert depth == 2
    assert profiler.report()["counters"] == {"host_sync.tail_depth": 1}


def test_a_read_inside_spans_is_charged_to_their_waits():
    """On, a ``sync`` read's host time goes to every open span's
    ``wait_ms``; off, it is only counted."""
    profiler.enable()
    with profiler.span("outer"):
        with profiler.span("inner"):
            with profiler.sync("site"):
                time.sleep(0.01)
        with profiler.sync("site"):
            pass
    spans = profiler.report()["spans"]
    assert spans["inner"]["wait_ms"] >= 10.0
    assert spans["outer"]["wait_ms"] >= spans["inner"]["wait_ms"]
    assert spans["outer"]["wait_ms"] <= spans["outer"]["host_ms"]
    profiler.disable()
    with profiler.sync("site"):
        pass
    assert profiler.report()["counters"]["host_sync.site"] == 3


class _Profile:
    """A callback that runs a ``torch.profiler`` session (host activity)
    from chunk ``first``'s callback to chunk ``last``'s."""

    def __init__(self, first: int, last: int):
        self.first, self.last, self.n = first, last, 0
        self.prof = self.events = None

    def __call__(self, state):
        from torch.profiler import ProfilerActivity, profile

        self.n += 1
        if self.n == self.first:
            self.prof = profile(activities=[ProfilerActivity.CPU])
            self.prof.start()
        elif self.n == self.last:
            self.prof.stop()
            self.events = self.prof.profiler.kineto_results.events()


def test_a_profiler_session_names_the_stages_then_arms_the_recorder(cavity):
    state, params, spec = cavity
    cb = _Profile(1, 2)
    simulate(state, params, spec, 8, callback=cb)
    # the session runs through chunk 2; chunks 3 and 4 are timed, and
    # the recorder is off again once the call returns
    spans, counters = (profiler.report()[k] for k in ("spans", "counters"))
    assert profiler._mode == profiler.OFF
    assert counters["steps"] == 4 and counters["chunks"] == 2
    assert spans["step"]["calls"] == 4 and spans["rebin"]["calls"] == 2
    now = time.time_ns()
    named = [e for e in cb.events if e.name() in PROGRAM_SPANS]
    assert {e.name() for e in named} >= {"step", "forces", "pass_a.kernel",
                                         "rebin", "rebin.move"}
    assert sum(e.name() == "step" for e in named) == 2
    for e in named:
        assert e.device_type() == torch.autograd.DeviceType.CPU
        assert not e.is_user_annotation()
        assert abs(e.start_ns() - now) < 1e9


def test_no_session_and_no_enable_records_nothing(cavity):
    state, params, spec = cavity
    simulate(state, params, spec, 4, callback=lambda s: None)
    assert profiler._mode == profiler.OFF
    assert profiler.report()["spans"] == {}


def test_ssa_stages_and_the_hop_mean_readback():
    """The SSA cavity's reactions and, behind a stand-in kernel (the plain
    pass without its inline draws), the Qd pass under ``forces``."""
    text = (ROOT / "examples" / "lid_cavity_ssa.lmp").read_text()
    state, params, spec = parse_script(text, {"N": 8}).build(device="cpu")
    spec = dataclasses.replace(spec, rebin_every=2)
    state = setup(state, params, spec, dt=1e-4)

    def kernel_stand_in(pf, params, geom, cfg, noise=None):
        acc = pair_cuda._plain(pf, params, geom, cfg, noise)
        del acc["Qd"]
        return acc

    route = pair_cuda.route
    pair_cuda.route = lambda geom, cfg: kernel_stand_in
    profiler.enable()
    try:
        simulate(state, params, spec, 2)
    finally:
        pair_cuda.route = route
    rep = profiler.report()
    spans, counters = rep["spans"], rep["counters"]
    assert spans["qd"]["parent"] == "forces" and spans["qd"]["calls"] == 2
    assert spans["reactions"]["parent"] == "step"
    assert spans["reactions"]["calls"] == 2
    assert counters["host_sync.final.mu_max"] == 1
    assert counters["host_sync.stoich_table"] == 2
    assert pair._pass_a_qd.calls >= 2


def test_setup_and_library_loads_are_timed_in_every_mode(monkeypatch,
                                                         cavity):
    """With the recorder off, ``setup`` and the library load its first
    pass A makes (a stand-in kernel that loads a stand-in library) are
    timed; its stages are not."""
    from sph_bvf_tpu_torch import _build

    state, params, spec = cavity
    monkeypatch.setattr(_build, "_load", lambda name: name)
    monkeypatch.setattr(_build, "_loaded", {})

    def kernel_stand_in(pf, params, geom, cfg, noise=None):
        assert _build.load("stand_in") == "stand_in"
        return pair_cuda._plain(pf, params, geom, cfg, noise)

    monkeypatch.setattr(pair_cuda, "route", lambda geom, cfg: kernel_stand_in)
    setup(state, params, spec, dt=1e-4)
    spans = profiler.report()["spans"]
    assert spans["setup"]["calls"] == 1 and spans["setup"]["host_ms"] > 0
    assert spans["load.stand_in"]["parent"] == "setup"
    assert spans["load.stand_in"]["calls"] == 1
    assert set(spans) == {"setup", "load.stand_in"}


@pytest.mark.gpu
def test_no_program_event_on_the_device_timeline():
    """Under a CUDA profiler session the recorder's stage names are host
    events only, and the device runs the same operations over the same
    chunk with the recorder off, in session mode and on."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from torch.profiler import ProfilerActivity, profile

    from sph_bvf_tpu_torch.core.stepper import run_chunk

    state, params, spec, _ = lid_cavity.build(N=100, device="cuda")
    state = setup(state, params, spec, dt=1e-4)
    run_chunk(state, params, spec, spec.rebin_every)
    torch.cuda.synchronize()
    counts = {}
    for mode in ("off", "session", "on"):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if mode == "session":
                profiler.chunk_boundary()
            elif mode == "on":
                profiler.enable()
            run_chunk(state, params, spec, spec.rebin_every)
            torch.cuda.synchronize()
        profiler.disable()
        events = prof.profiler.kineto_results.events()
        dev = [e for e in events
               if e.device_type() == torch.autograd.DeviceType.CUDA]
        assert not any(e.is_user_annotation() for e in dev), mode
        assert not any(e.name() in PROGRAM_SPANS for e in dev), mode
        host = {e.name() for e in events
                if e.device_type() == torch.autograd.DeviceType.CPU}
        assert ("step" in host) == (mode == "session"), mode
        counts[mode] = len(dev)
    assert counts["off"] == counts["session"] == counts["on"] > 0
