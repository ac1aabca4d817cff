"""Spans and counters inside the run loop, and the per-stage breakdown
built on them: the analog of the reference's Timer categories and
Finish::end (PyTorch).

The reference stamps each Verlet stage (PAIR/NEIGH/COMM/MODIFY/OUTPUT,
timer.h:25-28) and prints a breakdown at the end of the run
(finish.cpp:64).  Here the stepper, pass A, the rebin and the kernel
wrappers open a ``span`` at each stage boundary and advance a ``count`` at
each host readback; ``report`` sums what was recorded, and
``print_breakdown`` prints it as the reference's table.

One recorder per process, in one of three modes:

- **off** (the default): ``span`` returns one shared no-op context after
  one flag test; nothing is recorded per step.  No CUDA event is made and
  no device value is read.
- **on**: each span records its name, its parent span, the recorder's own
  step and chunk index (the ``steps`` and ``chunks`` counters the stepper
  advances), its host start and end (``time.time_ns``) and, when given a
  CUDA tensor, a CUDA event at each end on that device's current stream.
  The events come from a pool and are read without a synchronise: at chunk
  boundaries once ``query()`` reports them done, and at ``report()``.  On
  the CPU a span's device ms are its host ms.  A span that closes while a
  ``torch.profiler`` session runs is not kept.
- **session**: while a ``torch.profiler`` session is active a span only
  enters ``torch._C._profiler._RecordFunctionFast(name)``, which puts the
  stage's name into the profiler's trace as a host ``cpu_op`` on the device
  trace's clock.  It records nothing itself: the profiler stretches the
  host many times over.  (``torch.profiler.record_function`` is never
  used: its user annotation is projected onto the device timeline, where
  a trace reader would count it as a device operation, and it costs some
  7 us a call even with no profiler running.)

Two routes turn the recorder on: ``enable()``, which holds until
``disable()``, and a ``torch.profiler`` session seen by
``core.stepper.simulate``, which checks for one once a chunk, at the chunk
boundary.  A session puts the recorder in session mode; from the first
chunk boundary after the session ends the recorder is on, until that
``simulate`` call returns and the mode it started in comes back
(``scoped``).  So an operator who profiles part of a run, or a benchmark
that profiles a few chunks, gets the stage names in the profiler's trace
and the stages' times for the chunks after it, and the next ``simulate``
call runs with the recorder as it was.  What was recorded stays for
``report()``.

``once(name)`` spans run once a run (``setup`` and the library loads of
``_build.load``): they record host time in every mode.  ``count(site)``
always adds: it sits at sites that run once a chunk or rarer.
``sync(site)`` goes around each host synchronisation on the run path (a
device-to-host read, or a copy from pageable host memory to the card,
which also waits for the stream): it counts ``host_sync.<site>`` and, on,
charges the host time it waits to every open span (its ``wait_ms``), so a
span's host time net of its waits is the host's own work in it.
``report()`` gives each count since the recorder was first on after the
last ``reset()``, so a reader divides by the chunks it recorded and not by
the set-up's and warm-up's.

The spans (parents indented; ``PERF.md`` names what reads each)::

    setup                       core.stepper.setup (once a run)
      load.<library>            _build.load (once a library and process)
    step                        core.stepper.step
      integrate.initial
      fixes.post_integrate      (a stage with no fix has no span)
      forces                    ops.pair.compute_forces
        pass_a.kernel           the K1-K4 launch (the plain loop on the CPU)
        pass_b
        qd                      ops.pair._pass_a_qd
      fixes.post_force
      integrate.final
      reactions                 core.ssa.ssa_step
      fixes.end_of_step
    rebin                       core.state.rebin
      rebin.move                the K5-K7 wrapper
    callback                    simulate's callback
    check                       simulate's counter readback

and the counters: ``steps`` and ``chunks``, and ``host_sync.<site>``, one
per host synchronisation on the run path: ``tail_depth`` (a rebin's K1/K4
window), ``wrap_pbc`` (a rebin on a periodic axis), ``stoich_table`` (an
SSA step with reactions), ``check.overflow``, ``check.drift`` and
``check.mu_max`` (every 10 chunks), ``halted`` (a mesh's callback), and
the once-a-call reads
``simulate.step0`` and ``final.overflow``, ``final.drift``,
``final.mu_max`` (the check when the call ends).
"""

from __future__ import annotations

import collections
import functools
import time

import torch

OFF, SESSION, ON = 0, 1, 2
_mode = OFF
_began = False  # the recorder has been on since the last reset
_stack: list = []  # the open spans, innermost last
_pending: collections.deque = collections.deque()  # closed, not yet read
_pool: list = []  # CUDA events free for reuse
_spans: dict = {}  # name -> _Sum
_counts: dict = {}
_base: dict = {}  # the counts when the recorder was first on
_RESOLVE_AT = 4096  # pending spans read at a close past this many

_profiler_enabled = torch._C._autograd._profiler_enabled
_fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def _event():
    return _pool.pop() if _pool else torch.cuda.Event(enable_timing=True)


class _Span:
    """One recorded span (on mode, or a ``once`` span in any mode)."""

    __slots__ = ("name", "on", "keep", "parent", "step", "chunk", "t0", "t1",
                 "stream", "e0", "e1", "child_ms", "wait_ns")

    def __init__(self, name: str, on, keep: bool):
        self.name, self.on, self.keep = name, on, keep
        self.e0 = self.e1 = None
        self.child_ms = 0.0
        self.wait_ns = 0

    def __enter__(self):
        self.parent = _stack[-1] if _stack else None
        self.step = _counts.get("steps", 0)
        self.chunk = _counts.get("chunks", 0)
        _stack.append(self)
        on, self.on = self.on, None  # a record holds no tensor
        if on is not None and on.is_cuda:
            self.stream = torch.cuda.current_stream(on.device)
            self.e0 = _event()
            self.e0.record(self.stream)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.time_ns()
        if self.e0 is not None:
            self.e1 = _event()
            self.e1.record(self.stream)
        _stack.pop()
        if not self.keep and _profiler_enabled():
            _release(self)
        else:
            _pending.append(self)
            if len(_pending) > _RESOLVE_AT:
                _resolve(wait=False)
        return False


class _Wait:
    """One device-to-host read while on: its host time goes to the open
    spans' waits."""

    __slots__ = ("t0",)

    def __enter__(self):
        self.t0 = time.time_ns()

    def __exit__(self, *exc):
        dt = time.time_ns() - self.t0
        for rec in _stack:
            rec.wait_ns += dt
        return False


class _Sum:
    __slots__ = ("parent", "calls", "host_ms", "wait_ms", "device_ms",
                 "self_ms", "steps", "chunks", "last")

    def __init__(self, parent):
        self.parent = parent
        self.calls, self.steps, self.chunks = 0, 0, 0
        self.host_ms = self.wait_ms = self.device_ms = self.self_ms = 0.0
        self.last = (None, None)  # the (step, chunk) of the last call


def span(name: str, on: torch.Tensor = None):
    """A context around one stage.  ``on``: a tensor of the stage's device;
    on a CUDA one the span times the device with CUDA events on that
    device's current stream."""
    if not _mode:
        return _NULL
    if _mode == SESSION:
        return _fast(name) if _fast is not None else _NULL
    return _Span(name, on, False)


def once(name: str):
    """A span of something that runs once a run: records its host time in
    every mode."""
    return _Span(name, None, True)


def count(site: str, k: int = 1) -> None:
    """Add ``k`` to the counter ``site``."""
    _counts[site] = _counts.get(site, 0) + k


def sync(site: str):
    """A context around one host synchronisation: counts
    ``host_sync.<site>`` and, on, charges its wait to the open spans."""
    count("host_sync." + site)
    if _mode != ON or not _stack:
        return _NULL
    return _Wait()


def _start() -> None:
    global _mode, _began, _base
    _mode = ON
    if not _began:
        _began, _base = True, dict(_counts)


def enable() -> None:
    """Turn the recorder on."""
    if _mode != ON:
        _start()


def disable() -> None:
    """Turn the recorder off (a ``torch.profiler`` session seen at a chunk
    boundary turns it on again, for that ``simulate`` call)."""
    global _mode
    _mode = OFF


def scoped(run):
    """``run`` (``core.stepper.simulate``) with the recorder's mode as it
    was when the call began once it returns, whatever a session seen at
    its chunk boundaries set."""

    @functools.wraps(run)
    def call(*args, **kw):
        global _mode
        was = _mode
        try:
            return run(*args, **kw)
        finally:
            _mode = was

    return call


def reset() -> None:
    """Forget every span and count recorded (the mode stays)."""
    global _began, _base
    while _pending:
        _release(_pending.popleft())
    _spans.clear()
    _counts.clear()
    _began, _base = _mode == ON, {}


def chunk_boundary() -> None:
    """Called by ``simulate`` once a chunk: a ``torch.profiler`` session
    puts the recorder in session mode, and the first boundary after it
    ends turns the recorder on; the spans whose events are done are read."""
    global _mode
    if _profiler_enabled():
        _mode = SESSION
    elif _mode == SESSION:
        _start()
    if _pending:
        _resolve(wait=False)


def _release(rec: _Span) -> None:
    if rec.e0 is not None:
        _pool.extend((rec.e0, rec.e1))


def _resolve(wait: bool) -> None:
    """Read the pending spans in the order they closed (the order their end
    events were recorded on the stream): up to the first not done, or, with
    ``wait``, all of them."""
    while _pending:
        rec = _pending[0]
        if rec.e1 is not None:
            if not rec.e1.query():
                if not wait:
                    return
                rec.e1.synchronize()
            dev = rec.e0.elapsed_time(rec.e1)
            _release(rec)
        else:
            dev = (rec.t1 - rec.t0) * 1e-6
        _pending.popleft()
        s = _spans.get(rec.name)
        if s is None:
            s = _spans[rec.name] = _Sum(
                rec.parent.name if rec.parent is not None else None)
        s.calls += 1
        s.host_ms += (rec.t1 - rec.t0) * 1e-6
        s.wait_ms += rec.wait_ns * 1e-6
        s.device_ms += dev
        s.self_ms += dev - rec.child_ms
        s.steps += rec.step != s.last[0]
        s.chunks += rec.chunk != s.last[1]
        s.last = (rec.step, rec.chunk)
        if rec.parent is not None:
            rec.parent.child_ms += dev


def report() -> dict:
    """What was recorded, in plain numbers: ``spans``, per name, its
    ``parent``'s name, ``calls``, ``host_ms``, ``wait_ms`` (the host ms of
    it spent in device-to-host reads), ``device_ms``, ``self_ms`` (the
    device ms its child spans do not cover) and the ``steps`` and
    ``chunks`` it ran in; ``counters``, each count since the recorder was
    first on (since the reset, if it never was), ``steps`` and ``chunks``
    among them.  Waits for the spans still on the device."""
    _resolve(wait=True)
    spans = {name: {"parent": s.parent, "calls": s.calls,
                    "host_ms": s.host_ms, "wait_ms": s.wait_ms,
                    "device_ms": s.device_ms,
                    "self_ms": s.self_ms, "steps": s.steps,
                    "chunks": s.chunks}
             for name, s in _spans.items()}
    counters = {k: v - _base.get(k, 0) for k, v in _counts.items()}
    return {"spans": spans, "counters": counters}


def stage_ms(rep: dict, names) -> float:
    """Device ms of ``rep``'s spans named in ``names``, where a name that
    ends in a dot stands for every span under that prefix."""
    return sum(s["device_ms"] for name, s in rep["spans"].items()
               if any(name == n or (n.endswith(".") and name.startswith(n))
                      for n in names))


# -- the per-stage breakdown -------------------------------------------------

PAIR, NEIGH, MODIFY = ("PAIR(force kernels)", "NEIGH(rebin)",
                       "MODIFY(integrate+fixes)")
# the spans each stage sums
STAGES = {PAIR: ("forces",), NEIGH: ("rebin",),
          MODIFY: ("integrate.", "fixes.", "reactions")}


def profile_step(state, params, spec, repeats: int = 20) -> dict:
    """Per-stage ms from one real chunk (a rebin and ``repeats`` steps, after
    a warm-up chunk of one step that builds and loads what it launches)
    run with the recorder on: PAIR (``forces``, ms a step), NEIGH
    (``rebin``, ms a rebin) and MODIFY (``integrate.*``, ``fixes.*`` and
    ``reactions``, ms a step); CUDA events on a card, the host clock on the
    CPU.  What the recorder held is reset and its mode is restored.
    Returns {stage: ms}."""
    return _profile(state, params, spec, repeats)[0]


def _profile(state, params, spec, repeats: int) -> tuple:
    from sph_bvf_tpu_torch.core.stepper import run_chunk

    was = _mode
    run_chunk(state, params, spec, 1)
    reset()
    enable()
    try:
        run_chunk(state, params, spec, repeats)
        rep = report()
    finally:
        if was != ON:
            disable()
        reset()
    per = {PAIR: repeats, NEIGH: 1, MODIFY: repeats}
    ms = {stage: stage_ms(rep, STAGES[stage]) / per[stage] for stage in STAGES}
    return ms, rep


def _tree(rep: dict, parent=None, depth: int = 0):
    """(depth, name, span) of ``rep``'s spans under ``parent``, depth first."""
    for name, s in rep["spans"].items():
        if s["parent"] == parent:
            yield depth, name, s
            yield from _tree(rep, name, depth + 1)


def print_breakdown(state, params, spec, repeats: int = 20, nsteps_hint=None):
    """Finish::end-style table from ``profile_step``'s chunk, then every
    span of the chunk (device ms a step, and the part no child span
    covers); returns ``profile_step``'s dict."""
    ms, rep = _profile(state, params, spec, repeats)
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
    print(f"{'span':<28s} {'ms/step':>9s} {'self':>9s} {'calls':>6s}")
    for depth, name, s in _tree(rep):
        label = "  " * depth + name
        print(f"{label:<28s} {s['device_ms'] / repeats:9.3f} "
              f"{s['self_ms'] / repeats:9.3f} {s['calls']:6d}")
    return ms
