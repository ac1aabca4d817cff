"""The traced run's record: CUDA events at every chunk boundary, and a span
of a few chunks under ``torch.profiler`` (kept short: the profiler loses
device records late in a long process).

``Tracer.chunk(state)`` is called from the window's callback after every
chunk.  It records a CUDA event (no host synchronisation) and, at the
span's first and last chunk, synchronises, starts or stops the profiler
and reads the step counter.  ``record()`` reduces all of it to plain
numbers that the metric readers (``metrics/*.py``) read.
"""

from __future__ import annotations

import time

import numpy as np
import torch

# device kernels of the program's own libraries, by name
PASS_A_KERNELS = ("window_tv_kernel", "window_mech_kernel", "pass_a_3d_",
                  "pass_a_2d_rowloop_kernel")
MOVE_KERNELS = ("rebin_move_2d_kernel", "rebin_move_3d_kernel")
TOP = 10


class Tracer:
    """``first``: the chunk after which the span starts; ``chunks``: its
    length.  On a CPU device (the tests) the chunk marks are host clock
    readings and the profiler records host operations only."""

    def __init__(self, first: int, chunks: int, device):
        self.first, self.last = first, first + chunks
        self.cuda = torch.device(device).type == "cuda"
        self.events = []  # one CUDA event per chunk boundary
        self.host = []  # the host clock at each chunk boundary
        self.prof = None
        self.span = None  # (host s, step) at the span's ends
        self.kineto = None
        self.stretch = 0.0  # host seconds the span and its stop took

    @property
    def done(self) -> bool:
        return self.kineto is not None

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def chunk(self, index: int, state):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        else:
            ev = time.perf_counter()
        self.events.append(ev)
        self.host.append(time.perf_counter())
        if index == self.first:
            from torch.profiler import ProfilerActivity, profile

            self._sync()
            self.span = [(time.perf_counter(), int(state.step))]
            acts = [ProfilerActivity.CPU]
            if self.cuda:
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.start()
        elif index == self.last:
            self._sync()
            self.span.append((time.perf_counter(), int(state.step)))
            self.prof.stop()
            self.kineto = self.prof.profiler.kineto_results.events()
            self.stretch = time.perf_counter() - self.span[0][0]

    def record(self) -> dict:
        """The chunks' device ms outside the span, and the span's device
        events reduced: kernels by name, busy seconds, idle gaps by what the
        host was doing."""
        ms = [a.elapsed_time(b) if self.cuda else 1e3 * (b - a)
              for a, b in zip(self.events, self.events[1:])]
        host = np.diff(self.host)
        # ms[i] is chunk i + 2 (chunks count from 1); the span's chunks and
        # the one after it, which waits for the profiler to stop, are left out
        keep = [not self.first < i + 2 <= self.last + 1
                for i in range(len(ms))]
        rec = {"chunk_ms": [m for m, k in zip(ms, keep) if k]}
        if not self.done:
            return rec
        (t0, s0), (t1, s1) = self.span
        # the profiler stretches the host's side of the span many times
        # over, so the span's length is taken at the pace of the run's
        # other chunks (host clock); its device time is the trace's
        paced = [h for h, k in zip(host, keep) if k]
        length = ((self.last - self.first) * float(np.median(paced))
                  if paced else t1 - t0)
        dev, host = [], []
        for e in self.kineto:
            item = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            (dev if e.device_type() == torch.autograd.DeviceType.CUDA
             else host).append(item)
        dev.sort()
        by_name = {}
        for a, b, name in dev:
            name = short_name(name)
            by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-9
        # busy: the union of the device intervals; gaps between them
        busy, gaps, end = 0.0, [], None
        for a, b, _ in dev:
            if end is None or a > end:
                if end is not None:
                    gaps.append((end, a))
                busy += (b - a) * 1e-9
                end = b
            elif b > end:
                busy += (b - end) * 1e-9
                end = b
        rec.update(span_steps=s1 - s0, span_chunks=self.last - self.first,
                   window_s=length, profiled_s=t1 - t0, busy_s=busy,
                   device_events=len(dev),
                   kernel_s=by_name, idle_gaps=_name_gaps(gaps, host))
        return rec


def _name_gaps(gaps, host) -> dict:
    """Idle seconds summed by the innermost host operation running at the
    middle of each gap ("python" where none was)."""
    if not gaps:
        return {}
    host.sort()
    starts = np.array([a for a, _, _ in host], dtype=np.int64)
    out = {}
    for a, b in gaps:
        mid = (a + b) // 2
        name = "python"
        k = int(np.searchsorted(starts, mid, side="right")) - 1
        for j in range(k, max(k - 64, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        out[name] = out.get(name, 0.0) + (b - a) * 1e-9
    return out


def breakdown(rec: dict) -> dict:
    """The result line's ``breakdown``: the device operations that took
    most time and the longest idle gaps, each by name, in seconds."""
    top = lambda d: [[k, v] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"device_ops": top(rec.get("kernel_s", {})),
            "idle_gaps": top(rec.get("idle_gaps", {}))}


def short_name(name: str, limit: int = 160) -> str:
    """A device operation's name without its argument list, at most
    ``limit`` characters: kernels of one template stay apart."""
    name = name.replace("(anonymous namespace)::", "")
    depth = 0
    for k, ch in enumerate(name):
        depth += (ch in "<{") - (ch in ">}")
        if ch == "(" and depth == 0 and k > 0:
            name = name[:k]
            break
    return name.removeprefix("void ")[:limit]


def matches(name: str, kinds) -> bool:
    return any(k in name for k in kinds)
