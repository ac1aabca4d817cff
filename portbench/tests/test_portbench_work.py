"""``work.py``'s counts and the reference's pair list against hand counts
on small lattices, and the tracer's reduction of a device trace."""

from __future__ import annotations

import itertools

import pytest
import torch

from portbench import trace, work
from portbench.reference import cavity, physics


def _brute_pairs(x, radius):
    d = x[:, None, :] - x[None, :, :]
    close = (d * d).sum(-1) < radius * radius
    return int(close.sum()) - x.shape[0]


@pytest.mark.parametrize("dim,side", [(2, 7), (3, 5)])
def test_pair_list_counts_a_lattice_by_hand(dim, side):
    """On a square lattice of spacing 1 and support 2.5 each inner site
    has 20 neighbours in 2D (the sites of |k| < 2.5) and 80 in 3D."""
    pts = torch.tensor(list(itertools.product(range(side), repeat=dim)),
                       dtype=torch.float64)
    x = torch.zeros((pts.shape[0], 3), dtype=torch.float64)
    x[:, :dim] = pts
    i, j = physics.pair_list(x, 2.5)
    assert len(i) == _brute_pairs(x, 2.5)
    inner = {2: 20, 3: 80}[dim]
    centre = (side // 2) * sum(side ** k for k in range(dim))
    assert int((i == centre).sum()) == inner
    assert bool((i != j).all())


def test_pass_a_and_move_bounds_by_hand():
    # 2D, filter step: in 3 x 2 + 3 + 1 = 10 rows, out 3 x 2 + 4 + 2 = 12
    assert work.pass_a_rows(2, True) == (10, 12)
    assert work.pass_a_rows(3, False) == (12, 13)
    t, by = work.pass_a_bound(1000, 0, 2, True)
    assert by == "bytes" and t == pytest.approx(4 * 1000 * 22 / 3.35e12)
    t, by = work.pass_a_bound(10, 20_000, 3, False)
    assert by == "operations"
    assert t == pytest.approx(20_000 * work.PAIR_FLOPS[3] / 67e12)
    assert work.move_rows(2, 1) == 16
    assert work.move_bound(100, 3, 0)[0] == pytest.approx(
        2 * 4 * 100 * 20 / 3.35e12)


def test_flagship_pairs_match_the_lattice_count():
    """The tiny cavity's pairs inside h = 2.5 dx: each inner fluid site
    has 20 on the unjittered lattice."""
    sc = cavity.build(2, 20)
    x = torch.as_tensor(sc.x)
    i, _ = physics.pair_list(x, sc.h * (1 - 1e-9))
    counts = torch.bincount(i, minlength=sc.n)
    mid = (abs(x[:, 0] - 0.525) < 1e-9) & (abs(x[:, 1] - 0.525) < 1e-9)
    assert int(counts[mid][0]) == 20


def test_tracer_reduction_of_a_synthetic_trace():
    class Ev:
        def __init__(self, a, b, name, dev):
            self.a, self.b, self._n, self.dev = a, b, name, dev

        def start_ns(self):
            return self.a

        def duration_ns(self):
            return self.b - self.a

        def name(self):
            return self._n

        def device_type(self):
            return (torch.autograd.DeviceType.CUDA if self.dev
                    else torch.autograd.DeviceType.CPU)

    t = trace.Tracer(1, 1, "cpu")
    t.events = [0.0, 1.0, 2.0, 3.0]
    t.host = [0.0, 2.0, 4.0, 5.5]
    t.span = [(0.0, 10), (1e-6, 20)]
    t.kineto = [Ev(0, 100, "window_tv_kernel", True),
                Ev(50, 150, "elementwise", True),
                Ev(300, 400, "rebin_move_2d_kernel", True),
                Ev(140, 320, "aten::item", False)]
    rec = t.record()
    assert rec["busy_s"] == pytest.approx(250e-9)
    assert rec["idle_gaps"] == {"aten::item": pytest.approx(150e-9)}
    assert rec["span_steps"] == 10 and rec["device_events"] == 3
    # chunk 2 is the span, chunk 3 waits for the profiler: chunk 4 is left
    assert rec["chunk_ms"] == [1000.0]
    assert rec["window_s"] == pytest.approx(1.5)
    bd = trace.breakdown(rec)
    assert bd["device_ops"][0][0] in ("window_tv_kernel", "elementwise")
    assert trace.short_name("void ns::k<a, (b)>(float const*, int)") == \
        "ns::k<a, (b)>"
    assert trace.short_name(
        "void (anonymous namespace)::pass_a_3d_tv_kernel<false, 0>(float*)"
    ) == "pass_a_3d_tv_kernel<false, 0>"
    assert trace.short_name("at::k<x::{lambda(int)#1}>(int)") == \
        "at::k<x::{lambda(int)#1}>"
