"""Whole runs of the harness at CPU sizes (``tiny``): the port's plain CPU
path against the reference, the result line, the modules a run loads, the
control and planted faults, which must come out as not correct.  The
``gpu`` test runs one cell on the card."""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import cell as cell_mod
from portbench import control, run
from portbench.reference import physics
from portbench.tests import tiny

CELLS = ("cavity2d-re100-n2000", "cavity2d-ssa-n1000", "cavity3d-re100-n100")
SEED = 2 ** 31 + 7


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny.make(tmp_path_factory.mktemp("tiny"))


def _run(root, capsys, cell, trace=0, seed=SEED):
    rc = run.run(["--workload", cell, "--seed", str(seed), "--seconds", "0.5",
                  "--trace", str(trace)], device="cpu", root=root)
    out = capsys.readouterr().out
    assert rc == 0
    return tiny.last_line(out)


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_port_cpu_path(root, capsys, cell):
    line = _run(root, capsys, cell)
    assert line["correct"], line["checks"]
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["metrics"]) == {"particle_steps_per_s", "setup_s"}
    for m in line["metrics"].values():
        assert m["value"] > 0


def test_traced_line_has_the_breakdown(root, capsys):
    line = _run(root, capsys, CELLS[0], trace=1)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(line["device"])
    # on the CPU no device metric is read: only the host clock's
    assert set(line["metrics"]) == {"scene_build_s"}


def _stepper():
    from sph_bvf_tpu_torch.core import stepper

    return stepper


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(_stepper(), "step", lambda state, params, spec: state)


def _half_left_out(monkeypatch):
    st = _stepper()
    forces = st.compute_forces

    def half(state, params, geom, cfg, mesh=None):
        out = forces(state, params, geom, cfg, mesh)
        keep = torch.arange(out.f.shape[-1]) % 2 == 0
        return dataclasses.replace(out, f=torch.where(keep, out.f, 0.0))
    monkeypatch.setattr(st, "compute_forces", half)


def _answer_altered(monkeypatch):
    st = _stepper()
    final = st.final_integrate

    def altered(state, params, cfg):
        out = final(state, params, cfg)
        hit = (out.tag % 97 == 0) & out.valid
        x = out.x + torch.where(hit, 5e-4, 0.0)
        return dataclasses.replace(out, x=x)
    monkeypatch.setattr(st, "final_integrate", altered)


def _count_altered(monkeypatch):
    st = _stepper()
    ssa = st.ssa_step

    def altered(state, params, geom, cfg):
        out = ssa(state, params, geom, cfg)
        hit = ((out.tag % 7 == 0) & out.valid).to(torch.int32)
        return dataclasses.replace(out, Cd=out.Cd + hit[None])
    monkeypatch.setattr(st, "ssa_step", altered)


FAULTS = [(c, f) for c in CELLS
          for f in (_state_unchanged, _half_left_out, _answer_altered)]
FAULTS.append((CELLS[1], _count_altered))


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=lambda v: v if isinstance(v, str) else v.__name__)
def test_a_broken_timed_path_is_not_correct(root, capsys, monkeypatch, cell,
                                            fault):
    fault(monkeypatch)
    line = _run(root, capsys, cell)
    assert not line["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(root, cell):
    """The reference computing its pair pass in bfloat16, in the program's
    place, fails a limit on every seed, while the program passes them all.
    Each planted fault (a pair term left out) moves the judged chunk far
    past the program's rounding; whether a limit catches it depends on the
    flow's scale, so its readings at the cells' own sizes are the card's
    (``control.py --faults``)."""
    c = cell_mod.load(cell, root)
    lim = c.spec["limits"]
    rows = control.readings(c, [5, 6, 7], torch.device("cpu"),
                            physics.DROPPABLE)
    for seed, side, r in rows:
        over = [k for k, v in r.items() if v > lim[k]]
        if side in ("sound", "control"):
            assert bool(over) == (side == "control"), (seed, side, r)
    sound = [r for _, side, r in rows if side == "sound"]
    for f in physics.DROPPABLE:
        got = [r for _, side, r in rows if side == f"fault:{f}"]
        assert len(got) == 3
        assert max(r["chunk_f_q"] for r in got) > 100 * max(
            r["chunk_f_q"] for r in sound), (f, got)


def test_no_jax_after_a_run(root, tmp_path):
    """A run loads no module whose top-level name is jax, jaxlib, flax or
    the JAX package (a fresh process: the test session may hold JAX)."""
    code = (
        "import sys, torch; torch.set_num_threads(2)\n"
        "from pathlib import Path\n"
        f"sys.path.insert(0, {str(tiny.ROOT)!r})\n"
        "from portbench import run\n"
        f"rc = run.run(['--workload', {CELLS[1]!r}, '--seed', '3', "
        "'--seconds', '0.2', '--trace', '0'], device='cpu', "
        f"root=Path({str(root)!r}))\n"
        "bad = {m.split('.')[0] for m in sys.modules} & "
        "{'jax', 'jaxlib', 'flax', 'sph_bvf_tpu'}\n"
        "print('BAD', sorted(bad), rc)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert "BAD [] 0" in out.stdout, out.stderr[-2000:]


def test_reference_imports_nothing_of_the_port():
    ref = tiny.ROOT / "portbench" / "reference"
    for path in ref.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import)
                     else [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in (
                    "sph_bvf_tpu_torch", "sph_bvf_tpu", "jax"), (path, name)


def test_no_result_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.run(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                  "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


@pytest.mark.gpu
def test_a_cell_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed",
         "2147483651", "--seconds", "3", "--trace", "0"], cwd=tiny.ROOT,
        capture_output=True, text=True, timeout=900,
        env=dict(os.environ, TMPDIR=str(tmp_path)))
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
