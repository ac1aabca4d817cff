"""The port's example scripts (``examples/torch_run_model.py``,
``examples/torch_run_lmp_script.py``) against the JAX package's
(``examples/run_model.py``, ``examples/run_lmp_script.py``).

Each pair runs through its ``main`` on the CPU at a tiny size (the port's
with ``--device cpu``), each in an output directory of its own: the same
files come out, the thermo rows have the same columns and steps, and the
last frame holds the same particles and fields, each within 2e-6 of its
largest magnitude (both runs in f32, 20 steps: the frames written as text
differ by at most 2.4e-7 of a field's largest magnitude, rho).
"""

import importlib.util
import os
import re
import sys

import numpy as np
import pytest
import torch

from sph_bvf_tpu_torch.io import vtk as tvtk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-6  # of each field's largest magnitude


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _script(name):
    """The module of ``examples/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(name, argv, monkeypatch, capsys):
    """``main`` of ``examples/<name>.py`` with ``argv`` (as ``sys.argv``:
    the JAX package's scripts read it); the thermo rows it printed."""
    monkeypatch.setattr(sys, "argv", [name] + argv)
    _script(name).main()
    out = capsys.readouterr().out
    return [line for line in out.splitlines() if line.startswith("step ")]


def _columns(row):
    """A thermo row's (column, value) pairs before its rho range."""
    head = row.split("  rho [")[0]
    return re.findall(r"(\w+) +(\S+)", head)


CASES = {
    "model": ("run_model", "torch_run_model",
              ["lid_cavity", "--n", "16", "--steps", "20", "--dump-every", "10"],
              "lid_cavity_20.vtk"),
    "lmp": ("run_lmp_script", "torch_run_lmp_script",
            [os.path.join(REPO, "examples", "lid_cavity_ssa.lmp"), "--var", "N",
             "16", "--var", "nsteps", "20", "--var", "every", "10", "--var",
             "thermo", "10", "--max-steps", "20"],
            "cavity_ssa_20.vtk"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_example_matches_the_jax_script(case, tmp_path, monkeypatch, capsys):
    """The port's script and the JAX package's, the same arguments: the
    same output files, thermo rows of the same columns and steps (n equal),
    and the last frame's ids, types, points and fields within ``TOL`` of
    each field's largest magnitude."""
    jax_name, torch_name, argv, last = CASES[case]
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jrows = _run(jax_name, argv + ["--out", str(jdir)], monkeypatch, capsys)
    trows = _run(torch_name, argv + ["--out", str(tdir), "--device", "cpu"],
                 monkeypatch, capsys)
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    assert last in os.listdir(tdir)
    assert len(trows) == len(jrows) >= 2
    for a, b in zip(trows, jrows):
        ca, cb = _columns(a), _columns(b)
        assert [k for k, _ in ca] == [k for k, _ in cb]
        assert dict(ca)["step"] == dict(cb)["step"]
        assert dict(ca).get("n") == dict(cb).get("n")
    pa, da = tvtk.read_vtk(str(tdir / last))
    pb, db = tvtk.read_vtk(str(jdir / last))
    assert sorted(da) == sorted(db)
    np.testing.assert_array_equal(da["id"], db["id"])
    np.testing.assert_array_equal(da["type"], db["type"])
    for name, a, b in [("points", pa, pb)] + [(k, da[k], db[k]) for k in db]:
        scale = max(float(np.abs(b).max()), 1e-30)
        assert float(np.abs(a - b).max()) <= TOL * scale, name
