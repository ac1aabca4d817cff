"""The PyTorch port's long-run validation tools against the JAX package's.

``tools/torch_ghia_benchmark.py``, ``tools/torch_nusselt.py`` and
``tools/torch_fsi_release.py`` are held to ``tools/ghia_benchmark.py``,
``tools/nusselt.py`` and ``tools/fsi_release_ours.py`` on the CPU at small
sizes: the Ghia tables read from the JAX tool's source (it runs at import,
so it is parsed, never imported); the centerline profile of the port's
N=50 cavity after 100 steps at f64 against the JAX tool's formula on the
JAX package's run from the same inputs; both Nusselt legs at N=40 through
both ``run_to_steady`` at f32; and both FSI release tools as processes at
nx=24, their npz snapshots compared per tag.
"""

import ast
import importlib.util
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_bvf_tpu.core import state as JS
from sph_bvf_tpu.core import stepper as jstepper
from sph_bvf_tpu.models import lid_cavity as jlid
from sph_bvf_tpu.models import natural_convection as jconv
from sph_bvf_tpu_torch import bridge
from sph_bvf_tpu_torch.core import stepper as tstepper

import jax_ghia_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (the suite's parallel
    workers' OpenMP pools otherwise starve one another)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def fsi_runs(tmp_path_factory):
    """Both FSI release tools (nx=24, 20 steps, snapshots every 10, the
    beam released at step 10; the port on ``--device cpu``) started as
    processes when the module starts, so that they run beside its other
    tests: ({"jax", "port"}: Popen, {"jax", "port"}: npz path)."""
    tmp = tmp_path_factory.mktemp("fsi_release")
    args = ["--nx", "24", "--steps", "20", "--every", "10",
            "--tdamp-solid", "10"]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out, procs = {}, {}
    for key, tool, extra in (("jax", "fsi_release_ours.py", []),
                             ("port", "torch_fsi_release.py",
                              ["--device", "cpu"])):
        out[key] = tmp / f"{key}.npz"
        procs[key] = subprocess.Popen(
            [sys.executable, os.path.join(TOOLS, tool), *args,
             "--out", str(out[key]), *extra], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield procs, out
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


def _tool(name):
    """``tools/<name>.py`` as a module (``tools/`` is not a package)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ghia_tool = _tool("torch_ghia_benchmark")


def _f64(arrays):
    return {k: (v.astype(np.float64) if isinstance(v, np.ndarray)
                and v.dtype == np.float32 else v) for k, v in arrays.items()}


def _jax(cls, arrays):
    return cls(**{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                  for k, v in arrays.items()})


def _jax_tool_tables():
    """``ys``, ``GHIA_U`` and the dt table of ``tools/ghia_benchmark.py``,
    read from its source with ``ast``."""
    with open(os.path.join(TOOLS, "ghia_benchmark.py")) as fh:
        tree = ast.parse(fh.read())
    out = {}
    for node in tree.body:
        if not (isinstance(node, ast.Assign)
                and isinstance(node.targets[0], ast.Name)):
            continue
        name = node.targets[0].id
        if name == "ys":  # np.array([...])
            out["ys"] = ast.literal_eval(node.value.args[0])
        elif name == "GHIA_U":
            out["GHIA_U"] = ast.literal_eval(node.value)
        elif name == "dt":  # {100: ..., 1000: ...}[RE]
            out["dt"] = ast.literal_eval(node.value.value)
    assert set(out) == {"ys", "GHIA_U", "dt"}, out
    return out


@pytest.mark.parametrize("copy", ["tools/torch_ghia_benchmark.py",
                                  "tests/jax_ghia_run.py"])
def test_ghia_tables_match_the_jax_tool(copy):
    """The port's tool and the JAX holdout script keep the JAX tool's
    ``ys``, ``GHIA_U`` and dt table, value for value."""
    want = _jax_tool_tables()
    if copy.startswith("tools/"):
        ys, table, dt = ghia_tool.ys, ghia_tool.GHIA_U, ghia_tool.DT
    else:
        ys, table = jax_ghia_run.YS, {100: jax_ghia_run.GHIA_U100}
        dt = jax_ghia_run.DT
        want["GHIA_U"] = {100: want["GHIA_U"][100]}
    assert isinstance(ys, np.ndarray)
    assert ys.tolist() == want["ys"]
    assert table == want["GHIA_U"]
    assert dt == want["dt"]


def test_ghia_profile_matches_the_jax_tool_on_100_steps_f64():
    """The N=50 cavity from the JAX build, bridged, runs setup and 10
    chunks of 10 steps at f64 in both packages; the port's profile of its
    state equals the JAX tool's formula (``jax_ghia_run.jax_tool_profile``,
    a copy of ``tools/ghia_benchmark.py:35-48``) on the JAX package's
    gathered state within 1e-8."""
    N = 50
    js, jp, jspec, _ = jlid.build(N=N, Re=100.0, rebin_every=10)
    sa, pa = _f64(bridge.to_numpy(js)), _f64(bridge.to_numpy(jp))
    js, jp = _jax(type(js), sa), _jax(type(jp), pa)
    ts = bridge.state_to_port(sa, device="cpu")
    tp = bridge.params_to_port(jp, device="cpu")
    tspec = bridge.spec_to_port(jspec)
    assert ts.x.dtype == torch.float64 and tp.mass.dtype == torch.float64
    dt = ghia_tool.DT[100]
    js = jstepper.setup(js, jp, jspec, dt=dt)
    ts = tstepper.setup(ts, tp, tspec, dt=dt)
    for _ in range(10):
        js = jstepper.run_chunk(js, jp, jspec, ghia_tool.CHUNK)
        ts = tstepper.run_chunk(ts, tp, tspec, ghia_tool.CHUNK)
    assert int(ts.step) == int(js.step) == 100
    assert int(ts.overflow) == 0 and int(ts.drift_violation) == 0
    got = ghia_tool.state_profile(ts, tspec.geom, N)
    out = JS.gather_particles(js, jspec.geom, fields=("x", "v", "solid_tag"))
    want = jax_ghia_run.jax_tool_profile(out["x"], out["v"],
                                         out["solid_tag"], N)
    assert np.abs(want[0]) > 1e-3  # the lid has moved the fluid under it
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-8)


def test_ghia_run_blocks_and_summary():
    """``run`` on the CPU at N=16: a run of 25 steps takes chunks of 10, 10
    and 5 and ends on the state (and profile) of setup plus those chunks,
    bitwise; the summary counts the steps, the particles and no loss."""
    lines = []
    got = ghia_tool.run(N=16, Re=100, steps=25, profile_every=25,
                        device="cpu", log=lines.append)
    state, params, spec, _ = ghia_tool.lid_cavity.build(
        N=16, Re=100.0, rebin_every=10, device="cpu")
    state = tstepper.setup(state, params, spec, dt=ghia_tool.DT[100])
    for n in (10, 10, 5):
        state = tstepper.run_chunk(state, params, spec, n)
    want = ghia_tool.state_profile(state, spec.geom, 16)
    assert got["u"] == want.tolist()
    assert got["steps"] == 25 and got["overflow"] == 0 and got["drift"] == 0
    assert got["particles"] == [int(state.n_valid)] * 2
    assert got["max_diff"] == float(np.abs(want - ghia_tool.GHIA_U[100]).max())
    assert lines[0].startswith("steps=25 wall=") and lines[0].endswith(
        "overflow=0")
    assert len(lines) == 1 + 7 + 1
    assert lines[-1].startswith("steps=25: max|diff|")


def test_nusselt_qdot_matches_the_jax_tool():
    """``qdot`` of both tools on one set-up N=40 convection state (the JAX
    package's, bridged): the cylinder's heat output, relative 1e-6."""
    jtool, ttool = _tool("nusselt"), _tool("torch_nusselt")
    js, jp, jspec, sc = jconv.build(N=40, Ra=1e4)
    js = jstepper.setup(js, jp, jspec, dt=ttool.DT)
    ts = bridge.state_to_port(bridge.to_numpy(js), device="cpu")
    tp = bridge.params_to_port(jp, device="cpu")
    gb = sc.groupbit("sphere")
    want = jtool.qdot(js, jp, gb)
    assert want > 0
    assert abs(ttool.qdot(ts, tp, gb) - want) <= 1e-6 * want


@pytest.mark.parametrize("buoyancy", [False, True], ids=["cond", "conv"])
def test_nusselt_leg_matches_the_jax_tool(buoyancy, monkeypatch):
    """One leg of each tool's ``run_to_steady`` at N=40, f32, 40 steps
    checked every 20: the same (steps, steady) and Qdot within 1e-5
    relative; the conduction leg's Buoyancy fix carries acceleration 0 in
    both (the specs each hands to ``setup``), the convection leg's -1."""
    jtool, ttool = _tool("nusselt"), _tool("torch_nusselt")
    specs = {}

    def spy(setup, key):
        def wrapped(state, params, spec, dt):
            specs[key] = spec
            return setup(state, params, spec, dt)
        return wrapped

    monkeypatch.setattr(jstepper, "setup", spy(jstepper.setup, "jax"))
    monkeypatch.setattr(ttool, "setup", spy(ttool.setup, "port"))
    log = []
    jq, jsteps, jok = jtool.run_to_steady(40, 1e4, buoyancy, 40, 20, 2e-3)
    tq, tsteps, tok = ttool.run_to_steady(40, 1e4, buoyancy, 40, 20, 2e-3,
                                          device="cpu", log=log.append)
    assert (tsteps, tok) == (jsteps, jok) == (40, False)
    assert jq > 0 and abs(tq - jq) <= 1e-5 * jq
    accel = -1.0 if buoyancy else 0.0
    for key, spec in specs.items():
        fixes = [f for f in spec.fixes if type(f).__name__ == "Buoyancy"]
        assert [f.acceleration for f in fixes] == [accel], key
    assert len(log) == 3 and log[-1].startswith(
        f"[{'conv' if buoyancy else 'cond'}] step 40 Qdot")


def test_fsi_release_tools_agree_at_nx24(fsi_runs):
    """Both FSI release tools as processes, nx=24, 20 steps, snapshots
    every 10, the beam released at step 10 (the port on ``--device cpu``):
    the same npz keys and tags, x and v per tag within 5e-6 of each
    field's max, and the port's tip x read at each snapshot."""
    procs, out = fsi_runs
    logs = {k: p.communicate(timeout=600) for k, p in procs.items()}
    for k, p in procs.items():
        assert p.returncode == 0, (k, logs[k][1][-3000:])
    a, b = np.load(out["jax"]), np.load(out["port"])
    assert sorted(a.keys()) == sorted(b.keys()) == sorted(
        f"{s}_{f}" for s in (0, 10, 20) for f in ("tag", "x", "v"))
    for s in (0, 10, 20):
        np.testing.assert_array_equal(a[f"{s}_tag"], b[f"{s}_tag"])
        for f in ("x", "v"):
            ref = a[f"{s}_{f}"].astype(np.float64)
            scale = max(float(np.abs(ref).max()), 1e-30)
            err = float(np.abs(b[f"{s}_{f}"] - ref).max())
            assert err <= 5e-6 * scale, (s, f, err / scale)
    summary = json.loads(logs["port"][0].strip().splitlines()[-1])
    assert summary["overflow"] == 0 and summary["finite"]
    assert sorted(summary["tip_x"]) == ["0", "10", "20"]
    assert summary["tip_particles"] > 0
    assert 100e-6 < summary["tip_x"]["0"] < 105e-6  # within the beam's x span


def test_port_tools_never_import_jax():
    """The three port tools import with jax unimportable and load nothing
    of the JAX package."""
    code = (
        "import importlib.util, sys\n"
        "sys.modules['jax'] = None\n"
        "for name in ('torch_ghia_benchmark', 'torch_nusselt',\n"
        "             'torch_fsi_release'):\n"
        f"    spec = importlib.util.spec_from_file_location(name, {TOOLS!r}\n"
        "        + '/' + name + '.py')\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "assert not any(m == 'sph_bvf_tpu' or m.startswith('sph_bvf_tpu.')\n"
        "               for m in sys.modules)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, timeout=300,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
