"""The port's LAMMPS-script front end (``api/lmp.py``, ``__main__.py``) and
its system tools (``utils/info.py``, ``utils/profiler.py``) against the
JAX package.

Three scripts are parsed by both packages: ``tests/test_lmp.py``'s
``SYNTHETIC`` script, the SSA golden scenario (``tools/ssa_golden.py``) and
the lid-driven cavity with a stochastic species
(``examples/lid_cavity_ssa.lmp``, at N=50), whose particles are
``lid_cavity.build(N)``'s.  The port runs on the CPU (``device="cpu"``,
``--device cpu``).
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from sph_bvf_tpu.api import lmp as jlmp
from sph_bvf_tpu.utils import info as jinfo
from sph_bvf_tpu_torch import bridge
from sph_bvf_tpu_torch.__main__ import main
from sph_bvf_tpu_torch.api import lmp as tlmp
from sph_bvf_tpu_torch.core.state import gather_particles
from sph_bvf_tpu_torch.models import lid_cavity as tlid
from sph_bvf_tpu_torch.utils import info as tinfo
from sph_bvf_tpu_torch.utils import profiler as tprofiler
from test_lmp import SYNTHETIC

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAVITY_SSA = os.path.join(REPO, "examples", "lid_cavity_ssa.lmp")
sys.path.insert(0, REPO)
from tools.ssa_golden import CD0, NXP, scenario_lmp  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (the suite's parallel
    workers' OpenMP pools otherwise starve one another)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _golden(steps=20):
    return scenario_lmp(steps, "golden_out", steps)


def _cavity_ssa():
    with open(CAVITY_SSA) as f:
        return f.read()


SCRIPTS = {
    "synthetic": (lambda: SYNTHETIC, {}),
    "ssa golden": (_golden, {}),
    "cavity ssa": (_cavity_ssa, {"N": 50}),
}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_scripts_build_like_jax(name):
    """Each script parsed by both packages: the same variables, dumps and
    run directives; the built state, params and spec bitwise the JAX
    package's (carried across by ``bridge``)."""
    text, overrides = SCRIPTS[name]
    text = text()
    jm = jlmp.parse_script(text, overrides=overrides)
    tm = tlmp.parse_script(text, overrides=overrides)
    assert tm.variables == jm.variables
    assert (tm.nsteps, tm.dt, tm.thermo_every, tm.thermo_columns) == \
        (jm.nsteps, jm.dt, jm.thermo_every, jm.thermo_columns)
    assert [dataclasses.asdict(d) for d in tm.dumps] == \
        [dataclasses.asdict(d) for d in jm.dumps]
    assert tm.computes == jm.computes
    js, jp, jspec = jm.build()
    ts, tp, tspec = tm.build(device="cpu")
    a, b = bridge.to_numpy(js), bridge.state_from_port(ts)
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    pa, pb = bridge.to_numpy(jp), bridge.to_numpy(tp)
    for key in pa:
        np.testing.assert_array_equal(pa[key], pb[key], err_msg=key)
    assert bridge.spec_to_port(jspec) == tspec


def test_cavity_ssa_script_is_the_flagship():
    """``examples/lid_cavity_ssa.lmp`` at N=50 holds ``lid_cavity.build(50)``'s
    particles, masses and grid, bitwise, plus one species: 50 molecules on
    the fluid left of x = 0.5, a decay of rate ln 2 / (1000 dt), and a
    kappaSSA whose largest hop mean at N=200 lies in (0.01, 0.3) (it grows
    as N^2: 16 times smaller at N=50)."""
    from sph_bvf_tpu_torch.core.stepper import setup
    from sph_bvf_tpu_torch.ops.pair import compute_ssa_mu_max

    m = tlmp.parse_script(_cavity_ssa(), overrides={"N": 50})
    ts, tp, tspec = m.build(device="cpu")
    ls, lp, lspec, _ = tlid.build(N=50, device="cpu")
    fields = ("x", "v", "ptype", "solid_tag", "fixed_tag", "rho", "e")
    a = gather_particles(ts, tspec.geom, fields)
    b = gather_particles(ls, lspec.geom, fields)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert tspec.geom == lspec.geom and tspec.geom.cap == 14
    np.testing.assert_array_equal(tp.mass.numpy(), lp.mass.numpy())
    cd = gather_particles(ts, tspec.geom, ("Cd",))["Cd"][:, 0]
    fluid = (b["ptype"] == 0)
    left = fluid & (b["x"][:, 0] <= 0.5)
    assert (cd[left] == 50).all() and (cd[~left] == 0).all()
    (rx,) = tspec.ssa.reactions
    assert rx.reactants == (0,) and rx.products == ()
    assert rx.k_rate == np.log(2.0) / (1000 * m.dt)
    mu = float(compute_ssa_mu_max(setup(ts, tp, tspec, dt=m.dt), tp,
                                  tspec.geom, tspec.pair))
    assert 0.01 < 16 * mu < 0.3, mu


@pytest.mark.parametrize("fix,variant", list(tlmp._INTEGRATOR_FIXES.items()))
def test_integrator_fix_names(fix, variant):
    """Each of the seven integrator fix names reaches its variant, and the
    bvf family turns pass B on."""
    text = SYNTHETIC.replace("ssa_tsdpd/bvf/transportVelocity\ncompute",
                             f"{fix}\ncompute")
    assert f"fix integration all {fix}\n" in text
    _, _, spec = tlmp.parse_script(text).build(device="cpu")
    assert spec.integ.variant == variant
    assert spec.pair.weighted_solid == (
        variant in ("bvf", "artificial_stress", "zhang"))


def test_errors():
    with pytest.raises(tlmp.LmpError, match="unsupported command"):
        tlmp.parse_script("bogus_command 1 2 3")
    with pytest.raises(tlmp.LmpError, match="undefined variable"):
        tlmp.parse_script("variable a equal ${nope}")


def test_variable_styles_index_loop_string():
    """index, loop, world and string variables: first-value semantics, the
    raw token in ${} expansion, ``-var`` overrides winning; the same
    variables as the JAX package's parser."""
    script = SYNTHETIC.replace(
        "variable nx equal 12",
        "variable nx index 12 24\n"
        "variable it loop 5\n"
        "variable tag string 007\n"
        "variable wrank world 0",
    ).replace("run 1000", "variable label string ${tag}_${it}\nrun 1000")
    for overrides in ({}, {"nx": 8}):
        model = tlmp.parse_script(script, overrides=overrides)
        assert model.variables == jlmp.parse_script(
            script, overrides=overrides).variables
        assert model.variables["nx"] == overrides.get("nx", 12.0)
    assert model.variables["it"] == 1.0 and model.variables["wrank"] == 0.0
    assert model.variables["tag"] == 7.0
    with pytest.raises(tlmp.LmpError):
        tlmp.parse_script(script + "\nnext it\n")


def test_main_writes_frames_and_log(tmp_path, capsys):
    """``python -m sph_bvf_tpu_torch -in examples/lid_cavity_ssa.lmp`` on the
    CPU at N=16 for 40 steps: VTK frames at steps 0, 20 and 40 with the
    script's fields, the bounding box, thermo rows at the same steps in the
    ``-log`` file, a ``done:`` line; the molecule total has fallen (the
    decay) but not below the 1/2 it reaches at step 1000."""
    from sph_bvf_tpu_torch.io.vtk import read_vtk

    log = tmp_path / "log.cavity"
    out = tmp_path / "out"
    rc = main(["-in", CAVITY_SSA, "-var", "N", "16", "-var", "nsteps", "40",
               "-var", "every", "20", "-var", "thermo", "20", "-log", str(log),
               "--out", str(out), "--device", "cpu"])
    assert rc == 0
    frames = [str(out / f"cavity_ssa_{s}.vtk") for s in (0, 20, 40)]
    assert all(os.path.exists(f) for f in frames)
    assert os.path.exists(out / "cavity_ssa_boundingBox.vtk")
    _, d0 = read_vtk(frames[0])
    _, d2 = read_vtk(frames[-1])
    assert set(d2) >= {"id", "type", "vx", "vy", "c_rho", "c_cd"}
    assert d0["c_cd"].sum() == 50 * (d0["c_cd"] > 0).sum()
    assert 0.5 * d0["c_cd"].sum() < d2["c_cd"].sum() < d0["c_cd"].sum()
    rows = [l.split()[1] for l in log.read_text().splitlines()
            if l.startswith("step")]
    assert rows == ["0", "20", "40"], log.read_text()
    assert "done: step 40" in capsys.readouterr().out


def test_read_restart_resumes_deterministically(tmp_path):
    """``restart 10`` then ``read_restart`` of its step-10 file and 10 more
    steps of the golden scenario (the SSA counts and the key in the
    checkpoint): step 20, and two resumes bitwise equal."""
    base = "\n".join(l for l in _golden(20).splitlines()
                     if not l.startswith("dump"))
    writer = base.replace("timestep", "restart 10 ck*.npz\ntimestep")
    tlmp.parse_script(writer).run(out_dir=str(tmp_path), thermo=False,
                                  device="cpu")
    ck = tmp_path / "ck10.npz"
    assert ck.exists() and (tmp_path / "ck20.npz").exists()
    resume = base.replace("run", f"read_restart {ck}\nrun").replace(
        "run                20", "run 10")
    runs = [tlmp.parse_script(resume).run(out_dir=str(tmp_path / w),
                                          thermo=False, device="cpu")[0]
            for w in "bc"]
    assert int(runs[0].step) == 20
    for f in ("x", "v", "rho", "Cd", "Qd", "key"):
        np.testing.assert_array_equal(getattr(runs[0], f).numpy(),
                                      getattr(runs[1], f).numpy(), err_msg=f)
    total = int(torch.where(runs[0].valid, runs[0].Cd[0], 0).sum())
    assert abs(total - CD0 * (NXP // 2) * NXP) <= 2


def test_describe_and_breakdown_on_the_cpu(capsys):
    """``describe`` gives the JAX package's counts (box, grid, particles by
    type, solids, species, fixes) and names the pass-A route;
    ``print_breakdown`` prints the PAIR / NEIGH / MODIFY table."""
    text = _golden()
    js, jp, jspec = jlmp.parse_script(text).build()
    ts, tp, tspec = tlmp.parse_script(text).build(device="cpu")
    a = jinfo.describe(js, jp, jspec).splitlines()
    b = tinfo.describe(ts, tp, tspec).splitlines()
    assert len(a) == len(b)
    for la, lb in zip(a, b):
        if la.strip().startswith(("pair:", "rebin every")):
            continue
        assert la == lb
    assert "pass A pass_a_2d on cpu" in "\n".join(b)
    ms = tprofiler.print_breakdown(ts, tp, tspec, repeats=2)
    assert set(ms) == {tprofiler.PAIR, tprofiler.NEIGH, tprofiler.MODIFY}
    assert all(v > 0 for v in ms.values())
    assert "particle-steps/s" in capsys.readouterr().out
