"""The PyTorch port's scene builder and stepper against the JAX package.

The N=50 lid-driven cavity (the flagship scene at test size) is built by
both packages and stepped from identical inputs (carried across by
``sph_bvf_tpu_torch.bridge``).  Both run on the CPU: JAX through its jnp
path and sort rebin, the port through its plain pass A and plain rebin walk.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import torch

from sph_bvf_tpu.core import stepper as jstepper
from sph_bvf_tpu.models import lid_cavity as jlid
from sph_bvf_tpu_torch import bridge
from sph_bvf_tpu_torch.core import stepper as tstepper
from sph_bvf_tpu_torch.models import lid_cavity as tlid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _to_f64_numpy(arrays):
    return {k: (v.astype(np.float64) if isinstance(v, np.ndarray)
                and v.dtype == np.float32 else v) for k, v in arrays.items()}


def _jax_tree(cls, arrays):
    return cls(**{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                  for k, v in arrays.items()})


def test_scene_build_matches_jax():
    """Port-built N=50 cavity == JAX-built: geometry, configs, params and
    every state leaf (counts, cap, tags, positions, slots) bitwise."""
    js, jp, jspec, _ = jlid.build(N=50)
    ts, tp, tspec, _ = tlid.build(N=50, device="cpu")
    assert dataclasses.asdict(tspec.geom) == dataclasses.asdict(jspec.geom)
    assert tspec.geom.cap == 14 and tspec.geom.base_occ == 9
    assert dataclasses.asdict(tspec.pair) == dataclasses.asdict(jspec.pair)
    assert dataclasses.asdict(tspec.integ) == dataclasses.asdict(jspec.integ)
    assert tspec.rebin_every == jspec.rebin_every
    assert [dataclasses.asdict(f) for f in tspec.fixes] == \
        [dataclasses.asdict(f) for f in jspec.fixes]
    assert int(ts.n_valid) == int(js.n_valid) == 3136
    a, b = bridge.to_numpy(js), bridge.state_from_port(ts)
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    pa, pb = bridge.to_numpy(jp), bridge.to_numpy(tp)
    for name in pa:
        np.testing.assert_array_equal(pa[name], pb[name], err_msg=name)


def test_bridge_round_trips_the_spec_and_state():
    """JAX -> port -> JAX gives back the same ModelSpec and State leaves."""
    from sph_bvf_tpu.core import fixes as jfixes
    from sph_bvf_tpu.core.integrate import IntegratorConfig
    from sph_bvf_tpu.core.state import Geometry
    from sph_bvf_tpu.ops.pair import PairConfig

    js, jp, jspec, _ = jlid.build(N=16)
    classes = dict(ModelSpec=jstepper.ModelSpec, Geometry=Geometry,
                   PairConfig=PairConfig, IntegratorConfig=IntegratorConfig,
                   SetForce=jfixes.SetForce)
    assert bridge.spec_from_port(bridge.spec_to_port(jspec), classes) == jspec
    a = bridge.to_numpy(js)
    b = bridge.state_from_port(bridge.state_to_port(a, device="cpu"))
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_200_steps_f64_match_jax():
    """200 steps of the N=50 cavity at f64 from identical inputs: x, v and
    rho within 1e-8, slot assignment (tag, valid) bitwise."""
    js, jp, jspec, _ = jlid.build(N=50)
    sa = _to_f64_numpy(bridge.to_numpy(js))
    pa = _to_f64_numpy(bridge.to_numpy(jp))
    js = _jax_tree(type(js), sa)
    jp = _jax_tree(type(jp), pa)
    ts = bridge.state_to_port(sa, device="cpu")
    tp = bridge.params_to_port(jp, device="cpu")
    tspec = bridge.spec_to_port(jspec)
    assert ts.x.dtype == torch.float64 and tp.mass.dtype == torch.float64

    js = jstepper.simulate(jstepper.setup(js, jp, jspec, dt=1e-4), jp, jspec, 200)
    ts = tstepper.simulate(tstepper.setup(ts, tp, tspec, dt=1e-4), tp, tspec, 200)
    a, b = bridge.to_numpy(js), bridge.state_from_port(ts)
    assert int(a["step"]) == int(b["step"]) == 200
    np.testing.assert_array_equal(a["tag"], b["tag"])
    np.testing.assert_array_equal(a["valid"], b["valid"])
    assert int(b["overflow"]) == 0 and int(b["drift_violation"]) == 0
    moved = np.abs(a["v"]).max()
    assert moved > 0.5  # the lid drives the flow; the run is not trivial
    for name in ("x", "v", "rho"):
        np.testing.assert_allclose(b[name], a[name], rtol=0, atol=1e-8,
                                   err_msg=name)


def test_density_filter_cadence_gating_exact():
    """run_chunk's phase segmentation skips only dead work: on chunks with
    and without a filter event every physics field is bitwise equal to
    the ungated run, and the gated run really skipped rhoAux."""
    state, params, spec, _ = tlid.build(N=16, device="cpu")
    a = tstepper.setup(state, params, spec, dt=1e-4)
    b = a
    done = 0
    for n in (8, 8, 8):  # filter events (freq 20) at step 20: chunk 3
        a = tstepper.run_chunk(a, params, spec, n)
        b = tstepper.run_chunk(b, params, spec, n, phase=done % 20)
        done += n
        for f in ("x", "v", "vest", "rho", "rhoI", "f", "drho", "ddv",
                  "phi", "nw", "num_den", "tag", "valid"):
            assert torch.equal(getattr(a, f), getattr(b, f)), (done, f)
    # step 24 is off the cadence: the gated pass skipped the accumulators
    assert float(a.rhoAux1.abs().max()) > 0
    assert float(b.rhoAux1.abs().max()) == 0
    # and the filter is live in this window: disabling it diverges
    spec_nf = dataclasses.replace(
        spec, integ=dataclasses.replace(spec.integ, freq_filter=0))
    c = tstepper.setup(state, params, spec_nf, dt=1e-4)
    for n in (8, 8, 8):
        c = tstepper.run_chunk(c, params, spec_nf, n)
    assert float((a.rho - c.rho).abs().max()) > 0


def test_port_never_imports_jax():
    """The port builds the cavity and runs a chunk with jax unimportable."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "from sph_bvf_tpu_torch.models import lid_cavity\n"
        "from sph_bvf_tpu_torch.core.stepper import setup, simulate\n"
        "s, p, spec, _ = lid_cavity.build(N=16, device='cpu')\n"
        "s = simulate(setup(s, p, spec, dt=1e-4), p, spec, spec.rebin_every)\n"
        "assert int(s.step) == spec.rebin_every\n"
        "assert not any(m == 'sph_bvf_tpu' or m.startswith('sph_bvf_tpu.')\n"
        "               for m in sys.modules)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
