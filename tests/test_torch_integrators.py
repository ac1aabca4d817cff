"""The port's bvf, artificial_stress, zhang and stationary integrators and
its weighted-solid pass B against the JAX package.

``tests/test_integrators.py``'s clustered system (free and fixed fluid and
solid particles, a moving free-solid cluster with fluid inside it, so the
phi > 0.5 gate fires and vws/aws are nonzero) at f64, built by the JAX
package and carried to the port (``bridge.py``); both drive the same
force-then-integrate loop on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_bvf_tpu.core import integrate as jinteg
from sph_bvf_tpu.core.integrate import IntegratorConfig as JIntegratorConfig
from sph_bvf_tpu.core.state import gather_particles as jgather
from sph_bvf_tpu.ops import pair as jpair
from sph_bvf_tpu.ops.pair import PairConfig as JPairConfig
from sph_bvf_tpu_torch import bridge
from sph_bvf_tpu_torch.core import integrate as tinteg
from sph_bvf_tpu_torch.core.state import Geometry as TGeometry
from sph_bvf_tpu_torch.core.state import gather_particles as tgather
from sph_bvf_tpu_torch.ops import pair as tpair
from test_integrators import clustered_system
from test_pair import build_state_params

DT = 1e-3
FIELDS = ("x", "v", "vest", "rho")
VARIANTS = ("bvf", "artificial_stress", "zhang", "stationary")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (the suite's parallel
    workers' OpenMP pools otherwise starve one another)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _systems():
    """(JAX geometry, state, params) and (port state, params, geometry,
    pair config) of the clustered system at dt 1e-3, f64."""
    geom, st0, params = build_state_params(clustered_system())
    st0 = dataclasses.replace(st0, dt=jnp.asarray(DT, jnp.float64))
    ts = bridge.state_to_port(bridge.to_numpy(st0), device="cpu")
    tp = bridge.params_to_port(params, device="cpu")
    tgeom = TGeometry(**dataclasses.asdict(geom))
    return (geom, st0, params), (ts, tp, tgeom)


_jforces = jax.jit(jpair.compute_forces, static_argnames=("geom", "cfg"))
_jinitial = jax.jit(jinteg.initial_integrate, static_argnames=("cfg",))
_jfinal = jax.jit(jinteg.final_integrate, static_argnames=("cfg",))


def _run_jax(st, params, geom, pair_cfg, integ, nsteps):
    """``test_integrators._run_framework``, each stage one compiled program
    (op-by-op dispatch compiles every op of the pair pass apart)."""
    st = jinteg.setup_pre_force(st)
    st = _jforces(st, params, geom, pair_cfg)
    for _ in range(nsteps):
        st = dataclasses.replace(st, step=st.step + 1)
        st = _jinitial(st, params, integ)
        st = _jforces(st, params, geom, pair_cfg)
        st = _jfinal(st, params, integ)
    return st


def _run_port(st, params, geom, pair_cfg, integ, nsteps):
    """``test_integrators._run_framework`` on the port."""
    st = tinteg.setup_pre_force(st)
    st = tpair.compute_forces(st, params, geom, pair_cfg)
    for _ in range(nsteps):
        st = dataclasses.replace(st, step=st.step + 1)
        st = tinteg.initial_integrate(st, params, integ)
        st = tpair.compute_forces(st, params, geom, pair_cfg)
        st = tinteg.final_integrate(st, params, integ)
    return st


def _close(a, b, name):
    """rtol 1e-9 (atol 1e-11 of the largest finite value); NaNs where the
    JAX package has them (zhang's inverted filter divides by rhoAux1)."""
    scale = max(float(np.nanmax(np.abs(a))), 1e-12)
    np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-11 * scale,
                               err_msg=name)


@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_matches_jax(variant):
    """4 steps of each variant (zhang with a filter every 2 steps) with pass
    B on: x, v, vest and rho within rtol 1e-9 of the JAX package's, and the
    variant's mark on the run (the gate fired, the free solids moved,
    stationary froze x and v)."""
    (jgeom, jst, jparams), (ts, tp, tgeom) = _systems()
    kw = {"freq_filter": 2} if variant == "zhang" else {}
    jcfg = JPairConfig.transport_velocity(dim=2, weighted_solid=True)
    tcfg = tpair.PairConfig.transport_velocity(dim=2, weighted_solid=True)
    a = _run_jax(jst, jparams, jgeom, jcfg,
                       getattr(JIntegratorConfig, variant)(**kw), 4)
    b = _run_port(ts, tp, tgeom, tcfg,
                  getattr(tinteg.IntegratorConfig, variant)(**kw), 4)
    fields = FIELDS + ("phi", "vws", "aws")
    ga, gb = jgather(a, jgeom, fields=fields), tgather(b, tgeom, fields=fields)
    np.testing.assert_array_equal(ga["tag"], gb["tag"])
    for name in fields:
        _close(ga[name], gb[name], f"{variant}:{name}")
    before = tgather(tinteg.setup_pre_force(ts), tgeom, fields=FIELDS)
    if variant == "stationary":
        for name in ("x", "v", "vest"):
            np.testing.assert_array_equal(gb[name], before[name], err_msg=name)
    else:
        assert np.abs(gb["v"] - before["v"]).max() > 1e-6


def test_pass_b_matches_jax():
    """Pass B's vws and aws on the clustered system within 1e-9 of JAX's,
    nonzero, with and without ``weighted_solid_skip_fixed``; zero with
    ``weighted_solid`` off."""
    (jgeom, jst, jparams), (ts, tp, tgeom) = _systems()
    for skip in (False, True):
        kw = dict(dim=2, weighted_solid=True, weighted_solid_skip_fixed=skip)
        a = _jforces(jst, jparams, jgeom, JPairConfig.transport_velocity(**kw))
        b = tpair.compute_forces(ts, tp, tgeom,
                                 tpair.PairConfig.transport_velocity(**kw))
        for name in ("vws", "aws"):
            ref = np.asarray(getattr(a, name))
            _close(ref, getattr(b, name).numpy(), f"{name} skip={skip}")
            assert np.abs(ref).max() > 0
    off = tpair.compute_forces(ts, tp, tgeom, tpair.PairConfig.transport_velocity(
        dim=2, weighted_solid=False))
    assert float(off.vws.abs().max()) == float(off.aws.abs().max()) == 0.0


@pytest.mark.parametrize("pair", [("artificial_stress", "bvf"),
                                  ("zhang", "transport_velocity")])
def test_variants_differ_on_the_port(pair):
    """The two differences the JAX package's own tests assert:
    artificial_stress is not bvf (normalized gate and reflection terms) and
    zhang is not transport_velocity, here on the port's side."""
    _, (ts, tp, tgeom) = _systems()
    cfg = tpair.PairConfig.transport_velocity(dim=2, weighted_solid=True)
    runs = [tgather(_run_port(ts, tp, tgeom, cfg,
                              getattr(tinteg.IntegratorConfig, v)(), 3),
                    tgeom, fields=("v",))["v"] for v in pair]
    assert np.abs(runs[0] - runs[1]).max() > 1e-8
