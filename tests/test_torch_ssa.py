"""The port's stochastic (SSA) layer against the JAX package.

``core/ssa.py`` (the truncated-Poisson sampler, the hop counts, the
mass-action propensities, the per-particle Gillespie reactions),
``ops/pair.py``'s Qd (drawn inline by the plain pass, and by ``_pass_a_qd``
after a kernel), ``compute_ssa_mu_max``, ``parallel/ensemble.py``'s keys and
the rebin moving the ``Cd`` rows.  Both packages run on the CPU from the
same inputs (``bridge.py``); every count is compared bitwise.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_bvf_tpu.core import ssa as jssa
from sph_bvf_tpu.core import stepper as jstepper
from sph_bvf_tpu.core.state import GROUP_ALL
from sph_bvf_tpu.ops import pair as jpair
from sph_bvf_tpu.parallel import ensemble as jensemble
from sph_bvf_tpu_torch import bridge
from sph_bvf_tpu_torch.api import scene as tscene
from sph_bvf_tpu_torch.core import rebin_cuda
from sph_bvf_tpu_torch.core import ssa as tssa
from sph_bvf_tpu_torch.core import state as TS
from sph_bvf_tpu_torch.core import stepper as tstepper
from sph_bvf_tpu_torch.models import lid_cavity as tlid
from sph_bvf_tpu_torch.models import taylor_green2d as ttg
from sph_bvf_tpu_torch.ops import pair as tpair
from sph_bvf_tpu_torch.ops import pair_cuda
from sph_bvf_tpu_torch.parallel import ensemble as tensemble
from synthetic_edges import any_corner_drift, seam_hairs
from test_ssa import _decay_state, _ssa_cavity


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (the suite's parallel
    workers' OpenMP pools otherwise starve one another)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax(cls, arrays):
    return cls(**{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                  for k, v in arrays.items()})


def _cast(arrays, dtype):
    """Every floating leaf of a numpy dict in ``dtype``."""
    return {k: (v.astype(dtype) if isinstance(v, np.ndarray)
                and np.issubdtype(v.dtype, np.floating) else v)
            for k, v in arrays.items()}


def _both_states(jstate, dtype):
    """(JAX state, port state on the CPU) holding the same numpy leaves."""
    a = _cast(bridge.to_numpy(jstate), dtype)
    return _jax(type(jstate), a), bridge.state_to_port(a, device="cpu")


def _both_params(jparams, dtype):
    a = _cast(bridge.to_numpy(jparams), dtype)
    return _jax(type(jparams), a), bridge.params_to_port(
        _jax(type(jparams), a), device="cpu")


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_poisson_and_hop_counts_bitwise(dtype):
    """``poisson_hash`` and ``pair_hop_counts`` on mu drawn from numpy (seed
    0), words past 2^31 included: every count equal to JAX's."""
    rng = np.random.default_rng(0)
    n = 20_000
    mu = rng.uniform(0.0, 2.0, n).astype(dtype)
    words = rng.integers(0, 2**32, (3, n), dtype=np.uint64)
    a = np.asarray(jssa.poisson_hash(jnp.asarray(mu), 8, jnp.uint32(7),
                                     jnp.asarray(words[0], jnp.uint32)))
    b = tssa.poisson_hash(torch.as_tensor(mu), 8, 7,
                          torch.as_tensor(words[0].astype(np.int64))).numpy()
    np.testing.assert_array_equal(a, b)
    assert a.max() >= 4 and a.dtype == b.dtype == np.int32
    tags = rng.integers(1, 2**31 - 1, (2, n)).astype(np.int32)
    step, seed, sp = 12345, int(words[2, 0]), rng.integers(0, 3, n)
    a = np.asarray(jssa.pair_hop_counts(
        jnp.asarray(mu), jnp.uint32(seed), jnp.int32(step),
        jnp.asarray(tags[0]), jnp.asarray(tags[1]),
        jnp.asarray(sp, jnp.uint32), 6))
    b = tssa.pair_hop_counts(
        torch.as_tensor(mu), seed, torch.tensor(step, dtype=torch.int32),
        torch.as_tensor(tags[0]), torch.as_tensor(tags[1]),
        torch.as_tensor(sp), 6).numpy()
    np.testing.assert_array_equal(a, b)


def test_propensities_match_jax():
    """Sources, first-order, bimolecular and dimerization channels, one of
    them group-restricted, at f64 within 1e-12."""
    rng = np.random.default_rng(1)
    Cd = rng.integers(0, 30, (2, 5, 7)).astype(np.int32)
    volume = rng.uniform(0.5, 2.0, (5, 7))
    gm = rng.choice([GROUP_ALL, GROUP_ALL | 2], (5, 7)).astype(np.int32)
    rx = (dict(k_rate=1.5), dict(k_rate=2.0, reactants=(0,)),
          dict(k_rate=3.0, reactants=(0, 1), groupbit=2),
          dict(k_rate=4.0, reactants=(1, 1), products=(0,)))
    jcfg = jssa.SsaConfig(reactions=tuple(jssa.SsaReaction(**r) for r in rx))
    tcfg = tssa.SsaConfig(reactions=tuple(tssa.SsaReaction(**r) for r in rx))
    a = np.asarray(jssa._propensities(jnp.asarray(Cd), jnp.asarray(volume),
                                      jnp.asarray(gm), jcfg, jnp.float64))
    b = tssa._propensities(torch.as_tensor(Cd), torch.as_tensor(volume),
                           torch.as_tensor(gm), tcfg, torch.float64).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-12, atol=0)
    assert (a[2] == 0).any() and (a[2] > 0).any()
    np.testing.assert_array_equal(np.asarray(jssa._stoich_table(jcfg, 2)),
                                  tssa._stoich_table(tcfg, 2).numpy())


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_reactions_bitwise(dtype):
    """``ssa_reactions`` on ``tests/test_ssa.py``'s decay state (4096
    particles of 40 molecules, A -> 0): Cd bitwise JAX's with the state's
    key and with another key, and the two keys' counts different."""
    st, jparams, k = _decay_state(c0=40, k=3.0, dt=0.1)
    cfg = dict(max_reaction_events=64)
    jcfg = jssa.SsaConfig(reactions=(jssa.SsaReaction(k_rate=k, reactants=(0,)),), **cfg)
    tcfg = tssa.SsaConfig(reactions=(tssa.SsaReaction(k_rate=k, reactants=(0,)),), **cfg)
    jparams, tparams = _both_params(jparams, dtype)
    outs = []
    for key in (None, [0, 99]):
        if key is not None:
            st = dataclasses.replace(st, key=jnp.asarray(key, jnp.uint32))
        js, ts = _both_states(st, dtype)
        a = np.asarray(jssa.ssa_reactions(js, jparams, jcfg).Cd)
        b = tssa.ssa_reactions(ts, tparams, tcfg).Cd.numpy()
        np.testing.assert_array_equal(a, b)
        outs.append(b)
    assert not np.array_equal(outs[0], outs[1])
    valid = np.asarray(st.valid)
    assert 25 < outs[0][0][valid].mean() < 35  # 40 exp(-0.3) = 29.6


def _cavity_pair(dtype):
    """``tests/test_ssa.py``'s SSA cavity (12 x 12, one species of 100)
    built by the JAX package, as (JAX state, port state, JAX params, port
    params, JAX spec, port spec) in ``dtype``."""
    js, jp, jspec = _ssa_cavity()
    js, ts = _both_states(js, dtype)
    jp, tp = _both_params(jp, dtype)
    return js, ts, jp, tp, jspec, bridge.spec_to_port(jspec)


def test_mu_max_matches_jax():
    """``compute_ssa_mu_max`` at the set-up SSA cavity, f64, within 1e-12
    relative, and inside the tau-leap regime."""
    js, ts, jp, tp, jspec, tspec = _cavity_pair(np.float64)
    js = jstepper.setup(js, jp, jspec, dt=1e-4)
    ts = tstepper.setup(ts, tp, tspec, dt=1e-4)
    a = float(jpair.compute_ssa_mu_max(js, jp, jspec.geom, jspec.pair))
    b = float(tpair.compute_ssa_mu_max(ts, tp, tspec.geom, tspec.pair))
    assert abs(b - a) <= 1e-12 * a and 0.0 < a < 0.3, (a, b)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_ssa_cavity_steps_match_jax(dtype):
    """20 steps of the SSA cavity (setup, then 4 chunks of 5): Cd and Qd
    bitwise JAX's; x, v and rho within 1e-8 at f64, x and rho within 5e-6
    of their max at f32 (v, ~1e-3 there, carries f32 rounding of the two
    frameworks' pressure sums); the molecules conserved and
    redistributed."""
    js, ts, jp, tp, jspec, tspec = _cavity_pair(dtype)
    assert tspec.ssa is None and tp.n_ssa == 1  # diffusion only
    total0 = int(torch.where(ts.valid, ts.Cd[0], 0).sum())
    js = jstepper.setup(js, jp, jspec, dt=1e-4)
    ts = tstepper.setup(ts, tp, tspec, dt=1e-4)
    for _ in range(4):
        js = jstepper.run_chunk(js, jp, jspec, 5)
        ts = tstepper.run_chunk(ts, tp, tspec, 5)
    a, b = bridge.to_numpy(js), bridge.state_from_port(ts)
    for name in ("Cd", "Qd", "tag", "valid"):
        np.testing.assert_array_equal(b[name], a[name], err_msg=name)
    tol = 1e-8 if dtype == np.float64 else 5e-6
    for name in ("x", "v", "rho") if dtype == np.float64 else ("x", "rho"):
        scale = 1.0 if dtype == np.float64 else float(np.abs(a[name]).max())
        np.testing.assert_allclose(b[name], a[name], rtol=0, atol=tol * scale,
                                   err_msg=name)
    assert int(np.abs(b["Qd"]).max()) > 0
    assert int(np.where(b["valid"], b["Cd"][0], 0).sum()) == total0


def test_kernel_split_qd_equals_the_inline_draws():
    """The card's route for SSA: ``pair_cuda.route`` sends the SSA cavity's
    pass A to a kernel (K1 here; none refuses it), never to the plain pass;
    where the kernel returns no Qd, ``compute_forces`` draws it with
    ``_pass_a_qd``, bitwise the plain pass's inline draws, in one piece
    and in pieces of 3 cells.  The kernel is stood in for by the plain
    pass with its Qd taken out."""
    _, ts, _, tp, _, tspec = _cavity_pair(np.float32)
    ts = tstepper.setup(ts, tp, tspec, dt=1e-4)
    geom, cfg = tspec.geom, tspec.pair
    assert pair_cuda.route(geom, cfg) is pair_cuda.pass_a_2d
    assert pair_cuda.kernel_unsupported(geom, cfg, n_sdpd=tp.n_sdpd) == []
    pf = tpair._per_particle(ts, tp, cfg)
    pair_cuda._check_launch(pf, tp, geom, cfg, pair_cuda.pass_a_2d)
    inline = tpair.compute_forces(ts, tp, geom, cfg)

    def kernel_stand_in(pf, params, geom, cfg, noise=None):
        acc = tpair._pass_a_plain(pf, params, geom, cfg, noise)
        del acc["Qd"]
        return acc

    route = pair_cuda.route
    calls = tpair._pass_a_qd.calls
    pair_cuda.route = lambda geom, cfg: kernel_stand_in
    try:
        split = tpair.compute_forces(ts, tp, geom, cfg)
    finally:
        pair_cuda.route = route
    assert tpair._pass_a_qd.calls == calls + 1
    np.testing.assert_array_equal(split.Qd.numpy(), inline.Qd.numpy())
    # the same draws over pieces of 3 target cells
    pieces = tpair._pass_a_qd(pf, tp, geom, cfg, tpair.noise_inputs(ts),
                              max_pair_slots=3 * 9 * geom.cap ** 2)
    np.testing.assert_array_equal(pieces.numpy(), inline.Qd.numpy())
    assert int(inline.Qd.abs().max()) > 0


@pytest.mark.parametrize("seed0", [0, 7])
def test_stack_replicas_keys_match_jax(seed0):
    """Replica r's key is JAX's ``PRNGKey(seed0 + r)``; every other leaf is
    the state's own."""
    js, _, _ = _ssa_cavity()
    a = jensemble.stack_replicas(js, 4, seed0)
    b = tensemble.stack_replicas(bridge.state_to_port(bridge.to_numpy(js),
                                                      device="cpu"), 4, seed0)
    np.testing.assert_array_equal(np.asarray(a.key).astype(np.int64),
                                  b.key.numpy())
    np.testing.assert_array_equal(np.asarray(a.Cd), b.Cd.numpy())
    assert b.x.shape == (4,) + tuple(js.x.shape)


def _seed_cd(state, n_ssa, seed):
    """``state`` with ``n_ssa`` species of counts (and hop balances) drawn
    from numpy on its valid slots."""
    rng = np.random.default_rng(seed)
    shape = (n_ssa,) + tuple(state.valid.shape)
    valid = state.valid.numpy()
    cd = np.where(valid, rng.integers(0, 1000, shape), 0).astype(np.int32)
    qd = np.where(valid, rng.integers(-5, 6, shape), 0).astype(np.int32)
    return dataclasses.replace(state, Cd=torch.as_tensor(cd),
                               Qd=torch.as_tensor(qd))


@pytest.mark.parametrize("grid", ["cavity", "periodic"])
def test_walk_moves_two_ssa_species_like_the_sort(grid):
    """K5's plain walk with ``n_ssa`` = 2 (two i32 Cd rows in the move's
    pack): every leaf, Cd and Qd included, bitwise the sort rebin's, after
    seeded drifts across every face and corner of the walled cavity and of
    the doubly periodic 2D vortex, and with positions a hair from the
    periodic seam."""
    if grid == "cavity":
        state, _, spec, _ = tlid.build(N=16, device="cpu")
        drifts = (any_corner_drift,)
    else:
        state, _, spec = ttg.scene(tscene.Scene, tscene.Region, N=24).build(
            device="cpu")
        drifts = (any_corner_drift, seam_hairs)
    geom = spec.geom
    assert rebin_cuda.move_route(geom) is rebin_cuda.rebin_move_2d
    state = _seed_cd(state, 2, seed=3)
    for drift in drifts:
        x = drift(state.x.numpy(), state.valid.numpy(), geom)
        moved = dataclasses.replace(state, x=torch.as_tensor(x))
        walk = bridge.state_from_port(TS.rebin(moved, geom, use_kernel=True))
        sort = bridge.state_from_port(TS.rebin(moved, geom, use_kernel=False))
        for key in sort:
            np.testing.assert_array_equal(walk[key], sort[key], err_msg=key)
        n = int(state.n_valid)
        assert int(walk["valid"].sum()) + int(walk["overflow"]) == n
        kept = np.isin(bridge.state_from_port(state)["tag"], walk["tag"][walk["valid"]])
        assert int(np.where(walk["valid"], walk["Cd"], 0).sum()) == int(
            np.where(kept & state.valid.numpy(), state.Cd.numpy(), 0).sum())
