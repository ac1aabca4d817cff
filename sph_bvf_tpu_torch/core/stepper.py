"""The time-stepping loop (PyTorch).

Port of ``sph_bvf_tpu/core/stepper.py``.  The stage order of one step is
Verlet::run's (verlet.cpp:240-353):

    step++ ; initial_integrate ; post_integrate fixes ; compute_forces ;
    post_force fixes ; final_integrate ; end_of_step fixes

and a chunk is a rebin followed by ``rebin_every`` steps.  JAX scans a
chunk inside one compiled program; here a chunk is a Python loop of eager
steps.  The density-filter cadence segmentation is kept exactly: steps off
the cadence run with ``density_filter_accs=False`` (the pass-A kernel's
variant without the Shepard accumulators).

``simulate`` carries in-run load balancing (``spec.balance``): at a chunk
boundary every ``balance.every`` steps it may re-cut the x columns and
rebin the state into the new geometry with the sort rebin.  A callback that
raises ``utils.thermo.StopSimulation`` (``Halt``) ends the run at that
chunk, as fix halt does.  With SSA species (``spec.ssa``) the reactions
run after ``final_integrate`` and ``simulate`` warns once when the largest
per-pair hop mean leaves the tau-leap's regime.

``spec.mesh`` (``parallel/mesh.Mesh``) runs the same loop on every rank of
an x-slab mesh, each rank on its own slab of the state
(``mesh.shard_state``): the rebin and pass A exchange one halo plane with
the neighbours, and every value the host decides on (the overflow and
drift counts, a re-cut's acceptance, a halt, ``DtAdaptive``'s dt, a
thermo row) is reduced over the ranks, so they all take the same branch;
``simulate`` refuses a ``ThermoLogger`` or ``Halt`` whose ``mesh`` is not
``spec.mesh``.  The SSA hops are drawn on each rank's ghosted slab, pass B
exchanges f/m once more, and the reactions run on the slab unchanged
(per particle, keyed by tag); the tau-leap check's largest hop mean is the
whole grid's on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from sph_bvf_tpu_torch.core import fixes as fixes_mod
from sph_bvf_tpu_torch.core.integrate import (
    IntegratorConfig,
    final_integrate,
    initial_integrate,
    setup_pre_force,
)
from sph_bvf_tpu_torch.core.state import (
    Geometry,
    Params,
    State,
    rebin,
    rebin_droppable,
)
from sph_bvf_tpu_torch.core.ssa import ssa_step
from sph_bvf_tpu_torch.ops.pair import PairConfig, compute_forces, compute_ssa_mu_max
from sph_bvf_tpu_torch.parallel.mesh import all_reduce
from sph_bvf_tpu_torch.utils.thermo import Halt, StopSimulation, ThermoLogger


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Static description of a simulation (the JAX package's fields)."""

    geom: Geometry
    pair: PairConfig
    integ: IntegratorConfig
    fixes: Tuple[Any, ...] = ()
    ssa: Optional[Any] = None
    rebin_every: int = 10
    mesh: Optional[Any] = None
    balance: Optional[Any] = None


def step(state: State, params: Params, spec: ModelSpec) -> State:
    """One full Verlet step."""
    state = dataclasses.replace(state, step=state.step + 1)
    state = initial_integrate(state, params, spec.integ)
    state = fixes_mod.apply_stage(state, params, spec.fixes,
                                  fixes_mod.POST_INTEGRATE, spec.mesh)
    state = compute_forces(state, params, spec.geom, spec.pair, spec.mesh)
    state = fixes_mod.apply_stage(state, params, spec.fixes,
                                  fixes_mod.POST_FORCE, spec.mesh)
    state = final_integrate(state, params, spec.integ)
    if spec.ssa is not None:
        state = ssa_step(state, params, spec.geom, spec.ssa)
    state = fixes_mod.apply_stage(state, params, spec.fixes,
                                  fixes_mod.END_OF_STEP, spec.mesh)
    return state


def _rebin_drop(spec: ModelSpec) -> tuple:
    return rebin_droppable(bool(getattr(spec.integ, "xsph_factor", 0.0)))


def setup(state: State, params: Params, spec: ModelSpec, dt: float) -> State:
    """Verlet::setup: bin, vest=v, initial force eval, post_force fixes."""
    state = dataclasses.replace(
        state, dt=torch.tensor(dt, dtype=state.x.dtype, device=state.x.device))
    state = rebin(state, spec.geom, drop=_rebin_drop(spec), mesh=spec.mesh)
    state = setup_pre_force(state)
    state = compute_forces(state, params, spec.geom, spec.pair, spec.mesh)
    return fixes_mod.apply_stage(state, params, spec.fixes,
                                 fixes_mod.POST_FORCE, spec.mesh)


def run_chunk(state: State, params: Params, spec: ModelSpec, n: int,
              phase: Optional[int] = None) -> State:
    """rebin + n steps.  ``phase``: the chunk's absolute starting step
    modulo ``integ.freq_filter``; when given (and the integrator consumes
    the Shepard filter) only the steps on the filter cadence accumulate
    rhoAux1/rhoAux2.  ``None`` accumulates every step."""
    state = rebin(state, spec.geom, drop=_rebin_drop(spec), mesh=spec.mesh)
    return scan_steps(state, params, spec, n, phase)


def scan_steps(state: State, params: Params, spec: ModelSpec, n: int,
               phase: Optional[int]) -> State:
    """n steps, segmented at the density-filter cadence when ``phase`` is
    given (see run_chunk)."""
    freq = getattr(spec.integ, "freq_filter", 0)
    gate = (
        phase is not None
        and spec.pair.density_filter_accs
        and spec.integ.reads_rhoaux()
    )
    if not gate:
        for _ in range(n):
            state = step(state, params, spec)
        return state

    spec_ng = dataclasses.replace(
        spec, pair=dataclasses.replace(spec.pair, density_filter_accs=False)
    )
    for j in range(1, n + 1):
        on_cadence = (phase + j) % freq == 0
        state = step(state, params, spec if on_cadence else spec_ng)
    return state


def _halted(callback, state: State, mesh) -> bool:
    """Run ``callback(state)``; whether it (on any rank of ``mesh``) raised
    ``StopSimulation``, whose message is printed where it was raised."""
    stop = 0
    try:
        callback(state)
    except StopSimulation as e:
        print(f"[halt] {e}")
        stop = 1
    if mesh is not None:
        flag = torch.tensor(stop, device=mesh.device)
        stop = int(all_reduce(flag, mesh, "max"))
    return bool(stop)


def simulate(state: State, params: Params, spec: ModelSpec, nsteps: int,
             callback=None, callback_every: Optional[int] = None,
             balance_log: Optional[list] = None):
    """Host driver: run nsteps in chunks of ``rebin_every``, invoking
    ``callback(state)`` every ``callback_every`` steps (default: one chunk).

    Overflow and drift counters are read back every 10 chunks and at the
    end; a nonzero count raises.  A callback that raises ``StopSimulation``
    ends the run there: the message is printed, the counters are checked
    and the state is returned.

    With ``spec.balance`` set (``parallel/balance.BalanceFix``), every
    ``balance.every`` steps a chunk boundary asks ``rebalance`` for new x
    edges; an accepted re-cut rebins the state into the new geometry with
    the sort rebin (the slots still hold the old cells, so the locality
    walk cannot) and replaces ``spec.geom`` for the rest of the run, unless
    that rebin loses particles, in which case the old geometry stays.
    ``balance_log`` gets a dict per accepted re-cut (``step``, ``geom`` and
    the before/after metrics) and per refusal that gives a ``reason``
    (``geom`` None).

    Under ``spec.mesh`` every rank calls this on its slab; the counters it
    checks are sums over the ranks, the re-cut reads every rank's particles
    and a ``StopSimulation`` on any rank ends the run on all of them.
    """
    if (isinstance(callback, (Halt, ThermoLogger))
            and callback.mesh is not spec.mesh):
        raise ValueError(f"{type(callback).__name__}(mesh=...) must be the "
                         "run's spec.mesh, or its rows are one slab's")
    chunk = spec.rebin_every
    cb_every = callback_every or chunk
    if cb_every % chunk:
        raise ValueError("callback_every must be a multiple of rebin_every")

    warned_mu = [False]

    def check(state):
        overflow = int(state.overflow)
        if overflow:
            raise RuntimeError(
                f"{overflow} particles exceeded cell capacity (lost atoms)"
            )
        drift = int(state.drift_violation)
        if drift:
            raise RuntimeError(
                f"{drift} particles drifted past the cell margin between "
                f"rebins — pair coverage may have been violated; lower "
                f"rebin_every or raise Scene.margin_frac"
            )
        # the tau-leap's regime: the SSA diffusion truncates each pair's
        # Poisson draw, valid only for per-pair means << 1
        if params.n_ssa > 0 and not warned_mu[0]:
            mu = float(compute_ssa_mu_max(state, params, spec.geom, spec.pair,
                                          spec.mesh))
            if mu > 0.3:
                warned_mu[0] = True
                print(
                    f"[ssa] WARNING: max per-pair hop mean {mu:.3g} > 0.3 — "
                    f"the tau-leap truncation (poisson_terms="
                    f"{spec.pair.ssa_poisson_terms}) clips the hop-count "
                    f"tail; reduce dt or kappaSSA for exact-SSA statistics"
                )

    bal = spec.balance
    next_bal = bal.every if bal is not None else None

    # absolute step offset (nonzero on a resume): the filter phase follows
    # state.step, not the local step count
    step0 = int(state.step)
    done = 0
    while done < nsteps:
        if bal is not None and done >= next_bal:
            next_bal += bal.every
            from sph_bvf_tpu_torch.parallel.balance import rebalance

            new_geom, info = rebalance(state, spec.geom, bal, spec.mesh)
            if new_geom is not None:
                trial = rebin(state, new_geom, drop=_rebin_drop(spec),
                              use_kernel=False, drift_check=False,
                              mesh=spec.mesh)
                if int(trial.overflow) == int(state.overflow):
                    state = trial
                    spec = dataclasses.replace(spec, geom=new_geom)
                    if balance_log is not None:
                        balance_log.append(dict(step=done, geom=new_geom, **info))
                else:
                    print(
                        f"[balance] step {done}: re-cut rejected — new "
                        f"binning overflows cap={new_geom.cap} "
                        f"(imbalance {info.get('imbalance')})"
                    )
            elif balance_log is not None and "reason" in info:
                balance_log.append(dict(step=done, geom=None, **info))
        n = min(chunk, nsteps - done)
        freq = getattr(spec.integ, "freq_filter", 0)
        phase = (
            (step0 + done) % freq
            if spec.integ.reads_rhoaux() and spec.pair.density_filter_accs
            else None
        )
        state = run_chunk(state, params, spec, n, phase=phase)
        done += n
        if callback is not None and (done % cb_every == 0 or done >= nsteps):
            if _halted(callback, state, spec.mesh):
                check(state)
                return state
        # the counter readback costs a host round trip; amortize over chunks
        # but always check at the end so nothing slips through
        if done % (10 * chunk) == 0 or done >= nsteps:
            check(state)
    return state
