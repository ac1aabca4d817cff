"""Integrator fixes: the SPH-BVF velocity-Verlet family (PyTorch).

Port of ``sph_bvf_tpu/core/integrate.py``, every variant: transport
velocity (fix ssa_tsdpd/bvf/transportVelocity, the lid-driven cavity),
mechanics (fix ssa_tsdpd/bvf/mechanics: XSPH smoothing, the fluid-force
ramp and the solid release gate; the FSI beam), fsi (mechanics with the
release gate one step later; cell polarization), plain bvf (fix
ssa_tsdpd/bvf: one Verlet scheme with the raw-phi gate and the moving-wall
reflection), artificialStress (bvf with phi, nw, vws and aws normalized by
the number density), zhang (fix ssa_tsdpd/bvf/zhang, the Zhang-2017
density experiment, its inverted filter replicated as it is) and
stationary (only rho, C and Cd advance).  Every fluid/solid x free/fixed
branch is a ``torch.where`` over the whole state; the reference citations
are on the JAX module's lines.

The Shepard-filter cadence test ``step % freq_filter == 0`` is a 0-dim
device tensor, so a step makes no host round trip.  The SSA reactions run
after ``final_integrate`` (``core/ssa.py``, called by the stepper).
"""

from __future__ import annotations

import dataclasses

import torch

from sph_bvf_tpu_torch.core.state import Params, State

TRANSPORT_VELOCITY = "transport_velocity"
MECHANICS = "mechanics"
FSI = "fsi"
BVF = "bvf"
ARTIFICIAL_STRESS = "artificial_stress"
ZHANG = "zhang"
STATIONARY = "stationary"


@dataclasses.dataclass(frozen=True)
class IntegratorConfig:
    variant: str = TRANSPORT_VELOCITY
    # XSPH velocity smoothing factor (mechanics/fsi: 0.001)
    xsph_factor: float = 0.0
    # fluid force ramp: damp = min(step/tdamp, 1) (mechanics/fsi: tdamp=1)
    tdamp: float = 0.0
    # solid release gate: dampSolid = 0 until step >= tdamp_solid
    tdamp_solid: float = 0.0
    # Shepard density-filter cadence (fsi disables it with 1e16)
    freq_filter: int = 20
    # mechanics/fsi use dtv (not dtf) in the unfiltered free-fluid density update
    density_dtv: bool = False

    def reads_rhoaux(self) -> bool:
        """Does final_integrate ever consume the Shepard-filter accumulators
        (rhoAux1/rhoAux2)?  When True the stepper still skips them on the
        steps between filter events (run_chunk's ``phase`` segmentation)."""
        return (
            self.variant in (TRANSPORT_VELOCITY, MECHANICS, FSI, ZHANG)
            and 0 < self.freq_filter <= 2**31 - 1
        )

    @staticmethod
    def transport_velocity(**kw):
        return IntegratorConfig(variant=TRANSPORT_VELOCITY, **kw)

    @staticmethod
    def mechanics(**kw):
        kw.setdefault("xsph_factor", 0.001)
        kw.setdefault("tdamp", 1.0)
        kw.setdefault("tdamp_solid", 1e6)
        kw.setdefault("density_dtv", True)
        return IntegratorConfig(variant=MECHANICS, **kw)

    @staticmethod
    def fsi(**kw):
        kw.setdefault("xsph_factor", 0.001)
        kw.setdefault("tdamp", 1.0)
        kw.setdefault("tdamp_solid", 1.0)
        kw.setdefault("freq_filter", int(1e16))
        kw.setdefault("density_dtv", True)
        return IntegratorConfig(variant=FSI, **kw)

    @staticmethod
    def bvf(**kw):
        return IntegratorConfig(variant=BVF, **kw)

    @staticmethod
    def artificial_stress(**kw):
        """fix ssa_tsdpd/bvf/artificialStress: the plain bvf scheme with
        phi, nw, vws and aws normalized by the number density before the
        phi > 0.5 gate and the wall reflections; not an alias of bvf, which
        uses the raw accumulators (only the final half's normalization is
        observable, see the JAX factory)."""
        return IntegratorConfig(variant=ARTIFICIAL_STRESS, **kw)

    @staticmethod
    def zhang(**kw):
        """fix ssa_tsdpd/bvf/zhang: free solids take the fluid scheme with a
        full-dtv deviatoric step, the bounce-back is the moving-wall
        reflection with vws/aws normalized by the number density, and the
        filtered density is the (sic) inverted ``rhoAux2 / min(rhoAux1,
        1)``, replicated as it is; not an alias of transport_velocity."""
        return IntegratorConfig(variant=ZHANG, **kw)

    @staticmethod
    def stationary(**kw):
        return IntegratorConfig(variant=STATIONARY, **kw)


def _masks(state: State):
    solid = state.solid_tag == 1
    fixed = state.fixed_tag == 1
    return (~fixed & ~solid), (~fixed & solid), (fixed & ~solid), (fixed & solid)


def _damps(state: State, cfg: IntegratorConfig, dtype):
    """Fluid ramp + solid release gate: 0 while ``tnow < tdamp_solid``
    (mechanics, fix...mechanics.cpp:152) or ``tnow <= tdamp_solid`` (fsi,
    fix...fsi.cpp:151); 1 for the transport-velocity variant."""
    one = torch.ones((), dtype=dtype, device=state.x.device)
    tnow = state.step.to(dtype)
    damp = torch.clamp_max(tnow / cfg.tdamp, 1.0) if cfg.tdamp > 0 else one
    if cfg.variant == MECHANICS:
        return damp, torch.where(tnow < cfg.tdamp_solid, 0.0, one)
    if cfg.variant == FSI:
        return damp, torch.where(tnow <= cfg.tdamp_solid, 0.0, one)
    return damp, one


def setup_pre_force(state: State) -> State:
    """vest = v; rhoI = rho."""
    return dataclasses.replace(state, vest=state.v, rhoI=state.rho)


def _clamped_species_halfstep(state: State, dtf):
    """C += Q dtf, clamped >= 0."""
    if state.C.shape[0] == 0:
        return state.C
    return torch.clamp_min(state.C + state.Q * dtf, 0.0)


def _clamped_ssa(state: State):
    """Cd += Qd, clamped >= 0."""
    if state.Cd.shape[0] == 0:
        return state.Cd
    return torch.clamp_min(state.Cd + state.Qd, 0)


def _zero(state: State):
    return torch.zeros((), dtype=state.x.dtype, device=state.x.device)


def initial_integrate(state: State, params: Params, cfg: IntegratorConfig) -> State:
    dtype = state.x.dtype
    zero = _zero(state)
    dtv = state.dt
    dtf = 0.5 * state.dt * params.ftm2v
    m = params.mass[state.ptype.long()]
    dtfm = (dtf / m)[None]  # [1, cap, NC] against vectors

    if cfg.variant == STATIONARY:
        # only rho (and C) advance
        return dataclasses.replace(
            state,
            rho=state.rho + dtf * state.drho,
            C=_clamped_species_halfstep(state, dtf),
        )

    free_fluid, free_solid, fixed_fluid, fixed_solid = _masks(state)
    ff = free_fluid[None]
    fs = free_solid[None]

    if cfg.variant in (BVF, ARTIFICIAL_STRESS):
        # one scheme for every free particle, and fixed fluids integrate too
        moving = (free_fluid | free_solid | fixed_fluid)[None]
        vest = torch.where(moving, state.v + 2.0 * dtfm * state.f, state.vest)
        v = torch.where(moving, state.v + dtfm * state.f, state.v)
        x = state.x + torch.where(moving, dtf * v, zero)
        S_dot = (free_solid | fixed_solid)[None, None]
        S = state.S + torch.where(S_dot, dtf * state.dS, zero)
        # every particle: rho += dtf drho (no rhoI bookkeeping)
        return dataclasses.replace(
            state,
            vest=vest,
            v=v,
            x=x,
            S=S,
            rho=state.rho + dtf * state.drho,
            C=_clamped_species_halfstep(state, dtf),
        )

    if cfg.variant == ZHANG:
        # every free particle (fluid and solid) and the fixed fluids take
        # the fluid scheme; free solids advance S by a full dtv
        moving = (free_fluid | free_solid | fixed_fluid)[None]
        vest = torch.where(moving, state.v + dtfm * state.f, state.vest)
        v = torch.where(moving, vest - dtfm * state.ddv, state.v)
        x = state.x + torch.where(moving, dtv * v, zero)
        S = state.S + torch.where(free_solid[None, None], dtv * state.dS, zero)
        adv = free_fluid | free_solid | fixed_fluid
        return dataclasses.replace(
            state,
            vest=vest,
            v=v,
            x=x,
            S=S,
            rhoI=torch.where(state.valid, state.rho, state.rhoI),
            rho=state.rho + torch.where(adv, dtf * state.drho, zero),
            C=_clamped_species_halfstep(state, dtf),
        )

    # --- transport_velocity / mechanics / fsi family -----------------------

    damp, damp_solid = _damps(state, cfg, dtype)
    nden = state.num_den[None]
    xsph = cfg.xsph_factor * state.ddx / nden if cfg.xsph_factor else 0.0

    # free fluid
    vest_fluid = state.v + dtfm * state.f * damp + xsph
    v_fluid = vest_fluid - dtfm * state.ddv

    # free solid
    vest_solid = (state.v + 2.0 * dtfm * state.f + xsph) * damp_solid
    v_solid = (state.v + dtfm * state.f) * damp_solid

    vest = torch.where(ff, vest_fluid, torch.where(fs, vest_solid, state.vest))
    v = torch.where(ff, v_fluid, torch.where(fs, v_solid, state.v))
    # positions: fluid moves dtv*v, solid dtf*v
    x = state.x + torch.where(ff, dtv * v, torch.where(fs, dtf * v, zero))

    # deviatoric half-step for free and fixed solids
    S_mask = (free_solid | fixed_solid)[None, None]
    S = state.S + torch.where(S_mask, dtf * state.dS, zero)

    # density: all free + fixed fluid advance; fixed solid only rhoI
    adv = free_fluid | free_solid | fixed_fluid
    rho = state.rho + torch.where(adv, dtf * state.drho, zero)

    return dataclasses.replace(
        state,
        vest=vest,
        v=v,
        x=x,
        S=S,
        rhoI=torch.where(state.valid, state.rho, state.rhoI),
        rho=rho,
        C=_clamped_species_halfstep(state, dtf),
    )


def _on_filter(state: State, cfg: IntegratorConfig) -> torch.Tensor:
    """Is this step on the Shepard-filter cadence?  A 0-dim bool tensor on
    the state's device; fsi's 1e16 cadence (past int32) means never."""
    if 0 < cfg.freq_filter <= 2**31 - 1:
        return (state.step % cfg.freq_filter) == 0
    return torch.zeros((), dtype=torch.bool, device=state.x.device)


def _reflect(v, nw):
    """2 max(0, v.en) en, the wall reflection's no-penetration term, with
    en = -nw/|nw| the wall normal."""
    norm = torch.sqrt(torch.sum(nw * nw, dim=0, keepdim=True))
    en = -nw / torch.clamp_min(norm, 1e-30)
    v_dot_en = torch.sum(v * en, dim=0, keepdim=True)
    return 2.0 * torch.clamp_min(v_dot_en, 0.0) * en


def _bounce_back(state: State, v, nw, dtv, phi_gate):
    """BVF wall reflection: rewind x, reflect v about the wall normal with a
    no-penetration correction, re-advance x, where ``phi_gate`` holds."""
    zero = _zero(state)
    v_ref = -v + _reflect(v, nw)
    g = phi_gate[None]
    new_v = torch.where(g, v_ref, v)
    # x_new = x - dtv*v + dtv*new_v  where gated
    new_x = state.x + torch.where(g, dtv * (new_v - v), zero)
    return new_v, new_x


def final_integrate(state: State, params: Params, cfg: IntegratorConfig) -> State:
    dtype = state.x.dtype
    zero = _zero(state)
    dtv = state.dt
    dtf = 0.5 * state.dt * params.ftm2v
    m = params.mass[state.ptype.long()]
    dtfm = (dtf / m)[None]

    if cfg.variant == STATIONARY:
        return dataclasses.replace(
            state,
            rho=state.rho + dtf * state.drho,
            C=_clamped_species_halfstep(state, dtf),
            Cd=_clamped_ssa(state),
        )

    free_fluid, free_solid, fixed_fluid, fixed_solid = _masks(state)

    if cfg.variant in (BVF, ARTIFICIAL_STRESS):
        return _final_integrate_bvf(
            state, dtv, dtf, dtfm, free_fluid, free_solid, fixed_fluid,
            fixed_solid, normalize=(cfg.variant == ARTIFICIAL_STRESS))

    if cfg.variant == ZHANG:
        return _final_integrate_zhang(
            state, cfg, dtv, dtf, dtfm, free_fluid, free_solid, fixed_fluid,
            fixed_solid)

    # --- transport_velocity / mechanics / fsi family -----------------------

    damp, damp_solid = _damps(state, cfg, dtype)
    nden = torch.clamp_min(state.num_den, 1e-30)

    # normalize phi/nw in place; these persist for computes/dumps
    phi = state.phi / nden
    nw = state.nw / nden[None]
    xsph = cfg.xsph_factor * state.ddx / nden[None] if cfg.xsph_factor else 0.0

    # BVF bounce-back for free fluid with phi > 0.5
    gate = free_fluid & (phi > 0.5)
    v_bb, x_bb = _bounce_back(state, state.v, nw, dtv, gate)

    # final velocities
    v_fluid = state.vest + dtfm * state.f * damp + xsph
    v_solid = (v_bb + dtfm * state.f + xsph) * damp_solid
    v = torch.where(free_fluid[None], v_fluid,
                    torch.where(free_solid[None], v_solid, v_bb))

    # final deviatoric half-step
    S_mask = (free_solid | fixed_solid)[None, None]
    S = state.S + torch.where(S_mask, dtf * state.dS, zero)

    # density update table; the cadence test stays on the device
    on_filter = _on_filter(state, cfg)
    aux = state.rhoAux1 / torch.clamp_min(state.rhoAux2, 1e-30)
    if cfg.variant == TRANSPORT_VELOCITY:
        rho_free_f = torch.where(on_filter, aux + dtf * state.drho,
                                 state.rhoI + dtf * state.drho)
        rho_free_s = rho_free_f
    else:  # mechanics / fsi (fix...mechanics.cpp:391-448)
        rho_free_f = torch.where(on_filter, aux + dtf * state.drho,
                                 state.rhoI + dtv * state.drho)
        rho_free_s = state.rhoI + dtv * state.drho
    rho_fixed_f = torch.where(on_filter, aux + dtv * state.drho,
                              state.rhoI + dtv * state.drho)
    rho_fixed_s = torch.where(on_filter, aux, state.rhoI)
    rho = torch.where(
        free_fluid, rho_free_f,
        torch.where(free_solid, rho_free_s,
                    torch.where(fixed_fluid, rho_fixed_f, rho_fixed_s)),
    )
    rho = torch.where(state.valid, rho, torch.ones((), dtype=dtype,
                                                   device=rho.device))

    return dataclasses.replace(
        state,
        x=x_bb,
        v=v,
        S=S,
        rho=rho,
        phi=phi,
        nw=nw,
        C=_clamped_species_halfstep(state, dtf),
        Cd=_clamped_ssa(state),
    )


def _final_integrate_bvf(state, dtv, dtf, dtfm, free_fluid, free_solid,
                         fixed_fluid, fixed_solid, normalize=False):
    """fix_ssa_tsdpd_bvf.cpp:218-358: plain Verlet and the moving-wall
    reflection.  Unlike the tv family, phi/nw are not normalized, the
    weighted solid velocity and acceleration enter the reflection raw,
    fixed fluids keep integrating v and x, and the bounce-back rewinds no
    position.  ``normalize`` (artificialStress): phi, nw, vws and aws are
    divided by the number density first, and persist so."""
    zero = _zero(state)
    if normalize:
        nden = torch.clamp_min(state.num_den, 1e-30)
        phi = state.phi / nden
        nw = state.nw / nden[None]
        vws = state.vws / nden[None]
        aws = state.aws / nden[None]
    else:
        phi, nw, vws, aws = state.phi, state.nw, state.vws, state.aws

    # free particles and fixed fluids: v += dtfm f; fixed fluids drift x
    moving = free_fluid | free_solid | fixed_fluid
    v = state.v + torch.where(moving[None], dtfm * state.f, zero)
    x = state.x + torch.where(fixed_fluid[None], dtf * v, zero)

    # free fluid: the moving-wall form; fixed fluid: the stationary one
    refl = _reflect(v, nw)
    v_ref_free = 2.0 * vws + aws * dtv - v + refl
    v_ref_fixed = -v + refl
    v = torch.where((free_fluid & (phi > 0.5))[None], v_ref_free, v)
    v = torch.where((fixed_fluid & (phi > 0.5))[None], v_ref_fixed, v)

    S_mask = (free_solid | fixed_solid)[None, None]
    S = state.S + torch.where(S_mask, dtf * state.dS, zero)
    rho = state.rho + dtf * state.drho
    one = torch.ones((), dtype=rho.dtype, device=rho.device)
    persist = dict(phi=phi, nw=nw, vws=vws, aws=aws) if normalize else {}
    return dataclasses.replace(
        state,
        v=v,
        x=x,
        S=S,
        rho=torch.where(state.valid, rho, one),
        C=_clamped_species_halfstep(state, dtf),
        Cd=_clamped_ssa(state),
        **persist,
    )


def _final_integrate_zhang(state, cfg, dtv, dtf, dtfm, free_fluid, free_solid,
                           fixed_fluid, fixed_solid):
    """fix_ssa_tsdpd_bvf_zhang.cpp:246-443: the tv family's final kicks with
    the moving-wall reflection (vws/aws normalized by the number density,
    no position rewind), no deviatoric update for free solids (fixed ones
    advance by dtf) and the (sic) filtered density
    ``rhoAux2 / min(rhoAux1, 1) + dtf drho``, ``rhoI + dtv drho`` off the
    cadence."""
    zero = _zero(state)
    nden = torch.clamp_min(state.num_den, 1e-30)
    phi = state.phi / nden
    nw = state.nw / nden[None]
    vws = state.vws / nden[None]
    aws = state.aws / nden[None]

    moving = free_fluid | free_solid | fixed_fluid
    v = torch.where(moving[None], state.vest + dtfm * state.f, state.v)
    refl = _reflect(v, nw)
    v = torch.where((free_fluid & (phi > 0.5))[None],
                    2.0 * vws + aws * dtv - v + refl, v)
    v = torch.where((fixed_fluid & (phi > 0.5))[None], -v + refl, v)

    S = state.S + torch.where(fixed_solid[None, None], dtf * state.dS, zero)

    on_filter = _on_filter(state, cfg)
    aux = state.rhoAux2 / torch.clamp_max(state.rhoAux1, 1.0)
    rho_free = torch.where(on_filter, aux + dtf * state.drho,
                           state.rhoI + dtv * state.drho)
    rho = torch.where(
        free_fluid | free_solid, rho_free,
        torch.where(fixed_fluid, state.rhoI + dtv * state.drho, state.rhoI),
    )
    one = torch.ones((), dtype=rho.dtype, device=rho.device)
    return dataclasses.replace(
        state,
        v=v,
        S=S,
        rho=torch.where(state.valid, rho, one),
        phi=phi,
        nw=nw,
        vws=vws,
        aws=aws,
        C=_clamped_species_halfstep(state, dtf),
        Cd=_clamped_ssa(state),
    )
