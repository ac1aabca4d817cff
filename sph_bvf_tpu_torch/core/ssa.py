"""Stochastic (SSA) reaction-diffusion of integer species counts (PyTorch).

Port of ``sph_bvf_tpu/core/ssa.py``; the reference citations and the
re-derivation's reasoning are on the JAX module's lines.

* **Diffusion**: each directed pair (i -> j) draws its hop count in dt from
  a truncated Poisson of mean kappaSSA * (-dQc_base) * Cd_i * dt, keyed by
  a counter-based hash of (seed, step, tag_i, tag_j, species), so both
  endpoints draw the same count and molecules are conserved without a
  scatter.  The draws run in the pair pass (``ops/pair._qd_hops``); Cd is
  clamped at 0 after Qd is applied (``core/integrate._clamped_ssa``).
* **Reactions**: an exact per-particle Gillespie loop of at most
  ``max_reaction_events`` events a step over the mass-action propensities
  of fix ssa_tsdpd/ssa_rxn_mass_action, with counter-based uniforms per
  (particle, step, event).

Every uniform comes from ``ops/rand.uniform_01``, bitwise the JAX
package's, so the same state and key give the same counts.  The key is the
JAX package's two uint32 words held as int64 (``bridge.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from sph_bvf_tpu_torch.core.state import GROUP_ALL, Geometry, Params, State
from sph_bvf_tpu_torch.ops import rand
from sph_bvf_tpu_torch.utils.profiler import sync

_MASK = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class SsaReaction:
    """One mass-action channel (fix ssa_tsdpd/ssa_rxn_mass_action)."""

    k_rate: float
    reactants: Tuple[int, ...] = ()  # at most 2
    products: Tuple[int, ...] = ()  # at most 4
    groupbit: int = GROUP_ALL

    def __post_init__(self):
        assert len(self.reactants) <= 2 and len(self.products) <= 4


@dataclasses.dataclass(frozen=True)
class SsaConfig:
    reactions: Tuple[SsaReaction, ...] = ()
    max_reaction_events: int = 16  # exact while events/step below this bound
    poisson_terms: int = 6  # diffusion hop-count truncation order
    rng_seed: int = 0


def poisson_hash(mu, terms: int, *words):
    """Truncated-Poisson sample via CDF inversion from one hashed uniform
    (int32, ``mu``'s shape); exact for outcomes < ``terms``."""
    u = rand.uniform_01(*words)
    mu = torch.as_tensor(mu)
    term = torch.exp(-mu)  # P(N=0)
    cdf = term
    n = torch.zeros(mu.shape, dtype=torch.int32, device=mu.device)
    for m in range(1, terms):
        n = n + (u > cdf).to(torch.int32)
        term = term * mu / m
        cdf = cdf + term
    return n


def pair_hop_counts(mu, seed, step, tag_src, tag_dst, species, terms):
    """Hops src -> dst in dt; both endpoints reconstruct the same value."""
    return poisson_hash(mu, terms, seed, step, tag_src, tag_dst,
                        (torch.as_tensor(species) + 0xD1F) & _MASK)


# ---------------------------------------------------------------------------
# Reactions (per-particle exact SSA, bounded event loop)
# ---------------------------------------------------------------------------


def _propensities(Cd, volume, groupmask, cfg: SsaConfig, dtype):
    """[R, cap, NC] mass-action propensities (reference :101-144)."""
    zero = torch.zeros((), dtype=dtype, device=Cd.device)
    props = []
    for rx in cfg.reactions:
        if len(rx.reactants) == 0:
            a = rx.k_rate * volume
        elif len(rx.reactants) == 1:
            a = rx.k_rate * Cd[rx.reactants[0]].to(dtype)
        else:
            r0, r1 = rx.reactants
            c0 = Cd[r0].to(dtype)
            if r0 == r1:
                a = rx.k_rate / volume / 2.0 * c0 * (c0 - 1.0)
            else:
                a = rx.k_rate / volume * c0 * Cd[r1].to(dtype)
        a = torch.where((groupmask & rx.groupbit) != 0, a, zero)
        props.append(torch.clamp_min(a, 0.0))
    return torch.stack(props, dim=0)


def _stoich_table(cfg: SsaConfig, n_species: int, device=None):
    """[R, n_species] int32: each channel's change of every count.  Its
    copy to the card waits for the stream (a pageable host-to-device
    copy): ``host_sync.stoich_table``."""
    st = np.zeros((len(cfg.reactions), n_species), np.int32)
    for r, rx in enumerate(cfg.reactions):
        if len(rx.reactants) == 2 and rx.reactants[0] == rx.reactants[1]:
            st[r, rx.reactants[0]] -= 2
        else:
            for s in rx.reactants:
                st[r, s] -= 1
        for s in rx.products:
            st[r, s] += 1
    with sync("stoich_table"):
        return torch.as_tensor(st, device=device)


def ssa_reactions(state: State, params: Params, cfg: SsaConfig) -> State:
    """Exact per-particle Gillespie within one dt (reference :420-458);
    touches only ``Cd``."""
    if not cfg.reactions or state.Cd.shape[0] == 0:
        return state
    dtype = state.x.dtype
    R = len(cfg.reactions)
    stoichT = _stoich_table(cfg, state.Cd.shape[0], state.Cd.device).T  # [S, R]
    volume = params.mass[state.ptype.long()] / state.rho
    dt = state.dt
    seed_w = (cfg.rng_seed & _MASK) ^ rand.seed_word(state.key)

    # every event's two uniforms in one draw each: [events, cap, NC]
    events = torch.arange(cfg.max_reaction_events, dtype=torch.int64,
                          device=state.Cd.device)[:, None, None]
    u1s, u2s = (rand.uniform_01(seed_w, state.step, state.tag, events,
                                salt).to(dtype) for salt in (1, 2))

    Cd = state.Cd
    tt = torch.zeros(Cd.shape[1:], dtype=dtype, device=Cd.device)
    alive = state.valid
    for e in range(cfg.max_reaction_events):
        a = _propensities(Cd, volume, state.groupmask, cfg, dtype)  # [R, ...]
        a0 = torch.sum(a, dim=0)
        has = a0 > 0.0
        tt_next = tt - torch.log(1.0 - u1s[e]) / torch.clamp_min(a0, 1e-300)
        fire = alive & has & (tt_next < dt)
        # channel selection: the first r with cumsum(a) > u2 * a0
        csum = torch.cumsum(a, dim=0)
        idx = torch.sum((csum <= (u2s[e] * a0)[None]).to(torch.int32), dim=0)
        idx = torch.clamp_max(idx, R - 1)
        delta = stoichT[:, idx.long()]  # [S, ...]
        Cd = torch.where(fire[None], Cd + delta, Cd)
        tt = torch.where(alive & has, tt_next, tt)
        alive = fire
    return dataclasses.replace(state, Cd=torch.clamp_min(Cd, 0))


def ssa_step(state: State, params: Params, geom: Geometry, cfg: SsaConfig) -> State:
    """Reactions after final_integrate (the diffusion's Qd is drawn in the
    pair pass, as the reference draws it in Pair::compute).

    Neither the reactions nor the diffusion writes ``valid``, so the slots
    stay compacted for the rebin moves' row stop (K5 stops at the first
    slot row empty in every source cell); ``delete_atoms`` acts on the host
    before the build."""
    return ssa_reactions(state, params, cfg)
