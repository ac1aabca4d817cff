"""SPH-BVF pair physics, plain PyTorch path (port of ``sph_bvf_tpu/ops/pair.py``).

Full-neighbour (newton-off) reductions over the cell-slot layout: every
particle sums its pair terms over the candidates of its 3^dim stencil cells,
so no scatter-adds are needed.  Pair blocks are ``[ci, cj, NC]`` with
components leading; reductions run over the cj axis.

``compute_forces`` sends pass A through ``ops/pair_cuda.pass_a``: the
hand-written kernel the grid routes to (K1, K4 or K2 in 2D, K3 in 3D) on a
CUDA tensor, the stencil loop below (``_pass_a_plain``, over 3^dim offsets) on a
CPU tensor.  The loop is also the reference the kernels are checked against
on the card.

Ported: every branch of the JAX module.  The transport-velocity pair
style with the Sun-2018 pressure switch (the flagship lid-driven cavity),
the mechanics pair style (the FSI beam) and the fsi pair style (cell
polarization: mechanics plus the density diffusion ``ampl_damp`` and the
species-softened shear modulus ``g0_chem_coupling``): the symmetric
pressure force, XSPH, BVF walls of fixed solids, free solids with the
Pereira artificial viscosity, elastic solids (the 9-component artificial
stress, the deviatoric solid force and the Jaumann stress rate), periodic
axes, with and without the Shepard-filter accumulators, continuum species
transport (the tSDPD flux ``Q`` of ``C``, with its own support ``cutc``
and the transport-velocity advection correction), the SDPD thermal noise
(``thermal``: the pair-symmetric random force of counter-based draws,
``ops/rand.py``), the stochastic species' hop balance ``Qd`` (SSA,
``core/ssa.py``) and the weighted-solid pass B (``vws``/``aws``, sweep 3).

SSA on the card takes the JAX package's kernel split: the pass-A kernel
computes the mechanics and ``_pass_a_qd``, a stencil loop of torch ops,
draws Qd with the counter streams of ``_qd_hops``; on the CPU the plain
pass draws them inline.  Pass B is torch ops on both devices.
"""

from __future__ import annotations

import dataclasses

import torch

from sph_bvf_tpu_torch.core.halo import SlabGeometry, ghost_slabs, wrap_x
from sph_bvf_tpu_torch.core.state import Geometry, Params, State, shift_cells
from sph_bvf_tpu_torch.ops import rand
from sph_bvf_tpu_torch.ops.eos import tait_pressure
from sph_bvf_tpu_torch.ops.kernels import ipow, lucy_w, lucy_w_ih, lucy_wfd_ih
from sph_bvf_tpu_torch.parallel.mesh import plane_cells, slab_of

TRANSPORT_VELOCITY = "transport_velocity"
MECHANICS = "mechanics"
FSI = "fsi"


@dataclasses.dataclass(frozen=True)
class PairConfig:
    """Static physics-variant switches — every field of the JAX package's
    ``PairConfig``, so a configuration copies across unchanged (see the JAX
    module for the reference citation of each)."""

    variant: str = TRANSPORT_VELOCITY
    dim: int = 2
    thermal: bool = False
    pressure_switch: bool = True
    xsph: bool = False
    art_stress_coef: float = 0.35
    art_stress_abs_p: bool = False
    wdelta_ratio: float = 2.6
    ampl_damp: float = 0.0
    g0_chem_coupling: bool = False
    species_advection: bool = True
    store_pnew: bool = False
    weighted_solid_skip_fixed: bool = False
    weighted_solid: bool = True
    # accepted and ignored: the port has no Pallas kernels to select
    use_pallas: bool = True
    solids_present: bool = True
    elastic_present: bool = True
    free_solids_present: bool = True
    rng_seed: int = 0
    ssa_poisson_terms: int = 6
    ssa_kernel_split: bool = False
    # K4 (the window in shared memory) in place of K1: ops/pair_cuda.route
    preshift_window: bool = False
    # accumulate the Shepard-filter inputs rhoAux1/rhoAux2 this step?
    # The stepper turns this off on the steps between filter events.
    density_filter_accs: bool = True
    # coefficient tables whose [T, T] entries are all equal (bit-exact
    # scalar in place of the per-pair gather)
    uniform_tables: tuple = ()

    @staticmethod
    def transport_velocity(dim=2, **kw):
        return PairConfig(variant=TRANSPORT_VELOCITY, dim=dim, **kw)

    @staticmethod
    def mechanics(dim=2, **kw):
        return PairConfig(
            variant=MECHANICS, dim=dim, pressure_switch=False, xsph=True,
            art_stress_abs_p=True, wdelta_ratio=3.0, species_advection=False,
            store_pnew=True, weighted_solid_skip_fixed=True, **kw,
        )

    @staticmethod
    def fsi(dim=2, **kw):
        return PairConfig(
            variant=FSI, dim=dim, pressure_switch=False, xsph=True,
            art_stress_coef=0.1, wdelta_ratio=3.0, ampl_damp=0.1,
            g0_chem_coupling=True, species_advection=False, store_pnew=True,
            weighted_solid_skip_fixed=True, **kw,
        )


# ---------------------------------------------------------------------------
# per-particle precomputation
# ---------------------------------------------------------------------------


def _per_particle(state: State, params: Params, cfg: PairConfig):
    """Fields every pair term needs, computed once per particle [*, cap, NC]."""
    t = state.ptype
    m = params.mass[t]
    B = params.B[t]
    rho0 = params.rho0[t]
    G0 = params.G0[t]
    if cfg.g0_chem_coupling and state.C.shape[0] > 0:
        # fsi softens the shear modulus with the first species
        # (pair...fsi.cpp:441-445)
        G0 = G0 * (1.0 - 0.99 * state.C[0])
    P = tait_pressure(state.rho, rho0, B)
    inv_rho = 1.0 / state.rho
    m_rho = m * inv_rho
    V2 = m_rho * m_rho
    P_rho2 = P * inv_rho * inv_rho  # pressure force term, hoisted per particle
    solid = state.solid_tag == 1
    zero = torch.zeros((), dtype=P.dtype, device=P.device)
    # Monaghan artificial stress (tensile components of S - p delta only)
    p_for_as = torch.abs(P) if cfg.art_stress_abs_p else P
    inv_rho2 = inv_rho * inv_rho

    def tensile(total):
        return torch.where(solid & (total > 0.0),
                           -cfg.art_stress_coef * total * inv_rho2, zero)

    if cfg.elastic_present:
        stress = dict(AS=torch.stack([
            torch.stack([tensile(state.S[a, b] - (p_for_as if a == b else 0.0))
                         for b in range(3)])
            for a in range(3)]))
    else:
        # with S == 0 the tensor is diagonal, total = -p delta, tensile iff
        # p < 0 — one scalar row
        stress = dict(ASd=tensile(-p_for_as))
    return dict(
        valid=state.valid, x=state.x, v=state.v, vest=state.vest,
        rho=state.rho, rhoI=state.rhoI, e=state.e, C=state.C, Cd=state.Cd,
        S=state.S, tag=state.tag, ptype=t,
        solid=solid, fluid=~solid, fixed=state.fixed_tag == 1, m=m, B=B, c0=params.c0[t], G0=G0, P=P,
        P_rho2=P_rho2, inv_rho=inv_rho, m_rho=m_rho, V2=V2, **stress,
    )


def _bc(a, side):
    """Broadcast a per-particle field [*, cap, NC] to pair shape.

    side "i": [*, ci, 1, NC];  side "j": [*, 1, cj, NC].
    """
    return a[..., :, None, :] if side == "i" else a[..., None, :, :]


def _dot3(a, b):
    """Dot over the leading component axis: [3, ...] x [3, ...] -> [...]."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _pair_delta(xi, xj, pbc):
    """x_i - x_j with minimum-image correction on periodic axes
    (``pbc``: static tuple of (axis, extent))."""
    dx = xi - xj
    if not pbc:
        return dx
    comps = [dx[0], dx[1], dx[2]]
    for ax, ext in pbc:
        comps[ax] = comps[ax] - ext * torch.round(comps[ax] / ext)
    return torch.stack(comps, dim=0)


def _xdot_tensor(dx, T):
    """out[m] = sum_k dx[k] T[k, m] — unrolled over the tiny component dims."""
    return torch.stack(
        [sum(dx[k] * T[k, m] for k in range(3)) for m in range(3)], dim=0
    )


def _pbc(geom: Geometry):
    return tuple(
        (ax, geom.hi[ax] - geom.lo[ax])
        for ax in range(3)
        if geom.periodic[ax] and geom.ncells[ax] > 1
    )


def coeff_tables(params: Params, cfg: PairConfig):
    """[T, T] tables of every per-type-pair quantity the pair pass needs
    (divisions and kernel normalizations hoisted out of the pair loop)."""
    safe = lambda x: torch.where(x > 0, x, 1.0)
    h = params.cut
    out = dict(
        h=h,
        eta=params.visc,
        hc=params.cutc,
        inv_h=1.0 / safe(h),
        inv_hc=1.0 / safe(params.cutc),
        m_harm=params.mass[:, None] * params.mass[None, :]
        / safe(params.mass[:, None] + params.mass[None, :]),
    )
    if cfg.solids_present:
        # keep 1/wdelta (not its 4th power): (wf * inv_wdelta)**4 stays O(1)
        wdelta = lucy_w(h / cfg.wdelta_ratio, safe(h), cfg.dim)
        out["inv_wdelta"] = 1.0 / safe(wdelta)
    if cfg.elastic_present and not cfg.g0_chem_coupling:
        out["geff"] = (
            2.0 * params.G0[:, None] * params.G0[None, :]
            / (params.G0[:, None] + params.G0[None, :] + 1e-12)
        )
    return out


def used_table_names(params: Params, cfg: PairConfig, ssa: bool = True) -> tuple:
    """The coeff_tables entries `_pass_a_offset` reads under this config."""
    names = ["h", "inv_h", "eta"]
    if params.n_sdpd > 0 or (params.n_ssa > 0 and ssa):
        names += ["hc", "inv_hc", "m_harm"]
    if cfg.solids_present:
        names.append("inv_wdelta")
    if cfg.elastic_present and not cfg.g0_chem_coupling:
        names.append("geff")
    return tuple(names)


def lookup_pair_coeffs(ti, tj, params: Params, cfg: PairConfig):
    """Gather the per-type-pair tables for pair-shaped type indices.

    Uniform tables (cfg.uniform_tables) come back as 0-dim tensors —
    bit-exact with the gather, since every entry equals table[0, 0]."""
    tp = (ti * params.ntypes + tj).long()
    tabs = coeff_tables(params, cfg)
    out = {
        k: tabs[k].reshape(-1)[0]
        if k in cfg.uniform_tables
        else tabs[k].reshape(-1)[tp]
        for k in used_table_names(params, cfg)
    }
    if params.n_sdpd > 0:
        # [Ns, ci, cj, NC]: the species diffusivity of each pair's types
        out["kap"] = params.kappa.movedim(-1, 0).reshape(params.n_sdpd, -1)[:, tp]
    if params.n_ssa > 0:
        # [Nssa, ci, cj, NC]: kappaSSA of each pair's types
        out["kss"] = params.kappa_ssa.movedim(-1, 0).reshape(params.n_ssa, -1)[:, tp]
    return out


# ---------------------------------------------------------------------------
# pass A: fused sweeps 1 + 2
# ---------------------------------------------------------------------------


def _pass_a_dS(I, J, coeffs, cfg: PairConfig, dx, wfd):
    """Jaumann deviatoric stress-rate pair term (pair...mechanics.cpp:433-451)
    for one stencil offset, reduced over cj: [3, 3, ci, NC].  Exactly zero
    for every i that is not a solid with G0 > 0 or S != 0."""
    dvest = J["vest"] - I["vest"]
    # strain/rotation: 0.5 (mj/rhoj) wfd (dvest[m] dx[n] +/- dvest[n] dx[m])
    pref = 0.5 * J["m_rho"] * wfd
    if cfg.g0_chem_coupling:
        # per-pair harmonic mean of the softened per-particle moduli
        geff = 2.0 * I["G0"] * J["G0"] / (I["G0"] + J["G0"] + 1e-12)
    else:
        geff = coeffs["geff"]
    two_geff = 2.0 * geff
    outer = [[dvest[a] * dx[b] for b in range(3)] for a in range(3)]
    strain = [[pref * (outer[a][b] + outer[b][a]) for b in range(3)]
              for a in range(3)]
    rot = [[pref * (outer[a][b] - outer[b][a]) for b in range(3)]
           for a in range(3)]
    Si = I["S"]
    zero = torch.zeros((), dtype=wfd.dtype, device=wfd.device)
    rows = []
    for mm in range(3):
        cols = []
        for nn in range(3):
            el = two_geff * strain[mm][nn] * (1.0 if mm != nn else (1.0 - 1.0 / 3.0))
            sdr = sum(Si[mm, k] * rot[nn][k] for k in range(3))
            rds = sum(rot[mm][k] * Si[k, nn] for k in range(3))
            cols.append(torch.sum(torch.where(I["solid"], el + sdr + rds, zero),
                                  dim=-2))
        rows.append(torch.stack(cols))
    return torch.stack(rows)


def _pass_a_offset(I, J, coeffs, params: Params, cfg: PairConfig, notself,
                   acc, pbc=(), dt=None, step=None, seed=None):
    """Accumulate all sweep-1/2 terms for one stencil offset into ``acc``.

    The ported branches of the JAX function of the same name, term for term
    and in the same order (reference citations there).  ``dt``, ``step`` and
    ``seed`` (device tensors) feed the thermal noise only; with a ``vir``
    entry in ``acc`` it also sums the pairwise virial."""
    fdt = I["x"].dtype
    dim = cfg.dim
    RED = -2  # the cj axis of a scalar pair block
    zero = torch.zeros((), dtype=fdt, device=I["x"].device)

    h = coeffs["h"]
    inv_h = coeffs["inv_h"]
    dx = _pair_delta(I["x"], J["x"], pbc)  # [3, ci, cj, NC]
    rsq = _dot3(dx, dx)
    r = torch.sqrt(rsq)

    mask = (I["valid"] & J["valid"] & notself).to(fdt)
    wfd = lucy_wfd_ih(r, inv_h, dim) * mask
    wf = lucy_w_ih(r, inv_h, dim) * mask
    wfBvf = wf

    mi, mj = I["m"], J["m"]
    rhoi, rhoj = I["rho"], J["rho"]
    Vi2, Vj2 = I["V2"], J["V2"]
    solid_i, solid_j = I["solid"], J["solid"]

    # ---- sweep 1 ----------------------------------------------------------
    acc["num_den"] += torch.sum(Vj2 * wfBvf, dim=RED)
    if cfg.density_filter_accs:
        acc["rhoAux1"] += torch.sum(J["rhoI"] * wfBvf, dim=RED)
        acc["rhoAux2"] += torch.sum(wfBvf, dim=RED)
    # background-pressure velocity correction, Adami 2013
    ddv_coef = 10.0 * 7.0 * I["B"] * (Vi2 + Vj2) * wfd
    acc["ddv"] += torch.sum(ddv_coef[None] * dx, dim=RED)
    if cfg.xsph:
        dvest_ji = J["vest"] - I["vest"]
        acc["ddx"] += torch.sum((Vj2 * wf)[None] * dvest_ji, dim=RED)

    # ---- sweep 2 ----------------------------------------------------------
    velvec = I["vest"] - J["vest"]  # momentum-velocity difference
    delVdotDelR = _dot3(dx, velvec)

    # transport tensor force
    b_i_dot_dx = _dot3(I["v"] - I["vest"], dx)
    b_j_dot_dx = _dot3(J["v"] - J["vest"], dx)
    tdotx = 0.5 * (
        (rhoi * b_i_dot_dx)[None] * I["vest"]
        + (rhoj * b_j_dot_dx)[None] * J["vest"]
    )
    ftransport = ((Vi2 + Vj2) * wfd)[None] * tdotx

    # inter-particle viscosity, Adami 2013
    fvisc = (Vi2 + Vj2) * coeffs["eta"] * wfd

    # pressure force, Zhang 2017 (+ Sun 2018 switch in the tv variant)
    fi_term = I["P_rho2"]
    fj_term = J["P_rho2"]
    pij = fj_term + fi_term
    if cfg.pressure_switch:
        sgn = torch.where((pij >= 0.0) | (solid_i & solid_j), 1.0, -1.0)
        fpair = mi * mj * (fj_term + sgn * fi_term) * wfd
    else:
        fpair = mi * mj * pij * wfd

    # SDPD thermal random force
    if cfg.thermal:
        f_random = _thermal_force(I, J, dx, r, h, wfd, params, cfg, dt, step,
                                  seed)

    # artificial-stress force: mi mj wfd (wf/wdelta)^4 dx.(AS_i + AS_j)
    if cfg.solids_present:
        as_coef = mi * mj * wfd * ipow(wf * coeffs["inv_wdelta"], 4)
        if cfg.elastic_present:
            f_art = as_coef[None] * _xdot_tensor(dx, I["AS"] + J["AS"])
        else:
            # diagonal tensor: x.(AS_i+AS_j) = (as_i+as_j) dx
            f_art = (as_coef * (I["ASd"] + J["ASd"]))[None] * dx
    else:
        f_art = 0.0

    f_fluid = (-fpair)[None] * dx + fvisc[None] * velvec + ftransport + f_art
    if cfg.thermal:
        f_fluid = f_fluid + f_random

    if cfg.solids_present and cfg.free_solids_present:
        # solid-branch force
        if cfg.elastic_present:
            inv_i = I["inv_rho"] * I["inv_rho"]
            inv_j = J["inv_rho"] * J["inv_rho"]
            Ssum = I["S"] * inv_i[None, None] + J["S"] * inv_j[None, None]
            f_dev = (mi * mj * wfd)[None] * _xdot_tensor(dx, Ssum)
        else:
            f_dev = 0.0
        # Pereira 2017 artificial viscosity for solids
        mu = h * delVdotDelR / (rsq + 0.01 * h * h)
        fviscs = torch.where(
            delVdotDelR < 0.0,
            mi * mj * wfd * (-(I["c0"] + J["c0"]) * mu + 2.0 * mu * mu)
            / (rhoi + rhoj),
            zero,
        )
        f_solid = (-fpair - fviscs)[None] * dx + f_dev + f_art
        fsum = torch.where(solid_i[None], f_solid, f_fluid)
    else:
        # every solid is fixed, so its force is discarded
        fsum = f_fluid
    acc["f"] += torch.sum(fsum, dim=RED)
    if "vir" in acc:
        # pairwise virial r_ij . f_ij (each pair appears twice over i)
        acc["vir"] += torch.sum(_dot3(dx, fsum), dim=RED)

    # Jaumann deviatoric stress rate
    if cfg.elastic_present:
        acc["dS"] += _pass_a_dS(I, J, coeffs, cfg, dx, wfd)

    # density evolution, "new density formulation"
    dvt = I["v"] - J["v"]  # transport-velocity difference
    delVtdotDelR = _dot3(dx, dvt)
    corr_i = rhoi * _dot3(I["vest"] - I["v"], dx)
    corr_j = rhoj * _dot3(J["vest"] - J["v"], dx)
    m_rho_j = J["m_rho"]
    drho = rhoi * delVtdotDelR * wfd * m_rho_j
    if cfg.ampl_damp != 0.0:
        # density diffusion of the fsi pair style (pair...fsi.cpp:535), with
        # rhoi (rhoj/rhoi - 1) / rhoj rewritten as (rhoj - rhoi) m_rho_j / mj
        drho = drho - (
            cfg.ampl_damp
            * h
            * I["c0"]
            * 2.0
            * (rhoj - rhoi)
            * (rsq / (rsq + 0.01 * h * h))
            * wfd
            * m_rho_j
        )
    drho = drho - m_rho_j * (corr_i + corr_j) * wfd
    acc["drho"] += torch.sum(drho, dim=RED)

    # energy accumulation
    acc["de"] += torch.sum(
        -0.5 * (fpair * delVdotDelR + fvisc * _dot3(velvec, velvec)), dim=RED
    )

    # BVF volume fraction and wall normal
    if cfg.solids_present:
        fs = (I["fluid"] & solid_j).to(fdt)
        acc["phi"] += torch.sum(fs * Vj2 * wfBvf, dim=RED)
        acc["nw"] += torch.sum((fs * wfd * Vj2)[None] * dx, dim=RED)

    # species transport, Tartakovsky 2007; its own support cutc.  The "Qd"
    # key: the plain pass draws the SSA hops inline; the kernels carry no
    # Qd, and ``_pass_a_qd`` draws them after the kernel
    want_qd = params.n_ssa > 0 and "Qd" in acc
    if params.n_sdpd > 0 or want_qd:
        hc = coeffs["hc"]
        wfd_c = lucy_wfd_ih(r, coeffs["inv_hc"], dim) * mask
        dQc_base = (
            2.0
            * coeffs["m_harm"]
            * (I["inv_rho"] + J["inv_rho"])
            * rsq
            * wfd_c
            / (rsq + 0.01 * hc * hc)
        )
    if params.n_sdpd > 0:
        dQ = coeffs["kap"] * (I["C"] - J["C"]) * dQc_base[None]
        if cfg.species_advection:
            # advection correction (transport velocity only):
            # -(mj/rhoj) (C_i (vest_i-v_i).dx + C_j (vest_j-v_j).dx) wfd_c
            corr_ip = _dot3(I["vest"] - I["v"], dx)
            corr_jp = _dot3(J["vest"] - J["v"], dx)
            dQ = dQ - (J["m_rho"] * wfd_c)[None] * (
                I["C"] * corr_ip[None] + J["C"] * corr_jp[None]
            )
        acc["Q"] += torch.sum(dQ, dim=RED)

    # stochastic diffusion hops (core/ssa.py)
    if want_qd:
        acc["Qd"] += torch.sum(
            _qd_hops(I, J, coeffs, params, cfg, dt, step, seed, dQc_base),
            dim=RED).to(torch.int32)
    return acc


def _qd_hops(I, J, coeffs, params: Params, cfg: PairConfig, dt, step, seed,
             dQc_base):
    """Per-offset stochastic hop balance [n_ssa, ci, cj, NC] (int32), the
    counter-based tau-leap of the reference's D-matrix fill and serial
    Gillespie (pair...transport_velocity.cpp:739-809); the caller reduces
    over cj.  Shared by the plain pass and ``_pass_a_qd``, so both draw the
    same streams."""
    from sph_bvf_tpu_torch.core.ssa import pair_hop_counts

    fdt = dQc_base.dtype
    lam = coeffs["kss"] * (-dQc_base)[None] * dt  # per-molecule hop rate
    sp = torch.arange(params.n_ssa, dtype=torch.int64,
                      device=dQc_base.device).reshape(
        (params.n_ssa,) + (1,) * dQc_base.ndim)
    seed_w = (cfg.rng_seed & 0xFFFFFFFF) ^ seed
    n_out = pair_hop_counts(lam * I["Cd"].to(fdt), seed_w, step,
                            I["tag"], J["tag"], sp, cfg.ssa_poisson_terms)
    n_in = pair_hop_counts(lam * J["Cd"].to(fdt), seed_w, step,
                           J["tag"], I["tag"], sp, cfg.ssa_poisson_terms)
    return n_in - n_out


def _dqc_base(I, J, coeffs, cfg: PairConfig, pbc, notself):
    """(dQc_base, the pair mask) of one offset: the species-transport
    pair factor 2 m_harm (1/rho_i + 1/rho_j) r^2 W'_c / (r^2 + 0.01 hc^2)
    over the support cutc."""
    dx = _pair_delta(I["x"], J["x"], pbc)
    rsq = _dot3(dx, dx)
    r = torch.sqrt(rsq)
    mask = (I["valid"] & J["valid"] & notself).to(dx.dtype)
    wfd_c = lucy_wfd_ih(r, coeffs["inv_hc"], cfg.dim) * mask
    hc = coeffs["hc"]
    return (2.0 * coeffs["m_harm"] * (I["inv_rho"] + J["inv_rho"]) * rsq
            * wfd_c / (rsq + 0.01 * hc * hc))


def _pass_a_qd(pf: dict, params: Params, geom: Geometry, cfg: PairConfig,
               noise, max_pair_slots: int = 1 << 25) -> torch.Tensor:
    """Qd [n_ssa, cap, NC] (int32) alone: the SSA hop draws in torch ops,
    run after a pass-A kernel computed the mechanics (the JAX package's
    kernel split, ``ops/pair.py:1050-1057`` there).  The stencil's offsets
    are laid side by side along the candidate axis, so one pass of ops
    draws them all, over target cells in pieces of at most
    ``max_pair_slots`` pairs.  Each pair's draw is the plain pass's and
    the sums are of integers, so Qd is bitwise the plain pass's.
    ``noise``: the state's (dt, step, key).  On a mesh's slab (``geom`` a
    ``halo.SlabGeometry``, ``pf`` the ghosted slab's) the targets are the
    slab's own cells, as in ``_pass_a_plain``; the draws are keyed by the
    pair's tags, so they are the unsharded pass's.  ``_pass_a_qd.calls``
    counts its calls."""
    cap, NC_in = pf["rho"].shape
    dev = pf["x"].device
    first, NC = _own_cells(geom, NC_in)
    dt, step, key = noise
    seed = rand.seed_word(key)
    offsets = geom.stencil_offsets()
    pbc = _pbc(geom)
    # the zero offset's self pairs, side by side with the other offsets'
    notself = torch.cat([
        ~torch.eye(cap, dtype=torch.bool, device=dev) if off == (0, 0, 0)
        else torch.ones((cap, cap), dtype=torch.bool, device=dev)
        for off in offsets], dim=1)[:, :, None]
    J_all = {k: torch.cat([shift_cells(pf[k], off, geom) for off in offsets],
                          dim=-2)
             for k in _QD_FIELDS}
    piece = max(1, max_pair_slots // (cap * cap * len(offsets)))
    qd = torch.empty((params.n_ssa, cap, NC), dtype=torch.int32, device=dev)
    for c in range(0, NC, piece):
        sl = slice(c, min(c + piece, NC))
        src = slice(first + sl.start, first + sl.stop)
        I = {k: _bc(pf[k][..., src], "i") for k in _QD_FIELDS}
        J = {k: _bc(v[..., src], "j") for k, v in J_all.items()}
        coeffs = lookup_pair_coeffs(I["ptype"], J["ptype"], params, cfg)
        dQc_base = _dqc_base(I, J, coeffs, cfg, pbc, notself)
        qd[..., sl] = torch.sum(
            _qd_hops(I, J, coeffs, params, cfg, dt, step, seed, dQc_base),
            dim=-2).to(torch.int32)
    _pass_a_qd.calls += 1
    return qd


def _own_cells(geom: Geometry, NC_in: int) -> tuple:
    """(first, count) of the target cells among ``NC_in`` cells: all of
    them, or on a mesh's ghosted slab (``halo.SlabGeometry``) the slab's
    own, between its halo planes."""
    first = geom.strides[0] if isinstance(geom, SlabGeometry) else 0
    return first, NC_in - 2 * first


_pass_a_qd.calls = 0  # Qd passes in this process
_QD_FIELDS = ("x", "valid", "ptype", "inv_rho", "Cd", "tag")


def _thermal_force(I, J, dx, r, h, wfd, params: Params, cfg: PairConfig, dt,
                   step, seed):
    """SDPD random force (pair...transport_velocity.cpp:406-431), [3, ...].

    Wiener increment: a symmetric dim x dim gaussian matrix made traceless;
    prefactor sqrt(-4 kB e_i mi mj wfd / (rho_i rho_j dt)) / (r + 0.01 h).
    The draws are float32 (``rand.normal``) and pair-symmetric; each
    off-diagonal is one shared draw where the reference averages two (the
    JAX package's documented deviation, same distribution).  Only e of i
    enters, as in the reference: with a non-uniform e the noise is not
    pair-symmetric."""
    dim = cfg.dim
    W = [[None] * 3 for _ in range(3)]
    salt = 0
    for a in range(dim):
        for b in range(a, dim):
            g = rand.pair_symmetric_normal(
                (cfg.rng_seed & 0xFFFFFFFF) ^ seed, step, I["tag"], J["tag"],
                salt)
            W[a][b] = W[b][a] = g
            salt += 1
    trace = sum(W[a][a] for a in range(dim)) / dim
    for a in range(dim):
        W[a][a] = W[a][a] - trace
    pref = _thermal_prefactor(I, J, r, h, wfd, params, dt)
    comps = [pref * sum(W[l][k] * dx[k] for k in range(dim)) if l < dim
             else torch.zeros_like(r) for l in range(3)]
    return torch.stack(comps, dim=0)


def _thermal_prefactor(I, J, r, h, wfd, params: Params, dt):
    """sqrt(max(-4 kB e_i mi mj wfd / (rho_i rho_j) / dt, 0)) / (r + 0.01 h)
    in the JAX package's order of operations.  m_i m_j wfd / (rho_i rho_j)
    goes through the hoisted reciprocals, so it is 0 (not inf or nan) on
    masked lanes and the mask in wfd suffices."""
    return torch.sqrt(torch.clamp_min(
        -4.0 * params.boltz * I["e"]
        * (I["m"] * J["m"] * wfd * I["inv_rho"] * J["inv_rho"]) / dt,
        0.0)) / (r + 0.01 * h)


def _pass_a_j_fields(params: Params, cfg: PairConfig):
    """The per-particle fields the ported pass-A branches read j-side."""
    fields = "valid x v vest rho rhoI ptype solid m c0 P_rho2 inv_rho m_rho V2".split()
    if cfg.solids_present:
        fields.append("AS" if cfg.elastic_present else "ASd")
    if cfg.elastic_present:
        fields.append("S")
        if cfg.g0_chem_coupling:
            fields.append("G0")
    if params.n_sdpd > 0:
        fields.append("C")
    if cfg.thermal:
        fields.append("tag")
    if params.n_ssa > 0:
        fields += [f for f in ("Cd", "tag") if f not in fields]
    return fields


PASS_A_ACCS = ("num_den", "rhoAux1", "rhoAux2", "ddv", "ddx", "f", "dS",
               "drho", "de", "phi", "nw", "Q")
# leading component axes of the accumulators that are not [cap, NC] scalars
# (Q's is the species count, ``acc_lead``)
_ACC_LEAD = {"ddv": (3,), "ddx": (3,), "f": (3,), "nw": (3,), "dS": (3, 3)}


def acc_lead(name: str, params: Params) -> tuple:
    """Leading axes of the pass-A accumulator ``name`` before [cap, NC]."""
    return (params.n_sdpd,) if name == "Q" else _ACC_LEAD.get(name, ())


def _pass_a_plain(pf: dict, params: Params, geom: Geometry, cfg: PairConfig,
                  noise=None, virial: bool = False, cells_per_piece=None):
    """Pass A as a loop over the stencil offsets: the plain version of the
    K1, K2 and K3 kernels.  Returns every ``PASS_A_ACCS`` entry ([cap, NC]
    scalars, [3, cap, NC] vectors, [3, 3, cap, NC] dS, [Ns, cap, NC] Q);
    accumulators the configuration skips stay 0; with SSA species also Qd
    [n_ssa, cap, NC] (int32), drawn inline.  ``noise``: the state's (dt,
    step, key), read by the thermal noise and the SSA hops; ``virial`` adds
    the ``vir`` accumulator (``compute_pair_virial``).  ``cells_per_piece``:
    evaluate each offset's [cap, cap, NC] pair blocks over that many target
    cells at a time (every cell's sums are its own, so the pieces change
    only the memory the blocks take); all NC at once by default.

    On a mesh's slab (``geom`` a ``halo.SlabGeometry``, ``pf`` the ghosted
    slab's) the targets are the slab's own cells, whose sums it returns,
    [..., cap, NC of the slab]: the pair blocks are those of the same cells
    on one device, so a one-rank mesh sums bitwise as no mesh does."""
    cap, NC_in = pf["rho"].shape
    fdt, dev = pf["x"].dtype, pf["x"].device
    first, NC = _own_cells(geom, NC_in)
    targets = slice(first, first + NC)
    piece = NC if cells_per_piece is None else max(1, int(cells_per_piece))
    pieces = [slice(c, min(c + piece, NC)) for c in range(0, NC, piece)]
    # self-pair exclusion for the zero offset ([cap, cap, 1])
    not_diag = ~torch.eye(cap, dtype=torch.bool, device=dev)[:, :, None]
    pbc = _pbc(geom)
    acc = {name: torch.zeros(acc_lead(name, params) + (cap, NC), dtype=fdt,
                             device=dev)
           for name in PASS_A_ACCS}
    if virial:
        acc["vir"] = torch.zeros((cap, NC), dtype=fdt, device=dev)
    if params.n_ssa > 0:
        acc["Qd"] = torch.zeros((params.n_ssa, cap, NC), dtype=torch.int32,
                                device=dev)
    dt = step = seed = None
    if cfg.thermal or params.n_ssa > 0:
        if noise is None:
            raise ValueError("the thermal noise and the SSA hops need the "
                             "state's (dt, step, key)")
        dt, step, key = noise
        seed = rand.seed_word(key)
    ja_fields = _pass_a_j_fields(params, cfg)
    pf_in = pf
    pf = {k: v[..., targets] for k, v in pf.items()} if first else pf
    for off in geom.stencil_offsets():
        shifted = {k: shift_cells(pf_in[k], off, geom)[..., targets]
                   for k in ja_fields}
        notself = not_diag if off == (0, 0, 0) else True
        for sl in pieces:
            I = {k: _bc(v[..., sl], "i") for k, v in pf.items()}
            J = {k: _bc(v[..., sl], "j") for k, v in shifted.items()}
            coeffs = lookup_pair_coeffs(I["ptype"], J["ptype"], params, cfg)
            # the accumulators' views of the piece, summed into in place
            _pass_a_offset(I, J, coeffs, params, cfg, notself,
                           {k: v[..., sl] for k, v in acc.items()}, pbc=pbc,
                           dt=dt, step=step, seed=seed)
    return acc


def noise_inputs(state: State) -> tuple:
    """The thermal noise's inputs (dt, step, key): the state's own device
    tensors, never read back to the host."""
    return state.dt, state.step, state.key


def compute_ssa_mu_max(state: State, params: Params, geom: Geometry,
                       cfg: PairConfig, mesh=None) -> torch.Tensor:
    """Max per-directed-pair hop mean mu = kappaSSA * (-dQc_base) * Cd * dt
    (a 0-dim tensor).  The tau-leap diffusion truncates each pair's Poisson
    at ``cfg.ssa_poisson_terms`` and is statistically exact only for mu << 1;
    ``core/stepper.simulate`` reads this at check cadence and warns.

    ``mesh``: ``state`` is this rank's x-slab of ``geom``; the fields the
    hops read get their halo planes (one exchange), the slab's own pairs
    are measured on the ghosted slab and the max is taken over the ranks,
    so every rank returns the whole grid's."""
    if params.n_ssa == 0:
        return torch.zeros((), dtype=state.x.dtype, device=state.x.device)
    pf = _per_particle(state, params, cfg)
    pf = {k: pf[k] for k in _MU_FIELDS}
    if mesh is None:
        return _mu_max(pf, params, geom, cfg, state.dt)
    from sph_bvf_tpu_torch.parallel.mesh import all_reduce

    pf, slab = _ghosted(pf, geom, mesh)
    return all_reduce(_mu_max(pf, params, slab, cfg, state.dt), mesh, "max")


_MU_FIELDS = ("valid", "x", "inv_rho", "ptype", "Cd")


def _mu_max(pf: dict, params: Params, geom: Geometry, cfg: PairConfig, dt):
    """``compute_ssa_mu_max`` of the per-particle fields ``pf``
    (``_MU_FIELDS``): the largest hop mean of the target cells' pairs
    (on a ghosted slab, its own cells', as in ``_pass_a_plain``)."""
    x = pf["x"]
    first, NC = _own_cells(geom, x.shape[-1])
    own = slice(first, first + NC)
    not_diag = ~torch.eye(geom.cap, dtype=torch.bool, device=x.device)[:, :, None]
    pbc = _pbc(geom)
    need = _MU_FIELDS[:-1]
    I = {k: _bc(pf[k][..., own], "i") for k in _MU_FIELDS}
    mu_max = torch.zeros((), dtype=x.dtype, device=x.device)
    for off in geom.stencil_offsets():
        J = {k: _bc(shift_cells(pf[k], off, geom)[..., own], "j") for k in need}
        notself = not_diag if off == (0, 0, 0) else True
        coeffs = lookup_pair_coeffs(I["ptype"], J["ptype"], params, cfg)
        dQc_base = _dqc_base(I, J, coeffs, cfg, pbc, notself)
        mu = coeffs["kss"] * (-dQc_base)[None] * dt * torch.clamp_min(
            I["Cd"].to(x.dtype), 0.0)
        mu_max = torch.maximum(mu_max, torch.max(mu))
    return mu_max


# ---------------------------------------------------------------------------
# pass B: sweep 3 (weighted solid velocity/acceleration near fluids)
# ---------------------------------------------------------------------------


def _pass_b_offset(I, J, coeffs, cfg: PairConfig, params: Params, notself,
                   acc, pbc=()):
    """Accumulate one stencil offset's kernel-weighted solid velocity and
    acceleration (reference sweep 3) into ``acc``."""
    fdt = I["x"].dtype
    RED = -2
    dx = _pair_delta(I["x"], J["x"], pbc)
    r = torch.sqrt(_dot3(dx, dx))
    mask = (I["valid"] & J["valid"] & notself).to(fdt)
    wfBvf = lucy_w_ih(r, coeffs["inv_h"], cfg.dim) * mask

    sel = I["fluid"] & J["solid"]
    if cfg.weighted_solid_skip_fixed:
        sel = sel & ~J["fixed"]
    w = sel.to(fdt) * wfBvf * J["V2"]
    acc["vws"] += torch.sum(w[None] * J["vest"], dim=RED)
    acc["aws"] += torch.sum(w[None] * J["fom"], dim=RED)  # f/m, hoisted
    return acc


_PASS_B_J_FIELDS = "valid x vest ptype solid fluid fixed V2 fom".split()


def _pass_b(pf: dict, fom, params: Params, geom: Geometry, cfg: PairConfig):
    """Pass B over the stencil offsets, torch ops on either device: vws and
    aws [3, cap, NC] from the per-particle dict and ``fom``, pass A's force
    over the mass, f/m [3, cap, NC].  On a mesh's slab (``geom`` a
    ``halo.SlabGeometry``; ``pf`` and ``fom`` the ghosted slab's) the
    targets are the slab's own cells, as in ``_pass_a_plain``."""
    cap, NC_in = pf["rho"].shape
    fdt, dev = pf["x"].dtype, pf["x"].device
    first, NC = _own_cells(geom, NC_in)
    own = slice(first, first + NC)
    pf_b = {k: pf[k] for k in _PASS_B_J_FIELDS if k != "fom"}
    pf_b["fom"] = fom
    I = {k: _bc(v[..., own], "i") for k, v in pf_b.items()}
    not_diag = ~torch.eye(cap, dtype=torch.bool, device=dev)[:, :, None]
    pbc = _pbc(geom)
    acc = {k: torch.zeros((3, cap, NC), dtype=fdt, device=dev)
           for k in ("vws", "aws")}
    for off in geom.stencil_offsets():
        J = {k: _bc(shift_cells(pf_b[k], off, geom)[..., own], "j")
             for k in _PASS_B_J_FIELDS}
        notself = not_diag if off == (0, 0, 0) else True
        coeffs = lookup_pair_coeffs(I["ptype"], J["ptype"], params, cfg)
        _pass_b_offset(I, J, coeffs, cfg, params, notself, acc, pbc=pbc)
    return acc


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def compute_forces(
    state: State, params: Params, geom: Geometry, cfg: PairConfig,
    mesh=None,
) -> State:
    """Full force evaluation; returns the state with all accumulators replaced
    (force_clear + Pair::compute).

    Pass A goes through ``pair_cuda.pass_a``: the K1, K4, K2 or K3 kernel on a
    CUDA tensor, ``_pass_a_plain`` on a CPU tensor.  With SSA species the
    kernel's Qd comes from ``_pass_a_qd``; the plain pass draws it inline.
    Pass B (``vws``/``aws``) follows where ``cfg.weighted_solid`` asks for it.

    ``mesh`` (``parallel/mesh.Mesh``): ``state`` is this rank's x-slab of
    ``geom``.  The per-particle fields get one halo plane on each side (one
    exchange, ``halo.ghost_slabs``); pass A and the SSA hops run on that
    ghosted slab (``halo.SlabGeometry``) and give the slab's own cells'
    sums.  Pass B reads f/m of the halo particles, which only the
    neighbour's pass A gives: it costs a second exchange, of those 3 rows.
    """
    from sph_bvf_tpu_torch.ops.pair_cuda import pass_a

    NC, cap = state.valid.shape[-1], geom.cap
    fdt, dev = state.x.dtype, state.x.device
    pf = _per_particle(state, params, cfg)
    noise = noise_inputs(state)
    # the fields and grid pass A reads: this rank's slab with its halos
    # under a mesh (``_ghosted`` raises for a grid the mesh cannot cut)
    pf_a, geom_a = (pf, geom) if mesh is None else _ghosted(pf, geom, mesh)
    acc = pass_a(pf_a, params, geom_a, cfg, noise)

    def zeros(*lead, dtype=fdt):
        return torch.zeros(lead + (cap, NC), dtype=dtype, device=dev)

    # pass B needs the fresh forces.  vws/aws are read only by the bvf,
    # artificial_stress and zhang integrators' moving-wall reflections, so
    # it runs only where the configuration asks for it
    if cfg.solids_present and cfg.weighted_solid:
        fom = acc["f"] / pf["m"][None]  # f/m once per particle
        if mesh is not None:
            (fom,) = ghost_slabs([fom], plane_cells(geom), mesh, wrap_x(geom),
                                 label="pass_b")
        acc_b = _pass_b(pf_a, fom, params, geom_a, cfg)
    else:
        acc_b = dict(vws=zeros(3), aws=zeros(3))
    # the SSA hops after pass B, which does not read them: under a mesh its
    # exchange then waits for pass A alone, not for the hops as well
    if params.n_ssa > 0 and "Qd" not in acc:
        acc["Qd"] = _pass_a_qd(pf_a, params, geom_a, cfg, noise)

    one = torch.ones((), dtype=fdt, device=dev)
    return dataclasses.replace(
        state,
        f=acc["f"],
        drho=acc["drho"],
        de=acc["de"],
        Q=acc["Q"],
        Qd=acc["Qd"] if params.n_ssa > 0 else zeros(0, dtype=torch.int32),
        ddv=acc["ddv"],
        ddx=acc["ddx"],
        dS=acc["dS"],
        phi=acc["phi"],
        num_den=torch.where(state.valid, acc["num_den"], one),
        nw=acc["nw"],
        vws=acc_b["vws"],
        aws=acc_b["aws"],
        rhoAux1=acc["rhoAux1"],
        rhoAux2=torch.where(state.valid, acc["rhoAux2"], one),
        Pnew=pf["P"] if cfg.store_pnew else state.Pnew,
    )


def _ghosted(pf: dict, geom: Geometry, mesh):
    """``pf`` of this rank's slab with one halo plane on each side (one
    exchange, ``halo.ghost_slabs``), and the ghosted slab's geometry
    (which raises for a grid the mesh cannot cut, before any exchange)."""
    slab = slab_of(geom, mesh)
    names = list(pf)
    pf_gh = ghost_slabs([pf[k] for k in names], plane_cells(geom), mesh,
                        wrap_x(geom))
    return dict(zip(names, pf_gh)), slab


def compute_pair_virial(state: State, params: Params, geom: Geometry,
                        cfg: PairConfig, mesh=None) -> torch.Tensor:
    """Per-particle pairwise virial sum_j r_ij . f_ij as [cap, NC], 0 on
    empty slots.

    Feeds the thermo ``press`` keyword (thermo.cpp:56 -> compute pressure):
    P = (sum m v^2 + 0.5 sum_i vir_i) / (dim V).  It runs the plain stencil
    loop on whatever device the state is on, at thermo cadence only, as the
    JAX package runs its jnp loop: no kernel carries the extra accumulator.
    Under ``mesh`` (``state`` this rank's slab) the loop runs on the
    ghosted slab, as pass A does, and gives the slab's own particles'.
    """
    pf = _per_particle(state, params, cfg)
    if mesh is None:
        args = (pf, params, geom)
    else:
        pf_gh, slab = _ghosted(pf, geom, mesh)
        args = (pf_gh, params, slab)
    acc = _pass_a_plain(*args, cfg, noise_inputs(state), virial=True)
    return torch.where(state.valid, acc["vir"], 0.0)
