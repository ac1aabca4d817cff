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

Ported: the transport-velocity pair style with the Sun-2018 pressure
switch (the flagship lid-driven cavity), the mechanics pair style (the FSI
beam) and the fsi pair style (cell polarization: mechanics plus the density
diffusion ``ampl_damp`` and the species-softened shear modulus
``g0_chem_coupling``): the symmetric pressure force, XSPH, BVF walls of fixed solids,
free solids with the Pereira artificial viscosity, elastic solids (the
9-component artificial stress, the deviatoric solid force and the Jaumann
stress rate), periodic axes, with and without the Shepard-filter
accumulators, and continuum species transport (the tSDPD flux ``Q`` of
``C``, with its own support ``cutc`` and the transport-velocity advection
correction) and the SDPD thermal noise (``thermal``: the pair-symmetric
random force of counter-based draws, ``ops/rand.py``).  Every other branch
raises ``NotImplementedError`` (see ``_unported``).
"""

from __future__ import annotations

import dataclasses

import torch

from sph_bvf_tpu_torch.core.state import Geometry, Params, State, shift_cells
from sph_bvf_tpu_torch.ops import rand
from sph_bvf_tpu_torch.ops.eos import tait_pressure
from sph_bvf_tpu_torch.ops.kernels import ipow, lucy_w, lucy_w_ih, lucy_wfd_ih

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


def _unported(params: Params, cfg: PairConfig) -> list:
    """The pair branches this configuration needs that the port lacks."""
    return [what for what, needed in (
        ("weighted-solid pass B (weighted_solid)",
         cfg.solids_present and cfg.weighted_solid),
        ("SSA species (n_ssa > 0)", params.n_ssa > 0),
    ) if needed]


def check_ported(params: Params, cfg: PairConfig):
    missing = _unported(params, cfg)
    if missing:
        raise NotImplementedError(
            "pair physics not ported yet (ported in a later PR): "
            + ", ".join(missing)
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
        rho=state.rho, rhoI=state.rhoI, e=state.e, C=state.C, S=state.S,
        tag=state.tag, ptype=t,
        solid=solid,
        fluid=~solid, m=m, B=B, c0=params.c0[t], G0=G0, P=P,
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

    # species transport, Tartakovsky 2007; its own support cutc
    if params.n_sdpd > 0:
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
    return acc


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
    accumulators the configuration skips stay 0.  ``noise``: the state's
    (dt, step, key), read by the thermal noise only; ``virial`` adds the
    ``vir`` accumulator (``compute_pair_virial``).  ``cells_per_piece``:
    evaluate each offset's [cap, cap, NC] pair blocks over that many target
    cells at a time (every cell's sums are its own, so the pieces change
    only the memory the blocks take); all NC at once by default."""
    cap, NC = pf["rho"].shape
    fdt, dev = pf["x"].dtype, pf["x"].device
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
    dt = step = seed = None
    if cfg.thermal:
        if noise is None:
            raise ValueError("thermal noise needs the state's (dt, step, key)")
        dt, step, key = noise
        # the per-run seed word: the key's first and last words xor-ed
        key = key.reshape(-1)
        seed = (key[0] ^ key[-1]) & 0xFFFFFFFF
    ja_fields = _pass_a_j_fields(params, cfg)
    for off in geom.stencil_offsets():
        shifted = {k: shift_cells(pf[k], off, geom) for k in ja_fields}
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


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def compute_forces(
    state: State, params: Params, geom: Geometry, cfg: PairConfig,
    mesh=None, mesh_axis: str = "x",
) -> State:
    """Full force evaluation; returns the state with all accumulators replaced
    (force_clear + Pair::compute).

    Pass A goes through ``pair_cuda.pass_a``: the K1, K4, K2 or K3 kernel on a
    CUDA tensor, ``_pass_a_plain`` on a CPU tensor.
    """
    if mesh is not None:
        raise NotImplementedError("multi-device pair passes are ported in a later PR")
    check_ported(params, cfg)
    from sph_bvf_tpu_torch.ops.pair_cuda import pass_a

    NC, cap = geom.ncells_total, geom.cap
    fdt, dev = state.x.dtype, state.x.device
    pf = _per_particle(state, params, cfg)
    acc = pass_a(pf, params, geom, cfg, noise_inputs(state))

    def zeros(*lead, dtype=fdt):
        return torch.zeros(lead + (cap, NC), dtype=dtype, device=dev)

    one = torch.ones((), dtype=fdt, device=dev)
    return dataclasses.replace(
        state,
        f=acc["f"],
        drho=acc["drho"],
        de=acc["de"],
        Q=acc["Q"],
        Qd=zeros(params.n_ssa, dtype=torch.int32),
        ddv=acc["ddv"],
        ddx=acc["ddx"],
        dS=acc["dS"],
        phi=acc["phi"],
        num_den=torch.where(state.valid, acc["num_den"], one),
        nw=acc["nw"],
        vws=zeros(3),
        aws=zeros(3),
        rhoAux1=acc["rhoAux1"],
        rhoAux2=torch.where(state.valid, acc["rhoAux2"], one),
        Pnew=pf["P"] if cfg.store_pnew else state.Pnew,
    )


def compute_pair_virial(state: State, params: Params, geom: Geometry,
                        cfg: PairConfig) -> torch.Tensor:
    """Per-particle pairwise virial sum_j r_ij . f_ij as [cap, NC], 0 on
    empty slots.

    Feeds the thermo ``press`` keyword (thermo.cpp:56 -> compute pressure):
    P = (sum m v^2 + 0.5 sum_i vir_i) / (dim V).  It runs the plain stencil
    loop on whatever device the state is on, at thermo cadence only, as the
    JAX package runs its jnp loop: no kernel carries the extra accumulator.
    """
    pf = _per_particle(state, params, cfg)
    acc = _pass_a_plain(pf, params, geom, cfg, noise_inputs(state), virial=True)
    return torch.where(state.valid, acc["vir"], 0.0)
