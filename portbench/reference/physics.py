"""The SPH-BVF step of the lid-driven cavity, written from its equations in
plain PyTorch over a list of pairs: no cell slots, no kernels.

One step is velocity Verlet with transport-velocity correction (Adami,
Hu & Adams 2013; Zhang 2017), in the order of LAMMPS' Verlet::run:

1. step += 1; initial integrate: free fluid particles take
   vest = v + dt/2 f/m, v = vest - dt/2 ddv/m, x += dt v, rhoI = rho,
   rho += dt/2 drho; walls and lid stay.
2. Forces, every ordered pair (i, j) within the support h (Lucy kernel,
   W = A_d/h^d (1 + 3q)(1 - q)^3, F = W'/r = -12 A_d/h^(d+2) (1 - q)^2):
   number density sum V_j^2 W, the background-pressure correction
   ddv = sum 70 B_i (V_i^2 + V_j^2) F dx, the momentum force (pressure
   with Sun 2018's switch, viscosity eta, the transport tensor, and the
   Monaghan artificial stress of walls under tension), the continuity
   term with its transport correction, the BVF wall fraction phi and
   normal nw, the Shepard sums on filter steps, and with stochastic
   species the hop counts of every directed pair (a Poisson of mean
   kappa (-dQc) dt Cd_i, drawn by CDF inversion from one keyed uniform).
3. setforce: the lid's force is 0.
4. Final integrate: phi and nw over the number density; a free fluid
   particle with phi > 0.5 is bounced back (x rewound and advanced with v
   reflected off the wall normal); v = vest + dt/2 f/m; rho from the
   Shepard filter every ``freq_filter`` steps, else rhoI + dt/2 drho;
   Cd += the hop balance, clamped at 0.
5. Reactions: an exact Gillespie loop per particle within dt, at most 16
   events, of the mass-action propensities, with keyed uniforms.

Each force term is the reference implementation's own
(pair_ssa_tsdpd_bvf_transportVelocity.cpp); its order of operations is
kept where rounding decides a draw (the hop means), so that a float32 run
draws what a float32 program draws.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from portbench.reference import counter_rng

ART_STRESS_COEF = 0.35
WDELTA_RATIO = 2.6
MAX_EVENTS = 16
POISSON_TERMS = 6
PAIR_BLOCK = 1 << 24  # pairs evaluated at once
SKIN = 0.2  # the pair list's radius past h, in h


@dataclasses.dataclass
class Particles:
    """Per-tag state (index = tag - 1) on one device in one dtype."""

    x: torch.Tensor  # [n, 3]
    v: torch.Tensor
    vest: torch.Tensor
    f: torch.Tensor
    ddv: torch.Tensor
    rho: torch.Tensor  # [n]
    rhoI: torch.Tensor
    drho: torch.Tensor
    Cd: torch.Tensor  # int32 [n, ns]
    step: int

    def to(self, dtype) -> "Particles":
        return dataclasses.replace(self, **{
            k.name: getattr(self, k.name).to(dtype)
            for k in dataclasses.fields(self)
            if isinstance(getattr(self, k.name), torch.Tensor)
            and getattr(self, k.name).is_floating_point()})


@dataclasses.dataclass(frozen=True)
class Species:
    """Stochastic species: the hop rate between fluid particles and
    first-order decay channels (rate per species, 0 for none)."""

    kss: tuple  # per species: kappa between two fluid particles
    decay: tuple  # per species: the decay rate k of A -> 0


# pair terms a planted fault can leave out (``Model.drop``)
DROPPABLE = ("transport_tensor", "artificial_stress", "continuity_transport")


def lucy_consts(dim: int):
    """A_d of the Lucy kernel W = A_d / h^d (1 + 3q)(1 - q)^3."""
    return {2: 5.0 / math.pi, 3: 105.0 / (16.0 * math.pi)}[dim]


class Model:
    """A scene's constants as float32 tensors on ``device``, the particles'
    initial counts ``Cd0`` [n, ns], and how its pair pass computes.

    The state is held in float32 throughout.  The pair pass computes in
    ``compute``: float32 for the reference; a lower precision for the
    control, which keeps the state and the sums in float32 and takes each
    pair's separation as a float32 difference before rounding it, as a
    pair kernel computing in that precision would.  ``drop`` names pair
    terms (``DROPPABLE``) that a planted fault leaves out."""

    def __init__(self, sc, device, species: Species | None, Cd0,
                 compute=torch.float32, drop=()):
        assert set(drop) <= set(DROPPABLE), drop
        t = lambda a: torch.as_tensor(a, device=device)
        f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
        self.sc, self.dtype, self.device = sc, torch.float32, device
        self.cdt, self.drop, self.Cd0 = compute, frozenset(drop), Cd0
        self.dim = sc.dim
        self.ptype = t(sc.ptype)
        self.solid = t(sc.solid)
        self.fluid = ~self.solid
        self.lid = t(sc.lid)
        self.mass = f32(sc.mass)
        self.m = self.mass[self.ptype]
        self.B = f32(sc.c0 * sc.c0 * sc.rho0 / 7.0)
        self.h = f32(sc.h)
        self.ih = 1.0 / self.h
        self.eta = f32(sc.nu)
        self.dt = f32(sc.dt)
        A = lucy_consts(self.dim)
        self.w_coef = A * _ipow(self.ih, self.dim)
        self.f_coef = -12.0 * A * _ipow(self.ih, self.dim + 2)
        q = 1.0 / WDELTA_RATIO
        wdelta = A / self.h ** self.dim * (1 - q) ** 3 * (1 + 3 * q)
        self.inv_wdelta = 1.0 / wdelta
        m = self.mass
        self.m_harm = m[:, None] * m[None, :] / (m[:, None] + m[None, :])
        self.species = species
        ns = 0 if species is None else len(species.kss)
        self.kss = torch.zeros((2, 2, ns), dtype=torch.float32, device=device)
        if ns:
            self.kss[0, 0] = f32(species.kss)

    def initial(self, jitter: torch.Tensor) -> Particles:
        """The particles before set-up: lattice plus ``jitter`` on the
        fluid, rho 1, the lid moving at U0, the counts ``Cd0``."""
        sc = self.sc
        n = sc.n
        x = torch.as_tensor(sc.x, device=self.device).to(torch.float32)
        x = x + torch.where(self.fluid[:, None], jitter.to(torch.float32), 0.0)
        v = torch.zeros((n, 3), dtype=self.dtype, device=self.device)
        v[self.lid, 0] = sc.U0
        z = torch.zeros_like(v)
        one = torch.ones(n, dtype=self.dtype, device=self.device)
        return Particles(x=x, v=v, vest=v.clone(), f=z, ddv=z.clone(),
                         rho=one, rhoI=one.clone(), drho=torch.zeros_like(one),
                         Cd=self.Cd0.to(torch.int32), step=0)

    def setup(self, p: Particles, seed: int) -> Particles:
        """``setup`` of this model."""
        return setup(self, p, seed)

    def chunk(self, p: Particles, steps: int, seed: int) -> Particles:
        """``chunk`` of this model."""
        return chunk(self, p, steps, seed)


def pair_list(x: torch.Tensor, radius: float, block: int = 1 << 18):
    """Every ordered pair (i, j), i != j, closer than ``radius``: two int64
    tensors.  Positions are binned on cells of ``radius``; each particle
    looks at the 3^d cells around its own."""
    dev = x.device
    xs = x.to(torch.float64)
    lo = xs.min(0).values - radius
    dims = [ax for ax in range(3) if float(xs[:, ax].max() - xs[:, ax].min()) > 0]
    nc = [int((xs[:, ax].max() - lo[ax]) / radius) + 2 if ax in dims else 1
          for ax in range(3)]
    ci = [((xs[:, ax] - lo[ax]) / radius).long() if ax in dims
          else torch.zeros(len(xs), dtype=torch.long, device=dev)
          for ax in range(3)]
    flat = (ci[0] * nc[1] + ci[1]) * nc[2] + ci[2]
    order = torch.argsort(flat)
    fs = flat[order]
    counts = torch.bincount(fs, minlength=nc[0] * nc[1] * nc[2])
    start = torch.cumsum(counts, 0) - counts
    cap = int(counts.max())
    rank = torch.arange(len(fs), device=dev) - start[fs]
    table = torch.full((nc[0] * nc[1] * nc[2], cap), -1, dtype=torch.long,
                       device=dev)
    table[fs, rank] = order
    offs = [(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
            for c in (-1, 0, 1)
            if all(o == 0 or ax in dims for ax, o in enumerate((a, b, c)))]
    r2 = radius * radius
    ii, jj = [], []
    for s in range(0, len(xs), block):
        i = torch.arange(s, min(s + block, len(xs)), device=dev)
        for off in offs:
            nb = [ci[ax][i] + off[ax] for ax in range(3)]
            ok = torch.ones(len(i), dtype=torch.bool, device=dev)
            for ax in range(3):
                ok &= (nb[ax] >= 0) & (nb[ax] < nc[ax])
            cell = ((nb[0].clamp(0, nc[0] - 1) * nc[1]
                     + nb[1].clamp(0, nc[1] - 1)) * nc[2]
                    + nb[2].clamp(0, nc[2] - 1))
            j = table[cell]  # [b, cap]
            keep = ok[:, None] & (j >= 0) & (j != i[:, None])
            d = xs[i][:, None, :] - xs[j.clamp(min=0)]
            keep &= (d * d).sum(-1) < r2
            a, b = keep.nonzero(as_tuple=True)
            ii.append(i[a])
            jj.append(j[a, b])
    return torch.cat(ii), torch.cat(jj)


def _ipow(x, n: int):
    """x**n by repeated squaring, so that a power rounds the same on every
    device."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def _dot(a, b):
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def forces(md: Model, p: Particles, pairs, filt: bool, seed: int):
    """The force pass of ``p`` over ``pairs``, computed in ``md.cdt``: a
    dict of per-particle float32 sums."""
    n, dev, c = p.x.shape[0], md.device, md.cdt
    lo = lambda a: a.to(c)
    B, m, rho = lo(md.B), lo(md.m), lo(p.rho)
    v, vest, rhoI = lo(p.v), lo(p.vest), lo(p.rhoI)
    ih, eta = lo(md.ih), lo(md.eta)
    w_coef, f_coef, inv_wdelta = (lo(md.w_coef), lo(md.f_coef),
                                  lo(md.inv_wdelta))
    P = 7.0 * B * (rho / md.sc.rho0 - 1.0)
    inv_rho = 1.0 / rho
    m_rho = m * inv_rho
    V2 = m_rho * m_rho
    P_rho2 = P * inv_rho * inv_rho
    tensile = -P
    ASd = torch.where(md.solid & (tensile > 0.0),
                      -ART_STRESS_COEF * tensile * (inv_rho * inv_rho),
                      torch.zeros((), dtype=c, device=dev))
    f32 = torch.float32
    acc = {k: torch.zeros((n, 3), dtype=f32, device=dev)
           for k in ("f", "ddv", "nw")}
    acc.update({k: torch.zeros(n, dtype=f32, device=dev)
                for k in ("num_den", "drho", "phi", "aux1", "aux2")})
    add = lambda k, idx, a: acc[k].index_add_(0, idx, a.to(f32))
    ns = p.Cd.shape[1]
    Qd = torch.zeros((n, ns), dtype=torch.int32, device=dev)
    I_all, J_all = pairs
    for s in range(0, len(I_all), PAIR_BLOCK):
        i, j = I_all[s:s + PAIR_BLOCK], J_all[s:s + PAIR_BLOCK]
        dx = lo(p.x[i] - p.x[j])
        rsq = _dot(dx, dx)
        r = torch.sqrt(rsq)
        q = r * ih
        t = torch.clamp_min(1.0 - q, 0.0)
        wf = w_coef * t * t * t * (1.0 + 3.0 * q)
        wfd = f_coef * t * t
        Vsum = V2[i] + V2[j]
        add("num_den", i, V2[j] * wf)
        if filt:
            add("aux1", i, rhoI[j] * wf)
            add("aux2", i, wf)
        add("ddv", i, (70.0 * B * Vsum * wfd)[:, None] * dx)
        vi, vj, ei, ej = v[i], v[j], vest[i], vest[j]
        rho_i, rho_j = rho[i], rho[j]
        velvec = ei - ej
        bi = _dot(vi - ei, dx)
        bj = _dot(vj - ej, dx)
        tdotx = 0.5 * ((rho_i * bi)[:, None] * ei + (rho_j * bj)[:, None] * ej)
        fvisc = Vsum * eta * wfd
        pij = P_rho2[j] + P_rho2[i]
        sgn = torch.where((pij >= 0.0) | (md.solid[i] & md.solid[j]), 1.0,
                          -1.0).to(c)
        mm = m[i] * m[j]
        fpair = mm * (P_rho2[j] + sgn * P_rho2[i]) * wfd
        wq = wf * inv_wdelta
        wq2 = wq * wq
        f_art = (mm * wfd * (wq2 * wq2) * (ASd[i] + ASd[j]))[:, None] * dx
        fp = (-fpair)[:, None] * dx + fvisc[:, None] * velvec
        if "transport_tensor" not in md.drop:
            fp = fp + (Vsum * wfd)[:, None] * tdotx
        if "artificial_stress" not in md.drop:
            fp = fp + f_art
        add("f", i, fp)
        mrj = m_rho[j]
        drho = rho_i * _dot(dx, vi - vj) * wfd * mrj
        if "continuity_transport" not in md.drop:
            drho = drho - (mrj * (rho_i * _dot(ei - vi, dx)
                                  + rho_j * _dot(ej - vj, dx)) * wfd)
        add("drho", i, drho)
        fs = (md.fluid[i] & md.solid[j]).to(c)
        add("phi", i, fs * V2[j] * wf)
        add("nw", i, (fs * wfd * V2[j])[:, None] * dx)
        if ns:
            Qd.index_add_(0, i, _hops(md, p, i, j, rsq, r, inv_rho, seed))
    return acc, Qd


def _poisson(mu, u):
    """Truncated Poisson by CDF inversion: the count of partial sums below u."""
    term = torch.exp(-mu)
    cdf = term
    n = torch.zeros(mu.shape, dtype=torch.int32, device=mu.device)
    for k in range(1, POISSON_TERMS):
        n = n + (u > cdf).to(torch.int32)
        term = term * mu / k
        cdf = cdf + term
    return n


def _hops(md: Model, p: Particles, i, j, rsq, r, inv_rho, seed):
    """Hops j -> i minus hops i -> j of every pair, per species [pairs, ns],
    computed in ``md.cdt``."""
    c = md.cdt
    lo = lambda a: a.to(c)
    ti, tj = md.ptype[i], md.ptype[j]
    hc, ih, f_coef = lo(md.h), lo(md.ih), lo(md.f_coef)
    t = torch.clamp_min(1.0 - r * ih, 0.0)
    wfd_c = f_coef * t * t
    dqc = (2.0 * lo(md.m_harm)[ti, tj] * (inv_rho[i] + inv_rho[j]) * rsq
           * wfd_c / (rsq + 0.01 * hc * hc))
    word = counter_rng.seed_word(seed)
    kss, dt = lo(md.kss), lo(md.dt)
    out = []
    for s in range(p.Cd.shape[1]):
        lam = kss[ti, tj, s] * (-dqc) * dt
        salt = (s + counter_rng.HOP_SALT) & counter_rng.MASK
        ui = counter_rng.uniform(word, p.step, i + 1, j + 1, salt)
        uj = counter_rng.uniform(word, p.step, j + 1, i + 1, salt)
        n_out = _poisson(lam * p.Cd[i, s].to(c), ui.to(c))
        n_in = _poisson(lam * p.Cd[j, s].to(c), uj.to(c))
        out.append(n_in - n_out)
    return torch.stack(out, 1)


def reactions(md: Model, p: Particles, seed: int) -> torch.Tensor:
    """Cd after one dt of each particle's first-order decays A -> 0, an
    exact Gillespie loop of at most MAX_EVENTS events."""
    Cd = p.Cd
    if md.species is None or not any(md.species.decay):
        return Cd
    word = counter_rng.seed_word(seed)
    tags = torch.arange(1, p.x.shape[0] + 1, device=md.device)
    ks = [k for k in md.species.decay]
    tt = torch.zeros(p.x.shape[0], dtype=md.dtype, device=md.device)
    alive = torch.ones(p.x.shape[0], dtype=torch.bool, device=md.device)
    for e in range(MAX_EVENTS):
        u1 = counter_rng.uniform(word, p.step, tags, e, 1).to(md.dtype)
        u2 = counter_rng.uniform(word, p.step, tags, e, 2).to(md.dtype)
        a = torch.stack([k * Cd[:, s].to(md.dtype) for s, k in enumerate(ks)
                         if k], 0)
        chan = [s for s, k in enumerate(ks) if k]
        a0 = a.sum(0)
        has = a0 > 0.0
        tt_next = tt - torch.log(1.0 - u1) / torch.clamp_min(a0, 1e-300)
        fire = alive & has & (tt_next < md.dt)
        idx = torch.clamp_max(
            ((torch.cumsum(a, 0) <= (u2 * a0)[None]).to(torch.int32)).sum(0),
            len(chan) - 1)
        dec = torch.zeros_like(Cd)
        for r, s in enumerate(chan):
            dec[:, s] = (fire & (idx == r)).to(torch.int32)
        Cd = Cd - dec
        tt = torch.where(alive & has, tt_next, tt)
        alive = fire
    return torch.clamp_min(Cd, 0)


def step(md: Model, p: Particles, pairs, seed: int) -> Particles:
    """One step (module docstring)."""
    sc, dt = md.sc, md.dt
    s = p.step + 1
    dtf = 0.5 * dt
    dtfm = (dtf / md.m)[:, None]
    free = md.fluid[:, None]
    vest = torch.where(free, p.v + dtfm * p.f, p.vest)
    v = torch.where(free, vest - dtfm * p.ddv, p.v)
    x = p.x + torch.where(free, dt * v, 0.0)
    rhoI = p.rho
    rho = p.rho + torch.where(md.fluid, dtf * p.drho, 0.0)
    q = dataclasses.replace(p, x=x, v=v, vest=vest, rho=rho, rhoI=rhoI, step=s)
    on_filter = sc.freq_filter > 0 and s % sc.freq_filter == 0
    acc, Qd = forces(md, q, pairs, on_filter, seed)
    f = torch.where(md.lid[:, None], 0.0, acc["f"])
    nden = torch.clamp_min(acc["num_den"], 1e-30)
    phi = acc["phi"] / nden
    nw = acc["nw"] / nden[:, None]
    gate = (md.fluid & (phi > 0.5))[:, None]
    norm = torch.sqrt((nw * nw).sum(1, keepdim=True))
    en = -nw / torch.clamp_min(norm, 1e-30)
    vdot = (v * en).sum(1, keepdim=True)
    v_ref = -v + 2.0 * torch.clamp_min(vdot, 0.0) * en
    x = x + torch.where(gate, dt * (v_ref - v), 0.0)
    v = torch.where(free, vest + dtfm * f, v)
    drho = acc["drho"]
    if on_filter:
        aux = acc["aux1"] / torch.clamp_min(acc["aux2"], 1e-30)
        rho = torch.where(md.fluid, aux + dtf * drho, aux)
    else:
        rho = torch.where(md.fluid, rhoI + dtf * drho, rhoI)
    Cd = torch.clamp_min(p.Cd + Qd, 0)
    out = Particles(x=x, v=v, vest=vest, f=f, ddv=acc["ddv"], rho=rho,
                    rhoI=rhoI, drho=drho, Cd=Cd, step=s)
    out.Cd = reactions(md, out, seed)
    return out


def setup(md: Model, p: Particles, seed: int) -> Particles:
    """Verlet::setup: vest = v, rhoI = rho, one force pass, setforce."""
    p = dataclasses.replace(p, vest=p.v.clone(), rhoI=p.rho.clone())
    pairs = pair_list(p.x, (1.0 + SKIN) * md.sc.h)
    acc, Qd = forces(md, p, pairs, True, seed)
    f = torch.where(md.lid[:, None], 0.0, acc["f"])
    return dataclasses.replace(p, f=f, ddv=acc["ddv"], drho=acc["drho"])


def chunk(md: Model, p: Particles, steps: int, seed: int) -> Particles:
    """``steps`` steps from ``p`` over one pair list, built with a skin of
    SKIN h: pairs past h add exactly 0, and in one chunk no pair closes by
    more than the skin (the drift check's budget is a tenth of h)."""
    pairs = pair_list(p.x, (1.0 + SKIN) * md.sc.h)
    for _ in range(steps):
        p = step(md, p, pairs, seed)
    return p
