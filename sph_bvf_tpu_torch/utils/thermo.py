"""Thermo-style diagnostics, the analog of thermo.cpp's step table (port of
``sph_bvf_tpu/utils/thermo.py``).

Supports the reference's `thermo_style custom` keyword subset used by the
examples (step dt press temp etotal, thermo.cpp:56 keyword table) plus the
framework's own columns.

`temp` follows compute_temp.cpp: T = sum(m v^2) * mvv2e / (dof * boltz) with
dof = dim*N - dim (extra_dof = dim).  `press` follows compute_pressure.cpp
when geometry and pair config are supplied: the virial pressure P = (sum m
v^2 + 0.5 sum_i sum_j r_ij.f_ij) / (dim V), with the pairwise virial from
``ops/pair.compute_pair_virial`` at thermo cadence.  Without geometry it is
the mean Tait pressure (also reported as `press_tait`).  `etotal` is the
total kinetic energy.  The reductions run on the state's device and come
back to the host in one copy.

Under a mesh (``parallel/mesh.Mesh``, ``mesh=``; the state is this rank's
x-slab) every column is over the whole grid: the sums and the extremes are
reduced over the ranks (one collective each), the virial runs on the
ghosted slab, and every rank gets the same row, so a ``Halt`` or a
``ThermoLogger`` raise takes the same branch on all of them.
"""

from __future__ import annotations

import math
import time

import torch

from sph_bvf_tpu_torch.ops.eos import tait_pressure
from sph_bvf_tpu_torch.parallel.mesh import all_reduce


class StopSimulation(RuntimeError):
    """Raised by a callback (e.g. Halt) to end simulate() early: the
    graceful analog of fix halt (fix_halt.cpp)."""


_KEYS = ("step", "dt", "n", "vmax", "ke", "press", "press_tait", "temp",
         "rho_min", "rho_max", "overflow")
_INTS = ("step", "n", "overflow")


def _over(vals: dict, mesh, op: str) -> dict:
    """The 0-dim tensors ``vals`` reduced over the mesh in one collective
    (in f64, which holds a particle count exactly), each in its own dtype."""
    red = all_reduce(torch.stack([v.to(torch.float64) for v in vals.values()]),
                     mesh, op)
    return {k: r.to(v.dtype) for (k, v), r in zip(vals.items(), red.unbind())}


def _thermo_device(state, params, dim, geom, pair_cfg, mesh=None) -> dict:
    """Every thermo reduction as a 0-dim tensor on the state's device; under
    ``mesh``, over every rank's slab."""
    valid = state.valid
    t = state.ptype.long()
    vsq = torch.where(valid, torch.sum(state.v * state.v, dim=0), 0.0)
    P = tait_pressure(state.rho, params.rho0[t], params.B[t])
    virial = geom is not None and pair_cfg is not None
    sums = dict(n=torch.sum(valid),
                mvsq=torch.sum(torch.where(valid, params.mass[t] * vsq, 0.0)),
                P=torch.sum(torch.where(valid, P, 0.0)))
    if virial:
        from sph_bvf_tpu_torch.ops.pair import compute_pair_virial

        sums["vir"] = 0.5 * torch.sum(
            compute_pair_virial(state, params, geom, pair_cfg, mesh))
    maxes = dict(vsq=torch.max(vsq),
                 rho_max=torch.max(torch.where(valid, state.rho, -math.inf)),
                 neg_rho_min=-torch.min(torch.where(valid, state.rho, math.inf)))
    if mesh is not None:
        sums, maxes = _over(sums, mesh, "sum"), _over(maxes, mesh, "max")
    n, mvsq = sums["n"], sums["mvsq"]
    ke = 0.5 * mvsq
    press_tait = sums["P"] / torch.clamp_min(n, 1)
    if virial:
        vol = 1.0
        for ax in range(dim):
            vol *= geom.hi[ax] - geom.lo[ax]
        # compute_pressure.cpp scalar: (sum m v^2 * mvv2e + virial)/(dim V)
        press = (mvsq * params.mvv2e + sums["vir"]) / (dim * vol)
    else:
        press = press_tait
    # compute_temp.cpp: dof = dim*N - extra_dof, extra_dof = dim
    dof = torch.clamp_min(dim * n - dim, 1).to(ke.dtype)
    temp = mvsq * params.mvv2e / (dof * params.boltz)
    return dict(
        step=state.step, dt=state.dt, n=n, vmax=torch.sqrt(maxes["vsq"]),
        ke=ke, press=press, press_tait=press_tait, temp=temp,
        rho_min=-maxes["neg_rho_min"], rho_max=maxes["rho_max"],
        overflow=state.overflow,
    )


def thermo_row(state, params, dim: int = 2, geom=None, pair_cfg=None,
               mesh=None) -> dict:
    """Global diagnostics computed on the state's device; returns a small
    dict of Python numbers.

    With ``geom`` and ``pair_cfg`` supplied, ``press`` is the virial
    pressure (compute_pressure.cpp); otherwise the mean Tait pressure.
    ``mesh``: ``state`` is this rank's slab, and the row is the whole
    grid's, the same on every rank.
    """
    d = _thermo_device(state, params, dim, geom, pair_cfg, mesh)
    vals = torch.stack([d[k].to(torch.float64) for k in _KEYS]).cpu().tolist()
    row = {k: (int(v) if k in _INTS else v) for k, v in zip(_KEYS, vals)}
    row["etotal"] = row["ke"]
    return row


_FORMATS = {
    "step": "{step:>9d}",
    "dt": "{dt:.3e}",
    "n": "{n:>8d}",
    "vmax": "{vmax:.4e}",
    "ke": "{ke:.6e}",
    "etotal": "{etotal:.6e}",
    "press": "{press:.6e}",
    "press_tait": "{press_tait:.6e}",
    "temp": "{temp:.4e}",
}


class ThermoLogger:
    """Prints a LAMMPS-thermo-like table and tracks steps/sec.

    ``columns`` mirrors `thermo_style custom ...`; unknown keywords raise.
    ``mesh``: the run's mesh (``spec.mesh``); the rows are the whole grid's
    and only its first rank prints them.
    """

    def __init__(self, params, every=1000, file=None, columns=None, dim=2,
                 geom=None, pair_cfg=None, mesh=None):
        self.params = params
        self.mesh = mesh
        self.every = every
        self.file = file
        self.dim = dim
        # supply geom + pair_cfg for the virial `press` (see thermo_row)
        self.geom = geom
        self.pair_cfg = pair_cfg
        self.columns = list(columns) if columns else ["step", "n", "vmax", "ke"]
        for c in self.columns:
            if c not in _FORMATS:
                raise ValueError(
                    f"thermo column {c!r}: choose from {sorted(_FORMATS)}"
                )
        self._t0 = None
        self._step0 = 0
        self.history = []

    def __call__(self, state):
        row = thermo_row(state, self.params, dim=self.dim,
                         geom=self.geom, pair_cfg=self.pair_cfg, mesh=self.mesh)
        now = time.perf_counter()
        if self._t0 is None:
            self._t0 = now
            self._step0 = row["step"]
            rate = 0.0
        else:
            rate = (row["step"] - self._step0) / max(now - self._t0, 1e-9)
        row["steps_per_sec"] = rate
        self.history.append(row)
        cols = "  ".join(
            f"{c} " + _FORMATS[c].format(**row) for c in self.columns
        )
        msg = (
            f"{cols}  rho [{row['rho_min']:.4f},{row['rho_max']:.4f}]  "
            f"{rate:,.0f} steps/s"
        )
        if self.mesh is None or self.mesh.rank == 0:
            print(msg, flush=True)
            if self.file:
                with open(self.file, "a") as f:
                    f.write(msg + "\n")
        if row["overflow"]:
            raise RuntimeError(f"cell overflow: {row['overflow']} particles lost")
        if not math.isfinite(row["vmax"]):
            raise RuntimeError("simulation blew up (vmax is not finite)")
        return row


class Halt:
    """Condition-triggered graceful stop, the fix halt (fix_halt.cpp) analog.

    Use as (or inside) a simulate() callback:
        simulate(..., callback=Halt(lambda row: row["vmax"] > 10, params))

    ``mesh``: the run's mesh (``spec.mesh``); the condition reads the
    whole grid's row.
    """

    def __init__(self, condition, params, dim=2, mesh=None):
        self.condition = condition
        self.params = params
        self.dim = dim
        self.mesh = mesh

    def __call__(self, state):
        row = thermo_row(state, self.params, dim=self.dim, mesh=self.mesh)
        if self.condition(row):
            raise StopSimulation(f"halt condition met at step {row['step']}")
