"""The ranks of ``tests/test_torch_mesh.py``: the port over an x-slab mesh
of CPU processes (gloo), with no JAX import, so that no spawned rank pays
for one.

``legs(rank, out)`` runs in a group of 4 ranks started by
``sph_bvf_tpu_torch.parallel.launch.spawn``.  All four exchange halos (leg
1); ranks 0 and 1 then run the 2-rank legs on a mesh of their own, and
rank 2 meanwhile the one-rank legs.  Rank 0 writes every result, gathered over the
mesh, to ``out/<leg>.npz`` (``out/blob_log.json`` for the re-cut log);
the test compares them with the JAX package's runs of the same inputs.

The inputs are built from seeds here and in the test alike (the scene
builders of both packages give bitwise the same states): ``cavity``,
``fsi_beam`` and ``drift_blob`` take the package's modules.

``ssa_legs(rank, out)`` runs in a group of 2 ranks for
``tests/test_torch_mesh_ssa.py``: the lid-driven cavity with a stochastic
species (``examples/lid_cavity_ssa.lmp`` at N=``SSA_N``, ``ssa_model``),
as written and under the zhang integrator (pass B): the forces with Qd and
vws/aws, the largest hop mean and the computes on the slabs; two chunks
with a ``Restart`` on the mesh, a frame of the mesh and a resume from the
step-10 file.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import torch

# leg 1: the array every rank slices, [2, 3, RANKS * PLANES * WIDTH]
RANKS, PLANES, WIDTH = 4, 2, 4
DT = 1e-4
KB = 1e-4  # the thermal leg's kB
FIX = dict(every=50, threshold=1.5, min_budget=2.5e-3, occ_frac=0.8)
BLOB_STEPS = 105  # the re-cut at step 100 (occupancy) and 5 steps after
DT_FIX = dict(groupbit=1, cfl=0.25, dx_ave=0.02, tmin=1e-8, tmax=1e-2)


# the SSA legs: examples/lid_cavity_ssa.lmp at N=SSA_N (8 x 8 cells once
# its x cells are a multiple of 2), as written ("ssa") and under the zhang
# integrator ("zhang": pass B), with kappaSSA SSA_KSS (the script's 2e-3
# draws no hop at this size: the largest hop mean is 8e-4; at 0.5 it is
# 0.21); SSA_STEPS steps, a restart file every SSA_EVERY (the chunk)
SSA_SCRIPT = Path(__file__).resolve().parent.parent / "examples" / "lid_cavity_ssa.lmp"
SSA_N, SSA_KSS, SSA_STEPS, SSA_EVERY = 16, 0.5, 20, 10
SSA_CASES = {"ssa": None, "zhang": "ssa_tsdpd/bvf/zhang"}
SSA_FIELDS = ("v", "rho", "Cd")  # the frame's
# the computes held to JAX's: (name, indices)
SSA_COMPUTES = (("rho", ()), ("Cd", (0,)), ("number_density", ()),
                ("stress", (0, 1)), ("phi", ()))


def ssa_model(lmp, case):
    """``examples/lid_cavity_ssa.lmp`` at N=SSA_N and kappaSSA SSA_KSS
    parsed by package module ``lmp``, under the case's integrator, its x
    cells a multiple of 2."""
    text = SSA_SCRIPT.read_text()
    fix = SSA_CASES[case]
    if fix is not None:
        text = text.replace("integration all ssa_tsdpd/bvf/transportVelocity",
                            f"integration all {fix}")
        assert fix in text
    model = lmp.parse_script(text, overrides={"N": SSA_N, "kss": SSA_KSS})
    model.scene.ncx_multiple_of = 2
    return model


def exchange_input() -> np.ndarray:
    return np.random.default_rng(11).standard_normal(
        (2, 3, RANKS * PLANES * WIDTH))


def cavity(lid, **kw):
    """The N=16 cavity (8 x 8 cells, walls) with its x cells a multiple
    of 2: (state, params, spec) of package module ``lid``."""
    s, p, spec, _ = lid.build(N=16, Re=100.0, dt=DT, rebin_every=5,
                              ncx_multiple_of=2, **kw)
    return s, p, spec


def fsi_beam(fsi, **kw):
    """The FSI beam nx=12 (10 x 5 cells, periodic x, elastic, cap 28)."""
    s, p, spec, _ = fsi.build(nx=12, rebin_every=5, ncx_multiple_of=2, **kw)
    return s, p, spec


def drift_blob(mod):
    """``tests/test_sharding.py``'s drifting blob at s=1 in package ``mod``
    (its ``Scene``, ``Region``), balanced, with the in-run re-cut."""
    sc = mod.Scene(dim=2, boundary=("p", "f", "p"))
    sc.ncx_multiple_of = 8
    sc.create_box(1, mod.Region.block(0, 2.4, 0, 0.6, 0, 0.02))
    sc.lattice("sq", 0.02)
    sc.create_atoms(1, mod.Region.block(0, 1.08, 0, 1, -1, 1))
    sc.lattice("sq", 0.04)
    sc.create_atoms(1, mod.Region.block(1.1, 2.38, 0, 1, -1, 1))
    sc.mass(1, 4e-4)
    sc.set("all", rho=1.0, e=0.0)
    sc.velocity("all", 2.0)
    sc.pair_style("transport_velocity")
    sc.pair_coeff(1, 1, 1.0, 1e-3, 0.0, 0.05, 0.05, 0.0)
    sc.integrator("transport_velocity")
    sc.rebin_every = 5
    sc.timestep(2e-4)
    sc.balance(8, threshold=1.2)
    sc.fix_balance(8, **FIX)
    return sc


def f64(arrays: dict) -> dict:
    return {k: (v.astype(np.float64) if isinstance(v, np.ndarray)
                and v.dtype.kind == "f" else v) for k, v in arrays.items()}


def perturbed(s: dict, seed: int) -> dict:
    """Seeded noise on v, vest, rho, rhoI and e of the valid slots (both
    pressure signs, every pair term live), and a seeded symmetric S."""
    s = dict(s)
    rng = np.random.default_rng(seed)
    valid = s["valid"]
    v3 = s["v"].shape
    s["v"] = s["v"] + np.where(valid, rng.normal(0, 0.05, v3), 0.0)
    s["vest"] = s["v"] + np.where(valid, rng.normal(0, 0.01, v3), 0.0)
    s["v"][2] = s["vest"][2] = 0.0
    s["rho"] = s["rho"] * np.where(valid, rng.uniform(0.99, 1.01, valid.shape), 1.0)
    s["rhoI"] = np.where(valid, s["rho"] * (1 + rng.normal(0, 1e-3, valid.shape)),
                         s["rhoI"])
    s["e"] = np.where(valid, rng.uniform(0.5, 1.5, valid.shape), 0.0)
    S = rng.normal(0, 1.0, s["S"].shape)
    S = 0.5 * (S + np.swapaxes(S, 0, 1))
    S[2, :] = S[:, 2] = 0.0
    s["S"] = np.where(valid, S * float(np.max(np.abs(s["rho"]))), 0.0)
    s["dt"] = np.asarray(DT, s["x"].dtype)  # the thermal noise divides by it
    return s


def drifted(s: dict, cell_size, seed: int) -> dict:
    """Every valid particle moved by up to 0.45 of a cell per axis (a
    seeded drift across the slabs' seams and, on a periodic x, across the
    box's)."""
    s = dict(s)
    rng = np.random.default_rng(seed)
    d = rng.uniform(-0.45, 0.45, s["x"].shape) * np.asarray(cell_size)[:, None, None]
    d[2] = 0.0
    s["x"] = np.where(s["valid"], s["x"] + d, s["x"])
    return s


def thermal_params(p: dict) -> dict:
    return dict(p, boltz=KB)


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _save(out, name, **arrays):
    np.savez(os.path.join(out, name + ".npz"), **arrays)


def _port(state_np, params_np, spec, mesh, geom=None):
    """The whole state and params as port objects, this rank's slab."""
    from sph_bvf_tpu_torch import bridge
    from sph_bvf_tpu_torch.parallel import mesh as M

    st = bridge.state_to_port(state_np, device="cpu")
    pa = bridge.params_to_port(_Obj(params_np), device="cpu")
    return M.shard_state(st, mesh, geom or spec.geom), M.replicate(pa, mesh)


class _Obj:
    """Attribute access to a dict (``bridge.params_to_port`` reads fields)."""

    def __init__(self, d):
        self.__dict__.update(d)


def _whole(state, mesh):
    from sph_bvf_tpu_torch import bridge
    from sph_bvf_tpu_torch.parallel import mesh as M

    return bridge.state_from_port(M.gather_state(state, mesh))


def _leg_exchange(rank, mesh4, out):
    from sph_bvf_tpu_torch.core import halo

    n = PLANES * WIDTH
    M = torch.as_tensor(exchange_input()[..., rank * n:(rank + 1) * n])
    res = {}
    for periodic in (False, True):
        left, right = halo.exchange_slabs(M, WIDTH, mesh4, periodic)
        res[f"left_{periodic}"] = left.numpy()
        res[f"right_{periodic}"] = right.numpy()
    _save(out, f"exchange_{rank}", **res)


def _leg_pass_a(mesh, out):
    """Pass A on 2 slabs: the cavity on walls, the FSI beam (periodic x,
    elastic) and the cavity with the thermal noise."""
    from sph_bvf_tpu_torch import bridge
    from sph_bvf_tpu_torch.models import fsi, lid_cavity
    from sph_bvf_tpu_torch.ops import pair

    for name, build, thermal in (("cavity", lambda: cavity(lid_cavity, device="cpu"), False),
                                 ("fsi", lambda: fsi_beam(fsi, device="cpu"), False),
                                 ("thermal", lambda: cavity(lid_cavity, device="cpu"), True)):
        s, p, spec = build()
        s_np = perturbed(f64(bridge.state_from_port(s)), 3)
        p_np = f64(bridge.to_numpy(p))
        cfg = spec.pair
        if thermal:
            p_np = thermal_params(p_np)
            cfg = dataclasses.replace(cfg, thermal=True)
        st, pa = _port(s_np, p_np, spec, mesh)
        got = pair.compute_forces(st, pa, spec.geom, cfg, mesh)
        whole = _whole(got, mesh)
        if mesh.rank == 0:
            _save(out, f"pass_a_{name}", **{k: whole[k] for k in (
                "f", "drho", "ddv", "ddx", "num_den", "phi", "nw", "dS",
                "rhoAux1", "rhoAux2", "tag")})


def _leg_move(mesh, out):
    """The move on 2 slabs after a seeded drift: the cavity (walls, K5's
    walk) and the FSI beam (periodic x, K6's)."""
    from sph_bvf_tpu_torch import bridge
    from sph_bvf_tpu_torch.core import state as TS
    from sph_bvf_tpu_torch.models import fsi, lid_cavity

    for name, build in (("cavity", lambda: cavity(lid_cavity, device="cpu")),
                        ("fsi", lambda: fsi_beam(fsi, device="cpu"))):
        s, p, spec = build()
        s_np = drifted(f64(bridge.state_from_port(s)), spec.geom.cell_size, 7)
        st, _ = _port(s_np, f64(bridge.to_numpy(p)), spec, mesh)
        got = TS.rebin(st, spec.geom, mesh=mesh)
        whole = _whole(got, mesh)
        if mesh.rank == 0:
            _save(out, f"move_{name}", **whole)


def _leg_run_chunk(mesh, out):
    """setup and two chunks of 5 steps of the cavity at 2 ranks."""
    from sph_bvf_tpu_torch import bridge
    from sph_bvf_tpu_torch.core import stepper
    from sph_bvf_tpu_torch.models import lid_cavity

    s, p, spec = cavity(lid_cavity, device="cpu")
    st, pa = _port(f64(bridge.state_from_port(s)), f64(bridge.to_numpy(p)),
                   spec, mesh)
    spec = dataclasses.replace(spec, mesh=mesh)
    st = stepper.setup(st, pa, spec, dt=DT)
    for _ in range(2):
        st = stepper.run_chunk(st, pa, spec, spec.rebin_every)
    whole = _whole(st, mesh)
    if mesh.rank == 0:
        _save(out, "run_chunk", **whole)


def _leg_blob(mesh, out):
    """The balanced drifting blob with its in-run re-cut, at 2 ranks."""
    from sph_bvf_tpu_torch import bridge
    from sph_bvf_tpu_torch.api import scene as tscene
    from sph_bvf_tpu_torch.core import stepper

    s, p, spec = drift_blob(tscene).build(device="cpu")
    st, pa = _port(f64(bridge.state_from_port(s)), f64(bridge.to_numpy(p)),
                   spec, mesh)
    spec = dataclasses.replace(spec, mesh=mesh)
    log = []
    st = stepper.simulate(stepper.setup(st, pa, spec, dt=2e-4), pa, spec,
                          BLOB_STEPS, balance_log=log)
    whole = _whole(st, mesh)
    if mesh.rank == 0:
        _save(out, "blob", **whole)
        with open(os.path.join(out, "blob_log.json"), "w") as fh:
            json.dump([log_entry(e) for e in log], fh)


def log_entry(entry: dict) -> dict:
    """A ``balance_log`` entry as plain JSON (the geometry as a dict)."""
    e = dict(entry)
    if e.get("geom") is not None:
        e["geom"] = json.loads(json.dumps(dataclasses.asdict(e["geom"])))
    return e


def _leg_dt_adaptive(mesh, out):
    """``DtAdaptive`` on the perturbed cavity's slabs."""
    from sph_bvf_tpu_torch import bridge
    from sph_bvf_tpu_torch.core import fixes
    from sph_bvf_tpu_torch.models import lid_cavity

    s, p, spec = cavity(lid_cavity, device="cpu")
    st, pa = _port(perturbed(f64(bridge.state_from_port(s)), 13),
                   f64(bridge.to_numpy(p)), spec, mesh)
    got = fixes.DtAdaptive(**DT_FIX).apply(st, pa, mesh)
    if mesh.rank == 0:
        _save(out, "dt_adaptive", dt=got.dt.numpy())


def _leg_thermo(mesh, out):
    """The thermo row of 2 slabs, with the virial press, of the perturbed
    cavity (walls) and FSI beam (periodic x); the rows a ``Halt`` and a
    ``ThermoLogger`` on the mesh read."""
    from sph_bvf_tpu_torch import bridge
    from sph_bvf_tpu_torch.models import fsi, lid_cavity
    from sph_bvf_tpu_torch.utils import thermo

    res = {}
    for name, build in (("cavity", lambda: cavity(lid_cavity, device="cpu")),
                        ("fsi", lambda: fsi_beam(fsi, device="cpu"))):
        s, p, spec = build()
        st, pa = _port(perturbed(f64(bridge.state_from_port(s)), 3),
                       f64(bridge.to_numpy(p)), spec, mesh)
        row = thermo.thermo_row(st, pa, dim=2, geom=spec.geom,
                                pair_cfg=spec.pair, mesh=mesh)
        seen = []
        try:
            thermo.Halt(lambda r: seen.append(r) or True, pa, mesh=mesh)(st)
        except thermo.StopSimulation:
            pass
        log = thermo.ThermoLogger(pa, geom=spec.geom, pair_cfg=spec.pair,
                                  mesh=mesh)
        log(st)
        for k, v in row.items():
            res[f"{name}_row_{k}"] = np.asarray(v)
            res[f"{name}_logger_{k}"] = np.asarray(log.history[0][k])
        for k, v in seen[0].items():
            res[f"{name}_halt_{k}"] = np.asarray(v)
    _save(out, f"thermo_{mesh.rank}", **res)


def _leg_one_rank(mesh1, out):
    """A one-rank mesh against no mesh: the cavity (walls) and the FSI beam
    (a ring of one), setup and two chunks each, every leaf bitwise."""
    from sph_bvf_tpu_torch import bridge
    from sph_bvf_tpu_torch.core import stepper
    from sph_bvf_tpu_torch.models import fsi, lid_cavity

    res = {}
    for name, build, dt in (("cavity", lambda: cavity(lid_cavity, device="cpu"), DT),
                            ("fsi", lambda: fsi_beam(fsi, device="cpu"), 1e-8)):
        runs = []
        for m in (None, mesh1):
            s, p, spec = build()
            spec = dataclasses.replace(spec, mesh=m)
            s = stepper.setup(s, p, spec, dt=dt)
            for _ in range(2):
                s = stepper.run_chunk(s, p, spec, spec.rebin_every)
            runs.append(bridge.state_from_port(s))
        for k in runs[0]:
            res[f"{name}_plain_{k}"] = runs[0][k]
            res[f"{name}_mesh_{k}"] = runs[1][k]
    _save(out, "one_rank", **res)


def _leg_ssa_forces(mesh, out):
    """compute_forces, the largest hop mean and the computes of 2 slabs of
    the perturbed SSA cavity, as written and under zhang."""
    from sph_bvf_tpu_torch import bridge
    from sph_bvf_tpu_torch.api import lmp
    from sph_bvf_tpu_torch.core import computes
    from sph_bvf_tpu_torch.ops import pair

    for case in SSA_CASES:
        s, p, spec = ssa_model(lmp, case).build(device="cpu")
        st, pa = _port(perturbed(f64(bridge.state_from_port(s)), 3),
                       f64(bridge.to_numpy(p)), spec, mesh)
        got = pair.compute_forces(st, pa, spec.geom, spec.pair, mesh)
        mu = pair.compute_ssa_mu_max(st, pa, spec.geom, spec.pair, mesh)
        res = {f"compute_{name}{''.join(map(str, idx))}":
               computes.gather_compute(got, spec.geom, name, *idx, mesh=mesh)
               for name, idx in SSA_COMPUTES}
        whole = _whole(got, mesh)
        if mesh.rank == 0:
            _save(out, f"ssa_forces_{case}", mu=mu.numpy(), **res, **{
                k: whole[k] for k in ("Qd", "vws", "aws", "f", "tag", "valid")})


def _leg_ssa_runs(mesh, out):
    """setup and SSA_STEPS steps of each case at 2 ranks with a
    ``Restart`` on the mesh every SSA_EVERY steps (and, from rank 0, a
    single-device ``save`` of the gathered state beside it); a frame of the
    final state by the mesh and by one device; every rank's resume from
    the step-SSA_EVERY file to SSA_STEPS."""
    from sph_bvf_tpu_torch import bridge
    from sph_bvf_tpu_torch.api import lmp
    from sph_bvf_tpu_torch.core import stepper
    from sph_bvf_tpu_torch.io import checkpoint, vtk
    from sph_bvf_tpu_torch.parallel import mesh as M

    out = Path(out)
    for case in SSA_CASES:
        model = ssa_model(lmp, case)
        s, p, spec = model.build(device="cpu")
        st, pa = _port(f64(bridge.state_from_port(s)), f64(bridge.to_numpy(p)),
                       spec, mesh)
        geom = spec.geom
        spec = dataclasses.replace(spec, mesh=mesh)
        restart = checkpoint.Restart(
            SSA_EVERY, str(out / f"ckpt_{case}_{{step}}.npz"), geom, mesh)

        def callback(state):
            restart(state)
            whole = M.gather_state(state, mesh)
            if mesh.rank == 0:
                checkpoint.save(str(out / f"single_{case}_{int(state.step)}.npz"),
                                whole, geom)

        st = stepper.simulate(stepper.setup(st, pa, spec, dt=model.dt), pa,
                              spec, SSA_STEPS, callback=callback)
        vtk.dump_state(str(out / f"frame_mesh_{case}.vtk"), st, geom,
                       SSA_FIELDS, mesh=mesh)
        whole = M.gather_state(st, mesh)
        if mesh.rank == 0:
            vtk.dump_state(str(out / f"frame_single_{case}.vtk"), whole, geom,
                           SSA_FIELDS)
        run = bridge.state_from_port(whole)
        back = checkpoint.load(str(out / f"ckpt_{case}_{SSA_EVERY}.npz"), geom,
                               device="cpu")
        back = stepper.simulate(M.shard_state(back, mesh, geom), pa, spec,
                                SSA_STEPS - SSA_EVERY)
        resumed = _whole(back, mesh)
        if mesh.rank == 0:
            _save(str(out), f"ssa_run_{case}", **run)
            _save(str(out), f"ssa_resumed_{case}", **resumed)


def ssa_legs(rank, out):
    """The legs of ``tests/test_torch_mesh_ssa.py`` (the module
    docstring), on 2 ranks."""
    from sph_bvf_tpu_torch.parallel import mesh as M

    torch.set_num_threads(1)
    mesh = M.make_mesh(device="cpu")
    _leg_ssa_forces(mesh, out)
    _leg_ssa_runs(mesh, out)


def legs(rank, out):
    """Every leg of ``tests/test_torch_mesh.py`` (see the module docstring)."""
    from sph_bvf_tpu_torch.parallel import mesh as M

    torch.set_num_threads(1)
    mesh4 = M.make_mesh(device="cpu")
    _leg_exchange(rank, mesh4, out)
    mesh2 = M.make_mesh(2, device="cpu")
    if rank == 2:
        # a one-rank mesh makes no collective call: rank 2, idle beside
        # the 2-rank legs, runs the one-rank legs on a mesh of its own
        _leg_one_rank(M.Mesh(group=None, backend="gloo", rank=0, size=1,
                             device=torch.device("cpu"), ranks=(0,)), out)
    if mesh2 is None:
        return
    _leg_pass_a(mesh2, out)
    _leg_move(mesh2, out)
    _leg_dt_adaptive(mesh2, out)
    _leg_thermo(mesh2, out)
    _leg_run_chunk(mesh2, out)
    _leg_blob(mesh2, out)
