"""Run a function as the ranks of a ``torch.distributed`` group, one process
each, and a model over x-slab ranks from the command line.

``spawn(fn, nprocs, backend, init_file)`` starts ``nprocs`` processes
(the ``spawn`` start method: no rank inherits another's CUDA context),
initializes the group in each from a file store (``init_method=
"file://..."``, so concurrent launches never contend for a TCP port) and
calls ``fn(rank, *args)``.  A rank that raises fails the launch.

    python -m sph_bvf_tpu_torch.parallel.launch --nproc 2 --model lid_cavity \\
        --size 200 --steps 100 [--backend gloo] [--device cuda|cpu]

builds a registered model on every rank (with ``ncx_multiple_of`` the
rank count), keeps each rank's slab (``mesh.shard_state``), runs
``stepper.simulate`` over the mesh and prints, from rank 0, the
particle-steps/s, the halo traffic and the particle count.  Two ranks on a
host with one card share it: use gloo there (NCCL refuses two ranks on one
device), and read the speed as no measure of scaling.
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import os
import shutil
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank, fn, nprocs, backend, init_file, args):
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            world_size=nprocs, rank=rank)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, nprocs: int, backend: str = "gloo", init_file=None, args=(),
          timeout=None):
    """Run ``fn(rank, *args)`` in ``nprocs`` processes joined in one process
    group of ``backend``; ``init_file``: the file store's path, which must
    not exist yet (default: one in a new temporary directory, removed
    afterwards).  ``fn`` must be importable by name (a module's top-level
    function).  Returns when every rank has returned; raises if one
    failed (the others are ended), and ends them all and raises
    ``TimeoutError`` past ``timeout`` seconds (a rank stuck in a
    collective would otherwise wait for ever)."""
    tmp = None
    if init_file is None:
        tmp = tempfile.mkdtemp(prefix="sph_mesh_")
        init_file = os.path.join(tmp, "init")
    init_file = os.path.abspath(init_file)
    if os.path.exists(init_file):
        raise FileExistsError(f"the file store {init_file} exists: a stale "
                              f"one would join an old group")
    # every rank is a process of this host: gloo connects them on loopback
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    try:
        ctx = mp.start_processes(
            _rank_main, nprocs=nprocs, start_method="spawn", join=False,
            args=(fn, nprocs, backend, init_file, tuple(args)))
        deadline = None if timeout is None else time.monotonic() + timeout
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                for proc in ctx.processes:
                    proc.kill()
                    proc.join()
                raise TimeoutError(f"{nprocs} ranks of {fn.__name__} still "
                                   f"running after {timeout} s")
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def run_model(rank, model: str, size: int, steps: int, backend: str,
              device: str):
    """One rank of the command line's run (see the module docstring)."""
    from sph_bvf_tpu_torch.core import stepper
    from sph_bvf_tpu_torch.models import REGISTRY
    from sph_bvf_tpu_torch.parallel import mesh as mesh_mod

    torch.set_num_threads(1)
    mesh = mesh_mod.make_mesh(backend=backend,
                              device=None if device == "cuda" else device)
    arg = {"fsi": "nx", "cell_polarization": "nx"}.get(model, "N")
    build = REGISTRY[model]
    kw = {arg: size, "device": mesh.device}
    if "ncx_multiple_of" in inspect.signature(build).parameters:
        kw["ncx_multiple_of"] = mesh.size
    state, params, spec, scene = build(**kw)
    n_total = int(state.n_valid)
    state = mesh_mod.shard_state(state, mesh, spec.geom)
    params = mesh_mod.replicate(params, mesh)
    spec = dataclasses.replace(spec, mesh=mesh)
    state = stepper.setup(state, params, spec, dt=scene._dt)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    mesh.stats.clear()
    t0 = time.perf_counter()
    state = stepper.simulate(state, params, spec, steps)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    seconds = time.perf_counter() - t0
    n_after = mesh_mod.global_n_valid(state, mesh)
    if rank == 0:
        st = mesh.stats
        print(f"[launch] {model} {arg}={size} on {mesh.size} ranks "
              f"({backend}, {mesh.device}): {steps} steps in {seconds:.3f} s, "
              f"{n_total * steps / seconds:.4g} particle-steps/s; halo "
              f"{st.get('bytes', 0) / max(st.get('exchanges', 1), 1):.0f} "
              f"bytes an exchange, {st.get('exchanges', 0)} exchanges; "
              f"particles {n_total} -> {n_after}, overflow "
              f"{int(state.overflow)}, drift {int(state.drift_violation)}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m sph_bvf_tpu_torch.parallel.launch",
                                 description="Run a model over x-slab ranks.")
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--model", default="lid_cavity")
    ap.add_argument("--size", type=int, default=50,
                    help="N (nx for fsi and cell_polarization)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (a card a rank, cuda:rank %% count) or cpu")
    a = ap.parse_args(argv)
    spawn(run_model, a.nproc, a.backend,
          args=(a.model, a.size, a.steps, a.backend, a.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
