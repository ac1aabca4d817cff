#!/usr/bin/env python3
"""K3, the 3D pass-A kernel, in the tree this runs from, on one CUDA card,
at the states its main paths reach: the Taylor-Green vortex N=100 at step
1000, the 3D drifting blob s=8 balanced (setup and 50 steps), the 3D FSI
beam nx=60 released (tdamp_solid 500, setup and 1000 steps), the
spanwise-periodic cavity N=100 and the 3D cavity N=100 (setup and 50 steps
each).

    python3 tools/torch_pass_a3d_timing.py save DIR
    python3 tools/torch_pass_a3d_timing.py time DIR LABEL [keep [NAME]]
    python3 tools/torch_pass_a3d_timing.py compare DIR LABEL_A LABEL_B
    python3 tools/torch_pass_a3d_timing.py bodies DIR

``save`` runs the five states on the card and writes each with
``io/checkpoint.save`` under DIR, so that every tree times the same
particles.  ``time``, run from the root of a checkout (it imports the
package found there), loads each state with its geometry and, for the
instantiation the state routes to (density filter off, as a step between
two filter steps, and on), prints the registers and local bytes per thread,
K3's ms per call as called (CUDA events, 20 calls after 3 warm-up calls;
packing and staging included) and on the device (torch.profiler, 10 calls:
the kernels whose name holds ``pass_a_3d``), and a SHA-256 of every
output field, so that two trees' outputs compare bitwise by their hashes.
With ``keep`` it also writes the outputs under DIR/LABEL (~3 GB a label;
only the states whose name holds NAME, when given) for ``compare``, which
prints each field's max|a - b| / max|b| between two labels.  ``bodies``
times K3's two pair bodies on the solid-free states (the vortex and the
blob), which route to the transport-velocity body: that body as routed
beside the full body (``pair_cuda._mech_launch``), in turns, with each
one's largest field error against the plain loop.  Two checkouts timed
in turns on one card (parent / change / change / parent), the other tree
unpacked under build/parent:

    python3 tools/torch_pass_a3d_timing.py save build/k3ab
    (cd build/parent && python3 ../../tools/torch_pass_a3d_timing.py time ../k3ab parent)
    python3 tools/torch_pass_a3d_timing.py time build/k3ab change
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import sys
import time

import torch

sys.path.insert(0, os.getcwd())

from sph_bvf_tpu_torch.core.stepper import setup, simulate  # noqa: E402
from sph_bvf_tpu_torch.io import checkpoint  # noqa: E402
from sph_bvf_tpu_torch.models import (drift_blob, fsi, lid_cavity3d,  # noqa: E402
                                      taylor_green3d)
from sph_bvf_tpu_torch.ops import pair, pair_cuda  # noqa: E402

CALLS, PROFILED = 20, 10


def _cases():
    """name -> (the model's build on the card, dt, steps from the set-up
    state)."""
    return {
        "tgv3d N=100 step 1000": (lambda: taylor_green3d.build(100),
                                  taylor_green3d.timestep(100), 1000),
        "blob3d s=8 balanced": (lambda: drift_blob.build(8, True, True,
                                                         nz_cells=3),
                                drift_blob.timestep(8), 50),
        "fsi3d nx=60 released": (lambda: fsi.build_spanwise(60, tdamp_solid=500),
                                 1e-8, 1000),
        "spanwise N=100": (lambda: lid_cavity3d.build_spanwise(100), 1e-4, 50),
        "cavity3d N=100": (lambda: lid_cavity3d.build(N=100), 1e-4, 50),
    }


def _path(root: str, name: str) -> str:
    return os.path.join(root, name.replace(" ", "_").replace("=", "") + ".npz")


def save(root: str):
    os.makedirs(root, exist_ok=True)
    for name, (build, dt, steps) in _cases().items():
        t0 = time.perf_counter()
        state, params, spec, _ = build()
        log = []
        state = simulate(setup(state, params, spec, dt=dt), params, spec, steps,
                         balance_log=log if spec.balance is not None else None)
        cuts = [c["geom"] for c in log if c["geom"] is not None]
        geom = cuts[-1] if cuts else spec.geom
        checkpoint.save(_path(root, name), state, geom)
        print(f"saved {name}: step {int(state.step)}, {int(state.n_valid)} "
              f"particles, cells {geom.ncells}, cap {geom.cap}, in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        del state


def _digest(out: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(out):
        h.update(k.encode())
        h.update(out[k].contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _ms(fn, calls: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(calls):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / calls


def _device_ms(fn, calls: int) -> float:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "pass_a_3d" in e.key]
    return sum(e.self_device_time_total for e in hits) / calls / 1e3


def time_trees(root: str, label: str, keep: bool = False, only: str = ""):
    kept = os.path.join(root, label)
    if keep:
        os.makedirs(kept, exist_ok=True)
    for name, (build, _, _) in _cases().items():
        _, params, spec, _ = build()
        state, geom = checkpoint.load_with_geometry(_path(root, name))
        for filt in (False, True):
            cfg = dataclasses.replace(spec.pair, density_filter_accs=filt)
            pf = pair._per_particle(state, params, cfg)
            noise = pair.noise_inputs(state)

            def call():
                return pair_cuda.pass_a_3d(pf, params, geom, cfg, noise)

            out = call()
            torch.cuda.synchronize()
            tv = pair_cuda.tv_body(geom, cfg)
            attrs = pair_cuda.kernel_attributes(
                pair_cuda.pass_a_3d, filt, params.n_sdpd,
                bool(cfg.elastic_present), bool(cfg.thermal), tv)
            tag = f"{name} {'filter' if filt else 'nofilter'}"
            if keep and only in name:
                torch.save({k: v.cpu() for k, v in out.items()},
                           os.path.join(kept, tag.replace(" ", "_") + ".pt"))
            print(f"{label} | {tag} | body {'tv' if tv else 'full'} | "
                  f"(registers, local bytes) {attrs} | as called ms "
                  f"{_ms(call, CALLS)!r} | device ms {_device_ms(call, PROFILED)!r} "
                  f"| sha256 {_digest(out)} | step {int(state.step)}, "
                  f"{int(state.n_valid)} particles, cap {geom.cap}", flush=True)
            del out, pf
        del state


def compare(root: str, a: str, b: str):
    for fname in sorted(os.listdir(os.path.join(root, a))):
        oa = torch.load(os.path.join(root, a, fname))
        ob = torch.load(os.path.join(root, b, fname))
        errs = {k: float((oa[k] - ob[k]).abs().max()
                         / max(float(ob[k].abs().max()), 1e-30))
                for k in sorted(ob) if ob[k].numel()}
        same = all(torch.equal(oa[k], ob[k]) for k in ob)
        print(f"compare {a} / {b} | {fname} | bitwise {same} | max|a-b|/max|b| "
              + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()), flush=True)


def bodies(root: str):
    import ctypes

    for name in ("tgv3d N=100 step 1000", "blob3d s=8 balanced"):
        _, params, spec, _ = _cases()[name][0]()
        state, geom = checkpoint.load_with_geometry(_path(root, name))
        cfg = dataclasses.replace(spec.pair, density_filter_accs=False)
        pf = pair._per_particle(state, params, cfg)
        noise = pair.noise_inputs(state)
        calls = {
            "tv (routed)": lambda: pair_cuda.pass_a_3d(pf, params, geom, cfg,
                                                       noise),
            "full": lambda: pair_cuda._mech_launch(
                pair_cuda.pass_a_3d, geom.ncells, pf, params, geom, cfg,
                noise, [(ctypes.c_int, 1)]),
        }
        ref = pair._pass_a_plain(pf, params, geom, cfg, noise,
                                 cells_per_piece=4000)
        for body in ("tv (routed)", "full", "full", "tv (routed)"):
            out = calls[body]()
            err = max(float((out[k] - ref[k]).abs().max()
                            / max(float(ref[k].abs().max()), 1e-30))
                      for k in ref if ref[k].numel())
            print(f"bodies | {name} | {body} | device ms "
                  f"{_device_ms(calls[body], PROFILED)!r} | max field error "
                  f"against the plain loop {err:.3g}", flush=True)


def main() -> int:
    mode, root = sys.argv[1], sys.argv[2]
    if not torch.cuda.is_available():
        print("torch_pass_a3d_timing: no CUDA device", file=sys.stderr)
        return 2
    print(f"device {torch.cuda.get_device_name(0)}", flush=True)
    if mode == "save":
        save(root)
    elif mode == "time":
        time_trees(root, sys.argv[3], sys.argv[4:5] == ["keep"],
                   "".join(sys.argv[5:6]))
    elif mode == "compare":
        compare(root, sys.argv[3], sys.argv[4])
    elif mode == "bodies":
        bodies(root)
    else:
        raise SystemExit(f"unknown mode {mode!r}: save, time, compare or "
                         f"bodies")
    return 0


if __name__ == "__main__":
    sys.exit(main())
