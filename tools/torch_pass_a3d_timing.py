#!/usr/bin/env python3
"""The pass-A kernels in the tree this runs from, on one CUDA card, at the
states their main paths reach: K3 (3D) on the Taylor-Green vortex N=100 at
step 1000, the 3D drifting blob s=8 balanced (setup and 50 steps), the 3D
FSI beam nx=60 released (tdamp_solid 500, setup and 1000 steps), the
spanwise-periodic cavity N=100 and the 3D cavity N=100 (setup and 50 steps
each); K1 and K4 (2D, the grouped shape) on the flagship cavity N=1000 and
the cavity under the mechanics pair style N=1000 at step 1000; K2 (2D,
rowloop) on the 2D vortex N=1000 at step 1000, the 2D drifting blob s=20
balanced (setup and 50 steps), the FSI beam nx=60 released (tdamp_solid
500, setup and 1000 steps) and cell polarization at nx=100 (setup and 1000
steps) and nx=1000 (setup and 200 steps).

    python3 tools/torch_pass_a3d_timing.py save DIR [--only NAMES]
    python3 tools/torch_pass_a3d_timing.py time DIR LABEL [--keep] [--only NAMES]
    python3 tools/torch_pass_a3d_timing.py ops DIR LABEL [--only NAMES]
    python3 tools/torch_pass_a3d_timing.py steps DIR LABEL [--only NAMES]
    python3 tools/torch_pass_a3d_timing.py compare DIR LABEL_A LABEL_B
    python3 tools/torch_pass_a3d_timing.py bodies DIR
    python3 tools/torch_pass_a3d_timing.py tiles DIR

``save`` runs the states on the card and writes each with
``io/checkpoint.save`` under DIR, so that every tree times the same
particles.  ``time``, run from the root of a checkout (it imports the
package found there), loads each state with its geometry and, for each
kernel the state is timed with and the instantiation the state routes to
(density filter off, as a step between two filter steps, and on), prints
the registers and local bytes per thread, the wrapper's ms per call as
called (CUDA events, 20 calls after 3 warm-up calls; packing, staging and
index included) and its kernel's on the device (torch.profiler, 10 calls),
and a SHA-256 of every output field, so that two trees' outputs compare
bitwise by their hashes.  With ``--keep`` it also writes the outputs under
DIR/LABEL (~3 GB a label) for ``compare``, which prints each field's
max|a - b| / max|b| between two labels.  ``ops`` runs ``simulate`` from
each K2 and K3 state for one rebin period (at least 10 steps) after a
warm-up period and prints the device ops per step torch.profiler counts;
``steps`` times ``simulate`` from each state (particle-steps/s, three runs
of five rebin periods; the K1/K4 states once through each kernel).
``--only`` takes comma-separated parts of state names (e.g. ``2D,3D``).
``bodies`` times K3's two pair bodies on the solid-free states (the vortex
and the blob), which route to the transport-velocity body: that body as
routed beside the full body (``pair_cuda._mech_launch``), in turns, with
each one's largest field error against the plain loop.  ``tiles`` times
K1 on the flagship and mechanics states with each tile of ``TILES`` as its
first choice (``pair_cuda.K4_TILE``, K1's and K4's).  Two checkouts timed
in turns on one card (parent / change / change / parent), the other tree
unpacked under build/parent:

    python3 tools/torch_pass_a3d_timing.py save build/passa
    (cd build/parent && python3 ../../tools/torch_pass_a3d_timing.py time ../passa parent)
    python3 tools/torch_pass_a3d_timing.py time build/passa change
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import os
import sys
import time

import torch

sys.path.insert(0, os.getcwd())

from sph_bvf_tpu_torch.api.scene import Region, Scene  # noqa: E402
from sph_bvf_tpu_torch.core.fixes import SetForce  # noqa: E402
from sph_bvf_tpu_torch.core.stepper import setup, simulate  # noqa: E402
from sph_bvf_tpu_torch.io import checkpoint  # noqa: E402
from sph_bvf_tpu_torch.models import (cell_polarization, drift_blob,  # noqa: E402
                                      fsi, lid_cavity, lid_cavity3d,
                                      taylor_green2d, taylor_green3d)
from sph_bvf_tpu_torch.ops import pair, pair_cuda  # noqa: E402

CALLS, PROFILED = 20, 10
K1, K4, K2, K3 = ("pass_a_2d", "pass_a_2d_preshift", "pass_a_2d_rowloop",
                  "pass_a_3d")
# what each kernel's device-side names hold (K1's: "Neighbour" in trees that
# read j from the pack, "pa2d::window_" since it stages a window, which K4
# launches too; K4's: "Preshift" in trees that staged 9 copies, "preshift_"
# in those that staged every slot of a window)
DEVICE_NAMES = {K1: ("Neighbour", "pa2d::window_"),
                K4: ("Preshift", "preshift_", "pa2d::window_"),
                K2: ("pass_a_2d_rowloop",), K3: ("pass_a_3d",)}
# K1's tiles for ``tiles``: (cells along x, along y)
TILES = ((4, 8), (8, 4), (4, 4), (8, 8), (2, 16), (2, 8), (4, 16))
GROUPED_N, GROUPED_DT = 1000, 5e-3 / 1000  # chip_smoke.py's grouped paths


def _mechanics_cavity():
    return (*lid_cavity.scene(Scene, Region, SetForce, N=GROUPED_N,
                              pair_style="mechanics").build(), None)


def _cases():
    """name -> (the model's build on the card, dt, steps from the set-up
    state, the kernels it is timed with)."""
    return {
        "3D tgv3d N=100 step 1000": (lambda: taylor_green3d.build(100),
                                     taylor_green3d.timestep(100), 1000, (K3,)),
        "3D blob3d s=8 balanced": (lambda: drift_blob.build(8, True, True,
                                                            nz_cells=3),
                                   drift_blob.timestep(8), 50, (K3,)),
        "3D fsi3d nx=60 released": (
            lambda: fsi.build_spanwise(60, tdamp_solid=500), 1e-8, 1000, (K3,)),
        "3D spanwise N=100": (lambda: lid_cavity3d.build_spanwise(100), 1e-4,
                              50, (K3,)),
        "3D cavity3d N=100": (lambda: lid_cavity3d.build(N=100), 1e-4, 50,
                              (K3,)),
        "2D flagship N=1000 step 1000": (
            lambda: lid_cavity.build(N=GROUPED_N, dt=GROUPED_DT), GROUPED_DT,
            1000, (K1, K4)),
        "2D mechanics N=1000 step 1000": (_mechanics_cavity, GROUPED_DT, 1000,
                                          (K1, K4)),
        "2D tgv2d N=1000 step 1000": (lambda: taylor_green2d.build(1000),
                                      taylor_green2d.timestep(1000), 1000,
                                      (K2,)),
        "2D blob s=20 balanced": (lambda: drift_blob.build(20, True, True),
                                  drift_blob.timestep(20), 50, (K2,)),
        "2D fsi nx=60 released": (lambda: fsi.build(nx=60, tdamp_solid=500),
                                  1e-8, 1000, (K2,)),
        "2D polarization nx=100": (lambda: cell_polarization.build(nx=100),
                                   1e-10, 1000, (K2,)),
        "2D polarization nx=1000": (
            lambda: cell_polarization.build(nx=1000, dt=1e-11), 1e-11, 200,
            (K2,)),
    }


def _selected(only: str) -> dict:
    parts = [p for p in only.split(",") if p]
    return {name: case for name, case in _cases().items()
            if not parts or any(p in name for p in parts)}


def _path(root: str, name: str) -> str:
    return os.path.join(root, name.replace(" ", "_").replace("=", "") + ".npz")


def save(root: str, only: str = ""):
    os.makedirs(root, exist_ok=True)
    for name, (build, dt, steps, _) in _selected(only).items():
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


def _profiled(fn):
    """The device-side events of one profiled call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _device_ms(fn, calls: int, names=DEVICE_NAMES[K3]) -> float:
    events = _profiled(lambda: [fn() for _ in range(calls)])
    hits = [e for e in events if any(n in e.key for n in names)]
    return sum(e.self_device_time_total for e in hits) / calls / 1e3


def _loaded(root: str, name: str, build):
    """The saved state ``name``, the model's params and its spec on the
    saved geometry."""
    _, params, spec, _ = build()
    state, geom = checkpoint.load_with_geometry(_path(root, name))
    return state, params, dataclasses.replace(spec, geom=geom)


def time_trees(root: str, label: str, keep: bool = False, only: str = ""):
    kept = os.path.join(root, label)
    if keep:
        os.makedirs(kept, exist_ok=True)
    for name, (build, _, _, kernels) in _selected(only).items():
        state, params, spec = _loaded(root, name, build)
        geom = spec.geom
        for kname in kernels:
            wrapper = getattr(pair_cuda, kname)
            for filt in (False, True):
                cfg = dataclasses.replace(spec.pair, density_filter_accs=filt)
                pf = pair._per_particle(state, params, cfg)
                noise = pair.noise_inputs(state)

                def call():
                    return wrapper(pf, params, geom, cfg, noise)

                out = call()
                torch.cuda.synchronize()
                tv = kname != K2 and pair_cuda.tv_body(geom, cfg)
                attrs = pair_cuda.kernel_attributes(
                    wrapper, filt, params.n_sdpd, bool(cfg.elastic_present),
                    bool(cfg.thermal), tv)
                tag = f"{name} {kname} {'filter' if filt else 'nofilter'}"
                if keep:
                    torch.save({k: v.cpu() for k, v in out.items()},
                               os.path.join(kept, tag.replace(" ", "_") + ".pt"))
                print(f"{label} | {tag} | body {'tv' if tv else 'full'} | "
                      f"(registers, local bytes) {attrs} | as called ms "
                      f"{_ms(call, CALLS)!r} | device ms "
                      f"{_device_ms(call, PROFILED, DEVICE_NAMES[kname])!r} | "
                      f"sha256 {_digest(out)} | step {int(state.step)}, "
                      f"{int(state.n_valid)} particles, cells {geom.ncells}, "
                      f"cap {geom.cap}", flush=True)
                del out, pf
        del state


def ops(root: str, label: str, only: str = ""):
    """Device ops per step of ``simulate`` on the K2 and K3 states."""
    for name, (build, _, _, kernels) in _selected(only).items():
        if not {K2, K3} & set(kernels):
            continue
        state, params, spec = _loaded(root, name, build)
        steps = max(spec.rebin_every, 10)
        state = simulate(state, params, spec, steps)  # warm-up
        events = _profiled(lambda: simulate(state, params, spec, steps))
        names = DEVICE_NAMES[kernels[0]]
        launches = sum(e.count for e in events
                       if any(n in e.key for n in names))
        print(f"{label} | {name} | {steps} steps | device ops per step "
              f"{sum(e.count for e in events) / steps!r} | pass-A kernel "
              f"launches per step {launches / steps!r}", flush=True)
        del state


def steps(root: str, label: str, only: str = ""):
    """Particle-steps/s of ``simulate`` from each saved state, over five
    rebin periods (at least 50 steps) after a warm-up period, three runs,
    host clock ending in a synchronize; the K1/K4 states once through each
    (K4 with ``preshift_window``)."""
    for name, (build, _, _, kernels) in _selected(only).items():
        state, params, spec = _loaded(root, name, build)
        for kname in kernels:
            run = spec
            if kname == K4:
                run = dataclasses.replace(spec, pair=dataclasses.replace(
                    spec.pair, preshift_window=True))
            n = 5 * max(run.rebin_every, 10)
            simulate(state, params, run, run.rebin_every)  # warm-up
            rates = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                simulate(state, params, run, n)
                torch.cuda.synchronize()
                rates.append(int(state.n_valid) * n / (time.perf_counter() - t0))
            print(f"{label} | {name} | {kname} | {n} steps | particle-steps/s "
                  f"{rates!r} | median {sorted(rates)[1]!r}", flush=True)
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

    for name in ("3D tgv3d N=100 step 1000", "3D blob3d s=8 balanced"):
        state, params, spec = _loaded(root, name, _cases()[name][0])
        geom = spec.geom
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


def _grouped_states(root: str):
    """(name, state, params, geometry, cfg with the filter off, tv) of the
    flagship and the mechanics cavity."""
    for name in ("2D flagship N=1000 step 1000", "2D mechanics N=1000 step 1000"):
        state, params, spec = _loaded(root, name, _cases()[name][0])
        cfg = dataclasses.replace(spec.pair, density_filter_accs=False)
        yield name, state, params, spec.geom, cfg, pair_cuda.tv_body(spec.geom, cfg)
        del state


def tiles(root: str):
    for name, state, params, geom, cfg, tv in _grouped_states(root):
        pf = pair._per_particle(state, params, cfg)

        def call():
            return pair_cuda.pass_a_2d(pf, params, geom, cfg)

        for tile in TILES:
            pair_cuda.K4_TILE[tv] = tile
            print(f"tiles | {name} | body {'tv' if tv else 'full'} | tile "
                  f"{tile} | as called ms {_ms(call, CALLS)!r} | device ms "
                  f"{_device_ms(call, PROFILED, DEVICE_NAMES[K1])!r} | sha256 "
                  f"{_digest(call())}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("save", "time", "ops", "steps", "compare",
                                     "bodies", "tiles"))
    ap.add_argument("root")
    ap.add_argument("labels", nargs="*")
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--only", default="")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_pass_a3d_timing: no CUDA device", file=sys.stderr)
        return 2
    print(f"device {torch.cuda.get_device_name(0)}", flush=True)
    if a.mode == "save":
        save(a.root, a.only)
    elif a.mode == "time":
        time_trees(a.root, a.labels[0], a.keep, a.only)
    elif a.mode == "ops":
        ops(a.root, a.labels[0], a.only)
    elif a.mode == "steps":
        steps(a.root, a.labels[0], a.only)
    elif a.mode == "compare":
        compare(a.root, *a.labels)
    elif a.mode == "bodies":
        bodies(a.root)
    else:
        tiles(a.root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
