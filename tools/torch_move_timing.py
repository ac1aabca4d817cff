#!/usr/bin/env python3
"""The rebin moves in the tree this runs from, on one CUDA card: the
registers and local bytes ptxas reports for K5's, K6's and K7's kernels,
then each kernel's ms per call on its main path's grid, as called (CUDA
events, 50 calls) and on the device (torch.profiler, 50 calls), with a
SHA-256 of its outputs: K5 on the flagship cavity at N=1000 (1,012,036
particles, cap 14) and K7 on the 3D cavity at N=100 (1.19M particles, cap
38), each after build and setup; with DIR, K7 also on the 3D states that
``tools/torch_pass_a3d_timing.py save DIR`` wrote (the 3D Taylor-Green
vortex N=100 at step 1000, cap 86; the balanced 3D blob s=8, ``x_edges`` on
a periodic grid, cap 86; the released 3D FSI beam nx=60, cap 296; the
spanwise-periodic cavity N=100, cap 49; the 3D cavity N=100, cap 38), on
the packs the main path's rebin hands it.

    python3 tools/torch_move_timing.py LABEL [DIR]

from the root of a checkout: it imports the package found there, so two
checkouts timed in turns in one call (parent / change / change / parent)
compare their kernels on one card, their hashes showing whether the
outputs are bitwise the same.
"""

import hashlib
import os
import sys

import torch

sys.path.insert(0, os.getcwd())

from sph_bvf_tpu_torch import _build  # noqa: E402
from sph_bvf_tpu_torch.core import rebin_cuda  # noqa: E402
from sph_bvf_tpu_torch.core import state as S  # noqa: E402
from sph_bvf_tpu_torch.core.stepper import _rebin_drop, setup  # noqa: E402
from sph_bvf_tpu_torch.io import checkpoint  # noqa: E402
from sph_bvf_tpu_torch.models import (drift_blob, fsi, lid_cavity,  # noqa: E402
                                      lid_cavity3d, taylor_green3d)

CALLS = 50
# the 3D states of tools/torch_pass_a3d_timing.py, by name, with the
# model's build (for its spec)
SAVED = {
    "3D tgv3d N=100 step 1000": lambda: taylor_green3d.build(100),
    "3D blob3d s=8 balanced": lambda: drift_blob.build(8, True, True,
                                                       nz_cells=3),
    "3D fsi3d nx=60 released": lambda: fsi.build_spanwise(60, tdamp_solid=500),
    "3D spanwise N=100": lambda: lid_cavity3d.build_spanwise(100),
    "3D cavity3d N=100": lambda: lid_cavity3d.build(N=100),
}


def _packs(state, geom, drop=()):
    fields = {k: v for k, v in S.particle_fields(state).items()
              if k not in drop}
    fields["x"] = S.wrap_pbc(fields["x"], geom)
    PF, PI, fmeta, _ = rebin_cuda._pack_fields(fields, geom.cap,
                                               geom.ncells_total)
    return PF, PI, rebin_cuda._x_row(fmeta)


def _digest(*outs) -> str:
    h = hashlib.sha256()
    for t in outs:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _time(label, wrapper, PF, PI, xr, geom, what):
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        out = wrapper(PF, PI, geom, xr)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(CALLS):
        wrapper(PF, PI, geom, xr)
    e1.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            wrapper(PF, PI, geom, xr)
        torch.cuda.synchronize()
    name = f"{wrapper.__name__}_kernel"
    hits = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and name in e.key]
    device_ms = (sum(e.self_device_time_total for e in hits)
                 / max(sum(e.count for e in hits), 1) / 1e3)
    print(f"{label} | {wrapper.__name__} | {what} | grid {geom.ncells} cap "
          f"{geom.cap} | as called ms {e0.elapsed_time(e1) / CALLS!r} | device "
          f"ms per call {device_ms!r} | sha256 {_digest(*out)} | "
          f"{[e.key[:60] for e in hits]}", flush=True)


def _saved(root):
    """(name, packs and geometry) of each saved 3D state."""
    for name, build in SAVED.items():
        path = os.path.join(root, name.replace(" ", "_").replace("=", "")
                            + ".npz")
        _, _, spec, _ = build()
        state, geom = checkpoint.load_with_geometry(path)
        packs = _packs(state, geom, _rebin_drop(spec))
        yield (f"{name}, {int(state.n_valid)} particles", packs, geom)
        del state, packs


def main() -> int:
    label = sys.argv[1]
    root = sys.argv[2] if len(sys.argv) > 2 else None
    if not torch.cuda.is_available():
        print("torch_move_timing: no CUDA device", file=sys.stderr)
        return 2
    for name in ("rebin_move_2d", "rebin_move_2d_gated", "rebin_move_3d"):
        _build.load(name)
        for line in _build.build_log.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(label, name, line.strip())
    state, params, spec, _ = lid_cavity.build(N=1000, dt=5e-6)
    state = setup(state, params, spec, dt=5e-6)
    _time(label, rebin_cuda.rebin_move_2d, *_packs(state, spec.geom),
          spec.geom, "flagship N=1000 after setup")
    del state
    state, params, spec, _ = lid_cavity3d.build(N=100)
    state = setup(state, params, spec, dt=1e-4)
    _time(label, rebin_cuda.rebin_move_3d, *_packs(state, spec.geom),
          spec.geom, "3D cavity N=100 after setup")
    del state
    if root:
        for what, (PF, PI, xr), geom in _saved(root):
            _time(label, rebin_cuda.rebin_move_3d, PF, PI, xr, geom, what)
    return 0


if __name__ == "__main__":
    sys.exit(main())
