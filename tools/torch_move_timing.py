#!/usr/bin/env python3
"""K5 and K7 on wall grids in the tree this runs from, on one CUDA card: the
registers and local bytes ptxas reports for their kernels, then each
kernel's ms per call on its main path's grid, as called (CUDA events, 50
calls) and on the device (torch.profiler, 50 calls): K5 on the flagship
cavity at N=1000 (1,012,036 particles, cap 14) and K7 on the 3D cavity at
N=100 (1.19M particles, cap 38), each after build and setup.

    python3 tools/torch_move_timing.py LABEL

from the root of a checkout: it imports the package found there, so two
checkouts timed in turns in one call compare their kernels on one card.
"""

import os
import sys

import torch

sys.path.insert(0, os.getcwd())

from sph_bvf_tpu_torch import _build  # noqa: E402
from sph_bvf_tpu_torch.core import rebin_cuda  # noqa: E402
from sph_bvf_tpu_torch.core import state as S  # noqa: E402
from sph_bvf_tpu_torch.core.stepper import setup  # noqa: E402
from sph_bvf_tpu_torch.models import lid_cavity, lid_cavity3d  # noqa: E402

CALLS = 50


def _packs(state, geom):
    fields = S.particle_fields(state)
    fields["x"] = S.wrap_pbc(fields["x"], geom)
    PF, PI, fmeta, _ = rebin_cuda._pack_fields(fields, geom.cap,
                                               geom.ncells_total)
    return PF, PI, rebin_cuda._x_row(fmeta)


def _time(label, wrapper, state, geom):
    from torch.profiler import ProfilerActivity, profile

    PF, PI, xr = _packs(state, geom)
    for _ in range(3):
        wrapper(PF, PI, geom, xr)
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
                 / sum(e.count for e in hits) / 1e3)
    print(label, wrapper.__name__, f"grid {geom.ncells} cap {geom.cap}, "
          f"{int(state.n_valid)} particles: as called ms",
          e0.elapsed_time(e1) / CALLS, "device ms per call", device_ms,
          [e.key[:60] for e in hits], flush=True)


def main() -> int:
    label = sys.argv[1]
    for name in ("rebin_move_2d", "rebin_move_3d"):
        _build.load(name)
        for line in _build.build_log.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(label, name, line.strip())
    state, params, spec, _ = lid_cavity.build(N=1000, dt=5e-6)
    state = setup(state, params, spec, dt=5e-6)
    _time(label, rebin_cuda.rebin_move_2d, state, spec.geom)
    del state
    state, params, spec, _ = lid_cavity3d.build(N=100)
    state = setup(state, params, spec, dt=1e-4)
    _time(label, rebin_cuda.rebin_move_3d, state, spec.geom)
    return 0


if __name__ == "__main__":
    sys.exit(main())
