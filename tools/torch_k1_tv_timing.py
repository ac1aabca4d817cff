#!/usr/bin/env python3
"""K1's transport-velocity instantiations in the tree this runs from, on one
CUDA card: each one's registers and local bytes, then K1's ms per call on
the flagship cavity at N=1000 (setup and 100 steps, filter rows off) as
called (CUDA events, 20 calls) and on the device (torch.profiler, 20 calls).

    python3 tools/torch_k1_tv_timing.py LABEL

from the root of a checkout: it imports the package found there.
"""

import dataclasses
import os
import sys

import torch

sys.path.insert(0, os.getcwd())

from sph_bvf_tpu_torch.core.stepper import setup, simulate  # noqa: E402
from sph_bvf_tpu_torch.models import lid_cavity  # noqa: E402
from sph_bvf_tpu_torch.ops import pair, pair_cuda  # noqa: E402


def main() -> int:
    from torch.profiler import ProfilerActivity, profile

    label = sys.argv[1]
    regs = {f"{'f' if f else 'nf'}/{ns}{'/th' if th else ''}":
            pair_cuda.kernel_attributes(pair_cuda.pass_a_2d, f, ns,
                                        thermal=th, tv=True)
            for th in (False, True) for ns in range(5) for f in (True, False)}
    print(label, "K1 tv registers", regs)
    state, params, spec, _ = lid_cavity.build(N=1000, dt=5e-6)
    state = simulate(setup(state, params, spec, dt=5e-6), params, spec, 100)
    cfg = dataclasses.replace(spec.pair, density_filter_accs=False)
    args = (pair._per_particle(state, params, cfg), params, spec.geom, cfg)
    for _ in range(3):
        pair_cuda.pass_a_2d(*args)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(20):
        pair_cuda.pass_a_2d(*args)
    e1.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            pair_cuda.pass_a_2d(*args)
        torch.cuda.synchronize()
    # K1's kernel: pa2d::*<Neighbour> in trees that read j from the pack,
    # pa2d::window_* in those that stage a window
    hits = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and ("Neighbour" in e.key or "pa2d::window_" in e.key)]
    device_ms = (sum(e.self_device_time_total for e in hits)
                 / sum(e.count for e in hits) / 1e3)
    print(label, "K1 tv N=1000 step 100: as called ms",
          e0.elapsed_time(e1) / 20, "device ms per call", device_ms,
          [e.key[:60] for e in hits])
    return 0


if __name__ == "__main__":
    sys.exit(main())
