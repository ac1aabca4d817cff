#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s SSA, integrator and front-end phases alone on
the card (``chip_smoke._ssa_paths``): [main lmp ssa], [K5 ssa], [speed lmp
ssa], [main ssa golden], [main integrators] and [ensemble].

    python3 tools/torch_ssa_phases.py      # from the repository root

It builds only K1 and K5 (``pass_a_2d``, ``rebin_move_2d``), the kernels
these phases launch, and compares the card with the CPU as chip_smoke's
``card_vs_cpu`` does (the same bounds).
"""

import concurrent.futures
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    import chip_smoke as C
    from sph_bvf_tpu_torch import _build
    from sph_bvf_tpu_torch.core import rebin_cuda
    from sph_bvf_tpu_torch.core import state as S
    from sph_bvf_tpu_torch.core.stepper import setup, simulate
    from sph_bvf_tpu_torch.ops import pair_cuda

    if not torch.cuda.is_available():
        print("torch_ssa_phases: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(_build.load, n)
                  for n in ("pass_a_2d", "rebin_move_2d")]:
            f.result()
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = C._nvidia_smi("name,power.limit")
    counters = {n: getattr(pair_cuda, n) for n in (
        "pass_a_2d", "pass_a_2d_preshift", "pass_a_2d_rowloop", "pass_a_3d")}
    counters.update({n: getattr(rebin_cuda, n) for n in (
        "rebin_move_2d", "rebin_move_2d_gated", "rebin_move_3d")})
    bounds = {"x": 1e-5, "v": 1e-3, "rho": 1e-4, "S": 1e-3, "C": 1e-4}

    def card_vs_cpu(label, path, build, dt, fields):
        runs = {}
        for where in ("cpu", dev):
            s, p, sp, _ = build(where)
            s = simulate(setup(s, p, sp, dt=dt), p, sp, C.SMALL_STEPS[path])
            runs[str(where)] = S.gather_particles(s, sp.geom, fields)
        a, b = runs["cpu"], runs[str(dev)]
        rel = {k: float(abs(a[k] - b[k]).max())
               / max(float(abs(a[k]).max()), 1e-30) for k in fields}
        if not ((a["tag"] == b["tag"]).all()
                and all(rel[k] <= bounds[k] for k in fields)):
            raise AssertionError(f"{label} card run != CPU plain run: {rel}")
        print(f"[main] {label}: card vs CPU {rel} (bounds {bounds})", flush=True)
        return s

    t0 = time.perf_counter()
    C._ssa_paths(torch, dev, card, kind, counters, card_vs_cpu)
    print(f"[time] {time.perf_counter() - t0!r} s for the phases [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
