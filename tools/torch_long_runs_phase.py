#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s [long runs] phase alone on the card
(``chip_smoke._long_runs_phase``): ``tools/torch_ghia_benchmark.py``,
``tools/torch_nusselt.py`` and ``tools/torch_fsi_release.py`` through
their entry points at short horizons, held to the JAX package's Ghia
profile (``GHIA_JAX``), with their launch counts.

    python3 tools/torch_long_runs_phase.py      # from the repository root

It builds only the kernels the phase launches: K1 and K2
(``pass_a_2d``, ``pass_a_2d_rowloop``) and K5, whose library K6 shares
(``rebin_move_2d``).
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
    from sph_bvf_tpu_torch.ops import pair_cuda

    if not torch.cuda.is_available():
        print("torch_long_runs_phase: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    names = ("pass_a_2d", "pass_a_2d_rowloop", "rebin_move_2d")
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        for f in [pool.submit(_build.load, n) for n in names]:
            f.result()
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    counters = {n: getattr(pair_cuda, n) for n in (
        "pass_a_2d", "pass_a_2d_preshift", "pass_a_2d_rowloop", "pass_a_3d")}
    counters.update({n: getattr(rebin_cuda, n) for n in (
        "rebin_move_2d", "rebin_move_2d_gated", "rebin_move_3d")})
    C._long_runs_phase(torch, torch.device("cuda"),
                       C._nvidia_smi("name,power.limit"), counters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
