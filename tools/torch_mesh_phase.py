#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s [mesh] phase alone on the card
(``chip_smoke._mesh_phase``): each leg of ``MESH_LEGS`` with no mesh, then
by ``MESH_RANKS`` ranks sharing the card over gloo, held to each other,
with the slab kernels' checks and times.

    python3 tools/torch_mesh_phase.py      # from the repository root

It builds only the kernels the legs launch (K1, K2, K3, K5 and K6, K7).
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

    if not torch.cuda.is_available():
        print("torch_mesh_phase: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    names = ("pass_a_2d", "pass_a_2d_rowloop", "pass_a_3d", "rebin_move_2d",
             "rebin_move_3d")
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        for f in [pool.submit(_build.load, n) for n in names]:
            f.result()
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    card = C._nvidia_smi("name,power.limit")
    t0 = time.perf_counter()
    rows = C._mesh_phase(torch, torch.device("cuda"), card)
    for row in rows:
        print(f"[mesh] {row}")
    print(f"[time] {time.perf_counter() - t0!r} s for the phase [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
