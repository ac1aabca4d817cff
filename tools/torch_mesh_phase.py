#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s [mesh] phase alone on the card
(``chip_smoke._mesh_phase``): each leg of ``MESH_LEGS`` with no mesh, then
by ``MESH_RANKS`` ranks sharing the card over gloo, held to each other,
with the slab kernels' checks and times.

    python3 tools/torch_mesh_phase.py [LEG ...]   # from the repository root

LEG names legs of ``MESH_LEGS`` to run (default: every one).  It builds
only the kernels the legs launch (K1, K2, K3, K5 and K6, K7).
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
    legs = sys.argv[1:]
    unknown = [leg for leg in legs if leg not in C.MESH_LEGS]
    if unknown:
        print(f"torch_mesh_phase: no leg {unknown}; the legs are "
              f"{list(C.MESH_LEGS)}", file=sys.stderr)
        return 2
    if legs:
        C.MESH_LEGS = {leg: C.MESH_LEGS[leg] for leg in legs}
    card = C._nvidia_smi("name,power.limit")
    t0 = time.perf_counter()
    rows = C._mesh_phase(torch, torch.device("cuda"), card)
    for row in rows:
        print(f"[mesh] {row}")
    print(f"[time] {time.perf_counter() - t0!r} s for the phase [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
