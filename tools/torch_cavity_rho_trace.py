#!/usr/bin/env python3
"""The fluid's density extreme of the PyTorch port's lid-driven cavity,
through each pass-A route, on one CUDA card.

    python3 tools/torch_cavity_rho_trace.py N STEPS PAIR_STYLE ROUTES

builds ``lid_cavity.scene(N=N, pair_style=PAIR_STYLE)`` on the card, runs
``setup`` and ``simulate`` at the model's dt with pass A through each of
ROUTES (comma-separated: "K1", the grid's own route; "K2", the rowloop
kernel; "plain", the plain PyTorch loop on the card, which no entry point
takes) and prints, every 100 steps, the fluid's max|rho - 1| and where it
sits, its mean rho and max|v|.  The plain loop's value at N=1000 is the
reference ``chip_smoke.py`` holds the mechanics cavity's main path to.
"""

import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sph_bvf_tpu_torch.api.scene import Region, Scene  # noqa: E402
from sph_bvf_tpu_torch.core.fixes import SetForce  # noqa: E402
from sph_bvf_tpu_torch.core.stepper import setup, simulate  # noqa: E402
from sph_bvf_tpu_torch.models import lid_cavity  # noqa: E402
from sph_bvf_tpu_torch.ops import pair, pair_cuda  # noqa: E402


def _plain(pf, params, geom, cfg, noise=None):
    return pair._pass_a_plain(pf, params, geom, cfg, noise)


def main() -> int:
    N, steps, style = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    route = pair_cuda.route
    routes = {"K1": route,
              "K2": lambda geom, cfg: pair_cuda.pass_a_2d_rowloop,
              "plain": lambda geom, cfg: _plain}
    for which in sys.argv[4].split(","):
        pair_cuda.route = routes[which]
        state, params, spec = lid_cavity.scene(Scene, Region, SetForce, N=N,
                                               pair_style=style).build()
        dt = 1e-4 if N <= 200 else 5e-3 / N  # lid_cavity's dt rule
        state = setup(state, params, spec, dt=dt)
        t0 = time.perf_counter()
        for _ in range(steps // 100):
            state = simulate(state, params, spec, 100)
            fluid = state.valid & (state.solid_tag == 0)
            dev = torch.where(fluid, (state.rho - 1).abs(), 0.0)
            x = state.x.reshape(3, -1)[:, int(dev.argmax())]
            vmax = torch.sqrt((state.v * state.v).sum(0))[fluid].max()
            print(f"{style} N={N} {which} step {int(state.step)}: fluid "
                  f"max|rho-1| {float(dev.max())!r} at ({float(x[0]):.4f}, "
                  f"{float(x[1]):.4f}), mean "
                  f"{float(state.rho[fluid].double().mean())!r}, max|v| "
                  f"{float(vmax)!r} ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
    pair_cuda.route = route
    return 0


if __name__ == "__main__":
    sys.exit(main())
