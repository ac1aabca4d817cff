#!/usr/bin/env python3
"""The JAX package's own run of the lid-driven cavity under the mechanics
pair style: the reference values ``chip_smoke.py`` holds the PyTorch
port's run of the same scene to (``MECH_JAX``).

    JAX_PLATFORMS=cpu python3 tests/jax_mechanics_cavity_run.py N STEPS CHUNK

builds ``models/lid_cavity.scene(N=N, pair_style="mechanics")`` from the
JAX package's classes, runs ``setup`` and ``simulate`` on its jnp path
(``use_pallas=False``, f32) at the model's dt and prints, every CHUNK
steps, the fluid's max|rho - 1| and where it sits, its mean rho, max|v|
and kinetic energy (as ``chip_smoke._cavity_energy`` sums it).  Not a
test: pytest collects ``test_*.py`` only.
"""

import dataclasses
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sph_bvf_tpu.api import scene as jscene  # noqa: E402
from sph_bvf_tpu.core import fixes as jfixes  # noqa: E402
from sph_bvf_tpu.core import stepper as jstepper  # noqa: E402
from sph_bvf_tpu_torch.models import lid_cavity  # noqa: E402


def main() -> int:
    N, steps, chunk = (int(a) for a in sys.argv[1:4])
    state, params, spec = lid_cavity.scene(
        jscene.Scene, jscene.Region, jfixes.SetForce, N=N,
        pair_style="mechanics").build()
    spec = dataclasses.replace(
        spec, pair=dataclasses.replace(spec.pair, use_pallas=False))
    dt = 1e-4 if N <= 200 else 5e-3 / N  # lid_cavity's dt rule
    state = jstepper.setup(state, params, spec, dt=dt)
    mass = np.asarray(params.mass)
    t0 = time.perf_counter()
    for _ in range(steps // chunk):
        state = jstepper.simulate(state, params, spec, chunk)
        x, v, rho = (np.asarray(a) for a in (state.x, state.v, state.rho))
        fluid = np.asarray(state.valid) & (np.asarray(state.solid_tag) == 0)
        dev = np.where(fluid, np.abs(rho - 1), 0.0)
        at = np.unravel_index(dev.argmax(), dev.shape)
        vsq = (v * v).sum(0)
        mv2 = (np.float32(0.5) * mass[np.asarray(state.ptype)] * vsq)
        print(f"JAX mechanics N={N} step {int(state.step)}: fluid max|rho-1| "
              f"{float(dev.max())!r} at ({x[0][at]:.4f}, {x[1][at]:.4f}), "
              f"mean {float(rho[fluid].astype(np.float64).mean())!r}, max|v| "
              f"{float(np.sqrt(vsq[fluid].max()))!r}, ke "
              f"{float(mv2[fluid].astype(np.float64).sum())!r}, overflow "
              f"{int(state.overflow)} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
