#!/usr/bin/env python3
"""The JAX package's own short run of the Ghia cavity: the reference values
``chip_smoke.py`` holds the PyTorch port's ``tools/torch_ghia_benchmark.py``
to (``GHIA_JAX``).

    JAX_PLATFORMS=cpu python3 tests/jax_ghia_run.py [N] [STEPS] [RE]

(defaults 50, 5000, 100) builds the JAX package's
``lid_cavity.build(N, Re, rebin_every=10)``, runs ``setup`` and
``run_chunk(..., 10)`` at ``tools/ghia_benchmark.py``'s dt as that tool
does (f32, its jnp path on the CPU) and prints the seven u values along
the vertical centerline, the max|u - Ghia|, the overflow and the particle
count.  Not a test: pytest collects ``test_*.py`` only.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# tools/ghia_benchmark.py:19-27 (its module runs at import: not imported)
YS = np.array([0.9766, 0.8516, 0.7344, 0.5000, 0.2813, 0.1016, 0.0547])
GHIA_U100 = [0.84123, 0.23151, 0.00332, -0.20581, -0.15662, -0.06434, -0.03717]
DT = {100: 1e-4, 1000: 8e-5}


def jax_tool_profile(x, v, solid_tag, N):
    """``tools/ghia_benchmark.py:35-48``'s formula, copied: the fluid's
    v_x under a Gaussian weight of width 1.5 dx around (0.5, y), for each
    of the seven y, on gathered [n, 3] x and v."""
    fl = solid_tag == 0
    x, v = x[fl], v[fl]
    dx = 1.0 / N
    w = [np.exp(-(((x[:, 0] - 0.5) ** 2 + (x[:, 1] - y) ** 2)
                  / (1.5 * dx) ** 2)) for y in YS]
    return np.array([(wi * v[:, 0]).sum() / wi.sum() for wi in w])


def main() -> int:
    from sph_bvf_tpu.core.state import gather_particles
    from sph_bvf_tpu.core.stepper import run_chunk, setup
    from sph_bvf_tpu.models import lid_cavity

    args = [int(a) for a in sys.argv[1:4]]
    N, steps, re = args + [50, 5000, 100][len(args):]
    state, params, spec, _ = lid_cavity.build(N=N, Re=float(re),
                                              rebin_every=10)
    state = setup(state, params, spec, dt=DT[re])
    t0 = time.perf_counter()
    for _ in range(steps // 10):
        state = run_chunk(state, params, spec, 10)
    out = gather_particles(state, spec.geom, fields=("x", "v", "solid_tag"))
    u = jax_tool_profile(out["x"], out["v"], out["solid_tag"], N)
    print(f"JAX ghia N={N} Re={re} step {int(state.step)}: u "
          f"{[float(a) for a in u]!r}; max|u - Ghia| "
          f"{float(np.abs(u - np.array(GHIA_U100)).max())!r} (Re100's "
          f"column); "
          f"overflow {int(state.overflow)}, particles {int(state.n_valid)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
