#!/usr/bin/env python
"""Run any of the paper-example models with thermo + VTK output, on the
PyTorch/CUDA port (``sph_bvf_tpu_torch``).

    python examples/torch_run_model.py lid_cavity --n 100 --steps 20000 --out out/
    python examples/torch_run_model.py natural_convection --steps 50000
    python examples/torch_run_model.py fsi --steps 10000
    python examples/torch_run_model.py cell_polarization --steps 4000
    python examples/torch_run_model.py lid_cavity --n 16 --steps 20 --device cpu

The arguments of ``examples/run_model.py`` (the JAX package's), plus
``--device``: the torch device to run on, the card by default.  The
reference's own .lmp scripts run through
``python examples/torch_run_lmp_script.py <script.lmp>``.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sph_bvf_tpu_torch.core.stepper import setup, simulate  # noqa: E402
from sph_bvf_tpu_torch.io.vtk import dump_state  # noqa: E402
from sph_bvf_tpu_torch.models import REGISTRY  # noqa: E402
from sph_bvf_tpu_torch.utils.thermo import ThermoLogger  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("model", choices=sorted(REGISTRY))
    ap.add_argument("--n", type=int, default=None, help="grid size (model-specific)")
    ap.add_argument("--steps", type=int, default=10000)
    ap.add_argument("--dump-every", type=int, default=1000)
    ap.add_argument("--out", default="out")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    args = ap.parse_args(argv)

    kwargs = {}
    if args.n is not None:
        key = "N" if args.model in ("lid_cavity", "natural_convection") else "nx"
        kwargs[key] = args.n
    state, params, spec, sc = REGISTRY[args.model](**kwargs, device=args.device)
    state = setup(state, params, spec, dt=sc._dt)
    os.makedirs(args.out, exist_ok=True)
    logger = ThermoLogger(params)

    fields = ["rho", "phi"] + (["C"] if params.n_sdpd else []) + (
        ["Cd"] if params.n_ssa else []
    )

    def callback(st):
        logger(st)
        stepno = int(st.step)
        if stepno % args.dump_every == 0:
            dump_state(
                os.path.join(args.out, f"{args.model}_{stepno}.vtk"),
                st, spec.geom, fields=tuple(fields),
            )

    dump_every = max(args.dump_every - args.dump_every % spec.rebin_every,
                     spec.rebin_every)
    state = simulate(state, params, spec, args.steps,
                     callback=callback, callback_every=dump_every)
    print(f"done: step {int(state.step)}, {int(state.n_valid)} particles, "
          f"output in {args.out}/")


if __name__ == "__main__":
    main()
