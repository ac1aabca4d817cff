#!/usr/bin/env python
"""Run a LAMMPS input script (the reference's .lmp files work unmodified)
on the PyTorch/CUDA port (``sph_bvf_tpu_torch``).

    python examples/torch_run_lmp_script.py path/to/lid_driven_cavity.lmp \
        --var nx 100 --max-steps 100000 --out out/
    python examples/torch_run_lmp_script.py examples/lid_cavity_ssa.lmp \
        --var N 16 --max-steps 20 --device cpu

--var NAME VALUE overrides `variable NAME equal ...` definitions, like the
reference's CLI -var flag (lammps.cpp:112-192); the arguments are those of
``examples/run_lmp_script.py`` (the JAX package's), plus ``--device``: the
torch device to run on, the card by default.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sph_bvf_tpu_torch.api.lmp import parse_script  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("script")
    ap.add_argument("--var", nargs=2, action="append", default=[],
                    metavar=("NAME", "VALUE"))
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--out", default="out")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    args = ap.parse_args(argv)

    overrides = {k: float(v) for k, v in args.var}
    with open(args.script) as f:
        model = parse_script(f.read(), overrides=overrides)
    state, params, spec = model.run(max_steps=args.max_steps, out_dir=args.out,
                                    device=args.device)
    print(f"done: step {int(state.step)}, {int(state.n_valid)} particles, "
          f"output in {args.out}/")


if __name__ == "__main__":
    main()
