"""Reference-compatible command line: ``python -m sph_bvf_tpu_torch -in X.lmp``.

Port of ``sph_bvf_tpu/__main__.py``: the flag surface of the reference's
`lmp` binary (main.cpp:35, lammps.cpp:112-192), so a published run command
translates directly:

    mpirun -np 4 lmp_mpi -in cavity.lmp -var nx 100 -log log.cavity
  ->     python -m sph_bvf_tpu_torch -in cavity.lmp -var nx 100 -log log.cavity

Flags:
  -in/-i FILE      input script (required; "-" reads stdin)
  -var/-v N V      override `variable N equal ...` (repeatable)
  -log/-l FILE     append thermo rows to FILE ("none" disables the file)
  -echo/-e MODE    none|screen|log|both: echo the script (input.cpp:151)
  -sf/-suffix S    accepted and ignored: the kernels are native here (the
                   hand-written CUDA kernels replace /omp and /gpu)
  -partition       refused, with a pointer to parallel/ensemble.py (replica
                   ensembles in one process, not process partitions)

Beyond the reference's flags (all optional): --max-steps caps the `run N`
directive, --out sets the dump/restart directory, --device picks the
device (default: the card, ``cuda``; ``cpu`` runs the plain paths).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None, result=None):
    """Run the script the flags name; 0 when it ran.  ``result`` (a dict,
    for a Python caller) receives the run's ``state``, ``params``, ``spec``
    and parsed ``model``."""
    ap = argparse.ArgumentParser(
        prog="python -m sph_bvf_tpu_torch",
        description="Run a LAMMPS-style SPH-BVF input script on a CUDA card.",
    )
    ap.add_argument("-in", "-i", dest="infile", required=True,
                    help="input script (.lmp), or - for stdin")
    ap.add_argument("-var", "-v", nargs=2, action="append", default=[],
                    metavar=("NAME", "VALUE"), dest="var")
    ap.add_argument("-log", "-l", dest="log", default=None,
                    help="thermo log file ('none' for screen only)")
    ap.add_argument("-echo", "-e", dest="echo", default="none",
                    choices=("none", "screen", "log", "both"))
    ap.add_argument("-sf", "-suffix", dest="suffix", default=None,
                    help="accepted and ignored (kernels are native)")
    ap.add_argument("-partition", dest="partition", default=None)
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--out", default="out")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    args = ap.parse_args(argv)

    if args.partition is not None:
        ap.error("-partition: use sph_bvf_tpu_torch.parallel.ensemble "
                 "(replica runs in one process) instead of process partitions")

    from sph_bvf_tpu_torch.api.lmp import parse_script

    if args.infile == "-":
        text = sys.stdin.read()
    else:
        with open(args.infile) as f:
            text = f.read()

    log_file = None if args.log in (None, "none") else args.log
    if args.echo in ("screen", "both"):
        for line in text.splitlines():
            print(line)
    if args.echo in ("log", "both") and log_file:
        with open(log_file, "a") as f:
            f.write(text if text.endswith("\n") else text + "\n")

    overrides = {k: float(v) for k, v in args.var}
    model = parse_script(text, overrides=overrides)
    state, params, spec = model.run(
        max_steps=args.max_steps, out_dir=args.out, log_file=log_file,
        device=args.device,
    )
    if result is not None:
        result.update(state=state, params=params, spec=spec, model=model)
    import torch

    where = (torch.cuda.get_device_name(state.x.device)
             if state.x.is_cuda else str(state.x.device))
    print(f"done: step {int(state.step)}, {int(state.n_valid)} particles, "
          f"output in {args.out}/, on {where}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
