"""A checkout of the benchmark at CPU sizes: ``BENCHMARK.json`` and the
data under ``portbench/`` copied into a directory, with each
configuration cut by its ``dim`` to a lattice the port's plain CPU path
runs in seconds (a 2D cavity at N=20, a 3D one at N=6)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
TINY = {2: dict(N=20, dt=1e-4, particles=676, cells=81, cap=14),
        3: dict(N=6, dt=1e-4, particles=1728, cells=64, cap=38)}
DATA = ("configs", "traffic", "workloads", "metrics", "scripts", "reference")


def make(dest: Path) -> Path:
    """``dest`` as a tiny checkout; returns it."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    for d in DATA:
        shutil.copytree(ROOT / "portbench" / d, dest / "portbench" / d)
    for path in (dest / "portbench" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg.update(TINY[cfg["dim"]])
        path.write_text(json.dumps(cfg))
    return dest


def last_line(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])
