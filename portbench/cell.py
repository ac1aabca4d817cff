"""A benchmark cell found by name: its entry in ``BENCHMARK.json``, its
configuration (``configs/<config>.json``), its traffic
(``traffic/<traffic>.json``) and its own file (``workloads/<cell>.json``:
the kernels its route takes, the chunks it profiles, and the limits of its
comparison).  The configuration names the program's builder (``program``
and ``build_args``) and the plain reference (``reference``:
``reference/<name>.py``); ``build_program`` builds the cell's scene through
the program's public entry points."""

from __future__ import annotations

import dataclasses
import functools
import importlib
import importlib.util
import json
import sys
from pathlib import Path

import torch

from portbench.reference import judge

ROOT = Path(__file__).resolve().parent.parent
SNAP_FIELDS = judge.FIELDS + ("tag", "valid", "step")


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _module(path: Path, kind: str):
    """The module of the file ``path``, loaded once per process."""
    name = f"portbench_{kind}_{path.stem}_{abs(hash(str(path)))}"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    spec: dict  # workloads/<cell>.json
    end_to_end: list  # BENCHMARK.json entries this cell reports
    per_layer: list
    chips: int
    root: Path  # the checkout: BENCHMARK.json and portbench/

    def metric_reader(self, name: str):
        """The ``read`` function of ``portbench/metrics/<name>.py``."""
        path = self.root / "portbench" / "metrics" / f"{name}.py"
        return _module(path, "metric").read

    @functools.cached_property
    def reference(self):
        """The configuration's plain reference,
        ``portbench/reference/<reference>.py``: ``spacing(config)``,
        ``scene(config)`` and ``model(config, traffic, device, compute,
        drop)``."""
        name = self.config["reference"]
        path = self.root / "portbench" / "reference" / f"{name}.py"
        return _module(path, "reference")

    @property
    def dim(self) -> int:
        return self.config["dim"]

    def scene(self):
        """The reference's own build of the cell's scene."""
        return self.reference.scene(self.config)

    def model(self, device, compute=torch.float32, drop=()):
        """The reference's model of the cell (``physics.Model``)."""
        return self.reference.model(self.config, self.traffic, device,
                                    compute, drop)


def load(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``."""
    bench = _json(root / "BENCHMARK.json")
    data = root / "portbench"
    entry = [w for w in bench["workloads"] if w["name"] == name]
    if not entry:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = entry[0]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in moved)]
    return Cell(name=name,
                config=_json(data / "configs" / f"{entry['config']}.json"),
                traffic=_json(data / "traffic" / f"{entry['traffic']}.json"),
                spec=_json(data / "workloads" / f"{name}.json"),
                end_to_end=e2e, per_layer=layer, chips=entry["chips"],
                root=root)


def build_program(cell: Cell, device):
    """(state, params, spec) of the cell's scene, built by the program:
    the configuration's ``program`` module's ``build`` (its arguments taken
    from the configuration's keys as ``build_args`` maps them) or a script
    through ``api.lmp.parse_script``."""
    c, t = cell.config, cell.traffic
    if t["build"] == "model":
        mod = importlib.import_module(c["program"])
        state, params, spec, _ = mod.build(
            **{k: c[v] for k, v in c["build_args"].items()}, device=device)
    else:
        from sph_bvf_tpu_torch.api.lmp import parse_script

        text = (cell.root / t["script"]).read_text()
        model = parse_script(text, {k: c[v] for k, v in t["vars"].items()})
        state, params, spec = model.build(device=device)
    return state, params, spec


def clone_state(state):
    """A copy of a program state that shares no storage with it."""
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name).clone()
        for f in dataclasses.fields(state)
        if isinstance(getattr(state, f.name), torch.Tensor)})


def snapshot(state) -> dict:
    """Copies of the fields the judge reads (device copies: no host
    synchronisation)."""
    return {k: getattr(state, k).clone() for k in SNAP_FIELDS}


def apply_inputs(state, d: torch.Tensor, key: torch.Tensor):
    """The program's state with the seed's inputs: each fluid particle of
    tag t moved by row t-1 of ``d``, and the counter RNG's ``key``."""
    fluid = state.valid & (state.solid_tag == 0)
    dd = d[(state.tag.long() - 1).clamp(min=0)].movedim(-1, 0)
    x = state.x + torch.where(fluid[None], dd.to(state.x.dtype), 0.0)
    return dataclasses.replace(state, x=x, key=key)
