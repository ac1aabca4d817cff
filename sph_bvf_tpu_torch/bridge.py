"""Carry State, Params and ModelSpec between the JAX package and this port.

Numpy and plain dataclasses only: this module imports neither package's
framework on the JAX side.  A JAX object is read field by field
(``np.asarray`` works on its arrays), and a JAX object is rebuilt by the
caller from the numpy dict and the classes it passes in.  Layouts are the
same on both sides (scalars ``[cap, NC]``, vectors ``[3, cap, NC]``), so
every conversion is a copy, never a relayout.

The one dtype that differs is the PRNG key: the JAX package holds the raw
uint32 key words, the port an int64 pair of the same values.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from sph_bvf_tpu_torch.core import fixes as fixes_mod
from sph_bvf_tpu_torch.core.integrate import IntegratorConfig
from sph_bvf_tpu_torch.core.ssa import SsaConfig, SsaReaction
from sph_bvf_tpu_torch.core.state import Geometry, Params, State, resolve_device
from sph_bvf_tpu_torch.core.stepper import ModelSpec
from sph_bvf_tpu_torch.ops.pair import PairConfig
from sph_bvf_tpu_torch.parallel.balance import BalanceFix

# the fixes the port has, by class name
_FIXES = {name: getattr(fixes_mod, name)
          for name in ("SetForce", "Buffer", "Forcing", "Buoyancy",
                       "ChemRxnMassAction", "DtAdaptive")}


def to_numpy(obj) -> dict:
    """Every array field of a dataclass (JAX arrays or tensors) as numpy;
    plain Python fields pass through."""
    out = {}
    for f in dataclasses.fields(obj):
        a = getattr(obj, f.name)
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        elif hasattr(a, "__array__") and not isinstance(a, (int, float, bool)):
            a = np.asarray(a)
        out[f.name] = a
    return out


def state_to_port(arrays: Mapping[str, np.ndarray], device=None) -> State:
    """A port State on ``device`` (default: the card) from the JAX State's
    fields as numpy arrays."""
    device = resolve_device(device)
    kw = {}
    for f in dataclasses.fields(State):
        a = np.asarray(arrays[f.name])
        if f.name == "key":
            a = a.astype(np.int64)
        kw[f.name] = torch.as_tensor(np.array(a), device=device)
    return State(**kw)


def state_from_port(state: State) -> dict:
    """The port State as numpy arrays in the JAX State's dtypes."""
    out = to_numpy(state)
    out["key"] = out["key"].astype(np.uint32)
    return out


def params_to_port(params, device=None) -> Params:
    """A port Params on ``device`` (default: the card) from a JAX Params (or
    any object with its fields)."""
    device = resolve_device(device)
    kw = {}
    for f in dataclasses.fields(Params):
        a = getattr(params, f.name)
        kw[f.name] = (a if f.name in ("boltz", "ftm2v", "mvv2e")
                      else torch.as_tensor(np.array(a), device=device))
    return Params(**kw)


def _plain(cls, obj):
    """Rebuild a frozen config dataclass of ``cls`` from ``obj``'s fields."""
    return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})


def _ssa(cfg, config_cls, reaction_cls):
    """An ``SsaConfig`` of ``config_cls`` with its reactions rebuilt as
    ``reaction_cls`` (None stays None)."""
    if cfg is None:
        return None
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(config_cls)}
    fields["reactions"] = tuple(_plain(reaction_cls, rx) for rx in cfg.reactions)
    return config_cls(**fields)


def spec_to_port(spec, mesh=None) -> ModelSpec:
    """A port ModelSpec from a JAX ModelSpec, its geometry's ``x_edges``, its
    ``BalanceFix`` and its ``SsaConfig`` included.  A JAX mesh cannot cross:
    the port's spec runs over ``mesh``, the caller's
    ``parallel/mesh.Mesh`` (None: one device).  Raises for a fix the port
    does not have."""
    fixes = []
    for fx in spec.fixes:
        cls = _FIXES.get(type(fx).__name__)
        if cls is None:
            raise NotImplementedError(
                f"fix {type(fx).__name__} is ported in a later PR")
        fixes.append(_plain(cls, fx))
    return ModelSpec(
        geom=_plain(Geometry, spec.geom),
        pair=_plain(PairConfig, spec.pair),
        integ=_plain(IntegratorConfig, spec.integ),
        fixes=tuple(fixes),
        ssa=_ssa(spec.ssa, SsaConfig, SsaReaction),
        rebin_every=spec.rebin_every,
        mesh=mesh,
        balance=None if spec.balance is None else _plain(BalanceFix, spec.balance),
    )


def spec_from_port(spec: ModelSpec, classes: Mapping[str, type]):
    """A JAX ModelSpec from a port one; ``classes`` maps the names
    ModelSpec, Geometry, PairConfig, IntegratorConfig, BalanceFix and
    SsaConfig and SsaReaction (when the spec has them) and each fix's class
    name to the JAX package's classes."""
    return classes["ModelSpec"](
        geom=_plain(classes["Geometry"], spec.geom),
        pair=_plain(classes["PairConfig"], spec.pair),
        integ=_plain(classes["IntegratorConfig"], spec.integ),
        fixes=tuple(_plain(classes[type(fx).__name__], fx) for fx in spec.fixes),
        ssa=(None if spec.ssa is None else
             _ssa(spec.ssa, classes["SsaConfig"], classes["SsaReaction"])),
        rebin_every=spec.rebin_every,
        balance=(None if spec.balance is None
                 else _plain(classes["BalanceFix"], spec.balance)),
    )
