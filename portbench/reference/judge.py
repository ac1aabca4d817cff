"""The comparison that decides ``correct``: the program's outputs, read per
particle tag, against the reference's (plain PyTorch; imports nothing of
the program).

A program state reaches this module as a dict of plain tensors in the
cell-slot layout ([..., cap, NC], component axes first): ``tag``,
``valid`` and the fields named in ``FIELDS``.  ``per_tag`` turns it into
``physics.Particles`` indexed by tag - 1, with the flat cell each tag sits
in; the reference's own numbers then judge it.
"""

from __future__ import annotations

import torch

from portbench.reference.physics import Particles

FIELDS = ("x", "v", "vest", "f", "ddv", "rho", "rhoI", "drho", "Cd",
          "ptype", "solid_tag", "fixed_tag")


def tags(tag: torch.Tensor, valid: torch.Tensor, n: int) -> tuple:
    """(index = tag - 1 of each valid slot, the flat slots, the count of
    tags 1..n seen other than once plus tags outside 1..n)."""
    flat_valid = valid.reshape(-1)
    t = tag.reshape(-1)[flat_valid].long()
    seen = torch.bincount(t.clamp(1, n) - 1, minlength=n)
    bad = int((seen != 1).sum()) + int(((t < 1) | (t > n)).sum())
    return t.clamp(1, n) - 1, torch.nonzero(flat_valid).reshape(-1), bad


def per_tag(slots: dict, n: int, dtype=torch.float32):
    """(Particles, the flat cell of each tag, its type, solid and fixed
    flags, ``tags``' count of bad tags) of a slot-layout state of ``n``
    particles."""
    valid = slots["valid"]
    NC = valid.shape[-1]
    flat_valid = valid.reshape(-1)
    idx, slot, bad = tags(slots["tag"], valid, n)

    def take(name):
        a = slots[name]
        a = a.reshape(a.shape[:-2] + (flat_valid.numel(),))
        a = a[..., flat_valid].movedim(-1, 0)
        out = torch.zeros((n,) + tuple(a.shape[1:]), dtype=a.dtype,
                          device=a.device)
        out[idx] = a
        return out

    vec = lambda k: take(k).to(dtype)
    p = Particles(x=vec("x"), v=vec("v"), vest=vec("vest"), f=vec("f"),
                  ddv=vec("ddv"), rho=vec("rho"), rhoI=vec("rhoI"),
                  drho=vec("drho"), Cd=take("Cd").to(torch.int32),
                  step=int(slots["step"]))
    cell = torch.full((n,), -1, dtype=torch.int64, device=valid.device)
    cell[idx] = slot % NC
    flags = {k: take(k) for k in ("ptype", "solid_tag", "fixed_tag")}
    return p, cell, flags, bad


# The quantile of the particles' errors that a chunk number reads: all
# particles but one in 10,000 lie within it.  A bounce-back
# decision at phi = 0.5 that rounding flips moves one particle by up to
# 2 dt |v| and its neighbours' forces after it (a handful of particles,
# on about one seed in five of the 3D cell); the largest error over all
# particles reads that and not the program.
QUANTILE = 0.9999


def _max_rel(a, b, scale):
    d = (a.to(torch.float64) - b.to(torch.float64)).abs().max()
    return float(d) / float(scale)


def _q_rel(a, b, scale):
    """The ``QUANTILE`` of the particles' largest component error, over
    ``scale``."""
    d = (a.to(torch.float64) - b.to(torch.float64)).abs()
    d = d.reshape(d.shape[0], -1).amax(1)
    k = min(int(QUANTILE * d.numel()), d.numel() - 1)
    return float(torch.kthvalue(d.cpu(), k + 1).values) / float(scale)


def _fmax(a):
    return float(a.to(torch.float64).abs().max())


def start(prog: Particles, flags: dict, bad: int, mass_prog, ref: Particles,
          md) -> dict:
    """The set-up state against the reference's own (built, jittered and
    set up from the same inputs)."""
    sc = md.sc
    attrs = (bad
             + int((flags["ptype"].long() != md.ptype).sum())
             + int((flags["solid_tag"].bool() != md.solid).sum())
             + int((flags["fixed_tag"].bool() != md.solid).sum())
             + int((prog.v != ref.v).any(1).sum())
             + int((prog.Cd != ref.Cd).any(1).sum())
             + int((mass_prog.to(torch.float32)
                    != md.mass.to(torch.float32)).sum()))
    return {
        "start_attrs": attrs,
        "start_x": _max_rel(prog.x, ref.x, sc.dx),
        "setup_f": _max_rel(prog.f, ref.f, _fmax(ref.f)),
        "setup_drho": _max_rel(prog.drho, ref.drho, _fmax(ref.drho)),
    }


def chunk(before: Particles, prog: Particles, cells_prog, bad: int,
          ref: Particles, md) -> dict:
    """One chunk of the program (``before`` -> ``prog``, in ``cells_prog``
    after its rebin) against the reference's chunk from ``before``."""
    sc = md.sc
    want = sc.cell_of(before.x)
    out = {
        "chunk_steps": abs(prog.step - ref.step),
        "cells": int((cells_prog != want).sum()) + bad,
        "chunk_x_q": _q_rel(prog.x, ref.x, sc.dx),
        "chunk_v_q": _q_rel(prog.v, ref.v, sc.U0),
        "chunk_rho_q": _q_rel(prog.rho, ref.rho, sc.rho0),
        "chunk_f_q": _q_rel(prog.f, ref.f, _fmax(ref.f)),
    }
    if prog.Cd.shape[1]:
        out["cd_share"] = float((prog.Cd != ref.Cd).any(1).sum()) / len(prog.Cd)
    return out
