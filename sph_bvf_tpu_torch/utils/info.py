"""System description, the analog of the `info` command (info.cpp)
(PyTorch).

Port of ``sph_bvf_tpu/utils/info.py``: ``describe(state, params, spec)``
prints the configured system: box, grid, particle counts by type and tag,
physics variant, the route pass A takes (``ops/pair_cuda.route``), fixes
and the state's memory.
"""

from __future__ import annotations

import dataclasses


def describe(state, params, spec) -> str:
    from sph_bvf_tpu_torch.ops.pair_cuda import route

    geom = spec.geom
    host = lambda name: getattr(state, name).detach().cpu().numpy()
    valid = host("valid")
    ptype = host("ptype")[valid]
    solid = host("solid_tag")[valid]
    fixed = host("fixed_tag")[valid]
    nbytes = sum(getattr(state, f.name).element_size()
                 * getattr(state, f.name).numel()
                 for f in dataclasses.fields(state))
    lines = [
        "System info (info.cpp analog)",
        f"  box: lo={geom.lo} hi={geom.hi} periodic={geom.periodic} dim={geom.dim}",
        f"  cell grid: {geom.ncells} (cap {geom.cap}, cell {tuple(round(c, 8) for c in geom.cell_size)}, "
        f"drift budget {geom.drift_budget:.3g})",
        f"  particles: {valid.sum()} valid / {geom.nslots} slots "
        f"({100.0 * valid.sum() / geom.nslots:.0f}% occupancy)",
    ]
    for t in range(params.ntypes):
        n = int((ptype == t).sum())
        if n:
            lines.append(f"    type {t + 1}: {n}")
    lines += [
        f"  solids: {int((solid == 1).sum())} "
        f"(fixed {int(((solid == 1) & (fixed == 1)).sum())}), "
        f"species: {params.n_sdpd} continuum + {params.n_ssa} stochastic",
        f"  pair: {spec.pair.variant} (pass A {route(geom, spec.pair).__name__} "
        f"on {state.x.device.type}, thermal={spec.pair.thermal}), "
        f"integrator: {spec.integ.variant}",
        f"  fixes: {[type(f).__name__ for f in spec.fixes] or 'none'}",
        f"  rebin every {spec.rebin_every} steps; state {nbytes / 1e6:.1f} MB",
    ]
    out = "\n".join(lines)
    print(out)
    return out
