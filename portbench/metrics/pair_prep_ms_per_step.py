"""Device ms a step of pass A's torch ops: the part of the program's
``forces`` span that its children (``pass_a.kernel``, ``qd``, ``pass_b``)
do not cover, so the per-particle fields, the packing and the unpacking
(CUDA events), over the steps recorded after the profiled span."""

from portbench.spans import recorded


def read(rec):
    out = recorded(rec)
    if out is None or "forces" not in out["spans"]:
        return None
    return out["spans"]["forces"]["self_ms"] / out["counters"]["steps"]
