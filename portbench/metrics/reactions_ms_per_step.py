"""Device ms a step of the SSA reactions (``core/ssa.ssa_step``, the
program's ``reactions`` span; CUDA events), over the steps recorded after
the profiled span.  None where no species reacts."""

from portbench.spans import recorded


def read(rec):
    out = recorded(rec)
    if out is None or "reactions" not in out["spans"]:
        return None
    return out["spans"]["reactions"]["device_ms"] / out["counters"]["steps"]
