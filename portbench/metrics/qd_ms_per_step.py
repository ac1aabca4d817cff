"""Device ms a step of the SSA hop pass (``ops/pair._pass_a_qd``, the
program's ``qd`` span; CUDA events), over the steps recorded after the
profiled span.  None where no species hops."""

from portbench.spans import recorded


def read(rec):
    out = recorded(rec)
    if out is None or "qd" not in out["spans"]:
        return None
    return out["spans"]["qd"]["device_ms"] / out["counters"]["steps"]
