"""Device ms a rebin of the move kernels (K5, K6, K7 by name), from the
profiled span's device trace."""

from portbench.trace import MOVE_KERNELS, matches


def read(rec):
    s = sum(v for k, v in rec.get("kernel_s", {}).items()
            if matches(k, MOVE_KERNELS))
    if not s or not rec.get("span_chunks"):
        return None
    return 1e3 * s / rec["span_chunks"]
