"""The move kernels' share of their roofline: the least time the span's
rebins could take (``work.move_bound``: each particle's rows read and
written once) over their device time in the profiled span."""

from portbench import work
from portbench.trace import MOVE_KERNELS, matches


def read(rec):
    t = sum(v for k, v in rec.get("kernel_s", {}).items()
            if matches(k, MOVE_KERNELS))
    if not t:
        return None
    b = work.move_bound(rec["n_valid"], rec["dim"], rec["n_species"])[0]
    return 100.0 * rec["span_chunks"] * b / t
