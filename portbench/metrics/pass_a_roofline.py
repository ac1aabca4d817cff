"""The pass-A kernels' share of their roofline: the least time the span's
pass-A calls could take (``work.pass_a_bound``: the particles' rows and the
pairs inside the support, counted from the physics) over their device
time in the profiled span."""

from portbench import work
from portbench.trace import PASS_A_KERNELS, matches


def read(rec):
    t = sum(v for k, v in rec.get("kernel_s", {}).items()
            if matches(k, PASS_A_KERNELS))
    if not t or not rec.get("pairs"):
        return None
    n, pairs, dim = rec["n_valid"], rec["pairs"], rec["dim"]
    filt = rec["span_filter_steps"]
    bound = (filt * work.pass_a_bound(n, pairs, dim, True)[0]
             + (rec["span_steps"] - filt)
             * work.pass_a_bound(n, pairs, dim, False)[0])
    return 100.0 * bound / t
