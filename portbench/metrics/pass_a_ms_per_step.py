"""Device ms a step of the pass-A kernels (K1, K2, K3 by name), from the
profiled span's device trace."""

from portbench.trace import PASS_A_KERNELS, matches


def read(rec):
    s = sum(v for k, v in rec.get("kernel_s", {}).items()
            if matches(k, PASS_A_KERNELS))
    if not s or not rec.get("span_steps"):
        return None
    return 1e3 * s / rec["span_steps"]
