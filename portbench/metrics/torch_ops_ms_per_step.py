"""Device ms a step of every device operation that is not a kernel of the
program's own libraries (the integrator, the fixes, the SSA hop pass and
reactions, packing, copies), from the profiled span's device trace."""

from portbench.trace import MOVE_KERNELS, PASS_A_KERNELS, matches


def read(rec):
    if not rec.get("span_steps") or not rec.get("kernel_s"):
        return None
    s = sum(v for k, v in rec["kernel_s"].items()
            if not matches(k, PASS_A_KERNELS + MOVE_KERNELS))
    return 1e3 * s / rec["span_steps"]
