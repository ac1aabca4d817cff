"""Device ms a step of the fixes: the program's ``fixes.post_integrate``,
``fixes.post_force`` and ``fixes.end_of_step`` spans (CUDA events; a
stage with no fix has none), over the steps recorded after the profiled
span."""

from portbench.spans import device_ms_per_step


def read(rec):
    return device_ms_per_step(rec, ("fixes.",))
