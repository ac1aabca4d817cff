"""Device ms a step of the integrator's two half-steps: the program's
``integrate.initial`` and ``integrate.final`` spans (CUDA events), over
the steps recorded after the profiled span."""

from portbench.spans import device_ms_per_step


def read(rec):
    return device_ms_per_step(rec, ("integrate.",))
