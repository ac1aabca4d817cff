"""The 95th percentile of a chunk's device-timeline ms (CUDA events at the
chunk boundaries, no host synchronisation), over every chunk of the traced
run's window outside its profiled span; none below 20 chunks, and none
from a run whose trace holds no device operation (the CPU)."""

import numpy as np


def read(rec):
    ms = rec.get("chunk_ms", [])
    if len(ms) < 20 or not rec.get("device_events"):
        return None
    return float(np.percentile(ms, 95))
