"""The share of the profiled span's host-clock length in which no device
operation ran (the span starts and ends with a synchronisation)."""


def read(rec):
    if not rec.get("busy_s"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
