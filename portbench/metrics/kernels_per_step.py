"""Device operations (kernels, copies, fills) a step launches, from the
profiled span's device trace."""


def read(rec):
    if not rec.get("span_steps") or not rec.get("device_events"):
        return None
    return rec["device_events"] / rec["span_steps"]
