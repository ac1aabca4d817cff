"""Host ms a step: the host time of the program's ``step`` spans net of
the device-to-host reads inside them (their ``wait_ms``: the K1 window's
tail readback), over the steps recorded (the chunks after the profiled
span, with the program's recorder on).  A step that waits for a full
launch queue still counts that wait: where the card paces the run this
reads up to the device ms a step."""

from portbench.spans import recorded


def read(rec):
    out = recorded(rec)
    if out is None or "step" not in out["spans"]:
        return None
    step = out["spans"]["step"]
    return (step["host_ms"] - step["wait_ms"]) / out["counters"]["steps"]
