"""Host seconds of the program's set-up (``core.stepper.setup``, its
``setup`` span: the first rebin, the first forces with their tail
readback, the library loads they trigger, the post-force fixes).  The
rest of ``setup_s`` is the benchmark's own: imports, the scene build, the
jitter and the warm-up chunks."""

from portbench.spans import recorded


def read(rec):
    out = recorded(rec, whole_chunk=False)
    if out is None or "setup" not in out["spans"]:
        return None
    return out["spans"]["setup"]["host_ms"] / 1e3
