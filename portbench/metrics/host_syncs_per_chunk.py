"""Device-to-host reads a chunk on the run path: the program's
``host_sync.*`` counters (the K1 window's tail depth, the overflow, drift
and SSA hop-mean checks every 10 chunks, a mesh's halt) over the chunks
recorded after the profiled span.  The reads made once a ``simulate``
call (``simulate.step0`` and the ``final.*`` check when it ends) are left
out: the window is one call, and they are not the chunks'."""

from portbench.spans import recorded

ONCE = ("host_sync.simulate.", "host_sync.final.")


def read(rec):
    out = recorded(rec)
    if out is None:
        return None
    c = out["counters"]
    return (sum(v for k, v in c.items()
                if k.startswith("host_sync.") and not k.startswith(ONCE))
            / c["chunks"])
