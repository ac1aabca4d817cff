"""The program's own spans and counters (``sph_bvf_tpu_torch.utils.profiler``)
for the per-layer metrics that read them.

A traced run's window turns the program's recorder on at the first chunk
boundary after the profiled span (the program arms it when it sees a
``torch.profiler`` session), so its spans cover the chunks after the span,
outside any profiler session.  A program without that recorder, or a run
that traced no device (the CPU), gives no record: its readers return
``None``."""

from __future__ import annotations


def recorded(rec: dict, whole_chunk: bool = True):
    """The program's ``report()`` (``spans`` and ``counters``), or ``None``
    where ``rec`` traced no device, the program has no recorder, or, with
    ``whole_chunk``, not one whole chunk was recorded."""
    if not rec.get("device_events"):
        return None
    try:
        from sph_bvf_tpu_torch.utils import profiler
    except ImportError:
        return None
    report = getattr(profiler, "report", None)
    if report is None:
        return None
    out = report()
    counters = out.get("counters", {})
    if whole_chunk and (counters.get("chunks", 0) < 1
                        or not counters.get("steps")):
        return None
    return out


def device_ms_per_step(rec: dict, names) -> float | None:
    """Device ms a recorded step of the spans named in ``names``, where a
    name that ends in a dot stands for every span under that prefix."""
    out = recorded(rec)
    if out is None:
        return None
    from sph_bvf_tpu_torch.utils import profiler

    return profiler.stage_ms(out, names) / out["counters"]["steps"]
