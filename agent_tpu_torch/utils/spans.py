"""Shared per-op span accounting over controller result bodies — the
port's counterpart of ``agent_tpu.utils.spans``.

One definition of "device-side span" for drain reports (the reference's bench.py
and scripts/drain_at_scale.py): per-shard dispatch time (``timings.device_ms``)
plus the deferred device→host fetch wait (``timings.fetch_ms``, paid on the
pipeline's poster thread). Results without phase timings fall back to their
``elapsed_ms``. Under pipeline overlap these spans can over- or under-count
true device busy time — wall-clock throughput is the primary metric; spans
are the per-op attribution signal.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping


def result_op(result: Mapping) -> str | None:
    """The op a result body belongs to. Every op now stamps ``"op"`` into
    its result; the summaries/sink sniffing below is
    kept ONLY as a fallback for old bodies (pre-stamp journals, agents a
    version behind) and must not grow new cases — new attribution should
    come from the explicit key or from scraping ``/v1/metrics``
    (``agent_tpu_torch.obs.scrape``)."""
    op = result.get("op")
    if op:
        return op
    if (
        "summaries" in result
        or "summary" in result
        or "map_summarize" in str(result.get("output_path", ""))
    ):
        return "map_summarize"
    return None


def op_span_ms(results: Iterable[Mapping], ops: Iterable[str]) -> Dict[str, float]:
    """Sum per-op spans (milliseconds) over result bodies."""
    spans = {op: 0.0 for op in ops}
    for r in results:
        if not isinstance(r, Mapping):
            continue
        op = result_op(r)
        if op not in spans:
            continue
        t = r.get("timings", {})
        if t.get("device_ms") is not None:
            spans[op] += float(t.get("device_ms", 0.0)) + float(
                t.get("fetch_ms", 0.0)
            )
        else:
            spans[op] += float(r.get("elapsed_ms", 0.0))
    return spans
