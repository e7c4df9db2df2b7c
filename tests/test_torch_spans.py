"""The port's span sums (``utils/spans.py``) against the reference's on
the same result bodies: ``result_op`` and ``op_span_ms`` over seeded bodies
with and without phase timings, old bodies without an ``op`` stamp, and
bodies that are not mappings. Sums are compared exactly."""

import random

import pytest

from agent_tpu.utils import spans as ref_spans
from agent_tpu_torch.utils import spans as port_spans

OPS = ("map_classify_tpu", "map_summarize", "echo", "risk_accumulate")


def _bodies(seed: int) -> list:
    rng = random.Random(seed)
    out = [None, "text", 3, {}]
    for _ in range(200):
        body = {"elapsed_ms": rng.random() * 100}
        kind = rng.randrange(5)
        if kind == 0:
            body["op"] = rng.choice(OPS + ("other",))
        elif kind == 1:
            body["summaries"] = ["s"]
        elif kind == 2:
            body["output_path"] = f"/out/map_summarize-{rng.randrange(9)}.jsonl"
        elif kind == 3:
            body["summary"] = "s"
        if rng.random() < 0.6:
            body["timings"] = {"device_ms": rng.random() * 10}
            if rng.random() < 0.5:
                body["timings"]["fetch_ms"] = rng.random()
        out.append(body)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_span_sums_equal_the_references(seed):
    bodies = _bodies(seed)
    assert [port_spans.result_op(b) for b in bodies if isinstance(b, dict)] == \
        [ref_spans.result_op(b) for b in bodies if isinstance(b, dict)]
    for ops in (OPS, ("map_summarize",), ()):
        assert port_spans.op_span_ms(bodies, ops) == ref_spans.op_span_ms(bodies, ops)
