"""The port's traffic generator (``loadgen.py``) against the reference's on
the CPU: for the same configuration and seed, the arrival schedule (times,
classes, payloads, sequence numbers) is the same byte for byte, for flat,
burst and diurnal patterns, weighted class mixes, zipfian payload pools and
payload functions; ``zipf_rank`` draws alike; and ``run`` over
``session_submitter`` counts submits, 429 drops per partition and errors
alike with an injected clock."""

import json
import random

import pytest

import agent_tpu.config as ref_config
import agent_tpu.loadgen as ref_lg
import agent_tpu_torch.config as port_config
import agent_tpu_torch.loadgen as port_lg

SIDES = {"port": (port_lg, port_config), "ref": (ref_lg, ref_config)}


def _texts(rng, seq):
    return {"text": "x" * rng.randrange(20, 900), "params": {"topk": 5}, "seq": seq}


def _classes(lg, zipf):
    return [
        lg.TrafficClass(name="infer", op="classify", weight=3.0, tenant="acme", priority=8,
                        route="infer", payload_fn=_texts),
        lg.TrafficClass(name="jobs", op="map_classify_tpu", weight=1.0, tenant="globex",
                        deadline_sec=30.0, payload={"rows": 256}),
        lg.TrafficClass(name="zipf", op="echo", weight=0.5, payload={"k": 1},
                        payload_zipf_s=zipf, payload_pool=16),
    ]


CONFIGS = [
    dict(seed=0, base_rate=30.0, burst_factor=3.0, burst_at_sec=5.0, burst_len_sec=4.0),
    dict(seed=1234, base_rate=5.0, diurnal_amplitude=0.8, diurnal_period_sec=7.0),
    dict(seed=7, base_rate=2.0, burst_factor=10.0, burst_at_sec=1.0, burst_len_sec=2.0,
         diurnal_amplitude=1.0, diurnal_period_sec=3.0),
    dict(seed=99, base_rate=0.0),
]


def _schedule(side, cfg, zipf, duration):
    lg, config = SIDES[side]
    c = config.LoadgenConfig(**cfg)
    gen = lg.LoadGen(_classes(lg, zipf), lg.ArrivalPattern.from_config(c), seed=c.seed)
    return json.dumps([(a.t, a.cls.name, a.payload, a.seq) for a in gen.schedule(duration)])


@pytest.mark.parametrize("zipf", [None, 0.0, 1.2])
@pytest.mark.parametrize("cfg", range(len(CONFIGS)))
def test_schedules_equal_the_references_byte_for_byte(cfg, zipf):
    port, ref = (_schedule(side, CONFIGS[cfg], zipf, 15.0) for side in SIDES)
    assert port == ref
    if CONFIGS[cfg]["base_rate"]:
        assert len(json.loads(port)) > 5


@pytest.mark.parametrize("n,s", [(1, 1.0), (5, 0.0), (64, 1.1), (1000, 2.5)])
def test_zipf_ranks_draw_alike(n, s):
    draws = {side: [lg.zipf_rank(rng, n, s) for rng in [random.Random(3)] for _ in range(500)]
             for side, (lg, _) in SIDES.items()}
    assert draws["port"] == draws["ref"]


class Scripted:
    """Answers each post from a cycle: 200 with an id, a stamped 429, an
    unstamped 429, a 500."""

    def __init__(self):
        self.n = 0
        self.bodies = []

    def post(self, url, json=None, timeout=None):  # noqa: A002
        self.n += 1
        self.bodies.append((url, json))
        kind = self.n % 7
        if kind == 3:
            return _Resp(429, {"error": "full", "partition": ("p0", "p1")[self.n % 2]})
        if kind == 5:
            return _Resp(429, {"error": "full"})
        if kind == 6:
            return _Resp(500, {})
        key = "req_id" if url.endswith("/v1/infer") else "job_id"
        return _Resp(200, {key: f"id-{self.n}"})


class _Resp:
    def __init__(self, status, body):
        self.status_code, self._body = status, body

    def json(self):
        return self._body


def _run(side):
    lg, config = SIDES[side]
    c = config.LoadgenConfig(**CONFIGS[0])
    gen = lg.LoadGen(_classes(lg, 1.0), lg.ArrivalPattern.from_config(c), seed=c.seed)
    clock = {"t": 0.0}
    session = Scripted()
    stats = gen.run(lg.session_submitter(session, "http://router/"), 15.0,
                    now=lambda: clock["t"],
                    sleep=lambda d: clock.__setitem__("t", clock["t"] + d))
    return (stats.submitted, stats.rejected, stats.rejected_by_partition, stats.errors,
            stats.jobs, session.bodies)


def test_runs_count_drops_per_partition_alike():
    port, ref = _run("port"), _run("ref")
    assert port == ref
    assert set(port[2]) == {"p0", "p1", ""} and port[3]
