"""The port's router (``controller/router.py``) against the reference's on
the CPU, over HTTP on 127.0.0.1. One script of requests goes through a
``RouterServer`` over two in-process ``ControllerServer`` partitions of its
own package: job submits, a CSV job, a workflow, a ``/v1/infer`` request,
leases and results through the router (home-first, then stolen), a 429 with
its ``Retry-After`` and the partition stamped into the body, the by-id
lookups, and the merged ``/v1/status``, ``/v1/health``, ``/v1/usage`` and
``/v1/metrics``. The same script runs against ``python -m
...controller.router`` with ``PARTITIONS=2`` (its own in-process
partitions). Answers are compared exactly once generated ids are replaced
by their order of appearance, floats (times, rates) by their type, and
byte and time counters and time-series points dropped; the merged metrics by family, labels and
the values of the routing and result counters."""

import json
import os
import re
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

import agent_tpu.config as ref_config
import agent_tpu.controller.partition as ref_part
import agent_tpu.controller.router as ref_router
import agent_tpu_torch.config as port_config
import agent_tpu_torch.controller.partition as port_part
import agent_tpu_torch.controller.router as port_router
from agent_tpu_torch.obs.metrics import parse_exposition

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = {"port": (port_part, port_router, port_config, "agent_tpu_torch"),
         "ref": (ref_part, ref_router, ref_config, "agent_tpu")}
MAX_PENDING = 6
SERVE_WAIT_MS = 600_000  # the infer request stays queued in its bucket
URL = re.compile(r"http://127\.0\.0\.1:\d+")
HEX = re.compile(r"(?<![0-9a-z])[0-9a-f]{8,32}(?![0-9a-z])")
DROPPED = re.compile(r"bytes|wall|_sec|_ms$|uptime|age|generated_at|^ts$|^t$|cursors|"
                     r"last_seen|since|timings|duration|elapsed|usage|spans|trace|^points$")
COUNTED = ("controller_results_total", "controller_tasks_leased_total",
           "controller_admission_rejections_total")


def http(url, body=None, method=None):
    """-> (status, parsed JSON or text, Retry-After header)."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            status, raw, headers = resp.status, resp.read(), resp.headers
    except urllib.error.HTTPError as exc:
        status, raw, headers = exc.code, exc.read(), exc.headers
    ctype = headers.get("Content-Type", "")
    body = (json.loads(raw) if "json" in ctype else raw.decode()) if raw else None
    return status, body, headers.get("Retry-After")


class Ids:
    """Generated ids -> their order of appearance in one side's script."""

    def __init__(self):
        self.seen = {}

    def __call__(self, obj):
        if isinstance(obj, str):
            obj = URL.sub("http://127.0.0.1:<port>", obj)
            return HEX.sub(lambda m: "#" + str(self.seen.setdefault(m.group(0),
                                                                    len(self.seen))), obj)
        if isinstance(obj, dict):
            return {self(k): self(obj[k]) for k in sorted(obj) if not DROPPED.search(str(k))}
        if isinstance(obj, (list, tuple)):
            return [self(v) for v in obj]
        if isinstance(obj, float):
            return "float"
        return obj


def _metrics(text: str):
    """The merged exposition -> {(family, labels)}: the counted families'
    values, every other family's presence."""
    out = {}
    for family, samples in parse_exposition(text).items():
        for labels, value in samples:
            key = (family, tuple(sorted((k, v) for k, v in labels.items()
                                        if not HEX.search(v))))
            counted = family in COUNTED or family.startswith("router_")
            if counted and "failovers" not in family:
                out[key] = out.get(key, 0.0) + value
            else:
                out[key] = None
    return out


def script(url: str, csv_path: str, ids: Ids) -> list:
    """One HTTP session against a router at ``url`` -> normalised answers."""
    ring = ref_part.HashRing(["p0", "p1"])
    out = []

    def note(label, answer):
        out.append((label, ids(answer)))

    for i in range(4):
        note(f"submit {i}", http(f"{url}/v1/jobs", {"op": "echo", "payload": {"i": i},
                                                    "job_id": f"j-{i}",
                                                    "tenant": ("acme", None)[i % 2]}))
    note("csv", http(f"{url}/v1/jobs", {"source_uri": csv_path, "total_rows": 30,
                                        "shard_size": 10, "map_op": "read_csv_shard",
                                        "tenant": "acme"}))
    note("workflow", http(f"{url}/v1/workflows", {
        "workflow_id": "wf-r1", "tenant": "globex",
        "stages": [{"name": "a", "op": "echo", "payload": {"s": "a"}},
                   {"name": "b", "op": "echo", "payload": {"s": "b"}, "after": ["a"]}]}))
    status, infer, _ = http(f"{url}/v1/infer", {"op": "classify", "text": "hello router",
                                                "wait": False, "tenant": "acme"})
    note("infer", (status, infer))
    note("bad json route", http(f"{url}/v1/nope", {"x": 1}))
    # Lease through the router until nothing is left: home first, then
    # stolen from the other partition; each result routes by its tag.
    agent = next(f"r{i}" for i in range(100) if ring.place(f"agent\x1fr{i}") == "p0")
    for _ in range(12):
        status, lease, _ = http(f"{url}/v1/leases", {
            "agent": agent, "capabilities": {"ops": ["echo", "read_csv_shard"]},
            "max_tasks": 3})
        note("lease", (status, lease))
        if status != 200:
            break
        for task in lease["tasks"]:
            note("result", http(f"{url}/v1/results", {
                "lease_id": lease["lease_id"], "job_id": task["id"],
                "job_epoch": task["job_epoch"], "status": "succeeded",
                "result": {"ok": True, "echo": task["payload"]}}))
    note("untagged result", http(f"{url}/v1/results", {
        "lease_id": "lease-0", "job_id": "nope", "job_epoch": 0, "status": "succeeded"}))
    # Admission: p1 holds MAX_PENDING pending jobs, the next submits 429.
    for i in range(MAX_PENDING + 2):
        jid = ref_part.job_id_for_partition(ring, "p1", prefix=f"full{i}")
        note(f"fill {i}", http(f"{url}/v1/jobs", {"op": "echo", "payload": {}, "job_id": jid}))
    for route in ("/v1/jobs/j-0", "/v1/jobs/nope", "/v1/infer/{req}",
                  "/v1/trace/j-1", "/v1/workflows/wf-r1", "/v1/status", "/v1/health",
                  "/v1/usage", "/v1/depth", "/v1/router", "/v1/incidents",
                  "/v1/debug/requests", "/v1/timeseries?name=controller_queue_depth",
                  "/v1/nope"):
        note(route, http(url + route.format(req=infer["req_id"])))
    status, text, _ = http(f"{url}/v1/metrics")
    out.append(("/v1/metrics", (status, _metrics(text))))
    return out


@pytest.fixture(scope="module")
def csv_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("router") / "rows.csv"
    with open(path, "w") as f:
        f.write("id,text\n")
        for i in range(30):
            f.write(f'{i},"row {i}"\n')
    return str(path)


def _in_process(side, csv_path):
    part, router, config, _ = SIDES[side]
    parts = part.LocalPartitionSet(2, controller_kwargs=dict(
        sched=config.SchedConfig(max_pending=MAX_PENDING),
        flow=config.FlowConfig(cache_enabled=False),
        serve=config.ServeConfig(max_wait_ms=SERVE_WAIT_MS),
        obs=config.ObsConfig(tsdb_interval_sec=0.0))).start()
    try:
        with router.RouterServer(parts.pmap) as srv:
            return script(srv.url, csv_path, Ids())
    finally:
        parts.stop()


def test_the_router_answers_as_the_references_over_two_partitions(csv_path):
    port, ref = (_in_process(side, csv_path) for side in ("port", "ref"))
    assert [label for label, _ in port] == [label for label, _ in ref]
    for (label, got), (_, want) in zip(port, ref):
        assert got == want, label
    answers = dict(port)
    assert answers["fill 7"][0] == 429 and answers["fill 7"][1]["partition"] == "p1"
    assert answers["fill 7"][2] == "1"  # Retry-After passes through
    status = answers["/v1/status"][1]
    assert [p["name"] for p in status["partitions"]] == ["p0", "p1"]
    assert status["router"]["lease_grants_stolen_total"] >= 1


def _subprocess(side, csv_path, tmp_path):
    module = SIDES[side][3]
    env = dict(os.environ, PARTITIONS="2", ROUTER_PORT="0", ROUTER_HOST="127.0.0.1",
               CONTROLLER_JOURNAL=str(tmp_path / f"{side}.jsonl"), JAX_PLATFORMS="cpu",
               SCHED_MAX_PENDING=str(MAX_PENDING), ROUTER_COLLECT_SEC="0",
               SERVE_MAX_WAIT_MS=str(SERVE_WAIT_MS),
               CONTROLLER_SWEEP_SEC="0", TSDB_INTERVAL="0.05",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-m", f"{module}.controller.router"], env=env,
                            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        deadline = time.monotonic() + 120
        url = None
        while url is None and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            if "routing on " in line:
                url = line.split("routing on ", 1)[1].split()[0]
        assert url, f"{module}'s router did not start"
        answers = script(url, csv_path, Ids())
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        tail = proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert rc == 0 and "stopped" in tail, tail[-2000:]
    return answers


def test_partitions_mode_answers_as_the_references(csv_path, tmp_path):
    port, ref = (_subprocess(side, csv_path, tmp_path) for side in ("port", "ref"))
    assert [label for label, _ in port] == [label for label, _ in ref]
    for (label, got), (_, want) in zip(port, ref):
        assert got == want, label
    assert dict(port)["fill 7"][0] == 429


def test_the_merges_fold_partition_documents_alike():
    """merge_status, merge_health, merge_metrics and deep_sum on the same
    partition documents, one partition unreachable."""
    pmap_args = {"p0": ["http://a"], "p1": ["http://b"], "p2": ["http://c"]}
    status = {"p0": {"queue_depth": 2, "counts": {"pending": 2, "succeeded": 1},
                     "counts_by_op": {"echo": {"pending": 2}}, "drained": False,
                     "agents": {"x": {"last_seen_sec_ago": 3.0}}, "stale_results": 1,
                     "summary": {"uptime_sec": 5.0, "ops": {"echo": {
                         "succeeded": 1, "failed": 0, "tasks_per_sec": 0.5}}},
                     "serving": {"enabled": True, "requests": {"queued": 1},
                                 "open_buckets": 1, "rejected": 2}},
              "p1": {"queue_depth": 0, "counts": {"succeeded": 4}, "drained": True,
                     "agents": {"x": {"last_seen_sec_ago": 1.0}, "y": {"stale": True}},
                     "summary": {"uptime_sec": 7.5, "ops": {"echo": {
                         "succeeded": 4, "failed": 1, "tasks_per_sec": 1.25}}},
                     "serving": {"enabled": False}},
              "p2": None}
    health = {"p0": {"verdict": "warn", "reasons": [{"kind": "slo_burn"}],
                     "slo": {"enabled": True, "objectives": [{"objective": "lat",
                                                              "state": "warn"}]},
                     "queue": {"depth": 2, "by_tier": {"4": 2}, "starvation_age_sec": 3.5},
                     "counts": {"pending": 2}, "agents": {"x": {"last_seen_sec_ago": 2.0}}},
              "p1": {"verdict": "ok", "queue": {"depth": 0}, "agents": {}},
              "p2": None}
    texts = {"p0": 'controller_results_total{outcome="accepted"} 3\nup 1\n',
             "p1": 'controller_results_total{outcome="accepted"} 4\n', "p2": None}
    usage = [{"enabled": True, "billed_tasks": 3, "tenants": {"a": {"device_s": 1.5}},
              "list": [1]}, {"enabled": True, "billed_tasks": 2,
                             "tenants": {"a": {"device_s": 0.25}, "b": {"device_s": 1.0}},
                             "list": [2]}]
    got = {}
    for side in ("port", "ref"):
        part, router, _, _ = SIDES[side]
        pmap = part.PartitionMap(pmap_args)
        h = router.merge_health(health, pmap)
        h.pop("generated_at")
        got[side] = (router.merge_status(status, pmap, {"submits_total": 3}), h,
                     router.merge_metrics(texts, {"submits_total": 3, "flag": True}),
                     router.deep_sum(usage))
    assert got["port"] == got["ref"]
