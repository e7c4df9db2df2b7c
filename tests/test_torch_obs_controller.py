"""The controller's half of the port's observability against the
reference's, on the same seeded inputs: the metrics snapshot algebra
(merge, render, quantiles, parse, exemplars, validation), the usage ledger
(billing, dedupe, eviction, report, export and import), the trace store
(spans, links, bounds and eviction order, assembly, summaries), the health
verdict, the capture coordinator and host profiler, and the scrape helpers
against a ``127.0.0.1`` server. Floats are compared equal: both packages
do the same arithmetic in the same order."""

import http.server
import json
import random
import threading

import pytest

from agent_tpu.obs import health as jax_health
from agent_tpu.obs import metrics as jax_metrics
from agent_tpu.obs import profile as jax_profile
from agent_tpu.obs import scrape as jax_scrape
from agent_tpu.obs import trace as jax_trace
from agent_tpu.obs import usage as jax_usage
from agent_tpu_torch.obs import health as torch_health
from agent_tpu_torch.obs import metrics as torch_metrics
from agent_tpu_torch.obs import profile as torch_profile
from agent_tpu_torch.obs import scrape as torch_scrape
from agent_tpu_torch.obs import trace as torch_trace
from agent_tpu_torch.obs import usage as torch_usage

T0 = 1_700_000_000.0


# ---- metrics ----

def _registry(metrics, seed):
    rng = random.Random(seed)
    reg = metrics.MetricsRegistry()
    c = reg.counter("tasks_total", "Tasks by op\nand status", ("op", "status"))
    g = reg.gauge("queue_depth", 'Staged "depth"', ("queue",))
    h = reg.histogram("task_phase_seconds", "Phase seconds", ("op", "phase"))
    h2 = reg.histogram("tiny_seconds", "", (), buckets=(0.001, 0.01))
    for i in range(rng.randrange(20, 60)):
        op = rng.choice(["map_classify_tpu", "echo", 'we"ird\\op'])
        c.inc(rng.choice([1, 2.5]), op=op, status=rng.choice(["succeeded", "failed"]))
        g.set(rng.randrange(9), queue=rng.choice(["staged", "held"]))
        g.inc(1, queue="staged")
        g.dec(0.5, queue="held")
        h.observe(rng.expovariate(2.0) * (200 if i == 7 else 1), op=op,
                  phase=rng.choice(["stage", "execute", "fetch"]),
                  exemplar={"trace_id": f"job-{i}"} if rng.random() < 0.3 else None)
        h2.observe(rng.random() / 50)
    return reg


def _fix_ts(snap):
    """Exemplar timestamps are the observation's wall clock: pin them."""
    for fam in snap.values():
        for s in fam["series"]:
            for ex in (s.get("exemplars") or {}).values():
                ex["ts"] = T0 + len(ex["labels"]["trace_id"])
    return snap


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_snapshot_algebra_matches_the_reference(seed):
    got = {}
    for pkg, metrics in (("jax", jax_metrics), ("torch", torch_metrics)):
        snaps = [_fix_ts(_registry(metrics, seed * 10 + k).snapshot()) for k in range(3)]
        snaps.append({"queue_depth": {"type": "counter", "series": [{"labels": {},
                                                                      "value": 1}]}})
        snaps.append({"bad": 1, "tasks_total": "x"})
        merged = metrics.merge_snapshots(snaps)
        text = metrics.render_snapshots([(merged, {}), (snaps[0], {"agent": "gpu-0"}),
                                         (snaps[1], {"agent": 'b"1'})])
        fam = merged["task_phase_seconds"]
        quantiles = [metrics.histogram_quantile(fam["buckets"], s["counts"], q)
                     for s in fam["series"] for q in (0.0, 0.5, 0.9, 0.99, 1.0)]
        got[pkg] = (merged, text, quantiles, metrics.parse_exposition(text),
                    metrics.parse_exemplars(text), metrics.validate_exposition(
                        text, required=("tasks_total", "task_phase_seconds", "absent")))
    assert got["torch"] == got["jax"]
    assert got["torch"][5] == ["required series absent absent"]
    assert got["torch"][4]  # exemplars rendered and parsed back


BAD_EXPOSITIONS = [
    "x 1\n",
    "# TYPE x counter\n# TYPE x counter\nx 1\n",
    "# TYPE h histogram\nh_bucket{le=\"1\"} 1\n",
    "# TYPE x gauge\nx{a=\"1\" 2\n",
    "# TYPE x gauge\nx NaNx\n",
    "# TYPE x wat\n",
    '# TYPE x gauge\nx 1 # {trace_id="a"} 1\n',
    '# TYPE h histogram\nh_bucket{le="+Inf"} 1 # {bad} x\nh_sum 1\nh_count 1\n',
]


@pytest.mark.parametrize("i", range(len(BAD_EXPOSITIONS)))
def test_validation_and_parse_errors_match_the_reference(i):
    text = BAD_EXPOSITIONS[i]
    assert torch_metrics.validate_exposition(text) == jax_metrics.validate_exposition(text)
    outcomes = []
    for metrics in (jax_metrics, torch_metrics):
        try:
            outcomes.append(("ok", metrics.parse_exposition(text)))
        except ValueError as exc:
            outcomes.append(("raised", str(exc)))
    assert outcomes[1] == outcomes[0]


def test_registry_render_matches_the_reference():
    got = _fix_ts(_registry(torch_metrics, 5).snapshot())
    want = _fix_ts(_registry(jax_metrics, 5).snapshot())
    assert got == want
    assert torch_metrics.render_snapshots([(got, {})]) == \
        jax_metrics.render_snapshots([(want, {})])
    assert torch_metrics.get_registry() is torch_metrics.get_registry()
    assert torch_metrics.histogram_quantile([1.0], [0, 0], 0.5) is None


# ---- usage ledger ----

def _usage(rng):
    u = {"device_s": rng.random(), "host_s": rng.random() / 10, "flops": rng.random() * 1e12,
         "rows": rng.randrange(9000), "chips": rng.choice([1, 4]),
         "cache_hit_rows": rng.randrange(3), "result_cache_hits": rng.randrange(2),
         "wire_bytes": rng.randrange(100)}
    if rng.random() < 0.1:
        u.update(device_s=float("nan"), rows=-1, bogus=5, chips=True)
    return u


def _ledger(usage_mod, metrics_mod, seed):
    rng = random.Random(seed)
    reg = metrics_mod.MetricsRegistry()
    led = usage_mod.UsageLedger(registry=reg, top_k=3, max_jobs=16, cost_per_chip_hour=2.0,
                                cache_price_per_hit=0.001)
    out = []
    for i in range(120):
        job = f"job-{rng.randrange(40)}"
        out.append(led.bill(job, rng.choice(["acme", "b"]), rng.choice([4, 8]),
                            rng.choice(["map_classify_tpu", "echo"]), rng.randrange(3),
                            usage=_usage(rng) if rng.random() < 0.95 else None,
                            wire_bytes=rng.choice([0, 512])))
    out.append(led.job_billed_attempts())
    rep = led.report(pending_by_tenant={"acme": 3, "b": 0})
    rep.pop("since_wall", None)
    rep.pop("window_sec", None)
    out.append(rep)
    state = led.export_state()
    state.pop("started_wall", None)
    out.append(state)
    fresh = usage_mod.UsageLedger(registry=metrics_mod.MetricsRegistry(), top_k=3,
                                  max_jobs=16)
    fresh.import_state(led.export_state())
    rep2 = fresh.report(top_k=5)
    rep2.pop("since_wall", None)
    rep2.pop("window_sec", None)
    out.append(rep2)
    out.append(reg.snapshot())
    out.append([usage_mod.sanitize_usage(_usage(rng)) for _ in range(10)])
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_usage_ledger_matches_the_reference(seed):
    got = _ledger(torch_usage, torch_metrics, seed)
    want = _ledger(jax_usage, jax_metrics, seed)
    assert got == want
    assert any(b is None for b in want[:120]) and want[121]["by_tenant"]


def test_stamp_usage_matches_the_reference():
    tags_a, tags_b = {}, {}
    for tags, mod in ((tags_a, torch_usage), (tags_b, jax_usage)):
        mod.stamp_usage(tags, device_s=0.5, chips=4, flops=None)
        mod.stamp_usage(tags, device_s=0.25, chips=1, host_s=0.125)
        mod.stamp_usage(None, device_s=1.0)
    assert tags_a == tags_b == {"usage": {"device_s": 0.75, "chips": 1.0, "host_s": 0.125}}


# ---- trace store ----

def _trace_ops(trace_mod, seed, max_traces=4, max_spans=6):
    rng = random.Random(seed)
    store = trace_mod.TraceStore(max_traces=max_traces, max_spans_per_trace=max_spans)
    out = []
    opened = []
    for i in range(80):
        tid = f"job-{rng.randrange(7)}"
        r = rng.random()
        if r < 0.35:
            sid = store.open(tid, rng.choice(["submit", "lease", "apply"]),
                             parent_span_id=rng.choice([None] + [s for t, s in opened if t == tid]),
                             start_clock=float(i), span_id=f"s{i}",
                             attributes={"i": i},
                             links=[trace_mod.span_link(f"job-{i}", f"x{i}", rider=i)]
                             if rng.random() < 0.2 else None)
            out.append(("open", sid))
            if sid:
                opened.append((tid, sid))
        elif r < 0.55 and opened:
            tid, sid = rng.choice(opened)
            store.finish(tid, sid, float(i) + rng.random(), attributes={"done": i})
        elif r < 0.75:
            span = {"trace_id": tid, "span_id": f"a{rng.randrange(30)}",
                    "parent_span_id": rng.choice([None, f"s{rng.randrange(i + 1)}"]),
                    "name": "execute", "start_wall": T0 + i, "start_mono": float(i),
                    "duration_ms": 1.5, "process": "agent:gpu-0", "attributes": {}}
            out.append(("ingest", store.ingest([span, dict(span), {"bad": 1}, "x"])))
        elif r < 0.85 and opened:
            tid, sid = rng.choice(opened)
            store.add_links(tid, sid, [trace_mod.span_link(f"req-{i}")])
            out.append(("links", store.links(tid, sid)))
        else:
            out.append(("ingest_bad", store.add({"trace_id": "", "span_id": "x", "name": "n"}),
                        store.ingest("nope")))
    out.append(store.trace_ids())
    for tid in store.trace_ids() + ["job-missing"]:
        spans = store.spans(tid)
        for s in spans or []:
            s.pop("start_wall", None)
        out.append(spans)
        a = store.assemble(tid)
        if a:
            for s in a["spans"]:
                s.pop("start_wall", None)
            a["spans"].sort(key=lambda s: s["span_id"])
        out.append(a)
    out.append(store.summaries(limit=3))
    out.append((store.dropped_traces, store.dropped_spans))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_trace_store_matches_the_reference(seed):
    got = _trace_ops(torch_trace, seed)
    want = _trace_ops(jax_trace, seed)
    assert got == want
    assert want[-1][0] > 0  # the bound evicted traces, oldest first


def test_trace_store_is_a_no_op_when_tracing_is_off():
    torch_trace.set_enabled(False)
    try:
        store = torch_trace.TraceStore()
        assert store.open("t", "submit") is None
        assert store.add(torch_trace.make_span("x", "t")) is False
    finally:
        torch_trace.set_enabled(None)


def test_span_link_and_make_span_links_match_the_reference():
    for args, kw in ((("t",), {}), (("t", "s"), {}), (("t", None), {"a": 1})):
        assert torch_trace.span_link(*args, **kw) == jax_trace.span_link(*args, **kw)
    links = [torch_trace.span_link("t2", "s2")]
    got = torch_trace.make_span("x", "t", start_mono=5.0, duration_s=0.5, span_id="s",
                                links=links)
    want = jax_trace.make_span("x", "t", start_mono=5.0, duration_s=0.5, span_id="s",
                               links=links)
    got.pop("start_wall"), want.pop("start_wall")
    assert got == want and "links" not in torch_trace.make_span("y", "t")


# ---- health ----

def _agents(metrics_mod, seed):
    rng = random.Random(seed)
    out = {}
    for i in range(4):
        reg = metrics_mod.MetricsRegistry()
        if i != 2:
            reg.counter("device_busy_seconds_total", "", ("op",)).inc(rng.random() * 9,
                                                                       op="map_classify_tpu")
        else:
            reg.counter("device_busy_seconds_total", "").inc(3.0)
        reg.counter("device_idle_seconds_total", "").inc(rng.random() * 3)
        if i == 0:
            reg.gauge("device_duty_cycle", "").set(0.75)
        reg.gauge("device_mfu", "", ("op",)).set(rng.random(), op="map_classify_tpu")
        reg.gauge("queue_depth", "", ("queue",)).set(rng.randrange(5), queue="staged")
        out[f"a{i}"] = {"last_seen_wall": T0 - rng.choice([1, 5, 90, 300]),
                        "obs": reg.snapshot(), "draining": i == 3}
    out["legacy"] = {"last_seen_wall": T0 - 2}
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_health_verdicts_match_the_reference(seed):
    cases = [
        dict(slo_enabled=True, slo_objectives=[{"objective": "interactive", "state": "ok"}]),
        dict(slo_enabled=True, slo_objectives=[{"objective": "i", "state": "warn",
                                                "burn_short": 4.0}], queue_depth=9,
             queue_by_tier={8: 3, 4: 6}, starvation_age_sec=12.5),
        dict(slo_enabled=True, slo_objectives=[{"objective": "i", "state": "page"}],
             counts={"pending": 4, "leased": 1}),
        dict(slo_enabled=False, queue_depth=5, partition="p1",
             anomalies=[{"watch": "queue_depth", "z": 9.0}]),
    ]
    verdicts = []
    for kw in cases:
        outs = []
        for health, metrics in ((jax_health, jax_metrics), (torch_health, torch_metrics)):
            agents = _agents(metrics, seed)
            outs.append((health.build_health(agents=agents, now_wall=T0, agent_stale_sec=60.0,
                                              **kw),
                         {k: health.agent_health(v, now_wall=T0) for k, v in agents.items()}))
        assert outs[1] == outs[0]
        verdicts.append(outs[1][0]["verdict"])
    assert verdicts[0] != "page" and verdicts[2] == "page" and "warn" in verdicts


# ---- profile ----

def test_capture_coordinator_matches_the_reference():
    outs = []
    for mod in (jax_profile, torch_profile):
        cc = mod.CaptureCoordinator(max_captures=3)
        log = []
        for agent, op, dur in (("a", None, None), ("b", "map_classify_tpu", 50.0),
                               ("a", "echo", 1), ("a", None, None), ("b", None, 2.5)):
            rec = cc.request(agent, op=op, duration_ms=dur)
            log.append({k: v for k, v in rec.items() if k not in ("capture_id",
                                                                   "requested_wall")})
        for bad in ((None,), ("a", ""), ("a", None, 0), ("a", None, True)):
            with pytest.raises(ValueError) as exc:
                cc.request(*bad)
            log.append(str(exc.value))
        pend = cc.pending_for("a")
        log.append([{k: v for k, v in p.items() if k != "capture_id"} for p in pend])
        log.append(cc.pending_for("a"))
        log.append(cc.complete({"capture_id": pend[0]["capture_id"], "status": "done",
                                "artifact": "/tmp/x", "summary": {"ms": 1}}))
        log.append(cc.complete({"capture_id": pend[0]["capture_id"], "status": "done"}))
        log.append(cc.complete({"capture_id": "cap-nope"}))
        log.append(cc.complete("junk"))
        log.append([{k: v for k, v in r.items()
                     if k not in ("capture_id", "requested_wall", "delivered_wall",
                                  "completed_wall")} for r in cc.snapshot()])
        outs.append(log)
    assert outs[1] == outs[0]


def test_host_profiler_collapses_stacks_like_the_reference():
    stop = threading.Event()
    worker = threading.Thread(target=stop.wait, name="parked worker", daemon=True)
    worker.start()
    try:
        outs = []
        for mod in (jax_profile, torch_profile):
            prof = mod.HostProfiler(hz=1000.0, max_stacks=16, max_depth=2)
            for _ in range(3):
                prof.sample_once()
            lines = [ln for ln in prof.collapsed().splitlines()
                     if ln.startswith("parked worker;")]
            st = prof.stats()
            outs.append((lines, st["samples"], st["hz"], prof.running))
        assert outs[1] == outs[0]
        assert len(outs[1][0]) == 1 and outs[1][0][0].endswith(" 3")
        prof = torch_profile.HostProfiler(hz=50.0).start()
        prof.stop()
        assert not prof.running
    finally:
        stop.set()


# ---- scrape ----

class _Handler(http.server.BaseHTTPRequestHandler):
    routes = {}

    def do_GET(self):  # noqa: N802 — the stdlib's name
        body = self.routes.get(self.path)
        if body is None:
            self.send_response(404)
            self.end_headers()
            return
        data = body.encode() if isinstance(body, str) else json.dumps(body).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *args):
        pass


@pytest.fixture(scope="module")
def controller_url():
    store = torch_trace.TraceStore()
    for j in range(3):
        tid = f"job-{j}"
        root = store.open(tid, "submit", start_clock=0.0, span_id=f"r{j}")
        for k, name in enumerate(("stage", "execute", "stage", "execute")):
            store.add({"trace_id": tid, "span_id": f"{tid}-{k}", "parent_span_id": root,
                       "name": name, "start_wall": T0 + j + k * 0.4,
                       "start_mono": float(k), "duration_ms": 500.0 + 100 * j,
                       "process": f"agent:gpu-{j % 2}", "attributes": {}})
        store.finish(tid, root, 2.0 + j)
    reg = _registry(torch_metrics, 9)
    text = torch_metrics.render_snapshots([(_fix_ts(reg.snapshot()), {}),
                                           (_fix_ts(reg.snapshot()), {"agent": "gpu-0"})])
    _Handler.routes = {"/v1/metrics": text, "/v1/health": {"verdict": "ok"},
                       "/v1/traces?limit=64": {"traces": store.summaries(limit=64)},
                       **{f"/v1/trace/{t}": store.assemble(t) for t in store.trace_ids()}}
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


def _scrape(mod, url):
    text = mod.fetch_metrics_text(url)
    return (text, mod.op_phase_seconds(text, ["echo", "map_classify_tpu", "none"]),
            mod.op_phase_seconds("garbage{", ["echo"]), mod.fetch_health(url),
            mod.fetch_json(url, "/v1/missing"), mod.fetch_trace(url, "job-1"),
            mod.slowest_trace(url), mod.collect_trace_spans(url),
            mod.stage_execute_overlap(url), mod.stage_execute_overlap_by_agent(url),
            mod.fetch_metrics_text("http://127.0.0.1:9/", timeout=0.5))


def test_scrape_helpers_match_the_reference(controller_url):
    got, want = _scrape(torch_scrape, controller_url), _scrape(jax_scrape, controller_url)
    assert got == want
    assert want[0] and want[5]["trace_id"] == "job-1" and want[8] is not None
    spans = want[7]
    assert torch_scrape.overlap_by_process(spans) == jax_scrape.overlap_by_process(spans)
    assert torch_scrape.overlap_from_spans([]) == jax_scrape.overlap_from_spans([])
