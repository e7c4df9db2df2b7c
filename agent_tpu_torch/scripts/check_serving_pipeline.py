"""Check of the online-serving front door beside a bulk drain, on the card.

The port of the reference's ``scripts/check_serving_pipeline.py``. It drives
interactive ``POST /v1/infer`` requests against a real HTTP controller and a
real pipelined agent WHILE a bulk classify drain runs through the same agent,
and holds the serving bars:

1. every interactive request completes (classify and summarize, greedy and
   beam, mixed per-request ``max_length`` budgets);
2. TTFT stays under ``TTFT_BOUND_MS`` (warm-up requests pay the weights'
   build first, so the bound judges queueing and decode);
3. iteration-level batching batched: some serving batch held more than one
   request (``max_occupancy`` > 1);
4. the bulk drain's results are bit-identical to a serving-off drain of the
   same job;
5. the controller's ``interactive_ttft`` objective saw every request;
6. the disaggregated leg: with ``SERVE_DISAGG``, every summarize split into
   a ``serve_prefill`` -> ``serve_decode`` chain run by two agents (one
   offering only ``serve_prefill``, one ``serve_decode`` and the bulk op),
   the summaries are bit-identical to a colocated run of the same texts,
   both ops ran, the shared-prefix mix hit the prefix cache, and TTFT holds
   the bound while a bulk drain runs on the decode agent.

    python -m agent_tpu_torch.scripts.check_serving_pipeline
    TPU_DISABLED=1 python -m agent_tpu_torch.scripts.check_serving_pipeline

Exit 0 when every bar holds. It differs from the reference in these ways:

- No CPU unasked: the agents run on ``get_runtime()``, which is ``cuda:0``
  and raises without CUDA; the CPU runs only when ``TPU_DISABLED=1`` asks
  for it. The reference defaults ``JAX_PLATFORMS`` to ``cpu``.
- No ``requests``: the agents and the client post through the port's
  ``utils/http.py``.
- Bar 6 reads the prefix-cache hits through the controller's own counter,
  ``serve_prefix_cache_events_total{event="hits"}``.
- The front door flushes a bucket when it fills, or at its deadline when a
  lease poll, the sweeper or a wait pumps it. The reference posts its
  8-request volley while the agent polls, so on a loaded host eight posts
  can land further apart than ``max_wait_ms`` and each flush alone. Here
  the agents' lease polls are held while the volley and the split leg's
  requests are posted (``AgentWire.hold``): the first ``max_batch`` requests
  leave as one full batch (bar 3), and both stacks of the split leg form
  the same batches (bar 6). The load generator starts once the agent holds
  its first bulk shard, so every request is served beside the drain.
- The serving controllers run the fair scheduler (``SCHED_POLICY=fair``),
  under which the front door's batch jobs (priority ``SERVE_PRIORITY``, 8)
  lease ahead of the bulk shards (``SCHED_DEFAULT_PRIORITY``, 4). Under the
  reference's FIFO default every request waits for every bulk shard
  submitted before it, so none is served beside the drain; the reference's
  1,024 tiny rows drain in well under its load window, which hides that.
- Each leg takes its model configs, CSV rows, shard size and runtime as
  arguments whose defaults are the reference's constants, and records what
  it measured in ``report`` when given one: chip_smoke's phase 24 runs the
  legs at BERT-base and seq2seq width through them.
- The OK line is the reference's; on the card it adds the card's name and
  power limit (``nvidia-smi --query-gpu=name,power.limit``).
"""

from __future__ import annotations

import contextlib
import os
import statistics
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

TINY_S2S = {
    "d_model": 32, "n_heads": 4, "n_enc_layers": 1, "n_dec_layers": 1,
    "d_ff": 64, "max_src_len": 64, "max_tgt_len": 16, "dtype": "float32",
}
TINY_CLS = {
    "d_model": 32, "n_heads": 4, "n_layers": 1, "d_ff": 64,
    "max_len": 64, "dtype": "float32", "n_classes": 16,
}
BULK_ROWS = 1024
BULK_SHARD = 128
N_INFER = 24
TTFT_BOUND_MS = 30_000.0   # generous: 1-core CI containers stall freely
DISAGG_N = 10              # prefix-heavy: 10 requests over 3 shared docs
LOAD_SECONDS = max(4.0, N_INFER / 6.0)
VOLLEY = 8
DRAIN_TIMEOUT_S = 600.0
# The agents' staging pool: one worker, so that an agent holds few leased
# bulk shards (two queued for the worker, two staged) ahead of a serving job
# it leases next.
STAGE_WORKERS = 1
# Result outcomes the controller refuses (controller_results_total).
REFUSED = ("stale_epoch", "duplicate", "unknown_job")
# The front door's batching: the serving leg's, and the split leg's stacks'.
SERVE_KNOBS = {"max_wait_ms": 15.0, "max_batch": 6}
SPLIT_SERVE_KNOBS = {"max_wait_ms": 10.0, "max_batch": 4}


class BarFailed(AssertionError):
    """A serving bar that does not hold."""


def bar(ok: bool, message: str) -> None:
    if not ok:
        raise BarFailed(message)


class AgentWire:
    """An agent's session (its lease loop and its poster thread) over
    ``utils.http``: while ``hold()`` is in force its lease polls wait, and
    it keeps the wall time at which each job was first leased and at which
    each result post was answered."""

    def __init__(self, inner: Any = None) -> None:
        from agent_tpu_torch.utils.http import UrllibSession

        self.inner = inner if inner is not None else UrllibSession()
        self._cond = threading.Condition()
        self._held = False
        self._polls = 0  # lease polls in flight
        self.leased: Dict[str, float] = {}
        self.answered: Dict[str, float] = {}

    def post(self, url: str, json: Any = None, timeout: float = 10.0):  # noqa: A002
        lease = url.endswith("/v1/leases")
        if lease:
            with self._cond:
                while self._held:
                    self._cond.wait()
                self._polls += 1
        try:
            resp = self.inner.post(url, json=json, timeout=timeout)
        finally:
            if lease:
                with self._cond:
                    self._polls -= 1
                    self._cond.notify_all()
        wall = time.time()
        if lease and resp.status_code == 200:
            for task in resp.json().get("tasks") or ():
                with self._cond:
                    self.leased.setdefault(task["id"], wall)
        elif url.endswith("/v1/results") and isinstance(json, dict):
            with self._cond:
                self.answered[json.get("job_id")] = wall
        return resp

    def get(self, url: str, timeout: float = 10.0):
        return self.inner.get(url, timeout=timeout)

    @contextlib.contextmanager
    def hold(self):
        """No lease poll runs inside the block: a poll that started before
        it has returned when the block begins."""
        with self._cond:
            self._held = True
            while self._polls:
                self._cond.wait()
        try:
            yield
        finally:
            with self._cond:
                self._held = False
                self._cond.notify_all()

    def first_lease(self, job_ids) -> Optional[float]:
        with self._cond:
            walls = [self.leased[j] for j in job_ids if j in self.leased]
        return min(walls) if walls else None

    def last_answer(self, job_ids) -> Optional[float]:
        with self._cond:
            walls = [self.answered[j] for j in job_ids if j in self.answered]
        return max(walls) if walls else None


def warm_bodies(cls_config, s2s_config) -> List[Dict[str, Any]]:
    """The serving leg's warm-up requests, each posted and awaited alone."""
    return [{"op": op, "text": "warm the serving path", "params": params} for op, params in (
        ("classify", {"model_config": cls_config, "topk": 2}),
        ("summarize", {"model_config": s2s_config, "max_length": 4}),
        ("summarize", {"model_config": s2s_config, "max_length": 4, "num_beams": 2}),
    )]


def traffic(cls_config, s2s_config):
    """The serving leg's open-loop load: classify and summarize (greedy and
    beam, mixed ``max_length``) at weights 1 and 2, 6 arrivals a second,
    seed 7."""
    from agent_tpu_torch.loadgen import ArrivalPattern, LoadGen, TrafficClass

    classes = [
        TrafficClass(
            name="classify", op="classify", weight=1.0, route="infer",
            payload_fn=lambda rng, seq: {
                "text": f"interactive classify {seq}",
                "params": {"model_config": cls_config, "topk": 2},
            },
        ),
        TrafficClass(
            name="summarize", op="summarize", weight=2.0, route="infer",
            payload_fn=lambda rng, seq: {
                "text": f"interactive summarize {seq} " + "payload " * (seq % 3 + 1),
                "params": {
                    "model_config": s2s_config,
                    "max_length": 3 + seq % 6,
                    **({"num_beams": 2} if seq % 3 == 0 else {}),
                },
            },
        ),
    ]
    return LoadGen(classes, ArrivalPattern(6.0), seed=7)


def volley_bodies(s2s_config) -> List[Dict[str, Any]]:
    """VOLLEY same-bucket summarize requests posted at once (bar 3)."""
    return [{"op": "summarize", "text": f"volley request {i}",
             "params": {"model_config": s2s_config, "max_length": 4 + i}}
            for i in range(VOLLEY)]


def disagg_bodies(s2s_config) -> List[Dict[str, Any]]:
    """The split leg's prefix-heavy requests: DISAGG_N over 3 shared
    documents."""
    return [{"op": "summarize",
             "text": f"disagg shared context document {i % 3} "
                     + "with a common preamble clause " * 4,
             "params": {"model_config": s2s_config, "max_length": 6}}
            for i in range(DISAGG_N)]


def write_csv(path: str, rows: int) -> None:
    with open(path, "w") as f:
        f.write("id,text\n")
        for i in range(rows):
            f.write(f'{i},"serving smoke record {i} with a payload"\n')


def bulk_payload(cls_config: Dict[str, Any]) -> Dict[str, Any]:
    """The bulk job's shard payload fields beside the CSV's."""
    return {"text_field": "text", "allow_fallback": False,
            "result_format": "columnar", "model_config": cls_config}


def bulk_results(controller, shard_ids):
    out = {}
    for jid in shard_ids:
        snap = controller.job_snapshot(jid)
        bar(snap["state"] == "succeeded", f"bulk shard {jid}: {snap['state']} {snap['error']}")
        r = snap["result"]
        bar(isinstance(r, dict) and r.get("ok") is True, f"bulk shard {jid}: {r}")
        out[controller.job(jid).payload["start_row"]] = (r["indices"], r["scores"])
    return out


def kernel_launches() -> float:
    """Row 1's launch count in this process (the wrappers' counter)."""
    from agent_tpu_torch.kernels import flash_attention as fa

    return float(fa.LAUNCH_COUNTS["flash_attention"])


def start_agent(url: str, name: str, tasks, runtime):
    """A pipelined agent (depth 2) on its own thread -> (agent, wire,
    thread)."""
    from agent_tpu_torch.agent.app import Agent
    from agent_tpu_torch.agent.pipeline import PipelineRunner
    from agent_tpu_torch.config import AgentConfig, Config

    wire = AgentWire()
    agent = Agent(config=Config(agent=AgentConfig(
        controller_url=url, agent_name=name, tasks=tuple(tasks), idle_sleep_sec=0.0,
        stage_workers=STAGE_WORKERS,
    )), session=wire, runtime=runtime)
    agent.post_session_factory = lambda: wire
    agent._profile = {"tier": "smoke"}
    thread = threading.Thread(target=PipelineRunner(agent, depth=2).run, daemon=True)
    thread.start()
    return agent, wire, thread


def stop_agents(agents, threads) -> None:
    for a in agents:
        a.running = False
    for th in threads:
        th.join(timeout=60)


def wait_drained(controller) -> None:
    deadline = time.monotonic() + DRAIN_TIMEOUT_S
    while not controller.drained():
        bar(time.monotonic() < deadline, f"not drained: {controller.counts()}")
        time.sleep(0.02)


def post_infer(sess, url: str, body: Dict[str, Any], timeout: float) -> Dict[str, Any]:
    r = sess.post(url + "/v1/infer", json=body, timeout=timeout)
    bar(r.status_code == 200, f"POST /v1/infer: {r.status_code} {r.text[:500]}")
    return r.json()


def stack_record(controller, launches_before: float) -> Dict[str, Any]:
    """What one controller's run left: each succeeded job's op, agent,
    device, fallback flag, prefix-cache misses and bulk start row; the
    result outcomes; row 1's launches in this process since
    ``launches_before``."""
    from agent_tpu_torch.obs.metrics import parse_exposition

    jobs = []
    for jid, r in controller.results().items():
        job = controller.job(jid)
        r = r if isinstance(r, dict) else {}
        jobs.append({"job_id": jid, "op": job.op, "agent": job.agent,
                     "device": r.get("device"), "fallback": bool(r.get("fallback")),
                     "prefix_misses": int((r.get("prefix_cache") or {}).get("misses") or 0),
                     "n_requests": len(job.payload.get("requests") or ()),
                     "start_row": job.payload.get("start_row")})
    outcomes: Dict[str, float] = {}
    samples = parse_exposition(controller.metrics.render()).get("controller_results_total", [])
    for labels, value in samples:
        outcomes[labels["outcome"]] = outcomes.get(labels["outcome"], 0.0) + value
    return {"jobs": jobs, "counts": controller.counts(), "result_outcomes": outcomes,
            "refused_result_posts": sum(outcomes.get(o, 0.0) for o in REFUSED),
            "launches": kernel_launches() - launches_before}


def percentile(values: List[float], q: float) -> float:
    ordered = sorted(values)
    return ordered[min(len(ordered) - 1, int(q * len(ordered)))]


def check_answers(snaps, what: str = "") -> List[float]:
    """Bars 1 and 2: every request done, and its TTFT under
    ``TTFT_BOUND_MS`` -> the TTFTs."""
    for snap in snaps:
        bar(snap is not None and snap["state"] == "done", f"{what}request: {snap}")
    ttfts = [s["ttft_ms"] for s in snaps if s.get("ttft_ms") is not None]
    bar(bool(ttfts) and max(ttfts) < TTFT_BOUND_MS,
        f"{what}TTFT bound breached: max {max(ttfts or [0.0])}ms")
    return ttfts


def check_batched(serve_results) -> int:
    """Bar 3: some serving batch held more than one request -> the largest
    ``max_occupancy``."""
    max_occ = max([int(r.get("max_occupancy") or 0) for r in serve_results
                   if isinstance(r, dict)] or [0])
    bar(max_occ > 1, f"no serving batch ever held >1 request (max {max_occ})")
    return max_occ


def check_bulk(got, reference) -> None:
    """Bar 4: the bulk results bit-identical to the serving-off drain's."""
    bar(got == reference, "bulk drain results diverged with serving traffic on")


def check_objective(seen: float, n_requests: int) -> None:
    """Bar 5: the interactive_ttft objective saw every request."""
    bar(seen >= n_requests, f"TTFT objective saw {seen} < {n_requests} requests")


def check_split(colocated, split, ops, hits: float) -> None:
    """Bar 6: the split ran both halves, hit the prefix cache, and gave the
    colocated summaries."""
    bar({"serve_prefill", "serve_decode"} <= set(ops),
        f"disagg chain did not split: ops {sorted(ops)}")
    bar(hits > 0, "shared-prefix mix produced no cache hits")
    bar(split == colocated, "disaggregated summaries diverged from the colocated path")


def drain_reference(csv_path, cls_config=TINY_CLS, rows=BULK_ROWS, shard=BULK_SHARD,
                    runtime=None, report=None):
    """Serving-off reference drain: same bulk job, no interactive load."""
    from agent_tpu_torch.config import ServeConfig
    from agent_tpu_torch.controller import Controller, ControllerServer
    from agent_tpu_torch.runtime.runtime import get_runtime

    runtime = runtime if runtime is not None else get_runtime()
    controller = Controller(lease_ttl_sec=600.0, serve=ServeConfig(enabled=False))
    server = ControllerServer(controller).start()
    launches0 = kernel_launches()
    try:
        agent, wire, t = start_agent(server.url, "smoke-ref", ("map_classify_tpu",), runtime)
        shard_ids, _ = controller.submit_csv_job(
            csv_path, total_rows=rows, shard_size=shard, map_op="map_classify_tpu",
            extra_payload=bulk_payload(cls_config))
        wait_drained(controller)
        stop_agents([agent], [t])
        results = bulk_results(controller, shard_ids)
        if report is not None:
            first, last = wire.first_lease(shard_ids), wire.last_answer(shard_ids)
            report["reference"] = {
                **stack_record(controller, launches0), "rows": rows, "shards": len(shard_ids),
                "first_bulk_lease_wall": first, "last_bulk_result_wall": last,
                "bulk_rows_per_s": rows / (last - first), "bulk_results": results}
        return results
    finally:
        server.stop()


def disagg_leg(csv_path, s2s_config=TINY_S2S, cls_config=TINY_CLS, rows=BULK_ROWS,
               shard=BULK_SHARD, runtime=None, report=None) -> str:
    """Bar 6: prefill and decode on separate agents, outputs bit-identical
    to the colocated path, TTFT bound held under bulk load.

    Two stacks over the same texts: colocated (one agent offering
    ``serve_summarize``) and disaggregated (an agent offering ONLY
    ``serve_prefill`` plus an agent offering ``serve_decode`` and the bulk
    op: the encoded rows cross an agent boundary, with the controller's
    dependency gating as the queue between the stages). The engine store
    is reset between stacks so both start cold."""
    from agent_tpu_torch.config import SchedConfig, ServeConfig
    from agent_tpu_torch.controller import Controller, ControllerServer
    from agent_tpu_torch.ops.serve_infer import reset_engines
    from agent_tpu_torch.runtime.runtime import get_runtime
    from agent_tpu_torch.utils.http import UrllibSession

    runtime = runtime if runtime is not None else get_runtime()
    bodies = disagg_bodies(s2s_config)

    def run_stack(disagg, agent_specs, with_bulk):
        reset_engines()
        controller = Controller(
            lease_ttl_sec=600.0, sched=SchedConfig(policy="fair"),
            serve=ServeConfig(**SPLIT_SERVE_KNOBS, disaggregated=disagg),
        )
        server = ControllerServer(controller).start()
        launches0 = kernel_launches()
        agents, wires, threads = [], [], []
        try:
            for name, tasks in agent_specs:
                a, w, th = start_agent(server.url, name, tasks, runtime)
                agents.append(a)
                wires.append(w)
                threads.append(th)
            sess = UrllibSession()
            warm = post_infer(sess, server.url, dict(bodies[0], text="warm the serving path"),
                              timeout=600)
            bar(warm["state"] == "done", f"warm-up: {warm}")

            shard_ids = []
            if with_bulk:
                shard_ids, _ = controller.submit_csv_job(
                    csv_path, total_rows=rows, shard_size=shard, map_op="map_classify_tpu",
                    extra_payload=bulk_payload(cls_config))
            t0 = time.time()
            with contextlib.ExitStack() as held:
                for w in wires:
                    held.enter_context(w.hold())
                rids = [post_infer(sess, server.url, dict(body, wait=False),
                                   timeout=30)["req_id"] for body in bodies]
            snaps = [controller.wait_infer(rid, 300.0) for rid in rids]
            t_answered = time.time()
            ttfts = check_answers(snaps, "disagg ")
            if with_bulk:
                wait_drained(controller)
                bulk_results(controller, shard_ids)  # all shards succeeded
            stop_agents(agents, threads)
            record = {**stack_record(controller, launches0),
                      "ops": sorted({controller.job(j).op for j in controller.results()}),
                      "prefix_hits": controller._m_serve_prefix.value(event="hits"),
                      "requests": len(snaps), "ttft_ms": ttfts,
                      "ttft_ms_p50": statistics.median(ttfts),
                      "ttft_ms_p99": percentile(ttfts, 0.99),
                      "requests_per_s": len(snaps) / (t_answered - t0),
                      "summaries": [s["result"]["summary"] for s in snaps]}
            if with_bulk:
                first = min(w.first_lease(shard_ids) or float("inf") for w in wires)
                last = max(w.last_answer(shard_ids) or 0.0 for w in wires)
                record.update(bulk_rows=rows, bulk_shards=len(shard_ids),
                              first_bulk_lease_wall=first, last_bulk_result_wall=last,
                              bulk_rows_per_s=rows / (last - first))
            return record
        finally:
            for a in agents:
                a.running = False
            server.stop()

    print("[serving-smoke] disaggregated leg: colocated reference ...", flush=True)
    colo = run_stack(False, [("smoke-colo", ("serve_summarize",))], with_bulk=False)
    print("[serving-smoke] disaggregated leg: split agents + bulk ...", flush=True)
    split = run_stack(
        True,
        [("smoke-prefill", ("serve_prefill",)),
         ("smoke-decode", ("serve_decode", "map_classify_tpu"))],
        with_bulk=True,
    )
    if report is not None:
        report["disagg"] = {"colocated": colo, "split": split}
    check_split(colo["summaries"], split["summaries"], split["ops"], split["prefix_hits"])
    return (
        f"disagg {len(split['summaries'])} reqs bit-identical across split agents "
        f"(ttft max {max(split['ttft_ms']):.0f}ms under bulk)"
    )


def main(cls_config=TINY_CLS, s2s_config=TINY_S2S, rows=BULK_ROWS, shard=BULK_SHARD, *,
         csv_path: Optional[str] = None, disagg_rows: Optional[int] = None,
         runtime=None, report: Optional[Dict[str, Any]] = None) -> int:
    """The three legs in the reference's order: the serving-off drain, the
    serving leg (bars 1-5), the disaggregated leg (bar 6). ``csv_path``
    drains a CSV of ``rows`` rows the caller wrote (else the reference's,
    written to a temporary directory); the first ``disagg_rows`` of it
    (default ``rows``) feed the split leg's bulk drain. ``report`` receives
    each leg's record: its jobs, result outcomes and row-1 launches, TTFTs,
    requests/s, the drains' rows/s and walls, and the bars' evidence."""
    from agent_tpu_torch.config import SchedConfig, ServeConfig
    from agent_tpu_torch.controller import Controller, ControllerServer
    from agent_tpu_torch.loadgen import session_submitter
    from agent_tpu_torch.runtime.runtime import get_runtime
    from agent_tpu_torch.scripts.drain_at_scale import card_lines
    from agent_tpu_torch.utils.http import UrllibSession

    t_start = time.monotonic()
    runtime = runtime if runtime is not None else get_runtime()
    report = report if report is not None else {}
    with tempfile.TemporaryDirectory() as td:
        if csv_path is None:
            csv_path = os.path.join(td, "bulk.csv")
            write_csv(csv_path, rows)
        print("[serving-smoke] serving-off reference drain ...", flush=True)
        reference = drain_reference(csv_path, cls_config, rows, shard, runtime, report)

        controller = Controller(
            lease_ttl_sec=600.0, sched=SchedConfig(policy="fair"),
            serve=ServeConfig(**SERVE_KNOBS),
        )
        server = ControllerServer(controller).start()
        launches0 = kernel_launches()
        try:
            agent, wire, t = start_agent(
                server.url, "smoke-serving",
                ("serve_classify", "serve_summarize", "map_classify_tpu"), runtime)

            # Warm the serving and bulk paths: the weights' build must not
            # count against the TTFT bound (production pays it at boot).
            sess = UrllibSession()
            for body in warm_bodies(cls_config, s2s_config):
                warm = post_infer(sess, server.url, body, timeout=600)
                bar(warm["state"] == "done", f"warm-up: {warm}")

            # Interactive load (loadgen's infer route) over a running bulk
            # drain, from the agent's first bulk shard on.
            print("[serving-smoke] bulk drain + interactive load ...", flush=True)
            shard_ids, _ = controller.submit_csv_job(
                csv_path, total_rows=rows, shard_size=shard, map_op="map_classify_tpu",
                extra_payload=bulk_payload(cls_config))
            deadline = time.monotonic() + DRAIN_TIMEOUT_S
            while wire.first_lease(shard_ids) is None:
                bar(time.monotonic() < deadline, "the agent leased no bulk shard")
                time.sleep(0.002)
            gen = traffic(cls_config, s2s_config)
            t_load = time.time()
            stats = gen.run(session_submitter(sess, server.url), LOAD_SECONDS)
            req_ids = stats.job_ids()
            bar(len(req_ids) >= N_INFER // 2, f"loadgen submitted only {len(req_ids)} requests")

            # A volley on top of the open-loop trickle: VOLLEY same-bucket
            # summarize requests posted with the lease polls held, so the
            # coalescer and the decode engine share the batch (bar 3).
            with wire.hold():
                volley_ids = [post_infer(sess, server.url, dict(body, wait=False),
                                         timeout=30)["req_id"]
                              for body in volley_bodies(s2s_config)]
            req_ids.extend(volley_ids)

            # Bars 1 and 2: every request completes, TTFT under the bound.
            snaps = [controller.wait_infer(rid, 300.0) for rid in req_ids]
            t_answered = time.time()
            ttfts = check_answers(snaps)

            wait_drained(controller)
            serve_results = [controller.job(j).result for j in controller.results()
                             if j.startswith("serve-")]
            max_occ = check_batched(serve_results)
            got = bulk_results(controller, shard_ids)
            check_bulk(got, reference)

            # Bar 5: the interactive_ttft objective saw the stream. The
            # front door wakes a request's waiter before the completing
            # thread hands the request to the objective, so the read waits
            # (boundedly) for the last hand-over.
            deadline = time.monotonic() + 30.0
            while True:
                results = {r["objective"]: r for r in controller.slo.evaluate()}
                seen = results["interactive_ttft"]["windows"]["long"]["requests"]
                if seen >= len(snaps) or time.monotonic() > deadline:
                    break
                time.sleep(0.01)
            check_objective(seen, len(snaps))

            stop_agents([agent], [t])
            first_post = t_load + stats.jobs[0]["submitted_t"] if stats.jobs else t_load
            first, last = wire.first_lease(shard_ids), wire.last_answer(shard_ids)
            report["serving"] = {
                **stack_record(controller, launches0), "requests": len(snaps),
                "ttft_ms": ttfts, "ttft_ms_p50": statistics.median(ttfts),
                "ttft_ms_p99": percentile(ttfts, 0.99),
                "requests_per_s": len(snaps) / (t_answered - first_post),
                "max_occupancy": max_occ, "slo_requests_seen": seen,
                "bulk_rows": rows, "bulk_shards": len(shard_ids),
                "first_bulk_lease_wall": first, "first_request_wall": first_post,
                "last_answer_wall": t_answered, "last_bulk_result_wall": last,
                "bulk_rows_per_s": rows / (last - first),
                "overlap_s": min(t_answered, last) - max(first_post, first),
                "snaps": snaps, "serve_results": serve_results, "bulk_results": got}
        finally:
            server.stop()

        # Bar 6: the disaggregated prefill/decode leg.
        disagg_line = disagg_leg(csv_path, s2s_config, cls_config, disagg_rows or rows, shard,
                                 runtime, report)
    card = card_lines() if runtime.platform == "cuda" else None
    print(
        f"[serving-smoke] OK: {len(snaps)} interactive requests "
        f"(ttft p50 {sorted(ttfts)[len(ttfts) // 2]:.0f}ms, "
        f"max {max(ttfts):.0f}ms), max occupancy {max_occ}, "
        f"bulk bit-identical over {len(reference)} shards, "
        f"{disagg_line}, "
        f"wall {time.monotonic() - t_start:.1f}s"
        + (f", card {'; '.join(card)}" if card else ""),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
