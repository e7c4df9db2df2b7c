"""At-scale mixed drain: BASELINE.json's north-star job shape, on the card.

Drains an N-row (default 10M) CSV through both model ops (every row
classified and summarized) via the real controller, HTTP server, agent and
pipeline, with per-row results streaming to JSONL sinks (``output_uri``) so
the controller carries receipts, not payloads:

    python -m agent_tpu_torch.scripts.drain_at_scale --rows 10000000 \\
        --workdir /data/drain10m

    # classify at BERT-base width: a local HF BERT checkpoint directory
    TPU_MODEL_PATH=/ckpt/bert-base-uncased python -m agent_tpu_torch.scripts.drain_at_scale

    # a fleet of two device-pinned agent processes, one card each
    python -m agent_tpu_torch.scripts.drain_at_scale --agents 2 --fleet-platform cuda

    # one agent on a dp = 2 mesh
    python -m agent_tpu_torch.scripts.drain_at_scale --mesh-dp 2 --fleet-platform cuda

The runtime is ``cuda:0`` (``get_runtime``); without CUDA it raises, and
the CPU runs only when asked for (``TPU_DISABLED=1``). ``--agents N`` drains
through a fleet of N device-pinned agent processes
(``agent_tpu_torch.agent.fleet``; ``--fleet-platform cuda``, the default,
pins each to its own cards and raises when there are too few;
``--fleet-platform cpu`` makes each ask for the CPU, and is refused unless
``TPU_DISABLED=1`` asks for it too); ``--mesh-dp N`` drains through one
agent whose runtime runs dp-sharded over N devices. Both record
per-agent shard counts and each agent's stage/execute overlap from the
trace, and fail the drain if an agent got no shard. Each op's shards are
warmed outside the timed window (both ends of the CSV, since row ids grow
across a length bucket).

The report holds the wall time, per-op rows/s and device-span seconds,
shard counts, retries and failures, the platform (``cuda``) and the cards
used, and the sinks' row totals, under the keys of the reference script's
report (``scripts/drain_at_scale.py``). It differs from the reference's
in four ways:

- it adds the card's name and power limit (``card``, the lines of
  ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``) and each
  agent's pushed ``kernel_launches`` gauge (``kernel_launches``);
- ``--report`` defaults to ``<workdir>/drain_at_scale.json``, so a run from
  the repo root never overwrites the reference's ``DRAIN_AT_SCALE.json``;
- the controller's trace window holds every job of the run
  (``trace_window``): the reference's default of 512 traces loses every
  root past that many jobs, and its slowest-shard line then fails a
  10M-row drain;
- the reference's comments on one TPU generation's rates are left out; the
  fields they explain stay.

Exit 0 when every row of both ops landed in its sink with no failed shard.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

DRAIN_OPS = ("map_classify_tpu", "map_summarize")
CLASSIFY_SHARD = 8192
SUMMARIZE_SHARD = 8192
SUMMARIZE_MAX_NEW = 32
# Op-keyed objectives with a generous p99 (a bulk shard runs seconds): the
# report records attainment and the verdict; a healthy drain never pages.
SLO_SPEC = (
    '[{"name": "classify", "op": "map_classify_tpu",'
    ' "p99_ms": 600000, "availability": 0.999},'
    ' {"name": "summarize", "op": "map_summarize",'
    ' "p99_ms": 600000, "availability": 0.999}]'
)
# A gap longer than this with no completed shard counts as a stall.
STALL_GAP_S = 60.0


def build_csv(path: str, n_rows: int) -> None:
    if os.path.exists(path):
        return
    tmp = path + ".tmp"
    t0 = time.perf_counter()
    with open(tmp, "w") as f:
        f.write("id,text,risk\n")
        for i in range(n_rows):
            f.write(
                f'{i},"drain record {i} with a payload of text to classify '
                f'and summarize",{i % 89}\n'
            )
    os.replace(tmp, path)
    print(f"csv built: {n_rows} rows, "
          f"{os.path.getsize(path) / 1e6:.0f} MB, "
          f"{time.perf_counter() - t0:.0f}s", flush=True)


def op_payloads(workdir: str, summarize_quant: str) -> Dict[str, Dict[str, Any]]:
    """The one payload definition per op, shared by the warm submissions and
    the timed jobs (a drifted copy would warm another shape)."""
    summarize = {"text_field": "text", "allow_fallback": False,
                 "max_length": SUMMARIZE_MAX_NEW,
                 "output_uri": os.path.join(workdir, "summarize_out")}
    if summarize_quant != "none":
        summarize["model_config"] = {"quant": summarize_quant}
    return {"map_classify_tpu": {"text_field": "text", "allow_fallback": False,
                                 "output_uri": os.path.join(workdir, "classify_out")},
            "map_summarize": summarize}


def shard_sizes() -> Dict[str, int]:
    return {"map_classify_tpu": CLASSIFY_SHARD, "map_summarize": SUMMARIZE_SHARD}


def warm_payload_specs(csv_path: str, n_rows: int, extras: Dict[str, Dict[str, Any]],
                       warm_out: str) -> List[Dict[str, Any]]:
    """``[{op, payload}]`` covering both length buckets of both ops (row ids
    grow 1 to 7 digits across the dataset): the warm shape shared by the
    in-process warm submissions and the fleet members' warm-up."""
    specs = []
    for op_name in DRAIN_OPS:
        shard = shard_sizes()[op_name]
        starts = [0]
        tail = max(0, n_rows - min(shard, n_rows))
        if tail > 0:
            starts.append(tail)
        for start in starts:
            specs.append({"op": op_name, "payload": {
                **extras[op_name], "source_uri": csv_path, "start_row": start,
                "shard_size": min(shard, n_rows - start), "output_uri": warm_out,
            }})
    return specs


def trace_window(n_jobs: int) -> int:
    """Traces the drain's controller keeps: every job of the run, and never
    fewer than the store's default. The default window (512) holds the
    newest traces only; past it, a job's later spans open a trace whose
    root was evicted at submit, and a 2,442-shard run (10M rows) then has
    no closed root for the report's slowest-shard line."""
    from agent_tpu_torch.obs.trace import DEFAULT_MAX_TRACES

    return max(DEFAULT_MAX_TRACES, int(n_jobs))


def shard_count(n_rows: int) -> int:
    """Both ops' shards of an ``n_rows`` drain."""
    return sum(-(-n_rows // size) for size in shard_sizes().values())


def per_agent_shards(controller, job_ids) -> Dict[str, int]:
    """{agent: executed shard count} over ``job_ids``."""
    counts: Dict[str, int] = {}
    for jid in job_ids:
        agent = controller.job_snapshot(jid)["agent"]
        if agent:
            counts[agent] = counts.get(agent, 0) + 1
    return counts


def pushed_launches(controller) -> Dict[str, Dict[str, float]]:
    """{agent: {kernel: launches}} from each agent's last pushed
    ``kernel_launches`` gauge (cumulative over the agent's process), in the
    obs snapshot the controller keeps beside the agent's metrics."""
    out: Dict[str, Dict[str, float]] = {}
    for name, entry in dict(controller.agent_metrics).items():
        family = (entry.get("obs") or {}).get("kernel_launches") or {}
        out[name] = {s["labels"].get("kernel", ""): s["value"]
                     for s in family.get("series", [])}
    return out


def card_lines() -> Optional[List[str]]:
    """The cards' ``name, power.limit`` lines as nvidia-smi gives them; None
    where there is no nvidia-smi."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    try:
        proc = subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return [ln.strip() for ln in proc.stdout.splitlines() if ln.strip()] or None


def health_report(server_url: str) -> Optional[Dict[str, Any]]:
    """Per-op SLO attainment and MFU and the verdict from ``GET
    /v1/health``; None when unreachable (the caller fails the drain)."""
    from agent_tpu_torch.obs.scrape import fetch_health

    health = fetch_health(server_url)
    if health is None:
        return None
    attain = {o.get("op", o["objective"]): o.get("attainment")
              for o in health["slo"]["objectives"]}
    mfu: Dict[str, List[float]] = {}
    duty: Dict[str, Any] = {}
    for name, row in (health.get("agents") or {}).items():
        duty[name] = row.get("duty_cycle")
        for op, v in (row.get("mfu") or {}).items():
            mfu.setdefault(op, []).append(v)
    return {"verdict": health["verdict"], "attain": attain,
            # The fleet's MFU per op: the mean over the agents that report it.
            "mfu": {op: round(sum(vs) / len(vs), 4) for op, vs in mfu.items()},
            "duty": duty}


def health_fields(hf: Dict[str, Any]) -> Dict[str, Any]:
    """The flat report fields both drain modes record."""
    return {
        "health_verdict": hf["verdict"],
        "slo_attainment_classify": hf["attain"].get("map_classify_tpu"),
        "slo_attainment_summarize": hf["attain"].get("map_summarize"),
        "mfu_classify": hf["mfu"].get("map_classify_tpu"),
        "mfu_summarize": hf["mfu"].get("map_summarize"),
        "duty_cycle_by_agent": hf["duty"],
    }


def overlap_report(server_url: str):
    """(fleet overlap, per-agent overlap) from the trace window; either may
    be None when tracing is off."""
    from agent_tpu_torch.obs.scrape import (
        collect_trace_spans,
        overlap_by_process,
        overlap_from_spans,
    )

    spans = collect_trace_spans(server_url)
    if spans is None:
        return None, None
    return overlap_from_spans(spans), overlap_by_process(spans)


def rows_by_op(results) -> Dict[str, Any]:
    """Per-op ``rows_written`` over the ok results, the not-ok count and the
    ok results themselves."""
    from agent_tpu_torch.utils.spans import result_op

    rows_written = {op: 0 for op in DRAIN_OPS}
    not_ok = 0
    ok_results = []
    for r in results:
        if not isinstance(r, dict) or r.get("ok") is not True:
            not_ok += 1
            continue
        ok_results.append(r)
        op = result_op(r)
        if op in rows_written:
            rows_written[op] += int(r.get("rows_written", 0))
    return {"rows_written": rows_written, "not_ok": not_ok, "ok_results": ok_results}


def write_report(path: str, report: Dict[str, Any]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report), flush=True)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=10_000_000)
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "drain_at_scale"))
    ap.add_argument("--report", default="",
                    help="the report's path (default: <workdir>/drain_at_scale.json)")
    ap.add_argument("--progress-sec", type=float, default=60.0)
    # A fleet of N pinned agent processes, or one dp = N mesh agent; the
    # default (1, 0) is the in-process leg.
    ap.add_argument("--agents", type=int, default=1)
    ap.add_argument("--devices-per-agent", type=int, default=1)
    ap.add_argument("--mesh-dp", type=int, default=0,
                    help="run one agent with MESH_SHAPE=dp=N (N devices)")
    from agent_tpu_torch.agent.fleet import PLATFORMS

    ap.add_argument("--fleet-platform", choices=PLATFORMS, default=None,
                    help="cuda (the default) = each member pinned to its own cards; "
                         "cpu = each member asks for the CPU (needs TPU_DISABLED=1)")
    ap.add_argument("--summarize-quant", default="none", choices=("int8", "none"))
    args = ap.parse_args(argv)
    args.report = args.report or os.path.join(args.workdir, "drain_at_scale.json")
    from agent_tpu_torch.config import env_bool

    # The CPU is the operator's explicit request (TPU_DISABLED=1), for the
    # fleet's members as for the in-process runtime: never a default.
    cpu_asked = env_bool("TPU_DISABLED", False)
    args.fleet_platform = args.fleet_platform or ("cpu" if cpu_asked else "cuda")
    if (args.fleet_platform == "cpu") != cpu_asked:
        print(f"--fleet-platform {args.fleet_platform} with TPU_DISABLED "
              f"{'set' if cpu_asked else 'unset'}: the CPU runs only when TPU_DISABLED=1 "
              "asks for it, and then for every member", file=sys.stderr, flush=True)
        return 2

    if args.agents > 1 or args.mesh_dp > 1 or args.devices_per_agent > 1:
        return main_fleet(args)

    from agent_tpu_torch.agent.app import Agent
    from agent_tpu_torch.agent.pipeline import PipelineRunner
    from agent_tpu_torch.config import AgentConfig, Config, SloConfig
    from agent_tpu_torch.controller import Controller, ControllerServer
    from agent_tpu_torch.obs import trace as obs_trace
    from agent_tpu_torch.obs.scrape import (
        fetch_metrics_text,
        op_phase_seconds,
        slowest_trace,
        stage_execute_overlap,
        stage_execute_overlap_by_agent,
    )
    from agent_tpu_torch.obs.trace import TraceStore, phase_breakdown
    from agent_tpu_torch.runtime.runtime import get_runtime
    from agent_tpu_torch.utils.http import UrllibSession
    from agent_tpu_torch.utils.spans import op_span_ms

    os.makedirs(args.workdir, exist_ok=True)
    csv_path = os.path.join(args.workdir, f"drain_{args.rows}.csv")
    build_csv(csv_path, args.rows)
    extras = op_payloads(args.workdir, args.summarize_quant)

    runtime = get_runtime()
    warm_specs = warm_payload_specs(csv_path, args.rows, extras,
                                    os.path.join(args.workdir, "warm_out"))
    controller = Controller(lease_ttl_sec=600.0, slo=SloConfig(spec=SLO_SPEC),
                            trace_store=TraceStore(max_traces=trace_window(
                                len(warm_specs) + shard_count(args.rows))))
    with ControllerServer(controller) as server:
        cfg = Config(agent=AgentConfig(controller_url=server.url, agent_name="drain-at-scale",
                                       tasks=DRAIN_OPS, idle_sleep_sec=0.0))
        agent = Agent(config=cfg, session=UrllibSession(), runtime=runtime)
        agent._profile = {"tier": "at-scale"}

        # Warm outside the timed window: the weights' and kernels' build is
        # a once-a-process cost. Warm results go to a scratch sink, so the
        # real sinks hold exactly the timed job's shards.
        for spec in warm_specs:
            controller.submit(spec["op"], spec["payload"])
        n_warm = len(warm_specs)
        warm_done: Dict[str, bool] = {}

        def warm_watch():
            while not controller.drained():
                time.sleep(0.05)
            warm_done["ok"] = True
            agent.running = False

        threading.Thread(target=warm_watch, daemon=True).start()
        t_warm = time.perf_counter()
        PipelineRunner(agent, depth=2).run()
        # A failed warm shard leaves a cold build inside the timed window.
        warm_results = controller.results()
        warm_bad = [j for j, r in warm_results.items()
                    if not (isinstance(r, dict) and r.get("ok") is True)]
        if not warm_done.get("ok") or len(warm_results) != n_warm or warm_bad:
            print(f"DRAIN FAILED: warmup: {len(warm_results)}/{n_warm} results, "
                  f"bad={warm_bad}", flush=True)
            return 1
        print(f"warmup done ({time.perf_counter() - t_warm:.0f}s, "
              f"{n_warm} shards, both buckets x both ops)", flush=True)
        agent.running = True
        warm_jobs = set(warm_results)
        # Per-op device spans are the /v1/metrics delta across the window.
        pre_text = fetch_metrics_text(server.url)
        span_pre = op_phase_seconds(pre_text, DRAIN_OPS) if pre_text is not None else None
        t_start = time.perf_counter()  # the timed window starts after the warm-up

        for op_name in DRAIN_OPS:
            controller.submit_csv_job(csv_path, total_rows=args.rows,
                                      shard_size=shard_sizes()[op_name], map_op=op_name,
                                      extra_payload=extras[op_name])
        n_shards = sum(controller.counts().values()) - n_warm
        print(f"submitted {n_shards} shards ({args.rows} rows x 2 ops)", flush=True)

        done: Dict[str, float] = {}

        def watch():
            # Gaps over STALL_GAP_S with no completion are summed, so the
            # report separates the framework's rate from outages.
            last = 0.0
            last_done_n = -1
            last_change = time.perf_counter()
            stall_s = 0.0
            while not controller.drained():
                time.sleep(1.0)
                now = time.perf_counter()
                c = controller.counts()
                done_n = c.get("succeeded", 0) + c.get("failed", 0) - n_warm
                if done_n != last_done_n:
                    gap = now - last_change
                    if gap > STALL_GAP_S:
                        stall_s += gap
                        print(f"[stall] {gap:.0f}s with no completions", flush=True)
                    last_done_n = done_n
                    last_change = now
                if now - last >= args.progress_sec:
                    last = now
                    print(f"[{now - t_start:7.0f}s] {json.dumps(c)} "
                          f"({done_n}/{n_shards} shards)", flush=True)
            gap = time.perf_counter() - last_change
            if gap > STALL_GAP_S:
                stall_s += gap
            done["wall"] = time.perf_counter() - t_start
            done["stall_s"] = stall_s
            agent.running = False

        threading.Thread(target=watch, daemon=True).start()
        PipelineRunner(agent, depth=2).run()
        wall = done.get("wall", time.perf_counter() - t_start)
        stall_s = done.get("stall_s", 0.0)

        counts = dict(controller.counts())
        if counts.get("succeeded"):
            counts["succeeded"] -= n_warm  # the warm shards are untimed
        tally = rows_by_op(r for j, r in controller.results().items() if j not in warm_jobs)
        rows_written, not_ok = tally["rows_written"], tally["not_ok"]
        # Per-shard device span (dispatch + deferred fetch) from the scraped
        # fleet series; summed from the result bodies when there is none.
        post_text = fetch_metrics_text(server.url)
        busy_s: Dict[str, float] = {}
        span_source = "scrape"
        if span_pre is not None and post_text is not None:
            span_post = op_phase_seconds(post_text, DRAIN_OPS)
            busy_s = {op: span_post[op] - span_pre[op] for op in DRAIN_OPS}
        if not any(busy_s.values()):
            span_source = "result_bodies"
            busy_ms = op_span_ms(tally["ok_results"], DRAIN_OPS)
            busy_s = {op: busy_ms[op] / 1e3 for op in DRAIN_OPS}

        # The slowest shard's phases and the stage/execute overlap, from
        # GET /v1/trace/*: a broken trace path fails the drain.
        trace_line = overlap = overlap_by_agent = None
        if obs_trace.enabled():
            worst = slowest_trace(server.url)
            if worst is None:
                print("DRAIN FAILED: trace path broken — /v1/traces or "
                      "/v1/trace/{job_id} returned nothing for a drained run", flush=True)
                return 1
            trace_line = phase_breakdown(worst)
            print(f"[slowest shard] {trace_line}", flush=True)
            overlap = stage_execute_overlap(server.url)
            if overlap is None:
                print("DRAIN FAILED: no closed stage/execute spans in the trace window",
                      flush=True)
                return 1
            print(f"[overlap] {overlap['overlap_ratio']:.3f} of stage wall time hidden "
                  f"behind execute (stage p50 {overlap['stage_p50_ms']:.1f} ms vs "
                  f"execute p50 {overlap['execute_p50_ms']:.1f} ms)", flush=True)
            overlap_by_agent = stage_execute_overlap_by_agent(server.url)
        agent_shards = per_agent_shards(
            controller, [j for j in controller.results() if j not in warm_jobs])
        hf = health_report(server.url)
        if hf is None:
            print("DRAIN FAILED: GET /v1/health unreachable", flush=True)
            return 1
        print(f"[health] verdict={hf['verdict']} attainment={hf['attain']} "
              f"mfu={hf['mfu']}", flush=True)
        launches = pushed_launches(controller)

    report = {
        **health_fields(hf),
        "rows": args.rows,
        "ops": list(DRAIN_OPS),
        "wall_s": round(wall, 1),
        "shards": n_shards,
        "counts": counts,
        "non_ok_results": not_ok,
        "total_rows_per_sec": round(2 * args.rows / wall, 1),
        "tunnel_stall_s": round(stall_s, 1),
        "rows_per_sec_excl_stalls": round(2 * args.rows / max(wall - stall_s, 1e-9), 1),
        # "span" = per-shard dispatch + deferred-fetch wait summed per op;
        # under the pipeline's overlap it can over- or under-count the
        # device's busy time: wall_s and total_rows_per_sec come first.
        "span_source": span_source,
        "slowest_trace": trace_line,
        "stage_execute_overlap": overlap,
        "mode": "single",
        "per_agent_shards": agent_shards,
        "stage_execute_overlap_by_agent": overlap_by_agent,
        "classify": {
            "shard_size": CLASSIFY_SHARD,
            "rows_written": rows_written["map_classify_tpu"],
            "device_span_s": round(busy_s["map_classify_tpu"], 1),
            "rows_per_span_sec": round(args.rows / busy_s["map_classify_tpu"], 1)
            if busy_s["map_classify_tpu"] else None,
        },
        "summarize": {
            "shard_size": SUMMARIZE_SHARD,
            "max_new_tokens": SUMMARIZE_MAX_NEW,
            "quant": args.summarize_quant,
            "rows_written": rows_written["map_summarize"],
            "device_span_s": round(busy_s["map_summarize"], 1),
            "rows_per_span_sec": round(args.rows / busy_s["map_summarize"], 1)
            if busy_s["map_summarize"] else None,
        },
        "platform": runtime.platform,
        "n_chips": runtime.n_devices,
        "card": card_lines(),
        "kernel_launches": launches,
    }
    write_report(args.report, report)

    ok = (
        counts.get("failed", 0) == 0
        and not_ok == 0
        and rows_written["map_classify_tpu"] == args.rows
        and rows_written["map_summarize"] == args.rows
        # An agent with no shard fails the drain: placement is broken even
        # when every row landed.
        and bool(agent_shards)
        and all(v > 0 for v in agent_shards.values())
    )
    print("DRAIN", "OK" if ok else "FAILED", flush=True)
    return 0 if ok else 1


def main_fleet(args) -> int:
    """The same drain by a fleet of pinned agent processes (``--agents N``)
    or one dp = N mesh agent (``--mesh-dp N``), timed after the members'
    own warm-up like the in-process leg."""
    from agent_tpu_torch.agent import fleet as fleet_mod
    from agent_tpu_torch.config import SchedConfig, SloConfig
    from agent_tpu_torch.controller import Controller, ControllerServer
    from agent_tpu_torch.obs import trace as obs_trace
    from agent_tpu_torch.obs.scrape import fetch_metrics_text, op_phase_seconds, slowest_trace
    from agent_tpu_torch.obs.trace import TraceStore, phase_breakdown

    if args.mesh_dp > 1 and args.agents > 1:
        print("--agents and --mesh-dp are alternative modes; pick one", flush=True)
        return 2
    mode = "mesh" if args.mesh_dp > 1 else "fleet"
    n_agents = 1 if mode == "mesh" else args.agents
    dev_per = args.mesh_dp if mode == "mesh" else args.devices_per_agent
    mesh_shape = f"dp={args.mesh_dp}" if mode == "mesh" else ""
    if args.fleet_platform == "cuda":
        import torch

        need, have = n_agents * dev_per, torch.cuda.device_count()
        if need > have:
            raise RuntimeError(f"the {mode} drain pins {need} CUDA card(s) and {have} "
                               "are visible; the CPU runs only with TPU_DISABLED=1")

    os.makedirs(args.workdir, exist_ok=True)
    csv_path = os.path.join(args.workdir, f"drain_{args.rows}.csv")
    build_csv(csv_path, args.rows)
    extras = op_payloads(args.workdir, args.summarize_quant)
    # The members warm locally, before their first lease: the build is a
    # once-a-process cost and must stay out of the window.
    warm_file = os.path.join(args.workdir, "fleet_warm.json")
    with open(warm_file, "w") as f:
        json.dump(warm_payload_specs(csv_path, args.rows, extras,
                                     os.path.join(args.workdir, "warm_out")), f)

    controller = Controller(lease_ttl_sec=600.0, sched=SchedConfig(policy="fair"),
                            slo=SloConfig(spec=SLO_SPEC),
                            trace_store=TraceStore(max_traces=trace_window(shard_count(args.rows))))
    with ControllerServer(controller) as server:
        handle = fleet_mod.spawn_fleet(
            n_agents, dev_per, controller_url=server.url, tasks=",".join(DRAIN_OPS),
            platform=args.fleet_platform, name_prefix="drain", mesh_shape=mesh_shape,
            warm_file=warm_file, log_dir=os.path.join(args.workdir, "fleet_logs"),
            extra_env={"IDLE_SLEEP_SEC": "0.02"})
        try:
            if not fleet_mod.wait_for_agents(controller.agents_summary, handle.names,
                                             timeout=1800.0, fleet=handle):
                print(f"DRAIN FAILED: fleet not ready (failures={handle.poll_failures()}); "
                      f"see {args.workdir}/fleet_logs", flush=True)
                return 1
            print(f"fleet ready: {handle.names} ({mode}, {dev_per} device(s) each)",
                  flush=True)
            pre_text = fetch_metrics_text(server.url)
            span_pre = op_phase_seconds(pre_text, DRAIN_OPS) if pre_text is not None else None
            t_start = time.perf_counter()
            shard_ids: List[str] = []
            for op_name in DRAIN_OPS:
                ids, _ = controller.submit_csv_job(
                    csv_path, total_rows=args.rows, shard_size=shard_sizes()[op_name],
                    map_op=op_name, extra_payload=extras[op_name])
                shard_ids.extend(ids)
            n_shards = len(shard_ids)
            print(f"submitted {n_shards} shards ({args.rows} rows x 2 ops)", flush=True)
            last = 0.0
            while not controller.drained():
                time.sleep(1.0)
                if handle.poll_failures():
                    print(f"DRAIN FAILED: fleet member died ({handle.poll_failures()})",
                          flush=True)
                    return 1
                now = time.perf_counter()
                if now - last >= args.progress_sec:
                    last = now
                    print(f"[{now - t_start:7.0f}s] {json.dumps(controller.counts())}",
                          flush=True)
            wall = time.perf_counter() - t_start

            counts = dict(controller.counts())
            tally = rows_by_op(controller.job_snapshot(j)["result"] for j in shard_ids)
            rows_written, not_ok = tally["rows_written"], tally["not_ok"]
            post_text = fetch_metrics_text(server.url)
            busy_s: Dict[str, float] = {}
            if span_pre is not None and post_text is not None:
                span_post = op_phase_seconds(post_text, DRAIN_OPS)
                busy_s = {op: span_post[op] - span_pre[op] for op in DRAIN_OPS}
            agent_shards = per_agent_shards(controller, shard_ids)
            # Every member pushed its runtime's describe() with its leases.
            n_chips = 0
            platform = None
            for entry in controller.agents_summary().values():
                dev = (entry.get("metrics") or {}).get("device") or {}
                n_chips += int(dev.get("n_devices") or 0)
                platform = dev.get("platform") or platform
            trace_line = overlap = overlap_by_agent = None
            if obs_trace.enabled():
                worst = slowest_trace(server.url)
                if worst is None:
                    print("DRAIN FAILED: trace path broken for the fleet drain", flush=True)
                    return 1
                trace_line = phase_breakdown(worst)
                print(f"[slowest shard] {trace_line}", flush=True)
                overlap, overlap_by_agent = overlap_report(server.url)
                if not overlap_by_agent:
                    print("DRAIN FAILED: no per-agent stage/execute overlap assembled",
                          flush=True)
                    return 1
                for name, o in sorted(overlap_by_agent.items()):
                    print(f"[overlap {name}] {o['overlap_ratio']:.3f} hidden (stage p50 "
                          f"{o['stage_p50_ms']:.1f} ms, execute p50 "
                          f"{o['execute_p50_ms']:.1f} ms)", flush=True)
            hf = health_report(server.url)
            if hf is None:
                print("DRAIN FAILED: GET /v1/health unreachable", flush=True)
                return 1
            print(f"[health] verdict={hf['verdict']} attainment={hf['attain']} "
                  f"mfu={hf['mfu']}", flush=True)
            launches = pushed_launches(controller)
        finally:
            handle.stop()

    report = {
        **health_fields(hf),
        "rows": args.rows,
        "ops": list(DRAIN_OPS),
        "mode": mode,
        "agents": n_agents,
        "devices_per_agent": dev_per,
        "wall_s": round(wall, 1),
        "shards": n_shards,
        "counts": counts,
        "non_ok_results": not_ok,
        "total_rows_per_sec": round(2 * args.rows / wall, 1),
        "per_agent_shards": agent_shards,
        "slowest_trace": trace_line,
        "stage_execute_overlap": overlap,
        "stage_execute_overlap_by_agent": overlap_by_agent,
        "classify": {
            "shard_size": CLASSIFY_SHARD,
            "rows_written": rows_written["map_classify_tpu"],
            "device_span_s": round(busy_s.get("map_classify_tpu", 0.0), 1),
        },
        "summarize": {
            "shard_size": SUMMARIZE_SHARD,
            "max_new_tokens": SUMMARIZE_MAX_NEW,
            "quant": args.summarize_quant,
            "rows_written": rows_written["map_summarize"],
            "device_span_s": round(busy_s.get("map_summarize", 0.0), 1),
        },
        "platform": platform,
        "n_chips": n_chips,
        "card": card_lines(),
        "kernel_launches": launches,
    }
    write_report(args.report, report)

    # A member that executed nothing never appears in the per-job agents.
    zero = [a for a, v in agent_shards.items() if v == 0]
    missing = [a for a in handle.names if a not in agent_shards]
    ok = (
        counts.get("failed", 0) == 0
        and not_ok == 0
        and rows_written["map_classify_tpu"] == args.rows
        and rows_written["map_summarize"] == args.rows
        and n_chips >= n_agents * dev_per
        and not zero
        and not missing
    )
    if zero or missing:
        print(f"ZERO-SHARD AGENTS: {zero + missing}", flush=True)
    print("DRAIN", "OK" if ok else "FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
