"""``python -m agent_tpu_torch.scripts.drain_at_scale`` on the CPU
(``TPU_DISABLED=1``), with the ops' default models and 256 rows: the
in-process leg, a fleet of two member processes and a dp = 2 mesh agent.
Each report holds the keys of the reference script's report
(``scripts/drain_at_scale.py``, read with ``ast``) and of its record
``DRAIN_AT_SCALE.json``, plus the card's lines and the pushed launch
counts; every row of both ops lands in its sink."""

from __future__ import annotations

import ast
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from agent_tpu_torch.scripts import drain_at_scale as port

ROOT = Path(__file__).resolve().parents[1]
REFERENCE_SCRIPT = ROOT / "scripts" / "drain_at_scale.py"
ROWS = 256
PORT_ONLY_KEYS = {"card", "kernel_launches"}


def _dict_keys(node: ast.Dict, helpers) -> set:
    keys = set()
    for k, v in zip(node.keys, node.values):
        if k is None:  # **helper(...): that helper's returned keys
            keys |= helpers[v.func.id]
        else:
            keys.add(k.value)
    return keys


def reference_report_keys() -> dict:
    """{function: (top-level keys, classify keys, summarize keys)} of each
    ``report = {...}`` in the reference script."""
    tree = ast.parse(REFERENCE_SCRIPT.read_text(encoding="utf-8"))
    funcs = {f.name: f for f in tree.body if isinstance(f, ast.FunctionDef)}
    ret = next(n for n in ast.walk(funcs["health_fields"]) if isinstance(n, ast.Return))
    helpers = {"health_fields": {k.value for k in ret.value.keys}}
    out = {}
    for name in ("main", "main_fleet"):
        for node in ast.walk(funcs[name]):
            if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                    and getattr(node.targets[0], "id", None) == "report"):
                blocks = {k.value: _dict_keys(v, helpers)
                          for k, v in zip(node.value.keys, node.value.values)
                          if k is not None and isinstance(v, ast.Dict)}
                out[name] = (_dict_keys(node.value, helpers), blocks["classify"],
                             blocks["summarize"])
    return out


def _run(tmp_path, *args, timeout=240, **env_extra):
    env = dict(os.environ, TPU_DISABLED="1", OMP_NUM_THREADS="2", PYTHONPATH=str(ROOT),
               **env_extra)
    env.pop("TASKS", None)
    workdir = tmp_path / "work"
    proc = subprocess.run(
        [sys.executable, "-m", "agent_tpu_torch.scripts.drain_at_scale", "--rows", str(ROWS),
         "--workdir", str(workdir), "--progress-sec", "5", *args],
        cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=timeout)
    report_path = workdir / "drain_at_scale.json"
    report = json.loads(report_path.read_text()) if report_path.exists() else None
    return proc, report, workdir


def _sink_lines(workdir: Path, op: str) -> int:
    out = workdir / ("classify_out" if op == "map_classify_tpu" else "summarize_out")
    return sum(len(p.read_text().splitlines()) for p in out.glob(f"{op}_rows_*.jsonl"))


def _check_report(report, workdir, function):
    top, classify, summarize = reference_report_keys()[function]
    assert set(report) == top | PORT_ONLY_KEYS
    assert set(report["classify"]) == classify and set(report["summarize"]) == summarize
    if function == "main":  # the record is the in-process leg's
        record = json.loads((ROOT / "DRAIN_AT_SCALE.json").read_text())
        assert set(record) <= set(report)
        assert set(record["classify"]) <= set(report["classify"])
        assert set(record["summarize"]) <= set(report["summarize"])
    assert report["rows"] == ROWS and report["non_ok_results"] == 0
    assert report["counts"].get("failed", 0) == 0
    assert report["platform"] == "cpu"
    assert report["card"] is None or isinstance(report["card"], list)
    for op, block in (("map_classify_tpu", "classify"), ("map_summarize", "summarize")):
        assert report[block]["rows_written"] == ROWS
        assert _sink_lines(workdir, op) == ROWS


def test_the_in_process_leg_drains_every_row(tmp_path):
    proc, report, workdir = _run(tmp_path)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "DRAIN OK" in proc.stdout
    _check_report(report, workdir, "main")
    assert report["mode"] == "single" and report["n_chips"] == 1
    assert report["per_agent_shards"] == {"drain-at-scale": 2}
    # On the CPU no kernel launches; the gauge is pushed all the same.
    assert report["kernel_launches"]["drain-at-scale"]["flash_attention"] == 0
    # It writes only under --workdir (and --report, which defaults there).
    assert sorted(p.name for p in workdir.iterdir()) == [
        "classify_out", f"drain_{ROWS}.csv", "drain_at_scale.json", "summarize_out",
        "warm_out"]


def test_a_fleet_of_two_member_processes_drains_every_row(tmp_path):
    # Each member holds one task at a time (the serial loop), so the two
    # shards go one to each member.
    proc, report, workdir = _run(tmp_path, "--agents", "2", "--fleet-platform", "cpu",
                                 PIPELINE_DEPTH="0")
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    _check_report(report, workdir, "main_fleet")
    assert report["mode"] == "fleet" and report["agents"] == 2 and report["n_chips"] == 2
    assert report["per_agent_shards"] == {"drain-0": 1, "drain-1": 1}
    assert {name: got["flash_attention"] for name, got in report["kernel_launches"].items()} \
        == {"drain-0": 0, "drain-1": 0}


def test_the_mesh_leg_drains_on_a_dp_2_runtime(tmp_path):
    proc, report, workdir = _run(tmp_path, "--mesh-dp", "2", "--fleet-platform", "cpu")
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    _check_report(report, workdir, "main_fleet")
    assert report["mode"] == "mesh" and report["devices_per_agent"] == 2
    assert report["n_chips"] == 2 and report["per_agent_shards"] == {"drain-0": 2}


def _run_without_a_card(tmp_path, *args, **env_extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT), **env_extra)
    if "TPU_DISABLED" not in env_extra:
        env.pop("TPU_DISABLED", None)
    workdir = tmp_path / "work"
    proc = subprocess.run(
        [sys.executable, "-m", "agent_tpu_torch.scripts.drain_at_scale", "--rows", "16",
         "--workdir", str(workdir), *args], cwd=str(ROOT), env=env, capture_output=True,
        text=True, timeout=120)
    return proc, workdir


@pytest.mark.parametrize("leg", [[], ["--agents", "2"], ["--mesh-dp", "2"],
                                 ["--agents", "2", "--fleet-platform", "cuda"]],
                         ids=["in-process", "fleet", "mesh", "fleet-cuda"])
def test_without_a_card_the_drain_raises_and_writes_no_report(tmp_path, leg):
    """Every leg runs on the card by default: with no card it raises before
    it builds a CSV or starts a member, rather than draining on the CPU."""
    proc, workdir = _run_without_a_card(tmp_path, *leg)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr
    assert not (workdir / "drain_at_scale.json").exists()
    assert not (workdir / "fleet_logs").exists()


@pytest.mark.parametrize("leg,env", [
    (["--agents", "2", "--fleet-platform", "cpu"], {}),
    (["--mesh-dp", "2", "--fleet-platform", "cpu"], {}),
    (["--agents", "2", "--fleet-platform", "cuda"], {"TPU_DISABLED": "1"}),
], ids=["fleet-cpu-unasked", "mesh-cpu-unasked", "fleet-cuda-with-cpu-asked"])
def test_the_fleet_platform_must_agree_with_tpu_disabled(tmp_path, leg, env):
    """``--fleet-platform cpu`` is the members' CPU, which only
    ``TPU_DISABLED=1`` asks for; a flag that contradicts it is refused."""
    proc, workdir = _run_without_a_card(tmp_path, *leg, **env)
    assert proc.returncode == 2, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "TPU_DISABLED" in proc.stderr
    assert not workdir.exists()


def test_agents_and_mesh_are_alternatives(tmp_path):
    assert port.main(["--rows", "16", "--workdir", str(tmp_path), "--agents", "2",
                      "--mesh-dp", "2"]) == 2


@pytest.mark.parametrize("rows", [1, 300])
def test_build_csv_writes_the_reference_s_bytes(tmp_path, rows):
    spec = importlib.util.spec_from_file_location("reference_drain_at_scale",
                                                  REFERENCE_SCRIPT)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    ref.build_csv(str(tmp_path / "ref.csv"), rows)
    port.build_csv(str(tmp_path / "port.csv"), rows)
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "ref.csv").read_bytes()
    assert (ref.CLASSIFY_SHARD, ref.SUMMARIZE_SHARD, ref.SUMMARIZE_MAX_NEW, ref.SLO_SPEC) == (
        port.CLASSIFY_SHARD, port.SUMMARIZE_SHARD, port.SUMMARIZE_MAX_NEW, port.SLO_SPEC)


def test_the_warm_shards_are_the_reference_s(tmp_path):
    spec = importlib.util.spec_from_file_location("reference_drain_at_scale",
                                                  REFERENCE_SCRIPT)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    extras = port.op_payloads(str(tmp_path), "none")
    for rows in (100, 8192, 20000):
        want = ref.warm_payload_specs("x.csv", rows, extras["map_classify_tpu"],
                                      extras["map_summarize"], "warm")
        assert port.warm_payload_specs("x.csv", rows, extras, "warm") == want


def _slowest_after_echo_drain(max_traces: int, n_jobs: int):
    from agent_tpu_torch.agent.app import Agent
    from agent_tpu_torch.config import AgentConfig, Config
    from agent_tpu_torch.controller import Controller, ControllerServer
    from agent_tpu_torch.obs.scrape import slowest_trace
    from agent_tpu_torch.obs.trace import TraceStore
    from agent_tpu_torch.utils.http import UrllibSession

    c = Controller(trace_store=TraceStore(max_traces=max_traces))
    with ControllerServer(c, host="127.0.0.1", port=0) as srv:
        for i in range(n_jobs):
            c.submit("echo", {"i": i})
        agent = Agent(config=Config(agent=AgentConfig(
            controller_url=srv.url, agent_name="t", tasks=("echo",), idle_sleep_sec=0.0)),
            session=UrllibSession())
        for _ in range(10 * n_jobs):
            if c.drained():
                break
            agent.step()
        agent.step()  # the last spans ride the next poll
        return slowest_trace(srv.url)


def test_the_trace_window_holds_every_job_of_the_drain():
    """A run with more jobs than the trace store holds loses every root
    (a job's later spans reopen a trace evicted at submit), and the
    report's slowest-shard line fails the drain: the reference's default
    window of 512 did so on the card at 10M rows (2,442 shards). The
    port's drain sizes the window to its jobs."""
    assert port.shard_count(10_000_000) == 2442 == json.loads(
        (ROOT / "DRAIN_AT_SCALE.json").read_text())["shards"]
    assert port.trace_window(2446) == 2446 and port.trace_window(4) == 512
    assert _slowest_after_echo_drain(4, 12) is None
    got = _slowest_after_echo_drain(port.trace_window(12), 12)
    assert got is not None and got["spans"]
