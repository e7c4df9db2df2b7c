"""A rehearsal of chip_smoke's phase 19 on the CPU at toy size: the port's
controller plans two workflows, leases them through its fair scheduler to
the port's pipelined agent on an explicit CPU runtime, answers the
resubmitted workflows from the result cache, and samples, stores,
judges, bills and traces them. On the CPU the agent advertises
``device_kind`` "cpu", so the fair policy must defer its classify jobs (on
the card, "cuda", it must not). The phase must raise when a dependency is
leased early or a cached job is leased; and phase 14's bf16 route check
runs with both of its sides on the CPU."""

import pytest

import chip_smoke
from agent_tpu_torch.kernels import flash_attention as fa
from agent_tpu_torch.ops import load_ops
from agent_tpu_torch.runtime.runtime import TorchRuntime

TINY = {"d_model": 64, "n_heads": 2, "n_layers": 2, "d_ff": 64, "max_len": 64,
        "dtype": "float32"}


@pytest.fixture
def rehearsal(monkeypatch, tmp_path):
    for name, value in (("CARD", "cpu"), ("BERT_BASE", TINY), ("DRAIN_ROWS", 512),
                        ("DRAIN_SHARD", 128), ("CONTROL_RISK_VALUES", 300),
                        ("DRAIN_TIMEOUT_S", 120)):
        monkeypatch.setattr(chip_smoke, name, value)
    plain = fa.make_flash_attention

    def counting(mesh=None):
        attn = plain(mesh)

        def run(q, k, v, mask):
            fa.LAUNCH_COUNTS["flash_attention"] += 1
            return attn(q, k, v, mask)

        return run

    monkeypatch.setattr(fa, "make_flash_attention", counting)
    path = str(tmp_path / "drain.csv")
    chip_smoke.write_drain_csv(path)
    rt = TorchRuntime(device="cpu")
    op = load_ops(["map_classify_tpu"])["map_classify_tpu"]
    shards = chip_smoke.drain_payloads(path)[2]
    chunks = [len(op.stage(dict(p))[1]["chunks"]) for p in shards]
    serial, _ = chip_smoke.serial_shards(op, rt, shards)
    yield rt, path, serial, chunks
    chip_smoke.reset_counts(fa)


def test_control_plane_phase_rehearsal(rehearsal, capsys):
    rt, path, serial, chunks = rehearsal
    report = chip_smoke.control_plane_phase(fa, rt, path, serial, chunks)
    assert report["device_kind"] == "cpu" and report["placement_deferrals"] > 0
    assert report["workflows"]["jobs"] == 10 and len(report["lease_order"]) == 10
    order = report["lease_order"]
    assert order.index("reduce") > max(order.index(f"risk{i}") for i in range(4))
    assert order.index("report") > max(order.index(f"cls{i}") for i in range(4))
    assert report["row1_launches"] == report["row1_launches_want"] == TINY["n_layers"] * 4
    assert report["row1_launches_after_resubmit"] == report["row1_launches"]
    assert report["cache_hits"] == 10 and report["cache"]["hits"] == 10
    assert report["tsdb"]["bytes"] > 0 and report["tsdb"]["points_read_back"] > 0
    assert report["exposition"]["samples_checked"] > 0
    assert set(report["usage_by_tenant"]) == {"acme", "globex"}
    assert report["usage_by_tenant"]["acme"]["result_cache_hits"] == 5
    assert report["usage_by_tenant"]["globex"]["result_cache_hits"] == 5
    assert report["slo"]["objective"] == "classify_latency" and report["slo"]["state"] == "ok"
    assert report["sched_decisions"]["leased"] == 10
    assert report["trace_spans"] >= 10 * 6 + 2
    assert '"phase": "control_plane"' in capsys.readouterr().out


def test_the_phase_raises_when_a_dependency_is_leased_early(rehearsal, monkeypatch):
    """A planted fault in the controller's dependency gate lets the reduce
    and the report out before their upstream jobs are done; the lease
    audit, which reads the controller's flight recorder, catches it."""
    from agent_tpu_torch.controller.core import Controller

    monkeypatch.setattr(Controller, "_deps_done_locked", lambda self, job: True)
    rt, path, serial, chunks = rehearsal
    with pytest.raises(SystemExit, match="early"):
        chip_smoke.control_plane_phase(fa, rt, path, serial, chunks)


def test_the_phase_raises_when_a_cached_job_is_leased(rehearsal, monkeypatch):
    """A planted cache that never answers: the resubmitted workflows are
    leased again, and the phase fails."""
    from agent_tpu_torch.flow.result_cache import ResultCache

    monkeypatch.setattr(ResultCache, "get", lambda self, op, payload: None)
    rt, path, serial, chunks = rehearsal
    with pytest.raises(SystemExit, match="the cached resubmit"):
        chip_smoke.control_plane_phase(fa, rt, path, serial, chunks)


def test_moe_routes_bf16_rehearsal(monkeypatch):
    monkeypatch.setattr(chip_smoke, "CARD", "cpu")
    monkeypatch.setattr(chip_smoke, "MOE_ROUTE_TOKENS", 1024)
    report = chip_smoke.moe_routes_bf16()
    assert report["share_routed_alike"] == 1.0 and report["tokens"] == 1024
    assert report["expert_differs"] == report["keep_differs"] == 0
