"""The port of ``scripts/check_serving_pipeline.py``
(``agent_tpu_torch/scripts/check_serving_pipeline.py``) on the CPU at the
script's own tiny sizes. Its ``main()`` exits 0 with ``TPU_DISABLED=1`` and
prints the reference's OK line; without CUDA and without ``TPU_DISABLED``
the entry point exits non-zero. Against the reference script, loaded by
path: the same CSV bytes and constants; its serving-off drain and the
port's give equal top-k indices and scores within f32's 2e-5
(``tests/test_flash_attention.py``); its disaggregated leg's summaries and
the port's are equal token for token (f32, greedy), in both stacks. The
tiny weights are the reference's leaf for leaf, as
``tests/test_torch_prng.py`` and ``tests/test_torch_seq2seq.py`` hold for
``init_params``. Each of the six bars fails on one planted fault in the
evidence of the port's run."""

import contextlib
import copy
import importlib.util
import io
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import agent_tpu.controller.core as ref_core
from agent_tpu_torch.runtime import runtime as port_runtime
from agent_tpu_torch.scripts import check_serving_pipeline as csp

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = 2e-5


def _reference_script():
    path = os.path.join(REPO, "scripts", "check_serving_pipeline.py")
    spec = importlib.util.spec_from_file_location("ref_check_serving_pipeline", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def ported(tmp_path_factory):
    """The port's ``main()`` on the reference's CSV, the CPU asked for with
    TPU_DISABLED=1 -> its exit code, output and report."""
    csv_path = str(tmp_path_factory.mktemp("serving") / "bulk.csv")
    csp.write_csv(csv_path, csp.BULK_ROWS)
    env = pytest.MonkeyPatch()
    env.setenv("TPU_DISABLED", "1")
    port_runtime.reset_runtime()
    report, out = {}, io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = csp.main(csv_path=csv_path, report=report)
    finally:
        port_runtime.reset_runtime()
        env.undo()
    return {"rc": rc, "out": out.getvalue(), "report": report, "csv": csv_path}


def test_main_exits_0_with_tpu_disabled(ported):
    assert ported["rc"] == 0
    ok = [ln for ln in ported["out"].splitlines() if ln.startswith("[serving-smoke] OK: ")]
    assert len(ok) == 1 and "bulk bit-identical over 8 shards" in ok[0]
    assert "disagg 10 reqs bit-identical across split agents" in ok[0]
    report = ported["report"]
    stacks = [report["reference"], report["serving"], report["disagg"]["colocated"],
              report["disagg"]["split"]]
    assert {j["device"] for st in stacks for j in st["jobs"]} == {"cpu"}
    assert not any(st["refused_result_posts"] for st in stacks)
    assert report["serving"]["requests"] >= csp.N_INFER // 2 + csp.VOLLEY


def test_without_cuda_or_tpu_disabled_the_entry_point_exits_non_zero():
    env = {k: v for k, v in os.environ.items() if k != "TPU_DISABLED"}
    env.update(CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-m", "agent_tpu_torch.scripts.check_serving_pipeline"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "[serving-smoke] OK" not in proc.stdout and "RuntimeError" in proc.stderr


def test_the_csv_and_the_constants_are_the_reference_s(tmp_path):
    ref = _reference_script()
    ref.write_csv(str(tmp_path / "ref.csv"), ref.BULK_ROWS)
    csp.write_csv(str(tmp_path / "port.csv"), csp.BULK_ROWS)
    assert (tmp_path / "ref.csv").read_bytes() == (tmp_path / "port.csv").read_bytes()
    for name in ("TINY_CLS", "TINY_S2S", "BULK_ROWS", "BULK_SHARD", "N_INFER", "TTFT_BOUND_MS",
                 "DISAGG_N"):
        assert getattr(csp, name) == getattr(ref, name), name


def test_the_serving_off_drain_matches_the_reference(ported):
    want = _reference_script().drain_reference(ported["csv"])
    got = ported["report"]["reference"]["bulk_results"]
    assert sorted(got) == sorted(want) == list(range(0, csp.BULK_ROWS, csp.BULK_SHARD))
    for start in want:
        (gi, gs), (wi, ws) = got[start], want[start]
        assert gi == wi, start
        np.testing.assert_allclose(np.asarray(gs), np.asarray(ws), rtol=0, atol=F32_TOL)


def test_the_disaggregated_leg_matches_the_reference(ported, monkeypatch):
    summaries = []
    wait = ref_core.Controller.wait_infer

    def recording(self, req_id, timeout_sec):
        """The leg's own waits, on this thread (the HTTP threads' blocking
        warm-up requests wait too)."""
        snap = wait(self, req_id, timeout_sec)
        if threading.current_thread() is threading.main_thread():
            summaries.append(snap["result"]["summary"])
        return snap

    monkeypatch.setattr(ref_core.Controller, "wait_infer", recording)
    ref = _reference_script()
    ref.BULK_ROWS = 2 * ref.BULK_SHARD  # the split stack's bulk: the summaries do not read it
    line = ref.disagg_leg(ported["csv"])
    assert line.startswith(f"disagg {csp.DISAGG_N} reqs bit-identical")
    disagg = ported["report"]["disagg"]
    assert len(summaries) == 2 * csp.DISAGG_N
    assert summaries[:csp.DISAGG_N] == disagg["colocated"]["summaries"]
    assert summaries[csp.DISAGG_N:] == disagg["split"]["summaries"]


def _fails(check, *args, match):
    with pytest.raises(csp.BarFailed, match=match):
        check(*args)


def test_each_bar_fails_on_a_planted_fault(ported):
    report = ported["report"]
    serving, disagg = report["serving"], report["disagg"]
    snaps = serving["snaps"]
    # The run's own evidence passes every bar.
    csp.check_answers(snaps)
    csp.check_batched(serving["serve_results"])
    csp.check_bulk(serving["bulk_results"], report["reference"]["bulk_results"])
    csp.check_objective(serving["slo_requests_seen"], len(snaps))
    split = disagg["split"]
    csp.check_split(disagg["colocated"]["summaries"], split["summaries"], split["ops"],
                    split["prefix_hits"])
    # 1: a request that failed.
    failed = copy.deepcopy(snaps)
    failed[3] = {**failed[3], "state": "failed"}
    _fails(csp.check_answers, failed, match="request")
    # 2: a first token at the bound.
    slow = copy.deepcopy(snaps)
    slow[-1]["ttft_ms"] = csp.TTFT_BOUND_MS
    _fails(csp.check_answers, slow, match="TTFT bound breached")
    # 3: every batch ran one request at a time.
    single = [dict(r, max_occupancy=1) for r in serving["serve_results"]]
    _fails(csp.check_batched, single, match="held >1 request")
    # 4: one bulk score one ulp off.
    bulk = copy.deepcopy(serving["bulk_results"])
    indices, scores = bulk[csp.BULK_SHARD]
    scores[0][0] = float(np.nextafter(scores[0][0], np.inf))
    _fails(csp.check_bulk, bulk, report["reference"]["bulk_results"], match="diverged")
    # 5: the objective missed a request.
    _fails(csp.check_objective, len(snaps) - 1, len(snaps), match="objective saw")
    # 6: a split that never split, one with no prefix hit, one that decoded otherwise.
    colo = disagg["colocated"]["summaries"]
    _fails(csp.check_split, colo, split["summaries"], ["serve_summarize"],
           split["prefix_hits"], match="did not split")
    _fails(csp.check_split, colo, split["summaries"], split["ops"], 0.0, match="no cache hits")
    other = list(split["summaries"])
    other[0] += "x"
    _fails(csp.check_split, colo, other, split["ops"], split["prefix_hits"], match="diverged")
