"""Two real processes joined by the port's ``runtime.distributed`` (gloo on
a free local port), against the reference's two processes under
``jax.distributed`` (tests/test_multihost.py): the broadcast round trip,
the leader/follower agent draining the reference's controller, the op
table (each op's outcome on both processes of either package), the
lockstep crash and the joins that must raise.

Every child is killed at its deadline, so no test can hang the suite."""

import json
import os
import socket
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(code: str, *args: str, n: int = 2, timeout: float = TIMEOUT_S, env=None):
    """Run ``code`` as processes 0 .. n-1 (argv: pid, then ``args``) ->
    ``(return codes, outputs)``; every child still alive at the deadline is
    killed and the test fails."""
    base = dict(os.environ, JAX_PLATFORMS="cpu")
    base.pop("XLA_FLAGS", None)  # one local device a process
    procs = [subprocess.Popen([sys.executable, "-c", code, str(pid), *args],
                              env=dict(base, **(env[pid] if env else {})), cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for pid in range(n)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(0.1, deadline - time.monotonic()))
            outs.append(out)
    except subprocess.TimeoutExpired:
        pytest.fail(f"a child outlived its {timeout} s deadline")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], outs


def _ok(rcs, outs):
    for pid, (rc, out) in enumerate(zip(rcs, outs)):
        assert rc == 0, f"process {pid} failed:\n{out[-3000:]}"
        assert f"OK {pid}" in out, f"process {pid} output:\n{out[-3000:]}"


PRELUDE = textwrap.dedent("""
    import json, os, sys
    sys.path.insert(0, os.getcwd())
    pid, port = int(sys.argv[1]), sys.argv[2]
    addr = f"localhost:{port}"
""")

BROADCAST_CODE = PRELUDE + textwrap.dedent("""
    from agent_tpu_torch.runtime.distributed import (
        _broadcast_bytes, all_gather_tensor, broadcast_shutdown, broadcast_task, current,
        is_shutdown, maybe_initialize, shutdown)
    import torch
    info = maybe_initialize(addr, 2, pid, timeout_s=60)
    assert info.process_count == 2 and info.process_index == pid
    assert maybe_initialize(addr, 2, pid) == info  # idempotent
    tasks = [{"op": "echo", "payload": {"msg": "hi", "n": 42}},
             {"op": "echo", "payload": {"blob": "x" * 100_000, "u": "\\u00e9"}}]
    for task in tasks:
        got = broadcast_task(task if info.is_leader else None)
        assert got == task, got
    assert _broadcast_bytes(b"" if pid else bytes(range(256)) * 33) == bytes(range(256)) * 33
    rows = all_gather_tensor(torch.full((2, 4), float(pid), dtype=torch.float64))
    assert [r[0, 0].item() for r in rows] == [0.0, 1.0]
    if info.is_leader:
        broadcast_shutdown()
    else:
        assert is_shutdown(broadcast_task(None))
    shutdown()
    assert current().process_count == 1  # the group is gone
    print(f"OK {pid}")
""")

AGENT_CODE = PRELUDE + textwrap.dedent("""
    os.environ.update(COORDINATOR_ADDRESS=addr, NUM_PROCESSES="2", PROCESS_ID=str(pid),
                      TASKS="echo,risk_accumulate")
    from agent_tpu_torch.agent.app import Agent
    from agent_tpu_torch.config import Config

    if pid == 0:
        from agent_tpu.controller.core import Controller
        from agent_tpu.controller.server import ControllerServer

        ctrl = Controller()
        for i in range(3):
            ctrl.submit("echo", {"i": i})
        ctrl.submit("risk_accumulate", {"values": [1.0, 2.0, 3.0]})
        with ControllerServer(ctrl) as srv:
            os.environ["CONTROLLER_URL"] = srv.url
            agent = Agent(config=Config.from_env())
            assert agent.dist.is_leader and agent.session is not None
            while not ctrl.drained():
                agent.step()
            from agent_tpu_torch.runtime import distributed
            from agent_tpu_torch.utils.retry import RetryPolicy
            distributed.KEEPALIVE_SEC = 0.0  # idle steps: a keep-alive each
            for _ in range(3):
                agent.step()
            # A controller outage: every lease fails. The leader must keep
            # its followers alive through it, as on an idle step.
            sent = []
            keepalive = distributed.broadcast_keepalive
            distributed.broadcast_keepalive = lambda: (sent.append(1), keepalive())
            lease_once = agent.lease_once
            def failing_lease():
                raise RuntimeError("controller unreachable")
            agent.lease_once = failing_lease
            agent._lease_retry = RetryPolicy(base_sec=0.01, max_sec=0.01).start()
            for _ in range(3):
                assert agent.step() is False
            assert len(sent) == 3, sent
            agent.lease_once = lease_once
            ctrl.submit("echo", {"i": "after the outage"})
            while not ctrl.drained():
                agent.step()
            agent.running = False
            agent.run(max_steps=0)  # the clean exit's shutdown broadcast, then shutdown()
            assert distributed.current().process_count == 1  # the group is gone
            res = ctrl.results()
            assert len(res) == 5, res
            risk = [r for r in res.values() if "sum" in (r or {})][0]
            assert abs(risk["sum"] - 6.0) < 1e-6, risk
        print("OK 0")
    else:
        agent = Agent(config=Config.from_env())
        assert not agent.dist.is_leader and agent.session is None
        agent.run()  # leaves the group on the leader's shutdown
        from agent_tpu_torch.runtime.distributed import current
        assert current().process_count == 1
        assert agent.tasks_done == 5, agent.tasks_done
        print("OK 1")
""")


def test_broadcast_round_trip():
    _ok(*_spawn(BROADCAST_CODE, str(_free_port())))


def test_agent_leader_follower_drains_the_reference_controller():
    _ok(*_spawn(AGENT_CODE, str(_free_port())))


@pytest.mark.parametrize("repeat", range(3))
def test_a_clean_exit_leaves_the_group(repeat):
    """The broadcast round trip on a fresh port, both processes calling
    ``shutdown()`` at the end: each exits 0, and neither aborts at
    interpreter exit ("terminate called without an active exception", the
    gloo group's threads dying with an interpreter that never destroyed
    the group)."""
    rcs, outs = _spawn(BROADCAST_CODE, str(_free_port()))
    _ok(rcs, outs)
    for pid, out in enumerate(outs):
        assert "terminate called" not in out, f"process {pid}:\n{out[-3000:]}"


# ---- the op table: the same payloads through both packages ----

SMALL = {"d_model": 32, "n_heads": 4, "n_layers": 2, "d_ff": 64, "max_len": 64,
         "n_classes": 7, "dtype": "float32"}
S2S = {"d_model": 32, "n_heads": 4, "n_enc_layers": 1, "n_dec_layers": 1, "d_ff": 64,
       "max_src_len": 64, "max_tgt_len": 16, "dtype": "float32"}
# Quarters below 250 in magnitude: every partial sum is exact in f32, so the
# reference's f32 psum and the port's f64 combine agree to the bit.
RISK_VALUES = (np.random.default_rng(7).integers(-1000, 1000, 8192) / 4).tolist()
TABLE = {
    "echo": {"msg": "hi", "n": [1, 2, 3]},
    "map_tokenize": {"items": ["hello world", "two rows"]},
    "risk_accumulate": {"values": RISK_VALUES},
    "map_classify_tpu": {"texts": [f"row {i}" for i in range(16)], "model_config": SMALL,
                         "topk": 3, "allow_fallback": False},
    "train_classifier": {"texts": ["invoice payment", "sensor voltage"] * 4,
                         "labels": [0, 1] * 4, "epochs": 1, "batch_size": 4,
                         "model_config": {k: v for k, v in SMALL.items() if k != "n_classes"}},
    "map_summarize": {"texts": ["a document to compress"] * 4, "max_length": 4,
                      "model_config": S2S},
}
KEPT = ("echo", "tokens", "ids", "count", "sum", "mean", "min", "max", "results", "summaries")

TABLE_CODE = PRELUDE + textwrap.dedent("""
    pkg, table_path = sys.argv[3], sys.argv[4]
    with open(table_path) as fh:
        table, kept = json.load(fh)
    if pkg == "jax":
        import jax; jax.config.update("jax_platforms", "cpu")
        from agent_tpu.config import DeviceConfig
        from agent_tpu.ops import get_op
        from agent_tpu.runtime import TpuRuntime
        from agent_tpu.runtime.context import OpContext
        rt = TpuRuntime(DeviceConfig(tpu_disabled=True, coordinator_address=addr,
                                     num_processes=2, process_id=pid))
    else:
        from agent_tpu_torch.config import DeviceConfig
        from agent_tpu_torch.ops import get_op
        from agent_tpu_torch.runtime.context import OpContext
        from agent_tpu_torch.runtime.runtime import TorchRuntime
        rt = TorchRuntime(device="cpu", config=DeviceConfig(
            coordinator_address=addr, num_processes=2, process_id=pid))
    assert dict(rt.mesh.shape)["dp"] == 2
    outcome = {}
    for op, payload in table.items():
        if op == "train_classifier":
            payload = dict(payload, output_path=os.path.join(os.path.dirname(table_path),
                                                             f"{pkg}{pid}.npz"))
        try:
            out = get_op(op)(payload, OpContext(runtime=rt))
            outcome[op] = {"ok": out.get("ok"),
                           "result": {k: v for k, v in out.items() if k in kept}}
        except Exception as exc:
            outcome[op] = {"raised": type(exc).__name__}
    print("OUTCOME " + json.dumps(outcome))
    if pkg != "jax":
        from agent_tpu_torch.runtime.distributed import shutdown
        shutdown()
    print(f"OK {pid}")
""")


@pytest.fixture(scope="module")
def outcomes(tmp_path_factory):
    """Each package's outcome of every op of TABLE on each of its two
    processes: ``{pkg: [outcome of process 0, of process 1]}``."""
    path = tmp_path_factory.mktemp("table") / "table.json"
    path.write_text(json.dumps([TABLE, KEPT]))
    got = {}
    for pkg in ("jax", "torch"):
        rcs, outs = _spawn(TABLE_CODE, str(_free_port()), pkg, str(path), timeout=240.0)
        _ok(rcs, outs)
        got[pkg] = [json.loads(next(ln for ln in out.splitlines()
                                    if ln.startswith("OUTCOME "))[8:]) for out in outs]
    return got


@pytest.mark.parametrize("op", list(TABLE))
def test_op_table_matches_the_reference(outcomes, op):
    ref, port = ([o[op] for o in outcomes[pkg]] for pkg in ("jax", "torch"))
    assert ref[0] == ref[1] and port[0] == port[1], (ref, port)
    assert port[0] == ref[0], (port[0], ref[0])


def test_the_model_ops_raise_across_processes(outcomes):
    for op in ("map_classify_tpu", "train_classifier", "map_summarize"):
        for pkg in ("jax", "torch"):
            assert [o[op] for o in outcomes[pkg]] == [{"raised": "RuntimeError"}] * 2, (pkg, op)


RISK_CODE = PRELUDE + textwrap.dedent("""
    values = json.loads(sys.argv[3])
    from agent_tpu_torch.config import DeviceConfig
    from agent_tpu_torch.parallel.collectives import mesh_reduce_stats
    from agent_tpu_torch.runtime.runtime import TorchRuntime
    rt = TorchRuntime(device="cpu", config=DeviceConfig(
        coordinator_address=addr, num_processes=2, process_id=pid))
    assert rt.mesh.spans_processes and rt.mesh.local_positions() == [
        {"dp": pid, "tp": 0, "sp": 0}]
    print("STATS " + json.dumps(mesh_reduce_stats(rt, values)))
    from agent_tpu_torch.runtime.distributed import shutdown
    shutdown()
    print(f"OK {pid}")
""")


def test_risk_across_processes_equals_one_process_dp2_exactly():
    """Random f64 values with a subnormal and both signs: the two
    processes' statistics are each bit-equal to one process's dp 2 mesh's,
    and within the reference's hi/lo bound of math.fsum."""
    import math

    from agent_tpu_torch.parallel.collectives import mesh_reduce_stats
    from agent_tpu_torch.runtime.runtime import TorchRuntime

    rng = np.random.default_rng(11)
    values = (rng.normal(size=6000) * 10.0 ** rng.integers(-3, 4, 6000)).tolist() + [1.4e-45]
    rcs, outs = _spawn(RISK_CODE, str(_free_port()), json.dumps(values))
    _ok(rcs, outs)
    got = [json.loads(next(ln for ln in out.splitlines() if ln.startswith("STATS "))[6:])
           for out in outs]
    one = mesh_reduce_stats(TorchRuntime(devices=["cpu"] * 2, mesh_shape={"dp": 2}), values)
    assert got[0] == got[1] == json.loads(json.dumps(one))
    bound = len(values) * 2.0 ** -24 * math.fsum(abs(v) for v in values)
    assert abs(got[0]["sum"] - math.fsum(values)) <= bound


# ---- the lockstep crash ----

CRASH_CODE = PRELUDE + textwrap.dedent("""
    kind = sys.argv[3]
    os.environ.update(COORDINATOR_ADDRESS=addr, NUM_PROCESSES="2", PROCESS_ID=str(pid),
                      TPU_DISABLED="1")
    from agent_tpu_torch.agent.app import Agent
    from agent_tpu_torch.config import Config

    if pid == 0:
        from agent_tpu.controller.core import Controller
        from agent_tpu.controller.server import ControllerServer

        ctrl = Controller()
        if kind == "follower":  # only the follower lacks the op
            ctrl.submit("risk_accumulate", {"values": [1.0, 2.0]})
            ctrl.submit("echo", {"i": 1})
        else:  # the op raises on both: its result would span the processes
            jid = ctrl.submit("map_classify_tpu", {"texts": ["a", "b"], "allow_fallback": False,
                                             "model_config": {"d_model": 32, "n_heads": 2,
                                                              "n_layers": 1, "d_ff": 64,
                                                              "max_len": 32}})
        with ControllerServer(ctrl) as srv:
            os.environ["CONTROLLER_URL"] = srv.url
            agent = Agent(config=Config.from_env())
            try:
                for _ in range(50):
                    agent.step()
                agent.running = False
                agent.run(max_steps=0)
            finally:
                if kind == "both":
                    snap = ctrl.job_snapshot(jid)
                    print("JOB " + json.dumps([snap.get("attempts"), (snap.get(
                        "last_error") or snap.get("error") or {}).get("type")]), flush=True)
        print("survived 0")
    else:
        agent = Agent(config=Config.from_env())
        agent.run()
        print("survived 1")
""")


@pytest.mark.parametrize("kind,tasks", [
    ("follower", ("echo,risk_accumulate", "echo")),
    ("both", ("echo,map_classify_tpu", "echo,map_classify_tpu")),
])
def test_a_raise_takes_both_processes_down(kind, tasks):
    """A follower that raises crashes, and the leader's next collective
    against it raises too; an op that raises on both processes crashes
    both, the leader after posting the failure. Neither hangs."""
    rcs, outs = _spawn(CRASH_CODE, str(_free_port()), kind, timeout=90.0,
                       env=[{"TASKS": t} for t in tasks])
    for pid, (rc, out) in enumerate(zip(rcs, outs)):
        assert rc != 0 and f"survived {pid}" not in out, out[-3000:]
    if kind == "both":
        job = json.loads(next(ln for ln in outs[0].splitlines() if ln.startswith("JOB "))[4:])
        assert job == [1, "RuntimeError"], job


# ---- joins that must raise rather than leave a process alone ----

JOIN_CODE = PRELUDE + textwrap.dedent("""
    import torch.distributed as dist
    from agent_tpu_torch.runtime.distributed import DistInfo, maybe_initialize, shutdown
    kind = sys.argv[3]
    if kind == "joined_alone":
        dist.init_process_group("gloo", init_method=f"tcp://{addr}", world_size=1, rank=0)
        try:
            maybe_initialize(addr, 2, 0)
        except RuntimeError:
            print(f"OK {pid}")
        shutdown()
    elif kind == "other_count":
        info = maybe_initialize(addr, 2, pid, timeout_s=60)
        assert maybe_initialize(addr, None, pid) == info
        try:
            maybe_initialize(addr, 3, pid)
        except RuntimeError:
            print(f"OK {pid}")
        shutdown()
    else:  # "no_peer": the peer never comes
        try:
            info = maybe_initialize(addr, 2, 0, timeout_s=3)
            print("joined", info)
        except Exception as exc:
            print(type(exc).__name__, f"OK {pid}")
""")


@pytest.mark.parametrize("kind,n", [("joined_alone", 1), ("other_count", 2), ("no_peer", 1)])
def test_a_join_that_cannot_hold_raises(kind, n):
    _ok(*_spawn(JOIN_CODE, str(_free_port()), kind, n=n, timeout=60.0))


CKPT_CODE = PRELUDE + textwrap.dedent("""
    import numpy as np
    from agent_tpu_torch.config import DeviceConfig
    from agent_tpu_torch.models import checkpoint
    from agent_tpu_torch.runtime.runtime import TorchRuntime
    path = os.path.join(sys.argv[3], "ck")
    rt = TorchRuntime(device="cpu", mesh_shape={"tp": 2}, config=DeviceConfig(
        coordinator_address=addr, num_processes=2, process_id=pid))
    assert rt.mesh.local_positions() == [{"dp": 0, "tp": pid, "sp": 0}]
    tree = {"w": np.arange(16, dtype=np.float32).reshape(2, 8), "b": np.ones(3, np.float32)}
    written = []
    from agent_tpu_torch.models import safetensors_io
    save = safetensors_io.save_file
    safetensors_io.save_file = lambda t, p, **kw: (written.append(os.path.basename(p)),
                                                   save(t, p, **kw))
    checkpoint.save_sharded(tree, path, specs={"w": (None, "tp")}, mesh=rt.mesh)
    assert written == [f"shard-0000{pid}.safetensors"], written
    assert sorted(os.listdir(path)) == ["index.json", "shard-00000.safetensors",
                                        "shard-00001.safetensors"]
    like = {"w": np.zeros((2, 8), np.float32), "b": np.zeros(3, np.float32)}
    checkpoint.load_sharded(path, like)
    assert all((like[k] == tree[k]).all() for k in tree)
    from agent_tpu_torch.runtime.distributed import shutdown
    shutdown()
    print(f"OK {pid}")
""")


def test_each_process_writes_the_positions_it_holds(tmp_path):
    _ok(*_spawn(CKPT_CODE, str(_free_port()), str(tmp_path)))
