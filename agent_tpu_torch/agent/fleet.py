"""Device-pinned agent fleets — counterpart of ``agent_tpu.agent.fleet``.

One host, N agent processes, each owning a disjoint slice of the host's
cards, all leasing from one controller: the multi-process complement of
mesh mode (one agent, ``MESH_SHAPE="dp=N"``). The controller's scheduler
reads ``device_kind``/``mesh_devices``/``queue_depth`` from the lease
capabilities, so shards spread across the fleet with no new protocol.

Pinning, two fences in one grammar:

- ``CUDA_VISIBLE_DEVICES="2,3"`` (``platform="cuda"``): the process sees
  only its cards, so member *i* cannot touch a neighbour's even by bug; the
  in-process ``CHIP_SLICE`` is then ``0:count`` over that view.
- ``CHIP_SLICE="start:count"`` alone (``platform="cpu"``, the tests'
  shape): each member asks for the CPU (``TPU_DISABLED=1``) and keeps the
  slice it would own. The reference's ``force_host_devices`` rewrites
  ``XLA_FLAGS`` to give every CPU process K virtual devices; that flag
  means nothing to PyTorch, so the port has no counterpart.

``python -m agent_tpu_torch.agent.fleet`` is the child entry point: it
runs each ``{op, payload}`` of ``AGENT_WARM_FILE`` once (the build of
weights and kernels is a once-a-process cost that must not land in a timed
window; a failure exits 3), then the agent loop (``agent.app``).
``python -m agent_tpu_torch.agent.fleet_cli`` is the operator CLI over
:func:`spawn_fleet`.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

from agent_tpu_torch.utils.logging import log

# The port's root, for the children's PYTHONPATH: they run
# `-m agent_tpu_torch...` from the same tree as the parent, installed or not.
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DEFAULT_NAME_PREFIX = "fleet"
PLATFORMS = ("cpu", "cuda")


def fleet_slice(index: int, devices_per_agent: int) -> str:
    """Member ``index``'s ``CHIP_SLICE``: disjoint, contiguous, in launch
    order."""
    return f"{index * devices_per_agent}:{devices_per_agent}"


def agent_env(index: int, n_agents: int, devices_per_agent: int = 1, *, controller_url: str,
              tasks: str, platform: str = "cpu", base_env: Optional[Dict[str, str]] = None,
              name_prefix: str = DEFAULT_NAME_PREFIX, mesh_shape: str = "",
              warm_file: str = "", extra_env: Optional[Dict[str, str]] = None
              ) -> Dict[str, str]:
    """The environment of fleet member ``index`` of ``n_agents``:
    ``platform="cuda"`` pins its cards at the process level
    (``CUDA_VISIBLE_DEVICES``, ``CHIP_SLICE=0:count``); ``platform="cpu"``
    asks for the CPU and keeps ``CHIP_SLICE = fleet_slice(...)``.
    ``mesh_shape`` (``"dp=2"``) rides through as ``MESH_SHAPE``."""
    if index < 0 or index >= n_agents:
        raise ValueError(f"index {index} outside fleet of {n_agents}")
    if devices_per_agent < 1:
        raise ValueError("devices_per_agent must be >= 1")
    if platform not in PLATFORMS:
        raise ValueError(f"platform {platform!r} is not one of {PLATFORMS}")
    env = dict(base_env if base_env is not None else os.environ)
    env["CONTROLLER_URL"] = controller_url
    env["AGENT_NAME"] = f"{name_prefix}-{index}"
    env["TASKS"] = tasks
    env["PYTHONPATH"] = (_PKG_ROOT + os.pathsep + env["PYTHONPATH"]
                         if env.get("PYTHONPATH") else _PKG_ROOT)
    if platform == "cuda":
        cards = range(index * devices_per_agent, (index + 1) * devices_per_agent)
        env["CUDA_VISIBLE_DEVICES"] = ",".join(str(c) for c in cards)
        env["CHIP_SLICE"] = f"0:{devices_per_agent}"
        env.pop("TPU_DISABLED", None)
    else:
        env["TPU_DISABLED"] = "1"
        env["CHIP_SLICE"] = fleet_slice(index, devices_per_agent)
    if mesh_shape:
        env["MESH_SHAPE"] = mesh_shape
    if warm_file:
        env["AGENT_WARM_FILE"] = warm_file
    if extra_env:
        env.update(extra_env)
    return env


class Fleet:
    """The spawned members and their names (the controller's keys for
    readiness and shard accounting)."""

    def __init__(self, procs: List[subprocess.Popen], names: List[str]) -> None:
        self.procs = procs
        self.names = names

    def alive(self) -> int:
        return sum(1 for p in self.procs if p.poll() is None)

    def poll_failures(self) -> List[int]:
        """Return codes of members that already exited nonzero: a member
        dead mid-drain makes every scaling number fiction."""
        return [p.returncode for p in self.procs
                if p.poll() is not None and p.returncode not in (0, None)]

    def stop(self, timeout: float = 30.0) -> None:
        """Graceful drain (SIGTERM: the agent finishes its in-flight task),
        escalating to SIGKILL past ``timeout``."""
        for p in self.procs:
            if p.poll() is None:
                try:
                    p.terminate()
                except OSError:
                    pass
        deadline = time.monotonic() + timeout
        for p in self.procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=10)


def spawn_fleet(n_agents: int, devices_per_agent: int = 1, *, controller_url: str, tasks: str,
                platform: str = "cpu", name_prefix: str = DEFAULT_NAME_PREFIX,
                mesh_shape: str = "", warm_file: str = "",
                extra_env: Optional[Dict[str, str]] = None,
                log_dir: Optional[str] = None) -> Fleet:
    """Spawn ``n_agents`` pinned members leasing from ``controller_url``;
    each one's output goes to ``<log_dir>/<name>.log`` when given, else to
    the parent's."""
    procs: List[subprocess.Popen] = []
    names: List[str] = []
    for i in range(n_agents):
        env = agent_env(i, n_agents, devices_per_agent, controller_url=controller_url,
                        tasks=tasks, platform=platform, name_prefix=name_prefix,
                        mesh_shape=mesh_shape, warm_file=warm_file, extra_env=extra_env)
        names.append(env["AGENT_NAME"])
        out: Any = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            out = open(os.path.join(log_dir, f"{env['AGENT_NAME']}.log"), "ab")
        procs.append(subprocess.Popen([sys.executable, "-m", "agent_tpu_torch.agent.fleet"],
                                      env=env, stdout=out,
                                      stderr=subprocess.STDOUT if out else None,
                                      close_fds=True))
        if out is not None:
            out.close()  # the child holds its own descriptor
    return Fleet(procs, names)


def wait_for_agents(agents_fn: Callable[[], Dict[str, Any]], names: Iterable[str],
                    timeout: float = 180.0, fleet: Optional[Fleet] = None) -> bool:
    """Block until every name in ``names`` has polled the controller
    (``agents_fn`` gives the controller's ``agents`` map, in process or
    from ``GET /v1/status``): work submitted before a member's first poll
    would drain on a partial fleet. False on timeout, or as soon as a
    member has died."""
    want = set(names)
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            seen = set(agents_fn() or {})
        except Exception:  # noqa: BLE001 — the controller may still be starting
            seen = set()
        if want <= seen:
            return True
        if fleet is not None and fleet.poll_failures():
            return False
        time.sleep(0.1)
    return False


# ---- the child entry point (`python -m agent_tpu_torch.agent.fleet`) ----

def warm_from_file(path: str) -> int:
    """Run each ``{op, payload}`` of the warm file once on the member's
    runtime (weights and kernels built before the first lease); the results
    never reach the controller. A warm op that does not succeed raises."""
    from agent_tpu_torch.config import Config
    from agent_tpu_torch.ops import get_op
    from agent_tpu_torch.runtime.context import OpContext
    from agent_tpu_torch.runtime.runtime import get_runtime

    with open(path, "r", encoding="utf-8") as f:
        specs = json.load(f)
    if not isinstance(specs, list):
        raise ValueError("warm file must be a JSON list of {op, payload}")
    config = Config.from_env()
    runtime = get_runtime(config.device)
    n = 0
    for spec in specs:
        op = get_op(str(spec["op"]))
        t0 = time.perf_counter()
        out = op(dict(spec.get("payload") or {}), OpContext(runtime=runtime, config=config))
        if not (isinstance(out, dict) and out.get("ok") is True):
            raise RuntimeError(f"warm op {spec['op']!r} did not succeed: {str(out)[:200]}")
        log("fleet member warmed", op=spec["op"], ms=round((time.perf_counter() - t0) * 1e3, 1))
        n += 1
    return n


def child_main() -> int:
    """A fleet member: warm (when ``AGENT_WARM_FILE`` is set), then the
    agent loop; a failed warm-up exits 3. A SIGTERM that arrives while the
    member warms (an autoscaler retiring a member it just spawned) lets the
    warm-up finish and exits 0 without leasing, the drain path of a member
    that holds no lease; the reference's member dies of the signal there."""
    warm_file = os.environ.get("AGENT_WARM_FILE", "")
    if warm_file:
        retired: List[int] = []
        signal.signal(signal.SIGTERM, lambda signum, _frame: retired.append(signum))
        try:
            warm_from_file(warm_file)
        except Exception as exc:  # noqa: BLE001 — fatal by contract
            print(f"[agent-tpu-torch] fleet warmup failed: {type(exc).__name__}: {exc}",
                  flush=True)
            return 3
        if retired:
            log("fleet member retired while warming")
            return 0
        signal.signal(signal.SIGTERM, signal.SIG_DFL)  # until the agent installs its drain
    from agent_tpu_torch.agent.app import main as agent_main

    return agent_main()


if __name__ == "__main__":
    signal.signal(signal.SIGPIPE, signal.SIG_DFL)  # piped logs
    sys.exit(child_main())
