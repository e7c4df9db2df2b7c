"""The fleet's operator CLI — counterpart of ``scripts/fleet.py``: N
device-pinned agent processes on this host, all leasing from one
controller.

    # one agent per card against a running controller
    python -m agent_tpu_torch.agent.fleet_cli --agents 4 --platform cuda \\
        --controller http://ctrl:8080 --tasks map_classify_tpu,map_summarize

    # the CPU shape: 2 agents, each asking for the CPU
    python -m agent_tpu_torch.agent.fleet_cli --agents 2 --controller http://127.0.0.1:8080

Each member owns a disjoint slice (``CHIP_SLICE``, and
``CUDA_VISIBLE_DEVICES`` on the card; ``agent/fleet.py``) and runs
``--warm-file`` before its first lease. The launcher waits for every
member's first poll of the controller, then until SIGINT/SIGTERM, which it
passes on for a graceful drain.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading
from typing import Any, Dict, List, Optional

from agent_tpu_torch.agent import fleet

DEFAULT_TASKS = "map_classify_tpu,map_summarize"


def http_agents(controller_url: str) -> Dict[str, Any]:
    """The controller's ``agents`` map from ``GET /v1/status`` ({} while
    it is not up)."""
    import urllib.request

    url = controller_url.rstrip("/") + "/v1/status"
    try:
        with urllib.request.urlopen(url, timeout=5) as resp:
            return json.load(resp).get("agents") or {}
    except Exception:  # noqa: BLE001 — not up yet
        return {}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--agents", type=int, default=2)
    ap.add_argument("--devices-per-agent", type=int, default=1)
    ap.add_argument("--controller", required=True, help="controller base URL (http://host:port)")
    ap.add_argument("--tasks", default=DEFAULT_TASKS)
    ap.add_argument("--platform", choices=fleet.PLATFORMS, default="cpu",
                    help="cpu = every member on the CPU (the tests' shape); "
                         "cuda = each member pinned to its cards")
    ap.add_argument("--mesh-shape", default="", help='each member\'s MESH_SHAPE, e.g. "dp=2"')
    ap.add_argument("--warm-file", default="",
                    help="JSON [{op, payload}] each member runs before its first lease")
    ap.add_argument("--log-dir", default="", help="one log file a member (default: stdout)")
    ap.add_argument("--name-prefix", default=fleet.DEFAULT_NAME_PREFIX)
    ap.add_argument("--ready-timeout", type=float, default=300.0)
    args = ap.parse_args(argv)
    if args.agents < 1:
        print("--agents must be >= 1", flush=True)
        return 2

    handle = fleet.spawn_fleet(
        args.agents, args.devices_per_agent, controller_url=args.controller, tasks=args.tasks,
        platform=args.platform, name_prefix=args.name_prefix, mesh_shape=args.mesh_shape,
        warm_file=args.warm_file, log_dir=args.log_dir or None)
    print(f"fleet up: {args.agents} agent(s) x {args.devices_per_agent} device(s) "
          f"({args.platform}), members={handle.names}", flush=True)
    if not fleet.wait_for_agents(lambda: http_agents(args.controller), handle.names,
                                 timeout=args.ready_timeout, fleet=handle):
        print("fleet NOT ready (timeout or member death) — stopping", flush=True)
        handle.stop()
        return 1
    print("fleet ready: every member polled the controller", flush=True)

    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    while not stop.is_set():
        stop.wait(1.0)
        failures = handle.poll_failures()
        if failures:
            print(f"fleet member(s) died: exit codes {failures}", flush=True)
            handle.stop()
            return 1
    print("stopping fleet (graceful drain)", flush=True)
    handle.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
