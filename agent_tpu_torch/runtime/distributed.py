"""Several processes, one lease loop — counterpart of
``agent_tpu.runtime.distributed``, over ``torch.distributed``.

Process 0, the leader, alone talks to the controller; every other process,
a follower, opens no HTTP connection. The leader broadcasts each leased
task (bounded JSON) to every process before it runs the op, every process
runs the same op, and the leader alone posts the result.

The group is ``gloo`` on host tensors, on one card, on several and on the
CPU alike: what goes between processes here is small and lives on the host
(tasks, and the partials of the dp reductions in ``parallel.collectives``).
NCCL would also refuse two ranks on one card ("Duplicate GPU detected"),
and a one-card host runs both on ``cuda:0``.

:func:`maybe_initialize` joins when ``COORDINATOR_ADDRESS`` /
``NUM_PROCESSES`` / ``PROCESS_ID`` are set; without them every function
here is a pass-through, so one process runs the same code.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Dict, Optional

MIN_BCAST_BYTES = 1 << 12   # the smallest broadcast bucket (4 KiB)
MAX_TASK_BYTES = 1 << 26    # a sanity ceiling (64 MiB), not a payload budget
# How long a collective (a follower waiting for the next task included) or
# the join waits for its peers before it raises. An idle leader sends a
# keep-alive well inside it (KEEPALIVE_SEC).
TIMEOUT_SEC = 600.0
KEEPALIVE_SEC = TIMEOUT_SEC / 4
_SHUTDOWN = {"__control__": "shutdown"}
_KEEPALIVE = {"__control__": "keepalive"}


@dataclass(frozen=True)
class DistInfo:
    process_index: int
    process_count: int

    @property
    def is_leader(self) -> bool:
        return self.process_index == 0


def _joined() -> Optional[DistInfo]:
    """The live group's info, or None when this process joined none."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return None
    return DistInfo(process_index=dist.get_rank(), process_count=dist.get_world_size())


def current() -> DistInfo:
    """This process's place: the live group's, else ``DistInfo(0, 1)``."""
    return _joined() or DistInfo(0, 1)


def maybe_initialize(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     timeout_s: float = TIMEOUT_SEC) -> DistInfo:
    """Join the gloo group at ``coordinator_address`` (``host:port``) when
    one is given; else return ``DistInfo(0, 1)`` and touch nothing.

    Idempotent, with the reference's rule: a second call after a join
    returns the live info. It tolerates only a group already joined with
    more than one process and the requested count; anything else raises,
    since swallowing it would leave this process alone while its peers wait
    in a collective."""
    if not coordinator_address:
        return DistInfo(process_index=0, process_count=1)
    live = _joined()
    if live is not None:
        if live.process_count > 1 and num_processes in (None, live.process_count):
            return live
        raise RuntimeError(
            f"maybe_initialize: a process group of {live.process_count} is already "
            f"joined, and {num_processes} processes were asked for at "
            f"{coordinator_address}")
    if num_processes is None or process_id is None:
        raise ValueError("maybe_initialize: COORDINATOR_ADDRESS needs NUM_PROCESSES and "
                         "PROCESS_ID (torch.distributed does not detect them)")
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id),
                            timeout=timedelta(seconds=timeout_s))
    return current()


def _bucket(n: int) -> int:
    """The power-of-two buffer size >= n, from 4 KiB: a bounded set of
    buffer shapes and no payload cap below the ceiling (the size travels in
    a broadcast of its own)."""
    size = MIN_BCAST_BYTES
    while size < n:
        size *= 2
    return size


def _broadcast_bytes(payload: bytes, source: int = 0) -> bytes:
    """``payload`` from process ``source`` to every process, in two
    phases: an 8-byte size, then the bytes in a buffer of its bucket
    (uint8 CPU tensors through ``dist.broadcast`` on the gloo group)."""
    info = current()
    if info.process_count == 1:
        return payload
    import torch
    import torch.distributed as dist

    is_source = info.process_index == source
    if is_source and len(payload) > MAX_TASK_BYTES:
        # Only the source knows the size; it raises before the first phase,
        # and its peers then time out in it.
        raise ValueError(f"broadcast payload {len(payload)}B exceeds {MAX_TASK_BYTES}B")
    size = torch.zeros(8, dtype=torch.uint8)
    if is_source:
        size[:] = torch.frombuffer(bytearray(len(payload).to_bytes(8, "little")),
                                   dtype=torch.uint8)
    dist.broadcast(size, src=source)
    n = int.from_bytes(bytes(size.tolist()), "little")
    buf = torch.zeros(_bucket(n), dtype=torch.uint8)
    if is_source and n:
        buf[:n] = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
    dist.broadcast(buf, src=source)
    return buf[:n].numpy().tobytes()


def broadcast_task(task: Optional[Dict[str, Any]], source: int = 0
                   ) -> Optional[Dict[str, Any]]:
    """The leader's task dict (or None, an idle tick) on every process;
    one process: a pass-through."""
    info = current()
    if info.process_count == 1:
        return task
    payload = b""
    if info.process_index == source and task is not None:
        payload = json.dumps(task).encode("utf-8")
    raw = _broadcast_bytes(payload, source=source)
    if not raw:
        return None
    return json.loads(raw.decode("utf-8"))


def broadcast_shutdown(source: int = 0) -> None:
    """The leader tells the followers to leave their loop."""
    broadcast_task(_SHUTDOWN, source=source)


def broadcast_keepalive(source: int = 0) -> None:
    """An idle leader's sign of life: followers wait for the next task
    again, inside the group's timeout."""
    broadcast_task(_KEEPALIVE, source=source)


def is_shutdown(task: Optional[Dict[str, Any]]) -> bool:
    return isinstance(task, dict) and task.get("__control__") == "shutdown"


def is_keepalive(task: Optional[Dict[str, Any]]) -> bool:
    return isinstance(task, dict) and task.get("__control__") == "keepalive"


def all_gather_object(obj: Any) -> list:
    """``obj`` of every process, in process order (one process: ``[obj]``)."""
    info = current()
    if info.process_count == 1:
        return [obj]
    import torch.distributed as dist

    out: list = [None] * info.process_count
    dist.all_gather_object(out, obj)
    return out


def all_gather_tensor(t) -> list:
    """A host tensor of every process (one shape and dtype on all), in
    process order, through one gloo all-gather (one process: ``[t]``)."""
    info = current()
    if info.process_count == 1:
        return [t]
    import torch
    import torch.distributed as dist

    out = [torch.empty_like(t) for _ in range(info.process_count)]
    dist.all_gather(out, t.contiguous())
    return out


def barrier() -> None:
    """Wait for every process (one process: return)."""
    if current().process_count > 1:
        import torch.distributed as dist

        dist.barrier()
