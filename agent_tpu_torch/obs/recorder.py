"""Flight recorder — counterpart of ``agent_tpu.obs.recorder``: a bounded
ring of the agent's recent structured events (leases, phase transitions,
errors, failovers), dumped as JSONL on ``SIGUSR1``, on an SLO page alert
and on a fatal error, so a wedged or failed drain is diagnosable after the
fact. O(capacity) memory, not O(tasks).

Events carry the task's ``job_id``/``lease_id``/``attempt``, so one job's
life greps across the agent's dump and the controller's. Dumps land in
``$FLIGHT_RECORDER_DIR`` (else the system temp dir) as
``agent_tpu_torch_flight_<tag>_<pid>.jsonl``. Stdlib only.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

DEFAULT_CAPACITY = 2048

# One sequence for every recorder of the process, so two rings of one
# process interleave by `seq` (dumps of two processes on `ts`/`mono`).
_global_seq = itertools.count(1)


class FlightRecorder:
    """Thread-safe bounded event ring. ``record`` is called on hot paths: it
    never raises and never grows beyond ``capacity``."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY, clock=time.time) -> None:
        self.capacity = max(1, int(capacity))
        self._clock = clock
        self._lock = threading.Lock()
        self._events: "collections.deque" = collections.deque(maxlen=self.capacity)
        self._dropped = 0  # events pushed out of the ring

    def record(self, kind: str, **fields: Any) -> None:
        event = {"ts": self._clock(), "mono": time.monotonic(), "seq": next(_global_seq),
                 "kind": kind}
        event.update(fields)
        with self._lock:
            if len(self._events) == self.capacity:
                self._dropped += 1
            self._events.append(event)

    def events(self, job_id: Optional[str] = None,
               req_id: Optional[str] = None) -> List[Dict[str, Any]]:
        """All buffered events, optionally only one job's or one serving
        request's (both filters AND together)."""
        with self._lock:
            out = list(self._events)
        if job_id is not None:
            out = [e for e in out if e.get("job_id") == job_id]
        if req_id is not None:
            out = [e for e in out if e.get("req_id") == req_id]
        return out

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def dump(self, path: str) -> int:
        """Write the ring as JSONL, oldest first, through a temp file and a
        rename; returns the events written. Values that are not JSON are
        written as their ``str``."""
        events = self.events()
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            for ev in events:
                f.write(json.dumps(ev, default=str) + "\n")
        os.replace(tmp, path)
        return len(events)


# The process-global default; tests and the agent inject their own instances.
_default_recorder = FlightRecorder()


def get_recorder() -> FlightRecorder:
    return _default_recorder


def default_dump_path(tag: str) -> str:
    """``$FLIGHT_RECORDER_DIR`` (or the temp dir) /
    ``agent_tpu_torch_flight_<tag>_<pid>.jsonl``: one file per tag and
    process, so a restart never overwrites the last one's dump."""
    base = os.environ.get("FLIGHT_RECORDER_DIR") or tempfile.gettempdir()
    safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in tag)
    return os.path.join(base, f"agent_tpu_torch_flight_{safe}_{os.getpid()}.jsonl")


def install_sigusr1_dump(recorder: FlightRecorder, path: str) -> Optional[str]:
    """Arm ``SIGUSR1`` -> dump ``recorder`` to ``path``. Returns the path, or
    None where that cannot be armed (not the main thread, no SIGUSR1)."""
    import signal

    if not hasattr(signal, "SIGUSR1"):
        return None

    def _dump(*_args: Any) -> None:
        try:
            n = recorder.dump(path)
            print(f"[agent-tpu-torch] flight recorder dumped {n} events to {path}", flush=True)
        except OSError:
            pass  # a failing dump must not kill the drain

    try:
        signal.signal(signal.SIGUSR1, _dump)
    except ValueError:  # not the main thread
        return None
    return path
