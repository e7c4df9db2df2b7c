"""Structured stdout logging with per-key rate limiting — counterpart of
``agent_tpu.utils.logging``: one prefixed, flushed line per event, keyword
fields as compact JSON, and a per-key gate so a dead controller does not
flood stdout."""

from __future__ import annotations

import json
import time
from typing import Any, Dict

PREFIX = "[agent-tpu-torch]"


def log(msg: str, **fields: Any) -> None:
    """Print a prefixed, flushed log line; keyword fields render as compact JSON."""
    if fields:
        try:
            tail = " " + json.dumps(fields, sort_keys=True, default=str)
        except (TypeError, ValueError):
            tail = " " + repr(fields)
    else:
        tail = ""
    print(f"{PREFIX} {msg}{tail}", flush=True)


class RateLimiter:
    """Per-key 'at most once every N seconds' gate."""

    def __init__(self, every_sec: float = 10.0, clock=time.monotonic) -> None:
        self.every_sec = float(every_sec)
        self._clock = clock
        self._last: Dict[str, float] = {}

    def ready(self, key: str) -> bool:
        now = self._clock()
        last = self._last.get(key)
        if last is not None and (now - last) < self.every_sec:
            return False
        self._last[key] = now
        return True

    def log(self, key: str, msg: str, **fields: Any) -> bool:
        """Log if the key's window has elapsed; returns whether it logged."""
        if not self.ready(key):
            return False
        log(f"{key}: {msg}", **fields)
        return True
