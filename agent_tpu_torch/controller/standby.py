"""Hot-standby controller failover — the port's counterpart of
``agent_tpu.controller.standby``, host code that imports no torch. It rides
the port's journal (``JournalTailer``, ``SegmentedJournal``,
``load_snapshot``), whose segments and cursor are the reference's, so it
tails a journal that either package's controller wrote.

A second ``Controller`` incarnation that tails the primary's journal
segments (file-tail — the two incarnations share the journal volume; an
HTTP tail endpoint can ride the same cursor later) and maintains a WARM
in-memory replica of job state: every submit/result/requeue the primary
journals is applied to the replica within one poll interval, so promotion
pays only the uncovered tail, not a cold replay.

Promotion sequence (``promote()``):

1. stop the tail thread;
2. final catch-up poll — every complete event the dead primary managed to
   flush is applied;
3. **seal** the torn tail: the primary's mid-append death leaves a
   newline-less final line; it is truncated away (counted). That event
   was never acked to anyone — the submitter/agent that posted it saw a
   transport error and will redeliver — so sealing loses nothing and the
   healed journal replays clean forever after;
4. finalize: non-terminal jobs requeue at their CURRENT epoch (the same
   epoch-fencing contract a plain restart has — results agents spooled
   against the old incarnation are applied once; anything the old
   incarnation already fenced or completed is cleanly rejected by the
   journaled fences / terminal-state guard);
5. the journal reopens for append on a FRESH segment, so a zombie
   primary's still-open file handle can never interleave writes with the
   new incarnation's (its stray appends would land in an orphaned,
   already-sealed position).

Agents reach the promoted incarnation via ``CONTROLLER_URLS`` — the
agent-side failover list: a transport error rotates the active URL, and
the existing spool/retry classifier redelivers completed results to the
standby instead of dropping them.

``python -m agent_tpu_torch.controller.standby`` runs a standalone standby:
it tails ``CONTROLLER_JOURNAL``, optionally watches the primary's
``/v1/status`` (``PRIMARY_URL``), and promotes — then serves HTTP — when
the primary misses ``PRIMARY_DOWN_AFTER`` consecutive health polls or on
SIGUSR1 (operator-forced failover). Unlike the reference's, it logs what
the promotion found (the bytes it had not yet applied, the events applied,
the torn bytes sealed) on a ``standby promotion`` line.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

from agent_tpu_torch.config import JournalConfig
from agent_tpu_torch.controller.core import Controller
from agent_tpu_torch.controller.journal import (
    JournalTailer,
    SegmentedJournal,
    load_snapshot,
)
from agent_tpu_torch.utils.logging import log


class HotStandby:
    """Warm replica of a primary controller, fed by journal tailing.

    ``controller_kwargs`` are forwarded to the replica ``Controller``
    (journal_path/sweep_interval excluded — the replica neither appends
    nor sweeps until promoted). The replica object IS the controller that
    serves after ``promote()``; point a ``ControllerServer`` at
    ``standby.controller`` once promotion returns.
    """

    def __init__(
        self,
        journal_path: str,
        journal: Optional[JournalConfig] = None,
        poll_interval_sec: float = 0.05,
        sweep_interval_sec: Optional[float] = None,
        **controller_kwargs: Any,
    ) -> None:
        self.journal_path = journal_path
        self.journal_config = journal if journal is not None \
            else JournalConfig()
        self.poll_interval_sec = max(0.005, float(poll_interval_sec))
        self.sweep_interval_sec = sweep_interval_sec
        # The replica must never append to the primary's tsdb segment
        # streams while the primary lives — the store opens at promotion
        # (finalize_promotion), sealing whatever torn tail the dead
        # primary left.
        controller_kwargs.setdefault("tsdb_defer_open", True)
        self.controller = Controller(
            journal_path=None, journal=self.journal_config,
            **controller_kwargs,
        )
        self._tailer = JournalTailer(journal_path)
        self._bootstrapped = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self.promoted = False
        self.events_applied = 0
        self.torn_sealed_bytes = 0
        # Snapshot resyncs: how often compaction outran the tail and the
        # replica reloaded from the snapshot instead (lossless either way).
        self.resyncs = 0

    # ---- replica feed ----

    def _bootstrap(self) -> None:
        """Initial catch-up: snapshot (if one exists) + everything the
        tailer can read right now. Runs once, before the tail loop."""
        snap = load_snapshot(self.journal_path)
        if snap is not None:
            self.controller.apply_snapshot_doc(snap)
            # Position the cursor past the covered segments: the tailer
            # skips files the snapshot already folded in.
            through = snap.get("through_seq", -1)
            self._tailer._seq = max(0, int(through))  # noqa: SLF001
            self._tailer._offset = 0                  # noqa: SLF001
            # through_seq itself was GC'd (or is about to be); poll() jumps
            # to the oldest surviving newer segment on its own.
        self._bootstrapped = True

    def catch_up(self, limit: Optional[int] = None) -> int:
        """Apply newly-journaled events to the replica. Returns how many
        were applied. Safe to call concurrently with the tail thread.

        When the primary's compaction GC'd a segment before this tail
        finished reading it, the tailer flags a RESYNC: the replica
        reloads the (newer) snapshot — which folds in everything the
        collected segments held — and resumes past it. Bounded retries:
        snapshots advance monotonically, so a second GC mid-resync can
        only move the cursor forward."""
        with self._lock:
            return self._catch_up_locked(limit)

    def _catch_up_locked(self, limit: Optional[int] = None) -> int:
        if not self._bootstrapped:
            self._bootstrap()
        n = 0
        for _ in range(8):
            for ev in self._tailer.poll(limit=limit):
                n += self.controller.apply_journal_event(ev)
            if not self._tailer.need_resync:
                break
            snap = load_snapshot(self.journal_path)
            if snap is not None:
                # mirror=False: this replica's usage mirrors already
                # counted the events it applied live.
                self.controller.apply_snapshot_doc(snap, mirror=False)
                self._tailer.resync_to(snap.get("through_seq", 0))
            else:
                # GC without a snapshot cannot happen on a healthy
                # volume; resume at the oldest surviving segment.
                self._tailer.resync_to(0)
            self.resyncs += 1
        self.events_applied += n
        return n

    def _tail_loop(self) -> None:
        while not self._stop.wait(self.poll_interval_sec):
            try:
                self.catch_up()
            except Exception as exc:  # noqa: BLE001 — a tail hiccup must
                # not kill the standby; the next poll retries from the
                # same cursor.
                log(
                    "standby tail error (will retry)",
                    error=f"{type(exc).__name__}: {exc}"[:200],
                )

    def start(self) -> "HotStandby":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._tail_loop, name="standby-tail", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # ---- introspection ----

    def lag_bytes(self) -> int:
        with self._lock:
            return self._tailer.lag_bytes()

    def replica_counts(self) -> Dict[str, int]:
        return self.controller.counts()

    # ---- promotion ----

    def promote(self) -> Controller:
        """Take over as the live controller. The primary MUST be dead (or
        fenced off the journal volume) before this is called — see module
        docstring for the sequence and the zero-loss argument."""
        self.stop()
        with self._lock:
            if self.promoted:
                return self.controller
            # Final catch-up (resync-aware), then seal the torn tail.
            # seal() returns any complete events that landed between the
            # last poll and now.
            self._catch_up_locked()
            late, cut = self._tailer.seal()
            for ev in late:
                self.events_applied += (
                    self.controller.apply_journal_event(ev)
                )
            self.torn_sealed_bytes = cut
            if cut:
                # Operator-visible like any replay-time torn tail.
                self.controller.journal_torn_tail += 1
                self.controller._m_journal_torn.inc()  # noqa: SLF001
            impl = SegmentedJournal(
                self.journal_path,
                segment_max_bytes=self.journal_config.segment_max_bytes,
                segment_max_events=self.journal_config.segment_max_events,
                snapshot_every_events=(
                    self.journal_config.snapshot_every_events
                ),
                fsync=self.journal_config.fsync,
                fsync_every=self.journal_config.fsync_every,
            )
            impl.open_for_append()
            if impl.segmented:
                # Fresh-segment fencing: never append to a file the dead
                # primary may still hold open.
                impl._rotate_locked()  # noqa: SLF001
            self.controller.finalize_promotion(
                impl, sweep_interval_sec=self.sweep_interval_sec
            )
            self.promoted = True
        return self.controller


def main() -> int:
    """Standalone hot standby. Env: CONTROLLER_JOURNAL (required — the
    primary's journal path on a shared volume), CONTROLLER_HOST/PORT (where
    to serve AFTER promotion), PRIMARY_URL (optional — poll its /v1/status;
    PRIMARY_DOWN_AFTER consecutive failures trigger promotion),
    STANDBY_POLL_SEC (tail cadence), plus the same SCHED_*/SLO_*/JOURNAL_*
    knobs the primary runs with (the replica must judge state the same
    way). SIGUSR1 forces promotion."""
    import signal
    import urllib.request

    from agent_tpu_torch.config import (
        ObsConfig,
        SchedConfig,
        SloConfig,
        env_float,
        env_int,
        env_str,
    )
    from agent_tpu_torch.controller.server import ControllerServer

    journal = env_str("CONTROLLER_JOURNAL", "")
    if not journal:
        print("[agent-tpu-standby] CONTROLLER_JOURNAL is required", flush=True)
        return 2
    primary_url = env_str("PRIMARY_URL", "").rstrip("/")
    down_after = max(1, env_int("PRIMARY_DOWN_AFTER", 3))
    poll = env_float("STANDBY_POLL_SEC", 0.25)
    standby = HotStandby(
        journal,
        journal=JournalConfig.from_env(),
        poll_interval_sec=poll,
        sweep_interval_sec=env_float("CONTROLLER_SWEEP_SEC", 5.0) or None,
        lease_ttl_sec=env_float("LEASE_TTL_SEC", 30.0),
        max_attempts=max(1, env_int("MAX_ATTEMPTS", 2)),
        requeue_delay_sec=env_float("REQUEUE_DELAY_SEC", 1.0),
        sched=SchedConfig.from_env(),
        slo=SloConfig.from_env(),
        obs=ObsConfig.from_env(),
    ).start()

    promote_now = threading.Event()
    signal.signal(signal.SIGUSR1, lambda *_: promote_now.set())
    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    print(
        f"[agent-tpu-standby] tailing {journal}"
        + (f", watching {primary_url}" if primary_url else "")
        + " (SIGUSR1 promotes)",
        flush=True,
    )
    misses = 0
    while not stop.is_set() and not promote_now.is_set():
        if primary_url:
            try:
                with urllib.request.urlopen(
                    primary_url + "/v1/status", timeout=2
                ) as resp:
                    resp.read()
                misses = 0
            except Exception:  # noqa: BLE001 — any failure counts a miss
                misses += 1
                if misses >= down_after:
                    print(
                        f"[agent-tpu-standby] primary missed {misses} "
                        "health polls — promoting",
                        flush=True,
                    )
                    promote_now.set()
        stop.wait(1.0)
    if stop.is_set():
        standby.stop()
        standby.controller.close()
        print("[agent-tpu-standby] stopped (never promoted)", flush=True)
        return 0
    lag = standby.lag_bytes()
    controller = standby.promote()
    server = ControllerServer(
        controller,
        host=env_str("CONTROLLER_HOST", "0.0.0.0"),
        port=env_int("CONTROLLER_PORT", 8080),
    )
    server.start()
    print(f"[agent-tpu-standby] promoted — serving on {server.url}", flush=True)
    log("standby promotion", lag_bytes=lag, events_applied=standby.events_applied,
        torn_sealed_bytes=standby.torn_sealed_bytes, resyncs=standby.resyncs)
    stop.wait()
    server.stop()
    controller.close()
    print("[agent-tpu-standby] stopped", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
