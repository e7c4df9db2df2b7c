"""Segmented journal with snapshot/compaction — controller crash survival
at O(live state) replay cost.

The append-only JSONL journal made controller death survivable,
but replay cost grew without bound: a month-old controller replays every
submit/result/requeue it ever journaled before serving its first lease.
This module bounds that:

- **Segments** — the journal rotates into bounded files
  ``<path>.seg-<NNNNNNNN>`` once ``segment_max_bytes`` (or
  ``segment_max_events``) is exceeded. The active segment is always the
  highest sequence number; a hot standby tails segments in order by
  ``(seq, byte offset)``.
- **Snapshots** — ``<path>.snapshot`` is a one-JSON-document image of live
  controller state (jobs, epochs, attempts, depended-on result bodies,
  usage ledger) taken at a segment boundary: the journal rotates first, the
  state is captured under the controller lock, and the snapshot covers
  every segment up to and including the just-closed one
  (``through_seq``). Replay = snapshot + segments with ``seq >
  through_seq`` — O(live state + tail), not O(history).
- **Atomicity** — snapshots write ``<path>.snapshot.tmp``, fsync, then
  ``os.replace`` (atomic on POSIX): at every instant ``<path>.snapshot``
  is either absent or a complete previous/new image. A snapshot that fails
  validation anyway (externally truncated, version skew) is *ignored* in
  favor of full-segment replay and counted (``snapshot_invalid``).
- **Garbage collection** — segments covered by the current snapshot are
  deleted after the rename lands; the disk footprint is bounded by one
  snapshot + the uncovered tail.
- **Durability knob** — ``JOURNAL_FSYNC=1`` fdatasyncs
  appends; ``JOURNAL_FSYNC_EVERY=N`` batches the sync to every N appends
  (group commit) plus rotation/close boundaries. Default off: the journal
  protects against process death (flushed OS buffers survive SIGKILL),
  not kernel crashes, and a 10M-row drain posts thousands of results.

**Legacy mode**: with every segmentation/snapshot knob at 0 (the default),
the journal is the exact historical single file at ``<path>`` —
byte-identical appends, identical replay semantics — so existing journals,
tests, and operators see no change until they opt in. A legacy file that
predates a switch to segmented mode is replayed first (before segment 1)
until a snapshot covers it.

Torn-line semantics across the segment chain (matching the single-file
contract): an unparseable FINAL line of the FINAL segment is the expected
crash artifact — tolerated, counted ``torn_tail``. An unparseable line
anywhere else in the logical stream (mid-segment, or the last line of a
non-final segment) is real corruption — skipped, counted ``skipped``.
Promotion (``controller/standby.py``) *seals* a dead primary's torn tail
by truncating the active segment to the last complete line before the new
incarnation appends, so the healed journal replays clean.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

from agent_tpu_torch.utils.logging import log

SNAPSHOT_VERSION = 1
SEGMENT_PREFIX = ".seg-"
SNAPSHOT_SUFFIX = ".snapshot"


def segment_path(base: str, seq: int) -> str:
    return f"{base}{SEGMENT_PREFIX}{seq:08d}"


def parse_segment_seq(base: str, path: str) -> Optional[int]:
    name = os.path.basename(path)
    prefix = os.path.basename(base) + SEGMENT_PREFIX
    if not name.startswith(prefix):
        return None
    try:
        return int(name[len(prefix):])
    except ValueError:
        return None


def list_segments(base: str) -> List[Tuple[int, str]]:
    """``[(seq, path)]`` sorted ascending — the replay/tail order."""
    parent = os.path.dirname(base) or "."
    if not os.path.isdir(parent):
        return []
    out: List[Tuple[int, str]] = []
    for name in os.listdir(parent):
        path = os.path.join(parent, name)
        seq = parse_segment_seq(base, path)
        if seq is not None and os.path.isfile(path):
            out.append((seq, path))
    return sorted(out)


def load_snapshot(base: str) -> Optional[Dict[str, Any]]:
    """The current snapshot document, or None when absent or invalid (a
    half-written/corrupt snapshot must never win over replayable
    segments). Validation: parses as JSON, carries the version and a
    ``through_seq``/``jobs`` payload."""
    path = base + SNAPSHOT_SUFFIX
    if not os.path.exists(path):
        return None
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict):
        return None
    if doc.get("version") != SNAPSHOT_VERSION:
        return None
    if not isinstance(doc.get("through_seq"), int):
        return None
    if not isinstance(doc.get("jobs"), list):
        return None
    return doc


class ReplayStats:
    """What one replay pass saw — the counters the controller mirrors."""

    def __init__(self) -> None:
        self.events = 0
        self.torn_tail = 0
        self.skipped = 0
        self.skipped_lines: List[str] = []   # "<file>:<lineno>" samples
        self.snapshot_used = False
        self.snapshot_invalid = 0
        self.segments_read = 0
        self.duration_sec = 0.0


def _iter_file_events(
    path: str, stats: ReplayStats, final_file: bool
) -> Iterator[Dict[str, Any]]:
    """Parse one journal file's lines. The torn-FINAL-line tolerance only
    applies when this file is the last of the logical stream."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            lines = f.read().splitlines()
    except OSError:
        return
    for i, raw in enumerate(lines):
        line = raw.strip()
        if not line:
            continue
        try:
            ev = json.loads(line)
        except ValueError:
            if final_file and i == len(lines) - 1:
                stats.torn_tail += 1
                log(
                    "journal replay tolerated a torn final line",
                    path=path, line=i + 1,
                )
            else:
                stats.skipped += 1
                if len(stats.skipped_lines) < 20:
                    stats.skipped_lines.append(f"{path}:{i + 1}")
            continue
        if isinstance(ev, dict):
            stats.events += 1
            yield ev


class SegmentedJournal:
    """Owns the journal files for one controller incarnation.

    Appends are serialized by the caller (the controller journals under
    its state lock, ordered with the mutations the events record);
    ``commit_snapshot`` runs outside that lock and is internally
    serialized. Thread-safe members only where the snapshot path needs
    them.
    """

    def __init__(
        self,
        path: str,
        segment_max_bytes: int = 0,
        segment_max_events: int = 0,
        snapshot_every_events: int = 0,
        fsync: bool = False,
        fsync_every: int = 1,
    ) -> None:
        self.path = path
        self.segment_max_bytes = max(0, int(segment_max_bytes))
        self.segment_max_events = max(0, int(segment_max_events))
        self.snapshot_every_events = max(0, int(snapshot_every_events))
        self.fsync = bool(fsync)
        self.fsync_every = max(1, int(fsync_every))
        # Segmented the moment any bound is set; a snapshot cadence alone
        # forces segmentation too (compaction GC works on whole segments).
        self.segmented = bool(
            self.segment_max_bytes
            or self.segment_max_events
            or self.snapshot_every_events
        )
        if self.segmented and not (
            self.segment_max_bytes or self.segment_max_events
        ):
            self.segment_max_bytes = 4 * 1024 * 1024
        self._file = None
        self._active_seq = 0
        self._active_bytes = 0
        self._active_events = 0
        self._events_since_snapshot = 0
        self._unsynced = 0
        self._snapshot_lock = threading.Lock()
        self.appended_events = 0
        self.fsyncs = 0
        self.snapshots_written = 0
        self.last_snapshot_wall: Optional[float] = None
        self.last_replay: Optional[ReplayStats] = None

    # ---- replay (before open_for_append) ----

    def replay(self) -> Tuple[Optional[Dict[str, Any]], Iterator[Dict[str, Any]], ReplayStats]:
        """``(snapshot_doc, event_iterator, stats)``. The iterator yields
        the logical event stream NOT covered by the snapshot, torn/skip
        rules applied; ``stats`` is also kept as ``last_replay`` (fields
        keep filling while the iterator is consumed)."""
        stats = ReplayStats()
        self.last_replay = stats
        snap = load_snapshot(self.path)
        if snap is None and os.path.exists(self.path + SNAPSHOT_SUFFIX):
            # Present but unreadable/invalid: fall back to full-segment
            # replay, loudly — a half image must never beat whole segments.
            stats.snapshot_invalid += 1
            log(
                "snapshot invalid — ignored in favor of full segment replay",
                path=self.path + SNAPSHOT_SUFFIX,
            )
        stats.snapshot_used = snap is not None
        through = snap["through_seq"] if snap else -1

        def events() -> Iterator[Dict[str, Any]]:
            files: List[str] = []
            # The legacy single file predates every segment; a snapshot
            # (always taken at seq >= 1) covers it.
            if through < 0 and os.path.exists(self.path) \
                    and os.path.getsize(self.path) > 0:
                files.append(self.path)
            for seq, seg in list_segments(self.path):
                if seq > through:
                    files.append(seg)
            stats.segments_read = len(files)
            for i, fp in enumerate(files):
                yield from _iter_file_events(
                    fp, stats, final_file=(i == len(files) - 1)
                )

        return snap, events(), stats

    # ---- append ----

    @staticmethod
    def _seal_torn_tail_at_open(path: str) -> int:
        """Truncate a half-written final line before the first append.

        Replay *tolerates* a dead incarnation's torn death write, but
        appending after it would glue the next event onto the fragment —
        turning a benign torn tail into mid-stream corruption (and losing
        that next event) on every later replay. Promotion already seals via
        ``StandbyTailer.seal()``; a plain restart over the same journal
        (the partition-kill recovery path) must seal too. Returns the
        bytes cut (0 = file was clean)."""
        try:
            size = os.path.getsize(path)
        except OSError:
            return 0
        if size == 0:
            return 0
        with open(path, "rb+") as f:
            f.seek(-1, os.SEEK_END)
            if f.read(1) == b"\n":
                return 0
            f.seek(0)
            data = f.read()
            keep = data.rfind(b"\n") + 1
            f.truncate(keep)
            f.flush()
            os.fsync(f.fileno())
        cut = size - keep
        log("sealed torn journal tail at restart", path=path, bytes=cut)
        return cut

    def open_for_append(self) -> None:
        if self._file is not None:
            return
        if not self.segmented:
            self._seal_torn_tail_at_open(self.path)
            self._file = open(self.path, "a", encoding="utf-8")
            return
        segments = list_segments(self.path)
        self._active_seq = segments[-1][0] if segments else 1
        active = segment_path(self.path, self._active_seq)
        self._seal_torn_tail_at_open(active)
        self._file = open(active, "a", encoding="utf-8")
        self._active_bytes = self._file.tell()
        self._active_events = 0  # event budget counts THIS incarnation's

    def append(self, event: Dict[str, Any]) -> None:
        """One journal event. Caller holds the controller lock — appends
        are ordered with the state changes they record."""
        if self._file is None:
            return
        data = json.dumps(event) + "\n"
        self._file.write(data)
        self._file.flush()
        self.appended_events += 1
        self._events_since_snapshot += 1
        if self.fsync:
            self._unsynced += 1
            if self._unsynced >= self.fsync_every:
                self._fdatasync()
        if self.segmented:
            self._active_bytes += len(data.encode("utf-8"))
            self._active_events += 1
            if self._over_budget():
                self._rotate_locked()

    def _over_budget(self) -> bool:
        return (
            (self.segment_max_bytes
             and self._active_bytes >= self.segment_max_bytes)
            or (self.segment_max_events
                and self._active_events >= self.segment_max_events)
        )

    def _fdatasync(self) -> None:
        try:
            fd = self._file.fileno()
            if hasattr(os, "fdatasync"):
                os.fdatasync(fd)
            else:  # pragma: no cover — platforms without fdatasync
                os.fsync(fd)
            self.fsyncs += 1
        except (OSError, ValueError):
            pass  # durability is best-effort; the drain must not die on it
        self._unsynced = 0

    def _rotate_locked(self) -> int:
        """Close the active segment, open the next. Returns the seq of the
        segment just closed. Caller holds the controller lock (append
        ordering)."""
        closed = self._active_seq
        if self.fsync and self._unsynced:
            self._fdatasync()
        self._file.close()
        self._active_seq += 1
        self._file = open(
            segment_path(self.path, self._active_seq), "a", encoding="utf-8"
        )
        self._active_bytes = 0
        self._active_events = 0
        return closed

    # ---- snapshot / compaction ----

    def snapshot_due(self) -> bool:
        return bool(
            self.snapshot_every_events
            and self._events_since_snapshot >= self.snapshot_every_events
        )

    def rotate_for_snapshot(self) -> int:
        """Seal the active segment so the snapshot about to be captured
        covers whole segments only. Caller holds the controller lock; the
        state captured right after this call is exactly the state at the
        returned segment boundary (events appended later land in the new
        segment, which replay applies on top of the snapshot)."""
        if not self.segmented or self._file is None:
            raise RuntimeError("snapshotting requires a segmented journal")
        through = self._rotate_locked()
        self._events_since_snapshot = 0
        return through

    def commit_snapshot(
        self, through_seq: int, state: Dict[str, Any]
    ) -> str:
        """Write the snapshot atomically (tmp, fsync, rename) and GC the
        segments it covers. Runs OUTSIDE the controller lock — pure file
        I/O over an already-captured state dict."""
        with self._snapshot_lock:
            doc = {
                "version": SNAPSHOT_VERSION,
                "through_seq": int(through_seq),
                "taken_wall": time.time(),
                **state,
            }
            path = self.path + SNAPSHOT_SUFFIX
            tmp = f"{path}.tmp.{os.getpid()}"
            data = json.dumps(doc)
            try:
                with open(tmp, "w", encoding="utf-8") as f:
                    f.write(data)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
            except OSError:
                # A failed snapshot must not take down the control plane:
                # the previous snapshot (or full segments) still replay.
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
            self.snapshots_written += 1
            self.last_snapshot_wall = doc["taken_wall"]
            self._gc_covered(through_seq)
            # The pre-segmentation legacy file is folded into the snapshot
            # too — compact it away like any covered segment.
            if os.path.exists(self.path):
                try:
                    os.unlink(self.path)
                except OSError:
                    pass
            return path

    def _gc_covered(self, through_seq: int) -> None:
        for seq, seg in list_segments(self.path):
            if seq <= through_seq:
                try:
                    os.unlink(seg)
                except OSError:
                    pass

    # ---- introspection ----

    def stats(self) -> Dict[str, Any]:
        """The ``/v1/status`` ``journal`` durability block's file-side
        half: segment count, total bytes, snapshot age."""
        segments = list_segments(self.path) if self.segmented else []
        total = sum(
            os.path.getsize(p) for _, p in segments if os.path.exists(p)
        )
        if not self.segmented and os.path.exists(self.path):
            total = os.path.getsize(self.path)
        snap_path = self.path + SNAPSHOT_SUFFIX
        snapshot_age: Optional[float] = None
        if self.last_snapshot_wall is not None:
            snapshot_age = max(0.0, time.time() - self.last_snapshot_wall)
        elif os.path.exists(snap_path):
            try:
                snapshot_age = max(
                    0.0, time.time() - os.path.getmtime(snap_path)
                )
            except OSError:
                pass
        return {
            "segmented": self.segmented,
            "segments": len(segments) if self.segmented else 1,
            "bytes": int(total),
            "snapshot_bytes": (
                os.path.getsize(snap_path)
                if os.path.exists(snap_path) else 0
            ),
            "snapshots_written": self.snapshots_written,
            "last_snapshot_age_sec": (
                round(snapshot_age, 3) if snapshot_age is not None else None
            ),
            "fsync": self.fsync,
            "appended_events": self.appended_events,
        }

    def close(self) -> None:
        if self._file is not None:
            if self.fsync and self._unsynced:
                self._fdatasync()
            self._file.close()
            self._file = None


class JournalTailer:
    """Read-only incremental cursor over another incarnation's segments —
    the hot standby's feed (file-tail first; an HTTP tail endpoint can
    ride the same cursor later).

    Yields complete newline-terminated events only; a partial final line
    (the primary mid-append, or its torn death write) is left for the next
    poll — or for ``seal()``, which truncates it away at promotion time.
    Legacy single-file journals tail too (segment seq 0).
    """

    def __init__(self, path: str) -> None:
        self.path = path
        self._seq: Optional[int] = None     # None = not positioned yet
        self._offset = 0
        self._buf = b""
        self.events_read = 0
        self.torn_sealed = 0
        # Set when the segment under the cursor was garbage-collected (a
        # snapshot covered it before we finished reading): the consumer
        # must resync from the snapshot — silently jumping ahead would
        # drop the unread events from its replica.
        self.need_resync = False

    def _current_files(self) -> List[Tuple[int, str]]:
        files = list_segments(self.path)
        if os.path.exists(self.path) and os.path.getsize(self.path) > 0:
            files.insert(0, (0, self.path))
        return files

    def _file_for_seq(self, seq: int) -> Optional[str]:
        if seq == 0:
            return self.path if os.path.exists(self.path) else None
        p = segment_path(self.path, seq)
        return p if os.path.exists(p) else None

    def poll(self, limit: Optional[int] = None) -> List[Dict[str, Any]]:
        """New complete events since the last poll, oldest first. Skips
        unparseable complete lines (counted by the consumer via its own
        apply path if it cares); advances across segment boundaries when
        the current segment is exhausted and a higher one exists."""
        out: List[Dict[str, Any]] = []
        while limit is None or len(out) < limit:
            files = self._current_files()
            if not files:
                break
            if self._seq is None:
                self._seq, _ = files[0]
                self._offset = 0
                self._buf = b""
            path = self._file_for_seq(self._seq)
            if path is None:
                # Our segment was GC'd under us (a compacting snapshot
                # landed and collected it, possibly before we finished
                # reading). STOP and flag: the consumer reloads the
                # snapshot (which folds in everything we may have missed)
                # and repositions us via resync_to().
                self.need_resync = True
                break
            chunk = self._read_chunk(path)
            if chunk is None:
                # The file vanished between the existence check and the
                # read (GC racing us): resync, don't skip.
                self.need_resync = True
                break
            if chunk:
                self._buf += chunk
                *complete, rest = self._buf.split(b"\n")
                self._buf = rest
                for raw in complete:
                    line = raw.strip()
                    if not line:
                        continue
                    try:
                        ev = json.loads(line)
                    except ValueError:
                        continue
                    if isinstance(ev, dict):
                        out.append(ev)
                        self.events_read += 1
                        if limit is not None and len(out) >= limit:
                            return out
                continue
            # Current file exhausted: move to the next segment only when
            # one exists (the primary rotated past us) AND no partial line
            # is pending (a rotation never splits a line).
            newer = [s for s, _ in files if s > self._seq]
            if newer and not self._buf:
                self._seq = newer[0]
                self._offset = 0
                continue
            break
        return out

    def resync_to(self, through_seq: int) -> None:
        """Reposition past everything a just-loaded snapshot covers: the
        next poll resumes at the oldest surviving segment newer than
        ``through_seq`` (or re-reads ``through_seq`` itself if GC left it
        behind — re-application on top of the snapshot fold is
        convergent)."""
        self._seq = max(0, int(through_seq))
        self._offset = 0
        self._buf = b""
        self.need_resync = False
        if self._file_for_seq(self._seq) is None:
            newer = [s for s, _ in self._current_files()
                     if s > self._seq]
            if newer:
                self._seq = newer[0]

    def _read_chunk(
        self, path: str, size: int = 1 << 20
    ) -> Optional[bytes]:
        """Next chunk from ``path`` at the cursor. ``b""`` = genuine EOF;
        ``None`` = the file is gone/unreadable (GC won a race — the
        caller must resync rather than treat it as exhausted)."""
        try:
            with open(path, "rb") as f:
                f.seek(self._offset)
                chunk = f.read(size)
        except OSError:
            return None
        self._offset += len(chunk)
        return chunk

    def lag_bytes(self) -> int:
        """Bytes appended beyond this cursor — the standby staleness
        signal."""
        files = self._current_files()
        if not files:
            return 0
        if self._seq is None:
            return sum(os.path.getsize(p) for _, p in files)
        lag = 0
        for seq, p in files:
            try:
                size = os.path.getsize(p)
            except OSError:
                continue
            if seq == self._seq:
                lag += max(0, size - self._offset)
            elif seq > self._seq:
                lag += size
        return lag + len(self._buf)

    def seal(self) -> Tuple[List[Dict[str, Any]], int]:
        """Promotion-time repair: truncate the current segment at the last
        complete line, discarding a dead primary's torn final write (it
        never acked that event to anyone — the poster redelivers).

        Returns ``(late_events, bytes_cut)``: any COMPLETE events that
        landed after the caller's last ``poll`` are returned for
        application, only the genuinely newline-less tail is cut. Only
        call once the primary is known dead; a live writer's buffered
        append would fight the truncation."""
        if self._seq is None:
            return [], 0
        path = self._file_for_seq(self._seq)
        if path is None:
            return [], 0
        # Pull in anything written since the last poll so complete lines
        # in it are applied, not truncated.
        chunk = self._read_chunk(path)
        if chunk:
            self._buf += chunk
        elif chunk is None:
            return [], 0
        late: List[Dict[str, Any]] = []
        if b"\n" in self._buf:
            complete, _, rest = self._buf.rpartition(b"\n")
            self._buf = rest
            for raw in complete.split(b"\n"):
                line = raw.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except ValueError:
                    continue
                if isinstance(ev, dict):
                    late.append(ev)
                    self.events_read += 1
        cut = len(self._buf)
        if cut <= 0:
            return late, 0
        keep = max(0, self._offset - cut)
        try:
            with open(path, "rb+") as f:
                f.truncate(keep)
        except OSError:
            return late, 0
        self._buf = b""
        self._offset = keep
        self.torn_sealed += 1
        log("sealed torn journal tail at promotion", path=path, bytes=cut)
        return late, cut
