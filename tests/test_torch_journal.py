"""The port's segmented journal (``agent_tpu_torch.controller.journal``)
against the reference's (``agent_tpu.controller.journal``): the same seeded
event streams, rotations, snapshots, torn writes and corruptions, driven
through both packages in sibling directories, leave the same files byte for
byte (a snapshot's ``taken_wall`` aside), replay the same events with the
same counters, count the same fsyncs, and tail and seal alike. Every file
lives under pytest's ``tmp_path``."""

import json
import os
import random

import pytest

from agent_tpu import config as jax_config
from agent_tpu.controller import journal as jax_journal
from agent_tpu_torch import config as torch_config
from agent_tpu_torch.controller import journal as torch_journal

MODS = {"jax": jax_journal, "torch": torch_journal}


def _event(rng, i):
    ev = rng.choice(["submit", "lease", "result", "requeue"])
    out = {"ev": ev, "job_id": f"j{rng.randrange(40)}", "seq": i}
    if ev == "result":
        out["result"] = {"rows": rng.randrange(1000), "score": rng.random()}
    if ev == "submit":
        out["payload"] = {"text": "é" * rng.randrange(5), "n": [rng.randrange(9)]}
    return out


def _files(root):
    """Every file under ``root``: relative name -> bytes (the snapshot's
    wall time dropped)."""
    out = {}
    for name in sorted(os.listdir(root)):
        data = open(os.path.join(root, name), "rb").read()
        if name.endswith(".snapshot"):
            try:
                doc = json.loads(data)
            except ValueError:
                doc = None
            if isinstance(doc, dict):
                doc.pop("taken_wall", None)
                data = json.dumps(doc, sort_keys=True).encode()
        out[name] = data
    return out


def _replay(mod, path, **kw):
    j = mod.SegmentedJournal(path, **kw)
    snap, events, stats = j.replay()
    events = list(events)
    if snap:
        snap = {k: v for k, v in snap.items() if k != "taken_wall"}
    st = {k: v for k, v in vars(stats).items() if k != "duration_sec"}
    st["skipped_lines"] = [os.path.basename(s) for s in st["skipped_lines"]]
    return snap, events, st


def _scenario(mod, root, seed, kw):
    """Append, rotate and snapshot a seeded stream; tear and corrupt;
    reopen and append again. Returns what each step observed."""
    rng = random.Random(seed)
    path = os.path.join(root, "j.jsonl")
    seen = []
    j = mod.SegmentedJournal(path, **kw)
    j.open_for_append()
    for i in range(60):
        j.append(_event(rng, i))
        if j.snapshot_due():
            through = j.rotate_for_snapshot()
            j.commit_snapshot(through, {"jobs": [{"id": f"j{k}"} for k in range(i % 7)],
                                        "epochs": {"j1": i}})
            seen.append(("snapshot", through))
    # The snapshot's size and age follow its wall-clock stamp.
    seen.append(("stats", {k: v for k, v in j.stats().items()
                           if k not in ("last_snapshot_age_sec", "snapshot_bytes")},
                 j.fsyncs, j.appended_events))
    # A crash mid-write: half a line at the end of the active segment.
    j._file.write('{"ev": "submit", "job_id": "torn"')
    j._file.flush()
    j.close()
    seen.append(("files", _files(root)))
    seen.append(("replay", _replay(mod, path, **kw)))
    # Reopen seals the torn tail, then appends after it.
    j = mod.SegmentedJournal(path, **kw)
    list(j.replay()[1])
    j.open_for_append()
    j.append({"ev": "submit", "job_id": "after", "op": "echo"})
    j.close()
    seen.append(("files", _files(root)))
    segs = mod.list_segments(path)
    if len(segs) > 1:  # corrupt a middle line of the first segment left
        first = segs[0][1]
        lines = open(first, encoding="utf-8").read().splitlines(keepends=True)
        lines[len(lines) // 2] = "{not json\n"
        open(first, "w", encoding="utf-8").write("".join(lines))
    seen.append(("replay", _replay(mod, path, **kw)))
    seen.append(("segments", [(s, os.path.basename(p)) for s, p in mod.list_segments(path)]))
    snap = mod.load_snapshot(path)
    seen.append(("snapshot_doc", snap and {k: v for k, v in snap.items() if k != "taken_wall"}))
    return seen


CONFIGS = [
    {},
    {"segment_max_bytes": 400},
    {"segment_max_events": 7},
    {"segment_max_bytes": 400, "snapshot_every_events": 8},
    {"segment_max_events": 5, "snapshot_every_events": 11, "fsync": True, "fsync_every": 3},
    {"fsync": True},
]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kw", CONFIGS, ids=[",".join(f"{k}={v}" for k, v in c.items()) or
                                             "legacy" for c in CONFIGS])
def test_journal_files_and_replay_match_the_reference(tmp_path, kw, seed):
    got = {}
    for pkg, mod in MODS.items():
        root = tmp_path / pkg
        root.mkdir()
        got[pkg] = _scenario(mod, str(root), seed, kw)
    assert got["torch"] == got["jax"]


def test_a_legacy_file_replays_before_segments_and_a_bad_snapshot_is_ignored(tmp_path):
    got = {}
    for pkg, mod in MODS.items():
        root = tmp_path / pkg
        root.mkdir()
        path = str(root / "j.jsonl")
        legacy = mod.SegmentedJournal(path)
        legacy.open_for_append()
        for i in range(3):
            legacy.append({"ev": "submit", "job_id": f"old{i}"})
        legacy.close()
        seg = mod.SegmentedJournal(path, segment_max_events=2)
        seg.open_for_append()
        for i in range(5):
            seg.append({"ev": "submit", "job_id": f"new{i}"})
        seg.close()
        before = _replay(mod, path, segment_max_events=2)
        with open(path + ".snapshot", "w") as fh:
            fh.write('{"version": 1, "through_seq": "x"')
        got[pkg] = (before, _replay(mod, path, segment_max_events=2), _files(str(root)))
    assert got["torch"] == got["jax"]
    assert [e["job_id"] for e in got["torch"][0][1]][:3] == ["old0", "old1", "old2"]
    assert got["torch"][1][2]["snapshot_invalid"] == 1


def test_tailer_follows_rotation_and_seals_like_the_reference(tmp_path):
    got = {}
    for pkg, mod in MODS.items():
        path = str(tmp_path / f"{pkg}.jsonl")
        j = mod.SegmentedJournal(path, segment_max_events=3)
        j.open_for_append()
        tail = mod.JournalTailer(path)
        seen = []
        for i in range(7):
            j.append({"ev": "submit", "job_id": f"j{i}"})
            if i % 2:
                seen.append([e["job_id"] for e in tail.poll(limit=2)])
        j._file.write('{"ev": "submit", "job_id": "part')
        j._file.flush()
        seen.append(([e["job_id"] for e in tail.poll()], tail.lag_bytes()))
        late, cut = tail.seal()
        seen.append(([e["job_id"] for e in late], cut))
        j.close()
        seen.append(open(mod.list_segments(path)[-1][1], "rb").read())
        got[pkg] = seen
    assert got["torch"] == got["jax"]


def test_fsync_counts_match_the_reference(tmp_path):
    counts = {}
    for pkg, mod in MODS.items():
        out = []
        for name, kw in (("off", {}), ("per", {"fsync": True}),
                         ("grp", {"fsync": True, "fsync_every": 4})):
            j = mod.SegmentedJournal(str(tmp_path / f"{pkg}-{name}.jsonl"), **kw)
            j.open_for_append()
            for i in range(6):
                j.append({"ev": "submit", "job_id": f"j{i}"})
            out.append(j.fsyncs)
            j.close()
            out.append(j.fsyncs)
        counts[pkg] = out
    assert counts["torch"] == counts["jax"] == [0, 0, 6, 6, 1, 2]


def test_journal_config_from_env_matches_the_reference(monkeypatch):
    assert vars(torch_config.JournalConfig.from_env()) == \
        vars(jax_config.JournalConfig.from_env())
    for k, v in {"JOURNAL_FSYNC": "1", "JOURNAL_FSYNC_EVERY": "0",
                 "JOURNAL_SEGMENT_MAX_BYTES": "1048576", "JOURNAL_SEGMENT_MAX_EVENTS": "-1",
                 "SNAPSHOT_EVERY_EVENTS": "5000", "SNAPSHOT_RETAIN_TERMINAL": "9"}.items():
        monkeypatch.setenv(k, v)
    assert vars(torch_config.JournalConfig.from_env()) == \
        vars(jax_config.JournalConfig.from_env())
