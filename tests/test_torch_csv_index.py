"""The port's CSV row index (``agent_tpu_torch.data.csv_index``) against the
reference's: the same row offsets from the numpy scanner and, where g++
exists, from the native one, on quoting edge cases; the same rows from
``read_shard``, ``read_shard_column`` and ``read_shard_texts``; and the same
error types (ValueError for a malformed address, RuntimeError for an empty
shard or a missing column, OSError for an unreadable file)."""

import numpy as np
import pytest

from agent_tpu.data import csv_index as jax_csv
from agent_tpu.data.native import scan_row_offsets_native as jax_native
from agent_tpu_torch.data import csv_index
from agent_tpu_torch.data.native import native_available, scan_row_offsets_native

EDGE_CASES = [
    ("plain", 'a,b,c\n1,2,3\n4,5,6\n'),
    ("quoted_newline", 'a,b\n1,"x\ny"\n2,z\n'),
    ("doubled_quotes", 'a,b\n1,"he said ""hi"""\n2,"a""b"\n'),
    ("quote_spanning_chunks", 'a,b\n1,"' + "x" * 3000 + '\n' + "y" * 3000 + '"\n2,z\n'),
    ("crlf", 'a,b\r\n1,"x\r\ny"\r\n2,z\r\n'),
    ("no_trailing_newline", 'a,b\n1,2\n3,4'),
    ("empty_rows", 'a,b\n\n\n1,2\n'),
    ("only_header", 'a,b\n'),
    ("empty_file", ''),
]
IDS = [c[0] for c in EDGE_CASES]


@pytest.fixture
def edge_file(tmp_path, request):
    name, content = request.param
    p = tmp_path / f"{name}.csv"
    p.write_bytes(content.encode())
    return str(p)


@pytest.mark.parametrize("edge_file", EDGE_CASES, ids=IDS, indirect=True)
def test_numpy_scanner_matches_the_reference(edge_file):
    np.testing.assert_array_equal(csv_index._scan_row_offsets_py(edge_file),
                                  jax_csv._scan_row_offsets_py(edge_file))


@pytest.mark.parametrize("edge_file", EDGE_CASES, ids=IDS, indirect=True)
def test_native_scanner_matches_the_reference(edge_file):
    if not native_available():
        pytest.skip("no C++ compiler on this host")
    want = jax_csv._scan_row_offsets_py(edge_file)
    np.testing.assert_array_equal(scan_row_offsets_native(edge_file), want)
    np.testing.assert_array_equal(jax_native(edge_file), want)


@pytest.mark.parametrize("edge_file", EDGE_CASES, ids=IDS, indirect=True)
def test_read_shard_matches_the_reference(edge_file):
    for start, size in ((0, 1), (0, 100), (1, 1), (2, 5)):
        assert csv_index.read_shard(edge_file, start, size) == \
            jax_csv.read_shard(edge_file, start, size)
    assert csv_index.count_rows(edge_file) == jax_csv.count_rows(edge_file)


def test_native_build_stays_in_the_checkout():
    from agent_tpu_torch.data.native import build

    if not native_available():
        pytest.skip("no C++ compiler on this host")
    assert build._lib is not None
    assert build.BUILD_DIR.endswith("agent_tpu_torch/data/native/_build")


@pytest.fixture
def data_csv(tmp_path):
    p = tmp_path / "rows.csv"
    lines = ["id,text,risk"] + [f'{i},"row {i}, ""quoted"" ☕\nsecond line",{i * 0.5}'
                                for i in range(25)]
    p.write_text("\n".join(lines) + "\n", encoding="utf-8")
    return str(p)


@pytest.mark.parametrize("extra", [
    {}, {"start_row": 3, "shard_size": 7}, {"start_row": 20, "shard_size": 100},
    {"shard_size": 1}, {"text_field": "id"},
], ids=["default", "middle", "tail", "one", "text_field"])
def test_read_shard_texts_matches_the_reference(data_csv, extra):
    for uri in (data_csv, "file://" + data_csv):
        payload = dict(extra, source_uri=uri)
        assert csv_index.read_shard_texts(payload) == jax_csv.read_shard_texts(payload)
    payload = dict(extra, source_uri=data_csv, field="risk")
    assert csv_index.read_shard_column(payload, "field", "risk") == \
        jax_csv.read_shard_column(payload, "field", "risk")


@pytest.mark.parametrize("payload,exc", [
    ({"source_uri": ""}, ValueError),
    ({"source_uri": 5}, ValueError),
    ({}, ValueError),
    ({"source_uri": "X", "start_row": -1}, ValueError),
    ({"source_uri": "X", "start_row": True}, ValueError),
    ({"source_uri": "X", "shard_size": 0}, ValueError),
    ({"source_uri": "X", "shard_size": 2.5}, ValueError),
    ({"source_uri": "X", "text_field": ""}, ValueError),
    ({"source_uri": "X", "text_field": 3}, ValueError),
    ({"source_uri": "X", "start_row": 25}, RuntimeError),
    ({"source_uri": "X", "text_field": "missing"}, RuntimeError),
    ({"source_uri": "/nonexistent/rows.csv"}, OSError),
], ids=["empty_uri", "int_uri", "no_uri", "neg_start", "bool_start", "zero_size",
        "float_size", "empty_field", "int_field", "past_end", "no_column", "no_file"])
def test_read_shard_texts_raises_like_the_reference(data_csv, payload, exc):
    if payload.get("source_uri") == "X":
        payload = dict(payload, source_uri=data_csv)
    with pytest.raises(exc) as want:
        jax_csv.read_shard_texts(dict(payload))
    with pytest.raises(exc) as got:
        csv_index.read_shard_texts(dict(payload))
    assert type(got.value) is type(want.value) and str(got.value) == str(want.value)


def test_rewritten_file_reindexes(tmp_path):
    p = tmp_path / "grow.csv"
    p.write_text("text\na\nb\n")
    assert csv_index.read_shard_texts({"source_uri": str(p)}) == ["a", "b"]
    p.write_text("text\na\nb\nc\nd\n")
    assert csv_index.read_shard_texts({"source_uri": str(p)}) == ["a", "b", "c", "d"]


def test_sink_validates_and_merges_like_the_reference(tmp_path, capsys):
    """The output_uri sink: the model ops' shard files, inventoried,
    validated and merged by both packages' tools (and the port's CLI)."""
    import json

    from agent_tpu.data import sink as jax_sink
    from agent_tpu_torch.data import sink
    from agent_tpu_torch.ops._model_common import write_output_shard

    for start, n in ((0, 3), (3, 2), (5, 4)):
        write_output_shard(str(tmp_path), "map_classify_tpu", start,
                           ({"row": start + k} for k in range(n)))
    (tmp_path / "map_summarize_rows_000000000000.jsonl").write_text('{"row": 0}\n')
    want = jax_sink.validate_sink(str(tmp_path), "map_classify_tpu", total_rows=9)
    assert sink.validate_sink(str(tmp_path), "map_classify_tpu", total_rows=9) == want
    for mod, out in ((sink, "port.jsonl"), (jax_sink, "jax.jsonl")):
        mod.merge_sink(str(tmp_path), "map_classify_tpu", str(tmp_path / out), total_rows=9)
    merged = (tmp_path / "port.jsonl").read_text()
    assert merged == (tmp_path / "jax.jsonl").read_text()
    assert [json.loads(x)["row"] for x in merged.splitlines()] == list(range(9))
    with pytest.raises(ValueError, match="row total mismatch"):
        sink.validate_sink(str(tmp_path), "map_classify_tpu", total_rows=10)
    assert sink.main(["validate", str(tmp_path), "--op", "map_classify_tpu",
                      "--total-rows", "9"]) == 0
    assert json.loads(capsys.readouterr().out)["rows"] == 9
    (tmp_path / "map_classify_tpu_rows_000000000003.jsonl").unlink()
    assert sink.main(["validate", str(tmp_path), "--op", "map_classify_tpu"]) == 1
    assert "gap" in json.loads(capsys.readouterr().out)["error"]
