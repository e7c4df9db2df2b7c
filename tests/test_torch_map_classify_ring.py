"""map_classify_tpu on an sp mesh: the port's op on two CPU shards against
the JAX op on a two-device sp mesh (the reference's own multichip dry run,
__graft_entry__.py:76-96), in f32: top-k indices equal, probabilities
within 2e-5 (tests/test_ring.py's f32 tolerance), every layer's attention
taken by the ring."""

import numpy as np
import pytest
import torch

import jax

from agent_tpu.config import DeviceConfig
from agent_tpu.ops import get_op as jax_get_op
from agent_tpu.runtime import TpuRuntime
from agent_tpu.runtime.context import OpContext as JaxOpContext
from agent_tpu_torch.kernels import flash_attention as fa
from agent_tpu_torch.ops import load_ops
from agent_tpu_torch.runtime.context import OpContext
from agent_tpu_torch.runtime.runtime import TorchRuntime

torch.set_num_threads(1)

F32_TOL = 2e-5
# __graft_entry__.py:84-93: d_head 8, which the fold kernel does not take
# (the einsum fold); and the same width with d_head 32, which it does.
DRYRUN = {"vocab_size": 260, "d_model": 32, "n_heads": 4, "n_layers": 2, "d_ff": 64,
          "max_len": 64, "n_classes": 16, "dtype": "float32"}
CONFIGS = {"dryrun_d8": DRYRUN, "d32": dict(DRYRUN, n_heads=1)}


def _payload(cfg, texts=None):
    return {"texts": texts or ["ring attention dryrun %d" % i for i in range(8)], "topk": 3,
            "allow_fallback": False, "model_config": cfg}


@pytest.fixture(scope="module")
def jax_classify():
    rt = TpuRuntime(DeviceConfig(mesh_shape={"sp": 2}), devices=jax.devices()[:2])
    fn = jax_get_op("map_classify_tpu")
    return lambda payload: fn(dict(payload), JaxOpContext(runtime=rt))


@pytest.fixture(scope="module")
def classify():
    fn = load_ops(["map_classify_tpu"])["map_classify_tpu"]
    return lambda payload, rt: fn(dict(payload), OpContext(runtime=rt))


def _columns(result):
    rows = [r["topk"] for r in result["results"]]
    return ([[e["index"] for e in r] for r in rows], [[e["score"] for e in r] for r in rows])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_ring_op_matches_jax_sp_mesh(classify, jax_classify, name):
    cfg = CONFIGS[name]
    rt = TorchRuntime(devices=["cpu"] * 2, mesh_shape={"sp": 2})
    before = dict(fa.SELECTION_COUNTS)
    got, want = classify(_payload(cfg), rt), jax_classify(_payload(cfg))
    assert got["ok"] and want["ok"] and got["device"] == "cpu" and len(got["results"]) == 8
    assert fa.SELECTION_COUNTS["ring"] == before["ring"] + cfg["n_layers"]
    assert fa.SELECTION_COUNTS["ring_dense"] == before["ring_dense"]
    assert fa.SELECTION_COUNTS["flash"] == before["flash"]
    (gi, gs), (wi, ws) = _columns(got), _columns(want)
    assert gi == wi
    np.testing.assert_allclose(gs, ws, rtol=F32_TOL, atol=F32_TOL)
    # The one-device port agrees as well.
    one = classify(_payload(cfg), TorchRuntime(device="cpu"))
    assert _columns(one)[0] == gi
    np.testing.assert_allclose(_columns(one)[1], gs, rtol=F32_TOL, atol=F32_TOL)


def test_ring_op_folds_through_the_kernel_path(classify, monkeypatch):
    """d_head 32: every hop of every layer through flash_fold (its plain
    version on the CPU): n_layers x sp^2 folds a request."""
    calls = []
    real = fa.flash_fold
    monkeypatch.setattr(fa, "flash_fold", lambda *a: calls.append(1) or real(*a))
    rt = TorchRuntime(devices=["cpu"] * 4, mesh_shape={"sp": 4})
    out = classify(_payload(CONFIGS["d32"]), rt)
    assert out["ok"] and len(calls) == CONFIGS["d32"]["n_layers"] * 16


def test_staged_length_the_ring_cannot_split_goes_dense(classify):
    """A short row stages at the 16-token bucket, which sp = 3 does not
    divide: every layer takes dense attention (the reference's gate), and
    the result still matches the one-device run."""
    rt = TorchRuntime(devices=["cpu"] * 3, mesh_shape={"sp": 3})
    before = dict(fa.SELECTION_COUNTS)
    payload = _payload(CONFIGS["d32"], ["short row"])
    got = classify(payload, rt)
    assert fa.SELECTION_COUNTS["ring_dense"] == before["ring_dense"] + DRYRUN["n_layers"]
    assert fa.SELECTION_COUNTS["ring"] == before["ring"]
    one = classify(payload, TorchRuntime(device="cpu"))
    assert _columns(got)[0] == _columns(one)[0]
    np.testing.assert_allclose(_columns(got)[1], _columns(one)[1], rtol=F32_TOL, atol=F32_TOL)
