"""The GPipe encoder pipeline over ``pp`` (``parallel.pipeline``) against the
sequential forward and against the reference's pipeline on the same mesh.

The reference's four (mesh, n_micro) cases (tests/test_pp.py) must give the
dense forward's logits in f32; its rejections (a depth or a batch that does
not divide) hold; and ``map_classify_tpu`` routes through the pipeline both
ways the reference does — a ``pp`` axis on the runtime's mesh, and
``model_config {"pp": N}`` over a dp × pp mesh of the runtime's devices —
with the reference's soft guards (tests/test_pp_moe_serving.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agent_tpu.config import DeviceConfig as JaxDeviceConfig
from agent_tpu.models import encoder as jax_encoder
from agent_tpu.ops import get_op as jax_get_op
from agent_tpu.parallel.pipeline import encoder_forward_pp as jax_forward_pp
from agent_tpu.runtime.context import OpContext as JaxOpContext
from agent_tpu.runtime.mesh import build_mesh as jax_build_mesh
from agent_tpu.runtime.runtime import TpuRuntime
from agent_tpu_torch.kernels import flash_attention as fa
from agent_tpu_torch.models import encoder
from agent_tpu_torch.ops import load_ops
from agent_tpu_torch.parallel import pipeline
from agent_tpu_torch.runtime.context import OpContext
from agent_tpu_torch.runtime.mesh import build_mesh
from agent_tpu_torch.runtime.runtime import TorchRuntime

torch.set_num_threads(1)

CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=4, d_ff=64, max_len=16,
           n_classes=8, dtype="float32")


def _batch(b, seed=0, length=16):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, CFG["vocab_size"], (b, length)).astype(np.int32)
    mask = np.ones((b, length), dtype=np.int32)
    mask[0, length // 2:] = 0  # a ragged tail survives the pipeline untouched
    return ids, mask


@pytest.mark.parametrize("shape,n_micro", [({"pp": 4}, None), ({"pp": 2}, 4),
                                           ({"dp": 2, "pp": 4}, None), ({"dp": 4, "pp": 2}, 2)],
                         ids=["pp4", "pp2-micro4", "dp2-pp4", "dp4-pp2-micro2"])
def test_pp_matches_dense_forward_and_the_reference(shape, n_micro):
    """On 8 shards (dp absorbs the rest), as the reference's test."""
    cfg = encoder.EncoderConfig(**CFG)
    flat = encoder.init_params(cfg, "pp-test")
    mesh = build_mesh(["cpu"] * 8, shape)
    dp = mesh.shape["dp"]
    ids, mask = _batch(2 * (n_micro or shape["pp"]) * dp)
    model = encoder.from_jax_params(flat, cfg, mesh=mesh)
    assert isinstance(model, pipeline.PipelinedEncoder)
    model.n_micro = n_micro
    got = model(torch.from_numpy(ids), torch.from_numpy(mask))
    want = encoder.from_jax_params(flat, cfg)(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    jcfg = jax_encoder.EncoderConfig(**CFG)
    ref = jax_forward_pp(jax_encoder.init_params(jcfg, "pp-test"), jnp.asarray(ids),
                         jnp.asarray(mask), jcfg, jax_build_mesh(jax.devices(), shape),
                         n_micro=n_micro)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_each_stage_holds_only_its_layers():
    """Stage s holds layers [s·n/pp, (s+1)·n/pp) (plus the embedding on stage
    0, the head on the last): the rest of its frame stays on ``meta``."""
    cfg = encoder.EncoderConfig(**CFG)
    model = encoder.from_jax_params(encoder.init_params(cfg, "pp-test"), cfg,
                                    mesh=build_mesh(["cpu"] * 4, {"pp": 4}))
    for s in range(4):
        stage = model.stage(0, s)
        held = [i for i, b in enumerate(stage.blocks) if not b.attn.wq.is_meta]
        assert held == [s]
        assert stage.embed.is_meta == (s != 0) and stage.head.w.is_meta == (s != 3)
    back = model.to_flat_numpy()
    flat = encoder.init_params(cfg, "pp-test")
    assert back.keys() == flat.keys()
    assert all(np.array_equal(back[k], flat[k]) for k in flat)


def test_pp_rejects_indivisible_layers():
    with pytest.raises(ValueError, match="not divisible"):
        pipeline.stage_blocks(list(range(4)), 3)


def test_pp_rejects_indivisible_batch():
    cfg = encoder.EncoderConfig(**CFG)
    model = encoder.from_jax_params(encoder.init_params(cfg, "pp-test"), cfg,
                                    mesh=build_mesh(["cpu"] * 4, {"pp": 4}))
    ids, mask = _batch(6)
    with pytest.raises(ValueError, match="not divisible"):
        model(torch.from_numpy(ids), torch.from_numpy(mask))
    x = torch.zeros(6, 16, CFG["d_model"])
    with pytest.raises(ValueError, match="not divisible"):
        pipeline.pipeline_blocks([[]] * 4, [torch.device("cpu")] * 4, x,
                                 torch.ones(6, 16, dtype=torch.int32), fa.flash_attention)


def test_the_schedule_is_gpipe(monkeypatch):
    """Microbatch m reaches stage s at tick m + s: the (stage, microbatch)
    pairs run in tick order, every pair once, and none on a bubble."""
    seen = []
    real = pipeline.run_stage

    def spy(stage, blocks, x, mask, attn_fn):
        seen.append(stage)
        return real(stage, blocks, x, mask, attn_fn)

    monkeypatch.setattr(pipeline, "run_stage", spy)
    cfg = encoder.EncoderConfig(**CFG)
    model = encoder.from_jax_params(encoder.init_params(cfg, "pp-test"), cfg,
                                    mesh=build_mesh(["cpu"] * 2, {"pp": 2}))
    model.n_micro = 3
    ids, mask = _batch(6)
    model(torch.from_numpy(ids), torch.from_numpy(mask))
    # ticks: (s0,m0) | (s0,m1) (s1,m0) | (s0,m2) (s1,m1) | (s1,m2)
    assert seen == [0, 0, 1, 0, 1, 1]


# ---- the op's two routes and their guards ----

BASE = {"vocab_size": 260, "d_model": 32, "n_heads": 4, "n_layers": 2, "d_ff": 64,
        "max_len": 64, "n_classes": 16, "dtype": "float32"}
TEXTS = ["strategy serving row %d" % i for i in range(16)]


@pytest.fixture(scope="module")
def classify():
    fn = load_ops(["map_classify_tpu"])["map_classify_tpu"]
    return lambda cfg, rt: fn({"texts": TEXTS, "topk": 3, "result_format": "columnar",
                               "model_config": cfg}, OpContext(runtime=rt))


def _jax(cfg, shape):
    rt = TpuRuntime(config=JaxDeviceConfig(mesh_shape=shape), devices=jax.devices()[:8])
    return jax_get_op("map_classify_tpu")({"texts": TEXTS, "topk": 3,
                                           "result_format": "columnar",
                                           "model_config": cfg}, JaxOpContext(runtime=rt))


@pytest.mark.parametrize("route", ["mesh-axis", "model-config"])
def test_classify_routes_through_the_pipeline(classify, route):
    if route == "mesh-axis":
        shape, cfg = {"dp": 4, "pp": 2}, BASE
    else:
        shape, cfg = {"dp": 8}, dict(BASE, pp=2)
    rt = TorchRuntime(devices=["cpu"] * 8, mesh_shape=shape)
    got = classify(cfg, rt)
    model = next(iter(rt._params._cache.values()))
    assert isinstance(model, pipeline.PipelinedEncoder)
    assert model.mesh.shape["pp"] == 2 and model.mesh.shape["dp"] == 4
    want = _jax(cfg, shape)
    one = classify(BASE, TorchRuntime(device="cpu"))
    for other in (want, one):
        assert got["indices"] == other["indices"]
        np.testing.assert_allclose(got["scores"], other["scores"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("bad,msg", [
    ({"pp": 2, "n_layers": 3}, "not divisible"),
    ({"pp": 2, "moe_experts": 4}, "cannot combine"),
    ({"pp": 3, "n_layers": 3}, "pp=3 does not divide the 8-device mesh")])
def test_model_config_route_guards_are_soft(classify, bad, msg):
    rt = TorchRuntime(devices=["cpu"] * 8, mesh_shape={"dp": 8})
    got = classify(dict(BASE, **bad), rt)
    assert got["ok"] is False and msg in got["error"], got
    want = _jax(dict(BASE, **bad), {"dp": 8})
    assert want["ok"] is False and msg in want["error"], want


@pytest.mark.parametrize("bad,msg", [({"moe_experts": 4}, "cannot combine"),
                                     ({"n_layers": 3}, "not divisible")])
def test_mesh_axis_route_enforces_the_same_guards(classify, bad, msg):
    rt = TorchRuntime(devices=["cpu"] * 8, mesh_shape={"dp": 4, "pp": 2})
    got = classify(dict(BASE, **bad), rt)
    assert got["ok"] is False and msg in got["error"], got


@pytest.mark.parametrize("mode", ["int8", "w8a16"])
def test_quantized_pipeline_matches_the_unpipelined(classify, mode):
    rt = TorchRuntime(devices=["cpu"] * 4, mesh_shape={"dp": 2, "pp": 2})
    cfg = dict(BASE, quant=mode)
    got, one = classify(cfg, rt), classify(cfg, TorchRuntime(device="cpu"))
    assert got["indices"] == one["indices"]
    np.testing.assert_allclose(got["scores"], one["scores"], rtol=0, atol=1e-5)
