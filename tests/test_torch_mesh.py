"""The port's mesh and its runtime against the JAX package: MeshSpec.resolve
gives the reference's specs and errors, build_mesh lays devices out as
listed (one device may hold several shards), TorchRuntime takes an sp mesh
and refuses the axes not ported yet, and MESH_SHAPE parses as the
reference's DeviceConfig.from_env parses it."""

import numpy as np
import pytest
import torch

from agent_tpu.config import DeviceConfig
from agent_tpu.runtime.mesh import MeshSpec as JaxMeshSpec
from agent_tpu_torch.config import DeviceConfig as TorchDeviceConfig
from agent_tpu_torch.kernels import flash_attention as fa
from agent_tpu_torch.models import layers
from agent_tpu_torch.runtime import runtime as runtime_mod
from agent_tpu_torch.runtime.mesh import AXES, MeshSpec, build_mesh
from agent_tpu_torch.runtime.runtime import TorchRuntime

torch.set_num_threads(1)

RESOLVE_CASES = [
    (8, None), (8, {}), (8, {"sp": 2}), (8, {"dp": 2, "tp": 2, "sp": 2}), (8, {"tp": 4}),
    (1, {}), (4, {"sp": 4}), (6, {"tp": 2, "ep": 3}), (4, {"ep": 2}),
    (8, {"sp": 3}), (8, {"dp": 3}), (8, {"dp": 2, "tp": 2}), (8, {"sp": 0}),
    (8, {"sp": "2"}), (2, {"sp": 2, "tp": 2}),
]


@pytest.mark.parametrize("n,shape", RESOLVE_CASES, ids=[f"{n}-{s}" for n, s in RESOLVE_CASES])
def test_resolve_matches_jax(n, shape):
    try:
        want = JaxMeshSpec.resolve(n, shape)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            MeshSpec.resolve(n, shape)
        assert str(got.value) == str(exc)
        return
    got = MeshSpec.resolve(n, shape)
    assert got.axes == want.axes and got.n_devices == want.n_devices == n
    assert got.names[:3] == AXES


def test_build_mesh_lists_a_device_more_than_once():
    mesh = build_mesh(["cpu"] * 4, {"sp": 4})
    assert mesh.shape == {"dp": 1, "tp": 1, "sp": 4} and mesh.size == 4
    assert mesh.axis_names == AXES and mesh.devices.shape == (1, 1, 4)
    assert all(d == torch.device("cpu") for d in mesh.devices.reshape(-1))
    with pytest.raises(ValueError, match="not divisible"):
        build_mesh(["cpu"] * 3, {"sp": 2})
    with pytest.raises(ValueError, match="no devices"):
        build_mesh([], {})


def test_runtime_on_an_sp_mesh():
    rt = TorchRuntime(devices=["cpu"] * 2, mesh_shape={"sp": 2})
    assert rt.axis_size("sp") == 2 and rt.axis_size("dp") == rt.axis_size("tp") == 1
    assert rt.device == torch.device("cpu") and rt.n_devices == 2
    desc = rt.describe()
    assert desc["mesh"] == {"dp": 1, "tp": 1, "sp": 2}
    assert desc["mesh_devices"] == ["cpu", "cpu"]
    attn = rt.attention_fn()
    assert attn is not fa.flash_attention and attn is not layers.dot_product_attention
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 2, 8, 32)).astype(np.float32))
               for _ in range(3))
    mask = torch.ones(2, 1, 1, 8, dtype=torch.int32)
    before = fa.SELECTION_COUNTS["ring"]
    torch.testing.assert_close(attn(q, k, v, mask), layers.dot_product_attention(q, k, v, mask),
                               rtol=2e-5, atol=2e-5)
    assert fa.SELECTION_COUNTS["ring"] == before + 1
    # Ring attention is forward-only, as the reference's: sp meshes train dense.
    assert rt.train_attention_fn() is layers.dot_product_attention


def test_runtime_without_sp_keeps_the_flash_path():
    rt = TorchRuntime(device="cpu")
    assert rt.mesh.shape == {"dp": 1, "tp": 1, "sp": 1} and rt.axis_size("sp") == 1
    assert rt.attention_fn() is fa.flash_attention
    assert rt.train_attention_fn() is fa.flash_attention_trainable
    one = TorchRuntime(devices=["cpu"], mesh_shape={"sp": 1})
    assert one.attention_fn() is fa.flash_attention


@pytest.mark.parametrize("shape", [{"dp": 2}, {"tp": 2}, {"sp": 2, "dp": 2}, {"ep": 1},
                                   None])
def test_runtime_refuses_axes_not_ported(shape):
    """dp, tp, pp and ep are ported with sp; an axis no path reads is refused."""
    n = 4 if shape and len(shape) == 2 else 2
    rt = TorchRuntime(devices=["cpu"] * n, mesh_shape=shape)
    assert rt.mesh.size == n and rt.describe()["mesh"] == rt.mesh.shape
    assert set(rt.mesh.axis_names) <= {"dp", "tp", "sp", "pp", "ep"}
    with pytest.raises(ValueError, match=r"no path reads mesh axes \['xp'\]"):
        TorchRuntime(devices=["cpu"] * n, mesh_shape={**(shape or {}), "xp": 1})


def test_runtime_mesh_shape_without_devices_needs_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=r"needs 2 CUDA devices and 0 are visible"):
        TorchRuntime(mesh_shape={"sp": 2})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match=r"devices=\['cuda:0'\] \* 4"):
        TorchRuntime(mesh_shape={"sp": 4})
    with pytest.raises(ValueError, match="positive int"):
        TorchRuntime(mesh_shape={"sp": "two"})


def test_runtime_argument_errors():
    with pytest.raises(ValueError, match="not both"):
        TorchRuntime(device="cpu", devices=["cpu"])
    with pytest.raises(ValueError, match="one or more"):
        TorchRuntime(devices=[])


MESH_ENVS = ["sp=2", "dp=2, tp = 4,bogus,sp=x", "", "sp=2,sp=4", "tp=2,=3"]


@pytest.mark.parametrize("raw", MESH_ENVS)
def test_mesh_shape_env_parses_as_the_reference(monkeypatch, raw):
    monkeypatch.setenv("MESH_SHAPE", raw)
    assert TorchDeviceConfig.from_env().mesh_shape == DeviceConfig.from_env().mesh_shape


def test_get_runtime_reads_mesh_shape(monkeypatch):
    monkeypatch.setenv("MESH_SHAPE", "sp=2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    runtime_mod.reset_runtime()
    try:
        with pytest.raises(RuntimeError, match="needs 2 CUDA devices"):
            runtime_mod.get_runtime()
    finally:
        runtime_mod.reset_runtime()
