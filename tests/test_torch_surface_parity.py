"""The last of the reference's surface, held against ``agent_tpu`` on the
CPU: ``OPS_PLUGIN_PATH`` plugins, ``TPU_ONLY``'s CPU block,
``COMPUTE_DTYPE``, ``OpsConfig``, the WordPiece trainer, ``OpError``'s
classification, ``RetryState.expired``, ``count_params``,
``EncoderConfig.scaled``, ``AGENT_TPU_NATIVE_CACHE`` and a CPU runtime's
share of a ``CHIP_SLICE``."""

from __future__ import annotations

import random
import re
from pathlib import Path

import numpy as np
import pytest

from agent_tpu import config as jax_config
from agent_tpu import ops as jax_ops
from agent_tpu.models import encoder as jax_encoder
from agent_tpu.models import layers as jax_layers
from agent_tpu.models import tokenizer as jax_tokenizer
from agent_tpu.sizing import profile as jax_profile
from agent_tpu.utils import errors as jax_errors
from agent_tpu.utils import retry as jax_retry
from agent_tpu_torch import config
from agent_tpu_torch import ops
from agent_tpu_torch.data.native import build as native_build
from agent_tpu_torch.models import encoder, layers, tokenizer
from agent_tpu_torch.obs import recorder
from agent_tpu_torch.runtime.runtime import TorchRuntime, apply_chip_slice
from agent_tpu_torch.sizing import profile
from agent_tpu_torch.utils import errors, retry
from agent_tpu_torch.utils.errors import structured_error

ROOT = Path(__file__).resolve().parents[1]

# ---- OPS_PLUGIN_PATH --------------------------------------------------------

PLUGIN = ("from {pkg}.ops import register_op\n"
          "@register_op('plugin_scale_{tag}')\n"
          "def run(payload, ctx=None):\n"
          "    xs = payload['xs']\n"
          "    return {{'ok': True, 'scaled': [x * payload['k'] for x in xs], 'n': len(xs)}}\n")


@pytest.fixture()
def clean_registry():
    """Both registries' plugin artifacts removed afterwards, as the
    reference's own fixture does it: surgically, since a plugin may import
    a builtin op module, which stays in ``sys.modules`` (a wholesale restore
    would drop its registration for good)."""
    saved = [(m, dict(m.OP_TO_MODULE), list(m.OPS_LOAD_ERRORS), m._plugins_loaded)
             for m in (ops, jax_ops)]
    yield
    for m, o2m, errs, loaded in saved:
        for name in list(m.OP_TO_MODULE):
            if name not in o2m:
                del m.OP_TO_MODULE[name]
                m.OPS_REGISTRY.pop(name, None)
        m.OPS_LOAD_ERRORS[:] = errs
        for key in list(m._imported):
            if key.startswith("plugin:"):
                del m._imported[key]
        m._plugins_loaded = loaded


def test_a_plugin_registers_and_dispatches(tmp_path, clean_registry, monkeypatch):
    monkeypatch.delenv("TASKS", raising=False)
    plug = tmp_path / "scale_ops.py"
    plug.write_text(PLUGIN.format(pkg="agent_tpu_torch", tag="a"))
    assert ops.load_plugins(str(plug)) == ["plugin_scale_a"]
    assert ops.OP_TO_MODULE["plugin_scale_a"] == f"plugin:{plug}"
    assert "plugin_scale_a" in ops.list_ops()
    assert ops.get_op("plugin_scale_a")({"xs": [1, 2], "k": 3}) == {
        "ok": True, "scaled": [3, 6], "n": 2}


def test_load_ops_reads_the_env_once(tmp_path, clean_registry, monkeypatch):
    monkeypatch.delenv("TASKS", raising=False)
    plug = tmp_path / "scale_ops.py"
    plug.write_text(PLUGIN.format(pkg="agent_tpu_torch", tag="env"))
    monkeypatch.setenv("OPS_PLUGIN_PATH", f"{tmp_path / 'absent.py'}:{plug}")
    ops._plugins_loaded = False
    before = len(ops.OPS_LOAD_ERRORS)
    handlers = ops.load_ops(["echo", "plugin_scale_env"])
    assert handlers["plugin_scale_env"]({"xs": [2], "k": 2})["scaled"] == [4]
    assert [e[0] for e in ops.OPS_LOAD_ERRORS[before:]] == [f"plugin:{tmp_path / 'absent.py'}"]
    assert ops.load_plugins() == []  # once a process


def test_a_broken_plugin_is_recorded_not_raised(tmp_path, clean_registry):
    bad = tmp_path / "bad.py"
    bad.write_text("from agent_tpu_torch.ops import register_op\n"
                   "@register_op('half_registered')\n"
                   "def run(payload, ctx=None):\n    return {}\n"
                   "raise RuntimeError('boom at import')\n")
    before = len(ops.OPS_LOAD_ERRORS)
    assert ops.load_plugins(str(bad)) == []
    assert len(ops.OPS_LOAD_ERRORS) == before + 1
    assert "boom at import" in ops.OPS_LOAD_ERRORS[-1][1]
    # The op it registered before failing is rolled back, not left unreachable.
    assert "half_registered" not in ops.OPS_REGISTRY


def test_a_missing_plugin_path_is_recorded(tmp_path, clean_registry):
    before = len(ops.OPS_LOAD_ERRORS)
    assert ops.load_plugins(str(tmp_path / "nope.py")) == []
    assert len(ops.OPS_LOAD_ERRORS) == before + 1


def test_a_plugin_importing_a_builtin_keeps_the_builtin_s_module(tmp_path, clean_registry):
    plug = tmp_path / "reexport.py"
    plug.write_text("from agent_tpu_torch.ops.echo import run as _echo\n"
                    "from agent_tpu_torch.ops import register_op\n"
                    "@register_op('echo_twice')\n"
                    "def run(payload, ctx=None):\n"
                    "    return {'ok': True, 'echoes': [_echo(payload), _echo(payload)]}\n")
    assert ops.load_plugins(str(plug)) == ["echo_twice"]
    assert ops.OP_TO_MODULE["echo"] == "echo"
    assert ops.get_op("echo") is ops.OPS_REGISTRY["echo"]


def test_one_plugin_text_gives_both_packages_the_same_outputs(tmp_path, clean_registry):
    """The same plugin file, its import line retargeted, loaded into each
    package."""
    got = {}
    for pkg, mod in (("agent_tpu", jax_ops), ("agent_tpu_torch", ops)):
        plug = tmp_path / f"{pkg}_scale.py"
        plug.write_text(PLUGIN.format(pkg=pkg, tag="both"))
        assert mod.load_plugins(str(plug)) == ["plugin_scale_both"]
        rng = np.random.default_rng(7)
        payloads = [{"xs": rng.integers(-50, 50, size=n).tolist(), "k": int(rng.integers(1, 9))}
                    for n in (0, 1, 5, 33)]
        got[pkg] = [mod.get_op("plugin_scale_both")(p) for p in payloads]
    assert got["agent_tpu_torch"] == got["agent_tpu"]


# ---- TPU_ONLY, COMPUTE_DTYPE, OpsConfig --------------------------------------

@pytest.mark.parametrize("env,field", [("1", False), ("", True), ("", False), ("off", False)])
def test_tpu_only_caps_the_cpu_block_as_the_reference(env, field, monkeypatch):
    monkeypatch.setenv("TPU_ONLY", env)
    monkeypatch.setenv("TPU_DISABLED", "1")  # no device probe in either package
    want = jax_profile.build_worker_profile(jax_config.Config(
        device=jax_config.DeviceConfig(tpu_disabled=True, tpu_only=field)))
    got = profile.build_worker_profile(config.SizingConfig(),
                                       config.DeviceConfig(tpu_disabled=True, tpu_only=field))
    assert got["cpu"] == want["cpu"]
    capped = env == "1" or field
    assert (got["cpu"]["max_cpu_workers"], got["cpu"]["target_inflight"]) == (
        (1, 1) if capped else (want["cpu"]["max_cpu_workers"], want["cpu"]["target_inflight"]))
    assert got["max_total_workers"] == got["cpu"]["max_cpu_workers"] + got["gpu"]["max_gpu_workers"]


def test_tpu_only_keeps_the_gpu_block_in_the_port_only(monkeypatch):
    """The reference empties its gpu block under TPU_ONLY (no GPU is its
    accelerator); in the port the card is the accelerator and the shard hint
    rides that block, so the block stays."""
    card = {"gpu_present": True, "gpus": [{"name": "NVIDIA H100 80GB HBM3", "memory_mb": 81559}],
            "max_gpu_workers": 1}
    monkeypatch.setattr(profile, "detect_gpu", lambda: dict(card, gpus=list(card["gpus"])))
    monkeypatch.setattr(jax_profile, "detect_gpu", lambda: dict(card, gpus=list(card["gpus"])))
    monkeypatch.setenv("TPU_ONLY", "1")
    got = profile.build_worker_profile(config.SizingConfig(), config.DeviceConfig())
    want = jax_profile.build_worker_profile(jax_config.Config(
        device=jax_config.DeviceConfig(tpu_disabled=True)))
    assert want["gpu"]["gpu_present"] is False and want["gpu"]["gpus"] == []
    assert got["gpu"]["gpu_present"] is True and got["gpu"]["suggested_shard_rows"] == 16384
    assert got["cpu"] == want["cpu"]


@pytest.mark.parametrize("env", {"TPU_ONLY": ["1", "yes", "", "0"],
                                 "COMPUTE_DTYPE": ["float32", "", "bfloat16"]}.items())
def test_device_config_reads_the_reference_s_env(env, monkeypatch):
    name, values = env
    field = {"TPU_ONLY": "tpu_only", "COMPUTE_DTYPE": "compute_dtype"}[name]
    for value in values:
        monkeypatch.setenv(name, value)
        assert getattr(config.DeviceConfig.from_env(), field) == getattr(
            jax_config.DeviceConfig.from_env(), field)


def test_the_runtime_refuses_a_compute_dtype_it_cannot_apply(monkeypatch):
    """The reference's COMPUTE_DTYPE only labels its describe(); each model's
    config sets its dtype (the MoE encoder's is f32). The port's runtime
    claims no runtime-wide dtype and refuses a value it would ignore."""
    with pytest.raises(ValueError, match="COMPUTE_DTYPE='float32'"):
        TorchRuntime(device="cpu", config=config.DeviceConfig(compute_dtype="float32"))
    monkeypatch.setenv("COMPUTE_DTYPE", "float32")
    with pytest.raises(ValueError, match="COMPUTE_DTYPE"):
        TorchRuntime(device="cpu", config=config.DeviceConfig.from_env())
    rt = TorchRuntime(device="cpu", config=config.DeviceConfig(compute_dtype="bfloat16"))
    assert "compute_dtype" not in rt.describe()
    assert rt.peak_flops() is None  # the CPU has no entry; PEAK_TFLOPS overrides
    monkeypatch.setenv("PEAK_TFLOPS", "2.5")
    assert rt.peak_flops() == 2.5e12


@pytest.mark.parametrize("values", [{}, {"BART_MODEL": "bart-x", "SUMMARIZE_FORCE_CPU": "on",
                                         "SAP_HOST": "h", "ORA_USER": "u"}])
def test_ops_config_reads_the_reference_s_env(values, monkeypatch):
    """The port's OpsConfig keeps the reference's fields that an op reads;
    the others (summarize_model, the SAP/Oracle credentials) are read by no
    code of either package."""
    for name in ("BART_MODEL", "SUMMARIZE_FORCE_CPU", "SAP_HOST", "SAP_USER", "SAP_PASS",
                 "ORACLE_HOST", "ORA_USER", "ORA_PASS"):
        monkeypatch.delenv(name, raising=False)
    for name, value in values.items():
        monkeypatch.setenv(name, value)
    got, want = vars(config.OpsConfig.from_env()), vars(jax_config.OpsConfig.from_env())
    assert set(got) == {"summarize_force_cpu"}
    assert got == {k: want[k] for k in got}
    assert config.Config.from_env().ops == config.OpsConfig.from_env()


@pytest.mark.parametrize("field", ["summarize_model", "sap_host", "sap_user", "sap_pass",
                                   "oracle_host", "oracle_user", "oracle_pass"])
def test_the_ops_config_fields_left_out_are_read_by_nothing(field):
    """Each field the port leaves out of OpsConfig is read nowhere in the
    reference outside the config module: porting it would add a dead knob."""
    readers = [p for p in (ROOT / "agent_tpu").rglob("*.py")
               if p.name != "config.py" and re.search(rf"\.{field}\b", p.read_text())]
    assert readers == []


# ---- WordPiece ----------------------------------------------------------------

WORDS = ("swarm agent lease shard drain controller partition standby router kernel "
         "attention encoder decoder summary classify token vocab piece würfel café naïve")


def _corpus(seed: int, n: int):
    rng = random.Random(seed)
    words = WORDS.split()
    return [" ".join(rng.choice(words) + rng.choice(["", "s", "ing", "ed", ",", "!"])
                     for _ in range(rng.randint(1, 12))) for _ in range(n)]


@pytest.mark.parametrize("seed,vocab_size,lowercase", [(0, 64, True), (1, 128, False),
                                                       (2, 4096, True), (3, 30, True)])
def test_wordpiece_trains_the_reference_s_vocab(seed, vocab_size, lowercase, tmp_path):
    corpus = _corpus(seed, 200)
    want = jax_tokenizer.WordPieceTokenizer.train(corpus, vocab_size=vocab_size,
                                                  lowercase=lowercase)
    got = tokenizer.WordPieceTokenizer.train(iter(corpus), vocab_size=vocab_size,
                                             lowercase=lowercase)
    assert list(got.vocab.items()) == list(want.vocab.items())  # same ids, same order
    for text in _corpus(seed + 100, 30) + ["unseen wordz", "", "CAFÉ naïve!"]:
        ids = got.encode(text, add_bos=True, add_eos=True)
        assert ids == want.encode(text, add_bos=True, add_eos=True)
        assert got.decode(ids) == want.decode(ids)
    # A saved file loads in either package.
    got.save(str(tmp_path / "port.txt"))
    want.save(str(tmp_path / "ref.txt"))
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "ref.txt").read_bytes()
    back = tokenizer.WordPieceTokenizer.from_file(str(tmp_path / "ref.txt"), lowercase=lowercase)
    cross = jax_tokenizer.WordPieceTokenizer.from_file(str(tmp_path / "port.txt"),
                                                       lowercase=lowercase)
    assert back.vocab == want.vocab and cross.vocab == got.vocab


def test_an_empty_wordpiece_holds_the_specials():
    assert tokenizer.WordPieceTokenizer().vocab == jax_tokenizer.WordPieceTokenizer().vocab
    assert tokenizer.WordPieceTokenizer().decode([0, 1, 2, 3, 99]) == ""


# ---- OpError, RetryPolicy.deadline_sec, RetryState.expired -------------------

def test_op_error_is_permanent_in_both_packages():
    for mod, err in ((errors, retry), (jax_errors, jax_retry)):
        try:
            raise mod.OpError("contract violated")
        except mod.OpError as exc:
            wire = structured_error(exc)
        assert wire["type"] == "OpError" and err.classify_error(wire) == err.PERMANENT
    assert retry.classify_error({"type": "OpError"}) == jax_retry.classify_error(
        {"type": "OpError"})


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("deadline", [0.0, 2.5, 10.0])
def test_retry_state_expires_as_the_reference(deadline):
    answers = {}
    for name, mod in (("port", retry), ("ref", jax_retry)):
        clock = _Clock()
        policy = mod.RetryPolicy(base_sec=0.5, max_sec=4.0, deadline_sec=deadline)
        state = policy.start(rng=random.Random(11), clock=clock)
        seq = [state.expired()]  # never before the first backoff
        for _ in range(8):
            sleep = state.next_backoff()
            clock.t += sleep
            seq.append((round(sleep, 12), state.attempts, state.expired()))
        state.reset()
        seq.append((state.attempts, state.expired()))
        answers[name] = seq
    assert answers["port"] == answers["ref"]
    assert any(s[2] for s in answers["port"][1:-1] if isinstance(s, tuple)) == (deadline > 0)


# ---- count_params, scaled, causal_mask ---------------------------------------

@pytest.mark.parametrize("kw", [{}, {"n_layers": 2, "d_model": 64, "n_heads": 4, "d_ff": 128},
                                {"moe_experts": 4, "n_layers": 1}])
def test_count_params_is_the_reference_s(kw):
    want = jax_layers.count_params(jax_encoder.init_params(jax_encoder.EncoderConfig(**kw)))
    cfg = encoder.EncoderConfig(**kw)
    assert layers.count_params(encoder.init_params(cfg)) == want
    assert layers.count_params(layers.unflatten(encoder.init_params(cfg))) == want
    if not kw.get("moe_experts"):
        assert layers.count_params(encoder.Encoder(cfg, device="cpu", trainable=True)) == want


def test_scaled_replaces_fields_as_the_reference():
    over = {"n_layers": 2, "dtype": "float32", "quant": "int8"}
    got = encoder.EncoderConfig().scaled(**over)
    want = jax_encoder.EncoderConfig().scaled(**over)
    assert {k: getattr(got, k) for k in vars(got)} == {k: getattr(want, k) for k in vars(got)}
    assert encoder.EncoderConfig().n_layers != 2  # frozen: a copy


def test_causal_mask_is_the_reference_s():
    for n in (1, 5):
        assert np.array_equal(layers.causal_mask(n), jax_layers.causal_mask(n))


# ---- AGENT_TPU_NATIVE_CACHE, CHIP_SLICE on the CPU, the recorder --------------

def test_the_native_scanner_builds_where_agent_tpu_native_cache_says(tmp_path, monkeypatch):
    monkeypatch.delenv("AGENT_TPU_NATIVE_CACHE", raising=False)
    assert native_build.build_dir() == native_build.BUILD_DIR
    monkeypatch.setenv("AGENT_TPU_NATIVE_CACHE", str(tmp_path / "cache"))
    assert native_build.build_dir() == str(tmp_path / "cache")
    so = native_build._build()
    if so is not None:  # no compiler: the numpy scanner serves instead
        assert so.startswith(str(tmp_path / "cache"))


@pytest.mark.parametrize("spec,n", [("0:1", 1), ("1:2", 2), ("2:4", 4)])
def test_a_cpu_runtime_owns_its_slice_s_count(spec, n):
    """A CPU fleet member (TPU_DISABLED) owns ``count`` devices, as the
    reference's member owns ``count`` host devices."""
    rt = TorchRuntime(config=config.DeviceConfig(tpu_disabled=True, chip_slice=spec))
    assert rt.platform == "cpu" and rt.n_devices == n and rt.mesh.shape["dp"] == n


def test_apply_chip_slice_takes_the_reference_s_slice():
    from agent_tpu.runtime.runtime import apply_chip_slice as jax_apply

    devices = list("abcd")
    for spec in ("0:1", "1:2", "0:4", "3:1"):
        assert apply_chip_slice(devices, spec) == jax_apply(devices, spec)
    for spec in ("3:2", "4:1"):
        with pytest.raises(ValueError):
            apply_chip_slice(devices, spec)
        with pytest.raises(ValueError):
            jax_apply(devices, spec)


def test_the_process_recorder_is_one_instance():
    assert recorder.get_recorder() is recorder.get_recorder()
    recorder.get_recorder().record("probe", x=1)
    assert recorder.get_recorder().events()[-1]["kind"] == "probe"
