"""The port's in-house seq2seq and decode engines against the JAX package's:
``init_params`` bit-identical, and greedy and beam tokens and lengths
identical to JAX's for the same weights and inputs (f32 on the CPU),
across min_length, length penalties and early stopping; the engines alone
on scripted logits that emit EOS often."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from agent_tpu.models import decoding as jax_decoding
from agent_tpu.models import seq2seq as jax_s2s
from agent_tpu_torch.models import decoding, layers, seq2seq

torch.set_num_threads(1)

SMALL = dict(vocab_size=64, d_model=32, n_heads=4, n_enc_layers=2, n_dec_layers=2, d_ff=64,
             max_src_len=16, max_tgt_len=8, dtype="float32")
BYTES = dict(d_model=64, n_heads=2, n_enc_layers=2, n_dec_layers=2, d_ff=128,
             max_src_len=64, max_tgt_len=12, dtype="float32")


def _flat_jax(params) -> dict:
    return layers.flatten(jax.tree_util.tree_map(np.asarray, params))


@pytest.mark.parametrize("kw,model_id", [(SMALL, "beam-test"), ({}, "summarize-default")],
                         ids=["small", "default"])
def test_init_params_bit_identical(kw, model_id):
    want = _flat_jax(jax_s2s.init_params(jax_s2s.Seq2SeqConfig(**kw), model_id))
    got = seq2seq.init_params(seq2seq.Seq2SeqConfig(**kw), model_id)
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype and np.array_equal(got[key], value), key


@pytest.fixture(scope="module", params=["small", "bytes"])
def model(request):
    kw = SMALL if request.param == "small" else BYTES
    jcfg, tcfg = jax_s2s.Seq2SeqConfig(**kw), seq2seq.Seq2SeqConfig(**kw)
    jp = jax_s2s.init_params(jcfg, f"s2s-{request.param}")
    tm = seq2seq.from_jax_params(seq2seq.init_params(tcfg, f"s2s-{request.param}"), tcfg)
    rng = np.random.default_rng(7)
    src = rng.integers(4, jcfg.vocab_size, size=(3, 16)).astype(np.int32)
    mask = np.ones((3, 16), dtype=np.int32)
    mask[1, 10:] = 0
    return jcfg, jp, tm, src, mask


def _port(tm, fn, src, mask, *args, **kw):
    with torch.inference_mode():
        toks, lens = fn(tm, torch.from_numpy(src), torch.from_numpy(mask), *args, **kw)
    return toks.numpy(), lens.numpy()


def test_encode_matches_jax(model):
    jcfg, jp, tm, src, mask = model
    want = np.asarray(jax_s2s.encode(jp, src, mask, jcfg))
    got = seq2seq.encode(tm, torch.from_numpy(src), torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=3e-5, rtol=0)


@pytest.mark.parametrize("min_length", [0, 5])
def test_greedy_matches_jax(model, min_length):
    jcfg, jp, tm, src, mask = model
    T = jcfg.max_tgt_len
    want = jax_s2s.greedy_generate(jp, src, mask, jcfg, T, min_length=min_length)
    got = _port(tm, seq2seq.greedy_generate, src, mask, T, min_length=min_length)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))


@pytest.mark.parametrize("lp,early,min_length", [(1.0, False, 0), (2.0, False, 0),
                                                 (-1.0, False, 0), (1.0, True, 0),
                                                 (2.0, True, 4)])
def test_beam_matches_jax(model, lp, early, min_length):
    jcfg, jp, tm, src, mask = model
    T = jcfg.max_tgt_len
    want = jax_s2s.beam_generate(jp, src, mask, jcfg, T, num_beams=4, length_penalty=lp,
                                 early_stopping=early, min_length=min_length)
    got = _port(tm, seq2seq.beam_generate, src, mask, T, num_beams=4, length_penalty=lp,
                early_stopping=early, min_length=min_length)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))


def test_beam1_equals_greedy(model):
    jcfg, _, tm, src, mask = model
    T = jcfg.max_tgt_len
    g = _port(tm, seq2seq.greedy_generate, src, mask, T)
    b = _port(tm, seq2seq.beam_generate, src, mask, T, num_beams=1)
    np.testing.assert_array_equal(g[0], b[0])
    np.testing.assert_array_equal(g[1], b[1])


@pytest.mark.parametrize("lp", [0.0, 1.0, 2.0])
def test_cache_reorder_delta_equals_gather(model, lp):
    jcfg, _, tm, src, mask = model
    runs = {scheme: _port(tm, seq2seq.beam_generate, src, mask, jcfg.max_tgt_len,
                          num_beams=4, length_penalty=lp, cache_reorder=scheme)
            for scheme in ("gather", "delta")}
    np.testing.assert_array_equal(runs["delta"][0], runs["gather"][0])
    np.testing.assert_array_equal(runs["delta"][1], runs["gather"][1])


def test_cache_reorder_rejects_unknown_scheme():
    with pytest.raises(ValueError, match="cache_reorder"):
        decoding.beam_scan(lambda t, s, c: (None, c), None, 1, 8, 4, num_beams=2,
                           start_id=1, eos_id=2, cache_reorder="sometimes")


def test_load_npz_matches_jax(tmp_path):
    cfg_kw = dict(SMALL)
    path = str(tmp_path / "s2s.npz")
    rng = np.random.default_rng(3)
    override = {"dec.1.xattn.wq": rng.normal(size=(32, 4, 8)).astype(np.float32),
                "embed": rng.normal(size=(64, 32)).astype(np.float32)}
    np.savez(path, **override)
    want = _flat_jax(jax_s2s.load_npz(path, jax_s2s.Seq2SeqConfig(**cfg_kw)))
    got = seq2seq.load_npz(path, seq2seq.Seq2SeqConfig(**cfg_kw))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(got["embed"], override["embed"])


# ---- the engines on scripted logits ----

V, EOS, PAD, START = 11, 9, 0, 1


def _scripted_table(seed: int, T: int, B: int) -> np.ndarray:
    """Logits [T, V (previous token), B, V]: a function of step, previous
    token and batch row, with EOS often near the top."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(T, V, B, V)).astype(np.float32) * 2.0
    table[..., EOS] += rng.normal(size=(T, V, B)).astype(np.float32) + 1.0
    return table


def _jax_step(table, K):
    def step_fn(tok, step, caches):
        rows = jnp.arange(tok.shape[0]) // K
        return jnp.asarray(table)[step, tok, rows], caches
    return step_fn


def _torch_step(table, K):
    t = torch.from_numpy(table)

    def step_fn(tok, step, caches):
        rows = torch.arange(tok.shape[0]) // K
        return t[step, tok.long(), rows], caches
    return step_fn


@pytest.mark.parametrize("min_length", [0, 3])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_scan_matches_jax_on_scripted_logits(seed, min_length):
    B, T = 4, 10
    table = _scripted_table(seed, T, B)
    kw = dict(start_id=START, eos_id=EOS, pad_id=PAD, min_length=min_length)
    want = jax_decoding.greedy_scan(_jax_step(table, 1), None, B, T, **kw)
    got = decoding.greedy_scan(_torch_step(table, 1), None, B, T, **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("lp,early,min_length", [(1.0, False, 0), (2.0, False, 2),
                                                 (-1.0, False, 0), (0.5, True, 0),
                                                 (1.0, True, 3)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_beam_scan_matches_jax_on_scripted_logits(seed, lp, early, min_length):
    """EOS-heavy logits exercise banking, the full-store stop rule (both
    early_stopping settings) and the final bank of rows left open."""
    B, K, T = 3, 3, 9
    table = _scripted_table(10 + seed, T, B)
    kw = dict(num_beams=K, start_id=START, eos_id=EOS, pad_id=PAD, length_penalty=lp,
              early_stopping=early, min_length=min_length)
    caches = {"c": np.arange(B * K, dtype=np.float32)}
    want = jax_decoding.beam_scan(_jax_step(table, K), {"c": jnp.asarray(caches["c"])}, B, V,
                                  T, **kw)
    got = decoding.beam_scan(_torch_step(table, K), {"c": torch.from_numpy(caches["c"])}, B, V,
                             T, **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


# BART's forced ids: (forced_first_id, forced_last_id); EOS forced first
# ends every row at step 0, and a forced last id other than EOS is written
# where a row ran out.
FORCED = [(3, None), (None, EOS), (3, EOS), (EOS, 4)]


@pytest.mark.parametrize("min_length", [0, 4])
@pytest.mark.parametrize("forced", FORCED, ids=lambda f: f"first{f[0]}-last{f[1]}")
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_scan_forced_ids_match_jax_on_scripted_logits(seed, forced, min_length):
    B, T = 4, 10
    table = _scripted_table(seed, T, B)
    kw = dict(start_id=START, eos_id=EOS, pad_id=PAD, min_length=min_length,
              forced_first_id=forced[0], forced_last_id=forced[1])
    want = jax_decoding.greedy_scan(_jax_step(table, 1), None, B, T, **kw)
    got = decoding.greedy_scan(_torch_step(table, 1), None, B, T, **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    if forced[0] is not None:
        assert (got[0][:, 0] == forced[0]).all()


@pytest.mark.parametrize("lp,early,min_length", [(1.0, False, 0), (2.0, True, 0),
                                                 (-1.0, False, 4)])
@pytest.mark.parametrize("forced", FORCED, ids=lambda f: f"first{f[0]}-last{f[1]}")
@pytest.mark.parametrize("seed", [0, 1])
def test_beam_scan_forced_ids_match_jax_on_scripted_logits(seed, forced, lp, early,
                                                           min_length):
    """The forced rows replace the whole log-probability row after the
    min_length ban, so a forced EOS wins over min_length."""
    B, K, T = 3, 3, 9
    table = _scripted_table(10 + seed, T, B)
    kw = dict(num_beams=K, start_id=START, eos_id=EOS, pad_id=PAD, length_penalty=lp,
              early_stopping=early, min_length=min_length, forced_first_id=forced[0],
              forced_last_id=forced[1])
    want = jax_decoding.beam_scan(_jax_step(table, K), {"c": jnp.zeros(B * K)}, B, V, T, **kw)
    got = decoding.beam_scan(_torch_step(table, K), {"c": torch.zeros(B * K)}, B, V, T, **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("seed", [0, 1])
def test_beam_scan_reorders_caches_with_the_beams(seed):
    """The logits depend on a cache that sums each beam's tokens, so a cache
    left with the wrong beam changes the tokens: both reorder schemes must
    match JAX's beam_scan."""
    B, K, T = 2, 3, 7
    table = _scripted_table(20 + seed, T, B)
    j_base, t_base = _jax_step(table, K), _torch_step(table, K)

    def j_step(tok, step, caches):
        logits, _ = j_base(tok, step, caches)
        total = caches["sum"] + tok
        return logits + 1.5 * jax.nn.one_hot(total % V, V), {"sum": total}

    def t_step(tok, step, caches):
        logits, _ = t_base(tok, step, caches)
        total = caches["sum"] + tok
        return logits + 1.5 * torch.nn.functional.one_hot(total.long() % V, V), {"sum": total}

    kw = dict(num_beams=K, start_id=START, eos_id=EOS, pad_id=PAD)
    want = jax_decoding.beam_scan(j_step, {"sum": jnp.zeros(B * K, jnp.int32)}, B, V, T, **kw)
    for scheme in ("delta", "gather"):
        got = decoding.beam_scan(t_step, {"sum": torch.zeros(B * K, dtype=torch.int32)}, B, V,
                                 T, cache_reorder=scheme, **kw)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


def test_greedy_stops_once_every_row_is_done():
    B, T = 3, 12
    calls = []

    def step_fn(tok, step, caches):
        calls.append(step)
        logits = torch.full((B, V), -1e9)
        want = torch.where(torch.arange(B) * 2 + 1 == step, EOS, (step + 2) % 7 + 2)
        logits[torch.arange(B), want] = 0.0
        return logits, caches

    toks, lens = decoding.greedy_scan(step_fn, None, B, T, start_id=START, eos_id=EOS,
                                      pad_id=PAD)
    assert calls == list(range(6))  # the last row emits EOS at step 5
    assert (toks[:, 6:] == PAD).all()
    assert lens.tolist() == [1, 3, 5]
