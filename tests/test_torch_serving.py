"""The port's continuous-batching engine (``agent_tpu_torch.models.decoding.
ContinuousBatcher``) against the reference's, on the CPU at a small f32
size (2 + 2 layers, d_model 64, max_tgt_len 32), with the same seeded
weights (``seq2seq.from_jax_params``) and the same f32 encoder rows.

Tokens, lengths and steps equal exactly, greedy and beam × dense and paged
KV × micro_steps 1 and 3, through staggered joins, early exits and per-slot
limits, at the byte vocabulary and at a 12-id one that emits EOS often. The
port's engine also equals the port's own solo ``greedy_generate`` /
``beam_generate`` of each request with its own budget (in bf16 too, where a
fork is allowed only at a near tie of the solo decode's logits). The
engine's contract cases mirror ``tests/test_serving.py`` and
``tests/test_paged_kv.py``: the backlog, per-slot limits, ``run()``,
``KVPoolExhausted``, FIFO head-of-line wait on a full pool, block reuse
after release, and the trash-block repoint on release."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from agent_tpu.models import decoding as jax_decoding
from agent_tpu.models import seq2seq as jax_s2s
from agent_tpu_torch.models import decoding, seq2seq
from agent_tpu_torch.models.tokenizer import BOS_ID, EOS_ID, PAD_ID

torch.set_num_threads(1)

SMALL = dict(d_model=64, n_heads=4, n_enc_layers=2, n_dec_layers=2, d_ff=128,
             max_src_len=32, max_tgt_len=32, dtype="float32")
SRC_LEN = 16
BLOCK_SIZE = 4
BLOCKS_PER_ROW = 8  # max_tgt_len 32 / BLOCK_SIZE


def _models(vocab: int, dtype: str = "float32", model_id: str = "serving-parity"):
    kw = dict(SMALL, vocab_size=vocab, dtype=dtype)
    jcfg, tcfg = jax_s2s.Seq2SeqConfig(**kw), seq2seq.Seq2SeqConfig(**kw)
    jp = jax_s2s.init_params(jcfg, model_id)
    tm = seq2seq.from_jax_params(seq2seq.init_params(tcfg, model_id), tcfg)
    return jcfg, jp, tcfg, tm


@pytest.fixture(scope="module", params=[260, 12], ids=["bytes", "eos_heavy"])
def models(request):
    return _models(request.param)


def _requests(vocab: int, n: int, seed: int, max_tgt: int = 32):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        real = int(rng.integers(4, SRC_LEN))
        ids = rng.integers(4 if vocab > 12 else 3, vocab, (1, SRC_LEN)).astype(np.int32)
        mask = np.zeros((1, SRC_LEN), np.int32)
        mask[0, :real] = 1
        out.append((ids, mask, int(rng.integers(2, max_tgt))))
    return out


def _encode(jcfg, jp, ids, mask):
    """The reference's f32 encoder rows: both engines are handed these."""
    return np.asarray(jax_s2s.encode(jp, jnp.asarray(ids), jnp.asarray(mask), jcfg)
                      .astype(jnp.float32))


def _engine_kw(cfg, num_beams, slots, micro_steps=1, **kw):
    return dict(slots=slots, vocab_size=cfg.vocab_size, max_tokens=cfg.max_tgt_len,
                enc_len=SRC_LEN, d_model=cfg.d_model, start_id=BOS_ID, eos_id=EOS_ID,
                pad_id=PAD_ID, num_beams=num_beams, micro_steps=micro_steps, **kw)


def _port_engine(tcfg, tm, num_beams, paged, slots=3, pool_blocks=0, **kw):
    factory = (seq2seq.make_paged_cache_factory(tcfg, block_size=BLOCK_SIZE,
                                                pool_blocks=pool_blocks)
               if paged else seq2seq.make_cache_factory(tcfg))
    return decoding.ContinuousBatcher(seq2seq.make_positional_step(tm), factory,
                                      **_engine_kw(tcfg, num_beams, slots, **kw))


def _jax_engine(jcfg, jp, num_beams, paged, slots=3, **kw):
    factory = (jax_s2s.make_paged_cache_factory(jcfg, block_size=BLOCK_SIZE)
               if paged else jax_s2s.make_cache_factory(jcfg))
    return jax_decoding.ContinuousBatcher(jax_s2s.make_positional_step(jp, jcfg), factory,
                                          **_engine_kw(jcfg, num_beams, slots, **kw))


def _drive(engine, rows, reqs):
    """Four requests up front (one over capacity waits in the backlog), the
    rest joining every other step -> {index: (tokens, length, steps)}."""
    done = []
    for i in range(4):
        engine.admit(rows[i], reqs[i][1][0], reqs[i][2], data=i)
    pending = list(range(4, len(reqs)))
    with torch.inference_mode():
        while engine.has_work():
            done.extend(engine.step())
            if pending and engine.steps_run % 2 == 0:
                i = pending.pop(0)
                engine.admit(rows[i], reqs[i][1][0], reqs[i][2], data=i)
    assert len(done) == len(reqs)
    return {t.data: (np.asarray(t.tokens).tolist(), t.length, t.steps) for t in done}


def _port_solo(tm, ids, mask, limit, num_beams):
    with torch.inference_mode():
        fn = seq2seq.greedy_generate if num_beams == 1 else seq2seq.beam_generate
        kw = {} if num_beams == 1 else {"num_beams": num_beams}
        toks, _ = fn(tm, torch.from_numpy(ids), torch.from_numpy(mask), limit, **kw)
    return toks.numpy()[0]


@pytest.mark.parametrize("micro_steps", [1, 3])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("num_beams", [1, 3], ids=["greedy", "beam3"])
def test_engine_matches_the_reference_engine(models, num_beams, paged, micro_steps):
    """The acceptance bar: the same stream through both engines gives the
    same tokens, lengths and steps per request, and the same step count."""
    jcfg, jp, tcfg, tm = models
    reqs = _requests(jcfg.vocab_size, 7, seed=num_beams + 10 * micro_steps)
    rows = [_encode(jcfg, jp, ids, mask)[0] for ids, mask, _ in reqs]
    want_engine = _jax_engine(jcfg, jp, num_beams, paged, micro_steps=micro_steps)
    got_engine = _port_engine(tcfg, tm, num_beams, paged, micro_steps=micro_steps)
    want, got = _drive(want_engine, rows, reqs), _drive(got_engine, rows, reqs)
    assert got == want
    assert got_engine.steps_run == want_engine.steps_run
    assert got_engine.max_occupancy == want_engine.max_occupancy == 3
    assert got_engine.occupancy_sum == want_engine.occupancy_sum
    assert got_engine.kv_blocks_total == want_engine.kv_blocks_total
    assert got_engine.kv_blocks_free == want_engine.kv_blocks_free == got_engine.kv_blocks_total


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("num_beams", [1, 3], ids=["greedy", "beam3"])
def test_engine_matches_port_solo_decodes(models, num_beams, paged):
    """Each request's tokens through the running batch equal a solo decode
    of it with its own budget (the reference's bar, on the port alone)."""
    jcfg, jp, tcfg, tm = models
    reqs = _requests(jcfg.vocab_size, 7, seed=20 + num_beams)
    rows = [_encode(jcfg, jp, ids, mask)[0] for ids, mask, _ in reqs]
    got = _drive(_port_engine(tcfg, tm, num_beams, paged), rows, reqs)
    for i, (ids, mask, limit) in enumerate(reqs):
        solo = _port_solo(tm, ids, mask, limit, num_beams)
        assert got[i][0][:limit] == solo[:limit].tolist(), f"request {i}"
        assert got[i][2] <= limit


def _solo_greedy_logits(tm, row, mask, limit):
    """The port's solo greedy decode of one encoded row, keeping each step's
    logits -> (tokens, [limit, V] logits)."""
    enc = torch.from_numpy(row[None]).to(tm.cfg.compute_dtype)
    enc_kv = seq2seq.cross_kv(tm, enc)
    mask_t = torch.from_numpy(mask[None])
    seen = []

    def step_fn(tok, step, caches):
        logits, caches = seq2seq._decode_step(tm, tok, step, enc_kv, mask_t, caches)
        seen.append(logits[0].clone())
        return logits, caches

    with torch.inference_mode():
        toks, _ = decoding.greedy_scan(step_fn, seq2seq.empty_cache(tm.cfg, 1), 1, limit,
                                       start_id=BOS_ID, eos_id=EOS_ID, pad_id=PAD_ID)
    return toks.numpy()[0], torch.stack(seen).float().numpy()


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_bf16_engine_matches_solo_up_to_a_tie(paged):
    """bf16: each request's engine tokens equal its solo greedy decode, or
    fork first where the solo decode's two candidates' logits lie within
    bf16's tolerance (2e-2 of the largest logit), the tie-flip allowance of
    the bf16 paths."""
    jcfg, jp, tcfg, tm = _models(260, "bfloat16", "serving-bf16")
    reqs = _requests(260, 6, seed=41)
    # bf16 rows: the engine and the solo decode start from the same values.
    rows = [torch.tensor(_encode(jcfg, jp, ids, mask)[0]).bfloat16().float().numpy()
            for ids, mask, _ in reqs]
    got = _drive(_port_engine(tcfg, tm, 1, paged), rows, reqs)
    exact = 0
    for i, (_, mask, limit) in enumerate(reqs):
        solo, logits = _solo_greedy_logits(tm, rows[i], mask[0], limit)
        toks = np.asarray(got[i][0][:limit])
        fork = np.nonzero(toks != solo[:limit])[0]
        if not fork.size:
            exact += 1
            continue
        p = int(fork[0])
        a, b = int(toks[p]), int(solo[p])
        assert abs(logits[p, a] - logits[p, b]) <= 2e-2 * max(1.0, np.abs(logits[p]).max()), \
            f"request {i} forks at step {p} away from a tie"
    assert exact >= len(reqs) // 2


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_backlog_joins_between_steps(models, paged):
    jcfg, jp, tcfg, tm = models
    reqs = _requests(jcfg.vocab_size, 5, seed=9)
    engine = _port_engine(tcfg, tm, 1, paged, slots=2)
    for i, (ids, mask, limit) in enumerate(reqs):
        engine.admit(_encode(jcfg, jp, ids, mask)[0], mask[0], limit, data=i)
    assert engine.occupancy == 2 and engine.backlog == 3
    finished = 0
    while engine.has_work():
        finished += len(engine.step())
        assert engine.occupancy <= 2
    assert finished == 5
    assert engine.mean_occupancy() > 1.0
    assert engine.tokens_emitted >= sum(1 for _ in reqs)


def test_per_slot_limits_exit_early_with_lifecycle_stamps(models):
    jcfg, jp, tcfg, tm = models
    ids = np.full((1, SRC_LEN), 7, np.int32)
    mask = np.ones((1, SRC_LEN), np.int32)
    clock = iter(float(t) for t in range(1000))
    engine = _port_engine(tcfg, tm, 1, False, slots=2, clock=lambda: next(clock))
    enc = _encode(jcfg, jp, ids, mask)[0]
    short = engine.admit(enc, mask[0], 2, data="short")
    long_ = engine.admit(enc, mask[0], 12, data="long")
    order = []
    while engine.has_work():
        order.extend(t.data for t in engine.step())
    assert order[0] == "short"
    assert short.steps <= 2 and long_.steps <= 12
    for t in (short, long_):
        names = [name for name, _ in t.events]
        assert names == ["admit", "seat", "first_token", "exit"]
        walls = [w for _, w in t.events]
        assert walls == sorted(walls) and t.done_wall >= t.first_token_wall >= t.joined_wall
        assert t.occupancy_at_join in (1, 2) and t.kv_wait_s == 0.0


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_run_is_the_monolithic_path(models, paged):
    jcfg, jp, tcfg, tm = models
    reqs = _requests(jcfg.vocab_size, 3, seed=3)
    engine = _port_engine(tcfg, tm, 2, paged, slots=2)
    tickets = [engine.admit(_encode(jcfg, jp, ids, mask)[0], mask[0], limit, data=i)
               for i, (ids, mask, limit) in enumerate(reqs)]
    with torch.inference_mode():
        engine.run(tickets)
    assert all(t.done_wall is not None and t.tokens is not None for t in tickets)
    assert not engine.has_work()


def test_never_seatable_request_raises(models):
    """A request whose reservation exceeds the whole pool is refused at
    admit; one that fits still seats and completes."""
    jcfg, jp, tcfg, tm = models
    engine = _port_engine(tcfg, tm, 2, True, slots=2, pool_blocks=BLOCKS_PER_ROW + 1)
    ids = np.full((1, SRC_LEN), 7, np.int32)
    mask = np.ones((1, SRC_LEN), np.int32)
    enc = _encode(jcfg, jp, ids, mask)[0]
    with pytest.raises(decoding.KVPoolExhausted):
        engine.admit(enc, mask[0], tcfg.max_tgt_len, data="too-big")
    t = engine.admit(enc, mask[0], BLOCK_SIZE, data="fits")
    while engine.has_work():
        engine.step()
    assert t.done_wall is not None
    assert engine.kv_blocks_free == engine.kv_blocks_total


def test_full_pool_waits_fifo_and_stays_exact(models):
    """With free slots but no free blocks, requests wait in FIFO order (no
    smaller request overtakes the head), the wait is stamped, and every
    request still gives the reference engine's tokens."""
    jcfg, jp, tcfg, tm = models
    limits = [tcfg.max_tgt_len - 1, 2, tcfg.max_tgt_len - 1]
    rng = np.random.default_rng(21)
    reqs = [(rng.integers(4, jcfg.vocab_size, (1, SRC_LEN)).astype(np.int32),
             np.ones((1, SRC_LEN), np.int32), limit) for limit in limits]
    rows = [_encode(jcfg, jp, ids, mask)[0] for ids, mask, _ in reqs]
    engine = _port_engine(tcfg, tm, 1, True, slots=3, pool_blocks=BLOCKS_PER_ROW + 1)
    tickets = [engine.admit(rows[i], reqs[i][1][0], reqs[i][2], data=i) for i in range(3)]
    assert engine.occupancy == 1 and engine.backlog == 2
    assert tickets[1].kv_wait_start is not None and tickets[2].kv_wait_start is None
    order = []
    while engine.has_work():
        order.extend(t.data for t in engine.step())
        assert engine.occupancy <= 1
    assert order == [0, 1, 2]
    assert [name for name, _ in tickets[1].events][:3] == ["admit", "kv_wait", "seat"]
    want = jax_decoding.ContinuousBatcher(
        jax_s2s.make_positional_step(jp, jcfg),
        jax_s2s.make_paged_cache_factory(jcfg, block_size=BLOCK_SIZE,
                                         pool_blocks=BLOCKS_PER_ROW + 1),
        **_engine_kw(jcfg, 1, 3))
    want_tickets = [want.admit(rows[i], reqs[i][1][0], reqs[i][2], data=i) for i in range(3)]
    while want.has_work():
        want.step()
    for t, w in zip(tickets, want_tickets):
        assert t.tokens.tolist() == np.asarray(w.tokens).tolist() and t.steps == w.steps
    assert engine.kv_blocks_free == engine.kv_blocks_total


def test_released_blocks_are_reused(models):
    """More requests than slots: released blocks serve later seats, the free
    count stays in range, and the pool is whole after the drain."""
    jcfg, jp, tcfg, tm = models
    reqs = _requests(jcfg.vocab_size, 6, seed=11)
    engine = _port_engine(tcfg, tm, 1, True, slots=2)
    total = engine.kv_blocks_total
    assert total == 2 * BLOCKS_PER_ROW
    seen_blocks = set()
    for i, (ids, mask, limit) in enumerate(reqs):
        engine.admit(_encode(jcfg, jp, ids, mask)[0], mask[0], limit, data=i)
    done = []
    while engine.has_work():
        for blocks in engine._slot_blocks.values():
            seen_blocks.update(blocks)
        done.extend(engine.step())
        assert 0 <= engine.kv_blocks_free <= total
    assert len(done) == len(reqs) and engine.max_occupancy == 2
    assert 0 not in seen_blocks and seen_blocks <= set(range(1, total + 1))
    assert engine.kv_blocks_free == total


class _NoRepoint(decoding.ContinuousBatcher):
    """A planted fault: release returns a slot's blocks without pointing its
    rows at the trash block."""

    def _release_blocks(self, slot):
        ids = self._slot_blocks.pop(slot, None)
        if ids is not None:
            self._free_blocks.extend(ids)


def _sparse_arrivals(engine, rows, reqs, every=10):
    """One request arriving every ``every`` steps into 3 slots, so slots sit
    empty while blocks they released serve later requests."""
    tickets, i, ticks = [], 0, 0
    while i < len(reqs) or engine.has_work():
        if i < len(reqs) and ticks % every == 0:
            tickets.append(engine.admit(rows[i], reqs[i][1][0], reqs[i][2], data=i))
            i += 1
        engine.step()
        ticks += 1
    return [t.tokens[:t.limit].tolist() for t in tickets]


@pytest.mark.parametrize("vocab", [260, 12], ids=["bytes", "eos_heavy"])
def test_trash_block_repoint_is_what_keeps_reused_blocks_clean(vocab):
    """Releasing a slot's blocks without repointing its rows lets the empty
    slot's frozen rows write into blocks a later request holds: tokens must
    change. The engine as it is gives the dense engine's tokens."""
    jcfg, jp, tcfg, tm = _models(vocab)
    reqs = _requests(vocab, 16, seed=5)
    rows = [_encode(jcfg, jp, ids, mask)[0] for ids, mask, _ in reqs]
    kw = _engine_kw(tcfg, 1, 3)
    factory = seq2seq.make_paged_cache_factory(tcfg, block_size=BLOCK_SIZE)
    dense = _sparse_arrivals(_port_engine(tcfg, tm, 1, False), rows, reqs)
    paged = _sparse_arrivals(_port_engine(tcfg, tm, 1, True), rows, reqs)
    faulty = _sparse_arrivals(_NoRepoint(seq2seq.make_positional_step(tm), factory, **kw),
                              rows, reqs)
    assert paged == dense
    assert faulty != dense


def test_paged_step_needs_vector_positions(models):
    _, _, tcfg, tm = models
    caches = seq2seq.make_paged_cache_factory(tcfg, block_size=BLOCK_SIZE)(1)
    kv = seq2seq.cross_kv(tm, torch.zeros((1, SRC_LEN, tcfg.d_model)))
    with pytest.raises(ValueError, match="vector positions"):
        seq2seq._decode_step(tm, torch.tensor([BOS_ID]), 0, kv,
                             torch.ones((1, SRC_LEN), dtype=torch.int32), caches)


@pytest.mark.parametrize("kw,message", [
    ({"slots": 0}, "slots"), ({"num_beams": 0}, "num_beams"),
    ({"micro_steps": 0}, "micro_steps"), ({"cache_reorder": "swap"}, "cache_reorder"),
])
def test_engine_refuses_bad_arguments(models, kw, message):
    _, _, tcfg, tm = models
    args = _engine_kw(tcfg, 1, 2)
    args.update(kw)
    with pytest.raises(ValueError, match=message):
        decoding.ContinuousBatcher(seq2seq.make_positional_step(tm),
                                   seq2seq.make_cache_factory(tcfg), **args)


def test_paged_factory_sizes_and_refuses_a_pool_too_small(models):
    _, _, tcfg, _ = models
    caches = seq2seq.make_paged_cache_factory(tcfg, block_size=BLOCK_SIZE)(3)
    assert tuple(caches["table"].shape) == (3, BLOCKS_PER_ROW)
    assert caches["layers"][0]["k"].shape[0] == 3 * BLOCKS_PER_ROW + 1
    with pytest.raises(ValueError, match="cannot seat"):
        seq2seq.make_paged_cache_factory(tcfg, block_size=BLOCK_SIZE,
                                         pool_blocks=BLOCKS_PER_ROW)(1)
    with pytest.raises(ValueError, match="block_size"):
        seq2seq.make_paged_cache_factory(tcfg, block_size=0)


def test_ban_eos_before_rows_matches_the_reference():
    rng = np.random.default_rng(2)
    scores = rng.standard_normal((3, 2, 9)).astype(np.float32)
    pos = np.array([0, 3, 6], np.int32)
    for min_length in (0, 4, 7):
        want = np.asarray(jax_decoding._ban_eos_before_rows(
            jnp.asarray(scores), jnp.asarray(pos), min_length, EOS_ID))
        got = decoding._ban_eos_before_rows(torch.from_numpy(scores), torch.from_numpy(pos),
                                            min_length, EOS_ID).numpy()
        np.testing.assert_array_equal(got, want)
