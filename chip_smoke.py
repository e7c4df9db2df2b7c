#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (agent_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py              # one card
    python3 chip_smoke.py --cards 4    # phases 1, 2, the ring and meshes over 4 cards
                                       # (the encoder's and the decoders'), and
                                       # phase 18 (a), (b) with one process a card

Phases, one JSON line each; any failure raises and exits non-zero:

1. device   — CUDA present, an H100 SXM (compute capability (9, 0)),
              nvidia-smi's name and power limit.
2. build    — nvcc builds every kernel of the paths from csrc/ (sm_90a),
              all sources at once; for each of the 12 flash_fwd_sm90
              instantiations (serving, training with lse, the ring's fold
              and T5's, at d_head 32, 64 and 128) and the 6 flash_bwd_*_sm90
              ones (the bf16 dQ and dK/dV), cuobjdump's SASS must hold
              HGMMA (wgmma) and UTMALDG (TMA loads), printed beside ptxas'
              registers, spills and shared memory; no kernel may hold HMMA
              (mma.sync) and none may be the old flash_fwd_bf16.
3. kernels vs plain — each kernel's wrapper on the card against its plain
              PyTorch version. The serving forward: at the shapes and key
              lengths that the requests of phases 4 and 5 stage (taken from
              the op's own stage phase), and at edge cases (among them Lq
              257 with Lk 129 around the 128-row block, Lq 1, a shared
              mask at d_head 128); two planted
              faults (the first key tile dropped, the score scale 10 % off)
              must fail the same check; non-contiguous inputs must give the
              contiguous result, and the launcher must refuse what the
              kernel does not take. The training kernels (forward with lse,
              dQ, which also computes delta = rowsum(dO * O), and dK/dV):
              o, lse, delta, dq, dk and dv at phase 6's batch shape and key
              lengths and at edge cases (ragged and Lq != Lk, Lq = 1, a row
              with no key, a shared mask, d_head 32 and 128); a backward that
              drops the first key tile, a dq with its scale 10 % off and a
              backward with delta zeroed must fail.
              The ring's fold kernel: m, l and acc after two hops, the
              second from carried state, at the shard shape and key lengths
              of phase 5b and at edge cases (a wholly masked block after a
              real one, bit-exact, at d_head 64 and 128, a row with no key
              anywhere, ragged Lq != Lk, Lq 257 with Lk 129, Lq 1, d_head
              32 and 64, a shared mask at d_head 128, a second block whose
              first tile raises every row's max, f32); a fold that ignores
              the carried state, one that drops the first key tile and one
              that skips tile 0's correction of the carried acc must fail;
              the launcher must refuse
              f16, misshapen, non-contiguous and CPU state. The T5 kernel:
              at phase 9's staged shape and key lengths and at edge cases
              (causal, ragged Lq != Lk, a row with no key, d_head 32 and
              128, f32, 32 buckets with max distance 256); the relative
              position reversed and the bias of head h + 1 must fail; the
              launcher must refuse CPU, f16 and misshapen inputs. The
              serving kernel's cases include phase 8's staged shapes and
              the first shards of phase 10 (B 8192, L 48, d_head 64 and
              the seq2seq's 32), and phases 11 and 12's staged requests
              (BERT-base's, and the BART encoder's B 64, H 16, L 1024), and
              phase 13's serving prefills (d_head 32: one admit batch B 8
              and the whole stream B 240 at L 64, the agent's jobs, the
              disaggregated mix's buckets); the fold's include phase 11's
              sp = 2 shard.
4. main path — map_classify_tpu through the op registry at BERT-base width
              (d_model 768, 12 heads, 12 layers, d_ff 3072, max_len 512;
              random weights from the model id): one text, 64 mixed-length
              rows, 256 rows of ~500 bytes, one 100-id input. Every request
              must run on cuda and launch the flash kernel once per layer;
              the 256-row request's profile must show the TMA + wgmma
              forward once per layer and no other attention kernel (as
              must phases 5, 5b and 8's, the fold's variant on the ring).
              The 64-row request is re-run asking for every class, with the
              kernel and with the plain attention swapped in, and the
              log-probabilities compared; the planted tile drop must fail
              that comparison. A small f32 model is checked against the
              same op on the CPU.
5. long context — d_model 512, 4 heads (d_head 128), max_len 4096: 8 rows
              of 3000-4096 bytes; p50 and one profiled request.
5b. ring    — the same request on an sp = 2 mesh whose two shards share the
              card (TorchRuntime(devices=["cuda:0"] * 2, mesh_shape={"sp":
              2})): ring attention in every layer, n_layers x sp^2 fold
              launches a request and no other attention. Log-probabilities
              of every class against the one-card run and against the ring
              with the plain fold (the planted state reset must fail); the
              same at sp = 4; a small f32 model at sp = 2 on the card
              against two CPU shards. The shards share one card, so the
              rotation copies nothing: the times show sp^2 folds and no
              communication.
6. train    — train_classifier through the op registry at BERT-base width:
              256 keyword rows of ~500 bytes (L 512), batch 128, 3 epochs.
              Every epoch loss finite; each training kernel launched once
              per layer per step and no dense attention; the artifact
              served by map_classify_tpu on cuda. Then the train step alone:
              p50 of 5 steps after 2 warm-ups, examples/s, peak memory,
              device time by kind of kernel (the profile must show the
              TMA + wgmma forward, dQ and dK/dV kernels once per layer and no
              other attention kernel); one step's gradients with the
              kernels against the plain trainable attention, leaf by leaf
              (the planted tile drop must fail); a small f32 model trained
              by the op on the card and on the CPU, losses compared.
8. summarize — map_summarize through the op registry with the in-house
              seq2seq at its defaults (d_model 256, 8 heads, 4 + 4 layers,
              d_ff 1024, vocab 260, bf16; random weights from the model
              id), bench.py's summarize leg: 256 rows of "a document to
              compress " * 20 with max_length 32, greedy, then 64 of them
              with 4 beams. Every request on cuda, the serving kernel once
              per encoder layer and no dense attention on the encoder; p50
              ms and emitted tokens/s. A small f32 config gives the same
              summaries on the card as on the CPU.
9. T5-large — a checkpoint directory with t5-large's published config.json
              and random weights from a seeded generator at HF T5's
              initialisation scales (bf16, not pretrained), served by the
              op's device phase (the family resolved from model_path,
              weights read by load_hf_dir) on ids staged with the op's
              bucketing (the text step needs spiece.model): 64 rows of
              384-512 ids, 32 new tokens greedy, then 8 rows with 4 beams.
              The T5 kernel runs once per encoder layer (24) and nothing
              takes the dense T5 path. Teacher-forced log-probabilities on
              the kernel's encoder output against the plain T5 attention's,
              and the planted reversed relative position against both; a
              small f32 T5 (gated-gelu, untied) gives the same tokens on
              the card as on the CPU. p50 ms, tokens/s, peak memory and
              device time by kind.
10. drain   — the port as a swarm worker: a stand-in controller in this
              script (the protocol of agent_tpu/agent/app.py on
              127.0.0.1) shards bench.py's 65,536-row CSV into 8 classify
              shards of 8,192 rows at BERT-base width; the port's Agent,
              in this process with its default urllib session and the
              pipelined runner (PIPELINE_DEPTH 2), drains them after one
              warm-up shard of each op. Every result ok on cuda with no
              fallback, each shard posted once over the b1 wire, n_rows
              summing to 65,536, row 1 launched n_layers times a dispatch
              chunk, and the decoded indices and scores equal to the same
              shards run serially through the op, bit for bit; wall,
              rows/s, both against the serial run, the staging pool's
              workers and the p50 of each phase (per-shard fetch_ms beside
              device_ms). One more shard profiled (the device's idle
              share); one risk_accumulate shard of 65,536 values on the
              card against the host path; a mixed drain of 2 summarize
              shards (the default seq2seq, 32 tokens) and 2 classify
              shards, summaries equal to the op's. Then
              `python -m agent_tpu_torch.agent.app` in a process of its
              own (TASKS=echo,read_csv_shard,map_classify_tpu, BERT-base
              cut to 2 layers) drains one echo, one read_csv_shard and two
              256-row shards; SIGUSR1 must dump its flight recorder (with
              the lease events) into FLIGHT_RECORDER_DIR, and it must exit 0
              on SIGTERM, and 2 with TASKS=none. Phase 15 runs between the
              drains and the entry point.
15. telemetry — the agent's spans, usage stamps, gauges, captures, flight
              recorder and failover list on phase 10's stand-in controller
              (which mints the reference controller's trace context on
              every task and collects the spans, capture records and obs
              snapshots), its 8 shards and the BERT-base weights on the
              card, through the pipelined agent (PIPELINE_DEPTH 2). The
              shards drain with TRACE_ENABLED=0 (no span may be shipped),
              then traced with PROFILE_DIR set (PROFILE_TASKS 1) and a
              profile_capture alert for map_classify_tpu on the first
              lease. Every shard's trace assembles with the port's
              trace.assemble into one complete tree, stage, queue, execute
              and post once each under the stand-in's lease span, and the
              Chrome export of all spans validates; Σ usage.device_s equals
              the device_busy_seconds_total the agent shipped within 1 %,
              chips is 1, Σ usage.flops equals Σ encoder_fwd_flops of the
              staged shapes and every host_s is > 0; device_mfu (printed
              beside the peak used, the card's name and power limit) and
              device_duty_cycle lie in (0, 1]; device_hbm_bytes{device="0"}
              has used, peak and limit, the limit within 1 % of
              mem_get_info's total; the PROFILE_DIR trace and the capture's
              artifact (its completion record reached the stand-in) each
              hold a flash_fwd_sm90 kernel event (traced printed beside
              launched, not required equal). One more shard whose lease
              carries an slo_page alert: one recorder dump, holding the lease
              and posted events of the traced shards. One shard through an
              agent whose CONTROLLER_URLS lists a dead local port first: one
              failover and its recorder event. Every result equals phase
              10's serial run bit for bit; rows/s traced over untraced is
              printed, not gated.
11. bert    — a checkpoint directory with bert-base-uncased's published
              config.json (a two-label head, as fine-tuned checkpoints ship
              it), a synthetic 30,522-line vocab.txt and random weights from
              a seeded generator (std 0.02, f32; not pretrained), served by
              map_classify_tpu through the registry with model_path: 256
              texts of 20-120 words, one text cut at 512 wordpieces and one
              8,192-row shard of phase 10's CSV. Row 1 once per layer a
              dispatch chunk, and the profile's forward the TMA + wgmma
              kernel alone; every class against the plain attention on the
              card; the 256-row request on an sp = 2 ring on the one card
              (the fold in every hop: n_layers x 4 launches) against one
              device; the same weights as model.safetensors alone, read by
              the port's reader, give the same results. p50 ms, rows/s, the
              idle share and device ms by kind of kernel.
12. bart    — a checkpoint directory with facebook/bart-large-cnn's
              published config.json, a synthetic byte-level vocab.json and
              merges.txt (the 256 byte symbols, 4,000 merges) and random
              weights from a seeded generator (std 0.02, bf16): map_summarize
              through the op's phases with model_path, 64 rows of 600-1000
              BPE tokens with 32 new tokens greedy, then 8 rows with 4 beams
              and min_length 8. Row 1 once per encoder layer a request;
              every row starts with the forced bos, every row that reaches
              the last step ends in the forced eos, none has an EOS before
              min_length; teacher-forced log-probabilities of the first 8
              rows on the kernel's encoder output against the plain
              attention's (bf16); those rows' greedy tokens in f32 with the
              kernel equal to the plain attention's. p50 ms, emitted
              tokens/s and the idle share.
13. serving — continuous batching (models/decoding.ContinuousBatcher) at
              the seq2seq defaults (bf16, the default model id's weights):
              bench.py's serving stream (240 requests of 64 ids, 90 % with a
              budget of 4 tokens and 10 % of 130, seed 5) prefilled as one
              batch (row 1 once per encoder layer), then decoded by the
              static path (arrival-order batches of 8 through
              greedy_generate / beam_generate, each to its longest budget)
              and by one persistent paged engine with 8 slots: tok/s of the
              requested tokens, the speedup, steps, mean occupancy, KV
              blocks at the end and a profiled stretch of 50 engine steps,
              greedy and with 4 beams; greedy again at 64 slots. A small f32
              model (SMALL_S2S_F32): 32 requests joining one every 8 steps
              into 4 slots give each request's solo greedy_generate /
              beam_generate tokens (dense and paged), the CPU engine's tokens,
              and other tokens with the trash-block repoint planted away.
              serve_summarize jobs of 8-32 requests through the port's
              pipelined agent against the stand-in controller (one shared
              engine; row 1 4 times a job) equal to the op run serially; TTFT
              p50/p95 and the occupancy gauge. bench.py's disaggregated mix
              (32 requests over 4 documents, every 4th a one-off) as
              serve_prefill (b1 results) -> serve_decode through the agent
              after a warm round: prefix hit rate >= 0.5, row 1 4 times a
              prefill with a miss and never in a decode, results equal to
              the colocated op. summarize_encode -> summarize_decode on 64
              rows equal to map_summarize's greedy summaries (row 1 4 times,
              then 0). serve_classify at BERT-base width (run after phase 4,
              while its weights are on the card): row 1 12 times, answers
              equal to map_classify_tpu's.
14. quant and MoE — quantized serving (models/quant.py: int8 W8A8
              through torch._int_mm, w8a16 weight only) and the Switch MoE
              encoder (models/moe.py), each seeded encoder drawn once on the
              host and placed in all its modes (place_seeded). BERT-base
              classify (bench.py's bert_base_int8 leg: 256 rows of 480
              bytes) in bf16, int8 and w8a16 in turns: rows/s, the ratio to
              bf16, top-1 agreement with bf16 over 5,120 rows of bench.py's
              keyword texts, held to the f32 control's agreement less 0.02,
              the resident weight bytes, row 1 n_layers times a request in
              every mode; one int8 request of one 8-byte text ([1, 16]
              staged: _int_mm's 16-row case), its top-1 equal to bf16's. The
              MoE encoder at BERT-base width and depth with 8 experts: the
              256-row request in bf16 and int8 (agreement held as above),
              and the train step at phase 6's batch (128 x L 512), 3 timed
              steps with rows 4-6 each 12 times a step, the aux loss before
              and after; a small f32 MoE on the card against the CPU
              (logits, aux loss, every gradient, 3 steps' losses within
              1e-4). Phase 8's
              requests in w8a16 against bf16, and greedy token agreement on
              1,024 rows of random ids with the f32 control; phase 9's T5-large
              greedy request (row 3 24 times a request) and 8 rows of phase
              12's BART greedy request, each in w8a16 against bf16; phase
              13's stream through a paged engine of 8 slots in bf16 and
              w8a16; the small f32 model in int8 and w8a16 through the engine
              (4 slots: 4-row W8A8 decode steps), the card's tokens equal to
              the CPU engine's.
16. meshes  — dp, tp, pp and ep in one process, every shard on the one card
              (TorchRuntime(devices=["cuda:0"] * N, mesh_shape=...)), from
              phase 14's host draws of the BERT-base encoders and phase 11's
              checkpoint. Serving: phase 4's 256-row request on tp 2, dp 2 ×
              tp 2, pp 2 (2 microbatches), model_config pp 2 on dp 2, int8
              and w8a16 on tp 2, the 8-expert MoE on ep 2 and on dp 2 × ep 4,
              and BERT on tp 2, each in turns with the same request on one
              device: rows/s and its ratio, top-1 equal but for bf16 ties and
              probabilities within 1e-3, row 1 n_layers × tp × dp times a
              request (n_layers × microbatches on pp); the tp 2 request's
              profile shows the TMA + wgmma forward alone, 24 times, and each
              tp shard's split block weights are half the one-device bytes.
              A small f32 model on every float mesh (and w8a16 on tp 2) of
              the card against the op on the CPU within 1e-5. The ring:
              phase 5's request on dp 2 × sp 2 and tp 2 × sp 2 against one
              device, the fold n_layers × sp² times in each (dp, tp) group.
              Training on dp 2 × tp 2: phase 6's first batch at BERT-base
              width, 3 timed steps (rows 4-6 each n_layers × 4 times a
              step), the p50 beside phase 6's; a small f32 step's loss and
              every gradient against the CPU within 1e-5; train_classifier
              on the mesh, its gathered .npz served on one device as on the
              CPU. risk_accumulate on dp 4 over 1,048,576 f64 values with
              subnormals, then with an overflow: count, min and max equal to
              one device, the sum within n · 2⁻²⁴ Σ|v| (inf with the
              overflow). Planted faults that must fail: a tp sum dropping
              shard 1's partial, a row-parallel bias added on every shard,
              a pp schedule skipping stage 1, an ep dispatch sending expert
              1's slots to shard 0's weights, a W8A8 row scale from one
              shard. No attention call may run unsharded.
17. decoder meshes — the decoder families on dp and tp, every shard on the
              one card, from phases 9 and 12's checkpoints and staged
              requests (models/sharded_decoder.py: rows over dp, heads, FFN
              columns and the vocabulary over tp, each tp shard's KV cache
              its heads; the decode loop on the first device). Each request
              once warm beside one device's. T5-large: phase 9's greedy and
              beam requests on tp 2 and dp 2 × tp 2, row 3 24 × tp × dp
              times a request, the greedy tokens' share equal to one
              device's, teacher-forced log-probabilities of one device's
              greedy tokens within LOGP_TOL (bf16); with both relative bias
              tables redrawn at T5_FAULT_BIAS_STD, tp 2 within it too, and
              outside it with each shard given the next shard's bias head
              columns (planted). BART-large-cnn: phase 12's 64-row greedy
              request on tp 2 (row 1 12 × 2 times), log-probabilities of
              its first rows within LOGP_TOL. The seq2seq at its defaults:
              phase 8's requests on dp 2 × tp 2 (row 1 4 × 4 times), the
              greedy one on tp 2 × sp 2 (row 2 4 × 4 times a tp group),
              SMALL_S2S_F32 on tp 2 of the card equal to the CPU op's
              summaries, each tp shard's split decoder-block bytes half of
              one device's, the greedy request on tp 2 profiled (row 1
              alone); int8, w8a16 and float on tp 2 over 32 random
              texts in f32 and bf16 compute, each mode's token share equal
              to one device's at least the float control's less 0.02.
              Serving on tp 2: phase 13's stream
              prefilled on the mesh and decoded by a paged engine of 8
              slots in bf16 (tok/s beside phase 13's), each shard's pool
              half the one-device pool's bytes, its first 64 requests in
              f32 with one device's tokens; serve_summarize twice with one
              prompt, the second from the prefix cache. summarize_encode on
              tp 2 then summarize_decode on dp 2 × tp 2 (f32): the
              one-device split's summaries. Neither the unsharded nor the
              dense-T5 counter may move.
18. processes — several processes on the card. (a) Two processes of
              `python -m agent_tpu_torch.agent.app` joined by
              COORDINATOR_ADDRESS on a free local port (runtime/distributed.py:
              gloo on host tensors), both on cuda:0 (under --cards N, N of
              them, one a card): the leader drains 3 echo, 1 map_tokenize and a
              risk_accumulate of 1,048,576 values from the seed over the
              cross-process dp 2 mesh from the stand-in; the sum within n ·
              2⁻²⁴ Σ|v| of math.fsum and bit-equal to one process's dp 2 mesh,
              min and max the f32 rounding of the exact extremes, the
              follower's tasks_done 5, both exit 0 once the leader has SIGTERM
              (a process alive at the deadline fails); a planted follower that
              drops an echo must fail the check. Each task's stage span (the
              broadcast) is printed. (b) spawn_fleet(device_count(),
              platform="cuda"): each member warmed on one BERT-base request
              (AGENT_WARM_FILE), ready by wait_for_agents over the stand-in's
              GET /v1/status, drains phase 10's 65,536-row CSV; results equal
              to phase 10's serial run bit for bit, each member's row-1 launch
              counter (its pushed kernel_launches gauge) moved; rows/s beside
              phase 10's. Run after phase 10's entry point. (c) After phase
              16: its tp 2 BERT-base encoder (phase 14's draw) saved with
              models/checkpoint.save_sharded, restored over zeroed weights
              onto tp 2, dp 2 × tp 2 and one device, each serving phase 4's
              256-row request: on tp 2 every leaf and probability bitwise the
              saved model's (a leaf nudged one ulp must fail), elsewhere within
              MESH_PROB_TOL; bytes written, save and load ms.
7. kernels  — per kernel: launches on its path, error against plain,
              kernel / plain / library times and the card's bound, and its
              design (all TMA + wgmma); each kernel timed through
              its launcher, its inputs built outside the timing (the fold
              at phase 5b's shard shape: launches over its timed requests;
              the T5 kernel at phase 9's staged shape with its per-distance
              table built once, launches over its requests, the entry
              point's time beside it). Printed after phases 8-17; row 1's
              launches by path include phases 10-17, and its entry holds
              three more: at phase 12's encoder shape, at phase 13's
              stream prefill (B 240, H 8, L 64, D 32) and at the BART
              encoder's tp 2 shard (B 64, H 8, L 1024, D 64); the T5
              kernel's one more at T5-large's tp 2 shard (B 64, H 8, L 512,
              D 64); the launches by path of rows 1-3 include phase 17's
              paths, each counted where it launched; the fold's include
              phase 11's ring and phase 16's; row 1's phase 18's fleet members
              (from their metrics) and restored checkpoints.

The line before the last is nvidia-smi's "name, power.limit"; the last line
is {"ok": true, "device": {...}}. Without CUDA it exits 2 and prints no
result.
"""

from __future__ import annotations

import gc
import json
import math
import os
import random
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

SEED = 1234
BERT_BASE = {"d_model": 768, "n_heads": 12, "n_layers": 12, "d_ff": 3072, "max_len": 512}
LONG_CTX = {"d_model": 512, "n_heads": 4, "max_len": 4096}
SMALL_F32 = {"d_model": 128, "n_heads": 2, "n_layers": 2, "d_ff": 256, "max_len": 128,
             "n_classes": 50, "dtype": "float32"}
REPS = 5  # timed repetitions of each main-path request, after one warm-up
# Phase 6: the two keyword "languages" of tests/test_train_lifecycle.py:11-14.
TRAIN_WORDS = {
    0: ["invoice", "payment", "ledger", "account", "balance"],
    1: ["sensor", "voltage", "telemetry", "actuator", "signal"],
}
LONG_LAYERS = 4  # EncoderConfig's default depth, which LONG_CTX keeps
SP, SP_WIDE = 2, 4  # phase 5b's ring sizes
CARD = "cuda:0"  # the device every shard of phase 5b's rings lists
TRAIN = {"batch_size": 128, "epochs": 3, "seed": 0}  # bench.py's train leg: batch 128, L 512
TRAIN_ROWS = 256
TIMED_STEPS, WARM_STEPS = 5, 2  # bench.py:488-510
SMALL_TRAIN_F32 = {"d_model": 64, "n_heads": 2, "n_layers": 2, "d_ff": 128, "max_len": 64,
                   "dtype": "float32"}
SMALL_TRAIN = {"epochs": 10, "batch_size": 32, "learning_rate": 1e-2, "seed": 1}

# Phase 8: bench.py's summarize leg (SUMMARIZE_BATCH, SUMMARIZE_MAX_NEW and
# its text) on Seq2SeqConfig's defaults, greedy and with 4 beams.
S2S_TEXT = "a document to compress " * 20
S2S_ROWS, S2S_BEAM_ROWS, S2S_MAX_NEW, S2S_BEAMS = 256, 64, 32, 4
S2S_ENC_LAYERS = 4  # Seq2SeqConfig's n_enc_layers
SMALL_S2S_F32 = {"d_model": 128, "n_heads": 4, "n_enc_layers": 2, "n_dec_layers": 2,
                 "d_ff": 256, "max_src_len": 256, "max_tgt_len": 32, "dtype": "float32"}
# Phase 9: google-t5/t5-large's published config.json (the fields the
# model reads).
T5_LARGE = {"model_type": "t5", "vocab_size": 32128, "d_model": 1024, "d_kv": 64,
            "num_heads": 16, "num_layers": 24, "num_decoder_layers": 24, "d_ff": 4096,
            "feed_forward_proj": "relu", "relative_attention_num_buckets": 32,
            "relative_attention_max_distance": 128, "tie_word_embeddings": True,
            "pad_token_id": 0, "eos_token_id": 1, "decoder_start_token_id": 0,
            "layer_norm_epsilon": 1e-6}
SMALL_T5_F32 = dict(T5_LARGE, vocab_size=512, d_model=128, d_kv=32, num_heads=4, num_layers=2,
                    num_decoder_layers=2, d_ff=256, feed_forward_proj="gated-gelu",
                    tie_word_embeddings=False)
T5_ROWS, T5_BEAM_ROWS, T5_MAX_NEW, T5_BEAMS = 64, 8, 32, 4
T5_LENGTHS = (384, 512)  # ids a row, EOS included: all in the 512 bucket
# The reversed-position fault moves the log-probabilities only by as much
# as bf16 rounding does when the relative bias tables are drawn at HF's
# initialisation scale (d_model^-1/2, small beside scores of order 1); with
# both tables redrawn at this standard deviation, of the order of the
# scores, it must fail the comparison.
T5_FAULT_BIAS_STD = 1.0
# Phase 10: bench.py's drain (DRAIN_ROWS, DRAIN_SHARD_SIZE and its rows,
# bench.py:92-94, :892-896): a 65,536-row CSV in shards of 8,192 through the
# port's agent at BERT-base width, then two 8,192-row summarize shards
# (DRAIN_SUMMARIZE_SHARD) with the default seq2seq, 32 new tokens.
DRAIN_ROWS, DRAIN_SHARD = 65_536, 8192
DRAIN_S2S_SHARDS = 2
DRAIN_RISK_VALUES = 65_536
DRAIN_TIMEOUT_S = 600
# The entry point's own process: two 256-row classify shards at BERT-base
# width with the depth cut to 2 (its weights are built anew in that process).
ENTRY_SHARD, ENTRY_LAYERS = 256, 2

# Kernel vs plain: the reference's elementwise tolerances
# (tests/test_flash_attention.py:30, :94), and a bound on the largest error
# relative to the largest output. One bf16 ulp of any output is at most
# 2^-7 (7.8e-3) of the largest, so 1e-2 admits one rounding flip and no
# more; f32 kernels and plain versions differ only in summation order.
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
REL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# Op vs op: the largest difference in any class's log-probability, and the
# reference's 2e-2 on scores (probabilities).
LOGP_TOL = {"bfloat16": 0.1, "float32": 1e-4}
SCORE_TOL = 2e-2
DROP_TILE = 64  # keys in the tile that the planted fault drops
# One train step's gradients, kernels against the plain trainable attention,
# leaf by leaf in relative L2 (|g_kernel - g_plain| / |g_plain|). Both
# round p, ds and o to bf16 at the same places, so they differ only where
# an f32 sum in another order lands a value on the other side of a bf16
# rounding boundary. How far that moves a leaf depends on the leaf: softmax
# is shift-invariant (sum_k ds = 0), so the q and k projections' gradients
# are small differences of large terms and carry most of bf16's noise
# (phase 6 reports it per kind of leaf: on an H100 at BERT-base width and
# 65k tokens, about 0.1 for wq/wk and under 1e-2 for the rest). So each
# leaf is held against the noise of a second valid evaluation measured in
# the same run, the plain attention with 32-key tiles (which moves every
# rounding point of P): a leaf passes within GRAD_NOISE_FACTOR times that
# spread, or within GRAD_REL_L2_FLOOR where the spread is smaller.
GRAD_NOISE_FACTOR = 2.0
GRAD_REL_L2_FLOOR = 1e-2
# The small f32 model trained on the card and on the CPU: every epoch loss
# within 1e-3 relative. f32 sums in another order drift apart step by step
# under AdamW; tests/test_torch_train_classifier.py holds the port to the
# JAX package on one CPU within the same 1e-3 after the same 40 steps.
TRAIN_F32_REL_TOL = 1e-3

# Phase 11: google-bert/bert-base-uncased's published config.json, with a
# two-label head as a fine-tuned checkpoint ships it (num_labels, id2label).
BERT_BASE_UNCASED = {"model_type": "bert", "architectures": ["BertForSequenceClassification"],
                     "vocab_size": 30522, "hidden_size": 768, "num_hidden_layers": 12,
                     "num_attention_heads": 12, "intermediate_size": 3072,
                     "max_position_embeddings": 512, "type_vocab_size": 2,
                     "layer_norm_eps": 1e-12, "hidden_act": "gelu", "initializer_range": 0.02,
                     "pad_token_id": 0, "num_labels": 2,
                     "id2label": {"0": "LABEL_0", "1": "LABEL_1"}}
BERT_ROWS, BERT_WORDS, BERT_LONG_PIECES = 256, (20, 120), 512
BERT_SP = 2
# Phase 12: facebook/bart-large-cnn's published config.json (the fields the
# model reads, and its generation defaults).
BART_LARGE_CNN = {"model_type": "bart", "architectures": ["BartForConditionalGeneration"],
                  "vocab_size": 50264, "d_model": 1024, "encoder_layers": 12,
                  "decoder_layers": 12, "encoder_attention_heads": 16,
                  "decoder_attention_heads": 16, "encoder_ffn_dim": 4096,
                  "decoder_ffn_dim": 4096, "max_position_embeddings": 1024,
                  "activation_function": "gelu", "init_std": 0.02, "scale_embedding": False,
                  "pad_token_id": 1, "bos_token_id": 0, "eos_token_id": 2,
                  "decoder_start_token_id": 2, "forced_bos_token_id": 0,
                  "forced_eos_token_id": 2, "num_beams": 4, "length_penalty": 2.0,
                  "min_length": 56, "max_length": 142}
BART_ROWS, BART_BEAM_ROWS, BART_MAX_NEW, BART_BEAMS, BART_MIN_LENGTH = 64, 8, 32, 4, 8
BART_TOKENS, BART_MERGES = (600, 1000), 4000
BART_CHECK_ROWS = 8  # rows whose f32 tokens are compared, kernel vs plain
# Phase 13: bench.py's serving leg (bench.py:1376-1392, _bench_serving_beam):
# 240 requests of 64 source ids, a budget of T // 32 tokens with probability
# 0.9 and T (max_tgt_len 130) otherwise, seed 5, 8 slots, greedy and 4
# beams, micro_steps 1; greedy again at 64 slots. Then the agent's jobs of
# 8-32 requests, and the disaggregated mix (SERVE_DISAGG_REQUESTS over
# SERVE_DISAGG_DOCS) with ServeConfig's buckets and batch cap.
SERVE_REQUESTS, SERVE_SRC, SERVE_SLOTS, SERVE_WIDE_SLOTS, SERVE_BEAMS = 240, 64, 8, 64, 4
SERVE_SHORT_FRAC, SERVE_SEED = 0.9, 5
SERVE_WARM = 8  # requests of each side's warm-up pass
SERVE_PROFILE_STEPS = 50
SERVE_EXACT_REQUESTS = 32
SERVE_EXACT_EVERY = 8  # steps between arrivals: slots sit empty, blocks are reused
SERVE_AGENT_JOBS = (8, 16, 24, 32)
DISAGG_REQUESTS, DISAGG_DOCS = 32, 4
SERVE_LEN_BUCKETS, SERVE_MAX_BATCH = (64, 128, 256, 512, 1024), 16
MPMD_ROWS = 64
SERVE_MODEL: dict = {}  # Seq2SeqConfig overrides of phase 13 (none: the defaults)

# Phase 14: quantized serving and the Switch MoE encoder. bench.py's
# bert_base_int8 leg (BERT_CONFIG, text_len 480; top-1 agreement with bf16
# over AGREEMENT_ROWS rows of its keyword texts, sent in requests of
# AGREEMENT_CHUNK rows to bound the W8A8 activations' f32 copies) and its
# moe leg (8 experts at BERT-base width), the MoE trained at phase 6's batch
# (128 x L 512) for MOE_TRAIN_STEPS timed steps; summarize_w8a16's requests
# (phase 8's), decode agreement on DECODE_AGREEMENT_ROWS rows of random ids
# against bf16 with the f32 control; T5-large and BART w8a16 greedy on phase
# 9 and 12's checkpoints; the continuous engine on phase 13's stream.
QUANT_MODES = ("int8", "w8a16")
QUANT_ROWS, QUANT_TEXT_LEN = 256, 480
AGREEMENT_ROWS, AGREEMENT_CHUNK = 5120, 512
AGREEMENT_WORDS = ["alpha", "risk", "ledger", "breach", "routine", "audit", "wire", "flag",
                   "normal", "urgent", "invoice", "metric"]
W8A8_SMALL_TEXT = "tiny row"  # one row of 8 bytes: a staged [1, 16] -> 16 rows of _int_mm
MOE_EXPERTS, MOE_TRAIN_STEPS = 8, 3
# A quantized mode's top-1 agreement with bf16 may fall this far below the
# f32 control's (the same weights and rows in f32 against bf16).
AGREEMENT_SLACK = 0.02
# The MoE's card-vs-CPU check at f32: phase 6's small training config with
# 4 experts, 16 rows of L 64 (two routing groups of 512 tokens).
MOE_F32 = dict(SMALL_TRAIN_F32, moe_experts=4)
MOE_F32_ROWS, MOE_F32_STEPS, MOE_F32_REL_TOL = 16, 3, 1e-4
DECODE_AGREEMENT_ROWS, DECODE_AGREEMENT_SRC = 1024, 64
QUANT_REPS = 3  # timed repetitions of each phase-14 request, after one warm-up
BART_QUANT_ROWS = 8

# NVIDIA's data sheet for the H100 SXM, dense, at the full 700 W limit.
HBM_BYTES_PER_S, BF16_FLOPS = 3.35e12, 989e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attn_inputs(B, H, Lq, Lk, D, dtype, lengths, seed=0):
    """Random q, k, v on the card and a key-padding mask [len(lengths), 1, 1,
    Lk] (one length = a mask shared by the batch; 0 = a row with no key)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v = (torch.randn(B, H, L, D, generator=g).to(CARD, dtype)
               for L in (Lq, Lk, Lk))
    mask = (torch.arange(Lk)[None, :] < torch.as_tensor(lengths)[:, None]).to(torch.int32)
    return q, k, v, mask[:, None, None, :].to(CARD)


def drop_first_tile(mask: torch.Tensor) -> torch.Tensor:
    """Planted fault: the first key tile masked out, as a kernel whose tile
    loop started one tile late would compute."""
    out = mask.clone()
    out[..., :DROP_TILE] = 0
    return out


def compare(got: torch.Tensor, want: torch.Tensor, dtype) -> tuple:
    """(ok, max |Δ|, max |Δ| / max |want|) under TOL and REL_TOL."""
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item()
    rel = err / max(w.abs().max().item(), 1e-30)
    ok = (bool(torch.isfinite(got).all()) and rel <= REL_TOL[dtype]
          and torch.allclose(g, w, rtol=TOL[dtype], atol=TOL[dtype]))
    return ok, err, rel


EDGE_CASES = [
    # name, (B, H, Lq, Lk, D), key lengths (one = shared mask; 0 = no key)
    ("d32_L48", (3, 8, 48, 48, 32), [48, 20, 1]),
    ("d128_L768", (2, 4, 768, 768, 128), [768, 300]),
    ("lq_ne_lk", (2, 4, 16, 768, 64), [700, 5]),
    ("shared_mask", (4, 4, 100, 48, 64), [40]),
    ("dead_row", (3, 4, 48, 48, 64), [48, 0, 30]),
    ("ragged", (2, 3, 77, 131, 32), [131, 64]),
    ("one_tile", (2, 2, 16, 16, 128), [16, 9]),
    # Lq past a 128-row block, Lk one key past a 128-key block whose last
    # real key is 128; one query row; a mask the batch shares at d_head 128.
    ("lq257_lk129", (2, 3, 257, 129, 64), [129, 100]),
    ("lq1", (2, 3, 1, 77, 64), [77, 5]),
    ("shared_mask_d128", (2, 4, 300, 300, 128), [250]),
]


def staged_cases(classify, requests) -> list:
    """The kernel's shapes and key lengths on the main path: every dispatch
    chunk of every request, as the op's stage phase builds it."""
    cases = []
    for name, payload, _ in requests:
        phase, state = classify.stage(dict(payload))
        if phase != "staged":
            raise SystemExit(f"{name} did not stage: {state}")
        cfg = state["cfg"]
        heads = getattr(cfg, "n_heads", None) or cfg.num_heads  # BERT's names
        width = getattr(cfg, "d_model", None) or cfg.hidden_size
        for ids, lengths, _ in state["chunks"]:
            B, L = ids.shape
            cases.append((f"{name}/B{B}xL{L}", (B, heads, L, L, width // heads),
                          lengths, cfg.compute_dtype))
    return cases


def check_kernels(fa, main_cases) -> dict:
    """Phase 3: the CUDA kernel against its plain version on the card."""
    cases = [(n, s, ln, dt) for n, s, ln in EDGE_CASES
             for dt in (torch.bfloat16, torch.float32)] + main_cases
    results, inputs = [], {}
    for i, (name, (B, H, Lq, Lk, D), lengths, dtype) in enumerate(cases):
        q, k, v, mask = attn_inputs(B, H, Lq, Lk, D, dtype, lengths, seed=i)
        got = fa.flash_attention(q, k, v, mask)
        want = fa.flash_attention_reference(q, k, v, mask)
        ok, err, rel = compare(got, want, dtype)
        if len(lengths) == B:
            dead = torch.as_tensor(np.asarray(lengths) == 0, device=got.device)
            ok = ok and bool((got[dead] == 0).all())
        faults = {
            "drop_first_tile": fa.flash_attention_reference(q, k, v, drop_first_tile(mask)),
            "scale_x1.1": fa.flash_attention_reference(q * 1.1, k, v, mask),
        }
        fault_rel = {f: compare(out, want, dtype)[2] for f, out in faults.items()}
        caught = all(not compare(out, want, dtype)[0] for out in faults.values())
        results.append({"case": name, "dtype": str(dtype).split(".")[-1],
                        "shape": [B, H, Lq, Lk, D], "max_abs_err": err, "max_rel_err": rel,
                        "fault_rel_err": fault_rel, "ok": ok, "faults_caught": caught})
        if name.startswith(("texts256/", "bart_greedy/", "serve_stream240/")):
            inputs[name.split("/")[0]] = (q, k, v, mask, lengths)
    # Strided inputs give the contiguous result; the launcher refuses what
    # the kernel does not take.
    q, k, v, mask = attn_inputs(2, 4, 32, 32, 64, torch.bfloat16, [32, 20])
    qt, kt, vt = (x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v))
    strided_equal = (not qt.is_contiguous()) and torch.equal(
        fa.flash_attention(qt, kt, vt, mask), fa.flash_attention(q, k, v, mask))
    refused = {}
    for why, args in (("mixed_dtypes", (q, k.float(), v, mask)),
                      ("d_head_16", (q[..., :16], k[..., :16], v[..., :16], mask)),
                      ("mask_on_cpu", (q, k, v, mask.cpu()))):
        try:
            fa._launch(*args)
            refused[why] = False
        except ValueError:
            refused[why] = True
    torch.cuda.synchronize()
    emit({"phase": "kernels_vs_plain", "tolerance": {"bf16": TOL[torch.bfloat16],
                                                     "f32": TOL[torch.float32]},
          "rel_tolerance": {"bf16": REL_TOL[torch.bfloat16], "f32": REL_TOL[torch.float32]},
          "cases": results, "strided_equal": strided_equal, "refused": refused})
    bad = [r for r in results if not (r["ok"] and r["faults_caught"])]
    if bad or not strided_equal or not all(refused.values()):
        raise SystemExit(f"flash_attention kernel check failed: {bad}, strided_equal "
                         f"{strided_equal}, refused {refused}")
    main = [r for r in results if "/" in r["case"]]
    return {"max_abs_err": max(r["max_abs_err"] for r in main),
            "max_rel_err": max(r["max_rel_err"] for r in main), "inputs": inputs.get("texts256"),
            "inputs_bart": inputs.get("bart_greedy"),
            "inputs_serving": inputs.get("serve_stream240")}


TRAIN_EDGE_CASES = [
    # name, (B, H, Lq, Lk, D), key lengths (one = shared mask; 0 = no key)
    ("ragged_L77", (2, 3, 77, 77, 64), [77, 40]),
    ("lq_ne_lk", (2, 4, 100, 300, 64), [300, 129]),
    ("dead_row", (3, 4, 48, 48, 64), [48, 0, 30]),
    ("shared_mask", (2, 2, 70, 70, 64), [33]),
    ("d32", (2, 4, 130, 130, 32), [130, 65]),
    ("d128", (2, 2, 200, 200, 128), [200, 17]),
    # Lq past a 128-row block, Lk one key past a 128-key block whose last
    # real key is 128; one query row; a mask the batch shares at d_head 128.
    ("lq257_lk129", (2, 3, 257, 129, 64), [129, 100]),
    ("lq1", (2, 3, 1, 77, 64), [77, 5]),
    ("shared_mask_d128", (2, 4, 300, 300, 128), [250]),
]
TRAIN_PARTS = ("o", "lse", "dq", "dk", "dv", "delta")


def train_kernel_outputs(fa, q, k, v, keep, do):
    """(o, lse, dq, dk, dv, delta) from the three training kernels, delta
    as the dQ kernel computes it for the dK/dV kernel."""
    o, lse = fa._launch_fwd_lse(q, k, v, keep)
    dq, delta = fa._launch_bwd_dq(q, k, v, keep, do, o, lse)
    return (o, lse, dq, *fa._launch_bwd_dkv(q, k, v, keep, do, lse, delta), delta)


def check_train_kernels(fa, main_case) -> dict:
    """Phase 3, training kernels: the forward with lse against its plain
    version, and dQ, dK/dV against the plain backward on the same inputs
    (the kernel forward's o and lse), under the serving check's
    tolerances; lse (f32 either way) under f32's, on rows with a key, and
    the dQ kernel's delta against attention_delta under f32's."""
    cases = [(n, s, ln, dt) for n, s, ln in TRAIN_EDGE_CASES
             for dt in (torch.bfloat16, torch.float32)] + [main_case]
    results, inputs = [], None
    for i, (name, (B, H, Lq, Lk, D), lengths, dtype) in enumerate(cases):
        q, k, v, mask = attn_inputs(B, H, Lq, Lk, D, dtype, lengths, seed=100 + i)
        do = torch.randn(q.shape, generator=torch.Generator().manual_seed(i)).to("cuda", dtype)
        keep = fa.key_keep(mask)
        got = train_kernel_outputs(fa, q, k, v, keep, do)
        o, lse = got[0], got[1]
        o_p, lse_p = fa.flash_attention_fwd_lse_reference(q, k, v, keep)
        delta = fa.attention_delta(o, do)
        want = (o_p, lse_p, *fa.flash_attention_bwd_reference(q, k, v, keep, o, lse, do), delta)
        live = (keep.sum(-1) > 0).expand(B)  # rows with a key (lse ≈ NEG_INF - 69 otherwise)

        def verdicts(outs):
            res = {}
            for j, part in enumerate(TRAIN_PARTS):
                g, w = outs[j], want[j]
                if part == "lse":
                    res[part] = compare(g[live], w[live], torch.float32)
                else:
                    res[part] = compare(g, w, torch.float32 if part == "delta" else dtype)
            return res

        res = verdicts(got)
        ok = all(r[0] for r in res.values())
        if len(lengths) == B and 0 in lengths:
            dead = torch.as_tensor(np.asarray(lengths) == 0, device=q.device)
            ok = ok and all(bool((x[dead] == 0).all()) for x in got[2:5])
        faults = {
            "drop_first_tile": (o, lse, *fa.flash_attention_bwd_reference(
                q, k, v, fa.key_keep(drop_first_tile(mask)), o, lse, do), delta),
            "dq_scale_x1.1": (*want[:2], want[2] * 1.1, *want[3:]),
            # The plain backward reads O only for delta: zero O, zero delta.
            "delta_zeroed": (o, lse, *fa.flash_attention_bwd_reference(
                q, k, v, keep, torch.zeros_like(o), lse, do), torch.zeros_like(delta)),
        }
        fault_res = {f: verdicts(outs) for f, outs in faults.items()}
        caught = all(not all(r[0] for r in fr.values()) for fr in fault_res.values())
        results.append({
            "case": name, "dtype": str(dtype).split(".")[-1], "shape": [B, H, Lq, Lk, D],
            "max_abs_err": {p: r[1] for p, r in res.items()},
            "max_rel_err": {p: r[2] for p, r in res.items()},
            "fault_max_rel_err": {f: max(r[2] for r in fr.values()) for f, fr in fault_res.items()},
            "ok": ok, "faults_caught": caught})
        if name.startswith("train/"):
            inputs = (q, k, v, keep, do, lengths)
    # The launchers refuse what the kernels do not take.
    q, k, v, keep, do, _ = inputs
    lse = torch.zeros(q.shape[:3] + (1,), device="cuda")
    o = torch.zeros_like(q)
    refused = {}
    for why, fn in (("non_contiguous_q", lambda: fa._launch_fwd_lse(q.transpose(1, 2), k, v, keep)),
                    ("lse_bf16", lambda: fa._launch_bwd_dq(q, k, v, keep, do, o, lse.bfloat16())),
                    ("delta_bf16", lambda: fa._launch_bwd_dkv(q, k, v, keep, do, lse, lse.bfloat16())),
                    ("o_non_contiguous", lambda: fa._launch_bwd_dq(
                        q, k, v, keep, do, o.transpose(2, 3).contiguous().transpose(2, 3), lse)),
                    ("o_on_cpu", lambda: fa._launch_bwd_dq(q, k, v, keep, do, o.cpu(), lse)),
                    ("keep_on_cpu", lambda: fa._launch_bwd_dkv(q, k, v, keep.cpu(), do, lse, lse)),
                    ("keep_bool", lambda: fa._launch_fwd_lse(q, k, v, keep.bool()))):
        try:
            fn()
            refused[why] = False
        except ValueError:
            refused[why] = True
    torch.cuda.synchronize()
    emit({"phase": "train_kernels_vs_plain", "tolerance": {"bf16": TOL[torch.bfloat16],
                                                           "f32": TOL[torch.float32]},
          "rel_tolerance": {"bf16": REL_TOL[torch.bfloat16], "f32": REL_TOL[torch.float32]},
          "cases": results, "refused": refused})
    bad = [r for r in results if not (r["ok"] and r["faults_caught"])]
    if bad or not all(refused.values()):
        raise SystemExit(f"training kernel check failed: {bad}, refused {refused}")
    main = results[-1]
    return {"inputs": inputs,
            "max_abs_err": {"fwd_lse": max(main["max_abs_err"][p] for p in ("o", "lse")),
                            "dq": max(main["max_abs_err"][p] for p in ("dq", "delta")),
                            "dkv": max(main["max_abs_err"][p] for p in ("dk", "dv"))},
            "max_rel_err": {"fwd_lse": max(main["max_rel_err"][p] for p in ("o", "lse")),
                            "dq": max(main["max_rel_err"][p] for p in ("dq", "delta")),
                            "dkv": max(main["max_rel_err"][p] for p in ("dk", "dv"))}}


def random_texts(rng: random.Random, n: int, lo: int, hi: int):
    alphabet = "abcdefghijklmnopqrstuvwxyz      .,;:!?0123456789ABCDEFGHIJ"
    return ["".join(rng.choice(alphabet) for _ in range(rng.randint(lo, hi)))
            for _ in range(n)]


def check_result(out: dict, n_rows: int, k: int) -> None:
    if not out.get("ok") or out.get("device") != torch.device(CARD).type or "fallback" in out:
        raise SystemExit(f"request did not run on cuda: {str(out)[:500]}")
    if out["n_rows"] != n_rows:
        raise SystemExit(f"n_rows {out['n_rows']} != {n_rows}")
    rows = [r["topk"] for r in out["results"]] if "results" in out else [out["topk"]]
    for row in rows:
        scores = [e["score"] for e in row]
        if len(row) != k or scores != sorted(scores, reverse=True) or not all(
                np.isfinite(scores)) or not 0 < sum(scores) <= 1 + 1e-4:
            raise SystemExit(f"bad top-k row {row}")


def op_agreement(got: dict, want: dict, tol: float) -> dict:
    """Two results of one request that asked for every class: per class the
    difference in log-probability (the logits' difference less the
    normaliser's) and in probability, and top-1 flips; a flip is a tie only
    where the reference puts the two classes within ``tol`` in log p."""
    worst_logp = worst_p = 0.0
    flips = non_ties = 0
    for g, w in zip(got["results"], want["results"], strict=True):
        gp = {e["index"]: e["score"] for e in g["topk"]}
        wp = {e["index"]: e["score"] for e in w["topk"]}
        if gp.keys() != wp.keys():
            raise SystemExit("results do not list the same classes")
        for c, p in wp.items():
            worst_p = max(worst_p, abs(gp[c] - p))
            worst_logp = max(worst_logp, abs(math.log(max(gp[c], 1e-30))
                                             - math.log(max(p, 1e-30))))
        g1, w1 = g["topk"][0]["index"], w["topk"][0]["index"]
        if g1 != w1:
            flips += 1
            non_ties += math.log(wp[w1]) - math.log(max(wp[g1], 1e-30)) > tol
    ok = worst_logp <= tol and worst_p <= SCORE_TOL and not non_ties
    return {"max_logp_diff": worst_logp, "max_score_diff": worst_p, "top1_flips": flips,
            "non_tie_flips": non_ties, "ok": ok}


def timed_requests(classify, ctx, fa, requests, launches: dict, k: int) -> list:
    """Run each request once to warm up, then REPS times; every run must
    launch each kernel as often as ``launches`` says (the others not at
    all) and select no dense attention."""
    want = {key: launches.get(key, 0) for key in fa.LAUNCH_COUNTS}
    report = []
    for name, payload, n_rows in requests:
        walls = []
        for rep in range(REPS + 1):
            before, sel = dict(fa.LAUNCH_COUNTS), dict(fa.SELECTION_COUNTS)
            t0 = time.perf_counter()
            out = classify(dict(payload), ctx)
            wall = time.perf_counter() - t0
            check_result(out, n_rows, k)
            got = {key: fa.LAUNCH_COUNTS[key] - before[key] for key in want}
            dense = {key: fa.SELECTION_COUNTS[key] - sel[key] for key in ("dense", "ring_dense")}
            if got != want or any(dense.values()):
                raise SystemExit(f"{name}: kernel launches {got} (want {want}), "
                                 f"dense selections {dense}")
            if rep:
                walls.append(wall)
        p50 = statistics.median(walls)
        report.append({"request": name, "rows": n_rows, "p50_ms": p50 * 1e3,
                       "rows_per_s": n_rows / p50})
    return report


# Device kernels by what they do, from their names (first match wins); the
# forward's variants by their template flags, demangled or mangled:
# flash_fwd_sm90<D, WriteLse, CarryState, RelBias> (TMA + wgmma, every bf16
# forward) and flash_fwd_f32<D, WriteLse, CarryState, RelBias> (FMA).
FWD_VARIANT = re.compile(r"flash_fwd_(sm90|f32)(?:<\d+((?:, \w+)+)>|ILi\d+E((?:Lb\dE)+))")
FWD_FLAGS = ("lse", "carry", "bias")


def fwd_variant(name: str):
    """(kernel, {flag: bool}) of a forward kernel's name, or None."""
    found = FWD_VARIANT.search(name)
    if not found:
        return None
    kernel, demangled, mangled = found.groups()
    values = ([f.strip() == "true" for f in demangled.split(",")[1:]] if demangled
              else [bit == "1" for bit in re.findall(r"Lb(\d)E", mangled)])
    return kernel, dict(zip(FWD_FLAGS, values))


# The backward's TMA + wgmma kernels, flash_bwd_dq_sm90<D> and
# flash_bwd_dkv_sm90<D>, demangled or mangled: (which, D).
BWD_VARIANT = re.compile(r"flash_bwd_(dq|dkv)_sm90(?:<(\d+)>|ILi(\d+)E)")


def sm90_name(name: str):
    """The readable name of a TMA + wgmma instantiation, forward or
    backward, from its (mangled) name; None for any other kernel."""
    variant = fwd_variant(name)
    if variant and variant[0] == "sm90":
        d = re.search(r"(?:ILi|<)(\d+)", name).group(1)
        return f"flash_fwd_sm90<{d}, " + ", ".join(
            f"{f}={str(on).lower()}" for f, on in variant[1].items()) + ">"
    found = BWD_VARIANT.search(name)
    if found:
        return f"flash_bwd_{found.group(1)}_sm90<{found.group(2) or found.group(3)}>"
    return None


KERNEL_KINDS = (
    ("flash_attention", ("flash_fwd",)),
    ("flash_attention_bwd", ("flash_bwd",)),
    ("matmul", ("nvjet", "gemm", "gemv", "cutlass", "xmma")),
    ("layer_norm", ("layer_norm", "GammaBeta")),
    ("optimizer", ("multi_tensor_apply",)),
    ("embedding_index", ("embedding", "index", "scatter", "gather")),
    ("memcpy", ("Memcpy", "Memset")),
    ("reduce_sort_softmax", ("reduce", "sort", "Sort", "softmax")),
    ("elementwise", ("elementwise", "copy", "Gelu", "fill")),
)


def kernel_kind(name: str) -> str:
    variant = fwd_variant(name)
    if variant:
        flags = variant[1]
        return ("flash_t5" if flags.get("bias") else "flash_fold" if flags.get("carry")
                else "flash_attention")
    return next((kind for kind, keys in KERNEL_KINDS if any(k in name for k in keys)),
                "other")


PROFILE_ATTEMPTS = 3
# Spin kernels each profiled session launches before the call (about 40 ms
# of device time), so that the leading records the profiler loses are
# theirs and not the call's; see profile_call.
PROFILE_PREFIX, PROFILE_PREFIX_CYCLES = 1024, 80_000
PREFIX_KERNEL = "spin_kernel"  # torch.cuda._sleep's kernel


def call_events(averages) -> tuple:
    """The device events of a profiled session's ``key_averages()``, split
    into the call's and the prefix's spin kernels (which it never launches)."""
    events = [e for e in averages if e.device_type.name == "CUDA"]
    return ([e for e in events if PREFIX_KERNEL not in e.key],
            sum(e.count for e in events if PREFIX_KERNEL in e.key))


def profile_call(fn) -> dict:
    """One call of ``fn`` under torch.profiler: wall time, summed device
    time of its kernels (so 1 - device/wall is the device's idle share,
    kernels being serialised on one stream), device time by kind of
    kernel, the kernels that took the most, and the host's time blocked
    reading a device value (``aten::_local_scalar_dense``: ``bool(t)``,
    ``t.item()``, which wait for the stream), with their count.

    On an H100 (torch 2.11, CUDA 12.8) the profiler loses the first device
    records of a session, whichever kernels they are: none early in the
    process, more the longer it has lived, a few dozen in some sessions,
    and under a busy host the call's first flash kernel. Sleeping on the
    host inside the session does not help; device work first does. So
    each session first launches PROFILE_PREFIX spin
    kernels and waits for them; their records absorb the loss, and they are
    left out of every number (``prefix_records_lost`` says how many of
    theirs went). A call whose trace still holds fewer flash kernels than
    the launch counters counted during it is profiled again, up to
    PROFILE_ATTEMPTS times (``profile_attempts``); a call that never
    matches fails."""
    from torch.profiler import ProfilerActivity, profile

    from agent_tpu_torch.kernels import flash_attention as fa

    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        torch.cuda.synchronize()
        before = sum(fa.LAUNCH_COUNTS.values())
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_PREFIX):
                torch.cuda._sleep(PROFILE_PREFIX_CYCLES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        launched = sum(fa.LAUNCH_COUNTS.values()) - before
        events, prefix_traced = call_events(prof.key_averages())
        traced = sum(e.count for e in events if "flash_fwd" in e.key or "flash_bwd" in e.key)
        if traced == launched:
            break
    else:
        raise SystemExit(f"the profile traced {traced} flash kernels of {launched} launched, "
                         f"{PROFILE_ATTEMPTS} times (prefix records lost in the last: "
                         f"{PROFILE_PREFIX - prefix_traced})")
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    by_kind: dict = {}
    for e in events:
        kind = kernel_kind(e.key)
        by_kind[kind] = by_kind.get(kind, 0.0) + e.self_device_time_total / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    reads = [e for e in prof.key_averages() if e.key == "aten::_local_scalar_dense"]
    forwards: dict = {}  # launches of each forward kernel, by name and flags
    backwards: dict = {}  # launches of the backward's TMA + wgmma kernels
    for e in events:
        variant = fwd_variant(e.key)
        if variant:
            key = f"flash_fwd_{variant[0]}" + "".join(f" {f}" for f, on in variant[1].items() if on)
            forwards[key] = forwards.get(key, 0) + e.count
        found = BWD_VARIANT.search(e.key)
        if found:
            key = f"flash_bwd_{found.group(1)}_sm90"
            backwards[key] = backwards.get(key, 0) + e.count
    out = {"wall_ms": wall_ms, "device_ms": device_ms, "profile_attempts": attempt,
           "kernels_launched": sum(e.count for e in events),
           "prefix_records_lost": PROFILE_PREFIX - prefix_traced,
           "flash_fwd_launches": forwards, "flash_bwd_sm90_launches": backwards,
           "idle_share": 1 - device_ms / wall_ms if wall_ms else None,
           "host_blocked_reads": sum(e.count for e in reads),
           "host_blocked_ms": sum(e.cpu_time_total for e in reads) / 1e3,
           "device_ms_by_kind": by_kind,
           "top_kernels": [[e.key[:80], e.count, e.self_device_time_total / 1e3] for e in top]}
    # The profiler's event objects refer to one another (parents, children),
    # so a session leaves cyclic garbage that only a full collection frees;
    # left to a later phase, that collection paused phase 10's serial pass
    # for seconds inside its timing on the H100's host. Free it here.
    del prof, events, top, reads
    gc.collect()
    return out


def check_forwards(profile: dict, want: dict, what: str) -> None:
    """Fail unless the profiled call's forward attention kernels are exactly
    ``want`` (launches by kernel and set flags, as profile_call keys them):
    on a bf16 path, flash_fwd_sm90 alone."""
    if profile["flash_fwd_launches"] != want:
        raise SystemExit(f"{what} forwards: {profile['flash_fwd_launches']} (want {want})")


def keyword_rows(n: int, seed: int, lo: int = 0, hi: int = 0):
    """n rows from the two keyword vocabularies, label i % 2: four words a
    row, or words up to a length drawn from [lo, hi] bytes when hi > 0."""
    rng = np.random.default_rng(seed)
    texts, labels = [], []
    for i in range(n):
        words = TRAIN_WORDS[i % 2]
        if hi:
            target, text = int(rng.integers(lo, hi + 1)), ""
            while len(text) < target:
                text = f"{text} {rng.choice(words)}" if text else str(rng.choice(words))
            texts.append(text[:target])
        else:
            texts.append(" ".join(rng.choice(words, size=4)))
        labels.append(i % 2)
    return texts, labels


def reset_counts(fa) -> None:
    for counts in (fa.LAUNCH_COUNTS, fa.SELECTION_COUNTS):
        for key in counts:
            counts[key] = 0


class PlainTile32(torch.autograd.Function):
    """The plain trainable attention with 32-key tiles: another valid bf16
    evaluation of the same function, whose spread from the 64-key plain
    version measures bf16's own noise in the gradients."""

    @staticmethod
    def forward(ctx, q, k, v, mask):
        from agent_tpu_torch.kernels import flash_attention as fa

        keep = fa.key_keep(mask)
        o, lse = fa.flash_attention_fwd_lse_reference(q, k, v, keep, block_k=32)
        ctx.save_for_backward(q, k, v, keep, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        from agent_tpu_torch.kernels import flash_attention as fa

        return (*fa.flash_attention_bwd_reference(*ctx.saved_tensors, do, block_k=32), None)


TRAIN_KERNELS = ("flash_attention_fwd_lse", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")


def train_phase(fa, train_op, classify, payload, first_batch, tmp) -> dict:
    """Phase 6: the op at BERT-base width, then its step alone on the op's
    first batch (``first_batch``: the op's staged state and that batch's
    rows). Returns the op's kernel launches and the step's p50 ms."""
    from agent_tpu_torch.models import encoder, train
    from agent_tpu_torch.runtime.context import OpContext
    from agent_tpu_torch.runtime.runtime import TorchRuntime

    rt = TorchRuntime()
    ctx = OpContext(runtime=rt)
    n_layers = BERT_BASE["n_layers"]
    reset_counts(fa)
    torch.cuda.reset_peak_memory_stats()
    out = train_op(dict(payload, output_path=f"{tmp}/bert_base.npz"), ctx)
    launches, selection = dict(fa.LAUNCH_COUNTS), dict(fa.SELECTION_COUNTS)
    op_peak = torch.cuda.max_memory_allocated()
    if not out.get("ok") or out.get("device") != "cuda":
        raise SystemExit(f"train_classifier did not run on cuda: {str(out)[:500]}")
    losses = ctx.tags["train"]["epoch_losses"]
    n_steps = out["n_steps"]
    want = n_layers * n_steps
    if not all(math.isfinite(x) for x in losses) or len(losses) != payload["epochs"]:
        raise SystemExit(f"epoch losses {losses}")
    if any(launches[k] != want for k in TRAIN_KERNELS) or selection["dense_train"] \
            or selection["flash_train"] != want:
        raise SystemExit(f"train launches {launches}, selection {selection}; want {want} each")

    # The artifact serves on the card.
    texts, labels = keyword_rows(64, SEED + 1, 490, 500)
    served = classify({"texts": texts, "topk": 1, "model_path": out["output_path"],
                       "model_config": out["model_config"], "result_format": "columnar",
                       "allow_fallback": False}, ctx)
    if not served.get("ok") or served.get("device") != "cuda":
        raise SystemExit(f"trained artifact did not serve on cuda: {str(served)[:500]}")
    served_acc = float(np.mean([r[0] == lab for r, lab in zip(served["indices"], labels)]))
    rt.clear_params()

    # The step alone, on the op's first batch, from the op's trained weights.
    state, take = first_batch
    batch = [rt.put_batch(state[key][take]) for key in ("ids", "mask", "labels")]
    cfg = state["cfg"]
    with np.load(out["output_path"]) as f:
        flat = {key: f[key] for key in f.files}
    model = encoder.from_jax_params(flat, cfg, device=rt.device, trainable=True)
    init_state, step = train.make_train_step(cfg, train.adamw(1e-3),
                                             attn_fn=rt.train_attention_fn())
    opt = init_state(model)
    for _ in range(WARM_STEPS):
        step(model, opt, *batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        _, _, loss = step(model, opt, *batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    step_peak = torch.cuda.max_memory_allocated()
    if not math.isfinite(loss.item()):
        raise SystemExit(f"step loss {loss.item()}")
    p50 = statistics.median(walls)
    step_profile = profile_call(lambda: step(model, opt, *batch))
    if step_profile["flash_fwd_launches"] != {"flash_fwd_sm90 lse": n_layers} or \
            step_profile["flash_bwd_sm90_launches"] != {"flash_bwd_dq_sm90": n_layers,
                                                         "flash_bwd_dkv_sm90": n_layers}:
        raise SystemExit(f"train step forwards: {step_profile['flash_fwd_launches']}, "
                         f"backwards: {step_profile['flash_bwd_sm90_launches']}")

    # One step's gradients: the kernels against the plain trainable
    # attention, against bf16's own spread (the plain attention with
    # 32-key tiles), and the planted tile drop, leaf by leaf.
    def grads(attn):
        model.zero_grad(set_to_none=True)
        loss = train.cross_entropy_loss(model, *batch, attn_fn=attn)
        loss.backward()
        return loss.item(), {k: p.grad.detach().clone() for k, p in model.named_parameters()}

    def rel_l2(g, w) -> dict:
        return {k: ((g[k] - w[k]).norm() / w[k].norm()).item() for k in w if w[k].norm() > 0}

    loss_p, g_plain = grads(fa.flash_attention_trainable_reference)
    loss_k, g = grads(rt.train_attention_fn())
    rel_kernel = rel_l2(g, g_plain)
    loss_n, g = grads(PlainTile32.apply)
    rel_noise = rel_l2(g, g_plain)
    loss_f, g = grads(lambda q, k_, v, m: fa.flash_attention_trainable_reference(
        q, k_, v, drop_first_tile(m)))
    rel_fault = rel_l2(g, g_plain)
    del model, opt, g_plain, g
    limit = {k: max(GRAD_REL_L2_FLOOR, GRAD_NOISE_FACTOR * rel_noise[k]) for k in rel_kernel}
    grad_fails = sorted(k for k in limit if rel_kernel[k] > limit[k])
    fault_fails = sorted(k for k in limit if rel_fault[k] > limit[k])
    by_kind = {}
    for k in limit:
        kind = k.split(".", 2)[2] if k.startswith("blocks.") else k
        worst = by_kind.setdefault(kind, [0.0, 0.0, 0.0])
        for i, rel in enumerate((rel_kernel, rel_noise, rel_fault)):
            worst[i] = max(worst[i], rel[k])

    # A small f32 model: the op on the card against the same op on the CPU.
    texts, labels = keyword_rows(160, SEED)
    small = dict(SMALL_TRAIN, texts=texts, labels=labels, model_config=SMALL_TRAIN_F32)
    runs = {}
    for where, run_rt in (("cuda", rt), ("cpu", TorchRuntime(device="cpu"))):
        run_ctx = OpContext(runtime=run_rt)
        res = train_op(dict(small, output_path=f"{tmp}/small_{where}.npz"), run_ctx)
        if not res.get("ok") or res["device"] != where:
            raise SystemExit(f"small f32 training on {where}: {str(res)[:500]}")
        runs[where] = (res, run_ctx.tags["train"]["epoch_losses"])
    (card, card_losses), (cpu, cpu_losses) = runs["cuda"], runs["cpu"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses))
    small_ok = (loss_rel <= TRAIN_F32_REL_TOL and card["eval_accuracy"] > 0.9
                and cpu["eval_accuracy"] > 0.9
                and card["last_epoch_loss"] < card["first_epoch_loss"])

    emit({
        "phase": "train", "config": BERT_BASE, "payload": {
            "rows": len(payload["texts"]), **TRAIN, "seq_len": int(state["ids"].shape[1])},
        "op": {key: out[key] for key in ("n_train", "n_eval", "n_steps", "first_epoch_loss",
                                         "last_epoch_loss", "eval_accuracy", "elapsed_ms")},
        "epoch_losses": losses, "train_ms": ctx.tags["train"]["train_ms"],
        "launches": launches, "selection": selection, "op_peak_bytes": op_peak,
        "served_accuracy_64_rows": served_acc,
        "step": {"p50_ms": p50 * 1e3, "examples_per_s": payload["batch_size"] / p50,
                 "step_ms": [w * 1e3 for w in walls], "peak_bytes": step_peak,
                 "profile": step_profile},
        "grads_vs_plain": {
            "noise_factor": GRAD_NOISE_FACTOR, "floor": GRAD_REL_L2_FLOOR,
            "leaves": len(limit), "failing_leaves": grad_fails,
            "planted_tile_drop_failing_leaves": len(fault_fails),
            "max_rel_l2_by_kind_kernel_noise_fault": by_kind,
            "loss_kernel_plain_tile32_fault": [loss_k, loss_p, loss_n, loss_f]},
        "small_f32_card_vs_cpu": {"tolerance": TRAIN_F32_REL_TOL, "max_loss_rel_diff": loss_rel,
                                  "card_losses": card_losses, "cpu_losses": cpu_losses,
                                  "eval_accuracy": [card["eval_accuracy"], cpu["eval_accuracy"]],
                                  "ok": small_ok},
    })
    if grad_fails or not fault_fails or not small_ok:
        raise SystemExit("train gradients or the card-vs-CPU training disagree (or the "
                         "planted fault went unnoticed)")
    return launches, p50 * 1e3


def first_train_batch(payload) -> tuple:
    """The op's staged state for phase 6's payload and the rows of its first
    batch, as the op permutes them."""
    from agent_tpu_torch.ops import train_classifier

    _, state = train_classifier.stage(dict(payload, output_path="first_batch.npz"))
    take = np.random.default_rng(payload["seed"]).permutation(state["train_idx"])[
        : payload["batch_size"]]
    return state, take


SM90 = "sm90: TMA + wgmma"  # every kernel's design


def kernel_entry(name, source, design, replaces, launches, max_abs_err, max_rel_err, ms,
                 plain_ms, n_bytes, flops, library_ms, q, **extra) -> dict:
    """One entry of the kernels line; the bound is the larger of the bytes
    over the card's memory rate and the bf16 products over its peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return {"name": name, "route": "cuda", "source": source, "design": design,
            "replaces": replaces,
            "launches": launches, "max_abs_err": max_abs_err, "max_rel_err": max_rel_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "shape": list(q.shape),
            "dtype": str(q.dtype).split(".")[-1], **extra}


def train_kernel_entries(fa, check, launches, by_path=None) -> list:
    """The kernels line's entries of the three training kernels, timed at
    phase 6's first batch. Their library yardsticks are
    scaled_dot_product_attention's forward and its backward (which
    computes dq, dk and dv together, so both backward entries carry it)."""
    q, k, v, keep, do, lengths = check["inputs"]
    B, H, L, D = q.shape
    mask = keep[:, None, None, :] > 0
    o, lse = fa._launch_fwd_lse(q, k, v, keep)
    _, delta = fa._launch_bwd_dq(q, k, v, keep, do, o, lse)
    plain_bwd_ms = cuda_ms(lambda: fa.flash_attention_bwd_reference(q, k, v, keep, o, lse, do),
                           iters=3, warmup=1)
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
    sdpa_bwd_ms = cuda_ms(lambda: torch.autograd.grad(sdpa, (qg, kg, vg), do,
                                                      retain_graph=True))
    tensor = B * H * L * D * q.element_size()
    rows = B * H * L * 4  # one f32 per query row (lse, delta)
    keys = float(np.sum(lengths)) * H * L * D  # per product of 2 FLOP: real keys only
    src = "agent_tpu_torch/kernels/csrc/"
    covers = "dq, dk and dv in one call"

    def paths(kernel):
        return {"launches_by_path": {p: n[kernel] for p, n in by_path.items()}} if by_path else {}

    return [
        kernel_entry(
            "flash_attention_fwd_lse", src + "flash_fwd_sm90.cuh", SM90,
            "agent_tpu/kernels/flash_attention.py:598", launches["flash_attention_fwd_lse"],
            check["max_abs_err"]["fwd_lse"], check["max_rel_err"]["fwd_lse"],
            cuda_ms(lambda: fa._launch_fwd_lse(q, k, v, keep)),
            cuda_ms(lambda: fa.flash_attention_fwd_lse_reference(q, k, v, keep), iters=5),
            4 * tensor + rows + keep.numel() * 4, 4 * keys,
            cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=mask)), q, **paths("flash_attention_fwd_lse")),
        # dQ reads Q, K, V, dO and O (for delta), writes dQ and delta.
        kernel_entry(
            "flash_attention_bwd_dq", src + "flash_bwd_sm90.cuh", SM90,
            "agent_tpu/kernels/flash_attention.py:629", launches["flash_attention_bwd_dq"],
            check["max_abs_err"]["dq"], check["max_rel_err"]["dq"],
            cuda_ms(lambda: fa._launch_bwd_dq(q, k, v, keep, do, o, lse)), plain_bwd_ms,
            6 * tensor + 2 * rows + keep.numel() * 4, 6 * keys, sdpa_bwd_ms, q,
            plain_covers=covers, library_covers=covers, **paths("flash_attention_bwd_dq")),
        kernel_entry(
            "flash_attention_bwd_dkv", src + "flash_bwd_sm90.cuh", SM90,
            "agent_tpu/kernels/flash_attention.py:665", launches["flash_attention_bwd_dkv"],
            check["max_abs_err"]["dkv"], check["max_rel_err"]["dkv"],
            cuda_ms(lambda: fa._launch_bwd_dkv(q, k, v, keep, do, lse, delta)), plain_bwd_ms,
            6 * tensor + 2 * rows + keep.numel() * 4, 8 * keys, sdpa_bwd_ms, q,
            plain_covers=covers, library_covers=covers, **paths("flash_attention_bwd_dkv")),
    ]


FOLD_EDGE_CASES = [
    # name, (B, H, Lq, Lk, D), key lengths of the first block, of the second
    ("masked_after_real", (2, 4, 128, 192, 64), [192, 100], [0, 0]),
    ("masked_after_real_d128", (2, 4, 128, 192, 128), [192, 100], [0, 0]),
    ("dead_row", (3, 4, 96, 96, 64), [96, 0, 40], [50, 0, 96]),
    ("ragged_lq_ne_lk", (2, 3, 77, 131, 32), [131, 64], [100, 7]),
    ("d32", (2, 4, 160, 160, 32), [160, 33], [70, 160]),
    ("d64", (2, 4, 130, 200, 64), [200, 1], [150, 199]),
    # Around the kernel's 128-row block: Lq 257 (a third block of one row,
    # whose rows past Lq must not touch the next head's state), Lq 1; a
    # mask the batch shares at d_head 128.
    ("lq257_lk129", (2, 3, 257, 129, 64), [129, 100], [129, 60]),
    ("lq1", (2, 3, 1, 77, 64), [77, 5], [40, 77]),
    ("shared_mask_d128", (2, 4, 300, 300, 128), [250], [120]),
    # The second block's keys scaled (FOLD_KEY_SCALE): its first tile's
    # scores exceed every row's carried max, so tile 0's correction of the
    # carried acc matters on every row.
    ("carry_raised", (2, 4, 130, 150, 64), [150, 90], [150, 70]),
]
FOLD_KEY_SCALE = {"carry_raised": 4.0}


def carry_not_corrected(fa, q, k, v, keep, m, l, acc):
    """Planted fault: the plain fold with tile 0's correction of the carried
    acc skipped, as a kernel that starts O from the carry but runs tile 0
    as if O were still 0 would compute."""
    t = fa.BLOCK_K
    m0, l0, pv = fa.flash_fold_reference(q, k[:, :, :t], v[:, :, :t], keep[:, :t], m, l,
                                         torch.zeros_like(acc))
    return fa.flash_fold_reference(q, k[:, :, t:], v[:, :, t:], keep[:, t:], m0, l0, acc + pv)


def ring_fold_case(long_case) -> tuple:
    """The fold's main case: shard 0 of phase 5b's ring at sp = SP, whose
    second hop folds the second key block into the state of the first."""
    name, (B, H, L, _, D), lengths, dtype = long_case
    lq = L // SP
    blocks = [np.clip(np.asarray(lengths) - j * lq, 0, lq).tolist() for j in (0, 1)]
    return (f"ring_shard/{name}", (B, H, lq, lq, D), *blocks, dtype)


def check_fold_kernel(fa, main_case, extra_cases=()) -> dict:
    """Phase 3, the fold kernel: two hops, the first from the initial state,
    the second from the state the plain version carried out of the first;
    m, l and acc of each against the plain version under the serving
    check's tolerances (those of the input dtype). ``main_case`` is the one
    the kernels line times; ``extra_cases`` are other paths' shard shapes."""
    cases = [(n, s, l0, l1, dt) for n, s, l0, l1 in FOLD_EDGE_CASES
             for dt in (torch.bfloat16, torch.float32)] + [main_case, *extra_cases]
    results, inputs = [], None
    for i, (name, (B, H, Lq, Lk, D), len0, len1, dtype) in enumerate(cases):
        q, k0, v0, mask0 = attn_inputs(B, H, Lq, Lk, D, dtype, len0, seed=200 + i)
        _, k1, v1, mask1 = attn_inputs(B, H, Lq, Lk, D, dtype, len1, seed=300 + i)
        k1 = k1 * FOLD_KEY_SCALE.get(name, 1.0)  # a power of 2: exact in bf16
        keep0, keep1 = fa.key_keep(mask0), fa.key_keep(mask1)
        start = fa.initial_state(q)
        prev = fa.flash_fold_reference(q, k0, v0, keep0, *start)
        want = fa.flash_fold_reference(q, k1, v1, keep1, *prev)
        hop1 = fa.flash_fold(q, k0, v0, mask0, *(x.clone() for x in start))
        hop2 = fa.flash_fold(q, k1, v1, mask1, *(x.clone() for x in prev))

        def verdict(got, ref) -> list:
            return [compare(g, w, dtype) for g, w in zip(got, ref)]

        res = verdict(hop1, prev) + verdict(hop2, want)
        ok = all(r[0] for r in res)
        if name.startswith("masked_after_real"):  # the state passes through unchanged
            ok = ok and all(torch.equal(g, w) for g, w in zip(hop2, prev))
        if name == "dead_row":  # row 1 has no key in either block
            ok = ok and bool((hop2[0][1] == fa.NEG_INF).all() and (hop2[1][1] == 0).all()
                             and (hop2[2][1] == 0).all())
        faults = {"state_reset": fa.flash_fold_reference(q, k1, v1, keep1, *start)}
        if max(len1) > 0:  # a wholly masked block has no tile to drop or correct by
            faults["drop_first_tile"] = fa.flash_fold_reference(
                q, k1, v1, fa.key_keep(drop_first_tile(mask1)), *prev)
            faults["carry_not_corrected"] = carry_not_corrected(fa, q, k1, v1, keep1, *prev)
        fault_res = {f: verdict(out, want) for f, out in faults.items()}
        caught = all(not all(r[0] for r in fr) for fr in fault_res.values())
        results.append({
            "case": name, "dtype": str(dtype).split(".")[-1], "shape": [B, H, Lq, Lk, D],
            "max_abs_err": {"m": max(res[0][1], res[3][1]), "l": max(res[1][1], res[4][1]),
                            "acc": max(res[2][1], res[5][1])},
            "max_rel_err": max(r[2] for r in res),
            "fault_max_rel_err": {f: max(r[2] for r in fr) for f, fr in fault_res.items()},
            "ok": ok, "faults_caught": caught})
        if name == main_case[0]:
            inputs = (q, k1, v1, keep1, prev, len1)
    # The launcher refuses state it does not take.
    q, k, v, keep, (m, l, acc), _ = inputs
    refused = {}
    for why, state in (("state_f16", (m.half(), l, acc)),
                       ("state_shape", (m, l[:, :, :-1], acc)),
                       ("state_non_contiguous",
                        (m, l, acc.transpose(-1, -2).contiguous().transpose(-1, -2))),
                       ("state_on_cpu", (m.cpu(), l, acc))):
        try:
            fa._launch_fold(q, k, v, keep, *state)
            refused[why] = False
        except ValueError:
            refused[why] = True
    torch.cuda.synchronize()
    emit({"phase": "fold_kernel_vs_plain", "tolerance": {"bf16": TOL[torch.bfloat16],
                                                         "f32": TOL[torch.float32]},
          "rel_tolerance": {"bf16": REL_TOL[torch.bfloat16], "f32": REL_TOL[torch.float32]},
          "cases": results, "refused": refused})
    bad = [r for r in results if not (r["ok"] and r["faults_caught"])]
    if bad or not all(refused.values()):
        raise SystemExit(f"fold kernel check failed: {bad}, refused {refused}")
    main = [r for r in results if r["case"].startswith("ring_shard/")]
    return {"inputs": inputs, "max_abs_err": max(max(r["max_abs_err"].values()) for r in main),
            "max_rel_err": max(r["max_rel_err"] for r in main)}


def shared_runtime(base, attn=None, **kwargs):
    """A test hook: a runtime over ``kwargs``'s devices that shares
    ``base``'s resident weights and, when ``attn`` is given, attends with
    it instead of its own attention function."""
    from agent_tpu_torch.runtime.runtime import TorchRuntime

    rt = TorchRuntime(**(kwargs or {"device": CARD}))
    rt._params = base._params
    if attn is not None:
        rt.attention_fn = lambda: attn
    return rt


def ring_phase(fa, classify, rt, long_payload, one_card, small_payload, k) -> int:
    """Phase 5b: phase 5's request on an sp mesh whose shards share the
    card; ``rt`` is phase 5's one-card runtime, holding the weights.
    Returns the fold launches of the timed sp = SP requests."""
    from agent_tpu_torch.parallel import ring as ring_mod
    from agent_tpu_torch.runtime.context import OpContext
    from agent_tpu_torch.runtime.runtime import TorchRuntime

    def mesh_kwargs(sp, device=CARD):
        return {"devices": [device] * sp, "mesh_shape": {"sp": sp}}

    ring_rt = shared_runtime(rt, **mesh_kwargs(SP))
    ctx = OpContext(runtime=ring_rt)
    classify(dict(long_payload), ctx)  # warm-up
    reset_counts(fa)
    report = timed_requests(classify, ctx, fa, [(f"texts8_L4096_sp{SP}", long_payload, 8)],
                            {"flash_fold": LONG_LAYERS * SP * SP}, k)
    launches, selection = fa.LAUNCH_COUNTS["flash_fold"], dict(fa.SELECTION_COUNTS)
    if selection["ring"] != LONG_LAYERS * (REPS + 1) or selection["flash"]:
        raise SystemExit(f"ring selections {selection}")
    profile = profile_call(lambda: classify(dict(long_payload), ctx))

    # Every class: the ring against the one-card run, and against the ring
    # with the plain fold swapped in; the planted state reset must fail.
    every = dict(long_payload, topk=1000)
    one_card_out = classify(dict(every), OpContext(runtime=rt))
    ring_out = classify(dict(every), ctx)
    devices = list(ring_rt.mesh.devices.reshape(-1))

    def ring_with(fold):
        return lambda q, k_, v, mask: ring_mod.ring_attention_blocks(q, k_, v, mask, devices,
                                                                     fold)

    def plain_fold(q, k_, v, mask, m, l, acc):
        return fa.flash_fold_reference(q, k_, v, fa.key_keep(mask), m, l, acc)

    def reset_fold(q, k_, v, mask, m, l, acc):
        return plain_fold(q, k_, v, mask, *fa.initial_state(q))

    plain_out, fault_out = (classify(dict(every), OpContext(runtime=shared_runtime(
        rt, ring_with(fold), **mesh_kwargs(SP)))) for fold in (plain_fold, reset_fold))
    logp = LOGP_TOL["bfloat16"]
    vs_one_card = op_agreement(ring_out, one_card_out, logp)
    vs_plain = op_agreement(ring_out, plain_out, logp)
    fault_vs_plain = op_agreement(fault_out, plain_out, logp)

    # sp = SP_WIDE: the same request, n_layers x SP_WIDE^2 fold launches.
    reset_counts(fa)
    wide_out = classify(dict(every), OpContext(runtime=shared_runtime(
        rt, **mesh_kwargs(SP_WIDE))))
    wide_launches = fa.LAUNCH_COUNTS["flash_fold"]
    wide_vs_one_card = op_agreement(wide_out, one_card_out, logp)

    # A small f32 model at sp = SP: on the card against two CPU shards.
    reset_counts(fa)
    card = classify(dict(small_payload), OpContext(runtime=TorchRuntime(**mesh_kwargs(SP))))
    small_launches, small_selection = fa.LAUNCH_COUNTS["flash_fold"], dict(fa.SELECTION_COUNTS)
    cpu = classify(dict(small_payload),
                   OpContext(runtime=TorchRuntime(**mesh_kwargs(SP, "cpu"))))
    small_vs_cpu = op_agreement(card, cpu, LOGP_TOL["float32"])
    torch.cuda.synchronize()
    emit({"phase": "ring", "config": LONG_CTX, "sp": SP, "requests": report,
          "one_card_p50_ms": one_card[0]["p50_ms"], "launches": launches,
          "selection": selection, "profile_one_request": profile,
          "note": (f"the {SP} shards share one card, so rotating a K/V block copies "
                   "nothing: these times are sp^2 fold launches and no communication"),
          "logp_tolerance": LOGP_TOL, "vs_one_card": vs_one_card,
          "vs_plain_fold": vs_plain, "planted_state_reset_vs_plain_fold": fault_vs_plain,
          "sp_wide": {"sp": SP_WIDE, "launches": wide_launches,
                      "vs_one_card": wide_vs_one_card},
          "small_f32_vs_cpu": {"launches": small_launches, "selection": small_selection,
                               **small_vs_cpu}})
    check_forwards(profile, {"flash_fwd_sm90 carry": LONG_LAYERS * SP * SP}, "ring request")
    if not (vs_one_card["ok"] and vs_plain["ok"] and wide_vs_one_card["ok"]
            and small_vs_cpu["ok"]) or fault_vs_plain["ok"]:
        raise SystemExit("ring results disagree (or the planted fault went unnoticed)")
    if wide_launches != LONG_LAYERS * SP_WIDE ** 2 or card["device"] != torch.device(CARD).type \
            or not small_launches or small_selection["ring_dense"] or small_selection["flash"]:
        raise SystemExit(f"sp={SP_WIDE} launches {wide_launches}; small f32 on the card: "
                         f"{card['device']}, launches {small_launches}, {small_selection}")
    return launches


def fold_kernel_entry(fa, check, launches, **extra) -> dict:
    """The kernels line's entry of the fold kernel at its main case (phase
    5b's second hop of shard 0). The kernel updates the state in place, so
    repeated launches fold the same block again: the same work each time.
    No single PyTorch call returns the carried (m, l, acc), so it has no
    library yardstick."""
    q, k, v, keep, state, lengths = check["inputs"]
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    work = [x.clone() for x in state]
    rows = B * H * Lq * 4
    return kernel_entry(
        "flash_fold", "agent_tpu_torch/kernels/csrc/flash_fwd_sm90.cuh", SM90,
        "agent_tpu/kernels/flash_attention.py:258", launches,
        check["max_abs_err"], check["max_rel_err"],
        cuda_ms(lambda: fa._launch_fold(q, k, v, keep, *work)),
        cuda_ms(lambda: fa.flash_fold_reference(q, k, v, keep, *state), iters=5),
        B * H * (Lq + 2 * Lk) * D * q.element_size() + 2 * (B * H * Lq * D * 4 + 2 * rows)
        + keep.numel() * 4,
        4 * H * Lq * D * float(np.sum(lengths)),  # products with real keys only
        None, q, library_note="no single PyTorch call returns the carried (m, l, acc)", **extra)


def ring_cards_phase(fa, classify, n, long_payload, k) -> None:
    """``--cards N``: phase 5b's request on a ring over the first N cards,
    one shard a card, so every hop's K/V block is a peer copy between two
    cards; against the one-card run, and timed beside the same ring with
    its N shards on one card (where the rotation copies nothing)."""
    from agent_tpu_torch.runtime.context import OpContext
    from agent_tpu_torch.runtime.runtime import TorchRuntime

    one = TorchRuntime()
    ctx_one = OpContext(runtime=one)
    classify(dict(long_payload), ctx_one)  # weights
    reset_counts(fa)
    report = timed_requests(classify, ctx_one, fa, [("texts8_L4096", long_payload, 8)],
                            {"flash_attention": LONG_LAYERS}, k)
    folds = {"flash_fold": LONG_LAYERS * n * n}
    rings = {"cards": shared_runtime(one, mesh_shape={"sp": n}),
             "one_card": shared_runtime(one, devices=[CARD] * n, mesh_shape={"sp": n})}
    every = dict(long_payload, topk=1000)
    want = classify(dict(every), ctx_one)
    result = {}
    for name, rt in rings.items():
        ctx = OpContext(runtime=rt)
        classify(dict(long_payload), ctx)  # warm-up
        reset_counts(fa)
        result[name] = {
            "devices": [str(d) for d in rt.devices],
            "requests": timed_requests(classify, ctx, fa,
                                       [(f"texts8_L4096_sp{n}_{name}", long_payload, 8)],
                                       folds, k),
            "vs_one_card": op_agreement(classify(dict(every), ctx), want,
                                        LOGP_TOL["bfloat16"])}
    result["cards"]["profile_one_request"] = profile_call(
        lambda: classify(dict(long_payload), OpContext(runtime=rings["cards"])))
    torch.cuda.synchronize()
    emit({"phase": "ring_cards", "config": LONG_CTX, "sp": n, "one_card_requests": report,
          "logp_tolerance": LOGP_TOL, **result})
    check_forwards(result["cards"]["profile_one_request"],
                   {"flash_fwd_sm90 carry": LONG_LAYERS * n * n}, "ring request across cards")
    if not all(r["vs_one_card"]["ok"] for r in result.values()):
        raise SystemExit("the ring across cards disagrees with the one-card run")


T5_EDGE_CASES = [
    # name, (B, H, Lq, Lk, D), key lengths, bidirectional, (buckets, max distance), dtype
    ("causal", (2, 4, 130, 130, 64), [130, 77], False, (32, 128), torch.bfloat16),
    ("ragged_100x300", (2, 4, 100, 300, 64), [300, 129], True, (32, 128), torch.bfloat16),
    ("dead_row", (3, 4, 96, 96, 64), [96, 0, 40], True, (32, 128), torch.bfloat16),
    ("d32", (2, 4, 200, 200, 32), [200, 90], True, (32, 128), torch.bfloat16),
    ("d128", (2, 4, 200, 200, 128), [200, 90], True, (32, 128), torch.bfloat16),
    ("f32", (2, 4, 150, 170, 64), [170, 60], True, (32, 128), torch.float32),
    ("f32_causal", (2, 3, 77, 77, 32), [77, 20], False, (32, 128), torch.float32),
    ("buckets32_maxd256", (2, 4, 600, 600, 64), [600, 400], True, (32, 256), torch.bfloat16),
]


def check_t5_kernel(fa, main_case) -> dict:
    """Phase 3, the T5 kernel: its entry on the card against the plain
    version on the same per-distance table, with learned tables of standard
    deviation 1 (so the bias matters beside the scores); the relative
    position reversed (k - q read as q - k) and the table of head h + 1 must
    fail the same check."""
    results, inputs = [], None
    for i, (name, (B, H, Lq, Lk, D), lengths, bidir, (nb, maxd), dtype) in enumerate(
            T5_EDGE_CASES + [main_case]):
        q, k, v, mask = attn_inputs(B, H, Lq, Lk, D, dtype, lengths, seed=400 + i)
        rel_bias = torch.randn(nb, H, generator=torch.Generator().manual_seed(i)).to(CARD)
        table = fa.distance_bias_table(rel_bias, bidirectional=bidir, max_distance=maxd)
        got = fa.flash_attention_t5(q, k, v, mask, rel_bias, bidirectional=bidir,
                                    max_distance=maxd)
        want = fa.flash_attention_t5_reference(q, k, v, mask, table, max_distance=maxd)
        ok, err, rel = compare(got, want, dtype)
        if len(lengths) == B and 0 in lengths:
            dead = torch.as_tensor(np.asarray(lengths) == 0, device=got.device)
            ok = ok and bool((got[dead] == 0).all())
        faults = {
            "reversed_position": fa.flash_attention_t5_reference(
                q, k, v, mask, table.flip(-1), max_distance=maxd),
            "bias_of_head_h+1": fa.flash_attention_t5_reference(
                q, k, v, mask, table.roll(-1, 0), max_distance=maxd),
        }
        fault_rel = {f: compare(out, want, dtype)[2] for f, out in faults.items()}
        caught = all(not compare(out, want, dtype)[0] for out in faults.values())
        results.append({"case": name, "dtype": str(dtype).split(".")[-1],
                        "shape": [B, H, Lq, Lk, D], "bidirectional": bidir,
                        "buckets_max_distance": [nb, maxd], "max_abs_err": err,
                        "max_rel_err": rel, "fault_rel_err": fault_rel, "ok": ok,
                        "faults_caught": caught})
        if name.startswith("t5_large/"):
            inputs = (q, k, v, mask, rel_bias, table, lengths)
    # The launcher refuses what the kernel does not take.
    q, k, v, mask, _, table, _ = inputs
    refused = {}
    for why, args in (("cpu", (q.cpu(), k.cpu(), v.cpu(), mask.cpu(), table.cpu())),
                      ("f16", (q.half(), k.half(), v.half(), mask, table)),
                      ("table_shape", (q, k, v, mask, table[:, :-1])),
                      ("table_bf16", (q, k, v, mask, table.bfloat16())),
                      ("mask_shape", (q, k, v, mask[..., :-1], table))):
        try:
            fa._launch_t5(*args, 128, 1.0)
            refused[why] = False
        except ValueError:
            refused[why] = True
    torch.cuda.synchronize()
    emit({"phase": "t5_kernel_vs_plain", "tolerance": {"bf16": TOL[torch.bfloat16],
                                                       "f32": TOL[torch.float32]},
          "rel_tolerance": {"bf16": REL_TOL[torch.bfloat16], "f32": REL_TOL[torch.float32]},
          "cases": results, "refused": refused})
    bad = [r for r in results if not (r["ok"] and r["faults_caught"])]
    if bad or not all(refused.values()):
        raise SystemExit(f"T5 kernel check failed: {bad}, refused {refused}")
    main = results[-1]
    return {"inputs": inputs, "max_abs_err": main["max_abs_err"],
            "max_rel_err": main["max_rel_err"]}


def count_emitted(token_chunks, pad_id: int, eos_id: int) -> int:
    """Generated tokens of the real rows, EOS and padding excluded."""
    rows = [t.numpy()[:n] for t, n in token_chunks]
    return sum(int(((r != pad_id) & (r != eos_id)).sum()) for r in rows)


def summarize_phase(fa, summarize, rt) -> dict:
    """Phase 8: bench.py's summarize leg through the op's phases (stage,
    execute, finalize, as a pipelined caller drives them). Returns the
    serving kernel's launches over the requests' runs."""
    from agent_tpu_torch.models.tokenizer import EOS_ID, PAD_ID
    from agent_tpu_torch.runtime.context import OpContext
    from agent_tpu_torch.runtime.runtime import TorchRuntime

    ctx = OpContext(runtime=rt)
    requests = [
        ("texts256_greedy", {"texts": [S2S_TEXT] * S2S_ROWS, "max_length": S2S_MAX_NEW},
         S2S_ROWS),
        ("texts64_beam4", {"texts": [S2S_TEXT] * S2S_BEAM_ROWS, "max_length": S2S_MAX_NEW,
                           "num_beams": S2S_BEAMS}, S2S_BEAM_ROWS),
    ]
    t0 = time.perf_counter()
    summarize(dict(requests[0][1], texts=[S2S_TEXT]), ctx)  # builds the weights once
    weights_s = time.perf_counter() - t0
    want = {key: 0 for key in fa.LAUNCH_COUNTS}
    want["flash_attention"] = S2S_ENC_LAYERS
    report = []
    reset_counts(fa)
    for name, payload, n_rows in requests:
        walls, emitted = [], []
        for rep in range(REPS + 1):
            before, sel = dict(fa.LAUNCH_COUNTS), dict(fa.SELECTION_COUNTS)
            t0 = time.perf_counter()
            _, state = summarize.stage(dict(payload), ctx)
            state = summarize.execute(state, ctx)
            out = summarize.finalize(state, ctx)
            wall = time.perf_counter() - t0
            got = {key: fa.LAUNCH_COUNTS[key] - before[key] for key in want}
            selected = {key: fa.SELECTION_COUNTS[key] - sel[key] for key in ("flash", "dense")}
            if not out.get("ok") or out.get("device") != torch.device(CARD).type \
                    or len(out.get("summaries", [])) != n_rows:
                raise SystemExit(f"{name} did not run on cuda: {str(out)[:500]}")
            if got != want or selected != {"flash": S2S_ENC_LAYERS, "dense": 0}:
                raise SystemExit(f"{name}: launches {got} (want {want}), selection {selected}")
            if rep:
                walls.append(wall)
                emitted.append(count_emitted(state["token_chunks"], PAD_ID, EOS_ID))
        p50 = statistics.median(walls)
        report.append({"request": name, "rows": n_rows, "max_length": S2S_MAX_NEW,
                       "num_beams": payload.get("num_beams", 1), "p50_ms": p50 * 1e3,
                       "rows_per_s": n_rows / p50,
                       "emitted_tokens": statistics.median(emitted),
                       "emitted_tokens_per_s": statistics.median(emitted) / p50,
                       "bench_tokens_per_s": n_rows * S2S_MAX_NEW / p50,
                       "summary_0": out["summaries"][0][:80]})
    launches = fa.LAUNCH_COUNTS["flash_attention"]
    profile = profile_call(lambda: summarize(dict(requests[0][1]), ctx))

    # A small f32 config: the op on the card against the same op on the CPU.
    small = {"texts": random_texts(random.Random(SEED + 8), 12, 20, 200),
             "model_config": SMALL_S2S_F32, "max_length": 24}
    small_out = {}
    for beams in (1, 3):
        payload = dict(small, num_beams=beams)
        card = summarize(dict(payload), ctx)
        cpu = summarize(dict(payload), OpContext(runtime=TorchRuntime(device="cpu")))
        small_out[f"beams{beams}"] = {"same_summaries": card["summaries"] == cpu["summaries"],
                                      "devices": [card["device"], cpu["device"]]}
    torch.cuda.synchronize()
    emit({"phase": "summarize", "config": "Seq2SeqConfig defaults (d_model 256, 8 heads, "
          "4 + 4 layers, d_ff 1024, vocab 260, bf16)", "weights_build_s": weights_s,
          "requests": report, "launches": launches, "profile_256_rows_greedy": profile,
          "small_f32_card_vs_cpu": small_out})
    check_forwards(profile, {"flash_fwd_sm90": S2S_ENC_LAYERS}, "summarize request")
    if not all(r["same_summaries"] for r in small_out.values()):
        raise SystemExit(f"small f32 summaries differ between the card and the CPU: {small_out}")
    return {"launches": launches}


def write_t5_checkpoint(path, hf: dict, seed: int, dtype, device) -> None:
    """config.json and pytorch_model.bin with HF names, drawn from a seeded
    torch.Generator at HF T5's _init_weights standard deviations (shared
    1.0; q (d_model d_kv)^-1/2; k, v d_model^-1/2; o (H d_kv)^-1/2; wi
    d_model^-1/2; wo d_ff^-1/2; relative bias d_model^-1/2; norms 1)."""
    d, kv, H, f = hf["d_model"], hf["d_kv"], hf["num_heads"], hf["d_ff"]
    inner = H * kv
    gen = torch.Generator(device=device).manual_seed(seed)
    sd = {}

    def put(key, shape, std):
        sd[key] = (torch.randn(shape, generator=gen, device=device) * std).to(dtype).cpu()

    def ones(key, n):
        sd[key] = torch.ones(n, dtype=dtype)

    put("shared.weight", (hf["vocab_size"], d), 1.0)
    gated = hf["feed_forward_proj"].startswith("gated")
    for stack, n_layers, cross in (("encoder", hf["num_layers"], False),
                                   ("decoder", hf["num_decoder_layers"], True)):
        put(f"{stack}.block.0.layer.0.SelfAttention.relative_attention_bias.weight",
            (hf["relative_attention_num_buckets"], H), d ** -0.5)
        ones(f"{stack}.final_layer_norm.weight", d)
        for i in range(n_layers):
            p = f"{stack}.block.{i}.layer"
            attns = [f"{p}.0.SelfAttention"] + ([f"{p}.1.EncDecAttention"] if cross else [])
            for a in attns:
                put(f"{a}.q.weight", (inner, d), (d * kv) ** -0.5)
                put(f"{a}.k.weight", (inner, d), d ** -0.5)
                put(f"{a}.v.weight", (inner, d), d ** -0.5)
                put(f"{a}.o.weight", (d, inner), inner ** -0.5)
            for j in range(3 if cross else 2):
                ones(f"{p}.{j}.layer_norm.weight", d)
            ff = f"{p}.{2 if cross else 1}.DenseReluDense"
            for wi in (("wi_0", "wi_1") if gated else ("wi",)):
                put(f"{ff}.{wi}.weight", (f, d), d ** -0.5)
            put(f"{ff}.wo.weight", (d, f), f ** -0.5)
    if not hf["tie_word_embeddings"]:
        put("lm_head.weight", (hf["vocab_size"], d), d ** -0.5)
    with open(f"{path}/config.json", "w") as fh:
        json.dump(hf, fh)
    torch.save(sd, f"{path}/pytorch_model.bin")


def seeded_normal(gen, device, dtype, std):
    """``normal(shape)``: a tensor of that shape drawn from ``gen`` at
    standard deviation ``std``, in ``dtype`` on the CPU."""
    def normal(shape, mean=0.0):
        return (torch.randn(shape, generator=gen, device=device) * std + mean).to(dtype).cpu()
    return normal


def bert_state_dict(hf: dict, seed: int, dtype, device="cpu", std: float = 0.02) -> dict:
    """A BertForSequenceClassification state dict with HF names (``bert.``
    prefix, [out, in] linear weights, the position_ids buffer), every weight
    and bias drawn at standard deviation ``std`` (BERT's initializer_range)
    from a seeded generator, layer norm scales around 1."""
    d, f = hf["hidden_size"], hf["intermediate_size"]
    normal = seeded_normal(torch.Generator(device=device).manual_seed(seed), device, dtype, std)
    sd = {}

    def linear(name, n_out, n_in):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = normal((n_out, n_in)), normal((n_out,))

    def norm(name):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = normal((d,), 1.0), normal((d,))

    e = "bert.embeddings"
    sd[f"{e}.word_embeddings.weight"] = normal((hf["vocab_size"], d))
    sd[f"{e}.position_embeddings.weight"] = normal((hf["max_position_embeddings"], d))
    sd[f"{e}.token_type_embeddings.weight"] = normal((hf["type_vocab_size"], d))
    sd[f"{e}.position_ids"] = torch.arange(hf["max_position_embeddings"])[None]
    norm(f"{e}.LayerNorm")
    for i in range(hf["num_hidden_layers"]):
        p = f"bert.encoder.layer.{i}"
        for name in ("query", "key", "value"):
            linear(f"{p}.attention.self.{name}", d, d)
        linear(f"{p}.attention.output.dense", d, d)
        norm(f"{p}.attention.output.LayerNorm")
        linear(f"{p}.intermediate.dense", f, d)
        linear(f"{p}.output.dense", d, f)
        norm(f"{p}.output.LayerNorm")
    linear("bert.pooler.dense", d, d)
    if hf.get("num_labels"):
        linear("classifier", hf["num_labels"], d)
    return sd


def bart_state_dict(hf: dict, seed: int, dtype, device="cpu", std: float = 0.02) -> dict:
    """A BartForConditionalGeneration state dict with HF names (``model.``
    prefix, [out, in] linear weights, learned positions with HF's offset of
    2 rows, final_logits_bias), every weight and bias drawn at standard
    deviation ``std`` (BART's init_std) from a seeded generator, layer norm
    scales around 1."""
    d, f = hf["d_model"], hf["encoder_ffn_dim"]
    normal = seeded_normal(torch.Generator(device=device).manual_seed(seed), device, dtype, std)
    sd = {"model.shared.weight": normal((hf["vocab_size"], d))}

    def linear(name, n_out, n_in):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = normal((n_out, n_in)), normal((n_out,))

    def norm(name):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = normal((d,), 1.0), normal((d,))

    for stack in ("encoder", "decoder"):
        s = f"model.{stack}"
        sd[f"{s}.embed_positions.weight"] = normal((hf["max_position_embeddings"] + 2, d))
        norm(f"{s}.layernorm_embedding")
        for i in range(hf[f"{stack}_layers"]):
            p = f"{s}.layers.{i}"
            attns = ["self_attn"] + (["encoder_attn"] if stack == "decoder" else [])
            for a in attns:
                for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                    linear(f"{p}.{a}.{proj}", d, d)
                norm(f"{p}.{a}_layer_norm")
            linear(f"{p}.fc1", f, d)
            linear(f"{p}.fc2", d, f)
            norm(f"{p}.final_layer_norm")
    sd["final_logits_bias"] = normal((1, hf["vocab_size"]))
    return sd


def write_hf_checkpoint(path, hf: dict, sd: dict, safetensors: bool = False) -> None:
    """config.json and the weights under ``path``: pytorch_model.bin
    (torch.save), or with ``safetensors`` model.safetensors (the port's
    writer)."""
    from agent_tpu_torch.models import safetensors_io

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as fh:
        json.dump(hf, fh)
    if safetensors:
        safetensors_io.save_file(sd, os.path.join(path, "model.safetensors"),
                                 {"format": "pt"})
    else:
        torch.save(sd, os.path.join(path, "pytorch_model.bin"))


def synthetic_words(n: int, seed: int) -> list:
    """n distinct lower-case words of 2-9 letters, from a seeded generator."""
    rng = random.Random(seed)
    words, seen = [], set()
    while len(words) < n:
        w = "".join(rng.choice("abcdefghijklmnopqrstuvwxyz") for _ in range(rng.randint(2, 9)))
        if w not in seen:
            seen.add(w)
            words.append(w)
    return words


BERT_SPECIALS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")


def write_wordpiece_vocab(path, vocab_size: int, seed: int, extra=()) -> list:
    """vocab.txt of ``vocab_size`` lines: BERT's special tokens, the
    printable ASCII characters and their ``##`` forms, ``extra`` tokens,
    then generated words. Returns the words."""
    chars = [chr(c) for c in range(33, 127) if not chr(c).isupper()]
    head = list(BERT_SPECIALS) + chars + ["##" + c for c in chars] + list(extra)
    words = synthetic_words(vocab_size - len(head), seed)
    with open(os.path.join(path, "vocab.txt"), "w", encoding="utf-8") as fh:
        fh.write("\n".join(head + words) + "\n")
    return words


BART_SPECIALS = ("<s>", "<pad>", "</s>", "<unk>")


def write_bpe_vocab(path, n_merges: int, seed: int) -> list:
    """vocab.json and merges.txt of a byte-level BPE: BART's four special
    tokens, the 256 byte symbols, then merges that build generated words
    left to right, each bare and after a space (GPT-2's "Ġ"), until
    ``n_merges``. Returns the words whose merges are all present."""
    from agent_tpu_torch.models.bpe import bytes_to_unicode

    byte_syms = list(bytes_to_unicode().values())
    vocab = {t: i for i, t in enumerate(list(BART_SPECIALS) + byte_syms)}
    merges, words = [], []
    for word in synthetic_words(n_merges, seed):
        for form in (word, "\u0120" + word):
            for j in range(1, len(form)):
                pair = (form[:j], form[j])
                if form[:j + 1] not in vocab:
                    vocab[form[:j + 1]] = len(vocab)
                    merges.append(pair)
        if len(merges) > n_merges:
            break
        words.append(word)
    with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as fh:
        json.dump(vocab, fh, ensure_ascii=False)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as fh:
        fh.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    return words


class StagedIds:
    """Stands in for a checkpoint's SentencePiece model at staging time: the
    request's text "i" has the pieces ``rows[i]`` (the op's staging then
    appends </s> and buckets as it does for real text)."""

    def __init__(self, rows) -> None:
        self.rows = rows

    def EncodeAsIds(self, text):  # noqa: N802 — SentencePiece's name
        return self.rows[int(text)]


def stage_t5(op, ckpt, cfg, rows, num_beams) -> list:
    """The op's own staging (stage_text_chunks with t5.encode_pad_batch) of
    pre-drawn id rows: ``t5.hf_spm`` answers with the stand-in meanwhile."""
    from agent_tpu_torch.models import t5

    real = t5.hf_spm
    t5.hf_spm = lambda path: StagedIds(rows)
    try:
        return op._stage_chunks([str(i) for i in range(len(rows))], cfg, num_beams, "t5", ckpt)
    finally:
        t5.hf_spm = real


def t5_rows(n: int, vocab: int, lengths, seed: int) -> list:
    """n rows of random piece ids in [2, vocab), one fewer than the drawn
    length (staging appends </s>)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, size=int(L) - 1).tolist()
            for L in rng.integers(lengths[0], lengths[1] + 1, size=n)]


def t5_plain_kernel(fa, reverse: bool = False):
    """The T5 attention through the kernel's plain version (the yardstick),
    or with the relative position reversed (the planted fault)."""
    def attend(q, k, v, mask, rel_bias, *, bidirectional, max_distance, scale):
        table = fa.distance_bias_table(rel_bias, bidirectional=bidirectional,
                                       max_distance=max_distance)
        return fa.flash_attention_t5_reference(q, k, v, mask,
                                               table.flip(-1) if reverse else table,
                                               max_distance=max_distance, scale=scale)
    return attend


def teacher_forced(t5, fa, rt, params, cfg, ids, lengths, tgt) -> dict:
    """Log-probabilities of decode_full on the encoder output of the kernel,
    of the plain T5 attention and of the planted reversed position: the
    largest difference of each pair over every position and token."""
    mask = (torch.arange(ids.shape[1], device=ids.device)[None, :]
            < lengths[:, None]).to(torch.int32)
    logp = {}
    with torch.inference_mode():
        for name, kernel in (("kernel", rt.t5_attention_kernel()),
                             ("plain", t5_plain_kernel(fa)),
                             ("reversed", t5_plain_kernel(fa, reverse=True))):
            enc = t5.encode(params, ids, mask, cfg, kernel=kernel)
            logp[name] = torch.log_softmax(t5.decode_full(params, tgt, enc, mask, cfg), dim=-1)
    return {"kernel_vs_plain": (logp["kernel"] - logp["plain"]).abs().max().item(),
            "reversed_vs_plain": (logp["reversed"] - logp["plain"]).abs().max().item(),
            "finite": bool(torch.isfinite(logp["kernel"]).all())}


def t5_phase(fa, op, rt, ckpt, requests) -> dict:
    """Phase 9: T5-large through the op's device phase. ``requests``:
    (name, staged chunks, num_beams, rows). Returns the T5 kernel's
    launches over the requests' runs."""
    from agent_tpu_torch.models import t5
    from agent_tpu_torch.runtime.runtime import TorchRuntime

    family = op._resolve_family(ckpt)
    cfg = op._get_cfg({"model_path": ckpt}, family, ckpt)
    if family != "t5" or (cfg.d_model, cfg.n_heads, cfg.n_enc_layers, cfg.n_dec_layers) \
            != tuple(T5_LARGE[f] for f in ("d_model", "num_heads", "num_layers",
                                            "num_decoder_layers")):
        raise SystemExit(f"the op resolved {family} {cfg}")
    before_bytes = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = rt.get_params(op.params_key(ckpt, family, cfg),
                           lambda: op._build_model(ckpt, cfg, family, rt.device))
    load_s = time.perf_counter() - t0
    weights_bytes = torch.cuda.memory_allocated() - before_bytes
    want = {key: 0 for key in fa.LAUNCH_COUNTS}
    want["flash_attention_t5"] = cfg.n_enc_layers
    report, outputs = [], {}
    reset_counts(fa)
    for name, chunks, beams, n_rows in requests:
        walls, emitted = [], []
        torch.cuda.reset_peak_memory_stats()
        for rep in range(REPS + 1):
            before, sel = dict(fa.LAUNCH_COUNTS), dict(fa.SELECTION_COUNTS)
            t0 = time.perf_counter()
            pending = op._decode_chunks(rt, chunks, ckpt, cfg, T5_MAX_NEW, beams, family=family)
            toks = [(t.cpu(), n) for t, n in pending]
            wall = time.perf_counter() - t0
            got = {key: fa.LAUNCH_COUNTS[key] - before[key] for key in want}
            selected = {key: fa.SELECTION_COUNTS[key] - sel[key]
                        for key in ("t5_flash", "t5_dense")}
            if got != want or selected != {"t5_flash": cfg.n_enc_layers, "t5_dense": 0}:
                raise SystemExit(f"{name}: launches {got} (want {want}), selection {selected}")
            if rep:
                walls.append(wall)
                emitted.append(count_emitted(toks, cfg.pad_id, cfg.eos_id))
        outputs[name] = toks[0][0][:toks[0][1]]
        p50 = statistics.median(walls)
        report.append({"request": name, "rows": n_rows, "num_beams": beams,
                       "src_len": int(chunks[0][0].shape[1]), "max_new": T5_MAX_NEW,
                       "p50_ms": p50 * 1e3, "rows_per_s": n_rows / p50,
                       "emitted_tokens": statistics.median(emitted),
                       "emitted_tokens_per_s": statistics.median(emitted) / p50,
                       "bench_tokens_per_s": n_rows * T5_MAX_NEW / p50,
                       "peak_bytes": torch.cuda.max_memory_allocated(),
                       "all_rows_finite_ids": bool(((outputs[name] >= 0)
                                                    & (outputs[name] < cfg.vocab_size)).all())})
    launches = fa.LAUNCH_COUNTS["flash_attention_t5"]
    greedy_chunks = requests[0][1]
    profile = profile_call(lambda: [t.cpu() for t, _ in op._decode_chunks(
        rt, greedy_chunks, ckpt, cfg, T5_MAX_NEW, 1, family=family)])
    check_forwards(profile, {"flash_fwd_sm90 bias": cfg.n_enc_layers}, "T5 request")

    # Teacher-forced log-probabilities on the greedy tokens: the kernel's
    # encoder against the plain T5 attention's, and the planted reversed
    # position, on the checkpoint as written and with both relative bias
    # tables redrawn at T5_FAULT_BIAS_STD.
    ids_np, lengths_np, n = greedy_chunks[0]
    ids = rt.put_batch(ids_np.astype(np.int32))
    lengths = rt.put_batch(lengths_np)
    gen = outputs[requests[0][0]].to(rt.device, torch.int64)
    tgt = torch.cat([torch.full((gen.shape[0], 1), cfg.decoder_start_id, device=rt.device,
                                dtype=torch.int64), gen[:, :-1]], dim=1)
    ids, lengths = ids[:n], lengths[:n]
    as_written = teacher_forced(t5, fa, rt, params, cfg, ids, lengths, tgt)
    g = torch.Generator(device=rt.device).manual_seed(SEED)
    redrawn = {**params,
               "enc": {**params["enc"], "rel_bias": torch.randn(
                   params["enc"]["rel_bias"].shape, generator=g, device=rt.device)
                   * T5_FAULT_BIAS_STD},
               "dec": {**params["dec"], "rel_bias": torch.randn(
                   params["dec"]["rel_bias"].shape, generator=g, device=rt.device)
                   * T5_FAULT_BIAS_STD}}
    strong_bias = teacher_forced(t5, fa, rt, redrawn, cfg, ids, lengths, tgt)
    logp_tol = LOGP_TOL["bfloat16"]

    # A small f32 T5 (gated-gelu, untied): the device phase on the card
    # against the same on the CPU.
    small_dir = f"{ckpt}_small_f32"
    os.makedirs(small_dir, exist_ok=True)
    write_t5_checkpoint(small_dir, SMALL_T5_F32, SEED + 9, torch.float32, "cpu")
    small_cfg = op._get_cfg({"model_path": small_dir, "model_config": {"dtype": "float32"}},
                            "t5", small_dir)
    small_rows = t5_rows(12, SMALL_T5_F32["vocab_size"], (20, 60), SEED + 10)
    small = {}
    for beams in (1, 3):
        chunks = stage_t5(op, small_dir, small_cfg, small_rows, beams)
        toks = {}
        for where, run_rt in (("cuda", rt), ("cpu", TorchRuntime(device="cpu"))):
            (t, n_s), = op._decode_chunks(run_rt, chunks, small_dir, small_cfg, 16, beams,
                                          family="t5")
            toks[where] = t.cpu()[:n_s]
        small[f"beams{beams}"] = bool(torch.equal(toks["cuda"], toks["cpu"]))
    rt.evict_params(op.params_key(small_dir, "t5", small_cfg))
    torch.cuda.synchronize()
    emit({"phase": "t5_large", "config": T5_LARGE,
          "weights": "random from a seeded generator at HF T5 init scales, bf16; not pretrained",
          "load_s": load_s, "weights_bytes_on_card": weights_bytes, "requests": report,
          "launches_per_encoder_pass": cfg.n_enc_layers, "launches": launches,
          "profile_64_rows_greedy": profile, "logp_tolerance": logp_tol,
          "teacher_forced_as_written": as_written,
          "teacher_forced_bias_std_1": strong_bias,
          "small_f32_card_vs_cpu_same_tokens": small})
    if not (as_written["finite"] and as_written["kernel_vs_plain"] <= logp_tol
            and strong_bias["kernel_vs_plain"] <= logp_tol
            and strong_bias["reversed_vs_plain"] > logp_tol):
        raise SystemExit("T5 log-probabilities disagree (or the planted fault went unnoticed)")
    if not all(r["all_rows_finite_ids"] for r in report) or not all(small.values()):
        raise SystemExit(f"T5 outputs out of range or card and CPU disagree: {small}")
    return {"launches": launches}


def t5_kernel_entry(fa, check, launches, **extra) -> dict:
    """The kernels line's entry of the T5 kernel at phase 9's staged shape
    and key lengths, timed through its launcher with the per-distance table
    built once outside the timing (``entry_ms``: the entry point, which
    builds the table and the int32 keep each call). Its library yardstick is
    scaled_dot_product_attention with the relative bias and the padding
    mask materialised as one float mask [B, H, L, L] (in the input dtype,
    as SDPA takes it), also outside the timing."""
    q, k, v, mask, rel_bias, table, lengths = check["inputs"]
    B, H, L, D = q.shape
    maxd = T5_LARGE["relative_attention_max_distance"]
    pos = torch.arange(L, device=q.device)
    rel = (pos[None, :] - pos[:, None]).clamp(-maxd, maxd) + maxd
    float_mask = (table[:, rel][None] + torch.where(mask > 0, 0.0, fa.NEG_INF)).to(q.dtype)
    entry = kernel_entry(
        "flash_attention_t5", "agent_tpu_torch/kernels/csrc/flash_fwd_sm90.cuh", SM90,
        "agent_tpu/kernels/flash_attention.py:354", launches,
        check["max_abs_err"], check["max_rel_err"],
        cuda_ms(lambda: fa._launch_t5(q, k, v, mask, table, maxd, 1.0)),
        cuda_ms(lambda: fa.flash_attention_t5_reference(q, k, v, mask, table,
                                                        max_distance=maxd), iters=5),
        4 * B * H * L * D * q.element_size() + mask.numel() * mask.element_size()
        + table.numel() * 4 + rel_bias.numel() * 4,
        4 * H * L * D * float(np.sum(lengths)),  # products with real keys only
        cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=float_mask, scale=1.0)), q,
        library_note="SDPA with the bias and padding mask as one float attn_mask, "
                     "materialised outside the timing",
        entry_ms=cuda_ms(lambda: fa.flash_attention_t5(q, k, v, mask, rel_bias,
                                                       max_distance=maxd)), **extra)
    del float_mask
    return entry


class StandInController:
    """A controller for phases 10, 13 and 15, kept in this script because
    chip_smoke imports nothing of agent_tpu. It speaks the protocol of
    agent_tpu/agent/app.py:3-11 on 127.0.0.1:

    - ``POST /v1/leases``: up to ``max_tasks`` pending jobs whose op the
      agent offers, each at a bumped ``job_epoch``, with the reference
      controller's trace context (``trace: {trace_id: job id, span_id: the
      lease span}``, agent_tpu/controller/core.py:235-242); 204 when there
      is none (and for the metrics-only poll); ``wire: "b1"`` when the
      lease offers it; the next queued ``alerts`` list (``queue_alerts``:
      ``slo_page`` and ``profile_capture`` in the reference's shapes,
      core.py:2780-2789) on a granted lease. The ``metrics`` channel's
      ``spans`` and ``profile_captures`` are collected, and its ``obs``
      snapshot kept per agent;
    - ``POST /v1/results``: accepted only with the lease's id and the
      job's current ``job_epoch``; a ``b1`` result is decoded with the
      port's ``data/wire.py`` (held byte for byte to the reference's by
      tests/test_torch_wire.py); ``released`` puts the job back. The body's
      ``spans`` are collected whether or not the result is accepted.

    - ``GET /v1/status``: ``{"agents": {name: {polls, last_seen}}}``, every
      agent that has polled (the reference's ``agents_summary``, which
      ``agent/fleet.wait_for_agents`` reads).

    Each job's trace holds the stand-in's own ``submit`` root and one
    ``lease`` span per lease, closed by the result. Every post is counted
    per job, so a shard reported twice shows; each job records the agent
    that leased it. ``agent_cap`` caps the tasks an agent holds leased at
    once (a fleet's members then share the shards)."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.jobs: dict = {}
        self.posts: dict = {}
        self.stale = 0
        self.b1_leases = 0
        self._n = 0
        self.spans: dict = {}  # trace id -> {span id: span}
        self.spans_shipped = 0  # spans the agents sent
        self.captures: list = []  # profile_captures completion records
        self.agent_obs: dict = {}  # agent name -> its last obs snapshot
        self.agents: dict = {}  # agent name -> {polls, last_seen}
        self.agent_cap = None  # at most this many leased tasks an agent (None: no cap)
        self._alerts: list = []  # alert lists for the next granted leases
        ctrl = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server's name
                with ctrl.lock:
                    out = {"agents": {k: dict(v) for k, v in ctrl.agents.items()}} \
                        if self.path == "/v1/status" else {"error": "no such route"}
                data = json.dumps(out).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_POST(self):  # noqa: N802 — http.server's name
                body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
                if self.path == "/v1/leases":
                    out = ctrl.lease(body)
                elif self.path == "/v1/results":
                    out = ctrl.report(body)
                else:
                    out = {"error": "no such route"}
                data = b"" if out is None else json.dumps(out).encode()
                self.send_response(204 if out is None else 200)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=10)

    def _open_span(self, job_id: str, name: str, parent) -> str:
        from agent_tpu_torch.obs.trace import make_span

        span = make_span(name, job_id, parent, process="controller")
        span["duration_ms"] = None  # open until the result closes it
        self.spans.setdefault(job_id, {})[span["span_id"]] = span
        return span["span_id"]

    def _close_span(self, job_id: str, span_id, **attributes) -> None:
        span = self.spans.get(job_id, {}).get(span_id)
        if span is not None and span["duration_ms"] is None:
            span["duration_ms"] = round((time.monotonic() - span["start_mono"]) * 1e3, 3)
            span["attributes"].update(attributes)

    def _ingest(self, spans) -> None:
        for span in spans or []:
            self.spans_shipped += 1
            self.spans.setdefault(span["trace_id"], {})[span["span_id"]] = span

    def submit(self, op: str, payload: dict) -> str:
        with self.lock:
            self._n += 1
            job_id = f"job-{self._n:05d}"
            self.jobs[job_id] = {"op": op, "payload": payload, "epoch": 0, "state": "pending",
                                 "lease": None, "status": None, "result": None,
                                 "root": self._open_span(job_id, "submit", None),
                                 "lease_span": None}
        return job_id

    def queue_alerts(self, alerts: list) -> None:
        """Hand ``alerts`` out with the next granted lease."""
        with self.lock:
            self._alerts.append(alerts)

    def trace(self, job_id: str) -> list:
        with self.lock:
            return [dict(s) for s in self.spans.get(job_id, {}).values()]

    def submit_csv(self, path: str, op: str, start: int, rows: int, shard: int,
                   extra: dict) -> list:
        """Shard rows [start, start + rows) of the CSV into ``op`` tasks."""
        return [self.submit(op, dict(extra, source_uri=path, start_row=s,
                                     shard_size=min(shard, start + rows - s)))
                for s in range(start, start + rows, shard)]

    def drained(self) -> bool:
        with self.lock:
            return all(j["state"] == "done" for j in self.jobs.values())

    def lease(self, body: dict):
        caps = body.get("capabilities") or {}
        ops = set(caps.get("ops") or [])
        metrics = body.get("metrics") or {}
        with self.lock:
            self._ingest(metrics.get("spans"))
            self.captures += metrics.get("profile_captures") or []
            if body.get("agent") and "obs" in metrics:
                self.agent_obs[body["agent"]] = metrics["obs"]
            if body.get("agent"):
                seen = self.agents.setdefault(body["agent"], {"polls": 0})
                seen.update(polls=seen["polls"] + 1, last_seen=time.time())
            picked = [j for j, job in self.jobs.items()
                      if job["state"] == "pending" and job["op"] in ops]
            room = int(body.get("max_tasks") or 0)
            if self.agent_cap is not None:
                held = sum(1 for job in self.jobs.values()
                           if job["state"] == "leased" and job.get("agent") == body.get("agent"))
                room = min(room, self.agent_cap - held)
            picked = picked[:max(room, 0)]
            if not picked:
                return None
            self._n += 1
            lease_id = f"lease-{self._n:05d}"
            tasks = []
            for j in picked:
                job = self.jobs[j]
                job.update(state="leased", epoch=job["epoch"] + 1, lease=lease_id,
                           lease_span=self._open_span(j, "lease", job["root"]),
                           agent=body.get("agent"))
                tasks.append({"id": j, "op": job["op"], "payload": job["payload"],
                              "job_epoch": job["epoch"], "attempt": job["epoch"],
                              "trace": {"trace_id": j, "span_id": job["lease_span"]}})
            out = {"lease_id": lease_id, "tasks": tasks}
            if self._alerts:
                out["alerts"] = self._alerts.pop(0)
            if "b1" in (caps.get("wire_formats") or []):
                out["wire"] = "b1"
                self.b1_leases += 1
            return out

    def report(self, body: dict) -> dict:
        from agent_tpu_torch.data import wire

        job_id = body.get("job_id")
        with self.lock:
            self._ingest(body.get("spans"))
            self.posts[job_id] = self.posts.get(job_id, 0) + 1
            job = self.jobs.get(job_id)
            if job is None or job["state"] != "leased" or body.get("lease_id") != job["lease"] \
                    or body.get("job_epoch") != job["epoch"]:
                self.stale += 1
                return {"accepted": False, "reason": "stale or unknown"}
            self._close_span(job_id, job["lease_span"], outcome=body.get("status"))
            if body.get("status") == "released":
                job["state"] = "pending"
                return {"accepted": True, "released": True}
            self._close_span(job_id, job["root"])
            result = body.get("result")
            job["b1"] = wire.is_binary_result(result)
            if job["b1"]:
                result = wire.decode_result(result)
            job.update(state="done", status=body.get("status"), result=result,
                       error=body.get("error"))
            return {"accepted": True}

    def outcome(self, job_ids: list) -> list:
        """The accepted results of ``job_ids``; fails unless each succeeded,
        was posted exactly once and came over the b1 wire."""
        out = []
        for j in job_ids:
            job = self.jobs[j]
            if job["status"] != "succeeded" or self.posts.get(j) != 1:
                raise SystemExit(f"{j} ({job['op']}): status {job['status']}, posted "
                                 f"{self.posts.get(j)} times, error {job['error']}")
            out.append(job)
        return out


def pipelined_drain(agent, ctrl, profile: bool = False):
    """Run the agent's pipelined runner on this (the device) thread until the
    stand-in controller has every result -> (wall seconds to that moment,
    the profile of the run when asked)."""
    from agent_tpu_torch.agent.pipeline import PipelineRunner

    done = {}

    def run():
        agent.running = True
        t0 = time.perf_counter()

        def watch():
            while not ctrl.drained() and time.perf_counter() - t0 < DRAIN_TIMEOUT_S:
                time.sleep(0.002)
            done["wall"] = time.perf_counter() - t0
            agent.running = False

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        PipelineRunner(agent, depth=agent.config.agent.pipeline_depth).run()
        watcher.join(timeout=30)

    prof = profile_call(run) if profile else run()
    if not ctrl.drained():
        raise SystemExit(f"the drain did not finish in {DRAIN_TIMEOUT_S} s")
    return done["wall"], prof


def serial_shards(fn, rt, payloads) -> tuple:
    """The shards run one after another through the op's phases (stage ->
    execute -> finalize, the JSON result path) -> (results, wall seconds)."""
    from agent_tpu_torch.runtime.context import OpContext

    outs, t0 = [], time.perf_counter()
    for payload in payloads:
        ctx = OpContext(runtime=rt)
        phase, state = fn.stage(dict(payload), ctx)
        if phase != "staged":
            raise SystemExit(f"a serial shard did not stage: {str(state)[:300]}")
        outs.append(fn.finalize(fn.execute(state, ctx), ctx))
    return outs, time.perf_counter() - t0


def p50_phases(results: list) -> dict:
    """The median of each phase's milliseconds over the shards' timings."""
    keys = ("stage_ms", "queue_ms", "device_ms", "fetch_ms", "finalize_ms")
    return {k: statistics.median(r["timings"][k] for r in results) for k in keys}


def drain_payloads(path: str) -> tuple:
    """Phase 10's classify and summarize shard payloads."""
    classify = {"text_field": "text", "result_format": "columnar", "allow_fallback": False,
                "model_config": BERT_BASE, "topk": 5}
    summarize = {"text_field": "text", "max_length": S2S_MAX_NEW, "allow_fallback": False}
    shards = [dict(classify, source_uri=path, start_row=s, shard_size=DRAIN_SHARD)
              for s in range(0, DRAIN_ROWS, DRAIN_SHARD)]
    s2s = [dict(summarize, source_uri=path, start_row=s * DRAIN_SHARD, shard_size=DRAIN_SHARD)
           for s in range(DRAIN_S2S_SHARDS)]
    return classify, summarize, shards, s2s


def write_drain_csv(path: str) -> None:
    """bench.py's drain rows (bench.py:892-896)."""
    with open(path, "w") as f:
        f.write("id,text,risk\n")
        for i in range(DRAIN_ROWS):
            f.write(f'{i},"drain record {i} with a payload of text",{i % 89}\n')


def drain_phase(fa, rt, path: str) -> dict:
    """Phase 10: the port as a swarm worker. The port's Agent, in this
    process with its default urllib session and the pipelined runner
    (PIPELINE_DEPTH 2), drains the stand-in controller's jobs: one warm-up
    shard of each op, then 8 classify shards (the counts set to 0 just
    before, read just after), one profiled shard, one risk_accumulate shard
    of 65,536 values, and a mixed drain of 2 summarize and 2 classify
    shards. The same shards run serially through the ops on the same card
    for the bit-for-bit comparison and the ratio of rows/s."""
    from agent_tpu_torch.agent.app import Agent
    from agent_tpu_torch.config import AgentConfig, Config
    from agent_tpu_torch.data.staging import default_workers
    from agent_tpu_torch.ops import load_ops

    ops = load_ops(["map_classify_tpu", "map_summarize", "risk_accumulate"])
    classify_extra, s2s_extra, shards, s2s_shards = drain_payloads(path)
    device = torch.device(CARD).type
    n_layers = BERT_BASE["n_layers"]
    staged = [ops["map_classify_tpu"].stage(dict(p))[1] for p in shards]
    chunks = [len(state["chunks"]) for state in staged]
    with StandInController() as ctrl:
        agent = Agent(Config(agent=AgentConfig(
            controller_url=ctrl.url, agent_name="chip-smoke-drain",
            tasks=("map_classify_tpu", "map_summarize", "risk_accumulate"),
            idle_sleep_sec=0.005, pipeline_depth=2)), runtime=rt)
        if type(agent.session).__name__ != "UrllibSession":
            raise SystemExit("the agent's default session is not the urllib one")

        # Warm-up: builds both models' weights; not timed.
        t0 = time.perf_counter()
        warm = ctrl.submit_csv(path, "map_classify_tpu", 0, DRAIN_SHARD, DRAIN_SHARD,
                               classify_extra)
        warm += ctrl.submit_csv(path, "map_summarize", 0, DRAIN_SHARD, DRAIN_SHARD, s2s_extra)
        pipelined_drain(agent, ctrl)
        ctrl.outcome(warm)
        warm_s = time.perf_counter() - t0

        # The classify drain: the slice's main path. Each timed pass starts
        # with a full collection, so none lands inside it.
        ids = [ctrl.submit("map_classify_tpu", p) for p in shards]
        torch.cuda.synchronize()
        gc.collect()
        reset_counts(fa)
        wall, _ = pipelined_drain(agent, ctrl)
        launches = fa.LAUNCH_COUNTS["flash_attention"]
        others = {k: v for k, v in fa.LAUNCH_COUNTS.items() if k != "flash_attention" and v}
        dense = fa.SELECTION_COUNTS["dense"]
        jobs = ctrl.outcome(ids)
        results = [j["result"] for j in jobs]
        workers = {"max": agent.config.agent.stage_workers or default_workers(),
                   "picked": agent.obs.gauge("stage_pool_workers").value(),
                   "prefetch_depth": agent.obs.gauge("stage_prefetch_depth").value()}
        bad = [r for r in results if not r.get("ok") or r.get("device") != device
               or "fallback" in r]
        if bad or not all(j["b1"] for j in jobs):
            raise SystemExit(f"drain results not ok on {device} over b1: {str(bad)[:500]}")
        if sum(r["n_rows"] for r in results) != DRAIN_ROWS:
            raise SystemExit(f"the shards' n_rows sum to {sum(r['n_rows'] for r in results)}")
        if launches != n_layers * sum(chunks) or others or dense:
            raise SystemExit(f"row 1 launched {launches} times (want {n_layers} x "
                             f"{sum(chunks)} dispatch chunks), others {others}, dense {dense}")

        # The same shards serially through the op, on the same card.
        gc.collect()
        serial, serial_wall = serial_shards(ops["map_classify_tpu"], rt, shards)
        for r, want in zip(results, serial):
            if r["indices"] != want["indices"] or r["scores"] != want["scores"]:
                raise SystemExit("the drain's decoded columns differ from the serial op's")

        # One more shard, profiled: the device's idle share over the drain.
        one = [ctrl.submit("map_classify_tpu", shards[0])]
        _, profile = pipelined_drain(agent, ctrl, profile=True)
        ctrl.outcome(one)
        check_forwards(profile, {"flash_fwd_sm90": n_layers * chunks[0]}, "profiled shard")

        # risk_accumulate: its device path on the card against the host path.
        rng = np.random.default_rng(SEED + 10)
        values = (rng.standard_normal(DRAIN_RISK_VALUES) * 1e3).tolist()
        values[:3] = [1.4e-45, -3e-39, 5e-40]
        risk_id = ctrl.submit("risk_accumulate", {"values": values})
        pipelined_drain(agent, ctrl)
        (risk_job,) = ctrl.outcome([risk_id])
        risk, host = risk_job["result"], ops["risk_accumulate"]({"values": values})
        bound = DRAIN_RISK_VALUES * 2.0 ** -24 * math.fsum(abs(v) for v in values)
        risk_ok = (risk.get("device") == "mesh" and risk["count"] == DRAIN_RISK_VALUES
                   and risk["min"] == float(np.float32(host["min"]))
                   and risk["max"] == float(np.float32(host["max"]))
                   and abs(risk["sum"] - host["sum"]) <= bound)
        if not risk_ok:
            raise SystemExit(f"risk_accumulate on the card {risk} against the host {host}")

        # The mixed drain: 2 summarize and 2 classify shards in one drain.
        mixed_s2s = [ctrl.submit("map_summarize", p) for p in s2s_shards]
        mixed_cls = [ctrl.submit("map_classify_tpu", p) for p in shards[:2]]
        mixed_wall, _ = pipelined_drain(agent, ctrl)
        s2s_jobs = ctrl.outcome(mixed_s2s)
        cls_jobs = ctrl.outcome(mixed_cls)
        s2s_serial, s2s_serial_wall = serial_shards(ops["map_summarize"], rt, s2s_shards)
        for job, want in zip(s2s_jobs, s2s_serial):
            r = job["result"]
            if not job["b1"] or r.get("device") != device or r["summaries"] != want["summaries"]:
                raise SystemExit("the mixed drain's summaries differ from the serial op's")
        for job, want in zip(cls_jobs, serial):
            if job["result"]["indices"] != want["indices"] \
                    or job["result"]["scores"] != want["scores"]:
                raise SystemExit("the mixed drain's classify columns differ from the serial op's")
        if ctrl.stale:
            raise SystemExit(f"{ctrl.stale} results came with a stale epoch or lease")
        mixed_rows = DRAIN_S2S_SHARDS * DRAIN_SHARD + 2 * DRAIN_SHARD
        report = {
            "phase": "drain", "config": BERT_BASE, "rows": DRAIN_ROWS, "shard_rows": DRAIN_SHARD,
            "warmup_s": warm_s, "wall_s": wall, "rows_per_s": DRAIN_ROWS / wall,
            "serial_wall_s": serial_wall, "serial_rows_per_s": DRAIN_ROWS / serial_wall,
            "drain_over_serial": serial_wall / wall, "stage_workers": workers,
            "p50_phase_ms": p50_phases(results),
            "per_shard_ms": [{k: r["timings"][k] for k in ("device_ms", "fetch_ms")}
                             for r in results],
            "launches": launches, "dispatch_chunks": chunks,
            "profiled_shard": {k: profile[k] for k in ("wall_ms", "device_ms", "idle_share",
                                                      "device_ms_by_kind", "profile_attempts")},
            "risk": {k: risk[k] for k in ("count", "sum", "min", "max", "device")},
            "risk_vs_host": {"sum_diff": abs(risk["sum"] - host["sum"]), "sum_bound": bound},
            "mixed": {"wall_s": mixed_wall, "rows": mixed_rows,
                      "rows_per_s": mixed_rows / mixed_wall,
                      "summarize_serial_wall_s": s2s_serial_wall,
                      "p50_phase_ms_summarize": p50_phases([j["result"] for j in s2s_jobs])},
            "b1_leases": ctrl.b1_leases,
        }
        emit(report)
        # 15. the agent's telemetry, on the same stand-in and weights.
        report["telemetry"] = telemetry_phase(fa, rt, ctrl, shards, serial, staged)
        if ctrl.stale:
            raise SystemExit(f"{ctrl.stale} results came with a stale epoch or lease")
    report["serial_results"] = serial  # phase 18's fleet is held to them
    return report


TELEMETRY_AGENT = "chip-smoke-telemetry"
CAPTURE_ID = "cap-chip-smoke"
DEAD_CONTROLLER = "http://127.0.0.1:9"  # a local port nothing listens on


def obs_values(snapshot, name: str, **labels) -> list:
    """The values of a metrics snapshot family's series whose labels
    include ``labels``."""
    family = (snapshot or {}).get(name) or {}
    return [s["value"] for s in family.get("series", [])
            if all(s["labels"].get(k) == v for k, v in labels.items())]


def trace_kernels(path: str, name: str) -> int:
    """Kernel events of a torch.profiler Chrome trace whose name holds
    ``name``."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return sum(1 for e in events if e.get("cat") == "kernel" and name in str(e.get("name")))


def check_span_trees(ctrl, job_ids: list) -> tuple:
    """Every job's trace, assembled by the port's ``trace.assemble``, must be
    complete, with stage, queue, execute and post once each, parented to
    the stand-in's lease span and closed -> (all spans, spans per job)."""
    from agent_tpu_torch.obs import trace as obs_trace

    every, problems = [], []
    for job_id in job_ids:
        spans = ctrl.trace(job_id)
        every += spans
        tree = obs_trace.assemble(job_id, spans)
        (lease,) = [s for s in spans if s["name"] == "lease"]
        for phase in ("stage", "queue", "execute", "post"):
            got = [s for s in spans if s["name"] == phase]
            if len(got) != 1 or got[0]["parent_span_id"] != lease["span_id"] \
                    or got[0]["duration_ms"] is None:
                problems.append(f"{job_id} {phase}: {got}")
        if not tree["complete"] or tree["orphans"]:
            problems.append(f"{job_id}: {obs_trace.phase_breakdown(tree)}, orphans "
                            f"{tree['orphans']}, open {tree['open_spans']}")
    bad = obs_trace.validate_chrome_trace(obs_trace.to_chrome_trace(every))
    if problems or bad:
        raise SystemExit(f"span trees: {problems[:4]}, chrome trace: {bad[:4]}")
    return every, len(every) / len(job_ids)


def telemetry_phase(fa, rt, ctrl, shards: list, serial: list, staged: list) -> dict:
    """Phase 15: the agent's telemetry on phase 10's stand-in controller,
    shards and resident BERT-base weights, through the pipelined runner
    (PIPELINE_DEPTH 2). The 8 shards drain once with TRACE_ENABLED=0 (no
    span may be shipped) and once traced, with PROFILE_DIR set
    (PROFILE_TASKS 1) and a profile_capture alert on the first lease: each
    shard's spans assemble into a complete tree, Σ usage.device_s equals
    the busy counter the agent shipped within 1 %, Σ usage.flops the
    staged shapes' encoder_fwd_flops, device_mfu and device_duty_cycle lie
    in (0, 1], device_hbm_bytes' limit is the card's total within 1 %, and
    both Chrome traces hold row 1's kernel (on the card). Then one shard
    whose lease carries an slo_page alert (the recorder's dump must hold the
    traced shards' lease and posted events), and one shard through an agent
    whose CONTROLLER_URLS lists a dead local port first (one failover).
    Every result equals phase 10's serial run bit for bit."""
    from agent_tpu_torch.agent.app import Agent
    from agent_tpu_torch.config import AgentConfig, Config, DeviceConfig
    from agent_tpu_torch.obs import trace as obs_trace
    from agent_tpu_torch.obs.health import resolve_peak_flops
    from agent_tpu_torch.ops._model_common import encoder_fwd_flops

    t_phase = time.perf_counter()
    op, n_layers = "map_classify_tpu", BERT_BASE["n_layers"]
    on_card = torch.device(CARD).type == "cuda"
    smi = nvidia_smi_line() if on_card else "not a card"

    def agent(name: str, device=None, **kw):
        kw.setdefault("controller_url", ctrl.url)
        return Agent(Config(agent=AgentConfig(agent_name=name, tasks=(op,), idle_sleep_sec=0.005,
                                              pipeline_depth=2, **kw),
                            device=device or DeviceConfig()), runtime=rt)

    def drain(worker, payloads: list, want: list) -> tuple:
        ids = [ctrl.submit(op, p) for p in payloads]
        if on_card:
            torch.cuda.synchronize()
        gc.collect()
        wall, _ = pipelined_drain(worker, ctrl)
        results = [job["result"] for job in ctrl.outcome(ids)]
        for r, w in zip(results, want):
            if r["indices"] != w["indices"] or r["scores"] != w["scores"]:
                raise SystemExit(f"{worker.config.agent.agent_name}: the decoded columns "
                                 "differ from phase 10's serial run")
        return ids, results, wall

    env_keys = ("TRACE_ENABLED", "PROFILE_CAPTURE_DIR", "FLIGHT_RECORDER_DIR")
    saved = {k: os.environ.get(k) for k in env_keys}
    tmp = tempfile.TemporaryDirectory()
    prof_dir, rec_dir = os.path.join(tmp.name, "profile"), os.path.join(tmp.name, "recorder")
    os.makedirs(rec_dir)
    os.environ["PROFILE_CAPTURE_DIR"] = os.path.join(tmp.name, "captures")
    os.environ["FLIGHT_RECORDER_DIR"] = rec_dir
    try:
        # Tracing off.
        os.environ["TRACE_ENABLED"] = "0"
        obs_trace.set_enabled(None)
        shipped = ctrl.spans_shipped
        _, _, wall_off = drain(agent("chip-smoke-trace-off"), shards, serial)
        if ctrl.spans_shipped != shipped:
            raise SystemExit(f"TRACE_ENABLED=0 shipped {ctrl.spans_shipped - shipped} spans")

        # Tracing on (the default), PROFILE_DIR, and a capture on the first
        # lease (the staging pool may lease every shard at once): the
        # capture takes the first execute, PROFILE_DIR the next.
        del os.environ["TRACE_ENABLED"]
        obs_trace.set_enabled(None)
        on = agent(TELEMETRY_AGENT, DeviceConfig(profile_dir=prof_dir, profile_tasks=1))
        ctrl.queue_alerts([{"kind": "profile_capture", "capture_id": CAPTURE_ID, "op": op,
                            "duration_ms": None}])
        reset_counts(fa)
        ids, results, wall_on = drain(on, shards, serial)
        launches = fa.LAUNCH_COUNTS["flash_attention"]
        obs = ctrl.agent_obs[TELEMETRY_AGENT]  # its final flush
        spans, spans_per_job = check_span_trees(ctrl, ids)

        # Usage against the agent's own counters and the staged shapes.
        busy = sum(obs_values(obs, "device_busy_seconds_total", op=op))
        device_s = sum(r["usage"]["device_s"] for r in results)
        flops = sum(r["usage"]["flops"] for r in results)
        staged_flops = sum(encoder_fwd_flops(ids_.shape[0], ids_.shape[1], st["cfg"].d_model,
                                             st["cfg"].d_ff, n_layers, st["cfg"].n_classes)
                           for st in staged for ids_, _, _ in st["chunks"])
        chips = sorted({r["usage"]["chips"] for r in results})
        host_s = [r["usage"]["host_s"] for r in results]
        if not busy > 0 or abs(device_s - busy) > 0.01 * busy or flops != staged_flops \
                or chips != [1.0] or min(host_s) <= 0:
            raise SystemExit(f"usage: device_s {device_s} against busy {busy}, flops {flops} "
                             f"against {staged_flops}, chips {chips}, host_s {host_s}")

        # Gauges.
        peak = resolve_peak_flops(rt)
        mfu = obs_values(obs, "device_mfu", op=op)
        duty = obs_values(obs, "device_duty_cycle")
        if len(mfu) != 1 or not 0 < mfu[0] <= 1 or len(duty) != 1 or not 0 < duty[0] <= 1:
            raise SystemExit(f"device_mfu {mfu} (peak {peak}), device_duty_cycle {duty}")
        hbm = {kind: obs_values(obs, "device_hbm_bytes", device=str(rt.device.index), kind=kind)
               for kind in ("used", "peak", "limit")}
        total = torch.cuda.mem_get_info(rt.device)[1] if on_card else None
        if on_card and (any(len(v) != 1 for v in hbm.values())
                        or abs(hbm["limit"][0] - total) > 0.01 * total):
            raise SystemExit(f"device_hbm_bytes {hbm} against the card's {total} bytes")

        # Captures: the PROFILE_DIR trace and the on-demand one.
        traces = sorted(os.listdir(prof_dir)) if os.path.isdir(prof_dir) else []
        records = [c for c in ctrl.captures if c.get("capture_id") == CAPTURE_ID]
        artifact = records[0].get("artifact") if len(records) == 1 else None
        if len(traces) != 1 or artifact is None or records[0]["status"] != "done" \
                or not os.path.isfile(os.path.join(artifact, "trace.json")):
            raise SystemExit(f"captures: PROFILE_DIR holds {traces}, the stand-in got {records}")
        kernels = {"profile_dir": trace_kernels(os.path.join(prof_dir, traces[0]),
                                                "flash_fwd_sm90"),
                   "capture": trace_kernels(os.path.join(artifact, "trace.json"),
                                            "flash_fwd_sm90")}
        if on_card and min(kernels.values()) < 1:
            raise SystemExit(f"row 1 missing from the agent's captures: {kernels}")

        # An slo_page alert: the recorder's dump of the traced shards.
        ctrl.queue_alerts([{"objective": "interactive", "state": "page", "tier": 8, "op": op}])
        drain(on, shards[:1], serial[:1])
        if len(on.slo_dump_paths) != 1 or not on.slo_dump_paths[0].startswith(rec_dir):
            raise SystemExit(f"slo_page dumps: {on.slo_dump_paths}")
        with open(on.slo_dump_paths[0]) as fh:
            dumped = [json.loads(line) for line in fh]
        leased = {j for e in dumped if e["kind"] == "lease" for j in e["job_ids"]}
        posted = {e["job_id"] for e in dumped if e["kind"] == "phase" and e["phase"] == "posted"}
        if not set(ids) <= leased & posted:
            raise SystemExit(f"the slo_page dump lacks {sorted(set(ids) - (leased & posted))}")

        # CONTROLLER_URLS with a dead local port first.
        fo = agent("chip-smoke-failover", controller_url=DEAD_CONTROLLER,
                   controller_urls=(DEAD_CONTROLLER, ctrl.url), error_backoff_sec=0.05)
        drain(fo, shards[1:2], serial[1:2])
        failovers = [e for e in fo.recorder.events() if e["kind"] == "controller_failover"]
        if fo.m_failover.value() != 1 or len(failovers) != 1 \
                or fo.active_controller_url() != ctrl.url:
            raise SystemExit(f"failover: {fo.m_failover.value()} rotations, {failovers}")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        obs_trace.set_enabled(None)
        tmp.cleanup()
    report = {
        "phase": "telemetry", "config": BERT_BASE, "rows": DRAIN_ROWS, "nvidia_smi": smi,
        "seconds": time.perf_counter() - t_phase,
        "rows_per_s_tracing_off": DRAIN_ROWS / wall_off,
        "rows_per_s_tracing_on": DRAIN_ROWS / wall_on, "on_over_off": wall_off / wall_on,
        "spans": len(spans), "spans_per_job": spans_per_job,
        "usage": {"device_s": device_s, "busy_counter_s": busy, "flops": flops,
                  "staged_flops": staged_flops, "chips": chips, "host_s_min": min(host_s)},
        "device_mfu": mfu[0], "peak_tflops": None if peak is None else peak / 1e12,
        "card": torch.cuda.get_device_name(rt.device) if on_card else "cpu",
        "device_duty_cycle": duty[0], "device_hbm_bytes": hbm, "card_total_bytes": total,
        "launches": launches, "launched_per_shard": sorted({n_layers * len(st["chunks"])
                                                            for st in staged}),
        "flash_fwd_sm90_traced": kernels, "slo_dump_events": len(dumped),
        "failover": failovers[0],
    }
    emit(report)
    return report


def entry_point_phase(path: str) -> dict:
    """Phase 10, the entry point: ``python -m agent_tpu_torch.agent.app`` in
    a process of its own against the stand-in controller with
    TASKS=echo,read_csv_shard,map_classify_tpu drains one echo, one
    read_csv_shard and two 256-row classify shards, then SIGUSR1 must dump
    its flight recorder (holding the lease events) and SIGTERM end it with
    exit code 0; with TASKS=none it must exit 2 at once."""
    import signal

    root = os.path.dirname(os.path.abspath(__file__))
    extra = {"text_field": "text", "result_format": "columnar", "allow_fallback": False,
             "model_config": dict(BERT_BASE, n_layers=ENTRY_LAYERS), "topk": 5}
    torch.cuda.empty_cache()  # leave the card's memory to the other process
    with StandInController() as ctrl, tempfile.TemporaryFile("w+") as log, \
            tempfile.TemporaryDirectory() as rec_dir:
        ids = [ctrl.submit("echo", {"hello": "card"}),
               ctrl.submit("read_csv_shard", {"source_uri": path, "shard_size": 5})]
        ids += ctrl.submit_csv(path, "map_classify_tpu", 0, 2 * ENTRY_SHARD, ENTRY_SHARD, extra)
        env = dict(os.environ, CONTROLLER_URL=ctrl.url, AGENT_NAME="chip-smoke-entry",
                   TASKS="echo,read_csv_shard,map_classify_tpu", IDLE_SLEEP_SEC="0.05",
                   FLIGHT_RECORDER_DIR=rec_dir, PYTHONPATH=root)
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m", "agent_tpu_torch.agent.app"], cwd=root,
                                env=env, stdout=log, stderr=subprocess.STDOUT)
        try:
            while not ctrl.drained() and proc.poll() is None \
                    and time.perf_counter() - t0 < DRAIN_TIMEOUT_S:
                time.sleep(0.05)
            drained_s = time.perf_counter() - t0
            dump = os.path.join(rec_dir, f"agent_tpu_torch_flight_agent-chip-smoke-entry_"
                                         f"{proc.pid}.jsonl")
            proc.send_signal(signal.SIGUSR1)
            t_dump = time.perf_counter()
            while not os.path.exists(dump) and proc.poll() is None \
                    and time.perf_counter() - t_dump < 60:
                time.sleep(0.05)
            dumped = []
            if os.path.exists(dump):
                with open(dump) as fh:
                    dumped = [json.loads(line) for line in fh]
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        log.seek(0)
        out = log.read()
        jobs = ctrl.outcome(ids) if ctrl.drained() else []
    none = subprocess.run([sys.executable, "-m", "agent_tpu_torch.agent.app"], cwd=root,
                          env=dict(env, TASKS="none"), capture_output=True, text=True,
                          timeout=300)
    leases = sum(1 for e in dumped if e["kind"] == "lease")
    report = {"phase": "entry_point", "drained_s": drained_s, "exit_code": rc,
              "exit_code_tasks_none": none.returncode, "sigusr1_dump_events": len(dumped),
              "sigusr1_dump_leases": leases, "log_tail": out[-1500:]}
    emit(report)
    cls = [j["result"] for j in jobs if j["op"] == "map_classify_tpu"]
    if rc != 0 or none.returncode != 2 or len(jobs) != 4 or not leases \
            or [r.get("device") for r in cls] != [torch.device(CARD).type] * 2 \
            or [r["n_rows"] for r in cls] != [ENTRY_SHARD] * 2:
        raise SystemExit(f"the entry point failed: exit {rc}, TASKS=none exit "
                         f"{none.returncode}, {len(jobs)} of 4 jobs, {leases} leases in the "
                         f"SIGUSR1 dump, log {out[-2000:]}")
    return report


def bert_texts(words: list, n: int, lo: int, hi: int, seed: int) -> list:
    """n rows of lo..hi words: the vocab's words, some capitalised, with
    accented, hyphenated, numeric and CJK words and punctuation mixed in."""
    rng = random.Random(seed)
    extras = ["Café", "naïve", "2024", "e-mail", "don't", "中文", "U.S.", "résumé"]
    rows = []
    for _ in range(n):
        picked = [rng.choice(extras) if rng.random() < 0.05 else rng.choice(words)
                  for _ in range(rng.randint(lo, hi))]
        rows.append(" ".join(w.capitalize() if rng.random() < 0.1 else w for w in picked) + ".")
    return rows


def bert_requests(ckpt: str, csv_path: str, words: list) -> list:
    """Phase 11's requests: 256 texts of 20-120 words, one text cut at 512
    wordpieces, and one 8,192-row shard of phase 10's CSV."""
    base = {"model_path": ckpt, "topk": BERT_BASE_UNCASED["num_labels"], "allow_fallback": False}
    return [
        ("bert_texts256", dict(base, texts=bert_texts(words, BERT_ROWS, *BERT_WORDS, SEED + 12)),
         BERT_ROWS),
        ("bert_text512", dict(base, text=bert_texts(words, 1, 2 * BERT_LONG_PIECES,
                                                    2 * BERT_LONG_PIECES, SEED + 13)[0]), 1),
        ("bert_drain_shard", dict(base, source_uri=csv_path, text_field="text", start_row=0,
                                  shard_size=DRAIN_SHARD), DRAIN_SHARD),
    ]


def bert_phase(fa, classify, rt, ckpt, requests) -> dict:
    """Phase 11: a BERT checkpoint directory (bert-base-uncased's config,
    seeded weights) served by map_classify_tpu through the registry. Row 1
    once per layer a dispatch chunk; every class against the plain
    attention on the card; the 256-row request on an sp = 2 ring on the one
    card (the fold kernel in every hop) against one device; and the same
    checkpoint read from model.safetensors by the port's own reader. Returns
    the launches of row 1 and of the fold over the timed requests."""
    from agent_tpu_torch.models import safetensors_io
    from agent_tpu_torch.runtime.context import OpContext

    n_layers, k = BERT_BASE_UNCASED["num_hidden_layers"], BERT_BASE_UNCASED["num_labels"]
    ctx = OpContext(runtime=rt)
    first = requests[0][1]
    t0 = time.perf_counter()
    classify(dict(first, texts=first["texts"][:1]), ctx)  # reads the checkpoint once
    load_s = time.perf_counter() - t0
    reset_counts(fa)
    report = timed_requests(classify, ctx, fa, requests, {"flash_attention": n_layers}, k)
    launches = fa.LAUNCH_COUNTS["flash_attention"]
    profile = profile_call(lambda: classify(dict(first), ctx))

    # Every class (topk = num_labels): the kernel against the plain attention.
    kernel_out = classify(dict(first), ctx)
    plain_out = classify(dict(first), OpContext(runtime=shared_runtime(
        rt, fa.flash_attention_reference)))
    vs_plain = op_agreement(kernel_out, plain_out, LOGP_TOL["bfloat16"])

    # The 256-row request on an sp ring whose shards share the card.
    ring_ctx = OpContext(runtime=shared_runtime(rt, devices=[CARD] * BERT_SP,
                                                mesh_shape={"sp": BERT_SP}))
    classify(dict(first), ring_ctx)  # warm-up
    reset_counts(fa)
    ring_report = timed_requests(classify, ring_ctx, fa,
                                 [(f"bert_texts256_sp{BERT_SP}", first, BERT_ROWS)],
                                 {"flash_fold": n_layers * BERT_SP ** 2}, k)
    fold_launches = fa.LAUNCH_COUNTS["flash_fold"]
    vs_one_card = op_agreement(classify(dict(first), ring_ctx), kernel_out,
                               LOGP_TOL["bfloat16"])

    # The same weights as model.safetensors alone, read by the port's reader.
    st_dir = f"{ckpt}_safetensors"
    os.makedirs(st_dir, exist_ok=True)
    for name in ("config.json", "vocab.txt"):
        shutil.copy(os.path.join(ckpt, name), st_dir)
    safetensors_io.save_file(torch.load(os.path.join(ckpt, "pytorch_model.bin"),
                                        weights_only=True),
                             os.path.join(st_dir, "model.safetensors"), {"format": "pt"})
    t0 = time.perf_counter()
    st_out = classify(dict(first, model_path=st_dir), ctx)
    st_s = time.perf_counter() - t0
    st_same = st_out["results"] == kernel_out["results"]
    torch.cuda.synchronize()
    emit({"phase": "bert", "config": BERT_BASE_UNCASED,
          "weights": "random from a seeded generator at std 0.02, f32; not pretrained",
          "load_s": load_s, "requests": report, "launches": launches,
          "launches_per_dispatch_chunk": n_layers, "profile_256_rows": profile,
          "logp_tolerance": LOGP_TOL["bfloat16"], "vs_plain_attention": vs_plain,
          "sp": {"sp": BERT_SP, "requests": ring_report, "fold_launches": fold_launches,
                 "vs_one_card": vs_one_card},
          "safetensors": {"first_request_s": st_s, "results_equal_to_bin": st_same}})
    check_forwards(profile, {"flash_fwd_sm90": n_layers}, "BERT request")
    if not (vs_plain["ok"] and vs_one_card["ok"] and st_same):
        raise SystemExit("BERT results disagree: kernel vs plain, sp vs one card, or the "
                         "safetensors copy")
    return {"launches": launches, "fold_launches": fold_launches}


def bart_texts(tok, words: list, n: int, lengths, seed: int) -> list:
    """n texts of lengths[0]..lengths[1] BPE tokens with <s> and </s>: the
    vocab's words, cut at the drawn length in tokens."""
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        pieces = rng.randint(*lengths) - 2
        text = " ".join(rng.choice(words) for _ in range(pieces))
        out.append(tok.decode(tok.encode(text)[:pieces]))
    return out


def bart_requests(ckpt: str, texts: list) -> list:
    """Phase 12's requests: 64 rows greedy, and 8 rows with 4 beams and
    min_length 8, 32 new tokens each."""
    base = {"model_path": ckpt, "max_length": BART_MAX_NEW}
    return [("bart_greedy", dict(base, texts=texts), BART_ROWS),
            ("bart_beam4", dict(base, texts=texts[:BART_BEAM_ROWS], num_beams=BART_BEAMS,
                                min_length=BART_MIN_LENGTH), BART_BEAM_ROWS)]


def summarize_tokens(summarize, payload: dict, ctx) -> tuple:
    """The op's phases on ``payload`` -> (result, tokens of the real rows)."""
    _, state = summarize.stage(dict(payload), ctx)
    state = summarize.execute(state, ctx)
    out = summarize.finalize(state, ctx)
    return out, np.concatenate([t.numpy()[:n] for t, n in state["token_chunks"]])


def forced_ids_report(toks: np.ndarray, cfg, min_length: int) -> dict:
    """Rows whose first token is not the forced bos, rows that reached the
    last step without ending in the forced eos, and rows with an EOS before
    min_length (HF counting: the decoder start included)."""
    T = toks.shape[1]
    early_eos = (toks[:, :T - 1] == cfg.eos_id).any(axis=1)
    reached = ~early_eos
    return {"rows": int(toks.shape[0]),
            "first_not_forced_bos": int((toks[:, 0] != cfg.forced_bos_id).sum()),
            "reached_last_step": int(reached.sum()),
            "reached_without_forced_eos": int((toks[reached, T - 1] != cfg.forced_eos_id).sum()),
            "eos_before_min_length": int((toks[:, :max(0, min_length - 1)] == cfg.eos_id)
                                         .any(axis=1).sum())}


def bart_phase(fa, summarize, rt, ckpt, requests) -> dict:
    """Phase 12: a BART checkpoint directory (bart-large-cnn's config,
    seeded weights) served by map_summarize through the op's phases. Row 1
    once per encoder layer a request, the forced first and last ids, the
    encoder's teacher-forced log-probabilities against the plain attention
    in bf16, and the first rows' greedy tokens in f32 with the kernel
    against the plain attention. Returns row 1's launches over the timed
    requests."""
    from agent_tpu_torch.models import bart
    from agent_tpu_torch.models.layers import dot_product_attention
    from agent_tpu_torch.ops import map_summarize as op
    from agent_tpu_torch.runtime.context import OpContext

    cfg = op._get_cfg({"model_path": ckpt}, "bart", ckpt)
    n_enc = cfg.n_enc_layers
    ctx = OpContext(runtime=rt)
    greedy = requests[0][1]
    t0 = time.perf_counter()
    summarize(dict(greedy, texts=greedy["texts"][:1]), ctx)  # reads the checkpoint once
    load_s = time.perf_counter() - t0
    want = {key: 0 for key in fa.LAUNCH_COUNTS}
    want["flash_attention"] = n_enc
    report, outputs = [], {}
    reset_counts(fa)
    for name, payload, n_rows in requests:
        walls, emitted = [], []
        for rep in range(REPS + 1):
            before, sel = dict(fa.LAUNCH_COUNTS), dict(fa.SELECTION_COUNTS)
            t0 = time.perf_counter()
            out, toks = summarize_tokens(summarize, payload, ctx)
            wall = time.perf_counter() - t0
            got = {key: fa.LAUNCH_COUNTS[key] - before[key] for key in want}
            selected = {key: fa.SELECTION_COUNTS[key] - sel[key] for key in ("flash", "dense")}
            if not out.get("ok") or out.get("device") != torch.device(CARD).type \
                    or len(out.get("summaries", [])) != n_rows:
                raise SystemExit(f"{name} did not run on cuda: {str(out)[:500]}")
            if got != want or selected != {"flash": n_enc, "dense": 0}:
                raise SystemExit(f"{name}: launches {got} (want {want}), selection {selected}")
            if rep:
                walls.append(wall)
                emitted.append(int(((toks != cfg.pad_id) & (toks != cfg.eos_id)).sum()))
        outputs[name] = toks
        p50 = statistics.median(walls)
        report.append({"request": name, "rows": n_rows, "num_beams": payload.get("num_beams", 1),
                       "min_length": payload.get("min_length", 0), "max_new": BART_MAX_NEW,
                       "p50_ms": p50 * 1e3, "rows_per_s": n_rows / p50,
                       "emitted_tokens": statistics.median(emitted),
                       "emitted_tokens_per_s": statistics.median(emitted) / p50,
                       "forced_ids": forced_ids_report(toks, cfg, payload.get("min_length", 0)),
                       "summary_0": out["summaries"][0][:80]})
    launches = fa.LAUNCH_COUNTS["flash_attention"]
    profile = profile_call(lambda: summarize(dict(greedy), ctx))

    # Teacher-forced log-probabilities of the first rows' greedy tokens, on
    # the kernel's encoder output against the plain attention's (the
    # decoder dense in both, as generate runs it).
    params = rt.get_params(op.params_key(ckpt, "bart", cfg),
                           lambda: op._build_model(ckpt, cfg, "bart", rt.device))
    (ids_np, lengths_np, _), = op._stage_chunks(greedy["texts"][:BART_CHECK_ROWS], cfg, 1,
                                                "bart", ckpt)
    ids = rt.put_batch(ids_np.astype(np.int32))
    mask = (torch.arange(ids.shape[1], device=ids.device)[None, :]
            < rt.put_batch(lengths_np)[:, None]).to(torch.int32)
    gen = torch.as_tensor(outputs["bart_greedy"][:BART_CHECK_ROWS], device=ids.device)
    tgt = torch.cat([torch.full_like(gen[:, :1], cfg.decoder_start_id), gen[:, :-1]], dim=1)
    logp = {}
    with torch.inference_mode():
        for which, attn in (("kernel", fa.flash_attention), ("plain", fa.flash_attention_reference)):
            enc = bart.encode(params, ids, mask, cfg, attn_fn=attn)
            logp[which] = torch.log_softmax(bart.decode_full(
                params, tgt, enc, mask, cfg, attn_fn=dot_product_attention), dim=-1)
    teacher = {"kernel_vs_plain": (logp["kernel"] - logp["plain"]).abs().max().item(),
               "finite": bool(torch.isfinite(logp["kernel"]).all())}

    # The first rows' greedy tokens in f32: the kernel against the plain
    # attention (both on the card), and the bf16 run's agreement with them.
    check = dict(greedy, texts=greedy["texts"][:BART_CHECK_ROWS],
                 model_config={"dtype": "float32"})
    _, f32_kernel = summarize_tokens(summarize, check, ctx)
    _, f32_plain = summarize_tokens(summarize, check, OpContext(runtime=shared_runtime(
        rt, fa.flash_attention_reference)))
    f32 = {"kernel_equals_plain": bool(np.array_equal(f32_kernel, f32_plain)),
           "bf16_tokens_equal_to_f32_plain": float(np.mean(
               outputs["bart_greedy"][:BART_CHECK_ROWS] == f32_plain))}
    torch.cuda.synchronize()
    emit({"phase": "bart", "config": BART_LARGE_CNN,
          "weights": "random from a seeded generator at std 0.02, bf16; not pretrained",
          "load_s": load_s, "requests": report, "launches": launches,
          "launches_per_encoder_pass": n_enc, "profile_64_rows_greedy": profile,
          "logp_tolerance": LOGP_TOL["bfloat16"], "teacher_forced": teacher,
          "f32_first_rows": f32})
    check_forwards(profile, {"flash_fwd_sm90": n_enc}, "BART request")
    forced = [r["forced_ids"] for r in report]
    if any(f["first_not_forced_bos"] or f["reached_without_forced_eos"]
           or f["eos_before_min_length"] for f in forced) \
            or not any(f["reached_last_step"] for f in forced):
        raise SystemExit(f"forced ids or min_length not honoured: {forced}")
    if not (teacher["finite"] and teacher["kernel_vs_plain"] <= LOGP_TOL["bfloat16"]
            and f32["kernel_equals_plain"]):
        raise SystemExit(f"BART kernel and plain attention disagree: {teacher}, {f32}")
    return {"launches": launches}


def shape_entry(fa, check, inputs: str, launches) -> dict:
    """Row 1 at another staged shape (``check[inputs]``: phase 12's BART
    encoder, B 64, H 16, L 1024, D 64, or phase 13's serving prefill, B 240,
    H 8, L 64, D 32, with their key lengths): kernel, plain and SDPA's
    forward times beside the bound, as a kernels-line entry of its own."""
    q, k, v, mask, lengths = check[inputs]
    B, H, L, D = q.shape
    bool_mask = mask > 0
    return kernel_entry(
        "flash_attention", "agent_tpu_torch/kernels/csrc/flash_fwd_sm90.cuh", SM90,
        "agent_tpu/kernels/flash_attention.py:149", launches,
        check["max_abs_err"], check["max_rel_err"],
        cuda_ms(lambda: fa.flash_attention(q, k, v, mask)),
        cuda_ms(lambda: fa.flash_attention_reference(q, k, v, mask), iters=5),
        4 * B * H * L * D * q.element_size() + mask.numel() * mask.element_size(),
        4 * H * L * D * float(np.sum(lengths)),  # products with real keys only
        cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=bool_mask)), q)


def launches_of(tally: dict, kernel: str) -> dict:
    """Phase 17's paths that launched ``kernel``, with their counts."""
    return {path: counts[kernel] for path, counts in tally.items() if counts.get(kernel)}


def head_shard(t: torch.Tensor, heads: int) -> torch.Tensor:
    """The first tp shard's heads of [B, H, L, D] inputs."""
    return t[:, :heads].contiguous()


def shard_shape_entry(fa, inputs, launches) -> dict:
    """Row 1 at the BART encoder's tp 2 shard shape (phase 12's staged
    inputs, the first half of the heads: B 64, H 8, L 1024, D 64): its own
    error against the plain version, and the times beside the bound, as
    :func:`shape_entry`."""
    q, k, v, mask, lengths = inputs
    h = q.shape[1] // 2
    q, k, v = (head_shard(t, h) for t in (q, k, v))
    _, err, rel = compare(fa.flash_attention(q, k, v, mask),
                          fa.flash_attention_reference(q, k, v, mask), q.dtype)
    check = {"max_abs_err": err, "max_rel_err": rel, "inputs": (q, k, v, mask, lengths)}
    return shape_entry(fa, check, "inputs", launches)


def t5_shard_entry(fa, check, launches) -> dict:
    """Row 3 at T5-large's tp 2 shard shape (phase 9's staged inputs, the
    first half of the heads and of the bias table's head columns: B 64, H
    8, L 512, D 64), its own error against the plain version, as
    :func:`t5_kernel_entry`."""
    q, k, v, mask, rel_bias, table, lengths = check["inputs"]
    h = q.shape[1] // 2
    q, k, v = (head_shard(t, h) for t in (q, k, v))
    rel_bias, table = rel_bias[:, :h].contiguous(), table[:h].contiguous()
    maxd = T5_LARGE["relative_attention_max_distance"]
    _, err, rel = compare(fa.flash_attention_t5(q, k, v, mask, rel_bias, max_distance=maxd),
                          fa.flash_attention_t5_reference(q, k, v, mask, table,
                                                          max_distance=maxd), q.dtype)
    return t5_kernel_entry(fa, {"inputs": (q, k, v, mask, rel_bias, table, lengths),
                                "max_abs_err": err, "max_rel_err": rel}, launches)


def serve_cfg():
    from agent_tpu_torch.models.seq2seq import Seq2SeqConfig

    return Seq2SeqConfig(**SERVE_MODEL)


def with_model(payload: dict) -> dict:
    """``payload`` with phase 13's model_config when it overrides any."""
    return dict(payload, model_config=SERVE_MODEL) if SERVE_MODEL else payload


def serving_stream(cfg) -> tuple:
    """bench.py's serving stream (_bench_serving_beam): per request a token
    budget, T // 32 with probability SERVE_SHORT_FRAC else T, then the
    source ids, all from one generator seeded SERVE_SEED."""
    rng = np.random.default_rng(SERVE_SEED)
    n = SERVE_REQUESTS
    T = cfg.max_tgt_len
    short = max(2, T // 32)
    limits = [short if rng.random() < SERVE_SHORT_FRAC else T for _ in range(n)]
    ids = rng.integers(4, cfg.vocab_size, (n, SERVE_SRC)).astype(np.int32)
    return ids, np.ones((n, SERVE_SRC), np.int32), limits


def new_engine(model, slots: int, num_beams: int, paged: bool = True, cls=None, enc_len=None):
    """A continuous engine on ``model``'s device with ServeConfig's default
    KV layout (paged, 16-token blocks, the pool at dense parity)."""
    from agent_tpu_torch.models import decoding, seq2seq
    from agent_tpu_torch.models.tokenizer import BOS_ID, EOS_ID, PAD_ID

    cfg = model.cfg
    # A sharded model's engine runs on replica 0's tp group, one cache a shard.
    shards = model if isinstance(model, seq2seq.ShardedSeq2Seq) else None
    dev = model.devices(0)[0] if shards else model.embed.device
    factory = (seq2seq.make_paged_cache_factory(cfg, block_size=16, device=dev, shards=shards)
               if paged else seq2seq.make_cache_factory(cfg, device=dev, shards=shards))
    return (cls or decoding.ContinuousBatcher)(
        seq2seq.make_positional_step(model), factory, slots=slots, vocab_size=cfg.vocab_size,
        max_tokens=cfg.max_tgt_len, enc_len=enc_len or SERVE_SRC, d_model=cfg.d_model,
        start_id=BOS_ID, eos_id=EOS_ID, pad_id=PAD_ID, num_beams=num_beams)


def engine_vs_static(model, attn_fn, stream, enc_all, num_beams: int, slots: int,
                     profile: bool) -> dict:
    """bench.py's comparison on the card: the static path decodes
    arrival-order batches of ``slots`` requests through greedy_generate /
    beam_generate, each batch run to its longest budget; one persistent
    paged engine runs the same stream with per-slot limits. Both count the
    requested tokens (the engine's steps per request). Each side is warmed
    on the first SERVE_WARM requests; ``profile`` adds one profiled stretch
    of SERVE_PROFILE_STEPS engine steps in a third pass."""
    from agent_tpu_torch.models import seq2seq

    ids, mask, limits = stream
    ids_t, mask_t = torch.from_numpy(ids).to(CARD), torch.from_numpy(mask).to(CARD)

    def static_pass(n):
        steps = 0
        with torch.inference_mode():
            for s in range(0, n, slots):
                b = slice(s, min(s + slots, n))
                mx = max(limits[b])
                if num_beams == 1:
                    toks, _ = seq2seq.greedy_generate(model, ids_t[b], mask_t[b], mx,
                                                      attn_fn=attn_fn)
                else:
                    toks, _ = seq2seq.beam_generate(model, ids_t[b], mask_t[b], mx,
                                                    num_beams=num_beams, attn_fn=attn_fn)
                toks.cpu()
                steps += mx
        return steps

    engine = new_engine(model, slots, num_beams)

    def engine_pass(n):
        tickets = [engine.admit(enc_all[i], mask[i], limits[i], data=i) for i in range(n)]
        while engine.has_work():
            engine.step()
        return tickets

    static_pass(SERVE_WARM)
    engine_pass(SERVE_WARM)
    torch.cuda.synchronize()
    gc.collect()  # no full collection inside either timed pass (see profile_call)
    t0 = time.perf_counter()
    static_steps = static_pass(len(limits))
    static_wall = time.perf_counter() - t0
    steps0, occ0 = engine.steps_run, engine.occupancy_sum
    gc.collect()
    t0 = time.perf_counter()
    tickets = engine_pass(len(limits))
    cont_wall = time.perf_counter() - t0
    engine_steps = engine.steps_run - steps0
    tokens = sum(t.steps for t in tickets)
    out = {"requests": len(limits), "num_beams": num_beams, "slots": slots, "micro_steps": 1,
           "kv_layout": "paged", "limit_short": min(limits), "limit_long": max(limits),
           "tokens": tokens, "static_wall_s": static_wall, "continuous_wall_s": cont_wall,
           "static_tok_per_s": tokens / static_wall, "continuous_tok_per_s": tokens / cont_wall,
           "speedup_vs_static": static_wall / cont_wall, "static_steps": static_steps,
           "engine_steps": engine_steps,
           "mean_occupancy": (engine.occupancy_sum - occ0) / max(1, engine_steps),
           "max_occupancy": engine.max_occupancy,
           "kv_blocks_total": engine.kv_blocks_total, "kv_blocks_free": engine.kv_blocks_free,
           "ttft_steps_p50": statistics.median(t.join_step - steps0 + 1 for t in tickets)}
    if engine.kv_blocks_free != engine.kv_blocks_total or len(tickets) != len(limits) \
            or any(t.steps > t.limit or t.tokens is None for t in tickets):
        raise SystemExit(f"the engine's pass is inconsistent: {out}")
    if profile:
        # A third pass, profiled for SERVE_PROFILE_STEPS steps once the batch
        # is full, then dropped.
        t0 = time.perf_counter()
        for i in range(len(limits)):
            engine.admit(enc_all[i], mask[i], limits[i])
        for _ in range(10):
            engine.step()
        prof = profile_call(lambda: [engine.step() for _ in range(SERVE_PROFILE_STEPS)])
        out["profile_50_steps"] = {k: prof[k] for k in (
            "wall_ms", "device_ms", "idle_share", "kernels_launched", "host_blocked_reads",
            "host_blocked_ms", "device_ms_by_kind", "top_kernels", "profile_attempts")}
        out["profiled_pass_s"] = time.perf_counter() - t0
    return out


class NoTrashRepoint:
    """Planted fault, mixed into the engine: a released slot's blocks go back
    to the free list but its rows still point at them."""

    def _release_blocks(self, slot):
        ids = self._slot_blocks.pop(slot, None)
        if ids is not None:
            self._free_blocks.extend(ids)


def sparse_arrivals(engine, rows, masks, limits, every: int = SERVE_EXACT_EVERY) -> list:
    """One request admitted every ``every`` steps, so slots sit empty while
    blocks they released serve later requests -> each request's tokens."""
    tickets, i, ticks = [], 0, 0
    while i < len(limits) or engine.has_work():
        if i < len(limits) and ticks % every == 0:
            tickets.append(engine.admit(rows[i], masks[i], limits[i]))
            i += 1
        engine.step()
        ticks += 1
    return [t.tokens[:t.limit].tolist() for t in tickets]


def serving_exactness() -> dict:
    """The engine's tokens on the card, on a small f32 model (SMALL_S2S_F32):
    SERVE_EXACT_REQUESTS requests joining one every SERVE_EXACT_EVERY steps
    into 4 slots (slots sit empty between arrivals), each equal to a solo
    greedy_generate / beam_generate of it with its own budget, dense and
    paged; the paged engine on the card equal to the same engine on the
    CPU; and the engine with the trash-block repoint skipped must give other
    tokens."""
    from agent_tpu_torch.models import decoding, seq2seq
    from agent_tpu_torch.runtime.runtime import TorchRuntime

    cfg = seq2seq.Seq2SeqConfig(**SMALL_S2S_F32)
    flat = seq2seq.init_params(cfg, "serving-exact")
    card, cpu = (seq2seq.from_jax_params(flat, cfg, device=d) for d in (CARD, "cpu"))
    attn_fn = TorchRuntime(device=CARD).attention_fn()
    rng = np.random.default_rng(SEED + 13)
    n, src = SERVE_EXACT_REQUESTS, 32
    ids = rng.integers(4, cfg.vocab_size, (n, src)).astype(np.int32)
    lengths = rng.integers(8, src + 1, n)
    masks = (np.arange(src)[None, :] < lengths[:, None]).astype(np.int32)
    limits = [int(x) for x in rng.integers(2, cfg.max_tgt_len, n)]
    report, failures = {}, []
    with torch.inference_mode():
        # One row at a time, the shape each solo decode encodes.
        rows = [seq2seq.encode(card, torch.from_numpy(ids[i:i + 1]).to(CARD),
                               torch.from_numpy(masks[i:i + 1]).to(CARD), attn_fn)
                .float().cpu().numpy()[0] for i in range(n)]
        for beams in (1, SERVE_BEAMS):
            solo = []
            for i in range(n):
                args = (card, torch.from_numpy(ids[i:i + 1]).to(CARD),
                        torch.from_numpy(masks[i:i + 1]).to(CARD), limits[i])
                toks, _ = (seq2seq.greedy_generate(*args, attn_fn=attn_fn) if beams == 1 else
                           seq2seq.beam_generate(*args, num_beams=beams, attn_fn=attn_fn))
                solo.append(toks.cpu().numpy()[0].tolist())
            got = {layout: sparse_arrivals(new_engine(card, 4, beams, layout == "paged",
                                                      enc_len=src), rows, masks, limits)
                   for layout in ("dense", "paged")}
            got["cpu_paged"] = sparse_arrivals(new_engine(cpu, 4, beams, enc_len=src),
                                               rows, masks, limits)
            for name, toks in got.items():
                want = solo if name != "cpu_paged" else got["paged"]
                same = sum(a == b for a, b in zip(toks, want))
                report[f"beams{beams}_{name}_equal"] = same
                if same != n:
                    failures.append(f"beams {beams} {name}: {same} of {n} equal")
            if beams == 1:
                class Faulty(NoTrashRepoint, decoding.ContinuousBatcher):
                    pass

                fault = sparse_arrivals(new_engine(card, 4, 1, cls=Faulty, enc_len=src),
                                        rows, masks, limits)
                changed = sum(a != b for a, b in zip(fault, got["paged"]))
                report["planted_no_trash_repoint_changed"] = changed
                if not changed:
                    failures.append("the planted trash-block fault changed no request")
    report["requests"] = n
    report["lengths"] = {"limits": [min(limits), max(limits)], "tokens_solo_distinct": len(
        {t for row in solo for t in row})}
    if failures:
        raise SystemExit(f"serving exactness on the card failed: {failures} {report}")
    return report


def serve_batches(texts: list, limits: list, max_batch: int = 64) -> list:
    """The front door's batching (agent_tpu/controller/serving.py): requests
    grouped by length bucket (ServeConfig.len_buckets, on the text's bytes),
    max_batch a job -> serve_summarize payloads (greedy)."""
    by_bucket: dict = {}
    for i, (text, limit) in enumerate(zip(texts, limits)):
        n = len(text.encode("utf-8"))
        bucket = next((b for b in SERVE_LEN_BUCKETS if n <= b), SERVE_LEN_BUCKETS[-1])
        by_bucket.setdefault(bucket, []).append({"req_id": f"q{i:04d}", "text": text,
                                                 "max_length": limit})
    return [with_model({"requests": reqs[s:s + max_batch], "bucket": bucket})
            for bucket, reqs in by_bucket.items() for s in range(0, len(reqs), max_batch)]


def agent_jobs() -> list:
    """The serve_summarize jobs of the agent's run: SERVE_AGENT_JOBS
    requests of 20-60 bytes (one length bucket), budgets drawn as the
    stream's (90 % T // 32, else T)."""
    rng = random.Random(SEED + 17)
    long_ = serve_cfg().max_tgt_len
    short = max(2, long_ // 32)
    jobs = []
    for j, n in enumerate(SERVE_AGENT_JOBS):
        texts = random_texts(rng, n, 20, 60)
        limits = [short if rng.random() < SERVE_SHORT_FRAC else long_ for _ in texts]
        for job in serve_batches(texts, limits):
            for r in job["requests"]:
                r["req_id"] = f"j{j}-{r['req_id']}"
            jobs.append(job)
    return jobs


def disagg_jobs(round_idx: int) -> list:
    """bench.py's disaggregated mix (bench.py:1383-1392, :1592-1606): of
    DISAGG_REQUESTS requests every 4th a one-off, the rest one of
    DISAGG_DOCS shared documents, 4 tokens each, batched as the front door
    batches them (SERVE_MAX_BATCH a job)."""
    docs = [f"shared context document {d} " + "with common preamble content " * 8
            for d in range(DISAGG_DOCS)]
    texts = [f"one-off request r{round_idx} i{i} " + "tail words " * 18 if i % 4 == 0
             else docs[i % DISAGG_DOCS] for i in range(DISAGG_REQUESTS)]
    return serve_batches(texts, [4] * DISAGG_REQUESTS, max_batch=SERVE_MAX_BATCH)


def serving_cases(serve) -> list:
    """Row 1's shapes and key lengths on the serving path, as the serve
    stage pads them: one admit batch (B 8) and the whole stream (B 240) of
    the bench stream at L 64, the agent's jobs and the disaggregated
    measured round's buckets."""
    cfg = serve_cfg()
    H, D, dtype = cfg.n_heads, cfg.d_model // cfg.n_heads, cfg.compute_dtype
    cases = [(f"serve_admit8/B8xL{SERVE_SRC}", (8, H, SERVE_SRC, SERVE_SRC, D),
              [SERVE_SRC] * 8, dtype),
             (f"serve_stream240/B{SERVE_REQUESTS}xL{SERVE_SRC}",
              (SERVE_REQUESTS, H, SERVE_SRC, SERVE_SRC, D), [SERVE_SRC] * SERVE_REQUESTS, dtype)]
    for name, jobs in (("serve_agent", agent_jobs()), ("serve_disagg", disagg_jobs(1))):
        for job in jobs:
            phase, state = serve.stage(dict(job))
            if phase != "staged":
                raise SystemExit(f"{name} did not stage: {state}")
            B, L = state["ids"].shape
            cases.append((f"{name}/B{B}xL{L}", (B, H, L, L, D), state["lengths"].tolist(),
                          dtype))
    return cases


def per_request(results: list) -> list:
    return [{k: r[k] for k in ("req_id", "summary", "tokens", "steps")}
            for out in results for r in out["results"]]


def serving_agent(fa, rt) -> dict:
    """serve_summarize jobs of 8-32 requests through the port's pipelined
    agent against the stand-in controller, sharing one engine, against the
    same payloads run serially through the op; then bench.py's
    disaggregated mix as serve_prefill -> serve_decode over b1 after a warm
    round, against the colocated op; and summarize_encode ->
    summarize_decode against map_summarize. Row 1's launches are counted
    for each."""
    from agent_tpu_torch.agent.app import Agent
    from agent_tpu_torch.config import AgentConfig, Config
    from agent_tpu_torch.ops import load_ops, serve_infer
    from agent_tpu_torch.runtime.context import OpContext

    ops = load_ops(["serve_summarize", "serve_prefill", "serve_decode", "summarize_encode",
                    "summarize_decode", "map_summarize"])
    device = torch.device(CARD).type
    n_enc = serve_cfg().n_enc_layers
    serve_infer.reset_engines()
    jobs = agent_jobs()
    report = {}
    with StandInController() as ctrl:
        agent = Agent(Config(agent=AgentConfig(
            controller_url=ctrl.url, agent_name="chip-smoke-serving",
            tasks=("serve_summarize", "serve_prefill", "serve_decode"), max_tasks=4,
            idle_sleep_sec=0.005, pipeline_depth=2)), runtime=rt)
        ctx = OpContext(runtime=rt, config=agent.config)
        now = time.time()
        for job in jobs:
            for r in job["requests"]:
                r["arrived_wall"] = now
        ids = [ctrl.submit("serve_summarize", job) for job in jobs]
        occupancy, stop = [], threading.Event()

        def sample():
            while not stop.is_set():
                occupancy.append(agent.m_serve_occupancy.value())
                time.sleep(0.002)

        sampler = threading.Thread(target=sample, daemon=True)
        reset_counts(fa)
        sampler.start()
        wall, _ = pipelined_drain(agent, ctrl)
        stop.set()
        sampler.join(timeout=10)
        launches = fa.LAUNCH_COUNTS["flash_attention"]
        results = [j["result"] for j in ctrl.outcome(ids)]
        engines = len(serve_infer._ENGINES)
        bad = [r for r in results if not r.get("ok") or r.get("device") != device]
        serial = [ops["serve_summarize"](dict(job), ctx) for job in jobs]
        ttft = sorted(r["ttft_ms"] for out in results for r in out["results"])
        tokens = sum(r["steps"] for out in results for r in out["results"])
        report["agent"] = {
            "jobs": [len(job["requests"]) for job in jobs], "wall_s": wall,
            "tok_per_s": tokens / wall, "tokens": tokens, "engines": engines,
            "ttft_ms_p50": statistics.median(ttft), "ttft_ms_p95": ttft[int(0.95 * len(ttft))],
            "occupancy_gauge_max": max(occupancy or [0.0]),
            "occupancy_gauge_end": agent.m_serve_occupancy.value(),
            "occupancy_by_job": [r["occupancy"] for r in results],
            "launches": launches, "launches_want": n_enc * len(jobs)}
        if bad or engines != 1 or per_request(results) != per_request(serial) \
                or launches != n_enc * len(jobs):
            raise SystemExit(f"serving through the agent failed: {report['agent']} "
                             f"{str(bad)[:300]}")

        # bench.py's disaggregated mix: the warm round through the op, the
        # measured round through the agent.
        for job in disagg_jobs(0):
            if not ops["serve_prefill"](dict(job), ctx)["ok"]:
                raise SystemExit("a warm serve_prefill failed")
        measured = disagg_jobs(1)
        now = time.time()
        for job in measured:
            for r in job["requests"]:
                r["arrived_wall"] = now
        reset_counts(fa)
        pre_ids = [ctrl.submit("serve_prefill", job) for job in measured]
        prefill_wall, _ = pipelined_drain(agent, ctrl)
        prefill_launches = fa.LAUNCH_COUNTS["flash_attention"]
        prefills = ctrl.outcome(pre_ids)
        pre = [j["result"] for j in prefills]
        hits = sum(r["prefix_cache"]["hits"] for r in pre)
        misses = sum(r["prefix_cache"]["misses"] for r in pre)
        want_prefill = n_enc * sum(1 for r in pre if r["prefix_cache"]["misses"])
        t0 = time.perf_counter()
        handoffs = [dict(r, enc_rows=np.asarray(r["enc_rows"]).tolist(),
                         lengths=np.asarray(r["lengths"]).tolist()) for r in pre]
        handoff_s = time.perf_counter() - t0
        reset_counts(fa)
        dec_ids = [ctrl.submit("serve_decode", dict(job, encoded=h))
                   for job, h in zip(measured, handoffs)]
        decode_wall, _ = pipelined_drain(agent, ctrl)
        decode_launches = fa.LAUNCH_COUNTS["flash_attention"]
        decoded = [j["result"] for j in ctrl.outcome(dec_ids)]
        colocated = [ops["serve_summarize"](dict(job), ctx) for job in measured]
        ttft = sorted(r["ttft_ms"] for out in decoded for r in out["results"])
        report["disagg"] = {
            "jobs": [[len(j["requests"]), j["bucket"]] for j in measured],
            "prefill_b1": [j["b1"] for j in prefills], "hit_rate": hits / (hits + misses),
            "hits": hits, "misses": misses, "prefill_launches": prefill_launches,
            "prefill_launches_want": want_prefill, "decode_launches": decode_launches,
            "ttft_ms_p50": statistics.median(ttft), "ttft_ms_p95": ttft[int(0.95 * len(ttft))],
            "prefill_drain_s": prefill_wall, "handoff_tolist_s": handoff_s,
            "decode_drain_s": decode_wall,
            "equal_to_colocated": per_request(decoded) == per_request(colocated)}
        if not all(j["b1"] for j in prefills) or hits / (hits + misses) < 0.5 \
                or prefill_launches != want_prefill or decode_launches \
                or not report["disagg"]["equal_to_colocated"] \
                or any(r.get("device") != device for r in pre + decoded):
            raise SystemExit(f"the disaggregated chain failed: {report['disagg']}")
        if ctrl.stale:
            raise SystemExit(f"{ctrl.stale} serving results came with a stale epoch or lease")

    # summarize_encode -> summarize_decode against map_summarize, greedy.
    texts = random_texts(random.Random(SEED + 18), MPMD_ROWS, 20, 60)
    counts = {}
    reset_counts(fa)
    enc = ops["summarize_encode"](with_model({"texts": texts}), ctx)
    counts["encode"] = fa.LAUNCH_COUNTS["flash_attention"]
    reset_counts(fa)
    dec = ops["summarize_decode"](with_model({"encoded": enc, "max_length": S2S_MAX_NEW}), ctx)
    counts["decode"] = fa.LAUNCH_COUNTS["flash_attention"]
    whole = ops["map_summarize"](with_model({"texts": texts, "max_length": S2S_MAX_NEW}), ctx)
    report["mpmd"] = {"rows": MPMD_ROWS, "launches": counts,
                      "equal_to_map_summarize": dec.get("summaries") == whole["summaries"],
                      "devices": [enc.get("device"), dec.get("device")]}
    if not report["mpmd"]["equal_to_map_summarize"] or counts != {"encode": n_enc,
                                                                   "decode": 0}:
        raise SystemExit(f"summarize_encode -> summarize_decode failed: {report['mpmd']}")
    return report


def serve_classify_check(fa, ctx, texts: list, k: int) -> dict:
    """serve_classify at BERT-base width (run while phase 4's weights are on
    the card): one batch of requests, row 1 once per layer, each answer
    equal to map_classify_tpu's columnar result for the same texts."""
    from agent_tpu_torch.ops import load_ops

    ops = load_ops(["serve_classify", "map_classify_tpu"])
    payload = {"requests": [{"req_id": f"c{i}", "text": t} for i, t in enumerate(texts)],
               "model_config": BERT_BASE, "topk": k}
    reset_counts(fa)
    out = ops["serve_classify"](payload, ctx)
    launches = fa.LAUNCH_COUNTS["flash_attention"]
    want = ops["map_classify_tpu"]({"texts": texts, "model_config": BERT_BASE, "topk": k,
                                    "result_format": "columnar", "allow_fallback": False}, ctx)
    same = [r["indices"] for r in out["results"]] == want["indices"] \
        and [r["scores"] for r in out["results"]] == want["scores"]
    report = {"requests": len(texts), "launches": launches,
              "launches_want": BERT_BASE["n_layers"], "equal_to_map_classify": same,
              "device": out.get("device")}
    emit(dict({"phase": "serve_classify", "config": BERT_BASE}, **report))
    if not same or launches != BERT_BASE["n_layers"] \
            or out.get("device") != torch.device(CARD).type:
        raise SystemExit(f"serve_classify failed: {report}")
    return report


def serving_phase(fa, rt, classify_check: dict) -> dict:
    """Phase 13: continuous-batching serving on the card (see the module
    docstring)."""
    from agent_tpu_torch.models import seq2seq
    from agent_tpu_torch.ops import map_summarize as summarize_op
    from agent_tpu_torch.runtime.runtime import TorchRuntime

    t0 = time.perf_counter()
    cfg = serve_cfg()
    # The default model's weights, placed where the serving ops look for
    # them, so the ops below reuse them.
    model = rt.get_params(summarize_op.params_key(summarize_op.DEFAULT_MODEL_ID, "seq2seq", cfg),
                          lambda: summarize_op._build_model(summarize_op.DEFAULT_MODEL_ID, cfg,
                                                            "seq2seq", rt.device))
    attn_fn = TorchRuntime(device=CARD).attention_fn()
    stream = serving_stream(cfg)
    reset_counts(fa)
    with torch.inference_mode():
        enc_all = seq2seq.encode(model, torch.from_numpy(stream[0]).to(CARD),
                                 torch.from_numpy(stream[1]).to(CARD), attn_fn
                                 ).float().cpu().numpy()
    prefill_launches = fa.LAUNCH_COUNTS["flash_attention"]
    if prefill_launches != cfg.n_enc_layers:
        raise SystemExit(f"the stream's prefill launched row 1 {prefill_launches} times")
    seconds = {}
    legs = []
    for beams, slots, profile in ((1, SERVE_SLOTS, True), (SERVE_BEAMS, SERVE_SLOTS, True),
                                  (1, SERVE_WIDE_SLOTS, False)):
        t1 = time.perf_counter()
        legs.append(engine_vs_static(model, attn_fn, stream, enc_all, beams, slots, profile))
        seconds[f"beams{beams}_slots{slots}"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    exact = serving_exactness()
    seconds["exactness"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    agent = serving_agent(fa, rt)
    seconds["agent_disagg_mpmd"] = time.perf_counter() - t1
    report = {"phase": "serving", "config": SERVE_MODEL or "Seq2SeqConfig defaults (d_model "
              "256, 8 heads, 4 + 4 layers, d_ff 1024, vocab 260, max_tgt_len 130, bf16)",
              "stream": {"requests": SERVE_REQUESTS, "src": SERVE_SRC, "seed": SERVE_SEED,
                         "short_frac": SERVE_SHORT_FRAC},
              "stream_prefill_launches": prefill_launches, "engine_vs_static": legs,
              "exactness_f32": exact, **agent, "serve_classify": classify_check,
              "seconds": time.perf_counter() - t0, "seconds_by_part": seconds}
    emit(report)
    return report


def place_seeded(rt, configs: dict, flat) -> None:
    """The classify op's seeded encoder in each of ``configs``' modes put on
    ``rt`` under the op's weights key, from one f32 draw ``flat`` of the
    op's default model id: the op's own build (``from_jax_params``, which
    quantizes a mode's tables from f32), without drawing again for each
    mode (a BERT-base MoE draws 453M normals on the host). The op's
    requests then find them resident (``held_resident`` checks it)."""
    from agent_tpu_torch.models import encoder
    from agent_tpu_torch.ops import map_classify_tpu as classify_op

    for conf in configs.values():
        cfg = encoder.EncoderConfig(**conf)
        rt.get_params(classify_op.params_key(classify_op.DEFAULT_MODEL_ID, "encoder", cfg),
                      lambda cfg=cfg: encoder.from_jax_params(flat, cfg))


def held_resident(rt, configs: dict) -> None:
    """Fails when the op built weights of its own beside ``place_seeded``'s."""
    from agent_tpu_torch.models import encoder
    from agent_tpu_torch.ops import map_classify_tpu as classify_op

    placed = {classify_op.params_key(classify_op.DEFAULT_MODEL_ID, "encoder",
                                     encoder.EncoderConfig(**conf)) for conf in configs.values()}
    resident_now = set(rt.describe()["models_resident"])
    if resident_now != placed:
        raise SystemExit(f"the op built weights of its own: {sorted(resident_now - placed)}")


def agreement_floor(control: float) -> float:
    """The least top-1 agreement with bf16 a quantized mode may show: the
    f32 control's agreement with bf16 (the compute dtype's own noise on
    the same weights and rows) less AGREEMENT_SLACK."""
    return control - AGREEMENT_SLACK


def interleaved(runs: dict, reps: int, check) -> dict:
    """``runs``: mode -> a callable of one request. Each mode warmed once,
    then timed ``reps`` times in turns (the order reversed every round, so
    no mode always runs after another); ``check(mode, result)`` holds each
    timed result -> mode -> (p50 seconds, last result)."""
    for fn in runs.values():
        fn()
    torch.cuda.synchronize()
    gc.collect()
    walls, last = {m: [] for m in runs}, {}
    order = list(runs)
    for rep in range(reps):
        for mode in (order if rep % 2 == 0 else order[::-1]):
            t0 = time.perf_counter()
            out = runs[mode]()
            walls[mode].append(time.perf_counter() - t0)
            check(mode, out)
            last[mode] = out
    return {m: (statistics.median(w), last[m]) for m, w in walls.items()}


def resident_bytes(weights) -> int:
    """Bytes of every parameter and buffer (a module) or leaf (a tree)."""
    if isinstance(weights, torch.nn.Module):
        return sum(t.numel() * t.element_size()
                   for t in list(weights.parameters()) + list(weights.buffers()))
    if isinstance(weights, dict):
        return sum(resident_bytes(v) for v in weights.values())
    if isinstance(weights, list):
        return sum(resident_bytes(v) for v in weights)
    return weights.numel() * weights.element_size() if isinstance(weights, torch.Tensor) else 0


def resident(rt, key: str):
    """The weights an op call left on the runtime under ``key``."""
    def missing():
        raise SystemExit(f"{key} is not resident")

    return rt.get_params(key, missing)


def ok_rows(rows: int):
    """A check for ``interleaved``: a summarize result of ``rows`` summaries."""
    def check(mode, out):
        if not out.get("ok") or out.get("device") != torch.device(CARD).type \
                or len(out["summaries"]) != rows:
            raise SystemExit(f"{mode}: {str(out)[:300]}")
    return check


def launch_delta(fa, fn, want: dict, tally: dict | None = None):
    """``fn()``, holding the kernels it launched to ``want`` (the others 0);
    the launches counted are added into ``tally`` when one is given."""
    before = dict(fa.LAUNCH_COUNTS)
    out = fn()
    got = {key: fa.LAUNCH_COUNTS[key] - before[key] for key in fa.LAUNCH_COUNTS}
    if got != {key: want.get(key, 0) for key in got}:
        raise SystemExit(f"kernel launches {got}, want {want}")
    if tally is not None:
        for key, n in got.items():
            tally[key] = tally.get(key, 0) + n
    return out


def quant_classify(fa, classify, ctx, rt) -> dict:
    """Phase 14, classify: BERT-base in bf16, int8 and w8a16 (bench.py's
    bert_base_int8 leg), drawn once (``place_seeded``): rows/s of the
    256-row request in turns, each mode's ratio to bf16, top-1 agreement
    with bf16 over AGREEMENT_ROWS rows held to ``agreement_floor`` of the
    f32 control's, the resident weight bytes, row 1's launches (n_layers a
    request in every mode); then one int8 request of one 8-byte text, whose
    staged [1, 16] gives _int_mm 16 rows, held to bf16's top-1."""
    from agent_tpu_torch.models import encoder
    from agent_tpu_torch.ops import map_classify_tpu as classify_op

    n_layers = BERT_BASE["n_layers"]
    texts = random_texts(random.Random(SEED + 20), QUANT_ROWS, QUANT_TEXT_LEN, QUANT_TEXT_LEN)
    words = np.random.default_rng(7)
    agree = [" ".join(words.choice(AGREEMENT_WORDS, size=60).tolist()) + f" case {i}"
             for i in range(AGREEMENT_ROWS)]
    modes = ("none",) + QUANT_MODES
    configs = {m: dict(BERT_BASE, quant=m) for m in modes}
    configs["float32"] = dict(BERT_BASE, dtype="float32")  # the agreement's control
    SEEDED["dense"] = encoder.init_params(encoder.EncoderConfig(**BERT_BASE),
                                          classify_op.DEFAULT_MODEL_ID)
    place_seeded(rt, configs, SEEDED["dense"])
    launches = {m: 0 for m in modes}

    def request(mode):
        payload = {"texts": texts, "topk": 5, "model_config": configs[mode],
                   "allow_fallback": False}
        out = launch_delta(fa, lambda: classify(payload, ctx), {"flash_attention": n_layers})
        launches[mode] += n_layers
        return out

    reset_counts(fa)
    timed = interleaved({m: (lambda m=m: request(m)) for m in modes}, QUANT_REPS,
                        lambda m, out: check_result(out, QUANT_ROWS, 5))
    report = {}
    top1 = {}
    for mode in configs:
        picks = []
        for s in range(0, AGREEMENT_ROWS, AGREEMENT_CHUNK):
            out = classify({"texts": agree[s:s + AGREEMENT_CHUNK], "topk": 1,
                            "result_format": "columnar", "model_config": configs[mode]}, ctx)
            picks.append(np.asarray(out["indices"])[:, 0])
        top1[mode] = np.concatenate(picks)
    for mode in modes:
        model = resident(rt, classify_op.params_key(
            classify_op.DEFAULT_MODEL_ID, "encoder", encoder.EncoderConfig(**configs[mode])))
        p50 = timed[mode][0]
        report[mode] = {"p50_ms": p50 * 1e3, "rows_per_s": QUANT_ROWS / p50,
                        "resident_weight_bytes": resident_bytes(model),
                        "row1_launches": launches[mode]}
    control = float(np.mean(top1["float32"] == top1["none"]))
    report["top1_agreement_control_f32_vs_bf16"] = control
    report["top1_agreement_floor"] = agreement_floor(control)
    for mode in QUANT_MODES:
        report[mode]["rows_per_s_vs_bf16"] = report[mode]["rows_per_s"] / \
            report["none"]["rows_per_s"]
        report[mode]["top1_agreement_vs_bf16"] = float(np.mean(top1[mode] == top1["none"]))
    if len(set(launches.values())) != 1:
        raise SystemExit(f"row 1's launches differ between the modes: {launches}")

    small = {"texts": [W8A8_SMALL_TEXT], "topk": 5, "allow_fallback": False}
    _, state = classify.stage(dict(small, model_config=configs["int8"]), ctx)
    rows = int(np.prod(state["chunks"][0][0].shape))
    outs = {m: launch_delta(fa, lambda m=m: classify(dict(small, model_config=configs[m]), ctx),
                            {"flash_attention": n_layers}) for m in ("none", "int8")}
    for out in outs.values():
        check_result(out, 1, 5)
    if rows > 16:
        raise SystemExit(f"the small int8 request staged {rows} rows, not 16 or fewer")
    report["int8_small_request"] = {"text": W8A8_SMALL_TEXT, "int_mm_rows": rows,
                                    "top1": outs["int8"]["results"][0]["topk"][0]["index"],
                                    "top1_bf16": outs["none"]["results"][0]["topk"][0]["index"]}
    report["agreement_rows"] = AGREEMENT_ROWS
    held_resident(rt, configs)
    low = {m: report[m]["top1_agreement_vs_bf16"] for m in QUANT_MODES
           if report[m]["top1_agreement_vs_bf16"] < report["top1_agreement_floor"]}
    small_out = report["int8_small_request"]
    if low or small_out["top1"] != small_out["top1_bf16"]:
        raise SystemExit(f"quantized classify disagrees with bf16 beyond the f32 control "
                         f"{low} or on the 16-row request: {report}")
    return report


def moe_phase(fa, classify, ctx, rt, train_batch) -> dict:
    """Phase 14, MoE: BERT-base with MOE_EXPERTS experts (bench.py's moe
    leg), drawn once (``place_seeded``): the 256-row classify request in
    bf16 and int8 in turns (row 1 n_layers times a request), int8's top-1
    agreement with bf16 held to ``agreement_floor`` of the f32 control's;
    then the train step at phase 6's first batch (batch 128, L 512): one
    warm-up and MOE_TRAIN_STEPS timed steps, rows 4-6 each n_layers times a
    step, the Switch aux loss before and after them."""
    from agent_tpu_torch.models import encoder, train
    from agent_tpu_torch.ops import map_classify_tpu as classify_op

    n_layers = BERT_BASE["n_layers"]
    texts = random_texts(random.Random(SEED + 21), QUANT_ROWS, QUANT_TEXT_LEN, QUANT_TEXT_LEN)
    moe_base = dict(BERT_BASE, moe_experts=MOE_EXPERTS)
    configs = {m: dict(moe_base, quant=m) for m in ("none", "int8")}
    control = dict(configs, float32=dict(moe_base, dtype="float32"))
    launches = {m: 0 for m in configs}
    t0 = time.perf_counter()
    flat = encoder.init_params(encoder.EncoderConfig(**moe_base), classify_op.DEFAULT_MODEL_ID)
    SEEDED["moe"] = flat  # phase 16 places it on its ep meshes
    weights_draw_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    place_seeded(rt, control, flat)
    weights_place_s = time.perf_counter() - t0

    def request(mode):
        payload = {"texts": texts, "topk": 5, "model_config": configs[mode],
                   "allow_fallback": False}
        out = launch_delta(fa, lambda: classify(payload, ctx), {"flash_attention": n_layers})
        launches[mode] += n_layers
        return out

    reset_counts(fa)
    timed = interleaved({m: (lambda m=m: request(m)) for m in configs}, QUANT_REPS,
                        lambda m, out: check_result(out, QUANT_ROWS, 5))
    f32_out = classify({"texts": texts, "topk": 5, "model_config": control["float32"],
                        "allow_fallback": False}, ctx)
    check_result(f32_out, QUANT_ROWS, 5)
    held_resident(rt, control)
    report = {"experts": MOE_EXPERTS, "n_layers": n_layers, "weights_draw_s": weights_draw_s,
              "weights_place_s": weights_place_s}
    for mode in configs:
        model = resident(rt, classify_op.params_key(
            classify_op.DEFAULT_MODEL_ID, "encoder", encoder.EncoderConfig(**configs[mode])))
        p50 = timed[mode][0]
        report[f"classify_{mode}"] = {"p50_ms": p50 * 1e3, "rows_per_s": QUANT_ROWS / p50,
                                      "resident_weight_bytes": resident_bytes(model),
                                      "row1_launches": launches[mode]}
    top1 = {m: np.asarray([r["topk"][0]["index"] for r in out["results"]])
            for m, out in (("none", timed["none"][1]), ("int8", timed["int8"][1]),
                           ("float32", f32_out))}
    agree = float(np.mean(top1["int8"] == top1["none"]))
    control_agree = float(np.mean(top1["float32"] == top1["none"]))
    report["classify_int8"]["top1_agreement_vs_bf16"] = agree
    report["top1_agreement_control_f32_vs_bf16"] = control_agree
    report["top1_agreement_floor"] = agreement_floor(control_agree)
    if agree < report["top1_agreement_floor"]:
        raise SystemExit(f"the int8 MoE disagrees with bf16 beyond the f32 control: {report}")
    rt.clear_params()

    cfg = encoder.EncoderConfig(**moe_base)
    state, take = train_batch
    ids, mask, labels = (torch.from_numpy(np.ascontiguousarray(state[k][take])).to(CARD)
                         for k in ("ids", "mask", "labels"))
    model = encoder.from_jax_params(flat, cfg, device=CARD, trainable=True)
    del flat
    attn_fn = rt.train_attention_fn()
    with torch.no_grad():
        aux_before = float(model(ids, mask, attn_fn, with_aux=True)[1])
    init, step = train.make_train_step(cfg, train.adamw(1e-3), attn_fn=attn_fn)
    opt = init(model)
    model, opt, loss = step(model, opt, ids, mask, labels)
    losses = [float(loss)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa)
    walls = []
    for _ in range(MOE_TRAIN_STEPS):
        t0 = time.perf_counter()
        model, opt, loss = step(model, opt, ids, mask, labels)
        losses.append(float(loss))  # reading the loss waits for the step
        walls.append(time.perf_counter() - t0)
    train_launches = {key: fa.LAUNCH_COUNTS[key] for key in TRAIN_KERNELS}
    want = {key: n_layers * MOE_TRAIN_STEPS for key in TRAIN_KERNELS}
    if train_launches != want or fa.LAUNCH_COUNTS["flash_attention"]:
        raise SystemExit(f"MoE train launches {dict(fa.LAUNCH_COUNTS)}, want {want}")
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        _, aux = model(ids, mask, attn_fn, with_aux=True)
    p50 = statistics.median(walls)
    report["train"] = {"batch": int(ids.shape[0]), "seq_len": int(ids.shape[1]),
                       "steps": MOE_TRAIN_STEPS, "step_p50_ms": p50 * 1e3,
                       "examples_per_s": ids.shape[0] / p50, "losses": losses,
                       "aux_loss_before": aux_before, "aux_loss": float(aux),
                       "peak_bytes": peak, "launches": train_launches}
    if not all(math.isfinite(x) for x in losses + [aux_before, float(aux)]):
        raise SystemExit(f"MoE training gave a non-finite loss: {report['train']}")
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    return report


def moe_exactness_f32(rt) -> dict:
    """Phase 14, MoE exactness: the small f32 MoE encoder (MOE_F32: 4
    experts, groups of 512 tokens at capacity 1.25, so tokens are dropped)
    on the card against the CPU, from the same weights and MOE_F32_ROWS
    padded rows: the logits, the Switch aux loss, the training loss and
    every leaf's gradient of one step (relative L2), then the losses of
    MOE_F32_STEPS AdamW steps, each within MOE_F32_REL_TOL. The card runs
    the training kernels (rows 4-6, f32), the CPU their plain version; both
    run ``moe.Route``'s backward."""
    from agent_tpu_torch.models import encoder, train
    from agent_tpu_torch.runtime.runtime import TorchRuntime

    cfg = encoder.EncoderConfig(**MOE_F32)
    flat = encoder.init_params(cfg, "moe-exact")
    rng = np.random.default_rng(SEED + 24)
    B, L = MOE_F32_ROWS, cfg.max_len
    lengths = rng.integers(L // 4, L + 1, B)
    mask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.int32)
    ids = rng.integers(4, cfg.vocab_size, (B, L)).astype(np.int32) * mask
    labels = rng.integers(0, cfg.n_classes, B).astype(np.int32)
    sides = {}
    for side, where, run_rt in (("card", CARD, rt), ("cpu", "cpu", TorchRuntime(device="cpu"))):
        attn_fn = run_rt.train_attention_fn()
        model = encoder.from_jax_params(flat, cfg, device=where, trainable=True)
        batch = [torch.from_numpy(a).to(where) for a in (ids, mask, labels)]
        with torch.enable_grad():
            logits, aux = model(batch[0], batch[1], attn_fn, with_aux=True)
            loss = train.cross_entropy_loss(model, *batch, attn_fn=attn_fn)
            loss.backward()
        grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()
                 if p.grad is not None}
        init, step = train.make_train_step(cfg, train.adamw(1e-2), attn_fn=attn_fn)
        opt = init(model)
        losses = [float(step(model, opt, *batch)[2]) for _ in range(MOE_F32_STEPS)]
        sides[side] = {"logits": logits.detach().cpu(), "aux": aux.detach().cpu(),
                       "loss": loss.detach().cpu(), "grads": grads,
                       "losses": torch.tensor(losses)}
    card, cpu = sides["card"], sides["cpu"]

    def rel(a, b) -> float:
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    if set(card["grads"]) != set(cpu["grads"]):
        raise SystemExit(f"MoE gradients on different leaves: "
                         f"{sorted(set(card['grads']) ^ set(cpu['grads']))}")
    report = {"rows": B, "seq_len": L, "tolerance": MOE_F32_REL_TOL,
              **{k: rel(card[k], cpu[k]) for k in ("logits", "aux", "loss", "losses")},
              "grads_max_rel_l2": max(rel(card["grads"][k], cpu["grads"][k])
                                      for k in cpu["grads"]),
              "router_grad_rel_l2": max(rel(card["grads"][k], cpu["grads"][k])
                                        for k in cpu["grads"] if ".router." in k),
              "aux_card_cpu": [float(card["aux"]), float(cpu["aux"])],
              "losses_card": card["losses"].tolist(), "losses_cpu": cpu["losses"].tolist()}
    worst = max(v for k, v in report.items() if k in (
        "logits", "aux", "loss", "losses", "grads_max_rel_l2"))
    if not worst <= MOE_F32_REL_TOL:
        raise SystemExit(f"the f32 MoE on the card disagrees with the CPU: {report}")
    return report


def summarize_w8a16(fa, summarize, ctx, rt) -> dict:
    """Phase 14, seq2seq: phase 8's requests (256 rows greedy, 64 rows with 4
    beams, 32 new tokens) in bf16 and w8a16 in turns, emitted tokens/s and
    the ratio; token agreement with bf16 of greedy decodes of
    DECODE_AGREEMENT_ROWS rows of random ids, and of the f32 decode of the
    same weights (bench.py's control: the model's own noise)."""
    from dataclasses import replace

    from agent_tpu_torch.models import seq2seq
    from agent_tpu_torch.models.tokenizer import EOS_ID, PAD_ID
    from agent_tpu_torch.ops import map_summarize as summarize_op

    report = {}
    launches = {"none": 0, "w8a16": 0}
    reset_counts(fa)
    for name, payload, rows in (
            ("texts256_greedy", {"texts": [S2S_TEXT] * S2S_ROWS, "max_length": S2S_MAX_NEW},
             S2S_ROWS),
            ("texts64_beam4", {"texts": [S2S_TEXT] * S2S_BEAM_ROWS, "max_length": S2S_MAX_NEW,
                               "num_beams": S2S_BEAMS}, S2S_BEAM_ROWS)):
        emitted = {}

        def request(mode, payload=payload):
            def run():
                _, state = summarize.stage(dict(payload, model_config={"quant": mode}), ctx)
                out = summarize.finalize(summarize.execute(state, ctx), ctx)
                emitted[mode] = count_emitted(state["token_chunks"], PAD_ID, EOS_ID)
                return out
            out = launch_delta(fa, run, {"flash_attention": S2S_ENC_LAYERS})
            launches[mode] += S2S_ENC_LAYERS
            return out

        timed = interleaved({m: (lambda m=m: request(m)) for m in ("none", "w8a16")},
                            QUANT_REPS, ok_rows(rows))
        entry = {m: {"p50_ms": timed[m][0] * 1e3, "emitted_tokens": emitted[m],
                     "emitted_tokens_per_s": emitted[m] / timed[m][0],
                     "bench_tokens_per_s": rows * S2S_MAX_NEW / timed[m][0]}
                 for m in timed}
        entry["w8a16_vs_bf16"] = timed["none"][0] / timed["w8a16"][0]
        report[name] = entry

    cfg = seq2seq.Seq2SeqConfig()
    report["launches"] = launches
    models = {m: resident(rt, summarize_op.params_key(summarize_op.DEFAULT_MODEL_ID, "seq2seq",
                                                      replace(cfg, quant=m)))
              for m in ("none", "w8a16")}
    models["float32"] = seq2seq.from_jax_params(
        seq2seq.init_params(cfg, summarize_op.DEFAULT_MODEL_ID),
        replace(cfg, dtype="float32"), device=CARD)
    attn_fn = rt.attention_fn()
    rng = np.random.default_rng(11)
    ids = rng.integers(4, cfg.vocab_size, (DECODE_AGREEMENT_ROWS, DECODE_AGREEMENT_SRC))
    toks = {m: [] for m in models}
    with torch.inference_mode():
        for s in range(0, DECODE_AGREEMENT_ROWS, 256):
            src = torch.from_numpy(ids[s:s + 256].astype(np.int32)).to(CARD)
            mask = torch.ones_like(src)
            for m, model in models.items():
                toks[m].append(seq2seq.greedy_generate(model, src, mask, S2S_MAX_NEW,
                                                       attn_fn=attn_fn)[0].cpu().numpy())
    toks = {m: np.concatenate(t) for m, t in toks.items()}
    report["decode_agreement"] = {
        "rows": DECODE_AGREEMENT_ROWS, "max_new": S2S_MAX_NEW, "num_beams": 1,
        "token_w8a16_vs_bf16": float(np.mean(toks["w8a16"] == toks["none"])),
        "sequence_w8a16_vs_bf16": float(np.mean((toks["w8a16"] == toks["none"]).all(axis=1))),
        "token_control_f32_vs_bf16": float(np.mean(toks["float32"] == toks["none"]))}
    del models
    rt.clear_params()
    return report


def t5_w8a16(fa, op, rt, ckpt, requests) -> dict:
    """Phase 14, T5-large: phase 9's greedy request (64 rows, 32 new tokens)
    through the op's device phase in w8a16 and bf16 in turns, row 3 once per
    encoder layer a request, token agreement and the resident bytes."""

    name, chunks, beams, n_rows = requests[0]
    models, toks, launches = {}, {}, {m: 0 for m in ("w8a16", "none")}
    for mode in launches:
        cfg = op._get_cfg({"model_path": ckpt, "model_config": {"quant": mode}}, "t5", ckpt)
        t0 = time.perf_counter()
        models[mode] = (cfg, rt.get_params(op.params_key(ckpt, "t5", cfg),
                                           lambda cfg=cfg: op._build_model(ckpt, cfg, "t5",
                                                                           rt.device)),
                        time.perf_counter() - t0)

    def request(mode):
        cfg = models[mode][0]
        pending = launch_delta(fa, lambda: op._decode_chunks(rt, chunks, ckpt, cfg, T5_MAX_NEW,
                                                             beams, family="t5"),
                               {"flash_attention_t5": cfg.n_enc_layers})
        launches[mode] += cfg.n_enc_layers
        toks[mode] = np.concatenate([t.cpu().numpy()[:n] for t, n in pending])
        return toks[mode]

    reset_counts(fa)
    timed = interleaved({m: (lambda m=m: request(m)) for m in launches}, 2, lambda m, out: None)
    report = {"request": name, "rows": n_rows, "max_new": T5_MAX_NEW, "launches": launches,
              "token_agreement_vs_bf16": float(np.mean(toks["w8a16"] == toks["none"]))}
    for mode, (cfg, params, load_s) in models.items():
        report[mode] = {"p50_ms": timed[mode][0] * 1e3, "load_s": load_s,
                        "bench_tokens_per_s": n_rows * T5_MAX_NEW / timed[mode][0],
                        "resident_weight_bytes": resident_bytes(params)}
    report["w8a16_vs_bf16"] = timed["none"][0] / timed["w8a16"][0]
    rt.clear_params()
    return report


def bart_w8a16(fa, summarize, ctx, rt, ckpt, requests) -> dict:
    """Phase 14, BART: the first BART_QUANT_ROWS rows of phase 12's greedy
    request through the op in w8a16 and bf16 in turns (row 1 once per
    encoder layer a request), token agreement."""
    _, payload, _ = requests[0]
    payload = dict(payload, texts=payload["texts"][:BART_QUANT_ROWS])
    toks, launches = {}, {"w8a16": 0, "none": 0}
    layers = BART_LARGE_CNN["encoder_layers"]

    def request(mode):
        out, toks[mode] = launch_delta(fa, lambda: summarize_tokens(
            summarize, dict(payload, model_config={"quant": mode}), ctx),
            {"flash_attention": layers})
        launches[mode] += layers
        return out

    timed = interleaved({m: (lambda m=m: request(m)) for m in launches}, 2,
                        ok_rows(BART_QUANT_ROWS))
    report = {"rows": BART_QUANT_ROWS, "max_new": BART_MAX_NEW, "launches": launches,
              "token_agreement_vs_bf16": float(np.mean(toks["w8a16"] == toks["none"])),
              "w8a16_vs_bf16": timed["none"][0] / timed["w8a16"][0]}
    for mode in timed:
        report[mode] = {"p50_ms": timed[mode][0] * 1e3}
    rt.clear_params()
    return report


def engine_w8a16(fa, rt) -> dict:
    """Phase 14, serving: phase 13's stream decoded by a paged engine with
    SERVE_SLOTS slots, greedy, on the bf16 and the w8a16 seq2seq (each
    prefilled by its own encoder: row 1 once per encoder layer), in turns;
    tok/s and the ratio, and the requested tokens' agreement."""
    from dataclasses import replace

    from agent_tpu_torch.models import seq2seq
    from agent_tpu_torch.ops import map_summarize as summarize_op

    cfg = serve_cfg()
    ids, mask, limits = serving_stream(cfg)
    attn_fn = rt.attention_fn()
    sides, tokens = {}, {}
    reset_counts(fa)
    for mode in ("none", "w8a16"):
        mcfg = replace(cfg, quant=mode)
        model = rt.get_params(summarize_op.params_key(summarize_op.DEFAULT_MODEL_ID, "seq2seq",
                                                      mcfg),
                              lambda mcfg=mcfg: summarize_op._build_model(
                                  summarize_op.DEFAULT_MODEL_ID, mcfg, "seq2seq", rt.device))
        with torch.inference_mode():
            enc = launch_delta(fa, lambda model=model: seq2seq.encode(
                model, torch.from_numpy(ids).to(CARD), torch.from_numpy(mask).to(CARD),
                attn_fn).float().cpu().numpy(), {"flash_attention": cfg.n_enc_layers})
        sides[mode] = (new_engine(model, SERVE_SLOTS, 1), enc)

    def engine_pass(mode, n=len(limits)):
        engine, enc = sides[mode]
        tickets = [engine.admit(enc[i], mask[i], limits[i]) for i in range(n)]
        while engine.has_work():
            engine.step()
        tokens[mode] = [t.tokens[:t.limit].tolist() for t in tickets]
        return sum(t.steps for t in tickets)

    for mode in sides:
        engine_pass(mode, SERVE_WARM)
    timed = interleaved({m: (lambda m=m: engine_pass(m)) for m in sides}, 2, lambda m, out: None)
    n_tok = timed["none"][1]
    same = sum(a == b for a, b in zip(tokens["w8a16"], tokens["none"]))
    report = {"requests": len(limits), "slots": SERVE_SLOTS, "num_beams": 1, "tokens": n_tok,
              "requests_equal_vs_bf16": same,
              "prefill_launches": fa.LAUNCH_COUNTS["flash_attention"],
              **{f"{m}_tok_per_s": timed[m][1] / timed[m][0] for m in sides},
              "w8a16_vs_bf16": timed["none"][0] / timed["w8a16"][0]}
    del sides
    rt.clear_params()
    return report


def quant_engine_exactness() -> dict:
    """Phase 14, exactness: the small f32 model (SMALL_S2S_F32) in int8 and
    w8a16, SERVE_EXACT_REQUESTS requests joining one every SERVE_EXACT_EVERY
    steps into 4 slots (so the W8A8 decode steps give _int_mm 4 rows):
    the paged engine's tokens on the card equal to the same engine's on the
    CPU, both from the card's prefill rows."""
    from dataclasses import replace

    from agent_tpu_torch.models import seq2seq
    from agent_tpu_torch.runtime.runtime import TorchRuntime

    base = seq2seq.Seq2SeqConfig(**SMALL_S2S_F32)
    flat = seq2seq.init_params(base, "serving-exact")
    attn_fn = TorchRuntime(device=CARD).attention_fn()
    rng = np.random.default_rng(SEED + 23)
    n, src = SERVE_EXACT_REQUESTS, 32
    ids = rng.integers(4, base.vocab_size, (n, src)).astype(np.int32)
    lengths = rng.integers(8, src + 1, n)
    masks = (np.arange(src)[None, :] < lengths[:, None]).astype(np.int32)
    limits = [int(x) for x in rng.integers(2, base.max_tgt_len, n)]
    report = {}
    for mode in QUANT_MODES:
        cfg = replace(base, quant=mode)
        card, cpu = (seq2seq.from_jax_params(flat, cfg, device=d) for d in (CARD, "cpu"))
        with torch.inference_mode():
            rows = seq2seq.encode(card, torch.from_numpy(ids).to(CARD),
                                  torch.from_numpy(masks).to(CARD), attn_fn).float().cpu().numpy()
            got = {d: sparse_arrivals(new_engine(m, 4, 1, enc_len=src), rows, masks, limits)
                   for d, m in (("card", card), ("cpu", cpu))}
        same = sum(a == b for a, b in zip(got["card"], got["cpu"]))
        report[mode] = {"requests": n, "card_equal_cpu": same}
        if same != n:
            raise SystemExit(f"{mode}: the card's engine gave {n - same} requests other tokens "
                             f"than the CPU's: {report}")
    return report


def quant_moe_phase(fa, rt, smi, train_batch, t5_ckpt, t5_requests, bart_ckpt,
                    bart_reqs) -> dict:
    """Phase 14: quantized serving and the Switch MoE encoder (see the
    module docstring)."""
    from agent_tpu_torch.ops import load_ops
    from agent_tpu_torch.ops import map_summarize as summarize_op
    from agent_tpu_torch.runtime.context import OpContext

    ops = load_ops(["map_classify_tpu", "map_summarize"])
    classify, summarize = ops["map_classify_tpu"], ops["map_summarize"]
    ctx = OpContext(runtime=rt)
    seconds, report = {}, {"phase": "quant_moe", "nvidia_smi": smi}
    for name, fn in (
            ("classify", lambda: quant_classify(fa, classify, ctx, rt)),
            ("moe", lambda: moe_phase(fa, classify, ctx, rt, train_batch)),
            ("moe_exactness_f32", lambda: moe_exactness_f32(rt)),
            ("summarize_seq2seq", lambda: summarize_w8a16(fa, summarize, ctx, rt)),
            ("summarize_t5_large", lambda: t5_w8a16(fa, summarize_op, rt, t5_ckpt,
                                                    t5_requests)),
            ("summarize_bart", lambda: bart_w8a16(fa, summarize, ctx, rt, bart_ckpt,
                                                  bart_reqs)),
            ("engine", lambda: engine_w8a16(fa, rt)),
            ("engine_exactness_f32", quant_engine_exactness)):
        reset_counts(fa)
        t0 = time.perf_counter()
        report[name] = fn()
        seconds[name] = time.perf_counter() - t0
        rt.clear_params()
    report["seconds_by_part"] = seconds
    emit(report)
    return report


# ---- phase 16: dp, tp, pp and ep meshes in one process ----

# Phase 16's meshes, all on the one card (a device listed once a shard).
# Serving: name -> (mesh shape, model_config overrides of BERT_BASE).
MESH_SERVING = {"tp2": ({"tp": 2}, {}), "dp2_tp2": ({"dp": 2, "tp": 2}, {}),
                "pp2": ({"pp": 2}, {}), "dp2_model_config_pp2": ({"dp": 2}, {"pp": 2}),
                "int8_tp2": ({"tp": 2}, {"quant": "int8"}),
                "w8a16_tp2": ({"tp": 2}, {"quant": "w8a16"}),
                "moe_ep2": ({"ep": 2}, {"moe_experts": MOE_EXPERTS}),
                "moe_dp2_ep4": ({"dp": 2, "ep": 4}, {"moe_experts": MOE_EXPERTS})}
MESH_RINGS = {"dp2_sp2": {"dp": 2, "sp": 2}, "tp2_sp2": {"tp": 2, "sp": 2}}
MESH_TRAIN, MESH_TRAIN_STEPS = {"dp": 2, "tp": 2}, 3
# bf16 on a mesh against one device: probabilities within 1e-3. BERT's
# two-class head puts them near 0.5, where one bf16 step of a logit moves a
# probability by about 1e-3: there another valid bf16 evaluation of the
# same weights on one device (the plain attention in place of the kernel)
# already differs by 3.01e-3 on the H100, so BERT is held to 4e-3, that
# spread rounded up to the next 1e-3. Both are fixed; the control is
# reported beside them.
MESH_PROB_TOL = 1e-3
MESH_BERT_PROB_TOL = 4e-3
MESH_F32_TOL = 1e-5   # a small f32 model on a mesh of the card against the CPU
MESH_F32 = {"d_model": 64, "n_heads": 2, "n_layers": 2, "d_ff": 128, "max_len": 64,
            "n_classes": 40, "dtype": "float32"}
MESH_RISK_VALUES = 1 << 20
MESH_REPS = 3
# Phase 14's host draws of the BERT-base encoders ("dense", "moe"): phase 16
# places them on its meshes instead of drawing them again.
SEEDED: dict = {}


def mesh_runtime(shape: dict, distinct: bool = False):
    """A runtime whose mesh of ``shape`` lists the card once a shard, or
    with ``distinct`` one card a shard (cuda:0, cuda:1, ...)."""
    from agent_tpu_torch.runtime.runtime import TorchRuntime

    n = int(np.prod(list(shape.values())))
    return TorchRuntime(devices=[f"cuda:{i}" for i in range(n)] if distinct else [CARD] * n,
                        mesh_shape=shape)


def mesh_launches(shape: dict, conf: dict) -> int:
    """Row 1's launches of one request on a mesh: every layer once per
    (dp, tp) shard, or, through the pipeline, once per microbatch (pp of
    them) of each dp replica."""
    n_layers = conf.get("n_layers", BERT_BASE["n_layers"])
    n = int(np.prod(list(shape.values())))
    pp = shape.get("pp", 1) if shape.get("pp", 1) > 1 else conf.get("pp", 1)
    if pp > 1:
        return n_layers * n
    return n_layers * shape.get("dp", 1) * shape.get("tp", 1)


def place_mesh(rt, conf: dict, flat) -> None:
    """Phase 14's host draw ``flat`` placed over ``rt``'s mesh under the
    op's key, as the op places it (``map_classify_tpu._get_model``)."""
    from agent_tpu_torch.models import encoder, quant
    from agent_tpu_torch.ops import map_classify_tpu as classify_op

    cfg = encoder.EncoderConfig(**conf)
    classify_op._get_model(rt, classify_op.DEFAULT_MODEL_ID, cfg, "encoder",
                           host=lambda: quant.quantize_flat(flat, "encoder", cfg.quant)[0])


def mesh_agreement(got: dict, want: dict, tol: float) -> dict:
    """Two top-k results of one request: the probability of every class
    both list within ``tol``, and a top-1 flip only where the reference
    puts the two classes within ``tol`` (a tie of the compute dtype)."""
    worst, flips, non_ties = 0.0, 0, 0
    for g, w in zip(got["results"], want["results"], strict=True):
        gp = {e["index"]: e["score"] for e in g["topk"]}
        wp = {e["index"]: e["score"] for e in w["topk"]}
        for c in gp.keys() & wp.keys():
            worst = max(worst, abs(gp[c] - wp[c]))
        g1, w1 = g["topk"][0]["index"], w["topk"][0]["index"]
        if g1 != w1:
            flips += 1
            non_ties += not (g1 in wp and wp[w1] - wp[g1] <= tol)
    return {"max_prob_diff": worst, "top1_flips": flips, "non_tie_flips": non_ties,
            "ok": worst <= tol and not non_ties}


def split_block_bytes(block) -> int:
    """Bytes of a block's split leaves: q/k/v/o (the decoder's cross
    attention's too) and the FFN's matrices and wi's bias."""
    names = tuple(f"{a}.{w}" for a in ("attn", "xattn") for w in ("wq", "wk", "wv", "wo")) \
        + ("ffn.wi.w", "ffn.wi.b", "ffn.wo.w")
    return sum(t.numel() * t.element_size() for n, t in block.named_parameters()
               if n in names)


def mesh_serving(fa, classify, texts: list, bert_payload: dict) -> dict:
    """Phase 16, serving: the 256-row request at BERT-base width on each of
    MESH_SERVING's meshes and phase 11's BERT checkpoint on tp = 2, each
    against the same request on one device (the weights of phase 14's
    draws), in turns: rows/s and its ratio, row 1's launches (n_layers × tp
    × dp, or × microbatches on pp), top-1 and the probabilities within
    MESH_PROB_TOL (BERT's two-class head MESH_BERT_PROB_TOL), beside the
    bf16 control's spread (one device with the plain attention); the
    profiled tp = 2 request's only attention kernel the
    TMA + wgmma forward, 2 × n_layers times; each tp shard's split block
    weights half of the one-device bytes."""
    from agent_tpu_torch.models import encoder, quant
    from agent_tpu_torch.ops import map_classify_tpu as classify_op
    from agent_tpu_torch.runtime.context import OpContext
    from agent_tpu_torch.runtime.runtime import TorchRuntime

    one = OpContext(runtime=TorchRuntime(device=CARD))
    dense, moe_flat = SEEDED["dense"], SEEDED["moe"]
    flats = {"none": dense, **{m: quant.quantize_flat(dense, "encoder", m)[0]
                               for m in QUANT_MODES}}
    baselines = {"none": dict(BERT_BASE), **{m: dict(BERT_BASE, quant=m) for m in QUANT_MODES},
                 "moe": dict(BERT_BASE, moe_experts=MOE_EXPERTS)}
    for name, conf in baselines.items():
        place_seeded(one.runtime, {name: conf}, moe_flat if name == "moe" else flats[name])
    runs, want, ctxs = {}, {}, {}
    for name, (shape, extra) in MESH_SERVING.items():
        conf = dict(BERT_BASE, **extra)
        base = "moe" if "moe_experts" in extra else extra.get("quant", "none")
        ctxs[name] = OpContext(runtime=mesh_runtime(shape))
        place_mesh(ctxs[name].runtime, conf, moe_flat if base == "moe" else flats[base])
        runs[name] = (ctxs[name], dict(texts=texts, model_config=conf), base,
                      mesh_launches(shape, conf))
    for base, conf in baselines.items():
        n = BERT_BASE["n_layers"]
        runs[f"one_{base}"] = (one, dict(texts=texts, model_config=conf), None, n)
    ctxs["bert_tp2"] = OpContext(runtime=mesh_runtime({"tp": 2}))
    runs["bert_tp2"] = (ctxs["bert_tp2"], bert_payload, "bert", 2 * BERT_BASE["n_layers"])
    runs["one_bert"] = (one, bert_payload, None, BERT_BASE["n_layers"])
    launches = {name: {} for name in runs}

    def request(name):
        ctx, payload, _, n = runs[name]
        return launch_delta(fa, lambda: classify(dict(payload, topk=5, allow_fallback=False), ctx),
                            {"flash_attention": n}, launches[name])

    rows = {name: len(runs[name][1]["texts"]) for name in runs}
    k_bert = min(5, BERT_BASE_UNCASED["num_labels"])
    timed = interleaved({name: (lambda name=name: request(name)) for name in runs}, MESH_REPS,
                        lambda name, out: check_result(out, rows[name],
                                                       k_bert if "bert" in name else 5))
    plain = OpContext(runtime=shared_runtime(one.runtime, fa.flash_attention_reference))
    control = {base: mesh_agreement(classify(dict(runs[f"one_{base}"][1], topk=5), plain),
                                    timed[f"one_{base}"][1], 1.0)["max_prob_diff"]
               for base in ("none", "bert")}
    report = {"bf16_control_max_prob_diff": control}
    for name, (ctx, payload, base, n) in runs.items():
        p50, out = timed[name]
        entry = {"p50_ms": p50 * 1e3, "rows_per_s": rows[name] / p50, "row1_launches": n,
                 "row1_launches_total": launches[name].get("flash_attention", 0)}
        if base is not None:
            tol = MESH_BERT_PROB_TOL if base == "bert" else MESH_PROB_TOL
            entry["mesh"] = ctx.runtime.mesh.shape
            entry["rows_per_s_vs_one_device"] = timed[f"one_{base}"][0] / p50
            entry["vs_one_device"] = dict(mesh_agreement(out, timed[f"one_{base}"][1], tol),
                                          tolerance=tol)
        report[name] = entry
    bad = {n: e["vs_one_device"] for n, e in report.items()
           if "vs_one_device" in e and not e["vs_one_device"]["ok"]}

    tp2 = ctxs["tp2"]
    profile = profile_call(lambda: classify(dict(runs["tp2"][1], topk=5), tp2))
    check_forwards(profile, {"flash_fwd_sm90": 2 * BERT_BASE["n_layers"]}, "tp = 2 request")
    key = classify_op.params_key(classify_op.DEFAULT_MODEL_ID, "encoder",
                                 encoder.EncoderConfig(**BERT_BASE))
    sharded = tp2.runtime.get_params(key, lambda: resident(tp2.runtime, key), specs={})
    whole = resident(one.runtime, key)
    shard_bytes = [split_block_bytes(sharded.shard(0, j).blocks[0]) for j in range(2)]
    report["tp2_profile"] = profile
    report["tp2_split_block_bytes"] = {"shards": shard_bytes,
                                       "one_device": split_block_bytes(whole.blocks[0])}
    if bad or any(2 * b != report["tp2_split_block_bytes"]["one_device"] for b in shard_bytes):
        raise SystemExit(f"a mesh disagrees with one device, or tp does not halve the "
                         f"block's weights: {bad}, {report['tp2_split_block_bytes']}")
    for ctx in list(ctxs.values()) + [one]:
        ctx.runtime.clear_params()
    return report


def mesh_small_f32(classify) -> dict:
    """Phase 16: a small f32 model through the op on each float serving mesh
    (and w8a16 on tp = 2) of the card against the op on the CPU: top-k
    equal, probabilities within MESH_F32_TOL."""
    from agent_tpu_torch.runtime.context import OpContext
    from agent_tpu_torch.runtime.runtime import TorchRuntime

    texts = random_texts(random.Random(SEED + 31), 12, 5, 60)
    cpu = OpContext(runtime=TorchRuntime(device="cpu"))
    report = {}
    for name, (shape, extra) in MESH_SERVING.items():
        if extra.get("quant") == "int8":  # W8A8's exactness: mesh_row_parallel_int8
            continue
        extra = dict(extra, moe_experts=4) if "moe_experts" in extra else extra
        conf = dict(MESH_F32, **extra)
        got = classify({"texts": texts, "topk": 5, "model_config": conf},
                       OpContext(runtime=mesh_runtime(shape)))
        # pp is a schedule: one CPU device serves the same model without it.
        want = classify({"texts": texts, "topk": 5,
                         "model_config": {k: v for k, v in conf.items() if k != "pp"}}, cpu)
        report[name] = mesh_agreement(got, want, MESH_F32_TOL)
        report[name]["device"] = got["device"]
    bad = {n: r for n, r in report.items()
           if not r["ok"] or r["device"] != torch.device(CARD).type}
    if bad:
        raise SystemExit(f"small f32 models on meshes of the card disagree with the CPU: {bad}")
    return report


def mesh_row_parallel_int8() -> dict:
    """Phase 16, W8A8 under tp: a row-parallel product whose rows' absmax
    lies in shard 1's half equals the one-device product exactly on the
    card (the activation scale spans every shard); with the scale taken
    from each shard's half alone (the planted fault) it must not."""
    from agent_tpu_torch.models import layers, quant
    from agent_tpu_torch.parallel import collectives

    gen = torch.Generator(device="cpu").manual_seed(SEED + 32)
    x = torch.randn(300, BERT_BASE["d_ff"], generator=gen)
    x[:, BERT_BASE["d_ff"] * 3 // 4] = 12.0
    w = torch.randn(BERT_BASE["d_ff"], BERT_BASE["d_model"], generator=gen)
    p = {k: torch.as_tensor(v).to(CARD) for k, v in quant.quantize_dense(
        {"w": w.numpy(), "b": np.linspace(-1, 1, BERT_BASE["d_model"], dtype=np.float32)},
        "int8").items()}
    x = x.to(CARD, torch.bfloat16)
    half = BERT_BASE["d_ff"] // 2
    shards = [dict(p, w_q=p["w_q"][:half]), dict(p, w_q=p["w_q"][half:])]
    xs = [x[:, :half], x[:, half:]]
    want = quant.dense(p, x, torch.bfloat16)
    exact = all(torch.equal(y, want) for y in layers.row_parallel(shards, xs, torch.bfloat16))
    with Planted(collectives, "all_reduce_max", lambda parts: list(parts)):
        fault = all(torch.equal(y, want) for y in layers.row_parallel(shards, xs,
                                                                      torch.bfloat16))
    return {"rows": 300, "exact": exact, "planted_local_scale_exact": fault}


class Planted:
    """Replace ``module.name`` by ``value`` for the ``with`` block."""

    def __init__(self, module, name: str, value) -> None:
        self.module, self.name, self.value = module, name, value

    def __enter__(self):
        self.real = getattr(self.module, self.name)
        setattr(self.module, self.name, self.value)

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def mesh_faults() -> dict:
    """Phase 16, planted faults on a small f32 model with random biases,
    forward on a mesh of the card against one device on the CPU (logits
    within MESH_F32_TOL relative L2): the honest model must pass and each
    fault must fail — a tp sum that drops shard 1's partial, a row-parallel
    bias added on every shard, a pp schedule that skips stage 1, an ep
    dispatch that sends expert 1's slots to shard 0's weights; and the W8A8
    row scale from one shard (mesh_row_parallel_int8)."""
    from agent_tpu_torch.models import encoder, layers, moe
    from agent_tpu_torch.parallel import collectives, pipeline
    from agent_tpu_torch.runtime.mesh import build_mesh

    rng = np.random.default_rng(SEED + 33)
    ids = torch.from_numpy(rng.integers(4, 260, (8, 64)).astype(np.int32))
    mask = torch.from_numpy((np.arange(64)[None] < rng.integers(8, 65, (8, 1))).astype(np.int32))

    def model_flat(conf):
        cfg = encoder.EncoderConfig(**conf)
        flat = encoder.init_params(cfg, "mesh-faults")
        for k in flat:  # biases away from 0, so one added twice shows
            if k.endswith(".b"):
                flat[k] = rng.normal(scale=0.5, size=flat[k].shape).astype(np.float32)
        return cfg, flat

    def rel(shape, conf) -> float:
        cfg, flat = model_flat(conf)
        want = encoder.from_jax_params(flat, cfg)(ids, mask)
        mesh = build_mesh([CARD] * int(np.prod(list(shape.values()))), shape)
        got = encoder.from_jax_params(flat, cfg, mesh=mesh)(ids.to(CARD), mask.to(CARD)).cpu()
        return float((got - want).norm() / want.norm())

    def drop_shard1(parts):
        return collectives.broadcast(parts[0], [p.device for p in parts])

    def bias_per_shard(leaves, xs, dtype):
        return collectives.all_reduce_sum([layers.add_bias(torch.matmul(x, p["w"].to(dtype)),
                                                           p.get("b"), dtype)
                                           for p, x in zip(leaves, xs)])

    real_stage, real_experts = pipeline.run_stage, moe.run_experts
    moe_conf = dict(MESH_F32, moe_experts=4, moe_capacity_factor=8.0)
    cases = {
        "tp_sum_drops_shard1": ({"tp": 2}, MESH_F32, collectives, "all_reduce_sum", drop_shard1),
        "bias_on_every_shard": ({"tp": 2}, MESH_F32, layers, "row_parallel", bias_per_shard),
        "pp_skips_stage1": ({"pp": 2}, MESH_F32, pipeline, "run_stage",
                            lambda s, *a: a[1] if s == 1 else real_stage(s, *a)),
        "ep_expert1_to_shard0": ({"ep": 2}, moe_conf, moe, "run_experts",
                                 lambda experts, x: real_experts([experts[0]] * len(experts),
                                                                 x)),
    }
    report = {}
    for name, (shape, conf, module, attr, fault) in cases.items():
        honest = rel(shape, conf)
        with Planted(module, attr, fault):
            faulty = rel(shape, conf)
        report[name] = {"mesh": shape, "honest_rel_l2": honest, "planted_rel_l2": faulty}
    report["w8a8_row_scale"] = mesh_row_parallel_int8()
    caught = all(r["honest_rel_l2"] <= MESH_F32_TOL < r["planted_rel_l2"]
                 for n, r in report.items() if "honest_rel_l2" in r)
    w8 = report["w8a8_row_scale"]
    if not caught or not w8["exact"] or w8["planted_local_scale_exact"]:
        raise SystemExit(f"a mesh check failed or a planted fault went unnoticed: {report}")
    return report


def mesh_rings(fa, classify, long_payload: dict) -> dict:
    """Phase 16, the ring with dp and tp: phase 5's long-context request on
    MESH_RINGS' meshes against one device, in turns: the fold n_layers ×
    sp² times in each (dp, tp) group, no serving kernel launch, top-1 and
    probabilities within MESH_PROB_TOL."""
    from agent_tpu_torch.runtime.context import OpContext
    from agent_tpu_torch.runtime.runtime import TorchRuntime

    ctxs = {"one": OpContext(runtime=TorchRuntime(device=CARD))}
    want = {"one": {"flash_attention": LONG_LAYERS}}
    for name, shape in MESH_RINGS.items():
        ctxs[name] = OpContext(runtime=mesh_runtime(shape))
        groups = shape.get("dp", 1) * shape.get("tp", 1)
        want[name] = {"flash_fold": LONG_LAYERS * shape["sp"] ** 2 * groups}
    n_rows = len(long_payload["texts"])
    tallies = {name: {} for name in ctxs}
    timed = interleaved({name: (lambda name=name: launch_delta(
        fa, lambda: classify(dict(long_payload), ctxs[name]), want[name], tallies[name]))
        for name in ctxs},
        MESH_REPS, lambda name, out: check_result(out, n_rows, long_payload["topk"]))
    report = {}
    for name in MESH_RINGS:
        report[name] = {"mesh": MESH_RINGS[name], "p50_ms": timed[name][0] * 1e3,
                        "rows_per_s_vs_one_device": timed["one"][0] / timed[name][0],
                        "fold_launches": want[name]["flash_fold"],
                        "fold_launches_total": tallies[name].get("flash_fold", 0),
                        "vs_one_device": mesh_agreement(timed[name][1], timed["one"][1],
                                                        MESH_PROB_TOL)}
    report["one_device_p50_ms"] = timed["one"][0] * 1e3
    for ctx in ctxs.values():
        ctx.runtime.clear_params()
    if not all(r["vs_one_device"]["ok"] for n, r in report.items() if n in MESH_RINGS):
        raise SystemExit(f"the ring with dp or tp disagrees with one device: {report}")
    return report


def mesh_train(fa, train_batch, one_device_step_ms: float, tmp: str) -> dict:
    """Phase 16, training on dp 2 × tp 2: the train step of phase 6's first
    batch (batch 128, L 512) at BERT-base width on phase 14's draw (its
    head cut to phase 6's classes), one warm-up and MESH_TRAIN_STEPS timed,
    rows 4-6 each n_layers × 4 times a step, its p50 beside phase 6's;
    a small f32 step on the mesh of the card against one device on the CPU
    (the loss and every gradient within MESH_F32_TOL relative L2); and
    train_classifier on the mesh (small f32), whose gathered .npz serves on
    one device of the card as on the CPU."""
    from agent_tpu_torch.kernels import flash_attention as fa_mod
    from agent_tpu_torch.models import encoder, train
    from agent_tpu_torch.ops import load_ops
    from agent_tpu_torch.parallel import shardings
    from agent_tpu_torch.runtime.context import OpContext
    from agent_tpu_torch.runtime.runtime import TorchRuntime

    state, take = train_batch
    cfg = state["cfg"]
    flat = dict(SEEDED["dense"])
    flat["head.w"] = np.ascontiguousarray(flat["head.w"][:, :cfg.n_classes])
    flat["head.b"] = np.ascontiguousarray(flat["head.b"][:cfg.n_classes])
    rt = mesh_runtime(MESH_TRAIN)
    specs = shardings.placement_specs(rt.mesh.shape, flat, shardings.encoder_specs(cfg))
    model = encoder.ShardedEncoder(flat, cfg, specs, rt.mesh, trainable=True)
    batch = [rt.put_batch(state[key][take]) for key in ("ids", "mask", "labels")]
    init, step = train.make_train_step(cfg, train.adamw(1e-3), attn_fn=rt.train_attention_fn())
    opt = init(model)
    per_step = {k: BERT_BASE["n_layers"] * MESH_TRAIN["dp"] * MESH_TRAIN["tp"]
                for k in TRAIN_KERNELS}
    launches = {}
    launch_delta(fa, lambda: step(model, opt, *batch), per_step, launches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, losses = [], []
    for _ in range(MESH_TRAIN_STEPS):
        t0 = time.perf_counter()
        _, _, loss = launch_delta(fa, lambda: step(model, opt, *batch), per_step, launches)
        losses.append(float(loss))  # reading the loss waits for the step
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    p50 = statistics.median(walls)
    report = {"mesh": MESH_TRAIN, "batch": len(take), "seq_len": int(state["ids"].shape[1]),
              "steps": MESH_TRAIN_STEPS, "step_p50_ms": p50 * 1e3,
              "step_p50_vs_one_device": p50 * 1e3 / one_device_step_ms,
              "one_device_step_p50_ms": one_device_step_ms, "losses": losses,
              "peak_bytes": peak, "launches_per_step": per_step,
              "launches": {k: launches.get(k, 0) for k in TRAIN_KERNELS}}

    # A small f32 step: the mesh of the card against one device on the CPU.
    small = encoder.EncoderConfig(**dict(MESH_F32, n_classes=4))
    small_flat = encoder.init_params(small, "mesh-train")
    rng = np.random.default_rng(SEED + 34)
    ids = rng.integers(4, 260, (8, 64)).astype(np.int32)
    mask = (np.arange(64)[None] < rng.integers(8, 65, (8, 1))).astype(np.int32)
    labels = rng.integers(0, 4, 8).astype(np.int32)
    sides = {}
    for side, model, where, attn in (
            ("card", encoder.from_jax_params(small_flat, small, trainable=True, mesh=rt.mesh),
             CARD, rt.train_attention_fn()),
            ("cpu", encoder.from_jax_params(small_flat, small, trainable=True), "cpu",
             fa_mod.flash_attention_trainable)):
        with torch.enable_grad():
            loss = train.cross_entropy_loss(model, *(torch.from_numpy(a).to(where)
                                                     for a in (ids, mask, labels)), attn_fn=attn)
            loss.backward()
        if side == "card":
            model.sync_grads()
            grads = mesh_grads(model)
        else:
            grads = {k: p.grad.numpy() for k, p in model.named_parameters()}
        sides[side] = (loss.item(), grads)
    (l_card, g_card), (l_cpu, g_cpu) = sides["card"], sides["cpu"]
    worst = max(float(np.linalg.norm(g_card[k] - g_cpu[k]) / max(np.linalg.norm(g_cpu[k]), 1e-30))
                for k in g_cpu)
    report["small_f32_step"] = {"loss_rel": abs(l_card - l_cpu) / abs(l_cpu),
                                "grads_max_rel_l2": worst, "leaves": len(g_cpu),
                                "tolerance": MESH_F32_TOL}

    # train_classifier on the mesh; its .npz served on one device.
    ops = load_ops(["train_classifier", "map_classify_tpu"])
    texts, labels = keyword_rows(64, SEED + 35)
    out = ops["train_classifier"](
        {"texts": texts, "labels": labels, "model_config": SMALL_TRAIN_F32, "epochs": 2,
         "batch_size": 16, "output_path": f"{tmp}/mesh_small.npz"}, OpContext(runtime=rt))
    served = {where: ops["map_classify_tpu"](
        {"texts": texts[:16], "topk": 2, "model_path": out["output_path"],
         "model_config": out["model_config"]}, OpContext(runtime=TorchRuntime(device=where)))
        for where in (CARD, "cpu")}
    report["op_small_f32"] = {k: out[k] for k in ("n_steps", "first_epoch_loss",
                                                  "last_epoch_loss", "device")}
    report["op_small_f32"]["npz_served_card_vs_cpu"] = mesh_agreement(
        served[CARD], served["cpu"], MESH_F32_TOL)
    small_ok = (report["small_f32_step"]["loss_rel"] <= MESH_F32_TOL and worst <= MESH_F32_TOL
                and out["device"] == served[CARD]["device"] == torch.device(CARD).type
                and report["op_small_f32"]["npz_served_card_vs_cpu"]["ok"])
    if not small_ok or not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"training on the mesh disagrees with one device: {report}")
    return report


def mesh_grads(model) -> dict:
    """A sharded encoder's gradients gathered into the flat layout."""
    from agent_tpu_torch.parallel import shardings

    pieces: dict = {}

    def piece_at(coords):
        key = model._key(0, coords.get("tp", 0), coords.get("ep", 0))
        if key not in pieces:
            pieces[key] = {k: p.grad.cpu().numpy()
                           for k, p in model.modules[key].named_parameters() if not p.is_meta}
        return pieces[key]

    return shardings.gather_flat(piece_at, model.specs, model.shape)


def mesh_risk() -> dict:
    """Phase 16, risk_accumulate on dp = 4: MESH_RISK_VALUES f64 values
    with subnormals (and, in a second request, an overflow past f32) on
    the card's four shards against one device: count, min and max equal,
    the sum within the reference's bound (n · 2⁻²⁴ of Σ|v|) of the exact
    sum, an overflow inf on both."""
    from agent_tpu_torch.ops import load_ops
    from agent_tpu_torch.runtime.context import OpContext
    from agent_tpu_torch.runtime.runtime import TorchRuntime

    risk = load_ops(["risk_accumulate"])["risk_accumulate"]
    rng = np.random.default_rng(SEED + 36)
    values = (rng.standard_normal(MESH_RISK_VALUES) * 1e3).tolist()
    values[7], values[11] = 1.401298464324817e-45, -1.401298464324817e-45
    report = {}
    for name, vals in (("subnormals", values), ("overflow", values[:-1] + [1e39])):
        got = risk({"values": vals}, OpContext(runtime=mesh_runtime({"dp": 4})))
        one = risk({"values": vals}, OpContext(runtime=TorchRuntime(device=CARD)))
        exact = math.fsum(vals)
        bound = len(vals) * 2.0 ** -24 * math.fsum(abs(v) for v in vals)
        report[name] = {"count": got["count"], "device": got["device"],
                        "min_equal": got["min"] == one["min"],
                        "max_equal": got["max"] == one["max"],
                        "sum": got["sum"], "exact_sum": exact, "bound": bound,
                        "sum_ok": (got["sum"] == one["sum"] == math.inf) if name == "overflow"
                        else abs(got["sum"] - exact) <= bound}
    if not all(r["min_equal"] and r["max_equal"] and r["sum_ok"] and r["device"] == "mesh"
               and r["count"] == MESH_RISK_VALUES for r in report.values()):
        raise SystemExit(f"risk_accumulate on dp = 4 disagrees with one device: {report}")
    return report


def mesh_cards_phase(fa, classify, n: int) -> None:
    """``--cards N``: phase 16's serving checks with one shard a card: on tp
    N, pp N, dp 2 × tp N/2 (N even, above 2) the request of 64 texts at
    BERT-base width cut to N layers in bf16 against one card (row 1 per
    shard, probabilities within MESH_PROB_TOL); on those and ep N a small
    f32 model against the op on the CPU (MESH_F32_TOL)."""
    from agent_tpu_torch.models import encoder
    from agent_tpu_torch.runtime.context import OpContext
    from agent_tpu_torch.runtime.runtime import TorchRuntime

    meshes = {f"tp{n}": {"tp": n}, f"pp{n}": {"pp": n}, f"ep{n}": {"ep": n}}
    if n > 2 and n % 2 == 0:
        meshes[f"dp2_tp{n // 2}"] = {"dp": 2, "tp": n // 2}
    conf = dict(BERT_BASE, n_layers=n)
    flat = encoder.init_params(encoder.EncoderConfig(**conf), "mesh-cards")
    texts = random_texts(random.Random(SEED + 37), 64, 200, 500)
    one = OpContext(runtime=TorchRuntime(device=CARD))
    place_seeded(one.runtime, {"bf16": conf}, flat)
    base = classify({"texts": texts, "topk": 5, "model_config": conf}, one)
    cpu = OpContext(runtime=TorchRuntime(device="cpu"))
    report = {}
    for name, shape in meshes.items():
        ctx = OpContext(runtime=mesh_runtime(shape, distinct=True))
        entry = {}
        if "ep" not in shape:
            place_mesh(ctx.runtime, conf, flat)
            out = launch_delta(fa, lambda: classify({"texts": texts, "topk": 5,
                                                     "model_config": conf}, ctx),
                               {"flash_attention": mesh_launches(shape, conf)})
            entry["bf16_vs_one_card"] = mesh_agreement(out, base, MESH_PROB_TOL)
        small = dict(MESH_F32, n_layers=n, **({"moe_experts": 2 * n} if "ep" in shape else {}))
        payload = {"texts": texts[:12], "topk": 5, "model_config": small}
        entry["small_f32_vs_cpu"] = mesh_agreement(classify(dict(payload), ctx),
                                                   classify(dict(payload), cpu), MESH_F32_TOL)
        report[name] = entry
        ctx.runtime.clear_params()
    emit({"phase": "mesh_cards", "cards": n, **report})
    if not all(r["ok"] for entry in report.values() for r in entry.values()):
        raise SystemExit(f"a mesh over {n} cards disagrees: {report}")


def mesh_phase(fa, smi, texts, bert_payload, long_payload, train_batch, train_step_ms) -> dict:
    """Phase 16: dp, tp, pp and ep meshes in one process, their shards on
    the one card (see the module docstring). Returns the launches of rows
    1, 2 and 4-6 by mesh path; the unsharded-kernel counter must read 0."""
    from agent_tpu_torch.ops import load_ops

    classify = load_ops(["map_classify_tpu"])["map_classify_tpu"]
    seconds, report = {}, {"phase": "meshes", "nvidia_smi": smi}
    reset_counts(fa)
    with tempfile.TemporaryDirectory() as tmp:
        for name, fn in (("serving", lambda: mesh_serving(fa, classify, texts, bert_payload)),
                         ("small_f32_vs_cpu", lambda: mesh_small_f32(classify)),
                         ("ring", lambda: mesh_rings(fa, classify, long_payload)),
                         ("train", lambda: mesh_train(fa, train_batch, train_step_ms, tmp)),
                         ("risk_accumulate", mesh_risk),
                         ("planted_faults", mesh_faults)):
            t0 = time.perf_counter()
            report[name] = fn()
            seconds[name] = time.perf_counter() - t0
    report["seconds_by_part"] = seconds
    report["unsharded_selections"] = fa.SELECTION_COUNTS["unsharded"]
    emit(report)
    if fa.SELECTION_COUNTS["unsharded"]:
        raise SystemExit("a mesh path ran the attention kernel unsharded")
    return report


# ---- phase 17: the decoder families on dp and tp meshes ----

# Phase 17's meshes, every shard on the one card; the ring's mesh for the
# seq2seq encoder (row 2 in each tp group).
DEC_MESHES = {"tp2": {"tp": 2}, "dp2_tp2": {"dp": 2, "tp": 2}}
DEC_RING = {"tp": 2, "sp": 2}
# The stream's first requests whose f32 tokens on tp 2 are held to one
# device's engine (the whole stream runs in bf16 for its rate).
DEC_SERVE_F32_REQUESTS = 64
DEC_ROWS = 32  # random texts of phase 8's length for the quant leg
DEC_PREFIX_BUCKET = 512
# --cards N: T5-large's widths cut to 2 + 2 layers (a checkpoint of its own).
DEC_CARDS_T5_LAYERS, DEC_CARDS_ROWS = 2, 16


def with_rel_bias(model, enc, dec):
    """A T5 over the same mesh whose shards hold ``enc``/``dec`` as their
    relative bias tables (each on its shard's device)."""
    shards = {key: dict(t, enc=dict(t["enc"], rel_bias=enc.to(key[0])),
                        dec=dict(t["dec"], rel_bias=dec.to(key[0])))
              for key, t in model.shards.items()}
    return type(model)(model.cfg, model.mesh, shards, model.split)


def next_shard_columns(real):
    """Planted fault: each shard reads the next shard's head columns of
    the relative bias tables (one shard of all heads reads its own)."""
    return lambda table, first, count: real(table, (first + count) % table.shape[-1], count)


def dec_t5(fa, ckpt, requests, tally: dict) -> dict:
    """Phase 17, T5-large: phase 9's checkpoint and staged ids through the
    op's device phase on tp 2 and dp 2 × tp 2 against one device, each
    request once warm: row 3 24 × tp × dp times a request, the greedy
    tokens' share equal to one device's, teacher-forced log-probabilities
    of one device's greedy tokens within LOGP_TOL; with both relative bias
    tables redrawn at T5_FAULT_BIAS_STD the same within it on tp 2, and
    outside it with each shard given the next shard's bias columns."""
    from agent_tpu_torch.models import t5
    from agent_tpu_torch.ops import map_summarize as op
    from agent_tpu_torch.runtime.runtime import TorchRuntime

    cfg = op._get_cfg({"model_path": ckpt}, "t5", ckpt)
    runs = {"one": TorchRuntime(device=CARD),
            **{name: mesh_runtime(shape) for name, shape in DEC_MESHES.items()}}
    models, place_s = {}, {}
    for name, rt in runs.items():
        t0 = time.perf_counter()
        models[name] = op._get_model(rt, ckpt, cfg, "t5")
        torch.cuda.synchronize()
        place_s[name] = time.perf_counter() - t0
    shards = {name: rt.axis_size("dp") * rt.axis_size("tp") for name, rt in runs.items()}
    report = {"place_s": place_s, "requests": {}}
    toks = {}
    def decode(rt, chunks, beams):
        return [(t.cpu(), n) for t, n in op._decode_chunks(rt, chunks, ckpt, cfg, T5_MAX_NEW,
                                                           beams, family="t5")]

    for req, chunks, beams, n_rows in requests:
        entry = {}
        for name, rt in runs.items():
            def run(name=name, rt=rt):
                return launch_delta(fa, lambda: decode(rt, chunks, beams),
                                    {"flash_attention_t5": cfg.n_enc_layers * shards[name]},
                    None if name == "one" else tally.setdefault(f"map_summarize_t5_large_{name}",
                                                                {}))
            if beams == 1:
                run()  # warm
            t0 = time.perf_counter()
            out = run()
            entry[name] = {"ms": (time.perf_counter() - t0) * 1e3,
                           "row3_launches": cfg.n_enc_layers * shards[name]}
            toks[(req, name)] = out[0][0].numpy()[:out[0][1]]
        for name in DEC_MESHES:
            entry[name]["vs_one_device"] = entry["one"]["ms"] / entry[name]["ms"]
            entry[name]["token_share_equal"] = float(np.mean(toks[(req, name)]
                                                             == toks[(req, "one")]))
        report["requests"][req] = entry

    ids_np, lengths_np, n = requests[0][1][0]
    ids = runs["one"].put_batch(ids_np.astype(np.int32))[:n]
    mask = (torch.arange(ids.shape[1], device=ids.device)[None, :]
            < runs["one"].put_batch(lengths_np)[:n, None]).to(torch.int32)
    gen = torch.from_numpy(toks[(requests[0][0], "one")]).to(CARD, torch.int64)
    tgt = torch.cat([torch.full_like(gen[:, :1], cfg.decoder_start_id), gen[:, :-1]], dim=1)

    def logp(model, name):
        return launch_delta(fa, lambda: model.forced_logp(
            ids, mask, tgt, runs[name].t5_attention_kernel()),
            {"flash_attention_t5": cfg.n_enc_layers * shards[name]})

    one = t5.ShardedT5.of(cfg, models["one"], CARD)
    g = torch.Generator(device=CARD).manual_seed(SEED)
    tables = [torch.randn(models["one"][b]["rel_bias"].shape, generator=g, device=CARD)
              * T5_FAULT_BIAS_STD for b in ("enc", "dec")]
    with torch.inference_mode():
        base = logp(one, "one")
        report["logp_vs_one_device"] = {name: (logp(models[name], name) - base).abs().max().item()
                                        for name in DEC_MESHES}
        report["logp_finite"] = bool(torch.isfinite(base).all())
        del base
        strong_base = logp(with_rel_bias(one, *tables), "one")
        strong = with_rel_bias(models["tp2"], *tables)
        report["bias_std_1_tp2_logp"] = (logp(strong, "tp2") - strong_base).abs().max().item()
        with Planted(t5, "bias_columns", next_shard_columns(t5.bias_columns)):
            report["planted_next_shard_columns_logp"] = (
                logp(strong, "tp2") - strong_base).abs().max().item()
        del strong_base
    report["tp2_split_bytes"] = {
        "shards": [resident_bytes(s["dec"]["layers"][0]) for s in models["tp2"].group(0)],
        "one_device": resident_bytes(models["one"]["dec"]["layers"][0])}
    for rt in runs.values():
        rt.clear_params()
    tol = LOGP_TOL["bfloat16"]
    if not (report["logp_finite"] and max(report["logp_vs_one_device"].values()) <= tol
            and report["bias_std_1_tp2_logp"] <= tol
            and report["planted_next_shard_columns_logp"] > tol):
        raise SystemExit(f"T5 on a mesh disagrees with one device (or the planted bias "
                         f"columns went unnoticed): {report}")
    return report


def dec_bart(fa, summarize, ckpt, requests, tally: dict) -> dict:
    """Phase 17, BART-large-cnn: phase 12's checkpoint and 64-row greedy
    request on tp 2 against one device, once warm: row 1 12 × tp times a
    request, the token share equal to one device's, and teacher-forced
    log-probabilities of the first BART_CHECK_ROWS rows' one-device tokens
    within LOGP_TOL."""
    from agent_tpu_torch.models import bart
    from agent_tpu_torch.ops import map_summarize as op
    from agent_tpu_torch.runtime.context import OpContext
    from agent_tpu_torch.runtime.runtime import TorchRuntime

    cfg = op._get_cfg({"model_path": ckpt}, "bart", ckpt)
    greedy = requests[0][1]
    ctxs = {"one": OpContext(runtime=TorchRuntime(device=CARD)),
            "tp2": OpContext(runtime=mesh_runtime({"tp": 2}))}
    report, toks, models = {}, {}, {}
    for name, ctx in ctxs.items():
        t0 = time.perf_counter()
        models[name] = op._get_model(ctx.runtime, ckpt, cfg, "bart")
        torch.cuda.synchronize()
        n = cfg.n_enc_layers * ctx.runtime.axis_size("tp")

        def run(ctx=ctx, n=n, name=name):
            return launch_delta(fa, lambda: summarize_tokens(summarize, greedy, ctx),
                                {"flash_attention": n},
                                None if name == "one" else tally.setdefault(
                                    "map_summarize_bart_tp2", {}))
        place = time.perf_counter() - t0
        run()
        t0 = time.perf_counter()
        out, toks[name] = run()
        report[name] = {"ms": (time.perf_counter() - t0) * 1e3, "place_s": place,
                        "row1_launches": n, "ok": out["ok"], "device": out["device"]}
    report["tp2"]["vs_one_device"] = report["one"]["ms"] / report["tp2"]["ms"]
    report["tp2"]["token_share_equal"] = float(np.mean(toks["tp2"] == toks["one"]))
    (ids_np, lengths_np, _), = op._stage_chunks(greedy["texts"][:BART_CHECK_ROWS], cfg, 1,
                                                "bart", ckpt)
    rt = ctxs["one"].runtime
    ids = rt.put_batch(ids_np.astype(np.int32))
    mask = (torch.arange(ids.shape[1], device=ids.device)[None, :]
            < rt.put_batch(lengths_np)[:, None]).to(torch.int32)
    gen = torch.as_tensor(toks["one"][:BART_CHECK_ROWS], device=ids.device).long()
    tgt = torch.cat([torch.full_like(gen[:, :1], cfg.decoder_start_id), gen[:, :-1]], dim=1)
    with torch.inference_mode():
        base = launch_delta(fa, lambda: bart.ShardedBart.of(cfg, models["one"], CARD).forced_logp(
            ids, mask, tgt, rt.attention_fn()), {"flash_attention": cfg.n_enc_layers})
        got = launch_delta(fa, lambda: models["tp2"].forced_logp(
            ids, mask, tgt, ctxs["tp2"].runtime.attention_fn()),
            {"flash_attention": 2 * cfg.n_enc_layers})
    report["logp_vs_one_device"] = (got - base).abs().max().item()
    report["logp_finite"] = bool(torch.isfinite(got).all())
    del base, got
    for ctx in ctxs.values():
        ctx.runtime.clear_params()
    if not (all(report[n]["ok"] and report[n]["device"] == torch.device(CARD).type
                for n in ctxs)
            and report["logp_finite"] and report["logp_vs_one_device"] <= LOGP_TOL["bfloat16"]):
        raise SystemExit(f"BART on tp 2 disagrees with one device: {report}")
    return report


def dec_seq2seq(fa, summarize, tally: dict) -> dict:
    """Phase 17, the in-house seq2seq at its defaults: phase 8's 256 rows
    greedy and 64 rows with 4 beams on dp 2 × tp 2 (row 1 4 × 4 times a
    request), the greedy request on tp 2 × sp 2 (row 2 4 × sp² per tp
    group), each once warm against one device with the token share; a
    small f32 config on tp 2 of the card equal to the CPU op's summaries;
    each tp shard's split decoder-block bytes; the greedy request on tp 2
    profiled (row 1 alone, 4 × 2 times), beside phase 8's one-device
    profile of it."""
    from agent_tpu_torch.ops import map_summarize as op
    from agent_tpu_torch.runtime.context import OpContext
    from agent_tpu_torch.runtime.runtime import TorchRuntime

    ctxs = {"one": OpContext(runtime=TorchRuntime(device=CARD)),
            "dp2_tp2": OpContext(runtime=mesh_runtime({"dp": 2, "tp": 2})),
            "tp2_sp2": OpContext(runtime=mesh_runtime(DEC_RING))}
    want = {"one": {"flash_attention": S2S_ENC_LAYERS},
            "dp2_tp2": {"flash_attention": S2S_ENC_LAYERS * 4},
            "tp2_sp2": {"flash_fold": S2S_ENC_LAYERS * DEC_RING["sp"] ** 2 * DEC_RING["tp"]}}
    requests = [("texts256_greedy", {"texts": [S2S_TEXT] * S2S_ROWS,
                                     "max_length": S2S_MAX_NEW}),
                ("texts64_beam4", {"texts": [S2S_TEXT] * S2S_BEAM_ROWS,
                                   "max_length": S2S_MAX_NEW, "num_beams": S2S_BEAMS})]
    report = {}
    for req, payload in requests:
        entry, toks = {}, {}
        for name, ctx in ctxs.items():
            if name == "tp2_sp2" and "num_beams" in payload:
                continue

            def run(ctx=ctx, name=name):
                return launch_delta(fa, lambda: summarize_tokens(summarize, payload, ctx),
                                    want[name], None if name == "one" else tally.setdefault(
                                        f"map_summarize_{name}", {}))
            run()
            t0 = time.perf_counter()
            out, toks[name] = run()
            entry[name] = {"ms": (time.perf_counter() - t0) * 1e3, "launches": want[name],
                           "device": out["device"]}
            if name != "one":
                entry[name]["vs_one_device"] = entry["one"]["ms"] / entry[name]["ms"]
                entry[name]["token_share_equal"] = float(np.mean(toks[name] == toks["one"]))
        report[req] = entry
    tp2 = OpContext(runtime=mesh_runtime({"tp": 2}))
    summarize(dict(requests[0][1]), tp2)  # places the weights
    report["tp2_profile_greedy"] = profile_call(lambda: summarize(dict(requests[0][1]), tp2))
    check_forwards(report["tp2_profile_greedy"], {"flash_fwd_sm90": 2 * S2S_ENC_LAYERS},
                   "seq2seq tp 2 request")
    cfg = op._get_cfg({}, "seq2seq", op.DEFAULT_MODEL_ID)
    mesh = op._get_model(ctxs["dp2_tp2"].runtime, op.DEFAULT_MODEL_ID, cfg, "seq2seq")
    whole = op._get_model(ctxs["one"].runtime, op.DEFAULT_MODEL_ID, cfg, "seq2seq")
    report["split_decoder_block_bytes"] = {
        "shards": [split_block_bytes(s.dec[0]) for s in mesh.group(0)],
        "one_device": split_block_bytes(whole.dec[0])}
    small = {"texts": random_texts(random.Random(SEED + 8), 12, 20, 200),
             "model_config": SMALL_S2S_F32, "max_length": 24}
    cpu = OpContext(runtime=TorchRuntime(device="cpu"))
    report["small_f32_tp2_vs_cpu"] = {
        f"beams{b}": summarize(dict(small, num_beams=b), tp2)["summaries"]
        == summarize(dict(small, num_beams=b), cpu)["summaries"] for b in (1, 3)}
    for ctx in (*ctxs.values(), tp2):
        ctx.runtime.clear_params()
    halves = report["split_decoder_block_bytes"]
    if not all(report["small_f32_tp2_vs_cpu"].values()) \
            or any(2 * b != halves["one_device"] for b in halves["shards"]) \
            or any(e["device"] != torch.device(CARD).type
                   for r in requests for e in report[r[0]].values()):
        raise SystemExit(f"the seq2seq on a mesh disagrees with the CPU, or tp does not halve "
                         f"its decoder block: {report}")
    return report


def dec_quant(fa, summarize, tally: dict) -> dict:
    """Phase 17, quantized: the seq2seq at its widths in int8 and w8a16 on
    tp 2 against one device over DEC_ROWS random texts, 32 tokens greedy, in
    f32 and in bf16 compute: each mode's share of tokens equal to its
    one-device run must reach the float control's share in the same dtype
    less AGREEMENT_SLACK. (W8A8 rounds each activation to a code: where the
    mesh's f32 order moves an activation by an ulp across a rounding
    boundary, the code moves by a step, so int8 need not repeat one
    device's tokens even where float does.)"""
    from agent_tpu_torch.runtime.context import OpContext
    from agent_tpu_torch.runtime.runtime import TorchRuntime

    texts = random_texts(random.Random(SEED + 41), DEC_ROWS, 490, 500)
    one = OpContext(runtime=TorchRuntime(device=CARD))
    tp2 = OpContext(runtime=mesh_runtime({"tp": 2}))
    report = {}
    for dtype in ("float32", "bfloat16"):
        for mode in ("none",) + QUANT_MODES:
            payload = {"texts": texts, "max_length": S2S_MAX_NEW,
                       "model_config": {"dtype": dtype, "quant": mode}}
            want = summarize_tokens(summarize, payload, one)[1]
            got = launch_delta(fa, lambda: summarize_tokens(summarize, payload, tp2)[1],
                               {"flash_attention": 2 * S2S_ENC_LAYERS},
                               tally.setdefault(f"map_summarize_{mode}_{dtype}_tp2", {}))
            report[f"{mode}_{dtype}"] = {"token_share_equal": float(np.mean(got == want))}
    one.runtime.clear_params()
    tp2.runtime.clear_params()
    low = {key: r for key, r in report.items() if r["token_share_equal"]
           < report["none_" + key.split("_")[1]]["token_share_equal"] - AGREEMENT_SLACK}
    if low:
        raise SystemExit(f"quantized tokens on tp 2 agree with one device's less than the "
                         f"float control's: {report}")
    return report


def engine_pool_bytes(caches) -> list:
    """Bytes of each tp shard's paged pools (a one-device cache: one)."""
    from agent_tpu_torch.models.decoding import paged_shards

    return [resident_bytes(part["layers"]) for part in paged_shards(caches)]


def dec_serving(fa, tally: dict, stream_tok_s: float) -> dict:
    """Phase 17, serving on tp 2: phase 13's stream prefilled on the mesh
    (row 1 4 × 2 times), then decoded by a paged engine of 8 slots on the
    mesh in bf16 (tok/s beside phase 13's), each shard's pool half the
    one-device pool's bytes; its first DEC_SERVE_F32_REQUESTS requests in
    f32 on tp 2 and one device, the same tokens; serve_summarize on tp 2
    twice with one prompt: the second from the prefix cache, equal."""
    from agent_tpu_torch.config import Config, ServeConfig
    from agent_tpu_torch.models import seq2seq
    from agent_tpu_torch.ops import load_ops
    from agent_tpu_torch.ops import map_summarize as op
    from agent_tpu_torch.ops import serve_infer
    from agent_tpu_torch.runtime.context import OpContext
    from agent_tpu_torch.runtime.runtime import TorchRuntime

    cfg = serve_cfg()
    ids, mask, limits = serving_stream(cfg)
    ids_t, mask_t = torch.from_numpy(ids).to(CARD), torch.from_numpy(mask).to(CARD)
    tp2, one = mesh_runtime({"tp": 2}), TorchRuntime(device=CARD)
    model = op._get_model(tp2, op.DEFAULT_MODEL_ID, cfg, "seq2seq")
    with torch.inference_mode():
        enc_all = launch_delta(fa, lambda: seq2seq.encode(model, ids_t, mask_t, tp2.attention_fn())
                               .float().cpu().numpy(), {"flash_attention": 2 * cfg.n_enc_layers},
                               tally.setdefault("serve_engine_prefill_tp2", {}))
    engine = new_engine(model, SERVE_SLOTS, 1)

    def engine_pass(eng, enc, n):
        tickets = [eng.admit(enc[i], mask[i], limits[i], data=i) for i in range(n)]
        while eng.has_work():
            eng.step()
        return tickets

    engine_pass(engine, enc_all, SERVE_WARM)
    torch.cuda.synchronize()
    gc.collect()
    t0 = time.perf_counter()
    tickets = engine_pass(engine, enc_all, len(limits))
    wall = time.perf_counter() - t0
    tokens = sum(t.steps for t in tickets)
    whole_pool = resident_bytes(seq2seq.make_paged_cache_factory(cfg, block_size=16, device=CARD)(
        SERVE_SLOTS)["layers"])
    report = {"bf16_tp2": {"requests": len(limits), "tokens": tokens, "wall_s": wall,
                           "tok_per_s": tokens / wall,
                           "phase13_one_device_tok_per_s": stream_tok_s,
                           "vs_one_device": tokens / wall / stream_tok_s},
              "pool_bytes": {"shards": engine_pool_bytes(engine._dyn["caches"]),
                             "one_device": whole_pool}}
    del engine

    f32 = seq2seq.Seq2SeqConfig(**dict(SERVE_MODEL, dtype="float32"))
    n = DEC_SERVE_F32_REQUESTS
    toks = {}
    for name, rt, n_launch in (("tp2", tp2, 2), ("one", one, 1)):
        m = op._get_model(rt, op.DEFAULT_MODEL_ID, f32, "seq2seq")
        with torch.inference_mode():
            enc = launch_delta(fa, lambda: seq2seq.encode(m, ids_t[:n], mask_t[:n],
                                                          rt.attention_fn()).cpu().numpy(),
                               {"flash_attention": n_launch * f32.n_enc_layers})
        toks[name] = [t.tokens for t in engine_pass(new_engine(m, SERVE_SLOTS, 1), enc, n)]
    report["f32_first_requests_equal"] = all(np.array_equal(a, b)
                                             for a, b in zip(toks["tp2"], toks["one"]))

    serve_infer.reset_engines()
    ctx = OpContext(runtime=tp2, config=Config(serve=ServeConfig()))
    serve = load_ops(["serve_summarize"])["serve_summarize"]
    payload = with_model({"requests": [{"req_id": "p", "text": S2S_TEXT, "max_length": 8}],
                          "bucket": DEC_PREFIX_BUCKET})
    cold = launch_delta(fa, lambda: serve(dict(payload), ctx),
                        {"flash_attention": 2 * cfg.n_enc_layers},
                        tally.setdefault("serve_summarize_tp2", {}))
    warm = launch_delta(fa, lambda: serve(dict(payload), ctx), {})
    report["prefix_cache"] = {"cold": cold["prefix_cache"], "warm": warm["prefix_cache"],
                              "equal": cold["results"][0]["summary"]
                              == warm["results"][0]["summary"]}
    serve_infer.reset_engines()
    tp2.clear_params()
    one.clear_params()
    pools = report["pool_bytes"]
    if not report["f32_first_requests_equal"] or not report["prefix_cache"]["equal"] \
            or report["prefix_cache"]["warm"]["hits"] != 1 \
            or any(2 * b != pools["one_device"] for b in pools["shards"]):
        raise SystemExit(f"serving on tp 2 disagrees with one device: {report}")
    return report


def dec_mpmd(fa, tally: dict) -> dict:
    """Phase 17, summarize_mpmd: summarize_encode on tp 2 (row 1 4 × 2
    times) then summarize_decode on dp 2 × tp 2 (no kernel), MPMD_ROWS
    random texts at the seq2seq's widths in f32: the one-device split's
    summaries."""
    from agent_tpu_torch.ops import load_ops
    from agent_tpu_torch.runtime.context import OpContext
    from agent_tpu_torch.runtime.runtime import TorchRuntime

    ops = load_ops(["summarize_encode", "summarize_decode"])
    texts = random_texts(random.Random(SEED + 43), MPMD_ROWS, 200, 500)
    conf = {"dtype": "float32"}
    one = OpContext(runtime=TorchRuntime(device=CARD))
    enc_ctx = OpContext(runtime=mesh_runtime({"tp": 2}))
    dec_ctx = OpContext(runtime=mesh_runtime({"dp": 2, "tp": 2}))

    def split(enc, dec, tallied):
        t0 = time.perf_counter()
        encoded = launch_delta(fa, lambda: ops["summarize_encode"](
            {"texts": texts, "model_config": conf}, enc),
            {"flash_attention": S2S_ENC_LAYERS * enc.runtime.axis_size("tp")},
            tally.setdefault("summarize_encode_tp2", {}) if tallied else None)
        out = launch_delta(fa, lambda: ops["summarize_decode"](
            {"encoded": encoded, "model_config": conf, "max_length": S2S_MAX_NEW}, dec), {})
        return out, time.perf_counter() - t0

    want, one_s = split(one, one, False)
    got, mesh_s = split(enc_ctx, dec_ctx, True)
    for ctx in (one, enc_ctx, dec_ctx):
        ctx.runtime.clear_params()
    report = {"rows": len(texts), "one_device_s": one_s, "mesh_s": mesh_s,
              "equal": got["summaries"] == want["summaries"]}
    if not report["equal"]:
        raise SystemExit(f"summarize_mpmd on the meshes differs from one device: {report}")
    return report


def decoder_mesh_phase(fa, smi, t5_ckpt, t5_requests, bart_ckpt, bart_reqs,
                       stream_tok_s) -> dict:
    """Phase 17: the decoder families on dp and tp meshes, every shard on
    the one card (see the module docstring). Returns the launches of rows
    1-3 by path, each counted where its path launched it; the unsharded and
    dense-T5 counters must read 0."""
    from agent_tpu_torch.ops import load_ops

    summarize = load_ops(["map_summarize"])["map_summarize"]
    seconds, tally = {}, {}
    report = {"phase": "decoder_meshes", "nvidia_smi": smi, "logp_tolerance": LOGP_TOL}
    reset_counts(fa)
    try:
        for name, fn in (("t5_large", lambda: dec_t5(fa, t5_ckpt, t5_requests, tally)),
                         ("bart", lambda: dec_bart(fa, summarize, bart_ckpt, bart_reqs, tally)),
                         ("seq2seq", lambda: dec_seq2seq(fa, summarize, tally)),
                         ("quant", lambda: dec_quant(fa, summarize, tally)),
                         ("serving", lambda: dec_serving(fa, tally, stream_tok_s)),
                         ("mpmd", lambda: dec_mpmd(fa, tally))):
            t0 = time.perf_counter()
            report[name] = fn()
            seconds[name] = time.perf_counter() - t0
    finally:  # the legs that ran, also when one fails
        report["seconds_by_part"] = seconds
        report["selection"] = {k: fa.SELECTION_COUNTS[k]
                               for k in ("unsharded", "t5_dense", "dense")}
        report["launches_by_path"] = tally
        emit(report)
    if fa.SELECTION_COUNTS["unsharded"] or fa.SELECTION_COUNTS["t5_dense"]:
        raise SystemExit(f"a decoder mesh path ran a kernel unsharded or T5 dense: "
                         f"{report['selection']}")
    return tally


def decoder_cards_phase(fa, n: int) -> None:
    """``--cards N``: the seq2seq at its defaults on tp N (one shard a card)
    against one card, DEC_CARDS_ROWS rows greedy (the token share), a small f32 config
    on tp N against the CPU op (equal summaries), and T5-large's widths cut
    to DEC_CARDS_T5_LAYERS + DEC_CARDS_T5_LAYERS layers on tp N:
    teacher-forced log-probabilities within LOGP_TOL of one card."""
    from agent_tpu_torch.models import t5
    from agent_tpu_torch.ops import load_ops
    from agent_tpu_torch.ops import map_summarize as op
    from agent_tpu_torch.runtime.context import OpContext
    from agent_tpu_torch.runtime.runtime import TorchRuntime

    summarize = load_ops(["map_summarize"])["map_summarize"]
    shape = {"tp": n}
    cards = OpContext(runtime=mesh_runtime(shape, distinct=True))
    one = OpContext(runtime=TorchRuntime(device=CARD))
    cpu = OpContext(runtime=TorchRuntime(device="cpu"))
    payload = {"texts": random_texts(random.Random(SEED + 45), DEC_CARDS_ROWS, 490, 500),
               "max_length": S2S_MAX_NEW}
    got = launch_delta(fa, lambda: summarize_tokens(summarize, payload, cards)[1],
                       {"flash_attention": S2S_ENC_LAYERS * n})
    report = {"seq2seq_token_share_equal": float(np.mean(
        got == summarize_tokens(summarize, payload, one)[1]))}
    small = {"texts": payload["texts"][:12], "model_config": SMALL_S2S_F32, "max_length": 24}
    report["small_f32_vs_cpu"] = (summarize(dict(small), cards)["summaries"]
                                  == summarize(dict(small), cpu)["summaries"])
    with tempfile.TemporaryDirectory() as tmp:
        hf = dict(T5_LARGE, num_layers=DEC_CARDS_T5_LAYERS,
                  num_decoder_layers=DEC_CARDS_T5_LAYERS)
        write_t5_checkpoint(tmp, hf, SEED + 47, torch.bfloat16, CARD)
        cfg = op._get_cfg({"model_path": tmp}, "t5", tmp)
        rows = t5_rows(DEC_CARDS_ROWS, hf["vocab_size"], T5_LENGTHS, SEED + 48)
        (ids_np, lengths_np, m), = stage_t5(op, tmp, cfg, rows, 1)
        ids = one.runtime.put_batch(ids_np.astype(np.int32))[:m]
        mask = (torch.arange(ids.shape[1], device=ids.device)[None, :]
                < one.runtime.put_batch(lengths_np)[:m, None]).to(torch.int32)
        (toks, k), = op._decode_chunks(one.runtime, [(ids_np, lengths_np, m)], tmp, cfg, 8, 1,
                                       family="t5")
        gen = toks[:k].long()
        tgt = torch.cat([torch.full_like(gen[:, :1], cfg.decoder_start_id), gen[:, :-1]], dim=1)
        with torch.inference_mode():
            want = t5.ShardedT5.of(cfg, op._get_model(one.runtime, tmp, cfg, "t5"), CARD) \
                .forced_logp(ids, mask, tgt, one.runtime.t5_attention_kernel())
            got = launch_delta(fa, lambda: op._get_model(cards.runtime, tmp, cfg, "t5")
                               .forced_logp(ids, mask, tgt, cards.runtime.t5_attention_kernel()),
                               {"flash_attention_t5": DEC_CARDS_T5_LAYERS * n})
        report["t5_logp_vs_one_card"] = (got - want).abs().max().item()
    for ctx in (cards, one, cpu):
        ctx.runtime.clear_params()
    emit({"phase": "decoder_cards", "cards": n, **report})
    if not report["small_f32_vs_cpu"] or report["t5_logp_vs_one_card"] > LOGP_TOL["bfloat16"]:
        raise SystemExit(f"a decoder over {n} cards disagrees: {report}")


# ---- phase 18: several processes on the card ----

PROC_ECHOS = 3
PROC_RISK_VALUES = 1 << 20
PROC_TASKS = "echo,map_tokenize,risk_accumulate,map_classify_tpu"  # a device op: a runtime
PROC_DEADLINE_S = 240  # a process group's start, drain and exit
FLEET_DEADLINE_S = 420  # the fleet's start and warm-up, and its drain
FLEET_TASKS = "map_classify_tpu"
FLEET_PLATFORM = "cuda"  # each member pinned to its card (CUDA_VISIBLE_DEVICES)
CKPT_LAYOUTS = {"tp2": {"tp": 2}, "dp2_tp2": {"dp": 2, "tp": 2}, "one_device": None}
# The planted follower: it drops the first echo it receives, then goes on.
SKIPPING_FOLLOWER = """
import sys
from agent_tpu_torch.agent import app
from agent_tpu_torch.runtime import distributed
real, dropped = distributed.broadcast_task, []

def skipping(task, source=0):
    got = real(task, source)
    if not dropped and isinstance(got, dict) and got.get("op") == "echo":
        dropped.append(got)
        return real(task, source)
    return got

distributed.broadcast_task = skipping
sys.exit(app.main())
"""


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def repo_env(**extra) -> dict:
    """This process's environment with the checkout first on PYTHONPATH."""
    root = os.path.dirname(os.path.abspath(__file__))
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONPATH=root + (os.pathsep + path if path else ""), **extra)


def stop_all(procs: list) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def wait_all(procs: list, deadline: float) -> list:
    """The processes' return codes; fails, after killing them all, when
    one is still alive at ``deadline`` (time.monotonic)."""
    try:
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        stop_all(procs)
        raise SystemExit("a process outlived its deadline")
    return [p.returncode for p in procs]


def follower_tasks(log: str) -> list:
    """The ``tasks_done`` of each ``follower drained`` line of an agent log."""
    return [json.loads(ln.split("follower drained ", 1)[1])["tasks_done"]
            for ln in log.splitlines() if "follower drained " in ln]


def leader_followers(n: int, ctrl, tasks: str, tmp: str, cards: int = 0,
                     follower_code: str = "") -> dict:
    """``n`` processes of ``python -m agent_tpu_torch.agent.app`` joined on a
    free local port (``COORDINATOR_ADDRESS``), process 0 leasing from
    ``ctrl``: all on the first card, or with ``cards`` one a card
    (``CHIP_SLICE``); a follower runs ``follower_code`` when given. Once the
    stand-in has every result the leader gets SIGTERM (a clean exit, whose
    shutdown broadcast ends the followers) -> return codes, each
    follower's tasks_done, the wall seconds and the logs' tails."""
    port, procs, logs = free_port(), [], []
    t0 = time.monotonic()
    deadline = t0 + PROC_DEADLINE_S
    try:
        for i in range(n):
            env = repo_env(COORDINATOR_ADDRESS=f"127.0.0.1:{port}", NUM_PROCESSES=str(n),
                           PROCESS_ID=str(i), TASKS=tasks, CONTROLLER_URL=ctrl.url,
                           AGENT_NAME=f"chip-smoke-procs-{i}", IDLE_SLEEP_SEC="0.01")
            env.pop("CHIP_SLICE", None)
            if cards:
                env["CHIP_SLICE"] = f"{i}:1"
            logs.append(os.path.join(tmp, f"procs-{port}-{i}.log"))
            cmd = [sys.executable, "-c", follower_code] if i and follower_code else \
                [sys.executable, "-m", "agent_tpu_torch.agent.app"]
            with open(logs[-1], "w") as out:
                procs.append(subprocess.Popen(cmd, env=env, stdout=out,
                                              stderr=subprocess.STDOUT))
        while not ctrl.drained():
            if time.monotonic() > deadline or any(p.poll() is not None for p in procs):
                stop_all(procs)
                tails = [open(f).read()[-2000:] for f in logs]
                raise SystemExit(f"the processes did not drain the stand-in: {tails}")
            time.sleep(0.02)
        drained_s = time.monotonic() - t0
        procs[0].send_signal(signal.SIGTERM)
        rcs = wait_all(procs, deadline)
    finally:
        stop_all(procs)
    texts = [open(f).read() for f in logs]
    return {"rcs": rcs, "follower_tasks_done": [follower_tasks(t) for t in texts[1:]],
            "drained_s": drained_s, "exit_s": time.monotonic() - t0 - drained_s,
            "tails": [t[-1500:] for t in texts]}


def procs_ok(run: dict, want_tasks: int) -> bool:
    """Every process exited 0 and every follower ran each of the tasks."""
    return all(rc == 0 for rc in run["rcs"]) and \
        all(done == [want_tasks] for done in run["follower_tasks_done"])


def stage_ms(ctrl, job_id: str) -> float:
    """The leader's ``stage`` span of a job: resolving and broadcasting the
    task before its op ran."""
    (span,) = [s for s in ctrl.trace(job_id) if s["name"] == "stage"]
    return span["duration_ms"]


def procs_phase(n: int, tmp: str, cards: int = 0) -> dict:
    """Phase 18 (a): the leader and its followers (see the module
    docstring), then the planted follower that skips a task."""
    from agent_tpu_torch.parallel.collectives import mesh_reduce_stats
    from agent_tpu_torch.runtime.runtime import TorchRuntime

    rng = np.random.default_rng(SEED + 18)
    values = (rng.standard_normal(PROC_RISK_VALUES) * 1e3).tolist()
    values[:3] = [1.4e-45, -3e-39, 5e-40]
    with StandInController() as ctrl:
        ids = [ctrl.submit("echo", {"i": i}) for i in range(PROC_ECHOS)]
        ids.append(ctrl.submit("map_tokenize", {"text": "several processes, one lease loop"}))
        ids.append(ctrl.submit("risk_accumulate", {"values": values}))
        run = leader_followers(n, ctrl, PROC_TASKS, tmp, cards)
        jobs = ctrl.outcome(ids)
        stage = {f"{ctrl.jobs[j]['op']}_{j}": stage_ms(ctrl, j) for j in ids}
    risk = jobs[-1]["result"]
    one = mesh_reduce_stats(TorchRuntime(
        devices=[f"cuda:{i}" for i in range(n)] if cards else [CARD] * n,
        mesh_shape={"dp": n}), values)
    bound = PROC_RISK_VALUES * 2.0 ** -24 * math.fsum(abs(v) for v in values)
    exact = math.fsum(values)
    risk_ok = (risk.get("device") == "mesh" and risk["count"] == PROC_RISK_VALUES
               and risk["min"] == float(np.float32(min(values)))
               and risk["max"] == float(np.float32(max(values)))
               and abs(risk["sum"] - exact) <= bound
               and all(risk[k] == one[k] for k in ("count", "sum", "min", "max")))
    echoes = [j["result"].get("echo") for j in jobs[:PROC_ECHOS]]
    ok = procs_ok(run, len(ids)) and risk_ok and echoes == [{"i": i} for i in range(PROC_ECHOS)]
    # The planted fault: a follower that drops a task must fail the check.
    with StandInController() as ctrl:
        planted_ids = [ctrl.submit("echo", {"i": i}) for i in range(PROC_ECHOS)]
        planted_ids.append(ctrl.submit("map_tokenize", {"text": "a dropped task"}))
        planted = leader_followers(2, ctrl, "echo,map_tokenize", tmp,
                                   follower_code=SKIPPING_FOLLOWER)
        ctrl.outcome(planted_ids)
    planted_caught = not procs_ok(planted, len(planted_ids))
    report = {"processes": n, "cards": cards or 1, "rcs": run["rcs"],
              "follower_tasks_done": run["follower_tasks_done"], "drained_s": run["drained_s"],
              "exit_s": run["exit_s"], "stage_ms_by_task": stage,
              "stage_ms_p50_small_tasks": statistics.median(list(stage.values())[:-1]),
              "risk": {k: risk[k] for k in ("count", "sum", "min", "max", "device")},
              "risk_vs_one_process_dp": {k: one[k] for k in ("sum", "min", "max")},
              "risk_sum_vs_fsum": {"diff": abs(risk["sum"] - exact), "bound": bound},
              "planted_skip": {"rcs": planted["rcs"],
                               "follower_tasks_done": planted["follower_tasks_done"],
                               "caught": planted_caught}}
    if not ok or not planted_caught:
        raise SystemExit(f"phase 18 (a) failed: {report}, {run['tails']}")
    return report


def fleet_launches(ctrl, name: str) -> float:
    """A member's row-1 launch counter, from its last pushed metrics."""
    got = obs_values(ctrl.agent_obs.get(name), "kernel_launches", kernel="flash_attention")
    return got[0] if got else 0.0


def fleet_phase(n: int, path: str, serial: list, serial_rows_per_s: float,
                drain_rows_per_s: float, tmp: str) -> dict:
    """Phase 18 (b): ``n`` device-pinned members (``spawn_fleet``, one card
    each) warmed on one BERT-base request, drain phase 10's 65,536-row CSV
    after ``wait_for_agents``; the results equal the serial op's, and every
    member's row-1 counter moved over the drain."""
    from agent_tpu_torch.agent import fleet
    from agent_tpu_torch.agent.fleet_cli import http_agents

    _, _, shards, _ = drain_payloads(path)
    warm = os.path.join(tmp, "warm.json")
    with open(warm, "w") as fh:
        json.dump([{"op": "map_classify_tpu", "payload": {
            "texts": random_texts(random.Random(SEED + 18), 8, 20, 200),
            "model_config": BERT_BASE, "topk": 5, "allow_fallback": False}}], fh)
    with StandInController() as ctrl:
        ctrl.agent_cap = 1 if n > 1 else None
        t0 = time.monotonic()
        handle = fleet.spawn_fleet(n, platform=FLEET_PLATFORM, controller_url=ctrl.url,
                                   tasks=FLEET_TASKS, warm_file=warm,
                                   extra_env={"IDLE_SLEEP_SEC": "0.01"},
                                   log_dir=os.path.join(tmp, "fleet"))
        try:
            if not fleet.wait_for_agents(lambda: http_agents(ctrl.url), handle.names,
                                         timeout=FLEET_DEADLINE_S, fleet=handle):
                raise SystemExit(f"the fleet did not come up: {handle.poll_failures()}")
            ready_s = time.monotonic() - t0
            before = {m: fleet_launches(ctrl, m) for m in handle.names}
            t1 = time.monotonic()
            ids = [ctrl.submit("map_classify_tpu", p) for p in shards]
            while not ctrl.drained():
                if time.monotonic() - t1 > FLEET_DEADLINE_S or handle.poll_failures():
                    raise SystemExit(f"the fleet did not drain: {handle.poll_failures()}")
                time.sleep(0.005)
            wall = time.monotonic() - t1
            jobs = ctrl.outcome(ids)
            polls = {m: ctrl.agents[m]["polls"] for m in handle.names}
            while any(ctrl.agents[m]["polls"] < polls[m] + 2 for m in handle.names):
                if time.monotonic() - t1 > FLEET_DEADLINE_S or handle.poll_failures():
                    raise SystemExit("a fleet member stopped polling")
                time.sleep(0.01)  # a metrics push from each member after the drain
            after = {m: fleet_launches(ctrl, m) for m in handle.names}
        finally:
            handle.stop(timeout=60.0)
    rcs = [p.returncode for p in handle.procs]
    by_member = {m: sum(1 for j in jobs if j["agent"] == m) for m in handle.names}
    same = all(j["result"]["indices"] == want["indices"]
               and j["result"]["scores"] == want["scores"] for j, want in zip(jobs, serial))
    report = {"members": n, "names": handle.names, "ready_s": ready_s, "wall_s": wall,
              "rows": DRAIN_ROWS, "rows_per_s": DRAIN_ROWS / wall,
              "phase10_serial_rows_per_s": serial_rows_per_s,
              "phase10_drain_rows_per_s": drain_rows_per_s,
              "shards_by_member": by_member,
              "row1_launches_by_member": {m: after[m] - before[m] for m in handle.names},
              "row1_launches_total": {m: after[m] for m in handle.names},
              "equal_to_serial": same, "rcs": rcs}
    if not same or any(rcs) or any(after[m] <= before[m] for m in handle.names) \
            or any(not j["b1"] for j in jobs):
        raise SystemExit(f"phase 18 (b) failed: {report}")
    return report


def leaves_equal(a, b) -> bool:
    """Every leaf of two sharded models bitwise equal, shard by shard."""
    from agent_tpu_torch.parallel.shardings import positions

    for c in positions(dict(a.mesh.shape)):
        ha, hb = (m.held(c["dp"], c["tp"], c.get("ep", 0)) for m in (a, b))
        if ha.keys() != hb.keys() or not all(torch.equal(ha[k], hb[k]) for k in ha):
            return False
    return True


def checkpoint_phase(fa, classify, texts: list, tmp: str) -> dict:
    """Phase 18 (c): phase 16's BERT-base encoder on tp 2 (phase 14's draw)
    saved with ``save_sharded``, restored over zeroed weights onto tp 2,
    dp 2 x tp 2 and one device, each serving the 256-row request: on tp 2
    every leaf and every probability bitwise the saved model's, elsewhere
    within MESH_PROB_TOL; a restored leaf nudged by one ulp must fail."""
    from agent_tpu_torch.models import checkpoint, encoder
    from agent_tpu_torch.ops import map_classify_tpu as classify_op
    from agent_tpu_torch.runtime.context import OpContext
    from agent_tpu_torch.runtime.runtime import TorchRuntime

    dense, conf = SEEDED["dense"], dict(BERT_BASE)
    cfg = encoder.EncoderConfig(**conf)
    payload = dict(texts=texts, model_config=conf, topk=5, allow_fallback=False)
    zeros = {k: np.zeros_like(v) for k, v in dense.items()}

    def placed(shape, flat):
        rt = mesh_runtime(shape) if shape else TorchRuntime(device=CARD)
        if not shape:
            place_seeded(rt, {"one": conf}, flat)
        return rt, classify_op._get_model(rt, classify_op.DEFAULT_MODEL_ID, cfg, "encoder",
                                          host=lambda: flat)

    def serve(rt, shape, tally):
        n = conf["n_layers"] * (shape or {}).get("dp", 1) * (shape or {}).get("tp", 1)
        out = launch_delta(fa, lambda: classify(dict(payload), OpContext(runtime=rt)),
                           {"flash_attention": n}, tally)
        check_result(out, len(texts), 5)
        return out

    launches: dict = {}
    src_rt, src = placed({"tp": 2}, dense)
    want = serve(src_rt, {"tp": 2}, {})
    path = os.path.join(tmp, "bert_base_tp2")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.save_sharded(src, path)
    save_ms = (time.perf_counter() - t0) * 1e3
    files = {f: os.path.getsize(os.path.join(path, f)) for f in sorted(os.listdir(path))}
    report = {"saved_from": {"tp": 2}, "save_ms": save_ms, "files": files,
              "bytes_written": sum(files.values()), "restored": {}}
    bad = []
    for name, shape in CKPT_LAYOUTS.items():
        rt, like = placed(shape, zeros)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint.load_sharded(path, like)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        launches[name] = {}
        out = serve(rt, shape, launches[name])
        entry = {"load_ms": load_ms, "row1_launches": launches[name].get("flash_attention", 0)}
        if name == "tp2":
            entry["leaves_bitwise"] = leaves_equal(like, src)
            entry["probabilities_bitwise"] = out["results"] == want["results"]
            wq = like.held(0, 1)["blocks.0.attn.wq"]
            keep = wq.view(-1)[0].clone()
            wq.view(-1)[0] = torch.nextafter(keep, torch.tensor(float("inf"), dtype=keep.dtype,
                                                                 device=keep.device))
            entry["planted_one_ulp_caught"] = not leaves_equal(like, src)
            wq.view(-1)[0] = keep
            if not (entry["leaves_bitwise"] and entry["probabilities_bitwise"]
                    and entry["planted_one_ulp_caught"]):
                bad.append(name)
        else:
            entry["vs_saved"] = dict(mesh_agreement(out, want, MESH_PROB_TOL),
                                     tolerance=MESH_PROB_TOL)
            if not entry["vs_saved"]["ok"]:
                bad.append(name)
        report["restored"][name] = entry
        rt.clear_params()
    src_rt.clear_params()
    shutil.rmtree(path, ignore_errors=True)
    report["launches"] = launches
    if bad:
        raise SystemExit(f"phase 18 (c): restores that disagree: {bad}, {report}")
    return report


def cuobjdump_path(build) -> str:
    """cuobjdump beside nvcc, else the copy Triton's package carries."""
    found = shutil.which("cuobjdump")
    if found:
        return found
    beside = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    if os.path.exists(beside):
        return beside
    import triton

    return os.path.join(os.path.dirname(triton.__file__), "backends", "nvidia", "bin",
                        "cuobjdump")


SM90_OPCODES = ("HGMMA", "UTMALDG", "UTMASTG")


def sm90_build_report(build, paths) -> tuple:
    """For each TMA + wgmma instantiation in the libraries ``paths`` (name
    -> .so): the forward's flash_fwd_sm90 and the backward's
    flash_bwd_{dq,dkv}_sm90. Which of SM90_OPCODES its SASS holds
    (cuobjdump -sass), and ptxas' registers, spilled bytes and static shared
    memory from the library's build log. Also the (mangled) names of every
    kernel whose SASS holds HMMA (mma.sync) or that is the old mma.sync
    forward flash_fwd_bf16: none may be left."""
    report, mma_sync = {}, set()
    for lib, so in paths.items():
        sass = subprocess.run([cuobjdump_path(build), "-sass", str(so)], capture_output=True,
                              text=True, check=True, timeout=300).stdout
        current, function = None, None
        for line in sass.splitlines():
            fn = re.search(r"Function : (\S+)", line)
            if fn:
                function = fn.group(1)
                if "flash_fwd_bf16" in function:
                    mma_sync.add(function)
                name = sm90_name(function)
                current = (report.setdefault(name, {op: False for op in SM90_OPCODES})
                           if name else None)
                continue
            if function and re.search(r"\bHMMA\b", line):
                mma_sync.add(function)
            if current is not None:
                for op in SM90_OPCODES:
                    if re.search(rf"\b{op}\b", line):
                        current[op] = True
        entry = None
        for line in (build.BUILD_DIR / f"{lib}.nvcc.log").read_text().splitlines():
            fn = re.search(r"Compiling entry function '(\S+)'", line)
            if fn:
                name = sm90_name(fn.group(1))
                entry = report.get(name) if name else None
            elif entry is not None:
                used = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
                spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
                if used:
                    entry["registers"], entry["static_smem_bytes"] = map(int, used.groups())
                if spill:
                    entry["spill_bytes"] = sum(map(int, spill.groups()))
    return report, sorted(mma_sync)


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cards", type=int, default=0,
                        help="only phases 1, 2, the ring and phase 16's serving checks "
                             "over the first CARDS cards")
    cards = parser.parse_args(argv).cards
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; no CUDA card", file=sys.stderr)
        return 2
    from agent_tpu_torch.kernels import build
    from agent_tpu_torch.kernels import flash_attention as fa
    from agent_tpu_torch.ops import load_ops
    from agent_tpu_torch.runtime.context import OpContext
    from agent_tpu_torch.runtime.runtime import TorchRuntime

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "cuda": True, "name": kind, "capability": list(cap),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda_version": torch.version.cuda})
    if cap != (9, 0):
        raise SystemExit(f"compute capability {cap}, the kernels target sm_90a")
    if "H100" not in kind or "PCIe" in kind or "NVL" in kind:
        raise SystemExit(f"{kind}: the bound below uses the H100 SXM's data-sheet peaks")

    # 2. build
    t0 = time.perf_counter()
    paths = build.build_all(["flash_attention", "flash_attention_bwd"])
    ptxas = {}
    for name in paths:
        log = (build.BUILD_DIR / f"{name}.nvcc.log")
        lines = log.read_text().splitlines() if log.exists() else []
        ptxas[name] = [ln.split("info    : ")[-1] for ln in lines
                       if "registers" in ln or "spill" in ln]
    sm90, mma_sync = sm90_build_report(build, paths)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {n: {"so": p.name, "build_s": build.BUILD_SECONDS.get(n)}
                      for n, p in paths.items()}, "ptxas": ptxas, "sm90_sass": sm90,
          "mma_sync_kernels": mma_sync})
    # Twelve forward instantiations (D 32, 64, 128 of the serving forward,
    # the training forward, the fold and T5's) and six backward ones (dQ and
    # dK/dV at each D), all on wgmma and TMA; no mma.sync anywhere.
    kinds = [n.split("<")[0] for n in sm90]
    if kinds.count("flash_fwd_sm90") != 12 or kinds.count("flash_bwd_dq_sm90") != 3 \
            or kinds.count("flash_bwd_dkv_sm90") != 3 or mma_sync \
            or not all(r["HGMMA"] and r["UTMALDG"] for r in sm90.values()):
        raise SystemExit(f"the TMA + wgmma instantiations lack wgmma or TMA, or mma.sync "
                         f"kernels remain: {sm90}, {mma_sync}")

    # The requests of phases 4 and 5; phase 3 holds the kernel against its
    # plain version at the shapes they stage.
    classify = load_ops(["map_classify_tpu"])["map_classify_tpu"]
    rng = random.Random(SEED)
    k = 5
    base = {"model_config": BERT_BASE, "topk": k, "allow_fallback": False}
    requests = [
        ("text", dict(base, text=random_texts(rng, 1, 60, 60)[0]), 1),
        ("texts64", dict(base, texts=random_texts(rng, 64, 10, 500)), 64),
        ("texts256", dict(base, texts=random_texts(rng, 256, 490, 500)), 256),
        ("input100", dict(base, input=[rng.randrange(260) for _ in range(100)]), 1),
    ]
    small_payload = {"texts": random_texts(rng, 12, 5, 120), "model_config": SMALL_F32,
                     "topk": SMALL_F32["n_classes"], "allow_fallback": False}
    long_payload = {"texts": random_texts(rng, 8, 3000, 4096), "model_config": LONG_CTX,
                    "topk": k, "allow_fallback": False}
    long_requests = [("texts8_L4096", long_payload, 8)]
    if cards:
        if torch.cuda.device_count() < cards:
            raise SystemExit(f"--cards {cards}: {torch.cuda.device_count()} visible")
        ring_cards_phase(fa, classify, cards, long_payload, k)
        mesh_cards_phase(fa, classify, cards)
        decoder_cards_phase(fa, cards)
        with tempfile.TemporaryDirectory() as tmp:  # 18 (a), (b): one process a card
            path = os.path.join(tmp, "drain.csv")
            write_drain_csv(path)
            serial, serial_wall = serial_shards(classify, TorchRuntime(),
                                                drain_payloads(path)[2])
            emit({"phase": "processes", "leader_follower": procs_phase(cards, tmp, cards),
                  "fleet": fleet_phase(cards, path, serial, DRAIN_ROWS / serial_wall, None,
                                       tmp)})
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                     "count": torch.cuda.device_count()}})
        return 0

    # Phase 6's payload; phase 3 holds the training kernels against their
    # plain versions at its first batch's shape and key lengths.
    train_op = load_ops(["train_classifier"])["train_classifier"]
    texts, labels = keyword_rows(TRAIN_ROWS, SEED, 490, 500)
    train_payload = dict(TRAIN, texts=texts, labels=labels, model_config=BERT_BASE)
    train_state, take = first_train_batch(train_payload)
    cfg = train_state["cfg"]
    B, L = len(take), train_state["ids"].shape[1]
    train_case = (f"train/B{B}xL{L}", (B, cfg.n_heads, L, L, cfg.d_model // cfg.n_heads),
                  train_state["mask"][take].sum(axis=1).tolist(), cfg.compute_dtype)

    # Phase 8's requests, and phase 9's ids staged with the op's bucketing
    # into a checkpoint directory whose weights phase 9 writes.
    from agent_tpu_torch.ops import map_summarize as summarize_op

    summarize = load_ops(["map_summarize"])["map_summarize"]
    s2s_cases = [("s2s_texts256", {"texts": [S2S_TEXT] * S2S_ROWS, "max_length": S2S_MAX_NEW},
                  S2S_ROWS),
                 ("s2s_small_f32", {"texts": random_texts(random.Random(SEED + 8), 12, 20, 200),
                                    "model_config": SMALL_S2S_F32}, 12)]
    t5_dir = tempfile.TemporaryDirectory()
    ckpt = os.path.join(t5_dir.name, "t5_large")
    os.makedirs(ckpt)
    with open(os.path.join(ckpt, "config.json"), "w") as fh:
        json.dump(T5_LARGE, fh)
    t5_cfg = summarize_op._get_cfg({"model_path": ckpt}, "t5", ckpt)
    rows = t5_rows(T5_ROWS, T5_LARGE["vocab_size"], T5_LENGTHS, SEED + 11)
    t5_requests = [
        ("t5_large_64_greedy", stage_t5(summarize_op, ckpt, t5_cfg, rows, 1), 1, T5_ROWS),
        ("t5_large_8_beam4", stage_t5(summarize_op, ckpt, t5_cfg, rows[:T5_BEAM_ROWS],
                                      T5_BEAMS), T5_BEAMS, T5_BEAM_ROWS)]
    t5_ids, t5_lengths, _ = t5_requests[0][1][0]
    t5_case = (f"t5_large/B{t5_ids.shape[0]}xL{t5_ids.shape[1]}",
               (t5_ids.shape[0], t5_cfg.n_heads, t5_ids.shape[1], t5_ids.shape[1], t5_cfg.d_kv),
               t5_lengths.tolist(), True, (t5_cfg.rel_buckets, t5_cfg.rel_max_distance),
               t5_cfg.compute_dtype)

    # Phase 10's CSV and shards; phase 3 holds the serving kernel against its
    # plain version at the shapes their first shards stage.
    drain_dir = tempfile.TemporaryDirectory()
    drain_csv = os.path.join(drain_dir.name, "drain.csv")
    write_drain_csv(drain_csv)
    _, _, drain_shards, drain_s2s = drain_payloads(drain_csv)

    # Phases 11 and 12's checkpoint directories: config.json and the vocab
    # now (their requests stage for phase 3), the weights when each runs.
    from agent_tpu_torch.models import bart as bart_model

    hf_dir = tempfile.TemporaryDirectory()
    bert_ckpt, bart_ckpt = (os.path.join(hf_dir.name, n) for n in ("bert", "bart"))
    for path, hf in ((bert_ckpt, BERT_BASE_UNCASED), (bart_ckpt, BART_LARGE_CNN)):
        os.makedirs(path)
        with open(os.path.join(path, "config.json"), "w") as fh:
            json.dump(hf, fh)
    bert_reqs = bert_requests(bert_ckpt, drain_csv, write_wordpiece_vocab(
        bert_ckpt, BERT_BASE_UNCASED["vocab_size"], SEED + 14))
    bart_words = write_bpe_vocab(bart_ckpt, BART_MERGES, SEED + 15)
    bart_reqs = bart_requests(bart_ckpt, bart_texts(bart_model.hf_bpe(bart_ckpt), bart_words,
                                                    BART_ROWS, BART_TOKENS, SEED + 16))

    # 3. kernel vs plain
    kernel_cases = staged_cases(
        classify, requests + long_requests + [("small_f32", small_payload, 12),
                                              ("drain_shard", drain_shards[0], DRAIN_SHARD)]
    ) + staged_cases(summarize, s2s_cases + [("drain_s2s_shard", drain_s2s[0], DRAIN_SHARD)]) \
        + staged_cases(classify, bert_reqs) + staged_cases(summarize, bart_reqs) \
        + serving_cases(load_ops(["serve_summarize"])["serve_summarize"])
    kernel_check = check_kernels(fa, kernel_cases)
    train_check = check_train_kernels(fa, train_case)
    fold_check = check_fold_kernel(fa, ring_fold_case(
        next(c for c in kernel_cases if c[0].startswith("texts8_L4096/"))), [ring_fold_case(
            next(c for c in kernel_cases if c[0].startswith("bert_texts256/")))])
    t5_check = check_t5_kernel(fa, t5_case)

    # 4. main path
    rt = TorchRuntime()
    ctx = OpContext(runtime=rt)
    t_build = time.perf_counter()
    classify(dict(requests[0][1]), ctx)  # builds the BERT-base weights once
    build_weights_s = time.perf_counter() - t_build
    reset_counts(fa)
    report = timed_requests(classify, ctx, fa, requests,
                            {"flash_attention": BERT_BASE["n_layers"]}, k)
    main_launches = fa.LAUNCH_COUNTS["flash_attention"]
    main_selection = dict(fa.SELECTION_COUNTS)
    profile = profile_call(lambda: classify(dict(requests[2][1]), ctx))

    # The 64-row request again, asking for every class, with the plain
    # attention swapped in (a test hook: a runtime with another attention
    # function, sharing the weights), and with the planted tile drop.
    every_class = dict(requests[1][1], topk=1000)
    kernel_out = classify(dict(every_class), ctx)
    plain_out = classify(dict(every_class), OpContext(runtime=shared_runtime(
        rt, fa.flash_attention_reference)))
    fault_out = classify(dict(every_class), OpContext(runtime=shared_runtime(
        rt, lambda q, k_, v, mask: fa.flash_attention_reference(q, k_, v,
                                                                drop_first_tile(mask)))))
    vs_plain = op_agreement(kernel_out, plain_out, LOGP_TOL["bfloat16"])
    fault_vs_plain = op_agreement(fault_out, plain_out, LOGP_TOL["bfloat16"])

    # A small f32 model: the op on the card against the same op on the CPU.
    on_card = classify(dict(small_payload), ctx)
    on_cpu = classify(dict(small_payload), OpContext(runtime=TorchRuntime(device="cpu")))
    vs_cpu = op_agreement(on_card, on_cpu, LOGP_TOL["float32"])
    total_rows = sum(r["rows"] for r in report)
    emit({"phase": "main_path", "config": BERT_BASE, "weights_build_s": build_weights_s,
          "requests": report, "launches": main_launches, "selection": main_selection,
          "profile_256_rows": profile,
          "rows_per_s_all": total_rows / sum(r["p50_ms"] / 1e3 for r in report),
          "logp_tolerance": LOGP_TOL, "vs_plain_attention": vs_plain,
          "planted_tile_drop_vs_plain": fault_vs_plain, "small_f32_vs_cpu": vs_cpu})
    check_forwards(profile, {"flash_fwd_sm90": BERT_BASE["n_layers"]}, "256-row request")
    if not vs_plain["ok"] or fault_vs_plain["ok"] or not vs_cpu["ok"]:
        raise SystemExit("op results disagree (or the planted fault went unnoticed)")
    # Phase 13's serve_classify, while the BERT-base weights are on the card.
    classify_check = serve_classify_check(fa, ctx, random_texts(random.Random(SEED + 19), 8,
                                                                10, 200), k)

    # 5. long context
    rt.clear_params()
    classify(dict(long_payload), ctx)  # weights
    reset_counts(fa)
    long_report = timed_requests(classify, ctx, fa, long_requests,
                                 {"flash_attention": LONG_LAYERS}, k)
    long_launches, long_selection = fa.LAUNCH_COUNTS["flash_attention"], dict(fa.SELECTION_COUNTS)
    long_profile = profile_call(lambda: classify(dict(long_payload), ctx))
    emit({"phase": "long_context", "config": LONG_CTX, "requests": long_report,
          "launches": long_launches, "selection": long_selection,
          "profile_one_request": long_profile})
    check_forwards(long_profile, {"flash_fwd_sm90": LONG_LAYERS}, "long-context request")

    # 5b. ring
    fold_launches = ring_phase(fa, classify, rt, long_payload, long_report, small_payload, k)
    rt.clear_params()

    # 6. train
    with tempfile.TemporaryDirectory() as tmp:
        train_launches, train_step_ms = train_phase(fa, train_op, classify, train_payload,
                                                    (train_state, take), tmp)

    # 8. summarize with the in-house seq2seq
    s2s = summarize_phase(fa, summarize, rt)
    rt.clear_params()

    # 9. T5-large
    t0 = time.perf_counter()
    write_t5_checkpoint(ckpt, T5_LARGE, SEED, torch.bfloat16, CARD)
    emit({"phase": "t5_checkpoint", "seconds": time.perf_counter() - t0,
          "bytes": os.path.getsize(os.path.join(ckpt, "pytorch_model.bin"))})
    t5_run = t5_phase(fa, summarize_op, rt, ckpt, t5_requests)
    rt.clear_params()

    # 10. the agent's drain, then its entry point in a process of its own
    drain = drain_phase(fa, rt, drain_csv)
    rt.clear_params()
    entry_point_phase(drain_csv)

    # 18 (a), (b): several processes on the card — the leader and its
    # follower, then the device-pinned fleet on phase 10's CSV
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs = procs_phase(2, tmp)
        fleet_run = fleet_phase(torch.cuda.device_count(), drain_csv, drain.pop("serial_results"),
                                drain["serial_rows_per_s"], drain["rows_per_s"], tmp)
    emit({"phase": "processes", "leader_follower": procs, "fleet": fleet_run,
          "seconds": time.perf_counter() - t0, "nvidia_smi": smi})

    # 11. a BERT checkpoint through map_classify_tpu
    t0 = time.perf_counter()
    write_hf_checkpoint(bert_ckpt, BERT_BASE_UNCASED,
                        bert_state_dict(BERT_BASE_UNCASED, SEED, torch.float32, CARD))
    emit({"phase": "bert_checkpoint", "seconds": time.perf_counter() - t0,
          "bytes": os.path.getsize(os.path.join(bert_ckpt, "pytorch_model.bin"))})
    bert_run = bert_phase(fa, classify, rt, bert_ckpt, bert_reqs)
    rt.clear_params()
    drain_dir.cleanup()

    # 12. a BART checkpoint through map_summarize
    t0 = time.perf_counter()
    write_hf_checkpoint(bart_ckpt, BART_LARGE_CNN,
                        bart_state_dict(BART_LARGE_CNN, SEED, torch.bfloat16, CARD))
    emit({"phase": "bart_checkpoint", "seconds": time.perf_counter() - t0,
          "bytes": os.path.getsize(os.path.join(bart_ckpt, "pytorch_model.bin"))})
    bart_run = bart_phase(fa, summarize, rt, bart_ckpt, bart_reqs)
    rt.clear_params()

    # 13. continuous-batching serving
    serving = serving_phase(fa, rt, classify_check)
    rt.clear_params()

    # 14. quantized serving and the Switch MoE encoder (phases 9 and 12's
    # checkpoints)
    qm = quant_moe_phase(fa, rt, smi, (train_state, take), ckpt, t5_requests, bart_ckpt,
                         bart_reqs)

    # 16. dp, tp, pp and ep meshes on the one card (phase 14's draws, phase
    # 11's checkpoint)
    meshes = mesh_phase(fa, smi, requests[2][1]["texts"], bert_reqs[0][1], long_payload,
                        (train_state, take), train_step_ms)

    # 18 (c): the sharded checkpoint of phase 16's tp 2 model
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt_run = checkpoint_phase(fa, classify, requests[2][1]["texts"], tmp)
    emit({"phase": "sharded_checkpoint", **ckpt_run, "seconds": time.perf_counter() - t0,
          "nvidia_smi": smi})
    SEEDED.clear()

    # 17. the decoder families on dp and tp meshes on the one card (phases 9
    # and 12's checkpoints, then removed)
    dec = decoder_mesh_phase(fa, smi, ckpt, t5_requests, bart_ckpt, bart_reqs,
                             serving["engine_vs_static"][0]["continuous_tok_per_s"])
    t5_dir.cleanup()
    hf_dir.cleanup()

    # 7. kernels: the serving kernel on the 256-row request's staged shape
    # and key lengths, the training kernels on phase 6's first batch, the T5
    # kernel on phase 9's staged shape.
    q, k_, v, mask, lengths = kernel_check["inputs"]
    B, H, L, D = q.shape
    bool_mask = mask > 0
    serving = kernel_entry(
        "flash_attention", "agent_tpu_torch/kernels/csrc/flash_fwd_sm90.cuh", SM90,
        "agent_tpu/kernels/flash_attention.py:149", main_launches,
        kernel_check["max_abs_err"], kernel_check["max_rel_err"],
        cuda_ms(lambda: fa.flash_attention(q, k_, v, mask)),
        cuda_ms(lambda: fa.flash_attention_reference(q, k_, v, mask), iters=5),
        4 * B * H * L * D * q.element_size() + mask.numel() * mask.element_size(),
        4 * H * L * D * float(np.sum(lengths)),  # products with real keys only
        cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k_, v, attn_mask=bool_mask)), q,
        launches_by_path={"map_classify_tpu": main_launches, "map_summarize": s2s["launches"],
                          "agent_drain_map_classify_tpu": drain["launches"],
                          "agent_telemetry_map_classify_tpu": drain["telemetry"]["launches"],
                          "map_classify_tpu_bert": bert_run["launches"],
                          "map_summarize_bart": bart_run["launches"],
                          "serve_classify": classify_check["launches"],
                          "serve_summarize_stream_prefill": serving["stream_prefill_launches"],
                          "serve_summarize_agent": serving["agent"]["launches"],
                          "serve_prefill_disagg": serving["disagg"]["prefill_launches"],
                          "serve_decode_disagg": serving["disagg"]["decode_launches"],
                          "summarize_encode": serving["mpmd"]["launches"]["encode"],
                          "summarize_decode": serving["mpmd"]["launches"]["decode"],
                          **{f"map_classify_tpu_{'bf16' if m == 'none' else m}":
                             qm["classify"][m]["row1_launches"] for m in ("none",) + QUANT_MODES},
                          "map_classify_tpu_moe_bf16": qm["moe"]["classify_none"]["row1_launches"],
                          "map_classify_tpu_moe_int8": qm["moe"]["classify_int8"]["row1_launches"],
                          "map_summarize_w8a16": qm["summarize_seq2seq"]["launches"]["w8a16"],
                          "map_summarize_bart_w8a16": qm["summarize_bart"]["launches"]["w8a16"],
                          "serve_engine_prefill_bf16_w8a16":
                              qm["engine"]["prefill_launches"],
                          **{f"map_classify_tpu_mesh_{name}": r["row1_launches_total"]
                             for name, r in meshes["serving"].items()
                             if "vs_one_device" in r},
                          **launches_of(dec, "flash_attention"),
                          "map_classify_tpu_fleet_members":
                              sum(fleet_run["row1_launches_by_member"].values()),
                          **{f"map_classify_tpu_ckpt_{name}": r["row1_launches"]
                             for name, r in ckpt_run["restored"].items()}},
        at_bart_encoder_shape=shape_entry(fa, kernel_check, "inputs_bart", bart_run["launches"]),
        at_serving_prefill_shape=shape_entry(fa, kernel_check, "inputs_serving",
                                             serving["stream_prefill_launches"]),
        at_bart_tp2_shard_shape=shard_shape_entry(
            fa, kernel_check["inputs_bart"], dec["map_summarize_bart_tp2"]["flash_attention"]))
    moe_train = qm["moe"]["train"]["launches"]
    emit({"kernels": [serving, *train_kernel_entries(fa, train_check, train_launches, {
                          "train_classifier": train_launches, "moe_train_step": moe_train,
                          "train_step_mesh_dp2_tp2": meshes["train"]["launches"]}),
                      fold_kernel_entry(fa, fold_check, fold_launches, launches_by_path={
                          "map_classify_tpu": fold_launches,
                          "map_classify_tpu_bert_sp2": bert_run["fold_launches"],
                          **{f"map_classify_tpu_ring_{name}":
                             meshes["ring"][name]["fold_launches_total"]
                             for name in MESH_RINGS},
                          **launches_of(dec, "flash_fold")}),
                      t5_kernel_entry(fa, t5_check, t5_run["launches"], launches_by_path={
                          "map_summarize_t5_large": t5_run["launches"],
                          **{f"map_summarize_t5_large_{'bf16' if m == 'none' else m}": n
                             for m, n in qm["summarize_t5_large"]["launches"].items()},
                          **launches_of(dec, "flash_attention_t5")},
                          at_tp2_shard_shape=t5_shard_entry(
                              fa, t5_check, dec["map_summarize_t5_large_tp2"]
                              ["flash_attention_t5"]))]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
