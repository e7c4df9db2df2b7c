#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (agent_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py              # one card
    python3 chip_smoke.py --cards 4    # phases 1, 2, the ring and meshes over 4 cards
                                       # (the encoder's and the decoders'), and
                                       # phase 18 (a), (b) with one process a card
    python3 chip_smoke.py --mix-shard 8192 4096  # phase 24 at each bulk shard size
                                       # (after phase 3's check at its shapes)

Phases, one JSON line each; any failure raises and exits non-zero:

1. device   — CUDA present, an H100 SXM (compute capability (9, 0)),
              nvidia-smi's name and power limit.
2. build    — nvcc builds every kernel of the paths from csrc/ (sm_90a),
              all sources at once (phase 14's MoE host draw on a thread
              beside it); for each of the 12 flash_fwd_sm90
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
              disaggregated mix's buckets), and phase 24's first bulk shard
              (B 4096) and the batches its front doors form of the
              script's requests (serve_classify at BERT-base width,
              serve_summarize and serve_prefill at the seq2seq's); the
              fold's include phase 11's sp = 2 shard.
4. main path — map_classify_tpu through the op registry at BERT-base width
              (d_model 768, 12 heads, 12 layers, d_ff 3072, max_len 512;
              random weights from the model id, drawn once on the host and
              placed as the op's own build, then shared with phase 10):
              one text, 64 mixed-length
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
10. drain   — the port as a swarm worker: the port's controller
              (agent_tpu_torch.controller: ControllerServer around a
              Controller on 127.0.0.1, port 0) shards bench.py's 65,536-row
              CSV (submit_csv_job) into 8 classify shards of 8,192 rows at
              BERT-base width; the port's Agent,
              in this process with its default urllib session and the
              pipelined runner (PIPELINE_DEPTH 2), drains them after one
              warm-up shard of each op. Every result ok on cuda with no
              fallback, each shard leased once and decoded from the b1 wire
              (controller_wire_total), no post refused
              (controller_results_total's stale_epoch, duplicate), n_rows
              summing to 65,536, row 1 launched n_layers times a dispatch
              chunk, and the decoded indices and scores equal to the same
              shards run serially through the op, bit for bit; wall,
              rows/s, both against the serial run, the staging pool's
              workers and the p50 of each phase (per-shard fetch_ms beside
              device_ms). One more shard profiled (the device's idle
              share); one risk_accumulate shard of 65,536 values on the
              card against the host path; a mixed drain of 2 summarize
              shards (the default seq2seq, 32 tokens) and 2 classify
              shards, summaries equal to the op's; a CSV submitted without
              a shard size split by the agent's profile hint (the
              reference's memory formula over nvidia-smi's memory.total:
              16,384 rows on an 80 GB card). Then the entry points, each in
              a process of its own: `python -m
              agent_tpu_torch.controller.server` (CONTROLLER_PORT=0, its
              URL from the "serving on" line) and `python -m
              agent_tpu_torch.agent.app` against it
              (TASKS=echo,read_csv_shard,map_classify_tpu, BERT-base cut to
              2 layers) drain one echo, one read_csv_shard and two 256-row
              shards posted over HTTP; SIGUSR1 must dump the agent's flight
              recorder (with the lease events) into FLIGHT_RECORDER_DIR,
              SIGTERM end the agent and then the controller with exit code
              0, and TASKS=none exit 2. Phases 15 and 19 run between the
              drains and the entry points.
15. telemetry — the agent's spans, usage stamps, gauges, captures, flight
              recorder and failover list against a port controller of its
              own (which mints trace context on every task and collects
              the spans, capture records and obs snapshots), on phase 10's
              8 shards and the BERT-base weights on the card, through the
              pipelined agent (PIPELINE_DEPTH 2). The shards drain with
              TRACE_ENABLED=0 (no agent span may reach the controller),
              then traced with PROFILE_DIR set (PROFILE_TASKS 1) and a deep
              capture of map_classify_tpu requested from the controller
              (request_capture). Every shard's trace (GET /v1/trace/{job})
              assembles with the port's trace.assemble into one complete
              tree, stage, queue, execute and post once each under the
              controller's lease span, and the
              Chrome export of all spans validates; Σ usage.device_s equals
              the device_busy_seconds_total the agent shipped within 1 %,
              chips is 1, Σ usage.flops equals Σ encoder_fwd_flops of the
              staged shapes and every host_s is > 0; device_mfu (printed
              beside the peak used, the card's name and power limit) and
              device_duty_cycle lie in (0, 1]; device_hbm_bytes{device="0"}
              has used, peak and limit, the limit within 1 % of
              mem_get_info's total; the PROFILE_DIR trace and the capture's
              artifact (its completion record reached the controller) each
              hold a flash_fwd_sm90 kernel event (traced printed beside
              launched, not required equal). One shard of tenant "paging",
              whose objective (p99 1 ms) it sends to page (GET /v1/health),
              then one more, whose lease carries the page alert: one
              recorder dump, holding the lease and posted events of the
              traced shards. One shard through an
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
23. drain at scale — right after phase 11, on its checkpoint: `python -m
              agent_tpu_torch.scripts.drain_at_scale --rows 65536` in a
              process of its own, TPU_MODEL_PATH set to phase 11's
              bert-base-uncased directory (classify at BERT-base width, the
              in-house seq2seq summarizing with 32 new tokens): 8 classify
              and 8 summarize shards of 8,192 rows through the port's
              controller, HTTP server, agent and pipeline, per-row JSONL
              sinks. Exit 0; rows_written and each sink's lines equal the
              rows for both ops, no non-ok result; each op's first shard bit
              for bit the op run here on the same rows, checkpoint and
              payload; the drain agent's pushed row-1 launches above 0. Its
              total_rows_per_sec and each op's rows_per_span_sec printed
              beside nvidia-smi's name and power limit.
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
              requested tokens, the speedup, steps, mean occupancy and KV
              blocks at the end, greedy on the stream's first 60 requests
              (with a profiled stretch of 20 engine steps), then on its
              first 60 with 4 beams, and greedy at 64 slots on its first
              128. A small f32
              model (SMALL_S2S_F32): 16 requests joining one every 8 steps
              into 4 slots give each request's solo greedy_generate /
              beam_generate tokens (dense and paged), the CPU engine's tokens,
              and other tokens with the trash-block repoint planted away.
              48 requests of 20-60 bytes through the port's POST /v1/infer
              front door (the default ServeConfig: batches of up to 16)
              and pipelined agent (serve_summarize jobs, one shared engine;
              row 1 4 times a job), each request's tokens equal to its
              batch payload run serially through the op; TTFT p50/p95, its
              components from GET /v1/debug/requests, and the occupancy
              gauge. bench.py's disaggregated mix (its first 16 requests over 4
              documents, every 4th a one-off) through a front door with
              disaggregated=True: the controller chains serve_prefill (b1
              results) -> serve_decode through __collect_partials__, a
              prefill pool then a decode pool of agents, after a warm round:
              prefix hit rate >= 0.5, row 1 4 times a prefill with a miss
              and never in a decode, answers equal to the colocated op on
              the decode jobs' payloads. summarize_encode -> summarize_decode on 64
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
              bf16, top-1 agreement with bf16 over 1,280 rows of bench.py's
              keyword texts, held to the f32 control's agreement less 0.02,
              the resident weight bytes, row 1 n_layers times a request in
              every mode; one int8 request of one 8-byte text ([1, 16]
              staged: _int_mm's 16-row case), its top-1 equal to bf16's. The
              MoE encoder at BERT-base width and depth with 8 experts: the
              256-row request in bf16 and int8 (agreement held as above),
              and the train step at phase 6's batch (128 x L 512), 2 timed
              steps with rows 4-6 each 12 times a step, the aux loss before
              and after; a small f32 MoE on the card against the CPU
              (logits, aux loss, every gradient, 3 steps' losses within
              1e-4), the batch holding a row with no real key and every
              MoE layer's routes alike on card and CPU; a bf16 MoE layer at
              BERT-base width routing 4,096
              seeded tokens on the card and on the CPU from the same
              weights: the share of tokens routed alike (expert, keep or
              drop) at least 0.99, since bf16 gate logits near a tie can
              flip between devices. Phase 8's
              requests in w8a16 against bf16, and greedy token agreement on
              256 rows of random ids with the f32 control; phase 9's T5-large
              greedy request (row 3 24 times a request) and 8 rows of phase
              12's BART greedy request, each in w8a16 against bf16; phase
              13's stream (its first 40 requests) through a paged engine of 8 slots in bf16 and
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
              prefilled on the mesh and its first 16 requests decoded by a
              paged engine of 8 slots in bf16 (tok/s beside phase 13's),
              each shard's pool half the one-device pool's bytes, its first
              32 requests in f32 with one device's tokens; serve_summarize twice with one
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
              cross-process dp 2 mesh from the port's controller; the sum
              within n ·
              2⁻²⁴ Σ|v| of math.fsum and bit-equal to one process's dp 2 mesh,
              min and max the f32 rounding of the exact extremes, the
              follower's tasks_done 5, both exit 0 once the leader has SIGTERM
              (a process alive at the deadline fails); a planted follower that
              drops an echo must fail the check. Each task's stage span (the
              broadcast) is printed. (b) spawn_fleet(device_count(),
              platform="cuda"): each member warmed on one BERT-base request
              (AGENT_WARM_FILE), ready by wait_for_agents over the
              controller's GET /v1/status (several members: MAX_TASKS 1 and
              the serial loop each), drains phase 10's 65,536-row CSV;
              results equal
              to phase 10's serial run bit for bit, each member's row-1 launch
              counter (its pushed kernel_launches gauge) moved; rows/s beside
              phase 10's. Run after phase 10's entry point. (c) After phase
              16: its tp 2 BERT-base encoder (phase 14's draw) saved with
              models/checkpoint.save_sharded, restored over zeroed weights
              onto tp 2, dp 2 × tp 2 and one device, each serving phase 4's
              256-row request: on tp 2 every leaf and probability bitwise the
              saved model's (a leaf nudged one ulp must fail), elsewhere within
              MESH_PROB_TOL; bytes written, save and load ms.
19. control plane — the port's controller with the fair scheduler, the
              workflow engine, the result cache and its observability,
              after phase 10 and on its CSV and BERT-base weights, with a
              new pipelined agent on cuda:0: two workflows, tenant acme's
              (weight 3) of 4 classify stages (phase 10's first four
              8,192-row shards, tier 7) and an echo report after them,
              tenant globex's (weight 1) of 4 risk_accumulate stages of
              16,384 host values and a reduce collecting their partials,
              leased by the fair policy from the real lease bodies'
              capabilities. From the controller's flight recorder: no job
              leased before its dependencies, none past a higher tier, each
              once; no placement deferral (sched_decisions_total) on the
              card's agent ("cuda", where the reference's policy defers);
              the classify results bit for bit phase 10's serial ones; the
              reduce's sum within n · 2⁻²⁴ Σ|v| of math.fsum; row 1 12
              times a shard. Both workflows again under new ids: every
              job from the result cache (GET /v1/workflows/{id}; the reduce
              at lease time, keyed on its collected partials), no lease,
              the same results, row 1 not launched. Each lease poll samples the
              controller's registry and the agent's obs into its ring and
              the durable TSDB (TSDB_DIR); GET /v1/metrics validates and
              parses back; the store, reopened, reads back the ring's
              series; an SLO on the classify jobs reports its burn (GET
              /v1/health), GET /v1/usage both tenants; each workflow's trace
              is complete, each job's submit and lease spans with the
              agent's spans under the lease.
20. front door — the port's ControllerServer with the default
              ServeConfig (max_batch 16, max_wait_ms 25, five length
              buckets) and one pipelined agent on cuda:0 offering
              serve_classify, on phase 4's weights: 8 client threads post
              512 blocking POST /v1/infer classify requests at BERT-base
              width (bf16, top 5) of 20-900 bytes from the seed, so that
              every bucket takes requests. Each answer agrees with
              serve_classify run directly on its batch (phase 4's bf16
              tolerance); the batches by bucket and flush reason (GET
              /v1/debug/requests) match serve_batches_total and GET
              /v1/status; row 1 n_layers times a job the agent ran (its
              tasks_total). 32 requests of one bucket posted at once:
              two "full" batches of 16 (serve_batches_total), each answer
              agreeing with the direct one. A burst of 32 against
              max_pending 8: each
              refusal an HTTP 429 with retry_after_ms, its retries
              answered. Requests/s, p50/p99 latency and the TTFT
              components beside nvidia-smi's name and power limit.
24. serving beside a drain — right after phase 20, on phase 4's weights:
              agent_tpu_torch.scripts.check_serving_pipeline's three legs
              in this process (the port's controller and HTTP server,
              pipelined agents on cuda:0) at full width: classify and the
              bulk drain at BERT-base width (bf16), summarize with phase
              13's seq2seq. A serving-off drain of 196,608 rows of phase
              10's CSV shape in 4,096-row shards; then the same drain
              beside the script's traffic (warm-ups, a seeded 4 s open-loop
              LoadGen of classify and summarize requests, greedy and beam,
              an 8-request volley) through one agent offering
              serve_classify, serve_summarize and the bulk op; then 10
              shared-prefix summarize requests colocated, and split
              (SERVE_DISAGG) over a serve_prefill agent and a serve_decode
              agent that drains 32,768 rows beside them. The script's six
              bars (every request done, TTFT under 30 s, a batch holding
              more than one request, the bulk results bit for bit the
              serving-off drain's, the TTFT objective saw every request,
              the split's summaries bit for bit the colocated ones with
              both halves run and prefix hits). Every job on cuda with no
              fallback; row 1 n_layers times a bulk shard's dispatch chunk
              and a serve_classify batch, n_enc times a prefill with a
              miss, never in a decode, in each leg and in all; no result
              post refused; the last answer before the last bulk result
              (the load starts after the first bulk lease). TTFT
              p50/p99, requests/s, the drain's rows/s with and without
              serving, the overlap.
21. partitioned plane — on phase 10's CSV and weights (its agent process,
              started after phase 10, builds its weights while phases 19
              and 10's entry points run):
              two partition controllers (`python -m
              agent_tpu_torch.controller.server`, CONTROLLER_PARTITION p0
              and p1, each its own segmented journal), p0's hot standby
              (`python -m agent_tpu_torch.controller.standby`) and the
              router (`python -m agent_tpu_torch.controller.router`,
              PARTITION_URLS "p0=<p0>|<standby>,p1=<p1>"), each a process
              of its own. Phase 10's CSV under two source names that the
              router's hash homes one on each partition, submitted through
              the router; one pipelined agent process on cuda:0 with
              CONTROLLER_PARTITION_MAP drains the 16 shards. Once p0 has
              accepted 2 results its primary is SIGKILLed; the standby
              promotes (SIGUSR1, or its missed polls) and serves at p0's
              alternate URL, where the agent's session rotates. Every shard
              applied and billed once (GET /v1/usage through the router),
              no result refused as unknown, results bit for bit phase 10's
              serial run, at least one lease stolen from the agent's other
              partition (its shim's counters), row 1 n_layers times each
              dispatch chunk a shard run (runs again after the kill
              counted), and the router's merged status, health and metrics
              naming both partitions. Rows/s, the failover gap (the kill to
              the promoted standby's first lease), the standby's lag at
              promotion and its torn-tail seal, the steals and each
              process's start seconds.
22. elastic fleet and chaos — on phase 21's router and partitions (p0
              now its promoted standby). (a) The autoscaler (min 1, max 2,
              interval 0.5 s, 2 idle evaluations, 2 s cooldowns) over a
              ProcessFleetDriver of `python -m agent_tpu_torch.agent.fleet`
              members on the router (map_classify_tpu and serve_classify
              at BERT-base width, warmed, all on card 0), reading the
              router's merged GET /v1/health, while two seeded open-loop
              LoadGens run 15 s: /v1/infer classify requests of 20-900
              bytes at 30 a second with a 3x burst for 4 s (tenant homed on
              p1, whose front door takes 32 pending), and 256-row classify
              jobs at 2 a second. Every admitted arrival completes and
              agrees with the op run here (phase 4's bf16 tolerance); the
              429 drops per partition equal the partitions' refused
              counters; at least one scale-up, then a scale-down by
              SIGTERM's drain, every member exiting 0, no replacement, each
              member's row-1 launches moved. (b) A port agent in this
              process with a ChaosSession (seeded FaultPlan: dropped
              requests and responses, fabricated 500s, duplicate
              deliveries) on its result posts over the partition map's
              shim drains phase 10's first 4 shards under new ids: the
              plan's counts equal chaos_faults_injected_total, each shard
              applied once, every redelivery refused as a duplicate, the
              results bit for bit phase 10's serial ones.
7. kernels  — per kernel: launches on its path, error against plain,
              kernel / plain / library times and the card's bound, and its
              design (all TMA + wgmma); each kernel timed through
              its launcher (rows 1 and 3 also through their entry points,
              which add the keyless-row rule: entry_ms with the ops' host
              lengths hint, entry_flag_ms without it), its inputs built
              outside the timing (the fold
              at phase 5b's shard shape: launches over its timed requests;
              the T5 kernel at phase 9's staged shape with its per-distance
              table built once, launches over its requests, the entry
              point's time beside it). Printed after phases 8-24, after a
              line of each phase's seconds; row 1's launches by path include
              phases 10-17 and 19-24, and its entry holds
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

import collections
import copy
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

import numpy as np
import torch

SEED = 1234
BERT_BASE = {"d_model": 768, "n_heads": 12, "n_layers": 12, "d_ff": 3072, "max_len": 512}
LONG_CTX = {"d_model": 512, "n_heads": 4, "max_len": 4096}
SMALL_F32 = {"d_model": 128, "n_heads": 2, "n_layers": 2, "d_ff": 256, "max_len": 128,
             "n_classes": 50, "dtype": "float32"}
# Timed repetitions of each main-path request, after one warm-up.
REPS = 2
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
# beams, micro_steps 1; greedy again at 64 slots. Then the agent's 80
# requests (groups of 8-32) through the front door, and the disaggregated
# mix (DISAGG_REQUESTS over DISAGG_DOCS).
SERVE_REQUESTS, SERVE_SRC, SERVE_SLOTS, SERVE_WIDE_SLOTS, SERVE_BEAMS = 240, 64, 8, 64, 4
SERVE_SHORT_FRAC, SERVE_SEED = 0.9, 5
SERVE_WARM = 8  # requests of each side's warm-up pass
SERVE_PROFILE_STEPS = 20
# The beam leg and the greedy 8-slot leg decode these shares of the stream.
# The 64-slot leg decodes twice its slots, so that its engine refills slots
# as a static batch cannot.
SERVE_BEAM_LEG_FRAC = 1 / 4
SERVE_GREEDY_LEG_FRAC = 1 / 4
SERVE_WIDE_LEG_PER_SLOT = 2
SERVE_EXACT_REQUESTS = 16  # 32 until the cut that paid for phase 23
SERVE_EXACT_EVERY = 8  # steps between arrivals: slots sit empty, blocks are reused
SERVE_AGENT_JOBS = (8, 16, 24)
DISAGG_REQUESTS, DISAGG_DOCS = 16, 4
MPMD_ROWS = 64
SERVE_MODEL: dict = {}  # Seq2SeqConfig overrides of phase 13 (none: the defaults)
# Phase 24: the bulk drain beside the serving load, in rows of phase 10's CSV
# shape. The agent interleaves one decode step with each bulk shard it runs,
# so a request's latency grows with the shard, and half of DRAIN_SHARD leaves
# the overlap gate a margin that DRAIN_SHARD does not (PERF.md section 6;
# ``--mix-shard`` runs the phase at other sizes). The split leg's bulk drains
# the first MIX_DISAGG_ROWS.
MIX_ROWS, MIX_SHARD = 196_608, 4096
MIX_DISAGG_ROWS = 32_768

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
AGREEMENT_ROWS, AGREEMENT_CHUNK = 1280, 512
AGREEMENT_WORDS = ["alpha", "risk", "ledger", "breach", "routine", "audit", "wire", "flag",
                   "normal", "urgent", "invoice", "metric"]
W8A8_SMALL_TEXT = "tiny row"  # one row of 8 bytes: a staged [1, 16] -> 16 rows of _int_mm
MOE_EXPERTS, MOE_TRAIN_STEPS = 8, 2  # 3 steps until the cut that paid for phase 23
# A quantized mode's top-1 agreement with bf16 may fall this far below the
# f32 control's (the same weights and rows in f32 against bf16).
AGREEMENT_SLACK = 0.02
# The MoE's card-vs-CPU check at f32: phase 6's small training config with
# 4 experts, 16 rows of L 64 (two routing groups of 512 tokens).
MOE_F32 = dict(SMALL_TRAIN_F32, moe_experts=4)
MOE_F32_ROWS, MOE_F32_STEPS, MOE_F32_REL_TOL = 16, 3, 1e-4
# The bf16 MoE's routes, card against CPU: one layer at BERT-base width
# with MOE_EXPERTS experts, MOE_ROUTE_TOKENS seeded bf16 tokens (8 routing
# groups of 512). The router's logits are f32 on both, but the card and the
# CPU sum the products in different orders, so a token whose top two logits
# nearly tie can take another expert, and that moves the capacity queue of
# the tokens after it in its group: the share routed alike (the same expert
# and the same keep or drop) must reach MOE_ROUTE_AGREEMENT, not 1.
MOE_ROUTE_TOKENS, MOE_ROUTE_AGREEMENT = 4096, 0.99
DECODE_AGREEMENT_ROWS, DECODE_AGREEMENT_SRC = 256, 64
# Timed repetitions of each phase-14 request, after one warm-up (3, then 2,
# before the cut that paid for phase 23).
QUANT_REPS = 1
QUANT_ENGINE_REQUESTS = 40  # of phase 13's 240, timed through the bf16 and w8a16 engines
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
    # A keyless row at the reference's 2048-key gate: 0 there, not the mean.
    ("dead_row_L2048", (2, 2, 64, 2048, 64), [2048, 0]),
]


def keyless_check(fa, entry, got, q, k, v, mask, lengths, dtype) -> tuple:
    """The entry point (``entry()``) against its launcher's ``got``: without
    a hint it is ``got`` with ``fa.keyless_rows_dense`` on top; with the
    ops' host hint (``fa.keyless_rows(lengths)``) its rows with keys are
    ``got`` bit for bit. Its keyless rows, both ways, below the 2048-key
    gate against the port's dense attention on the same inputs
    (``layers.dot_product_attention``: every score NEG_INF, a uniform
    softmax, P·V in the input dtype) at the case's tolerance, from the gate
    on 0 -> (ok, max |Δ| of the keyless rows against the dense path)."""
    from agent_tpu_torch.models.layers import dot_product_attention

    plain = entry()
    with fa.keyless_rows(lengths):
        hinted = entry()
    ok = torch.equal(plain, fa.keyless_rows_dense(got, v, mask))
    dead = torch.as_tensor(np.asarray(lengths) == 0, device=got.device)
    dead = dead.expand(q.shape[0]) if dead.numel() == 1 else dead
    ok = ok and torch.equal(hinted[~dead], got[~dead])
    if not bool(dead.any()):
        return ok and torch.equal(hinted, plain), 0.0
    if k.shape[2] >= fa.FLASH_MIN_KEY_LEN:
        return ok and bool((plain[dead] == 0).all() and (hinted[dead] == 0).all()), 0.0
    dense = dot_product_attention(q[dead], k[dead], v[dead], mask.expand(
        q.shape[0], *mask.shape[1:])[dead])
    err = 0.0
    for out in (plain, hinted):
        same, e, _ = compare(out[dead], dense, dtype)
        ok, err = ok and same, max(err, e)
    return ok, err


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
    """Phase 3: the CUDA kernel (its launcher) against its plain version on
    the card, a row with no real key 0 in both; and the wrapper, with and
    without the ops' host hint, against the kernel and its keyless rows
    against the dense path (``keyless_check``)."""
    cases = [(n, s, ln, dt) for n, s, ln in EDGE_CASES
             for dt in (torch.bfloat16, torch.float32)] + main_cases
    results, inputs = [], {}
    for i, (name, (B, H, Lq, Lk, D), lengths, dtype) in enumerate(cases):
        q, k, v, mask = attn_inputs(B, H, Lq, Lk, D, dtype, lengths, seed=i)
        got = fa._launch(q, k, v, mask)
        want = fa.flash_attention_reference(q, k, v, mask)
        ok, err, rel = compare(got, want, dtype)
        if len(lengths) == B:
            dead = torch.as_tensor(np.asarray(lengths) == 0, device=got.device)
            ok = ok and bool((got[dead] == 0).all())
        rule_ok, keyless_err = keyless_check(
            fa, lambda: fa.flash_attention(q, k, v, mask), got, q, k, v, mask, lengths, dtype)
        ok = ok and rule_ok
        faults = {
            "drop_first_tile": fa.flash_attention_reference(q, k, v, drop_first_tile(mask)),
            "scale_x1.1": fa.flash_attention_reference(q * 1.1, k, v, mask),
        }
        fault_rel = {f: compare(out, want, dtype)[2] for f, out in faults.items()}
        caught = all(not compare(out, want, dtype)[0] for out in faults.values())
        results.append({"case": name, "dtype": str(dtype).split(".")[-1],
                        "shape": [B, H, Lq, Lk, D], "max_abs_err": err, "max_rel_err": rel,
                        "keyless_vs_dense_err": keyless_err,
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


def entry_times(fa, lengths, entry) -> dict:
    """The entry point's times beside its launcher's: ``entry_ms`` as the
    ops call it, inside ``fa.keyless_rows`` with the batch's host lengths
    (entered once, as an op enters it once for all of a forward's layers;
    a batch without a keyless row pays no rule), and ``entry_flag_ms``
    without that hint, the rule's flag made from the mask on the card."""
    with fa.keyless_rows(lengths):
        hinted = cuda_ms(entry)
    return {"entry_ms": hinted, "entry_flag_ms": cuda_ms(entry)}


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
    """Phase 3, the T5 kernel: its launcher on the card against the plain
    version on the same per-distance table (the entry equal to it with the
    keyless-row rule on top), with learned tables of standard
    deviation 1 (so the bias matters beside the scores); the relative
    position reversed (k - q read as q - k) and the table of head h + 1 must
    fail the same check."""
    results, inputs = [], None
    for i, (name, (B, H, Lq, Lk, D), lengths, bidir, (nb, maxd), dtype) in enumerate(
            T5_EDGE_CASES + [main_case]):
        q, k, v, mask = attn_inputs(B, H, Lq, Lk, D, dtype, lengths, seed=400 + i)
        rel_bias = torch.randn(nb, H, generator=torch.Generator().manual_seed(i)).to(CARD)
        table = fa.distance_bias_table(rel_bias, bidirectional=bidir, max_distance=maxd)
        got = fa._launch_t5(q.contiguous(), k.contiguous(), v.contiguous(), mask, table, maxd,
                            1.0)
        want = fa.flash_attention_t5_reference(q, k, v, mask, table, max_distance=maxd)
        ok, err, rel = compare(got, want, dtype)
        if len(lengths) == B and 0 in lengths:
            dead = torch.as_tensor(np.asarray(lengths) == 0, device=got.device)
            ok = ok and bool((got[dead] == 0).all())
        rule_ok, keyless_err = keyless_check(
            fa, lambda: fa.flash_attention_t5(q, k, v, mask, rel_bias, bidirectional=bidir,
                                              max_distance=maxd),
            got, q, k, v, mask, lengths, dtype)
        ok = ok and rule_ok
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
                        "max_rel_err": rel, "keyless_vs_dense_err": keyless_err,
                        "fault_rel_err": fault_rel, "ok": ok,
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
    built once outside the timing (``entry_times``: the entry point, which
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
        **entry_times(fa, lengths, lambda: fa.flash_attention_t5(q, k, v, mask, rel_bias,
                                                                 max_distance=maxd)),
        **extra)
    del float_mask
    return entry


# Phase 19: the control plane. A workflow over phase 10's CSV and weights.
CONTROL_SHARDS = 4  # classify stages: phase 10's first four 8,192-row shards
CONTROL_RISK_VALUES = 16_384  # host values of each of the four risk stages
CONTROL_TENANTS = {"acme": 3.0, "globex": 1.0}  # SCHED_TENANT_WEIGHTS
CONTROL_CLASSIFY_PRIORITY = 7  # the classify stages' tier; the rest take the default 5
# One latency objective on the classify jobs (submit -> apply).
CONTROL_SLO = [{"name": "classify_latency", "op": "map_classify_tpu", "p99_ms": 30_000,
                "availability": 0.99}]
CONTROL_RING_INTERVAL_S = 0.05  # the ring's sampling interval (TSDB_INTERVAL)


LEASE_TTL_S = 600.0  # a lease outlives any task of the run (weights build inside one)


class PortController:
    """The port's controller for a phase: ``ControllerServer`` around a
    port ``Controller`` on 127.0.0.1, port 0 (``kwargs`` go to the
    Controller), or with ``env`` ``python -m
    agent_tpu_torch.controller.server`` in a process of its own, configured
    by those environment knobs (``c`` is then None). Leases are held up to
    LEASE_TTL_S; the result cache is off unless ``cache``, since the phases
    resubmit shards whose kernel launches they count. What the phases read
    of it comes from the controller's own surfaces: job states and results
    (``job_snapshot``, ``GET /v1/jobs/{id}``), result posts by outcome
    (``controller_results_total``: a post of a job twice is ``duplicate``,
    one fenced by its epoch or lease ``stale_epoch``), the binary wire
    (``controller_wire_total``), traces (``trace_json``), ``GET
    /v1/status`` and the agents' pushed metrics."""

    FENCED = ("stale_epoch", "duplicate", "unknown_job")

    def __init__(self, cache: bool = False, env=None, **kwargs) -> None:
        from agent_tpu_torch.config import FlowConfig
        from agent_tpu_torch.controller import Controller, ControllerServer

        self.env, self.c, self.server, self.proc = env, None, None, None
        if env is None:
            kwargs.setdefault("lease_ttl_sec", LEASE_TTL_S)
            kwargs.setdefault("flow", FlowConfig(cache_enabled=cache))
            self.c = Controller(**kwargs)
            self.server = ControllerServer(self.c)
        else:
            self.env = dict(env, LEASE_TTL_SEC=str(LEASE_TTL_S),
                            CACHE_ENABLED="1" if cache else "0")

    @property
    def url(self) -> str:
        return self.server.url if self.server is not None else self._url

    def __enter__(self):
        if self.server is not None:
            self.server.start()
            return self
        root = os.path.dirname(os.path.abspath(__file__))
        self._log = tempfile.TemporaryFile("w+")
        self.proc, self._url = start_controller(dict(os.environ, PYTHONPATH=root, **self.env),
                                                self._log)
        return self

    def __exit__(self, *exc):
        if self.server is not None:
            self.server.stop()
            self.c.close()
            return
        self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=60)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
            self._log.close()
        if rc != 0 and exc[0] is None:
            raise SystemExit(f"the controller process exited {rc}")

    def get(self, route: str):
        status, body = http_json(self.url + route)
        if status != 200:
            raise SystemExit(f"GET {route}: {status} {str(body)[:300]}")
        return body

    def submit(self, op: str, payload: dict, **kwargs) -> str:
        return self.c.submit(op, payload, **kwargs)

    def submit_csv(self, path: str, op: str, rows: int, shard, extra: dict) -> list:
        """``submit_csv_job``: rows [0, rows) of the CSV in ``op`` shards of
        ``shard`` rows (None: the size the agents' profiles suggest)."""
        return self.c.submit_csv_job(path, rows, shard_size=shard, map_op=op,
                                     extra_payload=extra)[0]

    def drained(self) -> bool:
        return self.c.drained() if self.c is not None else self.get("/v1/status")["drained"]

    def series(self, name: str, **labels) -> float:
        """The sum of ``GET /v1/metrics``' ``name`` samples whose labels
        include ``labels``."""
        from agent_tpu_torch.obs.metrics import parse_exposition

        text = self.c.metrics_text() if self.c is not None else self.get("/v1/metrics")
        return sum(v for lab, v in parse_exposition(text).get(name, [])
                   if all(lab.get(k) == str(x) for k, x in labels.items()))

    def fenced(self) -> dict:
        """Result posts the controller refused, by outcome."""
        return {o: self.series("controller_results_total", outcome=o) for o in self.FENCED}

    def b1_results(self) -> float:
        """Results that came over the b1 wire and were decoded."""
        return self.series("controller_wire_total", direction="result", format="b1")

    def outcome(self, job_ids: list) -> list:
        """The job snapshots of ``job_ids``; fails unless each succeeded, was
        leased once, and no result post was refused."""
        out = [self.c.job_snapshot(j) if self.c is not None else self.get(f"/v1/jobs/{j}")
               for j in job_ids]
        bad = [s for s in out if s["state"] != "succeeded" or s["attempts"] != 1]
        fenced = self.fenced()
        if bad or any(fenced.values()):
            raise SystemExit(f"jobs {[(s['job_id'], s['op'], s['state'], s['attempts'], s['error']) for s in bad][:4]}, "
                             f"refused posts {fenced}")
        return out

    def trace(self, trace_id: str) -> list:
        return (self.c.trace_json(trace_id) or {}).get("spans", [])

    def agent_obs(self, name: str):
        """The last obs snapshot ``name`` pushed with a lease."""
        return (self.c.agent_metrics.get(name) or {}).get("obs")


def pipelined_drain(agent, ctrl, profile: bool = False, until=None):
    """Run the agent's pipelined runner on this (the device) thread until the
    controller has every result (or ``until()`` holds) -> (wall seconds to
    that moment, the profile of the run when asked)."""
    from agent_tpu_torch.agent.pipeline import PipelineRunner

    until = until or ctrl.drained
    done = {}

    def run():
        agent.running = True
        t0 = time.perf_counter()

        def watch():
            while not until() and time.perf_counter() - t0 < DRAIN_TIMEOUT_S:
                time.sleep(0.002)
            done["wall"] = time.perf_counter() - t0
            agent.running = False

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        PipelineRunner(agent, depth=agent.config.agent.pipeline_depth).run()
        watcher.join(timeout=30)

    prof = profile_call(run) if profile else run()
    if not until():
        status = ctrl.get("/v1/status")
        raise SystemExit(f"the drain did not finish in {DRAIN_TIMEOUT_S} s: jobs "
                         f"{status['counts_by_op']}, serving {status['serving']}")
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


def write_drain_csv(path: str, rows: int = DRAIN_ROWS) -> None:
    """bench.py's drain rows (bench.py:892-896)."""
    with open(path, "w") as f:
        f.write("id,text,risk\n")
        for i in range(rows):
            f.write(f'{i},"drain record {i} with a payload of text",{i % 89}\n')


def drain_phase(fa, rt, path: str) -> dict:
    """Phase 10: the port as a swarm worker. The port's Agent, in this
    process with its default urllib session and the pipelined runner
    (PIPELINE_DEPTH 2), drains the port's controller's jobs: one warm-up
    shard of each op, then the CSV split by ``submit_csv_job`` into 8
    classify shards (the counts set to 0 just before, read just after), one
    profiled shard, one risk_accumulate shard of 65,536 values, a mixed
    drain of 2 summarize and 2 classify shards, and one CSV submitted
    without a shard size, which must take the card's hint (the reference's
    memory formula over nvidia-smi's memory.total: 16,384 rows on an 80 GB
    card). The same shards run serially through the ops on the same card
    for the bit-for-bit comparison and the ratio of rows/s."""
    from agent_tpu_torch.agent.app import Agent
    from agent_tpu_torch.config import AgentConfig, Config
    from agent_tpu_torch.data.staging import default_workers
    from agent_tpu_torch.ops import load_ops
    from agent_tpu_torch.controller.core import DEFAULT_SHARD_ROWS
    from agent_tpu_torch.sizing.profile import batch_hints, detect_gpu

    ops = load_ops(["map_classify_tpu", "map_summarize", "risk_accumulate"])
    on_card = torch.device(CARD).type == "cuda"
    classify_extra, s2s_extra, shards, s2s_shards = drain_payloads(path)
    device = torch.device(CARD).type
    n_layers = BERT_BASE["n_layers"]
    staged = [ops["map_classify_tpu"].stage(dict(p))[1] for p in shards]
    chunks = [len(state["chunks"]) for state in staged]
    with PortController() as ctrl:
        agent = Agent(Config(agent=AgentConfig(
            controller_url=ctrl.url, agent_name="chip-smoke-drain",
            tasks=("map_classify_tpu", "map_summarize", "risk_accumulate"),
            idle_sleep_sec=0.005, pipeline_depth=2)), runtime=rt)
        if type(agent.session).__name__ != "UrllibSession":
            raise SystemExit("the agent's default session is not the urllib one")

        # Warm-up: builds both models' weights; not timed.
        t0 = time.perf_counter()
        warm = ctrl.submit_csv(path, "map_classify_tpu", DRAIN_SHARD, DRAIN_SHARD,
                               classify_extra)
        warm += ctrl.submit_csv(path, "map_summarize", DRAIN_SHARD, DRAIN_SHARD, s2s_extra)
        pipelined_drain(agent, ctrl)
        ctrl.outcome(warm)
        warm_s = time.perf_counter() - t0

        # The classify drain: the slice's main path. Each timed pass starts
        # with a full collection, so none lands inside it.
        ids = ctrl.submit_csv(path, "map_classify_tpu", DRAIN_ROWS, DRAIN_SHARD, classify_extra)
        payloads = [ctrl.c.job(j).payload for j in ids]
        if payloads != shards:
            raise SystemExit(f"submit_csv_job's shards {payloads[:2]} are not {shards[:2]}")
        b1_before = ctrl.b1_results()
        torch.cuda.synchronize()
        gc.collect()
        reset_counts(fa)
        wall, _ = pipelined_drain(agent, ctrl)
        launches = fa.LAUNCH_COUNTS["flash_attention"]
        others = {k: v for k, v in fa.LAUNCH_COUNTS.items() if k != "flash_attention" and v}
        dense = fa.SELECTION_COUNTS["dense"]
        jobs = ctrl.outcome(ids)
        b1 = ctrl.b1_results() - b1_before
        results = [j["result"] for j in jobs]
        workers = {"max": agent.config.agent.stage_workers or default_workers(),
                   "picked": agent.obs.gauge("stage_pool_workers").value(),
                   "prefetch_depth": agent.obs.gauge("stage_prefetch_depth").value()}
        bad = [r for r in results if not r.get("ok") or r.get("device") != device
               or "fallback" in r]
        if bad or b1 != len(jobs):
            raise SystemExit(f"drain results not ok on {device}, {b1} of {len(jobs)} over b1: "
                             f"{str(bad)[:500]}")
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
        mixed_b1 = ctrl.b1_results()
        mixed_s2s = [ctrl.submit("map_summarize", p) for p in s2s_shards]
        mixed_cls = [ctrl.submit("map_classify_tpu", p) for p in shards[:2]]
        mixed_wall, _ = pipelined_drain(agent, ctrl)
        s2s_jobs = ctrl.outcome(mixed_s2s)
        cls_jobs = ctrl.outcome(mixed_cls)
        s2s_serial, s2s_serial_wall = serial_shards(ops["map_summarize"], rt, s2s_shards)
        for job, want in zip(s2s_jobs, s2s_serial):
            r = job["result"]
            if r.get("device") != device or r["summaries"] != want["summaries"]:
                raise SystemExit("the mixed drain's summaries differ from the serial op's")
        for job, want in zip(cls_jobs, serial):
            if job["result"]["indices"] != want["indices"] \
                    or job["result"]["scores"] != want["scores"]:
                raise SystemExit("the mixed drain's classify columns differ from the serial op's")
        if ctrl.b1_results() - mixed_b1 != len(mixed_s2s) + len(mixed_cls):
            raise SystemExit(f"{ctrl.b1_results() - mixed_b1} mixed results over b1, want "
                             f"{len(mixed_s2s) + len(mixed_cls)}")

        # A CSV without a shard size: the controller splits it by the hint
        # of the agent's worker profile, the reference's formula over the
        # card's memory (one shard of that many rows is drained).
        gpu = detect_gpu()
        mem = [g["memory_mb"] for g in gpu["gpus"] if "memory_mb" in g]
        want_rows = batch_hints(len(gpu["gpus"]), min(mem) * 2**20)["suggested_shard_rows"] \
            if gpu["gpu_present"] and mem else None
        hint = ctrl.c.suggested_shard_size()
        hinted_rows = hint or DRAIN_SHARD
        hinted = ctrl.submit_csv(path, "map_classify_tpu", hinted_rows, None, classify_extra)
        pipelined_drain(agent, ctrl)
        hinted_jobs = ctrl.outcome(hinted)
        shard_rows = ctrl.c.job(hinted[0]).payload["shard_size"]
        if hint != want_rows or shard_rows != min(want_rows or DEFAULT_SHARD_ROWS, hinted_rows) \
                or sum(j["result"]["n_rows"] for j in hinted_jobs) != hinted_rows \
                or (on_card and hint is None):
            raise SystemExit(f"the shard-size hint: controller {hint}, formula {want_rows}, "
                             f"a shard of {shard_rows} rows")
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
            "b1_results": b1, "b1_tasks_sent": ctrl.series("controller_wire_total",
                                                            direction="task", format="b1"),
            "lease_http_bytes": {d: ctrl.series("controller_http_bytes_total", route="/v1/leases",
                                                direction=d) for d in ("in", "out")},
            "result_http_bytes_in": ctrl.series("controller_http_bytes_total",
                                                route="/v1/results", direction="in"),
            "shard_hint": {"controller": hint, "formula": want_rows, "cards": len(gpu["gpus"]),
                           "memory_mb": min(mem) if mem else None, "shard_rows": shard_rows},
        }
        emit(report)
        # 15. the agent's telemetry, on the same weights.
        report["telemetry"] = telemetry_phase(fa, rt, shards, serial, staged)
    report["serial_results"] = serial  # phase 18's fleet is held to them
    return report


def control_workflows(shards: list, risk_values: list) -> tuple:
    """Phase 19's workflow documents, one a tenant: acme's classify stage
    for each shard (the CONTROL_CLASSIFY_PRIORITY tier) and an echo report
    after them, without partials; globex's risk_accumulate stage for each
    list of values and a reduce after them that collects their partials.
    No op reads ``fan_index``, so each shard is its own stage."""
    cls = [f"cls{i}" for i in range(len(shards))]
    risk = [f"risk{i}" for i in range(len(risk_values))]
    classify = {"stages": [
        *({"name": n, "op": "map_classify_tpu", "payload": dict(p),
           "priority": CONTROL_CLASSIFY_PRIORITY} for n, p in zip(cls, shards)),
        {"name": "report", "op": "echo", "payload": {"report": "classify"}, "after": cls,
         "collect": False}]}
    reduce = {"stages": [
        *({"name": n, "op": "risk_accumulate", "payload": {"values": v}}
          for n, v in zip(risk, risk_values)),
        {"name": "reduce", "op": "risk_accumulate", "after": risk}]}
    return classify, reduce


def lease_audit(ctrl, ids: list) -> dict:
    """From the controller's flight recorder (``GET /v1/debug/events``), in
    its sequence order: the jobs of ``ids`` leased before every dependency
    had its result (``early``), leases that passed over a job of a higher
    tier that was already leasable and never deferred for placement
    (``tier_breaks``), and each job's lease count."""
    events = sorted(ctrl.c.recorder.events(), key=lambda e: e["seq"])
    jobs = {j: ctrl.c.job(j) for j in ids}
    done_at = {e["job_id"]: e["seq"] for e in events
               if e["kind"] == "result" and e.get("state") == "succeeded"}
    lease_at: dict = {}
    for e in events:
        if e["kind"] == "lease" and e["job_id"] in jobs:
            lease_at.setdefault(e["job_id"], []).append(e["seq"])
    submit_at = {e["job_id"]: e["seq"] for e in events if e["kind"] == "submit"}

    def ready(j: str, seq: int) -> bool:
        return submit_at.get(j, seq) < seq and all(done_at.get(d, seq) < seq
                                                   for d in jobs[j].after)

    early = [j for j, seqs in lease_at.items() if not ready(j, seqs[0])]
    breaks = []
    for j, seqs in lease_at.items():
        for k, job in jobs.items():
            if job.priority > jobs[j].priority and k in lease_at and not job.placement_defers \
                    and lease_at[k][0] > seqs[0] and ready(k, seqs[0]):
                breaks.append((j, k))
    return {"early": early, "tier_breaks": breaks,
            "leases": {j: len(seqs) for j, seqs in lease_at.items()},
            "order": [e["job_id"] for e in events
                      if e["kind"] == "lease" and e["job_id"] in jobs]}


def exposition_round_trip(parts: list, parsed: dict) -> int:
    """Every counter and gauge series of the rendered ``parts`` (and each
    histogram's count) read back from the parsed exposition with its value
    -> the samples checked; raises on a missing or changed one."""
    checked = 0
    for snap, extra in parts:
        for name, fam in snap.items():
            for series in fam["series"]:
                labels = {**{k: str(v) for k, v in series["labels"].items()}, **extra}
                sample, want = (f"{name}_count", float(series["count"])) \
                    if fam["type"] == "histogram" else (name, float(series["value"]))
                if (labels, want) not in parsed.get(sample, []):
                    raise SystemExit(f"the exposition lost {sample}{labels} = {want}")
                checked += 1
    return checked


def control_plane_phase(fa, rt, path: str, serial: list, chunks: list) -> dict:
    """Phase 19: the port's controller with the fair scheduler, the
    workflow engine, the result cache and its observability, driving
    classify workflows on the card: phase 10's CSV's first CONTROL_SHARDS
    shards and the BERT-base weights phase 10 left on the card, and a new
    agent on the same runtime (PIPELINE_DEPTH 2). Two workflows
    (``control_workflows``), one a tenant of CONTROL_TENANTS' weights, are
    planned by the controller and leased by the fair policy from the real
    lease bodies' capabilities. From the controller's flight recorder
    (``lease_audit``): no job leased before its dependencies were done, no
    lease passing over a higher tier, every job leased once; no placement
    deferral (``sched_decisions_total``) on an agent whose device_kind is
    the device (``sched.fair.DEVICE_KINDS``), where the reference defers
    one from "cuda"; the classify results bit for bit phase 10's serial
    results for the same shards; the reduce's sum within n · 2⁻²⁴ Σ|v| of
    math.fsum; row 1 n_layers times a dispatch chunk. Both workflows
    resubmitted under new ids are answered from the result cache (``GET
    /v1/workflows/{id}``: every job a cache hit, the reduce's at lease time
    on its collected partials): no lease, the same results, row 1 not
    launched. ``GET /v1/metrics`` validates and parses
    back; the TSDB (TSDB_INTERVAL CONTROL_RING_INTERVAL_S), closed and
    reopened, reads back the ring's series (``GET /v1/timeseries``); the
    SLO's burn (``GET /v1/health``), ``GET /v1/usage``'s two tenants, the
    anomaly detector's events; each workflow's trace complete, each job's
    submit and lease spans with the agent's queue, execute and post spans
    (and a classify job's stage span) under the lease span."""
    from agent_tpu_torch.agent.app import Agent
    from agent_tpu_torch.config import AgentConfig, Config, ObsConfig, SchedConfig, SloConfig
    from agent_tpu_torch.obs import metrics
    from agent_tpu_torch.obs.tsdb import TsdbStore, query_history
    from agent_tpu_torch.sched.fair import DEVICE_KINDS

    t_phase = time.perf_counter()
    on_card = torch.device(CARD).type == "cuda"
    smi = nvidia_smi_line() if on_card else "not a card"
    n_layers = BERT_BASE["n_layers"]
    shards = drain_payloads(path)[2][:CONTROL_SHARDS]
    rng = np.random.default_rng(SEED + 19)
    risk_values = [(rng.standard_normal(CONTROL_RISK_VALUES) * 1e3).tolist()
                   for _ in range(CONTROL_SHARDS)]
    classify_doc, reduce_doc = control_workflows(shards, risk_values)
    tmp = tempfile.TemporaryDirectory()
    tsdb_dir = os.path.join(tmp.name, "tsdb")
    ctrl = PortController(
        cache=True, sched=SchedConfig(policy="fair", tenant_weights=dict(CONTROL_TENANTS)),
        slo=SloConfig(spec=json.dumps(CONTROL_SLO)),
        obs=ObsConfig(tsdb_dir=tsdb_dir, tsdb_interval_sec=CONTROL_RING_INTERVAL_S))
    c = ctrl.c
    try:
        with ctrl:
            name = "chip-smoke-control"
            agent = Agent(Config(agent=AgentConfig(
                controller_url=ctrl.url, agent_name=name,
                tasks=("map_classify_tpu", "risk_accumulate", "echo"), idle_sleep_sec=0.005,
                pipeline_depth=2)), runtime=rt)
            kind = agent.capabilities().get("device_kind")
            if on_card:
                torch.cuda.synchronize()
            gc.collect()
            reset_counts(fa)
            wfs = [c.submit_workflow(copy.deepcopy(classify_doc), tenant="acme"),
                   c.submit_workflow(copy.deepcopy(reduce_doc), tenant="globex")]
            ids = [j for wf in wfs for j in wf["job_ids"]]
            stage_of = {j: st for wf in wfs for j, st in zip(wf["job_ids"], wf["stages"])}
            wall, _ = pipelined_drain(agent, ctrl)
            launches = fa.LAUNCH_COUNTS["flash_attention"]
            audit = lease_audit(ctrl, ids)
            defers = ctrl.series("sched_decisions_total", decision="deferred_placement")
            if audit["early"] or audit["tier_breaks"] or sorted(audit["leases"]) != sorted(ids) \
                    or set(audit["leases"].values()) != {1}:
                raise SystemExit(f"the workflows' leases: early {audit['early']}, past a higher "
                                 f"tier {audit['tier_breaks'][:4]}, leased {audit['leases']}")
            if (kind in DEVICE_KINDS) == bool(defers):
                raise SystemExit(f"{defers} placement deferrals on an agent of device_kind "
                                 f"{kind!r}")
            jobs = {stage_of[j]: snap for j, snap in zip(ids, ctrl.outcome(ids))}
            for i in range(CONTROL_SHARDS):
                got = jobs[f"cls{i}"]["result"]
                if got["indices"] != serial[i]["indices"] or got["scores"] != serial[i]["scores"]:
                    raise SystemExit(f"the workflow's shard {i} differs from phase 10's serial run")
            want = n_layers * sum(chunks[:CONTROL_SHARDS])
            if launches != want:
                raise SystemExit(f"row 1 launched {launches} times in the workflow (want {want})")
            every = [v for values in risk_values for v in values]
            exact = math.fsum(every)
            bound = len(every) * 2.0 ** -24 * math.fsum(abs(v) for v in every)
            reduce = jobs["reduce"]["result"]
            views = [c.workflow_json(wf["workflow_id"]) for wf in wfs]
            if reduce.get("count") != len(every) or reduce.get("n_partials") != CONTROL_SHARDS \
                    or not abs(reduce["sum"] - exact) <= bound or not jobs["report"]["result"]["ok"] \
                    or [v["state"] for v in views] != ["succeeded"] * 2:
                raise SystemExit(f"the reduce {reduce} against math.fsum {exact} (bound {bound}), "
                                 f"workflows {[v['state'] for v in views]}")

            # Both workflows again, under new ids: every job answered from
            # the result cache (the risk stages at submit, the reduce at
            # lease time, keyed on its collected partials), none leased,
            # row 1 not launched, the same results.
            leased = ctrl.series("controller_tasks_leased_total")
            t0 = time.perf_counter()
            again = [c.submit_workflow(copy.deepcopy(classify_doc), tenant="acme"),
                     c.submit_workflow(copy.deepcopy(reduce_doc), tenant="globex")]
            wall2, _ = pipelined_drain(agent, ctrl)
            resubmit_s = time.perf_counter() - t0
            views2 = [c.workflow_json(wf["workflow_id"]) for wf in again]
            cache_hits = sum(v["cache_hits"] for v in views2)
            if ctrl.series("controller_tasks_leased_total") != leased \
                    or cache_hits != len(ids) \
                    or [v["state"] for v in views2] != ["succeeded"] * 2 \
                    or fa.LAUNCH_COUNTS["flash_attention"] != launches:
                raise SystemExit(f"the cached resubmit: {views2}, leases "
                                 f"{ctrl.series('controller_tasks_leased_total') - leased}, row 1 "
                                 f"{fa.LAUNCH_COUNTS['flash_attention'] - launches} more")
            for wf in again:
                for j, st in zip(wf["job_ids"], wf["stages"]):
                    if c.job_snapshot(j)["result"] != jobs[st]["result"]:
                        raise SystemExit(f"the cache answered {j} ({st}) with another result")

            # Observability. The server counts a request's bytes after its
            # response is sent, so the agent's last lease may land between
            # two reads: the exposition is read between two equal snapshots.
            for _ in range(100):
                snap = c.metrics.snapshot()
                text = c.metrics_text()
                if c.metrics.snapshot() == snap:
                    break
                time.sleep(0.01)
            problems = metrics.validate_exposition(text, required=(
                "controller_queue_depth", "controller_tasks_leased_total", "slo_burn_rate",
                "device_busy_seconds_total", "sched_decisions_total"))
            parts = [(snap, {}), (metrics.merge_snapshots([ctrl.agent_obs(name)]), {})]
            checked = exposition_round_trip(parts, metrics.parse_exposition(text))
            slo = [o for o in c.health_json()["slo"]["objectives"]
                   if o["objective"] == CONTROL_SLO[0]["name"]]
            usage = c.usage_json()
            trees = [c.trace_json(wf["workflow_id"]) for wf in wfs]
            spans = [sp for tree in trees for sp in tree["spans"]]
            trace_problems = []
            for j in ids:
                job = c.job(j)
                sub = [sp for sp in spans if sp["span_id"] == job.root_span_id]
                lease = [sp for sp in spans if sp["name"] == "lease"
                         and sub and sp["parent_span_id"] == sub[0]["span_id"]]
                under = collections.Counter(sp["name"] for sp in spans if lease
                                            and sp["parent_span_id"] == lease[0]["span_id"])
                # A host op with nothing to stage (risk_accumulate's values
                # in the payload) ships no stage span.
                phases = ("queue", "execute", "post") + (
                    ("stage",) if job.op == "map_classify_tpu" else ())
                if len(sub) != 1 or len(lease) != 1 or any(under[p] != 1 for p in phases) \
                        or under["stage"] > 1:
                    trace_problems.append(f"{j}: submit {len(sub)}, lease {len(lease)}, "
                                          f"under it {dict(under)}")
            if problems or not all(t["complete"] for t in trees) or trace_problems \
                    or set(usage["by_tenant"]) != set(CONTROL_TENANTS) or len(slo) != 1:
                raise SystemExit(f"exposition {problems[:4]}, traces complete "
                                 f"{[t['complete'] for t in trees]} (orphans "
                                 f"{[t['orphans'] for t in trees]}), {trace_problems[:4]}, "
                                 f"tenants {sorted(usage['by_tenant'])}, SLO {slo}")
            family = "device_busy_seconds_total"
            from_ring = query_history(family, ring=c.tsdb)
            samples = c.tsdb_store.samples_appended
            points = c.timeseries_json(family)["series"]
            anomalies = [e for e in c.recorder.events() if e["kind"] == "anomaly"]
        reopened = TsdbStore(tsdb_dir)  # the controller closed its store on exit
        from_disk = query_history(family, store=reopened)
        tsdb_bytes = reopened.stats()["bytes"]
        reopened.close()
        if not from_disk["series"] or from_disk["series"] != from_ring["series"] or not points:
            raise SystemExit(f"the reopened TSDB's {family}: {str(from_disk)[:300]} against "
                             f"the ring's {str(from_ring)[:300]}")
        (slo,) = slo
        report = {
            "phase": "control_plane", "nvidia_smi": smi, "config": BERT_BASE,
            "workflows": {"jobs": len(ids), "shards": CONTROL_SHARDS,
                          "shard_rows": DRAIN_SHARD, "risk_values": len(every),
                          "tenants": CONTROL_TENANTS},
            "lease_order": [stage_of[j] for j in audit["order"]],
            "device_kind": kind, "placement_deferrals": defers,
            "sched_decisions": {d: ctrl.series("sched_decisions_total", decision=d)
                                for d in ("leased", "deferred_placement")},
            "wall_s": wall, "cached_resubmit_s": resubmit_s, "cached_drain_s": wall2,
            "row1_launches": launches, "row1_launches_want": want,
            "row1_launches_after_resubmit": fa.LAUNCH_COUNTS["flash_attention"],
            "cache_hits": cache_hits, "cache": c.workflows_json()["result_cache"],
            "reduce": {"sum": reduce["sum"], "fsum": exact, "diff": abs(reduce["sum"] - exact),
                       "bound": bound},
            "exposition": {"bytes": len(text), "samples_checked": checked},
            "tsdb": {"bytes": tsdb_bytes, "samples": samples,
                     "points_read_back": sum(len(s["points"]) for s in from_disk["series"])},
            "slo": {k: slo[k] for k in ("objective", "state", "attainment",
                                        "burn_rate_short", "burn_rate_long",
                                        "error_budget_remaining")},
            "anomaly_events": anomalies,
            "usage_by_tenant": {t: {k: v for k, v in u.items() if k in (
                "tasks", "device_seconds", "rows", "result_cache_hits")}
                for t, u in usage["by_tenant"].items()},
            "trace_spans": len(spans), "seconds": time.perf_counter() - t_phase}
    finally:
        tmp.cleanup()
    emit(report)
    return report


TELEMETRY_AGENT = "chip-smoke-telemetry"
# An objective that pages on one slow job of its tenant: phase 15's slo_page.
TELEMETRY_PAGE = {"name": "telemetry_page", "tenant": "paging", "p99_ms": 1,
                  "availability": 0.99}
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
    """Every job's trace (``GET /v1/trace/{job}``), assembled again by the
    port's ``trace.assemble``, must be complete, with stage, queue, execute
    and post once each, parented to the controller's lease span and closed
    -> (all spans, spans per job)."""
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


def telemetry_phase(fa, rt, shards: list, serial: list, staged: list) -> dict:
    """Phase 15: the agent's telemetry against a port controller, on phase
    10's shards and resident BERT-base weights, through the pipelined
    runner (PIPELINE_DEPTH 2). The 8 shards drain once with TRACE_ENABLED=0
    (no agent span may reach the controller) and once traced, with
    PROFILE_DIR set (PROFILE_TASKS 1) and a deep capture requested from the
    controller (``request_capture``, riding the first granted lease): each
    shard's trace is complete, Σ usage.device_s equals the busy counter
    the agent shipped within 1 %, Σ usage.flops the staged shapes'
    encoder_fwd_flops, device_mfu and device_duty_cycle lie in (0, 1],
    device_hbm_bytes' limit is the card's total within 1 %, and both Chrome
    traces hold row 1's kernel (on the card). Then one shard of tenant
    ``paging``, whose objective (TELEMETRY_PAGE) that one slow job sends to
    ``page`` (``GET /v1/health``), and one more shard, whose lease carries
    the page alert: the agent's recorder dump must hold the traced shards'
    lease and posted events. Last, one shard through an agent whose
    CONTROLLER_URLS lists a dead local port first (one failover). Every
    result equals phase 10's serial run bit for bit."""
    from agent_tpu_torch.agent.app import Agent
    from agent_tpu_torch.config import AgentConfig, Config, DeviceConfig, SloConfig
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

    def drain(worker, payloads: list, want: list, **submit) -> tuple:
        ids = [ctrl.submit(op, p, **submit) for p in payloads]
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
    ctrl = PortController(slo=SloConfig(spec=json.dumps([TELEMETRY_PAGE])))
    ctrl.__enter__()
    try:
        # Tracing off.
        os.environ["TRACE_ENABLED"] = "0"
        obs_trace.set_enabled(None)
        off_ids, _, wall_off = drain(agent("chip-smoke-trace-off"), shards, serial)
        shipped = [s for j in off_ids for s in ctrl.trace(j) if s.get("process") != "controller"]
        if shipped:
            raise SystemExit(f"TRACE_ENABLED=0 shipped {len(shipped)} spans")

        # Tracing on (the default), PROFILE_DIR, and a capture on the first
        # lease (the staging pool may lease every shard at once): the
        # capture takes the first execute, PROFILE_DIR the next.
        del os.environ["TRACE_ENABLED"]
        obs_trace.set_enabled(None)
        on = agent(TELEMETRY_AGENT, DeviceConfig(profile_dir=prof_dir, profile_tasks=1))
        capture_id = ctrl.c.request_capture(TELEMETRY_AGENT, op=op)["capture_id"]
        reset_counts(fa)
        ids, results, wall_on = drain(on, shards, serial)
        launches = fa.LAUNCH_COUNTS["flash_attention"]
        obs = ctrl.agent_obs(TELEMETRY_AGENT)  # its final flush
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
        records = [c for c in ctrl.c.captures_json()["captures"]
                   if c.get("capture_id") == capture_id]
        artifact = records[0].get("artifact") if len(records) == 1 else None
        if len(traces) != 1 or artifact is None or records[0]["status"] != "done" \
                or not os.path.isfile(os.path.join(artifact, "trace.json")):
            raise SystemExit(f"captures: PROFILE_DIR holds {traces}, the controller has "
                             f"{records}")
        kernels = {"profile_dir": trace_kernels(os.path.join(prof_dir, traces[0]),
                                                "flash_fwd_sm90"),
                   "capture": trace_kernels(os.path.join(artifact, "trace.json"),
                                            "flash_fwd_sm90")}
        if on_card and min(kernels.values()) < 1:
            raise SystemExit(f"row 1 missing from the agent's captures: {kernels}")

        # A slow job of tenant "paging" pages its objective; the next lease
        # carries the alert, and the agent dumps its recorder.
        if on.slo_dump_paths:
            raise SystemExit(f"slo_page dumps before the page: {on.slo_dump_paths}")
        drain(on, shards[:1], serial[:1], tenant=TELEMETRY_PAGE["tenant"])
        health = ctrl.c.health_json()
        paged = [o for o in health["slo"]["objectives"]
                 if o["objective"] == TELEMETRY_PAGE["name"]]
        drain(on, shards[:1], serial[:1])
        if [o["state"] for o in paged] != ["page"] or len(on.slo_dump_paths) != 1 \
                or not on.slo_dump_paths[0].startswith(rec_dir):
            raise SystemExit(f"slo_page: objective {paged}, dumps {on.slo_dump_paths}")
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
        fenced = ctrl.fenced()
    finally:
        ctrl.__exit__(None, None, None)
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
        "slo_page": {k: paged[0][k] for k in ("objective", "state", "burn_rate_short",
                                              "burn_rate_long")},
        "failover": failovers[0], "refused_posts": fenced,
    }
    emit(report)
    return report


def http_json(url: str, body=None, timeout: float = 120.0):
    """GET ``url`` (or POST ``body`` as JSON) -> (status, the JSON answer,
    the text of a text answer, or None); an HTTP error's status and body
    come back, not raised."""
    import urllib.error
    import urllib.request

    def decode(raw: bytes, ctype: str):
        if not raw:
            return None
        return json.loads(raw) if "json" in ctype else raw.decode()

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, decode(resp.read(), resp.headers.get("Content-Type", ""))
    except urllib.error.HTTPError as exc:
        return exc.code, decode(exc.read(), exc.headers.get("Content-Type", ""))


def start_controller(env: dict, log, timeout: float = 120.0):
    """``python -m agent_tpu_torch.controller.server`` in a process of its own
    (``CONTROLLER_PORT=0``) -> (the process, the URL of its "serving on"
    line). Its output goes to ``log`` once the line is read."""
    proc = subprocess.Popen([sys.executable, "-m", "agent_tpu_torch.controller.server"],
                            cwd=env["PYTHONPATH"], env=dict(env, CONTROLLER_PORT="0",
                                                            CONTROLLER_HOST="127.0.0.1"),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    t0, seen = time.perf_counter(), []
    while time.perf_counter() - t0 < timeout:
        line = proc.stdout.readline()
        if not line:
            break
        seen.append(line)
        if "serving on " in line:
            url = line.split("serving on ", 1)[1].split()[0]
            threading.Thread(target=lambda: shutil.copyfileobj(proc.stdout, log),
                             daemon=True).start()
            return proc, url
    proc.kill()
    proc.wait()
    raise SystemExit(f"the controller process did not start: {''.join(seen)[-2000:]}")


def entry_point_phase(path: str) -> dict:
    """Phase 10, the entry points: ``python -m agent_tpu_torch.controller.server``
    (CONTROLLER_PORT=0, its URL read from the "serving on" line) and
    ``python -m agent_tpu_torch.agent.app`` against it, each in a process of
    its own. Over HTTP, one echo, one read_csv_shard and a CSV of two 256-row
    classify shards go in (``POST /v1/jobs``); with
    TASKS=echo,read_csv_shard,map_classify_tpu the agent drains them
    (``GET /v1/status``), then SIGUSR1 must dump its flight recorder (holding
    the lease events), and SIGTERM end the agent and then the controller,
    each with exit code 0; with TASKS=none the agent must exit 2 at once."""
    root = os.path.dirname(os.path.abspath(__file__))
    extra = {"text_field": "text", "result_format": "columnar", "allow_fallback": False,
             "model_config": dict(BERT_BASE, n_layers=ENTRY_LAYERS), "topk": 5}
    torch.cuda.empty_cache()  # leave the card's memory to the other process
    t_phase = time.perf_counter()
    with tempfile.TemporaryFile("w+") as log, tempfile.TemporaryFile("w+") as ctl_log, \
            tempfile.TemporaryDirectory() as rec_dir:
        env = dict(os.environ, PYTHONPATH=root, LEASE_TTL_SEC=str(LEASE_TTL_S))
        t_ctl = time.perf_counter()
        ctl, url = start_controller(env, ctl_log)
        ctl_start_s = time.perf_counter() - t_ctl
        proc = None
        try:
            ids = [http_json(f"{url}/v1/jobs", {"op": "echo", "payload": {"hello": "card"}}),
                   http_json(f"{url}/v1/jobs", {"op": "read_csv_shard", "payload": {
                       "source_uri": path, "shard_size": 5}})]
            status, csv = http_json(f"{url}/v1/jobs", {
                "source_uri": path, "total_rows": 2 * ENTRY_SHARD, "shard_size": ENTRY_SHARD,
                "map_op": "map_classify_tpu", "extra_payload": extra})
            if any(st != 200 for st, _ in ids) or status != 200:
                raise SystemExit(f"POST /v1/jobs: {ids}, {status} {csv}")
            ids = [body["job_id"] for _, body in ids] + csv["job_ids"]
            env = dict(env, CONTROLLER_URL=url, AGENT_NAME="chip-smoke-entry",
                       TASKS="echo,read_csv_shard,map_classify_tpu", IDLE_SLEEP_SEC="0.05",
                       FLIGHT_RECORDER_DIR=rec_dir)
            t0 = time.perf_counter()
            proc = subprocess.Popen([sys.executable, "-m", "agent_tpu_torch.agent.app"],
                                    cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT)
            drained = False
            while proc.poll() is None and time.perf_counter() - t0 < DRAIN_TIMEOUT_S:
                drained = bool(http_json(f"{url}/v1/status")[1]["drained"])
                if drained:
                    break
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
            jobs = [http_json(f"{url}/v1/jobs/{j}")[1] for j in ids] if drained else []
            _, status = http_json(f"{url}/v1/status")
            t_ctl = time.perf_counter()
            ctl.send_signal(signal.SIGTERM)
            ctl_rc = ctl.wait(timeout=60)
            ctl_stop_s = time.perf_counter() - t_ctl
        finally:
            for p in (proc, ctl):
                if p is not None and p.poll() is None:
                    p.kill()
                    p.wait()
        log.seek(0)
        out = log.read()
        ctl_log.seek(0)
        ctl_out = ctl_log.read()
    none = subprocess.run([sys.executable, "-m", "agent_tpu_torch.agent.app"], cwd=root,
                          env=dict(env, TASKS="none"), capture_output=True, text=True,
                          timeout=300)
    leases = sum(1 for e in dumped if e["kind"] == "lease")
    report = {"phase": "entry_point", "controller_url": url, "drained_s": drained_s,
              "exit_code": rc, "controller_exit_code": ctl_rc,
              "controller_start_s": ctl_start_s, "controller_stop_s": ctl_stop_s,
              "exit_code_tasks_none": none.returncode, "sigusr1_dump_events": len(dumped),
              "sigusr1_dump_leases": leases, "stale_results": status.get("stale_results"),
              "agents_seen": sorted(status.get("agents", {})),
              "seconds": time.perf_counter() - t_phase, "log_tail": out[-1500:],
              "controller_log_tail": ctl_out[-500:]}
    emit(report)
    cls = [j["result"] for j in jobs if j["op"] == "map_classify_tpu"]
    if rc != 0 or ctl_rc != 0 or none.returncode != 2 or len(jobs) != 4 \
            or any(j["state"] != "succeeded" or j["attempts"] != 1 for j in jobs) or not leases \
            or status.get("stale_results") or "chip-smoke-entry" not in report["agents_seen"] \
            or [r.get("device") for r in cls] != [torch.device(CARD).type] * 2 \
            or [r["n_rows"] for r in cls] != [ENTRY_SHARD] * 2:
        raise SystemExit(f"the entry points failed: agent exit {rc}, controller exit {ctl_rc}, "
                         f"TASKS=none exit {none.returncode}, {len(jobs)} of 4 jobs, {leases} "
                         f"leases in the SIGUSR1 dump, log {out[-2000:]}, controller "
                         f"{ctl_out[-1000:]}")
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
    forward times beside the bound, as a kernels-line entry of its own (ms
    through the launcher; ``entry_times`` through the entry point, which
    adds the keyless-row rule)."""
    q, k, v, mask, lengths = check[inputs]
    B, H, L, D = q.shape
    bool_mask = mask > 0
    return kernel_entry(
        "flash_attention", "agent_tpu_torch/kernels/csrc/flash_fwd_sm90.cuh", SM90,
        "agent_tpu/kernels/flash_attention.py:149", launches,
        check["max_abs_err"], check["max_rel_err"],
        cuda_ms(lambda: fa._launch(q, k, v, mask)),
        cuda_ms(lambda: fa.flash_attention_reference(q, k, v, mask), iters=5),
        4 * B * H * L * D * q.element_size() + mask.numel() * mask.element_size(),
        4 * H * L * D * float(np.sum(lengths)),  # products with real keys only
        cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=bool_mask)), q,
        **entry_times(fa, lengths, lambda: fa.flash_attention(q, k, v, mask)))


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
    _, err, rel = compare(fa._launch(q, k, v, mask),
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
    _, err, rel = compare(fa._launch_t5(q, k, v, mask, table, maxd, 1.0),
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
                     profile: bool, requests: int) -> dict:
    """bench.py's comparison on the card, over the stream's first
    ``requests``: the static path decodes arrival-order batches of
    ``slots`` requests through greedy_generate / beam_generate, each batch
    run to its longest budget; one persistent paged engine runs the same
    requests with per-slot limits. Both count the requested tokens (the
    engine's steps per request). Each side is warmed on the first
    SERVE_WARM requests; ``profile`` adds one profiled stretch of
    SERVE_PROFILE_STEPS engine steps in a third pass."""
    from agent_tpu_torch.models import seq2seq

    ids, mask, limits = (part[:requests] for part in stream)
    enc_all = enc_all[:requests]
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
        out["profile_steps"] = {"steps": SERVE_PROFILE_STEPS, **{k: prof[k] for k in (
            "wall_ms", "device_ms", "idle_share", "kernels_launched", "host_blocked_reads",
            "host_blocked_ms", "device_ms_by_kind", "top_kernels", "profile_attempts")}}
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


def front_door_batches(op: str, requests: list, config=None) -> list:
    """The batch jobs the port's front door (controller/serving.py's
    ServeFrontDoor, on ``config`` or the default ServeConfig) forms from
    ``requests`` (``POST /v1/infer`` bodies) posted at once, before any
    lease: the full buckets as they fill, then the rest at the deadline ->
    their payloads in flush order, each request's req_id its index in
    ``requests``."""
    from agent_tpu_torch.config import ServeConfig
    from agent_tpu_torch.controller.serving import ServeFrontDoor

    door = ServeFrontDoor(config or ServeConfig(), clock=lambda: 0.0)
    batches, index = [], {}
    for i, body in enumerate(requests):
        req, full = door.submit(op, body["text"], params=body.get("params"))
        index[req.req_id] = f"q{i:04d}"
        batches += full
    batches += door.pop_due(now_clock=math.inf)
    out = []
    for batch in batches:
        payload = batch.job_payload()
        for r in payload["requests"]:
            r["req_id"] = index[r["req_id"]]
        out.append(payload)
    return out


def formed_batches(ctrl, op: str, bodies: list, req_ids: list) -> dict:
    """The batch jobs the front door formed of ``bodies``, posted at once
    before any lease (``req_ids`` their ids): each request's job from ``GET
    /v1/debug/requests``, each job's riders held to ``front_door_batches``'
    prediction -> {job id: (its payload, the predicted one with the
    controller's req ids; its prefill job or None)}, in flush order."""
    recs = {r["trace_id"]: r for r in ctrl.get("/v1/debug/requests?limit=4096")["requests"]}
    riders: dict = {}
    for i, rid in enumerate(req_ids):
        riders.setdefault(recs[rid]["job_id"], []).append(i)
    by_members = {tuple(ids): job for job, ids in riders.items()}
    out = {}
    for payload in front_door_batches(op, bodies):
        members = tuple(int(r["req_id"][1:]) for r in payload["requests"])
        job = by_members.get(members)
        if job is None:
            raise SystemExit(f"the front door's batches {sorted(riders.values())} are not "
                             f"the predicted ones (no job rode {list(members)})")
        for r in payload["requests"]:
            r["req_id"] = req_ids[int(r["req_id"][1:])]
        out[job] = (payload, recs[req_ids[members[0]]].get("prefill_job_id"))
    if len(out) != len(riders):
        raise SystemExit(f"{len(riders)} batch jobs, {len(out)} predicted")
    return out


def summarize_requests(texts: list, limits: list) -> list:
    """``POST /v1/infer`` bodies of summarize requests (phase 13's model)."""
    model = {"model_config": SERVE_MODEL} if SERVE_MODEL else {}
    return [{"op": "summarize", "text": t, "params": {"max_length": n, **model}}
            for t, n in zip(texts, limits)]


def agent_requests() -> list:
    """The requests of the agent's colocated run: SERVE_AGENT_JOBS groups
    of requests of 20-60 bytes (one length bucket), budgets drawn as the
    stream's (90 % T // 32, else T)."""
    rng = random.Random(SEED + 17)
    long_ = serve_cfg().max_tgt_len
    short = max(2, long_ // 32)
    texts, limits = [], []
    for n in SERVE_AGENT_JOBS:
        texts += random_texts(rng, n, 20, 60)
        limits += [short if rng.random() < SERVE_SHORT_FRAC else long_ for _ in range(n)]
    return summarize_requests(texts, limits)


def disagg_requests(round_idx: int) -> list:
    """bench.py's disaggregated mix (bench.py:1383-1392, :1592-1606): of
    DISAGG_REQUESTS requests every 4th a one-off, the rest one of
    DISAGG_DOCS shared documents, 4 tokens each."""
    docs = [f"shared context document {d} " + "with common preamble content " * 8
            for d in range(DISAGG_DOCS)]
    texts = [f"one-off request r{round_idx} i{i} " + "tail words " * 18 if i % 4 == 0
             else docs[i % DISAGG_DOCS] for i in range(DISAGG_REQUESTS)]
    return summarize_requests(texts, [4] * DISAGG_REQUESTS)


def serving_cases(serve) -> list:
    """Row 1's shapes and key lengths on the serving path, as the serve
    stage pads them: one admit batch (B 8) and the whole stream (B 240) of
    the bench stream at L 64, and the batches the front door forms of the
    agent's requests and of the disaggregated measured round."""
    cfg = serve_cfg()
    H, D, dtype = cfg.n_heads, cfg.d_model // cfg.n_heads, cfg.compute_dtype
    cases = [(f"serve_admit8/B8xL{SERVE_SRC}", (8, H, SERVE_SRC, SERVE_SRC, D),
              [SERVE_SRC] * 8, dtype),
             (f"serve_stream240/B{SERVE_REQUESTS}xL{SERVE_SRC}",
              (SERVE_REQUESTS, H, SERVE_SRC, SERVE_SRC, D), [SERVE_SRC] * SERVE_REQUESTS, dtype)]
    for name, reqs in (("serve_agent", agent_requests()), ("serve_disagg", disagg_requests(1))):
        for job in front_door_batches("summarize", reqs):
            phase, state = serve.stage(dict(job))
            if phase != "staged":
                raise SystemExit(f"{name} did not stage: {state}")
            B, L = state["ids"].shape
            cases.append((f"{name}/B{B}xL{L}", (B, H, L, L, D), state["lengths"].tolist(),
                          dtype))
    return cases


def serving_mix_cases(classify, serve) -> list:
    """Row 1's shapes and key lengths on phase 24's serving legs: the
    batches the front door forms of check_serving_pipeline's bodies posted
    at once (each warm-up alone; the LoadGen schedule and the volley at the
    serving leg's batching; the split leg's requests at its own), staged by
    map_classify_tpu at BERT_BASE (serve_classify's forward) and by
    serve_summarize at SERVE_MODEL (serve_prefill stages alike). Under load
    the door flushes subsets of these batches. Distinct shapes and key
    lengths only."""
    from agent_tpu_torch.config import ServeConfig
    from agent_tpu_torch.scripts import check_serving_pipeline as csp

    serving, split = ServeConfig(**csp.SERVE_KNOBS), ServeConfig(**csp.SPLIT_SERVE_KNOBS)
    load = [dict(a.payload, op=a.cls.op)
            for a in csp.traffic(BERT_BASE, SERVE_MODEL).schedule(csp.LOAD_SECONDS)]
    groups = [("mix_warm", [b], serving) for b in csp.warm_bodies(BERT_BASE, SERVE_MODEL)] + [
        ("mix_load", load, serving), ("mix_volley", csp.volley_bodies(SERVE_MODEL), serving),
        ("mix_split", csp.disagg_bodies(SERVE_MODEL), split)]
    cfg = serve_cfg()
    H, D = cfg.n_heads, cfg.d_model // cfg.n_heads
    cases, seen = [], set()
    for name, bodies, door in groups:
        for op in ("classify", "summarize"):
            for job in front_door_batches(op, [b for b in bodies if b["op"] == op], door):
                texts = [r["text"] for r in job["requests"]]
                if op == "classify":
                    new = staged_cases(classify, [(f"{name}_classify", {
                        "texts": texts, "topk": job["topk"],
                        "model_config": job["model_config"]}, len(texts))])
                else:
                    phase, state = serve.stage(dict(job))
                    if phase != "staged":
                        raise SystemExit(f"{name} did not stage: {state}")
                    B, L = state["ids"].shape
                    new = [(f"{name}_summarize/B{B}xL{L}", (B, H, L, L, D),
                            state["lengths"].tolist(), cfg.compute_dtype)]
                for case in new:
                    key = (case[1], tuple(case[2]), case[3])
                    if key not in seen:
                        seen.add(key)
                        cases.append(case)
    return cases


def per_request(results: list) -> list:
    return [{k: r[k] for k in ("req_id", "summary", "tokens", "steps")}
            for out in results for r in out["results"]]


def post_infer(url: str, bodies: list) -> list:
    """``POST /v1/infer`` each body with ``wait: false`` -> the req_ids."""
    out = []
    for body in bodies:
        status, answer = http_json(f"{url}/v1/infer", dict(body, wait=False))
        if status != 200:
            raise SystemExit(f"POST /v1/infer: {status} {answer}")
        out.append(answer["req_id"])
    return out


def infer_answers(url: str, req_ids: list, threads: int = 1) -> list:
    """``GET /v1/infer/{id}`` of each request, ``threads`` at a time; fails
    unless each is done."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(threads) as pool:
        out = list(pool.map(lambda r: http_json(f"{url}/v1/infer/{r}")[1], req_ids))
    bad = [a for a in out if not a or a.get("state") != "done"]
    if bad:
        raise SystemExit(f"{len(bad)} requests not done: {str(bad[:2])[:600]}")
    return out


def requests_done(ctrl, n: int) -> bool:
    """Every one of the ``n`` requests the front door has seen is terminal
    (``GET /v1/status``'s serving block)."""
    states = (ctrl.c.serve_status() if ctrl.c is not None
              else ctrl.get("/v1/status")["serving"])["requests"]
    return sum(states.values()) >= n and states.get("done", 0) + states.get("failed", 0) >= n


def ttft_components(ctrl, names=("bucket_wait", "queue_wait", "prefill", "handoff",
                                 "kv_wait", "first_decode")) -> dict:
    """p50 and max of each TTFT component (ms) over ``GET
    /v1/debug/requests``' records, and the records' count."""
    recs = ctrl.get("/v1/debug/requests?limit=4096")["requests"]
    out = {"records": len(recs)}
    for name in names:
        vals = sorted(r["components"][name] for r in recs if name in r["components"])
        if vals:
            out[name] = {"p50": statistics.median(vals), "max": vals[-1]}
    return out


def serving_agent(fa, rt) -> dict:
    """The port's front door, in a controller process of its own (no
    sweeper: ``CONTROLLER_SWEEP_SEC=0``), and pipelined agent, all requests
    through ``POST /v1/infer`` (the default ServeConfig) and posted before
    the agent starts, so that the batches are the ones
    ``front_door_batches`` predicts (``formed_batches`` holds them to it):
    the agent's requests through serve_summarize jobs sharing one engine,
    each request's tokens equal to the same batch payloads run serially
    through the op, row 1 n_enc times a batch job; then bench.py's
    disaggregated mix with ``disaggregated=True``: the controller chains
    serve_prefill -> serve_decode through ``__collect_partials__`` (the
    prefill's encoded rows ride the results wire as b1 and the decode's
    lease), one pool of agents a stage (the prefill pool drains, then the
    decode pool), after a warm round of prefills through the op, the
    answers equal to the colocated op on the decode jobs' payloads, row 1
    n_enc times a prefill with a miss and never in a decode; and
    summarize_encode ->
    summarize_decode against map_summarize. No result post refused; the
    TTFT components from ``GET /v1/debug/requests``."""
    from agent_tpu_torch.agent.app import Agent
    from agent_tpu_torch.config import AgentConfig, Config
    from agent_tpu_torch.ops import load_ops, serve_infer
    from agent_tpu_torch.runtime.context import OpContext

    ops = load_ops(["serve_summarize", "serve_prefill", "serve_decode", "summarize_encode",
                    "summarize_decode", "map_summarize"])
    device = torch.device(CARD).type
    n_enc = serve_cfg().n_enc_layers
    serve_infer.reset_engines()
    report = {}

    def agent_for(ctrl, name, tasks):
        return Agent(Config(agent=AgentConfig(
            controller_url=ctrl.url, agent_name=name, tasks=tasks, max_tasks=4,
            idle_sleep_sec=0.005, pipeline_depth=2)), runtime=rt)

    bodies = agent_requests()
    with PortController(env={"CONTROLLER_SWEEP_SEC": "0"}) as ctrl:
        agent = agent_for(ctrl, "chip-smoke-serving", ("serve_summarize",))
        ctx = OpContext(runtime=rt, config=agent.config)
        req_ids = post_infer(ctrl.url, bodies)
        occupancy, stop = [], threading.Event()

        def sample():
            while not stop.is_set():
                occupancy.append(agent.m_serve_occupancy.value())
                time.sleep(0.002)

        sampler = threading.Thread(target=sample, daemon=True)
        reset_counts(fa)
        sampler.start()
        wall, _ = pipelined_drain(agent, ctrl, until=lambda: requests_done(ctrl, len(bodies)))
        stop.set()
        sampler.join(timeout=10)
        launches = fa.LAUNCH_COUNTS["flash_attention"]
        answers = infer_answers(ctrl.url, req_ids)
        batches = formed_batches(ctrl, "summarize", bodies, req_ids)
        job_ids = list(batches)
        results = [j["result"] for j in ctrl.outcome(job_ids)]
        payloads = [batches[j][0] for j in job_ids]
        engines = len(serve_infer._ENGINES)
        bad = [r for r in results if not r.get("ok") or r.get("device") != device]
        serial = [ops["serve_summarize"](dict(p), ctx) for p in payloads]
        by_req = {r["req_id"]: r for out in serial for r in out["results"]}
        answered = [dict(a["result"], req_id=a["req_id"]) for a in answers]
        ttft = sorted(a["ttft_ms"] for a in answers)
        tokens = sum(r["steps"] for out in results for r in out["results"])
        report["agent"] = {
            "requests": len(bodies), "jobs": [len(p["requests"]) for p in payloads],
            "wall_s": wall, "tok_per_s": tokens / wall, "tokens": tokens, "engines": engines,
            "ttft_ms_p50": statistics.median(ttft), "ttft_ms_p95": ttft[int(0.95 * len(ttft))],
            "ttft_components_ms": ttft_components(ctrl),
            "occupancy_gauge_max": max(occupancy or [0.0]),
            "occupancy_gauge_end": agent.m_serve_occupancy.value(),
            "occupancy_by_job": [r["occupancy"] for r in results],
            "launches": launches, "launches_want": n_enc * len(job_ids),
            "batches_as_predicted": True}  # formed_batches raises otherwise
        if bad or engines != 1 or per_request(results) != per_request(serial) \
                or per_request([{"results": answered}]) != per_request(
                    [{"results": [by_req[r] for r in req_ids]}]) \
                or launches != n_enc * len(job_ids):
            raise SystemExit(f"serving through the agent failed: {report['agent']} "
                             f"{str(bad)[:300]}")

    # bench.py's disaggregated mix: a warm round, then the measured one.
    with PortController(env={"CONTROLLER_SWEEP_SEC": "0", "SERVE_DISAGG": "1"}) as ctrl:
        prefill_pool = agent_for(ctrl, "chip-smoke-prefill", ("serve_prefill",))
        decode_pool = agent_for(ctrl, "chip-smoke-decode", ("serve_decode",))
        ctx = OpContext(runtime=rt, config=decode_pool.config)
        # The warm round through the op, as bench.py warms its prefix cache.
        for job in front_door_batches("summarize", disagg_requests(0)):
            if not ops["serve_prefill"](job, ctx)["ok"]:
                raise SystemExit("a warm serve_prefill failed")
        bodies = disagg_requests(1)

        def prefilled() -> bool:
            # Every request left its bucket AND rides a submitted job (a
            # request turns "batched" only after its jobs are submitted).
            status = ctrl.get("/v1/status")
            st = status["serving"]["requests"]
            per_op = status["counts_by_op"].get("serve_prefill", {})
            return sum(st.values()) >= len(bodies) and not st.get("queued") \
                and not per_op.get("pending") and not per_op.get("leased")

        t0 = time.perf_counter()
        req_ids = post_infer(ctrl.url, bodies)
        reset_counts(fa)
        b1_before = ctrl.b1_results()
        prefill_wall, _ = pipelined_drain(prefill_pool, ctrl, until=prefilled)
        prefill_launches = fa.LAUNCH_COUNTS["flash_attention"]
        prefill_b1 = ctrl.b1_results() - b1_before
        reset_counts(fa)
        decode_wall, _ = pipelined_drain(decode_pool, ctrl,
                                         until=lambda: requests_done(ctrl, len(bodies)))
        decode_launches = fa.LAUNCH_COUNTS["flash_attention"]
        wall = time.perf_counter() - t0
        answers = infer_answers(ctrl.url, req_ids)
        batches = formed_batches(ctrl, "summarize", bodies, req_ids)
        dec_ids = list(batches)
        pre_ids = [batches[j][1] for j in dec_ids]
        pre = [j["result"] for j in ctrl.outcome(pre_ids)]
        decoded = [j["result"] for j in ctrl.outcome(dec_ids)]
        hits = sum(r["prefix_cache"]["hits"] for r in pre)
        misses = sum(r["prefix_cache"]["misses"] for r in pre)
        want_prefill = n_enc * sum(1 for r in pre if r["prefix_cache"]["misses"])
        colocated = [ops["serve_summarize"](dict(batches[j][0]), ctx) for j in dec_ids]
        ttft = sorted(a["ttft_ms"] for a in answers)
        comps = ttft_components(ctrl)
        report["disagg"] = {
            "jobs": [[len(batches[j][0]["requests"]), batches[j][0]["bucket"]] for j in dec_ids],
            "prefill_b1": prefill_b1, "hit_rate": hits / (hits + misses),
            "hits": hits, "misses": misses, "prefill_launches": prefill_launches,
            "prefill_launches_want": want_prefill, "decode_launches": decode_launches,
            "ttft_ms_p50": statistics.median(ttft), "ttft_ms_p95": ttft[int(0.95 * len(ttft))],
            "ttft_components_ms": comps, "round_s": wall,
            "prefill_drain_s": prefill_wall, "decode_drain_s": decode_wall,
            "equal_to_colocated": per_request(decoded) == per_request(colocated)}
        if prefill_b1 != len(pre_ids) or None in pre_ids or hits / (hits + misses) < 0.5 \
                or prefill_launches != want_prefill or decode_launches \
                or not report["disagg"]["equal_to_colocated"] \
                or any(r.get("device") != device for r in pre + decoded) \
                or not all(n in comps for n in ("queue_wait", "prefill", "handoff",
                                                 "first_decode")):
            raise SystemExit(f"the disaggregated chain failed: {report['disagg']}")

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


DOOR_REQUESTS, DOOR_CLIENTS, DOOR_BYTES = 512, 8, (20, 900)
DOOR_BURST, DOOR_BURST_PENDING = 32, 8  # the 429 burst, against max_pending 8
# The loaded burst: two max_batch loads of one bucket (texts within its 64
# bytes), posted at once, so the front door flushes them "full".
DOOR_FULL, DOOR_FULL_BYTES = 32, (20, 60)


def topk_agreement(got: list, want: list, tol: float) -> dict:
    """Per request, two top-k answers (``indices``, ``scores``): every class
    both list within ``tol`` in log p and SCORE_TOL in p, and a top-1 flip
    only where the reference puts the two classes within ``tol`` in log p
    (a tie)."""
    worst_logp = worst_p = 0.0
    flips = non_ties = exact = 0
    for g, w in zip(got, want, strict=True):
        gp, wp = dict(zip(g["indices"], g["scores"])), dict(zip(w["indices"], w["scores"]))
        exact += g["indices"] == w["indices"] and g["scores"] == w["scores"]
        for c in gp.keys() & wp.keys():
            worst_p = max(worst_p, abs(gp[c] - wp[c]))
            worst_logp = max(worst_logp, abs(math.log(max(gp[c], 1e-30))
                                             - math.log(max(wp[c], 1e-30))))
        if g["indices"][0] != w["indices"][0]:
            flips += 1
            rival = wp.get(g["indices"][0], w["scores"][-1])
            non_ties += math.log(w["scores"][0]) - math.log(max(rival, 1e-30)) > tol
    return {"max_logp_diff": worst_logp, "max_score_diff": worst_p, "top1_flips": flips,
            "non_tie_flips": non_ties, "bit_equal": exact,
            "ok": worst_logp <= tol and worst_p <= SCORE_TOL and not non_ties}


def door_batches(ctrl) -> dict:
    """The batches the front door formed, from ``GET /v1/debug/requests``'
    records: job id -> (bucket, flush reason, riders)."""
    out: dict = {}
    for r in ctrl.get("/v1/debug/requests?limit=4096")["requests"]:
        key = (r["bucket"], r["flush_reason"])
        prev = out.setdefault(r["job_id"], (*key, 0))
        if prev[:2] != key:
            raise SystemExit(f"job {r['job_id']} rode buckets {prev[:2]} and {key}")
        out[r["job_id"]] = (*key, prev[2] + 1)
    return out


def front_door_phase(fa, rt, ctx, k: int) -> dict:
    """Phase 20: the front door at full width. The port's ControllerServer
    with the default ServeConfig (max_batch 16, max_wait_ms 25, the five
    length buckets), in a process of its own (``python -m
    agent_tpu_torch.controller.server``, as a deployment runs it: in this
    process its HTTP threads would share the agent's interpreter), and one
    pipelined port agent on the card offering serve_classify; DOOR_CLIENTS client threads post DOOR_REQUESTS blocking
    ``POST /v1/infer`` classify requests at BERT-base width (phase 4's
    weights, bf16, top 5), texts of 20-900 bytes from SEED, so that every
    bucket takes requests. Each answer agrees with serve_classify's direct
    answer on the same text (run here, max_batch texts a call;
    ``topk_agreement`` at phase 4's bf16 tolerance); the batches by bucket and flush reason (``GET
    /v1/debug/requests``) match ``serve_batches_total`` and ``GET
    /v1/status``'s serving block; row 1 launched n_layers times each
    serve_classify job the agent ran (its ``tasks_total``). Then DOOR_FULL
    requests of one bucket posted at once: every max_batch of them one
    "full" batch (``serve_batches_total{reason="full"}``), answered as
    serve_classify answers them directly. Then a burst of
    DOOR_BURST requests against a front door of max_pending
    DOOR_BURST_PENDING, posted before the agent polls: past the budget each
    draws HTTP 429 with retry_after_ms, and its retries, after that wait,
    succeed."""
    from agent_tpu_torch.agent.app import Agent
    from agent_tpu_torch.config import AgentConfig, Config, ServeConfig
    from agent_tpu_torch.ops import load_ops

    t_phase = time.perf_counter()
    smi = nvidia_smi_line() if torch.device(CARD).type == "cuda" else "not a card"
    serve = load_ops(["serve_classify"])["serve_classify"]
    n_layers, cfg = BERT_BASE["n_layers"], ServeConfig()
    rng = random.Random(SEED + 20)
    params = {"model_config": BERT_BASE, "topk": k}
    bodies = [{"op": "classify", "text": t, "params": params}
              for t in random_texts(rng, DOOR_REQUESTS, *DOOR_BYTES)]

    def agent_for(ctrl, name):
        return Agent(Config(agent=AgentConfig(
            controller_url=ctrl.url, agent_name=name, tasks=("serve_classify",),
            idle_sleep_sec=0.005, pipeline_depth=2)), runtime=rt)

    def direct(requests: list) -> list:
        """serve_classify run directly on this thread over ``requests``'
        texts, max_batch at a time -> one answer a request, in order."""
        out = []
        for s in range(0, len(requests), cfg.max_batch):
            chunk = [{"req_id": str(i), "text": b["text"]}
                     for i, b in enumerate(requests[s:s + cfg.max_batch])]
            out += serve({"requests": chunk, **params}, ctx)["results"]
        return out

    with PortController(env={}) as ctrl:
        agent = agent_for(ctrl, "chip-smoke-door")
        answers, latency = [None] * len(bodies), [None] * len(bodies)

        def client(c: int) -> None:
            for i in range(c, len(bodies), DOOR_CLIENTS):
                t0 = time.perf_counter()
                status, answers[i] = http_json(f"{ctrl.url}/v1/infer", bodies[i],
                                               timeout=DRAIN_TIMEOUT_S)
                latency[i] = (time.perf_counter() - t0) * 1e3
                if status != 200:
                    answers[i] = {"state": f"HTTP {status}", "answer": answers[i]}

        clients = [threading.Thread(target=client, args=(c,), daemon=True)
                   for c in range(DOOR_CLIENTS)]
        gc.collect()
        reset_counts(fa)
        t0 = time.perf_counter()
        for t in clients:
            t.start()
        wall, _ = pipelined_drain(agent, ctrl, until=lambda: not any(
            t.is_alive() for t in clients))
        launches = fa.LAUNCH_COUNTS["flash_attention"]
        tasks = agent.m_tasks.value(op="serve_classify", status="succeeded")
        bad = [a for a in answers if not a or a.get("state") != "done"]
        if bad:
            raise SystemExit(f"{len(bad)} of {len(bodies)} requests failed: {str(bad[:2])[:600]}")
        agree = topk_agreement([a["result"] for a in answers], direct(bodies),
                               LOGP_TOL["bfloat16"])
        batches = door_batches(ctrl)
        by_reason = collections.Counter(reason for _, reason, _ in batches.values())
        by_bucket = collections.Counter(bucket for bucket, _, _ in batches.values())
        status = ctrl.get("/v1/status")["serving"]
        metric = {r: ctrl.series("serve_batches_total", op="classify", reason=r)
                  for r in ("full", "deadline")}
        comps = ttft_components(ctrl)
        job_ids = {a["job_id"] for a in answers}
        jobs_ok = ctrl.outcome(sorted(job_ids))
        lat = sorted(latency)
        report = {
            "phase": "front_door", "nvidia_smi": smi, "config": BERT_BASE,
            "serve_config": {"max_batch": cfg.max_batch, "max_wait_ms": cfg.max_wait_ms,
                             "len_buckets": list(cfg.len_buckets)},
            "requests": len(bodies), "clients": DOOR_CLIENTS, "wall_s": wall,
            "requests_per_s": len(bodies) / wall,
            "latency_ms": {"p50": statistics.median(lat), "p99": lat[int(0.99 * len(lat))],
                           "max": lat[-1]},
            "ttft_ms": {"p50": statistics.median(sorted(a["ttft_ms"] for a in answers))},
            "ttft_components_ms": comps,
            "batches": len(batches), "batches_by_reason": dict(by_reason),
            "batches_by_bucket": {str(b): n for b, n in sorted(by_bucket.items())},
            "riders_per_batch": {"mean": len(bodies) / len(batches),
                                 "max": max(n for _, _, n in batches.values())},
            "serve_batches_total": metric, "status_requests": status["requests"],
            "agent_tasks": tasks, "launches": launches, "launches_want": n_layers * tasks,
            "agreement": agree}
        if not agree["ok"] or launches != n_layers * tasks or tasks != len(batches) \
                or len(job_ids) != len(batches) or len(jobs_ok) != len(batches) \
                or {r: by_reason.get(r, 0) for r in metric} != metric \
                or status["requests"].get("done") != len(bodies) or status["bucketed"] \
                or set(by_bucket) != set(cfg.len_buckets):
            raise SystemExit(f"the front door failed: {report}")

        # The loaded burst, on the same front door once the clients are
        # done: DOOR_FULL requests of one bucket posted before the agent
        # polls again. Each max_batch of them flushes as a "full" batch (the
        # blocking clients above, 8 against max_batch 16, flush at the
        # deadline), one serve_classify job each.
        loaded = [{"op": "classify", "text": t, "params": params}
                  for t in random_texts(rng, DOOR_FULL, *DOOR_FULL_BYTES)]
        posted = [http_json(f"{ctrl.url}/v1/infer", dict(b, wait=False)) for b in loaded]
        reset_counts(fa)
        full_wall, _ = pipelined_drain(agent, ctrl, until=lambda: requests_done(
            ctrl, len(bodies) + len(loaded)))
        full_answers = infer_answers(ctrl.url, [a["req_id"] for _, a in posted])
        full_batches = {j: b for j, b in door_batches(ctrl).items()
                        if j in {a["job_id"] for a in full_answers}}
        full_metric = ctrl.series("serve_batches_total", op="classify", reason="full")
        want_full = DOOR_FULL // cfg.max_batch
        report["loaded_burst"] = {
            "requests": len(loaded), "posted_200": sum(st == 200 for st, _ in posted),
            "batches": sorted(full_batches.values()), "serve_batches_full": full_metric,
            "launches": fa.LAUNCH_COUNTS["flash_attention"],
            "agent_tasks": agent.m_tasks.value(op="serve_classify", status="succeeded"),
            "wall_s": full_wall, "agreement": topk_agreement(
                [a["result"] for a in full_answers], direct(loaded), LOGP_TOL["bfloat16"])}
        if report["loaded_burst"]["posted_200"] != len(loaded) \
                or sorted(full_batches.values()) != [(cfg.len_buckets[0], "full",
                                                      cfg.max_batch)] * want_full \
                or full_metric - metric["full"] != want_full \
                or report["loaded_burst"]["agent_tasks"] != tasks + want_full \
                or report["loaded_burst"]["launches"] != n_layers * want_full \
                or not report["loaded_burst"]["agreement"]["ok"]:
            raise SystemExit(f"the loaded burst failed: {report['loaded_burst']}")

    # The 429 burst: a front door of max_pending DOOR_BURST_PENDING, every
    # request posted before the agent's first poll.
    burst = [{"op": "classify", "text": t, "params": params}
             for t in random_texts(rng, DOOR_BURST, *DOOR_BYTES)]
    with PortController(env={"SERVE_MAX_PENDING": str(DOOR_BURST_PENDING)}) as ctrl:
        agent = agent_for(ctrl, "chip-smoke-door-burst")
        first = [http_json(f"{ctrl.url}/v1/infer", dict(b, wait=False)) for b in burst]
        refused = [i for i, (st, _) in enumerate(first) if st == 429]
        waits = [first[i][1].get("retry_after_ms") for i in refused]
        req_ids = {i: a["req_id"] for i, (st, a) in enumerate(first) if st == 200}
        retries = collections.Counter()

        def retry() -> None:
            for i in refused:
                wait_ms = first[i][1]["retry_after_ms"]
                while True:
                    time.sleep(wait_ms / 1e3)
                    st, a = http_json(f"{ctrl.url}/v1/infer", dict(burst[i], wait=False))
                    retries[i] += 1
                    if st == 200:
                        req_ids[i] = a["req_id"]
                        break
                    if st != 429 or retries[i] > 1000:
                        return
                    wait_ms = a["retry_after_ms"]

        retrier = threading.Thread(target=retry, daemon=True)
        retrier.start()
        burst_wall, _ = pipelined_drain(agent, ctrl, until=lambda: not retrier.is_alive()
                                        and requests_done(ctrl, len(burst)))
        answers = infer_answers(ctrl.url, [req_ids[i] for i in range(len(burst))])
        burst_agree = topk_agreement([a["result"] for a in answers], direct(burst),
                                     LOGP_TOL["bfloat16"])
        rejected = ctrl.get("/v1/status")["serving"]["rejected"]
    report["burst"] = {"requests": len(burst), "max_pending": DOOR_BURST_PENDING,
                       "refused_429": len(refused), "retry_after_ms": sorted(set(waits)),
                       "retries": sum(retries.values()), "rejected_counter": rejected,
                       "wall_s": burst_wall, "agreement": burst_agree}
    report["seconds"] = time.perf_counter() - t_phase
    emit(report)
    if not refused or not all(isinstance(w, int) and w > 0 for w in waits) \
            or len(req_ids) != len(burst) or not burst_agree["ok"] \
            or rejected < len(refused):
        raise SystemExit(f"the 429 burst failed: {report['burst']}")
    return report


def mix_payload(path: str, start_row: int = 0, shard: int = 0) -> dict:
    """Phase 24's bulk shard of ``path`` at ``start_row``, ``shard`` rows
    (MIX_SHARD by default), as check_serving_pipeline submits it."""
    from agent_tpu_torch.scripts import check_serving_pipeline as csp

    return dict(csp.bulk_payload(BERT_BASE), source_uri=path, start_row=start_row,
                shard_size=shard or MIX_SHARD)


def mix_want(job: dict, chunks: dict, n_layers: int, n_enc: int) -> int:
    """Row 1's launches a job of phase 24 makes: n_layers a dispatch chunk
    of a bulk shard, n_layers a serve_classify batch, n_enc a prefill with
    a prefix-cache miss (serve_summarize, serve_prefill), none in a
    decode."""
    op = job["op"]
    if op == "map_classify_tpu":
        return n_layers * chunks[job["start_row"]]
    if op == "serve_classify":
        return n_layers
    if op in ("serve_summarize", "serve_prefill"):
        return n_enc if job["prefix_misses"] else 0
    return 0


def serving_mix_phase(fa, rt, smi: str, shard: int = 0) -> dict:
    """Phase 24: ``agent_tpu_torch.scripts.check_serving_pipeline``'s three
    legs in this process at full width: classify and the bulk drain at
    BERT_BASE on phase 4's weights (bf16, on ``rt``), summarize with phase
    13's seq2seq (SERVE_MODEL), MIX_ROWS rows of phase 10's CSV shape in
    ``shard``-row shards (MIX_SHARD by default; MIX_DISAGG_ROWS of them
    beside the split leg). The script's six bars, and: every job of every
    leg on the card with no fallback; row 1 launched as ``mix_want`` says,
    job by job, in each leg's window and in all; no result post refused;
    the last answer before the last bulk result (the script starts the load
    once the agent holds its first bulk shard, so the first request comes
    after the first bulk lease by construction)."""
    from agent_tpu_torch.ops import load_ops
    from agent_tpu_torch.scripts import check_serving_pipeline as csp

    t_phase = time.perf_counter()
    classify = load_ops(["map_classify_tpu"])["map_classify_tpu"]
    n_layers, n_enc = BERT_BASE["n_layers"], serve_cfg().n_enc_layers
    device = torch.device(CARD).type
    shard = shard or MIX_SHARD
    report: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mix.csv")
        write_drain_csv(path, MIX_ROWS)
        reset_counts(fa)
        try:
            csp.main(BERT_BASE, SERVE_MODEL, MIX_ROWS, shard, csv_path=path,
                     disagg_rows=MIX_DISAGG_ROWS, runtime=rt, report=report)
        except csp.BarFailed as exc:
            raise SystemExit(f"phase 24 failed a serving bar: {exc}") from exc
        launches = fa.LAUNCH_COUNTS["flash_attention"]
        t_stage = time.perf_counter()
        payloads = [mix_payload(path, s, min(shard, MIX_ROWS - s))
                    for s in range(0, MIX_ROWS, shard)]
        chunks = {p["start_row"]: len(classify.stage(p)[1]["chunks"]) for p in payloads}
        stage_s = time.perf_counter() - t_stage
    serving, ref = report["serving"], report["reference"]
    stacks = {"reference": ref, "serving": serving, "colocated": report["disagg"]["colocated"],
              "split": report["disagg"]["split"]}
    jobs = [j for st in stacks.values() for j in st["jobs"]]
    by_stack = {name: {"launches": st["launches"],
                       "launches_want": sum(mix_want(j, chunks, n_layers, n_enc)
                                            for j in st["jobs"]),
                       "jobs_by_op": dict(collections.Counter(j["op"] for j in st["jobs"])),
                       "result_outcomes": st["result_outcomes"]}
                for name, st in stacks.items()}
    for name in ("serving", "split"):  # one agent, two: the ops each agent ran
        agents = collections.defaultdict(set)
        for j in stacks[name]["jobs"]:
            agents[j["agent"]].add(j["op"])
        by_stack[name]["by_agent"] = {a: {"ops": sorted(ops)} for a, ops in sorted(agents.items())}
    split = stacks["split"]
    out = {
        "phase": "serving_mix", "config": {"classify": BERT_BASE, "summarize": SERVE_MODEL},
        "rows": MIX_ROWS, "shard": shard, "disagg_rows": MIX_DISAGG_ROWS,
        "requests": serving["requests"], "max_occupancy": serving["max_occupancy"],
        "slo_requests_seen": serving["slo_requests_seen"],
        "ttft_ms": {name: {"p50": stacks[name]["ttft_ms_p50"],
                           "p99": stacks[name]["ttft_ms_p99"]}
                    for name in ("serving", "colocated", "split")},
        "requests_per_s": {name: stacks[name]["requests_per_s"]
                           for name in ("serving", "colocated", "split")},
        "drain_rows_per_s": {"without_serving": ref["bulk_rows_per_s"],
                             "beside_serving": serving["bulk_rows_per_s"],
                             "beside_the_split": split["bulk_rows_per_s"]},
        "overlap_s": serving["overlap_s"],
        "window_s": {k: serving[k] - serving["first_bulk_lease_wall"] for k in (
            "first_request_wall", "last_answer_wall", "last_bulk_result_wall")},
        "prefix_hits_split": split["prefix_hits"], "split_ops": split["ops"],
        "devices": sorted({str(j["device"]) for j in jobs}),
        "fallbacks": sum(j["fallback"] for j in jobs),
        "refused_result_posts": {n: st["refused_result_posts"] for n, st in stacks.items()},
        "launches": launches,
        "launches_want": sum(b["launches_want"] for b in by_stack.values()),
        "by_stack": by_stack, "chunks_stage_s": stage_s, "nvidia_smi": smi,
        "seconds": time.perf_counter() - t_phase}
    emit(out)
    if out["devices"] != [device] or out["fallbacks"] \
            or any(b["launches"] != b["launches_want"] for b in by_stack.values()) \
            or launches != out["launches_want"] or any(out["refused_result_posts"].values()) \
            or not serving["last_answer_wall"] < serving["last_bulk_result_wall"]:
        raise SystemExit(f"phase 24 failed: {str(out)[:4000]}")
    return out


def mix_sizes_phase(fa, classify, warm: dict, shards: list, smi: str) -> None:
    """``--mix-shard``: phase 3's row-1 check at phase 24's shapes (a first
    bulk shard of each size, the serving legs' batches), then phase 24 on
    BERT_BASE's seeded weights once for each of ``shards`` (bulk rows a
    shard), in that order; fails after the last run if any run failed."""
    from agent_tpu_torch.ops import load_ops
    from agent_tpu_torch.runtime.context import OpContext
    from agent_tpu_torch.runtime.runtime import TorchRuntime

    serve = load_ops(["serve_summarize"])["serve_summarize"]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "drain.csv")
        write_drain_csv(path, max(shards))
        check_kernels(fa, staged_cases(classify, [(f"mix_shard{n}", mix_payload(path, 0, n), n)
                                                  for n in sorted(set(shards))])
                      + serving_mix_cases(classify, serve))
    rt = TorchRuntime()
    place_seeded(rt, {"none": BERT_BASE}, seeded_dense())
    classify(dict(warm), OpContext(runtime=rt))  # finds the weights resident
    failed = []
    for n in shards:
        try:
            serving_mix_phase(fa, rt, smi, n)
        except SystemExit as exc:
            failed.append({"shard": n, "error": str(exc)[:500]})
    if failed:
        raise SystemExit(f"phase 24 failed: {failed}")


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
    # One profiled stretch, greedy: the beam search's profiled pass (about
    # 23 s on the H100) is left out to keep the whole run's time; the beam
    # leg decodes the stream's first quarter, the 64-slot leg its first
    # 2 × 64 requests.
    wide = min(SERVE_REQUESTS, SERVE_WIDE_LEG_PER_SLOT * SERVE_WIDE_SLOTS)
    for beams, slots, profile, n in ((1, SERVE_SLOTS, True,
                                      int(SERVE_REQUESTS * SERVE_GREEDY_LEG_FRAC)),
                                     (SERVE_BEAMS, SERVE_SLOTS, False,
                                      int(SERVE_REQUESTS * SERVE_BEAM_LEG_FRAC)),
                                     (1, SERVE_WIDE_SLOTS, False, wide)):
        t1 = time.perf_counter()
        legs.append(engine_vs_static(model, attn_fn, stream, enc_all, beams, slots, profile, n))
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


def seeded_dense():
    """The classify op's default encoder at BERT_BASE as one f32 host draw,
    kept in SEEDED and reused (phases 4, 10, 14, 16, 18 (c)): the op would draw
    it again at each build, about 16 s on the card's host."""
    from agent_tpu_torch.models import encoder
    from agent_tpu_torch.ops import map_classify_tpu as classify_op

    if SEEDED.get("dense_config") != BERT_BASE:
        SEEDED["dense"] = encoder.init_params(encoder.EncoderConfig(**BERT_BASE),
                                              classify_op.DEFAULT_MODEL_ID)
        SEEDED["dense_config"] = dict(BERT_BASE)
    return SEEDED["dense"]


def seeded_moe():
    """The classify op's default encoder at BERT_BASE with MOE_EXPERTS
    experts as one f32 host draw (453M normals), kept in SEEDED for phases
    14 and 16. ``main`` runs it on a thread of its own beside the kernels'
    build, whose nvcc processes leave most cores idle."""
    from agent_tpu_torch.models import encoder
    from agent_tpu_torch.ops import map_classify_tpu as classify_op

    conf = dict(BERT_BASE, moe_experts=MOE_EXPERTS)
    if SEEDED.get("moe_config") != conf:
        t0 = time.perf_counter()
        SEEDED["moe"] = encoder.init_params(encoder.EncoderConfig(**conf),
                                            classify_op.DEFAULT_MODEL_ID)
        SEEDED["moe_config"] = conf
        SEEDED["moe_draw_s"] = time.perf_counter() - t0
    return SEEDED["moe"]


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
    place_seeded(rt, configs, seeded_dense())
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
    flat = seeded_moe()  # drawn beside the kernels' build; phase 16 places it too
    weights_draw_s = SEEDED["moe_draw_s"]
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
    padded rows, the first with no real key (it attends as the reference's
    dense path does, and its tokens compete for capacity): every MoE
    layer's routes (``MoeFFN.routes`` of the tokens ``dispatch`` got; the
    share routed alike at least MOE_ROUTE_AGREEMENT), the logits, the Switch
    aux loss, the training loss and every leaf's gradient of one step
    (relative L2), then the losses of MOE_F32_STEPS AdamW steps, each within
    MOE_F32_REL_TOL. The card runs the training kernels (rows 4-6, f32), the
    CPU their plain version; both run ``moe.Route``'s backward."""
    from agent_tpu_torch.models import encoder, moe, train
    from agent_tpu_torch.runtime.runtime import TorchRuntime

    cfg = encoder.EncoderConfig(**MOE_F32)
    flat = encoder.init_params(cfg, "moe-exact")
    rng = np.random.default_rng(SEED + 24)
    B, L = MOE_F32_ROWS, cfg.max_len
    lengths = rng.integers(L // 4, L + 1, B)
    lengths[0] = 0  # a row with no real key
    mask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.int32)
    ids = rng.integers(4, cfg.vocab_size, (B, L)).astype(np.int32) * mask
    labels = rng.integers(0, cfg.n_classes, B).astype(np.int32)
    sides = {}
    for side, where, run_rt in (("card", CARD, rt), ("cpu", "cpu", TorchRuntime(device="cpu"))):
        attn_fn = run_rt.train_attention_fn()
        model = encoder.from_jax_params(flat, cfg, device=where, trainable=True)
        batch = [torch.from_numpy(a).to(where) for a in (ids, mask, labels)]
        seen, dispatch = [], moe.MoeFFN.dispatch

        def spy(self, x, group_size, experts, seen=seen, dispatch=dispatch):
            seen.append(self.routes(x.detach(), group_size))
            return dispatch(self, x, group_size, experts)

        moe.MoeFFN.dispatch = spy
        try:
            with torch.no_grad():
                model(batch[0], batch[1], run_rt.attention_fn())
        finally:
            moe.MoeFFN.dispatch = dispatch
        with torch.enable_grad():
            logits, aux = model(batch[0], batch[1], attn_fn, with_aux=True)
            loss = train.cross_entropy_loss(model, *batch, attn_fn=attn_fn)
            loss.backward()
        grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()
                 if p.grad is not None}
        init, step = train.make_train_step(cfg, train.adamw(1e-2), attn_fn=attn_fn)
        opt = init(model)
        losses = [float(step(model, opt, *batch)[2]) for _ in range(MOE_F32_STEPS)]
        sides[side] = {"routes": [(e.cpu(), k.cpu()) for e, k in seen],
                       "logits": logits.detach().cpu(), "aux": aux.detach().cpu(),
                       "loss": loss.detach().cpu(), "grads": grads,
                       "losses": torch.tensor(losses)}
    card, cpu = sides["card"], sides["cpu"]

    def rel(a, b) -> float:
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    if set(card["grads"]) != set(cpu["grads"]):
        raise SystemExit(f"MoE gradients on different leaves: "
                         f"{sorted(set(card['grads']) ^ set(cpu['grads']))}")
    alike = [float(((ec == eu) & (kc == ku)).float().mean())
             for (ec, kc), (eu, ku) in zip(card["routes"], cpu["routes"], strict=True)]
    report = {"rows": B, "seq_len": L, "keyless_rows": int((lengths == 0).sum()),
              "tolerance": MOE_F32_REL_TOL, "share_routed_alike_by_layer": alike,
              **{k: rel(card[k], cpu[k]) for k in ("logits", "aux", "loss", "losses")},
              "grads_max_rel_l2": max(rel(card["grads"][k], cpu["grads"][k])
                                      for k in cpu["grads"]),
              "router_grad_rel_l2": max(rel(card["grads"][k], cpu["grads"][k])
                                        for k in cpu["grads"] if ".router." in k),
              "aux_card_cpu": [float(card["aux"]), float(cpu["aux"])],
              "losses_card": card["losses"].tolist(), "losses_cpu": cpu["losses"].tolist()}
    worst = max(v for k, v in report.items() if k in (
        "logits", "aux", "loss", "losses", "grads_max_rel_l2"))
    if not worst <= MOE_F32_REL_TOL or len(alike) != cfg.n_layers \
            or min(alike) < MOE_ROUTE_AGREEMENT:
        raise SystemExit(f"the f32 MoE on the card disagrees with the CPU: {report}")
    return report


def moe_routes_bf16() -> dict:
    """Phase 14, the bf16 MoE's routes on the card against the CPU: one MoE
    layer at BERT-base width (MOE_EXPERTS experts, capacity 1.25, groups of
    512 tokens) from seeded weights, MOE_ROUTE_TOKENS seeded bf16 tokens;
    each token's expert and whether it keeps its capacity slot
    (``MoeFFN.routes``, the routing ``dispatch`` decides) on each device.
    Fails when the share routed alike falls below MOE_ROUTE_AGREEMENT."""
    from agent_tpu_torch.models import layers, moe, prng

    cfg = moe.MoeConfig(d_model=BERT_BASE["d_model"], d_ff=BERT_BASE["d_ff"],
                        n_experts=MOE_EXPERTS, capacity_factor=1.25, dtype="bfloat16")
    flat = layers.flatten(moe.init_moe_ffn(prng.PRNGKey(SEED + 25), cfg))
    x = torch.from_numpy(np.random.default_rng(SEED + 25).standard_normal(
        (MOE_ROUTE_TOKENS, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    routes = {}
    for where in (CARD, "cpu"):
        m = moe.MoeFFN(cfg, device=where)
        m.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in flat.items()})
        with torch.no_grad():
            expert, kept = m.routes(x.to(where), moe.MOE_GROUP_TOKENS)
        routes[where] = (expert.cpu(), kept.cpu())
    (e_card, k_card), (e_cpu, k_cpu) = routes[CARD], routes["cpu"]
    alike = (e_card == e_cpu) & (k_card == k_cpu)
    report = {"tokens": MOE_ROUTE_TOKENS, "experts": MOE_EXPERTS,
              "share_routed_alike": float(alike.float().mean()),
              "expert_differs": int((e_card != e_cpu).sum()),
              "keep_differs": int((k_card != k_cpu).sum()),
              "dropped_cpu": int((~k_cpu).sum()), "threshold": MOE_ROUTE_AGREEMENT}
    if not report["share_routed_alike"] >= MOE_ROUTE_AGREEMENT:
        raise SystemExit(f"the bf16 MoE routes on the card differ from the CPU's: {report}")
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
    timed = interleaved({m: (lambda m=m: request(m)) for m in launches}, QUANT_REPS,
                        lambda m, out: None)
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

    timed = interleaved({m: (lambda m=m: request(m)) for m in launches}, QUANT_REPS,
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
    timed = interleaved({m: (lambda m=m: engine_pass(m, QUANT_ENGINE_REQUESTS)) for m in sides},
                        QUANT_REPS, lambda m, out: None)
    n_tok = timed["none"][1]
    same = sum(a == b for a, b in zip(tokens["w8a16"], tokens["none"]))
    report = {"requests": QUANT_ENGINE_REQUESTS, "slots": SERVE_SLOTS, "num_beams": 1,
              "tokens": n_tok,
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
            ("moe_routes_bf16", moe_routes_bf16),
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
MESH_REPS = 1
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
DEC_SERVE_F32_REQUESTS = 32
DEC_SERVE_REQUESTS = 16  # of phase 13's 240
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
    (row 1 4 × 2 times), then its first DEC_SERVE_REQUESTS decoded by a
    paged engine of 8 slots on the mesh in bf16 (tok/s beside phase 13's
    whole stream's), each shard's pool half the
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
    tickets = engine_pass(engine, enc_all, min(DEC_SERVE_REQUESTS, len(limits)))
    wall = time.perf_counter() - t0
    tokens = sum(t.steps for t in tickets)
    whole_pool = resident_bytes(seq2seq.make_paged_cache_factory(cfg, block_size=16, device=CARD)(
        SERVE_SLOTS)["layers"])
    report = {"bf16_tp2": {"requests": len(tickets), "tokens": tokens, "wall_s": wall,
                           "tok_per_s": tokens / wall,
                           "phase13_one_device_tok_per_s": stream_tok_s,
                           "vs_one_device": tokens / wall / stream_tok_s},
              "pool_bytes": {"shards": engine_pool_bytes(engine._dyn["caches"]),
                             "one_device": whole_pool}}
    del engine

    f32 = seq2seq.Seq2SeqConfig(**dict(SERVE_MODEL, dtype="float32"))
    n = DEC_SERVE_F32_REQUESTS
    toks, decode_s = {}, 0.0
    for name, rt, n_launch in (("tp2", tp2, 2), ("one", one, 1)):
        m = op._get_model(rt, op.DEFAULT_MODEL_ID, f32, "seq2seq")
        with torch.inference_mode():
            enc = launch_delta(fa, lambda: seq2seq.encode(m, ids_t[:n], mask_t[:n],
                                                          rt.attention_fn()).cpu().numpy(),
                               {"flash_attention": n_launch * f32.n_enc_layers})
        t0 = time.perf_counter()
        toks[name] = [t.tokens for t in engine_pass(new_engine(m, SERVE_SLOTS, 1), enc, n)]
        decode_s += time.perf_counter() - t0
    report["f32_first_requests_equal"] = all(np.array_equal(a, b)
                                             for a, b in zip(toks["tp2"], toks["one"]))
    report["f32_requests"], report["f32_decode_s"] = n, decode_s

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


# ---- phase 23: the north-star drain's entry point ----

# bench.py's drain shape again (DRAIN_ROWS), through both ops: 8 shards of
# 8,192 rows each (drain_at_scale's CLASSIFY_SHARD and SUMMARIZE_SHARD).
AT_SCALE_ROWS = DRAIN_ROWS
AT_SCALE_TIMEOUT_S = 600
AT_SCALE_AGENT = "drain-at-scale"  # drain_at_scale's agent name


def drain_at_scale_phase(classify, summarize, rt, bert_ckpt: str, smi: str) -> dict:
    """Phase 23 (see the module docstring): the drain's entry point in a
    process of its own on phase 11's checkpoint, its sinks and report
    checked, each op's first shard against the op run here."""
    from agent_tpu_torch.runtime.context import OpContext
    from agent_tpu_torch.scripts import drain_at_scale as das

    root = os.path.dirname(os.path.abspath(__file__))
    torch.cuda.empty_cache()  # leave the card's memory to the other process
    with tempfile.TemporaryDirectory() as tmp:
        workdir, report_path = os.path.join(tmp, "work"), os.path.join(tmp, "report.json")
        env = dict(os.environ, PYTHONPATH=root, TPU_MODEL_PATH=bert_ckpt)
        for name in ("TASKS", "BART_MODEL"):
            env.pop(name, None)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "agent_tpu_torch.scripts.drain_at_scale",
             "--rows", str(AT_SCALE_ROWS), "--workdir", workdir, "--report", report_path,
             "--progress-sec", "30"], cwd=root, env=env, capture_output=True, text=True,
            timeout=AT_SCALE_TIMEOUT_S)
        process_s = time.perf_counter() - t0
        report = None
        if os.path.exists(report_path):
            with open(report_path) as fh:
                report = json.load(fh)
        shard_files = {op: f"{op}_rows_{0:012d}.jsonl" for op in das.DRAIN_OPS}
        sinks = {op: os.path.join(workdir, "classify_out" if op == "map_classify_tpu"
                                  else "summarize_out") for op in das.DRAIN_OPS}
        lines = {op: sum(file_bytes(os.path.join(d, name)).count(b"\n")
                         for name in (os.listdir(d) if os.path.isdir(d) else [])
                         if name.endswith(".jsonl")) for op, d in sinks.items()}
        # Each op's first shard here, with the drain's payload, into sinks
        # of this process's own.
        t0 = time.perf_counter()
        here = das.op_payloads(os.path.join(tmp, "here"), "none")
        csv = os.path.join(workdir, f"drain_{AT_SCALE_ROWS}.csv")
        ctx = OpContext(runtime=rt)
        equal = {}
        for op, fn, extra in (("map_classify_tpu", classify, {"model_path": bert_ckpt}),
                              ("map_summarize", summarize, {})):
            shard = das.shard_sizes()[op]
            out = fn(dict(here[op], source_uri=csv, start_row=0, shard_size=shard, **extra), ctx)
            mine = os.path.join(here[op]["output_uri"], shard_files[op])
            theirs = os.path.join(sinks[op], shard_files[op])
            equal[op] = (bool(out.get("ok")) and os.path.exists(theirs)
                         and file_bytes(mine) == file_bytes(theirs))
        here_s = time.perf_counter() - t0
    rep = report or {}
    launches = (rep.get("kernel_launches") or {}).get(AT_SCALE_AGENT, {}).get("flash_attention",
                                                                             0)
    run = {"phase": "drain_at_scale", "rows": AT_SCALE_ROWS, "returncode": proc.returncode,
           "process_s": process_s, "first_shards_here_s": here_s,
           "wall_s": rep.get("wall_s"), "total_rows_per_sec": rep.get("total_rows_per_sec"),
           "rows_per_span_sec": {op: (rep.get(block) or {}).get("rows_per_span_sec")
                                 for op, block in (("map_classify_tpu", "classify"),
                                                   ("map_summarize", "summarize"))},
           "rows_written": {op: (rep.get(block) or {}).get("rows_written")
                            for op, block in (("map_classify_tpu", "classify"),
                                              ("map_summarize", "summarize"))},
           "sink_lines": lines, "non_ok_results": rep.get("non_ok_results"),
           "counts": rep.get("counts"), "platform": rep.get("platform"),
           "n_chips": rep.get("n_chips"), "card": rep.get("card"),
           "first_shard_equal_here": equal, "row1_launches": launches,
           "slowest_trace": rep.get("slowest_trace"),
           "stage_execute_overlap": rep.get("stage_execute_overlap"), "nvidia_smi": smi}
    gates = {"exit_0": proc.returncode == 0 and report is not None,
             "no_non_ok_result": rep.get("non_ok_results") == 0,
             "on_the_card": rep.get("platform") == torch.device(CARD).type,
             "every_row": all(run["rows_written"][op] == AT_SCALE_ROWS
                              and lines[op] == AT_SCALE_ROWS for op in das.DRAIN_OPS),
             "first_shards_equal": all(equal.values()),
             "row1_launches": launches > 0}
    run["failed"] = [name for name, ok in gates.items() if not ok]
    emit(run)
    print(f"drain_at_scale: {run['total_rows_per_sec']} rows/s in all, rows/span-s "
          f"{run['rows_per_span_sec']}, {smi}", flush=True)
    if run["failed"]:
        raise SystemExit(f"phase 23 failed: {run}\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return run


def file_bytes(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


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
    controller has every result the leader gets SIGTERM (a clean exit, whose
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
                raise SystemExit(f"the processes did not drain the controller: {tails}")
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
    """The leader's ``stage`` span of a job (``GET /v1/trace/{job}``):
    resolving and broadcasting the task before its op ran."""
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
    with PortController() as ctrl:
        ids = [ctrl.submit("echo", {"i": i}) for i in range(PROC_ECHOS)]
        ids.append(ctrl.submit("map_tokenize", {"text": "several processes, one lease loop"}))
        ids.append(ctrl.submit("risk_accumulate", {"values": values}))
        run = leader_followers(n, ctrl, PROC_TASKS, tmp, cards)
        jobs = ctrl.outcome(ids)
        stage = {f"{job['op']}_{j}": stage_ms(ctrl, j) for j, job in zip(ids, jobs)}
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
    with PortController() as ctrl:
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
    got = obs_values(ctrl.agent_obs(name), "kernel_launches", kernel="flash_attention")
    return got[0] if got else 0.0


def fleet_phase(n: int, path: str, serial: list, serial_rows_per_s: float,
                drain_rows_per_s: float, tmp: str) -> dict:
    """Phase 18 (b): ``n`` device-pinned members (``spawn_fleet``, one card
    each) warmed on one BERT-base request, drain phase 10's 65,536-row CSV
    after ``wait_for_agents`` (``GET /v1/status``'s agents); the results
    equal the serial op's, and every member's row-1 counter moved over the
    drain. With several members each holds one task at a time (MAX_TASKS
    1 and the serial loop, PIPELINE_DEPTH 0), so that they share the
    shards."""
    from agent_tpu_torch.agent import fleet
    from agent_tpu_torch.agent.fleet_cli import http_agents

    _, _, shards, _ = drain_payloads(path)
    warm = os.path.join(tmp, "warm.json")
    with open(warm, "w") as fh:
        json.dump([{"op": "map_classify_tpu", "payload": {
            "texts": random_texts(random.Random(SEED + 18), 8, 20, 200),
            "model_config": BERT_BASE, "topk": 5, "allow_fallback": False}}], fh)
    share = {"MAX_TASKS": "1", "PIPELINE_DEPTH": "0"} if n > 1 else {}
    with PortController() as ctrl:
        t0 = time.monotonic()
        handle = fleet.spawn_fleet(n, platform=FLEET_PLATFORM, controller_url=ctrl.url,
                                   tasks=FLEET_TASKS, warm_file=warm,
                                   extra_env={"IDLE_SLEEP_SEC": "0.01", **share},
                                   log_dir=os.path.join(tmp, "fleet"))
        try:
            if not fleet.wait_for_agents(lambda: http_agents(ctrl.url), handle.names,
                                         timeout=FLEET_DEADLINE_S, fleet=handle):
                raise SystemExit(f"the fleet did not come up: {handle.poll_failures()}")
            ready_s = time.monotonic() - t0
            before = {m: fleet_launches(ctrl, m) for m in handle.names}
            b1_before = ctrl.b1_results()
            t1 = time.monotonic()
            ids = [ctrl.submit("map_classify_tpu", p) for p in shards]
            while not ctrl.drained():
                if time.monotonic() - t1 > FLEET_DEADLINE_S or handle.poll_failures():
                    raise SystemExit(f"the fleet did not drain: {handle.poll_failures()}")
                time.sleep(0.005)
            wall = time.monotonic() - t1
            jobs = ctrl.outcome(ids)
            b1 = ctrl.b1_results() - b1_before
            t_end = time.time()
            seen = lambda m: (ctrl.c.agent_metrics.get(m) or {}).get(  # noqa: E731
                "last_seen_wall", 0.0)
            while any(seen(m) < t_end + 0.05 for m in handle.names):
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
            or b1 != len(jobs):
        raise SystemExit(f"phase 18 (b) failed: {report}, {b1} results over b1")
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


# ---- phases 21 and 22: the partitioned control plane, the elastic fleet ----

# Phase 21: partition controllers p0 and p1, each `python -m
# agent_tpu_torch.controller.server` with its own segmented journal, p0's hot
# standby and the router, each in a process of its own on 127.0.0.1; phase
# 10's CSV under two source names, one homed on each partition, drained by
# one pipelined agent process with the partition map. p0's primary is
# SIGKILLed once it has accepted PART_KILL_AFTER results.
PART_NAMES = ("p0", "p1")
PART_KILL_AFTER = 2
PART_LABELS = {"smoke_phase": "21"}  # the phase's shards lease to its own agent alone
PART_SEGMENT_EVENTS = 256  # JOURNAL_SEGMENT_MAX_EVENTS: the promotion opens a fresh segment
PART_SERVE_MAX_PENDING = 96  # p1's front-door budget (SERVE_MAX_PENDING), which the burst passes
PROMOTE_DEADLINE_S = 60
STANDBY_CMD = [sys.executable, "-m", "agent_tpu_torch.controller.standby"]
# Phase 22 (a): the autoscaler over a process fleet on the router, under two
# open-loop LoadGen schedules from SEED: serve_classify requests of 20-900
# bytes at LOAD_INFER_RATE a second with a LOAD_INFER_BURST (start, length,
# factor), and 256-row map_classify_tpu jobs (phase 4's shape). The burst
# comes first, so that the backlog it leaves outlasts the start of the
# member it scales up (a member starts in 9 s on an idle host, 18 s under
# this load: 7 s of it importing torch). The members share the queue as
# phase 18's fleet does, one task at a time (MAX_TASKS 1, the serial loop):
# the backlog stays in the queue the autoscaler reads, not in one member's
# leases. The scale-down is judged on the queue alone (down_max_duty 1): the
# members' duty window is 60 s, longer than the phase.
ELASTIC_TASKS = "map_classify_tpu,serve_classify"
# BERT-base width at the depth of phase 10's entry point: each member builds
# its weights anew, which takes the host about 24 s at 12 layers, longer than
# a member scaled up in the burst could wait and still take work.
ELASTIC_LAYERS = 2
ELASTIC_PLATFORM = "cuda"
ELASTIC_EXTRA_ENV: dict = {}
ELASTIC_SCALER = {"min_agents": 1, "max_agents": 2, "interval_sec": 0.5, "down_idle_evals": 2,
                  "up_cooldown_sec": 2.0, "down_cooldown_sec": 2.0, "down_max_duty": 1.0}
ELASTIC_DEADLINE_S = 300
LOAD_SECONDS = 15.0
LOAD_INFER_RATE, LOAD_INFER_BURST, LOAD_INFER_BYTES = 30.0, (0.0, 4.0, 3.0), (20, 900)
LOAD_JOBS_RATE, LOAD_JOB_ROWS, LOAD_JOB_BYTES = 2.0, 256, (490, 500)
# Phase 22 (b): phase 10's first CHAOS_SHARDS shards under new ids through a
# ChaosSession on the result posts (a faulted lease would strand its job for
# the lease's 600 s).
CHAOS_SHARDS = 4
CHAOS_PLAN = {"drop_request": 0.2, "drop_response": 0.2, "http_500": 0.2,
              "duplicate_result": 0.3}


class Service:
    """A command in a process of its own, its output copied line by line to
    ``log_path`` and kept; ``wait(marker)`` returns the first line holding
    ``marker`` and records the seconds the process took to print it."""

    def __init__(self, name: str, cmd: list, env: dict, log_path: str) -> None:
        self.name, self.log_path, self.ready_s = name, log_path, None
        self.lines, self.times, self.closed = [], [], False
        self._cv = threading.Condition()
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(cmd, env=env, cwd=os.path.dirname(os.path.abspath(__file__)),
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        threading.Thread(target=self._copy, daemon=True).start()

    def _copy(self) -> None:
        with open(self.log_path, "w") as log:
            for line in self.proc.stdout:
                log.write(line)
                log.flush()
                with self._cv:
                    self.lines.append(line)
                    self.times.append(time.perf_counter())
                    self._cv.notify_all()
        with self._cv:
            self.closed = True
            self._cv.notify_all()

    def wait(self, marker: str, timeout: float) -> str:
        deadline = time.monotonic() + timeout
        with self._cv:
            while True:
                for line in self.lines:
                    if marker in line:
                        if self.ready_s is None:
                            self.ready_s = time.perf_counter() - self.t0
                        return line
                if self.closed or time.monotonic() > deadline:
                    raise SystemExit(f"{self.name}: no {marker!r} line in {timeout} s "
                                     f"{self.tail()}")
                self._cv.wait(timeout=0.1)

    def _read_to_end(self, timeout: float) -> None:
        """Once the process has exited, wait for the copying thread to read
        its output to the end: the lines it printed as it exited may still
        be in the pipe when it is reaped."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while not self.closed and time.monotonic() < deadline:
                self._cv.wait(timeout=0.1)

    def tail(self, n: int = 2000) -> str:
        """The exit code (None while it runs) and the last ``n`` characters
        of the output, read to its end when the process has exited."""
        if self.proc.poll() is not None:
            self._read_to_end(10.0)
        return f"(exit {self.proc.poll()}): {''.join(self.lines)[-n:]}"

    def url(self, marker: str, timeout: float = 120.0) -> str:
        return self.wait(marker, timeout).split(marker, 1)[1].split()[0]

    def since(self, t0: float) -> list:
        """The lines printed after ``t0`` (perf_counter), each with its
        seconds since ``t0``."""
        return [(round(t - t0, 3), ln.rstrip()[:200]) for t, ln in zip(self.times, self.lines)
                if t >= t0]

    def logged(self, message: str) -> dict:
        """The fields of the last ``[agent-tpu-torch] <message> {...}`` line."""
        head = f"] {message} "
        found = [ln for ln in self.lines if head in ln]
        return json.loads(found[-1].split(head, 1)[1]) if found else {}

    def stop(self, timeout: float = 60.0) -> int:
        """SIGTERM -> the exit code, the output read to its end (``logged``
        after ``stop`` sees the lines the process printed as it exited)."""
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
            raise SystemExit(f"{self.name} outlived SIGTERM by {timeout} s")
        self._read_to_end(timeout)
        return rc


class PartitionedPlane:
    """Phase 21's processes, kept for phase 22: p0 and p1, p0's standby
    (serving at p0's alternate URL once promoted) and the router in front of
    both. On exit every live one gets SIGTERM and must exit 0."""

    def __init__(self, tmp: str) -> None:
        self.tmp, self.services, self.killed = tmp, {}, set()

    def _start(self, name: str, cmd: list, env: dict) -> Service:
        self.services[name] = Service(name, cmd, env, os.path.join(self.tmp, f"{name}.log"))
        return self.services[name]

    def __enter__(self):
        base = repo_env(LEASE_TTL_SEC=str(LEASE_TTL_S), CACHE_ENABLED="0",
                        JOURNAL_SEGMENT_MAX_EVENTS=str(PART_SEGMENT_EVENTS),
                        CONTROLLER_HOST="127.0.0.1", CONTROLLER_SWEEP_SEC="1")
        base.pop("CHIP_SLICE", None)
        self.journal = os.path.join(self.tmp, "p0.jsonl")
        try:
            for name in PART_NAMES:
                extra = {"SERVE_MAX_PENDING": str(PART_SERVE_MAX_PENDING)} if name == "p1" else {}
                self._start(name, [sys.executable, "-m", "agent_tpu_torch.controller.server"],
                            dict(base, CONTROLLER_PARTITION=name, CONTROLLER_PORT="0",
                                 CONTROLLER_JOURNAL=os.path.join(self.tmp, f"{name}.jsonl"),
                                 **extra))
            self.urls = {name: self.services[name].url("serving on ") for name in PART_NAMES}
            port = free_port()
            self.standby_url = f"http://127.0.0.1:{port}"
            self.spec = f"p0={self.urls['p0']}|{self.standby_url},p1={self.urls['p1']}"
            self._start("standby", STANDBY_CMD, dict(
                base, CONTROLLER_JOURNAL=self.journal, PRIMARY_URL=self.urls["p0"],
                PRIMARY_DOWN_AFTER="2", STANDBY_POLL_SEC="0.05", CONTROLLER_PORT=str(port)))
            self._start("router", [sys.executable, "-m", "agent_tpu_torch.controller.router"],
                        dict(base, PARTITION_URLS=self.spec, ROUTER_HOST="127.0.0.1",
                             ROUTER_PORT="0", ROUTER_COLLECT_SEC="0"))
            self.services["standby"].wait("tailing ", 120)
            self.url = self.services["router"].url("routing on ")
        except BaseException:
            self.__exit__(*sys.exc_info())
            raise
        return self

    def kill(self, name: str) -> None:
        proc = self.services[name].proc
        proc.send_signal(signal.SIGKILL)
        proc.wait()
        self.killed.add(name)

    def promoted(self) -> bool:
        return any("promoted — serving on " in ln for ln in self.services["standby"].lines)

    def live_urls(self) -> dict:
        """Each partition's URL now: p0's standby's once it promoted."""
        return dict(self.urls, p0=self.standby_url) if self.promoted() else dict(self.urls)

    def __exit__(self, *exc):
        rcs, late = {}, None
        for name in ("router", "standby", "p1", "p0"):
            service = self.services.get(name)
            if service is None or name in self.killed:
                continue
            try:
                rcs[name] = service.stop()
            except SystemExit as err:
                late = late or err
        self.rcs = rcs
        if exc[0] is None:
            if late is not None:
                raise late
            if any(rcs.values()):
                raise SystemExit(f"a process of the partitioned plane exited non-zero: {rcs}, "
                                 f"{ {n: self.services[n].lines[-5:] for n in rcs if rcs[n]} }")


def get_json(url: str) -> dict:
    status, body = http_json(url)
    if status != 200:
        raise SystemExit(f"GET {url}: {status} {str(body)[:300]}")
    return body


def scrape(url: str) -> dict:
    from agent_tpu_torch.obs.metrics import parse_exposition

    return parse_exposition(get_json(url + "/v1/metrics"))


def series(samples: dict, family: str, **labels) -> float:
    return sum(v for lab, v in samples.get(family, [])
               if all(lab.get(k) == str(x) for k, x in labels.items()))


def agent_gauge(plane, family: str, agent: str, **labels) -> float:
    """An agent's pushed gauge, the largest over the partitions' exposition:
    its ``agent``-labelled sample, or the fleet's unlabelled one on a
    partition where it is the only agent that polled."""
    best = 0.0
    for url in plane.live_urls().values():
        samples = scrape(url)
        agents = {lab.get("agent") for lab, _ in samples.get("agent_last_seen_seconds", [])}
        for lab, value in samples.get(family, []):
            if all(lab.get(k) == str(x) for k, x in labels.items()) and (
                    lab.get("agent") == agent or ("agent" not in lab and agents == {agent})):
                best = max(best, value)
    return best


def fleet_counter(plane, family: str, **labels) -> float:
    """A counter the agents push, merged over a partition's agents, the
    largest over the partitions (the freshest push)."""
    return max(sum(v for lab, v in scrape(url).get(family, [])
                   if "agent" not in lab and all(lab.get(k) == str(x) for k, x in labels.items()))
               for url in plane.live_urls().values())


def results_by_outcome(plane) -> dict:
    """``controller_results_total`` by outcome, summed over the partitions
    now serving."""
    out: dict = collections.Counter()
    for url in plane.live_urls().values():
        for lab, value in scrape(url).get("controller_results_total", []):
            out[lab.get("outcome")] += value
    return dict(out)


def billed(plane) -> tuple:
    """``GET /v1/usage`` through the router -> (billed tasks, job id ->
    attempts billed)."""
    usage = get_json(plane.url + "/v1/usage?top_k=100000")
    return usage["billed_tasks"], {j["job_id"]: j["attempts_billed"] for j in usage["top_jobs"]}


def homed_names(ring, key, prefix: str) -> dict:
    """partition -> the first ``<prefix><i>`` that ``key`` places there."""
    out: dict = {}
    for i in range(10_000):
        out.setdefault(ring.place(key(f"{prefix}{i}")), f"{prefix}{i}")
        if len(out) == len(PART_NAMES):
            return out
    raise SystemExit(f"no {prefix} names homed on every partition")


def submit_partitioned(plane, sources: dict, extra: dict) -> dict:
    """Each CSV source through the router's POST /v1/jobs -> partition ->
    (the partition the answer names, the shard job ids)."""
    out = {}
    for want, source in sources.items():
        status, body = http_json(plane.url + "/v1/jobs", {
            "source_uri": source, "total_rows": DRAIN_ROWS, "shard_size": DRAIN_SHARD,
            "map_op": "map_classify_tpu", "extra_payload": extra,
            "required_labels": PART_LABELS})
        if status != 200:
            raise SystemExit(f"POST /v1/jobs through the router: {status} {body}")
        out[want] = (body.get("partition"), body["job_ids"])
    return out


def warm_file(tmp: str, name: str, specs: list) -> str:
    path = os.path.join(tmp, name)
    with open(path, "w") as fh:
        json.dump(specs, fh)
    return path


def classify_warm(model: dict, n: int = 8) -> dict:
    """One small request: a fresh process builds ``model``'s weights on it."""
    return {"op": "map_classify_tpu", "payload": {
        "texts": random_texts(random.Random(SEED + 21), n, 20, 200),
        "model_config": model, "topk": 5, "allow_fallback": False}}


def start_partition_drain(plane, path: str, tmp: str) -> dict:
    """Phase 21's start: phase 10's CSV under two source names that the
    router's hash homes one on each partition, submitted through the
    router with the phase's label, and the agent process started. It builds
    the BERT-base weights on the host (about 16 s), which main() overlaps
    with phases 19 and 10's entry points; nothing else leases the labelled
    shards."""
    from agent_tpu_torch.controller.partition import HashRing, placement_key
    from agent_tpu_torch.ops import load_ops

    ring = HashRing(PART_NAMES)
    names = homed_names(ring, lambda s: placement_key(None, "csv\x1f" + os.path.join(tmp, s)),
                        "drain-")
    sources = {}
    for part, name in names.items():
        sources[part] = os.path.join(tmp, name)
        os.symlink(path, sources[part])
    agent = homed_names(ring, lambda a: f"agent\x1f{a}", "chip-smoke-part-")["p0"]
    warm = classify_warm(BERT_BASE)
    warm_chunks = len(load_ops(["map_classify_tpu"])["map_classify_tpu"].stage(
        dict(warm["payload"]))[1]["chunks"])
    proc = Service("agent", [sys.executable, "-m", "agent_tpu_torch.agent.fleet"], repo_env(
        CONTROLLER_PARTITION_MAP=plane.spec, CONTROLLER_URL=plane.url,
        TASKS="map_classify_tpu,echo",
        AGENT_NAME=agent, AGENT_LABELS=",".join(f"{k}={v}" for k, v in PART_LABELS.items()),
        IDLE_SLEEP_SEC="0.01", PIPELINE_DEPTH="2", RETRY_BASE_SEC="0.05", RETRY_MAX_SEC="0.5",
        ERROR_BACKOFF_SEC="0.05", AGENT_WARM_FILE=warm_file(tmp, "part-warm.json", [warm])),
        os.path.join(tmp, "agent.log"))
    try:
        submitted = submit_partitioned(plane, sources, drain_payloads(path)[0])
    except BaseException:
        proc.stop()
        raise
    return {"ring": ring, "sources": sources, "agent": agent, "warm_chunks": warm_chunks,
            "proc": proc, "submitted": submitted}


def partition_phase(fa, plane, started: dict, serial: list, chunks: list) -> dict:
    """Phase 21 (see the module docstring), on ``start_partition_drain``'s
    shards and agent process."""
    from agent_tpu_torch.controller.partition import job_id_for_partition

    t_phase = time.perf_counter()
    n_layers = BERT_BASE["n_layers"]
    ring, sources, agent, proc, submitted, warm_chunks = (started[k] for k in (
        "ring", "sources", "agent", "proc", "submitted", "warm_chunks"))
    try:
        ids = [j for part in PART_NAMES for j in submitted[part][1]]
        shard_of = {j: i % len(serial) for i, j in enumerate(ids)}
        t0 = time.perf_counter()
        while agent not in get_json(plane.url + "/v1/status")["agents"]:
            if proc.proc.poll() is not None or time.perf_counter() - t0 > DRAIN_TIMEOUT_S:
                raise SystemExit(f"the agent did not come up: {proc.tail()}")
            time.sleep(0.02)
        t_ready = time.perf_counter()
        proc.ready_s = t_ready - proc.t0  # its start, its warm-up and its first poll
        # The kill: p0's primary once it has accepted PART_KILL_AFTER results.
        while get_json(plane.urls["p0"] + "/v1/status")["counts"].get("succeeded", 0) \
                < PART_KILL_AFTER:
            if proc.proc.poll() is not None or time.perf_counter() - t_ready > DRAIN_TIMEOUT_S:
                raise SystemExit(f"p0 accepted no results: {proc.tail()}")
            time.sleep(0.005)
        # A shard's result body is journaled only when a job depends on it,
        # so the standby replays p0's applied shards without their bodies:
        # they are read from the primary first, the agent paused (SIGSTOP)
        # so that no result lands between that read and the kill.
        proc.proc.send_signal(signal.SIGSTOP)
        time.sleep(0.1)
        before_kill = {j: snap for j in submitted["p0"][1] if (snap := get_json(
            f"{plane.urls['p0']}/v1/jobs/{j}"))["state"] == "succeeded"}
        plane.kill("p0")
        t_kill, kill_wall = time.perf_counter(), time.time()
        proc.proc.send_signal(signal.SIGCONT)
        plane.services["standby"].proc.send_signal(signal.SIGUSR1)
        plane.services["standby"].wait("promoted — serving on ", PROMOTE_DEADLINE_S)
        t_promoted = time.perf_counter()
        # A canary homed on p0, so that the promoted standby has a job to
        # lease even when the agent leased all of p0's shards before the kill.
        canary = job_id_for_partition(ring, "p0", prefix="chip-smoke-canary-")
        status, body = http_json(plane.url + "/v1/jobs", {
            "op": "echo", "payload": {"canary": True}, "job_id": canary,
            "required_labels": PART_LABELS})
        if status != 200 or body.get("partition") != "p0":
            raise SystemExit(f"the canary's submit: {status} {body}")
        t_canary = time.perf_counter()
        while not get_json(plane.url + "/v1/status")["drained"]:
            if proc.proc.poll() is not None or time.perf_counter() - t_ready > DRAIN_TIMEOUT_S:
                raise SystemExit(f"the partitioned drain did not finish: "
                                 f"{get_json(plane.url + '/v1/status')['counts_by_op']}, "
                                 f"{proc.tail()}")
            time.sleep(0.01)
        wall = time.perf_counter() - t_ready
        # The promoted standby's first lease: the earliest lease span it
        # recorded (GET /v1/trace/{job}) of p0's jobs and the canary.
        leases = [span["start_wall"] for j in submitted["p0"][1] + [canary]
                  for span in (http_json(f"{plane.standby_url}/v1/trace/{j}")[1] or {}).get(
                      "spans", []) if span["name"] == "lease" and span["start_wall"] >= kill_wall]
        rc = proc.stop()  # SIGTERM: the drain ends with a last metrics push
        # The agent's pushed counters: its runs and its row-1 launches.
        runs = fleet_counter(plane, "tasks_total", op="map_classify_tpu", status="succeeded")
        launches = agent_gauge(plane, "kernel_launches", agent, kernel="flash_attention")
        status = get_json(plane.url + "/v1/status")
        health = get_json(plane.url + "/v1/health")
        merged = scrape(plane.url)
        jobs = {j: get_json(f"{plane.url}/v1/jobs/{j}") for j in ids}
        canary_state = get_json(f"{plane.url}/v1/jobs/{canary}")["state"]
        for j, snap in before_kill.items():  # the body the primary applied
            if jobs[j]["state"] == "succeeded" and jobs[j]["result"] is None:
                jobs[j] = snap
        tasks, by_job = billed(plane)
        outcomes = results_by_outcome(plane)
    finally:
        proc.stop()
    routing = proc.logged("partition routing")
    promotion = plane.services["standby"].logged("standby promotion")
    bad = [j for j, s in jobs.items() if s["state"] != "succeeded" or s["result"] is None
           or s["result"]["indices"] != serial[shard_of[j]]["indices"]
           or s["result"]["scores"] != serial[shard_of[j]]["scores"]]
    once = [by_job.get(j) for j in ids]
    classify_done = status["counts_by_op"].get("map_classify_tpu", {}).get("succeeded")
    per_run = sorted({n_layers * c for c in chunks})  # row 1 a shard run (one value: exact)
    reruns = int(runs) - len(ids)
    run_launches = launches - n_layers * warm_chunks
    launches_ok = per_run[0] * runs <= run_launches <= per_run[-1] * runs
    report = {
        "phase": "partitioned_plane", "config": BERT_BASE, "rows": len(ids) * DRAIN_SHARD,
        "shards": len(ids), "sources": {p: os.path.basename(s) for p, s in sources.items()},
        "partition_of_source": {p: submitted[p][0] for p in PART_NAMES},
        "agent": agent, "agent_home": "p0", "wall_s": wall,
        "applied_before_kill": len(before_kill),
        "rows_per_s": len(ids) * DRAIN_SHARD / wall,
        "failover_gap_s": min(leases) - kill_wall if leases else None,
        "canary": {"job_id": canary, "state": canary_state},
        "kill_to_promotion_s": t_promoted - t_kill, "standby_promotion": promotion,
        "torn_tail_seals": promotion.get("torn_sealed_bytes", 0) > 0,
        "routing": routing, "runs": runs, "reruns": reruns,
        "row1_launches": launches, "row1_launches_runs": run_launches,
        "row1_launches_warm": n_layers * warm_chunks,
        "billed_tasks": tasks, "billed_once": once.count(1), "results_by_outcome": outcomes,
        "status_partitions": [(r["name"], r["ok"]) for r in status["partitions"]],
        "health_partitions": [(r["name"], r["ok"]) for r in health["partitions"]],
        "metrics_partitions": sorted({lab["partition"] for samples in merged.values()
                                      for lab, _ in samples if "partition" in lab}),
        "start_s": {n: s.ready_s for n, s in plane.services.items()} | {"agent": proc.ready_s},
        "agent_exit_code": rc, "canary_submitted_s": t_canary - t_kill,
        "after_kill": {"agent": proc.since(t_kill)[:40],
                       "standby": plane.services["standby"].since(t_kill)[:20]},
        "seconds": time.perf_counter() - t_phase}
    emit(report)
    if bad or once != [1] * len(ids) or tasks != len(ids) + by_job.get(canary, 0) \
            or classify_done != len(ids) or canary_state != "succeeded" \
            or outcomes.get("unknown_job") or rc != 0 or not leases \
            or [p for p, (got, _) in submitted.items() if got != p] \
            or routing.get("lease_grants_stolen_total", 0) < 1 or not launches_ok \
            or report["status_partitions"] != [(p, True) for p in PART_NAMES] \
            or report["health_partitions"] != [(p, True) for p in PART_NAMES] \
            or report["metrics_partitions"] != list(PART_NAMES):
        raise SystemExit(f"phase 21 failed: {len(bad)} shards wrong, billed {once}, "
                         f"{str(report)[:3000]}, agent log {proc.tail(1500)}")
    return report


def elastic_driver(plane, tmp: str):
    """Phase 22's ProcessFleetDriver on the router, its first member spawned
    now so that it builds its weights while phase 21 runs (phase 21's shards
    require a label it lacks): warmed on one classify request
    (AGENT_WARM_FILE; serve_classify serves the same weights); every member
    takes one task at a time (MAX_TASKS 1, the serial loop), every one
    pinned to card 0."""
    from agent_tpu_torch.autoscale import ProcessFleetDriver

    warm = warm_file(tmp, "elastic-warm.json",
                     [classify_warm(dict(BERT_BASE, n_layers=ELASTIC_LAYERS))])
    extra = {"IDLE_SLEEP_SEC": "0.01", "AGENT_WARM_FILE": warm, "RETRY_BASE_SEC": "0.05",
             "RETRY_MAX_SEC": "0.5", "ERROR_BACKOFF_SEC": "0.05", "MAX_TASKS": "1",
             "PIPELINE_DEPTH": "0"}
    if ELASTIC_PLATFORM == "cuda":
        extra["CUDA_VISIBLE_DEVICES"] = "0"  # the one card; agent_env would give slot i card i
    driver = ProcessFleetDriver(plane.url, ELASTIC_TASKS, max_agents=ELASTIC_SCALER["max_agents"],
                                platform=ELASTIC_PLATFORM, name_prefix="chip-smoke-elastic",
                                extra_env=dict(extra, **ELASTIC_EXTRA_ENV),
                                log_dir=os.path.join(tmp, "elastic"))
    driver.spawn(1)
    # The members it scales up poll at once and build their weights on
    # their first job: a warm-up would outlast the load they are spawned for.
    driver.extra_env.pop("AGENT_WARM_FILE")
    return driver


def elastic_phase(fa, ctx, plane, driver, k: int) -> dict:
    """Phase 22 (a) (see the module docstring)."""
    from agent_tpu_torch.autoscale import HOLD, Autoscaler, read_signals
    from agent_tpu_torch.config import AutoscaleConfig
    from agent_tpu_torch.controller.partition import HashRing
    from agent_tpu_torch.loadgen import ArrivalPattern, LoadGen, TrafficClass, session_submitter
    from agent_tpu_torch.obs.scrape import fetch_health
    from agent_tpu_torch.ops import load_ops
    from agent_tpu_torch.utils.http import UrllibSession

    t_phase = time.perf_counter()
    ring = HashRing(PART_NAMES)
    tenants = homed_names(ring, lambda t: f"tenant\x1f{t}", "tenant-")
    model = dict(BERT_BASE, n_layers=ELASTIC_LAYERS)
    params = {"model_config": model, "topk": k}
    job_base = {"model_config": model, "topk": k, "allow_fallback": False,
                "result_format": "columnar"}
    infer = LoadGen([TrafficClass("infer", "classify", tenant=tenants["p1"], route="infer",
                                  payload_fn=lambda rng, seq: {
                                      "text": random_texts(rng, 1, *LOAD_INFER_BYTES)[0],
                                      "params": params})],
                    ArrivalPattern(LOAD_INFER_RATE, bursts=[(LOAD_INFER_BURST[0], sum(
                        LOAD_INFER_BURST[:2]), LOAD_INFER_BURST[2])]), seed=SEED + 22)
    jobs = LoadGen([TrafficClass("jobs", "map_classify_tpu", tenant=tenants["p0"],
                                 payload_fn=lambda rng, seq: dict(job_base, texts=random_texts(
                                     rng, LOAD_JOB_ROWS, *LOAD_JOB_BYTES)))],
                   ArrivalPattern(LOAD_JOBS_RATE), seed=SEED + 23)
    cfg = AutoscaleConfig(**ELASTIC_SCALER)
    scaler = Autoscaler(driver, lambda: fetch_health(plane.url, timeout=10.0), config=cfg)
    ready, at_ready, decisions, holds, errors = {}, {}, [], collections.Counter(), []
    signals = []  # every evaluation: (s since the load began, queue, active jobs, fleet)
    stop, t_load = threading.Event(), [None]

    def watch_ready():
        """Each member's first poll (GET /v1/status's agents) and its row-1
        launches then: its warm-up's."""
        while not stop.is_set():
            try:
                seen = get_json(plane.url + "/v1/status")["agents"]
                for name in list(driver.history):
                    if name in seen and name not in ready:
                        ready[name] = time.monotonic()
                        at_ready[name] = agent_gauge(plane, "kernel_launches", name,
                                                     kernel="flash_attention")
            except (OSError, ValueError, SystemExit):
                pass
            time.sleep(0.25)

    def scale():
        """The autoscaler's step (read, decide, act), each decision kept
        with its signals and the members it spawned or retired; a step that
        raises is kept and the loop goes on, as ``Autoscaler.run``'s."""
        while not stop.wait(cfg.interval_sec):
            try:
                step()
            except Exception as exc:  # noqa: BLE001 — reported, and the phase fails
                errors.append(repr(exc)[:300])

    def step():
        sig = read_signals(fetch_health(plane.url, timeout=10.0))
        decision = scaler.decide(sig)
        if t_load[0] is not None:
            signals.append((round(time.perf_counter() - t_load[0], 2), sig.queue_depth,
                            sig.active_jobs, driver.size()))
        spawned = set(driver.history)
        retired = {n for n, h in driver.history.items() if "retired" in h}
        scaler.apply(decision)
        if decision.action == HOLD:
            holds[decision.reason] += 1
            return
        decisions.append({
            "t_s": None if t_load[0] is None else time.perf_counter() - t_load[0],
            "action": decision.action, "n": decision.n, "reason": decision.reason,
            "queue_depth": sig.queue_depth, "active_jobs": sig.active_jobs,
            "live_agents": sig.live_agents, "fleet": driver.size(),
            "spawned": sorted(set(driver.history) - spawned),
            "retired": sorted({n for n, h in driver.history.items() if "retired" in h}
                              - retired)})

    watchers = [threading.Thread(target=fn, daemon=True) for fn in (watch_ready, scale)]
    watchers[0].start()
    first = next(iter(driver.history))
    while first not in ready:
        if driver.size() < 1 or time.monotonic() - driver.history[first]["spawned"] \
                > ELASTIC_DEADLINE_S:
            stop.set()
            driver.reap()
            raise SystemExit(f"the first fleet member did not come up: {driver.history}")
        time.sleep(0.05)
    live = plane.live_urls()
    before = {p: (get_json(u + "/v1/status")["serving"]["rejected"],
                  series(scrape(u), "controller_admission_rejections_total"))
              for p, u in live.items()}
    watchers[1].start()
    stats = {}

    def run(name, gen):
        stats[name] = gen.run(session_submitter(UrllibSession(), plane.url), LOAD_SECONDS)

    loads = [threading.Thread(target=run, args=a, daemon=True)
             for a in (("infer", infer), ("jobs", jobs))]
    gc.collect()
    t_load[0] = time.perf_counter()
    for t in loads:
        t.start()
    for t in loads:
        t.join(timeout=LOAD_SECONDS + 120)
    t_sent = time.perf_counter()
    req_ids = stats["infer"].job_ids()
    while True:
        status = get_json(plane.url + "/v1/status")
        states = status["serving"].get("requests", {})
        if status["drained"] and states.get("done", 0) + states.get("failed", 0) \
                >= len(req_ids) and sum(states.values()) >= len(req_ids):
            break
        if time.perf_counter() - t_sent > ELASTIC_DEADLINE_S or [
                h for h in driver.history.values() if h.get("rc") not in (None, 0)]:
            stop.set()
            raise SystemExit(f"the elastic load did not finish: {status['counts_by_op']}, "
                             f"{status['serving']}, members {driver.history}")
        time.sleep(0.05)
    t_done = time.perf_counter()
    # The fleet back at its floor once the load is served: at least one
    # member retired by SIGTERM, every retired member reaped.
    while not (scaler.scale_downs and driver.size() == cfg.min_agents and all(
            "rc" in h for h in driver.history.values() if "retired" in h)):
        if time.perf_counter() - t_done > ELASTIC_DEADLINE_S:
            stop.set()
            raise SystemExit(f"no member was retired: {decisions}, {dict(holds)}, {errors}, "
                             f"{driver.history}, signals {signals}")
        driver.reap()
        time.sleep(0.1)
    launches = {n: agent_gauge(plane, "kernel_launches", n, kernel="flash_attention")
                for n in driver.history if n in ready}
    after = {p: (get_json(u + "/v1/status")["serving"]["rejected"],
                 series(scrape(u), "controller_admission_rejections_total"))
             for p, u in live.items()}
    stop.set()
    for t in watchers:
        t.join(timeout=10)
    driver.stop_all(timeout=60)
    # The answers: every admitted request and job, against the ops run here.
    answers = infer_answers(plane.url, req_ids, threads=8)
    texts = {a.seq: a.payload["text"] for a in infer.schedule(LOAD_SECONDS)}
    by_req = {j["job_id"]: texts[j["seq"]] for j in stats["infer"].jobs}
    serve = load_ops(["serve_classify"])["serve_classify"]
    direct = []
    for s in range(0, len(req_ids), 16):
        chunk = [{"req_id": str(i), "text": by_req[r]} for i, r in enumerate(req_ids[s:s + 16])]
        direct += serve({"requests": chunk, **params}, ctx)["results"]
    infer_agree = topk_agreement([a["result"] for a in answers], direct, LOGP_TOL["bfloat16"])
    payloads = {a.seq: a.payload for a in jobs.schedule(LOAD_SECONDS)}
    classify = load_ops(["map_classify_tpu"])["map_classify_tpu"]
    got_rows, want_rows = [], []
    for j in stats["jobs"].jobs:
        snap = get_json(f"{plane.url}/v1/jobs/{j['job_id']}")
        want = classify(dict(payloads[j["seq"]]), ctx)
        if snap["state"] != "succeeded":
            raise SystemExit(f"job {j['job_id']} {snap['state']}: {snap['error']}")
        for r in (snap["result"], want):
            (got_rows if r is snap["result"] else want_rows).extend(
                {"indices": i, "scores": sc} for i, sc in zip(r["indices"], r["scores"]))
    jobs_agree = topk_agreement(got_rows, want_rows, LOGP_TOL["bfloat16"])
    drops = dict(collections.Counter(stats["infer"].rejected_by_partition)
                 + collections.Counter(stats["jobs"].rejected_by_partition))
    refused = {p: (after[p][0] - before[p][0]) + (after[p][1] - before[p][1]) for p in live}
    lat = sorted(a["latency_ms"] for a in answers)
    h = driver.history
    report = {
        "phase": "elastic_fleet", "config": model, "scaler": dict(ELASTIC_SCALER),
        "load_seconds": LOAD_SECONDS, "infer_rate": LOAD_INFER_RATE,
        "infer_burst": LOAD_INFER_BURST, "jobs_rate": LOAD_JOBS_RATE, "tenants": tenants,
        "submitted": {n: s.total_submitted() for n, s in stats.items()},
        "rejected": {n: s.total_rejected() for n, s in stats.items()},
        "errors": {n: dict(s.errors) for n, s in stats.items()},
        "requests_per_s_offered": (len(req_ids) + stats["infer"].total_rejected()) / LOAD_SECONDS,
        "requests_per_s_done": len(req_ids) / (t_done - t_load[0]),
        "latency_ms": {"p50": statistics.median(lat), "p99": lat[int(0.99 * (len(lat) - 1))]},
        "drops_by_partition": drops, "refused_by_partition": refused,
        "decisions": decisions, "holds": dict(holds), "scaler_errors": errors,
        "signals": signals,
        "scale_ups": scaler.scale_ups, "scale_downs": scaler.scale_downs,
        "replacements": scaler.replacements,
        "members": {n: {"spawn_to_ready_s": ready[n] - h[n]["spawned"] if n in ready else None,
                        "retire_to_exit_s": h[n]["exited"] - h[n]["retired"]
                        if "retired" in h[n] and "exited" in h[n] else None,
                        "exit_code": h[n].get("rc"), "retired_by_scaler": n in driver.retired,
                        "row1_launches": launches.get(n),
                        "row1_launches_at_ready": at_ready.get(n)} for n in h},
        "infer_agreement": infer_agree, "jobs_agreement": jobs_agree,
        "seconds": time.perf_counter() - t_phase}
    # Every member that polled ran work; a member retired while it still
    # warmed never polled (it exits 0 after its warm-up, leasing nothing).
    moved = all(launches[n] > at_ready[n] for n in ready)
    burst_end = sum(LOAD_INFER_BURST[:2]) + cfg.interval_sec
    in_burst = [n for d in decisions if d["action"] == "up" and d["t_s"] is not None
                and d["t_s"] <= burst_end for n in d["spawned"]]
    report["checks"] = {"every_polling_member_launched": moved,
                        "scaled_up_in_burst": in_burst,
                        "scaled_up_member_launched": [n for n in in_burst if n in ready],
                        "retired_by_sigterm": sorted(n for n, x in h.items() if "retired" in x
                                                     and n in driver.retired)}
    emit(report)
    if not infer_agree["ok"] or not jobs_agree["ok"] or errors or scaler.replacements \
            or not report["checks"]["scaled_up_member_launched"] or not moved \
            or first not in ready or not scaler.scale_downs \
            or any(m["exit_code"] != 0 for m in report["members"].values()) \
            or {p: drops.get(p, 0) for p in live} != refused or any(
                report["errors"].values()):
        raise SystemExit(f"phase 22 (a) failed: {str(report)[:4000]}")
    return report


class CountingSession:
    """``inner``'s posts, counted in ``n``."""

    def __init__(self, inner) -> None:
        self.inner, self.n = inner, 0

    def post(self, url: str, json=None, timeout=None):  # noqa: A002
        self.n += 1
        return self.inner.post(url, json=json, timeout=timeout)


class ResultsThrough:
    """Phase 22 (b)'s agent session: result posts through ``chaos``, every
    other post (leases, metrics polls) straight to ``inner``."""

    def __init__(self, inner, chaos) -> None:
        self.inner, self.chaos = inner, chaos

    def post(self, url: str, json=None, timeout=None):  # noqa: A002
        target = self.chaos if url.endswith("/v1/results") else self.inner
        return target.post(url, json=json, timeout=timeout)


def chaos_phase(fa, rt, plane, path: str, serial: list, chunks: list) -> dict:
    """Phase 22 (b) (see the module docstring)."""
    from agent_tpu_torch.agent.app import Agent
    from agent_tpu_torch.chaos import ChaosSession, FaultPlan
    from agent_tpu_torch.config import AgentConfig, Config
    from agent_tpu_torch.obs.metrics import MetricsRegistry, parse_exposition

    t_phase = time.perf_counter()
    shards = drain_payloads(path)[2][:CHAOS_SHARDS]
    ids = [f"chip-smoke-chaos-{i}" for i in range(len(shards))]
    for jid, payload in zip(ids, shards):
        status, body = http_json(plane.url + "/v1/jobs", {"op": "map_classify_tpu",
                                                          "payload": payload, "job_id": jid})
        if status != 200:
            raise SystemExit(f"POST /v1/jobs: {status} {body}")
    plan, registry = FaultPlan(seed=SEED, **CHAOS_PLAN), MetricsRegistry()
    agent = Agent(Config(agent=AgentConfig(
        controller_url=plane.url, controller_partition_map=plane.spec,
        agent_name="chip-smoke-chaos", tasks=("map_classify_tpu",), idle_sleep_sec=0.005,
        error_backoff_sec=0.01, retry_base_sec=0.01, retry_max_sec=0.05, pipeline_depth=0)),
        runtime=rt)
    delivered = CountingSession(agent.session)  # the partition map's shim
    agent.session = ResultsThrough(agent.session, ChaosSession(delivered, plan,
                                                               registry=registry))
    before = results_by_outcome(plane)
    reset_counts(fa)
    t0 = time.perf_counter()
    while not (get_json(plane.url + "/v1/status")["drained"] and not len(agent.spool)):
        if time.perf_counter() - t0 > DRAIN_TIMEOUT_S:
            raise SystemExit(f"the chaos drain did not finish: {plan.counts}")
        agent.step()
        if len(agent.spool):
            agent.flush_spool(force=True)
    wall = time.perf_counter() - t0
    launches = fa.LAUNCH_COUNTS["flash_attention"]
    after = results_by_outcome(plane)
    delta = {o: after.get(o, 0) - before.get(o, 0) for o in set(after) | set(before)}
    jobs = [get_json(f"{plane.url}/v1/jobs/{j}") for j in ids]
    _, by_job = billed(plane)
    injected = collections.Counter()
    for lab, value in parse_exposition(registry.render()).get("chaos_faults_injected_total", []):
        injected[lab["fault"]] += value
    same = all(j["state"] == "succeeded" and j["result"]["indices"] == w["indices"]
               and j["result"]["scores"] == w["scores"] for j, w in zip(jobs, serial))
    report = {"phase": "chaos", "shards": len(ids), "rows": len(ids) * DRAIN_SHARD,
              "plan": CHAOS_PLAN, "seed": SEED, "fault_counts": dict(plan.counts),
              "chaos_faults_injected_total": dict(injected), "result_posts_delivered":
              delivered.n, "results_by_outcome": delta,
              "billed_attempts": [by_job.get(j) for j in ids], "equal_to_serial": same,
              "launches": launches, "launches_want": BERT_BASE["n_layers"] * sum(
                  chunks[:len(ids)]), "wall_s": wall, "seconds": time.perf_counter() - t_phase}
    emit(report)
    if not same or dict(injected) != {k: float(v) for k, v in plan.counts.items()} \
            or not plan.counts or report["billed_attempts"] != [1] * len(ids) \
            or delta.get("succeeded", 0) != len(ids) or delta.get("unknown_job", 0) \
            or delta.get("stale_epoch", 0) \
            or delta.get("duplicate", 0) != delivered.n - len(ids) \
            or launches != report["launches_want"]:
        raise SystemExit(f"phase 22 (b) failed: {report}")
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
    parser.add_argument("--mix-shard", type=int, nargs="+", default=[], metavar="ROWS",
                        help="only phases 1, 2, phase 3 at phase 24's shapes and phase 24 "
                             "once for each bulk shard size given, in that order")
    args = parser.parse_args(argv)
    cards, mix_shards = args.cards, args.mix_shard
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
    t_start = time.perf_counter()
    times, mark = {}, [t_start]

    def lap(name: str) -> None:
        """The seconds since the last lap, as phase ``name``'s."""
        now = time.perf_counter()
        times[name] = times.get(name, 0.0) + now - mark[0]
        mark[0] = now

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

    # 2. build, with phase 14's MoE host draw beside it (joined below)
    moe_draw = threading.Thread(target=seeded_moe, daemon=True)
    moe_draw.start()
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

    moe_draw.join()
    lap("1-2 device, build")

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
    if mix_shards:
        mix_sizes_phase(fa, classify, requests[0][1], mix_shards, smi)
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
    serve = load_ops(["serve_summarize"])["serve_summarize"]
    kernel_cases = staged_cases(
        classify, requests + long_requests + [("small_f32", small_payload, 12),
                                              ("drain_shard", drain_shards[0], DRAIN_SHARD),
                                              ("mix_shard", mix_payload(drain_csv), MIX_SHARD)]
    ) + staged_cases(summarize, s2s_cases + [("drain_s2s_shard", drain_s2s[0], DRAIN_SHARD)]) \
        + staged_cases(classify, bert_reqs) + staged_cases(summarize, bart_reqs) \
        + serving_cases(serve) + serving_mix_cases(classify, serve)
    kernel_check = check_kernels(fa, kernel_cases)
    train_check = check_train_kernels(fa, train_case)
    fold_check = check_fold_kernel(fa, ring_fold_case(
        next(c for c in kernel_cases if c[0].startswith("texts8_L4096/"))), [ring_fold_case(
            next(c for c in kernel_cases if c[0].startswith("bert_texts256/")))])
    t5_check = check_t5_kernel(fa, t5_case)
    lap("3 kernels vs plain (and staging)")

    # 4. main path, on the BERT-base host draw that phase 10 reuses
    rt = TorchRuntime()
    ctx = OpContext(runtime=rt)
    # The seeded host draw and its placement; the op then finds the weights
    # resident and builds none of its own.
    t_place = time.perf_counter()
    place_seeded(rt, {"none": BERT_BASE}, seeded_dense())
    classify(dict(requests[0][1]), ctx)  # finds the weights resident
    held_resident(rt, {"none": BERT_BASE})
    seeded_weights_s = time.perf_counter() - t_place
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
    emit({"phase": "main_path", "config": BERT_BASE, "seeded_weights_s": seeded_weights_s,
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
    lap("4 main path")
    # 20. the front door at full width, on phase 4's weights
    door = front_door_phase(fa, rt, ctx, k)
    lap("20 front door")
    # 24. /v1/infer beside a bulk drain (check_serving_pipeline's legs), on
    # phase 4's weights
    mix = serving_mix_phase(fa, rt, smi)
    lap("24 serving beside a drain")

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
    lap("5 long context")

    # 5b. ring
    fold_launches = ring_phase(fa, classify, rt, long_payload, long_report, small_payload, k)
    rt.clear_params()
    lap("5b ring")

    # 6. train
    with tempfile.TemporaryDirectory() as tmp:
        train_launches, train_step_ms = train_phase(fa, train_op, classify, train_payload,
                                                    (train_state, take), tmp)
    lap("6 train")

    # 8. summarize with the in-house seq2seq
    s2s = summarize_phase(fa, summarize, rt)
    rt.clear_params()
    lap("8 summarize")

    # 9. T5-large
    t0 = time.perf_counter()
    write_t5_checkpoint(ckpt, T5_LARGE, SEED, torch.bfloat16, CARD)
    emit({"phase": "t5_checkpoint", "seconds": time.perf_counter() - t0,
          "bytes": os.path.getsize(os.path.join(ckpt, "pytorch_model.bin"))})
    t5_run = t5_phase(fa, summarize_op, rt, ckpt, t5_requests)
    rt.clear_params()
    lap("9 T5-large")

    # 10. the agent's drain, then its entry point in a process of its own;
    # 19. the control plane, on phase 10's CSV and weights, between them
    place_seeded(rt, {"none": BERT_BASE}, seeded_dense())  # phase 4's host draw again
    drain = drain_phase(fa, rt, drain_csv)
    lap("10 drain, 15 telemetry")
    # 21. the partitioned control plane and 22. the elastic fleet and chaos,
    # on phase 10's CSV and weights. Their agent processes build their
    # weights on the host while phases 19 and 10's entry points run.
    with tempfile.TemporaryDirectory() as tmp, PartitionedPlane(tmp) as plane:
        driver = elastic_driver(plane, tmp)
        started = start_partition_drain(plane, drain_csv, tmp)
        try:
            lap("21, 22 start")
            control = control_plane_phase(fa, rt, drain_csv, drain["serial_results"],
                                          drain["dispatch_chunks"])
            lap("19 control plane")
            entry_point_phase(drain_csv)
            lap("10 entry points")
            part = partition_phase(fa, plane, started, drain["serial_results"],
                                   drain["dispatch_chunks"])
            lap("21 partitioned plane")
            elastic = elastic_phase(fa, ctx, plane, driver, k)
        finally:
            driver.stop_all(timeout=60)
            started["proc"].stop()
        chaos = chaos_phase(fa, rt, plane, drain_csv, drain["serial_results"],
                            drain["dispatch_chunks"])
    lap("22 elastic fleet, chaos")
    rt.clear_params()

    # 18 (a), (b): several processes on the card — the leader and its
    # follower, then the device-pinned fleet on phase 10's CSV
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs = procs_phase(2, tmp)
        fleet_run = fleet_phase(torch.cuda.device_count(), drain_csv, drain.pop("serial_results"),
                                drain["serial_rows_per_s"], drain["rows_per_s"], tmp)
    emit({"phase": "processes", "leader_follower": procs, "fleet": fleet_run,
          "seconds": time.perf_counter() - t0, "nvidia_smi": smi})
    lap("18 (a), (b) processes")

    # 11. a BERT checkpoint through map_classify_tpu
    t0 = time.perf_counter()
    write_hf_checkpoint(bert_ckpt, BERT_BASE_UNCASED,
                        bert_state_dict(BERT_BASE_UNCASED, SEED, torch.float32, CARD))
    emit({"phase": "bert_checkpoint", "seconds": time.perf_counter() - t0,
          "bytes": os.path.getsize(os.path.join(bert_ckpt, "pytorch_model.bin"))})
    bert_run = bert_phase(fa, classify, rt, bert_ckpt, bert_reqs)
    rt.clear_params()
    drain_dir.cleanup()
    lap("11 bert")

    # 23. the north-star drain's entry point, on phase 11's checkpoint
    at_scale = drain_at_scale_phase(classify, summarize, rt, bert_ckpt, smi)
    rt.clear_params()
    lap("23 drain at scale")

    # 12. a BART checkpoint through map_summarize
    t0 = time.perf_counter()
    write_hf_checkpoint(bart_ckpt, BART_LARGE_CNN,
                        bart_state_dict(BART_LARGE_CNN, SEED, torch.bfloat16, CARD))
    emit({"phase": "bart_checkpoint", "seconds": time.perf_counter() - t0,
          "bytes": os.path.getsize(os.path.join(bart_ckpt, "pytorch_model.bin"))})
    bart_run = bart_phase(fa, summarize, rt, bart_ckpt, bart_reqs)
    rt.clear_params()
    lap("12 bart")

    # 13. continuous-batching serving
    serving = serving_phase(fa, rt, classify_check)
    rt.clear_params()
    lap("13 serving")

    # 14. quantized serving and the Switch MoE encoder (phases 9 and 12's
    # checkpoints)
    qm = quant_moe_phase(fa, rt, smi, (train_state, take), ckpt, t5_requests, bart_ckpt,
                         bart_reqs)
    lap("14 quant and MoE")

    # 16. dp, tp, pp and ep meshes on the one card (phase 14's draws, phase
    # 11's checkpoint)
    meshes = mesh_phase(fa, smi, requests[2][1]["texts"], bert_reqs[0][1], long_payload,
                        (train_state, take), train_step_ms)
    lap("16 meshes")

    # 18 (c): the sharded checkpoint of phase 16's tp 2 model
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt_run = checkpoint_phase(fa, classify, requests[2][1]["texts"], tmp)
    emit({"phase": "sharded_checkpoint", **ckpt_run, "seconds": time.perf_counter() - t0,
          "nvidia_smi": smi})
    SEEDED.clear()
    lap("18 (c) sharded checkpoint")

    # 17. the decoder families on dp and tp meshes on the one card (phases 9
    # and 12's checkpoints, then removed)
    dec = decoder_mesh_phase(fa, smi, ckpt, t5_requests, bart_ckpt, bart_reqs,
                             serving["engine_vs_static"][0]["continuous_tok_per_s"])
    t5_dir.cleanup()
    hf_dir.cleanup()
    lap("17 decoder meshes")

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
        cuda_ms(lambda: fa._launch(q, k_, v, mask)),
        cuda_ms(lambda: fa.flash_attention_reference(q, k_, v, mask), iters=5),
        4 * B * H * L * D * q.element_size() + mask.numel() * mask.element_size(),
        4 * H * L * D * float(np.sum(lengths)),  # products with real keys only
        cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k_, v, attn_mask=bool_mask)), q,
        **entry_times(fa, lengths, lambda: fa.flash_attention(q, k_, v, mask)),
        launches_by_path={"map_classify_tpu": main_launches, "map_summarize": s2s["launches"],
                          "agent_drain_map_classify_tpu": drain["launches"],
                          "agent_telemetry_map_classify_tpu": drain["telemetry"]["launches"],
                          "workflow_map_classify_tpu": control["row1_launches"],
                          "map_classify_tpu_partitioned_agent": part["row1_launches"],
                          "elastic_fleet_members": sum(m["row1_launches"] or 0 for m in
                                                       elastic["members"].values()),
                          "map_classify_tpu_chaos": chaos["launches"],
                          "map_classify_tpu_bert": bert_run["launches"],
                          "drain_at_scale_agent": at_scale["row1_launches"],
                          "map_summarize_bart": bart_run["launches"],
                          "serve_classify": classify_check["launches"],
                          "serve_classify_front_door": door["launches"],
                          "serving_beside_a_drain": mix["launches"],
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
    lap("7 kernel timings")
    emit({"phase": "times", "nvidia_smi": smi, "total_s": time.perf_counter() - t_start,
          "seconds": times})
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
