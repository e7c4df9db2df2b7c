#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (agent_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. device   — CUDA present, an H100 SXM (compute capability (9, 0)),
              nvidia-smi's name and power limit.
2. build    — nvcc builds every kernel of the path from csrc/ (sm_90a).
3. kernels vs plain — each kernel's wrapper on the card against its plain
              PyTorch version: at the shapes and key lengths that the
              requests of phases 4 and 5 stage (taken from the op's own
              stage phase), and at edge cases. Two planted faults (the
              first key tile dropped, the score scale 10 % off)
              must fail the same check. Non-contiguous inputs must give the
              contiguous result, and the launcher must refuse what the
              kernel does not take.
4. main path — map_classify_tpu through the op registry at BERT-base width
              (d_model 768, 12 heads, 12 layers, d_ff 3072, max_len 512;
              random weights from the model id): one text, 64 mixed-length
              rows, 256 rows of ~500 bytes, one 100-id input. Every request
              must run on cuda and launch the flash kernel once per layer.
              The 64-row request is re-run asking for every class, with the
              kernel and with the plain attention swapped in, and the
              log-probabilities compared; the planted tile drop must fail
              that comparison. A small f32 model is checked against the
              same op on the CPU.
5. long context — d_model 512, 4 heads (d_head 128), max_len 4096: 8 rows
              of 3000-4096 bytes.
6. kernels  — per kernel: launches on the main path, error against plain,
              kernel / plain / library times and the card's bound.

The line before the last is nvidia-smi's "name, power.limit"; the last line
is {"ok": true, "device": {...}}. Without CUDA it exits 2 and prints no
result.
"""

from __future__ import annotations

import json
import math
import random
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 1234
BERT_BASE = {"d_model": 768, "n_heads": 12, "n_layers": 12, "d_ff": 3072, "max_len": 512}
LONG_CTX = {"d_model": 512, "n_heads": 4, "max_len": 4096}
SMALL_F32 = {"d_model": 128, "n_heads": 2, "n_layers": 2, "d_ff": 256, "max_len": 128,
             "n_classes": 50, "dtype": "float32"}
REPS = 5  # timed repetitions of each main-path request, after one warm-up

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
    q, k, v = (torch.randn(B, H, L, D, generator=g).to("cuda", dtype)
               for L in (Lq, Lk, Lk))
    mask = (torch.arange(Lk)[None, :] < torch.as_tensor(lengths)[:, None]).to(torch.int32)
    return q, k, v, mask[:, None, None, :].cuda()


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
        for ids, lengths, _ in state["chunks"]:
            B, L = ids.shape
            cases.append((f"{name}/B{B}xL{L}", (B, cfg.n_heads, L, L, cfg.d_model // cfg.n_heads),
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
        if name.startswith("texts256/"):
            inputs["main"] = (q, k, v, mask, lengths)
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
            "max_rel_err": max(r["max_rel_err"] for r in main), "inputs": inputs["main"]}


def random_texts(rng: random.Random, n: int, lo: int, hi: int):
    alphabet = "abcdefghijklmnopqrstuvwxyz      .,;:!?0123456789ABCDEFGHIJ"
    return ["".join(rng.choice(alphabet) for _ in range(rng.randint(lo, hi)))
            for _ in range(n)]


def check_result(out: dict, n_rows: int, k: int) -> None:
    if not out.get("ok") or out.get("device") != "cuda" or "fallback" in out:
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


def timed_requests(classify, ctx, fa, requests, n_layers: int, k: int) -> list:
    """Run each request once to warm up, then REPS times; every run must
    launch the kernel once per layer and take no dense path."""
    report = []
    for name, payload, n_rows in requests:
        walls = []
        for rep in range(REPS + 1):
            launches, dense = fa.LAUNCH_COUNTS["flash_attention"], fa.SELECTION_COUNTS["dense"]
            t0 = time.perf_counter()
            out = classify(dict(payload), ctx)
            wall = time.perf_counter() - t0
            check_result(out, n_rows, k)
            d_launch = fa.LAUNCH_COUNTS["flash_attention"] - launches
            if d_launch != n_layers or fa.SELECTION_COUNTS["dense"] != dense:
                raise SystemExit(f"{name}: {d_launch} kernel launches (want {n_layers}), "
                                 f"dense selections {fa.SELECTION_COUNTS['dense'] - dense}")
            if rep:
                walls.append(wall)
        p50 = statistics.median(walls)
        report.append({"request": name, "rows": n_rows, "p50_ms": p50 * 1e3,
                       "rows_per_s": n_rows / p50})
    return report


# Device kernels by what they do, from their names (first match wins).
KERNEL_KINDS = (
    ("flash_attention", ("flash_fwd",)),
    ("matmul", ("nvjet", "gemm", "cutlass", "xmma")),
    ("layer_norm", ("layer_norm",)),
    ("memcpy", ("Memcpy", "Memset")),
    ("reduce_sort_softmax", ("reduce", "sort", "Sort", "softmax")),
    ("elementwise", ("elementwise", "copy", "Gelu", "fill")),
)


def kernel_kind(name: str) -> str:
    return next((kind for kind, keys in KERNEL_KINDS if any(k in name for k in keys)),
                "other")


def profile_request(classify, ctx, payload) -> dict:
    """One request under torch.profiler: wall time, summed device time of
    its kernels (so 1 - device/wall is the device's idle share, kernels
    being serialised on one stream), device time by kind of kernel, and the
    kernels that took the most."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        classify(dict(payload), ctx)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    by_kind: dict = {}
    for e in events:
        kind = kernel_kind(e.key)
        by_kind[kind] = by_kind.get(kind, 0.0) + e.self_device_time_total / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": 1 - device_ms / wall_ms if wall_ms else None,
            "device_ms_by_kind": by_kind,
            "top_kernels": [[e.key[:80], e.count, e.self_device_time_total / 1e3]
                            for e in top]}


def main() -> int:
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
    paths = build.build_all(["flash_attention"])
    ptxas = {}
    for name in paths:
        log = (build.BUILD_DIR / f"{name}.nvcc.log")
        lines = log.read_text().splitlines() if log.exists() else []
        ptxas[name] = [ln.split("info    : ")[-1] for ln in lines
                       if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {n: {"so": p.name, "build_s": build.BUILD_SECONDS.get(n)}
                      for n, p in paths.items()}, "ptxas": ptxas})

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

    # 3. kernel vs plain
    kernel_check = check_kernels(fa, staged_cases(
        classify, requests + long_requests + [("small_f32", small_payload, 12)]))

    # 4. main path
    rt = TorchRuntime()
    ctx = OpContext(runtime=rt)
    t_build = time.perf_counter()
    classify(dict(requests[0][1]), ctx)  # builds the BERT-base weights once
    build_weights_s = time.perf_counter() - t_build
    fa.LAUNCH_COUNTS["flash_attention"] = 0
    fa.SELECTION_COUNTS.update(flash=0, dense=0)
    report = timed_requests(classify, ctx, fa, requests, BERT_BASE["n_layers"], k)
    main_launches = fa.LAUNCH_COUNTS["flash_attention"]
    main_selection = dict(fa.SELECTION_COUNTS)
    profile = profile_request(classify, ctx, requests[2][1])

    # The 64-row request again, asking for every class, with the plain
    # attention swapped in (a test hook: a runtime with another attention
    # function, sharing the weights), and with the planted tile drop.
    class HookedRuntime(TorchRuntime):
        def __init__(self, attn):
            super().__init__()
            self._params, self._attn = rt._params, attn

        def attention_fn(self):
            return self._attn

    every_class = dict(requests[1][1], topk=1000)
    kernel_out = classify(dict(every_class), ctx)
    plain_out = classify(dict(every_class), OpContext(runtime=HookedRuntime(
        fa.flash_attention_reference)))
    fault_out = classify(dict(every_class), OpContext(runtime=HookedRuntime(
        lambda q, k_, v, mask: fa.flash_attention_reference(q, k_, v, drop_first_tile(mask)))))
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
    if not vs_plain["ok"] or fault_vs_plain["ok"] or not vs_cpu["ok"]:
        raise SystemExit("op results disagree (or the planted fault went unnoticed)")

    # 5. long context
    rt.clear_params()
    classify(dict(long_payload), ctx)  # weights
    fa.LAUNCH_COUNTS["flash_attention"] = 0
    fa.SELECTION_COUNTS.update(flash=0, dense=0)
    long_report = timed_requests(classify, ctx, fa, long_requests, 4, k)
    emit({"phase": "long_context", "config": LONG_CTX, "requests": long_report,
          "launches": fa.LAUNCH_COUNTS["flash_attention"],
          "selection": dict(fa.SELECTION_COUNTS)})
    rt.clear_params()

    # 6. kernels: timed on the 256-row request's staged shape and key lengths.
    q, k_, v, mask, lengths = kernel_check["inputs"]
    B, H, L, D = q.shape
    ms = cuda_ms(lambda: fa.flash_attention(q, k_, v, mask))
    plain_ms = cuda_ms(lambda: fa.flash_attention_reference(q, k_, v, mask), iters=5)
    bool_mask = mask > 0
    library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k_, v, attn_mask=bool_mask))
    n_bytes = 4 * B * H * L * D * q.element_size() + mask.numel() * mask.element_size()
    flops = 4 * H * L * D * float(np.sum(lengths))  # products with real keys only
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    emit({"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "agent_tpu_torch/kernels/csrc/flash_attention.cu",
        "replaces": "agent_tpu/kernels/flash_attention.py:149",
        "launches": main_launches,
        "max_abs_err": kernel_check["max_abs_err"],
        "max_rel_err": kernel_check["max_rel_err"],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
        "shape": [B, H, L, D],
        "dtype": str(q.dtype).split(".")[-1],
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
