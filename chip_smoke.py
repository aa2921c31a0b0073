#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (modalities_tpu_torch) on one
NVIDIA H100: the quickest proof that the port builds and serves on the card.

    python3 chip_smoke.py

Phases (each raises on failure, so any failed phase exits non-zero):
  0. the card's name and power limit; sm_90 required; build the kernels from
     modalities_tpu_torch/csrc with nvcc and report the build time.
  1. every kernel against its plain PyTorch version on the card, at the shapes
     the serving path gives it, with stated tolerances; per-kernel times
     (kernel, plain version, one library call as a yardstick, least possible).
     A small GPT2 then runs prefill + decode on the card and on the CPU with the
     same weights: logits must agree (the end-to-end reference check).
  2. serve the 2.7B GPT2 of configs/config_2p7b_dp.yaml (full width and depth,
     random weights from a seed) with bf16 weights: 9 requests through 8 slots
     of a 2048-token ring cache. Every request finishes; the RMSNorm kernel ran
     65 times per forward; one greedy request re-served alone gets bitwise its
     batched tokens.
  3. the same weights quantized to int8 and to fp8: every request finishes and
     the dequant-matmul kernel ran 225 times per forward.
  4. one JSON line naming the kernels, then the device line (last line).

Exits non-zero, printing no result, without a CUDA device or without the rest
of the repository beside it.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from typing import Any

import numpy as np

PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12  # dense tensor-core bf16
PEAK_F32_FLOPS = 67e12  # fp32 outside the tensor cores
L2_FLUSH_BYTES = 128 * 2**20  # > the 50 MB L2: every timed call starts cold, as in a decode step
SPIN_CYCLES = 2_000_000  # ~1 ms at 1.98 GHz: covers the host's enqueue of one timed call

MODEL_2P7B = {  # config_serve.yaml's model node at configs/config_2p7b_dp.yaml's widths
    "sample_key": "input_ids",
    "prediction_key": "logits",
    "poe_type": "NOPE",
    "sequence_length": 4096,
    "vocab_size": 50304,
    "n_layer": 32,
    "n_head_q": 32,
    "n_head_kv": 8,
    "n_embd": 2560,
    "ffn_hidden": 11520,
    "dropout": 0.0,
    "bias": False,
    "attention_config": {
        "qkv_transforms": [
            {"type_hint": "RotaryTransform", "config": {"n_embd": 2560, "n_head": 32, "base_freq": 10000}}
        ]
    },
    "attention_implementation": "manual",
    "activation_type": "swiglu",
    "attention_norm_config": {"norm_type": "rms_norm", "config": {"ndim": 2560, "bias": False, "epsilon": 1e-5}},
    "ffn_norm_config": {"norm_type": "rms_norm", "config": {"ndim": 2560, "bias": False, "epsilon": 1e-5}},
    "lm_head_norm_config": {"norm_type": "rms_norm", "config": {"ndim": 2560, "bias": False, "epsilon": 1e-5}},
    "use_weight_tying": False,
}
SLOTS, CAPACITY, NEW_TOKENS = 8, 2048, 64
QMM_SHAPES = [(2560, 2560), (2560, 640), (2560, 7680), (7680, 2560), (2560, 50304)]  # (K, N) per decode step


def log(msg: str) -> None:
    print(msg, flush=True)


class _IdTok:
    """Identity tokenizer: prompts and completions stay token-id lists."""

    def tokenize(self, ids):
        return list(ids)

    def decode(self, ids):
        return list(ids)

    def get_token_id(self, token):
        return -1


def time_ms(torch, fn, reps: int = 20) -> float:
    """Mean device time of `fn` over `reps` calls, each after an L2 flush,
    measured with CUDA events around the call alone. A spin kernel queued
    before the start event keeps the card busy while the host enqueues `fn`,
    so host-side wrapper time does not show up as device time."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def host_us(torch, fn, reps: int = 200) -> float:
    """Host time per call of `fn` (enqueue only, no synchronisation inside the
    loop): what a call costs the host in an eager decode step."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(reps):
        fn()
    elapsed = time.perf_counter() - start
    torch.cuda.synchronize()
    return 1e6 * elapsed / reps


def check_close(torch, got, want, atol: float, rtol: float, what: str) -> float:
    """Raise unless |got - want| <= atol + rtol*|want| elementwise; returns the max abs error."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if not torch.isfinite(got).all() or bool(bad.any()):
        raise AssertionError(f"{what}: {int(bad.sum())} elements outside atol={atol:g} rtol={rtol:g}, "
                             f"max abs err {float(err.max()):g}")
    return float(err.max())


# ---------------------------------------------------------------- phase 1
def phase_kernels(torch) -> dict:
    import torch.nn.functional as F

    from modalities_tpu_torch.ops.quant_matmul import quant_matmul, reference_quant_matmul
    from modalities_tpu_torch.ops.rmsnorm import reference_rms_norm, rms_norm
    from modalities_tpu_torch.quant.core import quantize_fp8, quantize_per_channel

    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 plain version is full fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    out: dict[str, Any] = {}

    # RMSNorm. Tolerances: f32 atol/rtol 1e-5 (the kernel's warp-tree sum vs
    # torch's mean: a few f32 ulps); bf16 two bf16 ulps (rtol 2^-6) on the
    # output rounded from those fp32 values.
    e, eps, err_max, cases = 2560, 1e-5, 0.0, 0
    for dtype, tol in ((torch.float32, (1e-5, 1e-5)), (torch.bfloat16, (1e-6, 2**-6))):
        for n in (1, 4, 8, 16, 64, 1000):  # decode 8, prefill ladder 64/16/4/1, and many rows
            x = torch.randn(n, e, generator=g, device=dev).to(dtype)
            for affine in (False, True):
                s = torch.randn(e, generator=g, device=dev) if affine else None
                b = torch.randn(e, generator=g, device=dev) if affine else None
                y, r = rms_norm(x, s, b, eps=eps, residual=True)
                torch.cuda.synchronize()
                err_max = max(err_max, check_close(torch, y, reference_rms_norm(x, s, b, eps=eps), *tol,
                                                   f"rms_norm {dtype} N={n} affine={affine}"))
                r_ref = torch.rsqrt((x.float() ** 2).mean(-1, keepdim=True) + eps)
                check_close(torch, r, r_ref, 0.0, 1e-5, f"rms_norm residual {dtype} N={n}")
                cases += 1
    timings = []
    for n in (8, 64):  # decode rows, largest prefill chunk
        x = torch.randn(n, e, generator=g, device=dev).to(torch.bfloat16)
        s = torch.randn(e, generator=g, device=dev)
        s_lib = s.to(torch.bfloat16)
        nbytes = 2 * n * e * 2 + 4 * e + 4 * n  # x in, y out, scale, r
        bound = 1e3 * max(nbytes / PEAK_BYTES_S, 4.0 * n * e / PEAK_F32_FLOPS)
        timings.append({
            "shape": f"x[{n},{e}] bf16, scale f32",
            "ms": time_ms(torch, lambda: rms_norm(x, s, eps=eps)),
            "plain_ms": time_ms(torch, lambda: reference_rms_norm(x, s, eps=eps)),
            "library_ms": time_ms(torch, lambda: F.rms_norm(x, (e,), s_lib, eps)),
            "bound_ms": bound,
        })
    out["rmsnorm"] = {"max_abs_err": err_max, "timings": timings}
    x = torch.randn(8, e, generator=g, device=dev).to(torch.bfloat16)
    s = torch.randn(e, generator=g, device=dev)
    s_lib = s.to(torch.bfloat16)
    log(f"[phase 1] host us per call at x[8,{e}] bf16: "
        f"rms_norm wrapper {host_us(torch, lambda: rms_norm(x, s, eps=eps)):.1f}, "
        f"plain version {host_us(torch, lambda: reference_rms_norm(x, s, eps=eps)):.1f}, "
        f"F.rms_norm {host_us(torch, lambda: F.rms_norm(x, (e,), s_lib, eps)):.1f}, "
        f"one torch.add {host_us(torch, lambda: torch.add(x, x)):.1f}")
    for t in timings:
        log(f"[phase 1] rms_norm {t['shape']}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
            f"F.rms_norm {t['library_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms (bytes)")
    log(f"[phase 1] rms_norm: {cases} cases agree, max abs err {err_max:g}")

    # Dequant-matmul. Tolerances: f32 x |err| <= 1e-5*max|ref| (fp32 sums of
    # up to 7680 products in another order); bf16 x the same plus two bf16
    # ulps (rtol 2^-6) for the final rounding of values near a boundary.
    err_max, cases = 0.0, 0
    weights = {}
    for k, n in QMM_SHAPES:
        w = torch.randn(n, k, generator=g, device=dev) * 0.02  # [out, in] rows -> per-out scales
        q8, s8 = quantize_per_channel(w)
        qf, sf = quantize_fp8(w)
        weights[(k, n)] = {"int8": (q8.t().contiguous(), s8[:, 0].contiguous()),
                           "fp8": (qf.t().contiguous(), sf[:, 0].contiguous()), "bf16": w.t().contiguous().bfloat16()}
    for (k, n), ws in weights.items():
        for mode in ("int8", "fp8"):
            wq, scale = ws[mode]
            for m in (1, 4, 8, 16, 64):  # decode 8, prefill ladder 64/16/4/1
                for dtype in (torch.bfloat16, torch.float32):
                    x = torch.randn(m, k, generator=g, device=dev).to(dtype)
                    got = quant_matmul(x, wq, scale)
                    torch.cuda.synchronize()
                    want = reference_quant_matmul(x, wq, scale)
                    atol = 1e-5 * float(want.float().abs().max())
                    rtol = 2**-6 if dtype == torch.bfloat16 else 0.0
                    err_max = max(err_max, check_close(torch, got, want, atol, rtol,
                                                       f"quant_matmul {mode} {dtype} M={m} K={k} N={n}"))
                    cases += 1
    log(f"[phase 1] quant_matmul: {cases} cases agree, max abs err {err_max:g}")
    timings = []
    for m in (8, 64):
        for k, n in QMM_SHAPES:
            x_dtype = torch.float32 if n == 50304 else torch.bfloat16  # the untied head runs in fp32
            wq, scale = weights[(k, n)]["int8"]
            w_lib = weights[(k, n)]["bf16"].to(x_dtype)
            x = torch.randn(m, k, generator=g, device=dev).to(x_dtype)
            xb = x.element_size()
            flops = 2.0 * m * k * n
            nbytes = m * k * xb + k * n + 4 * n + m * n * xb  # x, wq (1 byte), scale in; y out
            peak = PEAK_F32_FLOPS if x_dtype == torch.float32 else PEAK_BF16_FLOPS
            bound = 1e3 * max(nbytes / PEAK_BYTES_S, flops / peak)
            timings.append({
                "shape": f"x[{m},{k}] {str(x_dtype)[6:]} @ int8[{k},{n}]",
                "m": m, "k": k, "n": n,
                "ms": time_ms(torch, lambda: quant_matmul(x, wq, scale)),
                "plain_ms": time_ms(torch, lambda: reference_quant_matmul(x, wq, scale)),
                "library_ms": time_ms(torch, lambda: torch.matmul(x, w_lib) * scale),
                "bound_ms": bound,
                "bound_by": "bytes" if nbytes / PEAK_BYTES_S >= flops / peak else "operations",
            })
    wq, scale = weights[(2560, 2560)]["int8"]
    w_lib = weights[(2560, 2560)]["bf16"]
    x = torch.randn(8, 2560, generator=g, device=dev).to(torch.bfloat16)
    log(f"[phase 1] host us per call at x[8,2560] bf16 @ int8[2560,2560]: quant_matmul wrapper "
        f"{host_us(torch, lambda: quant_matmul(x, wq, scale)):.1f}, "
        f"plain version {host_us(torch, lambda: reference_quant_matmul(x, wq, scale)):.1f}, "
        f"bf16 torch.matmul {host_us(torch, lambda: torch.matmul(x, w_lib)):.1f}")
    for t in timings:
        log(f"[phase 1] quant_matmul {t['shape']}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
            f"matmul+scale {t['library_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms ({t['bound_by']})")
    per_layer = {"q": (2560, 2560), "k": (2560, 640), "v": (2560, 640), "c_proj": (2560, 2560),
                 "W": (2560, 7680), "V": (2560, 7680), "W_2": (7680, 2560)}
    for m in (8, 64):
        row = {(t["k"], t["n"]): t for t in timings if t["m"] == m}
        step = {key: 32 * sum(row[kn][key] for kn in per_layer.values()) + row[(2560, 50304)][key]
                for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        log(f"[phase 1] quant_matmul, all 225 calls of one forward at M={m}: kernel {step['ms']:.3f} ms, "
            f"plain {step['plain_ms']:.3f} ms, matmul+scale {step['library_ms']:.3f} ms, bound {step['bound_ms']:.3f} ms")
    out["quant_matmul"] = {"max_abs_err": err_max, "timings": timings}
    return out


def phase_small_model_reference(torch) -> None:
    """A small GPT2 (f32 compute) on the card, through both kernels, against the
    same module on the CPU (plain versions): prefill + decode logits agree."""
    from modalities_tpu_torch.models.gpt2.gpt2_model import GPT2LLM
    from modalities_tpu_torch.quant.weights import quantize_params, quantized_model

    cfg = dict(MODEL_2P7B, vocab_size=256, n_layer=2, n_head_q=4, n_head_kv=2, n_embd=128, ffn_hidden=256,
               sequence_length=64)
    for key in ("attention_norm_config", "ffn_norm_config", "lm_head_norm_config"):
        cfg[key] = {"norm_type": "rms_norm", "config": {"ndim": 128, "bias": False, "epsilon": 1e-5}}
    cfg["attention_config"] = {"qkv_transforms": [{"type_hint": "RotaryTransform",
                                                   "config": {"n_embd": 128, "n_head": 4}}]}
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(rng.integers(0, 256, size=(1, 11)))
    steps = [torch.as_tensor(rng.integers(0, 256, size=(4, 1))) for _ in range(4)]
    for mode in ("none", "int8"):
        model = GPT2LLM(**cfg).with_spec_updates(compute_dtype="float32")
        params = model.init_params(torch.Generator().manual_seed(0))
        if mode != "none":
            model, params = quantized_model(model, mode), quantize_params(params, mode)
        logits = {}
        for dev in ("cpu", "cuda"):
            module = model.build_module({k: v.to(dev) for k, v in params.items()})
            cache = module.init_slot_cache(4, 32)
            with torch.inference_mode():
                outs = [module.prefill_slot(cache, prompt.to(dev), 2, 0)]
                pos = torch.tensor([3, 5, 11, 0], device=dev)
                for toks in steps:
                    outs.append(module.decode_slots(cache, toks.to(dev), pos))
                    pos = pos + 1
            logits[dev] = [o.cpu() for o in outs]
        for i, (a, b) in enumerate(zip(logits["cuda"], logits["cpu"])):
            check_close(torch, a, b, 1e-4, 1e-4, f"small GPT2 ({mode}) forward {i}: card vs CPU")
    log("[phase 1] small GPT2 (f32, plain and int8): card logits agree with the CPU reference (atol 1e-4)")


# ---------------------------------------------------------------- phases 2-3
def build_model():
    from modalities_tpu_torch.config.component_factory import ComponentFactory
    from modalities_tpu_torch.registry.components import COMPONENTS
    from modalities_tpu_torch.registry.registry import Registry

    @dataclasses.dataclass
    class _ModelOnly:
        model: Any

    node = {"component_key": "model", "variant_key": "gpt2", "config": MODEL_2P7B}
    return ComponentFactory(Registry(COMPONENTS)).build_components({"model": node}, _ModelOnly).model


def make_requests() -> list[dict]:
    rng = np.random.default_rng(2024)
    reqs = []
    for i in range(9):
        length = int(rng.integers(32, 513))
        reqs.append({
            "prompt": rng.integers(0, MODEL_2P7B["vocab_size"], size=length).tolist(),
            "temperature": 0.8 if i in (2, 6) else 0.0,  # 7 greedy, 2 sampled
            "seed": 100 + i,
        })
    return reqs


def serve_phase(torch, model, params, quant: str, reqs: list[dict], device: str = "cuda") -> dict:
    from modalities_tpu_torch.ops.quant_matmul import quant_matmul
    from modalities_tpu_torch.ops.rmsnorm import rms_norm
    from modalities_tpu_torch.serving.serve import ServingComponent

    component = ServingComponent(model, _IdTok(), max_batch_slots=SLOTS, cache_capacity=CAPACITY,
                                 max_new_tokens=NEW_TOKENS, quant={"weights": quant})
    component.device, component.params = torch.device(device), params
    rms0, qmm0 = rms_norm.launches, quant_matmul.launches
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t_build = time.perf_counter()
    engine = component.build_engine()
    if device == "cuda":
        torch.cuda.synchronize()
    t_build = time.perf_counter() - t_build
    rids = [engine.submit(r["prompt"], NEW_TOKENS, temperature=r["temperature"], seed=r["seed"]) for r in reqs]
    t0 = time.perf_counter()
    results = engine.run()
    wall = time.perf_counter() - t0
    stats = dict(engine.stats())
    res = [results[r] for r in rids]
    for i, r in enumerate(res):
        if r.finish_reason not in ("budget", "eod"):
            raise AssertionError(f"{quant}: request {i} finished {r.finish_reason!r}")
    first_finish = min(r.finish_s for r in res[:SLOTS])
    if res[SLOTS].first_token_s < first_finish:
        raise AssertionError("the 9th request was admitted before any slot was freed")
    out = {
        "tokens": [r.tokens for r in res],
        "ttft_s": [r.ttft_s for r in res],
        "stats": stats,
        "wall_s": wall,
        "build_s": t_build,
    }
    if quant == "none":  # batch invariance: a greedy request alone == its batched tokens
        alone_rid = engine.submit(reqs[0]["prompt"], NEW_TOKENS, temperature=0.0, seed=reqs[0]["seed"])
        alone = engine.run()[alone_rid].tokens
        if alone != res[0].tokens:
            raise AssertionError("batch invariance: request 0 alone differs from its batched tokens")
    out["profile"] = profile_decode(torch, engine, reqs) if device == "cuda" else None
    out["forward_calls"] = engine.stats()["forward_calls"]
    out["rms_launches"] = rms_norm.launches - rms0
    out["qmm_launches"] = quant_matmul.launches - qmm0
    if device == "cuda":
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del engine, component
        torch.cuda.empty_cache()
    return out


def profile_decode(torch, engine, reqs: list[dict], steps: int = 8) -> dict:
    """Where a decode step's time goes: torch.profiler over `steps` batched
    decode steps with all slots busy (prompts cut to one 64-token chunk).
    busy = summed device time of the window's kernels / the window's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for r in reqs[:SLOTS]:
        engine.submit(r["prompt"][:64], steps + 2, temperature=0.0, seed=r["seed"])
    t0 = time.monotonic()
    engine.step(t0)  # admissions (prefill) and the first decode step stay outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        for _ in range(steps):
            engine.step(t0)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - w0)
    engine.run()  # drain
    rows = []  # per decode step: (device ms, calls, kernel); kernels only, not the ops that launch them
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0.0)
        if ev.device_type == DeviceType.CUDA and dev_us > 0:
            rows.append((dev_us / 1e3 / steps, ev.count / steps, ev.key))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    return {"wall_ms": wall_ms / steps, "device_ms": device_ms, "launches": sum(r[1] for r in rows), "top": rows[:8]}


def report_profile(name: str, r: dict) -> None:
    """Device time per decode step (profiled window) against the unprofiled
    run's host time per step: busy = device / host-step time."""
    p, s = r["profile"], r["stats"]
    step_ms = 1e3 * s["decode_seconds"] / s["decode_steps"]
    log(f"[{name}] decode step: {p['device_ms']:.3f} ms of kernels ({p['launches']:.0f} launches) per "
        f"{step_ms:.2f} ms step -> device busy {p['device_ms'] / step_ms:.3f} "
        f"(profiled window: {p['wall_ms']:.2f} ms/step under the profiler)")
    for ms, count, key in p["top"]:
        log(f"[{name}]   {ms:.4f} ms/step in {count:.0f} x {key[:90]}")


def report_serve(name: str, r: dict) -> None:
    s = r["stats"]
    ttft = np.asarray(r["ttft_s"]) * 1e3
    log(f"[{name}] {s['decode_tokens']} decode tokens in {s['decode_steps']} steps, "
        f"{s['prefill_chunks']} prefill chunks; decode {s['decode_tokens'] / s['decode_seconds']:.1f} tokens/s "
        f"over this short trace (informational, not a throughput measurement) "
        f"({1e3 * s['decode_seconds'] / s['decode_steps']:.2f} ms/step, occupancy {s['slot_occupancy']:.3f}); "
        f"TTFT ms p50 {np.percentile(ttft, 50):.1f} max {ttft.max():.1f}; "
        f"prefill {s['prefill_seconds']:.2f} s, run wall {r['wall_s']:.2f} s; "
        f"KV cache {s['kv_pool_bytes'] / 1e9:.3f} GB, weights {s['weights_bytes'] / 1e9:.3f} GB, "
        f"peak mem {r['peak_mem_gb']:.1f} GB; engine build {r['build_s']:.1f} s")


def greedy_agreement(reqs, base, other) -> float:
    same = total = 0
    for req, a, b in zip(reqs, base, other):
        if req["temperature"] == 0.0:
            total += len(a)
            same += sum(x == y for x, y in zip(a, b))
    return same / total


# ---------------------------------------------------------------- main
def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    try:
        from modalities_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the modalities_tpu_torch package is not beside this script ({e})", file=sys.stderr)
        return 2

    # phase 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[phase 0] {smi}")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"needs an sm_90 card, got capability {cap}")
    log(f"[phase 0] torch {torch.__version__} cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t = time.perf_counter()
    _build.library()
    built = _build.build_seconds
    log(f"[phase 0] kernels {'built in %.1f s' % built if built is not None else 'loaded'} "
        f"({time.perf_counter() - t:.1f} s) -> {_build.library_path()}")

    # phase 1
    kernels = phase_kernels(torch)
    phase_small_model_reference(torch)

    # phases 2-3: the main path. Counts start from 0 here; launches above were comparisons.
    from modalities_tpu_torch.ops.quant_matmul import quant_matmul
    from modalities_tpu_torch.ops.rmsnorm import rms_norm

    model = build_model()
    t = time.perf_counter()
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"[phase 2] 2.7B params ({sum(p.numel() for p in params.values()) / 1e9:.3f} B, fp32) "
        f"initialized on the card in {time.perf_counter() - t:.1f} s")
    reqs = make_requests()
    log(f"[phase 2] 9 requests, prompt lengths {[len(r['prompt']) for r in reqs]}, {NEW_TOKENS} new tokens each")
    rms_norm.launches = 0
    quant_matmul.launches = 0
    runs = {}
    for quant, phase in (("none", "phase 2"), ("int8", "phase 3"), ("fp8", "phase 3")):
        r = serve_phase(torch, model, params, quant, reqs)
        runs[quant] = r
        fwd = r["forward_calls"]
        if r["rms_launches"] != 65 * fwd:
            raise AssertionError(f"{quant}: rms_norm launched {r['rms_launches']} times, expected 65 x {fwd}")
        want_qmm = 0 if quant == "none" else 225 * fwd
        if r["qmm_launches"] != want_qmm:
            raise AssertionError(f"{quant}: quant_matmul launched {r['qmm_launches']} times, expected {want_qmm}")
        report_serve(f"{phase} {quant if quant != 'none' else 'bf16'}", r)
        report_profile(f"{phase} {quant if quant != 'none' else 'bf16'}", r)
        log(f"[{phase}] launches: rms_norm {r['rms_launches']} = 65 x {fwd} forwards, "
            f"quant_matmul {r['qmm_launches']}")
        if quant != "none":
            log(f"[{phase}] {quant}: greedy tokens agreeing with bf16 position by position: "
                f"{greedy_agreement(reqs, runs['none']['tokens'], r['tokens']):.3f} (information only)")
    log("[phase 2] batch invariance: request 0 served alone matches its batched tokens bitwise")
    rms_total, qmm_total = rms_norm.launches, quant_matmul.launches
    if rms_total == 0 or qmm_total == 0:
        raise AssertionError("a kernel of the serving path was never launched")

    # phase 4
    def entry(name, source, replaces, launches, k, pick):
        t = pick(kernels[k]["timings"])
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
                "max_abs_err": kernels[k]["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t.get("bound_by", "bytes"), "library_ms": t["library_ms"],
                "shape": t["shape"]}

    print(json.dumps({"kernels": [
        entry("fused_rmsnorm_fwd", "modalities_tpu_torch/csrc/fused_rmsnorm.cu",
              "modalities_tpu/ops/pallas/fused_rmsnorm.py:34", rms_total, "rmsnorm", lambda ts: ts[0]),
        entry("quant_matmul", "modalities_tpu_torch/csrc/quant_matmul.cu",
              "modalities_tpu/ops/pallas/quant_matmul.py:31", qmm_total, "quant_matmul",
              lambda ts: next(t for t in ts if t["m"] == 8 and (t["k"], t["n"]) == (2560, 7680))),
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
