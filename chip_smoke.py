#!/usr/bin/env python3
"""Drive paddle_tpu_torch, the PyTorch / CUDA port, on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py [--seed N]
[--out DIR] [--profile]

Phases, each printing its own lines; any failure raises and exits non-zero
without the final result line:

1. device: `nvidia-smi` name and power limit, torch's device name;
2. build: every CUDA kernel of the port with nvcc (sm_90a), in parallel;
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card at the main path's shapes, in bf16 and fp32, max abs error
   beside the tolerance; kernel, plain-version and library (yardstick
   only) device times by CUDA events over calls queued behind a spin (and
   the kernel's time when issued call by call from Python), and the
   bound: the larger of bytes over 3.35 TB/s and operations over the
   peak rate of the input type;
4. slice: LLaMA-7B at full width (random bf16 weights from --seed, drawn
   on the card) served by ServingEngine (page_size 16, 8 rows,
   max_seq_len 1024, decode_horizon 8, bf16 pools): 8 greedy requests,
   two arriving after the first steps. Launch counters are zeroed just
   before and read just after; each kernel must have launched. Two
   requests are re-scored by the no-cache forward: wherever its top-2
   logit margin exceeds the stated tolerance, the engine's token must be
   its argmax.

The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}. This script imports no JAX and nothing of
paddle_tpu; the card machine has neither.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet; dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# tolerances of kernel vs plain version (max abs error), by type: the
# kernels keep fp32 where the plain versions round to bf16 (attention
# probabilities, norm outputs), so bf16 allows a few bf16 ulps of O(1)
# (one ulp is 0.0156 for outputs in [2, 4))
TOL = {
    "K1": {torch.float32: 2e-4, torch.bfloat16: 5e-2},
    "K4": {torch.float32: 1e-4, torch.bfloat16: 6e-2},
    "K6": {torch.float32: 2e-4, torch.bfloat16: 3e-2},
}
# the engine's greedy token must be the no-cache argmax wherever the top-2
# margin of the no-cache logits exceeds this: the paged and no-cache bf16
# paths round differently, and on an H100 positions whose tokens differed
# had margins below 0.05 (PERF.md), so 0.15 leaves a 3x guard band
MARGIN_TOL = 0.15


def log(*parts):
    print(*parts, flush=True)


def time_ms(fn, iters=20, warmup=3, queued=True):
    """Mean time of fn() by CUDA events over `iters` calls. With `queued`
    the card first runs a ~25 ms spin while the host enqueues every call,
    so the events time the kernels back to back (device time); without
    it, calls that take the host longer to launch than the card to run
    are timed at the host's launch rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, flops, dtype):
    """(bound_ms, bound_by) for work moving `nbytes` and doing `flops`."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def check(name, err, dtype):
    tol = TOL[name][dtype]
    if not err <= tol:      # NaN fails too
        raise AssertionError(f"{name} {dtype}: max abs error {err} > {tol}")
    return tol


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


# ------------------------------------------------------------------ phases

def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    log(f"[device] nvidia-smi: {line}")
    log(f"[device] torch: {torch.cuda.get_device_name(0)} "
        f"cuda {torch.version.cuda} torch {torch.__version__} "
        f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return line


def phase_build(out_dir):
    from paddle_tpu_torch import _build

    secs = _build.build_all(force=True)
    log(f"[build] nvcc sm_90a {list(_build.SOURCES)} in {secs:.1f} s")
    for name, text in _build.BUILD_LOGS.items():
        regs = [ln.strip() for ln in text.splitlines() if "registers" in ln]
        log(f"[build] {name}: {len(regs)} kernels; " + " | ".join(regs[:2]))
        if out_dir:
            with open(os.path.join(out_dir, f"ptxas_{name}.log"), "w") as f:
                f.write(text)
    return secs


def k1_cases(rows, dev):
    """Flash-attention forward at the prefill shape (1, 512, 32, 128)."""
    from paddle_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(1)
    b, s, h, d = 1, 512, 32, 128
    causal = torch.full((s, s), -1e9, device=dev).triu(1)[None, None]
    main = None
    for dtype in (torch.bfloat16, torch.float32):
        def rnd(*shape):
            return torch.randn(*shape, generator=g, device=dev).to(dtype)
        q, k, v = rnd(b, s, h, d), rnd(b, s, h, d), rnd(b, s, h, d)
        kv8 = [rnd(b, s, 8, d) for _ in range(2)]
        cases = [
            ("no mask", (q, k, v), {}),
            ("causal float mask", (q, k, v), {"attn_mask": causal}),
            # the engine's prefill call: the mask plus is_causal, which
            # lets the kernel skip the tiles above the diagonal
            ("causal float mask + is_causal", (q, k, v),
             {"attn_mask": causal, "is_causal": True}),
            ("gqa 32/8 expanded, is_causal",
             (q, kv8[0].repeat_interleave(4, 2),
              kv8[1].repeat_interleave(4, 2)), {"is_causal": True}),
        ]
        for label, (q_, k_, v_), kw in cases:
            got = fa.flash_attention(q_, k_, v_, **kw)
            ref = fa.flash_attention_reference(q_, k_, v_, **kw)
            torch.cuda.synchronize()
            err = max_err(got, ref)
            tol = check("K1", err, dtype)
            ms = time_ms(lambda: fa.flash_attention(q_, k_, v_, **kw))
            issued_ms = time_ms(lambda: fa.flash_attention(q_, k_, v_, **kw),
                                queued=False)
            plain_ms = time_ms(
                lambda: fa.flash_attention_reference(q_, k_, v_, **kw), 5, 1)
            qt, kt, vt = (x.transpose(1, 2) for x in (q_, k_, v_))
            mask = kw.get("attn_mask")
            # sdpa takes a mask or is_causal, not both: the causal mask
            # alone is the same function
            lib_ms = time_ms(lambda: torch.nn.functional
                             .scaled_dot_product_attention(
                                 qt, kt, vt, attn_mask=(None if mask is None
                                                        else mask.to(dtype)),
                                 is_causal=(mask is None
                                            and kw.get("is_causal", False))))
            pairs = s * (s + 1) // 2 if (kw or mask is not None) else s * s
            flops = 4 * b * h * d * pairs
            io = nbytes(q_, k_, v_, got) + (nbytes(mask) if mask is not None
                                            else 0)
            bms, by = bound(io, flops, dtype)
            log(f"[K1] {str(dtype)[6:]} {label}: max_abs_err {err:.3g} "
                f"(tol {tol}) kernel {ms:.4f} ms (issued from Python "
                f"{issued_ms:.4f}) plain {plain_ms:.4f} ms library "
                f"{lib_ms:.4f} ms bound {bms:.4f} ms ({by})")
            row = dict(dtype=str(dtype)[6:], case=label, max_abs_err=err,
                       tol=tol, ms=ms, issued_ms=issued_ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=bms, bound_by=by)
            rows.append(("K1", row))
            if dtype == torch.bfloat16 and label.endswith("+ is_causal"):
                main = row
    return main


def k4_cases(rows, dev):
    """Fused RMSNorm / LayerNorm forward at (512, 4096) and (8, 4096)."""
    from paddle_tpu_torch.ops import norm

    g = torch.Generator(device=dev).manual_seed(2)
    main = None
    for dtype in (torch.bfloat16, torch.float32):
        for n in (512, 8):
            x = torch.randn(n, 4096, generator=g, device=dev).to(dtype)
            w = (1 + 0.1 * torch.randn(4096, generator=g, device=dev)
                 ).to(dtype)
            bias = (0.1 * torch.randn(4096, generator=g, device=dev)
                    ).to(dtype)
            for mode, bb, sub in (("rms", None, False), ("layer", bias, True)):
                y, mu, rs = norm.norm_forward(x, w, bb, 1e-6, sub)
                ry, rmu, rrs = norm.norm_forward_reference(x, w, bb, 1e-6,
                                                           sub)
                torch.cuda.synchronize()
                err = max(max_err(y, ry), max_err(mu, rmu),
                          max_err(rs, rrs) / float(rrs.abs().max()))
                tol = check("K4", err, dtype)
                ms = time_ms(lambda: norm.norm_forward(x, w, bb, 1e-6, sub))
                issued_ms = time_ms(lambda: norm.norm_forward(
                    x, w, bb, 1e-6, sub), queued=False)
                plain_ms = time_ms(lambda: norm.norm_forward_reference(
                    x, w, bb, 1e-6, sub))
                tF = torch.nn.functional
                if sub:
                    lib_ms = time_ms(lambda: tF.layer_norm(
                        x, (4096,), w, bb, 1e-6))
                elif hasattr(tF, "rms_norm"):
                    lib_ms = time_ms(lambda: tF.rms_norm(x, (4096,), w, 1e-6))
                else:
                    lib_ms = None
                io = nbytes(x, w, y, mu, rs) + (nbytes(bb) if sub else 0)
                bms, by = bound(io, (8 if sub else 5) * x.numel(), dtype)
                lib_txt = "n/a" if lib_ms is None else f"{lib_ms:.4f} ms"
                log(f"[K4] {str(dtype)[6:]} {mode} ({n}, 4096): max_abs_err "
                    f"{err:.3g} (tol {tol}) kernel {ms:.4f} ms (issued from "
                    f"Python {issued_ms:.4f}) plain {plain_ms:.4f} ms library "
                    f"{lib_txt} bound {bms:.4f} ms ({by})")
                row = dict(dtype=str(dtype)[6:], case=f"{mode} ({n}, 4096)",
                           max_abs_err=err, tol=tol, ms=ms,
                           issued_ms=issued_ms, plain_ms=plain_ms,
                           library_ms=lib_ms, bound_ms=bms, bound_by=by)
                rows.append(("K4", row))
                if dtype == torch.bfloat16 and n == 512 and not sub:
                    main = row
    return main


def k6_cases(rows, dev):
    """Paged decode at b=8, hd=128, page_size 16, 64 pages per row."""
    from paddle_tpu_torch.serving import attention as att
    from paddle_tpu_torch.serving.kv_cache import PagedLayerCache

    g = torch.Generator(device=dev).manual_seed(3)
    b, hd, ps, maxp = 8, 128, 16, 64
    num_pages = b * maxp + 1
    rng = np.random.RandomState(3)
    spread = np.linspace(0, 1023, b).astype(np.int64)
    parked = spread.copy()
    parked[[2, 5]] = maxp * ps                 # parked rows walk every page
    main = None
    for dtype in (torch.bfloat16, torch.float32):
        for heads, kvh, label, pos_np in (
                (32, 32, "rep 1, positions 0..1023", spread),
                (32, 8, "gqa rep 4", spread),
                (32, 32, "rep 1, 2 parked rows", parked)):
            kp = torch.randn(kvh, num_pages, ps, hd, generator=g,
                             device=dev).to(dtype)
            vp = torch.randn(kvh, num_pages, ps, hd, generator=g,
                             device=dev).to(dtype)
            table = torch.from_numpy(
                rng.permutation(np.arange(1, num_pages))[:b * maxp]
                .reshape(b, maxp).astype(np.int32)).to(dev)
            pos = torch.from_numpy(pos_np.astype(np.int32)).to(dev)
            q = torch.randn(b, 1, heads, hd, generator=g, device=dev).to(dtype)
            cache = PagedLayerCache(kp, vp, table)
            rep = heads // kvh
            got = att.paged_decode_attention(q, cache, pos, rep)
            ref = att._paged_decode_reference(q, cache, pos, rep)
            torch.cuda.synchronize()
            err = max_err(got, ref)
            tol = check("K6", err, dtype)
            ms = time_ms(lambda: att.paged_decode_attention(q, cache, pos,
                                                            rep))
            issued_ms = time_ms(lambda: att.paged_decode_attention(
                q, cache, pos, rep), queued=False)
            plain_ms = time_ms(lambda: att._paged_decode_reference(
                q, cache, pos, rep), 5, 1)
            # yardstick: sdpa over the pages gathered beforehand
            ptl = table.long()
            kg = kp[:, ptl].permute(1, 0, 2, 3, 4).reshape(b, kvh, -1, hd)
            vg = vp[:, ptl].permute(1, 0, 2, 3, 4).reshape(b, kvh, -1, hd)
            kg, vg = (x.repeat_interleave(rep, 1) for x in (kg, vg))
            allowed = (torch.arange(maxp * ps, device=dev)[None, :]
                       <= pos.long()[:, None])
            mask = torch.where(allowed, 0.0, float("-inf")).to(dtype)[
                :, None, None]
            qt = q.transpose(1, 2)
            lib_ms = time_ms(lambda: torch.nn.functional
                             .scaled_dot_product_attention(
                                 qt, kg, vg, attn_mask=mask))
            toks = int(np.minimum(pos_np + 1, maxp * ps).sum())
            io = toks * 2 * kvh * hd * kp.element_size() + nbytes(
                q, got, table, pos)
            bms, by = bound(io, 4 * heads * hd * toks, dtype)
            log(f"[K6] {str(dtype)[6:]} {label}: max_abs_err {err:.3g} "
                f"(tol {tol}) kernel {ms:.4f} ms (issued from Python "
                f"{issued_ms:.4f}) plain {plain_ms:.4f} ms library "
                f"{lib_ms:.4f} ms bound {bms:.4f} ms ({by})")
            row = dict(dtype=str(dtype)[6:], case=label, max_abs_err=err,
                       tol=tol, ms=ms, issued_ms=issued_ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=bms, bound_by=by)
            rows.append(("K6", row))
            if dtype == torch.bfloat16 and label.startswith("rep 1, pos"):
                main = row
            del kp, vp, kg, vg
    return main


def serve(engine, prompts, late, max_new):
    """Add all but the `late` last prompts, step twice, add the rest, run.
    Returns the request ids and the wall seconds."""
    t0 = time.perf_counter()
    rids = [engine.add_request(p, max_new_tokens=max_new)
            for p in prompts[:len(prompts) - late]]
    for _ in range(2):
        engine.step()
    rids += [engine.add_request(p, max_new_tokens=max_new)
             for p in prompts[len(prompts) - late:]]
    engine.run()
    torch.cuda.synchronize()
    return rids, time.perf_counter() - t0


def phase_slice(seed, dev, profile=False, out_dir=None):
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import norm
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.serving import attention as att

    cfg = LlamaConfig.llama7b()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16, seed=seed)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[slice] LLaMA-7B ({cfg.num_hidden_layers} layers, hidden "
        f"{cfg.hidden_size}, {n_params / 1e9:.3f} B params, bf16) drawn on "
        f"the card in {time.perf_counter() - t0:.1f} s")
    for p in model.parameters():
        p.requires_grad_(False)
    engine = ServingEngine(model, page_size=16, max_batch_size=8,
                           max_seq_len=1024, decode_horizon=8,
                           kv_dtype="bf16", device=dev)
    rng = np.random.RandomState(seed)
    # warm-up (Triton specializations, cuBLAS handles): not measured
    serve(engine, [rng.randint(0, cfg.vocab_size, (n,)) for n in (40, 200)],
          1, 9)
    lens = rng.randint(32, 513, 8)
    prompts = [rng.randint(0, cfg.vocab_size, (int(n),)) for n in lens]
    counters = {"K1": fa.flash_attention, "K4": norm.norm_forward,
                "K6": att.paged_decode_attention}
    engine = ServingEngine(model, page_size=16, max_batch_size=8,
                           max_seq_len=1024, decode_horizon=8,
                           kv_dtype="bf16", device=dev)
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    rids, wall = serve(engine, prompts, 2, 32)
    launches = {k: fn.launches for k, fn in counters.items()}
    stats = engine.stats()
    peak = torch.cuda.max_memory_allocated()
    tokens = stats["tokens_generated"]
    ttfts = [stats["requests"][r]["ttft_s"] for r in rids]
    log(f"[slice] prompts {sorted(int(n) for n in lens)}, 32 new tokens "
        f"each, 2 late arrivals: {stats['num_finished']}/8 finished, "
        f"{tokens} tokens in {wall:.3f} s = {tokens / wall:.1f} tokens/s; "
        f"mean TTFT {np.mean(ttfts) * 1e3:.1f} ms; decode "
        f"{stats['decode_tokens_per_s']:.1f} tokens/s over "
        f"{stats['decode_steps']} blocks; peak memory "
        f"{peak / 2**30:.2f} GiB")
    log(f"[slice] launches in the served run: {launches}")
    if stats["num_finished"] != 8 or tokens != 8 * 32:
        raise AssertionError(f"served run incomplete: {stats['num_finished']} "
                             f"finished, {tokens} tokens")
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    # re-score the longest and the shortest request without the cache
    checked = mismatched = 0
    worst = 0.0          # largest top-2 margin at a position that differs
    order = np.argsort(lens)
    for i in (order[-1], order[0]):
        seq = engine.output(rids[i])
        n = len(prompts[i])
        with torch.no_grad():
            logits = model(torch.tensor([seq], device=dev))[0].float()
        if not torch.isfinite(logits).all():
            raise AssertionError("non-finite logits in the no-cache forward")
        top2 = logits[n - 1:-1].topk(2, dim=-1)
        margin = (top2.values[:, 0] - top2.values[:, 1]).cpu().numpy()
        argmax = top2.indices[:, 0].cpu().numpy()
        for j, tok in enumerate(seq[n:]):
            checked += bool(margin[j] > MARGIN_TOL)
            if int(argmax[j]) != tok:
                mismatched += 1
                worst = max(worst, float(margin[j]))
                if margin[j] > MARGIN_TOL:
                    raise AssertionError(
                        f"request {rids[i]} position {n + j}: engine token "
                        f"{tok} != no-cache argmax {int(argmax[j])} with "
                        f"margin {margin[j]:.3f} > {MARGIN_TOL}")
    log(f"[slice] greedy check: {checked} of 64 generated positions had a "
        f"top-2 margin > {MARGIN_TOL} and all matched the no-cache argmax; "
        f"{mismatched} positions differ, the largest margin among them "
        f"{worst:.4f}")
    if checked == 0:
        raise AssertionError("greedy check compared no position")
    prof = phase_profile(model, prompts, dev, out_dir) if profile else None
    br = stats["step_breakdown"]
    log("[slice] host wall by step phase (s): " + ", ".join(
        f"{k} {br[k]['sum']:.3f} over {br[k]['count']}" for k in br)
        + f"; prefill {stats['prefill_time_s']:.3f}, decode "
        f"{stats['decode_time_s']:.3f}")
    return dict(launches=launches, tokens_per_s=tokens / wall, wall_s=wall,
                stats={k: stats[k] for k in ("prefill_time_s",
                                             "decode_time_s",
                                             "step_breakdown", "latency")},
                mean_ttft_s=float(np.mean(ttfts)),
                decode_tokens_per_s=stats["decode_tokens_per_s"],
                peak_bytes=peak, checked=checked, prompt_lens=lens.tolist(),
                profile=prof)


def _device_us(evt):
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profile_window(label, fn, out_dir):
    """Run fn() under torch.profiler; print the wall, the summed device
    time of the kernels (their share of the wall is the device's busy
    share, one stream) and the kernels taking most device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, _device_us(e), e.count) for e in prof.key_averages()
            if _device_us(e) > 0 and e.device_type != torch.autograd
            .DeviceType.CPU]
    busy = sum(us for _, us, _ in rows) / 1e6
    rows.sort(key=lambda r: -r[1])
    log(f"[profile] {label}: wall {wall * 1e3:.1f} ms, kernels "
        f"{busy * 1e3:.1f} ms on the device (busy share "
        f"{busy / wall:.3f})")
    for key, us, count in rows[:8]:
        log(f"[profile]   {us / 1e3:8.3f} ms {count:6d}x {key[:90]}")
    host = sorted(((e.key, e.self_cpu_time_total, e.count)
                   for e in prof.key_averages()), key=lambda r: -r[1])
    log(f"[profile] {label}: host ops by self CPU time")
    for key, us, count in host[:8]:
        log(f"[profile]   {us / 1e3:8.3f} ms {count:6d}x {key[:90]}")
    if out_dir:
        with open(os.path.join(out_dir, f"profile_{label}.txt"), "w") as f:
            f.write(prof.key_averages().table(
                sort_by="self_cuda_time_total", row_limit=40))
    return dict(wall_s=wall, device_s=busy,
                top=[dict(kernel=k, ms=us / 1e3, count=c)
                     for k, us, c in rows[:12]])


def phase_profile(model, prompts, dev, out_dir):
    """Profile one prefill (the longest prompt) and two decode blocks of
    eight rows, on a fresh engine holding all eight requests."""
    from paddle_tpu_torch.serving import ServingEngine

    engine = ServingEngine(model, page_size=16, max_batch_size=8,
                           max_seq_len=1024, decode_horizon=8,
                           kv_dtype="bf16", device=dev)
    order = sorted(prompts, key=len)
    for p in order:
        engine.add_request(p, max_new_tokens=32)
    for _ in range(len(order) - 1):
        engine.step()                     # prefill all but the longest
    out = {"prefill": profile_window("prefill", engine.step, out_dir)}
    engine.step()                         # first decode block, fresh
    out["decode"] = profile_window(
        "decode_2_blocks", lambda: (engine.step(), engine.step()), out_dir)
    return out


KERNELS = {
    "K1": dict(name="flash_attention_forward", route="cuda",
               source="paddle_tpu_torch/csrc/flash_fwd.cu",
               replaces="paddle_tpu/ops/pallas_kernels.py:164"),
    "K4": dict(name="norm_forward", route="triton",
               source="paddle_tpu_torch/ops/norm.py",
               replaces="paddle_tpu/ops/pallas_kernels.py:796"),
    "K6": dict(name="paged_decode_attention", route="cuda",
               source="paddle_tpu_torch/csrc/paged_decode.cu",
               replaces="paddle_tpu/serving/attention.py:530"),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="directory for the full results JSON and the "
                         "ptxas reports")
    ap.add_argument("--profile", action="store_true",
                    help="after the served run, profile one prefill and "
                         "two decode blocks with torch.profiler")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    smi = phase_device()
    dev = torch.device("cuda", 0)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    build_s = phase_build(args.out)
    rows = []
    main_rows = {"K1": k1_cases(rows, dev), "K4": k4_cases(rows, dev),
                 "K6": k6_cases(rows, dev)}
    torch.cuda.empty_cache()
    result = {"nvidia_smi": smi, "build_s": build_s,
              "cases": [dict(kernel=k, **r) for k, r in rows]}
    result["slice"] = phase_slice(args.seed, dev, args.profile, args.out)
    launches = result["slice"]["launches"]
    summary = {"kernels": [
        dict(KERNELS[k], launches=launches[k],
             max_abs_err=main_rows[k]["max_abs_err"], ms=main_rows[k]["ms"],
             plain_ms=main_rows[k]["plain_ms"],
             bound_ms=main_rows[k]["bound_ms"],
             bound_by=main_rows[k]["bound_by"],
             library_ms=main_rows[k]["library_ms"])
        for k in KERNELS]}
    result["summary"] = summary
    result["seconds"] = time.perf_counter() - t_start
    if args.out:
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(result, f, indent=1)
    log(f"[done] {result['seconds']:.1f} s in all")
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
