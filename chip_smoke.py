#!/usr/bin/env python3
"""Drive paddle_tpu_torch, the PyTorch / CUDA port, on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py [--seed N]
[--out DIR] [--profile]

Phases, each printing its own lines; any failure raises and exits non-zero
without the final result line:

1. device: `nvidia-smi` name and power limit, torch's device name;
2. build: every CUDA kernel of the port with nvcc (sm_90a), in parallel;
   the Hopper kernels' (K1, K2, K3, and the paged kernels K6 / K6q and
   K7 / K7q in each of their 24 forms) registers and spill bytes from
   ptxas (a spill, or a kernel missing from the report, fails the phase)
   and their dynamic shared memory;
3. kernels: each hand-written kernel of the serving path (K1, K4, K6)
   against its plain PyTorch version on the card at the serving shapes, in
   bf16 and fp32, max abs error beside the tolerance; K1 also at a
   speculative verify window's shape, (8, 5, 32, 128) queries against (8,
   1024, 32, 128) gathered pages with the paged prefill's float mask, held
   row by row under TOL_REL, and the time of that window's whole paged
   attention (gather + K1); kernel,
   plain-version and library (yardstick only) device times by CUDA events
   over calls queued behind a spin (and the kernel's time when issued call
   by call from Python), and the bound: the larger of bytes over 3.35 TB/s and
   operations over the peak rate of the input type (for K1, the key rows
   and pairs its mask leaves visible);
4. kernels_serve_chunked: the same for the chunked serving path's kernels:
   K6q (K6 over int8 / fp8 pools with scale slabs) at the decode shape
   (b 8, positions 0..1023), and K7 (ragged paged attention) on the flat
   step of the chunked serve (8 decode tokens at 0..1023 plus one
   256-token chunk at 512, padded to T = 328) over bf16, fp32, int8 and fp8
   pools, with a GQA rep-4 case and parked tokens, which must come out
   zero, and over bf16 with the chunk parked and with the decode tokens
   parked (the call's two halves), and with only the chunk's last 17
   tokens (at 1007..1023) live, alone and beside the 8 decode tokens; the
   bytes of split partials each K7 call writes, counted (the partials'
   scratch is filled with a NaN pattern no kernel writes); two launches of
   K6q and of K7 must give the same bits. The library yardstick is sdpa
   over the gathered, dequantized pages. Then the paged edge cases: 72
   runs of K6 / K6q / K7 / K7q against their
   plain versions under TOL (bf16, int8, fp8 pools; head_dim 64 / 128; rep
   1, 2, 4, 8; page sizes 16, 8, 5; positions 0, 15, 16, 17, the last slot,
   a K6 row parked at the capacity; chunks of 1, 15, 16, 17, 65 tokens at
   offset 0 and mid-page, chunk-only and decode-only steps, a 17-token
   run at the last slots, alone (it must write split partials: its keys
   are split) and beside a decode token; K7 tokens parked or naming no row
   must come out exactly zero);
5. train_kernels: the same for the training path's kernels at ERNIE-base
   shapes (b 32, S 512, 12 heads of 64; 16384 rows of 768): K1 with
   attention dropout 0.1, K2 + K3 through `FlashAttention.backward` with
   and without a (32, 1, 1, 512) padding mask, K4 and K5 in LayerNorm mode,
   in the O1 type (fp32) and bf16, and in RMS mode (T5's) in fp32; then
   the flash edge cases: K1 / K2 / K3 against their plain versions at
   sizes around the kernels' tiles (1 to 200 rows, T5's 114 x 512), every
   mask shape (also with 456-byte rows at sk = 114), causal at ring
   offsets, dropout, and rows that see no key, at head_dim 64 and 128;
   and K2's d(mask) against the plain backward's (TOL_REL["K2m"]) for
   (1, h, q, k), (1, 1, q, k) and (b, h, q, k) masks at batch 1, 3 and 5
   and sizes 63, 129, 114 and 114 x 512, causal and not, dropout 0.1 and
   not, at the host's batch groups and at 2 (ragged) groups;
6. serve: LLaMA-7B at full width (random bf16 weights from --seed, drawn
   on the card) served by ServingEngine (page_size 16, 8 rows,
   max_seq_len 1024, decode_horizon 8, bf16 pools): 8 greedy requests,
   two arriving after the first steps. Launch counters are zeroed just
   before and read just after; each kernel must have launched. Two
   requests are re-scored by the no-cache forward: wherever its top-2
   logit margin exceeds the stated tolerance, the engine's token must be
   its argmax;
7. serve_chunked: the same model and engine with chunked prefill (chunks
   of 256, the ragged step) over bf16, then int8, then fp8 pools: 8 greedy
   requests with prompts of 64..960 tokens, 32 new tokens each, 2 late.
   K7 (in the pools' form) and the decode kernel (K6 or K6q) must launch,
   K1 must not; the margin check runs with the pool type's tolerance;
   prints tokens/s, mean TTFT, decode tokens/s, the decode-stall sum, pool
   bytes and peak memory;
8. serve_chained: chunked prefill without the ragged step (bf16, 3
   requests): K1 must launch, through the paged chunk prefill;
9. serve_prefix_spec: the prefix cache and speculative decoding on the
   same model and engine. Eight greedy requests share a 512-token system
   prefix (32 pages) and have their own 32-128-token suffixes, 32 new
   tokens each, two late: served with the prefix cache off, on, on with
   chunked prefill and the ragged step, and on over int8 pools. Eight
   requests repeat a seeded 40-token passage after a shared 256-token
   preamble: served with SpecConfig(lookahead=4) n-gram drafts off and
   on, then with method "combined", the prefix cache, chunked prefill and
   the ragged step, off and on, on engines whose prefix cache first takes
   the spec-off run's streams as prompts (so the tree holds a served
   continuation of each prompt). The first run of each knob set after a
   warm-up engine of those knobs; prints tokens/s, mean and late-arrival TTFT, pool pages at peak,
   prompt tokens served from the cache, drafted and accepted tokens and
   tokens per target step, and its launches; each run is held by the
   margin check, each path's kernels must launch (K1, K4, K6, K6q, K7 over
   the phase), and the streams identical to their cache-off or spec-off
   run are counted (not required); then the same speculation at fp32
   (LLaMA-7B's widths cut to 2 layers, fp32 weights and pools): spec off,
   then "combined" with the prefix cache (its tree holding the spec-off
   streams) unchunked and chunked with the ragged step, margin-checked at
   1e-3, the streams identical to spec-off counted;
10. train: the ERNIE-1.0 pretrain step at full width (ErnieConfig.ernie_base,
   random weights from --seed, batch 32, seq 512, fused MLM loss, bf16 O1
   autocast, hidden and attention dropout 0.1, Adam lr 1e-4, one fixed
   batch): 3 warm-up and 10 timed steps. Launch counters are zeroed before
   the timed steps; K1, K2, K3, K4 and K5 must launch exactly 12, 12, 12,
   26 and 26 times a step. The loss must be finite at every step and lower
   at the last than at the first. Prints tokens/s/chip, step ms, MFU (the
   FLOPs per token of bench.py over 989 TFLOP/s) and peak memory;
11. step_check: a 2-layer ERNIE at full width, fp32, dropout 0, batch 2,
   seq 512: loss and every parameter gradient on the card (through the
   kernels) against the same model on the CPU (the plain versions), from
   the same weights;
12. t5_train_kernels: K1, K2 (with d(mask) for a trainable (1, 12, q, k)
   bias) and K3 at T5-base's three attention shapes, batch 32 in bf16 and
   4 in fp32: the encoder (512 x 512, bidirectional bias, dropout 0.1), the
   decoder self-attention (114 x 114, causal plus bias) and the
   cross-attention (114 x 512, no mask). Prints each gradient's max abs
   error beside its limit, K2's time with and without d(mask), the time of
   the sum of d(mask)'s batch-group partials, their groups and bytes (a
   second launch must give dQ and the partials bit for bit), and PyTorch's
   sdpa backward with a float mask that requires grad as a yardstick;
13. train_t5: the T5-base pretraining step at full width
   (T5Config.t5_base, 222.9 M parameters, random weights from --seed):
   batch 32 x 512 source and 114 target tokens, -100 on a few target
   positions, bf16 O1, dropout 0.1, Adam lr 1e-4, one fixed batch, 3
   warm-up (the last under sync debug mode "error") and 10 timed steps.
   K1, K2, K3, K4 and K5 must launch exactly 36, 36, 36, 62 and 62 times a
   step, 24 of the K2 launches with d(mask); the loss must be finite and
   fall. Prints tokens/s/chip over source + target tokens, step ms, MFU
   (T5_FLOPS below) and peak memory;
14. t5_step_check: a 2-layer T5 at full width, fp32, dropout 0, batch 2,
   512 / 114: loss and every gradient (both bias tables included) on the
   card against the CPU, as step_check, with gated-GELU and with ReLU FFNs
   (the card's ReLU passes replay the CPU pass's ReLU masks);
15. moe_kernels: K9 (the MoE row gather) against its plain version on the
   card, bit-exact (tolerance 0): the dispatch (16384 fp32 rows of 768 into
   8 x 4916 slots, GShard; 8 x 2560, Switch) and the combine (the slots'
   bf16 rows back to 32768 / 16384 (token, choice) pairs) with the indices
   of the real routing of the MoE phase's batch, and an odd 301 x 9 fp32
   case with -1 indices; kernel, plain and library (index_select over a
   zero-padded src) device times and the bound (rows written plus live
   rows read, over 3.35 TB/s);
16. train_moe: MoELayer at Switch-Base-8's widths (8 experts of
   Linear(768, 3072), ReLU, Linear(3072, 768); 37.79 M parameters, random
   from --seed), x (32, 512, 768) fp32 and an fp32 target from the seed,
   mse_loss + 0.01 x aux_loss, bf16 O1, Adam lr 1e-4, one fixed batch, 3
   warm-up (the last under sync debug mode "error") and 10 timed steps,
   first with the GShard top-2 gate (capacity factor 1.2), then with a
   Switch top-1 gate (capacity (1.25, 2.0)). K9 must launch exactly twice
   a step; the loss must be finite and fall. Prints tokens/s/chip, step
   ms, MFU (model FLOPs over 989 TFLOP/s; the executed count over all
   slots beside it), peak memory and the dropped share of (token, choice)
   pairs;
17. moe_step_check: the layer at full width with GELU experts, fp32, 1024
   tokens, at capacity factor 1.2 (nothing dropped) and 0.5 (about half
   the pairs dropped): the routing indices on the card and on the CPU must
   be identical, then the loss and every gradient (gate and experts) under
   MOE_GRAD_RTOL, card (K9) against CPU (the plain version);
18. ring_kernels (run with the other kernel phases): K1r, K2r and K3r, the
   ring form of the flash kernels, at one ring step of LLaMA-7B's
   attention widths, (1, 4096, 32, 128) a rank, in bf16 (timed) and fp32,
   against their plain versions under TOL_REL: the diagonal step (which
   must equal the single-call causal K1 / K2 / K3 bit for bit), a past
   block (all visible), a future block (out exactly 0, lse all -inf, dQ =
   dK = dV = 0), an unaligned offset (4096 + 37) and a ragged 1000-row
   shard; kernel, plain and library times (sdpa is_causal on the
   diagonal, plain sdpa on the past block, sdpa with the step's causal
   pattern as a boolean mask on the future and unaligned steps; yardsticks
   only) and the bound from the live (query, key) pairs;
19. ring: first the single-call K1 / K2 / K3 over the whole global
   sequence of 16384 (32 heads of 128, bf16, causal) against their plain
   versions a head at a time, each rank's part of the sequence under
   SP_SINGLE_TOL; then `ring_flash_attention` forward and backward at
   that shape (and at 2048 in fp32), over 4 ranks of `distributed.spawn`
   (NCCL when the machine has a card per rank, else gloo with the ranks
   sharing the card and CUDA tensors staged through pinned host memory):
   each rank's output and dQ / dK / dV shard under SP_TOL (max error over
   the shard's max, L2 error over the shard's L2) of one call over the
   whole sequence on the same card (the single-call kernels in bf16, the
   plain versions in fp32); exactly
   4 K1r a forward and 4 K2r and 4 K3r a backward a rank; the transport
   and its staged bytes, each rank's kernel time by CUDA events (one rank
   at a time) and its wall (a speed figure only with a card a rank);
20. ulysses: the same through `ulysses_attention` (K1, K2, K3 once a rank
   on a quarter of the heads over the whole sequence);
21. moe_ep: the MoE layer at Switch-Base-8's widths expert-parallel over
   the same 4 ranks (2 experts a rank, 4096 tokens a rank, GShard top-2):
   at capacity factor MOE_EP_CF nothing may drop, and the rows, the aux
   loss and every gradient are held under MOE_EP_RTOL against the
   single-rank layer run over every rank's tokens on the card (GELU
   experts, fp32); then 3 + 10 O1 train steps at factor 1.2 (ReLU
   experts), finite, K9 exactly twice a step a rank: step ms, the
   transport and the dropped share;
22. with --profile: torch.profiler windows of one prefill and two decode
   blocks of the served slice, two ragged steps of the bf16 chunked
   serve, two speculative blocks (n-gram, lookahead 4) of the prefix /
   speculation serve, one ERNIE, one T5 and one GShard MoE train step:
   device busy share, top kernels and top host ops.
23. serve_recovery (run after serve_chained): the resilience and recovery
   layer on the serve model and engine. Eight requests of 32-512 prompt
   tokens and 32 new tokens (two seeded-stochastic at temperature 0.8),
   added up front and driven through an EngineSupervisor with a
   file-backed RequestJournal in a temporary directory: uninterrupted,
   supervised and bare, in the order A B B A (tokens/s of each: the
   journal's cost); killed by `device_lost` at the first step after every
   request has its first token and again 3 steps later, then the same
   with chunked prefill (256) and the ragged step, killed part-way
   through a chunked prefill. Each killed run must restart exactly twice
   (fatal_fault), finish every request with its streamed tokens its
   output exactly once, keep the journal's and the scheduler's audits,
   pass the margin check on its greedy streams and end the seeded rows at
   the uninterrupted run's draw index; prints the time to recover (salvage,
   snapshot, factory, restore), the time from a restart to the first
   token after it, the replayed tokens and peak memory. Then the faults
   the engine survives: a transient dispatch fault every 5th dispatch
   (streams bit-identical to the uninterrupted run, retries > 0), a
   persistent fault on the third prefill (exactly that request failed,
   the other 7 bit-identical) and a persistent drain fault on a decode
   block (its rows failed, no page left in use after the in-flight block
   was dropped, a new request then served). The restored paths must
   launch K1, K4, K6 (unchunked) and K4, K6, K7 (chunked);
24. recovery_fp32 (run after spec_fp32): the killed run of serve_recovery
   at fp32 on 2 layers of full width: every restored stream identical to
   the uninterrupted one.

The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}. This script imports no JAX and nothing of
paddle_tpu; the card machine has neither.
"""
import argparse
import gc
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
    # K7 over fp32 / bf16 pools: the plain version computes in the pools'
    # type as K6's does, so the same limits
    "K7": {torch.float32: 2e-4, torch.bfloat16: 3e-2},
    # the dequantizing forms: the plain versions dequantize to fp32 and
    # compute in fp32 as the kernels do, so only the bf16 rounding of the
    # output (half an ulp of values below 1) and summation order remain
    "K6q": {torch.float32: 2e-4, torch.bfloat16: 1e-2},
    "K7q": {torch.float32: 2e-4, torch.bfloat16: 1e-2},
}
# tolerances of the training kernels vs their plain versions, relative to
# the largest magnitude of the plain output (max abs error <= rel * max|ref|).
# The kernels round to bf16 where their plain versions do, so bf16 leaves
# the output's own rounding (half an ulp, 2^-9 of the value) and a little
# summation order; fp32 leaves summation order only. K1 is held to its
# plain version on the same values in fp32 (check_k1). Each bf16 limit is a
# few times the largest error read on an H100 (PERF.md, PR 2).
TOL_REL = {
    "K1": {torch.float32: 1e-4, torch.bfloat16: 1e-2},
    "K2": {torch.float32: 1e-4, torch.bfloat16: 5e-3},
    "K3": {torch.float32: 1e-4, torch.bfloat16: 5e-3},
    "K5": {torch.float32: 1e-4, torch.bfloat16: 1e-2},
    # K2's d(mask): the fp32 dS of the same products as the plain version,
    # summed over the batch, so only summation order differs: about ten
    # times the largest reading on an H100 (1.07e-6 x max|ref| fp32, 8.9e-7
    # bf16; PERF.md, section 6)
    "K2m": {torch.float32: 1e-5, torch.bfloat16: 1e-5},
    # the ring forms at one ring step of (1, 4096, 32, 128): bf16 at two
    # output ulps' worth of the largest value (a one-ulp rounding flip is
    # up to 2^-7 of it: K3r's dV read one ulp, 0.00098 at a max of 0.1865,
    # 5.2e-3 x max, on an H100; PERF.md, section 6)
    "K1r": {torch.float32: 1e-4, torch.bfloat16: 1e-2},
    "K2r": {torch.float32: 1e-4, torch.bfloat16: 1e-2},
    "K3r": {torch.float32: 1e-4, torch.bfloat16: 1e-2},
}
# K1's lse (fp32) max abs error: about ten times the largest read on an
# H100 (9.54e-7, two fp32 ulps of lse ~ 7; PERF.md, PR 2)
TOL_LSE = 1e-5
# whole-step check, card (kernels) against CPU (plain versions), both fp32:
# |loss difference| <= LOSS_RTOL * |loss|, and for every parameter
# max |grad difference| <= GRAD_RTOL * max |CPU grad|; about ten times the
# largest gradient error read on an H100 (1.51e-6, PERF.md, PR 2)
LOSS_RTOL = 2e-5
GRAD_RTOL = 2e-5
# the T5 step check's gradient limit (both FFNs; ReLU with the CPU's masks):
# T5 at init is worse conditioned than ERNIE, and the plain versions run on
# the card already read 2.51e-5 against the CPU with gated-GELU (the kernels
# 2.28e-5; PERF.md, section 6): about four times that reading
T5_GRAD_RTOL = 1e-4
# the training step's launches per step: K1-K3 once per layer, K4 / K5
# for the embedding norm, two norms per layer and the MLM norm
TRAIN_LAUNCHES = {"K1": 12, "K2": 12, "K3": 12, "K4": 26, "K5": 26}
# the T5-base step's launches per step: K1-K3 for 12 encoder self, 12
# decoder self and 12 cross attentions, K2 with d(mask) for the 24 that
# take the trainable bias; K4 / K5 for 2 norms per encoder layer, 3 per
# decoder layer and the two final norms
T5_LAUNCHES = {"K1": 36, "K2": 36, "K2m": 24, "K3": 36, "K4": 62, "K5": 62}
# Switch-Base-8 (Fedus et al. 2021, "Switch Transformers", released as
# google/switch-base-8): d_model 768 and 8 experts, each T5-base's FFN
# (d_ff 3072, ReLU), trained at the T5 phase's encoder batch, 32 x 512
MOE_D, MOE_FF, MOE_E, MOE_B, MOE_S = 768, 3072, 8, 32, 512
# K9 launches per MoE train step: the dispatch and the combine gathers
MOE_LAUNCHES = {"K9": 2}
# the MoE step check's gradient limit, card against CPU at fp32 with GELU
# experts (no ReLU mask flips): ERNIE's whole-step limit, the same fp32
# products summed in another order
MOE_GRAD_RTOL = GRAD_RTOL
# the prefix / speculation serve: a PREFIX_TOKENS system prefix (32 pages of
# 16) shared by 8 requests, and SpecConfig(lookahead=SPEC_LOOKAHEAD), whose
# verify windows are K1 calls of (8, 1 + SPEC_LOOKAHEAD) query tokens
PREFIX_TOKENS = 512
SPEC_LOOKAHEAD = 4
# the engine's greedy token must be the no-cache argmax wherever the top-2
# margin of the no-cache logits exceeds this, by KV pool type: the paged and
# no-cache bf16 paths round differently, and on an H100 positions whose
# tokens differed had margins below 0.05 (PERF.md), so 0.15 leaves a 3x
# guard band. Quantized pools move the logits further: the first reading
# on an H100 had differing positions up to 0.1328 (int8) and 0.2891 (fp8)
# (PERF.md, PR 3); random weights give few margins above ~0.4, so the
# quantized limits keep a smaller guard band
MARGIN_TOL = {"bf16": 0.15, "int8": 0.2, "fp8": 0.35,
              # fp32 pools and weights (the speculation check at fp32):
              # the paged and no-cache fp32 paths differ by summation
              # order, ~1e-5 in the logits; 1e-3 leaves 100x
              "fp32": 1e-3}


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
    return float((a.detach().float() - b.detach().float()).abs().max())


def check(name, err, dtype):
    tol = TOL[name][dtype]
    if not err <= tol:      # NaN fails too
        raise AssertionError(f"{name} {dtype}: max abs error {err} > {tol}")
    return tol


def check_rel(name, got, ref, dtype):
    """(max abs error, its tolerance) of got vs ref under TOL_REL."""
    err = max_err(got, ref)
    tol = TOL_REL[name][dtype] * float(ref.float().abs().max())
    if not err <= tol:
        raise AssertionError(f"{name} {dtype}: max abs error {err} > {tol} "
                             f"({TOL_REL[name][dtype]} x max|ref|)")
    return err, tol


def check_k1(out, lse, q, k, v, dtype, mask=None, causal=False,
             dropout_p=0.0, seed=None):
    """K1's output under TOL_REL and its lse under TOL_LSE, against the
    plain version on q / k / v cast to fp32, with the same keep mask. The
    kernel forms the logits in fp32 from either input type; the plain
    version on bf16 inputs rounds them to bf16, which moves its largest
    outputs by ~1.4% (0.0117 of 0.85 on an H100, PERF.md, PR 2). Returns
    (output error, its tolerance, lse error)."""
    from paddle_tpu_torch.ops import flash_attention as fa

    ref, ref_lse = fa.flash_attention_reference(
        q.float(), k.float(), v.float(), mask, causal, True, dropout_p, seed)
    e_out, t_out = check_rel("K1", out, ref, dtype)
    e_lse = max_err(lse, ref_lse)
    if not e_lse <= TOL_LSE:
        raise AssertionError(f"K1 {dtype}: lse max abs error {e_lse} > "
                             f"{TOL_LSE}")
    return e_out, t_out, e_lse


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


def ptxas_report(text):
    """{kernel entry: {"registers", "spill_stores", "spill_loads",
    "stack"}} from one source's `-Xptxas -v` output."""
    import re

    out, cur = {}, None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
    return out


# the Hopper kernels: the flash kernels (wgmma, TMA), the paged decode
# walk (K6, K6q) and the ragged kernel (K7, K7q: the walk and the wgmma
# tiles); their ptxas lines are printed and none may spill
SM90_KERNELS = ("flash_fwd_sm90_kernel", "flash_bwd_dq_sm90_kernel",
                "flash_bwd_dkv_sm90_kernel", "paged_decode_walk_kernel",
                "ragged_paged_kernel")
# the paged kernels' instantiations: (pool type code, head_dim, rep)
PAGED_FORMS = [(kv, hd, rep) for kv in (1, 2, 3) for hd in (64, 128)
               for rep in (1, 2, 4, 8)]


def sm90_report():
    """Registers and spills of each Hopper kernel (ptxas) beside its
    dynamic shared memory (the layouts' sizes, read from the libraries);
    raises if one spills or if an instantiation of the paged kernels is
    missing."""
    import ctypes

    from paddle_tpu_torch import _build

    smem = {}
    for kernel, lib_name, sym in (
            ("K1", "flash_fwd", "ptt_flash_fwd_sm90_smem"),
            ("K2", "flash_bwd", "ptt_flash_bwd_dq_sm90_smem"),
            ("K3", "flash_bwd", "ptt_flash_bwd_dkv_sm90_smem")):
        fn = getattr(_build.load(lib_name), sym)
        fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
        smem[kernel] = {(d, m): fn(d, m) for d in (64, 128) for m in (0, 1)}
    # the Python side's copies of the paged kernels' constants (readable
    # without the libraries) must be the kernels' own
    from paddle_tpu_torch.serving import attention as att

    rag = _build.load("ragged_paged")
    rag.ptt_ragged_paged_tile_rows.argtypes = [ctypes.c_int] * 2
    consts = {"RAGGED_TILE_ROWS": (rag.ptt_ragged_paged_tile_rows(1, 1),
                                   att.RAGGED_TILE_ROWS),
              "RAGGED_FMA_TILE_ROWS": (rag.ptt_ragged_paged_tile_rows(0, 0),
                                       att.RAGGED_FMA_TILE_ROWS)}
    wrong = {k: v for k, v in consts.items() if v[0] != v[1]}
    if wrong:
        raise AssertionError(f"kernel constants (C, Python) differ: {wrong}")
    paged_smem = {}
    for kernel, lib_name, sym in (
            ("K6", "paged_decode", "ptt_paged_decode_walk_smem"),
            ("K7", "ragged_paged", "ptt_ragged_paged_smem")):
        fn = getattr(_build.load(lib_name), sym)
        fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
        paged_smem[kernel] = {f: fn(*f) for f in PAGED_FORMS}
    report = {}
    for lib_name, text in _build.BUILD_LOGS.items():
        for entry, r in ptxas_report(text).items():
            if not any(k in entry for k in SM90_KERNELS):
                continue
            report[entry] = r
            log(f"[build] {lib_name} {entry}: {r.get('registers')} registers, "
                f"stack {r.get('stack')} B, spill stores "
                f"{r.get('spill_stores')} B, spill loads "
                f"{r.get('spill_loads')} B")
            if r.get("spill_stores") or r.get("spill_loads"):
                raise AssertionError(f"{entry} spills: {r}")
    missing = [k for k in SM90_KERNELS if not any(k in e for e in report)]
    for k in ("paged_decode_walk_kernel", "ragged_paged_kernel"):
        n = sum(k in e for e in report)
        if n != len(PAGED_FORMS):
            missing.append(f"{k}: {n} of {len(PAGED_FORMS)} instantiations")
    if missing:
        raise AssertionError(f"{missing} missing from the ptxas output")
    for kernel, sizes in smem.items():
        log(f"[build] {kernel} Hopper kernel dynamic shared memory (bytes, "
            "head_dim / with a staged mask tile): "
            + ", ".join(f"d {d} mask {m}: {b}" for (d, m), b in sizes.items()))
    names = {1: "bf16", 2: "int8", 3: "fp8"}
    for kernel, sizes in paged_smem.items():
        log(f"[build] {kernel} Hopper kernel dynamic shared memory (bytes, "
            "pool / head_dim / rep): " + ", ".join(
                f"{names[kv]} d {hd} rep {rep}: {b}"
                for (kv, hd, rep), b in sizes.items()))
    out = {k: {f"d{d} mask{m}": b for (d, m), b in sizes.items()}
           for k, sizes in smem.items()}
    out.update({k: {f"{names[kv]} d{hd} rep{rep}": b
                    for (kv, hd, rep), b in sizes.items()}
                for k, sizes in paged_smem.items()})
    return {"ptxas": report, "smem": out}


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
    sm90_report()
    return secs


def visible(q, k, kw):
    """(b, sq, sk) bool: the (query, key) pairs a K1 call's mask and
    is_causal leave visible (a mask entry at -1e9 hides its pair)."""
    b, sq, sk = q.shape[0], q.shape[1], k.shape[1]
    seen = torch.ones(b, sq, sk, dtype=torch.bool, device=q.device)
    mask = kw.get("attn_mask")
    if mask is not None:
        seen &= (mask > -1e8)[:, 0]
    if kw.get("is_causal"):
        seen &= torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
    return seen


def verify_window_inputs(g, dev, dtype):
    """A speculative verify window as `serving.attention.
    _prefill_attention_paged` hands it to K1: 8 rows of 1 + SPEC_LOOKAHEAD
    query tokens against each row's whole gathered page table (64 pages of
    16, LLaMA-7B's 32 heads of 128) under the paged prefill's float mask
    (column j visible to lane i of row r iff j <= pos[r] + i, else -1e9),
    rows at positions spread over the table. Returns (q, k, v, mask, pos,
    paged cache over pools holding the same shape)."""
    from paddle_tpu_torch.serving.kv_cache import PagedLayerCache

    b, lanes, h, d, ps, maxp = 8, 1 + SPEC_LOOKAHEAD, 32, 128, 16, 64
    length = ps * maxp

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    q = rnd(b, lanes, h, d)
    k, v = rnd(b, length, h, d), rnd(b, length, h, d)
    start = torch.from_numpy(np.linspace(0, length - lanes, b).astype(
        np.int64)).to(dev)
    pos = start[:, None] + torch.arange(lanes, device=dev)[None, :]
    allowed = torch.arange(length, device=dev)[None, None, :] \
        <= pos[:, :, None]
    mask = torch.where(allowed, 0.0, -1e9).to(torch.float32)[:, None]
    num_pages = b * maxp + 1
    table = torch.randperm(num_pages - 1, generator=g, device=dev)[
        :b * maxp].reshape(b, maxp).to(torch.int32) + 1
    cache = PagedLayerCache(rnd(h, num_pages, ps, d),
                            rnd(h, num_pages, ps, d), table)
    return q, k, v, mask, pos, cache


def k1_cases(rows, dev):
    """Flash-attention forward at the prefill shape (1, 512, 32, 128), and
    in bf16 at a speculative verify window's (verify_window_inputs), which
    is held row by row under TOL_REL against the plain version on the
    values cast to fp32, as check_k1 does: its long rows' outputs are
    small, so an absolute limit would not see a lost key tile there. The
    window also times the whole paged attention (the table gather + K1).
    Returns {"K1 verify": the window's row}."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.serving import attention as att

    g = torch.Generator(device=dev).manual_seed(1)
    b, s, h, d = 1, 512, 32, 128
    causal = torch.full((s, s), -1e9, device=dev).triu(1)[None, None]
    out, window = {}, None
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
        if dtype == torch.bfloat16:
            wq, wk, wv, wmask, wpos, wcache = verify_window_inputs(g, dev,
                                                                   dtype)
            window = (f"verify window {tuple(wq.shape)} x "
                      f"{tuple(wk.shape)}, float mask")
            cases.append((window, (wq, wk, wv), {"attn_mask": wmask}))
        for label, (q_, k_, v_), kw in cases:
            got = fa.flash_attention(q_, k_, v_, **kw)
            torch.cuda.synchronize()
            extra = {}
            if label == window:
                ref = fa.flash_attention_reference(q_.float(), k_.float(),
                                                   v_.float(), **kw)
                per_row = [check_rel("K1", got[r], ref[r], dtype)
                           for r in range(got.shape[0])]
                err = max(e for e, _ in per_row)
                tol = min(t for _, t in per_row)
                extra["row_tols"] = [t for _, t in per_row]
            else:
                err = max_err(got, fa.flash_attention_reference(q_, k_, v_,
                                                                **kw))
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
            # the work the visible pairs need: each query, each key row
            # some query of its batch entry sees, the mask and the output
            seen = visible(q_, k_, kw)
            flops = 4 * h * d * int(seen.sum())
            kv_rows = int(seen.any(1).sum())
            io = nbytes(q_, got) + 2 * kv_rows * h * d * k_.element_size() \
                + (nbytes(mask) if mask is not None else 0)
            bms, by = bound(io, flops, dtype)
            tol_text = (f"{tol}" if label != window else
                        f"{TOL_REL['K1'][dtype]} x max|ref| of each row, "
                        f"smallest {tol:.3g}")
            log(f"[K1] {str(dtype)[6:]} {label}: max_abs_err {err:.3g} "
                f"(tol {tol_text}) kernel {ms:.4f} ms (issued from Python "
                f"{issued_ms:.4f}) plain {plain_ms:.4f} ms library "
                f"{lib_ms:.4f} ms bound {bms:.4f} ms ({by}, {io} bytes)")
            row = dict(dtype=str(dtype)[6:], case=label, max_abs_err=err,
                       tol=tol, ms=ms, issued_ms=issued_ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=bms, bound_by=by,
                       bytes=io, visible_pairs=int(seen.sum()), **extra)
            if label == window:
                row["window_attend_ms"] = time_ms(
                    lambda: att._prefill_attention_paged(wq, wcache, wpos,
                                                         1))
                log(f"[K1] verify window: the whole paged attention (table "
                    f"gather + K1) {row['window_attend_ms']:.4f} ms")
                out["K1 verify"] = row
            rows.append(("K1", row))
        if window is not None:
            del wq, wk, wv, wcache
            window = None
    return out


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


QUANT_KV = ("int8", "fp8")


def _pools(kvh, num_pages, ps, hd, kv, g, dev):
    """(k, v, k_scale, v_scale) pools of KV type `kv`: random bf16 / fp32
    values, or random fp32 values quantized by the port's serving.quant
    (data slabs plus fp32 scale slabs)."""
    shape = (kvh, num_pages, ps, hd)
    if kv not in QUANT_KV:
        dt = {"bf16": torch.bfloat16, "fp32": torch.float32}[kv]
        return (torch.randn(shape, generator=g, device=dev).to(dt),
                torch.randn(shape, generator=g, device=dev).to(dt),
                None, None)
    from paddle_tpu_torch.serving.quant import (quantize_tokens,
                                                resolve_kv_dtype)

    spec = resolve_kv_dtype(kv)
    (kd, ks), (vd, vs) = (quantize_tokens(
        torch.randn(shape, generator=g, device=dev), spec) for _ in range(2))
    return kd, vd, ks, vs


def _gathered_sdpa(q, kp, vp, ks, vs, table, pos, rep, dtype):
    """The library yardstick of the paged kernels: PyTorch's sdpa over the
    pages of each query row gathered (and dequantized) beforehand, which
    the port never calls. q: (n, 1, heads, hd); table: (n, maxP); pos:
    (n,). Returns the timed call."""
    from paddle_tpu_torch.serving import attention as att

    pt = table.long()
    kg, vg = (att._gather(p, pt, sc).to(dtype).transpose(1, 2)
              .repeat_interleave(rep, 1) for p, sc in ((kp, ks), (vp, vs)))
    length = kg.shape[2]
    allowed = (torch.arange(length, device=q.device)[None, :]
               <= pos.long()[:, None])
    mask = torch.where(allowed, 0.0, float("-inf")).to(dtype)[:, None, None]
    qt = q.transpose(1, 2)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kg, vg, attn_mask=mask)


def k6q_cases(rows, dev):
    """K6q, the dequantizing paged decode, at the serving decode shape (b=8,
    hd=128, page 16, 64 pages a row, positions spread over 0..1023) over
    int8 and fp8 pools with bf16 queries."""
    from paddle_tpu_torch.serving import attention as att
    from paddle_tpu_torch.serving.kv_cache import PagedLayerCache

    g = torch.Generator(device=dev).manual_seed(9)
    rng = np.random.RandomState(9)
    b, hd, ps, maxp = 8, 128, 16, 64
    num_pages = b * maxp + 1
    pos_np = np.linspace(0, 1023, b).astype(np.int32)
    dtype = torch.bfloat16
    main = None
    for kv, heads, kvh in (("int8", 32, 32), ("fp8", 32, 32),
                           ("int8", 32, 8)):
        kp, vp, ks, vs = _pools(kvh, num_pages, ps, hd, kv, g, dev)
        table = torch.from_numpy(
            rng.permutation(np.arange(1, num_pages))[:b * maxp]
            .reshape(b, maxp).astype(np.int32)).to(dev)
        pos = torch.from_numpy(pos_np).to(dev)
        q = torch.randn(b, 1, heads, hd, generator=g, device=dev).to(dtype)
        cache = PagedLayerCache(kp, vp, table, k_scale=ks, v_scale=vs)
        rep = heads // kvh
        got = att.paged_decode_attention(q, cache, pos, rep)
        again = att.paged_decode_attention(q, cache, pos, rep)
        ref = att._paged_decode_reference(q, cache, pos, rep)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"K6q {kv} rep {rep}: two launches differ")
        err = max_err(got, ref)
        tol = check("K6q", err, dtype)
        ms = time_ms(lambda: att.paged_decode_attention(q, cache, pos, rep))
        plain_ms = time_ms(lambda: att._paged_decode_reference(
            q, cache, pos, rep), 5, 1)
        lib_ms = time_ms(_gathered_sdpa(q, kp, vp, ks, vs, table, pos, rep,
                                        dtype))
        toks = int((pos_np + 1).sum())
        io = toks * 2 * kvh * (hd * kp.element_size() + 4) + nbytes(
            q, got, table, pos)
        bms, by = bound(io, 4 * heads * hd * toks, dtype)
        label = f"{kv} pools, rep {rep}, b=8, positions 0..1023"
        row = _row(dtype, label, err, tol, ms, plain_ms, lib_ms, bms, by,
                   kv_dtype=kv, bitwise_repeat=True)
        _log_row("K6q", row)
        rows.append(("K6q", row))
        if kv == "int8" and rep == 1:
            main = row
        del kp, vp, ks, vs
    return main


# the flat step of the chunked LLaMA-7B serve: 8 decode tokens at positions
# spread over 0..1023, then one 256-token chunk at 512..767, padded with
# parked tokens to the engine's largest token bucket (8 + 256 + 8 x 8)
FLAT_T = 328


def _parked(idx):
    def edit(pos_np, cap):
        pos_np[list(idx)] = cap
    return edit


def _short_run(decode):
    """Only the chunk's last 17 tokens live, at 1007..1023 (the tail of
    a prompt chunked at ~1000), with or without the 8 decode tokens."""
    def edit(pos_np, cap):
        pos_np[(8 if decode else 0):247] = cap
        pos_np[247:264] = np.arange(cap - 17, cap)
    return edit


def k7_cases(rows, dev):
    """K7, ragged paged attention, on the flat step above at LLaMA-7B
    width (32 heads of 128, page 16, 64 pages a row; rows 0..7 decode, row
    8 the chunk): bf16 and fp32 pools, then int8 and fp8 pools with bf16
    queries; bf16 and int8 also at GQA rep 4 with 6 more parked tokens
    among the real ones; bf16 also with the chunk parked, with the decode
    tokens parked, and with only the chunk's last 17 tokens live, alone
    and beside the decode tokens. Parked tokens must come out exactly
    zero. Each row records the bytes of split partials the call wrote,
    counted by `partial_bytes_written`."""
    from paddle_tpu_torch.serving import attention as att
    from paddle_tpu_torch.serving.kv_cache import PagedLayerCache

    g = torch.Generator(device=dev).manual_seed(8)
    rng = np.random.RandomState(8)
    hd, ps, maxp, nrows = 128, 16, 64, 9
    cap = maxp * ps
    num_pages = nrows * maxp + 1
    main = {}
    for kv in ("bf16", "fp32") + QUANT_KV:
        dtype = torch.float32 if kv == "fp32" else torch.bfloat16
        cases = [("rep 1", 32, 32, _parked(()))]
        if kv in ("bf16", "int8"):
            cases.append(("gqa rep 4, 6 parked", 32, 8,
                          _parked((2, 5, 108, 109, 110, 111))))
        if kv == "bf16":
            # the call's two halves: the decode tokens alone (the chunk
            # parked) and the chunk alone (the decode tokens parked); and
            # a short run at a deep position, alone (too few tiles to fill
            # the card: its keys are split) and beside the decode tokens
            cases += [("rep 1, chunk parked", 32, 32,
                       _parked(range(8, 264))),
                      ("rep 1, decode tokens parked", 32, 32,
                       _parked(range(8))),
                      ("rep 1, 17-token run at 1007 alone", 32, 32,
                       _short_run(False)),
                      ("rep 1, 17-token run at 1007 + decode tokens", 32,
                       32, _short_run(True))]
        for label, heads, kvh, edit in cases:
            kp, vp, ks, vs = _pools(kvh, num_pages, ps, hd, kv, g, dev)
            table = torch.from_numpy(
                rng.permutation(np.arange(1, num_pages))[:nrows * maxp]
                .reshape(nrows, maxp).astype(np.int32)).to(dev)
            pos_np = np.full((FLAT_T,), cap, np.int32)
            rid_np = np.zeros((FLAT_T,), np.int32)
            pos_np[:8] = np.linspace(0, cap - 1, 8).astype(np.int32)
            rid_np[:8] = np.arange(8)
            pos_np[8:264] = np.arange(512, 768)
            rid_np[8:264] = 8
            edit(pos_np, cap)
            pos = torch.from_numpy(pos_np).to(dev)[None]
            rid = torch.from_numpy(rid_np).to(dev)
            q = torch.randn(1, FLAT_T, heads, hd, generator=g,
                            device=dev).to(dtype)
            cache = PagedLayerCache(kp, vp, table, rid, k_scale=ks,
                                    v_scale=vs, routing={})
            rep = heads // kvh
            got = att.ragged_paged_attention(q, cache, pos, rep)
            again = att.ragged_paged_attention(q, cache, pos, rep)
            ref = att._ragged_attention_reference(q, cache, pos, rep)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"K7 {kv} {label}: two launches differ")
            err = max_err(got, ref)
            name = "K7q" if kv in QUANT_KV else "K7"
            tol = check(name, err, dtype)
            live = pos_np < cap
            zeros = float(got[0, torch.from_numpy(~live).to(dev)].abs().max())
            if zeros != 0.0:
                raise AssertionError(f"K7 {kv}: parked tokens gave {zeros}, "
                                     "not zeros")
            ms = time_ms(lambda: att.ragged_paged_attention(q, cache, pos,
                                                            rep))
            plain_ms = time_ms(lambda: att._ragged_attention_reference(
                q, cache, pos, rep), 5, 1)
            lib_ms = time_ms(_gathered_sdpa(
                q[0][:, None], kp, vp, ks, vs, table[rid.long()], pos[0],
                rep, dtype))
            # each row's K/V read once up to its furthest real token, and
            # q . k plus p . v for every (token, key) a token attends
            span = {}
            for p, r in zip(pos_np[live], rid_np[live]):
                span[r] = max(span.get(r, 0), int(p) + 1)
            per_pos = 2 * kvh * (hd * kp.element_size()
                                 + (4 if kv in QUANT_KV else 0))
            io = sum(span.values()) * per_pos + nbytes(q, got, table, pos,
                                                       rid)
            flops = 4 * heads * hd * int((pos_np[live] + 1).sum())
            bms, by = bound(io, flops, dtype)
            case = (f"{kv} pools, {label}: 8 decode tokens + a 256-token "
                    f"chunk at 512, T={FLAT_T}")
            row = _row(dtype, case, err, tol, ms, plain_ms, lib_ms, bms, by,
                       kv_dtype=kv, bitwise_repeat=True,
                       partial_bytes=partial_bytes_written(
                           lambda: att.ragged_paged_attention(q, cache, pos,
                                                              rep)))
            _log_row(name, row)
            log(f"[{name}]   split partials written (counted): "
                f"{row['partial_bytes'] / 1e6:.3f} MB")
            rows.append((name, row))
            if label == "rep 1" and kv in ("bf16", "int8"):
                main[name] = row
            if label.startswith("rep 1, ") and kv == "bf16":
                main[f"K7 {label[7:]}"] = row
            del kp, vp, ks, vs
    return main


# paged edge cases: page sizes, the positions every run holds (besides the
# last slot and the capacity), chunk lengths
PAGED_EDGE_PS = (16, 8, 5)
PAGED_EDGE_POS = (0, 15, 16, 17)
PAGED_EDGE_CHUNKS = (1, 15, 16, 17, 65)
PAGED_EDGE_CAP = 300          # positions a table row holds, about


def _edge_pools(g, rng, kv, kvh, rows, ps, hd, dev):
    """(cache arguments, capacity) of a small pool: `rows` table rows of
    max_pages pages each, every page distinct, from the generator."""
    maxp = -(-PAGED_EDGE_CAP // ps)
    num_pages = rows * maxp + 1
    kp, vp, ks, vs = _pools(kvh, num_pages, ps, hd, kv, g, dev)
    table = torch.from_numpy(rng.permutation(np.arange(1, num_pages))[
        :rows * maxp].reshape(rows, maxp).astype(np.int32)).to(dev)
    return (kp, vp, table, ks, vs), maxp * ps


def paged_edge_case(dev, g, rng, kernel, kv, hd, rep, ps, layout=None):
    """One run of K6 / K6q (`kernel` "K6") or K7 / K7q ("K7") against the
    plain version under TOL. K6: rows at positions 0, 15, 16, 17, the last
    slot and the capacity (a parked row attends every page). K7: `layout`
    is a list of (kind, n, start) segments of the flat step: ("decode", 0,
    pos) one token of its own row, ("chunk", n, start) n tokens of one row
    at start.., ("parked", n, 0) n tokens at the capacity or past it,
    ("norow", 1, pos) a token naming no table row; parked and row-less
    tokens must come out exactly zero. Returns (max error, its tol, bytes
    of split partials the call wrote)."""
    from paddle_tpu_torch.serving import attention as att
    from paddle_tpu_torch.serving.kv_cache import PagedLayerCache

    dtype = torch.bfloat16
    heads = 32 if hd == 64 else 16
    kvh = heads // rep
    quant = kv in QUANT_KV
    if kernel == "K6":
        b = len(PAGED_EDGE_POS) + 2
        (kp, vp, table, ks, vs), cap = _edge_pools(g, rng, kv, kvh, b, ps,
                                                   hd, dev)
        pos_np = np.array(PAGED_EDGE_POS + (cap - 1, cap), np.int32)
        pos = torch.from_numpy(pos_np).to(dev)
        q = torch.randn(b, 1, heads, hd, generator=g, device=dev).to(dtype)
        cache = PagedLayerCache(kp, vp, table, k_scale=ks, v_scale=vs)
        got = []
        written = partial_bytes_written(lambda: got.append(
            att.paged_decode_attention(q, cache, pos, rep)))
        ref = att._paged_decode_reference(q, cache, pos, rep)
        name = "K6q" if quant else "K6"
        torch.cuda.synchronize()
        err = max_err(got[0], ref)
        return err, check(name, err, dtype), written
    rows = sum(k in ("decode", "chunk") for k, _, _ in layout) + 1
    (kp, vp, table, ks, vs), cap = _edge_pools(g, rng, kv, kvh, rows, ps, hd,
                                               dev)
    pos_l, rid_l, row = [], [], 0
    for kind, n, start in layout:
        if kind == "decode":
            pos_l.append(min(start, cap - 1))
            rid_l.append(row)
            row += 1
        elif kind == "chunk":
            start = min(start, cap - n)
            pos_l += list(range(start, start + n))
            rid_l += [row] * n
            row += 1
        elif kind == "parked":
            pos_l += [cap + (i % 3) for i in range(n)]
            rid_l += [int(rng.randint(0, rows)) for _ in range(n)]
        else:
            pos_l.append(start)
            rid_l.append(-1 if rng.randint(2) else rows)
    t = len(pos_l)
    pos_np = np.array(pos_l, np.int32)
    rid_np = np.array(rid_l, np.int32)
    pos = torch.from_numpy(pos_np).to(dev)[None]
    rid = torch.from_numpy(rid_np).to(dev)
    q = torch.randn(1, t, heads, hd, generator=g, device=dev).to(dtype)
    cache = PagedLayerCache(kp, vp, table, rid, k_scale=ks, v_scale=vs,
                            routing={})
    out = []
    written = partial_bytes_written(lambda: out.append(
        att.ragged_paged_attention(q, cache, pos, rep)))
    got = out[0]
    name = "K7q" if quant else "K7"
    dead = (pos_np >= cap) | (rid_np < 0) | (rid_np >= rows)
    # the plain version indexes the table by row id: give the row-less
    # tokens row 0 there (their outputs are held to zeros, not to it)
    ref_rows = torch.from_numpy(np.where(dead, 0, rid_np)).to(dev)
    ref = att._ragged_attention_reference(
        q, PagedLayerCache(kp, vp, table, ref_rows, k_scale=ks, v_scale=vs),
        pos, rep)
    torch.cuda.synchronize()
    if dead.any():
        z = float(got[0, torch.from_numpy(dead).to(dev)].abs().max())
        if z != 0.0:
            raise AssertionError(f"{name} edge case: parked or row-less "
                                 f"tokens gave {z}, not zeros")
    live = torch.from_numpy(~dead).to(dev)
    err = max_err(got[0, live], ref[0, live])
    return err, check(name, err, dtype), written


def paged_edge_cases(dev):
    """K6, K6q, K7 and K7q against their plain versions under the unchanged
    TOL over bf16, int8 and fp8 pools, head_dim 64 and 128 (32 and 16 query
    heads), rep 1, 2, 4 and 8, page sizes 16, 8 and 5, capacities of about
    300 positions (three decode splits): K6 rows at positions 0, 15, 16,
    17, the last slot and parked at the capacity; K7 flat steps mixing
    decode tokens at those positions, a chunk of 1, 15, 16, 17 or 65 tokens
    at offset 0 or mid-page, tokens parked at or past the capacity and
    tokens naming no row (exact zeros), and per pool type and head_dim a
    chunk-only and a decode-only step; then, from a generator of their
    own, per pool type and head_dim a 17-token run at the last slots
    alone, whose keys must be split (it writes split partials: its step
    has too few tiles to fill the card), and beside a decode token.
    Returns the runs' records."""
    g = torch.Generator(device=dev).manual_seed(21)
    rng = np.random.RandomState(21)
    g_deep = torch.Generator(device=dev).manual_seed(22)
    rng_deep = np.random.RandomState(22)
    out = []
    reps = (1, 2, 4, 8)
    i = i_deep = 0
    for kv in ("bf16",) + QUANT_KV:
        for hd in (64, 128):
            for ps in PAGED_EDGE_PS:
                rep = reps[i % 4]
                i += 1
                err, tol, _ = paged_edge_case(dev, g, rng, "K6", kv, hd, rep,
                                              ps)
                out.append(dict(kernel="K6", kv=kv, hd=hd, rep=rep, ps=ps,
                                max_abs_err=err, tol=tol))
            for j, n in enumerate(PAGED_EDGE_CHUNKS):
                rep = reps[i % 4]
                ps = PAGED_EDGE_PS[i % 3]
                i += 1
                start = 0 if j % 2 == 0 else 3 * ps + 2
                layout = ([("decode", 0, p) for p in PAGED_EDGE_POS]
                          + [("parked", 1, 0), ("norow", 1, 7),
                             ("chunk", n, start), ("decode", 0, 10 ** 6),
                             ("parked", 5, 0)])
                err, tol, _ = paged_edge_case(dev, g, rng, "K7", kv, hd, rep,
                                              ps, layout)
                out.append(dict(kernel="K7", kv=kv, hd=hd, rep=rep, ps=ps,
                                chunk=n, start=start, max_abs_err=err,
                                tol=tol))
            for tag, layout in (
                    ("chunk only", [("chunk", 65, 0), ("parked", 3, 0)]),
                    ("decode only", [("decode", 0, p)
                                     for p in PAGED_EDGE_POS + (10 ** 6,)])):
                rep = reps[i % 4]
                ps = PAGED_EDGE_PS[i % 3]
                i += 1
                err, tol, _ = paged_edge_case(dev, g, rng, "K7", kv, hd, rep,
                                              ps, layout)
                out.append(dict(kernel="K7", kv=kv, hd=hd, rep=rep, ps=ps,
                                layout=tag, max_abs_err=err, tol=tol))
    for kv in ("bf16",) + QUANT_KV:
        for hd in (64, 128):
            for tag, layout in (
                    ("deep run alone", [("chunk", 17, 10 ** 6),
                                        ("parked", 3, 0)]),
                    ("deep run + decode", [("decode", 0, 200),
                                           ("chunk", 17, 10 ** 6),
                                           ("parked", 3, 0)])):
                rep = reps[i_deep % 4]
                ps = PAGED_EDGE_PS[i_deep % 3]
                i_deep += 1
                err, tol, written = paged_edge_case(
                    dev, g_deep, rng_deep, "K7", kv, hd, rep, ps, layout)
                if tag == "deep run alone" and written == 0:
                    raise AssertionError(
                        f"K7 {kv} head_dim {hd} rep {rep}: a 17-token run "
                        "alone at the last slots wrote no split partials")
                out.append(dict(kernel="K7", kv=kv, hd=hd, rep=rep, ps=ps,
                                layout=tag, max_abs_err=err, tol=tol,
                                partial_bytes=written))
    worst = max(out, key=lambda r: r["max_abs_err"] / r["tol"])
    log(f"[paged_edge] {len(out)} runs (K6 / K6q {sum(r['kernel'] == 'K6' for r in out)}, "
        f"K7 / K7q {sum(r['kernel'] == 'K7' for r in out)}) within TOL; "
        f"worst {worst['max_abs_err']:.3g} of {worst['tol']} ({worst})")
    return out


# a NaN bit pattern no kernel writes (`partial_bytes_written`)
_UNWRITTEN = 0x7FA5A5A5


def partial_bytes_written(call):
    """Bytes of key-split partials that one call of a paged wrapper writes,
    counted: the wrapper's partials scratch (`attention._partials`) is
    filled with a NaN pattern no kernel writes, and the fp32 elements that
    no longer hold it after the call are counted."""
    from paddle_tpu_torch.serving import attention as att

    made, plain = [], att._partials

    def marked(*args):
        bufs = plain(*args)
        for b in bufs:
            b.view(torch.int32).fill_(_UNWRITTEN)
        made.extend(bufs)
        return bufs

    att._partials = marked
    try:
        call()
        torch.cuda.synchronize()
    finally:
        att._partials = plain
    return 4 * sum(int((b.view(torch.int32) != _UNWRITTEN).sum())
                   for b in made)


def _row(dtype, label, err, tol, ms, plain_ms, lib_ms, bms, by, **extra):
    return dict(dtype=str(dtype)[6:], case=label, max_abs_err=err, tol=tol,
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                bound_by=by, **extra)


def _log_row(kernel, r):
    lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
    log(f"[{kernel}] {r['dtype']} {r['case']}: max_abs_err "
        f"{r['max_abs_err']:.3g} (tol {r['tol']:.3g}) kernel {r['ms']:.4f} "
        f"ms plain {r['plain_ms']:.4f} ms library {lib} bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']})")


# ERNIE-base attention at the bench batch: (b, S, heads, head_dim)
TRAIN_ATTN = (32, 512, 12, 64)
TRAIN_DROPOUT = 0.1


def k1_train_cases(rows, dev):
    """K1 with attention dropout 0.1 at ERNIE-base shapes: bf16 at batch
    32 (the training path), fp32 at batch 4. The plain version draws the
    identical keep mask, so the comparison is exact up to rounding; it is
    timed on the kernel's own inputs."""
    from paddle_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(4)
    b0, s, h, d = TRAIN_ATTN
    p = TRAIN_DROPOUT
    seed = torch.tensor([20260], dtype=torch.int32, device=dev)
    main = None
    for dtype, b in ((torch.bfloat16, b0), (torch.float32, 4)):
        q, k, v = (torch.randn(b, s, h, d, generator=g, device=dev).to(dtype)
                   for _ in range(3))
        out, lse = fa.flash_attention(q, k, v, return_lse=True, dropout_p=p,
                                      seed=seed)
        undropped = fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        err, tol, lse_err = check_k1(out, lse, q, k, v, dtype, dropout_p=p,
                                     seed=seed)
        if max_err(out, undropped) < 1e-3:
            raise AssertionError("K1 dropout changed nothing")
        ms = time_ms(lambda: fa.flash_attention(
            q, k, v, return_lse=True, dropout_p=p, seed=seed))
        # the same call without dropout: what the keep-mask hashing costs
        ms_undropped = time_ms(lambda: fa.flash_attention(
            q, k, v, return_lse=True))
        plain_ms = time_ms(lambda: fa.flash_attention_reference(
            q, k, v, return_lse=True, dropout_p=p, seed=seed), 5, 1)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib_ms = time_ms(lambda: torch.nn.functional
                         .scaled_dot_product_attention(qt, kt, vt,
                                                       dropout_p=p))
        bms, by = bound(nbytes(q, k, v, out, lse), 4 * b * h * d * s * s,
                        dtype)
        row = _row(dtype, f"dropout {p} ({b}, {s}, {h}, {d})", err, tol, ms,
                   plain_ms, lib_ms, bms, by, dropout_p=p,
                   ms_without_dropout=ms_undropped, lse_err=lse_err)
        _log_row("K1", row)
        log(f"[K1] {str(dtype)[6:]} lse max_abs_err {lse_err:.3g} (tol "
            f"{TOL_LSE}); the same call without dropout: "
            f"{ms_undropped:.4f} ms")
        rows.append(("K1", row))
        if dtype == torch.bfloat16:
            main = row
        del q, k, v, out, undropped
    return main


def k23_cases(rows, dev):
    """K2 and K3 through FlashAttention.backward (dropout 0.1) at ERNIE-base
    shapes, without and with a (b, 1, 1, 512) padding mask; bf16 at batch
    32, fp32 at batch 4. Each gradient is held to the plain backward on the
    same inputs; each kernel is timed alone."""
    from paddle_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(5)
    b0, s, h, d = TRAIN_ATTN
    p = TRAIN_DROPOUT
    seed = torch.tensor([777], dtype=torch.int32, device=dev)
    main = {}
    for dtype, b in ((torch.bfloat16, b0), (torch.float32, 4)):
        q, k, v, dout = (torch.randn(b, s, h, d, generator=g, device=dev)
                         .to(dtype) for _ in range(4))
        pad = torch.zeros(b, 1, 1, s, device=dev)
        pad[::2, ..., s - 96:] = -1e4          # every other row padded
        for label, mask in (("no mask", None), ("padding mask", pad)):
            qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
            out = fa.FlashAttention.apply(qg, kg, vg, mask, False, p, seed)
            out.backward(dout)
            _, lse = fa.flash_attention(q, k, v, mask, return_lse=True,
                                        dropout_p=p, seed=seed)
            delta = fa.attention_delta(out.detach(), dout)
            rdq, rdk, rdv = fa.flash_attention_backward_reference(
                q, k, v, dout, lse, delta, mask, False, p, seed)
            torch.cuda.synchronize()
            e2, t2 = check_rel("K2", qg.grad, rdq, dtype)
            ek, tk = check_rel("K3", kg.grad, rdk, dtype)
            ev, tv = check_rel("K3", vg.grad, rdv, dtype)
            e3, t3 = (ek, tk) if ek / tk >= ev / tv else (ev, tv)
            args = (q, k, v, dout, lse, delta, mask, False, p, seed)
            ms2 = time_ms(lambda: fa.flash_attention_dq(*args))
            ms3 = time_ms(lambda: fa.flash_attention_dkv(*args))
            plain_ms = time_ms(
                lambda: fa.flash_attention_backward_reference(*args), 5, 1)
            qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_()
                          for x in (q, k, v))
            lib_out = torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=None if mask is None else mask.to(
                    dtype), dropout_p=p)
            dout_t = dout.transpose(1, 2)
            lib_ms = time_ms(lambda: torch.autograd.grad(
                lib_out, (qt, kt, vt), dout_t, retain_graph=True))
            pd_bytes = nbytes(lse, delta) + (nbytes(mask) if mask is not None
                                             else 0)
            b2 = bound(nbytes(q, k, v, dout, q) + pd_bytes,
                       6 * b * h * d * s * s, dtype)
            b3 = bound(nbytes(q, k, v, dout, k, v) + pd_bytes,
                       8 * b * h * d * s * s, dtype)
            case = f"{label} ({b}, {s}, {h}, {d}), dropout {p}"
            r2 = _row(dtype, case, e2, t2, ms2, plain_ms, lib_ms, *b2,
                      library_note="sdpa backward, dQ+dK+dV together")
            r3 = _row(dtype, case, e3, t3, ms3, plain_ms, lib_ms, *b3,
                      library_note="sdpa backward, dQ+dK+dV together")
            _log_row("K2", r2)
            _log_row("K3", r3)
            rows.append(("K2", r2))
            rows.append(("K3", r3))
            if dtype == torch.bfloat16 and mask is None:
                main = {"K2": r2, "K3": r3}
            del qg, kg, vg, out, lib_out, qt, kt, vt
    return main


# the Hopper kernels' edge cases (bf16, head_dim 64 and 128): sizes around
# their 64 / 128-row tiles, T5's cross shape (114 queries over 512 keys)
EDGE_SIZES = (1, 63, 65, 127, 129, 200, (114, 512))
# mask shapes by pattern; sk = 114 has a 456-byte row, no 16-byte multiple
EDGE_MASKS = (None, "b11k", "1hqk", "bhqk", "11qk")
# causal forms: none, one call (0, 0), a ring step 37 keys behind, and one
# wholly in the future (q_off - k_off = -sk), the last two with
# keep_neg_inf_lse as the ring calls them
EDGE_CAUSAL = (None, (0, 0), "unaligned", "future")
# dQ and dK with a single key, where they are zero up to rounding: a
# hundred times the ~1e-7 of fp32 rounding of dP - delta on unit inputs
ONE_KEY_ATOL = 1e-5


# K2's d(mask) edge cases (bf16, 2 heads of 64): masks with batch 1, whose
# d(mask) K2 sums over batch groups, and one with its own batch dim; batches
# whose groups come out ragged; sizes around the 64-key and 128-row tiles,
# T5's decoder length (456-byte mask rows) and its cross shape
DMASK_EDGE_MASKS = ("1hqk", "11qk", "bhqk")
DMASK_EDGE_BATCHES = (1, 3, 5)
DMASK_EDGE_SIZES = (63, 129, 114, (114, 512))


def _edge_mask(kind, b, h, sq, sk, g, dev):
    if kind is None:
        return None
    shape = {"b11k": (b, 1, 1, sk), "1hqk": (1, h, sq, sk),
             "bhqk": (b, h, sq, sk), "11qk": (1, 1, sq, sk)}[kind]
    return torch.where(torch.rand(*shape, generator=g, device=dev) < 0.2,
                       -1e4, 0.5 * torch.randn(*shape, generator=g,
                                               device=dev))


def flash_edge_case(dev, g, seed, dtype, shape, mask, causal, offsets,
                    neg_inf, p, label):
    """K1, K2 and K3 at one case against their plain versions (K1's on the
    values cast to fp32, as check_k1), under TOL_REL (the ring forms' limits
    K1r / K2r / K3r where the case has ring offsets) and TOL_LSE; lse must
    be -inf exactly where the plain version's is. Returns {kernel: (error,
    tolerance)}."""
    from paddle_tpu_torch.ops import flash_attention as fa

    n1, n2, n3 = ("K1r", "K2r", "K3r") if offsets else ("K1", "K2", "K3")

    b, sq, sk, h, d = shape
    q, dout = (torch.randn(b, sq, h, d, generator=g, device=dev).to(dtype)
               for _ in range(2))
    k, v = (torch.randn(b, sk, h, d, generator=g, device=dev).to(dtype)
            for _ in range(2))
    kw = dict(scale=None, offsets=offsets)
    out, lse = fa.flash_attention(q, k, v, mask, causal, True, p, seed,
                                  keep_neg_inf_lse=neg_inf, **kw)
    ref, ref_lse = fa.flash_attention_reference(
        q.float(), k.float(), v.float(), mask, causal, True, p, seed,
        keep_neg_inf_lse=neg_inf, **kw)
    lse0 = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))
    delta = fa.attention_delta(out, dout)
    args = (q, k, v, dout, lse0, delta, mask, causal, p, seed)
    dq = fa.flash_attention_dq(*args, **kw)
    dk, dv = fa.flash_attention_dkv(*args, **kw)
    rdq, rdk, rdv = fa.flash_attention_backward_reference(*args, **kw)
    torch.cuda.synchronize()
    if sk == 1:
        # one key: the softmax is 1 and dS = p (dP - delta) cancels exactly,
        # so dQ and dK are the fp32 rounding of dP - delta on both sides
        # (~1e-7 on unit inputs), which no bound relative to their own max
        # can hold: each is held to ONE_KEY_ATOL instead
        e2 = (max_err(dq, rdq), ONE_KEY_ATOL)
        ek = (max_err(dk, rdk), ONE_KEY_ATOL)
        for name, (e, t) in (("K2 dq", e2), ("K3 dk", ek)):
            if not e <= t:
                raise AssertionError(f"{label}: {name} max abs error {e} > "
                                     f"{t} with one key")
    else:
        e2, ek = check_rel(n2, dq, rdq, dtype), check_rel(n3, dk, rdk, dtype)
    errs = {"K1": check_rel(n1, out, ref, dtype),
            "K1 lse": (_ring_lse_check(lse, ref_lse, f"K1 {label}"), TOL_LSE),
            "K2": e2,
            "K3": max(ek, check_rel(n3, dv, rdv, dtype),
                      key=lambda et: et[0] / max(et[1], 1e-30))}
    return errs


def flash_edge_cases(dev):
    """Correctness only: K1 (dropout) and K2 / K3 against their plain
    versions on the branches the training shapes do not reach: causal
    tile skipping, ragged S, a full (1, h, S, S) mask, the bf16 tensor-core
    path at head_dim 128 and the FMA path at a head_dim that is not a
    multiple of 32. Then the Hopper kernels (bf16, head_dim 64 and 128) at
    every size of EDGE_SIZES under every mask shape of EDGE_MASKS, each
    case with a causal form of EDGE_CAUSAL (in turn) and dropout 0.1 on
    every other one; the four mask shapes at sk = 114 with every causal
    form; and rows that see no key (a -inf mask row, a -inf batch, a
    future step), whose out must be 0 and lse 0, or -inf under
    keep_neg_inf_lse."""
    from paddle_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(7)
    seed = torch.tensor([31337], dtype=torch.int32, device=dev)
    worst = {}
    for dtype, (b, s, h, d), causal, full_mask in (
            (torch.bfloat16, (2, 200, 2, 128), True, False),
            (torch.bfloat16, (2, 131, 3, 64), False, True),
            (torch.float32, (2, 200, 4, 40), True, True)):
        q, k, v, dout = (torch.randn(b, s, h, d, generator=g, device=dev)
                         .to(dtype) for _ in range(4))
        mask = None
        if full_mask:
            mask = torch.where(
                torch.rand(1, h, s, s, generator=g, device=dev) < 0.2,
                -1e4, 0.0)
        out, lse = fa.flash_attention(q, k, v, mask, causal, True,
                                      TRAIN_DROPOUT, seed)
        delta = fa.attention_delta(out, dout)
        args = (q, k, v, dout, lse, delta, mask, causal, TRAIN_DROPOUT, seed)
        dq = fa.flash_attention_dq(*args)
        dk, dv = fa.flash_attention_dkv(*args)
        rdq, rdk, rdv = fa.flash_attention_backward_reference(*args)
        torch.cuda.synchronize()
        label = (f"{str(dtype)[6:]} ({b}, {s}, {h}, {d})"
                 f"{' causal' if causal else ''}"
                 f"{' full mask' if full_mask else ''}")
        e1, t1, e_lse = check_k1(out, lse, q, k, v, dtype, mask, causal,
                                 TRAIN_DROPOUT, seed)
        e3 = max(check_rel("K3", dk, rdk, dtype),
                 check_rel("K3", dv, rdv, dtype), key=lambda et: et[0] / et[1])
        errs = {"K1": (e1, t1), "K1 lse": (e_lse, TOL_LSE),
                "K2": check_rel("K2", dq, rdq, dtype), "K3": e3}
        log(f"[edge] {label}, dropout {TRAIN_DROPOUT}: max abs error "
            + ", ".join(f"{kk} {e:.3g} (tol {t:.3g})"
                        for kk, (e, t) in errs.items()))
        worst[label] = errs

    cases = []
    for d in (64, 128):
        n = 0
        for size in EDGE_SIZES:
            sq, sk = size if isinstance(size, tuple) else (size, size)
            for mk in EDGE_MASKS:
                cases.append((d, sq, sk, mk, EDGE_CAUSAL[n % 4], n % 2, None))
                n += 1
        for mk in EDGE_MASKS[1:]:
            for c in EDGE_CAUSAL:
                cases.append((d, 114, 114, mk, c, 1, None))
        for dead in ("1hqk row", "b11k batch"):
            for neg_inf in (False, True):
                cases.append((d, 65, 65, dead, None, 0, neg_inf))
    bad = []
    for d, sq, sk, mk, c, drop, dead_inf in cases:
        b, h = 2, 2
        if mk in ("1hqk row", "b11k batch"):
            kind = mk.split()[0]
            mask = _edge_mask(kind, b, h, sq, sk, g, dev)
            if kind == "1hqk":
                mask[:, :, 3] = float("-inf")   # query row 3 sees no key
            else:
                mask[1] = float("-inf")         # batch 1 sees no key
            neg_inf = dead_inf
        else:
            mask = _edge_mask(mk, b, h, sq, sk, g, dev)
            neg_inf = c in ("unaligned", "future")
        offsets = {None: None, (0, 0): None, "unaligned": (37, 0),
                   "future": (0, sk)}[c]
        causal = c is not None
        p = TRAIN_DROPOUT if drop else 0.0
        label = (f"bf16 ({b}, {sq}, {sk}, {h}, {d}) mask {mk}"
                 f"{'' if c is None else f' causal {c}'}"
                 f"{' keep_neg_inf' if neg_inf else ''}, dropout {p}")
        errs = flash_edge_case(dev, g, seed, torch.bfloat16,
                               (b, sq, sk, h, d), mask, causal, offsets,
                               neg_inf, p, label)
        worst[label] = errs
        ratio = max(e / t if t > 0 else (0.0 if e == 0 else float("inf"))
                    for e, t in errs.values())
        bad.append((ratio, label))
    ratio, label = max(bad)
    log(f"[edge] Hopper kernels: {len(cases)} bf16 cases (head_dim 64 and "
        f"128) within their limits; the closest, at {ratio:.3f} of its "
        f"limit: {label}")
    worst.update(dmask_edge_cases(dev, g, seed))
    return worst


def dmask_edge_cases(dev, g, seed):
    """K2 with d(mask) against the plain backward with need_dmask, at every
    mask of DMASK_EDGE_MASKS, batch of DMASK_EDGE_BATCHES and size of
    DMASK_EDGE_SIZES, causal and not, with dropout 0.1 and without: dQ under
    TOL_REL["K2"], d(mask) under TOL_REL["K2m"], at the host's batch groups
    and, for a batch-1 mask at batch 3 and 5, at 2 (ragged) groups too.
    Returns {label: {kernel: (error, tolerance)}}."""
    from paddle_tpu_torch.ops import flash_attention as fa

    h, d, dtype = 2, 64, torch.bfloat16
    worst, bad = {}, []
    for mk in DMASK_EDGE_MASKS:
        for b in DMASK_EDGE_BATCHES:
            for size in DMASK_EDGE_SIZES:
                sq, sk = size if isinstance(size, tuple) else (size, size)
                for causal in (False, True):
                    for p in (0.0, TRAIN_DROPOUT):
                        q, dout = (torch.randn(b, sq, h, d, generator=g,
                                               device=dev).to(dtype)
                                   for _ in range(2))
                        k, v = (torch.randn(b, sk, h, d, generator=g,
                                            device=dev).to(dtype)
                                for _ in range(2))
                        mask = _edge_mask(mk, b, h, sq, sk, g, dev)
                        out, lse = fa.flash_attention(q, k, v, mask, causal,
                                                      True, p, seed)
                        delta = fa.attention_delta(out, dout)
                        prep = fa._bwd_prepare(q, k, v, dout, lse, delta,
                                               mask, p, seed,
                                               "dmask_edge_cases")
                        host = fa.dmask_groups(b, h, sq, mask.shape,
                                               fa._sms(dev))
                        ragged = {2} if mask.shape[0] == 1 and b > 2 else set()
                        for groups in sorted({host} | ragged):
                            dq, part = fa._launch_dq(prep, causal, groups)
                            dmask = fa.reduce_dmask(part, mask)
                            rdq, _, _, rdm = \
                                fa.flash_attention_backward_reference(
                                    q, k, v, dout, lse, delta, mask, causal,
                                    p, seed, need_dkv=False, need_dmask=True,
                                    groups=groups)
                            torch.cuda.synchronize()
                            label = (f"bf16 ({b}, {sq}, {sk}, {h}, {d}) "
                                     f"d(mask) of a {tuple(mask.shape)} mask"
                                     f"{' causal' if causal else ''}, "
                                     f"dropout {p}, {groups} groups")
                            try:
                                errs = {"K2": check_rel("K2", dq, rdq, dtype),
                                        "K2m": check_rel("K2m", dmask, rdm,
                                                         dtype)}
                            except AssertionError as e:
                                raise AssertionError(f"{label}: {e}") from None
                            worst[label] = errs
                            bad.append((max(e / t for e, t in errs.values()),
                                        label))
    ratio, label = max(bad)
    log(f"[edge] K2 with d(mask): {len(bad)} bf16 cases within their limits; "
        f"the closest, at {ratio:.3f} of its limit: {label}")
    return worst


def k45_train_cases(rows, dev):
    """K4 and K5 at the training width, 16384 rows of 768: LayerNorm mode
    (ERNIE, eps 1e-12) in fp32 (the O1 type of every norm) and bf16, and
    RMS mode (T5, eps 1e-6; its encoder's 32 x 512 rows) in fp32."""
    from paddle_tpu_torch.ops import norm

    g = torch.Generator(device=dev).manual_seed(6)
    n, hd = TRAIN_ATTN[0] * TRAIN_ATTN[1], 768
    tF = torch.nn.functional
    main = {}
    for dtype, sub in ((torch.float32, True), (torch.bfloat16, True),
                       (torch.float32, False)):
        eps = 1e-12 if sub else 1e-6
        x = (torch.randn(n, hd, generator=g, device=dev) * 2 + 0.3).to(dtype)
        w = (1 + 0.1 * torch.randn(hd, generator=g, device=dev)).to(dtype)
        bias = ((0.1 * torch.randn(hd, generator=g, device=dev)).to(dtype)
                if sub else None)
        dy = torch.randn(n, hd, generator=g, device=dev).to(dtype)
        y, mu, rs = norm.norm_forward(x, w, bias, eps, sub)
        ry, rmu, rrs = norm.norm_forward_reference(x, w, bias, eps, sub)
        dx = norm.norm_backward(x, w, dy, mu, rs, sub)
        rdx = norm.norm_backward_reference(x, w, dy, mu, rs, sub)
        torch.cuda.synchronize()
        err4 = max(max_err(y, ry), max_err(mu, rmu),
                   max_err(rs, rrs) / float(rrs.abs().max()))
        tol4 = check("K4", err4, dtype)
        err5, tol5 = check_rel("K5", dx, rdx, dtype)
        ms4 = time_ms(lambda: norm.norm_forward(x, w, bias, eps, sub))
        plain4 = time_ms(lambda: norm.norm_forward_reference(x, w, bias, eps,
                                                             sub))
        xl = x.detach().requires_grad_()
        if sub:
            def lib(x_):
                return tF.layer_norm(x_, (hd,), w, bias, eps)
        else:
            def lib(x_):
                return tF.rms_norm(x_, (hd,), w, eps)
        lib4 = time_ms(lambda: lib(x))
        ms5 = time_ms(lambda: norm.norm_backward(x, w, dy, mu, rs, sub))
        plain5 = time_ms(lambda: norm.norm_backward_reference(x, w, dy, mu,
                                                              rs, sub))
        yl = lib(xl)
        lib5 = time_ms(lambda: torch.autograd.grad(yl, xl, dy,
                                                   retain_graph=True))
        extra = nbytes(bias) if sub else 0
        b4 = bound(nbytes(x, w, y, mu, rs) + extra, 8 * x.numel(), dtype)
        b5 = bound(nbytes(x, w, dy, mu, rs, dx), 10 * x.numel(), dtype)
        mode = "layer" if sub else "rms"
        case = f"{mode} ({n}, {hd})"
        r4 = _row(dtype, case, err4, tol4, ms4, plain4, lib4, *b4)
        r5 = _row(dtype, case, err5, tol5, ms5, plain5, lib5, *b5,
                  library_note=f"F.{mode}_norm backward (dx, and dw)")
        _log_row("K4", r4)
        _log_row("K5", r5)
        rows.append(("K4", r4))
        rows.append(("K5", r5))
        if dtype == torch.float32 and sub:
            main = {"K4": r4, "K5": r5}
        del x, dy, y, dx, rdx, xl, yl
    return main


def train_counters():
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import norm

    return {"K1": fa.flash_attention, "K2": fa.flash_attention_dq,
            "K3": fa.flash_attention_dkv, "K4": norm.norm_forward,
            "K5": norm.norm_backward}


def flops_per_token(model, cfg, seq):
    """bench.py:1253-1254: 6 N per token (forward + backward) plus the
    attention term 12 L H S."""
    n_params = sum(p.numel() for p in model.parameters())
    return 6 * n_params + 12 * cfg.num_hidden_layers * cfg.hidden_size * seq


def phase_train(seed, dev, profile=False, out_dir=None):
    from paddle_tpu_torch.models import ErnieConfig, ErnieForPretraining
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.training import make_train_step

    cfg = ErnieConfig.ernie_base()
    cfg.fused_mlm_loss = True
    batch, seq, warmup, steps = 32, 512, 3, 10
    held = torch.cuda.memory_allocated()    # left by earlier phases
    model = ErnieForPretraining(cfg, device=dev, seed=seed)
    opt = Adam(learning_rate=1e-4, parameters=model.parameters())
    step = make_train_step(model, opt)
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.RandomState(seed)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (batch, seq))
                           ).to(dev)
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size, (batch, seq))
                              ).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    log(f"[train] ERNIE-1.0 base ({cfg.num_hidden_layers} layers, hidden "
        f"{cfg.hidden_size}, {cfg.num_attention_heads} heads, vocab "
        f"{cfg.vocab_size}, {n_params / 1e6:.2f} M params), batch {batch} x "
        f"seq {seq}, bf16 O1, dropout {cfg.hidden_dropout_prob}/"
        f"{cfg.attention_probs_dropout_prob}, fused MLM loss, Adam 1e-4")
    losses = []
    t0 = time.perf_counter()
    for i in range(warmup):
        # the last warm-up step runs with CUDA's sync debug mode at
        # "error": any operation that waits for the card raises, which
        # shows the step makes no host sync
        torch.cuda.set_sync_debug_mode("error" if i == warmup - 1 else 0)
        try:
            losses.append(step(ids, labels, gen))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    log("[train] a warm-up step ran under torch.cuda.set_sync_debug_mode"
        "('error'): no host sync in the step")
    counters = train_counters()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(step(ids, labels, gen))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    loss_vals = [float(x) for x in losses]
    tps = batch * seq * steps / wall
    fpt = flops_per_token(model, cfg, seq)
    mfu = tps * fpt / PEAK_FLOPS[torch.bfloat16]
    log(f"[train] warm-up {warmup} steps {warm_s:.2f} s; {steps} timed "
        f"steps {wall:.3f} s: {tps:.1f} tokens/s/chip, step "
        f"{wall / steps * 1e3:.2f} ms, MFU {mfu:.4f} ({fpt / 1e6:.1f} "
        f"MFLOP/token over 989 TFLOP/s), peak memory {peak / 2**30:.2f} GiB "
        f"({held / 2**30:.2f} GiB held before the phase)")
    log(f"[train] loss by step: " + ", ".join(f"{x:.4f}" for x in loss_vals))
    log(f"[train] launches in the {steps} timed steps: {launches}")
    if not all(np.isfinite(loss_vals)):
        raise AssertionError(f"non-finite training loss: {loss_vals}")
    if not loss_vals[-1] < loss_vals[0]:
        raise AssertionError(f"loss did not fall: {loss_vals}")
    wrong = {k: n for k, n in launches.items()
             if n != TRAIN_LAUNCHES[k] * steps}
    if wrong:
        raise AssertionError(f"launches per step {wrong} (over {steps} "
                             f"steps) != expected {TRAIN_LAUNCHES}")
    prof = None
    if profile:
        prof = profile_window("train_step", lambda: step(ids, labels, gen),
                              out_dir)
    return dict(launches=launches, tokens_per_s=tps, step_ms=wall / steps *
                1e3, mfu=mfu, flops_per_token=fpt, n_params=n_params,
                peak_bytes=peak, held_bytes=held, losses=loss_vals,
                wall_s=wall,
                warmup_s=warm_s, profile=prof)


def phase_step_check(seed, dev):
    """A 2-layer ERNIE at full width, fp32, dropout 0, batch 2, seq 512:
    the card (kernels) against the CPU (plain versions)."""
    from paddle_tpu_torch.models import ErnieConfig, ErnieForPretraining

    cfg = ErnieConfig.ernie_base()
    cfg.num_hidden_layers = 2
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    cfg.fused_mlm_loss = True
    card = ErnieForPretraining(cfg, device=dev, seed=seed)
    cpu = ErnieForPretraining(cfg, device="cpu", seed=seed)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    rng = np.random.RandomState(seed + 1)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 512)))
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 512)))
    labels[:, ::7] = -100                       # some ignored rows
    counters = train_counters()
    before = {k: fn.launches for k, fn in counters.items()}
    losses = {}
    for name, m in (("card", card), ("cpu", cpu)):
        m.train()
        d = next(m.parameters()).device
        loss, _ = m(ids.to(d), masked_lm_labels=labels.to(d))
        loss.backward()
        losses[name] = float(loss.detach())
    ran = {k: fn.launches - before[k] for k, fn in counters.items()}
    if any(n <= 0 for n in ran.values()):
        raise AssertionError(f"the card's step skipped a kernel: {ran}")
    dl = abs(losses["card"] - losses["cpu"])
    worst, worst_name = check_grads(grad_errors(card, cpu), losses,
                                    "step_check", GRAD_RTOL)
    log(f"[step_check] 2-layer full width fp32: loss card "
        f"{losses['card']!r} cpu {losses['cpu']!r} (|diff| {dl:.3g}, "
        f"tol {LOSS_RTOL} x |loss|); every gradient within {GRAD_RTOL} x "
        f"max|cpu grad|, worst {worst:.3g} ({worst_name}); kernels "
        f"launched {ran}")
    return dict(loss_card=losses["card"], loss_cpu=losses["cpu"],
                worst_grad_rel=worst, worst_grad=worst_name, launches=ran)


# T5-base attention at the T5 paper's span-corruption lengths for 512
# source tokens (114 targets), batch 32: (label, b, sq, sk, heads,
# head_dim, causal, trainable bias)
T5_ATTN = (("encoder self", 32, 512, 512, 12, 64, False, True),
           ("decoder self", 32, 114, 114, 12, 64, True, True),
           ("cross", 32, 114, 512, 12, 64, False, False))


def t5_kernel_cases(rows, dev):
    """K1, K2 (with d(mask) where the bias is trainable) and K3 through
    FlashAttention at T5-base's three attention shapes (T5_ATTN), dropout
    0.1, bf16 at batch 32 and fp32 at batch 4. Every gradient is held to
    the plain backward on the same inputs. Times: K1, K2 with and without
    d(mask), the batch sum of the d(mask) buffer, K3, the plain backward,
    and PyTorch's sdpa backward with a float mask that requires grad (the
    yardstick, and its forward beside K1; a causal case hands it the bias
    plus the causal -inf as one mask). Returns the encoder case's bf16
    rows."""
    from paddle_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(10)
    p = TRAIN_DROPOUT
    seed = torch.tensor([4242], dtype=torch.int32, device=dev)
    main = {}
    for label, b0, sq, sk, h, d, causal, trainable in T5_ATTN:
        for dtype, b in ((torch.bfloat16, b0), (torch.float32, 4)):
            def rnd(*shape):
                return torch.randn(*shape, generator=g, device=dev).to(dtype)
            q, dout = rnd(b, sq, h, d), rnd(b, sq, h, d)
            k, v = rnd(b, sk, h, d), rnd(b, sk, h, d)
            bias = (0.5 * torch.randn(1, h, sq, sk, generator=g, device=dev)
                    if trainable else None)
            bias_g = None if bias is None else bias.clone().requires_grad_()
            qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
            before = fa.flash_attention_dq.dmask_launches
            out = fa.FlashAttention.apply(qg, kg, vg, bias_g, causal, p, seed)
            out.backward(dout)
            n_dmask = fa.flash_attention_dq.dmask_launches - before
            if n_dmask != int(trainable):
                raise AssertionError(f"K2 {label}: {n_dmask} d(mask) "
                                     "launches in one backward")
            fwd, lse = fa.flash_attention(q, k, v, bias, causal, True, p, seed)
            delta = fa.attention_delta(out.detach(), dout)
            args = (q, k, v, dout, lse, delta, bias, causal, p, seed)
            ref = fa.flash_attention_backward_reference(
                *args, need_dmask=trainable)
            torch.cuda.synchronize()
            e1, t1, e_lse = check_k1(fwd, lse, q, k, v, dtype, bias, causal,
                                     p, seed)
            errs = {"K1": (e1, t1), "K2": check_rel("K2", qg.grad, ref[0],
                                                    dtype)}
            errs["K3"] = max(check_rel("K3", kg.grad, ref[1], dtype),
                             check_rel("K3", vg.grad, ref[2], dtype),
                             key=lambda et: et[0] / et[1])
            if trainable:
                errs["K2m"] = check_rel("K2m", bias_g.grad, ref[3], dtype)
            prep = fa._bwd_prepare(q, k, v, dout, lse, delta, bias, p, seed,
                                   "t5_kernel_cases")
            ms1 = time_ms(lambda: fa.flash_attention(q, k, v, bias, causal,
                                                     True, p, seed))
            ms2 = time_ms(lambda: fa._launch_dq(prep, causal))
            ms3 = time_ms(lambda: fa._launch_dkv(prep, causal))
            plain_ms = time_ms(lambda: fa.flash_attention_backward_reference(
                *args, need_dmask=trainable), 5, 1)
            plain1_ms = time_ms(lambda: fa.flash_attention_reference(
                q, k, v, bias, causal, True, p, seed), 5, 1)
            # the yardsticks: sdpa's forward, and its backward from one
            # forward
            qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_()
                          for x in (q, k, v))
            lib_mask, lib_leaf = None, None
            if trainable:
                lib_leaf = bias.to(dtype).requires_grad_()
                lib_mask = lib_leaf
                if causal:
                    lib_mask = lib_leaf + torch.full(
                        (sq, sk), float("-inf"), device=dev,
                        dtype=dtype).triu(1)
            sdpa = torch.nn.functional.scaled_dot_product_attention
            lib_out = sdpa(qt, kt, vt, attn_mask=lib_mask, dropout_p=p,
                           is_causal=causal and lib_mask is None)
            with torch.no_grad():
                lib1_ms = time_ms(lambda: sdpa(
                    qt, kt, vt, attn_mask=lib_mask, dropout_p=p,
                    is_causal=causal and lib_mask is None))
            wrt = (qt, kt, vt) + ((lib_leaf,) if trainable else ())
            dout_t = dout.transpose(1, 2)
            lib_ms = time_ms(lambda: torch.autograd.grad(
                lib_out, wrt, dout_t, retain_graph=True))
            pairs = sq * (sq + 1) // 2 if causal else sq * sk
            io_in = nbytes(q, k, v, dout, lse, delta) + (
                nbytes(bias) if trainable else 0)
            b1 = bound(nbytes(q, k, v, fwd, lse) + (nbytes(bias) if trainable
                                                    else 0),
                       4 * b * h * d * pairs, dtype)
            b2 = bound(io_in + nbytes(q), 6 * b * h * d * pairs, dtype)
            b3 = bound(io_in + nbytes(k, v), 8 * b * h * d * pairs, dtype)
            case = (f"T5 {label} ({b}, {sq}, {sk}, {h}, {d})"
                    f"{', causal' if causal else ''}"
                    f"{', (1, h, q, k) bias' if trainable else ''}, "
                    f"dropout {p}")
            note = ("sdpa backward, all grads together"
                    + (", the float mask's included" if trainable else ""))
            r1 = _row(dtype, case, e1, t1, ms1, plain1_ms, lib1_ms, *b1,
                      lse_err=e_lse, library_note="sdpa forward")
            r2 = _row(dtype, case, *errs["K2"], ms2, plain_ms, lib_ms, *b2,
                      library_note=note)
            r3 = _row(dtype, case, *errs["K3"], ms3, plain_ms, lib_ms, *b3,
                      library_note=note)
            for name, r in (("K1", r1), ("K2", r2), ("K3", r3)):
                _log_row(name, r)
                rows.append((name, r))
            if trainable:
                groups = fa.dmask_groups(b, h, sq, bias.shape, fa._sms(dev))
                dq1, part = fa._launch_dq(prep, causal, groups)
                ms2m = time_ms(lambda: fa._launch_dq(prep, causal, groups))
                sum_ms = time_ms(lambda: fa.reduce_dmask(part, bias))
                # no atomics: a second launch gives the same bits
                dq2, part2 = fa._launch_dq(prep, causal, groups)
                if not (torch.equal(dq1, dq2) and torch.equal(part, part2)):
                    raise AssertionError(f"K2m {label}: two launches differ")
                buf_ms = nbytes(part) / HBM_BYTES_PER_S * 1e3
                bm = bound(io_in + nbytes(q, bias), 6 * b * h * d * pairs,
                           dtype)
                rm = _row(dtype, case, *errs["K2m"], ms2m + sum_ms, plain_ms,
                          lib_ms, *bm, kernel_ms=ms2m, ms_without_dmask=ms2,
                          batch_sum_ms=sum_ms, groups=groups,
                          buffer_bytes=nbytes(part),
                          whole_ds_bytes=b * h * sq * sk * 4,
                          buffer_bound_ms=buf_ms, library_note=note)
                _log_row("K2m", rm)
                log(f"[K2m] {rm['dtype']} {label}: K2 with d(mask) "
                    f"{ms2m:.4f} ms, without {ms2:.4f} ms; batch sum "
                    f"{sum_ms:.4f} ms; {groups} batch groups, partials "
                    f"{nbytes(part)} B (the whole dS: {b * h * sq * sk * 4} "
                    f"B), written alone in {buf_ms:.4f} ms at 3.35 TB/s; "
                    "dQ and the partials bit-identical over two launches")
                rows.append(("K2m", rm))
                del dq1, dq2, part, part2
            if dtype == torch.bfloat16 and label == "encoder self":
                main = {"K2m": rm}
            del qg, kg, vg, out, lib_out, qt, kt, vt, ref, prep
    return main


def t5_counters():
    """The T5 step's launch counters: (fn, attribute) by kernel."""
    from paddle_tpu_torch.ops import flash_attention as fa

    out = {k: (fn, "launches") for k, fn in train_counters().items()}
    out["K2m"] = (fa.flash_attention_dq, "dmask_launches")
    return out


def t5_flops_per_step(model, batch, src, tgt):
    """FLOPs of one T5 training step: 6 x (each encoder matrix x source
    tokens + the cross-attention K / V matrices x source tokens + each
    other decoder matrix x target tokens) + 6 x d x vocab x target tokens
    (the tied head) + 12 x b x h x d_kv x sum of sq x sk over the 36
    attention calls. Embedding lookups, norms and the bias tables do no
    matrix work and are left out."""
    cfg = model.config
    t5 = model.t5

    def mats(mod, skip=()):
        return sum(m.weight.numel() for n, m in mod.named_modules()
                   if isinstance(m, torch.nn.Linear)
                   and not any(n.endswith(s) for s in skip))

    t_src, t_tgt = batch * src, batch * tgt
    n_enc = mats(t5.encoder_layers)
    n_cross_kv = sum(mats(layer.cross_attn) - mats(layer.cross_attn,
                                                   ("k", "v"))
                     for layer in t5.decoder_layers)
    n_dec = mats(t5.decoder_layers) - n_cross_kv
    n_enc_l, n_dec_l = len(t5.encoder_layers), len(t5.decoder_layers)
    pairs = n_enc_l * src * src + n_dec_l * (tgt * tgt + tgt * src)
    return (6 * ((n_enc + n_cross_kv) * t_src + n_dec * t_tgt)
            + 6 * cfg.d_model * cfg.vocab_size * t_tgt
            + 12 * batch * cfg.num_heads * cfg.d_kv * pairs)


def phase_train_t5(seed, dev, profile=False, out_dir=None):
    from paddle_tpu_torch.models import T5Config, T5ForConditionalGeneration
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.training import make_seq2seq_train_step

    cfg = T5Config.t5_base()
    batch, src, tgt, warmup, steps = 32, 512, 114, 3, 10
    held = torch.cuda.memory_allocated()    # left by earlier phases
    model = T5ForConditionalGeneration(cfg, device=dev, seed=seed)
    opt = Adam(learning_rate=1e-4, parameters=model.parameters())
    step = make_seq2seq_train_step(model, opt)
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.RandomState(seed + 3)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (batch, src))
                           ).to(dev)
    labels_np = rng.randint(1, cfg.vocab_size, (batch, tgt))
    labels_np[::4, -6:] = -100                  # a few ignored targets
    labels = torch.from_numpy(labels_np).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    log(f"[train_t5] T5-base ({cfg.num_layers} + {cfg.num_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.num_heads} heads of {cfg.d_kv}, d_ff "
        f"{cfg.d_ff}, {cfg.feed_forward_proj}, vocab {cfg.vocab_size}, "
        f"{n_params / 1e6:.1f} M params), batch {batch} x {src} source + "
        f"{tgt} target tokens, bf16 O1, dropout {cfg.dropout_rate}, Adam "
        f"1e-4")
    losses = []
    t0 = time.perf_counter()
    for i in range(warmup):
        torch.cuda.set_sync_debug_mode("error" if i == warmup - 1 else 0)
        try:
            losses.append(step(ids, labels, gen))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    log("[train_t5] a warm-up step ran under torch.cuda.set_sync_debug_mode"
        "('error'): no host sync in the step")
    counters = t5_counters()
    torch.cuda.reset_peak_memory_stats()
    zero_counters(counters)
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(step(ids, labels, gen))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters(counters)
    peak = torch.cuda.max_memory_allocated()
    loss_vals = [float(x) for x in losses]
    tokens = batch * (src + tgt)
    tps = tokens * steps / wall
    flops = t5_flops_per_step(model, batch, src, tgt)
    mfu = flops * steps / wall / PEAK_FLOPS[torch.bfloat16]
    log(f"[train_t5] warm-up {warmup} steps {warm_s:.2f} s; {steps} timed "
        f"steps {wall:.3f} s: {tps:.1f} tokens/s/chip ({tokens} source + "
        f"target tokens a step), step {wall / steps * 1e3:.2f} ms, MFU "
        f"{mfu:.4f} ({flops / 1e12:.3f} TFLOP a step over 989 TFLOP/s), "
        f"peak memory {peak / 2**30:.2f} GiB ({held / 2**30:.2f} GiB held "
        f"before the phase)")
    log(f"[train_t5] loss by step: " + ", ".join(f"{x:.4f}"
                                                 for x in loss_vals))
    log(f"[train_t5] launches in the {steps} timed steps: {launches}")
    if not all(np.isfinite(loss_vals)):
        raise AssertionError(f"non-finite T5 loss: {loss_vals}")
    if not loss_vals[-1] < loss_vals[0]:
        raise AssertionError(f"T5 loss did not fall: {loss_vals}")
    wrong = {k: n for k, n in launches.items()
             if n != T5_LAUNCHES[k] * steps}
    if wrong:
        raise AssertionError(f"T5 launches {wrong} (over {steps} steps) != "
                             f"expected per step {T5_LAUNCHES}")
    prof = None
    if profile:
        prof = profile_window("train_t5_step",
                              lambda: step(ids, labels, gen), out_dir)
    return dict(launches=launches, tokens_per_s=tps,
                step_ms=wall / steps * 1e3, mfu=mfu, flops_per_step=flops,
                n_params=n_params, peak_bytes=peak, held_bytes=held,
                losses=loss_vals, wall_s=wall, warmup_s=warm_s, profile=prof)


def grad_errors(model, ref):
    """{name: (max abs error, max |ref grad|)} of every parameter gradient
    of `model` against the same-named gradient of `ref`."""
    ref_params = dict(ref.named_parameters())
    out = {}
    for name, p in model.named_parameters():
        g, gr = p.grad, ref_params[name].grad
        if (g is None) != (gr is None):
            raise AssertionError(f"{name}: gradient on one side only")
        if g is not None:
            out[name] = (float((g.cpu() - gr).abs().max()),
                         float(gr.abs().max()))
    return out


def check_grads(errs, losses, tag, rtol):
    """Loss and every parameter gradient, card against CPU: |loss
    difference| <= LOSS_RTOL x |loss| and every max abs gradient error of
    `errs` (grad_errors' result) <= rtol x max |CPU grad|. Returns (worst
    relative error, its name)."""
    dl = abs(losses["card"] - losses["cpu"])
    if not dl <= LOSS_RTOL * abs(losses["cpu"]):
        raise AssertionError(f"{tag}: loss card {losses['card']} vs cpu "
                             f"{losses['cpu']}")
    bad = {n: e for n, e in errs.items() if not e[0] <= rtol * e[1] + 1e-12}
    if bad:
        raise AssertionError(f"{tag}: gradients beyond {rtol} x max|cpu "
                             f"grad| (max abs error, max|cpu grad|): {bad}")
    return worst_rel(errs)


def worst_rel(errs):
    """(worst relative error, its name) of grad_errors' result."""
    rel = {n: e / s if s > 0 else e for n, (e, s) in errs.items()}
    name = max(rel, key=rel.get)
    return rel[name], name


class shared_relu_masks:
    """Context in which the port's `F.relu` shares its masks between passes
    over one model: `record()` before a pass keeps each call's mask (x > 0)
    in call order; `replay()` before a later pass makes the i-th call
    return x * mask_i, whose gradient is mask_i, as ReLU's is. A ReLU model's
    card and CPU passes then take the same branches, and an fp32 rounding
    difference upstream can no longer flip a mask and move a gradient by a
    whole token's share."""

    def __enter__(self):
        from paddle_tpu_torch.nn import functional as F

        self._F, self._relu = F, F.relu
        self.masks, self._i, self._mode = [], 0, None
        F.relu = self._call
        return self

    def record(self):
        self.masks, self._mode = [], "record"

    def replay(self):
        self._i, self._mode = 0, "replay"

    def _call(self, x):
        if self._mode == "record":
            self.masks.append((x > 0).detach().cpu())
            return self._relu(x)
        m = self.masks[self._i]
        self._i += 1
        return x * m.to(device=x.device, dtype=x.dtype)

    def __exit__(self, *exc):
        self._F.relu = self._relu
        return False


class plain_versions:
    """Context in which the port's functional layer runs attention and
    RMSNorm through their plain PyTorch versions (autograd through them)
    even on CUDA tensors: the card's own reference for a whole step."""

    def __enter__(self):
        from paddle_tpu_torch.nn import functional as F
        from paddle_tpu_torch.ops import flash_attention as fa
        from paddle_tpu_torch.ops import norm

        self._F = F
        self._saved = F._attention, F._rms_norm
        F._attention = (lambda q, k, v, m, c, p, s:
                        fa.flash_attention_reference(q, k, v, m, c, False, p,
                                                     s))
        F._rms_norm = (lambda x, w, eps:
                       norm.norm_forward_reference(x, w, None, eps, False)[0])
        return self

    def __exit__(self, *exc):
        self._F._attention, self._F._rms_norm = self._saved
        return False


def phase_t5_step_check(seed, dev):
    """A 2-layer T5 at full width (2 encoder + 2 decoder layers), fp32,
    dropout 0, batch 2, 512 source / 114 target tokens: loss and every
    gradient on the card, through the kernels (d(mask) included) and again
    through the plain versions on the card, against the CPU (plain
    versions): the loss under LOSS_RTOL, every kernel-path gradient under
    T5_GRAD_RTOL, for the gated-GELU FFN and for ReLU (T5-base's own). The
    ReLU passes on the card replay the CPU pass's ReLU masks
    (`shared_relu_masks`): without that, an fp32 rounding difference
    anywhere upstream flips the mask of activations near zero and moves a
    gradient by a whole token's share (~2e-2, the plain versions on the
    card as far off as the kernels; PERF.md, section 6)."""
    from paddle_tpu_torch.models import T5Config, T5ForConditionalGeneration

    rng = np.random.RandomState(seed + 4)
    counters = t5_counters()
    out = {}
    for ff in ("gated-gelu", "relu"):
        cfg = T5Config.t5_base()
        cfg.num_layers = 2
        cfg.dropout_rate = 0.0
        cfg.feed_forward_proj = ff
        card = T5ForConditionalGeneration(cfg, device=dev, seed=seed)
        cpu = T5ForConditionalGeneration(cfg, device="cpu", seed=seed)
        state = {k: v.cpu() for k, v in card.state_dict().items()}
        cpu.load_state_dict(state)
        ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 512)))
        labels = torch.from_numpy(rng.randint(1, cfg.vocab_size, (2, 114)))
        labels[:, ::9] = -100                   # some ignored targets

        def run(m):
            m.zero_grad(set_to_none=True)
            m.train()
            d = next(m.parameters()).device
            lab = labels.to(d)
            loss = m.loss(m(ids.to(d), m.shift_right(lab)), lab)
            loss.backward()
            return float(loss.detach())

        with shared_relu_masks() as relu:
            relu.record()
            loss_cpu = run(cpu)
            relu.replay()
            before = read_counters(counters)
            loss_card = run(card)
            ran = {k: n - before[k]
                   for k, n in read_counters(counters).items()}
            if any(n <= 0 for n in ran.values()):
                raise AssertionError(f"the card's T5 step skipped a kernel: "
                                     f"{ran}")
            kernels = grad_errors(card, cpu)
            relu.replay()
            with plain_versions():
                loss_plain = run(card)
            plain = grad_errors(card, cpu)
            if (ff == "relu") != bool(relu.masks):
                raise AssertionError(f"t5_step_check {ff}: "
                                     f"{len(relu.masks)} ReLU masks shared")
        losses = {"card": loss_card, "cpu": loss_cpu}
        worst = check_grads(kernels, losses, f"t5_step_check {ff}",
                            T5_GRAD_RTOL)
        worst_plain = worst_rel(plain)
        bias = {n.split(".")[1] + "." + n.split(".")[2]:
                kernels[n][0] / kernels[n][1] for n in kernels
                if "relative_attention_bias" in n}
        held = f"every gradient within {T5_GRAD_RTOL} x max|cpu grad|"
        if ff == "relu":
            held += f" ({len(relu.masks)} ReLU masks from the CPU pass)"
        log(f"[t5_step_check] {ff}, 2 + 2 layers full width fp32, 512 / "
            f"114: loss card {loss_card!r} cpu {loss_cpu!r} (plain on the "
            f"card {loss_plain!r}); {held}: kernels worst {worst[0]:.3g} "
            f"({worst[1]}), plain versions on the card worst "
            f"{worst_plain[0]:.3g} ({worst_plain[1]}); bias tables "
            f"{ {k: f'{v:.3g}' for k, v in bias.items()} }; kernels launched "
            f"{ran}")
        out[ff] = dict(loss_card=loss_card, loss_cpu=loss_cpu,
                       loss_plain_on_card=loss_plain, worst_grad_rel=worst[0],
                       worst_grad=worst[1],
                       worst_plain_grad_rel=worst_plain[0],
                       worst_plain_grad=worst_plain[1], bias_grad_rel=bias,
                       launches=ran)
        del card, cpu
    return out


def moe_gate(kind, dev):
    """The gate of each MoE run: GShard top-2 as the layer's config dict
    (capacity factor 1.2), Switch top-1 with capacity (1.25, 2.0)."""
    from paddle_tpu_torch.incubate.distributed.models.moe import SwitchGate

    if kind == "gshard":
        return {"type": "gshard", "top_k": 2}
    return SwitchGate(MOE_D, num_expert=MOE_E, capacity=(1.25, 2.0),
                      device=dev)


def moe_layer(kind, dev, seed, act=torch.nn.ReLU):
    """MoELayer at Switch-Base-8's widths: MOE_E experts of Linear(768,
    3072), `act`, Linear(3072, 768) with the port's Linear (cast by O1)."""
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    from paddle_tpu_torch.nn import Linear

    experts = [torch.nn.Sequential(Linear(MOE_D, MOE_FF, device=dev), act(),
                                   Linear(MOE_FF, MOE_D, device=dev))
               for _ in range(MOE_E)]
    return MoELayer(MOE_D, experts, gate=moe_gate(kind, dev), device=dev,
                    seed=seed)


def moe_batch(seed, dev):
    """(x, target), fp32 (MOE_B, MOE_S, MOE_D), drawn on the card from the
    seed."""
    g = torch.Generator(device=dev).manual_seed(seed + 11)
    shape = (MOE_B, MOE_S, MOE_D)
    return (torch.randn(shape, generator=g, device=dev),
            torch.randn(shape, generator=g, device=dev))


def k9_cases(rows, dev, seed):
    """K9 (the row gather) against its plain version on the card: a copy, so
    bit-exact. The dispatch (x's 16384 fp32 rows into E x C slots) and the
    combine (E x C bf16 expert rows back to T x k) with the indices of the
    real routing of the train phase's first batch, for the GShard and the
    Switch gate, and the odd case of tests/test_moe_fused.py (301 x 9 fp32,
    413 indices in [-1, 301)), which takes the 4-byte path. The library
    yardstick: torch.index_select over src with a zero row appended, -1
    mapped to that row (the mapping and the append outside the timing)."""
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    from paddle_tpu_torch.ops import moe_dispatch as md

    x, _ = moe_batch(seed, dev)
    flat = x.reshape(-1, MOE_D)
    g = torch.Generator(device=dev).manual_seed(seed + 9)
    cases = []
    for kind in ("gshard", "switch"):
        router = MoELayer(MOE_D, [torch.nn.Identity()] * MOE_E,
                          gate=moe_gate(kind, dev), device=dev, seed=seed)
        slot_token, tok_slot, cap = router.dispatch_indices(x)
        out_rows = torch.randn(MOE_E * cap, MOE_D, generator=g, device=dev)
        cases += [(f"dispatch {kind} ({flat.shape[0]}, {MOE_D}) -> "
                   f"{MOE_E} x {cap}", flat, slot_token),
                  (f"combine {kind} ({MOE_E * cap}, {MOE_D}) -> "
                   f"{tok_slot.numel()}", out_rows.bfloat16(),
                   tok_slot.reshape(-1))]
    rng = np.random.RandomState(2)
    cases.append(("odd (301, 9) -> 413",
                  torch.from_numpy(rng.randn(301, 9).astype(np.float32)
                                   ).to(dev),
                  torch.from_numpy(rng.randint(-1, 301, 413).astype(
                      np.int32)).to(dev)))
    main = {}
    for label, src, idx in cases:
        out = md.gather_rows(src, idx)
        ref = md.gather_rows_reference(src, idx)
        n, d = src.shape
        src_z = torch.cat([src, src.new_zeros(1, d)])
        idx_z = torch.where(idx < 0, n, idx)
        lib = torch.index_select(src_z, 0, idx_z)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        if not (torch.equal(out, ref) and torch.equal(lib, ref)):
            raise AssertionError(f"K9 {label}: not bit-exact to the plain "
                                 f"version (max abs error {err})")
        ms = time_ms(lambda: md.gather_rows(src, idx))
        plain_ms = time_ms(lambda: md.gather_rows_reference(src, idx))
        lib_ms = time_ms(lambda: torch.index_select(src_z, 0, idx_z))
        live = int((idx >= 0).sum())
        es = src.element_size()
        # each output row written, each live row read once, the indices
        b9 = bound(idx.numel() * d * es + live * d * es + nbytes(idx), 0,
                   src.dtype)
        r = _row(src.dtype, label, err, 0.0, ms, plain_ms, lib_ms, *b9,
                 empty_share=1.0 - live / idx.numel(),
                 library_note="torch.index_select over src with a zero row "
                              "appended, -1 mapped to it")
        _log_row("K9", r)
        log(f"[K9] {label}: bit-exact; {1 - live / idx.numel():.4f} of the "
            f"indices empty")
        rows.append(("K9", r))
        if label.startswith("dispatch gshard"):
            main["K9"] = r
        elif label.startswith("combine gshard"):
            main["K9 combine"] = r
    return main


def moe_flops(layer, tokens, capacity):
    """(model FLOPs, executed FLOPs) of one MoE train step: 6 x tokens x k x
    (2 d d_ff) + 6 x tokens x d x E (the gate) for the model; the experts
    run over all E x C slots, so 6 x E x C x (2 d d_ff) + the gate's are
    executed."""
    k = layer.gate.topk
    gate = 6 * tokens * MOE_D * MOE_E
    expert = 2 * MOE_D * MOE_FF
    return (6 * tokens * k * expert + gate,
            6 * MOE_E * capacity * expert + gate)


def phase_train_moe(kind, seed, dev, profile=False, out_dir=None):
    """The MoE layer's train step at Switch-Base-8's widths through K9."""
    from paddle_tpu_torch.ops import moe_dispatch as md
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.training import make_moe_train_step

    warmup, steps = 3, 10
    tag = f"train_moe_{kind}"
    held = torch.cuda.memory_allocated()    # left by earlier phases
    layer = moe_layer(kind, dev, seed)
    opt = Adam(learning_rate=1e-4, parameters=layer.parameters())
    step = make_moe_train_step(layer, opt)
    n_params = sum(p.numel() for p in layer.parameters())
    x, target = moe_batch(seed, dev)
    tokens = MOE_B * MOE_S
    log(f"[{tag}] MoELayer at Switch-Base-8 widths ({MOE_E} experts of "
        f"Linear({MOE_D}, {MOE_FF}), ReLU, Linear({MOE_FF}, {MOE_D}); "
        f"{type(layer.gate).__name__} top-{layer.gate.topk}, capacity "
        f"factor {layer.capacity_factor}; {n_params / 1e6:.2f} M params), "
        f"x ({MOE_B}, {MOE_S}, {MOE_D}) fp32, mse_loss + 0.01 aux, bf16 O1, "
        f"Adam 1e-4")
    losses = []
    t0 = time.perf_counter()
    for i in range(warmup):
        torch.cuda.set_sync_debug_mode("error" if i == warmup - 1 else 0)
        try:
            losses.append(step(x, target))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    log(f"[{tag}] a warm-up step ran under torch.cuda.set_sync_debug_mode"
        "('error'): no host sync in the step")
    _, tok_slot, cap = layer.dispatch_indices(x)
    dropped = float((tok_slot < 0).float().mean())
    counters = {"K9": (md.gather_rows, "launches")}
    torch.cuda.reset_peak_memory_stats()
    zero_counters(counters)
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(step(x, target))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters(counters)
    peak = torch.cuda.max_memory_allocated()
    loss_vals = [float(v) for v in losses]
    tps = tokens * steps / wall
    flops, flops_exec = moe_flops(layer, tokens, cap)
    mfu = flops * steps / wall / PEAK_FLOPS[torch.bfloat16]
    log(f"[{tag}] warm-up {warmup} steps {warm_s:.2f} s; {steps} timed "
        f"steps {wall:.3f} s: {tps:.1f} tokens/s/chip, step "
        f"{wall / steps * 1e3:.2f} ms, MFU {mfu:.4f} ({flops / 1e12:.3f} "
        f"TFLOP a step by the model, {flops_exec / 1e12:.3f} executed over "
        f"{MOE_E} x {cap} slots; over 989 TFLOP/s), peak memory "
        f"{peak / 2**30:.2f} GiB ({held / 2**30:.2f} GiB held before the "
        f"phase); dropped (token, choice) pairs {dropped:.4f}")
    log(f"[{tag}] loss by step: " + ", ".join(f"{v:.5f}" for v in loss_vals))
    log(f"[{tag}] launches in the {steps} timed steps: {launches}")
    if not all(np.isfinite(loss_vals)):
        raise AssertionError(f"non-finite MoE loss: {loss_vals}")
    if not loss_vals[-1] < loss_vals[0]:
        raise AssertionError(f"MoE loss did not fall: {loss_vals}")
    wrong = {k: n for k, n in launches.items()
             if n != MOE_LAUNCHES[k] * steps}
    if wrong:
        raise AssertionError(f"MoE launches {wrong} (over {steps} steps) != "
                             f"expected per step {MOE_LAUNCHES}")
    prof = None
    if profile:
        prof = profile_window(f"{tag}_step", lambda: step(x, target),
                              out_dir)
    return dict(gate=type(layer.gate).__name__, top_k=layer.gate.topk,
                capacity=cap, launches=launches, tokens_per_s=tps,
                step_ms=wall / steps * 1e3, mfu=mfu, flops_per_step=flops,
                executed_flops_per_step=flops_exec, n_params=n_params,
                peak_bytes=peak, held_bytes=held, dropped_share=dropped,
                losses=loss_vals, wall_s=wall, warmup_s=warm_s,
                profile=prof)


def phase_moe_step_check(seed, dev):
    """The MoE layer at full width (GShard top-2, GELU experts, as
    tests/test_moe_fused.py builds them), fp32, 1024 tokens: the routing,
    then the loss and every gradient, on the card (through K9) against the
    CPU (the plain version), from the same weights. Twice: at the gate's
    capacity factor 1.2, where these random tokens drop nothing, and at 0.5,
    where about half the (token, choice) pairs are dropped, so the capacity
    mask, the renormalized gates and the combine's empty slots are held
    too."""
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import moe_dispatch as md

    card = moe_layer("gshard", dev, seed, act=torch.nn.GELU)
    cpu = moe_layer("gshard", "cpu", seed, act=torch.nn.GELU)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    rng = np.random.RandomState(seed + 5)
    x = torch.from_numpy(rng.randn(2, 512, MOE_D).astype(np.float32))
    target = torch.from_numpy(rng.randn(2, 512, MOE_D).astype(np.float32))
    out = {}
    for cf in (card.capacity_factor, 0.5):
        card.capacity_factor = cpu.capacity_factor = cf
        routes = {}
        for name, m in (("card", card), ("cpu", cpu)):
            d = m.gate.gate_weight.device
            routes[name] = [t.cpu() for t in m.dispatch_indices(x.to(d))[:2]]
        differ = [int((a != b).sum()) for a, b in zip(routes["card"],
                                                      routes["cpu"])]
        dropped = float((routes["cpu"][1] < 0).float().mean())
        tag = f"capacity factor {cf}"
        log(f"[moe_step_check] {tag}: routing card vs cpu: slot_token "
            f"differs in {differ[0]} of {routes['cpu'][0].numel()}, tok_slot "
            f"in {differ[1]} of {routes['cpu'][1].numel()}; dropped pairs "
            f"{dropped:.4f}")
        if any(differ):
            raise AssertionError(f"moe_step_check {tag}: the card routes "
                                 f"differently from the CPU ({differ})")
        losses = {}
        before = md.gather_rows.launches
        for name, m in (("card", card), ("cpu", cpu)):
            m.zero_grad(set_to_none=True)
            m.train()
            d = m.gate.gate_weight.device
            loss = F.mse_loss(m(x.to(d)), target.to(d)) + 0.01 * m.aux_loss
            loss.backward()
            losses[name] = float(loss.detach())
        ran = md.gather_rows.launches - before
        if ran != MOE_LAUNCHES["K9"]:
            raise AssertionError(f"the card's MoE step launched K9 {ran} "
                                 f"times")
        worst, worst_name = check_grads(grad_errors(card, cpu), losses,
                                        f"moe_step_check {tag}",
                                        MOE_GRAD_RTOL)
        dl = abs(losses["card"] - losses["cpu"])
        log(f"[moe_step_check] {tag}, GShard top-2, GELU experts, full "
            f"width fp32, 1024 tokens: loss card {losses['card']!r} cpu "
            f"{losses['cpu']!r} (|diff| {dl:.3g}, tol {LOSS_RTOL} x |loss|); "
            f"every gradient within {MOE_GRAD_RTOL} x max|cpu grad|, worst "
            f"{worst:.3g} ({worst_name}); K9 launched {ran}")
        out[str(cf)] = dict(loss_card=losses["card"],
                            loss_cpu=losses["cpu"], routing_differs=differ,
                            dropped_share=dropped, worst_grad_rel=worst,
                            worst_grad=worst_name, launches={"K9": ran})
    return out


# ------------------------------------------------- the multi-rank slice

# One rank's shard of ring attention at LLaMA-7B's attention widths (32
# heads of 128) over a global sequence of RING_GLOBAL split over
# RING_RANKS ranks: (batch, s_local, heads, head_dim), bf16, causal
RING_RANKS = 4
RING_GLOBAL = 16384
RING_ATTN = (1, RING_GLOBAL // RING_RANKS, 32, 128)
# the ring step kinds at that shard: name -> (q_off, k_off); the diagonal
# is a rank's own step, the past block a step whose keys all lie before
# its queries, the future block one whose keys all lie after them (a
# causal ring launches it all the same), the unaligned one a shift that
# no tile boundary matches
RING_STEPS = {"diagonal": (4096, 4096), "past": (8192, 4096),
              "future": (0, 4096), "unaligned": (4096 + 37, 4096)}
# a ragged shard (1000 rows, no multiple of the kernels' 64-row tiles)
RING_RAGGED = (1000, (1000 + 13, 1000))
# the second ring run: a global sequence short enough for the plain
# versions to hold the whole attention, in fp32
RING_SMALL = 2048
# the ring / Ulysses runs: (global sequence, dtype); the bf16 one is timed
SP_RUNS = ((RING_GLOBAL, torch.bfloat16), (RING_SMALL, torch.float32))
# Every sequence-parallel check reads each rank's part of the sequence on
# its own (`shard_errors`): the max abs error over that part's max|ref|,
# and the L2 error over its L2 norm, each under a limit of its own. The max
# alone is loose where a part holds a few large values among many small
# ones (the first query rows see one key or a few, so their outputs are
# v's own values; the first keys' dK / dV gather every query); the L2
# error reads a dropped or misplaced ring step as a change of order one.
# The single-call K1 / K2 / K3 over the whole RING_GLOBAL in bf16, against
# their plain versions one head at a time (K1's on the values cast to fp32,
# as check_k1): (max, L2) limits. The max may reach one output ulp, up to
# 2^-7 of a value (the largest reading, dV 5.08e-3); the L2 limits are
# about twice the largest readings (out 2.31e-3, dQ / dK / dV 4.29e-4 on an
# H100; PERF.md, section 6)
SP_SINGLE_TOL = {"out": (1e-2, 5e-3), "dq": (1e-2, 1e-3),
                 "dk": (1e-2, 1e-3), "dv": (1e-2, 1e-3)}
# ring / Ulysses against one call over the whole sequence, (max, L2): bf16
# against the single-call kernels (the ring rounds each step's partial
# output and dK / dV to bf16 before its fp32 merge and sums, the single
# call rounds once; the largest readings: max 7.75e-3, one ulp of a value
# near the part's max, L2 3.20e-3); fp32 against the plain versions
# (summation order only; the largest readings: max 3.95e-6, L2 1.30e-6 on
# an H100; PERF.md, section 6). A ring step left out of the merge or of dK
# reads L2 0.19-0.60 (a CPU rehearsal at a global 256).
SP_TOL = {torch.bfloat16: (2e-2, 1e-2), torch.float32: (2e-5, 5e-6)}
# expert parallelism: a capacity factor at which the ranks' 4096 tokens
# drop no (token, choice) pair, and the limit of EP against the
# single-rank layer on the card (fp32, the same products over other row
# batches: summation order only), relative to max|single-rank value|
MOE_EP_CF = 2.0
MOE_EP_RTOL = 2e-5


def live_pairs(sq, sk, q_off, k_off):
    """The (query, key) pairs a causal step at offsets (q_off, k_off)
    computes: row r sees clamp(r + q_off - k_off + 1, 0, sk) keys."""
    vis = torch.arange(sq, dtype=torch.int64) + (q_off - k_off + 1)
    return int(vis.clamp(0, sk).sum())


def _ring_lse_check(got, ref, tag):
    """lse against its plain version: -inf exactly where the plain one is
    (rows that see no key), within TOL_LSE elsewhere."""
    inf_ref, inf_got = torch.isneginf(ref), torch.isneginf(got)
    if not torch.equal(inf_ref, inf_got):
        raise AssertionError(f"{tag}: lse is -inf at other rows than its "
                             "plain version's")
    fin = ~inf_ref
    err = max_err(got[fin], ref[fin]) if bool(fin.any()) else 0.0
    if not err <= TOL_LSE:
        raise AssertionError(f"{tag}: lse max abs error {err} > {TOL_LSE}")
    return err


def ring_kernel_case(rows, dev, dtype, label, shape, offs, timed):
    """K1r, K2r and K3r at one ring step (q / k / v shards of `shape`, the
    global offsets `offs`) against their plain versions on the same values,
    K1r's on the values cast to fp32 as check_k1. Returns {kernel: row}."""
    from paddle_tpu_torch.ops import flash_attention as fa

    b, s, h, d = shape
    g = torch.Generator(device=dev).manual_seed(41)
    q, k, v, dout = (torch.randn(b, s, h, d, generator=g, device=dev)
                     .to(dtype) for _ in range(4))
    ring = dict(is_causal=True, offsets=offs)
    out, lse = fa.flash_attention(q, k, v, return_lse=True,
                                  keep_neg_inf_lse=True, **ring)
    ref, ref_lse = fa.flash_attention_reference(
        q.float(), k.float(), v.float(), None, True, True, offsets=offs,
        keep_neg_inf_lse=True)
    e1, t1 = check_rel("K1r", out, ref, dtype)
    e_lse = _ring_lse_check(lse, ref_lse, f"K1r {label}")
    lse0 = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))
    delta = fa.attention_delta(out, dout)
    args = (q, k, v, dout, lse0, delta)
    dq = fa.flash_attention_dq(*args, **ring)
    dk, dv = fa.flash_attention_dkv(*args, **ring)
    rdq, rdk, rdv = fa.flash_attention_backward_reference(
        *args, None, True, offsets=offs)
    torch.cuda.synchronize()
    e2, t2 = check_rel("K2r", dq, rdq, dtype)
    ek, tk = check_rel("K3r", dk, rdk, dtype)
    ev, tv = check_rel("K3r", dv, rdv, dtype)
    e3, t3 = (ek, tk) if ek * tv >= ev * tk else (ev, tv)
    live = live_pairs(s, s, *offs)
    if live == 0:
        # a block wholly in the future: nothing attends
        zero = {"out": out, "dq": dq, "dk": dk, "dv": dv}
        bad = {n: max_err(t, torch.zeros_like(t)) for n, t in zero.items()
               if bool(t.any())}
        if bad or not bool(torch.isneginf(lse).all()):
            raise AssertionError(f"ring step {label}: nonzero {bad} or a "
                                 "finite lse where no key is visible")
    if label == "diagonal":
        # the diagonal of a ring is one call's causal attention, bit for bit
        o1, l1 = fa.flash_attention(q, k, v, is_causal=True, return_lse=True)
        same = {"out": max_err(out, o1), "lse": max_err(lse, l1),
                "dq": max_err(dq, fa.flash_attention_dq(
                    q, k, v, dout, lse0, delta, is_causal=True)),
                "dk/dv": max(max_err(a, b_) for a, b_ in zip(
                    (dk, dv), fa.flash_attention_dkv(
                        q, k, v, dout, lse0, delta, is_causal=True)))}
        if any(e != 0 for e in same.values()):
            raise AssertionError(f"ring diagonal differs from the single "
                                 f"call: {same}")
        log(f"[ring_kernels] {str(dtype)[6:]} diagonal == the single-call "
            f"causal K1 / K2 / K3, bit for bit: {same}")
    ms = plain = lib = None
    times = {}
    if timed:
        iters = 20 if dtype == torch.bfloat16 else 5
        times = {
            "K1r": time_ms(lambda: fa.flash_attention(
                q, k, v, return_lse=True, keep_neg_inf_lse=True, **ring),
                iters, 2),
            "K2r": time_ms(lambda: fa.flash_attention_dq(*args, **ring),
                           iters, 2),
            "K3r": time_ms(lambda: fa.flash_attention_dkv(*args, **ring),
                           iters, 2)}
        plain = {"K1r": time_ms(lambda: fa.flash_attention_reference(
            q, k, v, None, True, True, offsets=offs,
            keep_neg_inf_lse=True), 3, 1)}
        plain["K2r"] = plain["K3r"] = time_ms(
            lambda: fa.flash_attention_backward_reference(
                *args, None, True, offsets=offs), 3, 1)
        # the yardstick: sdpa over the same shards, causal on the diagonal
        # (the same function there), unmasked for the past block, and at
        # the other offsets with the step's causal pattern as a boolean
        # mask (a future step's rows see no key: sdpa computes them all the
        # same and gives no zeros there, so only its time counts)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        kw_lib = {"diagonal": dict(is_causal=True), "past": {}}.get(
            label, dict(attn_mask=fa._causal_keep(s, s, dev, offs)))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib = {"K1r": time_ms(lambda: sdpa(qt, kt, vt, **kw_lib), iters, 2)}
        lo = sdpa(qt, kt, vt, **kw_lib)
        dot = dout.transpose(1, 2)
        lib["K2r"] = lib["K3r"] = time_ms(lambda: torch.autograd.grad(
            lo, (qt, kt, vt), dot, retain_graph=True), iters, 2)
        del qt, kt, vt, lo
    rows_lse = nbytes(lse)
    io = {"K1r": (nbytes(q, k, v), nbytes(out) + rows_lse, 4),
          "K2r": (nbytes(q, k, v, dout, lse, delta), nbytes(dq), 6),
          "K3r": (nbytes(q, k, v, dout, lse, delta), nbytes(dk, dv), 8)}
    errs = {"K1r": (e1, t1), "K2r": (e2, t2), "K3r": (e3, t3)}
    out_rows = {}
    for kern, (bin_, bout, mul) in io.items():
        # a wholly future step needs none of its inputs: its outputs only
        bms, by = bound((bin_ if live else 0) + bout, mul * b * h * d * live,
                        dtype)
        r = _row(dtype, f"{label} offsets {offs} ({b}, {s}, {h}, {d})",
                 errs[kern][0], errs[kern][1], times.get(kern),
                 None if plain is None else plain[kern],
                 None if lib is None else lib[kern], bms, by,
                 live_pairs=live, lse_err=e_lse if kern == "K1r" else None)
        if timed:
            _log_row(kern, r)
        else:
            log(f"[{kern}] {str(dtype)[6:]} {r['case']}: max_abs_err "
                f"{r['max_abs_err']:.3g} (tol {r['tol']:.3g})")
        rows.append((kern, r))
        out_rows[kern] = r
    return out_rows


def phase_ring_kernels(rows, dev):
    """K1r, K2r, K3r at one ring step of RING_ATTN in bf16 (timed) and fp32,
    at every step kind of RING_STEPS, and on the ragged shard. Returns the
    summary's rows (bf16: the diagonal as "K1r" ..., every step kind as
    "K1r steps" ...)."""
    main = {f"{k} steps": {} for k in ("K1r", "K2r", "K3r")}
    for dtype in (torch.bfloat16, torch.float32):
        for label, offs in RING_STEPS.items():
            r = ring_kernel_case(rows, dev, dtype, label, RING_ATTN, offs,
                                 timed=True)
            if dtype == torch.bfloat16:
                for k, row in r.items():
                    main[f"{k} steps"][label] = row
                    if label == "diagonal":
                        main[k] = row
            gc.collect()
            torch.cuda.empty_cache()
        s, offs = RING_RAGGED
        ring_kernel_case(rows, dev, dtype, "ragged", (1, s) + RING_ATTN[2:],
                         offs, timed=False)
    return main


def _ring_counters():
    from paddle_tpu_torch.ops import flash_attention as fa

    return {"K1r": (fa.flash_attention, "ring_launches"),
            "K2r": (fa.flash_attention_dq, "ring_launches"),
            "K3r": (fa.flash_attention_dkv, "ring_launches"),
            "K1": (fa.flash_attention, "launches"),
            "K2": (fa.flash_attention_dq, "launches"),
            "K3": (fa.flash_attention_dkv, "launches")}


def _sp_kernel_ms(q, k, v, dout, lse, delta, me, n, mode):
    """This rank's kernel time of one forward and backward, by CUDA events
    while the other ranks wait at a barrier: the ring's n steps of K1r, K2r
    and K3r, or Ulysses' K1, K2 and K3 on its heads."""
    from paddle_tpu_torch.ops import flash_attention as fa

    if mode == "ring":
        sl = q.shape[1] // n
        mine = slice(me * sl, (me + 1) * sl)
        qs, ds = q[:, mine].contiguous(), dout[:, mine].contiguous()
        ls, dl = lse[..., mine].contiguous(), delta[..., mine].contiguous()
        fwd, bwd = [], []
        for step in range(n):
            src = (me - step) % n
            theirs = slice(src * sl, (src + 1) * sl)
            ks, vs = k[:, theirs].contiguous(), v[:, theirs].contiguous()
            kw = dict(is_causal=True, offsets=(me * sl, src * sl))
            fwd.append(time_ms(lambda: fa.flash_attention(
                qs, ks, vs, return_lse=True, keep_neg_inf_lse=True, **kw),
                10, 2))
            bwd.append(time_ms(lambda: fa.flash_attention_dq(
                qs, ks, vs, ds, ls, dl, **kw), 10, 2)
                + time_ms(lambda: fa.flash_attention_dkv(
                    qs, ks, vs, ds, ls, dl, **kw), 10, 2))
        return dict(forward_ms=sum(fwd), backward_ms=sum(bwd),
                    forward_by_step=fwd, backward_by_step=bwd)
    hl = q.shape[2] // n
    heads = slice(me * hl, (me + 1) * hl)
    qh, kh, vh, dh = (x[:, :, heads].contiguous() for x in (q, k, v, dout))
    lh, dlh = lse[:, heads].contiguous(), delta[:, heads].contiguous()
    fwd = time_ms(lambda: fa.flash_attention(qh, kh, vh, is_causal=True,
                                             return_lse=True), 10, 2)
    bwd = (time_ms(lambda: fa.flash_attention_dq(
        qh, kh, vh, dh, lh, dlh, is_causal=True), 10, 2)
        + time_ms(lambda: fa.flash_attention_dkv(
            qh, kh, vh, dh, lh, dlh, is_causal=True), 10, 2))
    return dict(forward_ms=fwd, backward_ms=bwd)


def sp_inputs(dev, seq, dtype, seed):
    """q, k, v and dout of the ring / Ulysses runs, (1, seq) at RING_ATTN's
    heads, drawn on the card from the seed: the same values in the parent
    and in every rank."""
    gen = torch.Generator(device=dev).manual_seed(seed + 21)
    return tuple(torch.randn(1, seq, *RING_ATTN[2:], generator=gen,
                             device=dev).to(dtype) for _ in range(4))


def single_call(q, k, v, dout):
    """One causal call over the whole sequence through the single-call K1 /
    K2 / K3: ({out, dq, dk, dv}, lse, delta)."""
    from paddle_tpu_torch.ops import flash_attention as fa

    out, lse = fa.flash_attention(q, k, v, is_causal=True, return_lse=True)
    delta = fa.attention_delta(out, dout)
    res = dict(out=out, dq=fa.flash_attention_dq(q, k, v, dout, lse, delta,
                                                 is_causal=True))
    res["dk"], res["dv"] = fa.flash_attention_dkv(q, k, v, dout, lse, delta,
                                                  is_causal=True)
    return res, lse, delta


def shard_stats(got, ref, n):
    """(max |got - ref|, max |ref|, sum (got - ref)^2, sum ref^2) over each
    of n equal parts of the sequence axis (1) of (b, s, h, d) tensors:
    (4, n) fp64."""
    def parts(x):
        return (x.detach().double().unflatten(1, (n, -1)).transpose(0, 1)
                .reshape(n, -1))

    r = parts(ref)
    e = parts(got) - r
    return torch.stack((e.abs().amax(1), r.abs().amax(1),
                        e.square().sum(1), r.square().sum(1)))


def shard_errors(stats):
    """[(max error / max|ref|, L2 error / L2 of ref)], one a part of
    `shard_stats`."""
    me, mr, se, sr = stats.tolist()
    return [(a / b, (c / d) ** 0.5) for a, b, c, d in zip(me, mr, se, sr)]


def within(errs, tol):
    """Whether every (max, L2) pair of `errs` lies under `tol` (NaN
    does not)."""
    return all(m <= tol[0] and l2 <= tol[1] for m, l2 in errs)


def phase_sp_single_call(seed, dev):
    """The bf16 ring and Ulysses runs are held against the single-call K1 /
    K2 / K3 over the whole RING_GLOBAL; hold those first against their
    plain versions on the same values, one head at a time (1 GiB of fp32
    logits a head), each rank's part of the sequence on its own under
    SP_SINGLE_TOL. Returns {name: [(max, L2) a rank]}."""
    from paddle_tpu_torch.ops import flash_attention as fa

    n = RING_RANKS
    q, k, v, dout = sp_inputs(dev, RING_GLOBAL, torch.bfloat16, seed)
    got, lse, delta = single_call(q, k, v, dout)
    stats = {}
    for h in range(q.shape[2]):
        hs = slice(h, h + 1)
        qh, kh, vh, dh = (x[:, :, hs] for x in (q, k, v, dout))
        ref = {"out": fa.flash_attention_reference(
            qh.float(), kh.float(), vh.float(), None, True)}
        ref["dq"], ref["dk"], ref["dv"] = (
            fa.flash_attention_backward_reference(
                qh, kh, vh, dh, lse[:, hs], delta[:, hs], None, True))
        for name, r in ref.items():
            st = shard_stats(got[name][:, :, hs], r, n)
            if name in stats:
                old = stats[name]
                st = torch.cat((torch.maximum(old[:2], st[:2]),
                                old[2:] + st[2:]))
            stats[name] = st
        del ref
    errs = {name: shard_errors(st) for name, st in stats.items()}
    log(f"[sp_single_call] single-call K1 / K2 / K3 over {RING_GLOBAL}, "
        f"{RING_ATTN[2]} heads of {RING_ATTN[3]}, bf16, causal, against the "
        f"plain versions a head at a time; (max error / max|ref|, L2 error "
        f"/ L2 of ref) on each of {n} ranks' parts: " + "; ".join(
            f"{name} " + ", ".join(f"({m:.3g}, {l2:.3g})" for m, l2 in e)
            + f" (limit {SP_SINGLE_TOL[name]})" for name, e in errs.items()))
    bad = {name: e for name, e in errs.items()
           if not within(e, SP_SINGLE_TOL[name])}
    if bad:
        raise AssertionError(f"single-call kernels over {RING_GLOBAL} "
                             f"beyond SP_SINGLE_TOL: {bad}")
    return errs


def _sp_rank(g, dev, seq, dtype, seed):
    """One rank of the ring and Ulysses runs: both at causal attention over
    a global sequence `seq` split over the group, forward and backward,
    this rank's output and dQ / dK / dV shard held under SP_TOL against one
    call over the whole sequence on the same card (the single-call kernels
    in bf16, the plain versions in fp32), the launches of the run counted;
    the bf16 run's kernels timed one rank at a time."""
    from paddle_tpu_torch import distributed as ptd
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        ring_attention as ra)
    from paddle_tpu_torch.ops import flash_attention as fa

    n, me = g.nranks, g.rank
    sl = seq // n
    mine = slice(me * sl, (me + 1) * sl)
    q, k, v, dout = sp_inputs(dev, seq, dtype, seed)
    if dtype == torch.bfloat16:
        ref, lse, delta = single_call(q, k, v, dout)
    else:
        ref_out, lse = fa.flash_attention_reference(q, k, v, None, True,
                                                    True)
        delta = fa.attention_delta(ref_out, dout)
        ref = dict(out=ref_out)
        ref["dq"], ref["dk"], ref["dv"] = (
            fa.flash_attention_backward_reference(q, k, v, dout, lse, delta,
                                                  None, True))
    tol = SP_TOL[dtype]
    counters = _ring_counters()
    out = {}
    for mode, fn in (("ring", ra.ring_flash_attention),
                     ("ulysses", ra.ulysses_attention)):
        qs, ks, vs = (x[:, mine].transpose(1, 2).detach().clone()
                      .requires_grad_() for x in (q, k, v))
        staged0 = g.staged_bytes
        ptd.barrier(g)
        zero_counters(counters)
        t0 = time.perf_counter()
        o = fn(qs, ks, vs, group=g, causal=True)
        o.backward(dout[:, mine].transpose(1, 2))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counters(counters)
        got = dict(out=o.detach().transpose(1, 2), dq=qs.grad.transpose(1, 2),
                   dk=ks.grad.transpose(1, 2), dv=vs.grad.transpose(1, 2))
        errs = {n_: shard_errors(shard_stats(t, ref[n_][:, mine], 1))[0]
                for n_, t in got.items()}
        bad = {n_: e for n_, e in errs.items() if not within([e], tol)}
        if bad:
            raise AssertionError(f"{mode} rank {me} {str(dtype)[6:]} seq "
                                 f"{seq}: (max error / max|ref|, L2 error / "
                                 f"L2 of ref) of the rank's part beyond "
                                 f"{tol}: {bad}")
        want = ({"K1r": n, "K2r": n, "K3r": n, "K1": 0, "K2": 0, "K3": 0}
                if mode == "ring" else
                {"K1r": 0, "K2r": 0, "K3r": 0, "K1": 1, "K2": 1, "K3": 1})
        if launches != want:
            raise AssertionError(f"{mode} rank {me}: launches {launches}, "
                                 f"expected {want}")
        out[mode] = dict(errors=errs, tol=tol, launches=launches,
                         wall_s=wall, staged_bytes=g.staged_bytes - staged0)
        del qs, ks, vs, o, got
    if dtype == torch.bfloat16:
        for r in range(n):
            ptd.barrier(g)
            if r == me:
                for mode in out:
                    out[mode]["kernel_ms"] = _sp_kernel_ms(
                        q, k, v, dout, lse, delta, me, n, mode)
        ptd.barrier(g)
    return out


def _moe_ep_rank(g, dev, seed):
    """One rank of the expert-parallel MoE runs: at MOE_EP_CF, where
    nothing drops, the forward rows, aux loss and every gradient against
    the single-rank layer run over every rank's tokens on the same card
    (GELU experts, fp32); then 3 + 10 O1 train steps at the gate's own
    capacity factor (ReLU experts, Switch's FFN)."""
    import copy

    from paddle_tpu_torch.ops import moe_dispatch as md
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.training import make_moe_train_step

    warmup, steps = 3, 10
    n, me = g.nranks, g.rank
    x, target = moe_batch(seed, dev)
    flat = x.reshape(-1, MOE_D)
    per = flat.shape[0] // n
    rows = [slice(r * per, (r + 1) * per) for r in range(n)]
    gen = torch.Generator(device=dev).manual_seed(seed + 31)
    ct = torch.randn(flat.shape, generator=gen, device=dev)

    layer = moe_layer("gshard", dev, seed, act=torch.nn.GELU)
    layer.capacity_factor = MOE_EP_CF
    ref = copy.deepcopy(layer)
    _, tok_slot, cap = layer.dispatch_indices(flat[rows[me]])
    dropped = float((tok_slot < 0).float().mean())
    if dropped != 0:
        raise AssertionError(f"moe_ep rank {me}: {dropped} of the pairs "
                             f"dropped at capacity factor {MOE_EP_CF}")
    staged0 = g.staged_bytes
    y = layer.expert_parallel_forward(x, g)
    ((y * ct[rows[me]]).sum() + layer.aux_loss).backward()
    staged = g.staged_bytes - staged0
    ys, auxs = zip(*(ref._routed_forward(flat[r], ref.gate.gate_weight,
                                         ref._run_experts) for r in rows))
    ref_aux = torch.stack(auxs).mean()
    (sum((yr * ct[r]).sum() for yr, r in zip(ys, rows)) + ref_aux).backward()
    aux, ref_aux = float(layer.aux_loss.detach()), float(ref_aux.detach())
    errs = {"y": (max_err(y, ys[me]), float(ys[me].detach().abs().max())),
            "aux": (abs(aux - ref_aux), abs(ref_aux))}
    ref_params = dict(ref.named_parameters())
    local = MOE_E // n
    own = {"gate.gate_weight"} | {
        name for name, _ in layer.named_parameters()
        if name.startswith("experts.")
        and me * local <= int(name.split(".")[1]) < (me + 1) * local}
    with_grad = {name for name, p in layer.named_parameters()
                 if p.grad is not None}
    if with_grad != own:
        raise AssertionError(f"moe_ep rank {me}: gradients on "
                             f"{sorted(with_grad ^ own)} differ from the "
                             "rank's own parameters")
    for name in sorted(own):
        p, pr = dict(layer.named_parameters())[name], ref_params[name]
        errs[name] = (max_err(p.grad, pr.grad), float(pr.grad.abs().max()))
    bad = {k_: e for k_, e in errs.items()
           if not e[0] <= MOE_EP_RTOL * e[1]}
    if bad:
        raise AssertionError(f"moe_ep rank {me}: beyond {MOE_EP_RTOL} x "
                             f"max|single-rank| (error, max): {bad}")
    worst = max(errs, key=lambda k_: errs[k_][0] / max(errs[k_][1], 1e-30))
    check = dict(capacity=cap, capacity_factor=MOE_EP_CF, dropped_share=0.0,
                 staged_bytes=staged,
                 worst=(worst, errs[worst][0] / max(errs[worst][1], 1e-30)))
    del layer, ref, ys, auxs, y

    layer = moe_layer("gshard", dev, seed)
    params = [layer.gate.gate_weight] + [
        p for e in layer.experts[me * local:(me + 1) * local]
        for p in e.parameters()]
    step = make_moe_train_step(layer, Adam(learning_rate=1e-4,
                                           parameters=params), group=g)
    losses = [step(x, target) for _ in range(warmup)]
    counters = {"K9": (md.gather_rows, "launches")}
    zero_counters(counters)
    staged0 = g.staged_bytes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step(x, target) for _ in range(steps)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters(counters)
    loss_vals = [float(v) for v in losses]
    if not all(np.isfinite(loss_vals)):
        raise AssertionError(f"moe_ep rank {me}: non-finite loss "
                             f"{loss_vals}")
    if launches["K9"] != MOE_LAUNCHES["K9"] * steps:
        raise AssertionError(f"moe_ep rank {me}: K9 launched "
                             f"{launches['K9']} times in {steps} steps")
    _, tok_slot, cap_train = layer.dispatch_indices(flat[rows[me]])
    return dict(check=check, train=dict(
        capacity_factor=layer.capacity_factor, capacity=cap_train,
        dropped_share=float((tok_slot < 0).float().mean()),
        step_ms=wall / steps * 1e3, losses=loss_vals, launches=launches,
        staged_bytes_per_step=(g.staged_bytes - staged0) / steps))


def world_rank(seed):
    """The body of each rank of the multi-rank phases (run by
    `distributed.spawn`): the ring and Ulysses runs of SP_RUNS, then the
    expert-parallel MoE runs. Returns this rank's results."""
    from paddle_tpu_torch import distributed as ptd

    g = ptd.get_group()
    dev = g.device
    out = {"backend": g.backend, "device": str(dev), "sp": {}}
    for seq, dtype in SP_RUNS:
        out["sp"][f"{seq} {str(dtype)[6:]}"] = _sp_rank(g, dev, seq, dtype,
                                                        seed)
        gc.collect()
        torch.cuda.empty_cache()
    out["moe_ep"] = _moe_ep_rank(g, dev, seed)
    return out


def phase_multi_rank(seed, dev):
    """The ring, ulysses and moe_ep phases: first the single-call kernels
    the bf16 runs are held against, checked here against their plain
    versions; then one world of RING_RANKS processes
    (`distributed.spawn`; every kernel was built by phase_build, so no rank
    runs nvcc). On a machine with fewer cards than ranks the ranks share
    them over gloo, time-sliced: their wall times are no speed figure,
    their kernel times by CUDA events (taken one rank at a time) are. Any
    rank's failure raises here."""
    from paddle_tpu_torch import distributed as ptd

    out = {"single_call": phase_sp_single_call(seed, dev)}
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    n_ranks = RING_RANKS
    ranks = ptd.spawn(world_rank, (seed,), nprocs=n_ranks, timeout=900)
    wall = time.perf_counter() - t0
    backend = ranks[0]["backend"]
    # wall times are a speed figure only with a card a rank
    shared = ("(ranks share the card)"
              if len({r["device"] for r in ranks}) < n_ranks
              else "(a card a rank)")
    log(f"[multi_rank] {n_ranks} ranks on {[r['device'] for r in ranks]} "
        f"over {backend} in {wall:.1f} s (spawn, kernels and checks)")
    out.update(backend=backend, wall_s=wall, ranks=n_ranks)
    for key in ranks[0]["sp"]:
        for mode in ("ring", "ulysses"):
            per = [r["sp"][key][mode] for r in ranks]
            errs = "; ".join(f"{n_} " + ", ".join(
                f"({p['errors'][n_][0]:.3g}, {p['errors'][n_][1]:.3g})"
                for p in per) for n_ in per[0]["errors"])
            log(f"[{mode}] global {key}, {RING_ATTN[2]} heads of "
                f"{RING_ATTN[3]}, causal, over {n_ranks} ranks: (max error "
                f"/ max|ref|, L2 error / L2 of ref) on ranks 0-{n_ranks - 1}"
                f": {errs} (limit {per[0]['tol']}); launches a rank "
                f"{per[0]['launches']}; transport {backend}, staged "
                f"{per[0]['staged_bytes'] / 2**20:.1f} MiB a rank; wall a "
                f"rank {[round(p['wall_s'] * 1e3, 1) for p in per]} ms "
                f"{shared}")
            if "kernel_ms" in per[0]:
                log(f"[{mode}] kernel ms a rank (CUDA events, one rank at a "
                    "time): " + "; ".join(
                        f"rank {i} fwd {p['kernel_ms']['forward_ms']:.3f} "
                        f"bwd {p['kernel_ms']['backward_ms']:.3f}"
                        for i, p in enumerate(per)))
            out[f"{mode} {key}"] = dict(per_rank=per)
    per = [r["moe_ep"] for r in ranks]
    c = per[0]["check"]
    tokens = MOE_B * MOE_S
    log(f"[moe_ep] Switch-Base-8 widths, GShard top-2, {MOE_E} experts over "
        f"{n_ranks} ranks ({MOE_E // n_ranks} a rank), {tokens} tokens "
        f"({tokens // n_ranks} a rank): at capacity factor "
        f"{c['capacity_factor']} (C = {c['capacity']}) nothing dropped; "
        f"rows, aux and every gradient within {MOE_EP_RTOL} x max|single-"
        f"rank| on every rank, worst {[p['check']['worst'] for p in per]}")
    t = [p["train"] for p in per]
    log(f"[moe_ep] O1 train steps at capacity factor "
        f"{t[0]['capacity_factor']} (C = {t[0]['capacity']}): step ms a "
        f"rank {[round(x['step_ms'], 2) for x in t]} {shared}; "
        f"dropped share {[round(x['dropped_share'], 5) for x in t]}; "
        f"transport {backend}, staged {t[0]['staged_bytes_per_step'] / 2**20:.1f}"
        f" MiB a step a rank; K9 launches {t[0]['launches']}; loss rank 0 "
        + ", ".join(f"{v:.5f}" for v in t[0]["losses"]))
    out["moe_ep"] = per
    return out


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


def load_llama7b(seed, dev):
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.llama7b()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16, seed=seed)
    torch.cuda.synchronize()
    for p in model.parameters():
        p.requires_grad_(False)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[slice] LLaMA-7B ({cfg.num_hidden_layers} layers, hidden "
        f"{cfg.hidden_size}, {n_params / 1e9:.3f} B params, bf16) drawn on "
        f"the card in {time.perf_counter() - t0:.1f} s")
    return model


def serve_counters():
    """The serving path's launch counters: (name, read, reset)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import norm
    from paddle_tpu_torch.serving import attention as att

    dec, rag = att.paged_decode_attention, att.ragged_paged_attention
    return {"K1": (fa.flash_attention, "launches"),
            "K4": (norm.norm_forward, "launches"),
            "K6": (dec, "launches"), "K6q": (dec, "quant_launches"),
            "K7": (rag, "launches"), "K7q": (rag, "quant_launches")}


def zero_counters(counters):
    for fn, attr in counters.values():
        setattr(fn, attr, 0)


def read_counters(counters):
    return {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}


def rescore(model, engine, prompts, rids, tol, dev, tag):
    """Re-score the longest and the shortest request with the no-cache
    forward: wherever its top-2 logit margin exceeds `tol`, the engine's
    greedy token must be its argmax. Returns (positions checked, positions
    that differ, the largest margin among those)."""
    checked = mismatched = total = 0
    worst = 0.0
    margins = []
    lens = [len(p) for p in prompts]
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
        margins.extend(margin.tolist())
        for j, tok in enumerate(seq[n:]):
            total += 1
            checked += bool(margin[j] > tol)
            if int(argmax[j]) != tok:
                mismatched += 1
                worst = max(worst, float(margin[j]))
                if margin[j] > tol:
                    raise AssertionError(
                        f"{tag}: request {rids[i]} position {n + j}: engine "
                        f"token {tok} != no-cache argmax {int(argmax[j])} "
                        f"with margin {margin[j]:.3f} > {tol}")
    log(f"[{tag}] greedy check: {checked} of {total} generated positions had "
        f"a top-2 margin > {tol} and all matched the no-cache argmax; "
        f"{mismatched} positions differ, the largest margin among them "
        f"{worst:.4f}; largest margins "
        f"{[round(x, 4) for x in sorted(margins)[-5:]]}")
    if checked == 0:
        raise AssertionError(f"{tag}: greedy check compared no position")
    return checked, mismatched, worst


def serve_engine(model, dev, **kw):
    """The serve cells' engine (page_size 16, 8 rows, max_seq_len 1024,
    decode horizon 8) with the run's own knobs."""
    from paddle_tpu_torch.serving import ServingEngine

    return ServingEngine(model, page_size=16, max_batch_size=8,
                         max_seq_len=1024, decode_horizon=8, device=dev,
                         **kw)


def phase_slice(model, seed, dev, profile=False, out_dir=None):
    cfg = model.llama.config
    engine = serve_engine(model, dev, kv_dtype="bf16")
    rng = np.random.RandomState(seed)
    # warm-up (Triton specializations, cuBLAS handles): not measured
    serve(engine, [rng.randint(0, cfg.vocab_size, (n,)) for n in (40, 200)],
          1, 9)
    lens = rng.randint(32, 513, 8)
    prompts = [rng.randint(0, cfg.vocab_size, (int(n),)) for n in lens]
    counters = serve_counters()
    engine = serve_engine(model, dev, kv_dtype="bf16")
    torch.cuda.reset_peak_memory_stats()
    zero_counters(counters)
    rids, wall = serve(engine, prompts, 2, 32)
    launches = {k: n for k, n in read_counters(counters).items()
                if k in ("K1", "K4", "K6")}
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
    checked, _, _ = rescore(model, engine, prompts, rids, MARGIN_TOL["bf16"],
                            dev, "slice")
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


def chunked_engine(model, dev, kv, ragged=True):
    return serve_engine(model, dev, enable_chunked_prefill=True,
                        prefill_chunk_tokens=256, enable_ragged_step=ragged,
                        kv_dtype=kv)


def phase_serve_chunked(model, seed, dev, kv, n_requests=8, ragged=True,
                        profile=False, out_dir=None):
    """The chunked serve: `n_requests` greedy requests with prompts drawn
    from 64..960 tokens (2-4 chunks of 256 for most), 32 new tokens each,
    the last two arriving after two steps, on a fresh engine after an
    unmeasured warm-up. Checks the launch counts of the path (ragged: K7 and
    the decode kernel launch and K1 never does; chained: K1 launches through
    the paged chunk prefill), the no-cache margin check, and prints
    tokens/s, mean TTFT, decode tokens/s, the decode-stall sum, pool bytes
    and peak memory."""
    cfg = model.llama.config
    tag = f"serve_{'chunked' if ragged else 'chained'}_{kv}"
    rng = np.random.RandomState(seed + 1)
    warm = chunked_engine(model, dev, kv, ragged)
    serve(warm, [rng.randint(0, cfg.vocab_size, (n,)) for n in (300, 40)],
          1, 9)
    del warm
    gc.collect()
    lens = rng.randint(64, 961, n_requests)
    prompts = [rng.randint(0, cfg.vocab_size, (int(n),)) for n in lens]
    counters = serve_counters()
    engine = chunked_engine(model, dev, kv, ragged)
    torch.cuda.reset_peak_memory_stats()
    zero_counters(counters)
    rids, wall = serve(engine, prompts, 2 if n_requests > 2 else 0, 32)
    launches = read_counters(counters)
    stats = engine.stats()
    peak = torch.cuda.max_memory_allocated()
    tokens = stats["tokens_generated"]
    ttfts = [stats["requests"][r]["ttft_s"] for r in rids]
    stall = stats["latency"]["decode_stall"]
    log(f"[{tag}] prompts {sorted(int(n) for n in lens)}, 32 new tokens "
        f"each: {stats['num_finished']}/{n_requests} finished, {tokens} "
        f"tokens in {wall:.3f} s = {tokens / wall:.1f} tokens/s; mean TTFT "
        f"{np.mean(ttfts) * 1e3:.1f} ms; decode "
        f"{stats['decode_tokens_per_s']:.1f} tokens/s; decode stall sum "
        f"{stall['sum']:.3f} s over {stall['count']} gaps; "
        f"{stats['prefill_chunks']} chunks, {stats['ragged_steps']} ragged "
        f"steps, {stats['decode_steps']} decode dispatches; pool "
        f"{engine.cache.pool_bytes / 2**30:.3f} GiB ({kv}); peak memory "
        f"{peak / 2**30:.2f} GiB")
    log(f"[{tag}] launches in the served run: {launches}")
    if stats["num_finished"] != n_requests or tokens != n_requests * 32:
        raise AssertionError(f"{tag}: served run incomplete: "
                             f"{stats['num_finished']} finished, {tokens} "
                             "tokens")
    quant = kv in QUANT_KV
    dec = launches["K6q" if quant else "K6"]
    if ragged:
        want = {"K7q" if quant else "K7": launches["K7q" if quant else "K7"],
                "K6q" if quant else "K6": dec, "K4": launches["K4"]}
        if launches["K1"] != 0:
            raise AssertionError(f"{tag}: K1 launched {launches['K1']} "
                                 "times on the ragged path")
    else:
        want = {"K1": launches["K1"], "K6q" if quant else "K6": dec,
                "K4": launches["K4"]}
    missing = [k for k, n in want.items() if n <= 0]
    if missing:
        raise AssertionError(f"{tag}: kernels never launched: {missing}")
    checked, mismatched, worst = rescore(model, engine, prompts, rids,
                                         MARGIN_TOL[kv], dev, tag)
    prof = None
    if profile:
        # two steps of a fresh engine holding all the requests, once the
        # first ones decode beside the later ones' chunks
        engine = chunked_engine(model, dev, kv, ragged)
        for p in prompts:
            engine.add_request(p, max_new_tokens=32)
        for _ in range(4):
            engine.step()
        prof = profile_window(f"{tag}_2_steps",
                              lambda: (engine.step(), engine.step()),
                              out_dir)
    return dict(kv_dtype=kv, ragged=ragged, launches=launches,
                tokens_per_s=tokens / wall, wall_s=wall,
                mean_ttft_s=float(np.mean(ttfts)),
                decode_tokens_per_s=stats["decode_tokens_per_s"],
                decode_stall_sum_s=stall["sum"],
                decode_stall_count=stall["count"],
                pool_bytes=engine.cache.pool_bytes, peak_bytes=peak,
                prefill_chunks=stats["prefill_chunks"],
                ragged_steps=stats["ragged_steps"],
                margin_checked=checked, margin_mismatched=mismatched,
                margin_worst=worst, prompt_lens=lens.tolist(), profile=prof)


def prefix_spec_prompts(seed, vocab):
    """(prefix prompts, spec prompts). Prefix: a seeded PREFIX_TOKENS
    system prefix shared by 8 requests, each with its own 32-128-token
    suffix. Spec: a seeded 256-token shared preamble, then a request's own
    40-token passage three times and the start of a fourth (the repeated
    text n-gram drafting feeds on)."""
    rng = np.random.RandomState(seed + 2)
    shared = rng.randint(0, vocab, (PREFIX_TOKENS,)).tolist()
    prefix = [shared + rng.randint(0, vocab, (int(n),)).tolist()
              for n in rng.randint(32, 129, 8)]
    preamble = rng.randint(0, vocab, (256,)).tolist()
    spec = []
    for _ in range(8):
        passage = rng.randint(0, vocab, (40,)).tolist()
        spec.append(preamble + passage * 3 + passage[:5])
    return prefix, spec


def served_run(model, dev, tag, prompts, kw, counters, warmed, tree=()):
    """One measured run of the prefix / speculation serve: the first run of
    a knob set (`warmed` holds those seen) starts with an unmeasured
    warm-up engine of those knobs (two short requests); then a fresh
    engine serves `prompts` greedily, 32 new tokens each, the last two
    arriving after two steps. With `tree`, the fresh engine first serves
    those prompts for one token each, unmeasured, so that they sit in its
    prefix cache. Launch counters are zeroed just before the served run
    and read just after; the readings count the served run's requests
    only. Holds every request finished and the margin check; returns the
    run's readings and streams."""
    knobs = repr(sorted(kw.items()))
    if knobs not in warmed:
        warmed.add(knobs)
        warm = serve_engine(model, dev, **kw)
        serve(warm, [p[:48] for p in prompts[:2]], 1, 9)
        del warm
        gc.collect()
    engine = serve_engine(model, dev, **kw)
    if tree:
        serve(engine, tree, 0, 1)
    pc0 = (engine.prefix_cache.stats() if engine.prefix_cache is not None
           else None)
    prefill0 = engine.stats()["prefill_time_s"], \
        engine.stats()["prefill_steps"]
    pages = engine.cache.allocator
    pages.reset_peak()
    zero_counters(counters)
    rids, wall = serve(engine, prompts, 2, 32)
    launches = read_counters(counters)
    stats = engine.stats()
    reqs = [engine.requests[r] for r in rids]
    tokens = sum(len(r.generated) for r in reqs)
    finished = sum(r.status == "finished" for r in reqs)
    if finished != len(prompts) or tokens != 32 * len(prompts):
        raise AssertionError(f"{tag}: served run incomplete: {finished} "
                             f"finished, {tokens} tokens")
    kv = kw.get("kv_dtype", "bf16")
    checked, mismatched, worst = rescore(model, engine, prompts, rids,
                                         MARGIN_TOL[kv], dev, tag)
    ttfts = [stats["requests"][r]["ttft_s"] for r in rids]
    # the host wall of a whole-prompt (or whole-suffix) prefill dispatch
    # and sync; a chunked engine's chunks ride its flat steps instead
    prefills = stats["prefill_steps"] - prefill0[1]
    prefill_ms = (None if kw.get("enable_chunked_prefill") else
                  (stats["prefill_time_s"] - prefill0[0]) / prefills * 1e3)
    out = dict(tag=tag, launches=launches, wall_s=wall,
               tokens_per_s=tokens / wall, peak_pages=pages.peak_used,
               pool_pages=engine.cache.num_pages - 1,
               mean_ttft_s=float(np.mean(ttfts)),
               late_ttft_s=[float(t) for t in ttfts[-2:]],
               prefill_wall_ms=prefill_ms,
               margin_checked=checked, margin_mismatched=mismatched,
               margin_worst=worst,
               streams=[engine.output(r) for r in rids])
    line = (f"[{tag}] {tokens} tokens in {wall:.3f} s = "
            f"{tokens / wall:.1f} tokens/s; mean TTFT "
            f"{np.mean(ttfts) * 1e3:.1f} ms, the late arrivals' "
            f"{ttfts[-2] * 1e3:.1f} / {ttfts[-1] * 1e3:.1f} ms; "
            + ("" if prefill_ms is None else
               f"host wall a prefill {prefill_ms:.1f} ms over {prefills}; ")
            + f"pool pages at peak {pages.peak_used} of "
            f"{out['pool_pages']}")
    if pc0 is not None:
        pc = engine.prefix_cache.stats()
        hit = pc["hit_tokens"] - pc0["hit_tokens"]
        miss = pc["miss_tokens"] - pc0["miss_tokens"]
        out["prefix_hit_tokens"], out["prefix_miss_tokens"] = hit, miss
        line += f"; prompt tokens from the cache {hit} of {hit + miss}"
    if engine.spec_config is not None:
        sp = {k: sum(getattr(r, f"spec_{k}") for r in reqs)
              for k in ("drafted", "accepted", "target_steps", "emitted")}
        sp["tokens_per_target_step"] = sp["emitted"] / sp["target_steps"]
        out["spec"] = sp
        line += (f"; drafted {sp['drafted']}, accepted {sp['accepted']}, "
                 f"{sp['tokens_per_target_step']:.3f} tokens per target "
                 f"step over {sp['target_steps']} row passes")
    log(line)
    log(f"[{tag}] launches: {launches}")
    del engine
    gc.collect()
    return out


def phase_serve_prefix_spec(model, seed, dev, profile=False, out_dir=None):
    """The prefix cache and speculative decoding served at LLaMA-7B width.
    Prefix part: the shared-prefix requests with the cache off, on, on with
    chunked prefill (chunks of 256) and the ragged step, and on over int8
    pools. Spec part: the repeated-passage requests with SpecConfig(
    lookahead=SPEC_LOOKAHEAD) n-gram drafts off and on, then method
    "combined" with the prefix cache, chunked prefill and the ragged step,
    off and on, on engines whose tree first takes the spec-off run's
    streams (prompt + 32 tokens) as prompts. Each run is held by the
    margin check; the phase counts the streams identical to the run they
    pair with, and fails unless each kernel of the path (K1, K4, K6, K6q,
    K7) launched."""
    from paddle_tpu_torch.serving import SpecConfig

    prefix, spec_prompts = prefix_spec_prompts(seed, model.llama.config
                                               .vocab_size)
    counters = serve_counters()
    chunked = dict(enable_chunked_prefill=True, prefill_chunk_tokens=256)
    ngram = SpecConfig(lookahead=SPEC_LOOKAHEAD)
    combined = SpecConfig(lookahead=SPEC_LOOKAHEAD, method="combined")
    runs = [
        # (tag, prompts, engine knobs, kernels that must launch)
        ("prefix_off", prefix, dict(kv_dtype="bf16"), "K1 K4 K6"),
        ("prefix_on", prefix, dict(kv_dtype="bf16",
                                   enable_prefix_caching=True), "K1 K4 K6"),
        ("prefix_on_ragged", prefix, dict(kv_dtype="bf16",
                                          enable_prefix_caching=True,
                                          **chunked), "K4 K6 K7"),
        ("prefix_on_int8", prefix, dict(kv_dtype="int8",
                                        enable_prefix_caching=True),
         "K1 K4 K6q"),
        ("spec_off", spec_prompts, dict(kv_dtype="bf16"), "K1 K4 K6"),
        ("spec_on", spec_prompts, dict(kv_dtype="bf16", spec_config=ngram),
         "K1 K4"),
        ("combined_off", spec_prompts, dict(kv_dtype="bf16",
                                            enable_prefix_caching=True,
                                            **chunked), "K4 K6 K7"),
        ("combined_on", spec_prompts, dict(kv_dtype="bf16",
                                           enable_prefix_caching=True,
                                           spec_config=combined, **chunked),
         "K1 K4 K7"),
    ]
    out, total = {}, dict.fromkeys(("K1", "K4", "K6", "K6q", "K7", "K7q"),
                                   0)
    warmed = set()
    for tag, prompts, kw, need in runs:
        # the combined runs' engines first serve the spec-off run's whole
        # streams as prompts: their tree then holds a served continuation
        # of every prompt, what the radix drafts are for
        tree = out["spec_off"]["streams"] if tag.startswith("combined") \
            else ()
        r = served_run(model, dev, f"serve_{tag}", prompts, kw, counters,
                       warmed, tree)
        missing = [k for k in need.split() if r["launches"][k] <= 0]
        if missing:
            raise AssertionError(f"serve_{tag}: kernels never launched: "
                                 f"{missing}")
        for k in total:
            total[k] += r["launches"][k]
        out[tag] = r
    hits = out["prefix_on"]["prefix_hit_tokens"]
    if hits < (len(prefix) - 1) * PREFIX_TOKENS:
        raise AssertionError(f"serve_prefix_on: {hits} prompt tokens from "
                             "the cache, expected the shared prefix of "
                             "every request after the first")
    for on, off in (("prefix_on", "prefix_off"),
                    ("prefix_on_ragged", "prefix_off"),
                    ("spec_on", "spec_off"),
                    ("combined_on", "combined_off")):
        same = sum(a == b for a, b in zip(out[on]["streams"],
                                          out[off]["streams"]))
        out[on]["identical_to"] = {off: same}
        log(f"[serve_prefix_spec] {on}: {same} of {len(prefix)} streams "
            f"identical to {off}")
    for r in out.values():
        del r["streams"]
    missing = [k for k, n in total.items() if n <= 0 and k != "K7q"]
    if missing:
        raise AssertionError(f"serve_prefix_spec: kernels never launched: "
                             f"{missing}")
    log(f"[serve_prefix_spec] launches over the 8 runs: {total}")
    out["launches"] = total
    if profile:
        # two steps of a speculative engine holding all eight requests,
        # once every one decodes: each step drains the last block and
        # dispatches the next
        engine = serve_engine(model, dev, kv_dtype="bf16", spec_config=ngram)
        for p in spec_prompts:
            engine.add_request(p, max_new_tokens=32)
        for _ in range(len(spec_prompts) + 1):
            engine.step()
        out["profile"] = profile_window(
            "spec_2_blocks", lambda: (engine.step(), engine.step()), out_dir)
    return out


def phase_spec_fp32(seed, dev):
    """Speculation on the card without bf16's near-ties: LLaMA-7B's widths
    cut to 2 layers, fp32 weights from the seed and fp32 pools. The
    repeated-passage requests are served with speculation off, then with
    method "combined" and the prefix cache, unchunked and chunked with the
    ragged step, on engines whose tree first takes the spec-off streams as
    prompts (so the radix drafts propose the spec-off continuation). Each
    run is held by the margin check at MARGIN_TOL["fp32"]; prints the
    streams identical to spec-off (counted, not required) and the drafts
    accepted."""
    import dataclasses

    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import SpecConfig

    cfg = dataclasses.replace(LlamaConfig.llama7b(), num_hidden_layers=2)
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32,
                             seed=seed)
    for p in model.parameters():
        p.requires_grad_(False)
    _, prompts = prefix_spec_prompts(seed, cfg.vocab_size)
    counters = serve_counters()
    combined = dict(kv_dtype="fp32", enable_prefix_caching=True,
                    spec_config=SpecConfig(lookahead=SPEC_LOOKAHEAD,
                                           method="combined"))
    warmed = set()
    out = {"off": served_run(model, dev, "spec_fp32_off", prompts,
                             dict(kv_dtype="fp32"), counters, warmed)}
    tree = out["off"]["streams"]
    for tag, kw, need in (
            ("on", combined, "K1 K4"),
            ("on_ragged", dict(combined, enable_chunked_prefill=True,
                               prefill_chunk_tokens=256), "K1 K4 K7")):
        r = served_run(model, dev, f"spec_fp32_{tag}", prompts, kw,
                       counters, warmed, tree)
        missing = [k for k in need.split() if r["launches"][k] <= 0]
        if missing:
            raise AssertionError(f"spec_fp32_{tag}: kernels never "
                                 f"launched: {missing}")
        same = sum(a == b for a, b in zip(r["streams"], tree))
        r["identical_to_off"] = same
        log(f"[spec_fp32] {tag}: {same} of {len(prompts)} streams "
            "identical to spec-off")
        out[tag] = r
    for r in out.values():
        del r["streams"]
    del model
    return out


RECOVERY_NEW = 32
# the serve_recovery requests sampled stochastically (index: seed 100 + i)
RECOVERY_SEEDED = (1, 5)


def recovery_prompts(seed, vocab):
    """Eight prompts of 32-512 tokens and each one's sampling knobs: greedy,
    but for RECOVERY_SEEDED, which sample at temperature 0.8 from their own
    seed."""
    rng = np.random.RandomState(seed + 3)
    prompts = [rng.randint(0, vocab, (int(n),)).tolist()
               for n in rng.randint(32, 513, 8)]
    knobs = [dict(temperature=0.8, top_k=40, top_p=0.95, seed=100 + i)
             if i in RECOVERY_SEEDED else {} for i in range(8)]
    return prompts, knobs


def recovery_run(model, dev, prompts, knobs, kw, fi=None, journal=None,
                 counters=None, then=None):
    """Serve `prompts` (all added up front, RECOVERY_NEW tokens each)
    through an EngineSupervisor whose factory builds `serve_engine(model,
    dev, fault_injector=fi, **kw)`, or through one bare engine when
    `journal` is None. Drives the supervisor step by step as its stream()
    does, timing the first token after each restart; with `counters`,
    zeroes them at the first restart and reads them at the end (the
    restored path's launches). A supervised run ends with the journal's
    and the scheduler's audits, then `then(supervisor)` if given. Returns
    the readings, the streamed tokens, each request's final state and, per
    step, the state the kill points are chosen from; no engine outlives
    the call, so each run's peak memory is its own."""
    from paddle_tpu_torch.serving import EngineSupervisor

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if journal is None:
        sup = None
        eng = serve_engine(model, dev, fault_injector=fi, **kw)
    else:
        sup = EngineSupervisor(
            lambda: serve_engine(model, dev, fault_injector=fi, **kw),
            journal=journal)
    front = sup if sup is not None else eng
    rids = [front.add_request(p, max_new_tokens=RECOVERY_NEW, **k)
            for p, k in zip(prompts, knobs)]
    streamed = {r: [] for r in rids}
    # per restart: seconds from its end to the next token, None when the
    # next restart came first
    trace, first_after, restart_end = [], [], None
    while True:
        eng = sup.engine if sup is not None else eng
        live = [eng.requests[r] for r in rids if r in eng.requests]
        trace.append(dict(
            all_first=all(streamed[r] for r in rids),
            mid_prefill=any(0 < q.num_computed_tokens < len(q.prompt)
                            and q.status == "running" for q in live)))
        if eng.scheduler.has_work():
            events = front.step()
        elif eng._pending is not None or eng._spill:
            events = eng.drain_all()
        else:
            break
        now = time.perf_counter()
        if sup is not None and len(sup.restarts) > len(first_after):
            first_after.append(None)
            restart_end = now
            if counters is not None and len(first_after) == 1:
                zero_counters(counters)
        elif restart_end is not None and events:
            first_after[-1] = now - restart_end
            restart_end = None
        for rid, tok in events:
            streamed[rid].append(tok)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = dict(wall_s=wall, peak_bytes=torch.cuda.max_memory_allocated(),
               trace=trace, rids=rids, streamed=streamed,
               first_token_after_restart_s=first_after)
    if counters is not None:
        out["launches"] = read_counters(counters)
    eng = sup.engine if sup is not None else eng
    # a request that ended before the last restart lives only in the
    # journal: its draw index is the one its record replays
    out.update(outputs=[front.output(r) for r in rids],
               status=[front.status(r) for r in rids],
               draws=[eng._draws[r] if r in eng.requests else
                      sup.journal.record(r).key_splits
                      + len(sup.journal.record(r).delivered) for r in rids],
               retries=eng.stats()["transient_retries"],
               restarts=list(sup.restarts) if sup is not None else [])
    tokens = sum(len(o) - len(p) for o, p in zip(out["outputs"], prompts))
    out["tokens_per_s"] = tokens / wall
    if sup is not None:
        sup.journal.check_consistency()
        eng.scheduler.check_consistency()
    if then is not None:
        out["then"] = then(front)
    return out


class _Outputs:
    """`output(rid)` over a finished run's streams, for `rescore`."""

    def __init__(self, run):
        self._out = dict(zip(run["rids"], run["outputs"]))

    def output(self, rid):
        return self._out[rid]


def hold_recovered(tag, run, ref, prompts, knobs, restarts, model, dev,
                   tol, identical):
    """The checks of a killed run against its uninterrupted `ref`: exactly
    `restarts` restarts, all fatal_fault; every request finished and its
    streamed tokens after the prompt equal to its output (exactly once);
    the journal's and the scheduler's audits; the greedy streams held by
    the margin check, or, with `identical`, every stream equal to the
    reference's; the seeded rows' draw indices equal to the reference's."""
    reasons = [r["reason"] for r in run["restarts"]]
    if reasons != ["fatal_fault"] * restarts:
        raise AssertionError(f"{tag}: restarts {reasons}, expected "
                             f"{restarts} x fatal_fault")
    for i, rid in enumerate(run["rids"]):
        if run["status"][i][0] != "finished":
            raise AssertionError(f"{tag}: request {rid} ended "
                                 f"{run['status'][i]}")
        if list(prompts[i]) + run["streamed"][rid] != run["outputs"][i]:
            raise AssertionError(f"{tag}: request {rid}: the streamed tokens "
                                 "are not its output exactly once")
    same = sum(a == b for a, b in zip(run["outputs"], ref["outputs"]))
    if identical and same != len(prompts):
        raise AssertionError(f"{tag}: {same} of {len(prompts)} streams "
                             "identical to the uninterrupted run")
    greedy = [i for i, k in enumerate(knobs) if not k]
    checked = None
    if not identical:
        checked, _, _ = rescore(model, _Outputs(run),
                                [prompts[i] for i in greedy],
                                [run["rids"][i] for i in greedy], tol, dev,
                                tag)
    for i in RECOVERY_SEEDED:
        if run["draws"][i] != ref["draws"][i]:
            raise AssertionError(
                f"{tag}: seeded request {run['rids'][i]} ends at draw "
                f"{run['draws'][i]}, the uninterrupted run at "
                f"{ref['draws'][i]}")
    info = run["restarts"]
    first = run["first_token_after_restart_s"]
    ms = {k: [round(r[k] * 1e3, 3) for r in info] for k in (
        "t_recover_s", "t_salvage_s", "t_snapshot_s", "t_factory_s",
        "t_restore_s")}
    log(f"[{tag}] {len(info)} restarts, {same} of {len(prompts)} streams "
        f"identical to the uninterrupted run; time to recover (ms) "
        f"{ms['t_recover_s']}: salvage {ms['t_salvage_s']}, snapshot "
        f"{ms['t_snapshot_s']}, factory {ms['t_factory_s']}, restore "
        f"{ms['t_restore_s']}; restart to the first token after it (ms) "
        f"{[t if t is None else round(t * 1e3, 3) for t in first]};"
        f" replayed tokens {[r['replayed_tokens'] for r in info]}; peak "
        f"memory {run['peak_bytes'] / 2**30:.3f} GiB (uninterrupted "
        f"{ref['peak_bytes'] / 2**30:.3f}); wall {run['wall_s']:.3f} s, "
        f"{run['tokens_per_s']:.1f} tokens/s (uninterrupted "
        f"{ref['tokens_per_s']:.1f})")
    return dict(restarts=[{k: r[k] for k in (
        "reason", "t_recover_s", "t_salvage_s", "t_snapshot_s",
        "t_factory_s", "t_restore_s", "readmitted", "replayed_tokens")}
        for r in info], identical=same, margin_checked=checked,
        first_token_after_restart_s=run["first_token_after_restart_s"],
        peak_bytes=run["peak_bytes"], wall_s=run["wall_s"],
        tokens_per_s=run["tokens_per_s"], launches=run.get("launches"))


def kill_point(trace, chunked):
    """The step a first kill lands on: unchunked, the first step after every
    request has its first token; chunked, the first step taken while a
    request is part-way through its chunked prefill."""
    for k, s in enumerate(trace):
        if (s["mid_prefill"] if chunked else s["all_first"]):
            return k
    raise AssertionError("no step fits the kill point")


def phase_serve_recovery(model, seed, dev):
    """The resilience and recovery layer at LLaMA-7B width: the Serve
    engine's knobs, 8 requests of 32-512 prompt tokens and RECOVERY_NEW new
    tokens (two seeded-stochastic), all added up front and driven through
    an EngineSupervisor with a file-backed RequestJournal, every engine
    factory closing over the one model and one FaultInjector.

    1. uninterrupted: supervised + journal (A) and a bare engine (B), in
       the order A B B A; the streams must agree, tokens/s of each;
    2. kill: device_lost at the first step after every request has its
       first token and again 3 steps later; held by hold_recovered with the
       margin check; prints the time to recover and its parts, the first
       token after each restart, the replayed tokens and peak memory;
    3. kill, chunked: the same with chunked prefill (256) and the ragged
       step, killed part-way through a chunked prefill (K7 re-prefills);
    4. faults survived: a transient dispatch fault every 5th dispatch (the
       streams bit-identical to run 1, retries > 0); a persistent fault on
       the third prefill (exactly that request failed with its error, the
       other 7 bit-identical to run 1); a persistent drain fault on the
       second decode drain (its rows failed, the pool audited clean after
       the in-flight block was dropped, and a new request then served).
    Launch counters are zeroed at each killed run's first restart and read
    at its end: the restored path's K1, K4, K6 (unchunked) and K4, K6, K7
    (chunked) must have launched."""
    import tempfile

    from paddle_tpu_torch.serving import FaultInjector, RequestJournal

    t_phase = time.perf_counter()
    prompts, knobs = recovery_prompts(seed, model.llama.config.vocab_size)
    counters = serve_counters()
    plain = dict(kv_dtype="bf16")
    chunked = dict(plain, enable_chunked_prefill=True,
                   prefill_chunk_tokens=256)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        def journal(name):
            return RequestJournal(path=os.path.join(tmp, f"{name}.jsonl"))

        def run(name, kw, fi=None, bare=False, counted=False, then=None):
            return recovery_run(model, dev, prompts, knobs, kw, fi,
                                None if bare else journal(name),
                                counters if counted else None, then)

        runs = {"A": [], "B": []}
        for tag in "ABBA":
            runs[tag].append(run(f"uninterrupted_{len(runs[tag])}", plain,
                                 bare=tag == "B"))
        ref = runs["A"][0]
        for r in runs["A"] + runs["B"]:
            if r["outputs"] != ref["outputs"]:
                raise AssertionError("serve_recovery: the uninterrupted "
                                     "runs' streams differ")
        tps = {t: [round(r["tokens_per_s"], 1) for r in runs[t]]
               for t in runs}
        log(f"[serve_recovery] uninterrupted, A B B A: supervised + journal "
            f"{tps['A']} tokens/s, bare engine {tps['B']} tokens/s")
        out["uninterrupted"] = dict(
            supervised_tokens_per_s=tps["A"], bare_tokens_per_s=tps["B"],
            peak_bytes=ref["peak_bytes"])

        k = kill_point(ref["trace"], chunked=False)
        fi = FaultInjector().fail_at("device_lost", k) \
            .fail_at("device_lost", k + 3)
        killed = run("kill", plain, fi, counted=True)
        out["kill"] = hold_recovered("serve_recovery_kill", killed, ref,
                                     prompts, knobs, 2, model, dev,
                                     MARGIN_TOL["bf16"], identical=False)
        out["kill"]["kill_steps"] = [k, k + 3]

        cref = run("chunked", chunked)
        k = kill_point(cref["trace"], chunked=True)
        fi = FaultInjector().fail_at("device_lost", k) \
            .fail_at("device_lost", k + 3)
        killed = run("kill_chunked", chunked, fi, counted=True)
        out["kill_chunked"] = hold_recovered(
            "serve_recovery_kill_chunked", killed, cref, prompts, knobs, 2,
            model, dev, MARGIN_TOL["bf16"], identical=False)
        out["kill_chunked"]["kill_steps"] = [k, k + 3]
        for key, need in (("kill", "K1 K4 K6"), ("kill_chunked", "K4 K6 K7")):
            missing = [n for n in need.split()
                       if out[key]["launches"][n] <= 0]
            if missing:
                raise AssertionError(f"serve_recovery {key}: kernels never "
                                     f"launched after the restart: {missing}")

        tr = run("transient", plain, FaultInjector().fail_every("dispatch", 5))
        if tr["outputs"] != ref["outputs"] or tr["retries"] <= 0 \
                or tr["restarts"]:
            raise AssertionError(
                f"serve_recovery transient: streams identical "
                f"{tr['outputs'] == ref['outputs']}, retries "
                f"{tr['retries']}, restarts {len(tr['restarts'])}")
        log(f"[serve_recovery] transient dispatch faults: {tr['retries']} "
            f"retries, 8 of 8 streams bit-identical to run 1, "
            f"{tr['tokens_per_s']:.1f} tokens/s")
        out["transient"] = dict(retries=tr["retries"],
                                tokens_per_s=tr["tokens_per_s"])

        pf = run("persistent_prefill", plain,
                 FaultInjector().fail_at("dispatch", 2, transient=False))
        status, err = pf["status"][2]
        others = [i for i in range(8) if i != 2]
        if status != "failed" or not err or not err.startswith("prefill") \
                or any(pf["status"][i][0] != "finished" for i in others) \
                or any(pf["outputs"][i] != ref["outputs"][i]
                       for i in others):
            raise AssertionError(
                f"serve_recovery persistent prefill: {pf['status']}, "
                f"others identical "
                f"{[pf['outputs'][i] == ref['outputs'][i] for i in others]}")
        log(f"[serve_recovery] persistent prefill fault: request "
            f"{pf['rids'][2]} failed ({err}); 7 of 7 others bit-identical "
            "to run 1")
        out["persistent_prefill"] = dict(error=err)

        def serve_on(sup):
            # the pool as the dropped block left it, then one more request
            in_use, pending = (sup.engine.cache.allocator.num_used,
                               sup.engine._pending)
            after = sup.add_request(prompts[0], max_new_tokens=RECOVERY_NEW)
            sup.run()
            torch.cuda.synchronize()
            if sup.status(after)[0] != "finished":
                raise AssertionError("serve_recovery persistent drain: the "
                                     "engine did not serve on")
            rescore(model, sup, [prompts[0]], [after], MARGIN_TOL["bf16"],
                    dev, "serve_recovery_after_drain_fault")
            return in_use, pending is None

        dr = run("persistent_drain", plain,
                 FaultInjector().fail_at("drain", 1, transient=False),
                 then=serve_on)
        failed = [i for i, s in enumerate(dr["status"]) if s[0] == "failed"]
        in_use, dropped = dr["then"]
        if not failed or any(not dr["status"][i][1].startswith("drain")
                             for i in failed) or in_use != 0 or not dropped:
            raise AssertionError(
                f"serve_recovery persistent drain: {dr['status']}, pages in "
                f"use {in_use}, pending block dropped {dropped}")
        log(f"[serve_recovery] persistent drain fault: {len(failed)} rows "
            f"failed, pool audit clean ({in_use} pages in use) after the "
            "in-flight block was dropped; a new request then served")
        out["persistent_drain"] = dict(failed=len(failed))
    out["launches"] = {n: out["kill"]["launches"][n]
                       + out["kill_chunked"]["launches"][n]
                       for n in out["kill"]["launches"]}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[serve_recovery] launches on the restored paths: "
        f"{out['launches']}; the phase took {out['phase_s']:.1f} s")
    return out


def phase_recovery_fp32(seed, dev):
    """Run 2 of serve_recovery (two kills) without bf16's near-ties:
    LLaMA-7B's widths cut to 2 layers, fp32 weights from the seed and fp32
    pools. Every restored stream, greedy and seeded, must be identical to
    the uninterrupted run's."""
    import dataclasses
    import tempfile

    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import FaultInjector, RequestJournal

    t0 = time.perf_counter()
    cfg = dataclasses.replace(LlamaConfig.llama7b(), num_hidden_layers=2)
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32,
                             seed=seed)
    for p in model.parameters():
        p.requires_grad_(False)
    prompts, knobs = recovery_prompts(seed, cfg.vocab_size)
    kw = dict(kv_dtype="fp32")
    with tempfile.TemporaryDirectory() as tmp:
        ref = recovery_run(model, dev, prompts, knobs, kw, journal=
                           RequestJournal(os.path.join(tmp, "ref.jsonl")))
        k = kill_point(ref["trace"], chunked=False)
        fi = FaultInjector().fail_at("device_lost", k) \
            .fail_at("device_lost", k + 3)
        killed = recovery_run(model, dev, prompts, knobs, kw, fi,
                              RequestJournal(os.path.join(tmp, "k.jsonl")))
        out = hold_recovered("recovery_fp32", killed, ref, prompts, knobs, 2,
                             model, dev, MARGIN_TOL["fp32"], identical=True)
    del model
    out["phase_s"] = time.perf_counter() - t0
    log(f"[recovery_fp32] 8 of 8 restored streams identical; "
        f"{out['phase_s']:.1f} s")
    return out


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
    engine = serve_engine(model, dev, kv_dtype="bf16")
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
    "K2": dict(name="flash_attention_backward_dq", route="cuda",
               source="paddle_tpu_torch/csrc/flash_bwd.cu",
               replaces="paddle_tpu/ops/pallas_kernels.py:357"),
    "K2m": dict(name="flash_attention_backward_dq_dmask", route="cuda",
                source="paddle_tpu_torch/csrc/flash_bwd.cu",
                replaces="paddle_tpu/ops/pallas_kernels.py:357"),
    "K3": dict(name="flash_attention_backward_dkv", route="cuda",
               source="paddle_tpu_torch/csrc/flash_bwd.cu",
               replaces="paddle_tpu/ops/pallas_kernels.py:474"),
    "K4": dict(name="norm_forward", route="triton",
               source="paddle_tpu_torch/ops/norm.py",
               replaces="paddle_tpu/ops/pallas_kernels.py:796"),
    "K5": dict(name="norm_backward", route="triton",
               source="paddle_tpu_torch/ops/norm.py",
               replaces="paddle_tpu/ops/pallas_kernels.py:846"),
    "K6": dict(name="paged_decode_attention", route="cuda",
               source="paddle_tpu_torch/csrc/paged_decode.cu",
               replaces="paddle_tpu/serving/attention.py:530"),
    "K6q": dict(name="paged_decode_attention_dequantizing", route="cuda",
                source="paddle_tpu_torch/csrc/paged_decode.cu",
                replaces="paddle_tpu/serving/attention.py:530"),
    "K7": dict(name="ragged_paged_attention", route="cuda",
               source="paddle_tpu_torch/csrc/ragged_paged.cu",
               replaces="paddle_tpu/serving/attention.py:659"),
    "K9": dict(name="gather_rows", route="cuda",
               source="paddle_tpu_torch/csrc/gather_rows.cu",
               replaces="paddle_tpu/ops/pallas_kernels.py:1173"),
    "K1r": dict(name="flash_attention_forward_ring_step", route="cuda",
                source="paddle_tpu_torch/csrc/flash_fwd.cu",
                replaces="paddle_tpu/ops/pallas_kernels.py:164"),
    "K2r": dict(name="flash_attention_backward_dq_ring_step", route="cuda",
                source="paddle_tpu_torch/csrc/flash_bwd.cu",
                replaces="paddle_tpu/ops/pallas_kernels.py:357"),
    "K3r": dict(name="flash_attention_backward_dkv_ring_step", route="cuda",
                source="paddle_tpu_torch/csrc/flash_bwd.cu",
                replaces="paddle_tpu/ops/pallas_kernels.py:474"),
}


def summarize(main_rows, launches_by_path):
    """The kernels' JSON summary: each kernel's main-path row (the ERNIE
    training path's shapes for K1-K5, T5's encoder for K2 with d(mask) (its
    ms is the kernel plus the batch sum), the serving path's for K6, K6q
    and K7, the GShard MoE dispatch for K9, with its combine beside it, a
    ring step on the diagonal at RING_ATTN for K1r-K3r, every step kind
    beside it) and its launches, summed over the paths that run it. K7's
    launches count both its forms (fp32 / bf16 pools, and int8 / fp8 pools:
    K7q in the paths' counts)."""
    out = []
    for k, meta in KERNELS.items():
        r = main_rows[k]
        paths = {path: counts.get(k, 0) + (counts.get("K7q", 0)
                                           if k == "K7" else 0)
                 for path, counts in launches_by_path.items()
                 if k in counts}
        entry = dict(meta, launches=sum(paths.values()),
                     launches_by_path=paths, max_abs_err=r["max_abs_err"],
                     ms=r["ms"], plain_ms=r["plain_ms"],
                     bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                     library_ms=r["library_ms"], dtype=r["dtype"],
                     case=r["case"])
        if k == "K2m":
            entry.update({x: r[x] for x in (
                "kernel_ms", "ms_without_dmask", "batch_sum_ms", "groups",
                "buffer_bytes", "whole_ds_bytes", "buffer_bound_ms")})
        if k == "K1":
            entry["dropout_p"] = r.get("dropout_p", 0.0)
            entry["lse_max_abs_err"] = r.get("lse_err")
            v = main_rows["K1 verify"]
            entry["verify_window"] = {x: v[x] for x in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "window_attend_ms", "dtype", "case")}
        if k in ("K1r", "K2r", "K3r"):
            entry["steps"] = {label: {x: s[x] for x in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "live_pairs")}
                for label, s in main_rows[f"{k} steps"].items()}
        if k == "K9":
            c = main_rows["K9 combine"]
            entry["combine"] = {x: c[x] for x in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "dtype", "case")}
        if k == "K7":
            entry["partial_bytes"] = r["partial_bytes"]
            entry["halves"] = {h: {x: main_rows[f"K7 {h}"][x] for x in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "partial_bytes")}
                for h in ("chunk parked", "decode tokens parked",
                          "17-token run at 1007 alone",
                          "17-token run at 1007 + decode tokens")}
            q = main_rows["K7q"]
            entry["quantized"] = dict(
                launches=sum(c.get("K7q", 0)
                             for c in launches_by_path.values()),
                max_abs_err=q["max_abs_err"], ms=q["ms"],
                plain_ms=q["plain_ms"], bound_ms=q["bound_ms"],
                bound_by=q["bound_by"], library_ms=q["library_ms"],
                case=q["case"])
        out.append(entry)
    return {"kernels": out}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="directory for the full results JSON and the "
                         "ptxas reports")
    ap.add_argument("--profile", action="store_true",
                    help="profile one prefill and two decode blocks of the "
                         "served slice, two ragged steps of the chunked "
                         "serve, two speculative blocks, one ERNIE, one T5 "
                         "and one MoE train step with torch.profiler")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    smi = phase_device()
    dev = torch.device("cuda", 0)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    result = {"nvidia_smi": smi, "build_s": phase_build(args.out)}
    rows, main_rows, launches = [], {}, {}
    # the summary's K1 / K4 rows are the training path's (k1 /
    # k45_train_cases); K1's verify window rides beside its row
    main_rows.update(k1_cases(rows, dev))
    k4_cases(rows, dev)
    main_rows["K6"] = k6_cases(rows, dev)
    main_rows["K6q"] = k6q_cases(rows, dev)
    main_rows.update(k7_cases(rows, dev))
    result["paged_edge_cases"] = paged_edge_cases(dev)
    main_rows["K1"] = k1_train_cases(rows, dev)
    main_rows.update(k23_cases(rows, dev))
    result["edge_cases"] = flash_edge_cases(dev)
    main_rows.update(k45_train_cases(rows, dev))
    main_rows.update(t5_kernel_cases(rows, dev))
    main_rows.update(k9_cases(rows, dev, args.seed))
    main_rows.update(phase_ring_kernels(rows, dev))
    result["cases"] = [dict(kernel=k, **r) for k, r in rows]

    def release():
        # the engine and model of a phase hold reference cycles: collect
        # them before the next phase measures its own peak memory
        gc.collect()
        torch.cuda.empty_cache()

    release()
    model = load_llama7b(args.seed, dev)
    result["slice"] = phase_slice(model, args.seed, dev, args.profile,
                                  args.out)
    launches["serve"] = result["slice"]["launches"]
    release()
    for kv in ("bf16",) + QUANT_KV:
        r = phase_serve_chunked(model, args.seed, dev, kv,
                                profile=args.profile and kv == "bf16",
                                out_dir=args.out)
        result[f"serve_chunked_{kv}"] = r
        launches[f"serve_chunked_{kv}"] = r["launches"]
        release()
    r = phase_serve_chunked(model, args.seed, dev, "bf16", n_requests=3,
                            ragged=False)
    result["serve_chained"] = r
    launches["serve_chained"] = r["launches"]
    release()
    r = phase_serve_recovery(model, args.seed, dev)
    result["serve_recovery"] = r
    launches["serve_recovery"] = r["launches"]
    release()
    t0 = time.perf_counter()
    r = phase_serve_prefix_spec(model, args.seed, dev, args.profile,
                                args.out)
    result["serve_prefix_spec"] = r
    launches["serve_prefix_spec"] = r["launches"]
    del model
    release()
    result["spec_fp32"] = phase_spec_fp32(args.seed, dev)
    release()
    r["phases_s"] = time.perf_counter() - t0
    log(f"[serve_prefix_spec] this phase and spec_fp32 took "
        f"{r['phases_s']:.1f} s")
    result["recovery_fp32"] = phase_recovery_fp32(args.seed, dev)
    release()
    result["train"] = phase_train(args.seed, dev, args.profile, args.out)
    launches["train"] = result["train"]["launches"]
    release()
    result["step_check"] = phase_step_check(args.seed, dev)
    release()
    result["train_t5"] = phase_train_t5(args.seed, dev, args.profile,
                                        args.out)
    launches["train_t5"] = result["train_t5"]["launches"]
    release()
    result["t5_step_check"] = phase_t5_step_check(args.seed, dev)
    for kind in ("gshard", "switch"):
        release()
        r = phase_train_moe(kind, args.seed, dev,
                            args.profile and kind == "gshard", args.out)
        result[f"train_moe_{kind}"] = r
        launches[f"train_moe_{kind}"] = r["launches"]
    release()
    result["moe_step_check"] = phase_moe_step_check(args.seed, dev)
    release()
    result["multi_rank"] = r = phase_multi_rank(args.seed, dev)
    for key in (f"{seq} {str(dtype)[6:]}" for seq, dtype in SP_RUNS):
        for mode, kernels in (("ring", ("K1r", "K2r", "K3r")),
                              ("ulysses", ("K1", "K2", "K3"))):
            launches[f"{mode} {key}"] = {
                k: sum(p["launches"][k]
                       for p in r[f"{mode} {key}"]["per_rank"])
                for k in kernels}
    launches["moe_ep"] = {"K9": sum(p["train"]["launches"]["K9"]
                                    for p in r["moe_ep"])}
    result["seconds"] = time.perf_counter() - t_start
    result["summary"] = summarize(main_rows, launches)
    if args.out:
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(result, f, indent=1)
    log(f"[done] {result['seconds']:.1f} s in all")
    print(json.dumps(result["summary"]), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
