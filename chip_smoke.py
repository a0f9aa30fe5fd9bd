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
14. t5_step_check: a 1-layer T5 at full width, fp32, dropout 0, batch 2,
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
   speculation serve, one ERNIE, one T5, one GPT and one GShard MoE train
   step:
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
25. serve_cluster (run after serve_recovery): a ServingCluster of three
   serve engines sharing the one LLaMA-7B on the card, each with two SLO
   classes, its own FlightRecorder across rebuilds and a post-mortem
   directory, supervised with max_restarts=1. Twelve greedy requests of
   32 new tokens, two late: six share a 512-token prefix, six have their
   own 64-480-token prompts. Replica 1 is killed by `device_lost` twice
   once each of its requests is mid-decode: it restarts, then dies and
   its live requests migrate to the survivors as folded re-prefills.
   Every request must finish exactly once through `stream()` (no token
   twice, one `done` each, `check_consistency()`), pass the margin check,
   and K1, K4, K6 must launch; the death's post-mortem bundle must hold
   the fault, the death and the migrations and render through
   `tools/postmortem.py`; `ServingCluster(tp_size=2)` must refuse a
   factory that takes no `tp_size=` / `devices=`. Prints placements, affinity hits / misses, migrations, migrated
   tokens, `serving_cluster_migration_seconds`, the first token after the
   death, tokens/s, goodput and attainment per SLO class, peak memory,
   and how many streams equal an uninterrupted single engine's;
26. cluster_fp32 (run after recovery_fp32): the same kill at fp32 on 2
   layers of full width: every stream identical to the uninterrupted
   single engine's;
27. serve_observed (run after serve_cluster): the Serve phase's 8
   requests in the order A B B A, A with `enable_metrics=False`, B with
   metrics, two SLO classes, a FlightRecorder and the lifecycle tracker
   (tokens/s of each: the observability plane's cost); then a Profiler
   window with the device target over three decode steps: its chrome
   trace must hold `serving.decode_block` and `serving.request[<rid>]`
   spans and render through `tools/trace_summary.py`, its torch.profiler
   trace must hold K6's kernel inside the window, `stats()["slo"]` must
   be filled, and the healthy engine's post-mortem bundle must render
   through `tools/postmortem.py`.

28. gpt_kernels (run with the other kernel phases): K1, K2 and K3 at GPT-3
   1.3B's training shape, (8, 2048, 16, 128) causal with attention dropout
   0.1 in bf16 (and batch 1 in fp32), against their plain versions under
   TOL_REL; K1 at `generate`'s static decode shape, (4, 1, 32, 128)
   queries over a (4, 320, 32, 128) cache under a (1, 1, 1, 320) float
   mask; K4 and K5 in LayerNorm mode at (16384, 2048) fp32 and K4 at
   (512, 2048) bf16; kernel, plain and library (sdpa, F.layer_norm) times
   and the bound;
29. generate (run after serve_prefix_spec, on its LLaMA-7B): 4 seeded
   prompts of 256 tokens, 64 new tokens over a bf16 static cache: greedy
   (K1 exactly once a layer a step; every stream through the margin
   check, and against the Serve engine's streams for the same prompts:
   where they part, the no-cache margin must be under MARGIN_TOL), seeded
   sampling (temperature 0.8, top-k 50, top-p 0.9: the same seed twice
   identical, another seed different) and beam search (2 prompts, 4
   beams, 32 new tokens, an eos id); prints the prefill ms, decode
   tokens/s, peak memory and K1's launches;
30. generate_fp32 (after cluster_fp32): LLaMA-7B and GPT-3 1.3B widths at
   1 layer, fp32: greedy and beam streams on the card identical to the
   CPU's (the plain versions), seeded sampled streams identical or parted
   only where the two tokens' perturbed logits lie within
   SAMPLED_FP32_TOL; T5-base at 1 + 1 layers, greedy, identical; a bf16
   LLaMA over an fp32 cache through the margin check;
31. generate_t5: T5-base bf16, 8 x 512 source tokens, 64 new tokens,
   greedy; the stream held to the uncached decoder's argmax where its
   top-2 margin passes T5_MARGIN_TOL; prints the encoder ms and decode
   tokens/s;
32. serve_gpt: GPT-3 1.3B bf16 served by the Serve engine, 8 greedy
   requests of 32-512 prompt tokens and 32 new tokens, two late,
   unchunked (K1, K4, K6 must launch) and chunked (256, the ragged step:
   K4, K6, K7), each stream against `generate`'s (where they part, the
   margin must be under MARGIN_TOL) and through the margin check;
33. train_gpt (after step_check): the GPT-3 1.3B causal-LM step at full
   width (GPTConfig.gpt3_1p3b, 1.3157 B parameters, random weights from
   --seed), batch 8 x 2048, O1 bf16, dropout 0.1 / 0.1, the fused LM
   loss, Adam 1e-4, one fixed batch, 3 warm-up (the last under sync debug
   mode "error") and 10 timed steps through make_causal_lm_train_step;
   K1-K5 exactly 24, 24, 24, 49, 49 a step; the loss finite and falling;
   prints tokens/s/chip, step ms, MFU (bench.py's FLOPs per token) and
   peak memory (--profile adds one profiled step);
34. gpt_step_check: GPT-3 1.3B widths at 1 layer, fp32, dropout 0, batch
   2 x 256, the fused LM loss: loss, every gradient (GRAD_RTOL) and one
   Adam update (ADAM_ATOL, both fed the CPU's gradients) card against
   CPU; LLaMA-7B widths at 1 layer with `labels=`, unfused and fused,
   the same without the update; one O1 step of the GPT with the fused
   head against the unfused (O1_LOSS_RTOL, O1_GRAD_COS);
35. tp_kernels (run with the other kernel phases): K1 (the serve prefill
   and a verify window), K6, K6q (int8, fp8) and K7 (the flat step) at a
   tensor-parallel shard's head count, LLaMA-7B's 16 heads at tp=2 and 8
   at tp=4, against their plain versions, with kernel, plain, library
   times and the bound (`tp_kernel_cases`); then whether LLaMA-7B's shard
   products at 8-512 rows give the rows of the whole product when cut into
   2 or 4 row chunks (`row_chunk_products`, a reading);
36. serve_tp (after serve_observed, on the Serve model): tensor-parallel
   serving at tp 1, 2 and 4 with the Serve engine's knobs on the one card
   repeated (`devices=[cuda:0] * tp`; also on distinct cards when there
   are as many), then tp=2 chunked (256, ragged), over int8 pools with the
   int8 all-reduce, and overlapped (2 chunks): 8 greedy requests, 32 new
   tokens, 2 late. Streams held against tp=1 by the margin check; the
   overlapped streams identical to serial tp=2; on one card K1 and K6
   launch exactly tp times as often as at tp=1, K4 as often on one card
   (a norm a device). Prints
   tokens/s, `serving_tp_collective_seconds`, `overlap_fraction`, pool
   bytes a shard, peak memory and launches;
37. serve_tp_fp32 (after cluster_fp32): tp=2 at fp32 on 1 layer of full
   width, card streams identical to the CPU's; a tp=2 snapshot restored
   onto tp=4, every request exactly once;
38. cluster_tp (after serve_tp_fp32): 2 replicas of tp=2 (fp32, 1 layer)
   carved from the one card, replica 1 killed mid-decode, its requests
   migrated, every request exactly once and every stream identical to
   the run without the kill; serve_gpt adds serve_gpt_tp, its unchunked
   run at tp=2, held against tp=1 by the margin check;
39. plane_kernels (run with the other kernel phases): K1, K2 + K3 (bf16,
   dropout 0.1) and K4 / K5 (fp32 LayerNorm) at a ZeRO rank's ERNIE-base
   batch (8 x 512) and at the recompute cell's batch 64, against their
   plain versions, with kernel, plain, library times and the bound;
40. recompute (after step_check): ERNIE-1.0 base with every encoder layer
   recomputed: one O1 step on against off from the same weights and
   generator under PyTorch's deterministic algorithms (the default CUDA
   embedding backward is not run-to-run deterministic), the loss and
   every gradient bit for bit, K1 twice and K4
   24 more a step on; then batch 32 off and on and batch 64 on (3 + 5
   steps each): tokens/s/chip, MFU, peak memory (lower on than off);
41. train_gpt_o2 (after train_gpt): GPT-3 1.3B at 8 x 2048 under O2 with
   GPT-3's recipe (`amp.decorate`, AdamW 0.9 / 0.95 / 1e-8 with decay 0.1
   and fp32 masters, the global-norm clip 1.0, a linear warmup into a
   cosine decay, a GradScaler), 3 + 10 steps: the loss finite and
   falling, K1-K5 as in train_gpt; tokens/s/chip, MFU and peak memory
   beside O1's; then 2 layers at full width in fp32, three AdamW + clip
   + schedule updates card against CPU within ADAM_ATOL;
42. train_zero (last): ZeRO data parallelism of ERNIE-1.0 base's widths
   at 6 of its 12 layers (ZERO_LAYERS) at the Train ERNIE step (a global
   32 x 512, O1, dropout 0.1, the fused MLM loss, Adam 1e-4) over 4 ranks spawned once (gloo on one card, NCCL
   with a card a rank; PyTorch's deterministic algorithms in each rank),
   each rank's generator from (seed, rank), each leg
   1 + 1 steps: stage 0 twice (run-to-run identity), stages 1 and 2,
   stage 2 bucketed (25 MiB) serial and overlapped, grad_accum 2, bf16
   with fp32 masters and a planted non-finite step (skipped, the scale
   halved), telemetry off / on; stage 1 / 2 / bucketed /
   overlapped and telemetry on bit-identical to their references,
   optimizer bytes a rank a quarter of stage 0's; then a second world of
   2 ranks restores the dp-4 checkpoint at stage 2 and stage 0, which
   must stay bit-identical. Prints tokens/s/chip, optimizer and
   parameter bytes a rank, staged bytes, the collective probes and the
   overlap fraction of each leg;
43. fleet_kernels (run with the other kernel phases): K1, K2 + K3 (bf16,
   causal, dropout 0.1) at a fleet rank's micro-batch of GPT-3 1.3B
   (FLEET_ATTN: 2 x 2048, 16 / mp = 8 heads of 128) and K4 / K5 (fp32
   LayerNorm) at its 4096 rows of width 2048, against their plain
   versions, with kernel, plain, library times and the bound;
44. embedding_determinism (after step_check): F4: two identical ERNIE-1.0
   base O1 steps under PyTorch's defaults give the same bits in every
   gradient (the port's fixed-order embedding backward); each lookup's
   backward timed: the port's, PyTorch's default and its deterministic
   form;
45. train_fleet (last): fleet hybrid parallelism over 4 ranks spawned
   once, after the single-rank references: GPT-3 1.3B at pp 2 x mp 2
   through fleet.init, PipelineLayer(gpt_pipe_layers(tensor_parallel=
   True)), distributed_model, distributed_optimizer and train_batch (2 O1
   steps at dropout 0 against the single-rank accumulated step: loss and
   global gradient norm within the bf16 bounds; one step at GPT-3's
   recipe: tokens/s/chip, MFU, each rank's peak memory and staged bytes);
   pp 2 x dp 2 and its interleaved form at fp32 bit for bit the
   single-rank step; GroupSharded p_g_os bit for bit ZeroTrainStep stage
   0 with a quarter of its parameter bytes; ZeroTrainStep dp 2 x tp 2 on
   ERNIE-1.0 base's widths at ZERO_LAYERS within fp32 rounding of tp 1. PyTorch's default
   algorithms in every rank.
46. train_dp (last): the rest of distributed through the port's own
   launcher: `python -m paddle_tpu_torch.distributed.launch
   --nproc_per_node 4` runs this script's `--dp-worker` mode on 4 ranks
   (gloo on one card, NCCL with a card a rank), each joining with
   `init_parallel_env()` and no arguments. ERNIE-1.0 base's widths at
   ZERO_LAYERS at dp 4 through
   fleet.init and fleet.distributed_model (a DataParallel), fed by
   DistributedBatchSampler and DataLoader (32 x 512, 8 a rank), O1 bf16,
   dropout 0, Adam 1e-4, 1 + 1 steps under PyTorch's deterministic
   algorithms: loss and every parameter bit for bit ZeroTrainStep(stage=0)
   on the same global batches; broadcast, reduce, reduce_scatter, scatter,
   alltoall, isend / irecv and the object collectives on CUDA tensors
   against their definitions; an async checkpoint of the model and the
   optimizer (one more step while it is written, then wait_save), loaded
   here at world 1 into a fresh model and optimizer, every tensor bit for
   bit rank 0's snapshot; the Engine on GPT-3 1.3B's widths at 2 layers
   over ProcessMesh([[0, 1], [2, 3]], ["dp", "mp"]), 2 SGD steps against
   the dense model's 2 eager steps, and Adam on a ["sharding", "mp"] mesh
   against the dp mesh (losses within 1e-5, optimizer bytes a rank at
   half). Prints step ms, tokens/s/chip, staged bytes a step and peak
   memory a rank, the checkpoint's bytes and save / wait / load seconds,
   the Engine legs' walls and K1-K5 launches a rank.

47. dygraph (after step_check): the Paddle dygraph surface on the card,
   `import paddle_tpu_torch as paddle`: a plain dygraph network at
   ERNIE-1.0 base widths (three nn.Embedding, nn.LayerNorm(eps 1e-12),
   nn.Dropout(0.1), an nn.TransformerEncoder of 12 post-LN GELU layers,
   nn.Linear(768, 18000); 113.1 M parameters, random weights from --seed)
   trained at 32 x 512 under paddle.amp.auto_cast O1 bf16 with
   nn.CrossEntropyLoss over every token and paddle.optimizer.AdamW(1e-4)
   (loss.backward(), opt.step(), opt.clear_grad()): 2 warm-up and 5 timed
   steps, the loss finite and falling, K1-K5 exactly 12 / 12 / 12 / 25 /
   25 launches a step (the counters zeroed before the timed steps); an
   eval forward under paddle.no_grad(), finite, of the logits' shape;
   tokens/s/chip, step ms, MFU, peak memory beside the torch-native Train
   ERNIE step of the same call, the Tensors the surface wraps a step and
   its host cost an op, the busy share under --profile; then the network
   at 2 of its 12 layers, fp32, dropout 0, 2 x 512: one step on the card
   against the CPU from the same weights, the loss and every gradient
   under check_grads, one AdamW update of each within ADAM_ATOL.

48. vision (after dygraph): `paddle.Model`, `paddle.vision` and `nn` in
   full on the card. ResNet-50 at full width (`vision.models.resnet50()`,
   25.56 M parameters, 224 x 224, 1000 classes) through
   `Model.prepare(Momentum(0.1, 0.9, L2Decay(1e-4)), CrossEntropyLoss,
   Accuracy, amp_configs="O2")` on a seeded batch of 256 held on the card:
   2 warm-up and 5 timed `train_batch` steps (images/s/chip, step ms, MFU
   over 989 TFLOP/s with 3x the forward's convolution and linear FLOPs,
   peak memory), then one `Model.fit` epoch of 4 batches of a seeded
   in-memory dataset and an `evaluate` on the running statistics. LeNet
   through `Model.fit` on the seeded synthetic MNIST (ToTensor, Adam,
   Accuracy, batch 64, drop_last, 2 epochs): the loss falls and the
   accuracy rises; `Model.save` / `load` round-trips on the card.
   Transformer-base (Vaswani et al.: d_model 512, 8 heads of 64, 6 + 6
   post-LN ReLU layers, FFN 2048, dropout 0.1; a shared seeded
   `nn.Embedding(37000, 512)` (N(0, 512^-1/2), scaled by sqrt(512)) with
   sinusoidal positions, `nn.Transformer`
   with the decoder's float causal mask from
   `generate_square_subsequent_mask`, `nn.Linear(512, 37000)`,
   CrossEntropyLoss) at 96 x 256 source and target tokens through
   `Model.train_batch` at O1: 1 + 3 steps, K1-K5 exactly 18 / 18 / 18 / 30
   / 30 launches a step. Card against CPU at fp32 (cuDNN's TF32 off): a
   `ResNet(BottleneckBlock, 50, num_classes=10)` step at 2 x 3 x 64 x 64
   (loss, every gradient and the running statistics under VIS_GRAD_RTOL,
   one Momentum update within ADAM_ATOL) and a 1 + 1-layer Transformer
   step (GRAD_RTOL, one Adam update within ADAM_ATOL), ReLU masks shared.
   The kernels at the Transformer's shapes (K1-K3 for encoder self and
   cross attention, one launch shape, and decoder self with the float
   mask; K4 / K5 at 24576 x 512) are held to their plain versions with the other kernel cases.

The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}. This script imports no JAX and nothing of
paddle_tpu; the card machine has neither.
"""
import argparse
import contextlib
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
# the depth of the full-width card-against-CPU checks of t5_step_check
# (T5-base, encoder and decoder), gpt_step_check (GPT-3 1.3B, LLaMA-7B),
# generate_fp32 and tp_fp32_model (serve_tp_fp32, cluster_tp): 1 since PR
# 18, 2 before (the CPU's side of each check set most of its time)
CHECK_LAYERS = 1
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


def verify_window_inputs(g, dev, dtype, h=32):
    """A speculative verify window as `serving.attention.
    _prefill_attention_paged` hands it to K1: 8 rows of 1 + SPEC_LOOKAHEAD
    query tokens against each row's whole gathered page table (64 pages of
    16, `h` heads of 128: LLaMA-7B's 32, or a tensor-parallel shard's)
    under the paged prefill's float mask (column j visible to lane i of row
    r iff j <= pos[r] + i, else -1e9), rows at positions spread over the
    table. Returns (q, k, v, mask, pos, paged cache over pools holding the
    same shape)."""
    from paddle_tpu_torch.serving.kv_cache import PagedLayerCache

    b, lanes, d, ps, maxp = 8, 1 + SPEC_LOOKAHEAD, 128, 16, 64
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
            # GPT's training form, causal + dropout at head_dim 128, at a
            # length off the tiles, in bf16 (wgmma) and fp32 (FMA)
            (torch.bfloat16, (2, 257, 4, 128), True, False),
            (torch.float32, (1, 130, 2, 128), True, False),
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
        from paddle_tpu_torch.nn import torch_functional as F
        from paddle_tpu_torch.ops.registry import get_op

        self._F, self._relu = F, F.relu
        # the Paddle surface's relu (nn.ReLU, F.relu) is the op table's
        self._op = get_op("relu")
        self._op_fn = self._op.fn
        self.masks, self._i, self._mode = [], 0, None
        F.relu = self._call
        self._op.fn = self._call
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
        self._op.fn = self._op_fn
        return False


class plain_versions:
    """Context in which the port's functional layer runs attention and
    RMSNorm through their plain PyTorch versions (autograd through them)
    even on CUDA tensors: the card's own reference for a whole step."""

    def __enter__(self):
        from paddle_tpu_torch.nn import torch_functional as F
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
    """T5 at full width and CHECK_LAYERS encoder + decoder layers, fp32,
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
        cfg.num_layers = CHECK_LAYERS
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
        log(f"[t5_step_check] {ff}, {CHECK_LAYERS} + {CHECK_LAYERS} layers "
            f"full width fp32, 512 / "
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
    from paddle_tpu_torch.nn.layers import Linear

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
    from paddle_tpu_torch.nn import torch_functional as F
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


def serve(engine, prompts, late, max_new, classes=None):
    """Add all but the `late` last prompts, step twice, add the rest, run.
    `classes` gives each request its SLO class. Returns the request ids and
    the wall seconds."""
    kw = [{} if classes is None else {"slo_class": c}
          for c in (classes or prompts)]
    t0 = time.perf_counter()
    n = len(prompts) - late
    rids = [engine.add_request(p, max_new_tokens=max_new, **k)
            for p, k in zip(prompts[:n], kw[:n])]
    for _ in range(2):
        engine.step()
    rids += [engine.add_request(p, max_new_tokens=max_new, **k)
             for p, k in zip(prompts[n:], kw[n:])]
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


def rescore(model, engine, prompts, rids, tol, dev, tag, every=False):
    """Re-score the longest and the shortest request (with `every`, each
    request) with the no-cache forward: wherever its top-2 logit margin
    exceeds `tol`, the engine's greedy token must be its argmax. Returns
    (positions checked, positions that differ, the largest margin among
    those)."""
    checked = mismatched = total = 0
    worst = 0.0
    margins = []
    lens = [len(p) for p in prompts]
    order = np.argsort(lens)
    for i in (range(len(prompts)) if every else (order[-1], order[0])):
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


CLUSTER_REPLICAS = 3
CLUSTER_NEW = 32
CLUSTER_KILLED = 1
# every replica registers both classes; requests alternate between them
# (the shared-prefix ones interactive, the others batch)
CLUSTER_SLO = (("interactive", 0.5, 0.1), ("batch", 5.0, 0.5))


def cluster_prompts(seed, vocab):
    """Twelve prompts, interleaved: six share a seeded PREFIX_TOKENS-token
    prefix (own suffixes of 16-64 tokens), six have their own 64-480
    tokens. The last two (one of each) arrive late."""
    rng = np.random.RandomState(seed + 5)
    prefix = rng.randint(0, vocab, (PREFIX_TOKENS,)).tolist()
    shared = [prefix + rng.randint(0, vocab, (int(n),)).tolist()
              for n in rng.randint(16, 65, 6)]
    own = [rng.randint(0, vocab, (int(n),)).tolist()
           for n in rng.randint(64, 481, 6)]
    return [p for pair in zip(shared, own) for p in pair]


def cluster_factory(model, dev, kw, recorders, registries, pm_dir):
    """Replica engines: the serve engine over the one shared model, the
    two SLO classes, and per replica one FlightRecorder and one
    MetricsRegistry that its rebuilds keep."""
    from paddle_tpu_torch.observability import (FlightRecorder,
                                                MetricsRegistry, SloClass)

    classes = [SloClass(*c) for c in CLUSTER_SLO]

    def make(replica=None, fault_injector=None):
        return serve_engine(
            model, dev, fault_injector=fault_injector, slo_classes=classes,
            metrics=registries.setdefault(replica, MetricsRegistry()),
            flight_recorder=recorders.setdefault(
                replica, FlightRecorder(capacity=4096)),
            postmortem_dir=pm_dir, **kw)
    return make


def cluster_run(model, dev, prompts, kw, pm_dir, kill=True, counters=None):
    """Serve `prompts` (CLUSTER_NEW tokens each, the last two after the
    cluster's second step) on a ServingCluster of CLUSTER_REPLICAS serve
    engines under supervisors with max_restarts=1, through `stream()`.
    With `kill`, replica CLUSTER_KILLED's injector fires `device_lost` at
    its next step and two steps later once each of its requests has a
    decode block delivered: it restarts once, then dies and its live
    requests migrate. Checks every request finished exactly once through
    the stream (no token twice, one `done`) and the cluster's audit.
    Returns the readings; no engine outlives the call."""
    from paddle_tpu_torch.serving import FaultInjector, ServingCluster

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    recorders, registries = {}, {}
    inj = [FaultInjector() for _ in range(CLUSTER_REPLICAS)]
    cl = ServingCluster(cluster_factory(model, dev, kw, recorders,
                                        registries, pm_dir),
                        num_replicas=CLUSTER_REPLICAS, fault_injectors=inj,
                        supervisor_kw=dict(max_restarts=1),
                        postmortem_dir=pm_dir)
    deaths = []
    on_death = cl._on_replica_death

    def timed_death(rep, exc):
        deaths.append(time.perf_counter())
        return on_death(rep, exc)

    cl._on_replica_death = timed_death
    classes = [CLUSTER_SLO[i % 2][0] for i in range(len(prompts))]
    if counters is not None:
        zero_counters(counters)
    t0 = time.perf_counter()
    rids = [cl.add_request(p, max_new_tokens=CLUSTER_NEW, slo_class=c)
            for p, c in zip(prompts[:-2], classes[:-2])]
    seen, done = {}, {}
    armed = not kill
    first_after = None
    for rid, tok, fin in cl.stream():
        seen.setdefault(rid, []).append(tok)
        done[rid] = done.get(rid, 0) + fin
        if deaths and first_after is None \
                and cl._records[rid].migrations:
            first_after = time.perf_counter() - deaths[0]
        if len(rids) < len(prompts) and cl._step_count >= 2:
            rids += [cl.add_request(p, max_new_tokens=CLUSTER_NEW,
                                    slo_class=c)
                     for p, c in zip(prompts[-2:], classes[-2:])]
        if not armed:
            mine = [r for r in cl._records.values()
                    if r.replica == CLUSTER_KILLED]
            if mine and all(len(r.delivered) > 8 for r in mine):
                k = inj[CLUSTER_KILLED].counts.get("device_lost", 0)
                inj[CLUSTER_KILLED].fail_at("device_lost", k) \
                    .fail_at("device_lost", k + 2)
                armed = True
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters(counters) if counters is not None else None
    peak = torch.cuda.max_memory_allocated()
    for i, rid in enumerate(rids):
        if cl.status(rid) != ("finished", None):
            raise AssertionError(f"cluster: request {rid} ended "
                                 f"{cl.status(rid)}")
        out = cl.output(rid)
        if seen.get(rid, []) != out[len(prompts[i]):] \
                or len(out) != len(prompts[i]) + CLUSTER_NEW \
                or done.get(rid) != 1:
            raise AssertionError(
                f"cluster: request {rid}: {len(seen.get(rid, []))} tokens "
                f"streamed, {done.get(rid)} done flags, not its output "
                "exactly once")
    cl.check_consistency()
    st = cl.stats()
    if kill and (st["health"].count("dead") != 1
                 or st["health"][CLUSTER_KILLED] != "dead"
                 or not st["migrations"]):
        raise AssertionError(f"cluster: health {st['health']}, "
                             f"{st['migrations']} migrations")
    mig = cl.metrics.get("serving_cluster_migration_seconds")
    slo = {}
    for name, _, _ in CLUSTER_SLO:
        rows = [reg.get("serving_slo_goodput_tokens_total",
                        {"slo_class": name}) for reg in registries.values()]
        live = [rep.supervisor.engine.stats()["slo"][name]
                for rep in cl.replicas if rep.supervisor.engine is not None]
        slo[name] = dict(
            goodput_tokens=int(sum(c.value for c in rows if c is not None)),
            tokens=CLUSTER_NEW * classes.count(name),
            attainment=[row["attainment"] for row in live],
            ttft_p50_s=[row["lifetime"]["ttft"]["p50"] for row in live],
            tpot_p50_s=[row["lifetime"]["tpot"]["p50"] for row in live])
    tokens = sum(len(v) for v in seen.values())
    res = dict(
        rids=rids, outputs=[cl.output(r) for r in rids], wall_s=wall,
        tokens_per_s=tokens / wall, peak_bytes=peak, launches=launches,
        routed=st["router"]["routed"],
        affinity_hits=st["router"]["affinity_hits"],
        affinity_misses=st["router"]["affinity_misses"],
        migrations=st["migrations"], migrated_tokens=st["migrated_tokens"],
        migration_s=(mig.sum if mig is not None else 0.0),
        migration_count=(mig.count if mig is not None else 0),
        first_token_after_death_s=first_after, health=st["health"],
        restarts=[len(rep.supervisor.restarts) for rep in cl.replicas],
        postmortems=list(cl.postmortem_paths), slo=slo,
        telemetry_series=len(cl.telemetry()["metrics"]["metrics"]),
        migrated_rids=[r for r in rids if cl._records[r].migrations])
    cl.close()
    return res, cl


def _run_tool(name, *args):
    """Run tools/<name>.py (stdlib-only repo tools) in a subprocess;
    returns its stdout, failing on a non-zero exit."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tools", f"{name}.py")
    proc = subprocess.run([sys.executable, path, *args],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise AssertionError(f"tools/{name}.py exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    return proc.stdout


def hold_bundle(path, tag):
    """The dead replica's post-mortem bundle must hold the fatal fault,
    the death and the migrations, and render through tools/postmortem.py."""
    with open(path) as f:
        bundle = json.load(f)
    kinds = [e["kind"] for e in bundle["events"]]
    fatal = [e for e in bundle["events"]
             if e["kind"] == "fault" and e.get("fatal")
             and e.get("site") == "device_lost"]
    moves = [e for e in bundle["events"] if e["kind"] == "migrate"]
    if not fatal or "dead" not in kinds or not moves \
            or any(m["src"] != CLUSTER_KILLED for m in moves):
        raise AssertionError(f"{tag}: bundle kinds {sorted(set(kinds))}")
    text = _run_tool("postmortem", path)
    if "post-mortem:" not in text or ">>" not in text:
        raise AssertionError(f"{tag}: tools/postmortem.py rendered no "
                             "migration")
    return dict(events=len(bundle["events"]), migrate_events=len(moves),
                kinds=sorted(set(kinds)))


def phase_serve_cluster(model, seed, dev, out_dir=None):
    """Three LLaMA-7B replicas on the one card, replica 1 killed and its
    requests migrated (see the module docstring, phase 25)."""
    import tempfile

    from paddle_tpu_torch.serving import ServingCluster

    t_phase = time.perf_counter()
    prompts = cluster_prompts(seed, model.llama.config.vocab_size)
    try:
        ServingCluster(lambda: None, num_replicas=2, tp_size=2,
                       devices=[dev] * 4)
        raise AssertionError("serve_cluster: a tp_size=2 cluster took a "
                             "factory without tp_size= / devices=")
    except ValueError as e:
        if "tp_size" not in str(e):
            raise AssertionError(f"serve_cluster: tp_size=2 raised {e}")
    # the uninterrupted single engine: the streams' yardstick
    engine = serve_engine(model, dev, kv_dtype="bf16")
    ref_rids = [engine.add_request(p, max_new_tokens=CLUSTER_NEW)
                for p in prompts]
    ref = engine.run()
    ref = [ref[r] for r in ref_rids]
    del engine
    counters = serve_counters()
    with tempfile.TemporaryDirectory() as tmp:
        pm_dir = os.path.join(out_dir or tmp, "cluster_postmortems")
        run, cl = cluster_run(model, dev, prompts, dict(kv_dtype="bf16"),
                              pm_dir, counters=counters)
        launches = {k: run["launches"][k] for k in ("K1", "K4", "K6")}
        missing = [k for k, n in launches.items() if n <= 0]
        if missing:
            raise AssertionError(f"serve_cluster: kernels never launched: "
                                 f"{missing}")
        if len(run["postmortems"]) != 1:
            raise AssertionError(f"serve_cluster: bundles "
                                 f"{run['postmortems']}")
        bundle = hold_bundle(run["postmortems"][0], "serve_cluster")
        checked, _, _ = rescore(model, cl, prompts, run["rids"],
                                MARGIN_TOL["bf16"], dev, "serve_cluster",
                                every=True)
        del cl
    same = sum(a == b for a, b in zip(run["outputs"], ref))
    migrated = [run["rids"].index(r) for r in run["migrated_rids"]]
    same_migrated = sum(run["outputs"][i] == ref[i] for i in migrated)
    fta = run["first_token_after_death_s"]
    log(f"[serve_cluster] {CLUSTER_REPLICAS} replicas, prompts "
        f"{sorted(len(p) for p in prompts)}: placements {run['routed']}, "
        f"affinity hits {run['affinity_hits']} misses "
        f"{run['affinity_misses']}; replica {CLUSTER_KILLED} killed "
        f"(restarts {run['restarts']}, health {run['health']}): "
        f"{run['migrations']} migrations, {run['migrated_tokens']} migrated "
        f"(re-prefilled) tokens, serving_cluster_migration_seconds "
        f"{run['migration_s'] * 1e3:.3f} ms over {run['migration_count']}; "
        f"first token after the death "
        f"{'none' if fta is None else f'{fta * 1e3:.3f} ms'}")
    log(f"[serve_cluster] {run['tokens_per_s']:.1f} tokens/s ("
        f"{run['wall_s']:.3f} s); peak memory "
        f"{run['peak_bytes'] / 2**30:.3f} GiB; {same} of {len(prompts)} "
        f"streams ({same_migrated} of {len(migrated)} migrated) identical "
        f"to the uninterrupted single engine; launches {launches}; bundle "
        f"{bundle['events']} events, {bundle['migrate_events']} migrations;"
        f" telemetry() merged {run['telemetry_series']} series")
    for name, row in run["slo"].items():
        log(f"[serve_cluster] SLO {name}: goodput {row['goodput_tokens']} "
            f"of {row['tokens']} tokens; attainment by live replica "
            f"{[{k: round(v, 4) for k, v in a.items()} for a in row['attainment']]}"
            f"; TTFT p50 {[round(x * 1e3, 1) for x in row['ttft_p50_s']]} "
            f"ms, TPOT p50 {[round(x * 1e3, 2) for x in row['tpot_p50_s']]}"
            " ms")
    run.update(identical=same, migrated_identical=same_migrated,
               margin_checked=checked, bundle=bundle, launches=launches,
               phase_s=time.perf_counter() - t_phase)
    del run["outputs"]
    log(f"[serve_cluster] the phase took {run['phase_s']:.1f} s")
    return run


def phase_cluster_fp32(seed, dev):
    """serve_cluster's kill at fp32 on 2 layers of full width: every
    stream, the migrated ones too, identical to the uninterrupted single
    engine's."""
    import dataclasses
    import tempfile

    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    t0 = time.perf_counter()
    cfg = dataclasses.replace(LlamaConfig.llama7b(), num_hidden_layers=2)
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32,
                             seed=seed)
    for p in model.parameters():
        p.requires_grad_(False)
    prompts = cluster_prompts(seed, cfg.vocab_size)
    engine = serve_engine(model, dev, kv_dtype="fp32")
    ref_rids = [engine.add_request(p, max_new_tokens=CLUSTER_NEW)
                for p in prompts]
    ref = engine.run()
    ref = [ref[r] for r in ref_rids]
    del engine
    with tempfile.TemporaryDirectory() as tmp:
        run, cl = cluster_run(model, dev, prompts, dict(kv_dtype="fp32"),
                              tmp)
        del cl
    same = sum(a == b for a, b in zip(run["outputs"], ref))
    if same != len(prompts):
        raise AssertionError(f"cluster_fp32: {same} of {len(prompts)} "
                             "streams identical to the uninterrupted run")
    del model
    out = dict(identical=same, migrations=run["migrations"],
               migrated_tokens=run["migrated_tokens"],
               first_token_after_death_s=run["first_token_after_death_s"],
               phase_s=time.perf_counter() - t0)
    log(f"[cluster_fp32] {same} of {len(prompts)} streams identical ("
        f"{run['migrations']} migrated); {out['phase_s']:.1f} s")
    return out


def phase_serve_observed(model, seed, dev, out_dir=None):
    """The observability plane on the Serve engine (module docstring,
    phase 27)."""
    import tempfile

    from paddle_tpu_torch import profiler as P
    from paddle_tpu_torch.observability import FlightRecorder, SloClass

    t_phase = time.perf_counter()
    cfg = model.llama.config
    rng = np.random.RandomState(seed)
    for n in (40, 200):               # phase_slice's warm-up draws
        rng.randint(0, cfg.vocab_size, (n,))
    lens = rng.randint(32, 513, 8)
    prompts = [rng.randint(0, cfg.vocab_size, (int(n),)) for n in lens]
    classes = [SloClass(*c) for c in CLUSTER_SLO]
    names = [CLUSTER_SLO[i % 2][0] for i in range(len(prompts))]
    observed = dict(kv_dtype="bf16", slo_classes=classes)
    counters = serve_counters()
    zero_counters(counters)
    runs = {"A": [], "B": []}
    streams = []
    for tag in "ABBA":
        if tag == "A":
            engine = serve_engine(model, dev, kv_dtype="bf16",
                                  enable_metrics=False)
        else:
            engine = serve_engine(model, dev,
                                  flight_recorder=FlightRecorder(),
                                  **observed)
        rids, wall = serve(engine, prompts, 2, 32,
                           classes=None if tag == "A" else names)
        runs[tag].append(8 * 32 / wall)
        streams.append([engine.output(r) for r in rids])
        del engine
    if any(s != streams[0] for s in streams):
        raise AssertionError("serve_observed: the observed and unobserved "
                             "streams differ")
    tmp = tempfile.TemporaryDirectory()
    base = os.path.join(out_dir, "serve_observed") if out_dir else tmp.name
    engine = serve_engine(model, dev, flight_recorder=FlightRecorder(),
                          **observed)
    rids = [engine.add_request(p, max_new_tokens=32, slo_class=c)
            for p, c in zip(prompts, names)]
    # eight prefills (steps 0-7), a fresh decode block (8), then the window
    # records three chained decode steps
    prof = P.Profiler(scheduler=P.make_scheduler(closed=9, ready=0,
                                                 record=3, repeat=1),
                      on_trace_ready=P.export_chrome_tracing(
                          base, "serve_observed"),
                      profile_dir=os.path.join(tmp.name, "device"))
    prof.start()
    while engine.scheduler.has_work() or engine._pending is not None:
        if engine.scheduler.has_work():
            engine.step()
        else:
            engine.drain_all()
        prof.step()
    prof.stop()
    torch.cuda.synchronize()
    launches = {k: n for k, n in read_counters(counters).items()
                if k in ("K1", "K4", "K6")}
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"serve_observed: kernels never launched: "
                             f"{missing}")
    trace = prof._last_export
    with open(trace) as f:
        names = [e["name"] for e in json.load(f)["traceEvents"]]
    lanes = [n for n in names if n.startswith("serving.request[")]
    if "serving.decode_block" not in names or not lanes:
        raise AssertionError(f"serve_observed: the chrome trace holds "
                             f"{sorted(set(names))[:20]}")
    summary = _run_tool("trace_summary", trace, "--requests")
    if "serving.decode_block" not in summary:
        raise AssertionError("serve_observed: tools/trace_summary.py did "
                             "not render the decode blocks")
    if prof.device_trace_path is None:
        raise AssertionError("serve_observed: no device trace")
    with open(prof.device_trace_path) as f:
        dev_events = json.load(f)["traceEvents"]
    spans = [e for e in dev_events if e.get("name") == "serving.decode_block"
             and e.get("ph") == "X"]
    k6 = [e for e in dev_events if e.get("cat") == "kernel"
          and "paged_decode" in e.get("name", "")]
    if not spans or not k6 \
            or not any(e["ts"] >= min(s["ts"] for s in spans) for e in k6):
        raise AssertionError(f"serve_observed: device trace holds "
                             f"{len(spans)} decode_block spans and "
                             f"{len(k6)} K6 kernels")
    stats = engine.stats()
    if set(stats["slo"]) != {c.name for c in classes} or not all(
            row["lifetime"]["ttft"]["count"] == 4
            for row in stats["slo"].values()):
        raise AssertionError(f"serve_observed: stats()['slo'] "
                             f"{stats['slo']}")
    bundle = engine.dump_postmortem("healthy", directory=base)
    text = _run_tool("postmortem", bundle)
    if "post-mortem:" not in text:
        raise AssertionError("serve_observed: tools/postmortem.py rendered "
                             "nothing")
    del engine
    tmp.cleanup()
    ratio = (sum(runs["B"]) / sum(runs["A"]))
    log(f"[serve_observed] A B B A tokens/s: unobserved {[round(x, 1) for x in runs['A']]}, "
        f"observed {[round(x, 1) for x in runs['B']]} (B / A {ratio:.4f}); "
        f"streams identical; trace {trace} ({len(names)} host spans, "
        f"{len(lanes)} request-lane spans), device trace "
        f"{len(spans)} decode_block spans, {len(k6)} K6 kernels in the "
        f"window; goodput {stats['goodput_tokens']} of "
        f"{stats['tokens_generated']} tokens; launches {launches}")
    out = dict(unobserved_tokens_per_s=runs["A"],
               observed_tokens_per_s=runs["B"], observed_over_unobserved=ratio,
               trace=trace, host_spans=len(names), request_spans=len(lanes),
               device_decode_spans=len(spans), device_k6_kernels=len(k6),
               slo={k: v["attainment"] for k, v in stats["slo"].items()},
               goodput_tokens=stats["goodput_tokens"], launches=launches,
               phase_s=time.perf_counter() - t_phase)
    log(f"[serve_observed] the phase took {out['phase_s']:.1f} s")
    return out


# ------------------------------------------- generation and the GPT family

# GPT-3 1.3B attention at its published context, the Train GPT batch:
# (b, S, heads, head_dim)
GPT_ATTN = (8, 2048, 16, 128)
GPT_HIDDEN = 2048
# the static decode shape of the Generate cell: LLaMA-7B's 32 heads of 128,
# 4 rows, a 256-token prompt plus 64 new tokens in the cache; the query at
# position STATIC_DECODE_POS sees the keys 0..STATIC_DECODE_POS
STATIC_DECODE = (4, 320, 32, 128)
STATIC_DECODE_POS = 288


def gpt_launches(layers):
    """A GPT train step's launches: K1-K3 once a block, K4 / K5 for the
    block's two norms and the final norm (GPT-3 1.3B: 24, 24, 24, 49,
    49)."""
    return {"K1": layers, "K2": layers, "K3": layers, "K4": 2 * layers + 1,
            "K5": 2 * layers + 1}


# the Generate cell: LLaMA-7B, GEN_ROWS prompts of GEN_PROMPT tokens, GEN_NEW
# new tokens, sampled at GEN_SAMPLING; beam search over GEN_BEAM_ROWS of
# them with GEN_BEAMS beams and GEN_BEAM_NEW new tokens
GEN_ROWS, GEN_PROMPT, GEN_NEW = 4, 256, 64
GEN_SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.9)
GEN_BEAM_ROWS, GEN_BEAMS, GEN_BEAM_NEW = 2, 4, 32
# the card-against-CPU generation at fp32 (2 layers of full width): rows,
# prompt tokens, new tokens (greedy and sampled), beam new tokens and beams
GEN_FP32 = dict(rows=2, prompt=64, new=16, beam_new=8, beams=3)
# T5-base generation: rows, source tokens, new tokens
T5_GEN = (8, 512, 64)
# T5's tied head scales its logits by d_model**-0.5: random T5-base logits
# are ~0.02, their top-2 margins mostly below 0.01, so the bf16 cached
# decode is held to the uncached decoder's argmax where the margin passes
# 0.01 (the bf16 logits' own rounding is ~2e-4 there)
T5_MARGIN_TOL = 0.01
# a sampled stream on the card against the CPU at fp32: where they part,
# the two tokens' Gumbel-perturbed logits must lie within this (the fp32
# logits differ by summation order, ~1e-5)
SAMPLED_FP32_TOL = 1e-3
# the bf16 fused and unfused causal-LM heads of one O1 step: the loss
# within 2e-2 relative and every gradient's cosine above 0.99, the bounds
# of the port's O1 tests against the reference (tests/test_torch_gpt.py)
O1_LOSS_RTOL, O1_GRAD_COS = 2e-2, 0.99
# the Adam update, card against CPU fed the same gradients: fp32 rounding
# of one step of ~lr
ADAM_ATOL = 1e-6


def gpt_kernel_cases(rows, dev):
    """K1, K2 and K3 at GPT-3 1.3B's training shape (GPT_ATTN), causal with
    attention dropout 0.1, bf16 at batch 8 and fp32 at batch 1, each
    gradient held to the plain backward on the same inputs; K1 at the
    static decode shape; K4 / K5 in LayerNorm mode at GPT's width. Returns
    {"K1 gpt", "K2 gpt", "K3 gpt", "K1 static decode", "K4 gpt", "K5 gpt"}
    rows for the summary."""
    main = gpt_attention_cases(rows, dev)
    main["K1 static decode"] = static_decode_cases(rows, dev)
    main.update(gpt_norm_cases(rows, dev))
    return main


def gpt_attention_cases(rows, dev, shape=GPT_ATTN, fp32=True, key="gpt",
                        causal=True, p=TRAIN_DROPOUT, forms=None, label=None,
                        mask=None):
    """K1, K2 and K3 at `shape` (`causal`, dropout `p`, an additive float
    `mask` broadcast over batch and heads), bf16 at its batch
    and (`fp32`) fp32 at batch 1, or `forms` ((dtype, batch), ...); the
    first form's rows under `"K1 <key>"`..."""
    from paddle_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(11)
    b0, s, h, d = shape
    seed = torch.tensor([9001], dtype=torch.int32, device=dev)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    main = {}
    if forms is None:
        forms = ((torch.bfloat16, b0),) + (((torch.float32, 1),) if fp32
                                           else ())
    for dtype, b in forms:
        q, k, v, dout = (torch.randn(b, s, h, d, generator=g, device=dev)
                         .to(dtype) for _ in range(4))
        m = None if mask is None else mask.to(dtype)
        out, lse = fa.flash_attention(q, k, v, m, causal, True, p, seed)
        torch.cuda.synchronize()
        e1, t1, e_lse = check_k1(out, lse, q, k, v, dtype, m, causal, p,
                                 seed)
        delta = fa.attention_delta(out, dout)
        args = (q, k, v, dout, lse, delta, m, causal, p, seed)
        dq = fa.flash_attention_dq(*args)
        dk, dv = fa.flash_attention_dkv(*args)
        rdq, rdk, rdv = fa.flash_attention_backward_reference(*args)
        torch.cuda.synchronize()
        e2 = check_rel("K2", dq, rdq, dtype)
        e3 = max(check_rel("K3", dk, rdk, dtype),
                 check_rel("K3", dv, rdv, dtype),
                 key=lambda et: et[0] / et[1])
        del dq, dk, dv, rdq, rdk, rdv
        ms1 = time_ms(lambda: fa.flash_attention(q, k, v, m, causal,
                                                 True, p, seed))
        ms2 = time_ms(lambda: fa.flash_attention_dq(*args))
        ms3 = time_ms(lambda: fa.flash_attention_dkv(*args))
        plain1 = time_ms(lambda: fa.flash_attention_reference(
            q, k, v, m, causal, True, p, seed), 3, 1)
        plain_b = time_ms(
            lambda: fa.flash_attention_backward_reference(*args), 3, 1)
        qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_()
                      for x in (q, k, v))
        with torch.no_grad():
            lib1 = time_ms(lambda: sdpa(qt, kt, vt, attn_mask=m,
                                        dropout_p=p, is_causal=causal))
        lib_out = sdpa(qt, kt, vt, attn_mask=m, dropout_p=p,
                       is_causal=causal)
        dout_t = dout.transpose(1, 2)
        lib_b = time_ms(lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), dout_t, retain_graph=True))
        pairs = s * (s + 1) // 2 if causal else s * s
        if m is not None:       # the pairs the mask leaves finite
            pairs = int(torch.isfinite(m).sum()) // (m.numel() // (s * s))
        extra = () if m is None else (m,)
        io_in = nbytes(q, k, v, dout, lse, delta, *extra)
        b1 = bound(nbytes(q, k, v, out, lse, *extra),
                   4 * b * h * d * pairs, dtype)
        b2 = bound(io_in + nbytes(q), 6 * b * h * d * pairs, dtype)
        b3 = bound(io_in + nbytes(k, v), 8 * b * h * d * pairs, dtype)
        kind = ("causal" if causal else "no mask") if m is None else \
            f"float mask {tuple(m.shape)}"
        case = (f"{label or 'GPT ' + ('fleet rank ' if key != 'gpt' else '')}"
                f"{kind} ({b}, {s}, {h}, {d}), dropout {p}")
        note = "sdpa backward, dQ+dK+dV together"
        r1 = _row(dtype, case, e1, t1, ms1, plain1, lib1, *b1, lse_err=e_lse,
                  dropout_p=p, library_note="sdpa forward"
                  + (", is_causal" if causal else "")
                  + ("" if m is None else ", the same float mask"))
        r2 = _row(dtype, case, *e2, ms2, plain_b, lib_b, *b2,
                  library_note=note)
        r3 = _row(dtype, case, *e3, ms3, plain_b, lib_b, *b3,
                  library_note=note)
        for name, r in (("K1", r1), ("K2", r2), ("K3", r3)):
            _log_row(name, r)
            rows.append((name, r))
        if not main:
            main = {f"K1 {key}": r1, f"K2 {key}": r2, f"K3 {key}": r3}
        del q, k, v, dout, out, lib_out, qt, kt, vt
    return main


def static_decode_cases(rows, dev):
    """K1 at generate's static decode shape: one query row a batch entry
    over the whole (b, 320, 32, 128) cache, under the (1, 1, 1, 320) float
    mask that leaves the keys 0..STATIC_DECODE_POS visible; bf16 (the
    Generate cell's cache) and fp32. Held to the plain version on fp32
    values under TOL_REL; the bound counts the visible key rows, the
    whole cache's bytes beside it. Returns the bf16 row."""
    from paddle_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(12)
    b, total, h, d = STATIC_DECODE
    pos = STATIC_DECODE_POS
    mask = torch.zeros(1, 1, 1, total, device=dev)
    mask[..., pos + 1:] = -1e9
    main = None
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn(b, 1, h, d, generator=g, device=dev).to(dtype)
        k, v = (torch.randn(b, total, h, d, generator=g, device=dev)
                .to(dtype) for _ in range(2))
        out, lse = fa.flash_attention(q, k, v, mask, return_lse=True)
        torch.cuda.synchronize()
        err, tol, e_lse = check_k1(out, lse, q, k, v, dtype, mask)
        ms = time_ms(lambda: fa.flash_attention(q, k, v, mask))
        issued = time_ms(lambda: fa.flash_attention(q, k, v, mask),
                         queued=False)
        plain = time_ms(lambda: fa.flash_attention_reference(q, k, v, mask))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask.to(dtype)))
        rows_seen = pos + 1
        kv_bytes = 2 * b * rows_seen * h * d * q.element_size()
        io = nbytes(q, out, mask) + kv_bytes
        bms, by = bound(io, 4 * b * h * d * rows_seen, dtype)
        whole = nbytes(q, out, mask, k, v) / HBM_BYTES_PER_S * 1e3
        case = (f"static decode ({b}, 1, {h}, {d}) x ({b}, {total}, {h}, "
                f"{d}), (1, 1, 1, {total}) mask, {rows_seen} keys visible")
        r = _row(dtype, case, err, tol, ms, plain, lib, bms, by,
                 lse_err=e_lse, issued_ms=issued, whole_cache_bound_ms=whole,
                 library_note="sdpa with the same float mask")
        _log_row("K1", r)
        log(f"[K1] {str(dtype)[6:]} static decode: issued from Python "
            f"{issued:.4f} ms; the whole cache's bytes {whole:.4f} ms at "
            "3.35 TB/s")
        rows.append(("K1", r))
        if dtype == torch.bfloat16:
            main = r
    return main


def gpt_norm_cases(rows, dev, forms=None, key="gpt", hidden=None):
    """K4 and K5 in LayerNorm mode (eps 1e-5) at GPT-3 1.3B's width: the
    Train GPT step's 16384 rows in fp32 (O1's type), and K4 in bf16 at 512
    rows (the Serve GPT prefill), or `forms` ((dtype, rows, with the
    backward), ...). Library: F.layer_norm and its backward."""
    from paddle_tpu_torch.ops import norm

    g = torch.Generator(device=dev).manual_seed(13)
    hd, eps, tF = hidden or GPT_HIDDEN, 1e-5, torch.nn.functional
    main = {}
    if forms is None:
        forms = ((torch.float32, GPT_ATTN[0] * GPT_ATTN[1], True),
                 (torch.bfloat16, 512, False))
    for dtype, n, with_bwd in forms:
        x = (torch.randn(n, hd, generator=g, device=dev) * 2 + 0.3).to(dtype)
        w = (1 + 0.1 * torch.randn(hd, generator=g, device=dev)).to(dtype)
        bias = (0.1 * torch.randn(hd, generator=g, device=dev)).to(dtype)
        y, mu, rs = norm.norm_forward(x, w, bias, eps, True)
        ry, rmu, rrs = norm.norm_forward_reference(x, w, bias, eps, True)
        torch.cuda.synchronize()
        err4 = max(max_err(y, ry), max_err(mu, rmu),
                   max_err(rs, rrs) / float(rrs.abs().max()))
        tol4 = check("K4", err4, dtype)
        ms4 = time_ms(lambda: norm.norm_forward(x, w, bias, eps, True))
        plain4 = time_ms(lambda: norm.norm_forward_reference(x, w, bias, eps,
                                                             True))
        lib4 = time_ms(lambda: tF.layer_norm(x, (hd,), w, bias, eps))
        b4 = bound(nbytes(x, w, bias, y, mu, rs), 8 * x.numel(), dtype)
        case = f"layer ({n}, {hd})"
        r4 = _row(dtype, case, err4, tol4, ms4, plain4, lib4, *b4)
        _log_row("K4", r4)
        rows.append(("K4", r4))
        main[f"K4 {key} {str(dtype)[6:]}"] = r4
        if with_bwd:
            dy = torch.randn(n, hd, generator=g, device=dev).to(dtype)
            dx = norm.norm_backward(x, w, dy, mu, rs, True)
            rdx = norm.norm_backward_reference(x, w, dy, mu, rs, True)
            torch.cuda.synchronize()
            err5, tol5 = check_rel("K5", dx, rdx, dtype)
            ms5 = time_ms(lambda: norm.norm_backward(x, w, dy, mu, rs, True))
            plain5 = time_ms(lambda: norm.norm_backward_reference(
                x, w, dy, mu, rs, True))
            xl = x.detach().requires_grad_()
            yl = tF.layer_norm(xl, (hd,), w, bias, eps)
            lib5 = time_ms(lambda: torch.autograd.grad(yl, xl, dy,
                                                       retain_graph=True))
            b5 = bound(nbytes(x, w, dy, mu, rs, dx), 10 * x.numel(), dtype)
            r5 = _row(dtype, case, err5, tol5, ms5, plain5, lib5, *b5,
                      library_note="F.layer_norm backward (dx, and dw)")
            _log_row("K5", r5)
            rows.append(("K5", r5))
            main[f"K5 {key}"] = r5
            del dy, dx, rdx, xl, yl
        del x, y
    return main


class _Streams:
    """`rescore`'s view of token streams that no engine served."""

    def __init__(self, seqs):
        self.seqs = seqs

    def output(self, i):
        return self.seqs[i]


def hold_divergence(model, a, b, n_prompt, tol, dev, tag):
    """Streams a and b (lists of token lists, prompts included) of one
    greedy model: where a pair parts, the no-cache forward's top-2 margin
    at the first differing position must be at most `tol` (else one of
    them took a token the model clearly does not pick). Returns (identical
    streams, the largest margin at a parting)."""
    same, worst = 0, 0.0
    for x, y, n in zip(a, b, n_prompt):
        if x == y:
            same += 1
            continue
        j = next(i for i, (u, w) in enumerate(zip(x, y)) if u != w)
        if j < n:
            raise AssertionError(f"{tag}: the streams differ in the prompt")
        with torch.no_grad():
            logits = model(torch.tensor([x[:j]], device=dev))[0, -1].float()
        top2 = logits.topk(2).values
        margin = float(top2[0] - top2[1])
        worst = max(worst, margin)
        if margin > tol:
            raise AssertionError(f"{tag}: streams part at position {j} where "
                                 f"the top-2 margin is {margin:.4f} > {tol}")
    log(f"[{tag}] {same} of {len(a)} streams identical; where they part the "
        f"top-2 margin is at most {worst:.4f} (tol {tol})")
    return same, worst


def phase_generate(model, seed, dev):
    """`generate` on the Serve cell's LLaMA-7B (bf16 weights, a bf16
    cache): GEN_ROWS seeded prompts of GEN_PROMPT tokens, GEN_NEW new
    tokens. Greedy: each stream through the margin check, and against the
    port's ServingEngine's streams for the same prompts (K1 static against
    K6 paged rounds otherwise: where they part, the margin must be small);
    sampled at GEN_SAMPLING: the same seed twice identical, another seed
    different; beam search. Prints the prefill ms, decode tokens/s, peak
    memory and K1's launches (every layer once a step)."""
    from paddle_tpu_torch.models import generate, init_caches
    from paddle_tpu_torch.ops import flash_attention as fa

    cfg = model.llama.config
    rng = np.random.RandomState(seed + 13)
    prompts = rng.randint(0, cfg.vocab_size, (GEN_ROWS, GEN_PROMPT))
    ids = torch.from_numpy(prompts).to(dev)
    bf16 = dict(cache_dtype=torch.bfloat16)
    generate(model, ids[:, :32], max_new_tokens=4, temperature=0.0, **bf16)
    caches = init_caches(model, GEN_ROWS, GEN_PROMPT + GEN_NEW,
                         torch.bfloat16)
    with torch.no_grad():
        prefill_ms = time_ms(lambda: model(ids, caches=caches, start_pos=0),
                             5, 1, queued=False)
    del caches
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    fa.flash_attention.launches = 0
    t0 = time.perf_counter()
    out = generate(model, ids, max_new_tokens=GEN_NEW, temperature=0.0,
                   **bf16)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1 = fa.flash_attention.launches
    peak = torch.cuda.max_memory_allocated()
    layers = cfg.num_hidden_layers
    if k1 != layers * GEN_NEW:
        raise AssertionError(f"generate: K1 launched {k1} times, not "
                             f"{layers} x {GEN_NEW}")
    decode_tps = GEN_ROWS * (GEN_NEW - 1) / (wall - prefill_ms / 1e3)
    seqs = out.tolist()
    if out.shape != (GEN_ROWS, GEN_PROMPT + GEN_NEW) or not torch.equal(
            out[:, :GEN_PROMPT], ids):
        raise AssertionError(f"generate: output {tuple(out.shape)}")
    log(f"[generate] LLaMA-7B bf16, {GEN_ROWS} x {GEN_PROMPT} prompt tokens, "
        f"{GEN_NEW} new: {wall:.3f} s; prefill {prefill_ms:.2f} ms (CUDA "
        f"events, calls issued one by one); decode {decode_tps:.1f} "
        f"tokens/s ({(wall - prefill_ms / 1e3) / (GEN_NEW - 1) * 1e3:.2f} ms "
        f"a step); peak memory {peak / 2**30:.2f} GiB ({held / 2**30:.2f} "
        f"held before); K1 {k1} launches ({layers} at the prefill shape, "
        f"{k1 - layers} at the decode shape)")
    checked, _, _ = rescore(model, _Streams(seqs), list(prompts),
                            list(range(GEN_ROWS)), MARGIN_TOL["bf16"], dev,
                            "generate", every=True)
    engine = serve_engine(model, dev, kv_dtype="bf16")
    rids = [engine.add_request(p, max_new_tokens=GEN_NEW) for p in prompts]
    engine.run()
    served = [engine.output(r) for r in rids]
    del engine
    gc.collect()
    same, worst = hold_divergence(model, seqs, served, [GEN_PROMPT] *
                                  GEN_ROWS, MARGIN_TOL["bf16"], dev,
                                  "generate vs engine")
    a = generate(model, ids, max_new_tokens=GEN_NEW, seed=seed, **bf16,
                 **GEN_SAMPLING)
    b = generate(model, ids, max_new_tokens=GEN_NEW, seed=seed, **bf16,
                 **GEN_SAMPLING)
    c = generate(model, ids, max_new_tokens=GEN_NEW, seed=seed + 1, **bf16,
                 **GEN_SAMPLING)
    if not torch.equal(a, b) or torch.equal(a, c):
        raise AssertionError("generate: seeded sampling not reproducible, "
                             "or another seed gave the same streams")
    eos = seqs[0][GEN_PROMPT + 3]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    beam = generate(model, ids[:GEN_BEAM_ROWS], max_new_tokens=GEN_BEAM_NEW,
                    num_beams=GEN_BEAMS, eos_token_id=eos, **bf16)
    torch.cuda.synchronize()
    beam_s = time.perf_counter() - t0
    if beam.shape != (GEN_BEAM_ROWS, GEN_PROMPT + GEN_BEAM_NEW) or not \
            torch.equal(beam[:, :GEN_PROMPT], ids[:GEN_BEAM_ROWS]):
        raise AssertionError(f"beam search: output {tuple(beam.shape)}")
    for row in beam[:, GEN_PROMPT:].tolist():
        if eos in row and any(t != eos for t in row[row.index(eos):]):
            raise AssertionError("beam search: a token other than eos after "
                                 "eos")
    log(f"[generate] sampled ({GEN_SAMPLING}): seed {seed} twice identical, "
        f"seed {seed + 1} differs; beam search ({GEN_BEAM_ROWS} rows x "
        f"{GEN_BEAMS} beams, {GEN_BEAM_NEW} new, eos {eos}): {beam_s:.3f} s")
    return dict(launches={"K1": k1}, wall_s=wall, prefill_ms=prefill_ms,
                decode_tokens_per_s=decode_tps, peak_bytes=peak,
                held_bytes=held, margin_checked=checked,
                identical_to_engine=same, worst_parting_margin=worst,
                beam_s=beam_s)


def hold_sampled(cpu, card_out, cpu_out, n_prompt, seed, tag):
    """Sampled streams of one fp32 model, card against CPU: where a row
    parts, the two tokens' Gumbel-perturbed filtered logits (the CPU's, at
    that draw) lie within SAMPLED_FP32_TOL. Returns identical rows."""
    from paddle_tpu_torch.models import generation as gen

    same, rows = 0, card_out.shape[0]
    for r, (x, y) in enumerate(zip(card_out.tolist(), cpu_out.tolist())):
        if x == y:
            same += 1
            continue
        j = next(i for i, (u, w) in enumerate(zip(x, y)) if u != w)
        with torch.no_grad():
            logits = cpu(torch.tensor([y[:j]]))[0, -1:]
        u = gen._Draws(seed, rows, logits.shape[-1], "cpu")(j - n_prompt)
        s = (gen._filter(logits, **{k: GEN_SAMPLING[k] for k in
                                    ("temperature", "top_k", "top_p")})
             - torch.log(-torch.log(u[r:r + 1])))[0]
        gap = abs(float(s[x[j]] - s[y[j]]))
        if not gap <= SAMPLED_FP32_TOL:
            raise AssertionError(f"{tag}: sampled row {r} parts at {j} with "
                                 f"a perturbed-logit gap {gap}")
    return same


def generate_card_vs_cpu(tag, card, cpu, vocab, seed, dev):
    """Greedy, beam and seeded sampled `generate` of one fp32 decoder on
    the card and on the CPU (its plain versions): greedy and beam streams
    identical, sampled ones under hold_sampled."""
    from paddle_tpu_torch.models import generate

    g = GEN_FP32
    ids = np.random.RandomState(seed + 17).randint(0, vocab, (g["rows"],
                                                              g["prompt"]))
    runs = {"greedy": dict(max_new_tokens=g["new"], temperature=0.0),
            "beam": dict(max_new_tokens=g["beam_new"], num_beams=g["beams"]),
            "sampled": dict(max_new_tokens=g["new"], seed=seed,
                            **GEN_SAMPLING)}
    out = {}
    for name, kw in runs.items():
        a = generate(card, torch.from_numpy(ids).to(dev), **kw).cpu()
        b = generate(cpu, torch.from_numpy(ids), **kw)
        if name == "sampled":
            out[name] = hold_sampled(cpu, a, b, g["prompt"], seed, tag)
        elif not torch.equal(a, b):
            raise AssertionError(f"{tag}: {name} streams differ, card "
                                 f"{a.tolist()} cpu {b.tolist()}")
        else:
            out[name] = len(ids)
    log(f"[generate_fp32] {tag}: greedy {out['greedy']} and beam "
        f"{out['beam']} of {len(ids)} rows identical card against CPU; "
        f"sampled {out['sampled']} identical (the rest within "
        f"{SAMPLED_FP32_TOL})")
    return out


def phase_generate_fp32(seed, dev):
    """`generate` at fp32 on CHECK_LAYERS layers of full width, card
    against CPU: LLaMA-7B and GPT-3 1.3B (greedy, beam, sampled), and
    T5-base's greedy `generate` at CHECK_LAYERS + CHECK_LAYERS layers;
    then a bf16 LLaMA over an fp32 cache (the
    static attention's type rule), through the margin check."""
    from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                         LlamaConfig, LlamaForCausalLM,
                                         T5Config,
                                         T5ForConditionalGeneration,
                                         generate)
    from paddle_tpu_torch.ops import flash_attention as fa

    out = {}
    lcfg = LlamaConfig.llama7b()
    lcfg.num_hidden_layers = CHECK_LAYERS
    gcfg = GPTConfig.gpt3_1p3b()
    gcfg.num_hidden_layers = CHECK_LAYERS
    gcfg.hidden_dropout_prob = gcfg.attention_probs_dropout_prob = 0.0
    for tag, cls, cfg in (("llama", LlamaForCausalLM, lcfg),
                          ("gpt", GPTForCausalLM, gcfg)):
        card = cls(cfg, device=dev, seed=seed)
        cpu = cls(cfg, device="cpu", seed=seed)
        cpu.load_state_dict({k: v.cpu() for k, v in
                             card.state_dict().items()})
        out[tag] = generate_card_vs_cpu(tag, card, cpu, cfg.vocab_size,
                                        seed, dev)
        if tag == "llama":
            del cpu
            half = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16)
            half.load_state_dict(card.state_dict())
            del card
            ids = np.random.RandomState(seed + 19).randint(
                0, cfg.vocab_size, (GEN_FP32["rows"], GEN_FP32["prompt"]))
            n0 = fa.flash_attention.launches
            seqs = generate(half, torch.from_numpy(ids).to(dev),
                            max_new_tokens=GEN_FP32["new"], temperature=0.0,
                            cache_dtype="float32").tolist()
            ran = fa.flash_attention.launches - n0
            checked, _, _ = rescore(half, _Streams(seqs), list(ids),
                                    list(range(len(ids))),
                                    MARGIN_TOL["bf16"], dev,
                                    "generate bf16 model, fp32 cache",
                                    every=True)
            out["bf16_model_fp32_cache"] = dict(checked=checked,
                                                k1_launches=ran)
            del half
        else:
            del card, cpu
        gc.collect()
        torch.cuda.empty_cache()
    tcfg = T5Config.t5_base()
    tcfg.num_layers = CHECK_LAYERS
    card = T5ForConditionalGeneration(tcfg, device=dev, seed=seed)
    cpu = T5ForConditionalGeneration(tcfg, device="cpu", seed=seed)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    src = np.random.RandomState(seed + 23).randint(0, tcfg.vocab_size,
                                                   (2, 128))
    a = card.generate(torch.from_numpy(src).to(dev), max_new_tokens=16).cpu()
    b = cpu.generate(torch.from_numpy(src), max_new_tokens=16)
    if not torch.equal(a, b):
        raise AssertionError(f"t5 greedy streams differ: card {a.tolist()} "
                             f"cpu {b.tolist()}")
    log("[generate_fp32] t5: greedy 2 of 2 rows identical card against CPU")
    out["t5"] = {"greedy": 2}
    return out


def phase_generate_t5(seed, dev):
    """T5-base (bf16, random weights from the seed) `generate`: T5_GEN's
    rows of source tokens, greedy. Prints the encoder ms (the encoder and
    the cross K/V projections), decode tokens/s and K1's launches; the
    stream is held to the uncached decoder's argmax where its top-2 margin
    passes T5_MARGIN_TOL."""
    from paddle_tpu_torch.models import T5Config, T5ForConditionalGeneration
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import norm

    cfg = T5Config.t5_base()
    b, src_len, new = T5_GEN
    model = T5ForConditionalGeneration(cfg, device=dev, dtype=torch.bfloat16,
                                       seed=seed).eval()
    src = torch.from_numpy(np.random.RandomState(seed + 29).randint(
        0, cfg.vocab_size, (b, src_len))).to(dev)
    model.generate(src[:, :64], max_new_tokens=4)
    with torch.no_grad():
        enc_ms = time_ms(lambda: model(src), 5, 1, queued=False)
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention.launches = norm.norm_forward.launches = 0
    t0 = time.perf_counter()
    out = model.generate(src, max_new_tokens=new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K1": fa.flash_attention.launches,
                "K4": norm.norm_forward.launches}
    peak = torch.cuda.max_memory_allocated()
    steps = out.shape[1]
    tps = b * steps / (wall - enc_ms / 1e3)
    if out.shape != (b, new):
        raise AssertionError(f"t5 generate: output {tuple(out.shape)}")
    start = torch.full((b, 1), cfg.decoder_start_token_id, device=dev)
    dec_in = torch.cat([start, out[:, :-1].long()], dim=1)
    with torch.no_grad():
        logits = model(src, dec_in).float()
    if not torch.isfinite(logits).all():
        raise AssertionError("t5: non-finite logits in the uncached decoder")
    top2 = logits.topk(2, dim=-1)
    margin = top2.values[..., 0] - top2.values[..., 1]
    sure = margin > T5_MARGIN_TOL
    wrong = sure & (top2.indices[..., 0] != out.long())
    if int(sure.sum()) == 0 or bool(wrong.any()):
        raise AssertionError(f"t5 generate: {int(sure.sum())} positions over "
                             f"the margin, {int(wrong.sum())} of them wrong")
    log(f"[generate_t5] T5-base bf16, {b} x {src_len} source tokens, {new} "
        f"new: encoder {enc_ms:.2f} ms; {wall:.3f} s in all, decode "
        f"{tps:.1f} tokens/s; peak memory {peak / 2**30:.2f} GiB; launches "
        f"{launches}; {int(sure.sum())} of {b * new} positions had a top-2 "
        f"margin > {T5_MARGIN_TOL} and all matched the uncached argmax")
    return dict(launches=launches, encoder_ms=enc_ms, wall_s=wall,
                decode_tokens_per_s=tps, peak_bytes=peak,
                margin_checked=int(sure.sum()))


def phase_train_gpt(seed, dev, profile=False, out_dir=None):
    """The GPT-3 1.3B causal-LM step (GPTConfig.gpt3_1p3b), batch 8 x 2048,
    O1 bf16, dropout 0.1 / 0.1, the fused LM loss, Adam 1e-4, one fixed
    seeded batch (labels = the ids), through make_causal_lm_train_step: 3
    warm-up (the last under sync debug mode "error") and 10 timed steps."""
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.training import make_causal_lm_train_step

    cfg = GPTConfig.gpt3_1p3b()
    cfg.fused_lm_loss = True
    batch, seq, warmup, steps = GPT_ATTN[0], GPT_ATTN[1], 3, 10
    held = torch.cuda.memory_allocated()
    model = GPTForCausalLM(cfg, device=dev, seed=seed)
    opt = Adam(learning_rate=1e-4, parameters=model.parameters())
    step = make_causal_lm_train_step(model, opt)
    n_params = sum(p.numel() for p in model.parameters())
    ids = torch.from_numpy(np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (batch, seq))).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    log(f"[train_gpt] GPT-3 1.3B ({cfg.num_hidden_layers} layers, hidden "
        f"{cfg.hidden_size}, {cfg.num_attention_heads} heads, FFN "
        f"{cfg.intermediate_size}, vocab {cfg.vocab_size}, "
        f"{n_params / 1e9:.4f} B params), batch {batch} x seq {seq}, bf16 "
        f"O1, dropout {cfg.hidden_dropout_prob}/"
        f"{cfg.attention_probs_dropout_prob}, fused LM loss, Adam 1e-4")
    losses = []
    t0 = time.perf_counter()
    for i in range(warmup):
        torch.cuda.set_sync_debug_mode("error" if i == warmup - 1 else 0)
        try:
            losses.append(step(ids, ids, gen))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    counters = train_counters()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(step(ids, ids, gen))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    loss_vals = [float(x) for x in losses]
    tps = batch * seq * steps / wall
    fpt = flops_per_token(model, cfg, seq)
    mfu = tps * fpt / PEAK_FLOPS[torch.bfloat16]
    log(f"[train_gpt] warm-up {warmup} steps {warm_s:.2f} s (the last under "
        f"sync debug mode 'error'); {steps} timed steps {wall:.3f} s: "
        f"{tps:.1f} tokens/s/chip, step {wall / steps * 1e3:.2f} ms, MFU "
        f"{mfu:.4f} ({fpt / 1e9:.3f} GFLOP/token, "
        f"{fpt * batch * seq / 1e12:.1f} TFLOP a step, over 989 TFLOP/s), "
        f"peak memory {peak / 2**30:.2f} GiB ({held / 2**30:.2f} GiB held "
        "before the phase)")
    log("[train_gpt] loss by step: " + ", ".join(f"{x:.4f}"
                                                 for x in loss_vals))
    log(f"[train_gpt] launches in the {steps} timed steps: {launches}")
    if not all(np.isfinite(loss_vals)):
        raise AssertionError(f"non-finite training loss: {loss_vals}")
    if not loss_vals[-1] < loss_vals[0]:
        raise AssertionError(f"loss did not fall: {loss_vals}")
    expected = gpt_launches(cfg.num_hidden_layers)
    wrong = {k: n for k, n in launches.items() if n != expected[k] * steps}
    if wrong:
        raise AssertionError(f"launches {wrong} (over {steps} steps) != "
                             f"{expected} a step")
    prof = None
    if profile:
        prof = profile_window("train_gpt_step", lambda: step(ids, ids, gen),
                              out_dir)
    return dict(launches=launches, tokens_per_s=tps,
                step_ms=wall / steps * 1e3, mfu=mfu, flops_per_token=fpt,
                n_params=n_params, peak_bytes=peak, held_bytes=held,
                losses=loss_vals, wall_s=wall, warmup_s=warm_s,
                batch=batch, profile=prof)


def step_card_vs_cpu(tag, card, cpu, ids, labels, dev, adam=False):
    """One fp32 forward with labels and backward on the card (kernels) and
    on the CPU (plain versions) from the same weights: the loss and every
    gradient under check_grads; with `adam`, one Adam update of each, both
    fed the CPU's gradients, the parameters within ADAM_ATOL. Returns the
    readings."""
    from paddle_tpu_torch.optimizer import Adam

    counters = train_counters()
    before = {k: fn.launches for k, fn in counters.items()}
    losses = {}
    for name, m in (("card", card), ("cpu", cpu)):
        m.train()
        d = next(m.parameters()).device
        loss = m(ids.to(d), labels=labels.to(d))
        loss.backward()
        losses[name] = float(loss.detach())
    ran = {k: fn.launches - before[k] for k, fn in counters.items()}
    if any(n <= 0 for n in ran.values()):
        raise AssertionError(f"{tag}: the card's step skipped a kernel: {ran}")
    worst, worst_name = check_grads(grad_errors(card, cpu), losses, tag,
                                    GRAD_RTOL)
    out = dict(loss_card=losses["card"], loss_cpu=losses["cpu"],
               worst_grad_rel=worst, worst_grad=worst_name, launches=ran)
    line = (f"[gpt_step_check] {tag}: loss card {losses['card']!r} cpu "
            f"{losses['cpu']!r}; every gradient within {GRAD_RTOL} x "
            f"max|cpu grad|, worst {worst:.3g} ({worst_name}); kernels "
            f"launched {ran}")
    if adam:
        with torch.no_grad():
            for pc, pp in zip(card.parameters(), cpu.parameters()):
                pc.grad.copy_(pp.grad)
        for m in (card, cpu):
            Adam(learning_rate=1e-4, parameters=m.parameters()).step()
        err = max(max_err(pc.cpu(), pp) for pc, pp in
                  zip(card.parameters(), cpu.parameters()))
        if not err <= ADAM_ATOL:
            raise AssertionError(f"{tag}: Adam update max abs error {err}")
        out["adam_max_abs_err"] = err
        line += f"; one Adam update within {err:.3g} (tol {ADAM_ATOL})"
    log(line)
    return out


def o1_fused_vs_unfused(card, ids, dev):
    """One O1 forward and backward of the card model with the fused and
    the unfused causal-LM head: the losses within O1_LOSS_RTOL and every
    gradient's cosine above O1_GRAD_COS."""
    from paddle_tpu_torch import amp

    grads, losses = {}, {}
    for fused in (False, True):
        card.gpt.config.fused_lm_loss = fused
        card.zero_grad(set_to_none=True)
        with amp.auto_cast(level="O1"):
            loss = card(ids.to(dev), labels=ids.to(dev))
        loss.backward()
        losses[fused] = float(loss.detach())
        grads[fused] = {n: p.grad.detach().double().flatten()
                        for n, p in card.named_parameters()}
    if not abs(losses[True] - losses[False]) <= O1_LOSS_RTOL * abs(
            losses[False]):
        raise AssertionError(f"O1 fused loss {losses[True]} vs unfused "
                             f"{losses[False]}")
    cos = {n: float(grads[True][n] @ g / (grads[True][n].norm() * g.norm()))
           for n, g in grads[False].items()}
    low = min(cos, key=cos.get)
    if not cos[low] > O1_GRAD_COS:
        raise AssertionError(f"O1 fused vs unfused: gradient cosine "
                             f"{cos[low]} ({low})")
    log(f"[gpt_step_check] O1 bf16: fused loss {losses[True]!r}, unfused "
        f"{losses[False]!r}; the lowest gradient cosine {cos[low]:.6f} "
        f"({low})")
    return dict(fused=losses[True], unfused=losses[False],
                min_cosine=cos[low])


def phase_gpt_step_check(seed, dev):
    """GPT-3 1.3B's widths at CHECK_LAYERS layers, fp32, dropout 0, batch
    2 x 256: the fused LM loss, every gradient and one Adam update on the
    card against the CPU; the same at LLaMA-7B's widths (CHECK_LAYERS
    layers, batch 2 x 64) with
    `labels=`, unfused and fused; then an O1 step of the GPT with the fused
    head against the unfused."""
    import dataclasses

    from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                         LlamaConfig, LlamaForCausalLM)

    out = {}
    cfg = GPTConfig.gpt3_1p3b()
    cfg.num_hidden_layers = CHECK_LAYERS
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    cfg.fused_lm_loss = True
    card = GPTForCausalLM(cfg, device=dev, seed=seed)
    cpu = GPTForCausalLM(dataclasses.replace(cfg), device="cpu", seed=seed)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    ids = torch.from_numpy(np.random.RandomState(seed + 2).randint(
        0, cfg.vocab_size, (2, 256)))
    out["gpt"] = step_card_vs_cpu(f"GPT {CHECK_LAYERS}-layer fused loss",
                                  card, cpu, ids, ids, dev, adam=True)
    del cpu
    out["gpt_o1"] = o1_fused_vs_unfused(card, ids, dev)
    del card
    gc.collect()
    torch.cuda.empty_cache()
    for fused in (False, True):
        lcfg = LlamaConfig.llama7b()
        lcfg.num_hidden_layers = CHECK_LAYERS
        lcfg.fused_lm_loss = fused
        card = LlamaForCausalLM(lcfg, device=dev, seed=seed)
        cpu = LlamaForCausalLM(lcfg, device="cpu", seed=seed)
        cpu.load_state_dict({k: v.cpu() for k, v in
                             card.state_dict().items()})
        ids = torch.from_numpy(np.random.RandomState(seed + 3).randint(
            0, lcfg.vocab_size, (2, 64)))
        tag = f"LLaMA {CHECK_LAYERS}-layer labels{', fused' if fused else ''}"
        out["llama_fused" if fused else "llama"] = step_card_vs_cpu(
            tag, card, cpu, ids, ids, dev)
        del card, cpu
        gc.collect()
        torch.cuda.empty_cache()
    return out


def load_gpt3(seed, dev):
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    model = GPTForCausalLM(GPTConfig.gpt3_1p3b(), device=dev,
                           dtype=torch.bfloat16, seed=seed)
    for p in model.parameters():
        p.requires_grad_(False)
    return model


def phase_serve_gpt(seed, dev):
    """GPT-3 1.3B (bf16, random weights from the seed) served by the Serve
    cell's engine: 8 greedy requests of 32-512 prompt tokens and 32 new
    tokens, two late, unchunked and then chunked (256, the ragged step).
    Each run's streams against `generate`'s on the same model (where they
    part, the margin must be small) and through the margin check; K1, K4
    and K6 must launch unchunked, K4, K6 and K7 chunked. Then serve_gpt_tp:
    the unchunked run at tp=2 on the one card repeated (8 heads a shard,
    GPT's fused QKV interleaved), held against the tp=1 run's streams by
    the margin check; K1, K4 and K6 must launch."""
    from paddle_tpu_torch.models import generate

    model = load_gpt3(seed, dev)
    cfg = model.gpt.config
    rng = np.random.RandomState(seed + 31)
    lens = rng.randint(32, 513, 8)
    prompts = [rng.randint(0, cfg.vocab_size, (int(n),)) for n in lens]
    refs = [generate(model, torch.from_numpy(p).to(dev)[None],
                     max_new_tokens=32, temperature=0.0,
                     cache_dtype=torch.bfloat16)[0].tolist()
            for p in prompts]
    counters = serve_counters()
    out = {}
    for tag, kw, need in (
            ("serve_gpt", dict(kv_dtype="bf16"), ("K1", "K4", "K6")),
            ("serve_gpt_chunked", dict(kv_dtype="bf16",
                                       enable_chunked_prefill=True,
                                       prefill_chunk_tokens=256),
             ("K4", "K6", "K7"))):
        serve(serve_engine(model, dev, **kw),
              [p[:40] for p in prompts[:2]], 1, 9)
        engine = serve_engine(model, dev, **kw)
        torch.cuda.reset_peak_memory_stats()
        zero_counters(counters)
        rids, wall = serve(engine, prompts, 2, 32)
        launches = {k: n for k, n in read_counters(counters).items()
                    if k in ("K1", "K4", "K6", "K7")}
        stats = engine.stats()
        tokens = stats["tokens_generated"]
        peak = torch.cuda.max_memory_allocated()
        missing = [k for k in need if launches[k] <= 0]
        if stats["num_finished"] != 8 or tokens != 8 * 32 or missing:
            raise AssertionError(f"{tag}: {stats['num_finished']} finished, "
                                 f"{tokens} tokens, never launched "
                                 f"{missing}")
        log(f"[{tag}] GPT-3 1.3B bf16, prompts {sorted(lens.tolist())}, 32 "
            f"new each, 2 late: {tokens} tokens in {wall:.3f} s = "
            f"{tokens / wall:.1f} tokens/s; decode "
            f"{stats['decode_tokens_per_s']:.1f} tokens/s; peak memory "
            f"{peak / 2**30:.2f} GiB; launches {launches}")
        streams = [engine.output(r) for r in rids]
        if tag == "serve_gpt":
            tp1_streams = streams
        same, worst = hold_divergence(model, streams, refs, lens.tolist(),
                                      MARGIN_TOL["bf16"], dev,
                                      f"{tag} vs generate")
        checked, _, _ = rescore(model, engine, prompts, rids,
                                MARGIN_TOL["bf16"], dev, tag)
        out[tag] = dict(launches=launches, tokens_per_s=tokens / wall,
                        decode_tokens_per_s=stats["decode_tokens_per_s"],
                        peak_bytes=peak, identical_to_generate=same,
                        worst_parting_margin=worst, margin_checked=checked)
        del engine
        gc.collect()
    r = tp_served(model, dev, "serve_gpt_tp", prompts,
                  dict(kv_dtype="bf16", tp_size=2, devices=[dev] * 2),
                  counters, ("K1", "K4", "K6"), warm=True)
    r["identical_to_tp1"], r["worst_parting_margin"] = hold_divergence(
        model, r.pop("streams"), tp1_streams, lens.tolist(),
        MARGIN_TOL["bf16"], dev, "serve_gpt_tp vs tp1")
    out["serve_gpt_tp"] = r
    return out


# ------------------------------------------------- tensor-parallel serving

# LLaMA-7B's heads (and kv heads) a shard at tp 2 and 4
TP_SHARD_HEADS = {2: 16, 4: 8}
# the served runs of the TP phases: new tokens a request
TP_NEW = 32


def tp_kernel_cases(rows, dev):
    """K1, K6, K6q and K7 at a tensor-parallel shard's head count: LLaMA-7B
    at tp 2 and 4 runs every attention kernel over 16 and 8 heads (kv heads
    the same) of 128. bf16 queries: K1 at the serve prefill (1, 512, h,
    128) with the causal float mask and is_causal, and at a verify window
    (verify_window_inputs), held row by row under TOL_REL against the plain
    version on the values cast to fp32; K6 over bf16 pools and K6q over
    int8 and fp8 pools at the decode shape (b 8, positions 0..1023), and K7
    on the chunked serve's flat step (FLAT_T tokens) over bf16 pools, under
    TOL against their plain versions (K7's parked tokens exactly zero).
    Kernel, plain and library (sdpa; over the gathered pages for the paged
    kernels) times and the bound. Returns {"K1 tp2 prefill": row, ...}."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.serving import attention as att
    from paddle_tpu_torch.serving.kv_cache import PagedLayerCache

    g = torch.Generator(device=dev).manual_seed(14)
    rng = np.random.RandomState(14)
    dtype = torch.bfloat16
    d, ps, maxp, b, s = 128, 16, 64, 8, 512
    cap = maxp * ps
    out = {}

    def table(n_rows):
        return torch.from_numpy(
            rng.permutation(np.arange(1, n_rows * maxp + 1))[:n_rows * maxp]
            .reshape(n_rows, maxp).astype(np.int32)).to(dev)

    for tp, h in TP_SHARD_HEADS.items():
        tag = f"{h} heads a shard (tp={tp})"

        def rnd(*shape):
            return torch.randn(*shape, generator=g, device=dev).to(dtype)

        causal = torch.full((s, s), -1e9, device=dev).triu(1)[None, None]
        q, k, v = rnd(1, s, h, d), rnd(1, s, h, d), rnd(1, s, h, d)
        wq, wk, wv, wmask, _, _ = verify_window_inputs(g, dev, dtype, h)
        for key, label, (q_, k_, v_), kw in (
                ("prefill", f"prefill {tuple(q.shape)}, causal float mask "
                 "+ is_causal", (q, k, v),
                 {"attn_mask": causal, "is_causal": True}),
                ("verify", f"verify window {tuple(wq.shape)} x "
                 f"{tuple(wk.shape)}, float mask", (wq, wk, wv),
                 {"attn_mask": wmask})):
            got = fa.flash_attention(q_, k_, v_, **kw)
            ref = fa.flash_attention_reference(q_.float(), k_.float(),
                                               v_.float(), **kw)
            torch.cuda.synchronize()
            per_row = [check_rel("K1", got[r], ref[r], dtype)
                       for r in range(got.shape[0])]
            # the row nearest its own limit, with that limit
            err, tol = max(per_row, key=lambda et: et[0] / et[1])
            ms = time_ms(lambda: fa.flash_attention(q_, k_, v_, **kw))
            plain_ms = time_ms(lambda: fa.flash_attention_reference(
                q_, k_, v_, **kw), 5, 1)
            qt, kt, vt = (x.transpose(1, 2) for x in (q_, k_, v_))
            mask = kw["attn_mask"].to(dtype)
            lib_ms = time_ms(lambda: torch.nn.functional
                             .scaled_dot_product_attention(qt, kt, vt,
                                                           attn_mask=mask))
            seen = visible(q_, k_, kw)
            io = nbytes(q_, got, kw["attn_mask"]) + 2 * int(
                seen.any(1).sum()) * h * d * k_.element_size()
            bms, by = bound(io, 4 * h * d * int(seen.sum()), dtype)
            row = _row(dtype, f"{tag}: {label}", err, tol, ms, plain_ms,
                       lib_ms, bms, by, tp=tp, heads=h)
            _log_row("K1", row)
            rows.append(("K1", row))
            out[f"K1 tp{tp} {key}"] = row
        del q, k, v, wq, wk, wv
        pos_np = np.linspace(0, cap - 1, b).astype(np.int32)
        pos = torch.from_numpy(pos_np).to(dev)
        for kv in ("bf16",) + QUANT_KV:
            name = "K6q" if kv in QUANT_KV else "K6"
            kp, vp, ks, vs = _pools(h, b * maxp + 1, ps, d, kv, g, dev)
            tb = table(b)
            qd = rnd(b, 1, h, d)
            cache = PagedLayerCache(kp, vp, tb, k_scale=ks, v_scale=vs)
            got = att.paged_decode_attention(qd, cache, pos, 1)
            ref = att._paged_decode_reference(qd, cache, pos, 1)
            torch.cuda.synchronize()
            err = max_err(got, ref)
            tol = check(name, err, dtype)
            ms = time_ms(lambda: att.paged_decode_attention(qd, cache, pos,
                                                            1))
            plain_ms = time_ms(lambda: att._paged_decode_reference(
                qd, cache, pos, 1), 5, 1)
            lib_ms = time_ms(_gathered_sdpa(qd, kp, vp, ks, vs, tb, pos, 1,
                                            dtype))
            toks = int((pos_np + 1).sum())
            io = toks * 2 * h * (d * kp.element_size()
                                 + (4 if kv in QUANT_KV else 0)) \
                + nbytes(qd, got, tb, pos)
            bms, by = bound(io, 4 * h * d * toks, dtype)
            row = _row(dtype, f"{tag}: {kv} pools, b=8, positions "
                       "0..1023", err, tol, ms, plain_ms, lib_ms, bms, by,
                       tp=tp, heads=h, kv_dtype=kv)
            _log_row(name, row)
            rows.append((name, row))
            out[f"{name} tp{tp}" + (f" {kv}" if name == "K6q" else "")] = row
            del kp, vp, ks, vs
        nrows = 9
        kp, vp, _, _ = _pools(h, nrows * maxp + 1, ps, d, "bf16", g, dev)
        tb = table(nrows)
        pos_np = np.full((FLAT_T,), cap, np.int32)
        rid_np = np.zeros((FLAT_T,), np.int32)
        pos_np[:8] = np.linspace(0, cap - 1, 8).astype(np.int32)
        rid_np[:8] = np.arange(8)
        pos_np[8:264] = np.arange(512, 768)
        rid_np[8:264] = 8
        pos = torch.from_numpy(pos_np).to(dev)[None]
        rid = torch.from_numpy(rid_np).to(dev)
        qf = rnd(1, FLAT_T, h, d)
        cache = PagedLayerCache(kp, vp, tb, rid, routing={})
        got = att.ragged_paged_attention(qf, cache, pos, 1)
        ref = att._ragged_attention_reference(qf, cache, pos, 1)
        torch.cuda.synchronize()
        err = max_err(got, ref)
        tol = check("K7", err, dtype)
        live = pos_np < cap
        if float(got[0, torch.from_numpy(~live).to(dev)].abs().max()) != 0:
            raise AssertionError(f"K7 {tag}: parked tokens not zero")
        ms = time_ms(lambda: att.ragged_paged_attention(qf, cache, pos, 1))
        plain_ms = time_ms(lambda: att._ragged_attention_reference(
            qf, cache, pos, 1), 5, 1)
        lib_ms = time_ms(_gathered_sdpa(qf[0][:, None], kp, vp, None, None,
                                        tb[rid.long()], pos[0], 1, dtype))
        span = {}
        for p_, r_ in zip(pos_np[live], rid_np[live]):
            span[r_] = max(span.get(r_, 0), int(p_) + 1)
        io = sum(span.values()) * 2 * h * d * kp.element_size() + nbytes(
            qf, got, tb, pos, rid)
        bms, by = bound(io, 4 * h * d * int((pos_np[live] + 1).sum()),
                        dtype)
        row = _row(dtype, f"{tag}: bf16 pools, 8 decode tokens + a 256-token "
                   f"chunk at 512, T={FLAT_T}", err, tol, ms, plain_ms,
                   lib_ms, bms, by, tp=tp, heads=h)
        _log_row("K7", row)
        rows.append(("K7", row))
        out[f"K7 tp{tp}"] = row
        del kp, vp, qf
    return out


def row_chunk_products(dev):
    """Why the overlapped reduction (serving/overlap.py) does not cut the
    consumer's matmuls by rows: for the products of a LLaMA-7B shard at tp
    2 and 4 (q / k / v, gate / up, o, down: (4096 / tp, 4096), (11008 /
    tp, 4096), (4096, 4096 / tp), (4096, 11008 / tp)) in bf16 and fp32, at
    8, 64, 256 and 512 rows, whether the rows of the products of 2 and of
    4 row chunks equal the whole product's bit for bit. A reading, not a
    check. Returns {dtype: [[out, in, rows, chunks, equal], ...]}."""
    from paddle_tpu_torch.parallel import chunk_bounds

    g = torch.Generator(device=dev).manual_seed(15)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        cells = []
        for tp in TP_SHARD_HEADS:
            for n, k in ((4096 // tp, 4096), (11008 // tp, 4096),
                         (4096, 4096 // tp), (4096, 11008 // tp)):
                w = (torch.randn(n, k, generator=g, device=dev)
                     * 0.02).to(dtype)
                for rows in (8, 64, 256, 512):
                    x = torch.randn(rows, k, generator=g,
                                    device=dev).to(dtype)
                    whole = torch.nn.functional.linear(x, w)
                    for chunks in (2, 4):
                        parts = torch.cat([
                            torch.nn.functional.linear(x[lo:hi], w)
                            for lo, hi in chunk_bounds(chunks, rows)])
                        cells.append([n, k, rows, chunks,
                                      bool(torch.equal(parts, whole))])
        out[str(dtype)[6:]] = cells
        log(f"[row_chunk_products] {str(dtype)[6:]}: "
            f"{sum(not c[4] for c in cells)} of {len(cells)} (out, in, "
            "rows, chunks) products moved by a rounding when cut into row "
            f"chunks: {[tuple(c[:4]) for c in cells if not c[4]]}")
    return out


def tp_groups(dev, tp):
    """(label, devices) of the groups a tp-wide engine is served on: the
    one card repeated, and tp distinct cards where the machine has them."""
    groups = [("", [dev] * tp)]
    if torch.cuda.device_count() >= tp:
        groups.append(("_cards", [torch.device("cuda", i)
                                  for i in range(tp)]))
    return groups


def tp_served(model, dev, tag, prompts, kw, counters, need, warm=False):
    """One served run of `prompts` (TP_NEW new tokens each, the last two
    late) on a fresh serve engine with the knobs `kw`; with `warm`, an
    unmeasured engine of the same knobs serves two short requests first.
    The launch counters are zeroed just before and read just after; each
    kernel of `need` must launch. Returns the readings and the streams; no
    engine outlives the call."""
    if warm:
        serve(serve_engine(model, dev, **kw), [p[:40] for p in prompts[:2]],
              1, 9)
        gc.collect()
        torch.cuda.empty_cache()
    engine = serve_engine(model, dev, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters(counters)
    rids, wall = serve(engine, prompts, 2, TP_NEW)
    launches = read_counters(counters)
    stats = engine.stats()
    peak = torch.cuda.max_memory_allocated()
    tokens = stats["tokens_generated"]
    missing = [k for k in need if launches[k] <= 0]
    if stats["num_finished"] != len(prompts) \
            or tokens != TP_NEW * len(prompts) or missing:
        raise AssertionError(f"{tag}: {stats['num_finished']} finished, "
                             f"{tokens} tokens, never launched {missing}")
    tp = stats.get("tp")
    coll = None
    if tp is not None:
        h = engine.metrics.get("serving_tp_collective_seconds", labels={
            "overlap": "on" if tp["overlap"] else "off"})
        coll = dict(count=h.count, mean_s=h.sum / h.count,
                    summary=h.summary())
    res = dict(tp_size=stats["tp_size"], tokens_per_s=tokens / wall,
               wall_s=wall, decode_tokens_per_s=stats["decode_tokens_per_s"],
               peak_bytes=peak, launches=launches,
               pool_bytes=engine.cache.pool_bytes,
               shard_pool_bytes=engine.cache.shard_pool_bytes,
               collective=coll,
               overlap_fraction=None if tp is None else tp[
                   "overlap_fraction"],
               devices=None if tp is None else tp["devices"],
               streams=[engine.output(r) for r in rids])
    log(f"[{tag}] {tokens} tokens in {wall:.3f} s = {tokens / wall:.1f} "
        f"tokens/s; decode {stats['decode_tokens_per_s']:.1f} tokens/s; "
        f"pool {res['pool_bytes'] / 2**30:.3f} GiB, "
        f"{res['shard_pool_bytes'] / 2**30:.3f} GiB a shard; peak memory "
        f"{peak / 2**30:.2f} GiB; launches {launches}"
        + ("" if coll is None else
           f"; serving_tp_collective_seconds mean "
           f"{coll['mean_s'] * 1e6:.1f} us over {coll['count']}; "
           f"overlap_fraction {res['overlap_fraction']}; devices "
           f"{res['devices']}"))
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_serve_tp(model, seed, dev):
    """Tensor-parallel serving of the Serve cell's LLaMA-7B (bf16, the
    Serve engine's knobs): 8 greedy requests of 32-512 prompt tokens,
    TP_NEW new tokens each, two late, at tp 1, 2 and 4 on the one card
    repeated (and on distinct cards where the machine has as many), each
    after a warm-up engine of its knobs; then at tp 2 chunked (256, the
    ragged step), over int8 pools with the int8 all-reduce, and with the
    overlapped reduction (2 chunks). Each tp > 1 stream is held against
    the tp=1 streams by the margin check (a row-parallel sum rounds
    otherwise than the full product in bf16); the overlapped streams must
    equal the serial tp=2 streams. The schedule does not depend on the
    tokens (no eos, fixed budgets), so K1 and K6 must launch exactly tp
    times as often as at tp 1 (one a shard a layer), and K4 once a layer
    norm a device of the group plus the final norm once a forward (as
    often as at tp 1 on one card)."""
    cfg = model.llama.config
    rng = np.random.RandomState(seed + 41)
    lens = rng.randint(32, 513, 8)
    prompts = [rng.randint(0, cfg.vocab_size, (int(n),)) for n in lens]
    counters = serve_counters()
    bf16 = dict(kv_dtype="bf16")
    runs = [("tp1", bf16, ("K1", "K4", "K6"), True)]
    for tp in TP_SHARD_HEADS:
        for suffix, devs in tp_groups(dev, tp):
            runs.append((f"tp{tp}{suffix}",
                         dict(bf16, tp_size=tp, devices=devs),
                         ("K1", "K4", "K6"), True))
            if suffix:
                # across cards the overlap has copies to hide
                runs.append((f"tp{tp}{suffix}_overlap",
                             dict(bf16, tp_size=tp, devices=devs,
                                  tp_overlap=True, tp_overlap_chunks=2),
                             ("K1", "K4", "K6"), False))
    two = dict(tp_size=2, devices=[dev] * 2)
    runs += [("tp2_chunked", dict(bf16, enable_chunked_prefill=True,
                                  prefill_chunk_tokens=256, **two),
              ("K4", "K6", "K7"), False),
             ("tp2_int8_qar", dict(kv_dtype="int8",
                                   tp_quantized_allreduce=True, **two),
              ("K1", "K4", "K6q"), False),
             ("tp2_overlap", dict(bf16, tp_overlap=True,
                                  tp_overlap_chunks=2, **two),
              ("K1", "K4", "K6"), False)]
    out = {}
    for tag, kw, need, warm in runs:
        out[tag] = tp_served(model, dev, f"serve_tp {tag}", prompts, kw,
                             counters, need, warm)
    base = out["tp1"]
    # tp=1 runs 2 norms a layer and the final one a forward
    layers = cfg.num_hidden_layers
    forwards = base["launches"]["K4"] // (2 * layers + 1)
    for tp in TP_SHARD_HEADS:
        for suffix, devs in tp_groups(dev, tp):
            got = out[f"tp{tp}{suffix}"]["launches"]
            # the layers' norms once a device of the group, the final one
            # once on the engine's
            want = dict(K1=tp * base["launches"]["K1"],
                        K6=tp * base["launches"]["K6"],
                        K4=forwards * (2 * layers * len(set(devs)) + 1))
            if any(got[k] != n for k, n in want.items()):
                raise AssertionError(
                    f"serve_tp tp{tp}{suffix}: launches {got}, want {want} "
                    f"(tp1: {base['launches']})")
    for tag in [t for t in out if t.endswith("_overlap")]:
        serial = tag[:-len("_overlap")]
        same = sum(a == b for a, b in zip(out[tag]["streams"],
                                          out[serial]["streams"]))
        if same != len(prompts):
            raise AssertionError(f"serve_tp: {same} of 8 {tag} streams "
                                 f"identical to the serial {serial} streams")
        log(f"[serve_tp] {tag}: 8 of 8 streams identical to {serial}")
    for tag, r in out.items():
        if tag != "tp1":
            kv = "int8" if "int8" in tag else "bf16"
            r["identical_to_tp1"], r["worst_parting_margin"] = \
                hold_divergence(model, r["streams"], base["streams"],
                                lens.tolist(), MARGIN_TOL[kv], dev,
                                f"serve_tp {tag} vs tp1")
    for r in out.values():
        del r["streams"]
    log("[serve_tp] tokens/s on one card: " + ", ".join(
        f"{t} {out[t]['tokens_per_s']:.1f}" for t in
        ["tp1"] + [f"tp{tp}" for tp in TP_SHARD_HEADS]))
    return out


def tp_fp32_model(seed, dev):
    """LLaMA-7B's widths cut to CHECK_LAYERS layers, fp32 weights from the
    seed, on `dev` (no gradients)."""
    import dataclasses

    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = dataclasses.replace(LlamaConfig.llama7b(),
                              num_hidden_layers=CHECK_LAYERS)
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32,
                             seed=seed)
    for p in model.parameters():
        p.requires_grad_(False)
    return model


def tp_fp32_prompts(seed, vocab):
    rng = np.random.RandomState(seed + 43)
    return [rng.randint(0, vocab, (int(n),)).tolist()
            for n in rng.randint(32, 129, 8)]


def phase_serve_tp_fp32(seed, dev):
    """The tp=2 engine at fp32 on 1 layer of full width, without bf16's
    near-ties: its 8 greedy streams (TP_NEW new tokens, two late) on the
    card must be identical to the same TP engine's on the CPU (two CPU
    shards, the plain versions). Then a tp=2 engine with a journal, all 8
    requests up front, is snapshotted after its 8 prefills and two decode
    blocks (10 steps) and restored onto a
    tp=4 engine: every request must finish, its tokens streamed exactly
    once, and the streams are held against the uninterrupted tp=2 run's
    (margin check at fp32; identical ones counted)."""
    from paddle_tpu_torch.serving import RequestJournal, ServingEngine

    t0 = time.perf_counter()
    card = tp_fp32_model(seed, dev)
    cpu = tp_fp32_model(seed, torch.device("cpu"))
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    prompts = tp_fp32_prompts(seed, card.llama.config.vocab_size)
    kw = dict(page_size=16, max_batch_size=8, max_seq_len=1024,
              decode_horizon=8, kv_dtype="fp32", tp_size=2)
    streams = {}
    for where, model, d in (("card", card, dev), ("cpu", cpu, "cpu")):
        eng = ServingEngine(model, device=d, devices=[d] * 2, **kw)
        rids, _ = serve(eng, prompts, 2, TP_NEW)
        streams[where] = [eng.output(r) for r in rids]
        del eng
    del cpu
    gc.collect()
    same = sum(a == b for a, b in zip(streams["card"], streams["cpu"]))
    if same != len(prompts):
        raise AssertionError(f"serve_tp_fp32: {same} of {len(prompts)} "
                             "card streams identical to the CPU's")
    log(f"[serve_tp_fp32] tp=2: {same} of {len(prompts)} greedy streams "
        "identical card against CPU")
    ref_eng = ServingEngine(card, device=dev, devices=[dev] * 2, **kw)
    ref_rids = [ref_eng.add_request(p, max_new_tokens=TP_NEW)
                for p in prompts]
    ref = ref_eng.run()
    ref = [ref[r] for r in ref_rids]
    del ref_eng
    eng = ServingEngine(card, device=dev, devices=[dev] * 2,
                        journal=RequestJournal(), **kw)
    rids = [eng.add_request(p, max_new_tokens=TP_NEW) for p in prompts]
    seen = {r: [] for r in rids}
    done = {r: 0 for r in rids}
    # every prefill and two decode blocks: tokens delivered to every row
    for _ in range(len(prompts) + 2):
        for rid, tok in eng.step():
            seen[rid].append(tok)
    before = sum(len(v) for v in seen.values())
    snap = eng.snapshot()
    journal = eng._journal
    eng.release_pools()
    del eng
    gc.collect()
    kw4 = dict(kw, tp_size=4)
    eng = ServingEngine(card, device=dev, devices=[dev] * 4,
                        journal=journal, **kw4)
    eng.restore(snap)
    for rid, tok, fin in eng.stream():
        seen[rid].append(tok)
        done[rid] += fin
    outs = [eng.output(r) for r in rids]
    for i, rid in enumerate(rids):
        if eng.status(rid) != ("finished", None) or done[rid] != 1 \
                or seen[rid] != outs[i][len(prompts[i]):] \
                or len(seen[rid]) != TP_NEW:
            raise AssertionError(
                f"serve_tp_fp32: request {rid} ended {eng.status(rid)} with "
                f"{len(seen[rid])} tokens streamed and {done[rid]} done "
                "flags: not its output exactly once")
    eng.scheduler.check_consistency()
    journal.check_consistency()
    del eng
    identical, worst = hold_divergence(card, outs, ref,
                                       [len(p) for p in prompts],
                                       MARGIN_TOL["fp32"], dev,
                                       "serve_tp_fp32 tp2 -> tp4 restore")
    del card
    out = dict(card_vs_cpu_identical=same, delivered_before_snapshot=before,
               restored_identical=identical, worst_parting_margin=worst,
               phase_s=time.perf_counter() - t0)
    log(f"[serve_tp_fp32] tp=2 snapshot after {before} tokens restored onto "
        f"tp=4: 8 of 8 requests exactly once, {identical} of 8 streams "
        f"identical to the uninterrupted tp=2 run; {out['phase_s']:.1f} s")
    return out


def phase_cluster_tp(seed, dev):
    """A ServingCluster of 2 replicas of tp=2 (fp32, 1 layer of full width)
    carved from the one card listed 4 times (and from 4 distinct cards
    where the machine has them: replica 1's group then excludes the card
    that holds the model, its embedding and head); replica 1 is killed by
    `device_lost` once each of its requests has 8 tokens delivered, with no
    restart, so it dies and its requests migrate. Every request must
    finish with its streamed tokens its output exactly once, and every
    stream must be identical to the same cluster's run without the kill."""
    from paddle_tpu_torch.serving import FaultInjector, ServingCluster

    t0 = time.perf_counter()
    model = tp_fp32_model(seed, dev)
    prompts = tp_fp32_prompts(seed + 1, model.llama.config.vocab_size)

    def make(replica=None, fault_injector=None, tp_size=1, devices=None):
        return serve_engine(model, dev, kv_dtype="fp32",
                            fault_injector=fault_injector, tp_size=tp_size,
                            devices=devices)

    def run(kill, devices):
        inj = [FaultInjector(), FaultInjector()]
        cl = ServingCluster(make, num_replicas=2, tp_size=2,
                            devices=devices, fault_injectors=inj,
                            placement="round_robin",
                            supervisor_kw=dict(max_restarts=0))
        groups = [r.supervisor.engine._tp.devices for r in cl.replicas]
        rids = [cl.add_request(p, max_new_tokens=TP_NEW) for p in prompts]
        seen = {r: [] for r in rids}
        done = {r: 0 for r in rids}
        armed = not kill
        for rid, tok, fin in cl.stream():
            seen[rid].append(tok)
            done[rid] += fin
            mine = [r for r in cl._records.values() if r.replica == 1]
            if not armed and mine and all(len(r.delivered) >= 8
                                          for r in mine):
                k = inj[1].counts.get("device_lost", 0)
                inj[1].fail_at("device_lost", k)
                armed = True
        outs = [cl.output(r) for r in rids]
        for i, rid in enumerate(rids):
            if cl.status(rid) != ("finished", None) or done[rid] != 1 \
                    or seen[rid] != outs[i][len(prompts[i]):]:
                raise AssertionError(f"cluster_tp: request {rid} not its "
                                     "output exactly once")
        cl.check_consistency()
        st = cl.stats()
        cl.close()
        return outs, st, groups

    layouts = [("one card", [dev] * 4)]
    if torch.cuda.device_count() >= 4:
        layouts.append(("4 cards", [torch.device("cuda", i)
                                    for i in range(4)]))
    out = {}
    for label, devices in layouts:
        ref, _, groups = run(False, devices)
        outs, st, _ = run(True, devices)
        if st["health"].count("dead") != 1 or not st["migrations"]:
            raise AssertionError(f"cluster_tp {label}: health "
                                 f"{st['health']}, {st['migrations']} "
                                 "migrations")
        same = sum(a == b for a, b in zip(outs, ref))
        if same != len(prompts):
            raise AssertionError(f"cluster_tp {label}: {same} of "
                                 f"{len(prompts)} streams identical to the "
                                 "run without the kill")
        out[label] = dict(identical=same, migrations=st["migrations"],
                          migrated_tokens=st["migrated_tokens"],
                          groups=[[str(d) for d in g] for g in groups])
        log(f"[cluster_tp] 2 replicas of tp=2 on {out[label]['groups']}: "
            f"replica 1 killed, {st['migrations']} migrated "
            f"({st['migrated_tokens']} tokens), {same} of {len(prompts)} "
            "streams identical to the run without the kill")
    del model
    out["phase_s"] = time.perf_counter() - t0
    log(f"[cluster_tp] {out['phase_s']:.1f} s")
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
    # a record_function label (the optimizer's "Optimizer.step#...") also
    # appears as a device-side annotation spanning its kernels: keep only
    # names no host event carries, so no kernel is counted twice
    cpu = torch.autograd.DeviceType.CPU
    host_keys = {e.key for e in prof.key_averages() if e.device_type == cpu}
    rows = [(e.key, _device_us(e), e.count) for e in prof.key_averages()
            if _device_us(e) > 0 and e.device_type != cpu
            and e.key not in host_keys]
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


# ------------------------------------------------- the training plane
# ZeRO data parallelism: ERNIE-1.0 base at the Train ERNIE cell's step (a
# global batch of 32 x 512, O1 bf16, dropout 0.1, the fused MLM loss, Adam
# 1e-4) over ZERO_RANKS ranks, each leg ZERO_STEPS = (warm-up, timed) steps
ZERO_RANKS = 4
ZERO_BATCH = (32, 512)
# (1 + 1 since PR 18, 1 + 2 before: two steps still hold every leg's bits
# through an update; the run keeps to its time limit beside the fleet and
# dygraph phases)
ZERO_STEPS = (1, 1)
# the legs' model: ERNIE-1.0 base's widths at ZERO_LAYERS of its 12 layers
# (12 until PR 18; the fleet phase's ZeroTrainStep dp 2 x tp 2 leg too)
ZERO_LAYERS = 6
ZERO_BUCKET = 25 * 2 ** 20
ZERO_LR = 1e-4
# the bf16 leg's loss against the fp32 stage-2 leg's, step by step: bf16
# weights and bf16 dp sums (the documented bounded-error mode)
ZERO_BF16_RTOL = 2e-2
# the recompute cell: ERNIE-1.0 base at batch 32 off and on, then batch
# 64 on (bench.py's "64r"); (warm-up, timed) steps each
RECOMPUTE_BATCHES = ((32, False), (32, True), (64, True))
RECOMPUTE_STEPS = (3, 5)
# GPT-3's recipe (Brown et al. 2020, table 2.1 and appendix B for the 1.3B
# model): AdamW beta 0.9 / 0.95, eps 1e-8, weight decay 0.1, a global-norm
# clip of 1.0, a linear warmup into a cosine decay to 10% of the peak
# 2e-4; the warmup and decay cut to this phase's 13 steps
GPT_O2_LR, GPT_O2_WARMUP, GPT_O2_DECAY = 2e-4, 3, 10
GPT_O2_STEPS = (3, 10)


def gpt3_recipe(model, lr=GPT_O2_LR, warmup=GPT_O2_WARMUP,
                decay=GPT_O2_DECAY):
    """(AdamW with the clip, its schedule) of GPT-3's recipe."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer import lr as plr

    sched = plr.LinearWarmup(
        plr.CosineAnnealingDecay(lr, T_max=decay, eta_min=lr / 10),
        warmup_steps=warmup, start_lr=0.0, end_lr=lr)
    opt = AdamW(learning_rate=sched, beta1=0.9, beta2=0.95, epsilon=1e-8,
                weight_decay=0.1, parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0), multi_precision=True)
    return opt, sched


def plane_kernel_cases(rows, dev):
    """K1-K5 at the training plane's new shapes: a ZeRO rank's ERNIE-base
    batch (8 of the 32) and the recompute cell's batch 64, bf16 attention
    with dropout 0.1 (K2 + K3 through `FlashAttention.backward`), fp32
    LayerNorm (the O1 and O2 type of every norm), each against its plain
    version and timed alone. GPT-3 1.3B under O2 runs K1-K5 at the O1
    phase's shapes and types (gpt_kernel_cases)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import norm

    g = torch.Generator(device=dev).manual_seed(15)
    _, s, h, d = TRAIN_ATTN
    p = TRAIN_DROPOUT
    seed = torch.tensor([1515], dtype=torch.int32, device=dev)
    out = {}
    for label, b in (("zero rank", ZERO_BATCH[0] // ZERO_RANKS),
                     ("64r", 64)):
        dt = torch.bfloat16
        q, k, v, dout = (torch.randn(b, s, h, d, generator=g, device=dev)
                         .to(dt) for _ in range(4))
        o, lse = fa.flash_attention(q, k, v, return_lse=True, dropout_p=p,
                                    seed=seed)
        e1, t1, _ = check_k1(o, lse, q, k, v, dt, dropout_p=p, seed=seed)
        qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
        fa.FlashAttention.apply(qg, kg, vg, None, False, p, seed).backward(
            dout)
        delta = fa.attention_delta(o, dout)
        args = (q, k, v, dout, lse, delta, None, False, p, seed)
        rdq, rdk, rdv = fa.flash_attention_backward_reference(*args)
        torch.cuda.synchronize()
        e2, t2 = check_rel("K2", qg.grad, rdq, dt)
        ek, tk = check_rel("K3", kg.grad, rdk, dt)
        ev, tv = check_rel("K3", vg.grad, rdv, dt)
        e3, t3 = (ek, tk) if ek / tk >= ev / tv else (ev, tv)
        qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_()
                      for x in (q, k, v))
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, dropout_p=p)
        dout_t = dout.transpose(1, 2)
        case = f"{label} ({b}, {s}, {h}, {d}), dropout {p}"
        ops = b * h * d * s * s
        for k_, err, tol, fn, plain, lib, nb, fl in (
                ("K1", e1, t1,
                 lambda: fa.flash_attention(q, k, v, return_lse=True,
                                            dropout_p=p, seed=seed),
                 lambda: fa.flash_attention_reference(
                     q, k, v, return_lse=True, dropout_p=p, seed=seed),
                 lambda: torch.nn.functional.scaled_dot_product_attention(
                     qt.detach(), kt.detach(), vt.detach(), dropout_p=p),
                 nbytes(q, k, v, o, lse), 4 * ops),
                ("K2", e2, t2, lambda: fa.flash_attention_dq(*args),
                 lambda: fa.flash_attention_backward_reference(*args),
                 lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dout_t,
                                             retain_graph=True),
                 nbytes(q, k, v, dout, q, lse, delta), 6 * ops),
                ("K3", e3, t3, lambda: fa.flash_attention_dkv(*args),
                 lambda: fa.flash_attention_backward_reference(*args),
                 lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dout_t,
                                             retain_graph=True),
                 nbytes(q, k, v, dout, k, v, lse, delta), 8 * ops)):
            row = _row(dt, case, err, tol, time_ms(fn),
                       time_ms(plain, 5, 1), time_ms(lib),
                       *bound(nb, fl, dt))
            _log_row(k_, row)
            rows.append((k_, row))
            out[f"{k_} plane {label}"] = row
        del q, k, v, dout, o, qg, kg, vg, lib_out, qt, kt, vt
        n, hd, dt = b * s, 768, torch.float32
        x = (torch.randn(n, hd, generator=g, device=dev) * 2 + 0.3)
        w = 1 + 0.1 * torch.randn(hd, generator=g, device=dev)
        bias = 0.1 * torch.randn(hd, generator=g, device=dev)
        dy = torch.randn(n, hd, generator=g, device=dev)
        y, mu, rs = norm.norm_forward(x, w, bias, 1e-12, True)
        ry, rmu, rrs = norm.norm_forward_reference(x, w, bias, 1e-12, True)
        dx = norm.norm_backward(x, w, dy, mu, rs, True)
        rdx = norm.norm_backward_reference(x, w, dy, mu, rs, True)
        torch.cuda.synchronize()
        e4 = max(max_err(y, ry), max_err(mu, rmu),
                 max_err(rs, rrs) / float(rrs.abs().max()))
        t4 = check("K4", e4, dt)
        e5, t5 = check_rel("K5", dx, rdx, dt)
        tF = torch.nn.functional
        xl = x.detach().requires_grad_()
        yl = tF.layer_norm(xl, (hd,), w, bias, 1e-12)
        case = f"{label} layer ({n}, {hd})"
        for k_, err, tol, fn, plain, lib, nb, fl in (
                ("K4", e4, t4,
                 lambda: norm.norm_forward(x, w, bias, 1e-12, True),
                 lambda: norm.norm_forward_reference(x, w, bias, 1e-12,
                                                     True),
                 lambda: tF.layer_norm(x, (hd,), w, bias, 1e-12),
                 nbytes(x, w, bias, y, mu, rs), 8 * x.numel()),
                ("K5", e5, t5,
                 lambda: norm.norm_backward(x, w, dy, mu, rs, True),
                 lambda: norm.norm_backward_reference(x, w, dy, mu, rs,
                                                      True),
                 lambda: torch.autograd.grad(yl, xl, dy, retain_graph=True),
                 nbytes(x, w, dy, mu, rs, dx), 10 * x.numel())):
            row = _row(dt, case, err, tol, time_ms(fn), time_ms(plain),
                       time_ms(lib), *bound(nb, fl, dt))
            _log_row(k_, row)
            rows.append((k_, row))
            out[f"{k_} plane {label}"] = row
        del x, dy, y, dx, rdx, xl, yl
    return out


def _zero_world(seed, dev):
    """The ERNIE-1.0 base model, the global batch, the generator and the
    O1 loss function a ZeRO rank trains with. `plant[0] = True` makes the
    loss infinite (a planted non-finite gradient)."""
    from torch.func import functional_call

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import ErnieConfig, ErnieForPretraining

    cfg = ErnieConfig.ernie_base()
    cfg.num_hidden_layers = ZERO_LAYERS
    cfg.fused_mlm_loss = True
    model = ErnieForPretraining(cfg, device=dev, seed=seed)
    model.train()
    rng = np.random.RandomState(seed)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, ZERO_BATCH)).to(dev)
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size, ZERO_BATCH)
                              ).to(dev)
    gen = torch.Generator(device=dev)
    plant = [False]

    def loss_fn(params, ids_, labels_):
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            loss, _ = functional_call(model, params, (ids_,), {
                "masked_lm_labels": labels_, "generator": gen})
        return loss * float("inf") if plant[0] else loss

    return cfg, model, (ids, labels), gen, plant, loss_fn


class deterministic_library_ops:
    """PyTorch's deterministic algorithms for the library ops of a step
    (warn_only: an op without one warns and runs): bit parity between two
    runs of the same step needs them. The default CUDA embedding backward
    sums a row that many tokens share (ERNIE's token type 0, all 16384
    tokens of a step) in an order that changes from run to run: on an
    H100 the token-type gradient moved by ~2e-8 between two identical
    steps, every other gradient equal. Uninitialized memory is left as it
    is (every kernel of the port writes its outputs in full)."""

    def __enter__(self):
        import torch.utils.deterministic as det

        self._saved = (torch.are_deterministic_algorithms_enabled(),
                       torch.is_deterministic_algorithms_warn_only_enabled(),
                       det.fill_uninitialized_memory)
        torch.use_deterministic_algorithms(True, warn_only=True)
        det.fill_uninitialized_memory = False
        return self

    def __exit__(self, *exc):
        import torch.utils.deterministic as det

        on, warn, fill = self._saved
        torch.use_deterministic_algorithms(on, warn_only=warn)
        det.fill_uninitialized_memory = fill
        return False


def _first_difference(a, b):
    """The first parameter whose bits differ between two dicts, or None."""
    for k in a:
        if not torch.equal(a[k], b[k]):
            return k
    return None


def determinism_probe(dev, b=ZERO_BATCH[0] // ZERO_RANKS):
    """Each training kernel (and the library calls of the step) launched
    twice on the same inputs at a ZeRO rank's shapes: the names of those
    whose two results differ in any bit."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import norm

    g = torch.Generator(device=dev).manual_seed(16)
    _, s, h, d = TRAIN_ATTN
    seed = torch.tensor([99], dtype=torch.int32, device=dev)
    q, k, v, dout = (torch.randn(b, s, h, d, generator=g, device=dev)
                     .bfloat16() for _ in range(4))
    o, lse = fa.flash_attention(q, k, v, return_lse=True, dropout_p=0.1,
                                seed=seed)
    delta = fa.attention_delta(o, dout)
    args = (q, k, v, dout, lse, delta, None, False, 0.1, seed)
    x = torch.randn(b * s, 768, generator=g, device=dev)
    w, bias = torch.ones(768, device=dev), torch.zeros(768, device=dev)
    _, mu, rs = norm.norm_forward(x, w, bias, 1e-12, True)
    emb = torch.randn(18000, 768, generator=g, device=dev,
                      requires_grad=True)
    ids = torch.randint(0, 18000, (b, s), generator=g, device=dev)
    calls = {
        "K1": lambda: fa.flash_attention(q, k, v, return_lse=True,
                                         dropout_p=0.1, seed=seed),
        "K2": lambda: fa.flash_attention_dq(*args),
        "K3": lambda: fa.flash_attention_dkv(*args),
        "K4": lambda: norm.norm_forward(x, w, bias, 1e-12, True),
        "K5": lambda: norm.norm_backward(x, w, x, mu, rs, True),
        "matmul": lambda: x @ x[:768].T,
        "embedding backward": lambda: torch.autograd.grad(
            torch.nn.functional.embedding(ids, emb).sum(), emb),
    }
    differ = []
    for name, fn in calls.items():
        a, b_ = fn(), fn()
        a = a if isinstance(a, (tuple, list)) else (a,)
        b_ = b_ if isinstance(b_, (tuple, list)) else (b_,)
        if not all(torch.equal(x_, y_) for x_, y_ in zip(a, b_)):
            differ.append(name)
    return differ


def zero_world_rank(seed, ckpt):
    """The body of each rank of phase_train_zero (run by
    `distributed.spawn`): every ZeRO leg of ERNIE-1.0 base at dp =
    ZERO_RANKS; writes the dp-4 checkpoint to `ckpt` (rank 0). Returns this
    rank's readings; bit parity is judged here, against this rank's own
    stage-0 parameters."""
    from paddle_tpu_torch import distributed as ptd
    from paddle_tpu_torch.observability import training as T
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.parallel import zero as Z

    g = ptd.get_group()
    dev = g.device
    deterministic_library_ops().__enter__()     # this rank's process only
    cfg, model, batch, gen, plant, loss_fn = _zero_world(seed, dev)
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    counters = train_counters()
    # rank r works on cuda:(r % count): the cards the world spans
    count = torch.cuda.device_count()
    cards = len({r % count for r in range(g.nranks)})
    out = {"backend": g.backend, "device": str(dev), "legs": {}}
    ref = {}

    def leg(name, stage, params=None, host=None, t0=1, keep=False, **kw):
        gen.manual_seed(seed * 1000 + g.rank)      # from (seed, rank)
        opt = Adam(learning_rate=ZERO_LR, parameters=model.parameters())
        step = Z.zero_train_step(model, opt, loss_fn, stage=stage, group=g,
                                 **kw)
        p, st = step.init_state(init if params is None else params)
        if host is not None:
            st = step.load_optimizer_state(host)
        warm, timed = ZERO_STEPS
        losses, t = [], t0
        for _ in range(warm):
            loss, p, st = step(p, st, batch, ZERO_LR, t)
            losses.append(loss)
            t += 1
        torch.cuda.synchronize(dev)
        ptd.barrier(g)
        staged = g.staged_bytes
        for fn in counters.values():
            fn.launches = 0
        t_start = time.perf_counter()
        for _ in range(timed):
            loss, p, st = step(p, st, batch, ZERO_LR, t)
            losses.append(loss)
            t += 1
        torch.cuda.synchronize(dev)
        ptd.barrier(g)
        wall = time.perf_counter() - t_start
        launches = {k: fn.launches for k, fn in counters.items()}
        if any(n <= 0 for n in launches.values()):
            raise AssertionError(f"ZeRO leg {name}: a kernel of the path "
                                 f"did not launch: {launches}")
        tokens = ZERO_BATCH[0] * ZERO_BATCH[1]
        rec = dict(stage=stage, losses=[float(x) for x in losses],
                   step_ms=wall / timed * 1e3, wall_s=wall,
                   tokens_per_s_chip=tokens * timed / wall / cards,
                   launches=launches,
                   staged_bytes_per_step=(g.staged_bytes - staged) / timed,
                   opt_bytes=step.optimizer_state_bytes_per_chip(st),
                   param_bytes=step.bytes_per_chip(p),
                   knobs={k: v for k, v in kw.items()
                          if k != "telemetry"})
        if ref:
            rec["differs_from_stage0"] = _first_difference(ref, p)
        # the construction-time probes of this leg's engine (collectives
        # over the group: every rank runs them together)
        rec["collective_s"] = step.collective_seconds(samples=3, rows=1,
                                                      width=2 ** 20)
        if step._buckets:
            rec["buckets"] = len(step._buckets)
            rec["overlap_fraction"] = step.measure_overlap_fraction(
                samples=1, best_of=2)
        out["legs"][name] = rec
        return (rec, p, st, step) if keep else rec

    rec, p0, _, _ = leg("stage0", 0, keep=True)
    ref.update(p0)
    again = leg("stage0 again", 0)
    if again["differs_from_stage0"] is not None:
        out["not_deterministic"] = determinism_probe(dev)
        return out
    for stage in (1, 2):
        leg(f"stage{stage}", stage)
    _, p2, st2, s2 = leg("stage2 bucket", 2, keep=True,
                         bucket_bytes=ZERO_BUCKET)
    host = s2.save_optimizer_state(st2)
    if g.rank == 0:
        torch.save({"params": {k: v.cpu() for k, v in p2.items()},
                    "state": host, "t": sum(ZERO_STEPS) + 1}, ckpt)
    del host
    rec, _, _, s3 = leg("stage2 overlap", 2, keep=True,
                        bucket_bytes=ZERO_BUCKET, overlap=True)
    rec["comm_s"] = s3.comm_seconds(samples=2, elems=2 ** 20, best_of=2)
    del s3
    leg("stage2 accum2", 2, grad_accum=2)
    ref.clear()
    rec, p16, st16, s16 = leg("stage2 bf16", 2, keep=True,
                              param_dtype="bf16")
    scale = float(st16[Z._SCALER_KEY]["scale"])
    plant[0] = True
    _, p_after, st_after = s16(p16, st16, batch, ZERO_LR, sum(ZERO_STEPS) + 1)
    plant[0] = False
    rec["planted"] = dict(
        params_kept=_first_difference(p16, p_after) is None,
        state_kept=all(torch.equal(st16[k][s], st_after[k][s])
                       for k in st16 if k != Z._SCALER_KEY
                       for s in st16[k]),
        scale_before=scale,
        scale_after=float(st_after[Z._SCALER_KEY]["scale"]))
    del p16, st16, s16, p_after, st_after
    # telemetry off / on (A B; A B B A until PR 18); on must equal off
    for i, on in enumerate((False, True)):
        name = f"telemetry {'on' if on else 'off'} {'AB'[i in (1, 2)]}{i}"
        kw = {}
        tele = None
        if on:
            tele = T.TrainingTelemetry(tokens_per_step=ZERO_BATCH[0]
                                       * ZERO_BATCH[1], enable_recorder=False)
            kw["telemetry"] = tele
        rec, p, _, _ = leg(name, 2, keep=True, **kw)
        if i == 0:
            ref.update(p)
        else:
            rec["differs_from_off"] = _first_difference(ref, p)
        if tele is not None:
            s = tele.summary()
            rec["host_syncs"] = s["host_syncs"]
            rec["last"] = s["last"]
    return out


def zero_restore_rank(seed, ckpt):
    """The body of each rank of the second world (dp 2): the dp-4
    checkpoint restored and trained on at stage 2 and at stage 0, which
    must stay in lockstep bit for bit."""
    from paddle_tpu_torch import distributed as ptd
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.parallel import zero as Z

    g = ptd.get_group()
    dev = g.device
    deterministic_library_ops().__enter__()     # this rank's process only
    cfg, model, batch, gen, _, loss_fn = _zero_world(seed, dev)
    saved = torch.load(ckpt)
    out = {"device": str(dev), "legs": {}}
    results = {}
    counters = train_counters()
    for stage in (2, 0):
        gen.manual_seed(seed * 1000 + g.rank)
        opt = Adam(learning_rate=ZERO_LR, parameters=model.parameters())
        step = Z.zero_train_step(model, opt, loss_fn, stage=stage, group=g)
        p, _ = step.init_state({k: v.to(dev) for k, v in
                                saved["params"].items()})
        st = step.load_optimizer_state(saved["state"])
        for fn in counters.values():
            fn.launches = 0
        losses = []
        for t in range(saved["t"], saved["t"] + sum(ZERO_STEPS)):
            loss, p, st = step(p, st, batch, ZERO_LR, t)
            losses.append(float(loss))
        launches = {k: fn.launches for k, fn in counters.items()}
        if any(n <= 0 for n in launches.values()):
            raise AssertionError(f"restored stage {stage}: a kernel did not "
                                 f"launch: {launches}")
        results[stage] = p
        out["legs"][f"restored stage{stage}"] = dict(
            losses=losses, launches=launches,
            opt_bytes=step.optimizer_state_bytes_per_chip(st))
    out["differs"] = _first_difference(results[0], results[2])
    return out


def phase_train_zero(seed, dev):
    """ZeRO data-parallel ERNIE-1.0 base: one world of ZERO_RANKS ranks
    (`distributed.spawn`, spawned once; gloo on one card, staging through
    pinned host memory, NCCL with a card a rank) runs the legs of
    `zero_world_rank`; a second world of 2 ranks restores the dp-4
    checkpoint (zero_restore_rank). Stage 1 / 2 / bucketed / overlapped
    must equal stage 0 bit for bit (after stage 0 equals itself run to
    run), optimizer bytes a rank must be a quarter of stage 0's up to each
    leaf's padding, the bf16 leg must skip the planted step and halve its
    scale, telemetry on must equal off. Any rank's failure raises."""
    import tempfile

    from paddle_tpu_torch import distributed as ptd

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="ptt_zero_") as tmp:
        ckpt = os.path.join(tmp, "zero_dp4.pt")
        ranks = ptd.spawn(zero_world_rank, (seed, ckpt), nprocs=ZERO_RANKS,
                          timeout=900)
        r0 = ranks[0]
        if "not_deterministic" in r0:
            raise AssertionError(
                "ZeRO stage 0 run twice gave other bits: not run-to-run "
                f"deterministic on this card: {r0['not_deterministic']} "
                f"(first differing parameter "
                f"{r0['legs']['stage0 again']['differs_from_stage0']})")
        world2 = ptd.spawn(zero_restore_rank, (seed, ckpt), nprocs=2,
                           timeout=600)
    wall = time.perf_counter() - t0
    shared = len({r["device"] for r in ranks}) < ZERO_RANKS
    backend = r0["backend"]
    legs = r0["legs"]
    opt0 = legs["stage0"]["opt_bytes"]
    log(f"[train_zero] ERNIE-1.0 base's widths at {ZERO_LAYERS} layers, "
        f"global batch {ZERO_BATCH[0]} x "
        f"{ZERO_BATCH[1]}, O1 bf16, dropout 0.1, fused MLM loss, Adam "
        f"{ZERO_LR}, dp {ZERO_RANKS} on {[r['device'] for r in ranks]} over "
        f"{backend} ({'ranks share the card' if shared else 'a card a rank'})"
        f"; each leg {ZERO_STEPS[0]} + {ZERO_STEPS[1]} steps; {wall:.1f} s "
        "with the restore world")
    fails = []
    for name, rec in legs.items():
        diff = rec.get("differs_from_stage0", rec.get("differs_from_off"))
        extra = (f"; collective probe (4 MiB all-reduce) "
                 f"{min(rec['collective_s']) * 1e3:.2f} ms")
        if "comm_s" in rec:
            extra += (f", reduce-scatter "
                      f"{rec['comm_s']['reduce_scatter'] * 1e3:.2f} ms, "
                      f"all-gather {rec['comm_s']['all_gather'] * 1e3:.2f} "
                      "ms (4 MiB)")
        if "overlap_fraction" in rec:
            extra += (f"; {rec['buckets']} buckets, overlap fraction "
                      f"{rec['overlap_fraction']:.3f}")
        if "host_syncs" in rec:
            extra += f"; host drains {rec['host_syncs']}"
        log(f"[train_zero] {name}: {rec['tokens_per_s_chip']:.1f} tokens/s/"
            f"chip, step {rec['step_ms']:.1f} ms, optimizer "
            f"{rec['opt_bytes'] / 2**20:.1f} MiB / parameters "
            f"{rec['param_bytes'] / 2**20:.1f} MiB a rank, staged "
            f"{rec['staged_bytes_per_step'] / 2**20:.1f} MiB a step a rank, "
            f"launches {rec['launches']}, loss "
            + ", ".join(f"{x:.5f}" for x in rec["losses"])
            + (f"; bits differ from the reference from {diff}"
               if diff is not None else "") + extra)
        if diff is not None and "bf16" not in name and "accum" not in name:
            fails.append(f"{name} differs from its reference at {diff}")
        if not all(np.isfinite(rec["losses"])):
            fails.append(f"{name}: non-finite loss")
    for stage in (1, 2):
        got = legs[f"stage{stage}"]["opt_bytes"]
        # a quarter of stage 0's, up to each leaf's padding to 4 x chunk
        if not opt0 / ZERO_RANKS <= got <= opt0 / ZERO_RANKS * 1.001:
            fails.append(f"stage {stage} optimizer bytes {got} vs stage 0 "
                         f"{opt0} / {ZERO_RANKS}")
    b16 = legs["stage2 bf16"]
    ref32 = legs["stage2"]["losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(b16["losses"], ref32))
    pl = b16["planted"]
    log(f"[train_zero] bf16 leg: loss within {rel:.3g} of fp32 stage 2 (tol "
        f"{ZERO_BF16_RTOL}); planted non-finite step: parameters kept "
        f"{pl['params_kept']}, state kept {pl['state_kept']}, scale "
        f"{pl['scale_before']} -> {pl['scale_after']}")
    if not rel <= ZERO_BF16_RTOL:
        fails.append(f"bf16 loss {rel} from fp32")
    if not (pl["params_kept"] and pl["state_kept"]
            and pl["scale_after"] == pl["scale_before"] / 2):
        fails.append(f"the planted non-finite step was not skipped: {pl}")
    for name, rec in legs.items():
        if "host_syncs" in rec and rec["host_syncs"] != sum(ZERO_STEPS):
            fails.append(f"{name}: {rec['host_syncs']} host drains")
    w2 = world2[0]
    for name, rec in w2["legs"].items():
        log(f"[train_zero] dp-4 checkpoint restored at dp 2, {name}: loss "
            + ", ".join(f"{x:.5f}" for x in rec["losses"])
            + f"; optimizer {rec['opt_bytes'] / 2**20:.1f} MiB a rank; "
            f"launches {rec['launches']}")
    log(f"[train_zero] restored stage 2 vs stage 0 at dp 2: "
        f"{'bit-identical' if w2['differs'] is None else 'differ at ' + w2['differs']}")
    if w2["differs"] is not None:
        fails.append(f"restored dp 2 stage 2 differs from stage 0 at "
                     f"{w2['differs']}")
    if fails:
        raise AssertionError("train_zero: " + "; ".join(fails))
    launches = {k: sum(r["legs"][n]["launches"][k] for r in ranks
                       for n in r["legs"])
                + sum(r["legs"][n]["launches"][k] for r in world2
                      for n in r["legs"])
                for k in TRAIN_LAUNCHES}
    return dict(backend=backend, shared_card=shared, wall_s=wall,
                legs=legs, per_rank=[r["legs"] for r in ranks],
                restore=[r["legs"] for r in world2],
                launches=launches)


def recompute_grads(model, ids, labels, dev, seed):
    """One training forward / backward; (loss, {name: grad})."""
    model.zero_grad(set_to_none=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    from paddle_tpu_torch import amp

    with amp.auto_cast(level="O1", dtype="bfloat16"):
        loss, _ = model(ids, masked_lm_labels=labels, generator=gen)
    loss.backward()
    return loss.detach(), {n: p.grad.detach().clone()
                           for n, p in model.named_parameters()
                           if p.grad is not None}


def phase_recompute(seed, dev, profile=False, out_dir=None):
    """ERNIE-1.0 base with every encoder layer recomputed: one O1 step with
    recompute on against off from the same weights and generator, under
    `deterministic_library_ops` (the loss and every gradient bit for bit),
    then the train step at batch 32 off and on and at batch 64 on, with
    PyTorch's default algorithms as in the Train ERNIE cell,
    RECOMPUTE_STEPS each: tokens/s/chip, MFU, peak memory and launches (K1
    and K4 replay in the backward)."""
    from paddle_tpu_torch.models import ErnieConfig, ErnieForPretraining
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.training import make_train_step

    cfg = ErnieConfig.ernie_base()
    cfg.fused_mlm_loss = True
    model = ErnieForPretraining(cfg, device=dev, seed=seed)
    model.train()
    rng = np.random.RandomState(seed)
    data = {b: tuple(torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                                  (b, 512))).to(dev)
                     for _ in range(2))
            for b in sorted({b for b, _ in RECOMPUTE_BATCHES})}
    b0 = RECOMPUTE_BATCHES[0][0]
    ids, labels = data[b0]
    counters = train_counters()
    got = {}
    with deterministic_library_ops():
        for on in (False, True):
            model.config.recompute = on
            for fn in counters.values():
                fn.launches = 0
            got[on] = recompute_grads(model, ids, labels, dev, seed) + (
                {k: fn.launches for k, fn in counters.items()},)
    (l0, g0, n0), (l1, g1, n1) = got[False], got[True]
    same = torch.equal(l0, l1) and all(torch.equal(g0[k], g1[k]) for k in g0)
    layers = cfg.num_hidden_layers
    want = dict(n0, K1=2 * n0["K1"], K4=n0["K4"] + 2 * layers)
    log(f"[recompute] one O1 step, recompute on vs off: loss {float(l0)!r} "
        f"/ {float(l1)!r}, loss and every gradient "
        f"{'bit-identical' if same else 'DIFFER'}; launches off {n0}, on "
        f"{n1}")
    if not same:
        bad = next(k for k in g0 if not torch.equal(g0[k], g1[k]))
        raise AssertionError(f"recompute on != off: first gradient {bad}, "
                             f"max |diff| {max_err(g0[bad], g1[bad])}")
    if n1 != want:
        raise AssertionError(f"recompute launches {n1} != {want}")
    del g0, g1
    model.zero_grad(set_to_none=True)
    out = {"same_bits": same, "launches_one_step": {"off": n0, "on": n1}}
    fpt = flops_per_token(model, cfg, 512)
    warm, timed = RECOMPUTE_STEPS
    for b, on in RECOMPUTE_BATCHES:
        model.config.recompute = on
        opt = Adam(learning_rate=1e-4, parameters=model.parameters())
        step = make_train_step(model, opt)
        ids, labels = data[b]
        gen = torch.Generator(device=dev).manual_seed(seed)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for i in range(warm):
            torch.cuda.set_sync_debug_mode("error" if i == warm - 1 else 0)
            try:
                step(ids, labels, gen)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        losses = []
        t0 = time.perf_counter()
        for _ in range(timed):
            losses.append(step(ids, labels, gen))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = {k: fn.launches for k, fn in counters.items()}
        lv = [float(x) for x in losses]
        tps = b * 512 * timed / wall
        mfu = tps * fpt / PEAK_FLOPS[torch.bfloat16]
        tag = f"batch {b}{' recompute' if on else ''}"
        log(f"[recompute] {tag}: {tps:.1f} tokens/s/chip, step "
            f"{wall / timed * 1e3:.2f} ms, MFU {mfu:.4f} (model FLOPs, "
            f"{fpt / 1e6:.1f} MFLOP/token), peak memory "
            f"{peak / 2**30:.2f} GiB, launches in {timed} steps {launches}, "
            "loss " + ", ".join(f"{x:.4f}" for x in lv))
        if not all(np.isfinite(lv)):
            raise AssertionError(f"recompute {tag}: non-finite loss {lv}")
        if any(n <= 0 for n in launches.values()):
            raise AssertionError(f"recompute {tag}: launches {launches}")
        out[tag] = dict(tokens_per_s=tps, step_ms=wall / timed * 1e3,
                        mfu=mfu, peak_bytes=peak, launches=launches,
                        losses=lv)
        if profile and on and b == b0:
            out["profile"] = profile_window(
                "recompute_step", lambda: step(ids, labels, gen), out_dir)
        del opt, step
    if not out[f"batch {b0} recompute"]["peak_bytes"] < out[
            f"batch {b0}"]["peak_bytes"]:
        raise AssertionError("recompute did not lower the peak memory")
    runs = [out[f"batch {b}{' recompute' if on else ''}"]
            for b, on in RECOMPUTE_BATCHES]
    out["launches"] = {k: n0[k] + n1[k] + sum(r["launches"][k] for r in runs)
                       for k in TRAIN_LAUNCHES}
    return out


def phase_train_gpt_o2(seed, dev, o1, profile=False, out_dir=None):
    """GPT-3 1.3B at 8 x 2048 under O2 with GPT-3's recipe: `decorate`
    (bf16 parameters, fp32 masters), AdamW (0.9, 0.95, 1e-8, decay 0.1),
    the global-norm clip 1.0, warmup into cosine, a GradScaler, through
    make_causal_lm_train_step(level="O2"): GPT_O2_STEPS (warm-up, timed)
    steps; tokens/s/chip, MFU and peak memory beside the O1 phase's
    (`o1`). Then, at full width with 2 layers in fp32, three AdamW + clip
    + schedule updates on the card against the CPU's, both fed the CPU's
    gradients."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.training import make_causal_lm_train_step

    cfg = GPTConfig.gpt3_1p3b()
    cfg.fused_lm_loss = True
    batch, seq = GPT_ATTN[0], GPT_ATTN[1]
    held = torch.cuda.memory_allocated()
    model = GPTForCausalLM(cfg, device=dev, seed=seed)
    opt, sched = gpt3_recipe(model)
    model, opt = amp.decorate(model, opt, level="O2")
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 15)
    step = make_causal_lm_train_step(model, opt, scaler=scaler, level="O2")
    n_params = sum(p.numel() for p in model.parameters())
    ids = torch.from_numpy(np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (batch, seq))).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    warm, timed = GPT_O2_STEPS
    counters = train_counters()
    torch.cuda.reset_peak_memory_stats()
    losses, lrs = [], []
    t0 = time.perf_counter()
    for _ in range(warm):
        lrs.append(opt.get_lr())
        losses.append(step(ids, ids, gen))
        sched.step()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    for _ in range(timed):
        lrs.append(opt.get_lr())
        losses.append(step(ids, ids, gen))
        sched.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    lv = [float(x) for x in losses]
    tps = batch * seq * timed / wall
    fpt = flops_per_token(model, cfg, seq)
    mfu = tps * fpt / PEAK_FLOPS[torch.bfloat16]
    masters = sum(st["master_weight"].numel() for st in opt.state.values())
    log(f"[train_gpt_o2] GPT-3 1.3B ({n_params / 1e9:.4f} B params, bf16 "
        f"with {masters / 1e9:.4f} B fp32 master weights), batch {batch} x "
        f"seq {seq}, O2, AdamW(0.9, 0.95, 1e-8, decay 0.1), global-norm "
        f"clip 1.0, warmup {GPT_O2_WARMUP} into cosine over {GPT_O2_DECAY} "
        f"(peak {GPT_O2_LR}), GradScaler (scale now "
        f"{scaler.get_loss_scaling()}); warm-up {warm} steps {warm_s:.2f} s; "
        f"{timed} timed steps {wall:.3f} s: {tps:.1f} tokens/s/chip (O1 "
        f"{o1['tokens_per_s']:.1f}), step {wall / timed * 1e3:.2f} ms (O1 "
        f"{o1['step_ms']:.2f}), MFU {mfu:.4f} (O1 {o1['mfu']:.4f}), peak "
        f"memory {peak / 2**30:.2f} GiB (O1 {o1['peak_bytes'] / 2**30:.2f}; "
        f"{held / 2**30:.2f} GiB held before the phase)")
    log("[train_gpt_o2] lr by step: " + ", ".join(f"{x:.3g}" for x in lrs))
    log("[train_gpt_o2] loss by step: " + ", ".join(f"{x:.4f}" for x in lv))
    log(f"[train_gpt_o2] launches in the {timed} timed steps: {launches}")
    if not all(np.isfinite(lv)):
        raise AssertionError(f"non-finite O2 loss: {lv}")
    if not lv[-1] < lv[0]:
        raise AssertionError(f"O2 loss did not fall: {lv}")
    expected = gpt_launches(cfg.num_hidden_layers)
    wrong = {k: n for k, n in launches.items() if n != expected[k] * timed}
    if wrong:
        raise AssertionError(f"O2 launches {wrong} (over {timed} steps) != "
                             f"{expected} a step")
    out = dict(launches=launches, tokens_per_s=tps,
               step_ms=wall / timed * 1e3, mfu=mfu, peak_bytes=peak,
               held_bytes=held, losses=lv, lrs=lrs, n_params=n_params,
               loss_scale=scaler.get_loss_scaling())
    if profile:
        out["profile"] = profile_window(
            "train_gpt_o2_step", lambda: step(ids, ids, gen), out_dir)
    del model, opt, step, scaler
    gc.collect()
    torch.cuda.empty_cache()
    out["recipe_check"] = gpt3_recipe_card_vs_cpu(seed, dev)
    return out


def gpt3_recipe_card_vs_cpu(seed, dev, updates=3):
    """GPT-3 1.3B's widths at 2 layers, fp32, dropout 0, batch 2 x 256: the
    loss and every gradient card against CPU (step_card_vs_cpu), then
    `updates` AdamW + clip + schedule updates of each, both fed the CPU's
    gradients, the parameters within ADAM_ATOL."""
    import dataclasses

    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    cfg = GPTConfig.gpt3_1p3b()
    cfg.num_hidden_layers = 2
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    cfg.fused_lm_loss = True
    card = GPTForCausalLM(cfg, device=dev, seed=seed)
    cpu = GPTForCausalLM(dataclasses.replace(cfg), device="cpu", seed=seed)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    ids = torch.from_numpy(np.random.RandomState(seed + 4).randint(
        0, cfg.vocab_size, (2, 256)))
    out = step_card_vs_cpu("GPT 2-layer, for the recipe", card, cpu, ids,
                           ids, dev)
    # the recipe's peak rate, reached at the first update; the clip acts
    # (the global norm at init is above 1.0) and so does the decay
    recipe = [gpt3_recipe(m, warmup=1, decay=updates) for m in (card, cpu)]
    for _ in range(updates):
        with torch.no_grad():
            for pc, pp in zip(card.parameters(), cpu.parameters()):
                pc.grad = pp.grad.to(dev)
        for opt, sched in recipe:
            opt.step()
            sched.step()
    err = max(max_err(pc.cpu(), pp) for pc, pp in
              zip(card.parameters(), cpu.parameters()))
    log(f"[train_gpt_o2] 2-layer fp32: {updates} AdamW + global-norm clip + "
        f"warmup / cosine updates card vs CPU (same gradients): parameters "
        f"within {err:.3g} (tol {ADAM_ATOL})")
    if not err <= ADAM_ATOL:
        raise AssertionError(f"recipe update max abs error {err}")
    out["recipe_max_abs_err"] = err
    return out


# ------------------------------------------------------- the fleet cell
# GPT-3 1.3B at full width over FLEET_RANKS ranks: pp 2 x mp 2 x sharding 1,
# the reference dry run's `_factor_axes(4)` (__graft_entry__.py:43-51);
# global batch 8 x 2048 in FLEET_ACCUM micro-batches of 2 (a rank's K1-K3
# at FLEET_ATTN: 16 / mp heads of 128), O1 bf16, Adam FLEET_LR
FLEET_RANKS = 4
FLEET_BATCH = (8, 2048)
FLEET_ACCUM = 4
FLEET_ATTN = (2, 2048, 8, 128)
FLEET_LR = 1e-4
FLEET_STEPS = 2
# the pp 2 x mp 2 bf16 steps against the single-rank bf16 step at dropout
# 0: both round every product's output to bf16, but the mp split cuts the
# row-parallel products' sums in two and gathers the head in parts, so
# the loss and the global gradient norm move by bf16 roundings
FLEET_LOSS_RTOL, FLEET_NORM_RTOL = 5e-3, 2e-2
# the fp32 pp-only and interleaved legs, and the GroupSharded leg, at full
# width and cut depth: every rank holds its copy of the single-rank
# reference's work (the GroupSharded leg's stage 0 keeps four whole
# replicas with Adam state on the one card)
FLEET_PP_LAYERS = 2
FLEET_ZERO3_LAYERS = 2          # 4 until PR 18
# ZeroTrainStep at dp 2 x tp 2 on ERNIE-1.0 base (fp32, dropout 0, SGD so
# that an update is its gradient times lr): each parameter's update within
# this relative L2 error of tp 1's (a LayerNorm weight's gradient is a sum
# over the 16384 tokens whose terms cancel, so the reordered tp sums move
# it by up to ~1e-4 of itself: 9.25e-5 on an H100), the losses within
# FLEET_TP_LOSS_RTOL
FLEET_TP_LR = 0.1
FLEET_TP_UPDATE_RTOL = 1e-3
FLEET_TP_LOSS_RTOL = 1e-5


def fleet_kernel_cases(rows, dev):
    """K1, K2, K3 at a fleet rank's micro-batch (FLEET_ATTN, bf16, causal,
    dropout 0.1) and K4 / K5 in LayerNorm mode at its 2 x 2048 rows of
    GPT-3 1.3B's width (fp32, O1's type), against their plain versions."""
    main = gpt_attention_cases(rows, dev, FLEET_ATTN, fp32=False,
                               key="fleet")
    main.update(gpt_norm_cases(
        rows, dev, ((torch.float32, FLEET_ATTN[0] * FLEET_ATTN[1], True),),
        key="fleet"))
    main["K4 fleet"] = main.pop("K4 fleet float32")
    return main


def dp_kernel_cases(rows, dev):
    """The train_dp phase's kernel forms, against their plain versions:
    K1, K2, K3 at a DataParallel rank's ERNIE-1.0 base micro-batch (8 of
    DP_BATCH's 32, bf16, no mask, dropout 0: its own sm90 instances) and
    at an Engine rank's GPT-3 1.3B block (ENGINE_BATCH's rows over dp 2,
    heads over mp 2: fp32, causal, dropout 0), and K4 / K5 in LayerNorm
    mode at the Engine rank's rows (fp32). ERNIE's norms at the dp rank's
    4096 x 768 fp32 rows are plane_kernel_cases' zero-rank case."""
    dp_b = DP_BATCH[0] // DP_RANKS
    main = gpt_attention_cases(
        rows, dev, (dp_b, DP_BATCH[1]) + TRAIN_ATTN[2:], key="dp",
        causal=False, p=0.0, forms=((torch.bfloat16, dp_b),),
        label="ERNIE dp rank ")
    eng_b = ENGINE_BATCH[0] // 2
    main.update(gpt_attention_cases(
        rows, dev, (eng_b, ENGINE_BATCH[1], GPT_ATTN[2] // 2, GPT_ATTN[3]),
        key="engine", p=0.0, forms=((torch.float32, eng_b),),
        label="GPT Engine rank "))
    main.update(gpt_norm_cases(
        rows, dev, ((torch.float32, eng_b * ENGINE_BATCH[1], True),),
        key="engine"))
    main["K4 engine"] = main.pop("K4 engine float32")
    return main


# ------------------------------------------------- the dygraph surface
# ERNIE-1.0 base's widths (bench.py:1146: vocab 18000, 12 layers, hidden
# 768, 12 heads, FFN 3072, 512 positions, 2 token types) as a plain
# Paddle dygraph network: three nn.Embedding, nn.LayerNorm(eps 1e-12),
# nn.Dropout, a post-LN nn.TransformerEncoder of GELU layers and an
# nn.Linear vocabulary head, trained at the Train ERNIE cell's batch
DYG_VOCAB, DYG_LAYERS, DYG_HIDDEN, DYG_HEADS, DYG_FFN = 18000, 12, 768, 12, \
    3072
DYG_BATCH, DYG_SEQ, DYG_DROPOUT, DYG_LR = 32, 512, 0.1, 1e-4
DYG_STEPS = (2, 5)          # warm-up, timed
# K1-K3 once a layer; K4 / K5 for the embedding norm and two a layer
DYG_LAUNCHES = {"K1": 12, "K2": 12, "K3": 12, "K4": 25, "K5": 25}


def dygraph_net(paddle, layers=DYG_LAYERS, dropout=DYG_DROPOUT):
    nn = paddle.nn

    class ErnieShaped(nn.Layer):
        def __init__(self):
            super().__init__()
            self.word = nn.Embedding(DYG_VOCAB, DYG_HIDDEN)
            self.pos = nn.Embedding(512, DYG_HIDDEN)
            self.type = nn.Embedding(2, DYG_HIDDEN)
            self.norm = nn.LayerNorm(DYG_HIDDEN, epsilon=1e-12)
            self.drop = nn.Dropout(dropout)
            self.encoder = nn.TransformerEncoder(nn.TransformerEncoderLayer(
                DYG_HIDDEN, DYG_HEADS, DYG_FFN, dropout=dropout,
                activation="gelu"), layers)
            self.head = nn.Linear(DYG_HIDDEN, DYG_VOCAB)

        def forward(self, ids, types):
            pos = paddle.arange(ids.shape[1]).unsqueeze(0)
            h = self.word(ids) + self.pos(pos) + self.type(types)
            return self.head(self.encoder(self.drop(self.norm(h))))

    return ErnieShaped()


def dygraph_batch(paddle, seed, batch=None):
    rng = np.random.RandomState(seed + 60)
    return [paddle.to_tensor(rng.randint(0, hi, (batch or DYG_BATCH,
                                                 DYG_SEQ)))
            for hi in (DYG_VOCAB, 2, DYG_VOCAB)]


def dygraph_step(paddle, net, opt, ids, types, labels, o1=True):
    ctx = paddle.amp.auto_cast(level="O1", dtype="bfloat16") if o1 \
        else contextlib.nullcontext()
    with ctx:
        logits = net(ids, types)
        loss = paddle.nn.CrossEntropyLoss()(logits, labels)
    loss.backward()
    if opt is not None:
        opt.step()
        opt.clear_grad()
    return loss


def dygraph_wrapper_cost(paddle, net, opt, batch):
    """The Paddle surface's host cost: the Tensors one step wraps (its
    ops at the Paddle level, counted by patching `Tensor._wrap`) and the
    host time one wrapped op adds over the same torch op (2000 adds of
    two 1 x 8 tensors on the card, Paddle against torch, each issued
    back to back)."""
    from paddle_tpu_torch.core import tensor as ct

    counted = [0]
    wrap = ct.Tensor.__dict__["_wrap"]

    def counting(cls, t):
        counted[0] += 1
        return wrap.__func__(cls, t)

    ct.Tensor._wrap = classmethod(counting)
    try:
        dygraph_step(paddle, net, opt, *batch)
    finally:
        ct.Tensor._wrap = wrap
    a, b = paddle.ones([1, 8]), paddle.ones([1, 8])
    ta, tb = a._t, b._t
    times = {}
    for name, fn in (("paddle", lambda: a + b), ("torch", lambda: ta + tb)):
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        times[name] = (time.perf_counter() - t0) / 2000 * 1e6
    torch.cuda.synchronize()
    extra = times["paddle"] - times["torch"]
    return dict(wrapped_tensors_per_step=counted[0],
                paddle_add_us=times["paddle"], torch_add_us=times["torch"],
                extra_us_per_op=extra,
                est_wrapper_ms_per_step=counted[0] * extra / 1e3)


def dygraph_card_vs_cpu(paddle, seed):
    """The network at 2 of its 12 layers, fp32, dropout 0, 2 x 512 tokens:
    one step on the card (kernels) against the CPU (plain versions) from
    the card's weights: the loss and every gradient under check_grads,
    then one AdamW update of each, fed the CPU's gradients, every weight
    within ADAM_ATOL."""
    from paddle_tpu_torch.core.rng import seed as reseed

    reseed(seed)
    card = dygraph_net(paddle, layers=2, dropout=0.0)
    counters = train_counters()
    before = {k: fn.launches for k, fn in counters.items()}
    losses = {}
    # each network runs with its device as the default one (its forward
    # makes the position ids there)
    try:
        for name in ("cpu", "card"):
            paddle.set_device("cpu" if name == "cpu" else "cuda")
            if name == "cpu":
                cpu = dygraph_net(paddle, layers=2, dropout=0.0)
                cpu.set_state_dict({k: v._t.cpu() for k, v in
                                    card.state_dict().items()})
                batch = dygraph_batch(paddle, seed + 1, batch=2)
                m = cpu
            else:
                batch, m = [t.cuda() for t in batch], card
            m.train()
            losses[name] = float(dygraph_step(paddle, m, None, *batch,
                                              o1=False))
    finally:
        paddle.set_device("cuda")
    ran = {k: fn.launches - before[k] for k, fn in counters.items()}
    if any(n <= 0 for n in ran.values()):
        raise AssertionError(f"dygraph check: the card's step skipped a "
                             f"kernel: {ran}")
    cpu_params = dict(cpu.named_parameters())
    errs = {}
    for name, p in card.named_parameters():
        g, gr = p._t.grad, cpu_params[name]._t.grad
        errs[name] = (float((g.cpu() - gr).abs().max()),
                      float(gr.abs().max()))
    # the key projections' bias takes a zero gradient in exact arithmetic
    # (it shifts every score of a row alike), so both sides hold rounding
    # noise (~1e-10 on an H100): it is held to the largest gradient's scale
    top = max(scale for _, scale in errs.values())
    for name in errs:
        if name.endswith("self_attn.k_proj.bias"):
            errs[name] = (errs[name][0], top)
    worst, worst_name = check_grads(errs, losses, "dygraph check", GRAD_RTOL)
    with torch.no_grad():
        for name, p in card.named_parameters():
            p._t.grad.copy_(cpu_params[name]._t.grad)
    for m in (card, cpu):
        paddle.optimizer.AdamW(DYG_LR, parameters=m.parameters()).step()
    err = max(max_err(p._t.cpu(), cpu_params[n]._t)
              for n, p in card.named_parameters())
    if not err <= ADAM_ATOL:
        raise AssertionError(f"dygraph check: AdamW update max abs error "
                             f"{err}")
    log(f"[dygraph] 2-layer card vs CPU, fp32, dropout 0, 2 x {DYG_SEQ}: "
        f"loss card {losses['card']!r} cpu {losses['cpu']!r}; every "
        f"gradient within {GRAD_RTOL} x max|cpu grad|, worst {worst:.3g} "
        f"({worst_name}); one AdamW update within {err:.3g} (tol "
        f"{ADAM_ATOL}); kernels launched {ran}")
    return dict(loss_card=losses["card"], loss_cpu=losses["cpu"],
                worst_grad_rel=worst, worst_grad=worst_name,
                adamw_max_abs_err=err, launches=ran)


def phase_dygraph(seed, dev, native=None, profile=False, out_dir=None):
    """The Paddle dygraph surface on the card: `import paddle_tpu_torch as
    paddle`, the ERNIE-1.0-base-width network above trained with
    loss.backward(), AdamW.step() and clear_grad() under auto_cast O1 bf16
    (DYG_STEPS warm-up and timed steps, the launch counters zeroed just
    before the timed steps and read after), then an eval forward under
    no_grad; the wrapper's host cost; the 2-layer card-vs-CPU step. The
    torch-native Train ERNIE step of this call (`native`) is printed
    beside it."""
    import paddle_tpu_torch as paddle

    t_phase = time.perf_counter()
    paddle.set_device("cuda")
    paddle.seed(seed)
    held = torch.cuda.memory_allocated()
    net = dygraph_net(paddle)
    net.train()
    opt = paddle.optimizer.AdamW(DYG_LR, parameters=net.parameters())
    n_params = sum(p.numel() for p in net.parameters())
    batch = dygraph_batch(paddle, seed)
    log(f"[dygraph] Paddle dygraph network at ERNIE-1.0 base widths "
        f"({DYG_LAYERS} layers, hidden {DYG_HIDDEN}, {DYG_HEADS} heads, "
        f"FFN {DYG_FFN}, vocab {DYG_VOCAB}, {n_params / 1e6:.2f} M params), "
        f"batch {DYG_BATCH} x {DYG_SEQ}, O1 bf16, dropout {DYG_DROPOUT}, "
        f"CrossEntropyLoss over every token, AdamW {DYG_LR}")
    warm, timed = DYG_STEPS
    losses = [float(dygraph_step(paddle, net, opt, *batch))
              for _ in range(warm)]
    torch.cuda.synchronize()
    counters = train_counters()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    step_losses = [dygraph_step(paddle, net, opt, *batch)
                   for _ in range(timed)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    losses += [float(x) for x in step_losses]
    tokens = DYG_BATCH * DYG_SEQ
    tps = tokens * timed / wall
    fpt = 6 * n_params + 12 * DYG_LAYERS * DYG_HIDDEN * DYG_SEQ
    mfu = tps * fpt / PEAK_FLOPS[torch.bfloat16]
    net.eval()
    with paddle.no_grad():
        logits = net(*batch[:2])
    torch.cuda.synchronize()
    if not (logits.stop_gradient and logits.shape == [DYG_BATCH, DYG_SEQ,
                                                        DYG_VOCAB]
            and bool(paddle.isfinite(logits).all())):
        raise AssertionError("dygraph: the eval forward gave "
                             f"{logits.shape}, finite / no grad expected")
    net.train()
    log(f"[dygraph] {timed} timed steps {wall:.3f} s: {tps:.1f} "
        f"tokens/s/chip, step {wall / timed * 1e3:.2f} ms, MFU {mfu:.4f} "
        f"({fpt / 1e6:.1f} MFLOP/token over 989 TFLOP/s), peak memory "
        f"{peak / 2**30:.2f} GiB ({held / 2**30:.2f} GiB held before)")
    if native is not None:
        log(f"[dygraph] beside it in this call, the torch-native Train "
            f"ERNIE step (ErnieForPretraining, fused MLM loss, Adam): "
            f"{native['tokens_per_s']:.1f} tokens/s/chip, step "
            f"{native['step_ms']:.2f} ms")
    log("[dygraph] loss by step: " + ", ".join(f"{x:.4f}" for x in losses))
    log(f"[dygraph] launches in the {timed} timed steps: {launches}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"dygraph: loss not finite and falling: "
                             f"{losses}")
    wrong = {k: n for k, n in launches.items()
             if n != DYG_LAUNCHES[k] * timed}
    if wrong:
        raise AssertionError(f"dygraph: launches {wrong} over {timed} "
                             f"steps != {DYG_LAUNCHES} a step")
    cost = dygraph_wrapper_cost(paddle, net, opt, batch)
    log(f"[dygraph] wrapper: {cost['wrapped_tensors_per_step']} Tensors "
        f"wrapped a step; a Paddle add {cost['paddle_add_us']:.2f} us "
        f"against torch's {cost['torch_add_us']:.2f} us on the host, so "
        f"~{cost['est_wrapper_ms_per_step']:.2f} ms a step of host time")
    prof = None
    if profile:
        prof = profile_window("dygraph_step", lambda: dygraph_step(
            paddle, net, opt, *batch), out_dir)
    del net, opt, batch, logits
    gc.collect()
    torch.cuda.empty_cache()
    check = dygraph_card_vs_cpu(paddle, seed)
    out = dict(launches=launches, tokens_per_s=tps, step_ms=wall / timed *
               1e3, mfu=mfu, flops_per_token=fpt, n_params=n_params,
               peak_bytes=peak, held_bytes=held, losses=losses, wall_s=wall,
               wrapper=cost, profile=prof, card_vs_cpu=check,
               native_tokens_per_s=None if native is None
               else native["tokens_per_s"])
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[dygraph] the phase took {out['phase_s']:.1f} s")
    return out


# ------------------------------------------------ nn, hapi and vision
# ResNet-50 (He et al. 2016) at full width through paddle.Model at O2, at
# Goyal et al.'s 256 images a card (lr 0.1); LeNet on MNIST; Transformer-
# base (Vaswani et al. 2017) at its paper's ~25k tokens a batch
VIS_BATCH, VIS_RES, VIS_LR, VIS_DECAY = 256, 224, 0.1, 1e-4
VIS_STEPS = (2, 5)          # warm-up, timed
VIS_FIT_BATCHES = 4
LENET_BATCH, LENET_EPOCHS = 64, 2
TFB_VOCAB, TFB_MODEL, TFB_HEADS, TFB_LAYERS, TFB_FFN = 37000, 512, 8, 6, 2048
TFB_BATCH, TFB_SEQ, TFB_DROPOUT, TFB_LR = 96, 256, 0.1, 1e-4
TFB_STEPS = (1, 3)
# K1-K3 for each layer's attentions (6 encoder self, 6 decoder self, 6
# cross); K4 / K5 for two norms an encoder layer and three a decoder layer
TFB_LAUNCHES = {"K1": 18, "K2": 18, "K3": 18, "K4": 30, "K5": 30}
# the card-vs-CPU ResNet step at 64 x 64 and batch 2: layer4's BatchNorm
# sees 8 values a channel, which magnifies fp32 rounding: at seed 0 one
# fp32 step of this network sits up to 6.3e-4 of a tensor's largest
# gradient from a float64 step on the CPU, 6.5e-4 on the card, and the card
# up to 7.7e-4 from the CPU's fp32 step (one H100, tools/resnet_rounding.py,
# PERF.md). Each gradient, each running statistic and the eval forward's
# logits are held to 1e-3 of their own largest CPU value
VIS_GRAD_RTOL = 1e-3


def conv_linear_flops(paddle, net, shape):
    """The forward's FLOPs for one input of `shape` (batch 1): 2 x MACs of
    every Conv2D and Linear, from the shapes a forward hook sees."""
    total = [0]

    def hook(layer, inputs, out):
        if isinstance(layer, paddle.nn.Conv2D):
            w = layer.weight.shape
            total[0] += 2 * out.numel() * w[1] * w[2] * w[3]
        else:
            total[0] += 2 * layer.weight.shape[0] * layer.weight.shape[1]

    hooks = [m.register_forward_post_hook(hook) for m in net.sublayers()
             if isinstance(m, (paddle.nn.Conv2D, paddle.nn.Linear))]
    was = net.training
    net.eval()
    with paddle.no_grad():
        net(paddle.zeros([1] + list(shape)))
    net.train(was)
    for h in hooks:
        h.remove()
    return total[0]


def vision_batch(paddle, seed, n, dev, classes=1000, res=VIS_RES):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, 3, res, res, generator=g, device=dev)
    y = torch.randint(0, classes, (n, 1), generator=g, device=dev)
    return paddle.Tensor._wrap(x), paddle.Tensor._wrap(y)


def resnet_model(paddle, net):
    model = paddle.Model(net)
    opt = paddle.optimizer.Momentum(
        VIS_LR, 0.9, parameters=net.parameters(),
        weight_decay=paddle.optimizer.L2Decay(VIS_DECAY))
    model.prepare(opt, paddle.nn.CrossEntropyLoss(),
                  paddle.metric.Accuracy(), amp_configs="O2")
    return model


def vision_resnet50(paddle, seed, dev):
    """ResNet-50 through Model.train_batch at O2, then Model.fit and
    evaluate."""
    paddle.seed(seed)
    net = paddle.vision.models.resnet50()
    n_params = sum(p.numel() for p in net.parameters())
    model = resnet_model(paddle, net)
    x, y = vision_batch(paddle, seed, VIS_BATCH, dev)
    fwd = conv_linear_flops(paddle, net, (3, VIS_RES, VIS_RES))
    step_flops = 3 * fwd * VIS_BATCH
    warm, timed = VIS_STEPS
    losses = [float(model.train_batch([x], [y])[0][0]) for _ in range(warm)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    outs = [model.train_batch([x], [y]) for _ in range(timed)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses += [float(o[0][0]) for o in outs]
    ips = VIS_BATCH * timed / wall
    mfu = step_flops * timed / wall / PEAK_FLOPS[torch.bfloat16]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"vision: ResNet-50 losses {losses}")
    log(f"[vision] ResNet-50 ({n_params / 1e6:.2f} M params) via "
        f"paddle.Model O2, {VIS_BATCH} x 3 x {VIS_RES} x {VIS_RES}, "
        f"Momentum({VIS_LR}, 0.9, L2Decay({VIS_DECAY})): {timed} timed "
        f"steps {wall:.3f} s, {ips:.1f} images/s/chip, step "
        f"{wall / timed * 1e3:.2f} ms, MFU {mfu:.4f} ({fwd / 1e9:.3f} GFLOP "
        f"forward an image, {step_flops / 1e12:.3f} TFLOP a step), peak "
        f"memory {peak / 2**30:.2f} GiB; losses "
        + ", ".join(f"{v:.4f}" for v in losses))
    # one fit epoch over an in-memory dataset on the card, then evaluate
    dx, dy = vision_batch(paddle, seed + 1, VIS_FIT_BATCHES * VIS_BATCH, dev)
    data = paddle.io.TensorDataset([dx, dy])
    seen = []

    class Record(paddle.hapi.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            seen.append(logs["loss"][0])

    t0 = time.perf_counter()
    model.fit(data, batch_size=VIS_BATCH, epochs=1, shuffle=False,
              verbose=0, callbacks=[Record()])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    # what evaluate's BatchNorm meets: each channel's variance over the
    # eval batch against its running variance, at the first and last norm
    spread = {}

    def watch(name):
        def hook(layer, inputs):
            var = inputs[0]._t.float().var(dim=(0, 2, 3), unbiased=False)
            spread.setdefault(name, []).append(
                float((var / layer._variance._t).median()))
        return hook
    hooks = [bn.register_forward_pre_hook(watch(name)) for name, bn in
             (("bn1", net.bn1), ("layer4.2.bn3", net.layer4[-1].bn3))]
    t0 = time.perf_counter()
    ev = model.evaluate(data, batch_size=VIS_BATCH, verbose=0)
    eval_s = time.perf_counter() - t0
    for h in hooks:
        h.remove()
    spread = {k: float(np.median(v)) for k, v in spread.items()}
    bn = net.bn1
    stats = torch.cat([bn._mean._t, bn._variance._t])
    if not (len(seen) == VIS_FIT_BATCHES and np.isfinite(seen).all()
            and np.isfinite(ev["loss"]).all() and 0 <= ev["acc"] <= 1
            and bool(torch.isfinite(stats).all())
            and float(bn._mean._t.abs().max()) > 0):
        raise AssertionError(f"vision: fit losses {seen}, evaluate {ev}")
    log(f"[vision] Model.fit: {VIS_FIT_BATCHES} batches in {fit_s:.2f} s, "
        f"losses " + ", ".join(f"{v:.4f}" for v in seen) + f"; evaluate on "
        f"the running statistics in {eval_s:.2f} s: {ev}; the eval "
        f"batch's variance over the running variance, median over channels "
        f"and batches: " + ", ".join(f"{k} {v:.4g}" for k, v in
                                     spread.items()))
    return dict(images_per_s=ips, step_ms=wall / timed * 1e3, mfu=mfu,
                forward_flops_per_image=fwd, step_flops=step_flops,
                peak_bytes=peak, n_params=n_params, losses=losses,
                fit_losses=seen, fit_s=fit_s, evaluate=ev, eval_s=eval_s,
                eval_var_over_running=spread)


def vision_lenet(paddle, seed, out_dir):
    """LeNet through Model.fit on the synthetic MNIST, then Model.save /
    load on the card."""
    import tempfile
    import warnings

    T = paddle.vision.transforms
    paddle.seed(seed)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        data = paddle.vision.datasets.MNIST(mode="train",
                                            transform=T.ToTensor())
    net = paddle.vision.LeNet()

    def make(network):
        m = paddle.Model(network)
        m.prepare(paddle.optimizer.Adam(1e-3,
                                        parameters=network.parameters()),
                  paddle.nn.CrossEntropyLoss(), paddle.metric.Accuracy())
        return m

    model = make(net)
    epochs = []

    class Record(paddle.hapi.callbacks.Callback):
        def on_epoch_end(self, epoch, logs=None):
            epochs.append((logs["loss"][0], logs["acc"]))

    first = {}

    class First(paddle.hapi.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            first.setdefault("loss", logs["loss"][0])

    t0 = time.perf_counter()
    model.fit(data, batch_size=LENET_BATCH, epochs=LENET_EPOCHS,
              drop_last=True, verbose=0, callbacks=[Record(), First()])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    steps = LENET_EPOCHS * (len(data) // LENET_BATCH)
    if not (epochs[-1][0] < first["loss"] and epochs[-1][1] > epochs[0][1]
            and epochs[-1][1] > 0.5):
        raise AssertionError(f"vision: LeNet epochs (loss, acc) {epochs}, "
                             f"first loss {first}")
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        path = os.path.join(tmp, "lenet")
        model.save(path)
        other = make(paddle.vision.LeNet())
        other.load(path)
    x = paddle.Tensor._wrap(torch.stack([data[i][0]._t for i in range(8)]))
    same = all(torch.equal(a._t, b._t) for a, b in zip(
        model.parameters(), other.parameters())) and np.array_equal(
        model.predict_batch([x])[0], other.predict_batch([x])[0])
    if not (same and other._optimizer._step_count == steps):
        raise AssertionError("vision: LeNet Model.save / load did not "
                             "round-trip on the card")
    log(f"[vision] LeNet Model.fit on synthetic MNIST: {steps} steps of "
        f"{LENET_BATCH} in {fit_s:.2f} s; first batch loss "
        f"{first['loss']:.4f}; epochs (loss, acc) "
        + ", ".join(f"({l_:.4f}, {a:.4f})" for l_, a in epochs)
        + "; Model.save / load round-tripped")
    return dict(fit_s=fit_s, steps=steps, first_loss=first["loss"],
                epochs=epochs)


def transformer_base(paddle, layers=TFB_LAYERS, dropout=TFB_DROPOUT,
                     seq=TFB_SEQ):
    nn = paddle.nn

    class TransformerBase(nn.Layer):
        def __init__(self):
            super().__init__()
            # N(0, d^-1/2), so the sqrt(d)-scaled lookups have unit
            # variance (paddle's default N(0, 1) would saturate every
            # softmax of the random network)
            self.embed = nn.Embedding(
                TFB_VOCAB, TFB_MODEL, weight_attr=paddle.ParamAttr(
                    initializer=nn.initializer.Normal(0.0,
                                                      TFB_MODEL ** -0.5)))
            pos = np.arange(seq)[:, None] / np.power(
                10000.0, np.arange(0, TFB_MODEL, 2) / TFB_MODEL)
            table = np.zeros((seq, TFB_MODEL), np.float32)
            table[:, 0::2], table[:, 1::2] = np.sin(pos), np.cos(pos)
            self.register_buffer("pos", paddle.to_tensor(table),
                                 persistable=False)
            self.drop = nn.Dropout(dropout)
            self.transformer = nn.Transformer(
                TFB_MODEL, TFB_HEADS, layers, layers, TFB_FFN, dropout)
            self.head = nn.Linear(TFB_MODEL, TFB_VOCAB)
            self.tgt_mask = nn.Transformer.generate_square_subsequent_mask(
                seq)

        def embedding(self, ids):
            return self.drop(self.embed(ids) * TFB_MODEL ** 0.5
                             + self.pos[:ids.shape[1]])

        def forward(self, src, tgt):
            h = self.transformer(self.embedding(src), self.embedding(tgt),
                                 tgt_mask=self.tgt_mask)
            return self.head(h)

    return TransformerBase()


def tfb_batch(paddle, seed, batch, seq=TFB_SEQ):
    rng = np.random.RandomState(seed + 70)
    return [paddle.to_tensor(rng.randint(0, TFB_VOCAB, (batch, seq)))
            for _ in range(3)]


def tfb_model(paddle, net, o1=True):
    model = paddle.Model(net)
    model.prepare(paddle.optimizer.Adam(TFB_LR, beta2=0.98, epsilon=1e-9,
                                        parameters=net.parameters()),
                  paddle.nn.CrossEntropyLoss(),
                  amp_configs="O1" if o1 else None)
    return model


def vision_transformer(paddle, seed, dev):
    """Transformer-base through Model.train_batch at O1, the launches of
    the timed steps counted."""
    paddle.seed(seed)
    net = transformer_base(paddle)
    n_params = sum(p.numel() for p in net.parameters())
    model = tfb_model(paddle, net)
    src, tgt, labels = tfb_batch(paddle, seed, TFB_BATCH)
    warm, timed = TFB_STEPS
    losses = [float(model.train_batch([src, tgt], [labels])[0])
              for _ in range(warm)]
    torch.cuda.synchronize()
    counters = train_counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    outs = [model.train_batch([src, tgt], [labels]) for _ in range(timed)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    losses += [float(o[0]) for o in outs]
    tokens = 2 * TFB_BATCH * TFB_SEQ
    log(f"[vision] Transformer-base ({n_params / 1e6:.2f} M params) via "
        f"paddle.Model O1, {TFB_BATCH} x {TFB_SEQ} source and target "
        f"tokens, dropout {TFB_DROPOUT}: {timed} timed steps {wall:.3f} s, "
        f"step {wall / timed * 1e3:.2f} ms, {tokens * timed / wall:.1f} "
        f"tokens/s/chip (source + target), peak {peak / 2**30:.2f} GiB; "
        f"losses " + ", ".join(f"{v:.4f}" for v in losses)
        + f"; launches {launches}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"vision: Transformer losses {losses}")
    wrong = {k: n for k, n in launches.items()
             if n != TFB_LAUNCHES[k] * timed}
    if wrong:
        raise AssertionError(f"vision: Transformer launches {wrong} over "
                             f"{timed} steps != {TFB_LAUNCHES} a step")
    return dict(launches=launches, step_ms=wall / timed * 1e3,
                tokens_per_s=tokens * timed / wall, peak_bytes=peak,
                n_params=n_params, losses=losses)


def layer_grad_errors(card, cpu):
    """grad_errors for two Paddle Layers: {name: (max abs error, max |CPU
    grad|)}."""
    ref = dict(cpu.named_parameters())
    return {n: (max_err(p._t.grad.cpu(), ref[n]._t.grad),
                float(ref[n]._t.grad.abs().max()))
            for n, p in card.named_parameters()}


def _card_and_cpu(paddle, build):
    """`build()` on the card and on the CPU with the card's weights."""
    paddle.set_device("cuda")
    card = build()
    paddle.set_device("cpu")
    try:
        cpu = build()
        cpu.set_state_dict({k: v._t.cpu() for k, v in
                            card.state_dict().items()})
    finally:
        paddle.set_device("cuda")
    return card, cpu


def vision_card_vs_cpu(paddle, seed):
    """fp32 steps on the card against the CPU from the same weights, ReLU
    masks shared: the BottleneckBlock ResNet-50 at 2 x 3 x 64 x 64 (loss,
    every gradient and every BatchNorm running statistic within
    VIS_GRAD_RTOL of its own largest CPU value, then one Momentum update
    fed the CPU's gradients within ADAM_ATOL, then an eval forward on the
    running statistics whose logits are within VIS_GRAD_RTOL of the
    largest CPU logit and which leaves the statistics as they were), and
    Transformer-base at 1 + 1 layers, dropout 0, 2 x 64 tokens
    (check_grads at GRAD_RTOL, one Adam update within ADAM_ATOL). cuDNN's
    TF32 is off inside."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        paddle.seed(seed)
        M = paddle.vision.models
        card, cpu = _card_and_cpu(paddle, lambda: M.ResNet(
            M.resnet.BottleneckBlock, 50, num_classes=10))
        g = np.random.RandomState(seed + 80)
        x = g.randn(2, 3, 64, 64).astype(np.float32)
        y = g.randint(0, 10, (2, 1))
        losses, nets = {}, {"card": card, "cpu": cpu}
        with shared_relu_masks() as masks:
            for name in ("cpu", "card"):
                masks.record() if name == "cpu" else masks.replay()
                net = nets[name]
                net.train()
                place = "cpu" if name == "cpu" else "cuda"
                loss = paddle.nn.CrossEntropyLoss()(
                    net(paddle.to_tensor(x, place=place)),
                    paddle.to_tensor(y, place=place))
                loss.backward()
                losses[name] = float(loss)
            errs = layer_grad_errors(card, cpu)
            worst, worst_name = check_grads(errs, losses,
                                            "vision ResNet check",
                                            VIS_GRAD_RTOL)
            cpu_bufs = dict(cpu.named_buffers())
            buf_err = max(max_err(b._t.cpu(), cpu_bufs[n]._t) / float(
                cpu_bufs[n]._t.abs().max()) for n, b in card.named_buffers())
            if not buf_err <= VIS_GRAD_RTOL:
                raise AssertionError(f"vision ResNet check: running "
                                     f"statistics {buf_err} of their "
                                     f"largest value")
            cpu_params = dict(cpu.named_parameters())
            with torch.no_grad():
                for n, p in card.named_parameters():
                    p._t.grad.copy_(cpu_params[n]._t.grad)
            for net in nets.values():
                paddle.optimizer.Momentum(
                    VIS_LR, 0.9, parameters=net.parameters(),
                    weight_decay=paddle.optimizer.L2Decay(VIS_DECAY)).step()
            upd = max(max_err(p._t.cpu(), cpu_params[n]._t)
                      for n, p in card.named_parameters())
            if not upd <= ADAM_ATOL:
                raise AssertionError(f"vision ResNet check: Momentum update "
                                     f"{upd}")
            # eval: BatchNorm on the running statistics (batch_norm_infer)
            stats = {n: b._t.clone() for n, b in card.named_buffers()}
            logits = {}
            for name in ("cpu", "card"):
                masks.record() if name == "cpu" else masks.replay()
                nets[name].eval()
                place = "cpu" if name == "cpu" else "cuda"
                with paddle.no_grad():
                    logits[name] = nets[name](
                        paddle.to_tensor(x, place=place))._t.cpu()
        top_logit = float(logits["cpu"].abs().max())
        eval_err = max_err(logits["card"], logits["cpu"]) / top_logit
        if not (eval_err <= VIS_GRAD_RTOL and all(
                torch.equal(stats[n], b._t)
                for n, b in card.named_buffers())):
            raise AssertionError(f"vision ResNet check: eval logits "
                                 f"{eval_err} of the largest, or eval moved "
                                 f"the running statistics")
        log(f"[vision] ResNet-50 (10 classes) card vs CPU, fp32, 2 x 3 x 64 x "
            f"64: loss card {losses['card']!r} cpu {losses['cpu']!r}; worst "
            f"gradient {worst:.3g} of its own largest ({worst_name}), "
            f"running statistics {buf_err:.3g} (tol {VIS_GRAD_RTOL}); one "
            f"Momentum update within {upd:.3g} (tol {ADAM_ATOL}); eval "
            f"logits {eval_err:.3g} of the largest, {top_logit:.3g} (tol "
            f"{VIS_GRAD_RTOL})")
        out["resnet"] = dict(loss_card=losses["card"],
                             loss_cpu=losses["cpu"], worst_grad_rel=worst,
                             worst_grad=worst_name, buffers_rel=buf_err,
                             momentum_max_abs_err=upd, eval_rel=eval_err,
                             eval_top_logit=top_logit)
        del card, cpu, nets
        # Transformer-base at 1 + 1 layers
        paddle.seed(seed + 1)
        card, cpu = _card_and_cpu(paddle, lambda: transformer_base(
            paddle, layers=1, dropout=0.0, seq=64))
        src, tgt, labels = tfb_batch(paddle, seed + 1, 2, seq=64)
        counters = train_counters()
        before = {k: fn.launches for k, fn in counters.items()}
        losses, nets = {}, {"card": card, "cpu": cpu}
        with shared_relu_masks() as masks:
            for name in ("cpu", "card"):
                masks.record() if name == "cpu" else masks.replay()
                net = nets[name]
                net.train()
                args = [t.cpu() if name == "cpu" else t
                        for t in (src, tgt, labels)]
                loss = paddle.nn.CrossEntropyLoss()(net(*args[:2]), args[2])
                loss.backward()
                losses[name] = float(loss)
        ran = {k: fn.launches - before[k] for k, fn in counters.items()}
        if any(n <= 0 for n in ran.values()):
            raise AssertionError(f"vision Transformer check: the card's "
                                 f"step skipped a kernel: {ran}")
        errs = layer_grad_errors(card, cpu)
        top = max(scale for _, scale in errs.values())
        for name in errs:      # zero in exact arithmetic, as dygraph's
            if name.endswith("k_proj.bias"):
                errs[name] = (errs[name][0], top)
        worst_t, worst_t_name = check_grads(errs, losses,
                                            "vision Transformer check",
                                            GRAD_RTOL)
        cpu_params = dict(cpu.named_parameters())
        with torch.no_grad():
            for n, p in card.named_parameters():
                p._t.grad.copy_(cpu_params[n]._t.grad)
        for net in (card, cpu):
            paddle.optimizer.Adam(TFB_LR, beta2=0.98, epsilon=1e-9,
                                  parameters=net.parameters()).step()
        upd_t = max(max_err(p._t.cpu(), cpu_params[n]._t)
                    for n, p in card.named_parameters())
        if not upd_t <= ADAM_ATOL:
            raise AssertionError(f"vision Transformer check: Adam update "
                                 f"{upd_t}")
        log(f"[vision] Transformer-base 1 + 1 layers card vs CPU, fp32, "
            f"dropout 0, 2 x 64: loss card {losses['card']!r} cpu "
            f"{losses['cpu']!r}; worst gradient {worst_t:.3g} "
            f"({worst_t_name}, tol {GRAD_RTOL}); one Adam update within "
            f"{upd_t:.3g}; kernels launched {ran}")
        out["transformer"] = dict(loss_card=losses["card"],
                                  loss_cpu=losses["cpu"],
                                  worst_grad_rel=worst_t,
                                  worst_grad=worst_t_name,
                                  adam_max_abs_err=upd_t, launches=ran)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
        paddle.set_device("cuda")
    return out


def vision_kernel_cases(rows, dev):
    """K1, K2 and K3 at Transformer-base's attention shapes (96, 256, 8,
    64) in bf16 (O1's type): encoder self-attention (no mask, dropout
    0.1), which is also the cross attention's launch (256 target queries
    over 256 source keys, no mask, the same dropout and type), and
    decoder self-attention under the (1, 1, 256, 256) float causal mask
    of generate_square_subsequent_mask; K4 / K5 in LayerNorm mode at its
    24576 x 512 rows in fp32."""
    shape = (TFB_BATCH, TFB_SEQ, TFB_HEADS, TFB_MODEL // TFB_HEADS)
    forms = ((torch.bfloat16, TFB_BATCH),)
    causal = torch.triu(torch.full((TFB_SEQ, TFB_SEQ), float("-inf"),
                                   device=dev), 1)[None, None]
    main = gpt_attention_cases(rows, dev, shape, key="tfb enc", causal=False,
                               p=TFB_DROPOUT, forms=forms,
                               label="Transformer-base encoder and cross ")
    main.update(gpt_attention_cases(
        rows, dev, shape, key="tfb dec", causal=False, p=TFB_DROPOUT,
        forms=forms, label="Transformer-base decoder self ", mask=causal))
    main.update(gpt_norm_cases(
        rows, dev, ((torch.float32, TFB_BATCH * TFB_SEQ, True),),
        key="tfb", hidden=TFB_MODEL))
    main["K4 tfb"] = main.pop("K4 tfb float32")
    return main


def phase_vision(seed, dev, out_dir=None):
    """nn in full, hapi and vision on the card (see the module
    docstring's phase 48)."""
    import paddle_tpu_torch as paddle

    t_phase = time.perf_counter()
    paddle.set_device("cuda")
    out = dict(resnet50=vision_resnet50(paddle, seed, dev))
    gc.collect()
    torch.cuda.empty_cache()
    out["lenet"] = vision_lenet(paddle, seed, out_dir)
    out["transformer"] = vision_transformer(paddle, seed, dev)
    out["launches"] = out["transformer"]["launches"]
    gc.collect()
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = vision_card_vs_cpu(paddle, seed)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[vision] the phase took {out['phase_s']:.1f} s")
    return out


def embedding_determinism(seed, dev):
    """F4 on the card: two identical ERNIE-1.0 base O1 steps (dropout 0.1,
    32 x 512, the same weights and generator) under PyTorch's defaults
    must give the same bits in every gradient, now that the port's
    `F.embedding` sums each row in a fixed order; then each of ERNIE's
    three lookups' backward timed (CUDA events): the port's, PyTorch's
    default and PyTorch's deterministic form."""
    from paddle_tpu_torch.nn import torch_functional as F

    if torch.are_deterministic_algorithms_enabled():
        raise AssertionError("deterministic algorithms are on: the check "
                             "needs PyTorch's defaults")
    cfg, model, (ids, labels), _, _, _ = _zero_world(seed, dev)
    (l0, g0), (l1, g1) = [recompute_grads(model, ids, labels, dev, seed)
                          for _ in range(2)]
    differ = [k for k in g0 if not torch.equal(g0[k], g1[k])]
    del model, g0, g1
    lookups = {"word ids": (ids, cfg.vocab_size),
               "positions": (torch.arange(ids.shape[1], device=dev)[None]
                             .expand_as(ids), cfg.max_position_embeddings),
               "token types (all 0)": (torch.zeros_like(ids), 2)}
    times = {}
    for name, (i, n) in lookups.items():
        w = torch.randn(n, cfg.hidden_size, device=dev, requires_grad=True)
        dy = torch.randn(*i.shape, cfg.hidden_size, device=dev)

        def backward(fn):
            return lambda: torch.autograd.grad(fn(i, w), w, dy)

        row = {"port": time_ms(backward(F.embedding)),
               "torch default": time_ms(backward(
                   torch.nn.functional.embedding))}
        with deterministic_library_ops():
            row["torch deterministic"] = time_ms(backward(
                torch.nn.functional.embedding))
        times[name] = row
    log(f"[embedding] two ERNIE-1.0 base O1 steps under PyTorch's defaults: "
        f"losses {'equal' if torch.equal(l0, l1) else 'DIFFER'}, gradients "
        f"that differ: {differ or 'none'}")
    for name, row in times.items():
        log(f"[embedding] {name} lookup backward ({tuple(ids.shape)} ids): "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in row.items()))
    if differ or not torch.equal(l0, l1):
        raise AssertionError(f"F4: two identical ERNIE steps differ at "
                             f"{differ}")
    return dict(identical=True, lookup_backward_ms=times)


def fleet_batch(seed, dev, vocab):
    return torch.from_numpy(np.random.RandomState(seed + 16).randint(
        0, vocab, FLEET_BATCH)).to(dev)


def fleet_cfg(layers=None, dropout=0.0):
    from paddle_tpu_torch.models import GPTConfig

    cfg = GPTConfig.gpt3_1p3b()
    if layers is not None:
        cfg.num_hidden_layers = layers
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = dropout
    return cfg


def digest(t):
    import hashlib

    return hashlib.sha1(t.detach().float().contiguous().cpu().numpy()
                        .tobytes()).hexdigest()


def _accumulated_step(pipe, opt, ids, accum, data_ranks, o1):
    """One step of the single-rank reference in the pipeline's order:
    each data rank's rows cut into `accum` micro-batches, their gradients
    added in order, the data ranks' sums added in rank order, one
    multiply by 1 / (accum x data ranks), the optimizer. Returns (loss,
    the global gradient norm before the update)."""
    import contextlib

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion

    crit = GPTPretrainingCriterion()
    sums, per = [], []
    for rows in torch.split(ids, ids.shape[0] // data_ranks):
        losses = []
        for micro in torch.split(rows, rows.shape[0] // accum):
            ctx = (amp.auto_cast(level="O1", dtype="bfloat16") if o1
                   else contextlib.nullcontext())
            with ctx:
                loss = crit(pipe(micro), micro)
            loss.backward()
            losses.append(loss.detach())
        per.append(sum(l.float() for l in losses) / len(losses))
        if data_ranks > 1:
            sums.append({n: p.grad.clone() for n, p in
                         pipe.named_parameters()})
            pipe.zero_grad(set_to_none=True)
    with torch.no_grad():
        for n, p in pipe.named_parameters():
            g = p.grad if data_ranks == 1 else sums[0][n]
            for s in sums[1:]:
                g = g + s[n]
            p.grad = g * (1.0 / (accum * data_ranks))
    norm = torch.sqrt(sum(torch.sum(p.grad.float() ** 2)
                          for p in pipe.parameters()))
    opt.step()
    opt.clear_grad()
    loss = per[0]
    for v in per[1:]:
        loss = loss + v
    if data_ranks > 1:
        loss = loss * (1.0 / data_ranks)
    return float(loss), float(norm)


def fleet_references(seed, dev):
    """The single-rank references of phase_train_fleet, computed before
    its world starts and freed: (a) GPT-3 1.3B's pipe layers on one rank,
    O1, dropout 0, FLEET_STEPS steps accumulating the FLEET_ACCUM
    micro-batches (loss and global gradient norm a step); (b) the
    FLEET_PP_LAYERS-deep pipe layers at fp32, one step in the pp 2 x dp 2
    order (loss and every parameter's digest)."""
    from paddle_tpu_torch.distributed.fleet import meta_parallel as mpl
    from paddle_tpu_torch.models.gpt import gpt_pipe_layers
    from paddle_tpu_torch.optimizer import Adam

    out = {}
    t0 = time.perf_counter()
    cfg = fleet_cfg()
    pipe = mpl.PipelineLayer(gpt_pipe_layers(cfg, device=dev, seed=seed),
                             num_stages=1)
    pipe.train()
    out["n_params"] = sum(p.numel() for p in pipe.parameters())
    out["flops_per_token"] = (6 * out["n_params"] + 12 * cfg.num_hidden_layers
                              * cfg.hidden_size * FLEET_BATCH[1])
    opt = Adam(learning_rate=FLEET_LR, parameters=pipe.parameters())
    ids = fleet_batch(seed, dev, cfg.vocab_size)
    out["steps"] = [_accumulated_step(pipe, opt, ids, FLEET_ACCUM, 1, True)
                    for _ in range(FLEET_STEPS)]
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    del pipe, opt
    gc.collect()
    torch.cuda.empty_cache()
    cfg = fleet_cfg(FLEET_PP_LAYERS)
    pipe = mpl.PipelineLayer(gpt_pipe_layers(cfg, device=dev, seed=seed),
                             num_stages=1)
    pipe.train()
    opt = Adam(learning_rate=FLEET_LR, parameters=pipe.parameters())
    out["pp_loss"], _ = _accumulated_step(pipe, opt, ids, FLEET_ACCUM, 2,
                                          False)
    out["pp_digests"] = {n: digest(p) for n, p in pipe.named_parameters()}
    del pipe, opt
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


class _NormProbe:
    """The optimizer of a pipeline leg, reading the hybrid global norm of
    the reduced gradients before each step."""

    def __init__(self, opt, hcg):
        from paddle_tpu_torch.distributed.fleet import meta_parallel as mpl
        from paddle_tpu_torch.distributed.fleet.meta_parallel import (
            hybrid_parallel_optimizer as hpo)
        from paddle_tpu_torch.nn import ClipGradByGlobalNorm

        self.split = hpo.is_mp_split
        self.opt = opt
        self.clip = mpl.HybridParallelClipGrad(ClipGradByGlobalNorm(1.0),
                                               hcg)
        self.norms = []

    def step(self):
        params = [p for p in self.opt._parameter_list if p.grad is not None]
        self.norms.append(float(self.clip.hybrid_global_norm(
            [p.grad for p in params],
            [self.split(p) for p in params])))
        self.opt.step()

    def clear_grad(self):
        self.opt.clear_grad()


def _staged(ptd_group_mod):
    return sum(g.staged_bytes for g in ptd_group_mod._GROUPS.values())


def _fleet_init(**degrees):
    from paddle_tpu_torch.distributed import fleet

    s = fleet.DistributedStrategy()
    s.hybrid_configs = {f"{k}_degree": v for k, v in degrees.items()}
    s.pipeline_configs = {"accumulate_steps": FLEET_ACCUM}
    return fleet.init(is_collective=True, strategy=s)


def _free():
    gc.collect()
    torch.cuda.empty_cache()


def ernie_tp_specs(cfg):
    """The tp specs of ERNIE-1.0's Megatron split (the port's (out, in)
    layout): QKV and ffn_in split by output rows, the attention output and
    ffn_out by input columns; everything else replicated."""
    specs = {}
    for i in range(cfg.num_hidden_layers):
        pre = f"ernie.layers.{i}."
        specs.update({pre + "attention.qkv.weight": ("tp", None),
                      pre + "attention.qkv.bias": ("tp",),
                      pre + "attention.out.weight": (None, "tp"),
                      pre + "ffn_in.weight": ("tp", None),
                      pre + "ffn_in.bias": ("tp",),
                      pre + "ffn_out.weight": (None, "tp")})
    return specs


def ernie_tensor_parallel(model, group):
    """ERNIE-1.0's encoder layers made Megatron-parallel over `group`, in
    place: the fused QKV and ffn_in column-parallel (the QKV's output in
    the interleaved (tp, 3, heads / tp, hd) layout), the attention output
    and ffn_out row-parallel, each attention on heads / tp heads. The
    parameters keep their names and take this rank's tp shapes."""
    from paddle_tpu_torch.distributed.fleet import meta_parallel as mpl

    cfg, dev = model.config, model.mlm_bias.device
    h, ffn = cfg.hidden_size, cfg.intermediate_size
    kw = dict(mp_group=group, device=dev)
    for layer in model.ernie.layers:
        att = layer.attention
        att.qkv = mpl.ColumnParallelLinear(h, 3 * h, gather_output=False,
                                           **kw)
        att.qkv.interleave_heads = att.num_heads
        att.out = mpl.RowParallelLinear(h, h, input_is_parallel=True, **kw)
        att.num_heads //= group.nranks
        layer.ffn_in = mpl.ColumnParallelLinear(h, ffn, gather_output=False,
                                                **kw)
        layer.ffn_out = mpl.RowParallelLinear(ffn, h, input_is_parallel=True,
                                              **kw)


def _qkv_layout(full, heads, tp, inverse=False):
    """GPT / ERNIE's fused QKV between the dense (3, heads, hd) output
    layout and the interleaved (tp, 3, heads / tp, hd) one."""
    from paddle_tpu_torch.serving.tp import interleave_qkv

    out = {}
    for n, v in full.items():
        if ".qkv." in n:
            v = (v.reshape(tp, 3, heads // tp, -1, *v.shape[1:])
                 .transpose(0, 1).reshape(v.shape) if inverse
                 else interleave_qkv(v, heads, tp))
        out[n] = v
    return out


def fleet_world_rank(seed, refs):
    """The body of each rank of phase_train_fleet (`distributed.spawn`):
    its legs in the reference dry run's order. PyTorch's default
    algorithms throughout (no deterministic mode: F4's fixed-order
    embedding backward is what the bit-parity legs lean on)."""
    from torch.func import functional_call

    from paddle_tpu_torch import amp
    from paddle_tpu_torch import distributed as ptd
    from paddle_tpu_torch.distributed import group as ptd_group
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import meta_parallel as mpl
    from paddle_tpu_torch.models import ErnieConfig, ErnieForPretraining
    from paddle_tpu_torch.models.gpt import (GPTForCausalLM,
                                             GPTPretrainingCriterion,
                                             gpt_pipe_layers)
    from paddle_tpu_torch.optimizer import SGD, Adam
    from paddle_tpu_torch.parallel import zero as Z

    world = ptd.get_group()
    dev = world.device
    count = torch.cuda.device_count()
    cards = len({r % count for r in range(world.nranks)})
    counters = train_counters()
    out = {"backend": world.backend, "device": str(dev), "legs": {}}
    legs = out["legs"]
    ids = fleet_batch(seed, dev, fleet_cfg().vocab_size)

    def zero_counts():
        for fn in counters.values():
            fn.launches = 0

    def counts():
        return {k: fn.launches for k, fn in counters.items()}

    # 1. GPT-3 1.3B, pp 2 x mp 2: fleet.init -> PipelineLayer ->
    # distributed_model -> distributed_optimizer -> train_batch
    t0 = time.perf_counter()
    hcg = _fleet_init(pp=2, mp=2, sharding=1)
    mpl.model_parallel_random_seed(seed, device=dev)
    pipe = mpl.PipelineLayer(gpt_pipe_layers(fleet_cfg(), True, device=dev,
                                             seed=seed),
                             loss_fn=GPTPretrainingCriterion())
    engine = fleet.distributed_model(pipe)
    opt = _NormProbe(fleet.distributed_optimizer(Adam(
        learning_rate=FLEET_LR, parameters=pipe.parameters())), hcg)
    build_s = time.perf_counter() - t0
    zero_counts()
    losses = []
    t0 = time.perf_counter()
    for _ in range(FLEET_STEPS):
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            losses.append(float(engine.train_batch((ids, ids), opt)))
    torch.cuda.synchronize(dev)
    parity_s = time.perf_counter() - t0
    rec = dict(stage=hcg.get_stage_id(), mp_rank=hcg.get_model_parallel_rank(),
               losses=losses, norms=opt.norms, launches=counts(),
               build_s=build_s, parity_s=parity_s,
               params=sum(p.numel() for p in pipe.parameters()))
    # one step at GPT-3's recipe: dropout 0.1, AdamW + clip + schedule
    for mod in pipe.modules():
        if hasattr(mod, "dropout_p"):
            mod.dropout_p = 0.1
        if type(mod).__name__ == "Dropout":
            mod.p = 0.1
    inner, sched = gpt3_recipe(pipe)
    recipe = fleet.distributed_optimizer(inner)
    torch.cuda.synchronize(dev)
    ptd.barrier()
    torch.cuda.reset_peak_memory_stats(dev)
    staged0 = _staged(ptd_group)
    zero_counts()
    t0 = time.perf_counter()
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        loss = float(engine.train_batch((ids, ids), recipe, sched))
    torch.cuda.synchronize(dev)
    ptd.barrier()
    wall = time.perf_counter() - t0
    tokens = FLEET_BATCH[0] * FLEET_BATCH[1]
    rec.update(recipe_loss=loss, recipe_wall_s=wall,
               recipe_launches=counts(),
               tokens_per_s_chip=tokens / wall / cards,
               peak_bytes=torch.cuda.max_memory_allocated(dev),
               staged_bytes_per_step=_staged(ptd_group) - staged0,
               clip=type(inner._grad_clip).__name__)
    legs["pp2 mp2"] = rec
    del pipe, engine, opt, inner, recipe
    _free()
    # 2, 3. pp 2 x dp 2 (mp 1) and its interleaved form, fp32, cut depth:
    # the single-rank bits
    for name, vpp in (("pp2 dp2", 1), ("pp2 dp2 vpp2", 2)):
        _fleet_init(pp=2, dp=2)
        pipe = mpl.PipelineLayer(
            gpt_pipe_layers(fleet_cfg(FLEET_PP_LAYERS), device=dev,
                            seed=seed),
            loss_fn=GPTPretrainingCriterion(),
            num_virtual_pipeline_stages=vpp)
        engine = fleet.distributed_model(pipe)
        opt = fleet.distributed_optimizer(Adam(learning_rate=FLEET_LR,
                                               parameters=pipe.parameters()))
        zero_counts()
        loss = float(engine.train_batch((ids, ids), opt))
        mine = {n: digest(p) for n, p in pipe.named_parameters()}
        legs[name] = dict(
            loss=loss, chunks=pipe.local_chunks(), launches=counts(),
            params=len(mine),
            differ=[n for n, d in mine.items() if d != refs["pp_digests"][n]])
        del pipe, engine, opt
        _free()
    # 4. GroupSharded stage 3 over sharding 4 against ZeroTrainStep(stage 0)
    hcg = _fleet_init(sharding=4)
    group = hcg.get_sharding_parallel_group()
    cfg = fleet_cfg(FLEET_ZERO3_LAYERS)
    per = FLEET_BATCH[0] // world.nranks
    mine = ids[world.rank * per:(world.rank + 1) * per]
    model = GPTForCausalLM(cfg, device=dev, seed=seed)
    model.train()
    wrapped, opt = Z.group_sharded_parallel(
        model, Adam(learning_rate=FLEET_LR, parameters=model.parameters()),
        level="p_g_os", group=group)
    zero_counts()
    t0 = time.perf_counter()
    loss3 = wrapped(mine, labels=mine)
    loss3.backward()
    opt.step()
    torch.cuda.synchronize(dev)
    z3_s = time.perf_counter() - t0
    z3_launches = counts()
    loss3 = float(Z.ordered_psum(loss3.detach().reshape(1), group)[0]
                  * (1.0 / group.nranks))
    names = [n for n, _ in model.named_parameters()]
    d3 = dict(zip(names, (digest(p) for p in wrapped.get_all_parameters())))
    bytes3 = sum(p.numel() * p.element_size() for p in wrapped.parameters())
    opt3 = opt.state_bytes()
    del model, wrapped, opt
    _free()
    model = GPTForCausalLM(cfg, device=dev, seed=seed)
    model.train()

    def causal_loss(params, x, y):
        return functional_call(model, params, (x,), {"labels": y})

    step = Z.zero_train_step(model, Adam(learning_rate=FLEET_LR,
                                         parameters=model.parameters()),
                             causal_loss, stage=0, group=group)
    p, st = step.init_state()
    loss0, p, st = step(p, st, (ids, ids), FLEET_LR, 1)
    d0 = {n: digest(v) for n, v in p.items()}
    legs["group_sharded p_g_os"] = dict(
        loss=loss3, stage0_loss=float(loss0), seconds=z3_s,
        launches=z3_launches, param_bytes=bytes3,
        stage0_param_bytes=step.bytes_per_chip(p), opt_bytes=opt3,
        stage0_opt_bytes=step.optimizer_state_bytes_per_chip(st),
        differ=[n for n in d0 if d0[n] != d3[n]])
    del model, step, p, st
    _free()
    # 5. ZeroTrainStep(tp=2) on ERNIE-1.0 base against tp 1 (dp 2 on
    # the pairs {0, 1} and {2, 3}, which compute the same)
    ecfg = ErnieConfig.ernie_base()
    ecfg.num_hidden_layers = ZERO_LAYERS
    ecfg.hidden_dropout_prob = ecfg.attention_probs_dropout_prob = 0.0
    heads = ecfg.num_attention_heads
    eids = torch.from_numpy(np.random.RandomState(seed).randint(
        0, ecfg.vocab_size, ZERO_BATCH)).to(dev)
    pairs = [ptd.new_group([0, 1]), ptd.new_group([2, 3])]
    runs = {}
    for tp in (1, 2):
        model = ErnieForPretraining(ecfg, device=dev, seed=seed)
        model.train()
        init = {n: p.detach().clone() for n, p in model.named_parameters()}
        opt = SGD(learning_rate=FLEET_TP_LR, parameters=model.parameters())

        def ernie_loss(params, x, y, _m=model):
            loss, _ = functional_call(_m, params, (x,),
                                      {"masked_lm_labels": y})
            return loss

        if tp == 1:
            step = Z.zero_train_step(model, opt, ernie_loss, stage=1,
                                     group=pairs[world.rank // 2])
            start = init
        else:
            # dp 2 x tp 2 carved from the world (rank = d * 2 + t)
            step = Z.zero_train_step(model, opt, ernie_loss, stage=1, dp=2,
                                     tp=2, param_specs=ernie_tp_specs(ecfg))
            ernie_tensor_parallel(model, step.tp_group)
            start = _qkv_layout(init, heads, 2)
        p, st = step.init_state(start)
        zero_counts()
        losses = []
        for t in (1, 2):
            loss, p, st = step(p, st, (eids, eids), FLEET_TP_LR, t)
            losses.append(float(loss))
        got = step.full_params(p)
        if tp == 2:
            got = _qkv_layout(got, heads, 2, inverse=True)
        runs[tp] = dict(losses=losses, launches=counts(),
                        update={n: got[n] - init[n] for n in init})
        del model, step, opt, p, st, got
        _free()
    errs = {}
    for n, d1 in runs[1]["update"].items():
        d2 = runs[2]["update"][n]
        scale = float(torch.linalg.vector_norm(d1))
        errs[n] = (float(torch.linalg.vector_norm(d2 - d1)) / scale
                   if scale > 0 else float(torch.linalg.vector_norm(d2)))
    legs["zero tp2"] = dict(losses=runs[2]["losses"],
                            tp1_losses=runs[1]["losses"],
                            launches=runs[2]["launches"],
                            worst_update=max(errs.items(),
                                             key=lambda kv: kv[1]))
    return out


def phase_train_fleet(seed, dev):
    """Fleet hybrid parallelism (ROADMAP queue 1 item 5a), one world of
    FLEET_RANKS ranks spawned once (gloo on one card, staging through
    pinned host memory; NCCL with a card a rank), after the single-rank
    references (`fleet_references`, freed before the spawn): GPT-3 1.3B at
    pp 2 x mp 2 through fleet.init, PipelineLayer(gpt_pipe_layers(...,
    tensor_parallel=True)), distributed_model, distributed_optimizer and
    train_batch, FLEET_STEPS O1 steps at dropout 0 held to the single-rank
    accumulated step (loss within FLEET_LOSS_RTOL, global gradient norm
    within FLEET_NORM_RTOL), then one step at GPT-3's recipe (dropout
    0.1); pp 2 x dp 2 and its interleaved form (2 stages x 2 chunks) at
    fp32, FLEET_PP_LAYERS deep, bit for bit the single-rank step;
    GroupSharded stage 3 over sharding 4 (FLEET_ZERO3_LAYERS deep, fp32)
    bit for bit ZeroTrainStep(stage=0), parameter bytes a quarter;
    ZeroTrainStep at dp 2 x tp 2 on ERNIE-1.0 base against tp 1 within
    fp32 rounding. Any rank's failure raises."""
    from paddle_tpu_torch import distributed as ptd

    t0 = time.perf_counter()
    refs = fleet_references(seed, dev)
    ref_s = time.perf_counter() - t0
    ranks = ptd.spawn(fleet_world_rank,
                      (seed, {"pp_digests": refs["pp_digests"]}),
                      nprocs=FLEET_RANKS, timeout=900)
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    legs = r0["legs"]
    shared = len({r["device"] for r in ranks}) < FLEET_RANKS
    fails = []
    big = legs["pp2 mp2"]
    log(f"[train_fleet] GPT-3 1.3B at full width ({refs['n_params'] / 1e9:.4f}"
        f" B params), global batch {FLEET_BATCH[0]} x {FLEET_BATCH[1]} in "
        f"{FLEET_ACCUM} micro-batches, O1 bf16, Adam {FLEET_LR}; "
        f"{FLEET_RANKS} ranks on {[r['device'] for r in ranks]} over "
        f"{r0['backend']} ({'ranks share the card' if shared else 'a card a rank'}"
        f"); references {ref_s:.1f} s (peak {refs['peak_bytes'] / 2**30:.2f} "
        f"GiB), phase {wall:.1f} s")
    for i, (ref_loss, ref_norm) in enumerate(refs["steps"]):
        loss, norm = big["losses"][i], big["norms"][i]
        el, en = abs(loss - ref_loss) / ref_loss, abs(norm - ref_norm) / ref_norm
        log(f"[train_fleet] pp 2 x mp 2 step {i + 1}: loss {loss:.6f} against "
            f"the single-rank {ref_loss:.6f} (rel {el:.3g}, tol "
            f"{FLEET_LOSS_RTOL}), global gradient norm {norm:.6f} against "
            f"{ref_norm:.6f} (rel {en:.3g}, tol {FLEET_NORM_RTOL})")
        if not el <= FLEET_LOSS_RTOL:
            fails.append(f"pp2 mp2 step {i + 1} loss {loss} vs {ref_loss}")
        if not en <= FLEET_NORM_RTOL:
            fails.append(f"pp2 mp2 step {i + 1} norm {norm} vs {ref_norm}")
    mfu = big["tokens_per_s_chip"] * refs["flops_per_token"] / \
        PEAK_FLOPS[torch.bfloat16]
    log(f"[train_fleet] pp 2 x mp 2 at GPT-3's recipe (dropout 0.1, AdamW, "
        f"{big['clip']}, warmup + cosine): loss {big['recipe_loss']:.5f}, "
        f"step {big['recipe_wall_s'] * 1e3:.1f} ms, "
        f"{big['tokens_per_s_chip']:.1f} tokens/s/chip, MFU {mfu:.4f}; "
        f"build {big['build_s']:.1f} s, the {FLEET_STEPS} parity steps "
        f"{big['parity_s']:.1f} s")
    for r in ranks:
        b = r["legs"]["pp2 mp2"]
        log(f"[train_fleet]   rank on {r['device']} (stage {b['stage']}, mp "
            f"{b['mp_rank']}): {b['params'] / 1e6:.1f} M params, peak "
            f"{b['peak_bytes'] / 2**30:.2f} GiB, staged "
            f"{b['staged_bytes_per_step'] / 2**20:.1f} MiB a step, launches "
            f"{b['launches']} (parity steps), {b['recipe_launches']} "
            "(recipe step)")
        if any(n <= 0 for n in b["launches"].values()):
            fails.append(f"pp2 mp2: a kernel did not launch: {b['launches']}")
    if not np.isfinite(big["recipe_loss"]):
        fails.append(f"recipe step loss {big['recipe_loss']}")
    for name in ("pp2 dp2", "pp2 dp2 vpp2"):
        for r in ranks:
            rec = r["legs"][name]
            if rec["differ"] or rec["loss"] != refs["pp_loss"]:
                fails.append(f"{name} on {r['device']}: loss {rec['loss']} vs "
                             f"{refs['pp_loss']}, differs at {rec['differ']}")
        rec = legs[name]
        log(f"[train_fleet] {name} (fp32, {FLEET_PP_LAYERS} blocks at full "
            f"width, chunks {[r['legs'][name]['chunks'] for r in ranks]}): "
            f"loss {rec['loss']:.6f}, the single-rank {refs['pp_loss']:.6f}; "
            f"{'bit-identical' if not any(r['legs'][name]['differ'] for r in ranks) else 'DIFFER'}"
            f" over {sum(r['legs'][name]['params'] for r in ranks[::2])} "
            f"parameters; launches {rec['launches']}")
    z = legs["group_sharded p_g_os"]
    log(f"[train_fleet] GroupSharded p_g_os over sharding {FLEET_RANKS} "
        f"(fp32, {FLEET_ZERO3_LAYERS} blocks at full width, one step, "
        f"{z['seconds']:.2f} s): loss {z['loss']:.6f} against stage 0's "
        f"{z['stage0_loss']:.6f}; parameters "
        f"{'bit-identical' if not z['differ'] else 'differ at ' + str(z['differ'][:3])}"
        f"; parameter bytes a rank {z['param_bytes'] / 2**20:.1f} MiB "
        f"against stage 0's {z['stage0_param_bytes'] / 2**20:.1f}, "
        f"optimizer {z['opt_bytes'] / 2**20:.1f} MiB against "
        f"{z['stage0_opt_bytes'] / 2**20:.1f}; launches {z['launches']}")
    for r in ranks:
        rz = r["legs"]["group_sharded p_g_os"]
        if rz["differ"] or rz["loss"] != rz["stage0_loss"]:
            fails.append(f"p_g_os differs from stage 0 on {r['device']} at "
                         f"{rz['differ'][:3]}")
    q = z["stage0_param_bytes"] / FLEET_RANKS
    if not q <= z["param_bytes"] <= q * 1.001:
        fails.append(f"p_g_os parameter bytes {z['param_bytes']} vs stage 0 "
                     f"{z['stage0_param_bytes']} / {FLEET_RANKS}")
    e = legs["zero tp2"]
    worst_name, worst = e["worst_update"]
    lerr = max(abs(a - b) / abs(b) for a, b in zip(e["losses"],
                                                     e["tp1_losses"]))
    log(f"[train_fleet] ZeroTrainStep dp 2 x tp 2 on ERNIE-1.0 base's widths "
        f"at {ZERO_LAYERS} layers (fp32, "
        f"SGD {FLEET_TP_LR}, {ZERO_BATCH[0]} x {ZERO_BATCH[1]}): loss "
        + ", ".join(f"{x:.6f}" for x in e["losses"]) + " against tp 1's "
        + ", ".join(f"{x:.6f}" for x in e["tp1_losses"])
        + f" (rel {lerr:.3g}, tol {FLEET_TP_LOSS_RTOL}); worst update "
        f"{worst_name} rel {worst:.3g} (tol {FLEET_TP_UPDATE_RTOL}); "
        f"launches {e['launches']}")
    if not lerr <= FLEET_TP_LOSS_RTOL or not worst <= FLEET_TP_UPDATE_RTOL:
        fails.append(f"zero tp2 vs tp1: loss rel {lerr}, update {worst_name} "
                     f"rel {worst}")
    if fails:
        raise AssertionError("train_fleet: " + "; ".join(fails))
    launches = {k: sum(r["legs"][n][key][k] for r in ranks for n, key in (
        ("pp2 mp2", "launches"), ("pp2 mp2", "recipe_launches"),
        ("pp2 dp2", "launches"), ("pp2 dp2 vpp2", "launches"),
        ("group_sharded p_g_os", "launches"), ("zero tp2", "launches")))
        for k in TRAIN_LAUNCHES}
    return dict(backend=r0["backend"], shared_card=shared, wall_s=wall,
                references=dict(steps=refs["steps"], pp_loss=refs["pp_loss"],
                                seconds=ref_s, peak_bytes=refs["peak_bytes"],
                                n_params=refs["n_params"]),
                mfu=mfu, legs=legs,
                per_rank=[r["legs"] for r in ranks], launches=launches)


# ---------------------------------------------- train_dp (fleetrun, DP)
DP_RANKS = 4
# the Train ERNIE ZeRO cell's global batch: 8 x 512 a rank
DP_BATCH = (32, 512)
# warm-up + timed DataParallel steps (as ZERO_STEPS), then one more step
# while the async checkpoint is written
DP_STEPS = (1, 1)            # (1, 2) until PR 18
DP_LR = 1e-4
DP_TIMEOUT = 600
# the Engine leg: GPT-3 1.3B's widths, ENGINE_LAYERS deep, fp32, a batch
# of 4 x 512 over ProcessMesh([[0, 1], [2, 3]], ["dp", "mp"]); 2 SGD steps
# held to the dense single-rank model's 2 eager steps within the
# reference test's limits (tests/test_auto_parallel_engine.py:70-96)
ENGINE_LAYERS = 2
ENGINE_BATCH = (4, 512)
ENGINE_LR = 0.1
ENGINE_RTOL, ENGINE_ATOL = 2e-4, 1e-5
# the ["sharding", "mp"] mesh's Adam losses against the dp mesh's
ENGINE_LOSS_RTOL = 1e-5


def _dp_dataset(seed, cfg, steps):
    """The seeded token dataset: enough rows of DP_BATCH[1] tokens for
    `steps` global batches (ids and MLM labels, on the host)."""
    from paddle_tpu_torch.io import Dataset

    rng = np.random.RandomState(seed)
    n = DP_BATCH[0] * steps
    ids = rng.randint(0, cfg.vocab_size, (n, DP_BATCH[1])).astype(np.int64)
    labels = rng.randint(0, cfg.vocab_size, (n, DP_BATCH[1])
                         ).astype(np.int64)

    class Tokens(Dataset):
        def __len__(self):
            return n

        def __getitem__(self, i):
            return ids[i], labels[i]

    return Tokens(), ids, labels


def dp_collectives(g, dev):
    """The new collectives on CUDA tensors over `g`, each against its
    definition on seeded inputs (every rank computes every rank's input):
    {name: max abs error} (0 where exact) and {name: ok} of the object and
    point-to-point ones."""
    from paddle_tpu_torch import distributed as ptd
    from paddle_tpu_torch.parallel.mesh import fixed_order_sum

    n, me = g.nranks, g.rank

    def x(r, shape=(1000,)):
        gen = torch.Generator().manual_seed(1000 + r)
        return torch.randn(shape, generator=gen).to(dev)

    xs = [x(r) for r in range(n)]
    errs = {}
    t = xs[me].clone()
    ptd.broadcast(t, src=2, group=g)
    errs["broadcast"] = max_err(t, xs[2])
    t = xs[me].clone()
    ptd.reduce(t, dst=1, group=g)
    errs["reduce"] = max_err(t, fixed_order_sum(xs) if me == 1 else xs[me])
    parts = [[x(10 * r + j, (250,)) for j in range(n)] for r in range(n)]
    t = torch.empty(250, device=dev)
    ptd.reduce_scatter(t, parts[me], group=g)
    errs["reduce_scatter"] = max_err(
        t, fixed_order_sum([parts[r][me] for r in range(n)]))
    t = torch.empty(250, device=dev)
    ptd.scatter(t, parts[0] if me == 0 else None, src=0, group=g)
    errs["scatter"] = max_err(t, parts[0][me])
    got = ptd.alltoall([], parts[me], group=g)
    errs["alltoall"] = max(max_err(got[j], parts[j][me]) for j in range(n))
    recv_t = torch.empty(1000, device=dev)
    # even ranks send first, odd ranks receive first: NCCL makes a pair's
    # communicator at the pair's first exchange, and every rank sending
    # first around the ring would wait on its neighbour forever
    if me % 2 == 0:
        reqs = [ptd.isend(xs[me], (me + 1) % n, g),
                ptd.irecv(recv_t, (me - 1) % n, g)]
    else:
        reqs = [ptd.irecv(recv_t, (me - 1) % n, g),
                ptd.isend(xs[me], (me + 1) % n, g)]
    for r in reqs:
        ptd.wait(r)
    errs["isend_irecv"] = max_err(recv_t, xs[(me - 1) % n])
    objs = ptd.all_gather_object([], {"rank": me}, g)
    lst = [me, "r" * me]
    ptd.broadcast_object_list(lst, src=3, group=g)
    mine = ptd.scatter_object_list(
        [], [f"o{j}" for j in range(n)] if me == 0 else None, 0, g)
    ok = {"all_gather_object": objs == [{"rank": r} for r in range(n)],
          "broadcast_object_list": lst == [3, "rrr"],
          "scatter_object_list": mine == [f"o{me}"],
          "backend": ptd.get_backend(g) == g.backend.upper()}
    return errs, ok


def _engine_cfg():
    from paddle_tpu_torch.models import GPTConfig

    cfg = GPTConfig.gpt3_1p3b()
    cfg.num_hidden_layers = ENGINE_LAYERS
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    return cfg


def _engine_data(seed, dev, cfg):
    g = torch.Generator(device="cpu").manual_seed(seed + 17)
    ids = torch.randint(0, cfg.vocab_size, ENGINE_BATCH, generator=g)
    target = torch.randn(*ENGINE_BATCH, cfg.hidden_size, generator=g)
    return ids.to(dev), target.to(dev)


def _mse(out, target):
    return torch.mean((out - target) ** 2)


def dp_engine_legs(seed, dev, counters):
    """The Engine legs of a train_dp rank: GPT-3 1.3B's widths at
    ENGINE_LAYERS, built dense, then partitioned over dp 2 x mp 2 (2 SGD
    steps; rank 0 holds the gathered parameters to the dense model's 2
    eager steps); then Adam on the dp mesh and on a ["sharding", "mp"]
    mesh (ZeRO-1)."""
    from paddle_tpu_torch import distributed as ptd
    from paddle_tpu_torch.distributed.fleet.meta_parallel.parallel_layers \
        import mp_full_parameters
    from paddle_tpu_torch.io import TensorDataset
    from paddle_tpu_torch.models import GPTModel
    from paddle_tpu_torch.optimizer import SGD, Adam

    cfg = _engine_cfg()
    ids, target = _engine_data(seed, dev, cfg)
    ds = TensorDataset([ids, target])
    mesh = ptd.ProcessMesh([[0, 1], [2, 3]], ["dp", "mp"])
    out = {}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    model = GPTModel(cfg, tensor_parallel=True, device=dev, seed=seed)
    eng = ptd.Engine(model, loss=_mse, optimizer=SGD(
        learning_rate=ENGINE_LR, parameters=model.parameters()), mesh=mesh)
    hist = eng.fit(ds, epochs=2, batch_size=ENGINE_BATCH[0])
    torch.cuda.synchronize(dev)
    out["sgd"] = dict(losses=list(hist["loss"]),
                      wall_s=time.perf_counter() - t0,
                      launches={k: fn.launches for k, fn in
                                counters.items()},
                      local_params=sum(p.numel()
                                       for p in model.parameters()))
    full = mp_full_parameters(model)
    if ptd.get_rank() == 0:
        dense = GPTModel(cfg, tensor_parallel=True, device=dev, seed=seed)
        opt = SGD(learning_rate=ENGINE_LR, parameters=dense.parameters())
        ref_losses = []
        for _ in range(2):
            loss = _mse(dense(ids), target)
            loss.backward()
            opt.step()
            opt.clear_grad()
            ref_losses.append(float(loss))
        worst, worst_name = 0.0, None
        for name, p in dense.named_parameters():
            got, ref = full[name].float(), p.detach().float()
            # the excess over the reference test's allclose limit
            over = float(((got - ref).abs() - ENGINE_RTOL * ref.abs()).max())
            if over > worst or worst_name is None:
                worst, worst_name = over, name
        out["sgd"].update(ref_losses=ref_losses, worst_excess=worst,
                          worst_name=worst_name,
                          n_params=sum(p.numel()
                                       for p in dense.parameters()))
        del dense, opt
    del model, eng, full
    gc.collect()
    torch.cuda.empty_cache()
    for axes in (("dp", "mp"), ("sharding", "mp")):
        t0 = time.perf_counter()
        m = mesh if axes[0] == "dp" else ptd.ProcessMesh(
            [[0, 1], [2, 3]], list(axes))
        model = GPTModel(cfg, tensor_parallel=True, device=dev, seed=seed)
        eng = ptd.Engine(model, loss=_mse, optimizer=Adam(
            learning_rate=1e-4, parameters=model.parameters()), mesh=m)
        hist = eng.fit(ds, epochs=2, batch_size=ENGINE_BATCH[0])
        torch.cuda.synchronize(dev)
        out[axes[0]] = dict(losses=list(hist["loss"]),
                            opt_bytes=eng.optimizer_state_bytes(),
                            wall_s=time.perf_counter() - t0)
        del model, eng
        gc.collect()
        torch.cuda.empty_cache()
    return out


def dp_worker(out_dir, seed):
    """One rank of phase_train_dp, started by the port's launcher
    (`python -m paddle_tpu_torch.distributed.launch ... chip_smoke.py
    --dp-worker DIR`): joins the launcher's world with
    `init_parallel_env()`, runs every leg and writes its readings to
    DIR/rank<r>.json (rank 0 also DIR/snapshot.json, the digests of the
    checkpointed tensors)."""
    from torch.func import functional_call

    from paddle_tpu_torch import amp
    from paddle_tpu_torch import distributed as ptd
    from paddle_tpu_torch.distributed import checkpoint as ck
    from paddle_tpu_torch.distributed import group as ptd_group
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.io import DataLoader, DistributedBatchSampler
    from paddle_tpu_torch.models import ErnieConfig, ErnieForPretraining
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.parallel import zero as Z
    from paddle_tpu_torch.parallel.mesh import ordered_psum

    if not torch.cuda.is_available():
        raise RuntimeError("train_dp rank: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = ptd.init_parallel_env()
    dev, me = world.device, world.rank
    deterministic_library_ops().__enter__()     # this rank's process only
    count = torch.cuda.device_count()
    cards = len({r % count for r in range(world.nranks)})
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": world.nranks}
    # the NSP head and the pooler take no part in the MLM loss
    strategy.find_unused_parameters = True
    fleet.init(is_collective=True, strategy=strategy)
    out = {"rank": me, "backend": world.backend, "device": str(dev),
           "env": {k: os.environ.get(k) for k in (
               "PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM", "PADDLE_MASTER",
               "PADDLE_LOCAL_RANK")}}
    counters = train_counters()

    cfg = ErnieConfig.ernie_base()
    cfg.num_hidden_layers = ZERO_LAYERS
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    cfg.fused_mlm_loss = True
    steps = sum(DP_STEPS) + 1
    ds, ids_all, labels_all = _dp_dataset(seed, cfg, steps)
    per = DP_BATCH[0] // world.nranks
    loader = DataLoader(ds, batch_sampler=DistributedBatchSampler(
        ds, batch_size=per, shuffle=True), places=dev)
    # the global batches the ranks' samplers make, in rank order
    samplers = [DistributedBatchSampler(ds, per, num_replicas=world.nranks,
                                        rank=r, shuffle=True)
                for r in range(world.nranks)]
    order = [sum(b, []) for b in zip(*samplers)]
    model = ErnieForPretraining(cfg, device=dev, seed=seed)
    model.train()
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    gen = torch.Generator(device=dev).manual_seed(seed)

    # the reference: ZeroTrainStep(stage=0) on the same global batches
    def loss_fn(params, ids_, labels_):
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            return functional_call(model, params, (ids_,), {
                "masked_lm_labels": labels_, "generator": gen})[0]

    zstep = Z.zero_train_step(model, Adam(learning_rate=DP_LR,
                                          parameters=model.parameters()),
                              loss_fn, stage=0, group=world)
    zp, zst = zstep.init_state(init)
    z_losses = []
    for t in range(1, sum(DP_STEPS) + 1):
        idx = order[t - 1]
        batch = (torch.from_numpy(ids_all[idx]).to(dev),
                 torch.from_numpy(labels_all[idx]).to(dev))
        loss, zp, zst = zstep(zp, zst, batch, DP_LR, t)
        z_losses.append(float(loss))
    del zst, zstep
    torch.cuda.synchronize(dev)
    log(f"[train_dp rank {me}] ZeroTrainStep(stage=0) reference done")

    # DataParallel through fleet, fed by DistributedBatchSampler
    dp = fleet.distributed_model(model)
    opt = Adam(learning_rate=DP_LR, parameters=model.parameters())
    batches = iter(loader)

    def dp_step():
        x, y = next(batches)
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            loss, _ = dp(x, masked_lm_labels=y, generator=gen)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return float(ordered_psum(loss.detach().float().reshape(1),
                                  dp.group)[0] * (1.0 / dp.group.nranks))

    warm, timed = DP_STEPS
    losses = [dp_step() for _ in range(warm)]
    torch.cuda.synchronize(dev)
    ptd.barrier(world)
    staged0 = _staged(ptd_group)
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    losses += [dp_step() for _ in range(timed)]
    torch.cuda.synchronize(dev)
    ptd.barrier(world)
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    differ = [n for n, p in model.named_parameters()
              if not torch.equal(p.detach(), zp[n])]
    tokens = DP_BATCH[0] * DP_BATCH[1]
    out["dp"] = dict(losses=losses, zero_losses=z_losses, differ=differ,
                     step_ms=wall / timed * 1e3,
                     tokens_per_s_chip=tokens * timed / wall / cards,
                     staged_bytes_per_step=(_staged(ptd_group) - staged0)
                     / timed,
                     peak_bytes=torch.cuda.max_memory_allocated(dev),
                     launches=launches, buckets=len(dp._buckets),
                     group=list(dp.group.ranks))
    del zp
    log(f"[train_dp rank {me}] DataParallel steps done")

    # the collectives on CUDA tensors
    out["collectives"] = dp_collectives(world, dev)
    log(f"[train_dp rank {me}] collectives done")

    # the async checkpoint: saved at dp 4, one more step while it is
    # written, then wait_save; the parent loads it at world 1
    ckpt = os.path.join(out_dir, "ckpt")
    state = {"model": dp.state_dict(), "opt": opt.state_dict()}
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    ck.save_state_dict(state, ckpt, async_save=True)
    save_s = time.perf_counter() - t0
    if me == 0:
        snap = {k: digest(v) if isinstance(v, torch.Tensor) else v
                for k, v in _flat_state(state).items()}
        with open(os.path.join(out_dir, "snapshot.json"), "w") as f:
            json.dump(snap, f)
    losses.append(dp_step())
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    ck.wait_save()
    out["checkpoint"] = dict(save_s=save_s,
                             wait_s=time.perf_counter() - t0)
    log(f"[train_dp rank {me}] checkpoint done")
    del state, dp, opt, model, init
    gc.collect()
    torch.cuda.empty_cache()

    out["engine"] = dp_engine_legs(seed, dev, counters)
    log(f"[train_dp rank {me}] Engine legs done")
    with open(os.path.join(out_dir, f"rank{me}.json"), "w") as f:
        json.dump(out, f)
    ptd.barrier(world)
    ptd.destroy_process_group()
    return 0


def _flat_state(state, prefix=""):
    """A nested state dict as {dotted name: value}."""
    out = {}
    for k, v in state.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flat_state(v, key))
        else:
            out[key] = v
    return out


def _tails(log_dir, n=3000):
    """The last `n` characters of each rank's log."""
    out = []
    for name in sorted(os.listdir(log_dir)):
        with open(os.path.join(log_dir, name), errors="replace") as f:
            out.append(f"--- {name}:\n{f.read()[-n:]}")
    return "\n".join(out)


def phase_train_dp(seed, dev):
    """ERNIE-1.0 base's widths (ZERO_LAYERS deep) trained data-parallel
    through the port's own launcher (ROADMAP queue 1 item 5b): `python -m
    paddle_tpu_torch.distributed.launch --nproc_per_node DP_RANKS` runs
    this script's `--dp-worker` mode (dp_worker) on every rank: fleet.init
    at dp 4, DistributedBatchSampler + DataLoader, fleet.distributed_model
    (a DataParallel), O1 Adam at dropout 0, bit for bit against
    ZeroTrainStep(stage=0) on the same global batches; the new collectives
    on CUDA tensors; an async dp-4 checkpoint of the model and the
    optimizer, loaded here at world 1 into a fresh model and optimizer,
    every tensor bit for bit rank 0's snapshot; the Engine legs. A rank
    that fails fails the phase (its log's tail in the error)."""
    import socket
    import tempfile

    from paddle_tpu_torch.distributed import checkpoint as ck
    from paddle_tpu_torch.models import ErnieConfig, ErnieForPretraining
    from paddle_tpu_torch.optimizer import Adam

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="ptt_dp_") as tmp:
        logs = os.path.join(tmp, "logs")
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        here = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ)
        env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
        cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
               "--nproc_per_node", str(DP_RANKS), "--master",
               f"127.0.0.1:{port}", "--log_dir", logs,
               os.path.join(here, "chip_smoke.py"), "--dp-worker", tmp,
               "--seed", str(seed)]
        try:
            proc = subprocess.run(cmd, env=env, cwd=here, timeout=DP_TIMEOUT,
                                  capture_output=True, text=True)
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"train_dp: the launcher passed {DP_TIMEOUT} "
                               f"s\n{_tails(logs)}") from None
        if proc.returncode != 0:
            raise RuntimeError(f"train_dp: fleetrun exited "
                               f"{proc.returncode}\n{proc.stderr[-2000:]}\n"
                               f"{_tails(logs)}")
        launch_s = time.perf_counter() - t0
        ranks = []
        for r in range(DP_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        with open(os.path.join(tmp, "snapshot.json")) as f:
            snap = json.load(f)
        ckpt = os.path.join(tmp, "ckpt")
        ckpt_bytes = sum(os.path.getsize(os.path.join(ckpt, n))
                         for n in os.listdir(ckpt))
        # world 1: a fresh model (another seed) and optimizer, its slots
        # made by one step over zero gradients, filled from the checkpoint
        cfg = ErnieConfig.ernie_base()
        cfg.num_hidden_layers = ZERO_LAYERS       # the dp worker's model
        model = ErnieForPretraining(cfg, device=dev, seed=seed + 1)
        opt = Adam(learning_rate=DP_LR, parameters=model.parameters())
        opt.step()
        target = {"model": model.state_dict(), "opt": opt.state_dict()}
        t1 = time.perf_counter()
        ck.load_state_dict(target, ckpt)
        opt.set_state_dict(target["opt"])
        torch.cuda.synchronize(dev)
        load_s = time.perf_counter() - t1
        loaded = {k: digest(v) if isinstance(v, torch.Tensor) else v
                  for k, v in _flat_state(target).items()}
        del model, opt, target
    wall = time.perf_counter() - t0
    fails = []
    r0 = ranks[0]
    d0 = r0["dp"]
    shared = len({r["device"] for r in ranks}) < DP_RANKS
    log(f"[train_dp] ERNIE-1.0 base's widths at {ZERO_LAYERS} layers "
        f"through fleetrun: {DP_RANKS} ranks on "
        f"{[r['device'] for r in ranks]} over {r0['backend']} "
        f"({'ranks share the card' if shared else 'a card a rank'}), "
        f"launcher env {r0['env']}; global batch {DP_BATCH[0]} x "
        f"{DP_BATCH[1]} ({DP_BATCH[0] // DP_RANKS} a rank from "
        f"DistributedBatchSampler), O1 bf16, dropout 0, Adam {DP_LR}, "
        f"{DP_STEPS[0]} + {DP_STEPS[1]} steps; fleetrun {launch_s:.1f} s, "
        f"phase {wall:.1f} s")
    for r in ranks:
        d = r["dp"]
        if d["differ"] or d["losses"][:sum(DP_STEPS)] != d["zero_losses"]:
            fails.append(f"rank {r['rank']}: DataParallel differs from "
                         f"ZeroTrainStep(stage=0) at {d['differ'][:3]}, "
                         f"losses {d['losses']} vs {d['zero_losses']}")
        if any(n <= 0 for n in d["launches"].values()):
            fails.append(f"rank {r['rank']}: a kernel did not launch: "
                         f"{d['launches']}")
        if not all(np.isfinite(d["losses"])):
            fails.append(f"rank {r['rank']}: non-finite loss")
        log(f"[train_dp]   rank {r['rank']} on {r['device']}: step "
            f"{d['step_ms']:.1f} ms, staged "
            f"{d['staged_bytes_per_step'] / 2**20:.1f} MiB a step, peak "
            f"{d['peak_bytes'] / 2**30:.2f} GiB, launches {d['launches']} "
            f"({DP_STEPS[1]} steps), {d['buckets']} buckets over "
            f"{d['group']}")
    log(f"[train_dp] DataParallel: loss "
        + ", ".join(f"{x:.6f}" for x in d0["losses"])
        + f"; ZeroTrainStep(stage=0) "
        + ", ".join(f"{x:.6f}" for x in d0["zero_losses"])
        + f"; parameters {'bit-identical' if not d0['differ'] else 'DIFFER'}"
        f"; step {d0['step_ms']:.1f} ms, "
        f"{d0['tokens_per_s_chip']:.1f} tokens/s/chip")
    for r in ranks:
        errs, ok = r["collectives"]
        bad = [k for k, e in errs.items() if not e <= 1e-6] + \
            [k for k, v in ok.items() if not v]
        if bad:
            fails.append(f"rank {r['rank']}: collectives {bad}: {errs} {ok}")
    log(f"[train_dp] collectives on CUDA tensors (rank 0, max abs error "
        f"against the definition): {r0['collectives'][0]}; objects and "
        f"backend {r0['collectives'][1]}")
    differ = sorted(k for k in snap if loaded.get(k) != snap[k])
    c = r0["checkpoint"]
    log(f"[train_dp] async checkpoint at dp {DP_RANKS}: "
        f"{ckpt_bytes / 2**30:.3f} GiB ({len(snap)} entries), save "
        f"{c['save_s']:.3f} s (the snapshot), wait {c['wait_s']:.3f} s "
        f"after one more step; loaded at world 1 in {load_s:.3f} s: "
        f"{'every tensor bit-identical to rank 0' if not differ else 'DIFFER'}")
    if differ:
        fails.append(f"checkpoint loaded at world 1 differs at {differ[:3]}")
    e = r0["engine"]
    s = e["sgd"]
    lrel = max(abs(a - b) / abs(b) for a, b in zip(s["losses"],
                                                   s["ref_losses"]))
    log(f"[train_dp] Engine, GPT-3 1.3B widths at {ENGINE_LAYERS} layers "
        f"({s['n_params'] / 1e6:.1f} M parameters, {s['local_params'] / 1e6:.1f}"
        f" M a rank), fp32, {ENGINE_BATCH[0]} x {ENGINE_BATCH[1]} over dp 2 x "
        f"mp 2: 2 SGD steps, loss "
        + ", ".join(f"{x:.6f}" for x in s["losses"]) + " against the dense "
        + ", ".join(f"{x:.6f}" for x in s["ref_losses"])
        + f" (rel {lrel:.3g}); worst parameter {s['worst_name']} past "
        f"rtol {ENGINE_RTOL} by {s['worst_excess']:.3g} (atol {ENGINE_ATOL})"
        f"; {s['wall_s']:.1f} s, launches {s['launches']}")
    if not s["worst_excess"] <= ENGINE_ATOL:
        fails.append(f"Engine parameters past the limits: {s['worst_name']}"
                     f" {s['worst_excess']}")
    if not lrel <= ENGINE_RTOL:
        fails.append(f"Engine losses {s['losses']} vs {s['ref_losses']}")
    sh, dpm = e["sharding"], e["dp"]
    srel = max(abs(a - b) / abs(b) for a, b in zip(sh["losses"],
                                                   dpm["losses"]))
    log(f"[train_dp] Engine Adam on ['sharding', 'mp'] (ZeRO-1): loss "
        + ", ".join(f"{x:.6f}" for x in sh["losses"]) + " against ['dp', "
        "'mp'] " + ", ".join(f"{x:.6f}" for x in dpm["losses"])
        + f" (rel {srel:.3g}, tol {ENGINE_LOSS_RTOL}); optimizer "
        f"{sh['opt_bytes'] / 2**20:.1f} against {dpm['opt_bytes'] / 2**20:.1f}"
        f" MiB a rank; {sh['wall_s']:.1f} / {dpm['wall_s']:.1f} s")
    if not srel <= ENGINE_LOSS_RTOL:
        fails.append(f"sharding mesh losses {sh['losses']} vs "
                     f"{dpm['losses']}")
    if not dpm["opt_bytes"] / 2 <= sh["opt_bytes"] <= dpm["opt_bytes"] / 2 \
            * 1.001:
        fails.append(f"sharding mesh optimizer bytes {sh['opt_bytes']} vs "
                     f"{dpm['opt_bytes']} / 2")
    if fails:
        raise AssertionError("train_dp: " + "; ".join(fails))
    launches = {k: sum(r["dp"]["launches"][k] + r["engine"]["sgd"][
        "launches"][k] for r in ranks) for k in TRAIN_LAUNCHES}
    return dict(backend=r0["backend"], shared_card=shared, wall_s=wall,
                launch_s=launch_s, ckpt_bytes=ckpt_bytes, load_s=load_s,
                per_rank=ranks, launches=launches)


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
    training path's shapes for K1-K5, with GPT-3 1.3B's training shapes
    beside them, and K1's static decode shape; T5's encoder for K2 with
    d(mask) (its
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
        gpt_keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "dtype", "case")
        if k in ("K1", "K2", "K3"):
            entry["gpt_train"] = {x: main_rows[f"{k} gpt"][x]
                                  for x in gpt_keys}
        plane = {key[len(k) + 7:]: {x: row[x] for x in gpt_keys}
                 for key, row in main_rows.items()
                 if key.startswith(f"{k} plane ")}
        if plane:
            entry["training_plane"] = plane
        if f"{k} fleet" in main_rows:
            entry["fleet_rank"] = {x: main_rows[f"{k} fleet"][x]
                                   for x in gpt_keys}
        for tag in ("dp", "engine"):
            if f"{k} {tag}" in main_rows:
                entry[f"{tag}_rank"] = {x: main_rows[f"{k} {tag}"][x]
                                        for x in gpt_keys}
        tfb = {key[len(k) + 5:] or "rows": {x: row[x] for x in gpt_keys}
               for key, row in main_rows.items()
               if key.startswith(f"{k} tfb")}
        if tfb:
            entry["transformer_base"] = tfb
        if k in ("K4", "K5"):
            entry["gpt_layer_norm"] = [
                {x: row[x] for x in gpt_keys} for key, row in
                main_rows.items() if key.startswith(f"{k} gpt")]
        if k == "K1":
            entry["static_decode"] = dict(
                {x: main_rows["K1 static decode"][x] for x in gpt_keys},
                whole_cache_bound_ms=main_rows["K1 static decode"][
                    "whole_cache_bound_ms"])
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
        shards = {key[len(k) + 1:]: {x: row[x] for x in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "dtype", "case")}
            for key, row in main_rows.items()
            if key.startswith(f"{k} tp")}
        if shards:
            entry["tp_shards"] = shards
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
                         "serve, two speculative blocks, one ERNIE, one "
                         "recomputed ERNIE, one T5, one GPT (O1 and O2) "
                         "and one MoE train step with torch.profiler")
    ap.add_argument("--dp-worker", default=None, metavar="DIR",
                    help="run one rank of the train_dp phase (the phase "
                         "starts it through the port's launcher) and write "
                         "its readings to DIR")
    args = ap.parse_args(argv)
    if args.dp_worker:
        return dp_worker(args.dp_worker, args.seed)
    t_start = time.perf_counter()
    smi = phase_device()
    dev = torch.device("cuda", 0)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    result = {"nvidia_smi": smi, "build_s": phase_build(args.out),
              "phase_s": {}}
    rows, main_rows, launches = [], {}, {}
    mark = [time.perf_counter()]
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
    main_rows.update(gpt_kernel_cases(rows, dev))
    main_rows.update(fleet_kernel_cases(rows, dev))
    main_rows.update(dp_kernel_cases(rows, dev))
    main_rows.update(vision_kernel_cases(rows, dev))
    main_rows.update(plane_kernel_cases(rows, dev))
    main_rows.update(k9_cases(rows, dev, args.seed))
    main_rows.update(phase_ring_kernels(rows, dev))
    main_rows.update(tp_kernel_cases(rows, dev))
    result["row_chunk_products"] = row_chunk_products(dev)
    result["cases"] = [dict(kernel=k, **r) for k, r in rows]

    def release():
        # the engine and model of a phase hold reference cycles: collect
        # them before the next phase measures its own peak memory
        gc.collect()
        torch.cuda.empty_cache()
        # the wall since the last release, under the newest result key
        now = time.perf_counter()
        key = list(result)[-1]
        result["phase_s"][key] = now - mark[0]
        mark[0] = now
        log(f"[time] {key}: {result['phase_s'][key]:.1f} s")

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
    r = phase_serve_cluster(model, args.seed, dev, args.out)
    result["serve_cluster"] = r
    launches["serve_cluster"] = r["launches"]
    release()
    r = phase_serve_observed(model, args.seed, dev, args.out)
    result["serve_observed"] = r
    launches["serve_observed"] = r["launches"]
    release()
    result["serve_tp"] = r = phase_serve_tp(model, args.seed, dev)
    for tag, run in r.items():
        launches[f"serve_tp {tag}"] = run["launches"]
    release()
    t0 = time.perf_counter()
    r = phase_serve_prefix_spec(model, args.seed, dev, args.profile,
                                args.out)
    result["serve_prefix_spec"] = spec = r
    launches["serve_prefix_spec"] = r["launches"]
    release()
    spec_s = time.perf_counter() - t0
    result["generate"] = r = phase_generate(model, args.seed, dev)
    launches["generate"] = r["launches"]
    del model
    release()
    t0 = time.perf_counter()
    result["spec_fp32"] = phase_spec_fp32(args.seed, dev)
    release()
    spec["phases_s"] = spec_s + time.perf_counter() - t0
    log(f"[serve_prefix_spec] this phase and spec_fp32 took "
        f"{spec['phases_s']:.1f} s")
    result["recovery_fp32"] = phase_recovery_fp32(args.seed, dev)
    release()
    result["cluster_fp32"] = phase_cluster_fp32(args.seed, dev)
    release()
    result["serve_tp_fp32"] = phase_serve_tp_fp32(args.seed, dev)
    release()
    result["cluster_tp"] = phase_cluster_tp(args.seed, dev)
    release()
    result["generate_fp32"] = phase_generate_fp32(args.seed, dev)
    release()
    result["generate_t5"] = r = phase_generate_t5(args.seed, dev)
    launches["generate_t5"] = r["launches"]
    release()
    result["serve_gpt"] = r = phase_serve_gpt(args.seed, dev)
    for tag, run in r.items():
        launches[tag] = run["launches"]
    release()
    result["train"] = phase_train(args.seed, dev, args.profile, args.out)
    launches["train"] = result["train"]["launches"]
    release()
    result["step_check"] = phase_step_check(args.seed, dev)
    release()
    result["dygraph"] = r = phase_dygraph(args.seed, dev, result["train"],
                                          args.profile, args.out)
    launches["dygraph"] = r["launches"]
    release()
    result["vision"] = r = phase_vision(args.seed, dev, args.out)
    launches["vision"] = r["launches"]
    release()
    result["embedding_determinism"] = embedding_determinism(args.seed, dev)
    release()
    result["recompute"] = r = phase_recompute(args.seed, dev, args.profile,
                                              args.out)
    launches["recompute"] = r["launches"]
    release()
    result["train_gpt"] = phase_train_gpt(args.seed, dev, args.profile,
                                          args.out)
    launches["train_gpt"] = result["train_gpt"]["launches"]
    release()
    result["train_gpt_o2"] = r = phase_train_gpt_o2(
        args.seed, dev, result["train_gpt"], args.profile, args.out)
    launches["train_gpt_o2"] = r["launches"]
    release()
    result["gpt_step_check"] = phase_gpt_step_check(args.seed, dev)
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
    release()
    result["train_zero"] = r = phase_train_zero(args.seed, dev)
    launches["train_zero"] = r["launches"]
    release()
    result["train_fleet"] = r = phase_train_fleet(args.seed, dev)
    launches["train_fleet"] = r["launches"]
    release()
    result["train_dp"] = r = phase_train_dp(args.seed, dev)
    launches["train_dp"] = r["launches"]
    release()
    result["seconds"] = time.perf_counter() - t_start
    result["summary"] = summarize(main_rows, launches)
    if args.out:
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(result, f, indent=1)
    log(f"[done] {result['seconds']:.1f} s in all on {smi}")
    print(json.dumps(result["summary"]), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
