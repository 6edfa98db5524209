#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and nothing catches it:

  1. device line (name, ``nvidia-smi`` name and power limit), TF32 off;
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc);
  3. kernel phase at the main path's shapes (Mistral-NeMo-12B attention:
     Hq 32, Hkv 8, d 128, page = tile 128, one stream-K worker per SM, a
     ragged batch on shuffled pages): K1 (+ merge) and K2 against their
     plain PyTorch versions in float32 and bf16, dense == paged bit for
     bit, kernel / plain / library times and the bound; then the fused K4
     (stream-K chunk prefill with its merge in the launch: the chunk path's
     kernel, on the tensor cores in bf16), K4's partials (the ``fused=False``
     path) and K8 on a pack of two 256-token prompt chunks, K6 (fixed
     split) against K2 on
     two decode shapes -- the paper's comparison -- and K7 (whole-prompt
     FA-2 prefill) on a 3000-token causal prompt, with a 1024-token sliding
     window, and non-causal 37 x 150; then the int8 forms of K1, K2, K4
     (fused, and partials) and K5 (bf16 queries, int8 pool rows with a
     float32 scale per row) against
     their plain versions on the same decode batch (one sequence on a
     zero-scale page, which must read exact zeros), chunk pack and shared
     prefix, timed beside SDPA on the K/V dequantized to bf16; and the page
     sizes the port once refused: K8, K4 and K6 on pages of 12 and 100 (bf16)
     and 256 (float32 and bf16) at d 128;
  4. engine phase: Mistral-NeMo-12B at full width, random bf16 weights from
     a seeded generator, served through ``DecodeEngine`` (paged, blocking
     admission through K7 at the bucket length, lean decode through K2,
     every step -- decode, chunk, verify, admission -- replayed as a
     captured CUDA graph from its key's second sighting on: the engine's
     path on the card, as in every serving phase below); then the same
     prompts again on that engine
     with a few decode ticks under ``torch.profiler``: device busy, device
     kernels, host launch calls and idle share per tick;
  5. the same model with ``fused=False`` for a few ticks (K1 + merge);
  6. the first decode tick of a ``'ref'``-backend engine against the lean
     one on the same weights and prompts;
  7. scheduler phases: the same prompts served by ``Scheduler`` with
     chunked prefill on the ``lean`` backend (fused K4 chunks, K2 decode) and
     on
     ``fixed`` (K8 chunks, K6 decode), in turns lean, fixed, fixed, lean:
     steps, launches, TTFT, decode tokens flowing during the long prefill,
     first tokens against the blocking engine's; then the fixed phase
     under ``torch.profiler`` at ``TRACED_FIXED_LAYERS`` of depth: device
     busy, kernels, host syncs (``aten::item``) -- the lean one is traced
     in phase 12;
  8. prefix-sharing serving phase: a 2048-token system prompt served once,
     then four requests that start with it, through the ``Scheduler`` with
     the radix prefix cache and cascade decode (fused K4 tails, K5 cascade
     ticks,
     K2 before the grouping holds), against the same waves with the prefix
     cache off: tokens matched and prefill skipped, peak pages, cascade
     ticks, launches, TTFT, first-token and cascade-tick logits;
  9. dense-cache engine phase: the same requests on the engine with
     ``PagedConfig(enabled=False)`` (the reference's default), on ``lean``
     (K7 admissions, K2 decode) and ``fixed`` (K7, K6): admission ms per
     prompt, tick p50, tokens/s, launches; streams and logits against the
     paged lean engine's; traced lean ticks; tick p50 against the paged
     engine in turns; one tick of the legacy step (``use_fast_path=
     False``: K1 + merge) against the fast path's;
 10. int8 pages (``PagedConfig(kv_dtype="int8")``): the engine phase's
     requests on int8 pools (K7 admissions quantizing whole pages, K2-int8
     decode; launches, pool with its scales, tick p50, traced ticks, page
     bytes against bf16's, the logit gap and greedy agreement with the bf16
     engine), ``fused=False`` (K1-int8), the int8 ``ref`` engine's first tick
     against lean's; the Scheduler on ``ref`` (no kernel: what the
     quantization alone moves), then on ``lean`` (fused K4-int8, K2-int8) and
     ``fixed`` (K8 on pools widened to bf16, K6 on pages dequantized to
     float32) in turns, and the fixed phase traced (host syncs; at
     ``TRACED_FIXED_LAYERS`` of depth); prefix
     serving with cascade (K5-int8);
 11. f8 pages (``PagedConfig(kv_dtype="f8")``, e4m3 pools written through
     the reference's cast): the six f8 forms -- K2, K1, the fused K4, K8,
     K6 and K5 reading e4m3 K/V, widened in-register -- at the kernel
     phases' shapes, each bit for bit against its bf16 form on the K/V
     widened to bf16 and against its plain version, timed beside the bf16
     form and SDPA on the widened K/V with the bound on the halved bytes;
     the cast on the card against the CPU's codes; one NaN element in an
     f8 page reading as in bf16; the engine phase's requests on f8 pools
     (K7 admissions, K2-f8; launches, tick p50 eager and captured, traced
     ticks, an eager tick traced with shapes showing no pool widened, page
     bytes against bf16's, the logit gap and greedy agreement with the
     bf16 engine), ``fused=False`` (K1-f8), the Scheduler on ``lean``
     (fused K4-f8, K2-f8) and ``fixed`` (K8-f8, K6-f8 on the gathered e4m3
     pages), a prefix wave with cascade (K5-f8), and f16 and f32 caches
     (bf16 pools, as the reference stores them, bit for bit with bf16's);
 12. chunk step phase: the lean Scheduler with every step eager
     (``capture_decode = False``) and captured, in turns (eager, captured,
     captured, eager), on bf16 and int8 pages, a captured run serving the
     prompts three times on one engine (a key first seen in round 1 is
     captured in round 2 and replays from round 3): walls per round, TTFT,
     chunk captures and replays, capture + instantiation ms, the reserved
     memory the captures grew; then traced (a fourth round of the second
     captured run; with ``--chunk-step`` an eager run too): idle share and
     host launch calls per chunk step;
 13. spec phase: speculative decode (k 4, 41 new tokens) on bf16 and int8
     pages with an oracle proposer replaying the plain run's streams and
     with the n-gram proposer: spec ticks, accept rate, verify captures and
     replays, the fused K4's launches from verify steps, every stream held
     to the plain run's (a divergence must sit at a top-2 logit gap below
     the largest verify-vs-decode logit difference); tokens/s and tick p50
     against plain decode in turns; five verify ticks traced;
 14. admission phase: prompts of 17, 60, 100, 1100 and 1500 tokens (buckets
     128 and 1536) admitted twice each on paged bf16, int8 and dense
     engines, eager and captured in turns: ms per admission,
     ``prefill_compiles``, captures and replays, capture + instantiation
     ms, reserved memory grown, logits equal across the runs; and bucketed
     against exact-length first-token logits;
 15. captured-step phase: the engine phase's requests on an engine whose
     decode step runs eagerly (``capture_decode = False``) and on one that
     replays it as a CUDA graph, in turns (eager, captured, captured,
     eager) on bf16 and on int8 pages: tick p50, captures and replays per
     run; a few ticks of each traced (host launch calls -- kernel and graph
     launches -- and device kernels per tick, device busy, idle share); and
     the bit check: the eager and the captured engine serving the same
     requests in lockstep on every configuration and step kind the engine
     captures (paged bf16 and int8 and dense, on lean, lean two-call, fixed
     and ref: decode steps and admissions; the Scheduler on lean, fixed and
     ref, bf16 and int8: chunk steps; speculative decode on lean bf16 and
     int8 and fixed bf16: verify steps; the admission prompts twice on paged bf16, int8 and
     dense: admission replays; the cascade, K5 and two-call, on the prefix
     waves), logits and pools bit for bit after every step, greedy tokens
     and each step's launch counts equal;
 16. obs phase: the lean Scheduler (bf16 pages, every step captured) on an
     engine with every ``ObsConfig`` sink (tracer, metrics registry,
     flight recorder with a dump directory, perf watchdog with one SLO
     class) and on an untraced one, three rounds each, warm rounds in
     turns, five warm decode ticks of each profiled: token streams equal,
     2 host launch calls a replayed warm tick traced or not, every
     ``decode_kernel`` span synced and costed, ``engine_decode_replays``
     in the Prometheus text, no ``retrace_storm`` after round 2, and
     ``python -m repro_torch.obs`` report / calibrate / flight on the
     card's trace and dump; prints traced against untraced warm walls,
     the watchdog's fires, and measured ``decode_kernel`` ms against the
     roofline's prediction on the H100's peaks;
 17. guards phase (``GuardConfig`` and ``FaultInjector`` on the engine):
     NaN isolation -- ``_fill_page(NaN)`` into one private page of one slot
     at degraded-mode levels 0 (K2), 1 (K2, no cascade), 2 (K1 + merge),
     3 (the ``ref`` step) and 0 under the cascade (K5), eager and
     captured, bf16 and int8 pages: that slot's row non-finite, every other
     row bit-identical to the untouched pass, and a zero-scrubbed page
     handed to another slot reads finite; one audit's time; each level's
     captured pass with one degraded slot; a poison's recovery (scrub,
     requeue, recompute to the next token); the captured tick of a guarded
     engine against an unguarded one in turns, with its host launch calls;
     a fixed-seed chaos run (``nan_output``, ``nan_kv``, ``page_alloc``,
     ``cow_clone``, ``trie_corrupt`` with repairing audits,
     ``preempt_storm``) under the lean Scheduler with prefix sharing, bf16
     and int8, against a fault-free run: every request finishes, the pool
     and the radix cache check clean, the pool drains to the cache's
     pages, the degraded gauge ends at 0, and a request no fault touched
     keeps its fault-free stream or diverges at a top-2 gap within
     ``GUARD_NEAR_TIE``; and the watchdog's ``occupancy_collapse`` calling
     ``force_degrade(cause="watchdog")``;
 18. the attention-family architectures, once Mistral-NeMo-12B's weights
     are released: (a) the arch kernel phase -- K2, the fused K4, K8 and K7
     at each architecture's geometry (qwen3-moe gq 8, nemotron gq 6,
     qwen2-moe gq 1, musicgen gq 1 at d 64, gemma3 d 256 with its 1024-key
     window: K7 on the tensor cores, the fused K4 and K8 on the CUDA cores,
     which no engine path launches at d 256), K6 at qwen3's gq 8 and
     gemma3's d 256, K5 at qwen3's g 8 (32 stacked rows), against their
     plain versions; timed beside SDPA with their bounds where a run of that
     geometry launches them, and the fused K4 and K8 at d 256 too; (b) qwen3-moe-30b-a3b at full width, 24 of its 48 layers in the full
     run (``FULL_RUN_DEPTH``; ``--qwen3-step`` alone: all 48 or as many as
     fit; printed): the lean Scheduler (chunked prefill, every step
     captured), fixed and ref; lean's streams held to fixed's, the
     first-token logits of lean and ref to ``QWEN3_FIRST_LOGIT_GAP``, and
     where lean and ref part, the router witness (the first flipped rows'
     margins, their inputs held to ``ROUTER_WITNESS_REL``); an eager and a
     captured decode run with host launch calls per replayed tick; a
     prefix-sharing run with cascade decode (K5 at g 8) held to the same
     waves without cascade; speculative decode against plain decode;
     captured steps bit for bit against eager (chunk and decode; admission,
     verify and decode);
     (c) gemma3-4b at full width and depth: prompts of 16000, 3000 and
     1200 tokens admitted whole (K7 on the tensor cores at d 256, every
     launch; the window rings wrap), lean (K2 at d 256), fixed (K6) and ref, streams against
     ref, lean's steps bit for bit against eager; (d) the geometry sweep:
     qwen2-moe-a2.7b, nemotron-4-15b, yi-34b and musicgen-large at full
     width and one stage unit of depth on lean and ref, streams against
     ref, steps bit for bit. A dense model's stream may leave ref only at a
     near tie; a MoE model's divergences from ref are printed with their
     gaps (a router near tie sends a row to other experts);
 19. the recurrent architectures (``--recurrent-step [DEPTH]`` alone): K7
     at recurrentgemma-9b's window layers (16 query heads over one KV head,
     d 256, window 2048) on 3000 and 16000 keys against its plain version,
     beside SDPA and its bound; then recurrentgemma-9b (38 layers: RG-LRU
     and sliding-window MQA) and xlstm-350m (24 layers: mLSTM and sLSTM) at
     full width, 16 layers each in the full run (``FULL_RUN_DEPTH``; alone:
     full depth) on the paged lean engine: each block's parallel
     form against its sequential one at full width, prompts admitted at
     their exact length (K7 on the tensor cores at every admission of
     recurrentgemma, no decode kernel at all), captured and eager in turns
     (admission ms per prompt, tick p50), the rows after 1 and 8 decoded
     tokens against an exact prefill (the state handoff) and a planted
     fault that comparison must fail, five captured ticks traced, the
     captured steps bit for bit against eager, and the exact-length
     admission graphs held to their bound (their memory printed);
 20. training (``--train-step`` alone): (a) Mistral-NeMo-12B at full
     width, ``TRAIN_LAYERS`` (8) of its 40 layers -- float32 master weights
     and AdamW's float32 moments are 16 B a parameter, 56.4 GB at 8 layers
     -- trained ``TRAIN_STEPS`` steps on the data pipeline's batches of 2 x
     2048: the loss per step (it must fall), step ms by CUDA events,
     tokens/s, peak memory and MFU (``model_flops_for`` over the step time
     and the bf16 peak; beside it the MFU without the input embedding's
     rows, a gather the formula counts as a matmul), and no kernel launched (training attention is the
     plain, differentiable one on every device); then the loss's value and
     gradients and the AdamW update timed apart, and one step under
     ``torch.profiler`` (device busy, kernels by time); (b) one full-width layer's
     loss and gradients on the card against the port on the CPU, same
     float32 weights and batch (loss within 2e-3, each leaf's gradient
     cosine >= 0.999 and norm within 2%); (c) xlstm-350m at full width and
     depth, 4 steps straight against 2 + checkpoint + restore into fresh
     tensors + 2, bit for bit (losses, parameters, moments), in a child
     process under ``torch.use_deterministic_algorithms`` with
     ``CUBLAS_WORKSPACE_CONFIG=:4096:8``, the checkpoint written under a
     temporary directory and removed; (d) (a)'s weights through
     ``params_for_serving``, served on the paged lean engine (K7
     admissions, K2 decode, captured steps) against a ``ref`` engine: the
     first decode tick's logits and the greedy streams (equal or parting at
     a near tie); (e) one train step of each of the ten configurations at
     full width, one stage unit deep (llama-3.2-vision with the pipeline's
     image embeddings): finite loss and gradient norm, parameters moved,
     step ms and peak memory; one JSON line ``{"train": ...}``;
 21. sequence-parallel decode (``--sp-step`` alone): K2 in its dense form
     at gemma3-4b's global layers (Hq 16, Hkv 4, d 256) on 131,072 keys
     (held against its plain version) and 524,288, timed beside SDPA and
     the byte bound; then gemma3-4b at full width and depth with long_500k's
     524,288-position cache, its global layers' K/V and the window rings
     filled with seeded values to position 400,000, 8 greedy tokens in
     three runs: (a) world 1, ``mesh=None`` (the plain ``decode_step``);
     (b) world 1 over NCCL, plan ``seq_all`` (K2 over all 524,288 keys);
     (c) world 4 on the one card over gloo (CUDA tensors), ``decode_plan``'s
     ``seq_all`` on a ``(data=2, model=2)`` mesh, one spawned process a
     rank (K2 over each rank's 131,072 keys, the merge as two all-reduces):
     the first token's first global layer against a float32 oracle over
     all 524,288 positions (within ``SP_ULPS`` bf16 ulps), a planted fault
     (the ranks' offsets reversed) that must fail it, (c)'s logits equal
     on all ranks bit for bit, (b)'s and (c)'s first-token logits against
     (a)'s, the streams; step ms, the merge's ms per global layer, K2's
     launches and peak memory per run and rank; one JSON line
     ``{"sp": ...}``;
 22. tensor-parallel serving (``--tp-step`` alone): K2 and K7 at a ``(1,
     4)`` rank's geometry, then Mistral-NeMo-12B world 1 and world 4 on
     ``(1, 4)`` and ``(2, 2)``, qwen3-moe on ``(2, 2)``; one JSON line
     ``{"tp": ...}``;
 23. FSDP x TP training and the pipeline (``--fsdp-step [LAYERS]`` alone,
     no build: training launches no kernel): (a) Mistral-NeMo-12B at full
     width, ``FSDP_LAYERS`` (4) of its 40 layers, two steps of the
     one-device ``make_train_step`` on 4 x 2048 tokens, ``grad_accum`` 2,
     its gradients and updates recorded at seeded whole-leaf samples; then
     four spawned ranks over gloo on the one card: (b) the same on
     ``(data=2, model=2)``, layout "2d", each rank drawing every leaf whole
     from the shared seed and keeping its train-spec block, its state
     after step 1 saved by the sharded ``save_checkpoint``; (c) that state
     restored onto ``(4, 1)`` (each leaf's fingerprint against the saved
     one, bit for bit) and its step 2; (d) xlstm-350m under "dp_only" on
     ``(2, 2)``, 4 x 128 tokens, step 1 from the seed and step 2 from its
     world-1 run's step-1 checkpoint; (e) ``pipeline_forward`` over
     ``pod`` = 4, a decoder layer a stage, 6 micro-batches of 1 x 512,
     against the layers in sequence. Each step's loss, ce and grad_norm
     and each leaf's gradient norm and sampled gradients, moments and
     parameters against world 1 (``tests/_torch_train.py``'s tolerances),
     a planted fault (a whole norm's gradient summed over ``model`` too)
     that must fail, step ms, each category's collectives (ms, GB) and
     peak GB per rank; one JSON line ``{"fsdp": ...}``;
 24. the kernel summary (one JSON line: K1-K8, the fused K4 and the int8
     forms of K1, K2, K4 (fused and partials) and K5: 14 entries, then K2,
     the fused K4, K8, K7, K6 and K5 at the attention-family geometries,
     each with its launches from that architecture's run, and K7 at
     recurrentgemma-9b's, and K2 at gemma3-4b's global layers on 131,072 and
     524,288 keys with its launches from the sp phase), the fused K4's launches
     from verify steps, the guards phase's launches, the ``nvidia-smi``
     line, and last ``{"ok": true, "device": {...}}``.

Each phase starts with a ``[seconds] phase`` line: the time since the
script started. To stay inside its 1200 s on a slow host the full run cuts
depths (``FULL_RUN_DEPTH``): phases 13, 14, 16 and 17 serve Mistral-NeMo-12B
at 20 of its 40 layers, qwen3-moe runs at 24 of 48, the recurrent models at
8 layers, train phase (c) resumes xlstm-350m at 8 of 24, and the FSDP
phase trains Mistral-NeMo-12B 1 layer deep; run alone, each phase keeps
its depth. Phases 11-21 alone, at full width, after the build:

    python3 chip_smoke.py --f8-step | --chunk-step | --spec-step | --admission-step
    python3 chip_smoke.py --captured-step
    python3 chip_smoke.py --obs-step | --guards-step
    python3 chip_smoke.py --arch-kernels | --qwen3-step [DEPTH] | --gemma-step [DEPTH]
    python3 chip_smoke.py --arch-sweep | --recurrent-step [DEPTH] | --train-step
    python3 chip_smoke.py --sp-step | --tp-step | --fsdp-step [LAYERS]

The kernel phase (3) also holds K3 (the merge kernel) against its plain
version and ``segment_merge``, drives the two-phase ``merge_impl="pallas"``
plans of ``ops.decode`` (dense, paged, verify with ``fused=False`` on bf16
and on int8 pages: K4's partials, then K3), and holds K5 (fused cascade)
against
its plain version, against the same cascade over duplicated pages (bit for
bit), against K2 on the unshared batch and against the two-call cascade, on
a 2048-token shared prefix and on a two-level grouping.

K1, K2, K6 and K5 stream their K/V tiles through the decode ring
(``csrc/attn_decode_ring.cuh``: bulk copies into shared-memory slots kept
ahead of the compute by a producer warp); the kernel phases print each
one's slots and bytes in flight, and every serving phase checks that their
launches went through it (K2 in the engine, Scheduler, prefix and dense
phases on bf16 and int8 pages, K1 in the ``fused=False`` drives).

A change to the engine's step is compared with its parent on one card by
Mistral-NeMo-12B's decode tick p50 (the engine phase's paged lean engine,
eager and captured), one process per checkout, in turns (parent, change,
change, parent):

    python3 chip_smoke.py --tick-p50 [OTHER_CHECKOUT/src]

A change to the decode kernels is compared with its parent on one card by
timing only them, one process per checkout, in turns (parent, change,
change, parent):

    python3 chip_smoke.py --decode-kernel-times [OTHER_CHECKOUT/src]

prints one JSON line of median times for the kernels of this checkout, or
of the given ``src`` directory: K1 and K2 at the kernel phase's decode
shape (float32, bf16, int8 rows), K6 on both ``DECODE_SHAPES`` (float32,
bf16) and K5 on both ``CASCADE_CASES`` (float32, bf16, int8 rows). They
are held to another checkout bit for bit with

    python3 chip_smoke.py --decode-kernel-bits OTHER_CHECKOUT/src

which runs both checkouts' K1, K2, K5 and K6 (one process each) on the same
seeded inputs (K6 also on pages of 12 and 256) and prints one JSON line:
outputs compared, bit-identical, differing. Where their time goes is read
with

    python3 chip_smoke.py --decode-ring-clocks

which builds the ring kernels apart with the clock probe of
``csrc/attn_decode_ring.cuh`` and prints one JSON line: per case, the
first CTA's cycles in each phase of the decode update, and over all CTAs
the time to the first K tile and to the end of the walk. A change to K7
or K8 is compared the same way with

    python3 chip_smoke.py --prefill-kernel-times [OTHER_CHECKOUT/src]

which prints one JSON line of K7's (the 3000-token causal prompt) and K8's
(the two-chunk pack) median times, bf16 and f32, and the fused K4's on the
pack (bf16 and int8 pages, at 132, 66 and 16 stream-K workers). Both
lines carry the card's ``nvidia-smi`` name and power limit. A change to
the row-block kernels (K4's partials, the fused K4, and K7 and K8 on the
CUDA cores and on the tensor cores) is held to another checkout bit for
bit with

    python3 chip_smoke.py --row-kernel-bits OTHER_CHECKOUT/src

which runs both checkouts' kernels (one process each) on the same seeded
inputs, at pages that fit one tile, and prints one JSON line: outputs
compared, bit-identical, differing.

bf16 K7 and K8 at d 64 or 128 run on the tensor-core kernel (wgmma + TMA,
``csrc/attn_tc.cuh``), K7 also at d 256 (64 rows a CTA, O split by columns
between the consumer warpgroups, 64-key tiles), and so does the fused K4
(``csrc/lean_prefill_tc.cu``, bf16 and int8 pages); the build step prints
their ``-Xptxas -v`` lines (and fails on a spill in the d-256 one), the
K7 and K8 phases print each case's TFLOP/s beside SDPA's, and the engine,
Scheduler, prefix-serving and dense-engine phases check that every K7, K8
and fused K4 launch went through them (``dense_tc_launches ==
dense_launches``, ``tc_launches == launches``, ``fused_tc_launches ==
fused_launches``), as the gemma phase does for K7 at d 256.

The int8 prefix-serving comparison of phase 10 at another depth of
Mistral-NeMo-12B, split by backend, kernel and pages, with every lean
kernel held to its plain version and every decode and chunk attention call
to the ``ref`` oracle on the same inputs (checks nothing; one JSON line,
the rest in ``chiprun_out/prefix_fault_<DEPTH>.json``):

    python3 chip_smoke.py --prefix-step [DEPTH]

Imports ``repro_torch`` only, never JAX or the JAX package ``repro``.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# float32 contract of the reference (tests/test_paged_invariants.py:177-180).
F32_TOL = 2e-5
# bf16 inputs: kernel and plain version both upcast the bf16 values exactly
# to float32 and compute in float32, so they differ only in summation order
# and the float32 contract applies unchanged.
BF16_TOL = 2e-5
# Lean vs 'ref' engine logits (phase 6), elementwise |lean - ref| <= atol +
# rtol * |ref|. The model is bf16 and the two backends round attention
# differently: the lean kernels keep the softmax probabilities in float32,
# the plain oracle rounds them to bf16 before the PV product (as the
# reference's does). The logits leave the unembed GEMM rounded to bf16, so
# a large logit moves by whole bf16 steps of its own size: rtol is 4 steps
# (2^-6). The rest is drift of a few bf16 steps of the residual stream over
# the layers: atol is a tenth of the run's typical |logit| (the median of
# the ref logits, printed). A wrong attention output moves logits by about
# that typical size, ten times the allowance.
LOGIT_RTOL = 2.0 ** -6
LOGIT_ATOL_FRAC = 0.1
# Phase 10, where two runs read int8 K/V that were not quantized from the
# same values -- the int8 Scheduler's first tokens against blocking prefill
# (which reads bf16 K/V), prefix serving against the unshared run (pools
# written through other stream-K partitions): an element is off by up to
# half a scale step, amax/254 of its page and head, about 8x the bf16
# rounding of a unit-scale element, and upstream bf16 noise that crosses a
# rounding boundary moves it a whole step. The allowance doubles the bf16
# one; a wrong attention output still moves logits by 5x it. (Phase 10
# also serves the int8 'ref' Scheduler -- the plain oracles over int8
# pages, no kernel -- and prints its gap to blocking prefill: the size of
# the quantization's own effect.)
INT8_LOGIT_ATOL_FRAC = 0.2
# K5 against K2 on the unshared batch, and against the two-call cascade:
# the regrouping re-associates the float32 softmax sums, which the
# reference bounds by its float32 contract (tests/test_cascade.py:127-128)
CASCADE_TOL = 2e-5
RATE_BYTES = {"PCIe": 2.0e12, "NVL": 3.9e12, "H200": 4.8e12}   # else H100 SXM 3.35e12
RATE_OPS = {"float32": 67e12, "bfloat16": 989e12}             # dense, no sparsity


T0 = time.perf_counter()


def clock(what: str):
    """One line: seconds since the script started, at the start of ``what``.
    First the engines the phases before dropped are collected and their
    device memory handed back: an engine with a Scheduler sits in a
    reference cycle (the scheduler's preemption sink), which only the
    cyclic collector frees."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    print(f"[{time.perf_counter() - T0:.1f} s] {what}", flush=True)


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    sys.exit(1)


def check(cond, msg: str):
    if not cond:
        fail(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def mem_rate(name: str) -> float:
    for key, rate in RATE_BYTES.items():
        if key in name:
            return rate
    return 3.35e12


def gpu_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` runs, CUDA events around
    each run. Before each run a 256 MB write evicts the 50 MB L2, because
    the engine reads each layer's K/V cold; then a spin kernel keeps the
    stream busy while the host enqueues, so the wrappers' host overhead is
    not counted."""
    import torch

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    cycles = int(min(max(host_s * 4e9, 1e6), 2e9))
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        flush.zero_()
        torch.cuda._sleep(cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# --------------------------------------------------------------- kernel phase
def make_kv_problem(torch, lens, Hq, Hkv, d, tile, width, dtype, gen, dev):
    """A ragged paged batch: pages shuffled over the pool, page 0 the null
    page (zeros), and the dense view of the same K/V."""
    from repro_torch.core.attention import paged_gather_kv

    B = len(lens)
    n_pages = [-(-L // tile) for L in lens]
    num_pages = 1 + sum(n_pages) + 3
    perm = torch.randperm(num_pages - 1, generator=gen, device=dev).cpu() + 1
    tbl = torch.zeros(B, width, dtype=torch.int32)
    k = 0
    for b, n in enumerate(n_pages):
        tbl[b, :n] = perm[k:k + n]
        k += n
    shape = (num_pages, Hkv, tile, d)
    k_pool = torch.randn(shape, generator=gen, device=dev).to(dtype)
    v_pool = torch.randn(shape, generator=gen, device=dev).to(dtype)
    k_pool[0] = 0
    v_pool[0] = 0
    q = torch.randn(B, Hq, d, generator=gen, device=dev).to(dtype)
    tbl = tbl.to(dev)
    return q, k_pool, v_pool, tbl, paged_gather_kv(k_pool, tbl), paged_gather_kv(v_pool, tbl)


def kernel_phase(torch, sm_count: int, dev_name: str):
    from repro_torch.core.leantile import make_schedule
    from repro_torch.core.merge import AttnPartial, finalize, segment_merge
    from repro_torch.kernels import lean_decode as ld
    from repro_torch.kernels import ops

    lens, Hq, Hkv, d, tile, width = [4000, 1500, 700, 1], 32, 8, 128, 128, 32
    gq, B = Hq // Hkv, len(lens)
    sched = make_schedule(lens, Hkv, tile, sm_count)
    print(f"kernel phase: lens {lens} Hq {Hq} Hkv {Hkv} d {d} tile {tile} "
          f"workers {sm_count} tiles {sched.total_tiles} T {sched.tiles_per_worker} "
          f"pieces {sched.num_pieces}", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    dev = torch.device("cuda")
    seg_ctx = torch.tensor([L for L in lens for _ in range(Hkv)], dtype=torch.int32, device=dev)
    scale = 1.0 / math.sqrt(d)
    results = {}
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        dname = str(dtype).split(".")[-1]
        q, k_pool, v_pool, tbl, k_dense, v_dense = make_kv_problem(
            torch, lens, Hq, Hkv, d, tile, width, dtype, gen, dev)
        q_seg = q.reshape(B * Hkv, gq, d).contiguous()
        k_rows, v_rows = ops._pool_rows(k_pool, v_pool)
        route = ops.paged_route(sched, tbl, Hkv)
        args = (q_seg, k_rows, v_rows, seg_ctx, route, sched, scale)

        # K2 against its plain version, on the decode ring
        ring_before = (ld.fused_ring_launches, ld.partials_ring_launches)
        o, lse = ld.lean_decode_fused(*args)
        o_ref, lse_ref = ld.lean_decode_fused_plain(*args)
        torch.cuda.synchronize()
        err_k2 = max((o - o_ref).abs().max().item(), (lse - lse_ref).abs().max().item())
        check(torch.allclose(o, o_ref, atol=tol, rtol=tol)
              and torch.allclose(lse, lse_ref, atol=tol, rtol=tol),
              f"K2 {dname} disagrees with its plain version: max |err| {err_k2}")
        # K1 (partials, then + segment_merge) against its plain version
        parts = ld.lean_decode_partials(*args)
        parts_ref = ld.lean_decode_partials_plain(*args)
        torch.cuda.synchronize()
        err_k1 = max((a - b).abs().max().item() for a, b in zip(parts, parts_ref))
        check(all(torch.allclose(a, b, atol=tol, rtol=tol) for a, b in zip(parts, parts_ref)),
              f"K1 {dname} partials disagree with the plain version: max |err| {err_k1}")
        elem = torch.finfo(dtype).bits // 8
        check((ld.fused_ring_launches, ld.partials_ring_launches)
              == (ring_before[0] + 1, ring_before[1] + 1),
              f"K2 or K1 {dname} did not run on the decode ring")
        print("  " + ring_line(f"K1/K2 {dname}", elem, d, tile, gq), flush=True)
        seg = segment_merge(AttnPartial(*parts), ld.schedule_tensors(sched, dev)["piece_seg"],
                            sched.num_segments)
        o_two = finalize(seg)
        err_k1m = (o_two - o_ref).abs().max().item()
        check(torch.allclose(o_two, o_ref, atol=tol, rtol=tol),
              f"K1 + merge {dname} disagrees with plain K2: max |err| {err_k1m}")
        # dense and paged reach the same kernels: bit-identical outputs
        for fused in (True, False):
            out_p = ops.lean_decode_paged_from_schedule(
                q, k_pool, v_pool, seg_ctx, tbl, sched, fused=fused, return_lse=True)
            out_d = ops.lean_decode_from_schedule(
                q, k_dense, v_dense, seg_ctx, sched, fused=fused, return_lse=True)
            check(all(torch.equal(a, b) for a, b in zip(out_p, out_d)),
                  f"dense and paged differ ({dname}, fused={fused})")
        print(f"  {dname}: K2 max|err| {err_k2:.3e}  K1 max|err| {err_k1:.3e}  "
              f"K1+merge vs plain K2 {err_k1m:.3e}  dense==paged bitwise: yes", flush=True)
        # K3 on K1's partials against its plain version and segment_merge
        o3, lse3 = ld.lean_merge(*parts, sched)
        o3_ref, lse3_ref = ld.merge_pieces_plain(*parts, sched)
        torch.cuda.synchronize()
        err_k3 = max((o3 - o3_ref).abs().max().item(), (lse3 - lse3_ref).abs().max().item())
        err_k3s = (o3 - o_two).abs().max().item()
        check(torch.allclose(o3, o3_ref, atol=tol, rtol=tol)
              and torch.allclose(lse3, lse3_ref, atol=tol, rtol=tol),
              f"K3 {dname} disagrees with its plain version: max |err| {err_k3}")
        check(torch.allclose(o3, o_two, atol=tol, rtol=tol),
              f"K3 {dname} disagrees with segment_merge: max |err| {err_k3s}")
        k3_ms = gpu_ms(lambda: ld.lean_merge(*parts, sched))
        k3_plain_ms = gpu_ms(lambda: ld.merge_pieces_plain(*parts, sched), reps=5)
        k3_bytes = 4 * (sum(t.numel() for t in parts) + o3.numel() + lse3.numel()
                        + 2 * sched.num_segments)
        b_ms, b_by = bound(dev_name, dname, k3_bytes, 6 * parts[0].numel())
        results[("lean_merge", dname)] = {
            "ms": k3_ms, "plain_ms": k3_plain_ms, "library_ms": None, "bound_ms": b_ms,
            "bound_by": b_by, "max_abs_err": err_k3}
        print(f"  {dname} lean_merge (K3) on K1's {sched.num_pieces} pieces: max|err| "
              f"{err_k3:.3e} (vs segment_merge {err_k3s:.3e}); {k3_ms:.4f} ms (bound "
              f"{b_ms:.4f} ms by {b_by}; plain {k3_plain_ms:.3f} ms; no single library call)",
              flush=True)

        # times: kernel, plain version, and the library on the dense KV
        k2_ms = gpu_ms(lambda: ld.lean_decode_fused(*args))
        k2_plain_ms = gpu_ms(lambda: ld.lean_decode_fused_plain(*args), reps=5)
        k1_ms = gpu_ms(lambda: ld.lean_decode_partials(*args))
        k1_plain_ms = gpu_ms(lambda: ld.lean_decode_partials_plain(*args), reps=5)
        tokens = sum(lens) * Hkv                        # K/V rows attended
        kv_bytes = 2 * tokens * d * elem
        lib = library_yardstick(torch, q, k_dense, v_dense, lens, gq, elem)
        lib_ms = lib[LIBRARY_CALL][0]
        print("  " + dname + " SDPA (gather excluded): " + "; ".join(
            f"{how} {ms:.4f} ms reading {nb / 1e6:.1f} MB" for how, (ms, nb) in lib.items()),
            flush=True)
        small = q_seg.numel() * elem + 4 * (seg_ctx.numel() + route.numel()
                                            + ld.schedule_tensors(sched, dev)["desc"].numel())
        ops_count = 4 * gq * d * tokens                  # QK^T and PV, 2 flops a MAC
        out_k2 = 4 * (o.numel() + lse.numel())
        out_k1 = 4 * sum(t.numel() for t in parts)
        for name, out_bytes, ms, plain_ms, err in (
            ("lean_decode_fused", out_k2, k2_ms, k2_plain_ms, err_k2),
            ("lean_decode_partials", out_k1, k1_ms, k1_plain_ms, err_k1),
        ):
            t_bytes = (kv_bytes + small + out_bytes) / mem_rate(dev_name) * 1e3
            t_ops = ops_count / RATE_OPS[dname] * 1e3
            results[(name, dname)] = {
                "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "max_abs_err": err, "kv_bytes": kv_bytes,
            }
            r = results[(name, dname)]
            print(f"  {dname} {name}: {ms:.4f} ms (bound {r['bound_ms']:.4f} ms by "
                  f"{r['bound_by']}, {kv_bytes / 1e6:.1f} MB K/V; plain {plain_ms:.3f} ms; "
                  f"library {lib_ms:.4f} ms)", flush=True)
    return results


def check_src(module, src: str):
    check(os.path.abspath(module.__file__).startswith(os.path.abspath(src) + os.sep),
          f"kernels imported from {module.__file__}, not from {src}")


def decode_kernel_cases(torch, sm_count: int):
    """The decode kernels' inputs at the main path's widths, each made from
    its own seed on the card (so two checkouts get the same ones): ``(name,
    kernel, args, kwargs)``. K1 and K2 on the kernel phase's decode batch
    (float32, bf16, int8 rows); K6 on both ``DECODE_SHAPES`` (float32, bf16)
    and on pages of 12 and 256; K5 on both ``CASCADE_CASES`` (float32,
    bf16, int8 rows)."""
    from repro_torch.core.leantile import fixed_split_factor, make_schedule
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import lean_decode as ld
    from repro_torch.kernels import ops

    Hq, Hkv, d = 32, 8, 128
    g, scale, dev = Hq // Hkv, 1.0 / math.sqrt(d), torch.device("cuda")
    kinds = (("float32", torch.float32, False), ("bfloat16", torch.bfloat16, False),
             ("int8", torch.bfloat16, True))

    def seeded(seed):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        return gen

    lens, tile = [4000, 1500, 700, 1], 128
    sched = make_schedule(lens, Hkv, tile, sm_count)
    seg_ctx = torch.tensor([L for L in lens for _ in range(Hkv)], dtype=torch.int32, device=dev)
    for kind, dtype, int8 in kinds:
        q, k_pool, v_pool, tbl, _, _ = make_kv_problem(torch, lens, Hq, Hkv, d, tile, 32, dtype,
                                                       seeded(0), dev)
        kw = {}
        if int8:
            k_pool, kw["k_scales"], v_pool, kw["v_scales"] = quantized(torch, k_pool, v_pool)
        args = (q.reshape(len(lens) * Hkv, g, d).contiguous(), *ops._pool_rows(k_pool, v_pool),
                seg_ctx, ops.paged_route(sched, tbl, Hkv), sched, scale)
        yield f"K2 {kind}", ld.lean_decode_fused, args, kw
        yield f"K1 {kind}", ld.lean_decode_partials, args, kw
    shapes = [(lens_, 128) for lens_ in DECODE_SHAPES] + [((700, 1, 257), 12),
                                                            ((700, 1, 257), 256)]
    for lens_, tile in shapes:
        B = len(lens_)
        width = -(-max(lens_) // tile)
        splits = fixed_split_factor(max(lens_), B * Hkv, tile, sm_count)
        ctx = torch.tensor([L for L in lens_ for _ in range(Hkv)], dtype=torch.int32, device=dev)
        for kind, dtype, _ in kinds[:2]:
            q, _, _, _, k_dense, v_dense = make_kv_problem(torch, list(lens_), Hq, Hkv, d, tile,
                                                           width, dtype, seeded(2), dev)
            args = (q.reshape(B * Hkv, g, d).contiguous(),
                    k_dense.reshape(B * Hkv, width * tile, d),
                    v_dense.reshape(B * Hkv, width * tile, d), ctx, splits, tile, scale)
            yield f"K6 lens {list(lens_)} page {tile} {kind}", fd.flash_decode_partials, args, {}
    for case, (passes, suffixes) in CASCADE_CASES.items():
        for kind, dtype, int8 in kinds:
            q, k_pool, v_pool, tbl, _, lens_ = cascade_problem(torch, passes, suffixes, Hq, Hkv, d,
                                                               128, dtype, seeded(3), dev)
            kw = {}
            if int8:
                k_pool, kw["k_scales"], v_pool, kw["v_scales"] = quantized(torch, k_pool, v_pool)
            args, _ = cascade_operands(torch, q, k_pool, v_pool, tbl, lens_, passes, sm_count)
            yield f"K5 {case} {kind}", ld.lean_cascade_fused, args, kw


def decode_kernel_times(torch, sm_count: int, src: str) -> dict:
    """K1's, K2's, K6's and K5's median times on ``decode_kernel_cases``
    (the paged K6 cases aside), for the kernels of the ``repro_torch``
    under ``src`` (built there at first use); 50 runs each, L2 evicted
    before each run."""
    from repro_torch.kernels import lean_decode as ld

    check_src(ld, src)
    out = {"src": src}
    for name, fn, args, kw in decode_kernel_cases(torch, sm_count):
        if "page 128" in name or not name.startswith("K6"):
            out[name] = gpu_ms(lambda: fn(*args, **kw), reps=50)
    return out


def decode_kernel_outputs(torch, sm_count: int, src: str, out: str):
    """The outputs of the decode kernels of the ``repro_torch`` under
    ``src`` on ``decode_kernel_cases``, saved to ``out``."""
    from repro_torch.kernels import lean_decode as ld

    check_src(ld, src)
    res = {name: [t.cpu() for t in fn(*args, **kw)]
           for name, fn, args, kw in decode_kernel_cases(torch, sm_count)}
    torch.cuda.synchronize()
    torch.save(res, out)


RING_PHASES = ("wait K", "phase A", "sync A", "phase B + sync", "wait V", "phase C", "sync C")


def decode_ring_clocks(torch, sm_count: int) -> dict:
    """The decode ring's probe: the ring kernels built apart with
    ``DECODE_RING_CLOCKS`` (``build.DEFINES``), which stamp clocks, run on
    ``decode_kernel_cases`` (K6 at pages of 128), one warm launch and one
    stamped launch each. Per case: the first CTA's median cycles in each
    phase of its tiles and between tiles (Q loads, flushes, K2's fix-up),
    and over all CTAs the microseconds from the consumers' start to the
    first K copy landed (CTAs with a tile) and to the end of the walk
    (median, max), and the span from the first start to the last end."""
    import ctypes

    import numpy as np

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import lean_decode as ld

    build.DEFINES = ("DECODE_RING_CLOCKS",)
    libs = {"K1": lambda: ld._library(ld.SOURCE), "K2": lambda: ld._library(ld.SOURCE),
            "K5": lambda: ld._library(ld.CASCADE_SOURCE), "K6": fd._library}
    tiles_buf = (ctypes.c_longlong * (64 * 8))()
    ctas_buf = (ctypes.c_ulonglong * (4096 * 3))()
    out = {}
    for name, fn, args, kw in decode_kernel_cases(torch, sm_count):
        if name.startswith("K6") and "page 128" not in name:
            continue
        lib = libs[name[:2]]
        fn(*args, **kw)
        torch.cuda.synchronize()
        read = lib().decode_ring_clocks
        check(read(tiles_buf, ctas_buf) == 0, "decode_ring_clocks failed")
        fn(*args, **kw)
        torch.cuda.synchronize()
        check(read(tiles_buf, ctas_buf) == 0, "decode_ring_clocks failed")
        t = np.array(tiles_buf[:], dtype=np.int64).reshape(64, 8)
        t = t[t[:, 7] != 0]
        c = np.array(ctas_buf[:], dtype=np.uint64).reshape(4096, 3).astype(np.int64)
        c = c[c[:, 0] != 0]
        check(len(t) > 0 and len(c) > 0, f"{name}: the probe stamped nothing (not on the ring?)")
        landed = c[c[:, 1] != 0]                      # CTAs with a tile to walk
        first, walk = (landed[:, 1] - landed[:, 0]) / 1e3, (c[:, 2] - c[:, 0]) / 1e3
        out[name] = {
            "tiles": len(t),
            "cycles": {ph: int(np.median(np.diff(t, axis=1)[:, i]))
                       for i, ph in enumerate(RING_PHASES)},
            "cycles between tiles": int(np.median(t[1:, 0] - t[:-1, 7])) if len(t) > 1 else 0,
            "first K us (median, max)": [float(np.median(first)), float(first.max())],
            "walk us (median, max)": [float(np.median(walk)), float(walk.max())],
            "span us": float((c[:, 2].max() - c[:, 0].min()) / 1e3),
        }
    return out


def prefill_kernel_times(torch, src: str) -> dict:
    """K7's time on the 3000-token causal prompt and K8's on the two-chunk
    pack (the K7 and K8 phases' shapes), bf16 and float32, and -- where the
    checkout has it -- the fused K4's on the same pack, bf16 and int8, at
    132, 66 and 16 stream-K workers (fewer workers, fewer and longer
    pieces), for the kernels of the ``repro_torch`` under ``src`` (built
    there at first use); median of 20 runs each, L2 evicted before each
    run."""
    from repro_torch.core.leantile import make_chunk_schedule
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import lean_prefill as lp
    from repro_torch.kernels import ops

    check_src(fp, src)
    B, Hq, Hkv, d, tile = 1, 32, 8, 128, 128
    Lq, Lk, causal, window = K7_CASES["causal 3000"]
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    q_off = torch.tensor(CHUNK_OFFS, dtype=torch.int32, device=dev)
    out = {"src": src}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        q = torch.randn(B, Hq, Lq, d, generator=gen, device=dev).to(dtype)
        k = torch.randn(B, Hkv, Lk, d, generator=gen, device=dev).to(dtype)
        v = torch.randn(B, Hkv, Lk, d, generator=gen, device=dev).to(dtype)
        out[f"K7 {dname}"] = gpu_ms(lambda: fp.flash_prefill(q, k, v, causal=causal,
                                                             window=window))
        q8, k_pool, v_pool, tbl = chunk_pack(torch, CHUNK_OFFS, CHUNK, Hq, Hkv, d, tile, dtype,
                                             gen, dev)
        out[f"K8 {dname}"] = gpu_ms(lambda: fp.flash_prefill_paged(q8, k_pool, v_pool, tbl,
                                                                   q_off))
        if dtype != torch.bfloat16 or not hasattr(lp, "lean_prefill_fused"):
            continue
        visible = [o + CHUNK for o in CHUNK_OFFS]
        i32 = lambda xs: torch.tensor([x for x in xs for _ in range(Hkv)], dtype=torch.int32,
                                      device=dev)
        kq, ks, vq, vs = quantized(torch, k_pool, v_pool)
        pools = {"bfloat16": (k_pool, v_pool, {}),
                 "int8": (kq, vq, dict(k_scales=ks, v_scales=vs))}
        for workers in (132, 66, 16):
            sched = make_chunk_schedule(visible, Hkv, tile, workers, max_len=max(visible) + tile)
            for kind, (kp, vp, sc) in pools.items():
                args = (q8.reshape(len(CHUNK_OFFS) * Hkv, -1, d).contiguous(),
                        *ops._pool_rows(kp, vp), i32(visible), i32(CHUNK_OFFS),
                        ops.paged_route(sched, tbl, Hkv), sched, 1.0 / math.sqrt(d), CHUNK)
                out[f"K4 fused {kind}, {workers} workers ({sched.num_pieces} pieces)"] = gpu_ms(
                    lambda: lp.lean_prefill_fused(*args, **sc))
    return out


# library_ms is the single call; the per-sequence calls are printed beside it
LIBRARY_CALL = "one call, padded + mask"


def bound(dev_name, dname, nbytes, flops):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the peak rate for the inputs' type."""
    t_bytes = nbytes / mem_rate(dev_name) * 1e3
    t_ops = flops / RATE_OPS[dname] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def reset_launch_counts():
    from repro_torch.kernels import flash_decode, flash_prefill, lean_decode, lean_prefill

    for m in (lean_decode, lean_prefill, flash_decode, flash_prefill):
        m.reset_launch_counts()


def path_counts(what: str) -> dict:
    """K7's, K8's and the fused K4's tensor-core launches, and K1's, K2's,
    K6's and K5's launches on the decode ring, since the last reset; fails
    unless every launch of them went through that path (the main path is
    bf16 or int8 pages -- float32 for K6 on int8 pages -- at d 128 on pages
    of 128, where the path rules pick them)."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import lean_decode as ld
    from repro_torch.kernels import lean_prefill as lp

    tc = {"K7": fp.dense_tc_launches, "K8": fp.tc_launches, "K4f": lp.fused_tc_launches}
    check(tc["K7"] == fp.dense_launches and tc["K8"] == fp.launches
          and tc["K4f"] == lp.fused_launches,
          f"{what}: K7 launched {fp.dense_launches} times, {tc['K7']} on the tensor cores; "
          f"K8 {fp.launches} times, {tc['K8']} on the tensor cores; fused K4 "
          f"{lp.fused_launches} times, {tc['K4f']} on the tensor cores")
    check(fd.ring_launches == fd.launches and ld.cascade_ring_launches == ld.cascade_launches,
          f"{what}: K6 launched {fd.launches} times, {fd.ring_launches} on the decode ring; "
          f"K5 {ld.cascade_launches} times, {ld.cascade_ring_launches} on the ring")
    check(ld.partials_ring_launches == ld.partials_launches
          and ld.fused_ring_launches == ld.fused_launches,
          f"{what}: K1 launched {ld.partials_launches} times, {ld.partials_ring_launches} on the "
          f"decode ring; K2 {ld.fused_launches} times, {ld.fused_ring_launches} on the ring")
    return tc


def ring_line(kernel: str, elem: int, d: int, tile: int, rows: int) -> str:
    """What the decode ring holds for ``kernel`` at a shape: slots, tiles
    and bytes in flight (the host's rule, kernels/decode_ring.py)."""
    from repro_torch.kernels import decode_ring as dr

    ns = dr.ring_slots(elem, d, tile, rows)
    if ns == 0:
        return f"{kernel}: no ring (the walk over device memory)"
    return (f"{kernel} ring: {ns} slots of {dr.slot_bytes(elem, d, tile)} bytes ({ns // 2} "
            f"tiles' K and V), {dr.bytes_in_flight(elem, d, tile, rows)} bytes in flight "
            f"beside {dr.state_bytes(rows, d, tile)} bytes of float state")


def tc_ptxas_lines(report: str):
    """(kernel, registers line, spill line) of each tensor-core kernel in a
    ``-Xptxas -v`` report."""
    import re

    out, lines = [], report.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '.*row_block_kernelILi(\d+)ELi(\d+)E.*?"
                      r"((?:Dense|Paged)Walk)(?:ILi\d+EE)?ELb([01])E", line)
        k4 = re.search(r"Compiling entry function '.*lean_prefill_tc_kernelILi(\d+)ELi([012])E",
                       line)
        if not (m or k4):
            continue
        regs = spill = ""
        for nxt in lines[i + 1:i + 6]:
            if "spill" in nxt:
                spill = nxt.strip()
            if "registers" in nxt:
                regs = nxt.split(":", 1)[1].strip()
                break
        name = (f"row_block_kernel<{m.group(1)}, {m.group(2)}, {m.group(3)}"
                f"{', e4m3' if m.group(4) == '1' else ''}>" if m else
                f"lean_prefill_tc_kernel<{k4.group(1)}, "
                f"{('bf16', 'int8', 'e4m3')[int(k4.group(2))]}>")
        out.append((name, regs, spill))
    return out


def launch_counts():
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import lean_decode as ld
    from repro_torch.kernels import lean_prefill as lp

    return {"K1": ld.partials_launches, "K2": ld.fused_launches, "K3": ld.merge_launches,
            "K4": lp.launches, "K4f": lp.fused_launches, "K5": ld.cascade_launches,
            "K6": fd.launches, "K7": fp.dense_launches, "K8": fp.launches}


# ------------------------------------------------------- chunked-prefill kernels
CHUNK_OFFS, CHUNK = (2048, 37), 256


def chunk_pack(torch, offs, C, Hq, Hkv, d, tile, dtype, gen, dev):
    """A pack of prompt chunks of ``C`` tokens at offsets ``offs``, each
    row's pages (prefix + chunk) shuffled over the pool, page 0 null."""
    N = len(offs)
    n_pages = [-(-(o + C) // tile) for o in offs]
    width = max(n_pages)
    num_pages = 1 + sum(n_pages) + 3
    perm = torch.randperm(num_pages - 1, generator=gen, device=dev).cpu() + 1
    tbl = torch.zeros(N, width, dtype=torch.int32)
    k = 0
    for n, npg in enumerate(n_pages):
        tbl[n, :npg] = perm[k:k + npg]
        k += npg
    shape = (num_pages, Hkv, tile, d)
    k_pool = torch.randn(shape, generator=gen, device=dev).to(dtype)
    v_pool = torch.randn(shape, generator=gen, device=dev).to(dtype)
    k_pool[0] = 0
    v_pool[0] = 0
    q = torch.randn(N, Hq, C, d, generator=gen, device=dev).to(dtype)
    return q, k_pool, v_pool, tbl.to(dev)


def prefill_kernel_phase(torch, sm_count: int, dev_name: str):
    """The fused K4 (stream-K chunk prefill with the merge in the launch: the
    chunk path's kernel), K4's partials (the ``fused=False`` path) and K8
    (paged FA-2 chunk prefill) on a pack of two 256-token chunks at offsets
    2048 and 37, Mistral-NeMo-12B attention shapes, against their plain
    versions; times, bounds and the library yardstick (SDPA with the
    chunk-causal mask on the gathered K/V, the g query heads of a KV head
    folded into rows). The fused K4's bound is the function's -- q, the
    K/V seen and o once, and its flops, K8's work -- printed beside the
    bound with its partials' round trip."""
    from repro_torch.core.attention import paged_gather_kv
    from repro_torch.core.leantile import make_chunk_schedule
    from repro_torch.core.merge import AttnPartial, finalize, segment_merge
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import lean_decode as ld
    from repro_torch.kernels import lean_prefill as lp
    from repro_torch.kernels import ops

    Hq, Hkv, d, tile, C = 32, 8, 128, 128, CHUNK
    g, N = Hq // Hkv, len(CHUNK_OFFS)
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    visible = [o + C for o in CHUNK_OFFS]
    sched = make_chunk_schedule(visible, Hkv, tile, sm_count, max_len=max(visible) + tile)
    seg_ctx = torch.tensor([v for v in visible for _ in range(Hkv)], dtype=torch.int32, device=dev)
    seg_qs = torch.tensor([o for o in CHUNK_OFFS for _ in range(Hkv)], dtype=torch.int32,
                          device=dev)
    q_off = torch.tensor(CHUNK_OFFS, dtype=torch.int32, device=dev)
    scale = 1.0 / math.sqrt(d)
    # each query row sees its own prefix: offset + position in chunk + 1 keys
    keys_seen = sum(Hq * (C * o + C * (C + 1) // 2) for o in CHUNK_OFFS)
    flops = 4 * d * keys_seen                        # QK^T and PV, 2 flops a MAC
    print(f"prefill kernel phase: pack of {N} chunks of {C} at offsets {list(CHUNK_OFFS)}, "
          f"Hq {Hq} Hkv {Hkv} d {d} page {tile}, workers {sm_count}, tiles "
          f"{sched.total_tiles}, T {sched.tiles_per_worker}, pieces {sched.num_pieces}; "
          f"{flops / 1e9:.2f} GFLOP", flush=True)
    results = {}
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        dname = str(dtype).split(".")[-1]
        elem = torch.finfo(dtype).bits // 8
        q, k_pool, v_pool, tbl = chunk_pack(torch, CHUNK_OFFS, C, Hq, Hkv, d, tile, dtype,
                                            gen, dev)
        q_seg = q.reshape(N * Hkv, g * C, d).contiguous()
        k_rows, v_rows = ops._pool_rows(k_pool, v_pool)
        route = ops.paged_route(sched, tbl, Hkv)
        args = (q_seg, k_rows, v_rows, seg_ctx, seg_qs, route, sched, scale, C)

        parts = lp.lean_prefill_chunk_partials(*args)
        parts_ref = lp.lean_prefill_partials_plain(*args)
        torch.cuda.synchronize()
        err_k4 = max((a - b).abs().max().item() for a, b in zip(parts, parts_ref))
        check(all(torch.allclose(a, b, atol=tol, rtol=tol) for a, b in zip(parts, parts_ref)),
              f"K4 {dname} partials disagree with the plain version: max |err| {err_k4}")
        piece_seg = ld.schedule_tensors(sched, dev)["piece_seg"]
        merged = [finalize(segment_merge(AttnPartial(*x), piece_seg, sched.num_segments))
                  for x in (parts, parts_ref)]
        err_k4o = (merged[0] - merged[1]).abs().max().item()
        check(torch.allclose(merged[0], merged[1], atol=tol, rtol=tol),
              f"K4 {dname} merged output disagrees with the plain version: {err_k4o}")

        o8 = fp.flash_prefill_paged(q, k_pool, v_pool, tbl, q_off)
        o8_ref = fp.flash_prefill_paged_plain(q, k_pool, v_pool, tbl, q_off, scale)
        torch.cuda.synchronize()
        err_k8 = (o8.float() - o8_ref.float()).abs().max().item()
        if dtype == torch.float32:
            ok8 = torch.allclose(o8, o8_ref, atol=tol, rtol=tol)
        else:
            # both round a float32 result to bf16: one bf16 step of the
            # output apart (a tie can land either way), plus the float32
            # tolerance where the output nears zero and its sum cancels
            step = torch.finfo(torch.bfloat16).eps * o8_ref.float().abs()
            ok8 = bool(((o8.float() - o8_ref.float()).abs() <= step + tol).all())
        check(ok8, f"K8 {dname} disagrees with the plain version: max |err| {err_k8}")
        # the fused K4 against its plain version; the path rule picks its kernel
        lp.reset_launch_counts()
        o4f = lp.lean_prefill_fused(*args)
        o4f_ref = lp.lean_prefill_fused_plain(*args)
        torch.cuda.synchronize()
        tc4 = fp.tensor_core_path(dtype, d, tile)
        check((lp.fused_launches, lp.fused_tc_launches) == (1, int(tc4)),
              f"fused K4 {dname}: {lp.fused_launches} launches, {lp.fused_tc_launches} on "
              f"the tensor cores, expected 1, {int(tc4)}")
        err_k4f = (o4f.float() - o4f_ref.float()).abs().max().item()
        if dtype == torch.float32:
            ok4f = torch.allclose(o4f, o4f_ref, atol=tol, rtol=tol)
        else:
            # as K8: both round a float32 result to bf16 (the tensor-core
            # kernel's P goes through PV as two bf16 halves)
            step = torch.finfo(torch.bfloat16).eps * o4f_ref.float().abs()
            ok4f = bool(((o4f.float() - o4f_ref.float()).abs() <= step + tol).all())
        check(ok4f, f"fused K4 {dname} disagrees with its plain version: max |err| {err_k4f}")
        # K4 + merge against K8 and the fused K4: three kernels, one function
        o4 = merged[0].reshape(N, Hq, C, d)
        err_48 = (o4 - o8.float()).abs().max().item()
        err_4f8 = (o4f.float().reshape(N, Hq, C, d) - o8.float()).abs().max().item()
        print(f"  {dname}: K4 partials max|err| {err_k4:.3e}, merged {err_k4o:.3e}; "
              f"K8 max|err| {err_k8:.3e}; fused K4 ({'tensor' if tc4 else 'CUDA'} cores) "
              f"max|err| {err_k4f:.3e}; K4+merge vs K8 {err_48:.3e}; fused K4 vs K8 "
              f"{err_4f8:.3e}", flush=True)

        k4_ms = gpu_ms(lambda: lp.lean_prefill_chunk_partials(*args), reps=10)
        k4_plain_ms = gpu_ms(lambda: lp.lean_prefill_partials_plain(*args), reps=3)
        k4f_ms = gpu_ms(lambda: lp.lean_prefill_fused(*args), reps=10)
        k4f_plain_ms = gpu_ms(lambda: lp.lean_prefill_fused_plain(*args), reps=3)
        k8_ms = gpu_ms(lambda: fp.flash_prefill_paged(q, k_pool, v_pool, tbl, q_off), reps=10)
        k8_plain_ms = gpu_ms(lambda: fp.flash_prefill_paged_plain(q, k_pool, v_pool, tbl, q_off,
                                                                  scale), reps=3)
        # library: SDPA on the gathered K/V with the chunk-causal mask
        k_dense, v_dense = paged_gather_kv(k_pool, tbl), paged_gather_kv(v_pool, tbl)
        K = k_dense.shape[2]
        qpos = q_off[:, None].long() + torch.arange(g * C, device=dev)[None, :] % C
        mask = (torch.arange(K, device=dev)[None, None, :] <= qpos[..., None])[:, None]
        qf = q.reshape(N, Hkv, g * C, d)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_ms = gpu_ms(lambda: sdpa(qf, k_dense, v_dense, attn_mask=mask), reps=10)
        lib_bytes = 2 * k_dense.numel() * elem
        kv_bytes = 2 * sum(visible) * Hkv * d * elem           # each K/V row once
        small = 4 * (seg_ctx.numel() * 2 + route.numel()
                     + ld.schedule_tensors(sched, dev)["desc"].numel())
        part_bytes = 4 * sum(t.numel() for t in parts)
        print(f"  {dname} SDPA (gather excluded, chunk-causal mask): {lib_ms:.4f} ms reading "
              f"{lib_bytes / 1e6:.1f} MB; K4 partials {part_bytes / 1e6:.1f} MB "
              f"({sched.num_pieces} pieces x {g * C} rows)", flush=True)
        # the fused K4 under the old figure: its pieces written and read back
        bp_ms, _ = bound(dev_name, dname, q.numel() * elem + kv_bytes + small + 2 * part_bytes
                         + o8.numel() * elem, flops)
        print(f"  {dname} lean_prefill_fused: bound with the {part_bytes / 1e6:.1f} MB round "
              f"trip of K4's partials {bp_ms:.4f} ms", flush=True)
        for name, out_bytes, ms, plain_ms, err in (
            ("lean_prefill_fused", o4f.numel() * elem, k4f_ms, k4f_plain_ms, err_k4f),
            ("lean_prefill_chunk_partials", part_bytes, k4_ms, k4_plain_ms, err_k4),
            ("flash_prefill_paged", o8.numel() * elem, k8_ms, k8_plain_ms, err_k8),
        ):
            b_ms, b_by = bound(dev_name, dname, q.numel() * elem + kv_bytes + small + out_bytes,
                               flops)
            results[(name, dname)] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                                      "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err}
            path = ("" if name == "lean_prefill_chunk_partials" else
                    ", tensor cores" if fp.tensor_core_path(dtype, d, tile) else ", CUDA cores")
            print(f"  {dname} {name}{path}: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}; "
                  f"{flops / ms / 1e9:.1f} TFLOP/s; plain {plain_ms:.3f} ms; library "
                  f"{lib_ms:.4f} ms, {flops / lib_ms / 1e9:.1f} TFLOP/s)", flush=True)
    return results


# ------------------------------------------------- whole-prompt prefill (K7)
K7_CASES = {
    # name: (Lq, Lk, causal, window); B 1, Hq 32, Hkv 8, d 128 throughout.
    # 1024: Gemma-3's local window (src/repro/configs/gemma3_4b.py:22)
    "causal 3000": (3000, 3000, True, None),
    "window 1024": (3000, 3000, True, 1024),
    "non-causal 37x150": (37, 150, False, None),
}


def visible_keys(Lq, Lk, causal, window, q_offset=0):
    """Keys each query row sees, summed over the rows (one head)."""
    total = 0
    for i in range(Lq):
        qpos = q_offset + i
        hi = min(Lk, qpos + 1) if causal else Lk
        lo = max(qpos - window + 1, 0) if window else 0
        total += max(hi - lo, 0)
    return total


def prefill_k7_phase(torch, dev_name: str):
    """K7 (``flash_prefill``) at the dense engine's prefill shape -- one
    3000-token prompt, Mistral-NeMo-12B attention, causal, ``q_offset`` 0 --
    and with a 1024-token sliding window, and non-causal 37 x 150, in bf16
    and float32: against its plain version, its time, the plain version's,
    the bound and the library's (SDPA on the same inputs, the g query heads
    of a KV head sharing its K/V: ``enable_gqa``)."""
    from repro_torch.kernels import flash_prefill as fp

    B, Hq, Hkv, d = 1, 32, 8, 128
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    results = {}
    for case, (Lq, Lk, causal, window) in K7_CASES.items():
        seen = visible_keys(Lq, Lk, causal, window)
        flops = 4 * Hq * d * seen                     # QK^T and PV, 2 flops a MAC
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            dname = str(dtype).split(".")[-1]
            elem = torch.finfo(dtype).bits // 8
            q = torch.randn(B, Hq, Lq, d, generator=gen, device=dev).to(dtype)
            k = torch.randn(B, Hkv, Lk, d, generator=gen, device=dev).to(dtype)
            v = torch.randn(B, Hkv, Lk, d, generator=gen, device=dev).to(dtype)
            kw = dict(causal=causal, window=window)
            out = fp.flash_prefill(q, k, v, **kw)
            ref = fp.flash_prefill_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            if dtype == torch.float32:
                ok = torch.allclose(out, ref, atol=tol, rtol=tol)
            else:
                # both round a float32 result to bf16: one bf16 step apart
                # at most, plus the float32 tolerance where the sum cancels
                step = torch.finfo(torch.bfloat16).eps * ref.float().abs()
                ok = bool(((out.float() - ref.float()).abs() <= step + tol).all())
            check(ok, f"K7 {dname} ({case}) disagrees with its plain version: max |err| {err}")
            ms = gpu_ms(lambda: fp.flash_prefill(q, k, v, **kw))
            plain_ms = gpu_ms(lambda: fp.flash_prefill_plain(q, k, v, **kw), reps=3)
            if window is None:
                lib = lambda: sdpa(q, k, v, is_causal=causal, enable_gqa=True)
            else:
                pos = torch.arange(Lq, device=dev)[:, None]
                kpos = torch.arange(Lk, device=dev)[None, :]
                mask = (kpos <= pos) & (kpos > pos - window)
                lib = lambda: sdpa(q, k, v, attn_mask=mask, enable_gqa=True)
            lib_err = (lib().float() - ref.float()).abs().max().item()
            lib_ms = gpu_ms(lib)
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * elem     # q, k, v in; o out
            b_ms, b_by = bound(dev_name, dname, nbytes, flops)
            results[(case, dname)] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                                      "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err}
            path = "tensor cores" if fp.tensor_core_path(dtype, d) else "CUDA cores"
            print(f"K7 {case} {dname} ({path}): Lq {Lq} Lk {Lk}, {flops / 1e9:.2f} GFLOP, "
                  f"{nbytes / 1e6:.1f} MB; max|err| {err:.3e} (SDPA vs plain {lib_err:.3e}); "
                  f"{ms:.4f} ms, {flops / ms / 1e9:.2f} TFLOP/s (bound {b_ms:.4f} ms by {b_by}; "
                  f"plain {plain_ms:.3f} ms; library {lib_ms:.4f} ms, "
                  f"{flops / lib_ms / 1e9:.2f} TFLOP/s)", flush=True)
    return results


# ------------------------------------------------------ fixed-split decode (K6)
DECODE_SHAPES = ((4000, 1500, 700, 1), (16384, 512, 256, 17))


def fixed_decode_phase(torch, sm_count: int, dev_name: str):
    """K6 (fixed-split partials) against its plain version at K2's ragged
    lens and at one long-context shape, with FlashDecoding's split factor;
    then K2 against K6 on both shapes (the paper's comparison): K2 is the
    whole stream-K decode, K6 + merge_n the whole fixed-split one."""
    from repro_torch.core.leantile import fixed_split_factor, make_schedule
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import lean_decode as ld
    from repro_torch.kernels import ops

    Hq, Hkv, d, tile = 32, 8, 128, 128
    gq = Hq // Hkv
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    scale = 1.0 / math.sqrt(d)
    results = {}
    for lens in DECODE_SHAPES:
        B = len(lens)
        width = -(-max(lens) // tile)
        splits = fixed_split_factor(max(lens), B * Hkv, tile, sm_count)
        sched = make_schedule(list(lens), Hkv, tile, sm_count)
        seg_ctx = torch.tensor([L for L in lens for _ in range(Hkv)], dtype=torch.int32,
                               device=dev)
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            dname = str(dtype).split(".")[-1]
            elem = torch.finfo(dtype).bits // 8
            q, k_pool, v_pool, tbl, k_dense, v_dense = make_kv_problem(
                torch, list(lens), Hq, Hkv, d, tile, width, dtype, gen, dev)
            q_seg = q.reshape(B * Hkv, gq, d).contiguous()
            k_seg = k_dense.reshape(B * Hkv, width * tile, d)
            v_seg = v_dense.reshape(B * Hkv, width * tile, d)
            args = (q_seg, k_seg, v_seg, seg_ctx, splits, tile, scale)
            ring_before = fd.ring_launches
            parts = fd.flash_decode_partials(*args)
            parts_ref = fd.flash_decode_partials_plain(*args)
            torch.cuda.synchronize()
            check(fd.ring_launches == ring_before + 1,
                  f"K6 {dname} did not run on the decode ring")
            print("  " + ring_line(f"K6 {dname}", elem, d, tile, gq), flush=True)
            err = max((a - b).abs().max().item() for a, b in zip(parts, parts_ref))
            check(all(torch.allclose(a, b, atol=tol, rtol=tol) for a, b in zip(parts, parts_ref)),
                  f"K6 {dname} lens {lens} disagrees with the plain version: max |err| {err}")
            o6 = ops.flash_decode_from_lens(q, k_dense, v_dense, seg_ctx, num_splits=splits,
                                            tile=tile)
            k_rows, v_rows = ops._pool_rows(k_pool, v_pool)
            route = ops.paged_route(sched, tbl, Hkv)
            k2_args = (q_seg, k_rows, v_rows, seg_ctx, route, sched, scale)
            o2, _ = ld.lean_decode_fused(*k2_args)
            err_26 = (o2.reshape(B, Hq, d) - o6.float()).abs().max().item()
            check(err_26 <= (1e-4 if dtype == torch.float32 else 2.0 ** -7),
                  f"K2 and K6 + merge_n disagree on lens {lens} ({dname}): {err_26}")
            k6_ms = gpu_ms(lambda: fd.flash_decode_partials(*args))
            k6_plain_ms = gpu_ms(lambda: fd.flash_decode_partials_plain(*args), reps=3)
            k6_full_ms = gpu_ms(lambda: ops.flash_decode_from_lens(
                q, k_dense, v_dense, seg_ctx, num_splits=splits, tile=tile))
            k2_ms = gpu_ms(lambda: ld.lean_decode_fused(*k2_args))
            tokens = sum(lens) * Hkv
            kv_bytes = 2 * tokens * d * elem
            out_bytes = 4 * sum(t.numel() for t in parts)
            b_ms, b_by = bound(dev_name, dname, kv_bytes + q_seg.numel() * elem + 4 * B * Hkv
                               + out_bytes, 4 * gq * d * tokens)
            lib = library_yardstick(torch, q, k_dense, v_dense, list(lens), gq, elem)
            lib_ms, lib_bytes = lib[LIBRARY_CALL]
            results[(lens, dname)] = {"ms": k6_ms, "plain_ms": k6_plain_ms, "library_ms": lib_ms,
                                      "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err}
            print(f"K6 lens {list(lens)} {dname}: splits {splits} x {-(-width // splits)} tiles "
                  f"({B * Hkv * splits} CTAs), max|err| {err:.3e}; {k6_ms:.4f} ms partials, "
                  f"{k6_full_ms:.4f} ms with merge_n (bound {b_ms:.4f} ms by {b_by}, "
                  f"{kv_bytes / 1e6:.1f} MB K/V; plain {k6_plain_ms:.3f} ms; library "
                  f"{lib_ms:.4f} ms reading {lib_bytes / 1e6:.1f} MB)", flush=True)
            print(f"  K2 vs K6, lens {list(lens)} {dname}: stream-K K2 {k2_ms:.4f} ms "
                  f"({sched.num_workers} workers, {sched.num_pieces} pieces) against fixed-split "
                  f"K6 + merge_n {k6_full_ms:.4f} ms: K2/K6 = {k2_ms / k6_full_ms:.3f}; "
                  f"outputs agree within {err_26:.2e}", flush=True)
    return results


def library_yardstick(torch, q, k_dense, v_dense, lens, gq, elem):
    """``scaled_dot_product_attention`` on the K/V already gathered to dense
    ``(B, Hkv, S_pad, d)``, timed two ways; returns ``{how: (ms, K/V bytes
    read)}``. The ``gq`` query heads of a KV head are folded into query rows,
    which is the same function with no K/V copied per query head. One call
    reads the padded batch with a length mask; one call per sequence reads
    exactly its length. Timed only; the port never calls it."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    B, Hkv, S_pad, d = k_dense.shape
    qf = q.reshape(B, Hkv, gq, d)
    mask = (torch.arange(S_pad, device=q.device)[None, :]
            < torch.tensor(lens, device=q.device)[:, None])[:, None, None, :]
    padded_ms = gpu_ms(lambda: sdpa(qf, k_dense, v_dense, attn_mask=mask))
    views = [(qf[b:b + 1], k_dense[b:b + 1, :, :L], v_dense[b:b + 1, :, :L])
             for b, L in enumerate(lens)]
    per_seq_ms = gpu_ms(lambda: [sdpa(*v) for v in views])
    return {
        LIBRARY_CALL: (padded_ms, 2 * B * Hkv * S_pad * d * elem),
        f"{B} calls, one per sequence": (per_seq_ms, 2 * sum(lens) * Hkv * d * elem),
    }


# --------------------------------------------------------------- engine phases
PROMPT_LENS = (3000, 1200, 300, 17)


def make_requests(Request, vocab, new_tokens, seed=1):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [
        Request(uid=i, prompt=rng.integers(0, vocab, n).astype(np.int32),
                max_new_tokens=new_tokens)
        for i, n in enumerate(PROMPT_LENS)
    ]


def engine_config(backend, sm_count, fused=True, kv_dtype=None):
    from repro_torch.serving.config import EngineConfig, PagedConfig

    return EngineConfig(
        max_batch=4, cache_len=4096, attn_backend=backend, num_workers=sm_count,
        fused=fused, paged=PagedConfig(enabled=True, page_size=128, kv_dtype=kv_dtype),
    )


def drive(torch, eng, reqs):
    """Submit, then tick until drained. Returns (first tick's seconds, the
    later ticks' (seconds, tokens emitted), every tick's logits)."""
    for r in reqs:
        eng.submit(r)
    first, ticks, logits = None, [], []
    while eng.queue or any(eng.slot_req):
        t0 = time.perf_counter()
        out = eng.tick()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        logits.append(eng.last_logits.clone())
        if first is None:
            first = dt
        else:
            ticks.append((dt, len(out)))
    return first, ticks, logits


TRACED_TICKS = 5


# the record_function ranges the phases mark their steps with
MARKS = ("chunk step", "decode tick")


def _union_us(intervals):
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


# the CUDA API calls (cuda* and their cu* twins) that launch work on the
# device from the host: a kernel, or a captured graph
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                     "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch")


def host_launch_calls(prof) -> dict:
    """{call name: count} of the host's launch calls in a ``torch.profiler``
    run (``HOST_LAUNCH_CALLS``, as the profiler names its runtime events)."""
    calls = {}
    for e in prof.events():
        if e.device_type.name == "CPU" and e.name in HOST_LAUNCH_CALLS:
            calls[e.name] = calls.get(e.name, 0) + 1
    return calls


def launches_in_marks(prof, mark: str) -> list:
    """Host launch calls (``HOST_LAUNCH_CALLS``) inside each ``mark`` range
    of a ``torch.profiler`` run, in order."""
    import bisect

    cpu = [e for e in prof.events() if e.device_type.name == "CPU"]
    spans = sorted((e.time_range.start, e.time_range.end) for e in cpu if e.name == mark)
    starts = [a for a, _ in spans]
    counts = [0] * len(spans)
    for e in cpu:
        if e.name in HOST_LAUNCH_CALLS:
            i = bisect.bisect_right(starts, e.time_range.start) - 1
            if i >= 0 and e.time_range.start <= spans[i][1]:
                counts[i] += 1
    return counts


def traced_ticks(torch, eng, reqs, untraced_p50_s: float, label: str = "traced ticks"):
    """Where a decode tick's time goes: serve ``reqs`` again on the drained
    engine, past admission and a warm-up (on a captured engine: the key's
    eager warm-up tick, its capture, a replay), and trace ``TRACED_TICKS``
    decode ticks with ``torch.profiler``. Prints device busy per tick (union
    of the kernel intervals), device kernels per tick, host launch calls
    per tick (``HOST_LAUNCH_CALLS``: kernel launches and graph launches),
    the device's idle share -- of the traced ticks, and of the untraced
    tick p50, since the profiler slows the host -- and the kernels with the
    most device time. Returns those numbers."""
    for r in reqs:
        eng.submit(r)
    for _ in range(3):                       # admission tick + warm-up
        eng.tick()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    walls = []
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(TRACED_TICKS):
            t0 = time.perf_counter()
            eng.tick()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    while eng.queue or any(eng.slot_req):
        eng.tick()
    if eng.pool is not None:
        eng.pool.check()
        check(eng.pool.num_allocated == 0, "pages leaked after the traced ticks")
    kernels, busy_ms, by_name = device_time(prof)
    calls = host_launch_calls(prof)
    busy_ms /= TRACED_TICKS
    wall_ms = statistics.median(walls) * 1e3
    out = {"wall_ms": wall_ms, "busy_ms": busy_ms, "kernels": len(kernels) / TRACED_TICKS,
           "host_launch_calls": sum(calls.values()) / TRACED_TICKS,
           "idle_traced": 1 - busy_ms * TRACED_TICKS / (sum(walls) * 1e3),
           "idle_p50": 1 - busy_ms / (untraced_p50_s * 1e3)}
    print(f"{label}: {TRACED_TICKS} decode ticks under torch.profiler, wall p50 "
          f"{wall_ms:.2f} ms; device busy {busy_ms:.2f} ms/tick; "
          f"{out['kernels']:.0f} device kernels/tick; {out['host_launch_calls']:.1f} host launch "
          f"calls/tick ("
          + ", ".join(f"{n} {c / TRACED_TICKS:.1f}" for n, c in sorted(calls.items()))
          + f"); device idle share {out['idle_traced']:.3f} traced, {out['idle_p50']:.3f} of "
          f"the untraced tick p50; captures {eng.stats.decode_captures}, replays "
          f"{eng.stats.decode_replays} in this engine's life", flush=True)
    print_top(by_name, TRACED_TICKS, "tick", 10)
    return out


def device_time(prof):
    """(device kernels, device busy ms -- the union of their intervals --,
    {kernel name: (calls, us)}) of a ``torch.profiler`` run. The device-side
    ranges of ``record_function`` marks (``MARKS``) are not kernels."""
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA" and e.name not in MARKS]
    check(kernels, "the profiler recorded no device kernels")
    busy_ms = _union_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    return kernels, busy_ms, by_name


def print_top(by_name, per: int, unit: str, top: int):
    for kname, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        print(f"  {t / per / 1e3:8.3f} ms/{unit}  {n / per:7.1f}x  {kname[:90]}", flush=True)


def traced_scheduler_phase(torch, cfg, params, backend, sm_count, new_tokens, blocking,
                           kv_dtype=None, captured=True, rounds=1):
    """A scheduler phase under ``torch.profiler``: device busy against the
    traced wall, kernels, host syncs (``aten::item``: the host waits for the
    device and the launch queue drains), host launch calls
    (``HOST_LAUNCH_CALLS``) per chunk step -- those inside the ``"chunk
    step"`` ranges the phase's engine marks --, and the kernels with the
    most device time. ``captured`` and ``rounds`` as
    :func:`scheduler_phase`'s: the last round is traced. Returns {"syncs",
    "idle", "chunk_calls", "busy_ms"}."""
    prof = scheduler_profiler(torch)
    run = scheduler_phase(torch, cfg, params, backend, sm_count, new_tokens, blocking,
                          kv_dtype, captured=captured, rounds=rounds, profiler=prof)
    return traced_round(torch, prof, run, backend, kv_dtype, captured, rounds)


# the fixed Scheduler phases (bf16, int8) are served at full depth in turns
# and traced at this depth: a host sync is a per-step property (one made in
# a layer shows once per layer at any depth), and the full depth's 300k
# device kernels take a minute to read
TRACED_FIXED_LAYERS = 5


def traced_fixed_phase(torch, cfg, params, sm_count, new_tokens, kv_dtype=None) -> int:
    """The fixed Scheduler phase traced at ``TRACED_FIXED_LAYERS`` of
    ``cfg``'s depth, its first tokens held to exact prefill at that depth.
    Returns its host syncs."""
    cfg_t = arch_config(cfg, TRACED_FIXED_LAYERS)
    params_t = dict(params, layers=params["layers"][:cfg_t.n_layers])
    return traced_scheduler_phase(torch, cfg_t, params_t, "fixed", sm_count, new_tokens,
                                  exact_prefill_reference(torch, cfg_t, params_t),
                                  kv_dtype=kv_dtype)["syncs"]


def scheduler_profiler(torch):
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


def traced_round(torch, prof, run, backend, kv_dtype, captured, rounds):
    """What :func:`traced_scheduler_phase` reads from ``prof``, the profiler
    that ran around the last of ``rounds`` rounds of ``run``."""
    kernels, busy_ms, by_name = device_time(prof)
    syncs = sum(1 for e in prof.events()
                if e.device_type.name == "CPU" and e.name == "aten::item")
    per_step = launches_in_marks(prof, MARKS[0])
    check(per_step, f"traced scheduler phase ({backend}): no chunk step was marked")
    idle = 1 - busy_ms / (run["wall"] * 1e3)
    out = {"syncs": syncs, "idle": idle, "chunk_calls": sum(per_step) / len(per_step),
           "busy_ms": busy_ms}
    print(f"traced scheduler phase ({backend}{', int8' if kv_dtype else ''}, "
          f"{'captured' if captured else 'eager'} steps"
          + (f", round {rounds} of {rounds}" if rounds > 1 else "")
          + f"): wall {run['wall'] * 1e3:.1f} ms under the profiler, device busy {busy_ms:.1f} ms (idle share {idle:.3f}), "
          f"{len(kernels)} kernels, {syncs} host syncs (aten::item), "
          f"{out['chunk_calls']:.1f} host launch calls per chunk step ({len(per_step)} chunk steps)",
          flush=True)
    print_top(by_name, 1, "phase", 6)
    return out


SCHED_CHUNK, SCHED_PACK, SCHED_BUDGET = 256, 2, 512


def exact_prefill_reference(torch, cfg, params):
    """What the Scheduler phases hold first tokens to, on their own: the
    ``PROMPT_LENS`` prompts, each one's first-token logits from prefill at
    its exact length, and their greedy tokens."""
    from repro_torch.models import prefill
    from repro_torch.serving.engine import Request

    prompts = [r.prompt.copy() for r in make_requests(Request, cfg.vocab_size, 1)]
    rows = [prefill(params, cfg, torch.as_tensor(p.astype("int64")[None]).cuda(),
                    cache_len=4096)[0][0].float() for p in prompts]
    return {"prompts": prompts, "rows": rows, "first": [int(r.argmax()) for r in rows]}


def timed(Engine):
    """``Engine`` with each capture timed: ``capture_log`` gets (kind,
    capture + instantiation ms, growth of the allocator's reserved memory
    in bytes) per captured step, both taken across device syncs."""
    import torch

    class Timed(Engine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.capture_log = []

        def _capture(self, step, flat, layout):
            torch.cuda.synchronize()
            reserved, t0 = torch.cuda.memory_reserved(), time.perf_counter()
            rec = super()._capture(step, flat, layout)
            torch.cuda.synchronize()
            self.capture_log.append((step.kind, (time.perf_counter() - t0) * 1e3,
                                     torch.cuda.memory_reserved() - reserved))
            return rec

    return Timed


def scheduler_phase(torch, cfg, params, backend, sm_count, new_tokens, blocking,
                    kv_dtype=None, captured=True, quiet=False, rounds=1, profiler=None):
    """The ``PROMPT_LENS`` requests served by ``Scheduler`` with chunked
    prefill on ``backend`` (the fused K4 on ``lean``, K8 on ``fixed``; int8
    pools with ``kv_dtype="int8"``: the fused K4-int8 on ``lean``, K8 on the
    pools widened to bf16 on ``fixed``, the plain oracles and no kernel on
    ``ref``). ``blocking``
    holds the blocking engine phase's first tokens and first-token logits
    per request, which the first-token logits are held to (``LOGIT_RTOL``,
    and ``LOGIT_ATOL_FRAC`` -- ``INT8_LOGIT_ATOL_FRAC`` on int8 pools).
    With ``captured`` False every step runs eagerly (``capture_decode =
    False``). ``rounds`` serves the prompts that many times on one engine
    (its graphs kept: a key first seen in round 1 is captured in round 2),
    each round checked as the first; ``profiler`` (a ``torch.profiler``
    context) runs around the last round. Returns the last round's launch
    counts, step counts, wall and TTFT per request, every round's walls and
    TTFTs, the engine's stats and its capture times (``capture_log``);
    ``quiet`` prints nothing."""
    from repro_torch.serving.engine import DecodeEngine
    from repro_torch.serving.scheduler import RequestState, Scheduler, SchedulerConfig

    class FirstTokenEngine(timed(DecodeEngine)):
        """Keeps the logits row each request's first token was sampled
        from, off the chunk step that completed its prompt; marks each
        chunk step for the profiler."""

        first_rows = {}

        def prefill_chunks_tick(self, work, pack_width, chunk_cap):
            with torch.profiler.record_function(MARKS[0]):
                toks = super().prefill_chunks_tick(work, pack_width, chunk_cap)
            for i, (slot, chunk, off) in enumerate(work):
                req = self.slot_req[slot]
                if off + len(chunk) == len(req.prompt):
                    self.first_rows[req.uid] = self.last_prefill_logits[i].float()
            return toks

    eng = FirstTokenEngine(cfg, params, engine_config(backend, sm_count, kv_dtype=kv_dtype),
                           device="cuda")
    eng.capture_decode = captured
    what = f"{backend}{' ' + kv_dtype if kv_dtype else ''} scheduler"
    sch = Scheduler(eng, SchedulerConfig(chunk_size=SCHED_CHUNK, prefill_pack=SCHED_PACK,
                                         token_budget=SCHED_BUDGET, chunked=True))
    walls, ttfts = [], []
    for rnd in range(rounds):
        # the last round under the profiler when one is given
        ctx = profiler if profiler is not None and rnd == rounds - 1 else contextlib.nullcontext()
        st0 = {k: getattr(eng.stats, k) for k in ("ticks", "chunk_captures", "chunk_replays",
                                                   "decode_captures", "decode_replays")}
        steps0, chunks0 = sch.stats.steps, len(eng.stats.tick_prefill_tokens)
        reset_launch_counts()
        with ctx:
            t0 = time.perf_counter()
            handles = [sch.submit(p, new_tokens, uid=i) for i, p in enumerate(blocking["prompts"])]
            long = handles[0]
            overlap = 0
            while sch.pending and sch.stats.steps - steps0 < 400:
                out = sch.step()
                if long.state is RequestState.PREFILLING:
                    overlap += len(out)
            check(not sch.pending, f"{what}: requests still pending after 400 steps")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = launch_counts()
        st = {k: getattr(eng.stats, k) - v for k, v in st0.items()}
        chunk_steps, ticks = len(eng.stats.tick_prefill_tokens) - chunks0, st["ticks"]
        check(all(h.done and len(h.generated) == new_tokens for h in handles),
              f"{what}: a request did not finish")
        eng.pool.check(scales=eng._kv_scale_arrays())
        check(eng.pool.num_allocated == 0, f"{what}: {eng.pool.num_allocated} pages leaked")
        check(overlap > 0, f"{what}: decode stalled during the long prefill")
        kernels = {"lean": ("K4f", "K2"), "fixed": ("K8", "K6"), "ref": ()}[backend]
        if kernels:
            check(counts[kernels[0]] == cfg.n_layers * chunk_steps and chunk_steps > 0,
                  f"{what}: {kernels[0]} launched {counts[kernels[0]]} times, expected "
                  f"{cfg.n_layers} x {chunk_steps} chunk steps")
            check(counts[kernels[1]] == cfg.n_layers * ticks and ticks > 0,
                  f"{what}: {kernels[1]} launched {counts[kernels[1]]} times, expected "
                  f"{cfg.n_layers} x {ticks} decode ticks")
        others = {k: n for k, n in counts.items() if k not in kernels and n}
        check(not others, f"{what}: other kernels ran: {others}")
        tc = path_counts(what)
        ttft = [(h.first_token_time - h.arrival_time) * 1e3 for h in handles]
        agree = sum(h.generated[0] == blocking["first"][h.uid] for h in handles)
        atol_frac = {"int8": INT8_LOGIT_ATOL_FRAC, "f8": F8_LOGIT_ATOL_FRAC}.get(kv_dtype,
                                                                             LOGIT_ATOL_FRAC)
        worst = None
        for h in handles:
            ref = blocking["rows"][h.uid]
            got = eng.first_rows[h.uid]
            check(bool(torch.isfinite(got).all()), f"{what}: first-token logits not finite")
            atol = atol_frac * ref.abs().median().item()
            delta = (got - ref).abs()
            check(torch.allclose(got, ref, rtol=LOGIT_RTOL, atol=atol),
                  f"{what}: request {h.uid}'s first-token logits differ from blocking "
                  f"prefill by up to {delta.max().item()} (allowed {atol} + {LOGIT_RTOL} |ref|)")
            if worst is None or delta.max().item() > worst[0]:
                worst = (delta.max().item(), atol, h.uid)
        launched = (f"launches {kernels[0]} {counts[kernels[0]]} = {cfg.n_layers} x "
                    f"{chunk_steps}, {kernels[1]} {counts[kernels[1]]} = {cfg.n_layers} x "
                    f"{ticks} (on the tensor cores: K8 {tc['K8']}, fused K4 {tc['K4f']})"
                    if kernels else "no kernel launched")
        check(captured or st["chunk_captures"] == st["decode_captures"] == 0,
              f"{what}: the eager run captured a step")
        walls.append(wall)
        ttfts.append(ttft)
        if not quiet:
            print(f"scheduler phase ({backend}{f', {kv_dtype} pools' if kv_dtype else ''}, "
                  f"{'captured' if captured else 'eager'} steps"
                  + (f", round {rnd + 1} of {rounds}" if rounds > 1 else "")
                  + f"): chunk {SCHED_CHUNK}, pack {SCHED_PACK}, budget {SCHED_BUDGET}: "
                  f"{sch.stats.steps - steps0} scheduler steps, {chunk_steps} chunk steps "
                  f"({st['chunk_replays']} replayed, {st['chunk_captures']} captures), {ticks} "
                  f"decode ticks ({st['decode_replays']} replayed, {st['decode_captures']} "
                  f"captures) in {wall:.2f} s; {launched}; TTFT ms per request (prompts "
                  f"{list(PROMPT_LENS)}): " + ", ".join(f"{t:.1f}" for t in ttft)
                  + f"; {overlap} decode tokens while the {PROMPT_LENS[0]}-token prompt was "
                  f"prefilling; pool clean; first tokens agreeing with blocking prefill "
                  f"{agree}/{len(handles)}; worst first-token logit gap {worst[0]:.4f} "
                  f"(request {worst[2]}, allowed {worst[1]:.4f} + {LOGIT_RTOL} |ref|)",
                  flush=True)
    check(not captured or eng.stats.chunk_replays > 0, f"{what}: no chunk step replayed a graph")
    return {"counts": counts, "chunk_steps": chunk_steps, "ticks": ticks, "wall": wall,
            "walls": walls, "ttfts": ttfts, "ttft": ttft, "stats": eng.stats,
            "capture_log": eng.capture_log}


# ------------------------------------------------------------ merge kernel K3
def merge_plan_drive(torch, sm_count: int):
    """The two-phase plans of ``ops.decode`` with ``merge_impl="pallas"`` --
    the entry points K3 serves (the engine keeps ``segment_merge``) -- at
    the kernel phase's decode shape (dense and paged) and on a 256-token
    chunk pack (verify, ``fused=False``: K4 partials, then K3; on bf16 and
    on int8 pages), each against its ``"xla"`` plan. Returns the launch
    counts of each ``"pallas"`` call."""
    from repro_torch.core.leantile import make_chunk_schedule, make_schedule
    from repro_torch.kernels import ops

    lens, Hq, Hkv, d, tile, width = [4000, 1500, 700, 1], 32, 8, 128, 128, 32
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    q, k_pool, v_pool, tbl, k_dense, v_dense = make_kv_problem(
        torch, lens, Hq, Hkv, d, tile, width, torch.bfloat16, gen, dev)
    sched = make_schedule(lens, Hkv, tile, sm_count)
    seg_ctx = torch.tensor([L for L in lens for _ in range(Hkv)], dtype=torch.int32, device=dev)
    visible = [o + CHUNK for o in CHUNK_OFFS]
    csched = make_chunk_schedule(visible, Hkv, tile, sm_count, max_len=max(visible) + tile)
    qc, kc, vc, tblc = chunk_pack(torch, CHUNK_OFFS, CHUNK, Hq, Hkv, d, tile, torch.bfloat16,
                                  gen, dev)
    kq, ks, vq, vs = quantized(torch, kc, vc)
    c_ctx = torch.tensor([v for v in visible for _ in range(Hkv)], dtype=torch.int32, device=dev)
    c_qs = torch.tensor([o for o in CHUNK_OFFS for _ in range(Hkv)], dtype=torch.int32,
                        device=dev)

    def verify(impl, kv, **sc):
        plan = ops.DecodePlan(kind="verify", sched=csched, fused=False, merge_impl=impl,
                              spec_rows=CHUNK)
        return ops.decode(qc, kv, plan=plan, ctx=c_ctx, page_tbl=tblc, qstart=c_qs, **sc)

    calls = {
        "dense": lambda impl: ops.lean_decode_from_schedule(
            q, k_dense, v_dense, seg_ctx, sched, fused=False, merge_impl=impl),
        "paged": lambda impl: ops.lean_decode_paged_from_schedule(
            q, k_pool, v_pool, seg_ctx, tbl, sched, fused=False, merge_impl=impl),
        "verify": lambda impl: verify(impl, (kc, vc)),
        "verify int8": lambda impl: verify(impl, (kq, vq), k_scales=ks, v_scales=vs),
    }
    errs, counts = {}, {}
    for kind, fn in calls.items():
        reset_launch_counts()
        out = fn("pallas")
        torch.cuda.synchronize()
        counts[kind] = launch_counts()
        ref = fn("xla")
        errs[kind] = (out.float() - ref.float()).abs().max().item()
        # both round the same float32 merge of the same partials to bf16:
        # one bf16 step of the output apart at most
        step = torch.finfo(torch.bfloat16).eps * ref.float().abs()
        check(bool(((out.float() - ref.float()).abs() <= step + F32_TOL).all()),
              f"merge_impl='pallas' ({kind}) disagrees with 'xla': max |err| {errs[kind]}")
    want = {"dense": {"K1": 1, "K3": 1}, "paged": {"K1": 1, "K3": 1},
            "verify": {"K4": 1, "K3": 1}, "verify int8": {"K4": 1, "K3": 1}}
    for kind, w in want.items():
        got = {k: n for k, n in counts[kind].items() if n}
        check(got == w, f"the 'pallas' {kind} plan launched {got}, expected {w}")
    print("merge plans (merge_impl='pallas', bf16 queries; verify also on int8 pages): K3 "
          f"launches {sum(c['K3'] for c in counts.values())} (dense, paged, verify x 2); max "
          "|pallas - xla| " + ", ".join(f"{k} {e:.2e}" for k, e in errs.items()), flush=True)
    return counts


# ------------------------------------------------------ cascade kernel (K5)
PREFIX_TOKENS, SUFFIXES = 2048, (700, 300, 129, 1)
CASCADE_CASES = {
    # name: (passes (members, first page, pages), suffix tokens per sequence)
    "2048-token shared prefix": ([((0, 1, 2, 3), 0, PREFIX_TOKENS // 128)], SUFFIXES),
    "two-level (8 pages x 4, 8 more x 2)": ([((0, 1, 2, 3), 0, 8), ((0, 1), 8, 8)], SUFFIXES),
}


def cascade_problem(torch, passes, suffixes, Hq, Hkv, d, tile, dtype, gen, dev):
    """A cascade batch on shuffled pages: the passes' members alias shared
    pages (``tbl``), and ``dup`` is the same batch with every member past a
    pass's first on its own copy of them -- the same tokens in private
    pages."""
    import numpy as np

    B = len(suffixes)
    cover = [0] * B
    for mem, st, cnt in passes:
        for b in mem:
            cover[b] = max(cover[b], st + cnt)
    lens = [cover[b] * tile + suffixes[b] for b in range(B)]
    n_pages = [-(-L // tile) for L in lens]
    width = max(n_pages) + 1
    num_pages = 1 + sum(n_pages) + sum(c * len(m) for m, _, c in passes) + 2
    free = (torch.randperm(num_pages - 1, generator=gen, device=dev).cpu() + 1).tolist()
    tbl = np.zeros((B, width), np.int32)
    for mem, st, cnt in passes:
        pages = [free.pop() for _ in range(cnt)]
        for b in mem:
            tbl[b, st:st + cnt] = pages
    for b in range(B):
        for t in range(cover[b], n_pages[b]):
            tbl[b, t] = free.pop()
    shape = (num_pages, Hkv, tile, d)
    k_pool = torch.randn(shape, generator=gen, device=dev).to(dtype)
    v_pool = torch.randn(shape, generator=gen, device=dev).to(dtype)
    k_pool[0] = 0
    v_pool[0] = 0
    dup = tbl.copy()
    for mem, st, cnt in passes:
        for b in mem[1:]:
            copy = [free.pop() for _ in range(cnt)]
            src = torch.as_tensor(tbl[b, st:st + cnt]).long().to(dev)
            k_pool[copy], v_pool[copy] = k_pool[src], v_pool[src]
            dup[b, st:st + cnt] = copy
    q = torch.randn(B, Hq, d, generator=gen, device=dev).to(dtype)
    return q, k_pool, v_pool, tbl, dup, lens


def cascade_operands(torch, q, k_pool, v_pool, tbl, lens, passes, sm_count):
    """K5's operands as ``ops.lean_decode_cascade`` builds them."""
    import numpy as np

    from repro_torch.core.leantile import cascade_fused_descriptors, make_cascade_schedule
    from repro_torch.kernels import lean_decode as ld
    from repro_torch.kernels import ops

    dev = q.device
    B, Hq, d = q.shape
    _, Hkv, tile, _ = k_pool.shape
    g = Hq // Hkv
    csched, binding = make_cascade_schedule(
        lens, [list(m) for m, _, _ in passes], [c for _, _, c in passes], Hkv, tile, sm_count,
        page_starts=[st for _, st, _ in passes], max_len=tbl.shape[1] * tile)
    ptbl, stbl = ops.cascade_tables(tbl, binding)
    mem = torch.as_tensor(binding.members).long().clamp(min=0).to(dev)
    nmax, NP = csched.group_size, csched.num_groups
    q_pref = q.reshape(B, Hkv, g, d)[mem].movedim(2, 1).reshape(NP * Hkv, nmax * g, d)
    suffix = np.asarray(lens) - binding.seq_prefix_len
    ctx_all = np.concatenate([np.repeat(binding.prefix_lens, Hkv), np.repeat(suffix, Hkv)])
    route = torch.cat([ops.paged_route(csched.prefix_sched, torch.as_tensor(ptbl).to(dev), Hkv),
                       ops.paged_route(csched.suffix_sched, torch.as_tensor(stbl).to(dev), Hkv)])
    k_rows, v_rows = ops._pool_rows(k_pool, v_pool)
    fdesc = ld.cascade_fused_desc(cascade_fused_descriptors(csched, binding), csched, dev)
    return (q_pref.contiguous(), q.reshape(B * Hkv, g, d).contiguous(), k_rows, v_rows,
            torch.as_tensor(ctx_all.astype(np.int32)).to(dev), route.contiguous(), fdesc,
            csched, 1.0 / math.sqrt(d)), binding


def cascade_work(binding, csched, lens, args, q, o, lse, elem):
    """K5's bound terms: the bytes the function needs -- each pass's shared
    K/V once, the suffixes' K/V, the queries, o and lse -- its operations,
    the round trip of its partials (all stacked rows of a prefix piece,
    written once and read once: it comes from splitting the work over CTAs,
    so it is printed beside the bound, not counted in it) and the K/V
    bytes."""
    B, Hq, d = q.shape
    g = args[1].shape[1]                 # the suffix queries, (B * Hkv, g, d)
    Hkv = Hq // g
    pref_tok = int(binding.prefix_lens[binding.members[:, 0] >= 0].sum())
    suf_tok = sum(lens) - int(binding.seq_prefix_len.sum())
    kv_bytes = 2 * (pref_tok + suf_tok) * Hkv * d * elem
    Pp, Ps = csched.prefix_sched.num_pieces, csched.suffix_sched.num_pieces
    part_bytes = 2 * 4 * (d + 2) * (Pp * args[0].shape[1] + Ps * g)
    nbytes = kv_bytes + q.numel() * elem + 4 * (o.numel() + lse.numel())
    members = (binding.members >= 0).sum(axis=1)
    flops = 4 * d * (int((binding.prefix_lens * members).sum()) + suf_tok) * g * Hkv
    return nbytes, flops, part_bytes, kv_bytes


def cascade_kernel_phase(torch, sm_count: int, dev_name: str):
    """K5 at Mistral-NeMo-12B attention shapes (bf16 and f32, shuffled
    pages, one worker per SM) on the two ``CASCADE_CASES``: against its
    plain version, against the same cascade over duplicated pages (bit for
    bit), against K2 on the unshared batch (the same tokens in private
    pages; ``CASCADE_TOL``) and against the two-call cascade (K1 on each
    pass + segment_merge); K5's, the plain version's, K2's and SDPA's
    times, and K5's byte bound (without and with its partials)."""
    from repro_torch.core.attention import paged_gather_kv
    from repro_torch.core.leantile import make_schedule
    from repro_torch.kernels import decode_ring as dr
    from repro_torch.kernels import lean_decode as ld
    from repro_torch.kernels import ops

    Hq, Hkv, d, tile = 32, 8, 128, 128
    g = Hq // Hkv
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    results = {}
    for case, (passes, suffixes) in CASCADE_CASES.items():
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            dname = str(dtype).split(".")[-1]
            elem = torch.finfo(dtype).bits // 8
            q, k_pool, v_pool, tbl, dup, lens = cascade_problem(
                torch, passes, suffixes, Hq, Hkv, d, tile, dtype, gen, dev)
            args, binding = cascade_operands(torch, q, k_pool, v_pool, tbl, lens, passes,
                                             sm_count)
            csched = args[7]
            B = len(lens)
            ring_before = ld.cascade_ring_launches
            o, lse = ld.lean_cascade_fused(*args)
            o_ref, lse_ref = ld.lean_cascade_fused_plain(*args)
            torch.cuda.synchronize()
            check(ld.cascade_ring_launches == ring_before + 1,
                  f"K5 {dname} ({case}) did not run on the decode ring")
            print("  " + ring_line(f"K5 {dname} ({case})", elem, d, tile,
                                   dr.row_bucket(args[0].shape[1])), flush=True)
            err = max((o - o_ref).abs().max().item(), (lse - lse_ref).abs().max().item())
            check(torch.allclose(o, o_ref, atol=tol, rtol=tol)
                  and torch.allclose(lse, lse_ref, atol=tol, rtol=tol),
                  f"K5 {dname} ({case}) disagrees with its plain version: max |err| {err}")
            dup_args, _ = cascade_operands(torch, q, k_pool, v_pool, dup, lens, passes,
                                           sm_count)
            o_dup, lse_dup = ld.lean_cascade_fused(*dup_args)
            check(torch.equal(o, o_dup) and torch.equal(lse, lse_dup),
                  f"K5 {dname} ({case}): shared and duplicated pages differ")
            # K2 on the unshared batch: the same tokens, every page private
            sched = make_schedule(lens, Hkv, tile, sm_count)
            seg_ctx = torch.tensor([L for L in lens for _ in range(Hkv)], dtype=torch.int32,
                                   device=dev)
            dup_t = torch.as_tensor(dup).to(dev)
            k_rows, v_rows = ops._pool_rows(k_pool, v_pool)
            k2_args = (q.reshape(B * Hkv, g, d).contiguous(), k_rows, v_rows, seg_ctx,
                       ops.paged_route(sched, dup_t, Hkv), sched, 1.0 / math.sqrt(d))
            o2, lse2 = ld.lean_decode_fused(*k2_args)
            err_k2 = max((o - o2).abs().max().item(), (lse - lse2).abs().max().item())
            check(torch.allclose(o, o2, atol=CASCADE_TOL, rtol=CASCADE_TOL)
                  and torch.allclose(lse, lse2, atol=CASCADE_TOL, rtol=CASCADE_TOL),
                  f"K5 {dname} ({case}) and K2 on the unshared batch differ by {err_k2}")
            two = ops.lean_decode_cascade(
                q, k_pool, v_pool, tbl, lens, [list(m) for m, _, _ in passes],
                [c for _, _, c in passes], page_starts=[st for _, st, _ in passes],
                num_workers=sm_count, fused=False, return_lse=True)
            # the outputs leave in the inputs' type: in bf16 both round a
            # float32 result, one bf16 step of the output apart at most
            o_k5 = o.reshape(B, Hq, d).to(dtype).float()
            step = torch.finfo(dtype).eps * o_k5.abs() if dtype == torch.bfloat16 else 0.0
            err_two = max((two[0].float() - o_k5).abs().max().item(),
                          (two[1] - lse.reshape(B, Hq)).abs().max().item())
            check(bool(((two[0].float() - o_k5).abs() <= step + CASCADE_TOL).all())
                  and torch.allclose(two[1], lse.reshape(B, Hq), atol=CASCADE_TOL,
                                     rtol=CASCADE_TOL),
                  f"K5 {dname} ({case}) and the two-call cascade differ by {err_two}")
            k5_ms = gpu_ms(lambda: ld.lean_cascade_fused(*args))
            k5_plain_ms = gpu_ms(lambda: ld.lean_cascade_fused_plain(*args), reps=3)
            k2_ms = gpu_ms(lambda: ld.lean_decode_fused(*k2_args))
            k_dense, v_dense = paged_gather_kv(k_pool, dup_t), paged_gather_kv(v_pool, dup_t)
            lib = library_yardstick(torch, q, k_dense, v_dense, lens, g, elem)
            lib_ms = lib[LIBRARY_CALL][0]
            Pp, Ps = csched.prefix_sched.num_pieces, csched.suffix_sched.num_pieces
            qmax = args[0].shape[1]
            nbytes, flops, part_bytes, kv_bytes = cascade_work(binding, csched, lens, args, q, o,
                                                               lse, elem)
            b_ms, b_by = bound(dev_name, dname, nbytes, flops)
            bp_ms, _ = bound(dev_name, dname, nbytes + part_bytes, flops)
            unshared = 2 * sum(lens) * Hkv * d * elem
            results[(case, dname)] = {
                "ms": k5_ms, "plain_ms": k5_plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
                "bound_by": b_by, "max_abs_err": err, "k2_ms": k2_ms}
            print(f"K5 {case} {dname}: lens {lens}, {csched.num_groups} pass(es) x "
                  f"{csched.group_size} members ({qmax} stacked rows), pieces {Pp} + {Ps}; "
                  f"max|err| {err:.3e}, shared == duplicated bitwise, vs K2 unshared "
                  f"{err_k2:.2e}, vs two-call {err_two:.2e}; K5 {k5_ms:.4f} ms (bound "
                  f"{b_ms:.4f} ms by {b_by}, {kv_bytes / 1e6:.1f} MB K/V; with the "
                  f"{part_bytes / 1e6:.1f} MB round trip of K5's partials {bp_ms:.4f} ms; "
                  f"plain {k5_plain_ms:.3f} ms); "
                  f"K2 on the unshared batch {k2_ms:.4f} ms reading {unshared / 1e6:.1f} MB "
                  f"K/V: K5/K2 = {k5_ms / k2_ms:.3f}; SDPA on the gathered K/V "
                  f"{lib_ms:.4f} ms", flush=True)
    return results


# ------------------------------------------------------------- int8 kernels
INT8_REPLACES = {
    # the quantized=True branch of each TPU kernel
    "lean_decode_fused_int8": ("lean_decode.cu", "src/repro/kernels/lean_decode.py:321"),
    "lean_decode_partials_int8": ("lean_decode.cu", "src/repro/kernels/lean_decode.py:135"),
    "lean_prefill_fused_int8": ("lean_prefill_tc.cu", "src/repro/kernels/lean_prefill.py:102"),
    "lean_prefill_chunk_partials_int8": ("lean_prefill.cu",
                                         "src/repro/kernels/lean_prefill.py:102"),
    "lean_cascade_fused_int8": ("lean_cascade.cu", "src/repro/kernels/lean_decode.py:628"),
}
INT8_LIBRARY = "SDPA on the dequantized bf16 K/V"   # no one call reads int8 pages + scales


def quantized(torch, k_pool, v_pool, zero_pages=()):
    """An int8 engine's pools from float ones: int8 content and one float32
    scale per (page, head), as admission writes them; ``zero_pages`` get
    scale 0 (fresh pages), which must read as exact zeros."""
    from repro_torch.core.attention import quantize_kv_blocks

    (kq, ks), (vq, vs) = quantize_kv_blocks(k_pool), quantize_kv_blocks(v_pool)
    for p in zero_pages:
        ks[p] = 0.0
        vs[p] = 0.0
    return kq, ks, vq, vs


def int8_kernel_phase(torch, sm_count: int, dev_name: str):
    """K1-, K2-, K4- (fused, on the tensor cores, and partials) and K5-int8
    (bf16 queries, int8 pool rows, a float32 scale per row) against their
    plain versions at the bf16 kernel phases' shapes: the decode batch (one
    sequence on a zero-scale page, whose output must be exactly 0), the
    two-chunk pack, the 2048-token shared prefix. Times with L2 evicted, the
    plain versions' times, the byte
    bound (int8 K/V + scales + queries + outputs or partials), and the
    library yardstick: SDPA on the K/V dequantized to bf16 (no one call
    reads int8 pages with scales)."""
    from repro_torch.core.attention import paged_gather_kv_dequant
    from repro_torch.core.leantile import make_chunk_schedule, make_schedule
    from repro_torch.kernels import decode_ring as dr
    from repro_torch.kernels import lean_decode as ld
    from repro_torch.kernels import lean_prefill as lp
    from repro_torch.kernels import ops

    bf = torch.bfloat16
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    results = {}
    Hq, Hkv, d, tile = 32, 8, 128, 128
    g = Hq // Hkv
    scale = 1.0 / math.sqrt(d)

    def record(name, ms, plain_ms, lib_ms, nbytes, flops, err):
        b_ms, b_by = bound(dev_name, "bfloat16", nbytes, flops)
        results[(name, "bfloat16")] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                                       "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err}
        print(f"  {name}: max|err| {err:.3e}; {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}, "
              f"{nbytes / 1e6:.1f} MB; plain {plain_ms:.3f} ms; {INT8_LIBRARY} "
              f"{lib_ms:.4f} ms)", flush=True)

    # K2-int8 and K1-int8 on the decode batch
    lens, width = [4000, 1500, 700, 1], 32
    B = len(lens)
    sched = make_schedule(lens, Hkv, tile, sm_count)
    q, k_pool, v_pool, tbl, _, _ = make_kv_problem(torch, lens, Hq, Hkv, d, tile, width, bf,
                                                   gen, dev)
    kq, ks, vq, vs = quantized(torch, k_pool, v_pool, zero_pages=[int(tbl[3, 0])])
    seg_ctx = torch.tensor([L for L in lens for _ in range(Hkv)], dtype=torch.int32, device=dev)
    k_rows, v_rows = ops._pool_rows(kq, vq)
    sc = dict(k_scales=ks, v_scales=vs)
    q_seg = q.reshape(B * Hkv, g, d).contiguous()
    route = ops.paged_route(sched, tbl, Hkv)
    args = (q_seg, k_rows, v_rows, seg_ctx, route, sched, scale)
    print(f"int8 kernel phase: decode lens {lens}, Hq {Hq} Hkv {Hkv} d {d} page {tile}, "
          f"workers {sm_count}; sequence 3 on a zero-scale page", flush=True)
    ring_before = (ld.fused_ring_launches, ld.partials_ring_launches)
    o, lse = ld.lean_decode_fused(*args, **sc)
    o_ref, lse_ref = ld.lean_decode_fused_plain(*args, **sc)
    parts = ld.lean_decode_partials(*args, **sc)
    parts_ref = ld.lean_decode_partials_plain(*args, **sc)
    torch.cuda.synchronize()
    check((ld.fused_ring_launches, ld.partials_ring_launches)
          == (ring_before[0] + 1, ring_before[1] + 1),
          "K2-int8 or K1-int8 did not run on the decode ring")
    print("  " + ring_line("K1/K2-int8", 1, d, tile, g), flush=True)
    err_k2 = max((o - o_ref).abs().max().item(), (lse - lse_ref).abs().max().item())
    err_k1 = max((a - b).abs().max().item() for a, b in zip(parts, parts_ref))
    check(torch.allclose(o, o_ref, atol=BF16_TOL, rtol=BF16_TOL)
          and torch.allclose(lse, lse_ref, atol=BF16_TOL, rtol=BF16_TOL),
          f"K2-int8 disagrees with its plain version: max |err| {err_k2}")
    check(all(torch.allclose(a, b, atol=BF16_TOL, rtol=BF16_TOL)
              for a, b in zip(parts, parts_ref)),
          f"K1-int8 partials disagree with the plain version: max |err| {err_k1}")
    check(not o[3 * Hkv:].any() and not o_ref[3 * Hkv:].any(),
          "K2-int8: the zero-scale page did not read as exact zeros")
    tokens = sum(lens) * Hkv
    rows_read = sum(-(-L // tile) for L in lens) * Hkv
    kv_bytes = 2 * tokens * d + 2 * 4 * rows_read               # int8 K/V + their scales
    small = q_seg.numel() * 2 + 4 * (seg_ctx.numel() + route.numel()
                                     + ld.schedule_tensors(sched, dev)["desc"].numel())
    kd = paged_gather_kv_dequant(kq, ks, tbl, dtype=bf)
    vd = paged_gather_kv_dequant(vq, vs, tbl, dtype=bf)
    lib_ms = library_yardstick(torch, q, kd, vd, lens, g, 2)[LIBRARY_CALL][0]
    del kd, vd
    flops = 4 * g * d * tokens
    record("lean_decode_fused_int8", gpu_ms(lambda: ld.lean_decode_fused(*args, **sc)),
           gpu_ms(lambda: ld.lean_decode_fused_plain(*args, **sc), reps=5), lib_ms,
           kv_bytes + small + 4 * (o.numel() + lse.numel()), flops, err_k2)
    record("lean_decode_partials_int8", gpu_ms(lambda: ld.lean_decode_partials(*args, **sc)),
           gpu_ms(lambda: ld.lean_decode_partials_plain(*args, **sc), reps=5), lib_ms,
           kv_bytes + small + 4 * sum(t.numel() for t in parts), flops, err_k1)

    # K4-int8 on the two-chunk pack
    C, N = CHUNK, len(CHUNK_OFFS)
    visible = [o_ + C for o_ in CHUNK_OFFS]
    sched = make_chunk_schedule(visible, Hkv, tile, sm_count, max_len=max(visible) + tile)
    q, k_pool, v_pool, tbl = chunk_pack(torch, CHUNK_OFFS, C, Hq, Hkv, d, tile, bf, gen, dev)
    kq, ks, vq, vs = quantized(torch, k_pool, v_pool)
    k_rows, v_rows = ops._pool_rows(kq, vq)
    sc = dict(k_scales=ks, v_scales=vs)
    seg_ctx = torch.tensor([v for v in visible for _ in range(Hkv)], dtype=torch.int32, device=dev)
    seg_qs = torch.tensor([o_ for o_ in CHUNK_OFFS for _ in range(Hkv)], dtype=torch.int32,
                          device=dev)
    route = ops.paged_route(sched, tbl, Hkv)
    args = (q.reshape(N * Hkv, g * C, d).contiguous(), k_rows, v_rows, seg_ctx, seg_qs, route,
            sched, scale, C)
    parts = lp.lean_prefill_chunk_partials(*args, **sc)
    parts_ref = lp.lean_prefill_partials_plain(*args, **sc)
    lp.reset_launch_counts()
    o4f = lp.lean_prefill_fused(*args, **sc)
    o4f_ref = lp.lean_prefill_fused_plain(*args, **sc)
    torch.cuda.synchronize()
    err_k4 = max((a - b).abs().max().item() for a, b in zip(parts, parts_ref))
    check(all(torch.allclose(a, b, atol=BF16_TOL, rtol=BF16_TOL)
              for a, b in zip(parts, parts_ref)),
          f"K4-int8 partials disagree with the plain version: max |err| {err_k4}")
    check((lp.fused_launches, lp.fused_tc_launches) == (1, 1),
          f"fused K4-int8: {lp.fused_launches} launches, {lp.fused_tc_launches} on the tensor "
          "cores, expected 1, 1")
    # one bf16 step of the output plus 2e-5, as bf16 K4 and K8: both round a
    # float32 result; the kernel applies the scales to the scores and to P
    # (int8 values are exact in bf16) and splits P into two bf16 halves
    err_k4f = (o4f.float() - o4f_ref.float()).abs().max().item()
    step = torch.finfo(torch.bfloat16).eps * o4f_ref.float().abs()
    check(bool(((o4f.float() - o4f_ref.float()).abs() <= step + BF16_TOL).all()),
          f"fused K4-int8 disagrees with its plain version: max |err| {err_k4f}")
    kd = paged_gather_kv_dequant(kq, ks, tbl, dtype=bf)
    vd = paged_gather_kv_dequant(vq, vs, tbl, dtype=bf)
    K = kd.shape[2]
    q_off = torch.tensor(CHUNK_OFFS, dtype=torch.int32, device=dev)
    qpos = q_off[:, None].long() + torch.arange(g * C, device=dev)[None, :] % C
    mask = (torch.arange(K, device=dev)[None, None, :] <= qpos[..., None])[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qf = q.reshape(N, Hkv, g * C, d)
    lib_ms = gpu_ms(lambda: sdpa(qf, kd, vd, attn_mask=mask), reps=10)
    del kd, vd
    keys_seen = sum(Hq * (C * o_ + C * (C + 1) // 2) for o_ in CHUNK_OFFS)
    kv_bytes = 2 * sum(visible) * Hkv * d + 2 * 4 * sum(-(-v // tile) for v in visible) * Hkv
    small = 4 * (seg_ctx.numel() * 2 + route.numel()
                 + ld.schedule_tensors(sched, dev)["desc"].numel())
    record("lean_prefill_fused_int8", gpu_ms(lambda: lp.lean_prefill_fused(*args, **sc), reps=10),
           gpu_ms(lambda: lp.lean_prefill_fused_plain(*args, **sc), reps=3), lib_ms,
           q.numel() * 2 * 2 + kv_bytes + small, 4 * d * keys_seen, err_k4f)
    record("lean_prefill_chunk_partials_int8",
           gpu_ms(lambda: lp.lean_prefill_chunk_partials(*args, **sc), reps=10),
           gpu_ms(lambda: lp.lean_prefill_partials_plain(*args, **sc), reps=3), lib_ms,
           q.numel() * 2 + kv_bytes + small + 4 * sum(t.numel() for t in parts),
           4 * d * keys_seen, err_k4)

    # K5-int8 on the 2048-token shared prefix
    passes, suffixes = CASCADE_CASES[next(iter(CASCADE_CASES))]
    q, k_pool, v_pool, tbl, dup, lens = cascade_problem(torch, passes, suffixes, Hq, Hkv, d,
                                                        tile, bf, gen, dev)
    kq, ks, vq, vs = quantized(torch, k_pool, v_pool)
    args, binding = cascade_operands(torch, q, kq, vq, tbl, lens, passes, sm_count)
    sc = dict(k_scales=ks, v_scales=vs)
    ring_before = ld.cascade_ring_launches
    o, lse = ld.lean_cascade_fused(*args, **sc)
    o_ref, lse_ref = ld.lean_cascade_fused_plain(*args, **sc)
    torch.cuda.synchronize()
    check(ld.cascade_ring_launches == ring_before + 1, "K5-int8 did not run on the decode ring")
    print("  " + ring_line("K5-int8", 1, d, tile, dr.row_bucket(args[0].shape[1])), flush=True)
    err_k5 = max((o - o_ref).abs().max().item(), (lse - lse_ref).abs().max().item())
    check(torch.allclose(o, o_ref, atol=BF16_TOL, rtol=BF16_TOL)
          and torch.allclose(lse, lse_ref, atol=BF16_TOL, rtol=BF16_TOL),
          f"K5-int8 disagrees with its plain version: max |err| {err_k5}")
    dup_t = torch.as_tensor(dup).to(dev)
    kd = paged_gather_kv_dequant(kq, ks, dup_t, dtype=bf)
    vd = paged_gather_kv_dequant(vq, vs, dup_t, dtype=bf)
    lib_ms = library_yardstick(torch, q, kd, vd, lens, g, 2)[LIBRARY_CALL][0]
    del kd, vd
    pref_tok = int(binding.prefix_lens[binding.members[:, 0] >= 0].sum())
    suf_tok = sum(lens) - int(binding.seq_prefix_len.sum())
    kv_tok = (pref_tok + suf_tok) * Hkv
    kv_bytes = 2 * kv_tok * d + 2 * 4 * -(-kv_tok // tile)
    members = (binding.members >= 0).sum(axis=1)
    flops = 4 * d * (int((binding.prefix_lens * members).sum()) + suf_tok) * g * Hkv
    record("lean_cascade_fused_int8", gpu_ms(lambda: ld.lean_cascade_fused(*args, **sc)),
           gpu_ms(lambda: ld.lean_cascade_fused_plain(*args, **sc), reps=3), lib_ms,
           kv_bytes + q.numel() * 2 + 4 * (o.numel() + lse.numel()), flops, err_k5)
    return results


# --------------------------------------------------- page sizes the engine picks
PAGE_CASES = (
    # page, d, dtypes: pages that are not a multiple of 8 (the engine picks
    # 100 for a 100-token cache), and a page of 256 keys at d 128 (the
    # row-block kernel walks it in sub-tiles)
    (12, 128, ("bfloat16",)),
    (100, 128, ("bfloat16",)),
    (256, 128, ("float32", "bfloat16")),
)


def page_size_phase(torch, sm_count: int):
    """K8 (``fixed`` chunks), K4 (``lean`` chunks) and K6 (``fixed``
    decode) on ``PAGE_CASES`` against their plain versions, at Mistral-NeMo-
    12B attention shapes: a pack of two 100-token chunks at offsets 300 and
    5, and decode lengths 700, 1, 257. K8 runs on the CUDA cores where the
    page is not a multiple of 8 (the path rule)."""
    from repro_torch.core.leantile import fixed_split_factor, make_chunk_schedule
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import lean_prefill as lp
    from repro_torch.kernels import ops

    Hq, Hkv, offs, C = 32, 8, (300, 5), 100
    g, N = Hq // Hkv, len(offs)
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    lines = []
    for page, d, dtypes in PAGE_CASES:
        scale = 1.0 / math.sqrt(d)
        for dname in dtypes:
            dtype = getattr(torch, dname)
            tol = F32_TOL if dtype == torch.float32 else BF16_TOL
            q, kp, vp, tbl = chunk_pack(torch, offs, C, Hq, Hkv, d, page, dtype, gen, dev)
            q_off = torch.tensor(offs, dtype=torch.int32, device=dev)
            fp.reset_launch_counts()
            o8 = fp.flash_prefill_paged(q, kp, vp, tbl, q_off)
            o8_ref = fp.flash_prefill_paged_plain(q, kp, vp, tbl, q_off, scale)
            torch.cuda.synchronize()
            tc = fp.tensor_core_path(dtype, d, page)
            check((fp.launches, fp.tc_launches) == (1, int(tc)),
                  f"page {page} {dname}: K8 launched {fp.launches} times, {fp.tc_launches} "
                  f"on the tensor cores")
            # bf16: both round a float32 result, one bf16 step of the output apart
            step = (torch.finfo(torch.bfloat16).eps * o8_ref.float().abs()
                    if dtype == torch.bfloat16 else 0.0)
            err8 = (o8.float() - o8_ref.float()).abs().max().item()
            check(bool(((o8.float() - o8_ref.float()).abs() <= step + tol).all()),
                  f"page {page} {dname}: K8 disagrees with its plain version by {err8}")
            visible = [o_ + C for o_ in offs]
            sched = make_chunk_schedule(visible, Hkv, page, sm_count,
                                        max_len=tbl.shape[1] * page)
            k_rows, v_rows = ops._pool_rows(kp, vp)
            args = (q.reshape(N * Hkv, g * C, d).contiguous(), k_rows, v_rows,
                    torch.tensor([v for v in visible for _ in range(Hkv)], dtype=torch.int32,
                                 device=dev),
                    torch.tensor([o_ for o_ in offs for _ in range(Hkv)], dtype=torch.int32,
                                 device=dev),
                    ops.paged_route(sched, tbl, Hkv), sched, scale, C)
            parts = lp.lean_prefill_chunk_partials(*args)
            parts_ref = lp.lean_prefill_partials_plain(*args)
            torch.cuda.synchronize()
            err4 = max((a - b).abs().max().item() for a, b in zip(parts, parts_ref))
            check(all(torch.allclose(a, b, atol=tol, rtol=tol) for a, b in zip(parts, parts_ref)),
                  f"page {page} {dname}: K4 disagrees with its plain version by {err4}")
            lens = [700, 1, 257]
            s_pad = -(-max(lens) // page) * page
            S = len(lens) * Hkv
            kd = torch.randn(S, s_pad, d, generator=gen, device=dev).to(dtype)
            vd = torch.randn(S, s_pad, d, generator=gen, device=dev).to(dtype)
            qd = torch.randn(S, g, d, generator=gen, device=dev).to(dtype)
            seg = torch.tensor([L for L in lens for _ in range(Hkv)], dtype=torch.int32,
                               device=dev)
            fargs = (qd, kd, vd, seg, fixed_split_factor(max(lens), S, page, sm_count), page,
                     scale)
            out6 = fd.flash_decode_partials(*fargs)
            ref6 = fd.flash_decode_partials_plain(*fargs)
            torch.cuda.synchronize()
            err6 = max((a - b).abs().max().item() for a, b in zip(out6, ref6))
            check(all(torch.allclose(a, b, atol=tol, rtol=tol) for a, b in zip(out6, ref6)),
                  f"page {page} {dname}: K6 disagrees with its plain version by {err6}")
            lines.append(f"page {page} d {d} {dname}: K8 ({'tensor' if tc else 'CUDA'} cores) "
                         f"{err8:.2e}, K4 (sub-tiles of {lp.row_sub_tile(d, page)}) {err4:.2e}, "
                         f"K6 {err6:.2e}")
    print("page-size phase (max |err| against the plain versions): " + "; ".join(lines),
          flush=True)


# ------------------------------------------------------ prefix-sharing serving
SYSTEM_TOKENS, WAVE1_TAIL, WAVE2_TAILS = 2048, 64, (700, 300, 129, 17)


def prefix_waves(vocab, seed=5):
    """Wave 1: the system prompt and a 64-token tail; wave 2: four requests
    that start with the system prompt, with tails of ``WAVE2_TAILS``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    system = rng.integers(0, vocab, SYSTEM_TOKENS).astype(np.int32)
    tail = lambda n: rng.integers(0, vocab, n).astype(np.int32)
    return [[np.concatenate([system, tail(WAVE1_TAIL)])],
            [np.concatenate([system, tail(n)]) for n in WAVE2_TAILS]]


def prefix_serving_run(torch, cfg, params, sm_count, new_tokens, waves, prefix, kv_dtype=None,
                       cascade=None, captured=True, backend="lean", cascade_fused=True,
                       fused=True, budget=SCHED_BUDGET, snap=False, fresh_scales=False,
                       attn_audit=None):
    """The waves, one after the other, through ``Scheduler`` on ``backend``
    (``lean``; ``fused`` False: the two-phase plans), with the radix prefix
    cache and cascade decode (``prefix``; ``cascade_fused`` False: the
    two-call cascade) or without (``cascade`` False: the prefix cache
    without cascade decode). Records each request's first-token logits
    (from the chunk step that completed its prompt) and its decode logits
    rows with their tokens, the decode ticks' wall times, whether each was a
    cascade tick, and each request's prefill chunks ``(offset, length)``.
    ``snap``: also a copy of the pages that hold each request's system
    prompt (every layer's K and V, with their scales on int8 pools), taken
    when its prompt completes. ``fresh_scales`` (int8, eager steps only):
    every page the pool hands out starts from scale 0, where the engine
    keeps the scale its last owner left (the quantizing write only grows a
    scale). ``attn_audit`` (a list; eager lean steps without cascade): each
    paged decode attention call of the engine is followed by the ``ref``
    step's oracle on the same pools, tables and lengths, and appends
    ``(decode ticks before it, per-slot largest |lean - oracle|, the lean
    segments' visible lengths, the model's)``; each chunk attention call
    likewise ``("chunk", chunk steps before it, per pack row largest gap
    over its valid rows, offsets, lengths)``."""
    from repro_torch.core.attention import (mha_chunk_prefill_paged_ref, mha_decode_ref,
                                            paged_gather_kv_dequant)
    from repro_torch.models.layers import dequant_pool
    from repro_torch.serving.config import CascadeConfig, EngineConfig, PagedConfig
    from repro_torch.serving.engine import DecodeEngine
    from repro_torch.serving.scheduler import Scheduler, SchedulerConfig

    class Recorder(DecodeEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.first_rows, self.rows, self.tick_s = {}, {}, []
            self.chunks, self.snaps = {}, {}

        def prefill_chunks_tick(self, work, pack_width, chunk_cap):
            toks = super().prefill_chunks_tick(work, pack_width, chunk_cap)
            for i, (slot, chunk, off) in enumerate(work):
                req = self.slot_req[slot]
                self.chunks.setdefault(req.uid, []).append((off, len(chunk)))
                if off + len(chunk) == len(req.prompt):
                    self.first_rows[req.uid] = self.last_prefill_logits[i].float()
                    if snap:
                        pages = torch.as_tensor(
                            self.page_tbl[slot, :SYSTEM_TOKENS // self.tile].astype("int64"),
                            device=self.device)
                        self.snaps[req.uid] = [{k: t[pages].clone() for k, t in lc.items()}
                                               for lc in self.cache]
            return toks

        def _attn_fn(self, sched, ptbl, seg, num_splits, backend, fused):
            fn = super()._attn_fn(sched, ptbl, seg, num_splits, backend, fused)
            if attn_audit is None or ptbl is None or backend != "lean":
                return fn
            n_kv = self.cfg.n_kv_heads

            def audited(q, k, v, c, k_scales=None, v_scales=None):
                out = fn(q, k, v, c, k_scales=k_scales, v_scales=v_scales)
                gather = lambda pool, sc: paged_gather_kv_dequant(pool, sc, ptbl,
                                                                  dtype=torch.bfloat16)
                ref = mha_decode_ref(q, gather(k, k_scales), gather(v, v_scales), ctx_lens=c)
                gap = (out.float() - ref.float()).abs().flatten(1).amax(1)
                attn_audit.append((self.stats.ticks, gap.cpu().tolist(),
                                   seg.view(-1, n_kv)[:, 0].cpu().tolist(), c.cpu().tolist()))
                return out

            return audited

        def _chunk_attn_fn(self, offs, lens, tbls, sched):
            fn = super()._chunk_attn_fn(offs, lens, tbls, sched)
            if attn_audit is None or self.attn_backend != "lean":
                return fn

            def audited(q, k, v, tb, o, k_scales=None, v_scales=None):
                out = fn(q, k, v, tb, o, k_scales=k_scales, v_scales=v_scales)
                kd = dequant_pool(k, k_scales) if k_scales is not None else k
                vd = dequant_pool(v, v_scales) if v_scales is not None else v
                ref = mha_chunk_prefill_paged_ref(q, kd, vd, tb, o)
                valid = torch.arange(q.shape[2], device=q.device)[None, :] < lens[:, None]
                gap = torch.where(valid[:, None, :, None], (out.float() - ref.float()).abs(), 0.0)
                attn_audit.append(("chunk", len(self.stats.tick_prefill_tokens),
                                   gap.flatten(1).amax(1).cpu().tolist(), offs.cpu().tolist(),
                                   lens.cpu().tolist()))
                return out

            return audited

        def decode_tick(self, exclude=None):
            casc = self.stats.cascade_ticks
            slots = {s: self.slot_req[s].uid for s in range(self.max_batch)
                     if self.slot_req[s] is not None and s not in (exclude or ())}
            t0 = time.perf_counter()
            out = super().decode_tick(exclude)
            torch.cuda.synchronize()
            if out:
                cascade = self.stats.cascade_ticks > casc
                self.tick_s.append((time.perf_counter() - t0, cascade))
                for s, uid in slots.items():
                    if uid in out:
                        self.rows.setdefault(uid, []).append(
                            (self.last_logits[s].float(), out[uid], cascade))
            return out

    eng = Recorder(cfg, params, EngineConfig(
        max_batch=4, cache_len=4096, attn_backend=backend, num_workers=sm_count, fused=fused,
        paged=PagedConfig(enabled=True, page_size=128, prefix_cache=prefix, kv_dtype=kv_dtype),
        cascade=CascadeConfig(enabled=prefix if cascade is None else cascade,
                              fused=cascade_fused, stable_ticks=2)),
        device="cuda")
    eng.capture_decode = captured
    if fresh_scales:
        alloc = eng.pool.alloc

        def fresh_alloc(seq, n=1):
            pages = alloc(seq, n)
            if pages:
                idx = torch.as_tensor(pages, device=eng.device)
                for lc in eng.cache:
                    for name in ("k_scale", "v_scale"):
                        lc[name][idx] = 0.0
            return pages

        eng.pool.alloc = fresh_alloc
    sch = Scheduler(eng, SchedulerConfig(chunk_size=SCHED_CHUNK, prefill_pack=SCHED_PACK,
                                         token_budget=budget, chunked=True))
    reset_launch_counts()
    t0 = time.perf_counter()
    handles, uid = [], 0
    for wave in waves:
        hs = [sch.submit(p, new_tokens, uid=uid + i) for i, p in enumerate(wave)]
        uid += len(wave)
        sch.run_to_completion(max_steps=400)
        check(all(h.done and len(h.generated) == new_tokens for h in hs),
              f"prefix serving (prefix cache {prefix}): a request did not finish")
        handles += hs
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    eng.pool.check(scales=eng._kv_scale_arrays())
    if eng.prefix_cache is not None:
        eng.prefix_cache.check()
        check(eng.pool.num_allocated == eng.prefix_cache.cached_pages,
              "prefix serving: pages held beyond the radix cache's after the drain")
    else:
        check(eng.pool.num_allocated == 0, "prefix serving: pages leaked")
    return {"eng": eng, "sch": sch, "handles": handles, "counts": counts, "wall": wall}


def prefix_logit_gaps(torch, on, off, atol_frac):
    """Each request's logits rows in run ``on`` against run ``off`` on the
    same waves: its first-token row, then, if both runs took the same first
    token (each handle's first generated token), its decode rows up to the
    first one whose tokens differ (later rows follow different tokens; after
    a first-token flip every decode row does). Per row: ``uid``, ``row`` (0
    the first token, then decode rows), ``cascade`` (a cascade tick's row),
    ``finite``, ``delta`` (max |on - off|), ``atol`` (``atol_frac`` x the
    median |off logit|) and ``ok`` (within ``atol`` + ``LOGIT_RTOL``
    |off|)."""
    gaps = []
    first = {h.uid: h.generated[0] for h in off["handles"]}
    for h in on["handles"]:
        pairs = [(on["eng"].first_rows[h.uid], off["eng"].first_rows[h.uid], False)]
        rows = zip(on["eng"].rows.get(h.uid, []), off["eng"].rows.get(h.uid, []))
        for (a, ta, cascade), (b, tb, _) in rows if h.generated[0] == first[h.uid] else ():
            pairs.append((a, b, cascade))
            if ta != tb:
                break
        for row, (a, b, cascade) in enumerate(pairs):
            atol = atol_frac * b.abs().median().item()
            gaps.append({"uid": h.uid, "row": row, "cascade": cascade,
                         "finite": bool(torch.isfinite(a).all()),
                         "delta": (a - b).abs().max().item(), "atol": atol,
                         "ok": bool(torch.allclose(a, b, rtol=LOGIT_RTOL, atol=atol))})
    return gaps


def prefix_serving_phase(torch, cfg, params, sm_count, new_tokens, kv_dtype=None):
    """Prefix-sharing serving at full width, against the same waves with the
    prefix cache off: tokens matched, prefill skipped, peak pages, cascade
    ticks, launches (fused K4 per chunk step, K5 per cascade tick, K2 per other
    tick, one per layer), TTFT, tick p50; first-token logits and decode
    logits up to the first differing token (cascade ticks among them)
    within the engine phase's logit tolerance (``INT8_LOGIT_ATOL_FRAC`` on
    int8 pools). Returns the launch counts."""
    waves = prefix_waves(cfg.vocab_size)
    atol_frac = INT8_LOGIT_ATOL_FRAC if kv_dtype == "int8" else LOGIT_ATOL_FRAC
    off = prefix_serving_run(torch, cfg, params, sm_count, new_tokens, waves, prefix=False,
                             kv_dtype=kv_dtype)
    on = prefix_serving_run(torch, cfg, params, sm_count, new_tokens, waves, prefix=True,
                            kv_dtype=kv_dtype)
    eng, st, c = on["eng"], on["eng"].stats, on["counts"]
    L = cfg.n_layers
    chunk_steps = len(st.tick_prefill_tokens)
    check(st.cascade_fused_ticks > 0, "prefix serving: no cascade tick ran K5")
    check(c["K5"] == L * st.cascade_fused_ticks,
          f"prefix serving: K5 launched {c['K5']} times, expected {L} x "
          f"{st.cascade_fused_ticks} cascade ticks")
    check(c["K2"] == L * (st.ticks - st.cascade_ticks),
          f"prefix serving: K2 launched {c['K2']} times, expected {L} x "
          f"{st.ticks - st.cascade_ticks} non-cascade ticks")
    check(c["K4f"] == L * chunk_steps, f"prefix serving: fused K4 launched {c['K4f']} times, "
          f"expected {L} x {chunk_steps} chunk steps")
    path_counts("prefix serving")
    others = {k: n for k, n in c.items() if k not in ("K2", "K4f", "K5") and n}
    check(not others, f"prefix serving: other kernels ran: {others}")
    skipped = off["eng"].stats.prefill_tokens - st.prefill_tokens
    check(skipped > 0 and st.prefix_matched_tokens > 0, "prefix serving: nothing was shared")
    # logits against the unshared run on the same waves
    worst, compared, casc_rows, agree = (0.0, 0.0, -1), 0, 0, 0
    for gap in prefix_logit_gaps(torch, on, off, atol_frac):
        check(gap["finite"], "prefix serving: logits not finite")
        check(gap["ok"], f"prefix serving: request {gap['uid']}'s logits differ from the "
              f"unshared run by up to {gap['delta']} (allowed {gap['atol']} + {LOGIT_RTOL} |ref|)")
        worst = max(worst, (gap["delta"], gap["atol"], gap["uid"]))
        compared += 1
        casc_rows += int(gap["cascade"])
    agree = sum(h.generated == off["handles"][h.uid].generated for h in on["handles"])
    check(casc_rows > 0, "prefix serving: no cascade-tick logits were compared")
    peak = [r["eng"].pool.stats.high_water for r in (off, on)]
    ttft = [(h.first_token_time - h.arrival_time) * 1e3 for h in on["handles"]]
    ttft_off = [(h.first_token_time - h.arrival_time) * 1e3 for h in off["handles"]]
    p50 = {k: statistics.median(dt for dt, _ in r["eng"].tick_s[1:]) * 1e3
           for k, r in (("on", on), ("off", off))}
    casc_p50 = statistics.median([dt for dt, cs in eng.tick_s if cs] or [0.0]) * 1e3
    print(f"prefix serving phase{' (int8 pools)' if kv_dtype else ''}: {cfg.name} full width, "
          f"{SYSTEM_TOKENS}-token system prompt "
          f"+ {WAVE1_TAIL} served first, then 4 requests with tails {list(WAVE2_TAILS)}, "
          f"{new_tokens} new tokens each; chunk {SCHED_CHUNK}, pack {SCHED_PACK}, budget "
          f"{SCHED_BUDGET}, lean, prefix cache + cascade (stable_ticks 2)", flush=True)
    print(f"  prefix_matched_tokens {st.prefix_matched_tokens} over {st.prefix_attach_count} "
          f"attaches; prefill tokens {st.prefill_tokens} against {off['eng'].stats.prefill_tokens} "
          f"unshared ({skipped} skipped); peak pages in use {peak[1]} against {peak[0]} "
          f"unshared; cascade_ticks {st.cascade_ticks}, cascade_fused_ticks "
          f"{st.cascade_fused_ticks} of {st.ticks} decode ticks (stability skips "
          f"{st.cascade_stability_skips}); cow_copies {st.cow_copies}", flush=True)
    print(f"  launches fused K4 {c['K4f']} = {L} x {chunk_steps}, K5 {c['K5']} = {L} x "
          f"{st.cascade_fused_ticks}, K2 {c['K2']} = {L} x {st.ticks - st.cascade_ticks}; "
          f"steps {on['sch'].stats.steps} against {off['sch'].stats.steps}; wall "
          f"{on['wall']:.2f} s against {off['wall']:.2f} s", flush=True)
    print("  TTFT ms per request (wave 1, then tails " + str(list(WAVE2_TAILS)) + "): "
          + ", ".join(f"{t:.1f}" for t in ttft) + "; unshared: "
          + ", ".join(f"{t:.1f}" for t in ttft_off)
          + f"; decode tick p50 {p50['on']:.2f} ms (cascade ticks {casc_p50:.2f} ms) against "
          f"{p50['off']:.2f} ms unshared", flush=True)
    print(f"  logits against the unshared run: {compared} rows ({casc_rows} cascade-tick rows), "
          f"worst gap {worst[0]:.4f} (request {worst[2]}, allowed {worst[1]:.4f} + "
          f"{LOGIT_RTOL} |ref|); streams equal for {agree}/{len(on['handles'])} requests; pool "
          f"and radix cache clean", flush=True)
    return on["counts"]


def page_diffs(torch, a, b):
    """Two copies of the same request's system-prompt pages (``snaps`` of
    :func:`prefix_serving_run`), layer by layer: pages whose K or V rows
    differ, elements that differ, the largest |difference| (int8 steps on
    int8 pools), scales that differ and their largest relative difference,
    and the first layer where anything differs."""
    out = {"pages": 0, "elems": 0, "max_step": 0.0, "scales": 0, "max_scale_rel": 0.0,
           "first_layer": None}
    for layer, (la, lb) in enumerate(zip(a, b)):
        for name in ("k", "v"):
            diff = (la[name].float() - lb[name].float()).abs()
            per_page = diff.flatten(1).amax(1)
            out["pages"] += int((per_page > 0).sum())
            out["elems"] += int((diff > 0).sum())
            out["max_step"] = max(out["max_step"], diff.max().item())
            if name + "_scale" in la:
                sa, sb = la[name + "_scale"], lb[name + "_scale"]
                out["scales"] += int((sa != sb).sum())
                rel = ((sa - sb).abs() / sb.abs().clamp(min=1e-30)).max().item()
                out["max_scale_rel"] = max(out["max_scale_rel"], rel)
            if out["first_layer"] is None and (out["elems"] or out["scales"]):
                out["first_layer"] = layer
    return out


class KernelAudit:
    """Within the ``with`` block, every lean kernel the engine's plans call
    through ``repro_torch.kernels.ops`` (K1, K2, K5, K4's partials, the
    fused K4) is followed by its plain version on the same inputs. Keeps
    per kernel the call count and the largest |kernel - plain| (float32
    outputs; the fused K4's in q's dtype, against its plain one's), with the
    worst call's index and its four worst rows. Eager steps only: a
    captured step would replay the kernels without the comparison."""

    NAMES = {"lean_decode_fused": "lean_decode_fused_plain",
             "lean_decode_partials": "lean_decode_partials_plain",
             "lean_cascade_fused": "lean_cascade_fused_plain",
             "lean_prefill_chunk_partials": "lean_prefill_partials_plain",
             "lean_prefill_fused": "lean_prefill_fused_plain"}

    def __init__(self, torch):
        self.torch = torch
        self.calls, self.worst = {}, {}

    def _wrap(self, name, kernel, plain):
        torch = self.torch
        from repro_torch.kernels import lean_decode as ld

        def audited(*args, **kw):
            out = kernel(*args, **kw)
            pkw = dict(kw)
            if kw.get("k_scales") is not None:
                k_rows = args[2] if name == "lean_cascade_fused" else args[1]
                pkw["k_scales"], pkw["v_scales"] = ld.scale_rows(k_rows, kw["k_scales"],
                                                                 kw["v_scales"])
            ref = plain(*args, **pkw)
            outs = out if isinstance(out, tuple) else (out,)
            refs = ref if isinstance(ref, tuple) else (ref,)
            err, rows = 0.0, None
            for a, b in zip(outs, refs):
                a, b = a.float(), b.float()
                d = torch.where(a == b, torch.zeros_like(a), (a - b).abs())
                d = torch.nan_to_num(d, nan=float("inf"))
                e = d.max().item() if d.numel() else 0.0
                if e > err:
                    err, rows = e, d.flatten(1).amax(1) if d.dim() > 1 else d
            n = self.calls.get(name, 0)
            self.calls[name] = n + 1
            if err > self.worst.get(name, (-1.0,))[0]:
                top = (rows.topk(min(4, rows.numel())) if rows is not None else None)
                self.worst[name] = (err, n, None if top is None else
                                    [(int(i), float(v)) for v, i in zip(*top)])
            return out

        return audited

    def __enter__(self):
        from repro_torch.kernels import lean_decode as ld
        from repro_torch.kernels import lean_prefill as lp
        from repro_torch.kernels import ops

        self._orig = {}
        for name, plain in self.NAMES.items():
            self._orig[name] = getattr(ops, name)
            mod = lp if "prefill" in name else ld
            setattr(ops, name, self._wrap(name, self._orig[name], getattr(mod, plain)))
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        for name, fn in self._orig.items():
            setattr(ops, name, fn)
        return False


def prefix_fault_phase(torch, sm_count, smi, depth):
    """The int8 prefix-serving comparison of ``prefix_serving_phase`` on
    Mistral-NeMo-12B at ``depth`` layers, split three ways: the backend
    (the same waves on ``ref``, the plain step, against ``ref`` unshared),
    the kernels (K5-int8 against the two-call cascade, no cascade, the
    two-phase plans in place of the fused K4-int8 and K2-int8), and the
    pages (each request's system-prompt pages, int8 bytes and scales,
    against the unshared run's, against an unshared run whose token budget
    never shrinks a chunk, so that every system-prompt page is written
    whole, as the shared run's are, and against an unshared run whose pages
    start from scale 0 when the pool hands them out, as the shared run's
    system-prompt pages do: those were fresh when wave 1 wrote them, while
    the unshared run's wave 2 gets the pages wave 1 freed, scales and all).
    Checks nothing; prints a line per comparison and the whole as one JSON
    line."""
    import gc
    import types

    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = arch_config(get_config("mistral-nemo-12b"), depth)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = init_params(cfg, gen, device="cuda", dtype=torch.bfloat16)
    waves = prefix_waves(cfg.vocab_size)
    aligned = SCHED_BUDGET + 4              # budget - decode batch always fits two chunks
    variants = {
        "lean": dict(prefix=True, kv_dtype="int8"),
        "lean unshared": dict(prefix=False, kv_dtype="int8"),
        "lean unshared whole pages": dict(prefix=False, kv_dtype="int8", budget=aligned),
        "two-call cascade": dict(prefix=True, kv_dtype="int8", cascade_fused=False),
        "no cascade": dict(prefix=True, kv_dtype="int8", cascade=False),
        "two-phase": dict(prefix=True, kv_dtype="int8", fused=False, cascade_fused=False),
        "two-phase unshared": dict(prefix=False, kv_dtype="int8", fused=False),
        "lean unshared fresh scales": dict(prefix=False, kv_dtype="int8", fresh_scales=True,
                                           captured=False),
        "ref": dict(prefix=True, kv_dtype="int8", backend="ref", cascade=False),
        "ref unshared fresh scales": dict(prefix=False, kv_dtype="int8", backend="ref",
                                          fresh_scales=True, captured=False),
        "ref unshared": dict(prefix=False, kv_dtype="int8", backend="ref"),
        "ref unshared whole pages": dict(prefix=False, kv_dtype="int8", backend="ref",
                                         budget=aligned),
        "bf16": dict(prefix=True),
        "bf16 unshared": dict(prefix=False),
        "lean eager audited": dict(prefix=True, kv_dtype="int8", captured=False),
        "no cascade eager, attention audited": dict(prefix=True, kv_dtype="int8", cascade=False,
                                                    captured=False, attn_audit=[]),
    }
    runs = {}
    for name, kw in variants.items():
        t0 = time.perf_counter()
        audit = KernelAudit(torch) if name == "lean eager audited" else contextlib.nullcontext()
        with audit:
            r = prefix_serving_run(torch, cfg, params, sm_count, 16, waves, snap=True, **kw)
        e = r["eng"]
        runs[name] = {"handles": r["handles"], "eng": types.SimpleNamespace(
            first_rows=e.first_rows, rows=e.rows, snaps=e.snaps, chunks=e.chunks,
            cascade_ticks=e.stats.cascade_ticks, matched=e.stats.prefix_matched_tokens)}
        del r, e
        gc.collect()
        torch.cuda.empty_cache()
        print(f"  [{time.perf_counter() - t0:.1f} s] {name}: cascade ticks "
              f"{runs[name]['eng'].cascade_ticks}, prefix tokens matched "
              f"{runs[name]['eng'].matched}", flush=True)
        if kw.get("attn_audit") is not None:
            out = {}
            for kind in ("decode", "chunk"):
                calls = [r for r in kw["attn_audit"] if (r[0] == "chunk") == (kind == "chunk")]
                gaps = lambda r: r[2] if kind == "chunk" else r[1]
                worst = max(calls, key=lambda r: max(gaps(r)), default=None)
                bad = [r for r in calls if max(gaps(r)) > 0.25]
                out[kind] = {"calls": len(calls), "worst": worst, "over_0.25": len(bad),
                             "first_over": bad[:3]}
                print(f"  {kind} attention against the ref oracle in {name}: {len(calls)} "
                      f"calls; worst {worst}; calls with a gap over 0.25: {len(bad)}, the "
                      f"first: {bad[:3]}", flush=True)
            runs[name]["attn_audit"] = out
        if isinstance(audit, KernelAudit):
            runs[name]["audit"] = {k: (audit.calls[k], *w) for k, w in audit.worst.items()}
            print(f"  kernels against their plain versions in {name} (calls, largest "
                  f"|kernel - plain|, its call, its four worst rows): "
                  + "; ".join(f"{k}: {v}" for k, v in runs[name]["audit"].items()), flush=True)
    result = {"card": smi, "model": f"{cfg.name} at {cfg.n_layers} layers", "gaps": {},
              "pages": {}, "chunks": {}, "audit": runs["lean eager audited"]["audit"],
              "attn_audit": runs["no cascade eager, attention audited"]["attn_audit"]}
    pairs = [("lean", "lean unshared"), ("lean", "lean unshared whole pages"),
             ("lean unshared whole pages", "lean unshared"),
             ("lean", "lean unshared fresh scales"), ("ref", "ref unshared fresh scales"),
             ("two-call cascade", "lean unshared"), ("no cascade", "lean unshared"),
             ("two-phase", "two-phase unshared"), ("ref", "ref unshared"),
             ("ref", "ref unshared whole pages"), ("lean unshared", "ref unshared"),
             ("lean", "ref"), ("bf16", "bf16 unshared"), ("lean eager audited", "lean"),
             ("lean eager audited", "lean unshared"),
             ("no cascade eager, attention audited", "no cascade")]
    for a, b in pairs:
        frac = LOGIT_ATOL_FRAC if a.startswith("bf16") else INT8_LOGIT_ATOL_FRAC
        gaps = prefix_logit_gaps(torch, runs[a], runs[b], frac)
        per_uid = {}
        for g in gaps:
            w = per_uid.get(g["uid"])
            if w is None or g["delta"] > w["delta"]:
                per_uid[g["uid"]] = g
        agree = sum(h.generated == runs[b]["handles"][h.uid].generated
                    for h in runs[a]["handles"])
        # each request's first token in both runs, and the top-2 margin of
        # the first-token row it was picked from in each
        firsts = {}
        for h in runs[a]["handles"]:
            hb = runs[b]["handles"][h.uid]
            margin = lambda r: float((lambda t: t[0] - t[1])(r.float().topk(2).values))
            firsts[h.uid] = (h.generated[0], hb.generated[0],
                             margin(runs[a]["eng"].first_rows[h.uid]),
                             margin(runs[b]["eng"].first_rows[h.uid]))
        result["gaps"][f"{a} vs {b}"] = {
            "rows": len(gaps), "failed": sum(not g["ok"] for g in gaps),
            "streams_equal": agree, "first_tokens": firsts, "worst": {u: (g["delta"], g["atol"], g["row"], g["cascade"])
                                              for u, g in sorted(per_uid.items())}}
        print(f"  logits {a} vs {b}: {len(gaps)} rows, {sum(not g['ok'] for g in gaps)} out "
              f"of tolerance; worst per request (gap, allowed atol, row, cascade): "
              + "; ".join(f"{u}: {g['delta']:.4f} / {g['atol']:.4f} row {g['row']}"
                          f"{' cascade' if g['cascade'] else ''}" for u, g in
                          sorted(per_uid.items())) + f"; streams equal {agree}; first tokens "
              f"and their rows' top-2 margins (a, b): " + "; ".join(
                  f"{u}: {t[0]}/{t[1]} {t[2]:.4f}/{t[3]:.4f}" for u, t in sorted(firsts.items())),
              flush=True)
    for a, b in [("lean", "lean unshared"), ("lean", "lean unshared whole pages"),
                 ("lean", "lean unshared fresh scales"), ("ref", "ref unshared fresh scales"),
                 ("ref", "ref unshared"), ("ref", "ref unshared whole pages"),
                 ("lean unshared", "ref unshared"), ("bf16", "bf16 unshared")]:
        per_uid = {}
        for h in runs[a]["handles"]:
            per_uid[h.uid] = page_diffs(torch, runs[a]["eng"].snaps[h.uid],
                                        runs[b]["eng"].snaps[h.uid])
        result["pages"][f"{a} vs {b}"] = per_uid
        print(f"  system-prompt pages {a} vs {b}: " + "; ".join(
            f"{u}: pages differing (layers x K/V) {d['pages']}, elements "
            f"{d['elems']}, max step {d['max_step']:g}, scales {d['scales']} (max rel "
            f"{d['max_scale_rel']:.3g}), first layer {d['first_layer']}"
            for u, d in per_uid.items()), flush=True)
    for name in ("lean", "lean unshared", "lean unshared whole pages"):
        chunks = runs[name]["eng"].chunks
        result["chunks"][name] = {u: c for u, c in sorted(chunks.items())}
        split = {u: sum((o % 128 != 0 or (o + n) % 128 != 0) and o < SYSTEM_TOKENS
                        for o, n in c) for u, c in sorted(chunks.items())}
        print(f"  {name}: chunks per request (offset, length): " + "; ".join(
            f"{u}: {c}" for u, c in sorted(chunks.items())) + f"; chunks inside the system "
            f"prompt that split a page: {split}", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", f"prefix_fault_{depth}.json"), "w") as f:
        json.dump(result, f, indent=1, default=str)
    print(json.dumps({"prefix_fault": result["gaps"]}, default=str), flush=True)
    return result


# ------------------------------------------------------------ int8 engine
def int8_engine_phase(torch, cfg, params, sm_count, new_tokens, bf16):
    """The engine phase's requests on int8 page pools (``kv_dtype="int8"``):
    K7 admissions, whole pages quantized, K2-int8 decode. Checks the
    launches (K7 = layers x admissions, K2 = layers x steps, K1 none), the
    pool with its scales and drained; reports tick p50, tokens/s, traced
    ticks, page bytes against bf16's, and the logit gap and greedy agreement
    with the bf16 engine (``bf16``: its streams and logits rows), which are
    not bounded. Then one ``fused=False`` engine (K1-int8 + merge) for a few
    ticks, and the first tick of an int8 ``ref`` engine against the int8
    lean one within ``LOGIT_RTOL`` / ``LOGIT_ATOL_FRAC``. Returns the launch
    counts, K1-int8's launches and the blocking first tokens."""
    from repro_torch.serving.engine import DecodeEngine, Request
    from repro_torch.serving.kvpool import KVLayout

    L = cfg.n_layers
    eng = DecodeEngine(cfg, params, engine_config("lean", sm_count, kv_dtype="int8"),
                       device="cuda")
    lay = eng.pool.layout
    bf_bytes = KVLayout(kv_dtype="bf16", n_kv_heads=lay.n_kv_heads, head_dim=lay.head_dim,
                        page_size=lay.page_size, n_attn_layers=lay.n_attn_layers).page_bytes
    check(eng.quant and lay.quantized, "int8 engine: pools are not quantized")
    reqs = make_requests(Request, cfg.vocab_size, new_tokens)
    reset_launch_counts()
    first_s, ticks, rows = drive(torch, eng, reqs)
    counts = launch_counts()
    check(counts["K7"] == L * eng.stats.prefills == L * len(reqs),
          f"int8 engine: K7 launched {counts['K7']} times, expected {L} x {len(reqs)} admissions")
    check(counts["K2"] == L * eng.stats.ticks and eng.stats.ticks > 0,
          f"int8 engine: K2 launched {counts['K2']} times, expected {L} x {eng.stats.ticks}")
    others = {k: n for k, n in counts.items() if k not in ("K2", "K7") and n}
    check(not others, f"int8 engine: other kernels ran (K1 among them?): {others}")
    path_counts("int8 engine")
    check(all(len(r.generated) == new_tokens for r in reqs), "int8 engine: a request did not finish")
    check(eng.stats.decode_replays > 0, "int8 engine: no decode tick replayed a captured step")
    check(bool(torch.isfinite(rows[0]).all()), "int8 engine: logits not finite")
    eng.pool.check(scales=eng._kv_scale_arrays())
    check(eng.pool.num_allocated == 0, f"int8 engine: {eng.pool.num_allocated} pages leaked")
    p50 = statistics.median(dt for dt, _ in ticks)
    tok_s = sum(n for _, n in ticks) / sum(dt for dt, _ in ticks)
    streams = [list(r.generated) for r in reqs]
    gap = (rows[0] - bf16["rows"][0]).abs().max().item()
    agree = sum(a == b for s1, s2 in zip(streams, bf16["streams"]) for a, b in zip(s1, s2))
    print(f"int8 engine phase: {cfg.name} full width, int8 pages ({lay.page_bytes} B a page "
          f"across the layers against bf16's {bf_bytes} B: {bf_bytes / lay.page_bytes:.4f}x the "
          f"pages per GB), {len(reqs)} requests (prompts {list(PROMPT_LENS)}, {new_tokens} new "
          f"tokens): admission + first decode tick {first_s * 1e3:.1f} ms; decode tick p50 "
          f"{p50 * 1e3:.2f} ms over {len(ticks)} ticks, {tok_s:.1f} tokens/s; launches K2 "
          f"{counts['K2']} = {L} x {eng.stats.ticks} (all on the decode ring), K7 "
          f"{counts['K7']} = {L} x {len(reqs)}, K1 0; "
          f"pool clean with its scales; against the bf16 engine (not bounded): first decode "
          f"tick's max |logit gap| {gap:.4f}, greedy tokens agreeing {agree}/{len(reqs) * new_tokens}",
          flush=True)
    traced_ticks(torch, eng, make_requests(Request, cfg.vocab_size, TRACED_TICKS + 6), p50,
                 label="int8 traced ticks")
    lean_first = rows[0]
    blocking = {"prompts": [r.prompt.copy() for r in reqs], "first": [s[0] for s in streams],
                "rows": bf16["prefill_rows"]}
    del eng

    eng = DecodeEngine(cfg, params, engine_config("lean", sm_count, fused=False, kv_dtype="int8"),
                       device="cuda")
    reset_launch_counts()
    drive(torch, eng, make_requests(Request, cfg.vocab_size, 4))
    two = launch_counts()
    check(two["K1"] == L * eng.stats.ticks and two["K1"] > 0 and two["K2"] == 0,
          f"int8 two-phase: launches {two}, expected K1 {L} x {eng.stats.ticks} and no K2")
    path_counts("int8 two-phase")
    check(bool(torch.isfinite(eng.last_logits).all()), "int8 two-phase logits are not finite")
    eng.pool.check(scales=eng._kv_scale_arrays())
    k1_launches = two["K1"]
    del eng

    eng = DecodeEngine(cfg, params, engine_config("ref", sm_count, kv_dtype="int8"),
                       device="cuda")
    for r in make_requests(Request, cfg.vocab_size, new_tokens):
        eng.submit(r)
    eng.tick()
    ref = eng.last_logits
    atol = LOGIT_ATOL_FRAC * ref.abs().median().item()
    diff = (ref - lean_first).abs().max().item()
    check(torch.allclose(lean_first, ref, rtol=LOGIT_RTOL, atol=atol),
          f"int8 lean and ref logits differ by up to {diff} (allowed {atol} + {LOGIT_RTOL} |ref|)")
    print(f"int8 two-phase: {two['K1']} K1-int8 launches = {L} x {two['K1'] // L} ticks, logits "
          f"finite, pool clean; int8 ref cross-check: first tick max |logit lean - ref| "
          f"{diff:.4f} (allowed {atol:.4f} + {LOGIT_RTOL} |ref|)", flush=True)
    del eng
    torch.cuda.empty_cache()
    return counts, k1_launches, blocking

# ------------------------------------------------------------ f8 pages
F8_REPLACES = {
    # the reference widens an f8 pool before the kernel that reads it
    # (repro/models/layers.py:192-196, :279-287, :379-385): each f8 form
    # replaces that kernel, reading the e4m3 pool as it is
    "lean_decode_fused_f8": ("lean_decode.cu", "src/repro/kernels/lean_decode.py:302"),
    "lean_decode_partials_f8": ("lean_decode.cu", "src/repro/kernels/lean_decode.py:117"),
    "lean_prefill_fused_f8": ("lean_prefill_tc.cu", "src/repro/kernels/lean_prefill.py:51"),
    "flash_decode_partials_f8": ("flash_decode.cu", "src/repro/kernels/flash_decode.py:25"),
    "flash_prefill_paged_f8": ("flash_prefill.cu", "src/repro/kernels/flash_prefill.py:162"),
    "lean_cascade_fused_f8": ("lean_cascade.cu", "src/repro/kernels/lean_decode.py:604"),
}
F8_LIBRARY = "SDPA on the K/V widened to bf16"   # no one call reads e4m3 K/V
# The f8 Scheduler's first-token logits against blocking prefill (which
# reads the prompt's bf16 K/V; the chunk steps read earlier chunks' K/V
# from e4m3 pages): e4m3 rounds an element to within 2^-4 of its own size,
# so an element near its page's largest is off by about four times an int8
# page's half step (amax / 254). The allowance doubles int8's; a wrong
# attention output still moves logits by 2.5x it.
F8_LOGIT_ATOL_FRAC = 2 * INT8_LOGIT_ATOL_FRAC


def f8_pair(torch, *ts):
    """e4m3 copies of bf16 tensors through the reference's cast, and the
    same copies widened back to bf16 (exact): an f8 form's operands and
    its bf16 form's."""
    from repro_torch.core.attention import F8, to_kv

    f8 = [to_kv(t, F8) for t in ts]
    return f8, [t.to(torch.bfloat16) for t in f8]


def same_bits(torch, a, b) -> bool:
    """Equal bit for bit, NaN where NaN (a NaN's payload aside)."""
    nan = torch.isnan(a)
    if a.dtype != b.dtype or not torch.equal(nan, torch.isnan(b)):
        return False
    bits = torch.int32 if a.element_size() == 4 else torch.int16
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    return torch.equal(torch.where(nan, zero, a).view(bits), torch.where(nan, zero, b).view(bits))


def f8_kernel_phase(torch, sm_count: int, dev_name: str):
    """The six f8 forms (bf16 queries, e4m3 K/V rows, no scales) at the bf16
    kernel phases' shapes -- K2-f8 and K1-f8 on the decode batch, K6-f8 on
    the first ``DECODE_SHAPES``, the fused K4-f8 and K8-f8 on the two-chunk
    pack, K5-f8 on the 2048-token shared prefix -- each against its bf16
    form on the K/V widened to bf16, bit for bit (e4m3 -> bf16 is exact,
    and the kernels widen each element in registers or in shared memory),
    and against its plain version (2e-5; the bf16-output ones one bf16
    step plus 2e-5). Then the cast on the card against the CPU's codes, and
    the guards' NaN contract on an f8 page (K2-f8 and the fused K4-f8 with one
    NaN element give what the bf16 kernels give on the same element). Times
    with L2 evicted, the plain versions', the bf16 form's on the widened
    K/V, the bound on the halved bytes, and SDPA on the widened K/V."""
    from repro_torch.core.attention import F8, paged_gather_kv, to_kv
    from repro_torch.core.leantile import fixed_split_factor, make_chunk_schedule, make_schedule
    from repro_torch.kernels import decode_ring as dr
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import lean_decode as ld
    from repro_torch.kernels import lean_prefill as lp
    from repro_torch.kernels import ops

    bf, u8 = torch.bfloat16, torch.uint8
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    results = {}
    Hq, Hkv, d, tile = 32, 8, 128, 128
    g = Hq // Hkv
    scale = 1.0 / math.sqrt(d)

    def record(name, ms, bf_ms, plain_ms, lib_ms, nbytes, flops, err):
        b_ms, b_by = bound(dev_name, "bfloat16", nbytes, flops)
        results[(name, "bfloat16")] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                                       "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err}
        print(f"  {name}: bit for bit with its bf16 form on the widened K/V; max|err| vs plain "
              f"{err:.3e}; {ms:.4f} ms (bf16 form {bf_ms:.4f} ms; bound {b_ms:.4f} ms by {b_by}, "
              f"{nbytes / 1e6:.1f} MB; plain {plain_ms:.3f} ms; {F8_LIBRARY} {lib_ms:.4f} ms)",
              flush=True)

    # the cast on the card: every bf16 bit pattern, and float32 N(0, 1) at
    # four scales, against the CPU's codes (JAX's: NaN above 464)
    cpu_gen = torch.Generator().manual_seed(0)
    pats = torch.arange(-2**15, 2**15, dtype=torch.int32).to(torch.int16).view(bf)
    f32 = torch.cat([torch.randn(200_000, generator=cpu_gen) * s for s in (1e-3, 1.0, 30.0, 300.0)])
    for x in (pats, f32):
        cpu = to_kv(x, F8).view(u8)
        check(torch.equal(cpu, to_kv(x.to(dev), F8).view(u8).cpu()),
              f"the f8 cast gives other codes on the card than on the CPU ({x.dtype})")
    print(f"f8 kernel phase: the cast on the card equals the CPU's on all 65536 bf16 bit "
          f"patterns and {f32.numel()} float32 values "
          f"({int((to_kv(f32, F8).view(u8) & 0x7F == 0x7F).sum())} of them NaN: |x| > 464)",
          flush=True)

    # K2-f8 and K1-f8 on the decode batch
    lens, width = [4000, 1500, 700, 1], 32
    B = len(lens)
    sched = make_schedule(lens, Hkv, tile, sm_count)
    q, k_pool, v_pool, tbl, _, _ = make_kv_problem(torch, lens, Hq, Hkv, d, tile, width, bf,
                                                   gen, dev)
    (kf, vf), (kw, vw) = f8_pair(torch, k_pool, v_pool)
    seg_ctx = torch.tensor([L for L in lens for _ in range(Hkv)], dtype=torch.int32, device=dev)
    q_seg = q.reshape(B * Hkv, g, d).contiguous()
    route = ops.paged_route(sched, tbl, Hkv)
    args = (q_seg, *ops._pool_rows(kf, vf), seg_ctx, route, sched, scale)
    wargs = (q_seg, *ops._pool_rows(kw, vw), seg_ctx, route, sched, scale)
    print(f"  decode batch lens {lens}, Hq {Hq} Hkv {Hkv} d {d} page {tile}, workers "
          f"{sm_count}", flush=True)
    ring_before = (ld.fused_ring_launches, ld.partials_ring_launches)
    o, lse = ld.lean_decode_fused(*args)
    parts = ld.lean_decode_partials(*args)
    torch.cuda.synchronize()
    check((ld.fused_ring_launches, ld.partials_ring_launches)
          == (ring_before[0] + 1, ring_before[1] + 1),
          "K2-f8 or K1-f8 did not run on the decode ring")
    print("  " + ring_line("K1/K2-f8", 1, d, tile, g), flush=True)
    ow, lsew = ld.lean_decode_fused(*wargs)
    partsw = ld.lean_decode_partials(*wargs)
    check(same_bits(torch, o, ow) and same_bits(torch, lse, lsew),
          "K2-f8 differs from K2 on the widened K/V")
    check(all(same_bits(torch, a, b) for a, b in zip(parts, partsw)),
          "K1-f8 differs from K1 on the widened K/V")
    o_ref, lse_ref = ld.lean_decode_fused_plain(*args)
    parts_ref = ld.lean_decode_partials_plain(*args)
    err_k2 = max((o - o_ref).abs().max().item(), (lse - lse_ref).abs().max().item())
    err_k1 = max((a - b).abs().max().item() for a, b in zip(parts, parts_ref))
    check(torch.allclose(o, o_ref, atol=BF16_TOL, rtol=BF16_TOL)
          and torch.allclose(lse, lse_ref, atol=BF16_TOL, rtol=BF16_TOL),
          f"K2-f8 disagrees with its plain version: max |err| {err_k2}")
    check(all(torch.allclose(a, b, atol=BF16_TOL, rtol=BF16_TOL)
              for a, b in zip(parts, parts_ref)),
          f"K1-f8 partials disagree with the plain version: max |err| {err_k1}")
    # the NaN contract: one e4m3 NaN (0x7f) in the page column 0 reads
    nk = args[1].clone()
    nk.view(u8)[int(route[0]), 5, 9] = 0x7F
    on, _ = ld.lean_decode_fused(q_seg, nk, args[2], seg_ctx, route, sched, scale)
    onw, _ = ld.lean_decode_fused(q_seg, nk.to(bf), wargs[2], seg_ctx, route, sched, scale)
    bad = ~torch.isfinite(on).flatten(1).all(1)
    check(same_bits(torch, on, onw) and 0 < int(bad.sum()) < bad.numel(),
          "K2-f8 with a NaN element does not read as K2 on the widened page")
    tokens = sum(lens) * Hkv
    small = q_seg.numel() * 2 + 4 * (seg_ctx.numel() + route.numel()
                                     + ld.schedule_tensors(sched, dev)["desc"].numel())
    kd, vd = paged_gather_kv(kw, tbl), paged_gather_kv(vw, tbl)
    lib_ms = library_yardstick(torch, q, kd, vd, lens, g, 2)[LIBRARY_CALL][0]
    del kd, vd
    flops = 4 * g * d * tokens
    record("lean_decode_fused_f8", gpu_ms(lambda: ld.lean_decode_fused(*args)),
           gpu_ms(lambda: ld.lean_decode_fused(*wargs)),
           gpu_ms(lambda: ld.lean_decode_fused_plain(*args), reps=5), lib_ms,
           2 * tokens * d + small + 4 * (o.numel() + lse.numel()), flops, err_k2)
    record("lean_decode_partials_f8", gpu_ms(lambda: ld.lean_decode_partials(*args)),
           gpu_ms(lambda: ld.lean_decode_partials(*wargs)),
           gpu_ms(lambda: ld.lean_decode_partials_plain(*args), reps=5), lib_ms,
           2 * tokens * d + small + 4 * sum(t.numel() for t in parts), flops, err_k1)
    print(f"  NaN contract: one NaN element in a page makes {int(bad.sum())} of {bad.numel()} "
          f"segments' rows non-finite, the rest finite, bit for bit as K2 on the widened page",
          flush=True)
    del args, wargs, kf, vf, kw, vw, k_pool, v_pool

    # K6-f8 on the first decode shape (the fixed backend gathers the pages to dense)
    lens = list(DECODE_SHAPES[0])
    B, width = len(lens), -(-max(DECODE_SHAPES[0]) // tile)
    splits = fixed_split_factor(max(lens), B * Hkv, tile, sm_count)
    q, _, _, _, k_dense, v_dense = make_kv_problem(torch, lens, Hq, Hkv, d, tile, width, bf,
                                                   gen, dev)
    (kf, vf), (kw, vw) = f8_pair(torch, k_dense, v_dense)
    seg_ctx = torch.tensor([L for L in lens for _ in range(Hkv)], dtype=torch.int32, device=dev)
    q_seg = q.reshape(B * Hkv, g, d).contiguous()
    rs = lambda t: t.reshape(B * Hkv, width * tile, d)
    args = (q_seg, rs(kf), rs(vf), seg_ctx, splits, tile, scale)
    wargs = (q_seg, rs(kw), rs(vw), seg_ctx, splits, tile, scale)
    ring_before = fd.ring_launches
    parts = fd.flash_decode_partials(*args)
    torch.cuda.synchronize()
    check(fd.ring_launches == ring_before + 1, "K6-f8 did not run on the decode ring")
    print("  " + ring_line("K6-f8", 1, d, tile, g), flush=True)
    check(all(same_bits(torch, a, b) for a, b in zip(parts, fd.flash_decode_partials(*wargs))),
          "K6-f8 differs from K6 on the widened K/V")
    parts_ref = fd.flash_decode_partials_plain(*args)
    err = max((a - b).abs().max().item() for a, b in zip(parts, parts_ref))
    check(all(torch.allclose(a, b, atol=BF16_TOL, rtol=BF16_TOL) for a, b in zip(parts, parts_ref)),
          f"K6-f8 disagrees with its plain version: max |err| {err}")
    lib_ms = library_yardstick(torch, q, kw, vw, lens, g, 2)[LIBRARY_CALL][0]
    tokens = sum(lens) * Hkv
    record("flash_decode_partials_f8", gpu_ms(lambda: fd.flash_decode_partials(*args)),
           gpu_ms(lambda: fd.flash_decode_partials(*wargs)),
           gpu_ms(lambda: fd.flash_decode_partials_plain(*args), reps=3), lib_ms,
           2 * tokens * d + q_seg.numel() * 2 + 4 * B * Hkv + 4 * sum(t.numel() for t in parts),
           4 * g * d * tokens, err)
    del args, wargs, kf, vf, kw, vw, k_dense, v_dense

    # the fused K4-f8 and K8-f8 on the two-chunk pack
    C, N = CHUNK, len(CHUNK_OFFS)
    visible = [o_ + C for o_ in CHUNK_OFFS]
    sched = make_chunk_schedule(visible, Hkv, tile, sm_count, max_len=max(visible) + tile)
    q, k_pool, v_pool, tbl = chunk_pack(torch, CHUNK_OFFS, C, Hq, Hkv, d, tile, bf, gen, dev)
    (kf, vf), (kw, vw) = f8_pair(torch, k_pool, v_pool)
    seg_ctx = torch.tensor([v for v in visible for _ in range(Hkv)], dtype=torch.int32, device=dev)
    seg_qs = torch.tensor([o_ for o_ in CHUNK_OFFS for _ in range(Hkv)], dtype=torch.int32,
                          device=dev)
    route = ops.paged_route(sched, tbl, Hkv)
    qr = q.reshape(N * Hkv, g * C, d).contiguous()
    args = (qr, *ops._pool_rows(kf, vf), seg_ctx, seg_qs, route, sched, scale, C)
    wargs = (qr, *ops._pool_rows(kw, vw), seg_ctx, seg_qs, route, sched, scale, C)
    q_off = torch.tensor(CHUNK_OFFS, dtype=torch.int32, device=dev)
    lp.reset_launch_counts()
    fp.reset_launch_counts()
    o4 = lp.lean_prefill_fused(*args)
    o8 = fp.flash_prefill_paged(q, kf, vf, tbl, q_off)
    torch.cuda.synchronize()
    check((lp.fused_launches, lp.fused_tc_launches, fp.launches, fp.tc_launches) == (1, 1, 1, 1),
          "the fused K4-f8 or K8-f8 did not run on the tensor cores")
    check(same_bits(torch, o4, lp.lean_prefill_fused(*wargs)),
          "the fused K4-f8 differs from the fused K4 on the widened pool")
    check(same_bits(torch, o8, fp.flash_prefill_paged(q, kw, vw, tbl, q_off)),
          "K8-f8 differs from K8 on the widened pool")
    errs = []
    for out, ref in ((o4, lp.lean_prefill_fused_plain(*args)),
                     (o8, fp.flash_prefill_paged_plain(q, kf, vf, tbl, q_off, scale))):
        # one bf16 step of the output plus 2e-5, as the bf16 forms: both
        # round a float32 result, and the kernel splits P into two halves
        delta = (out.float() - ref.float()).abs()
        step = torch.finfo(bf).eps * ref.float().abs()
        check(bool((delta <= step + BF16_TOL).all()),
              f"an f8 chunk kernel disagrees with its plain version: max |err| {delta.max()}")
        errs.append(delta.max().item())
    nk = args[1].clone()
    nk.view(u8)[int(route[0]), 7, 3] = 0x7F
    on = lp.lean_prefill_fused(qr, nk, *args[2:])
    onw = lp.lean_prefill_fused(qr, nk.to(bf), *wargs[2:])
    check(same_bits(torch, on, onw) and bool(torch.isnan(on).any())
          and bool(torch.isfinite(on).any()),
          "the fused K4-f8 with a NaN element does not read as the fused K4 on the widened page")
    kd, vd = paged_gather_kv(kw, tbl), paged_gather_kv(vw, tbl)
    K = kd.shape[2]
    qpos = q_off[:, None].long() + torch.arange(g * C, device=dev)[None, :] % C
    mask = (torch.arange(K, device=dev)[None, None, :] <= qpos[..., None])[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qf = q.reshape(N, Hkv, g * C, d)
    lib_ms = gpu_ms(lambda: sdpa(qf, kd, vd, attn_mask=mask), reps=10)
    del kd, vd
    keys_seen = sum(Hq * (C * o_ + C * (C + 1) // 2) for o_ in CHUNK_OFFS)
    small = 4 * (seg_ctx.numel() * 2 + route.numel()
                 + ld.schedule_tensors(sched, dev)["desc"].numel())
    nbytes = q.numel() * 2 * 2 + 2 * sum(visible) * Hkv * d + small
    record("lean_prefill_fused_f8", gpu_ms(lambda: lp.lean_prefill_fused(*args), reps=10),
           gpu_ms(lambda: lp.lean_prefill_fused(*wargs), reps=10),
           gpu_ms(lambda: lp.lean_prefill_fused_plain(*args), reps=3), lib_ms, nbytes,
           4 * d * keys_seen, errs[0])
    record("flash_prefill_paged_f8",
           gpu_ms(lambda: fp.flash_prefill_paged(q, kf, vf, tbl, q_off), reps=10),
           gpu_ms(lambda: fp.flash_prefill_paged(q, kw, vw, tbl, q_off), reps=10),
           gpu_ms(lambda: fp.flash_prefill_paged_plain(q, kf, vf, tbl, q_off, scale), reps=3),
           lib_ms, nbytes, 4 * d * keys_seen, errs[1])
    del args, wargs, kf, vf, kw, vw, k_pool, v_pool

    # K5-f8 on the 2048-token shared prefix
    passes, suffixes = CASCADE_CASES[next(iter(CASCADE_CASES))]
    q, k_pool, v_pool, tbl, dup, lens = cascade_problem(torch, passes, suffixes, Hq, Hkv, d,
                                                        tile, bf, gen, dev)
    (kf, vf), (kw, vw) = f8_pair(torch, k_pool, v_pool)
    args, binding = cascade_operands(torch, q, kf, vf, tbl, lens, passes, sm_count)
    wargs, _ = cascade_operands(torch, q, kw, vw, tbl, lens, passes, sm_count)
    ring_before = ld.cascade_ring_launches
    o, lse = ld.lean_cascade_fused(*args)
    torch.cuda.synchronize()
    check(ld.cascade_ring_launches == ring_before + 1, "K5-f8 did not run on the decode ring")
    print("  " + ring_line("K5-f8", 1, d, tile, dr.row_bucket(args[0].shape[1])), flush=True)
    ow, lsew = ld.lean_cascade_fused(*wargs)
    check(same_bits(torch, o, ow) and same_bits(torch, lse, lsew),
          "K5-f8 differs from K5 on the widened pool")
    o_ref, lse_ref = ld.lean_cascade_fused_plain(*args)
    err = max((o - o_ref).abs().max().item(), (lse - lse_ref).abs().max().item())
    check(torch.allclose(o, o_ref, atol=BF16_TOL, rtol=BF16_TOL)
          and torch.allclose(lse, lse_ref, atol=BF16_TOL, rtol=BF16_TOL),
          f"K5-f8 disagrees with its plain version: max |err| {err}")
    dup_t = torch.as_tensor(dup).to(dev)
    kd, vd = paged_gather_kv(kw, dup_t), paged_gather_kv(vw, dup_t)
    lib_ms = library_yardstick(torch, q, kd, vd, lens, g, 2)[LIBRARY_CALL][0]
    del kd, vd
    pref_tok = int(binding.prefix_lens[binding.members[:, 0] >= 0].sum())
    suf_tok = sum(lens) - int(binding.seq_prefix_len.sum())
    members = (binding.members >= 0).sum(axis=1)
    flops = 4 * d * (int((binding.prefix_lens * members).sum()) + suf_tok) * g * Hkv
    record("lean_cascade_fused_f8", gpu_ms(lambda: ld.lean_cascade_fused(*args)),
           gpu_ms(lambda: ld.lean_cascade_fused(*wargs)),
           gpu_ms(lambda: ld.lean_cascade_fused_plain(*args), reps=3), lib_ms,
           2 * (pref_tok + suf_tok) * Hkv * d + q.numel() * 2 + 4 * (o.numel() + lse.numel()),
           flops, err)
    return results


def f8_conversions(torch, eng, Request, vocab):
    """Serve a few requests on ``eng`` (drained) with every step eager and
    trace one decode tick with the operators' input shapes: the largest
    tensor any dtype conversion (``aten::_to_copy``, ``aten::copy_``) read,
    in elements, against one layer's pool. Fails where a conversion read a
    whole pool: the f8 pools reach the kernels as they are."""
    eng.capture_decode = False
    for r in make_requests(Request, vocab, 4):
        eng.submit(r)
    eng.tick()
    eng.tick()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        eng.tick()
        torch.cuda.synchronize()
    while eng.queue or any(eng.slot_req):
        eng.tick()
    pool = eng.cache[0]["k"].numel()
    largest = 0
    for ev in prof.events():
        if ev.name in ("aten::_to_copy", "aten::copy_") and ev.input_shapes:
            shape = ev.input_shapes[0]
            largest = max(largest, math.prod(shape) if shape else 0)
    check(largest < pool, f"an f8 decode tick converted {largest} elements: a whole pool "
          f"({pool}) was widened")
    return largest, pool


def f8_engine_phase(torch, cfg, params, sm_count, new_tokens, bf16):
    """The engine phase's requests on f8 page pools (``kv_dtype="f8"``): K7
    admissions written through the reference's cast, K2-f8 decode. Checks
    the launches (K7 = layers x admissions, K2 = layers x steps, K1 none),
    the e4m3 pools and their drain, and that no step widens a pool (an
    eager tick traced with shapes); reports tick p50, tokens/s, traced
    ticks, page bytes against bf16's, and the logit gap and greedy
    agreement with the bf16 engine (``bf16``: its streams and logits rows),
    which are not bounded. Then a ``fused=False`` engine (K1-f8 + merge)
    for a few ticks, and the f16 and f32 caches: one admission and tick
    each on bf16 pools, as the reference stores them, bit for bit with the
    bf16 engine. Returns the launch counts, K1-f8's launches and the
    blocking first tokens."""
    from repro_torch.serving.engine import DecodeEngine, Request
    from repro_torch.serving.kvpool import KVLayout

    L = cfg.n_layers
    eng = DecodeEngine(cfg, params, engine_config("lean", sm_count, kv_dtype="f8"),
                       device="cuda")
    lay = eng.pool.layout
    bf_bytes = KVLayout(kv_dtype="bf16", n_kv_heads=lay.n_kv_heads, head_dim=lay.head_dim,
                        page_size=lay.page_size, n_attn_layers=lay.n_attn_layers).page_bytes
    check({t.dtype for lc in eng.cache for t in lc.values()} == {torch.float8_e4m3fn}
          and not eng.quant and 2 * lay.page_bytes == bf_bytes,
          "f8 engine: the pools are not e4m3 at half of bf16's page bytes")
    reqs = make_requests(Request, cfg.vocab_size, new_tokens)
    reset_launch_counts()
    first_s, ticks, rows = drive(torch, eng, reqs)
    counts = launch_counts()
    check(counts["K7"] == L * eng.stats.prefills == L * len(reqs),
          f"f8 engine: K7 launched {counts['K7']} times, expected {L} x {len(reqs)} admissions")
    check(counts["K2"] == L * eng.stats.ticks and eng.stats.ticks > 0,
          f"f8 engine: K2-f8 launched {counts['K2']} times, expected {L} x {eng.stats.ticks}")
    others = {k: n for k, n in counts.items() if k not in ("K2", "K7") and n}
    check(not others, f"f8 engine: other kernels ran: {others}")
    path_counts("f8 engine")
    check(all(len(r.generated) == new_tokens for r in reqs), "f8 engine: a request did not finish")
    check(eng.stats.decode_replays > 0, "f8 engine: no decode tick replayed a captured step")
    check(bool(torch.isfinite(rows[0]).all()), "f8 engine: logits not finite")
    eng.pool.check()
    check(eng.pool.num_allocated == 0, f"f8 engine: {eng.pool.num_allocated} pages leaked")
    p50 = statistics.median(dt for dt, _ in ticks)
    tok_s = sum(n for _, n in ticks) / sum(dt for dt, _ in ticks)
    streams = [list(r.generated) for r in reqs]
    gap = (rows[0] - bf16["rows"][0]).abs().max().item()
    agree = sum(a == b for s1, s2 in zip(streams, bf16["streams"]) for a, b in zip(s1, s2))
    print(f"f8 engine phase: {cfg.name} full width, e4m3 pages ({lay.page_bytes} B a page "
          f"across the layers against bf16's {bf_bytes} B: {bf_bytes / lay.page_bytes:.4f}x the "
          f"pages per GB), {len(reqs)} requests (prompts {list(PROMPT_LENS)}, {new_tokens} new "
          f"tokens): admission + first decode tick {first_s * 1e3:.1f} ms; decode tick p50 "
          f"{p50 * 1e3:.2f} ms (captured) over {len(ticks)} ticks, {tok_s:.1f} tokens/s; "
          f"launches K2-f8 {counts['K2']} = {L} x {eng.stats.ticks} (all on the decode ring), "
          f"K7 {counts['K7']} = {L} x {len(reqs)}, K1 0; pool clean; against the bf16 engine "
          f"(not bounded): first decode tick's max |logit gap| {gap:.4f}, greedy tokens "
          f"agreeing {agree}/{len(reqs) * new_tokens}", flush=True)
    traced_ticks(torch, eng, make_requests(Request, cfg.vocab_size, TRACED_TICKS + 6), p50,
                 label="f8 traced ticks (captured)")
    largest, pool = f8_conversions(torch, eng, Request, cfg.vocab_size)
    print(f"  f8 eager decode tick traced with shapes: the largest dtype conversion read "
          f"{largest} elements, one layer's K pool holds {pool}: no pool is widened", flush=True)
    blocking = {"prompts": [r.prompt.copy() for r in reqs], "first": [s[0] for s in streams],
                "rows": bf16["prefill_rows"]}
    del eng

    # eager tick p50 beside the captured one (the engine phase's is captured)
    eng = DecodeEngine(cfg, params, engine_config("lean", sm_count, kv_dtype="f8"),
                       device="cuda")
    eng.capture_decode = False
    _, ticks_e, _ = drive(torch, eng, make_requests(Request, cfg.vocab_size, 6))
    eager_p50 = statistics.median(dt for dt, _ in ticks_e)
    del eng

    eng = DecodeEngine(cfg, params, engine_config("lean", sm_count, fused=False, kv_dtype="f8"),
                       device="cuda")
    reset_launch_counts()
    drive(torch, eng, make_requests(Request, cfg.vocab_size, 4))
    two = launch_counts()
    check(two["K1"] == L * eng.stats.ticks and two["K1"] > 0 and two["K2"] == 0,
          f"f8 two-phase: launches {two}, expected K1-f8 {L} x {eng.stats.ticks} and no K2")
    path_counts("f8 two-phase")
    check(bool(torch.isfinite(eng.last_logits).all()), "f8 two-phase logits are not finite")
    eng.pool.check()
    k1_launches = two["K1"]
    print(f"f8 tick p50: eager {eager_p50 * 1e3:.2f} ms, captured {p50 * 1e3:.2f} ms; f8 "
          f"two-phase: {two['K1']} K1-f8 launches = {L} x {two['K1'] // L} ticks, logits "
          f"finite, pool clean", flush=True)
    del eng

    # f16 and f32: the reference stores both as bf16 (its KVLayout counts 2
    # and 4 bytes): one admission and decode tick each against bf16's
    r = make_requests(Request, cfg.vocab_size, 2)[2]
    logits, pages = {}, {}
    for kv in ("bf16", "f16", "f32"):
        eng = DecodeEngine(cfg, params, engine_config("lean", sm_count, kv_dtype=kv),
                           device="cuda")
        check({t.dtype for lc in eng.cache for t in lc.values()} == {torch.bfloat16},
              f"{kv} engine: the pools are not bf16")
        eng.submit(Request(uid=0, prompt=r.prompt.copy(), max_new_tokens=2))
        eng.tick()
        eng.tick()
        logits[kv], pages[kv] = eng.last_logits.clone(), eng.pool.layout.page_bytes
        del eng
    check(torch.equal(logits["f16"], logits["bf16"]) and torch.equal(logits["f32"], logits["bf16"]),
          "f16 or f32 pools serve other logits than bf16 ones")
    print(f"f16 and f32 caches: bf16 pools, one admission ({len(r.prompt)} tokens) and decode "
          f"tick with the bf16 engine's logits bit for bit; page bytes as the reference counts "
          f"them: " + ", ".join(f"{k} {v}" for k, v in pages.items()), flush=True)
    torch.cuda.empty_cache()
    return counts, k1_launches, blocking


def f8_prefix_wave(torch, cfg, params, sm_count, new_tokens) -> dict:
    """The prefix waves on f8 pages through the lean Scheduler with the
    radix cache and cascade decode: K5-f8 on the cascade ticks, the fused
    K4-f8 on the chunk steps, K2-f8 on the other ticks, one launch a layer;
    the pool and the radix cache clean. Returns the launch counts."""
    waves = prefix_waves(cfg.vocab_size)
    on = prefix_serving_run(torch, cfg, params, sm_count, new_tokens, waves, prefix=True,
                            kv_dtype="f8")
    st, c, L = on["eng"].stats, on["counts"], cfg.n_layers
    chunk_steps = len(st.tick_prefill_tokens)
    check(st.cascade_fused_ticks > 0 and c["K5"] == L * st.cascade_fused_ticks,
          f"f8 prefix serving: K5-f8 launched {c['K5']} times, expected {L} x "
          f"{st.cascade_fused_ticks} cascade ticks (> 0)")
    check(c["K2"] == L * (st.ticks - st.cascade_ticks) and c["K4f"] == L * chunk_steps,
          f"f8 prefix serving: launches {c}")
    path_counts("f8 prefix serving")
    others = {k: n for k, n in c.items() if k not in ("K2", "K4f", "K5") and n}
    check(not others, f"f8 prefix serving: other kernels ran: {others}")
    check(st.prefix_matched_tokens > 0, "f8 prefix serving: nothing was shared")
    check(all(bool(torch.isfinite(a).all()) for a in on["eng"].first_rows.values()),
          "f8 prefix serving: logits not finite")
    print(f"f8 prefix serving: {SYSTEM_TOKENS}-token system prompt, then tails "
          f"{list(WAVE2_TAILS)}, {new_tokens} new tokens: prefix_matched_tokens "
          f"{st.prefix_matched_tokens}, cascade_fused_ticks {st.cascade_fused_ticks} of "
          f"{st.ticks}, cow_copies {st.cow_copies}; launches fused K4-f8 {c['K4f']} = {L} x "
          f"{chunk_steps}, K5-f8 {c['K5']} = {L} x {st.cascade_fused_ticks}, K2-f8 {c['K2']} = "
          f"{L} x {st.ticks - st.cascade_ticks}; wall {on['wall']:.2f} s; pool and radix cache "
          f"clean", flush=True)
    return c


def f8_phase(torch, cfg, params, sm_count, new_tokens, dev_name, bf16):
    """Phase 11 (``--f8-step`` alone): the f8 kernels, the f8 engine, the
    Scheduler on lean and fixed, a prefix wave with cascade, and f16/f32.
    ``bf16``: the bf16 engine's streams, logits rows and blocking prefill
    rows. Returns the kernels' results and the launches of each f8 form on
    the path that serves it."""
    f8res = f8_kernel_phase(torch, sm_count, dev_name)
    counts, k1, blocking = f8_engine_phase(torch, cfg, params, sm_count, new_tokens, bf16)
    runs = {b: scheduler_phase(torch, cfg, params, b, sm_count, new_tokens, blocking,
                               kv_dtype="f8") for b in ("lean", "fixed")}
    prefix = f8_prefix_wave(torch, cfg, params, sm_count, 8)
    launches = {"lean_decode_fused_f8": counts["K2"], "lean_decode_partials_f8": k1,
                "lean_prefill_fused_f8": runs["lean"]["counts"]["K4f"],
                "flash_prefill_paged_f8": runs["fixed"]["counts"]["K8"],
                "flash_decode_partials_f8": runs["fixed"]["counts"]["K6"],
                "lean_cascade_fused_f8": prefix["K5"]}
    check(all(n > 0 for n in launches.values()), f"an f8 form was not launched: {launches}")
    print("f8 phase launches: " + ", ".join(f"{k} {v}" for k, v in launches.items()), flush=True)
    return f8res, launches


# ------------------------------------------------------------ captured step
CAPTURE_NEW_TOKENS = 6     # new tokens per request in the bit check (waves: 8)


def capture_configs(sm_count):
    """(label, EngineConfig, drive) of every configuration whose steps the
    engine captures: paged bf16 and int8 pools and the dense cache, on
    ``lean`` (K2, and the two-call K1 + merge), ``fixed`` and ``ref``,
    served as the engine phase serves (``"engine"``: blocking admission,
    decode steps); the same requests through the ``Scheduler`` on ``lean``,
    ``fixed`` and ``ref``, bf16 and int8 pages (``"sched"``: chunk steps);
    f8 pages on ``lean``, decode and chunk steps;
    speculative decode on ``lean`` bf16 and int8 pages and ``fixed`` bf16
    (``"engine"`` with ``SpecConfig(k=4)``, the n-gram proposer: verify
    steps, the fused K4 or K8 on 5-row chunks); ``ADMIT_LENS``
    admitted twice on paged bf16, int8 and dense engines (``"admit"``:
    every admission bucket comes back); and the cascade, fused K5 and the
    two-call path, on the prefix waves through the ``Scheduler``
    (``"waves"``)."""
    import dataclasses

    from repro_torch.serving.config import (
        CascadeConfig,
        EngineConfig,
        PagedConfig,
        SpecConfig,
    )

    kinds = (("lean", True), ("lean", False), ("fixed", True), ("ref", True))
    name = lambda b, f: b + ("" if f else " two-call")
    dense = lambda b, f: EngineConfig(max_batch=4, cache_len=4096, attn_backend=b,
                                      num_workers=sm_count, fused=f,
                                      paged=PagedConfig(enabled=False))
    out = [(f"paged {kv or 'bf16'} {name(b, f)}", engine_config(b, sm_count, f, kv), "engine")
           for kv in (None, "int8") for b, f in kinds]
    out += [(f"dense {name(b, f)}", dense(b, f), "engine") for b, f in kinds]
    out += [(f"chunk steps {kv or 'bf16'} {b}", engine_config(b, sm_count, True, kv), "sched")
            for kv in (None, "int8") for b in ("lean", "fixed", "ref")]
    out += [("paged f8 lean", engine_config("lean", sm_count, True, "f8"), "engine"),
            ("chunk steps f8 lean", engine_config("lean", sm_count, True, "f8"), "sched")]
    out += [(f"spec {kv or 'bf16'} {b}", dataclasses.replace(
        engine_config(b, sm_count, True, kv), spec=SpecConfig(enabled=True, k=SPEC_K)),
        "engine") for b, kv in (("lean", None), ("lean", "int8"), ("fixed", None))]
    out += [(f"admission {label}", config, "admit") for label, config in (
        ("paged bf16", engine_config("lean", sm_count)),
        ("paged int8", engine_config("lean", sm_count, kv_dtype="int8")),
        ("dense", dense("lean", True)))]
    out += [(f"cascade {'K5' if f else 'two-call'}", EngineConfig(
        max_batch=4, cache_len=4096, attn_backend="lean", num_workers=sm_count,
        paged=PagedConfig(enabled=True, page_size=128, prefix_cache=True),
        cascade=CascadeConfig(enabled=True, stable_ticks=2, fused=f)), "waves")
        for f in (True, False)]
    return out


def twin_bits(torch, cfg, params, config, drive, prompts=None):
    """The eager steps (``capture_decode = False``) and the captured ones
    on two engines of ``config``, serving the same requests in lockstep:
    after every engine or scheduler step, every pool (the null page aside)
    compared bit for bit, and the step's change of the launch counters
    compared; the logits of every chunk, verify and admission step compared
    bit for bit (the rows it served: chunk and verify rows with tokens);
    after every decode tick, the logits rows of the slots it served bit for
    bit and the greedy tokens. Idle and masked slots all write their token
    to the null page (every one the last such slot's K/V) and read it back
    as their one visible key: their rows and the null page are garbage by
    design, which no served row reads -- but a MoE routes them with the
    served rows, so they must match too. Returns {kind: [steps,
    bit-identical steps]} (decode: ticks), the max |logit difference|, the
    captured engine's stats, and its cascade ticks' replays. ``prompts``
    replaces the ``"engine"`` and ``"sched"`` drives' ``PROMPT_LENS``
    prompts."""
    import numpy as np

    from repro_torch.core.attention import kv_bytes
    from repro_torch.kernels import launches
    from repro_torch.serving.engine import DecodeEngine, Request
    from repro_torch.serving.scheduler import Scheduler, SchedulerConfig

    def run(eng):
        """Yields after every engine step: whether it ran a decode tick."""
        if drive in ("engine", "admit"):
            if drive == "engine" and prompts is not None:
                rounds = [[Request(uid=i, prompt=p, max_new_tokens=CAPTURE_NEW_TOKENS)
                           for i, p in enumerate(prompts)]]
            elif drive == "engine":
                rounds = [make_requests(Request, cfg.vocab_size, CAPTURE_NEW_TOKENS)]
            else:
                rng = np.random.default_rng(3)
                admit = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in ADMIT_LENS]
                rounds = [[Request(uid=5 * k + i, prompt=p, max_new_tokens=2)
                           for i, p in enumerate(admit)] for k in range(2)]
            for reqs in rounds:
                for r in reqs:
                    eng.submit(r)
                while eng.queue or any(eng.slot_req):
                    ticks = eng.stats.ticks
                    eng.tick()
                    yield eng.stats.ticks > ticks
            return
        sch = Scheduler(eng, SchedulerConfig(chunk_size=SCHED_CHUNK, prefill_pack=SCHED_PACK,
                                             token_budget=SCHED_BUDGET, chunked=True))
        if drive == "sched" and prompts is not None:
            waves = [[Request(uid=i, prompt=p, max_new_tokens=0) for i, p in enumerate(prompts)]]
        elif drive == "sched":
            waves = [list(make_requests(Request, cfg.vocab_size, 0))]
        else:
            waves = prefix_waves(cfg.vocab_size)
        uid = 0
        for wave in waves:
            for p in wave:
                sch.submit(p.prompt if drive == "sched" else p, CAPTURE_NEW_TOKENS + 2, uid=uid)
                uid += 1
            while sch.pending:
                ticks = eng.stats.ticks
                sch.step()
                yield eng.stats.ticks > ticks

    class Served(DecodeEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.outs = []

        def _emit_tokens(self, results, guard_on, spec=None):
            self.served = [s for active, _, _ in results for s in active]
            return super()._emit_tokens(results, guard_on, spec)

        def _run_step(self, step):
            out = super()._run_step(step)
            if step.kind != "decode":
                rows = out if step.kind == "admit" else out[
                    torch.as_tensor(step.host["lens"] > 0, device=out.device)]
                self.outs.append((step.kind, rows.clone()))
            return out

    engines = [Served(cfg, params, config, device="cuda") for _ in range(2)]
    engines[0].capture_decode = False
    first = 1 if engines[0].paged else 0
    runs = [run(e) for e in engines]
    steps = {}
    cascade_replays = 0
    worst = 0.0
    while True:
        replays = engines[1].stats.decode_replays
        ran, moved = [], []
        for r in runs:
            before = launches.snapshot()
            ran.append(next(r, None))
            moved.append(launches.delta(launches.snapshot(), before))
        check(ran[0] == ran[1], "the eager and the captured engine fell out of step")
        if ran[0] is None:
            break
        check(moved[0] == moved[1], f"a step's launches differ: eager {moved[0]}, captured "
              f"{moved[1]}")
        # (an f8 pool compared by its bytes)
        pools = all(torch.equal(kv_bytes(x)[first:], kv_bytes(y)[first:])
                    for l0, l1 in zip(*(e.cache for e in engines))
                    for x, y in zip(l0.values(), l1.values()))
        o0, o1 = (e.outs for e in engines)
        check([k for k, _ in o0] == [k for k, _ in o1], "the engines ran other steps")
        for (kind, a), (_, b) in zip(o0, o1):
            n = steps.setdefault(kind, [0, 0])
            n[0] += 1
            n[1] += int(torch.equal(a, b) and pools)
            worst = max(worst, (a - b).abs().max().item())
        o0.clear()
        o1.clear()
        if not ran[0]:
            check(pools, "a step's pools differ between the eager and the captured engine")
            continue
        n = steps.setdefault("decode", [0, 0])
        n[0] += 1
        cascade_replays += int(engines[1].last_step_key[0][1] == "cascade"
                               and engines[1].stats.decode_replays > replays)
        check(engines[0].served == engines[1].served, f"tick {n[0]}: served other slots")
        same = pools
        if engines[0].served:            # none when every slot ran a verify step
            a, b = (e.last_logits[e.served] for e in engines)
            check(torch.equal(a.argmax(-1), b.argmax(-1)),
                  f"tick {n[0]}: the captured step's greedy tokens differ from the eager step's")
            same = same and torch.equal(a, b)
            worst = max(worst, (a - b).abs().max().item())
        n[1] += int(same)
    st = engines[1].stats
    del engines, runs
    torch.cuda.empty_cache()
    return steps, worst, st, cascade_replays


CAPTURE_BITS_LAYERS = 10       # of Mistral-NeMo-12B's 40: the full run's time limit


def captured_step_phase(torch, cfg, params, sm_count, new_tokens, smi: str):
    """The decode step captured as a CUDA graph against the eager step, at
    full width (the engine phase's requests, batch 4, page 128): tick p50
    of the eager and the captured engine in turns (eager, captured,
    captured, eager) on bf16 and on int8 pages, with captures and replays
    per run; a few ticks of each traced (host launch calls and device
    kernels per tick, device busy, idle share); and the bit check of every
    configuration the engine captures (``capture_configs``, ``twin_bits``)
    at ``CAPTURE_BITS_LAYERS`` of depth (printed).
    Fails where a captured engine replays nothing, its greedy tokens or a
    step's launch counts differ from the eager engine's, or its logits or
    pools differ in any bit."""
    from repro_torch.serving.engine import DecodeEngine, Request

    for kv in (None, "int8"):
        what = f"{kv or 'bf16'} pages"
        p50s, runs = [], []
        for captured in (False, True, True, False):
            eng = DecodeEngine(cfg, params, engine_config("lean", sm_count, kv_dtype=kv),
                               device="cuda")
            eng.capture_decode = captured
            _, ticks, _ = drive(torch, eng, make_requests(Request, cfg.vocab_size, new_tokens))
            p50s.append(statistics.median(dt for dt, _ in ticks) * 1e3)
            runs.append((eng.stats.ticks, eng.stats.decode_captures, eng.stats.decode_replays))
            check(not captured or eng.stats.decode_replays > 0,
                  f"captured step ({what}): no tick replayed a graph")
            del eng
            torch.cuda.empty_cache()
        print(f"captured step phase ({what}; {smi}): decode tick p50 ms in turns (eager, "
              f"captured, captured, eager) " + ", ".join(f"{t:.2f}" for t in p50s)
              + "; per run (decode ticks, captures, replays) "
              + ", ".join(str(r) for r in runs), flush=True)
        traced = {}
        for captured, p50 in ((False, (p50s[0] + p50s[3]) / 2), (True, (p50s[1] + p50s[2]) / 2)):
            eng = DecodeEngine(cfg, params, engine_config("lean", sm_count, kv_dtype=kv),
                               device="cuda")
            eng.capture_decode = captured
            traced[captured] = traced_ticks(
                torch, eng, make_requests(Request, cfg.vocab_size, TRACED_TICKS + 6), p50 / 1e3,
                label=f"captured step phase, traced {'captured' if captured else 'eager'} "
                      f"ticks ({what})")
            del eng
            torch.cuda.empty_cache()
        e, c = traced[False], traced[True]
        print(f"captured step phase ({what}): per tick, eager -> captured: host launch calls "
              f"{e['host_launch_calls']:.1f} -> {c['host_launch_calls']:.1f}; device kernels "
              f"{e['kernels']:.0f} -> {c['kernels']:.0f}; device busy {e['busy_ms']:.2f} -> "
              f"{c['busy_ms']:.2f} ms; idle share of the untraced p50 {e['idle_p50']:.3f} -> "
              f"{c['idle_p50']:.3f}", flush=True)

    # the bit check at CAPTURE_BITS_LAYERS of depth: whether a replayed
    # step equals its eager step does not depend on how many layers repeat
    cfg_b = arch_config(cfg, CAPTURE_BITS_LAYERS)
    params_b = dict(params, layers=params["layers"][:cfg_b.n_layers])
    for label, config, how in capture_configs(sm_count):
        steps, worst, st, casc_replays = twin_bits(torch, cfg_b, params_b, config, how)
        expect = {"engine": ["decode", "admit"], "admit": ["admit"], "sched": ["chunk", "decode"],
                  "waves": ["chunk", "decode"]}[how] + (["verify"] if st.spec_ticks else [])
        print(f"captured step bit check ({label}, {cfg_b.n_layers} of {cfg.n_layers} layers): "
              + "; ".join(f"{kind} {same}/{n} bit for bit (captures "
                          f"{getattr(st, kind + '_captures')}, replays "
                          f"{getattr(st, kind + '_replays')})"
                          for kind, (n, same) in sorted(steps.items()))
              + f" (logits and pools); max |logit difference| {worst:.3g}; greedy tokens and "
              f"launch counts equal"
              + (f"; cascade ticks {st.cascade_ticks}, {casc_replays} of them replayed"
                 if how == "waves" else ""), flush=True)
        for kind in expect:
            n, same = steps.get(kind, (0, 0))
            check(same == n > 0, f"captured step ({label}): {n - same} of {n} {kind} steps "
                  f"differ from the eager step (max |logit difference| {worst})")
        # the kinds that must replay: a speculative engine's slots all verify
        # (the prompts leave room for every block), so it runs no
        # single-token step; the engine drive's admission buckets differ
        replayed = (["verify"] if st.spec_ticks else
                    [k for k in expect if k != "admit" or how == "admit"])
        check(all(getattr(st, f"{k}_replays") > 0 for k in replayed)
              and (how != "waves" or casc_replays > 0),
              f"captured step ({label}): a step kind of {replayed} replayed no graph")
        check(not label.startswith("spec") or st.spec_ticks > 0,
              f"captured step ({label}): no verify step ran")


# ------------------------------------------- chunk step, verify step, admission
# rounds a chunk step phase serves the prompts on one engine: a chunk key
# first seen in round 1 is captured in round 2 and replays from round 3
CHUNK_ROUNDS = 3


def chunk_step_phase(torch, cfg, params, sm_count, new_tokens, blockings, smi: str,
                     full=True):
    """The chunk step captured (with every other step) against the eager
    steps, on the lean Scheduler (chunk 256, pack 2, budget 512), on bf16 and
    on int8 pages: the phase wall and TTFT per request in turns (eager,
    captured, captured, eager), chunk captures and replays, and the capture
    plus instantiation time of a full-width chunk graph; then traced -- the
    second captured run serves a round more under the profiler, and an eager
    phase -- the device's idle share and host launch calls per chunk step --
    the eager phase only with ``full``
    (``--chunk-step``: an eager phase's trace takes a minute or two to
    read, and the full run traces the eager steps of other phases).
    ``blockings`` maps the kv dtype to the blocking engine's first tokens
    and rows, which every run's first tokens are held to. A captured run
    serves the prompts ``CHUNK_ROUNDS`` times on one engine: a chunk key
    first seen in round 1 is captured in round 2 and replays from then
    on."""
    out = {}
    for kv in (None, "int8"):
        what = f"{kv or 'bf16'} pages"
        clock(f"chunk step phase, {what}")
        # the second captured run serves one more round, traced: a round as
        # warm as its last untraced one, on the same engine
        prof = scheduler_profiler(torch)
        runs = [scheduler_phase(torch, cfg, params, "lean", sm_count, new_tokens, blockings[kv],
                                kv_dtype=kv, captured=c, quiet=True,
                                rounds=(CHUNK_ROUNDS + (i == 2)) if c else 1,
                                profiler=prof if i == 2 else None)
                for i, c in enumerate((False, True, True, False))]
        caps = [ms for r in runs for kind, ms, _ in r["capture_log"] if kind == "chunk"]
        grew = sum(b for r in runs[1:3] for _, _, b in r["capture_log"]) / 2
        st = [r["stats"] for r in runs[1:3]]
        print(f"chunk step phase ({what}; {smi}): lean Scheduler, runs in turns (eager, "
              f"captured, captured, eager), the captured ones {CHUNK_ROUNDS} rounds of the "
              f"prompts on one engine (the second then one traced); wall s per round: "
              + " | ".join(", ".join(f"{w:.2f}" for w in r["walls"][:CHUNK_ROUNDS]) for r in runs)
              + "; TTFT ms per request (prompts " + str(list(PROMPT_LENS)) + "), last round: "
              + " | ".join(", ".join(f"{t:.1f}" for t in r["ttfts"][:CHUNK_ROUNDS][-1])
                           for r in runs)
              + f"; chunk steps a round {runs[1]['chunk_steps']}; captured runs' chunk captures "
              f"/ replays {st[0].chunk_captures} / {st[0].chunk_replays}, {st[1].chunk_captures} "
              f"/ {st[1].chunk_replays}; chunk capture + instantiation ms: median "
              f"{statistics.median(caps):.1f}, max {max(caps):.1f} over {len(caps)}; reserved "
              f"memory grown by a run's captures (every step kind) {grew / 2**20:.0f} MiB",
              flush=True)
        clock(f"chunk step phase, {what}, traced")
        traced = {}
        if full:
            traced[False] = traced_scheduler_phase(torch, cfg, params, "lean", sm_count,
                                                   new_tokens, blockings[kv], kv_dtype=kv,
                                                   captured=False)
        traced[True] = traced_round(torch, prof, runs[2], "lean", kv, True, CHUNK_ROUNDS + 1)
        # the untraced walls of the same rounds: eager runs, and the captured
        # runs' last untraced round
        untraced = {False: (runs[0]["walls"][0] + runs[3]["walls"][0]) / 2,
                    True: (runs[1]["walls"][-1] + runs[2]["walls"][CHUNK_ROUNDS - 1]) / 2}
        line = lambda key, fmt: " -> ".join(format(traced[c][key], fmt) for c in traced)
        print(f"chunk step phase ({what}): traced lean Scheduler phase (captured: its last "
              f"round), {' -> '.join('captured' if c else 'eager' for c in traced)}: idle "
              f"share of the traced wall {line('idle', '.3f')}, of the untraced wall "
              + " -> ".join(f"{1 - traced[c]['busy_ms'] / (untraced[c] * 1e3):.3f}"
                            for c in traced)
              + f"; device busy {line('busy_ms', '.1f')} ms; host launch calls per chunk step "
              f"{line('chunk_calls', '.1f')}; host syncs {line('syncs', 'd')}", flush=True)
        out[kv] = {"runs": runs, "traced": traced}
        torch.cuda.empty_cache()
    return out


SPEC_K, SPEC_NEW = 4, 41


def spec_engine_class():
    """A :class:`DecodeEngine` recording the logits row behind every
    decode token, by (request, token index): the single-token step's rows
    and the verify step's rows it emitted."""
    from repro_torch.serving.engine import DecodeEngine

    class Rows(timed(DecodeEngine)):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.rows = {}

        def _emit_tokens(self, results, guard_on, spec=None):
            for active, _, _ in results:           # one pass: no guards here
                for s in active:
                    req = self.slot_req[s]
                    self.rows[(req.uid, len(req.generated))] = self.last_logits[s].clone()
            return super()._emit_tokens(results, guard_on, spec)

        def _emit_spec_tokens(self, spec, out, cap):
            before = {s: (self.slot_req[s], len(self.slot_req[s].generated)) for s in spec[0]}
            n = super()._emit_spec_tokens(spec, out, cap)
            for s, (req, m) in before.items():
                for i in range(len(req.generated) - m):
                    self.rows[(req.uid, m + i)] = self.last_verify_logits[s, i].clone()
            return n

    return Rows


def spec_drive(torch, eng, reqs, trace=None):
    """Serve ``reqs`` on ``eng``; returns (decode tokens per second over the
    ticks after the first, those ticks' seconds, the streams). With
    ``trace`` (a ``torch.profiler`` context) ticks 3 to 7 -- past the
    first tick's admissions and warm-ups and the second's captures -- run
    under it."""
    for r in reqs:
        eng.submit(r)
    eng.tick()                                   # admissions + the first tick
    torch.cuda.synchronize()
    n_tok, t0, ticks = 0, time.perf_counter(), []
    while eng.queue or any(eng.slot_req):
        if trace is not None and len(ticks) == 1:
            trace.start()
        t1 = time.perf_counter()
        out = eng.tick()
        torch.cuda.synchronize()
        ticks.append(time.perf_counter() - t1)
        if trace is not None and len(ticks) == 1 + TRACED_TICKS:
            trace.stop()
            trace = None
        n_tok += sum(len(v) if isinstance(v, list) else 1 for v in out.values())
    check(trace is None, f"the requests ended before {TRACED_TICKS} ticks were traced")
    return n_tok / (time.perf_counter() - t0), ticks, [list(r.generated) for r in reqs]


def spec_divergences(torch, base, eng, streams, got, what: str, hold: bool = True) -> float:
    """Hold a speculative run's streams (``got``, engine ``eng``) to the
    non-speculative run's (``streams``, engine ``base``): the largest logit
    difference between the rows both computed for the same token before
    any divergence; at each divergence the non-speculative run's top-2
    logit gap there must be below it (a near-tie that the two steps'
    roundings break apart), else the run fails -- unless ``hold`` is False
    (a MoE model: a verify step routes its rows with the other rows of its
    batch, so a row's experts, and the capacity drops among them, differ
    from the decode step's). Prints the divergences; returns the largest
    difference."""
    firsts = [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
              for a, b in zip(streams, got)]
    before = [(u, i) for u, j in enumerate(firsts)
              for i in range(1, len(streams[u]) if j is None else j)]
    worst = max(((base.rows[k] - eng.rows[k]).abs().max().item()
                 for k in before if k in eng.rows), default=0.0)
    for u, j in enumerate(firsts):
        if j is None:
            continue
        top = torch.topk(base.rows[(u, j)].float(), 2).values
        gap = (top[0] - top[1]).item()
        print(f"spec phase ({what}): request {u} diverges from the non-speculative stream at "
              f"token {j}; the non-speculative run's top-2 gap there {gap:.4f}, the largest "
              f"verify-vs-decode logit difference {worst:.4f}", flush=True)
        check(not hold or gap < worst, f"spec phase ({what}): request {u} diverges at token "
              f"{j} with a top-2 gap of {gap} (>= {worst})")
    return worst


def spec_phase(torch, cfg, params, sm_count, smi: str):
    """Speculative decode at full width (k 4, batch 4, paged lean, the
    ``PROMPT_LENS`` prompts, ``SPEC_NEW`` new tokens) on bf16 and int8
    pages, every step captured. The non-speculative run's greedy streams
    drive an ``OracleProposer`` (run A); every speculative stream is held
    to the non-speculative one (:func:`spec_divergences`). A random-weight
    model's logits tie often in bf16, so a verify row, rounded apart from
    the decode row, can break a tie the other way, after which the oracle's
    drafts stop matching: the timed runs therefore replay run A's own
    streams. Tokens/s against the non-speculative engine in turns (plain,
    spec, spec, plain) with tick p50s, spec ticks, accept rate, verify
    captures and replays, the fused K4's launches from verify steps, five
    replayed verify ticks traced; and the ``NGramProposer`` once. Returns
    the fused K4's launches from verify steps (bf16, run A)."""
    import dataclasses

    from repro_torch.serving.config import SpecConfig
    from repro_torch.serving.engine import Request
    from repro_torch.serving.speculative import NGramProposer, OracleProposer

    Rows = spec_engine_class()
    k4_verify = None
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for kv in (None, "int8"):
        what = f"{kv or 'bf16'} pages"
        clock(f"spec phase, {what}")
        config = engine_config("lean", sm_count, kv_dtype=kv)
        reqs = lambda: make_requests(Request, cfg.vocab_size, SPEC_NEW)
        spec = lambda prop: dataclasses.replace(config, spec=SpecConfig(
            enabled=True, k=SPEC_K, proposer=prop))
        base = Rows(cfg, params, config, device="cuda")
        _, _, streams = spec_drive(torch, base, reqs())
        runs = {}
        for label, conf in (("oracle (run A)", spec(OracleProposer(dict(enumerate(streams))))),
                            ("n-gram", spec(NGramProposer()))):
            eng = Rows(cfg, params, conf, device="cuda")
            reset_launch_counts()
            _, _, got = spec_drive(torch, eng, reqs())
            counts = launch_counts()
            st = eng.stats
            worst = spec_divergences(torch, base, eng, streams, got, f"{what}, {label}")
            check(st.spec_ticks > 0 and st.verify_replays > 0,
                  f"spec phase ({what}, {label}): no verify step replayed a graph")
            check(counts["K4f"] == cfg.n_layers * st.spec_ticks
                  and counts["K7"] == cfg.n_layers * st.prefills,
                  f"spec phase ({what}, {label}): launches {counts}, expected fused K4 "
                  f"{cfg.n_layers} x {st.spec_ticks} verify steps")
            eng.pool.check(scales=eng._kv_scale_arrays())
            check(eng.pool.num_allocated == 0, f"spec phase ({what}): pages leaked")
            runs[label] = got
            print(f"spec phase ({what}, {label} proposer, k {SPEC_K}; {smi}): {st.spec_ticks} "
                  f"spec ticks of {st.ticks}, accept rate "
                  f"{st.spec_accepted_tokens / max(1, st.spec_draft_tokens):.3f} "
                  f"({st.spec_accepted_tokens}/{st.spec_draft_tokens}), verify captures "
                  f"{st.verify_captures}, replays {st.verify_replays}; fused K4 launches "
                  f"{counts['K4f']} = {cfg.n_layers} x {st.spec_ticks} verify steps; streams "
                  f"equal to the non-speculative run's "
                  f"{sum(a == b for a, b in zip(streams, got))}/{len(got)}; max |verify row - "
                  f"decode row| before a divergence {worst:.4f}", flush=True)
            if kv is None and label.startswith("oracle"):
                k4_verify = counts["K4f"]
        oracle = OracleProposer(dict(enumerate(runs["oracle (run A)"])))
        turns = []
        for spec_on in (False, True, True, False):
            eng = Rows(cfg, params, spec(oracle) if spec_on else config, device="cuda")
            tok_s, ticks, got = spec_drive(torch, eng, reqs())
            if spec_on:
                spec_divergences(torch, base, eng, streams, got, f"{what}, oracle (timed)")
            turns.append((tok_s, ticks, eng.stats, eng.capture_log))
        st = turns[1][2]
        caps = [ms for kind, ms, _ in turns[1][3] if kind == "verify"]
        print(f"spec phase ({what}, oracle proposer on run A's streams, k {SPEC_K}; {smi}): "
              f"decode tokens/s in turns (plain, spec, spec, plain) "
              + ", ".join(f"{t[0]:.1f}" for t in turns)
              + "; tick p50 ms " + ", ".join(f"{statistics.median(t[1]) * 1e3:.2f}" for t in turns)
              + " over " + ", ".join(str(len(t[1])) for t in turns) + " ticks after the first; "
              f"accept rate {st.spec_accepted_tokens / max(1, st.spec_draft_tokens):.3f} "
              f"({st.spec_accepted_tokens}/{st.spec_draft_tokens}), {st.spec_ticks} spec ticks; "
              f"verify captures {st.verify_captures}, replays {st.verify_replays}, capture + "
              f"instantiation ms " + ", ".join(f"{c:.1f}" for c in caps), flush=True)
        eng = Rows(cfg, params, spec(oracle), device="cuda")
        prof = torch.profiler.profile(activities=acts)
        spec_drive(torch, eng, reqs(), trace=prof)
        kernels, busy_ms, by_name = device_time(prof)
        calls = host_launch_calls(prof)
        p50 = statistics.median(turns[1][1] + turns[2][1])
        print(f"spec phase ({what}): {TRACED_TICKS} replayed spec ticks under torch.profiler: "
              f"device busy {busy_ms / TRACED_TICKS:.2f} ms/tick against the untraced tick p50 "
              f"{p50 * 1e3:.2f} ms; {len(kernels) / TRACED_TICKS:.0f} device kernels/tick; "
              f"{sum(calls.values()) / TRACED_TICKS:.1f} host launch calls/tick", flush=True)
        print_top(by_name, TRACED_TICKS, "tick", 8)
        del base, turns, eng
        torch.cuda.empty_cache()
    return k4_verify


ADMIT_LENS = (17, 60, 100, 1100, 1500)    # buckets 128, 128, 128, 1536, 1536


def admission_phase(torch, cfg, params, sm_count, smi: str):
    """Blocking admission at the reference's bucket length, captured,
    against the eager admission, on paged bf16, int8 and dense engines:
    ``ADMIT_LENS`` admitted twice each into slot 0 (released after each), in
    turns (eager, captured, captured, eager); admission ms per prompt,
    ``prefill_compiles``, admission captures and replays, capture plus
    instantiation ms, the reserved memory the captures grew; the logits of
    every admission equal across the runs, bit for bit. Before it, on bf16
    pages: each prompt's first-token logits at the bucket against prefill at
    its exact length (cuBLAS may take other kernels at another M), printed."""
    import numpy as np

    from repro_torch.models import prefill
    from repro_torch.serving.config import EngineConfig, PagedConfig
    from repro_torch.serving.engine import DecodeEngine, Request

    class Logged(timed(DecodeEngine)):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.admit_logits = []

        def _run_prompt_prefill(self, prompt, slot, pages):
            logits = super()._run_prompt_prefill(prompt, slot, pages)
            self.admit_logits.append(logits.clone())
            return logits

    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in ADMIT_LENS]
    layouts = (("paged bf16", engine_config("lean", sm_count)),
               ("paged int8", engine_config("lean", sm_count, kv_dtype="int8")),
               ("dense", EngineConfig(max_batch=4, cache_len=4096, attn_backend="lean",
                                      num_workers=sm_count, paged=PagedConfig(enabled=False))))
    out = {}
    for label, config in layouts:
        runs = []
        for captured in (False, True, True, False):
            eng = Logged(cfg, params, config, device="cuda")
            eng.capture_decode = captured
            ms = []
            for rnd in range(2):
                for i, p in enumerate(prompts):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    check(eng.admit_blocking(Request(uid=i, prompt=p, max_new_tokens=1), 0),
                          f"admission ({label}): refused")
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                    eng.release_slot(0)
            if eng.paged:
                eng.pool.check(scales=eng._kv_scale_arrays())
            runs.append((eng, ms))
        ref = runs[0][0].admit_logits
        for eng, _ in runs[1:]:
            check(all(torch.equal(a, b) for a, b in zip(ref, eng.admit_logits)),
                  f"admission ({label}): logits differ between eager and captured runs")
        st = runs[1][0].stats
        buckets = sorted(runs[1][0]._prefill_shapes)
        check(st.admit_replays > 0 and st.prefill_compiles == len(buckets) == 2,
              f"admission ({label}): {st.admit_replays} replays, prefill_compiles "
              f"{st.prefill_compiles}, buckets {buckets}")
        log = runs[1][0].capture_log
        print(f"admission phase ({label}; {smi}): prompts {list(ADMIT_LENS)} (buckets "
              f"{buckets}) admitted twice each; ms per admission in turns (eager, captured, "
              f"captured, eager): " + " | ".join(", ".join(f"{t:.1f}" for t in ms)
                                                 for _, ms in runs)
              + f"; prefill_compiles {st.prefill_compiles}; captures {st.admit_captures}, "
              f"replays {st.admit_replays}; capture + instantiation ms "
              + ", ".join(f"{c:.1f}" for _, c, _ in log)
              + f"; reserved memory grown by the captures {sum(b for *_, b in log) / 2**20:.0f} "
              f"MiB; logits of every admission equal across the four runs", flush=True)
        out[label] = runs[1][1]
        if label == "paged bf16":
            gaps = []
            for p, bucketed in zip(prompts, ref):
                exact = prefill(params, cfg, torch.as_tensor(p.astype(np.int64)[None]).cuda(),
                                cache_len=len(p))[0]
                gaps.append(((bucketed - exact).abs().max().item(),
                             int(bucketed.argmax()) == int(exact.argmax())))
            print("admission phase: first-token logits at the bucket against the exact "
                  "length, max |difference| (argmax equal) per prompt: "
                  + ", ".join(f"{d:.4f} ({'yes' if same else 'no'})" for d, same in gaps),
                  flush=True)
        del runs, eng
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------- dense-cache engine
def dense_engine_phase(torch, cfg, params, sm_count, new_tokens, paged):
    """The ``PROMPT_LENS`` requests on the dense-cache engine
    (``PagedConfig(enabled=False)``, the reference's default), on ``lean``
    (K7 admissions, K2 decode) and on ``fixed`` (K7, K6): admission ms per
    prompt, decode tick p50, tokens/s, launches (K7 = layers x prompts
    admitted). The lean run's streams and every decode tick's logits are
    held to the paged lean engine's (``paged``: its streams and logits rows
    on the same requests), with the engine phase's logit tolerance, and a few
    of its decode ticks are traced as the engine phase's are; then one
    tick of the legacy step (``use_fast_path=False``: K1 + merge over a
    schedule built from the host lengths) against the fast path's first
    tick. Between them, the paged and the dense lean engine serve the same
    requests in turns for their tick p50. Returns the lean run's launch
    counts."""
    from repro_torch.serving.config import EngineConfig, PagedConfig
    from repro_torch.serving.engine import DecodeEngine, Request

    L = cfg.n_layers

    def dense_engine(backend, fast=True):
        return DecodeEngine(cfg, params, EngineConfig(
            max_batch=4, cache_len=4096, attn_backend=backend, num_workers=sm_count,
            use_fast_path=fast, paged=PagedConfig(enabled=False)), device="cuda")

    def close(got, ref, what):
        check(bool(torch.isfinite(got).all()), f"dense engine: {what} logits not finite")
        atol = LOGIT_ATOL_FRAC * ref.abs().median().item()
        delta = (got - ref).abs().max().item()
        check(torch.allclose(got, ref, rtol=LOGIT_RTOL, atol=atol),
              f"dense engine: {what} logits differ by up to {delta} (allowed {atol} + "
              f"{LOGIT_RTOL} |ref|)")
        return delta

    lean_counts, lean_first = None, None
    for backend in ("lean", "fixed"):
        eng = dense_engine(backend)
        gb = eng.cache[0]["k"].numel() * 2 * 2 * L / 1e9
        reqs = make_requests(Request, cfg.vocab_size, new_tokens)
        reset_launch_counts()
        admit_ms = []
        for slot, r in enumerate(reqs):
            t0 = time.perf_counter()
            check(eng.admit_blocking(r, slot), "dense engine: admission refused")
            torch.cuda.synchronize()
            admit_ms.append((time.perf_counter() - t0) * 1e3)
        ticks, rows = [], []
        while any(eng.slot_req):
            t0 = time.perf_counter()
            out = eng.decode_tick()
            torch.cuda.synchronize()
            ticks.append((time.perf_counter() - t0, len(out)))
            rows.append(eng.last_logits.clone())
        counts = launch_counts()
        check(all(len(r.generated) == new_tokens for r in reqs),
              f"dense engine ({backend}): a request did not finish")
        decode_k = {"lean": "K2", "fixed": "K6"}[backend]
        check(counts["K7"] == L * eng.stats.prefills == L * len(reqs),
              f"dense engine ({backend}): K7 launched {counts['K7']} times, expected {L} x "
              f"{len(reqs)} admissions")
        check(counts[decode_k] == L * eng.stats.ticks and eng.stats.ticks > 0,
              f"dense engine ({backend}): {decode_k} launched {counts[decode_k]} times, "
              f"expected {L} x {eng.stats.ticks} ticks")
        others = {k: n for k, n in counts.items() if k not in ("K7", decode_k) and n}
        check(not others, f"dense engine ({backend}): other kernels ran: {others}")
        tc = path_counts(f"dense engine ({backend})")
        p50 = statistics.median(dt for dt, _ in ticks[1:])
        tok_s = sum(n for _, n in ticks[1:]) / sum(dt for dt, _ in ticks[1:])
        streams = [list(r.generated) for r in reqs]
        line = (f"dense engine phase ({backend}): {cfg.name} full width, dense cache "
                f"{gb:.2f} GB, {len(reqs)} requests (prompts {list(PROMPT_LENS)}, {new_tokens} "
                f"new tokens each): admission ms per prompt (K7, {tc['K7']} launches on the "
                f"tensor cores) "
                + ", ".join(f"{t:.1f}" for t in admit_ms)
                + f"; decode tick p50 {p50 * 1e3:.2f} ms over {len(ticks) - 1} ticks after the "
                f"first, {tok_s:.1f} tokens/s; launches K7 {counts['K7']} = {L} x "
                f"{len(reqs)}, {decode_k} {counts[decode_k]} = {L} x {eng.stats.ticks}")
        if backend == "lean":
            lean_counts, lean_first = counts, rows[0]
            check(streams == paged["streams"],
                  f"dense and paged lean engines' streams differ: {streams} vs "
                  f"{paged['streams']}")
            check(len(rows) == len(paged["rows"]), "dense and paged lean engines' ticks differ")
            worst = max(close(a, b, "lean tick") for a, b in zip(rows, paged["rows"]))
            same = all(torch.equal(a, b) for a, b in zip(rows, paged["rows"]))
            line += (f"; streams equal to the paged lean engine's, {len(rows)} ticks' logits "
                     f"within {worst:.4f} ({'bit for bit' if same else 'not bit for bit'})")
        print(line, flush=True)
        if backend == "lean":
            traced_ticks(torch, eng, make_requests(Request, cfg.vocab_size, TRACED_TICKS + 6), p50,
                         label="dense traced ticks (lean)")
        del eng
        torch.cuda.empty_cache()

    # tick p50 of the paged and the dense lean engine in turns (paged, dense,
    # dense, paged), so that the two compare on one card and one host state
    turns = []
    for paged_turn in (True, False, False, True):
        eng = (DecodeEngine(cfg, params, engine_config("lean", sm_count), device="cuda")
               if paged_turn else dense_engine("lean"))
        _, ticks, _ = drive(torch, eng, make_requests(Request, cfg.vocab_size, new_tokens))
        turns.append(statistics.median(dt for dt, _ in ticks) * 1e3)
        del eng
        torch.cuda.empty_cache()
    print("decode tick p50 ms in turns (paged, dense, dense, paged), lean: "
          + ", ".join(f"{t:.2f}" for t in turns), flush=True)

    eng = dense_engine("lean", fast=False)
    reqs = make_requests(Request, cfg.vocab_size, new_tokens)
    for slot, r in enumerate(reqs):
        eng.admit_blocking(r, slot)
    reset_launch_counts()
    eng.decode_tick()
    torch.cuda.synchronize()
    counts = launch_counts()
    check(counts["K1"] == L and counts["K2"] == 0,
          f"legacy step: launches {counts}, expected K1 {L} and no K2")
    delta = close(eng.last_logits, lean_first, "legacy tick")
    print(f"dense legacy step (use_fast_path=False, lean): one tick, K1 launches {counts['K1']}, "
          f"logits within {delta:.4f} of the fast path's first tick", flush=True)
    del eng
    torch.cuda.empty_cache()
    return lean_counts


# ------------------------------------------------ row-block kernels, bit for bit
ROW_BITS_CASES = ((128, 128), (200, 128), (16, 64), (12, 96))   # (page, d): one tile each


def row_kernel_outputs(torch, src: str, out: str):
    """The row-block kernels of the ``repro_torch`` under ``src`` -- K4's
    partials, the fused K4 (on int8 pages too where it runs on the tensor
    cores), and K8 and K7 on the CUDA cores and on the tensor cores, as the
    path rule picks -- on seeded inputs at pages that fit one tile (float32
    and bf16; K7 with and without a window), saved to ``out``."""
    from repro_torch.core.attention import quantize_kv_blocks
    from repro_torch.core.leantile import make_chunk_schedule
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import lean_prefill as lp
    from repro_torch.kernels import ops

    check_src(lp, src)
    dev, res = torch.device("cuda"), {}
    Hq, Hkv, offs, C = 32, 8, (300, 5), 100
    for dtype in (torch.float32, torch.bfloat16):
        for page, d in ROW_BITS_CASES:
            gen = torch.Generator(device="cuda")
            gen.manual_seed(page * 1000 + d)
            n_pages = [-(-(o + C) // page) for o in offs]
            W = max(n_pages)
            tbl = torch.zeros(len(offs), W, dtype=torch.int32)
            first = 1
            for n, npg in enumerate(n_pages):
                tbl[n, :npg] = torch.arange(first, first + npg)
                first += npg
            tbl = tbl.to(dev)
            kp = torch.randn(first, Hkv, page, d, generator=gen, device=dev).to(dtype)
            vp = torch.randn(first, Hkv, page, d, generator=gen, device=dev).to(dtype)
            q = torch.randn(len(offs), Hq, C, d, generator=gen, device=dev).to(dtype)
            visible = [o + C for o in offs]
            sched = make_chunk_schedule(visible, Hkv, page, 132, max_len=W * page)
            k_rows, v_rows = ops._pool_rows(kp, vp)
            i32 = lambda xs: torch.tensor([x for x in xs for _ in range(Hkv)], dtype=torch.int32,
                                          device=dev)
            key = f"{dtype} page {page} d {d}"
            cargs = (q.reshape(len(offs) * Hkv, (Hq // Hkv) * C, d).contiguous(), k_rows, v_rows,
                     i32(visible), i32(offs), ops.paged_route(sched, tbl, Hkv), sched,
                     1 / math.sqrt(d), C)
            res["K4 " + key] = [t.cpu() for t in lp.lean_prefill_chunk_partials(*cargs)]
            res["fused K4 " + key] = lp.lean_prefill_fused(*cargs).cpu()
            if fp.tensor_core_path(dtype, d, page):
                (kq, ks), (vq, vs) = quantize_kv_blocks(kp), quantize_kv_blocks(vp)
                kr8, vr8 = ops._pool_rows(kq, vq)
                res["fused K4 int8 " + key] = lp.lean_prefill_fused(
                    cargs[0], kr8, vr8, *cargs[3:], k_scales=ks, v_scales=vs).cpu()
            res["K8 " + key] = fp.flash_prefill_paged(
                q, kp, vp, tbl, torch.tensor(offs, dtype=torch.int32, device=dev)).cpu()
            qd = torch.randn(1, Hq, 700, d, generator=gen, device=dev).to(dtype)
            kd = torch.randn(1, Hkv, 700, d, generator=gen, device=dev).to(dtype)
            for window in (None, 97):
                res[f"K7 window {window} " + key] = fp.flash_prefill(
                    qd, kd, kd, window=window, block_kv=min(page, 128)).cpu()
    torch.cuda.synchronize()
    torch.save(res, out)


def kernel_bits(torch, other_src: str, which: str) -> dict:
    """The row-block (``which`` "row") or decode ("decode") kernels of this
    checkout and of ``other_src`` (one process each) on the same seeded
    inputs: how many outputs are equal bit for bit."""
    outs = []
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    for i, src in enumerate((os.path.join(ROOT, "src"), other_src)):
        out = os.path.join(ROOT, "build", f"{which}_kernel_outputs_{i}.pt")
        subprocess.run([sys.executable, os.path.abspath(__file__), f"--{which}-kernel-outputs",
                        src, out], check=True, stdout=subprocess.DEVNULL)
        outs.append(torch.load(out))
    a, b = outs
    check(sorted(a) == sorted(b), "the two checkouts ran different cases")
    same = lambda x, y: (all(map(torch.equal, x, y)) if isinstance(x, list)
                         else torch.equal(x, y))
    differing = [k for k in sorted(a) if not same(a[k], b[k])]
    return {"compared": len(a), "bit_identical": len(a) - len(differing),
            "differing": differing}


OBS_ROUNDS = 3
OBS_SLO = "interactive"


def obs_phase(torch, cfg, params, sm_count, new_tokens, smi: str):
    """Observability on the card: the lean Scheduler (chunk 256, pack 2,
    budget 512, bf16 pages, every step captured) serving the
    ``PROMPT_LENS`` prompts ``OBS_ROUNDS`` rounds on an engine with every
    ``ObsConfig`` sink -- a ``Tracer``, a ``MetricsRegistry``, a
    ``FlightRecorder`` dumping into a temporary directory, the perf
    watchdog with one SLO class the requests are submitted in -- and on an
    untraced engine of the same configuration; then warm rounds in turns
    (traced, untraced, untraced, traced) and one more warm round of each
    with ``TRACED_TICKS`` of its decode ticks (once no prompt is left to
    prefill) under ``torch.profiler``. Checks: every round's token streams
    equal between the two engines; every warm decode tick that replayed its graph makes 2 host
    launch calls, traced or not; every ``decode_kernel`` span carries
    ``sync_ms`` and the roofline cost meta; ``engine_decode_replays > 0``
    in the Prometheus export read back; no ``retrace_storm`` fires after
    round 2 (a count, not a clock); ``python -m repro_torch.obs report``,
    ``calibrate`` and ``flight`` exit 0 on the saved trace and dump.
    Prints, without gating: the watchdog's fire counts, the traced and
    untraced warm-round walls, and the warm round's measured
    ``decode_kernel`` ms against the roofline's predicted ms on the H100's
    peaks (one layer's attention: the span times the whole decode step)."""
    import dataclasses
    import tempfile

    from repro_torch.obs import (FlightRecorder, MetricsRegistry, SLOConfig, Tracer,
                                 parse_prometheus)
    from repro_torch.roofline.analysis import HBM_BW, PEAK_FLOPS
    from repro_torch.serving.config import ObsConfig
    from repro_torch.serving.engine import DecodeEngine, Request
    from repro_torch.serving.scheduler import RequestState, Scheduler, SchedulerConfig

    class MarkedEngine(DecodeEngine):
        """Marks each decode tick for the profiler; ``replayed`` records
        whether the tick's decode step replayed a graph."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.replayed = []

        def decode_tick(self, exclude=None):
            before = (self.stats.decode_replays, self.stats.step_captures)
            with torch.profiler.record_function(MARKS[1]):
                out = super().decode_tick(exclude)
            self.replayed.append(self.stats.decode_replays == before[0] + 1
                                 and self.stats.step_captures == before[1])
            return out

    prompts = [r.prompt.copy() for r in make_requests(Request, cfg.vocab_size, new_tokens)]
    sched_cfg = SchedulerConfig(chunk_size=SCHED_CHUNK, prefill_pack=SCHED_PACK,
                                token_budget=SCHED_BUDGET, chunked=True)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_obs_")
    flight_dir = os.path.join(tmp.name, "flight")
    base = engine_config("lean", sm_count)
    obs = ObsConfig(tracer=Tracer(), metrics=MetricsRegistry(), flight=FlightRecorder(),
                    flight_dir=flight_dir, watchdog=True)
    runs = {}
    for name, conf in (("traced", dataclasses.replace(base, obs=obs)), ("untraced", base)):
        eng = MarkedEngine(cfg, params, conf, device="cuda")
        if name == "traced":
            eng.watchdog.add_slo(SLOConfig(name=OBS_SLO))
        runs[name] = {"eng": eng, "sch": Scheduler(eng, sched_cfg), "walls": [], "streams": []}

    def serve(name, profiler=None):
        """One round of the prompts, its wall and streams kept; with
        ``profiler``, ``TRACED_TICKS`` steps under it once every request
        left is decoding."""
        run = runs[name]
        eng, sch = run["eng"], run["sch"]
        rnd = len(run["walls"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hs = [sch.submit(p, new_tokens, uid=10 * rnd + i, slo_class=OBS_SLO)
              for i, p in enumerate(prompts)]
        steps0 = sch.stats.steps
        while sch.pending and sch.stats.steps - steps0 < 400:
            if profiler is not None and all(h.done or h.state is RequestState.DECODING
                                            for h in hs):
                with profiler:
                    for _ in range(TRACED_TICKS):
                        sch.step()
                    torch.cuda.synchronize()
                run["profiled"] = eng.replayed[-TRACED_TICKS:]
                profiler = None
                continue
            sch.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(not sch.pending and all(h.done and len(h.generated) == new_tokens for h in hs),
              f"obs phase ({name}): a request did not finish in round {rnd + 1}")
        eng.pool.check()
        check(eng.pool.num_allocated == 0, f"obs phase ({name}): pages leaked")
        run["walls"].append(wall)
        run["streams"].append([list(h.generated) for h in hs])

    tr_eng = runs["traced"]["eng"]
    tracer, wd = tr_eng.tracer, tr_eng.watchdog
    for name in ("traced", "untraced"):
        for _ in range(OBS_ROUNDS):
            serve(name)
    storms = wd.fire_counts()["retrace_storm"]
    tick0 = tracer.tick_index             # the warm rounds' spans come after
    for name in ("traced", "untraced", "untraced", "traced"):
        serve(name)
    warm_ticks = tracer.tick_index - tick0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    calls = {}
    for name in ("traced", "untraced"):
        prof = torch.profiler.profile(activities=acts)
        serve(name, prof)
        per_tick = launches_in_marks(prof, MARKS[1])
        check(len(per_tick) == TRACED_TICKS,
              f"obs phase ({name}): {len(per_tick)} marked decode ticks profiled, expected "
              f"{TRACED_TICKS}")
        replayed = [c for c, r in zip(per_tick, runs[name]["profiled"]) if r]
        check(replayed and all(c == 2 for c in replayed),
              f"obs phase ({name}): warm replayed decode ticks made host launch calls "
              f"{sorted(set(replayed))}, expected 2 each")
        calls[name] = (len(replayed), sorted(set(replayed)))
    t, u = runs["traced"], runs["untraced"]
    check(t["streams"] == u["streams"], "obs phase: traced and untraced token streams differ")
    check(wd.fire_counts()["retrace_storm"] == storms,
          f"obs phase: retrace_storm fired in a warm round ({wd.fire_counts()})")

    # the spans: every decode_kernel span synced and costed
    dks = [sp for sp in tracer.spans if sp["name"] == "decode_kernel"]
    need = ("path", "kv_bytes", "flops", "pred_mem_ms", "pred_compute_ms", "total_tiles")
    bad = [sp for sp in dks if "sync_ms" not in sp or any(k not in sp.get("meta", {})
                                                          for k in need)]
    check(dks and not bad, f"obs phase: {len(bad)} of {len(dks)} decode_kernel spans lack "
          f"sync_ms or the cost meta")
    prom = parse_prometheus(tr_eng.metrics.to_prometheus())
    replays = prom.get(("engine_decode_replays", ()), 0)
    check(replays > 0 and replays == tr_eng.stats.decode_replays,
          f"obs phase: engine_decode_replays exported as {replays}")
    # the warm rounds (in turns) of the traced engine: measured decode_kernel
    # ms against the roofline's prediction on the H100's peaks
    warm = [sp for sp in dks if tick0 < sp["tick"] <= tick0 + warm_ticks]
    meas = sum(sp["ms"] for sp in warm)
    sync = sum(sp["sync_ms"] for sp in warm)
    pred = sum(sp["meta"]["pred_mem_ms"] + sp["meta"]["pred_compute_ms"] for sp in warm)
    kv_mb = sum(sp["meta"]["kv_bytes"] for sp in warm) / len(warm) / 1e6

    # the CLI on the saved trace and a flight dump
    trace_path = os.path.join(tmp.name, "trace.json")
    tracer.save(trace_path, extra={"metrics": tr_eng.metrics.as_dict(), "watchdog": wd.as_dict()})
    tr_eng._flight_dump("chip-smoke")
    dump = tr_eng.flight.last_dump_path
    check(dump is not None and os.path.exists(dump), "obs phase: the flight dump was not written")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cli = {}
    for cmd in (["report", trace_path], ["calibrate", trace_path, "--out",
                                         os.path.join(tmp.name, "calib.json")],
                ["flight", dump]):
        out = subprocess.run([sys.executable, "-m", "repro_torch.obs", *cmd], capture_output=True,
                             text=True, timeout=300, env=env, cwd=ROOT)
        check(out.returncode == 0, f"obs phase: python -m repro_torch.obs {cmd[0]} exited "
              f"{out.returncode}: {out.stderr[-2000:]}")
        cli[cmd[0]] = out.stdout
    roofline = [ln.strip() for ln in cli["report"].splitlines() if "roofline bound" in ln]
    factors = [ln.strip() for ln in cli["calibrate"].splitlines() if "factor" in ln]
    budget = tr_eng.watchdog.budgets[OBS_SLO].as_dict()
    print(f"obs phase ({smi}): lean Scheduler, {OBS_ROUNDS} rounds then warm rounds in turns "
          f"(traced, untraced, untraced, traced) and one partly profiled round each; wall s per "
          f"round "
          f"traced {', '.join(f'{w:.3f}' for w in t['walls'])}, untraced "
          f"{', '.join(f'{w:.3f}' for w in u['walls'])}; warm rounds traced / untraced "
          f"{statistics.mean(t['walls'][OBS_ROUNDS:OBS_ROUNDS + 2]):.3f} / "
          f"{statistics.mean(u['walls'][OBS_ROUNDS:OBS_ROUNDS + 2]):.3f} s; streams equal; "
          f"host launch calls per replayed warm decode tick: traced {calls['traced'][1]} over "
          f"{calls['traced'][0]} ticks, untraced {calls['untraced'][1]} over "
          f"{calls['untraced'][0]}; {len(tracer.spans)} spans, {len(dks)} decode_kernel spans "
          f"all synced and costed; engine_decode_replays {replays:.0f} "
          f"(captures {tr_eng.stats.decode_captures})", flush=True)
    print(f"obs phase: warm rounds' decode_kernel spans ({len(warm)} over {warm_ticks} ticks): "
          f"measured {meas:.2f} ms (of it {sync:.2f} ms waiting in the stream sync), "
          f"{meas / len(warm):.3f} ms a tick; roofline prediction on the H100's peaks "
          f"({PEAK_FLOPS / 1e12:.0f} TFLOP/s, {HBM_BW / 1e12:.2f} TB/s) {pred:.5f} ms "
          f"({kv_mb:.2f} MB of K/V a tick, one layer's attention): measured / predicted "
          f"{meas / pred:.1f}; against {cfg.n_layers} layers' attention "
          f"{meas / (pred * cfg.n_layers):.2f}", flush=True)
    print(f"obs phase: watchdog fire counts {wd.fire_counts()} over {wd.ticks} ticks "
          f"(tick_spike reads the host clock; retrace_storm {storms} in rounds 1-{OBS_ROUNDS}, "
          f"none after); SLO {OBS_SLO!r} (TTFT {budget['ttft_target_s']} s, TPOT "
          f"{budget['tpot_target_s']} s): {budget['events']} observations, "
          f"{budget['breaches']} breaches {budget['breach_kinds']}; flight dumps "
          f"{tr_eng.flight.dumps}; report: {'; '.join(roofline)}; calibrate: "
          f"{'; '.join(factors)}", flush=True)
    tmp.cleanup()
    for run in runs.values():
        del run["eng"], run["sch"]
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ guards
GUARD_VICTIM, GUARD_VICTIM_TILE, GUARD_RECYCLE = 1, 2, 3   # slots of PROMPT_LENS; a full page
GUARD_NEAR_TIE = 0.0625          # the bf16 step of a logit near 8 (PR 21's divergence rule)
GUARD_FAULT_STOP = 14            # injector tick (of wave 2) the chaos run's faults stop at
GUARD_TICKS = 10                 # timed replays per measured pass


def guard_specs(FaultSpec) -> dict:
    """The chaos run's fixed-seed fault schedule over injector ticks, which
    count wave 2's decode ticks (``[start, GUARD_FAULT_STOP)``): in the
    fault-free run the continuation's first chunk copies the shared page
    before tick 1 (``cow_clone``), four slots decode from tick 4 to 15, one
    or two to 30."""
    stop = GUARD_FAULT_STOP
    return {"nan_output": FaultSpec(rate=0.25, start=3, stop=stop),
            "nan_kv": FaultSpec(rate=1.0, start=5, stop=stop, max_fires=1),
            "page_alloc": FaultSpec(rate=0.15, start=1, stop=stop, burst=2),
            "cow_clone": FaultSpec(rate=1.0, start=0, stop=stop, max_fires=2),
            "trie_corrupt": FaultSpec(rate=0.3, start=1, stop=stop),
            "preempt_storm": FaultSpec(rate=1.0, start=12, stop=stop, max_fires=1, magnitude=1)}


def guarded_config(sm_count, kv_dtype=None, **change):
    import dataclasses

    from repro_torch.serving.guards import GuardConfig

    change.setdefault("guards", GuardConfig())
    return dataclasses.replace(engine_config("lean", sm_count, kv_dtype=kv_dtype), **change)


def page_rows(torch, eng, page: int) -> list:
    """Copies of page ``page`` of every pool (int8: and its scales)."""
    return [{name: t[page].clone() for name, t in lc.items()} for lc in eng.cache]


def restore_page(eng, page: int, rows: list):
    for lc, saved in zip(eng.cache, rows):
        for name, t in lc.items():
            t[page].copy_(saved[name])


def nan_isolation(torch, eng, level, slots, victim, tile, recycle, captured, what):
    """One pass at ``level`` over ``slots`` three times: on the untouched
    pools; with logical tile ``tile`` of ``victim`` (a private full page)
    filled with NaN by ``_fill_page`` -- the victim's row must be
    non-finite, every other row bit-identical to the untouched pass; then
    with that page zero-scrubbed and handed to ``recycle`` as the page its
    next token is written into (its rows there copied in, the rest the
    scrub's zeros) -- every row finite, the recycler's bit-identical.
    ``captured``: the untouched pass also serves as the key's warm-up and
    capture, and the three compared passes replay one graph. The pages
    touched (and the victim's last page, where its NaN pass wrote its
    token, on int8 into the page's scale) are restored after."""
    eng.capture_decode = captured
    replays0 = eng.stats.decode_replays

    def run():
        return eng._decode_pass(level, slots, slots, set()).float()

    clean = run()
    if captured:
        clean = run()
    page = int(eng.page_tbl[victim, tile])
    last = int(eng.page_tbl[victim, int(eng.ctx_lens[victim]) // eng.tile])
    rt = int(eng.ctx_lens[recycle]) // eng.tile
    own, n = int(eng.page_tbl[recycle, rt]), int(eng.ctx_lens[recycle]) - rt * eng.tile
    check(len({page, last, own}) == 3 and rt not in eng._slot_shared_tiles[recycle],
          f"{what}: pages {page}, {last}, {own}")
    saved = {p: page_rows(torch, eng, p) for p in (page, last)}
    eng._fill_page(page, float("nan"))
    bad = run()
    check(not bool(torch.isfinite(bad[victim]).all()),
          f"{what}: the victim's row is finite over a NaN page")
    for s in slots:
        check(s == victim or torch.equal(bad[s], clean[s]),
              f"{what}: slot {s}'s row moved when slot {victim}'s page held NaN")
    restore_page(eng, last, saved[last])
    eng._fill_page(page, 0.0)
    for lc in eng.cache:
        for name, t in lc.items():
            if name.endswith("scale"):
                t[page].copy_(t[own])
            else:
                t[page][:, :n].copy_(t[own][:, :n])
    eng.page_tbl[recycle, rt] = page
    rec = run()
    eng.page_tbl[recycle, rt] = own
    for p, rows in saved.items():
        restore_page(eng, p, rows)
    check(bool(torch.isfinite(rec[slots]).all()), f"{what}: a row is not finite over a "
          "zero-scrubbed recycled page")
    check(torch.equal(rec[recycle], clean[recycle]),
          f"{what}: the recycling slot's row moved on the scrubbed page")
    if captured:
        check(eng.stats.decode_replays - replays0 >= 3, f"{what}: the passes did not replay")
    eng.capture_decode = True


def isolation_engine(torch, cfg, params, sm_count, kv_dtype):
    """A guarded engine serving the ``PROMPT_LENS`` prompts (blocking
    admission, one decode tick), long enough that none finishes."""
    from repro_torch.serving.engine import DecodeEngine, Request

    eng = DecodeEngine(cfg, params, guarded_config(sm_count, kv_dtype), device="cuda")
    for r in make_requests(Request, cfg.vocab_size, 1000):
        eng.submit(r)
    eng.tick()
    check(all(r is not None for r in eng.slot_req), "guards phase: a slot is idle")
    return eng


def cascade_isolation_engine(torch, cfg, params, sm_count, kv_dtype):
    """The prefix waves on a guarded engine with the radix cache and the
    cascade (``stable_ticks`` 1): wave 1 served, wave 2 prefilled until its
    four requests all decode, every slot sharing the system prompt."""
    from repro_torch.serving.config import CascadeConfig, PagedConfig
    from repro_torch.serving.engine import DecodeEngine
    from repro_torch.serving.scheduler import RequestState, Scheduler, SchedulerConfig

    conf = guarded_config(sm_count, kv_dtype, cascade=CascadeConfig(enabled=True, stable_ticks=1),
                          paged=PagedConfig(enabled=True, page_size=128, prefix_cache=True,
                                            kv_dtype=kv_dtype))
    eng = DecodeEngine(cfg, params, conf, device="cuda")
    sch = Scheduler(eng, SchedulerConfig(chunk_size=SCHED_CHUNK, prefill_pack=SCHED_PACK,
                                         token_budget=SCHED_BUDGET, chunked=True))
    w1, w2 = prefix_waves(cfg.vocab_size)
    sch.submit(w1[0], 4)
    sch.run_to_completion(max_steps=200)
    hs = [sch.submit(p, 1000) for p in w2]
    for _ in range(200):
        if all(h.state is RequestState.DECODING for h in hs):
            break
        sch.step()
    check(all(h.state is RequestState.DECODING for h in hs), "guards phase: wave 2 not decoding")
    return eng, sch


def guard_isolation(torch, cfg, params, sm_count, kv_dtype, level_times: bool):
    """NaN isolation at levels 0-3 and under the cascade (K5), eager and
    captured, on one pool dtype; with ``level_times`` also each level's
    captured pass with one degraded slot, the poison recovery and the
    audit's time. Returns the measurements."""
    tag = kv_dtype or "bf16"
    out = {}
    eng = isolation_engine(torch, cfg, params, sm_count, kv_dtype)
    slots = list(range(eng.max_batch))
    for level in range(4):
        for captured in (False, True):
            nan_isolation(torch, eng, level, slots, GUARD_VICTIM, GUARD_VICTIM_TILE, GUARD_RECYCLE,
                          captured, f"guards isolation ({tag}, level {level}, "
                          f"{'captured' if captured else 'eager'})")
    # one audit (audit_interval 1): pool.check with the int8 scales copied out
    eng.guard_cfg.audit_interval = 1
    ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._run_audits()
        ms.append((time.perf_counter() - t0) * 1e3)
    eng.guard_cfg.audit_interval = 0
    out["audit_ms"] = statistics.median(ms)
    check(eng.stats.audit_failures == 0, f"guards phase ({tag}): an audit failed")
    if level_times:
        others = [s for s in slots if s != GUARD_VICTIM]

        def pass_ms(level, members):
            for _ in range(3):              # warm-up, capture, replay
                eng._decode_pass(level, members, slots, set())
            ts = []
            for _ in range(GUARD_TICKS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng._decode_pass(level, members, slots, set())
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(ts)

        out["pass_ms"] = {"full": pass_ms(0, slots), "healthy 3": pass_ms(0, others),
                          **{f"level {lv}": pass_ms(lv, [GUARD_VICTIM]) for lv in (1, 2, 3)}}
        # a poison's recovery: scrub + requeue, then the recompute (blocking
        # admission of prompt + generated) to the slot's next token
        req = eng.slot_req[GUARD_VICTIM]
        n0 = len(req.generated)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._poison_slot(GUARD_VICTIM)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        eng._admit()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        check(eng.slot_req[GUARD_VICTIM] is req and len(req.generated) == n0 + 1,
              "guards phase: the poisoned request did not recompute its next token")
        check(eng.stats.poisoned_slots == 1 and eng.stats.preemptions == 1,
              "guards phase: poison counters")
        out["poison_ms"] = ((t1 - t0) * 1e3, (t2 - t1) * 1e3, len(req.prompt))
    del eng
    ceng, sch = cascade_isolation_engine(torch, cfg, params, sm_count, kv_dtype)
    slots = list(range(ceng.max_batch))
    victim = next(s for s in slots if any(
        t not in ceng._slot_shared_tiles[s] and (t + 1) * ceng.tile <= ceng.ctx_lens[s]
        for t in range(ceng.pages_per_slot)))
    tile = next(t for t in range(ceng.pages_per_slot) if t not in ceng._slot_shared_tiles[victim]
                and (t + 1) * ceng.tile <= ceng.ctx_lens[victim])
    recycle = next(s for s in slots if s != victim
                   and int(ceng.ctx_lens[s]) // ceng.tile not in ceng._slot_shared_tiles[s])
    casc0 = ceng.stats.cascade_ticks
    for captured in (False, True):
        nan_isolation(torch, ceng, 0, slots, victim, tile, recycle, captured,
                      f"guards isolation ({tag}, cascade, {'captured' if captured else 'eager'})")
    n_casc = ceng.stats.cascade_ticks - casc0
    check(n_casc == 7, f"guards phase ({tag}): {n_casc} of 7 cascade passes ran the cascade")
    out["cascade"] = (victim, tile, recycle)
    del ceng, sch
    return out


def guard_cost(torch, cfg, params, sm_count, new_tokens):
    """The captured decode tick of a guarded, fault-free engine (audits off)
    against an unguarded one, in turns (unguarded, guarded, guarded,
    unguarded): tick p50 and tokens; then ``TRACED_TICKS`` warm ticks of
    each under ``torch.profiler``: host launch calls per replayed tick."""
    from repro_torch.serving.engine import DecodeEngine, Request

    class Marked(DecodeEngine):
        def decode_tick(self, exclude=None):
            before = (self.stats.decode_replays, self.stats.step_captures)
            with torch.profiler.record_function(MARKS[1]):
                out = super().decode_tick(exclude)
            self.replayed = (self.stats.decode_replays == before[0] + 1
                             and self.stats.step_captures == before[1])
            return out

    confs = {"unguarded": engine_config("lean", sm_count),
             "guarded": guarded_config(sm_count)}
    p50, streams, calls = {}, {}, {}
    for name in ("unguarded", "guarded", "guarded", "unguarded"):
        eng = Marked(cfg, params, confs[name], device="cuda")
        reqs = make_requests(Request, cfg.vocab_size, new_tokens)
        _, ticks, _ = drive(torch, eng, reqs)
        p50.setdefault(name, []).append(statistics.median(dt for dt, _ in ticks) * 1e3)
        streams.setdefault(name, [list(r.generated) for r in reqs])
        if name in calls:
            continue
        for r in make_requests(Request, cfg.vocab_size, new_tokens):
            eng.submit(r)
        for _ in range(3):              # admission, then warm replayed ticks
            eng.tick()
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA])
        replayed = []
        with prof:
            for _ in range(TRACED_TICKS):
                eng.tick()
                replayed.append(eng.replayed)
            torch.cuda.synchronize()
        per_tick = launches_in_marks(prof, MARKS[1])
        check(len(per_tick) == TRACED_TICKS and any(replayed),
              f"guard cost ({name}): {len(per_tick)} marked ticks, replayed {replayed}")
        calls[name] = sorted({c for c, r in zip(per_tick, replayed) if r})
        check(eng.stats.nan_ticks == 0 and eng.degraded_gauge.value == 0,
              f"guard cost ({name}): a healthy engine tripped its guard")
        del eng
    check(streams["guarded"] == streams["unguarded"],
          "guard cost: the guarded engine's streams differ from the unguarded one's")
    return {"p50": p50, "calls": calls}


def guard_chaos_run(torch, cfg, params, sm_count, new_tokens, kv_dtype, faults):
    """The prefix waves through the lean Scheduler on a guarded engine (radix
    cache, cascade, ``audit_interval`` 4 with repair, the watchdog on):
    wave 1 (the donor) fault-free, then an exact continuation of its chain
    and wave 2 under ``faults`` (an injector, or None for the fault-free
    run); then quiesced (faults stopped, 8 idle ticks). Records each request's
    first-token and decode logits rows (one pass a tick when nothing is
    degraded), the requests a fault touched (a non-finite row, a
    preemption), launches, captures and the wall."""
    import numpy as np

    from repro_torch.serving.config import CascadeConfig, ObsConfig, PagedConfig
    from repro_torch.serving.engine import DecodeEngine
    from repro_torch.serving.guards import GuardConfig
    from repro_torch.serving.scheduler import Scheduler, SchedulerConfig

    class Chaos(DecodeEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.first_rows, self.rows, self.touched = {}, {}, set()

        def prefill_chunks_tick(self, work, pack_width, chunk_cap):
            toks = super().prefill_chunks_tick(work, pack_width, chunk_cap)
            for i, (slot, chunk, off) in enumerate(work):
                req = self.slot_req[slot]
                if off + len(chunk) == len(req.prompt):
                    self.first_rows[(req.uid, len(req.generated))] = \
                        self.last_prefill_logits[i].float()
            return toks

        def _emit_tokens(self, results, guard_on, spec=None):
            if len(results) == 1:
                for s in results[0][0]:
                    req = self.slot_req[s]
                    self.rows[(req.uid, len(req.generated))] = self.last_logits[s].float()
            return super()._emit_tokens(results, guard_on, spec)

        def _on_bad_slot(self, s):
            self.touched.add(self.slot_req[s].uid)
            super()._on_bad_slot(s)

        def _preempt(self, slot):
            self.touched.add(self.slot_req[slot].uid)
            super()._preempt(slot)

    conf = guarded_config(
        sm_count, kv_dtype, faults=faults,
        guards=GuardConfig(heal_after=2, audit_interval=4, audit_action="repair"),
        cascade=CascadeConfig(enabled=True, stable_ticks=2), obs=ObsConfig(watchdog=True),
        paged=PagedConfig(enabled=True, page_size=128, prefix_cache=True, kv_dtype=kv_dtype))
    eng = Chaos(cfg, params, conf, device="cuda")
    sch = Scheduler(eng, SchedulerConfig(chunk_size=SCHED_CHUNK, prefill_pack=SCHED_PACK,
                                         token_budget=SCHED_BUDGET, chunked=True, retry_backoff=1,
                                         deadline_steps=400, max_preemptions=30))
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w1, w2 = prefix_waves(cfg.vocab_size)
    if faults is not None:
        faults.enabled = False          # the donor wave runs fault-free
    donor = sch.submit(w1[0], new_tokens, uid=0)
    sch.run_to_completion(max_steps=800)
    if faults is not None:
        faults.enabled = True
    # an exact continuation of the donated chain shares its partial last
    # page, so its first chunk copies it first (the cow_clone point)
    cont = np.concatenate([w1[0], np.asarray(donor.generated, np.int32),
                           np.random.default_rng(7).integers(0, cfg.vocab_size, 5)])
    prompts = {i: [int(t) for t in p] for i, p in enumerate(w1 + [cont] + w2)}
    handles = [donor] + [sch.submit(p, new_tokens, uid=1 + i) for i, p in enumerate([cont] + w2)]
    sch.run_to_completion(max_steps=800)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tag = f"guards chaos ({kv_dtype or 'bf16'}, {'faults' if faults else 'fault-free'})"
    check(all(h.done and len(h.generated) == new_tokens for h in handles),
          f"{tag}: a request did not finish: {[(h.uid, h.state.value) for h in handles]}")
    counts = launch_counts()
    path_counts(tag)
    if faults is not None:
        faults.stop_all()
    for _ in range(8):
        eng.tick()
    eng.pool.check(scales=eng._kv_scale_arrays())
    eng.prefix_cache.check()
    check(eng.pool.num_allocated == eng.prefix_cache.cached_pages,
          f"{tag}: {eng.pool.num_allocated} pages held, the radix cache holds "
          f"{eng.prefix_cache.cached_pages}")
    check(eng.degraded_gauge.value == 0, f"{tag}: the degraded gauge ended at "
          f"{eng.degraded_gauge.value}")
    st = eng.stats
    return {"eng": eng, "streams": {h.uid: list(h.generated) for h in handles}, "wall": wall,
            "prompts": prompts,
            "counts": counts, "captures": st.step_captures,
            "stats": {k: getattr(st, k) for k in (
                "nan_ticks", "degrade_escalations", "degrade_heals", "poisoned_slots",
                "preemptions", "audits_run", "audit_failures", "audit_repairs",
                "donation_aborts", "cascade_ticks")},
            "retrace_storms": eng.watchdog.fire_counts()["retrace_storm"],
            "scheduler_poisoned": sch.stats.poisoned}


def guard_chaos(torch, cfg, params, sm_count, new_tokens, kv_dtype):
    """The fixed-seed chaos run against the fault-free one on one pool
    dtype: contracts checked in each run; the requests no fault touched
    keep the fault-free streams, or diverge only at a near tie of the
    fault-free logits (top-2 gap <= ``GUARD_NEAR_TIE``)."""
    from repro_torch.serving.faults import FaultInjector, FaultSpec

    base = guard_chaos_run(torch, cfg, params, sm_count, new_tokens, kv_dtype, None)
    inj = FaultInjector(guard_specs(FaultSpec), seed=23)
    run = guard_chaos_run(torch, cfg, params, sm_count, new_tokens, kv_dtype, inj)
    tag = kv_dtype or "bf16"
    fires = {p: v["fires"] for p, v in inj.as_dict()["points"].items()}
    check(all(fires.values()), f"guards chaos ({tag}): a point never fired: {fires}")
    st = run["stats"]
    check(st["poisoned_slots"] >= 1 and st["degrade_heals"] >= 1 and st["audit_repairs"] >= 1,
          f"guards chaos ({tag}): no poison, heal or repair: {st}")
    # the poisoned slot rode the chain: a level-1 pass (K2) and a level-2 one (K1)
    check(run["counts"]["K1"] >= cfg.n_layers and run["counts"]["K2"] > 0,
          f"guards chaos ({tag}): launches {run['counts']}")
    # a continuation of a donor whose stream differs continues another chain
    touched = run["eng"].touched | {uid for uid in base["prompts"]
                                    if base["prompts"][uid] != run["prompts"][uid]}
    equal, gaps = 0, []
    for uid, want in base["streams"].items():
        if uid in touched:
            continue
        got = run["streams"][uid]
        if got == want:
            equal += 1
            continue
        k = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        row = base["eng"].rows.get((uid, k), base["eng"].first_rows.get((uid, k)))
        check(row is not None, f"guards chaos ({tag}): no fault-free row at request {uid} "
              f"token {k}")
        top = torch.topk(row, 2).values
        gap = float(top[0] - top[1])
        gaps.append((uid, k, gap))
        check(gap <= GUARD_NEAR_TIE, f"guards chaos ({tag}): untouched request {uid} diverges "
              f"at token {k} with a top-2 gap of {gap} > {GUARD_NEAR_TIE}")
    out = {"fires": fires, "stats": st, "touched": sorted(touched), "equal": equal,
           "untouched": len(base["streams"]) - len(touched), "gaps": gaps,
           "extra_captures": run["captures"] - base["captures"],
           "walls": (base["wall"], run["wall"]), "counts": run["counts"],
           "storms": (base["retrace_storms"], run["retrace_storms"]),
           "scheduler_poisoned": run["scheduler_poisoned"]}
    del base["eng"], run["eng"]
    return out


def watchdog_degrade(torch, cfg, params, sm_count):
    """``WatchConfig(degrade_on_collapse=True)`` on a traced guarded engine
    with a calibration that puts every tick out of band: the occupancy
    detector fires once and calls ``force_degrade(cause="watchdog")``; the
    cause counter, the flight event and the heal back to 0 are checked."""
    from repro_torch.obs import Tracer
    from repro_torch.obs.calib import Calibration
    from repro_torch.obs.watch import PerfWatchdog, WatchConfig
    from repro_torch.serving.config import ObsConfig
    from repro_torch.serving.engine import DecodeEngine, Request

    eng = DecodeEngine(cfg, params, guarded_config(sm_count, obs=ObsConfig(tracer=Tracer())),
                       device="cuda")
    wd = PerfWatchdog(eng, WatchConfig(degrade_on_collapse=True, warmup_ticks=0,
                                       occupancy_consecutive=2, cooldown_ticks=10_000),
                      calibration=Calibration(default=1e-9))
    check(eng.watchdog is wd, "watchdog phase: the watchdog did not attach")
    reqs = make_requests(Request, cfg.vocab_size, 12)
    drive(torch, eng, reqs)
    moved = eng._degrade_cause.labels(cause="watchdog").value
    events = [e for e in eng.flight.events() if e["kind"] == "degrade"]
    check(wd.fire_counts()["occupancy_collapse"] == 1 and moved == len(reqs),
          f"watchdog phase: {wd.fire_counts()['occupancy_collapse']} collapse fires, "
          f"{moved} slots degraded by the watchdog")
    check(len(events) == moved and all(e["cause"] == "watchdog" for e in events),
          f"watchdog phase: degrade events {events}")
    check(eng.stats.degrade_heals >= moved and eng.degraded_gauge.value == 0
          and eng.degraded_gauge.peak == len(reqs),
          f"watchdog phase: heals {eng.stats.degrade_heals}, gauge {eng.degraded_gauge.value} "
          f"(peak {eng.degraded_gauge.peak})")
    return {"moved": moved, "heals": eng.stats.degrade_heals, "peak": eng.degraded_gauge.peak}


def guards_phase(torch, cfg, params, sm_count, new_tokens, smi: str):
    """Guards and fault injection at full width (lean, pages of 128, one
    stream-K worker per SM): NaN isolation at levels 0-3 and the cascade,
    eager and captured, bf16 and int8; the guard's cost on a captured tick;
    each level's captured pass with one degraded slot, a poison's recovery
    and an audit; the fixed-seed chaos run under the Scheduler with prefix
    sharing, bf16 and int8, against a fault-free run; the watchdog's
    degrade. Returns the chaos run's launches (bf16)."""
    t0 = time.perf_counter()
    iso = {dt: guard_isolation(torch, cfg, params, sm_count, dt, level_times=dt is None)
           for dt in (None, "int8")}
    print(f"guards phase ({smi}): NaN isolation holds at levels 0-3 and under the cascade "
          f"(K5), eager and captured, bf16 and int8: the victim's row non-finite, every other "
          f"row bit-identical, a zero-scrubbed recycled page finite (cascade victim, tile, "
          f"recycler: bf16 {iso[None]['cascade']}, int8 {iso['int8']['cascade']}); one audit "
          f"{iso[None]['audit_ms']:.3f} ms bf16, {iso['int8']['audit_ms']:.3f} ms int8 "
          f"({2 * cfg.n_layers} scale arrays copied)", flush=True)
    pm = iso[None]["pass_ms"]
    scrub, recompute, plen = iso[None]["poison_ms"]
    print(f"guards phase: captured pass ms (bf16, p50 of {GUARD_TICKS}): all 4 slots at level "
          f"0 {pm['full']:.3f}; one degraded slot: the 3 healthy at level 0 "
          f"{pm['healthy 3']:.3f}, the victim at level 1 {pm['level 1']:.3f}, level 2 "
          f"{pm['level 2']:.3f}, level 3 {pm['level 3']:.3f}; a poison's recovery: scrub + "
          f"requeue {scrub:.3f} ms, recompute ({plen}-token prompt) to the next token "
          f"{recompute:.3f} ms", flush=True)
    cost = guard_cost(torch, cfg, params, sm_count, new_tokens)
    print(f"guards phase: decode tick p50 ms in turns (unguarded, guarded, guarded, "
          f"unguarded): {cost['p50']['unguarded'][0]:.3f}, {cost['p50']['guarded'][0]:.3f}, "
          f"{cost['p50']['guarded'][1]:.3f}, {cost['p50']['unguarded'][1]:.3f}; host launch "
          f"calls per replayed tick: unguarded {cost['calls']['unguarded']}, guarded "
          f"{cost['calls']['guarded']}; streams equal", flush=True)
    chaos = {}
    for dt in (None, "int8"):
        c = chaos[dt] = guard_chaos(torch, cfg, params, sm_count, new_tokens, dt)
        print(f"guards chaos ({dt or 'bf16'}): fires {c['fires']} (stopped at injector tick "
              f"{GUARD_FAULT_STOP}); {c['stats']}; scheduler poisoned {c['scheduler_poisoned']}; "
              f"touched requests {c['touched']}, untouched streams equal to the fault-free run "
              f"{c['equal']}/{c['untouched']}, divergences (uid, token, top-2 gap) {c['gaps']}; "
              f"extra captures {c['extra_captures']}; retrace_storm fires fault-free / chaos "
              f"{c['storms']}; wall fault-free {c['walls'][0]:.2f} s, chaos "
              f"{c['walls'][1]:.2f} s; launches {c['counts']}; every request finished, pool "
              f"clean and drained to the radix cache's pages, trie clean, gauge 0", flush=True)
    wd = watchdog_degrade(torch, cfg, params, sm_count)
    print(f"guards phase: watchdog occupancy_collapse -> force_degrade(cause='watchdog'): "
          f"{wd['moved']} slots, cause counter {wd['moved']}, flight events cause 'watchdog', "
          f"heals {wd['heals']}, gauge peak {wd['peak']} back to 0; phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return chaos[None]["counts"]


# ------------------------------------------- attention-family architectures
# the geometries the attention-family configurations give the kernels:
# arch -> (Hq, Hkv, d); K4 and K8 run only where chunked prefill does
ARCH_GEOMETRY = {
    "qwen3-moe-30b-a3b": (32, 4, 128),
    "nemotron-4-15b": (48, 8, 128),
    "qwen2-moe-a2.7b": (16, 16, 128),
    "musicgen-large": (32, 32, 64),
    "gemma3-4b": (16, 4, 256),
}
ARCH_CHUNKED = ("qwen3-moe-30b-a3b", "nemotron-4-15b", "qwen2-moe-a2.7b")
# the geometries whose runs launch K7 (blocking admission: qwen3's spec run,
# gemma3, musicgen), K6 and K8 (a fixed run: qwen3, gemma3) and K5 (a
# cascade: qwen3's prefix-sharing run); a kernel is timed only at those
ARCH_K7 = ("qwen3-moe-30b-a3b", "gemma3-4b", "musicgen-large")
ARCH_FIXED = ("qwen3-moe-30b-a3b", "gemma3-4b")
ARCH_CASCADE = ("qwen3-moe-30b-a3b",)
# the stream rule of the architecture phases: a stream may leave the ref
# backend's only where the ref run's top-2 logit gap is below this (the
# guards phase's rule, GUARD_NEAR_TIE), or below the largest difference of
# the two runs' rows for the same token before the divergence. A MoE
# model's streams against ref are not held to it: where a row's k-th and
# (k+1)-th router probabilities lie within the backends' rounding of each
# other, the two runs route it to different experts, which moves its logits
# by far more than a near tie. They are held instead by what that cause
# predicts: lean equals fixed (other kernels, the same near-tie rule), the
# first-token logits of lean and ref stay within QWEN3_FIRST_LOGIT_GAP, and
# router_witness finds the first flipped rows and holds their MoE inputs to
# ROUTER_WITNESS_REL of each other (a kernel fault would part them first)
ARCH_NEAR_TIE = GUARD_NEAR_TIE
# bounds set from the measured runs (NVIDIA H100 80GB HBM3, 700.00 W)
QWEN3_FIRST_LOGIT_GAP = 8.0          # measured 5.2812 on lean and fixed
ROUTER_WITNESS_REL = 2.0 ** -5       # 8 bf16 steps; measured 1.28e-3 (chunk), 8.32e-3 (decode)
ARCH_NEW_TOKENS = 8
QWEN3_PROMPTS = (1200, 300, 17)
QWEN3_BITS_PROMPTS = (300, 17)
GEMMA_PROMPTS = (16000, 3000, 1200)        # past the 1024 window; the global layers see 16k
SWEEP_PROMPTS = (700, 130, 17)


def arch_name(kernel: str, arch: str) -> str:
    Hq, Hkv, d = ARCH_GEOMETRY[arch]
    return f"{kernel}@{arch} (gq {Hq // Hkv}, d {d})"


def arch_kernel_phase(torch, sm_count: int, dev_name: str) -> dict:
    """K2 (bf16, the ragged decode batch of the kernel phase on pages of
    128), the fused K4 and K8 (the two-chunk pack of the prefill kernel
    phase) and K7 (a 3000-token prompt, causal, and for gemma3 also its
    1024-key window) at each attention-family geometry (``ARCH_GEOMETRY``),
    K6 on K2's batch where a fixed run decodes (``ARCH_FIXED``: gq 8 at d
    128, gq 4 at d 256) and K5 on a 2048-token prefix shared by four
    sequences where a cascade runs (``ARCH_CASCADE``: g 8, 32 stacked rows):
    against their plain versions (K6 also against K2, K5 also against K2 on
    the unshared batch), with times, bounds and SDPA where a path of the
    geometry launches the kernel. Prints which kernel runs: K2/K6 on the
    decode ring (its slots) or the walk, K4/K7/K8 on the tensor cores or the
    CUDA cores. Returns {(kernel, arch): result}."""
    from repro_torch.core.attention import paged_gather_kv
    from repro_torch.core.leantile import fixed_split_factor, make_chunk_schedule, make_schedule
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import lean_decode as ld
    from repro_torch.kernels import lean_prefill as lp
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(24)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dt, dname, elem = torch.bfloat16, "bfloat16", 2
    results = {}

    def close_bf16(out, ref):
        step = torch.finfo(torch.bfloat16).eps * ref.float().abs()
        return bool(((out.float() - ref.float()).abs() <= step + BF16_TOL).all())

    def record(key, ms, plain_ms, lib_ms, nbytes, flops, err, what):
        b_ms, b_by = bound(dev_name, dname, nbytes, flops)
        results[key] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "max_abs_err": err}
        print(f"  {arch_name(key[0].replace('_window', ''), key[1])} {what}: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}; plain "
              f"{plain_ms:.3f} ms; SDPA {lib_ms:.4f} ms); max|err| {err:.3e}", flush=True)

    for arch, (Hq, Hkv, d) in ARCH_GEOMETRY.items():
        g = Hq // Hkv
        # K2: decode
        lens, tile = [4000, 1500, 700, 1], 128
        sched = make_schedule(lens, Hkv, tile, sm_count)
        q, k_pool, v_pool, tbl, k_dense, v_dense = make_kv_problem(
            torch, lens, Hq, Hkv, d, tile, 32, dt, gen, dev)
        q_seg = q.reshape(len(lens) * Hkv, g, d).contiguous()
        k_rows, v_rows = ops._pool_rows(k_pool, v_pool)
        seg_ctx = torch.tensor([L for L in lens for _ in range(Hkv)], dtype=torch.int32,
                               device=dev)
        route = ops.paged_route(sched, tbl, Hkv)
        args = (q_seg, k_rows, v_rows, seg_ctx, route, sched, 1.0 / math.sqrt(d))
        ring0 = ld.fused_ring_launches
        o, lse = ld.lean_decode_fused(*args)
        o_ref, lse_ref = ld.lean_decode_fused_plain(*args)
        torch.cuda.synchronize()
        err = max((o - o_ref).abs().max().item(), (lse - lse_ref).abs().max().item())
        check(torch.allclose(o, o_ref, atol=BF16_TOL, rtol=BF16_TOL)
              and torch.allclose(lse, lse_ref, atol=BF16_TOL, rtol=BF16_TOL),
              f"K2 at {arch}'s geometry disagrees with its plain version: max |err| {err}")
        ns = ld.ring_slots(dt, g, d, tile)
        check(ld.fused_ring_launches == ring0 + int(ns > 0),
              f"K2 at {arch}'s geometry: the ring counter does not follow the path rule")
        print(f"arch kernels, {arch}: Hq {Hq} Hkv {Hkv} (gq {g}, row bucket "
              f"{2 if g <= 2 else 4 if g <= 4 else 8}) d {d}; "
              + ring_line("K2", elem, d, tile, g), flush=True)
        ms = gpu_ms(lambda: ld.lean_decode_fused(*args))
        plain_ms = gpu_ms(lambda: ld.lean_decode_fused_plain(*args), reps=3)
        lib_ms = library_yardstick(torch, q, k_dense, v_dense, lens, g, elem)[LIBRARY_CALL][0]
        tokens = sum(lens) * Hkv
        nbytes = (2 * tokens * d * elem + q_seg.numel() * elem + 4 * (o.numel() + lse.numel())
                  + 4 * (seg_ctx.numel() + route.numel()))
        record(("lean_decode_fused", arch), ms, plain_ms, lib_ms, nbytes, 4 * g * d * tokens,
               err, "decode, lens [4000, 1500, 700, 1], page 128")
        if arch in ARCH_FIXED:
            # K6: the fixed run's decode, on K2's batch as dense sequences
            B = len(lens)
            splits = fixed_split_factor(max(lens), B * Hkv, tile, sm_count)
            fargs = (q_seg, k_dense.reshape(B * Hkv, -1, d), v_dense.reshape(B * Hkv, -1, d),
                     seg_ctx, splits, tile, 1.0 / math.sqrt(d))
            ring6 = fd.ring_launches
            parts = fd.flash_decode_partials(*fargs)
            parts_ref = fd.flash_decode_partials_plain(*fargs)
            torch.cuda.synchronize()
            on_ring = fd.ring_launches - ring6
            e6 = max((a - b).abs().max().item() for a, b in zip(parts, parts_ref))
            check(all(torch.allclose(a, b, atol=BF16_TOL, rtol=BF16_TOL)
                      for a, b in zip(parts, parts_ref)),
                  f"K6 at {arch}'s geometry disagrees with its plain version: max |err| {e6}")
            o6 = ops.flash_decode_from_lens(q, k_dense, v_dense, seg_ctx, num_splits=splits,
                                            tile=tile)
            e26 = (o.reshape(B, Hq, d) - o6.float()).abs().max().item()
            check(e26 <= 2.0 ** -7, f"K2 and K6 + merge_n disagree at {arch}'s geometry: {e26}")
            print("  " + ring_line("K6", elem, d, tile, g) + f"; this launch "
                  f"{'on the ring' if on_ring else 'on the walk'}, {splits} splits; K2 against "
                  f"K6 + merge_n {e26:.2e}", flush=True)
            out_bytes = 4 * sum(t.numel() for t in parts)
            record(("flash_decode_partials", arch),
                   gpu_ms(lambda: fd.flash_decode_partials(*fargs)),
                   gpu_ms(lambda: fd.flash_decode_partials_plain(*fargs), reps=3), lib_ms,
                   2 * tokens * d * elem + q_seg.numel() * elem + 4 * B * Hkv + out_bytes,
                   4 * g * d * tokens, e6, f"K6 decode, lens {lens}")
        if arch in ARCH_CASCADE:
            # K5: the prefix-sharing run's cascade, its stacked rows (g x 4)
            case = next(iter(CASCADE_CASES))
            passes, suffixes = CASCADE_CASES[case]
            q5, kp5, vp5, tbl5, dup5, lens5 = cascade_problem(torch, passes, suffixes, Hq, Hkv,
                                                              d, tile, dt, gen, dev)
            args5, binding = cascade_operands(torch, q5, kp5, vp5, tbl5, lens5, passes, sm_count)
            ring5 = ld.cascade_ring_launches
            o5, l5 = ld.lean_cascade_fused(*args5)
            o5r, l5r = ld.lean_cascade_fused_plain(*args5)
            torch.cuda.synchronize()
            check(ld.cascade_ring_launches == ring5 + 1,
                  f"K5 at {arch}'s geometry did not run on the decode ring")
            e5 = max((o5 - o5r).abs().max().item(), (l5 - l5r).abs().max().item())
            check(torch.allclose(o5, o5r, atol=BF16_TOL, rtol=BF16_TOL)
                  and torch.allclose(l5, l5r, atol=BF16_TOL, rtol=BF16_TOL),
                  f"K5 at {arch}'s geometry disagrees with its plain version: max |err| {e5}")
            B5 = len(lens5)
            sched5 = make_schedule(lens5, Hkv, tile, sm_count)
            ctx5 = torch.tensor([L for L in lens5 for _ in range(Hkv)], dtype=torch.int32,
                                device=dev)
            dup_t = torch.as_tensor(dup5).to(dev)
            kr5, vr5 = ops._pool_rows(kp5, vp5)
            o2u, l2u = ld.lean_decode_fused(q5.reshape(B5 * Hkv, g, d).contiguous(), kr5, vr5,
                                            ctx5, ops.paged_route(sched5, dup_t, Hkv), sched5,
                                            1.0 / math.sqrt(d))
            e52 = max((o5 - o2u).abs().max().item(), (l5 - l2u).abs().max().item())
            check(torch.allclose(o5, o2u, atol=CASCADE_TOL, rtol=CASCADE_TOL)
                  and torch.allclose(l5, l2u, atol=CASCADE_TOL, rtol=CASCADE_TOL),
                  f"K5 at {arch}'s geometry and K2 on the unshared batch differ by {e52}")
            lib5 = library_yardstick(torch, q5, paged_gather_kv(kp5, dup_t),
                                     paged_gather_kv(vp5, dup_t), lens5, g,
                                     elem)[LIBRARY_CALL][0]
            nb5, fl5, _, _ = cascade_work(binding, args5[7], lens5, args5, q5, o5, l5, elem)
            record(("lean_cascade_fused", arch), gpu_ms(lambda: ld.lean_cascade_fused(*args5)),
                   gpu_ms(lambda: ld.lean_cascade_fused_plain(*args5), reps=3), lib5, nb5, fl5,
                   e5, f"K5 {case}, lens {lens5}, {args5[0].shape[1]} stacked rows, against K2 "
                   f"unshared {e52:.2e}")
        # K7: whole-prompt prefill (the tensor cores, on 64-key tiles at d 256)
        cases = [("causal 3000", 3000, None)] + ([("window 1024", 3000, 1024)]
                                                 if arch == "gemma3-4b" else [])
        for label, L, window in cases:
            key = ("flash_prefill_window" if window else "flash_prefill", arch)
            qp = torch.randn(1, Hq, L, d, generator=gen, device=dev).to(dt)
            kp = torch.randn(1, Hkv, L, d, generator=gen, device=dev).to(dt)
            vp = torch.randn(1, Hkv, L, d, generator=gen, device=dev).to(dt)
            fp.reset_launch_counts()
            out = fp.flash_prefill(qp, kp, vp, causal=True, window=window)
            ref = fp.flash_prefill_plain(qp, kp, vp, causal=True, window=window)
            torch.cuda.synchronize()
            tc = fp.tensor_core_path(dt, d)
            check(fp.dense_tc_launches == int(tc), f"K7 at {arch}: the path rule was not kept")
            err = (out.float() - ref.float()).abs().max().item()
            check(close_bf16(out, ref), f"K7 {label} at {arch}'s geometry disagrees with its "
                  f"plain version: max |err| {err}")
            if arch not in ARCH_K7:
                print(f"  {arch_name('flash_prefill', arch)} K7 {label}: max|err| {err:.3e} "
                      "(no run of this geometry admits by K7: not timed)", flush=True)
                continue
            ms = gpu_ms(lambda: fp.flash_prefill(qp, kp, vp, causal=True, window=window), reps=10)
            plain_ms = gpu_ms(lambda: fp.flash_prefill_plain(qp, kp, vp, causal=True,
                                                             window=window), reps=2)
            if window is None:
                lib = lambda: sdpa(qp, kp, vp, is_causal=True, enable_gqa=True)
            else:
                pos = torch.arange(L, device=dev)
                mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
                lib = lambda: sdpa(qp, kp, vp, attn_mask=mask, enable_gqa=True)
            lib_ms = gpu_ms(lib, reps=10)
            keys = visible_keys(L, L, True, window) * Hq
            record(key, ms, plain_ms, lib_ms,
                   (qp.numel() + kp.numel() + vp.numel() + out.numel()) * elem, 4 * d * keys,
                   err, f"K7 {label} ({'tensor' if tc else 'CUDA'} cores)")
        off_path = arch not in ARCH_CHUNKED
        if off_path and d != 256:
            continue
        # the fused K4 and K8: the chunk pack (at d 256 on the CUDA cores and
        # on no engine path: gemma3 mixes in window layers, so its engine
        # admits whole prompts by K7)
        C, offs = CHUNK, CHUNK_OFFS
        visible = [o + C for o in offs]
        csched = make_chunk_schedule(visible, Hkv, tile, sm_count, max_len=max(visible) + tile)
        qc, kc, vc, tblc = chunk_pack(torch, offs, C, Hq, Hkv, d, tile, dt, gen, dev)
        N = len(offs)
        kr, vr = ops._pool_rows(kc, vc)
        cctx = torch.tensor([v for v in visible for _ in range(Hkv)], dtype=torch.int32,
                            device=dev)
        cqs = torch.tensor([o for o in offs for _ in range(Hkv)], dtype=torch.int32, device=dev)
        cargs = (qc.reshape(N * Hkv, g * C, d).contiguous(), kr, vr, cctx, cqs,
                 ops.paged_route(csched, tblc, Hkv), csched, 1.0 / math.sqrt(d), C)
        q_off = torch.tensor(offs, dtype=torch.int32, device=dev)
        lp.reset_launch_counts()
        fp.reset_launch_counts()
        o4 = lp.lean_prefill_fused(*cargs)
        o4_ref = lp.lean_prefill_fused_plain(*cargs)
        o8 = fp.flash_prefill_paged(qc, kc, vc, tblc, q_off)
        o8_ref = fp.flash_prefill_paged_plain(qc, kc, vc, tblc, q_off, 1.0 / math.sqrt(d))
        torch.cuda.synchronize()
        tc4 = fp.tensor_core_path(dt, d, tile)
        check((lp.fused_tc_launches, fp.tc_launches) == (int(tc4), int(tc4)),
              f"fused K4 or K8 at {arch}'s geometry did not follow the path rule")
        e4 = (o4.float() - o4_ref.float()).abs().max().item()
        e8 = (o8.float() - o8_ref.float()).abs().max().item()
        check(close_bf16(o4, o4_ref) and close_bf16(o8, o8_ref),
              f"fused K4 / K8 at {arch}'s geometry disagree with their plain versions: "
              f"{e4}, {e8}")
        k_dense, v_dense = paged_gather_kv(kc, tblc), paged_gather_kv(vc, tblc)
        K = k_dense.shape[2]
        qpos = q_off[:, None].long() + torch.arange(g * C, device=dev)[None, :] % C
        mask = (torch.arange(K, device=dev)[None, None, :] <= qpos[..., None])[:, None]
        qf = qc.reshape(N, Hkv, g * C, d)
        lib_ms = gpu_ms(lambda: sdpa(qf, k_dense, v_dense, attn_mask=mask), reps=10)
        keys = sum(Hq * (C * o + C * (C + 1) // 2) for o in offs)
        nbytes = (2 * qc.numel() + 2 * sum(visible) * Hkv * d) * elem
        for name, fn, plain, err in (
            ("lean_prefill_fused", lambda: lp.lean_prefill_fused(*cargs),
             lambda: lp.lean_prefill_fused_plain(*cargs), e4),
            ("flash_prefill_paged", lambda: fp.flash_prefill_paged(qc, kc, vc, tblc, q_off),
             lambda: fp.flash_prefill_paged_plain(qc, kc, vc, tblc, q_off, 1.0 / math.sqrt(d)),
             e8),
        ):
            if name == "flash_prefill_paged" and arch not in ARCH_FIXED:
                continue                     # no fixed run of this geometry: held, not timed
            record((name, arch), gpu_ms(fn, reps=10), gpu_ms(plain, reps=2), lib_ms, nbytes,
                   4 * d * keys, err, f"pack of {N} chunks of {C} at {list(offs)} "
                   f"({'tensor' if tc4 else 'CUDA'} cores"
                   + ("; no engine path launches it)" if off_path else ")"))
    return results


def arch_config(cfg, n_layers: int):
    """``cfg`` at ``n_layers`` of depth: its stage pattern kept, repeated
    as often as fits (the last unit cut short)."""
    import dataclasses

    if n_layers >= cfg.n_layers:
        return cfg
    pattern = cfg.stages[0][0]
    reps, rest = divmod(n_layers, len(pattern))
    stages = (((pattern, reps),) if reps else ()) + (((pattern[:rest], 1),) if rest else ())
    return dataclasses.replace(cfg, n_layers=n_layers, stages=stages)


def arch_engine_class():
    """A :class:`DecodeEngine` recording, per request, the logits row each
    emitted token was picked from (admission, the chunk completing a
    prompt, each decode pass), each decode tick's seconds and each blocking
    admission's (prompt tokens, seconds)."""
    import torch

    from repro_torch.serving.engine import DecodeEngine

    class Rows(DecodeEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.rows, self.tick_s, self.admit_s = {}, [], []

        def _run_prompt_prefill(self, prompt, slot, pages):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = super()._run_prompt_prefill(prompt, slot, pages)
            torch.cuda.synchronize()
            self.admit_s.append((len(prompt), time.perf_counter() - t0))
            self.rows.setdefault(self.slot_req[slot].uid, []).append(logits[0].float())
            return logits

        def prefill_chunks_tick(self, work, pack_width, chunk_cap):
            toks = super().prefill_chunks_tick(work, pack_width, chunk_cap)
            for i, (slot, chunk, off) in enumerate(work):
                req = self.slot_req[slot]
                if off + len(chunk) == len(req.prompt):
                    self.rows.setdefault(req.uid, []).append(self.last_prefill_logits[i].float())
            return toks

        def _emit_tokens(self, results, guard_on, spec=None):
            for active, _, _ in results:
                for s in active:
                    self.rows.setdefault(self.slot_req[s].uid, []).append(
                        self.last_logits[s].float())
            return super()._emit_tokens(results, guard_on, spec)

        def decode_tick(self, exclude=None):
            t0 = time.perf_counter()
            out = super().decode_tick(exclude)
            torch.cuda.synchronize()
            if out:
                self.tick_s.append(time.perf_counter() - t0)
            return out

    return Rows


def arch_serve(torch, cfg, params, sm_count, backend, prompts, new_tokens, chunked, cache_len,
               captured=True):
    """Serve ``prompts`` on a paged engine of ``cfg`` (page 128, batch 4)
    through the ``Scheduler`` with chunked prefill (``chunked``) or the
    engine's blocking admission. Returns the streams, the engine (rows,
    tick and admission times, stats) and the run's launch counts."""
    from repro_torch.serving.config import EngineConfig, PagedConfig
    from repro_torch.serving.engine import Request
    from repro_torch.serving.scheduler import Scheduler, SchedulerConfig

    eng = arch_engine_class()(cfg, params, EngineConfig(
        max_batch=4, cache_len=cache_len, attn_backend=backend, num_workers=sm_count,
        paged=PagedConfig(enabled=True, page_size=128)), device="cuda")
    eng.capture_decode = captured
    reset_launch_counts()
    if chunked:
        sch = Scheduler(eng, SchedulerConfig(chunk_size=SCHED_CHUNK, prefill_pack=SCHED_PACK,
                                             token_budget=SCHED_BUDGET, chunked=True))
        hs = [sch.submit(p, new_tokens, uid=i) for i, p in enumerate(prompts)]
        sch.run_to_completion(max_steps=600)
        streams = [list(h.generated) for h in hs]
    else:
        reqs = [Request(uid=i, prompt=p, max_new_tokens=new_tokens)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion(max_ticks=600)
        streams = [list(r.generated) for r in reqs]
    torch.cuda.synchronize()
    counts = launch_counts()
    check(all(len(s) == new_tokens for s in streams), f"{cfg.name} {backend}: a request did "
          "not finish")
    eng.pool.check()
    check(eng.pool.num_allocated == 0, f"{cfg.name} {backend}: {eng.pool.num_allocated} pages "
          "leaked")
    for rows in eng.rows.values():
        check(all(bool(torch.isfinite(r).all()) for r in rows),
              f"{cfg.name} {backend}: non-finite logits")
    return streams, eng, counts


def arch_streams(what, streams, eng, ref_streams, ref_eng) -> list:
    """Hold ``streams`` to the ref backend's: equal, or leaving them where
    the ref run's top-2 logit gap is a near tie (``ARCH_NEAR_TIE``, or the
    largest difference of the two runs' rows before the divergence); a MoE
    model's are reported only (see ``ARCH_NEAR_TIE``: they are held by
    :func:`router_witness` instead). Returns the divergences (request,
    token, gap)."""
    moe = eng.cfg.moe is not None
    out = []
    for u, (a, b) in enumerate(zip(streams, ref_streams)):
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        worst = max(((r0 - r1).abs().max().item() for r0, r1 in
                     zip(eng.rows[u][:j], ref_eng.rows[u][:j])), default=0.0)
        top = ref_eng.rows[u][j].topk(2).values
        gap = (top[0] - top[1]).item()
        check(moe or gap < max(ARCH_NEAR_TIE, worst), f"{what}: request {u} leaves the ref "
              f"stream at token {j} with a top-2 gap of {gap} (near tie below "
              f"{max(ARCH_NEAR_TIE, worst)})")
        out.append((u, j, round(gap, 4)))
    return out


def router_calls(torch, cfg, serve) -> list:
    """Run ``serve()`` (an eager run) with every MoE call's input and router
    probabilities recorded: the forward's own grouping, softmax and top-k.
    Returns [(input (T, D), probabilities (T, E), top-k expert ids sorted)]
    per call, in call order."""
    from repro_torch.models import moe as tmoe
    from repro_torch.models import transformer as tt

    orig, K, rec = tt.moe_forward, cfg.moe.top_k, []

    def forward(p, x, mcfg, *a, **kw):
        B, L, D = x.shape
        T = B * L
        G = tmoe._auto_groups(T)
        while T % G:
            G //= 2
        xt = x.reshape(G, T // G, D).to(tmoe.COMPUTE_DTYPE)
        probs = torch.softmax((xt @ p["router"].to(tmoe.COMPUTE_DTYPE)).float(), dim=-1)
        _, idx = tmoe.top_k(probs, K)
        rec.append((x.reshape(T, D).detach().clone(), probs.reshape(T, -1),
                    idx.reshape(T, K).sort(dim=-1).values))
        return orig(p, x, mcfg, *a, **kw)

    tt.moe_forward = forward
    try:
        serve()
    finally:
        tt.moe_forward = orig
    return rec


def router_witness(torch, cfg, a, b, what, new_tokens) -> dict:
    """Where a MoE model's two runs part (``what``: "x against y"): their
    MoE calls ``a`` and ``b`` (:func:`router_calls`, eager, ``new_tokens``
    deep: to the earliest token where the streams part). At the first call
    where a row's top-k expert set differs: the rows that flipped, their
    k-th against (k+1)-th router probability margins in each run, how far
    their router probabilities differ, and how far their MoE inputs differ
    relative to the row's largest input. Held: a flip exists, the flipped
    rows sit at near ties (each one's smaller margin below the call's
    median margin), and their inputs agree to ``ROUTER_WITNESS_REL`` -- the
    runs' rounding, not a fault (a kernel fault, or pad and idle rows
    filled differently, would part the inputs before any flip). Returns the
    numbers printed."""
    K = cfg.moe.top_k
    check(len(a) == len(b) and all(x[0].shape == y[0].shape for x, y in zip(a, b)),
          f"router witness ({what}): the runs' MoE calls do not align ({len(a)} against "
          f"{len(b)})")
    first = next((i for i, (x, y) in enumerate(zip(a, b)) if not torch.equal(x[2], y[2])), None)
    check(first is not None, f"router witness ({what}): the streams part but no row's "
          "experts differ")
    (xa, pa, ia), (xb, pb, ib) = a[first], b[first]
    rows = (ia != ib).any(dim=-1).nonzero().flatten()
    top_a, top_b = pa.topk(K + 1, dim=-1).values, pb.topk(K + 1, dim=-1).values
    margin = lambda t: t[:, K - 1] - t[:, K]
    rel = ((xa.float() - xb.float()).abs().amax(-1)
           / xb.float().abs().amax(-1).clamp(min=1e-30))
    out = {"call": first, "layer": first % cfg.n_layers, "step": first // cfg.n_layers,
           "tokens": new_tokens,
           "rows": rows.numel(), "of": xa.shape[0],
           "margins_ref": [round(v, 6) for v in margin(top_b)[rows].tolist()],
           "margins": [round(v, 6) for v in margin(top_a)[rows].tolist()],
           "median_margin": margin(top_b).median().item(),
           "dprob": (pa[rows] - pb[rows]).abs().max().item(),
           "dx_flipped": rel[rows].max().item(), "dx_call": rel.max().item(),
           "dx_first_call": max(((x[0].float() - y[0].float()).abs().amax(-1)
                                 / y[0].float().abs().amax(-1).clamp(min=1e-30)).max().item()
                                for x, y in zip(a[:1], b[:1]))}
    print(f"  router witness ({what}, eager, {new_tokens} token(s) deep): the "
          f"first top-{K} difference at MoE call {first} (step {out['step']} of the run, layer "
          f"{out['layer']}): {out['rows']} of {out['of']} rows; their k-th - (k+1)-th router "
          f"probability margins {out['margins']} and {out['margins_ref']} against a "
          f"median of {out['median_margin']:.6f} over the call's rows; router probabilities "
          f"apart by up to {out['dprob']:.2e}; MoE inputs apart by up to "
          f"{out['dx_flipped']:.2e} of the row's largest (every row of the call "
          f"{out['dx_call']:.2e}; the first call {out['dx_first_call']:.2e}); bound "
          f"{ROUTER_WITNESS_REL}", flush=True)
    tie = max(min(x, y) for x, y in zip(out["margins"], out["margins_ref"]))
    check(tie < out["median_margin"], f"router witness ({what}): a flipped row's margin "
          f"{tie} is not below the call's median {out['median_margin']}: not a near tie")
    check(out["dx_flipped"] <= ROUTER_WITNESS_REL,
          f"router witness ({what}): the flipped rows' MoE inputs differ by "
          f"{out['dx_flipped']} of their largest (bound {ROUTER_WITNESS_REL}): not a near tie "
          "of the router")
    return out


def arch_prompts(vocab, lens, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def arch_bits(torch, cfg, params, sm_count, configs, prompts, replayed=()) -> dict:
    """``twin_bits`` on each (label, EngineConfig, drive): eager against
    captured in lockstep, every step bit for bit, and a replay of each step
    kind in ``replayed``. Returns {label: steps}."""
    out = {}
    for label, config, drive in configs:
        steps, worst, st, _ = twin_bits(torch, cfg, params, config, drive, prompts=prompts)
        for kind, (n, same) in steps.items():
            check(n > 0 and same == n, f"{cfg.name} {label}: {kind} steps bit-identical "
                  f"{same}/{n} (max |logit diff| {worst})")
        check(st.step_captures > 0, f"{cfg.name} {label}: nothing was captured")
        check(all(getattr(st, f"{kind}_replays") > 0 for kind in replayed),
              f"{cfg.name} {label}: a step kind of {list(replayed)} replayed no graph")
        out[label] = {k: v[0] for k, v in steps.items()}
    print(f"  {cfg.name}: captured against eager, bit for bit: "
          + "; ".join(f"{label} {steps}" for label, steps in out.items()), flush=True)
    return out


def arch_depth(torch, cfg, reserve_gb: float) -> int:
    """The most layers of ``cfg`` whose bf16 weights fit the card's free
    memory, ``reserve_gb`` kept for caches, activations and graphs."""
    D, V = cfg.d_model, cfg.vocab_size
    attn = D * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim + cfg.n_heads * cfg.head_dim * D
    if cfg.moe is not None:
        m = cfg.moe
        ffn = D * m.num_experts + 3 * m.num_experts * D * m.d_ff_expert + 3 * D * m.d_ff_shared
    else:
        ffn = (3 if cfg.ffn_kind == "swiglu" else 2) * D * cfg.d_ff
    layer = 2 * (attn + ffn)
    fixed = 2 * V * D * (1 if cfg.tie_embeddings else 2)
    free, _ = torch.cuda.mem_get_info()
    return max(1, min(cfg.n_layers, int((free - fixed - reserve_gb * 1e9) // layer)))


def arch_params(torch, cfg, seed):
    from repro_torch.models import init_params

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    return params, time.perf_counter() - t0


def qwen3_phase(torch, sm_count, smi: str, depth=None) -> dict:
    """qwen3-moe-30b-a3b at full width (d_model 2048, 32/4 heads, d 128, 128
    experts top-8 of width 768, vocab 151936), at all 48 layers or the most
    that fit (printed): the lean Scheduler with chunked prefill and every
    step captured, the fixed and ref Schedulers, streams against ref
    (reported; lean held to fixed, the first-token logits of lean and ref
    to a bound, and where they part, :func:`router_witness`); an eager and
    a captured decode run with host launch calls per tick; one
    prefix-sharing run with the radix cache and cascade decode (K5 at g 8)
    against the same waves without cascade; speculative decode against
    plain decode; and captured steps bit for bit against eager (chunk and
    decode on the Scheduler; admission, verify and decode on the spec
    engine). Returns launches per kernel from the lean and fixed runs, the
    cascade and the spec run."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import lean_decode as ld
    from repro_torch.serving.config import SpecConfig
    from repro_torch.serving.engine import Request

    full = get_config("qwen3-moe-30b-a3b")
    n = depth or arch_depth(torch, full, reserve_gb=10.0)
    cfg = arch_config(full, n)
    params, init_s = arch_params(torch, cfg, 30)
    print(f"qwen3 phase: {cfg.name} full width (d_model {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads, d {cfg.head_dim}, {cfg.moe.num_experts} experts top-"
          f"{cfg.moe.top_k} of width {cfg.moe.d_ff_expert}, vocab {cfg.vocab_size}), "
          f"{cfg.n_layers} of {full.n_layers} layers"
          + ("" if n == full.n_layers else " (depth cut: set by the caller)" if depth
             else " (depth cut: the weights of more do not fit)")
          + f"; bf16 weights in {init_s:.1f} s, {torch.cuda.memory_allocated() / 1e9:.1f} GB",
          flush=True)
    prompts = arch_prompts(cfg.vocab_size, QWEN3_PROMPTS, 31)
    new = ARCH_NEW_TOKENS
    runs = {}
    for backend in ("ref", "lean", "fixed"):
        runs[backend] = arch_serve(torch, cfg, params, sm_count, backend, prompts, new, True,
                                   4096)
    launches, parted = {}, {}
    for backend in ("lean", "fixed"):
        streams, eng, counts = runs[backend]
        kernels = {"lean": ("K4f", "K2"), "fixed": ("K8", "K6")}[backend]
        chunks, ticks = len(eng.stats.tick_prefill_tokens), len(eng.tick_s)
        check(counts[kernels[0]] > 0 and counts[kernels[1]] > 0 and
              counts[kernels[1]] % cfg.n_layers == 0,
              f"qwen3 {backend}: launches {counts}")
        div = arch_streams(f"qwen3 {backend}", streams, eng, runs["ref"][0], runs["ref"][1])
        if div:
            parted[backend] = 1 + min(j for _, j, _ in div)
        st = eng.stats
        print(f"  {backend} Scheduler: launches {kernels[0]} {counts[kernels[0]]}, "
              f"{kernels[1]} {counts[kernels[1]]}; chunk steps {st.chunk_prefills}"
              f" chunks, captures {st.chunk_captures} chunk / {st.decode_captures} decode, "
              f"replays {st.chunk_replays} / {st.decode_replays}; tick p50 "
              f"{statistics.median(eng.tick_s) * 1e3:.2f} ms; divergences from ref "
              f"(request, token, gap) {div}", flush=True)
        launches[backend] = counts
    check(runs["lean"][1].stats.decode_replays > 0,
          "qwen3 lean: no decode step replayed a captured graph")
    # the first-token logits against ref, held to a bound from the measured
    # runs; where a stream parts from ref, the router witness
    ref_eng = runs["ref"][1]
    gaps = {b: max((runs[b][1].rows[u][0] - ref_eng.rows[u][0]).abs().max().item()
                   for u in range(len(prompts))) for b in ("lean", "fixed")}
    print(f"  first-token logits against ref: max |gap| lean {gaps['lean']:.4f}, fixed "
          f"{gaps['fixed']:.4f} (bound {QWEN3_FIRST_LOGIT_GAP})", flush=True)
    check(max(gaps.values()) <= QWEN3_FIRST_LOGIT_GAP, f"qwen3: first-token logits against ref "
          f"apart by {gaps} (bound {QWEN3_FIRST_LOGIT_GAP}, from the measured runs)")
    del runs, ref_eng
    if parted:
        n = max(parted.values())
        eager = lambda b: router_calls(torch, cfg, lambda: arch_serve(
            torch, cfg, params, sm_count, b, prompts, n, True, 4096, captured=False))
        ref_calls = eager("ref")
        for backend in parted:
            router_witness(torch, cfg, eager(backend), ref_calls, f"{backend} against ref", n)
        del ref_calls
    clock("qwen3 phase: eager against captured ticks")
    ticks = {}
    for captured in (False, True):
        _, eng, _ = arch_serve(torch, cfg, params, sm_count, "lean", prompts, new, False, 4096,
                               captured=captured)
        ticks[captured] = statistics.median(eng.tick_s[2:]) * 1e3
        if captured:
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            reqs = [Request(uid=10 + i, prompt=p, max_new_tokens=10)
                    for i, p in enumerate(prompts)]
            for r in reqs:
                eng.submit(r)
            for _ in range(4):                   # admissions, warm-up, capture
                eng.tick()
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(2):
                    eng.tick()
                torch.cuda.synchronize()
            eng.run_to_completion()
            calls = sum(host_launch_calls(prof).values()) / 2
            busy = device_time(prof)[1] / 2
        del eng
    print(f"  decode tick p50, eager then captured: {ticks[False]:.2f}, {ticks[True]:.2f} ms; "
          f"a replayed tick: {calls:.1f} host launch calls, device busy {busy:.2f} ms; {smi}",
          flush=True)
    clock("qwen3 phase: prefix sharing, spec, bits")
    waves = prefix_waves(cfg.vocab_size)
    res = prefix_serving_run(torch, cfg, params, sm_count, 8, waves, True)
    # against the same waves on the same radix cache without cascade decode
    # (K2 over the shared pages): the chunk steps are the same rows, so the
    # router sees the same batches. A run with the cache off is not the same
    # function for a MoE: its chunk steps prefill the system prompt again,
    # beside other rows, and an expert's capacity keeps other rows
    plain = prefix_serving_run(torch, cfg, params, sm_count, 8, waves, True, cascade=False)
    check(plain["eng"].stats.cascade_ticks == 0, "qwen3 prefix serving: cascade off ran cascade")
    # the first tokens come from chunk steps, which cascade decode does not
    # touch: held to the logit tolerance. The decode ticks route a 4-row
    # batch through experts that keep C = 1 row each, so where K5's
    # rounding and K2's flip a router near tie the runs part: held by the
    # router witness on the same two runs, eager
    first_gap = 0.0
    for h in res["handles"]:
        a, b = res["eng"].first_rows[h.uid], plain["eng"].first_rows[h.uid]
        atol = LOGIT_ATOL_FRAC * b.abs().median().item()
        first_gap = max(first_gap, (a - b).abs().max().item())
        check(torch.allclose(a, b, rtol=LOGIT_RTOL, atol=atol), f"qwen3 prefix serving: "
              f"request {h.uid}'s first-token logits differ from the non-cascade run's by "
              f"{(a - b).abs().max().item()} (allowed {atol} + {LOGIT_RTOL} |ref|)")
    agree = sum(h.generated == plain["handles"][h.uid].generated for h in res["handles"])
    parts, decode_gap = agree < len(res["handles"]), 0.0
    for h in res["handles"]:
        for (x, tx, _), (y, ty, _) in zip(res["eng"].rows.get(h.uid, []),
                                          plain["eng"].rows.get(h.uid, [])):
            decode_gap = max(decode_gap, (x - y).abs().max().item())
            atol = LOGIT_ATOL_FRAC * y.abs().median().item()
            parts = parts or not torch.allclose(x, y, rtol=LOGIT_RTOL, atol=atol)
            if tx != ty:
                break               # later rows follow different tokens
    del plain
    if parts:
        runs = [router_calls(torch, cfg, lambda c=c: prefix_serving_run(
            torch, cfg, params, sm_count, 8, waves, True, cascade=c, captured=False))
            for c in (False, True)]
        router_witness(torch, cfg, runs[1], runs[0], "cascade against no cascade", 8)
        del runs
    st = res["eng"].stats
    check(st.cascade_fused_ticks > 0 and st.prefix_matched_tokens > 0,
          f"qwen3 prefix serving: no cascade tick ({st.cascade_ticks}) or no match")
    check(res["counts"]["K5"] == cfg.n_layers * st.cascade_fused_ticks,
          f"qwen3 prefix serving: K5 launched {res['counts']['K5']} times, expected "
          f"{cfg.n_layers} x {st.cascade_fused_ticks}")
    check(ld.cascade_ring_launches == ld.cascade_launches, "qwen3: K5 off the decode ring")
    launches["cascade"] = res["counts"]
    print(f"  prefix sharing (system prompt {SYSTEM_TOKENS}, tails {list(WAVE2_TAILS)}): "
          f"{st.prefix_matched_tokens} tokens from the radix cache, {st.cascade_fused_ticks} "
          f"cascade ticks (K5 {res['counts']['K5']} = {cfg.n_layers} x "
          f"{st.cascade_fused_ticks}, g {cfg.n_heads // cfg.n_kv_heads}); pool and cache clean; "
          f"against the same waves without cascade: first-token logits within {first_gap:.4f}, "
          f"decode logits up to the first differing token within {decode_gap:.4f}, streams "
          f"equal {agree}/{len(res['handles'])}",
          flush=True)
    del res
    from repro_torch.serving.speculative import OracleProposer

    Rows = spec_engine_class()
    base_cfg = engine_config("lean", sm_count)
    out = {}
    for spec in (False, True):
        # the oracle proposer replays the plain run's streams
        config = (dataclasses.replace(base_cfg, spec=SpecConfig(
            enabled=True, k=SPEC_K, proposer=OracleProposer(dict(enumerate(out[False][1])))))
            if spec else base_cfg)
        eng = Rows(cfg, params, config, device="cuda")
        reqs = [Request(uid=i, prompt=p, max_new_tokens=new) for i, p in enumerate(prompts)]
        reset_launch_counts()
        tps, _, streams = spec_drive(torch, eng, reqs)
        out[spec] = (eng, streams, tps, launch_counts())
    worst = spec_divergences(torch, out[False][0], out[True][0], out[False][1], out[True][1],
                             "qwen3", hold=False)
    st = out[True][0].stats
    check(st.spec_ticks > 0 and st.verify_replays > 0, "qwen3 spec: no verify step replayed")
    launches["spec"] = out[True][3]
    print(f"  speculative decode (k {SPEC_K}, oracle of the plain run): {st.spec_ticks} verify "
          f"ticks, accept "
          f"{st.spec_accepted_tokens}/{st.spec_draft_tokens}, {out[True][2]:.1f} tokens/s "
          f"against plain {out[False][2]:.1f}; streams held to plain decode (largest "
          f"verify-vs-decode logit difference {worst:.4f})", flush=True)
    del out
    bits = arch_bits(torch, cfg, params, sm_count, [
        ("chunk steps lean", engine_config("lean", sm_count), "sched"),
        ("spec lean", dataclasses.replace(engine_config("lean", sm_count),
                                          spec=SpecConfig(enabled=True, k=SPEC_K)), "engine"),
    ], arch_prompts(cfg.vocab_size, QWEN3_BITS_PROMPTS, 32))
    del params
    return {"launches": launches, "bits": bits, "depth": cfg.n_layers}


def gemma_phase(torch, sm_count, smi: str, depth=None) -> dict:
    """gemma3-4b at full width and depth (34 layers: 28 sliding-window of
    1024 keys, 6 global; d 256; vocab 262144): prompts of 16000, 3000 and
    1200 tokens admitted by blocking whole-prompt prefill (K7 on the tensor
    cores at d 256, 64-key tiles; the rings wrap), decode on lean (K2 at d 256), fixed
    (K6) and ref, streams against ref; the lean engine's captured steps bit
    for bit against eager. Returns launches per kernel of the lean run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import lean_decode as ld

    full = get_config("gemma3-4b")
    cfg = arch_config(full, depth or full.n_layers)
    params, init_s = arch_params(torch, cfg, 34)
    kinds = [k for pat, reps in cfg.stages for _ in range(reps) for k in pat]
    n_attn, n_win = kinds.count("attn"), kinds.count("win")
    print(f"gemma phase: {cfg.name} full width (d_model {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads, d {cfg.head_dim}, window {cfg.window}, vocab "
          f"{cfg.vocab_size}), {cfg.n_layers} of {full.n_layers} layers ({n_win} win, {n_attn} "
          f"attn); bf16 weights in {init_s:.1f} s, {torch.cuda.memory_allocated() / 1e9:.1f} GB",
          flush=True)
    prompts = arch_prompts(cfg.vocab_size, GEMMA_PROMPTS, 35)
    cache_len = max(GEMMA_PROMPTS) + 128
    runs, launches = {}, {}
    for backend in ("ref", "lean", "fixed"):
        runs[backend] = arch_serve(torch, cfg, params, sm_count, backend, prompts,
                                   ARCH_NEW_TOKENS, False, cache_len)
        streams, eng, counts = runs[backend]
        ticks = len(eng.tick_s)
        check(counts["K7"] == cfg.n_layers * len(prompts)
              and fp.dense_tc_launches == fp.dense_launches == counts["K7"],
              f"gemma {backend}: K7 launched {counts['K7']} times ({fp.dense_tc_launches} on "
              f"the tensor cores), expected {cfg.n_layers} x {len(prompts)}, all on the "
              f"tensor cores")
        decode = {"lean": "K2", "fixed": "K6", "ref": None}[backend]
        if decode:
            check(counts[decode] == n_attn * ticks and ticks > 0,
                  f"gemma {backend}: {decode} launched {counts[decode]} times, expected "
                  f"{n_attn} global layers x {ticks} ticks")
        others = {k: v for k, v in counts.items() if v and k not in ("K7", decode)}
        check(not others, f"gemma {backend}: other kernels ran: {others}")
        div = ([] if backend == "ref" else
               arch_streams(f"gemma {backend}", streams, eng, runs["ref"][0], runs["ref"][1]))
        ring = (f", {ld.fused_ring_launches} on the decode ring" if backend == "lean" else "")
        print(f"  {backend}: admissions {eng.stats.prefills} (K7 {counts['K7']}, "
              f"{fp.dense_tc_launches} on the tensor cores; ms by prompt tokens: "
              + ", ".join(f"{n} {t * 1e3:.1f}" for n, t in eng.admit_s)
              + f"), decode {decode or 'plain oracle'} {counts.get(decode, 0) if decode else ''}"
              f"{ring}; tick p50 {statistics.median(eng.tick_s) * 1e3:.2f} ms; captures "
              f"{eng.stats.decode_captures} decode / {eng.stats.admit_captures} admission; "
              f"divergences from ref {div}", flush=True)
        launches[backend] = counts
    del runs
    bits = arch_bits(torch, cfg, params, sm_count,
                     [("paged lean", engine_config("lean", sm_count), "engine")],
                     arch_prompts(cfg.vocab_size, (1500, 700, 17), 36))
    del params
    return {"launches": launches, "bits": bits}


def sweep_phase(torch, sm_count, smi: str) -> dict:
    """qwen2-moe-a2.7b (gq 1, 60 experts + shared), nemotron-4-15b (gq 6,
    squared ReLU), yi-34b (gq 8) and musicgen-large (gq 1, d 64, GeLU,
    sinusoidal positions) at full width and one stage unit of depth: a few
    requests on lean and ref (the Scheduler with chunked prefill where the
    architecture takes it, else blocking admission), streams against ref,
    and lean's captured steps bit for bit against eager. Returns {arch: lean
    launches}."""
    from repro_torch.configs import get_config
    from repro_torch.models import supports_chunked_prefill

    out = {}
    for seed, arch in enumerate(("qwen2-moe-a2.7b", "nemotron-4-15b", "yi-34b", "musicgen-large")):
        full = get_config(arch)
        cfg = arch_config(full, len(full.stages[0][0]))
        params, init_s = arch_params(torch, cfg, 40 + seed)
        chunked = supports_chunked_prefill(cfg)
        prompts = arch_prompts(cfg.vocab_size, SWEEP_PROMPTS, 41 + seed)
        ref = arch_serve(torch, cfg, params, sm_count, "ref", prompts, 8, chunked, 1024)
        streams, eng, counts = arch_serve(torch, cfg, params, sm_count, "lean", prompts, 8,
                                          chunked, 1024)
        div = arch_streams(f"{arch} lean", streams, eng, ref[0], ref[1])
        want = ("K4f", "K2") if chunked else ("K7", "K2")
        check(all(counts[k] > 0 for k in want), f"{arch} lean: launches {counts}")
        print(f"sweep {arch}: full width (d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
              f"heads, d {cfg.head_dim}), {cfg.n_layers} of {full.n_layers} layers, weights in "
              f"{init_s:.1f} s; {'chunked Scheduler' if chunked else 'blocking admission'}; "
              f"lean launches " + ", ".join(f"{k} {v}" for k, v in counts.items() if v)
              + f"; divergences from ref {div}", flush=True)
        del ref, eng
        arch_bits(torch, cfg, params, sm_count,
                  [("paged lean", engine_config("lean", sm_count), "engine")], prompts)
        out[arch] = counts
        del params
        clock(f"sweep: {arch} done")
    return out


# ------------------------------------------------ recurrent architectures
RECURRENT_PROMPTS = {"recurrentgemma-9b": (16000, 3000, 1200, 17),   # the 2048-slot rings wrap
                     "xlstm-350m": (3000, 1200, 300, 17)}
RECURRENT_NEW_TOKENS = 16
RECURRENT_TURNS = (True, False, True)   # captured, eager, captured: the first feeds the handoff
RECURRENT_BITS_PROMPTS = (700, 300, 300, 17)   # a length twice: an admission replays
# more distinct prompt lengths than an engine holds admission graphs for
RECURRENT_GRAPH_LENS = (17, 40, 70, 130, 260, 300)
RECURRENT_TRACED_PROMPT = 300   # the traced ticks' prompts cut to this: a tick's cost does not
                                # depend on the context (states, full 2048-slot rings)
HANDOFF_K = (1, 8)           # decoded tokens after which a row is held to an exact prefill
FORMS_T = 256                # tokens of the parallel-against-sequential check
FORMS_CHUNK = 64             # the mLSTM's chunk there: four chunks, the state carried across
# recurrentgemma-9b's 'win' layers at admission: (Hq, Hkv, d, window), causal over these keys
RG_K7 = (16, 1, 256, 2048)
RG_K7_KEYS = (3000, 16000)
# the parallel and the sequential forms of a block take their inputs through
# other roundings (the RG-LRU's prefill conv rounds in bf16, its decode conv
# keeps float32; the forms' GEMMs have other shapes): float32 states and bf16
# outputs are held to four bf16 steps of their scale (2**-6 x their largest
# magnitude); the mLSTM's chunkwise form against its step oracle on the same
# bf16 q/k/v to one bf16 step (the chunked path rounds its weighted products
# to bf16; tests/test_torch_recurrent.py holds the same at smoke width)
FORMS_REL = 2.0 ** -6
MLSTM_FORMS_REL = 2.0 ** -8
# The state handoff against an exact prefill of prompt + k tokens: the
# decode step computes those tokens through the sequential forms, prefill
# through the parallel ones, so beside the lean-vs-ref drift that
# LOGIT_ATOL_FRAC allows (window layers: the ring read by the plain oracle,
# bf16 P, against K7's float32 P) every RG-LRU layer adds a second source of
# that size (its decode conv in float32 against prefill's bf16, a bf16
# rounding at every layer, as the forms check shows at full width): the
# allowance doubles LOGIT_ATOL_FRAC, as INT8_LOGIT_ATOL_FRAC does for
# int8's second source. On an H100, LOGIT_ATOL_FRAC failed first (0.109);
# recurrentgemma-9b's rows then sat 0.0905-0.1267 of the median logit from
# exact prefill, and the planted fault of ``recurrent_handoff`` (one
# layer's state zeroed) moved them by 3.0-4.3.
HANDOFF_ATOL_FRAC = 2 * LOGIT_ATOL_FRAC
# An sLSTM model's rows part from exact prefill further, from the first
# decoded token on: on an H100, xlstm-350m's rows after one token sat
# 0.2674-0.9178 of the median logit from it (0.27 on a 17-token prompt),
# which HANDOFF_ATOL_FRAC failed, while the planted fault moved them by
# 6.4-7.9. Held after the first token only, at this allowance, between the
# two; the rows after more tokens are reported.
SLSTM_HANDOFF_ATOL_FRAC = 2.0


def rg_k7_name() -> str:
    Hq, Hkv, d, _ = RG_K7
    return f"flash_prefill@recurrentgemma-9b (gq {Hq // Hkv}, d {d}, window {RG_K7[3]})"


def recurrent_k7(torch, dev_name: str) -> dict:
    """K7 at recurrentgemma-9b's window layers (MQA: 16 query heads over one
    KV head, d 256, window 2048), causal over ``RG_K7_KEYS`` keys, bf16:
    against its plain version, on the tensor cores, timed beside SDPA (the
    window as a boolean mask over K/V expanded to the 16 heads) and its
    bound. Returns {keys: result}."""
    from repro_torch.kernels import flash_prefill as fp

    Hq, Hkv, d, window = RG_K7
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(26)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out_res = {}
    for L in RG_K7_KEYS:
        q = torch.randn(1, Hq, L, d, generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn(1, Hkv, L, d, generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn(1, Hkv, L, d, generator=gen, device=dev).to(torch.bfloat16)
        fp.reset_launch_counts()
        out = fp.flash_prefill(q, k, v, causal=True, window=window)
        ref = fp.flash_prefill_plain(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        check(fp.dense_tc_launches == fp.dense_launches == 1,
              f"K7 at recurrentgemma's geometry ({L} keys) did not take the tensor cores")
        err = (out.float() - ref.float()).abs().max().item()
        step = torch.finfo(torch.bfloat16).eps * ref.float().abs()
        check(bool(((out.float() - ref.float()).abs() <= step + BF16_TOL).all()),
              f"K7 at recurrentgemma's geometry ({L} keys) disagrees with its plain version: "
              f"max |err| {err}")
        ms = gpu_ms(lambda: fp.flash_prefill(q, k, v, causal=True, window=window), reps=10)
        plain_ms = gpu_ms(lambda: fp.flash_prefill_plain(q, k, v, causal=True, window=window),
                          reps=2, warmup=1)
        pos = torch.arange(L, device=dev)
        mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
        ke, ve = k.expand(1, Hq, L, d), v.expand(1, Hq, L, d)
        lib_ms = gpu_ms(lambda: sdpa(q, ke, ve, attn_mask=mask), reps=10)
        del mask
        torch.cuda.empty_cache()
        keys = visible_keys(L, L, True, window)
        flops = 4 * Hq * d * keys
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
        b_ms, b_by = bound(dev_name, "bfloat16", nbytes, flops)
        out_res[L] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
                      "bound_by": b_by, "max_abs_err": err}
        print(f"  {rg_k7_name()} causal over {L} keys ({keys / 1e6:.2f} M visible pairs a head, "
              f"{flops / 1e9:.1f} GFLOP): max|err| {err:.3e}; {ms:.4f} ms, "
              f"{flops / ms / 1e9:.1f} TFLOP/s (bound {b_ms:.4f} ms by {b_by}; plain "
              f"{plain_ms:.2f} ms; SDPA {lib_ms:.4f} ms)", flush=True)
    return out_res


def recurrent_forms(torch, cfg, params) -> dict:
    """Each recurrent block of ``cfg`` (its first layer of the kind) at full
    width on ``FORMS_T`` tokens: the parallel form against the sequential
    one -- ``rglru_forward`` against a loop of ``rglru_step``,
    ``mlstm_sequence_chunked`` (chunks of ``FORMS_CHUNK``, the state carried
    across) against ``mlstm_sequence_ref`` (the block's own q/k/v and
    gates), ``slstm_forward`` against ``slstm_step`` repeated
    -- outputs and final states within ``FORMS_REL`` (the mLSTM's
    ``MLSTM_FORMS_REL``) of their scale. Returns {kind: worst relative
    gap}."""
    from repro_torch.models import recurrent as rec
    from repro_torch.models.transformer import layer_kinds

    gen = torch.Generator(device="cuda")
    gen.manual_seed(27)
    x = torch.randn(1, FORMS_T, cfg.d_model, generator=gen, device="cuda")
    kinds = layer_kinds(cfg)
    out = {}

    def gap(a, b):
        return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()

    for kind in sorted(set(kinds) - {"win"}):
        p = params["layers"][kinds.index(kind)]["rec"]
        if kind == "rglru":
            o_par, (h_par, _) = rec.rglru_forward(p, x)
            W = cfg.rnn_width
            h = torch.zeros(1, W, device="cuda")
            conv = torch.zeros(1, 3, W, device="cuda")
            steps = []
            for t in range(FORMS_T):
                o, h, conv = rec.rglru_step(p, x[:, t:t + 1], h, conv)
                steps.append(o)
            gaps = [gap(o_par, torch.cat(steps, 1)), gap(h_par, h)]
            rel = FORMS_REL
        elif kind == "mlstm":
            up = x.to(torch.bfloat16) @ p["w_up"].to(torch.bfloat16)
            u = up[..., :up.shape[-1] // 2]
            q, k, v = rec.mlstm_qkv(p, u, cfg.n_heads, torch.bfloat16)
            i_pre, logf = rec._mlstm_gates(p, u)
            h_c, s_c = rec.mlstm_sequence_chunked(q, k, v, i_pre, logf, chunk=FORMS_CHUNK)
            h_r, s_r = rec.mlstm_sequence_ref(q.float(), k.float(), v.float(), i_pre, logf)
            gaps = [gap(h_c, h_r), gap(s_c[0], s_r[0]), gap(s_c[1], s_r[1])]
            rel = MLSTM_FORMS_REL
        else:
            o_par, s_par = rec.slstm_forward(p, x, cfg.n_heads)
            state, steps = None, []
            for t in range(FORMS_T):
                o, state = rec.slstm_step(p, x[:, t:t + 1], cfg.n_heads, state)
                steps.append(o)
            gaps = [gap(o_par, torch.cat(steps, 1))] + [gap(a, b) for a, b in zip(s_par, state)]
            rel = FORMS_REL
        out[kind] = max(gaps)
        check(all(math.isfinite(g) and g <= rel for g in gaps),
              f"{cfg.name} {kind}: the parallel form differs from the sequential one by "
              f"{gaps} of their scale (bound {rel})")
    print(f"  parallel against sequential forms at full width, {FORMS_T} tokens (largest "
          f"|difference| over the largest magnitude; bound {FORMS_REL}, mLSTM "
          f"{MLSTM_FORMS_REL}): " + ", ".join(f"{k} {v:.2e}" for k, v in out.items()),
          flush=True)
    return out


def recurrent_handoff(torch, cfg, params, prompts, streams, eng, cache_len) -> dict:
    """The state handoff, for each request, the engine's logits row after
    decoding k of its tokens (``HANDOFF_K``) against

    - ``steps``: the same functions outside the engine -- each prompt's
      ``prefill`` (a batch of one) copied into row i of a dense cache of
      the engine's batch, then k ``decode_step`` calls over the batch with
      the engine's tokens: what its admission writes, slots and captured
      steps must not change; held for every model;
    - ``exact``: an exact prefill of the prompt plus those k tokens, held
      with ``HANDOFF_ATOL_FRAC`` where every recurrent block is contractive
      (RG-LRU); for an sLSTM model held after the first k only, with
      ``SLSTM_HANDOFF_ATOL_FRAC``, and reported after the others: the
      reference's own decode and prefill forms part further there (the
      decode step keeps the mLSTM's q/k/v in float32 where the chunked
      prefill rounds them to bf16, and the sLSTM's recurrence amplifies a
      rounding: ``tests/test_torch_recurrent.py::
      test_slstm_reference_init_is_chaotic_at_full_width``);
    - ``fault``: a planted fault, the ``steps`` rows decoded from the same
      cache with the first recurrent layer's state zeroed (a state lost at
      admission), against the exact prefill wherever that is held: the
      exact comparison must fail it, or its allowance would not tell a
      wrong handoff from a right one.

    All in the prefix check's tolerance form, ``atol_frac`` x the median
    |reference logit| + ``LOGIT_RTOL`` |reference logit|: ``steps`` with
    ``LOGIT_ATOL_FRAC``, ``exact`` and ``fault`` with the exact allowance
    above. Every gap is printed before any is checked. Returns the
    worst gap over the median of each comparison (``fault``: the least of
    its rows' largest, per request)."""
    import numpy as np

    from repro_torch.models import decode_step, init_cache, layer_kinds, prefill

    kinds = layer_kinds(cfg)
    slstm = "slstm" in kinds
    fault_layer = next(i for i, kind in enumerate(kinds) if kind != "win")
    dev = torch.device("cuda")
    cache = init_cache(cfg, len(prompts), cache_len, device=dev)
    for i, prompt in enumerate(prompts):
        _, one, _ = prefill(params, cfg, torch.as_tensor(prompt[None], device=dev),
                            cache_len=cache_len)
        for lc, l1 in zip(cache, one):
            for name, t in l1.items():
                lc[name][i:i + 1].copy_(t)
        del one
    faulty = [{name: t.clone() for name, t in lc.items()} for lc in cache]
    for t in faulty[fault_layer].values():
        t.zero_()
    steps, fault_steps = [], []
    for k in range(max(HANDOFF_K)):
        toks = torch.tensor([[s[k]] for s in streams], dtype=torch.int32, device=dev)
        ctx = torch.tensor([len(p) + k for p in prompts], dtype=torch.int32, device=dev)
        logits, cache = decode_step(params, cfg, cache, toks, ctx_lens=ctx)
        steps.append(logits.float())
        logits, faulty = decode_step(params, cfg, faulty, toks, ctx_lens=ctx)
        fault_steps.append(logits.float())
    del cache, faulty
    allowed = SLSTM_HANDOFF_ATOL_FRAC if slstm else HANDOFF_ATOL_FRAC
    gaps = []     # (uid, k, name, gap over the median, within the allowance, held)
    for uid, (prompt, stream) in enumerate(zip(prompts, streams)):
        for k in HANDOFF_K:
            got = eng.rows[uid][k]
            held = not slstm or k == HANDOFF_K[0]
            toks = np.concatenate([prompt, np.asarray(stream[:k], np.int32)])[None]
            exact, _, _ = prefill(params, cfg, torch.as_tensor(toks, device=dev),
                                  cache_len=toks.shape[1])
            refs = [("steps", got, steps[k - 1][uid], LOGIT_ATOL_FRAC, True),
                    ("exact", got, exact[0].float(), allowed, held)]
            if held:
                refs.append(("fault", fault_steps[k - 1][uid], exact[0].float(), allowed, True))
            for name, row, want, frac, hold in refs:
                med = want.abs().median().item()
                ok = torch.allclose(row, want, rtol=LOGIT_RTOL, atol=frac * med)
                gaps.append((uid, k, name, (row - want).abs().max().item() / med, ok, hold))
    print(f"  {cfg.name}: state handoff gaps over the median |logit| (request: prompt tokens; "
          f"k decoded: steps / exact / planted fault, layer {fault_layer}'s state zeroed; "
          "* = reported, not held): " + "; ".join(
              f"{uid}: {len(prompts[uid])}; " + ", ".join(
                  f"k {k} " + " / ".join(f"{g:.4f}" + ("" if hold else "*")
                                         for u, kk, _, g, _, hold in gaps if (u, kk) == (uid, k))
                  for k in HANDOFF_K) for uid in range(len(prompts))), flush=True)
    for uid, k, name, g, ok, hold in gaps:
        frac = LOGIT_ATOL_FRAC if name == "steps" else allowed
        check(ok or not hold or name == "fault",
              f"{cfg.name}: request {uid}'s row after {k} decoded tokens differs from "
              f"{'an exact prefill' if name == 'exact' else 'prefill + decode steps'} by "
              f"{g} x the median |logit| (allowed {frac} + {LOGIT_RTOL} |ref|)")
    fault = {uid: max(g for u, _, name, g, _, _ in gaps if u == uid and name == "fault")
             for uid in {u for u, _, name, *_ in gaps if name == "fault"}}
    check(any(not ok for *_, name, _, ok, _ in gaps if name == "fault"),
          f"{cfg.name}: the exact handoff comparison passed a planted fault (layer "
          f"{fault_layer}'s state zeroed): worst gap {max(fault.values())}")
    worst = {name: max((g for *_, n, g, _, hold in gaps if n == name and hold), default=0.0)
             for name in ("steps", "exact")}
    worst["reported"] = max((g for *_, g, _, hold in gaps if not hold), default=None)
    worst["fault"] = min(fault.values())
    worst["fault_layer"] = fault_layer
    worst["allowed"] = allowed
    return worst


def recurrent_phase(torch, sm_count, smi: str, depth=None) -> dict:
    """The recurrent architectures at full width (``RECURRENT_PROMPTS``,
    ``RECURRENT_NEW_TOKENS`` new tokens, paged lean engine, batch 4,
    ``sm_count`` workers, blocking admission at the exact prompt length):
    K7 at recurrentgemma's window geometry first (``recurrent_k7``), then
    recurrentgemma-9b (38 layers: 26 RG-LRU, 12 sliding-window MQA) and
    xlstm-350m (24 layers: 21 mLSTM, 3 sLSTM), each at ``depth`` layers or
    all: the parallel against the sequential forms, the engine captured and
    eager in turns (``RECURRENT_TURNS``; admission ms per prompt, tick p50,
    K7 on the tensor cores at every admission, no decode kernel), the state
    handoff with its planted fault (``recurrent_handoff``), five captured
    ticks traced, the lean engine's captured steps bit for bit against
    eager, and the bounded admission graphs (``recurrent_admit_graphs``).
    Returns the K7 results, the
    launches of each model's first captured run and the bits."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.models import count_params, layer_kinds
    from repro_torch.serving.engine import DecodeEngine, Request

    dev_name = torch.cuda.get_device_name(0)
    print(f"recurrent phase ({smi}): K7 at recurrentgemma-9b's window layers", flush=True)
    k7 = recurrent_k7(torch, dev_name)
    out = {"k7": k7, "launches": {}, "bits": {}}
    for seed, arch in enumerate(("recurrentgemma-9b", "xlstm-350m")):
        clock(f"recurrent phase: {arch}")
        full = get_config(arch)
        cfg = arch_config(full, depth or full.n_layers)
        params, init_s = arch_params(torch, cfg, 50 + seed)
        kinds = layer_kinds(cfg)
        n_win = kinds.count("win")
        print(f"{arch}: full width (d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, "
              f"d {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}), {cfg.n_layers} of "
              f"{full.n_layers} layers (" + ", ".join(f"{kinds.count(k)} {k}"
                                                     for k in sorted(set(kinds)))
              + f"); count_params {count_params(cfg) / 1e9:.3f} B, weights in {init_s:.1f} s, "
              f"{torch.cuda.memory_allocated() / 1e9:.1f} GB",
              flush=True)
        recurrent_forms(torch, cfg, params)
        prompts = arch_prompts(cfg.vocab_size, RECURRENT_PROMPTS[arch], 51 + seed)
        cache_len = max(RECURRENT_PROMPTS[arch]) + 128
        p50s, runs, first = [], [], None
        for captured in RECURRENT_TURNS:
            streams, eng, counts = arch_serve(torch, cfg, params, sm_count, "lean", prompts,
                                              RECURRENT_NEW_TOKENS, False, cache_len,
                                              captured=captured)
            check(counts["K7"] == n_win * len(prompts)
                  and fp.dense_tc_launches == fp.dense_launches == counts["K7"],
                  f"{arch}: K7 launched {counts['K7']} times ({fp.dense_tc_launches} on the "
                  f"tensor cores), expected {n_win} x {len(prompts)}, all on the tensor cores")
            others = {k: n for k, n in counts.items() if n and k != "K7"}
            check(not others, f"{arch}: decode or chunk kernels ran: {others}")
            check(eng.stats.prefill_compiles == len(set(RECURRENT_PROMPTS[arch]))
                  and not eng.bucket_prefill, f"{arch}: admissions not at the exact length")
            check(not captured or eng.stats.decode_replays > 0,
                  f"{arch}: no decode tick replayed a captured step")
            p50s.append(statistics.median(eng.tick_s) * 1e3)
            runs.append(streams)
            print(f"  {'captured' if captured else 'eager'}: admission ms by prompt tokens "
                  + ", ".join(f"{n} {t * 1e3:.1f}" for n, t in eng.admit_s)
                  + f"; decode tick p50 {p50s[-1]:.2f} ms over {len(eng.tick_s)} ticks; K7 "
                  f"{counts['K7']} ({fp.dense_tc_launches} on the tensor cores), other kernels "
                  f"0; prefill_compiles {eng.stats.prefill_compiles}; decode captures "
                  f"{eng.stats.decode_captures}, replays {eng.stats.decode_replays}", flush=True)
            if captured and first is None:
                first = (streams, eng, counts)
            else:
                del eng
        streams, eng, counts = first
        agree = [sum(a == b for a, b in zip(run, runs[0])) for run in runs[1:]]
        worst = recurrent_handoff(torch, cfg, params, prompts, streams, eng, cache_len)
        turns = ", ".join("captured" if c else "eager" for c in RECURRENT_TURNS)
        reported = ("" if worst["reported"] is None else
                    f", after {HANDOFF_K[-1]} tokens (reported, not held) "
                    f"{worst['reported']:.4f}")
        print(f"  {arch}: tick p50 ms in turns ({turns}) "
              + ", ".join(f"{t:.2f}" for t in p50s) + f"; streams equal to the first run's "
              f"{agree} of {len(prompts)}; state handoff, rows after {list(HANDOFF_K)} decoded "
              f"tokens, worst gap over the median |logit|: against prefill + decode steps "
              f"{worst['steps']:.4f} (allowed {LOGIT_ATOL_FRAC}), against exact prefill "
              f"{worst['exact']:.4f} (allowed {worst['allowed']}"
              + (f", after {HANDOFF_K[0]} token: sLSTM" if "slstm" in kinds else "")
              + f"){reported}; planted fault (layer "
              f"{worst['fault_layer']}'s state zeroed) against exact prefill: every request's "
              f"largest gap at least {worst['fault']:.4f}, failed as it must; + {LOGIT_RTOL} "
              f"|ref| / median throughout",
              flush=True)
        out["launches"][arch] = counts
        del first, eng
        eng = DecodeEngine(cfg, params, dataclasses.replace(engine_config("lean", sm_count),
                                                            cache_len=cache_len), device="cuda")
        traced_ticks(torch, eng, [Request(uid=i, prompt=p[:RECURRENT_TRACED_PROMPT],
                                          max_new_tokens=TRACED_TICKS + 6)
                                  for i, p in enumerate(prompts)],
                     statistics.mean(t for t, c in zip(p50s, RECURRENT_TURNS) if c) / 1e3,
                     label=f"{arch} traced captured ticks (prompts cut to "
                           f"{RECURRENT_TRACED_PROMPT} tokens)")
        del eng
        out["bits"][arch] = arch_bits(torch, cfg, params, sm_count,
                                      [("paged lean", engine_config("lean", sm_count), "engine")],
                                      arch_prompts(cfg.vocab_size, RECURRENT_BITS_PROMPTS,
                                                   53 + seed), replayed=("admit", "decode"))
        recurrent_admit_graphs(torch, cfg, params, sm_count, 54 + seed)
        del params
    return out


def recurrent_admit_graphs(torch, cfg, params, sm_count, seed):
    """The captured exact-length admissions, bounded: prompts of
    ``RECURRENT_GRAPH_LENS`` tokens admitted into slot 0 of a paged lean
    engine in three rounds (warm-up, capture, replay), each capture timed.
    The engine must hold ``EXACT_ADMIT_GRAPHS`` of them at the end, the
    least recently used dropped; prints the captures' ms and the reserved
    memory each grew, and the reserved memory given back when the held
    graphs go."""
    import gc

    from repro_torch.serving.engine import EXACT_ADMIT_GRAPHS, DecodeEngine, Request

    eng = timed(DecodeEngine)(cfg, params, engine_config("lean", sm_count), device="cuda")
    prompts = arch_prompts(cfg.vocab_size, RECURRENT_GRAPH_LENS, seed)
    for _ in range(3):
        for i, p in enumerate(prompts):
            check(eng.admit_blocking(Request(uid=i, prompt=p, max_new_tokens=1), 0),
                  f"{cfg.name}: admission refused")
            eng.release_slot(0)
    torch.cuda.synchronize()
    held = [k for k, (_, g) in eng._graphs.items() if g is not None]
    st = eng.stats
    check(len(held) == EXACT_ADMIT_GRAPHS and st.admit_captures == len(prompts),
          f"{cfg.name}: {len(held)} admission graphs held after {st.admit_captures} captures "
          f"(expected {EXACT_ADMIT_GRAPHS} after {len(prompts)})")
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    eng._graphs.clear()
    eng._exact_admits.clear()
    eng._graph_pool = None
    gc.collect()
    torch.cuda.empty_cache()
    freed = reserved - torch.cuda.memory_reserved()
    print(f"  {cfg.name}: exact-length admission graphs, prompts {list(RECURRENT_GRAPH_LENS)} "
          f"admitted in three rounds: captures {st.admit_captures}, replays "
          f"{st.admit_replays}, graphs held {len(held)} (at most {EXACT_ADMIT_GRAPHS}); "
          "capture + instantiation ms " + ", ".join(f"{c:.1f}" for _, c, _ in eng.capture_log)
          + "; reserved MiB grown per capture " + ", ".join(
              f"{b / 2**20:.0f}" for *_, b in eng.capture_log)
          + f"; reserved MiB given back when the held graphs go {freed / 2**20:.0f}", flush=True)
    del eng


# ------------------------------------------------------------------ training
# Mistral-NeMo-12B at full width trains with float32 master weights and
# AdamW's two float32 moments: with the gradient 16 B a parameter. All 40
# layers are 12.25 B parameters (196 GB); 8 layers and the 131072-row
# embedding and unembedding are 3.52 B (56.4 GB), which fit the card
TRAIN_LAYERS = 8
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 2048, 8
TRAIN_OPT = dict(lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS)
# (b) the card against the CPU port: one layer at full width, batch 1 of
# TRAIN_CPU_SEQ tokens; loss_chunk 0 (one chunk of the 31 targets: the
# reference pads a short sequence's targets to a whole 512-row chunk, 16x
# the unembedding's work, which the CPU side cannot afford in its 30 s)
TRAIN_CPU_SEQ = 32
# both sides round the same bf16 products in float32 sums of other orders
# (cuBLAS against the CPU's GEMMs; TF32 off): a gradient element moves by
# a bf16 step where a sum crossed a rounding boundary. A missing or wrong
# term moves a leaf by its own size
TRAIN_LOSS_REL, TRAIN_GRAD_COS, TRAIN_NORM_RATIO = 2e-3, 0.999, 0.02
# xlstm-350m's sLSTM gradients explode at full width, in the reference
# too (ROADMAP queue 3: its recurrent weights' fan-in): about 10**3.5 every
# 32 tokens, so past about 160 tokens the global norm overflows float32
# (the clip scale is then 0 and a step is weight decay alone), past about
# 300 the gradients do (NaN). Its training runs at 128 tokens, where the
# norm is about 1e17 and Adam's steps are real ones
XLSTM_TRAIN_SEQ = 128
# (c) exact resume, in a child process under deterministic algorithms:
# xlstm-350m at full width and depth (its mLSTM and sLSTM backward)
RESUME_ARCH, RESUME_BATCH, RESUME_SEQ = "xlstm-350m", 2, XLSTM_TRAIN_SEQ
RESUME_OPT = dict(lr=3e-4, warmup_steps=1, total_steps=4)
# (d) the trained weights served on the paged lean engine against ref
TRAIN_SERVE_PROMPTS = (2000, 700, 130, 17)
TRAIN_SERVE_TOKENS = 16
# (e) one train step of every config at full width, one stage unit deep
UNIT_BATCH, UNIT_SEQ = 2, 512


def train_mistral(torch, smi: str):
    """(a) Mistral-NeMo-12B at full width and TRAIN_LAYERS deep: float32
    master weights from a seeded generator, TRAIN_STEPS AdamW steps on the
    data pipeline's batches. Prints the loss per step, step ms (CUDA
    events), tokens/s, peak memory and MFU; fails unless every loss is
    finite and the last is below the first."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.models import count_active_params
    from repro_torch.roofline.analysis import PEAK_FLOPS, model_flops_for
    from repro_torch.training import (OptConfig, adamw_update, init_train_state, make_loss,
                                      make_train_step, value_and_grad)
    from repro_torch.training.tree import flatten

    cfg = arch_config(get_config("mistral-nemo-12b"), TRAIN_LAYERS)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt = init_train_state(cfg, gen, "cuda")
    torch.cuda.synchronize()
    n = sum(p.numel() for p in flatten(params)[1])
    print(f"train phase (a) ({smi}): {cfg.name} full width (d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}), {cfg.n_layers} of 40 layers: {n:,} float32 parameters, weights "
          f"+ moments {torch.cuda.memory_allocated() / 1e9:.1f} GB in "
          f"{time.perf_counter() - t0:.1f} s; batch {TRAIN_BATCH} x {TRAIN_SEQ}, "
          f"OptConfig({TRAIN_OPT}), TF32 off", flush=True)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    step = make_train_step(cfg, OptConfig(**TRAIN_OPT))
    reset_launch_counts()
    out, events = [], []
    for i in range(TRAIN_STEPS):
        batch = {k: torch.from_numpy(v).cuda() for k, v in batch_at(dcfg, i).items()}
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        params, opt, m = step(params, opt, batch)
        end.record()
        out.append(m)
        events.append((start, end))
    torch.cuda.synchronize()
    ms = [s.elapsed_time(e) for s, e in events]
    losses = [float(m["loss"]) for m in out]
    gnorms = [float(m["grad_norm"]) for m in out]
    peak = torch.cuda.max_memory_allocated()
    check(not any(launch_counts().values()), f"training launched kernels: {launch_counts()}")
    p50 = statistics.median(ms)
    shape = ShapeSpec("train", "train", TRAIN_SEQ, TRAIN_BATCH)
    flops = model_flops_for(cfg, shape, count_active_params(cfg))
    # the input embedding is a gather, yet the formula counts it as a matmul
    # (6 N a token); the untied model's MFU without its V x D rows beside it
    gather = 0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model
    flops_mm = model_flops_for(cfg, shape, count_active_params(cfg) - gather)
    res = {"layers": cfg.n_layers, "params": n, "losses": losses, "grad_norms": gnorms,
           "step_ms": ms, "step_ms_p50": p50, "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / p50 * 1e3,
           "peak_gb": peak / 1e9, "model_tflop": flops / 1e12,
           "mfu": flops / (p50 / 1e3) / PEAK_FLOPS,
           "model_tflop_no_embed": flops_mm / 1e12,
           "mfu_no_embed": flops_mm / (p50 / 1e3) / PEAK_FLOPS}
    print(f"train phase (a) ({smi}): loss per step " + ", ".join(f"{v:.4f}" for v in losses)
          + "; grad norm " + ", ".join(f"{v:.3f}" for v in gnorms)
          + "; step ms " + ", ".join(f"{v:.1f}" for v in ms)
          + f"; p50 {p50:.1f} ms, {res['tokens_per_s']:.0f} tokens/s; peak memory "
          f"{res['peak_gb']:.2f} GB; model_flops_for {res['model_tflop']:.1f} TFLOP a step, MFU "
          f"{res['mfu']:.4f} of {PEAK_FLOPS / 1e12:.0f} TFLOP/s (without the input embedding's "
          f"rows {res['model_tflop_no_embed']:.1f} TFLOP, MFU {res['mfu_no_embed']:.4f}); "
          "kernels launched 0", flush=True)
    check(all(math.isfinite(v) for v in losses + gnorms), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")

    # where a step's time goes, past the phase's steps: the loss's value and
    # gradients and the AdamW update timed apart, then one step traced
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch_at(dcfg, TRAIN_STEPS).items()}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    _, grads = value_and_grad(make_loss(cfg), params, batch)
    ev[1].record()
    adamw_update(grads, opt, params, OptConfig(**TRAIN_OPT))
    ev[2].record()
    torch.cuda.synchronize()
    del grads
    res["grad_ms"], res["adamw_ms"] = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch_at(dcfg, TRAIN_STEPS + 1).items()}
    with scheduler_profiler(torch) as prof:
        params, opt, _ = step(params, opt, batch)
        torch.cuda.synchronize()
    kernels, busy_ms, by_name = device_time(prof)
    res["traced_busy_ms"], res["traced_kernels"] = busy_ms, len(kernels)
    print(f"train phase (a) ({smi}): a step apart: value and gradients {res['grad_ms']:.1f} ms, "
          f"AdamW update {res['adamw_ms']:.1f} ms; one step traced: device busy {busy_ms:.1f} ms, "
          f"{len(kernels)} device kernels; by kernel:", flush=True)
    print_top(by_name, 1, "step", 12)
    return cfg, params, res


def train_card_vs_cpu(torch, smi: str) -> dict:
    """(b) The loss and every gradient of one full-width layer of
    Mistral-NeMo-12B on the card against the port on the CPU, the same
    float32 weights and batch. Fails beyond TRAIN_LOSS_REL, a cosine under
    TRAIN_GRAD_COS or a norm ratio off by more than TRAIN_NORM_RATIO."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.models import init_params
    from repro_torch.training import make_loss, value_and_grad
    from repro_torch.training.tree import flatten, unflatten

    cfg = dataclasses.replace(arch_config(get_config("mistral-nemo-12b"), 1), loss_chunk=0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    params = init_params(cfg, gen, device="cuda", dtype=torch.float32)
    cpu = unflatten(params, [p.cpu() for p in flatten(params)[1]])
    b = batch_at(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_CPU_SEQ, global_batch=1,
                            seed=2), 0)
    (lg, _), gg = value_and_grad(make_loss(cfg), params, {k: torch.from_numpy(v).cuda()
                                                          for k, v in b.items()})
    t0 = time.perf_counter()
    (lc, _), gc = value_and_grad(make_loss(cfg), cpu, {k: torch.from_numpy(v)
                                                       for k, v in b.items()})
    cpu_s = time.perf_counter() - t0
    rel = abs(float(lg) - float(lc)) / abs(float(lc))
    rows = []
    for path, a, c in zip(*flatten(gg), flatten(gc)[1]):
        a, c = a.double(), c.cuda().double()
        na, nc = float(a.norm()), float(c.norm())
        rows.append((path, float((a * c).sum()) / (na * nc), na / nc))
    print(f"train phase (b) ({smi}): one layer at full width, batch 1 x {TRAIN_CPU_SEQ}: loss "
          f"card {float(lg):.6f}, CPU {float(lc):.6f} (relative gap {rel:.2e}, allowed "
          f"{TRAIN_LOSS_REL}); the CPU's value and gradients in {cpu_s:.1f} s; per leaf "
          f"(gradient cosine, card/CPU norm): "
          + "; ".join(f"{p} {cos:.6f}, {r:.5f}" for p, cos, r in rows), flush=True)
    check(rel <= TRAIN_LOSS_REL, f"card and CPU losses differ by {rel}")
    for p, cos, r in rows:
        check(cos >= TRAIN_GRAD_COS and abs(r - 1) <= TRAIN_NORM_RATIO,
              f"{p}: the card's gradient against the CPU's: cosine {cos}, norm ratio {r}")
    return {"loss_rel": rel, "min_cos": min(r[1] for r in rows),
            "max_norm_off": max(abs(r[2] - 1) for r in rows), "cpu_s": cpu_s}


def train_resume_child(torch, layers=None) -> dict:
    """(c), in a child process with deterministic algorithms: RESUME_ARCH at
    full width, at ``layers`` of depth (None: all), 4 steps straight
    against 2 steps, a checkpoint,
    a restore into fresh tensors and 2 more. Returns the losses, whether
    every parameter and moment is equal bit for bit, and the checkpoint's
    size and times."""
    import shutil
    import tempfile
    from pathlib import Path

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.training import (OptConfig, init_train_state, make_train_step,
                                      restore_checkpoint, save_checkpoint,
                                      train_state_from_numpy, train_state_to_numpy)
    from repro_torch.training.tree import flatten

    torch.use_deterministic_algorithms(True)
    cfg = arch_config(get_config(RESUME_ARCH), layers or get_config(RESUME_ARCH).n_layers)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=RESUME_SEQ, global_batch=RESUME_BATCH,
                      seed=3)
    step = make_train_step(cfg, OptConfig(**RESUME_OPT))

    def fresh():
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        return init_train_state(cfg, gen, "cuda")

    gnorms = []

    def run(params, opt, start, n):
        losses = []
        for i in range(start, start + n):
            batch = {k: torch.from_numpy(v).cuda() for k, v in batch_at(dcfg, i).items()}
            params, opt, m = step(params, opt, batch)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
        return params, opt, losses

    t0 = time.perf_counter()
    p, o, straight = run(*fresh(), 0, 4)
    straight_s = time.perf_counter() - t0
    q, r, resumed = run(*fresh(), 0, 2)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        t0 = time.perf_counter()
        saved = train_state_to_numpy(q, r, cfg)
        save_checkpoint(tmp, 2, saved, extra={"data_step": 2})
        save_s = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in Path(tmp).rglob("*") if f.is_file())
        del q, r
        t0 = time.perf_counter()
        # into fresh tensors: the saved tree gives only the structure
        state, extra = restore_checkpoint(tmp, saved, device="cuda")
        del saved
        q, r = train_state_from_numpy(state, cfg, "cuda")
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    q, r, rest = run(q, r, extra["data_step"], 2)
    _, a = flatten({"params": p, "m": o["m"], "v": o["v"], "step": o["step"]})
    _, b = flatten({"params": q, "m": r["m"], "v": r["v"], "step": r["step"]})
    same = sum(bool(torch.equal(x, y)) for x, y in zip(a, b))
    return {"arch": cfg.name, "layers": cfg.n_layers,
            "params": sum(x.numel() for x in flatten(p)[1]),
            "losses_straight": straight, "losses_resumed": resumed + rest,
            "grad_norms": gnorms[:4],
            "leaves": len(a), "leaves_equal": same, "checkpoint_bytes": nbytes,
            "save_s": save_s, "restore_s": restore_s, "four_steps_s": straight_s,
            "removed": not os.path.exists(tmp)}


def train_resume(smi: str, layers=None) -> dict:
    """(c) in its child process (``--train-resume-child``), with
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8``: deterministic algorithms set in
    this process could move the serving phases' bits. Fails unless the
    losses and every parameter and moment are equal bit for bit."""
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    out = subprocess.run([sys.executable, os.path.abspath(__file__), "--train-resume-child",
                          *([str(layers)] if layers else [])],
                         capture_output=True, text=True, env=env, timeout=900)
    check(out.returncode == 0, f"the exact-resume child failed ({out.returncode}): "
          f"{out.stderr[-3000:]}")
    res = json.loads(out.stdout.strip().splitlines()[-1])
    print(f"train phase (c) ({smi}): {res['arch']} at full width, {res['layers']} layers "
          f"({res['params']:,} parameters), batch {RESUME_BATCH} x {RESUME_SEQ}, deterministic "
          f"algorithms: losses 4 straight {res['losses_straight']}, 2 + checkpoint + restore + 2 "
          f"{res['losses_resumed']}; grad norms {res['grad_norms']}; {res['leaves_equal']} of "
          f"{res['leaves']} leaves (parameters, "
          f"moments, step) bit for bit; checkpoint {res['checkpoint_bytes'] / 1e9:.2f} GB, save "
          f"{res['save_s']:.1f} s, restore {res['restore_s']:.1f} s, removed {res['removed']}; 4 "
          f"steps {res['four_steps_s']:.1f} s", flush=True)
    check(all(math.isfinite(v) for v in res["grad_norms"]), "exact resume: a gradient norm "
          f"overflowed ({res['grad_norms']}): its steps would be weight decay alone")
    check(res["losses_straight"] == res["losses_resumed"], "resumed losses differ")
    check(res["leaves_equal"] == res["leaves"], "resumed parameters or moments differ")
    check(res["removed"], "the checkpoint directory was not removed")
    return res


def train_serve(torch, cfg, params, sm_count, smi: str) -> dict:
    """(d) (a)'s trained weights through ``params_for_serving``, served on
    the paged lean engine (K7 admission, K2 decode, captured steps) against
    a ``ref`` engine on the same weights: the first decode tick's logits
    within the ref cross-check's rule, the greedy streams equal or parting
    at a near tie (``arch_streams``)."""
    from repro_torch.models import params_for_serving

    served = params_for_serving(params)
    prompts = arch_prompts(cfg.vocab_size, TRAIN_SERVE_PROMPTS, seed=11)
    runs = {}
    for backend in ("lean", "ref"):
        runs[backend] = arch_serve(torch, cfg, served, sm_count, backend, prompts,
                                   TRAIN_SERVE_TOKENS, chunked=False, cache_len=4096)
    (sl, el, cl), (sr, er, cr) = runs["lean"], runs["ref"]
    lean = torch.stack([el.rows[u][1] for u in range(len(prompts))])
    ref = torch.stack([er.rows[u][1] for u in range(len(prompts))])
    typical = ref.abs().median().item()
    atol = LOGIT_ATOL_FRAC * typical
    diff = (lean - ref).abs().max().item()
    div = arch_streams("train phase (d)", sl, el, sr, er)
    tc = path_counts("train phase (d)")
    print(f"train phase (d) ({smi}): the trained {cfg.n_layers} layers (bf16 matmul weights) "
          f"served, prompts {list(TRAIN_SERVE_PROMPTS)}, {TRAIN_SERVE_TOKENS} new tokens: lean "
          f"K7 {cl['K7']} launches ({tc['K7']} on the tensor cores), K2 {cl['K2']}; "
          f"decode captures {el.stats.decode_captures}, replays {el.stats.decode_replays}; first "
          f"decode tick max |logit lean - ref| {diff:.4f} (allowed {atol:.4f} + {LOGIT_RTOL} "
          f"|ref|, median |ref logit| {typical:.4f}); streams against ref: "
          + (", ".join(f"request {u} parts at token {j} (gap {g})" for u, j, g in div)
             or "equal"), flush=True)
    check(cl["K7"] == cfg.n_layers * len(prompts), f"K7 launched {cl['K7']} times")
    check(cl["K2"] == cfg.n_layers * el.stats.ticks and cl["K2"] > 0,
          f"K2 launched {cl['K2']} times over {el.stats.ticks} decode ticks")
    check(el.stats.decode_replays > 0, "train phase (d): no decode tick replayed a graph")
    check(torch.allclose(lean, ref, rtol=LOGIT_RTOL, atol=atol),
          f"trained weights: lean and ref first-tick logits differ by {diff}")
    return {"K7": cl["K7"], "K2": cl["K2"], "first_tick_gap": diff, "divergences": div}


def train_unit_sweep(torch, smi: str) -> dict:
    """(e) One train step of every configuration at full width, one stage
    unit deep (llama-3.2-vision fed the pipeline's stub image embeddings):
    two steps, the second timed; fails unless the loss and the gradient
    norm are finite and the parameters move."""
    import dataclasses

    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.training import OptConfig, init_train_state, make_train_step
    from repro_torch.training.tree import flatten

    out = {}
    for arch in ARCH_IDS:
        full = get_config(arch)
        pattern = full.stages[0][0]
        cfg = dataclasses.replace(full, n_layers=len(pattern), stages=((pattern, 1),))
        gen = torch.Generator(device="cuda")
        gen.manual_seed(4)
        torch.cuda.reset_peak_memory_stats()
        params, opt = init_train_state(cfg, gen, "cuda")
        n = sum(p.numel() for p in flatten(params)[1])
        seq = XLSTM_TRAIN_SEQ if arch == "xlstm-350m" else UNIT_SEQ
        dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=UNIT_BATCH,
                          img_tokens=cfg.cross_kv_len, d_model=cfg.d_model)
        step = make_train_step(cfg, OptConfig(**TRAIN_OPT))
        before = [params["layers"][0]["ln1"].clone(), params["final_norm"].clone()]
        ms, ms_out = [], []
        for i in range(2):
            batch = {k: torch.from_numpy(v).cuda() for k, v in batch_at(dcfg, i).items()}
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            params, opt, m = step(params, opt, batch)
            end.record()
            ms_out.append(m)
            ms.append((start, end))
        torch.cuda.synchronize()
        ms = [s.elapsed_time(e) for s, e in ms]
        losses = [float(m["loss"]) for m in ms_out]
        gnorms = [float(m["grad_norm"]) for m in ms_out]
        moved = [int((a != b).sum()) for a, b in zip(before, (params["layers"][0]["ln1"],
                                                               params["final_norm"]))]
        peak = torch.cuda.max_memory_allocated() / 1e9
        out[arch] = {"layers": cfg.n_layers, "params": n, "seq": seq, "losses": losses,
                     "grad_norms": gnorms, "step_ms": ms[1], "first_ms": ms[0], "peak_gb": peak}
        print(f"train phase (e) ({smi}): {arch}, one unit ({cfg.n_layers} layers, "
              f"{n / 1e9:.3f} B parameters), batch {UNIT_BATCH} x {seq}: loss "
              f"{losses[0]:.4f}, {losses[1]:.4f}; grad norm {gnorms[0]:.4f}, {gnorms[1]:.4f}; "
              f"step ms {ms[1]:.1f} (first {ms[0]:.1f}); peak {peak:.2f} GB; elements moved "
              f"(layer 0 ln1, final_norm) {moved}", flush=True)
        check(all(math.isfinite(v) for v in losses + gnorms), f"{arch}: non-finite training step")
        check(all(moved), f"{arch}: a step left the parameters where they were")
        del params, opt, before, ms_out
        torch.cuda.empty_cache()
    return out


def train_phase(torch, sm_count, smi: str, resume_layers=None) -> dict:
    """The training phase: (a) Mistral-NeMo-12B trained at full width,
    (b) the card's gradients against the CPU port's, (c) exact resume of
    xlstm-350m, (d) (a)'s weights served through K7 and K2 against ref,
    (e) one step of every configuration."""
    cfg, params, a = train_mistral(torch, smi)
    clock("train phase (b)")
    b = train_card_vs_cpu(torch, smi)
    clock("train phase (d)")
    d = train_serve(torch, cfg, params, sm_count, smi)
    del params
    clock("train phase (c)")
    c = train_resume(smi, resume_layers)
    clock("train phase (e)")
    e = train_unit_sweep(torch, smi)
    res = {"card": smi, "a": a, "b": b, "c": c, "d": d, "e": e}
    print(json.dumps({"train": res}), flush=True)
    return res


# ------------------------------------------------- sequence-parallel decode
SP_ARCH = "gemma3-4b"
SP_FILL = 400_000        # cur_len: at world 4 ranks 0-2 are full, rank 3 holds 6,784 keys
SP_NEW_TOKENS = 8
SP_MESH = (2, 2)         # world 4 on the one card, over gloo
SP_BLOCK = 16384         # positions of one seeded block of a global layer's cache
SP_SEED = 29
SP_TOKEN = 17            # the first decoded token's input
SP_ULPS = 2              # the attention output against the float32 oracle, in bf16 ulps
SP_K2_KEYS = (131072, 524288)   # a world-4 rank's shard, and the whole cache


def free_port() -> int:
    """A free TCP port on localhost, for a process group's rendezvous."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def sp_fill(torch, cfg, cache, offset: int):
    """Seeded bf16 K/V in every layer of ``cache``: a global layer's block
    ``[offset, offset + t)`` of the 524,288-position cache, by blocks of
    ``SP_BLOCK`` positions each drawn from its own seed (so any rank draws
    its block alone), valid below ``SP_FILL`` and zero past it; a window
    ring whole (``SP_FILL`` is past the window)."""
    from repro_torch.models import layer_kinds

    g = torch.Generator(device="cuda")
    for i, (kind, lc) in enumerate(zip(layer_kinds(cfg), cache)):
        for j, name in enumerate(("k", "v")):
            t = lc[name]
            B, H, S, d = t.shape
            if kind == "win":
                g.manual_seed(SP_SEED * 1_000_003 + 2 * i + j)
                t.copy_(torch.randn(t.shape, generator=g, device="cuda"))
                continue
            for start in range(offset, offset + S, SP_BLOCK):
                g.manual_seed(SP_SEED * 1_000_003 + 4096 * (2 * i + j + 1) + start // SP_BLOCK)
                blk = torch.randn((B, H, SP_BLOCK, d), generator=g, device="cuda")
                n = min(max(SP_FILL - start, 0), SP_BLOCK)
                dst = t[:, :, start - offset:start - offset + SP_BLOCK]
                dst.zero_()
                dst[:, :, :n].copy_(blk[:, :, :n])


class SpProbe:
    """Wraps the serve step's ``sp_decode_attention`` and the merge it
    calls: the first call's query and output (the first token's first
    global layer) are kept, and every merge is timed with CUDA events on
    the stream (no sync added). ``reverse`` plants the fault: each rank's
    sequence index reversed, both where the attention reads its offset and
    where the step writes the token."""

    def __init__(self, torch, reverse: bool = False):
        import repro_torch.core.distributed as cd
        import repro_torch.launch.serve_step as ss

        self.torch, self.cd, self.ss, self.first, self.events = torch, cd, ss, None, []
        self.saved = (ss.sp_decode_attention, cd.lean_merge_collective, cd.axis_index,
                      ss.axis_index)
        attn, merge, index = self.saved[:3]

        def sp_attention(q, *args, **kw):
            out = attn(q, *args, **kw)
            if self.first is None:
                self.first = (q.detach().clone(), out.detach().clone())
            return out

        def timed_merge(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = merge(*args, **kw)
            end.record()
            self.events.append((start, end))
            return out

        def reversed_index(mesh, axes):
            from repro_torch.launch.mesh import axis_size

            return axis_size(mesh, axes) - 1 - index(mesh, axes)

        ss.sp_decode_attention, cd.lean_merge_collective = sp_attention, timed_merge
        if reverse:
            cd.axis_index = ss.axis_index = reversed_index

    def merge_ms(self) -> list:
        self.torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]

    def close(self):
        (self.ss.sp_decode_attention, self.cd.lean_merge_collective, self.cd.axis_index,
         self.ss.axis_index) = self.saved


def sp_serve(torch, cfg, params, cache, step, steps: int = SP_NEW_TOKENS) -> dict:
    """Greedy decode of ``steps`` tokens from ``SP_TOKEN`` at position
    ``SP_FILL``: logits and tokens per step, step ms (synced), K2's
    launches."""
    from repro_torch.kernels import lean_decode as ld

    reset_launch_counts()
    tok = torch.full((1, 1), SP_TOKEN, dtype=torch.int32, device="cuda")
    logits, tokens, ms = [], [], []
    for t in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = step(params, cache, tok, SP_FILL + t)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        tokens.append(int(tok[0, 0]))
        logits.append(lg.float().cpu())
        tok = lg.argmax(-1)[:, None].to(torch.int32)
    counts = launch_counts()
    return {"logits": torch.cat(logits), "tokens": tokens, "ms": ms,
            "step_ms_p50": statistics.median(ms), "K2": counts["K2"],
            "K2_ring": ld.fused_ring_launches,
            "others": {k: v for k, v in counts.items() if k != "K2" and v}}


def sp_model(torch, cfg):
    """gemma3-4b's weights, seeded (bf16 matmul weights, float32 norms:
    what ``params_for_serving`` gives of float32 masters), on the card."""
    from repro_torch.models import init_params

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SP_SEED)
    return init_params(cfg, gen, device="cuda", dtype=torch.bfloat16)


def sp_rank(rank: int, world: int, port: int, out_dir: str):
    """One rank of run (c): gloo over CUDA tensors, a (data, model) mesh on
    the one card, ``decode_plan``'s plan for batch 1; this rank's blocks of
    the global layers' caches, the window rings whole; the greedy run, then
    one step of the planted fault (offsets reversed) on a fresh fill."""
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.distributed.sharding import choose_layout, decode_plan
    from repro_torch.launch.mesh import axis_index, init_distributed, make_mesh
    from repro_torch.launch.serve_step import make_serve_step
    from repro_torch.models import init_cache, layer_kinds

    init_distributed(rank, world, port, "gloo")
    try:
        cfg = get_config(SP_ARCH)
        mesh = make_mesh(SP_MESH, ("data", "model"), "cuda")
        plan = decode_plan(cfg, mesh, 1, choose_layout(cfg))
        S = SHAPES["long_500k"].seq_len
        block = S // world
        offset = axis_index(mesh, plan["seq_axes"]) * block
        params = sp_model(torch, cfg)
        kinds = layer_kinds(cfg)
        cache = init_cache(cfg, 1, block, device="cuda")     # the rings: the window's length
        sp_fill(torch, cfg, cache, offset)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step = make_serve_step(cfg, mesh, plan)
        probe = SpProbe(torch)
        try:
            run = sp_serve(torch, cfg, params, cache, step)
            run["merge_ms"] = probe.merge_ms()
            run["first"] = [t.cpu() for t in probe.first]
        finally:
            probe.close()
        run["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        first_global = kinds.index("attn")
        at = SP_FILL - offset
        if 0 <= at < block:       # the first token's K/V: the oracle needs it
            lc = cache[first_global]
            run["row"] = (lc["k"][:, :, at].cpu(), lc["v"][:, :, at].cpu())
        sp_fill(torch, cfg, cache, offset)
        probe = SpProbe(torch, reverse=True)
        try:
            bad_step = make_serve_step(cfg, mesh, plan)
            bad = sp_serve(torch, cfg, params, cache, bad_step, steps=1)
            run["fault"] = {"first": [t.cpu() for t in probe.first], "logits": bad["logits"]}
        finally:
            probe.close()
        run.update(plan=plan, offset=offset, coord=mesh.get_coordinate())
        torch.save(run, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def sp_k2(torch, sm_count: int, dev_name: str, smi: str) -> dict:
    """K2 in its dense form at gemma3-4b's geometry (Hq 16, Hkv 4, d 256,
    batch 1, tile 128) over ``SP_K2_KEYS``: held against its plain version
    at 131,072 keys (on the decode ring), timed at both beside its plain
    version, SDPA on the same K/V (the query heads folded into rows) and
    the byte bound."""
    from repro_torch.core.leantile import make_schedule
    from repro_torch.kernels import lean_decode as ld
    from repro_torch.kernels import ops

    Hq, Hkv, d, tile = 16, 4, 256, 128
    g, dt, elem = Hq // Hkv, torch.bfloat16, 2
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SP_SEED)
    dev = torch.device("cuda")
    out = {}
    for S in SP_K2_KEYS:
        q = torch.randn(1, Hq, d, generator=gen, device=dev).to(dt)
        k = torch.randn(1, Hkv, S, d, generator=gen, device=dev).to(dt)
        v = torch.randn(1, Hkv, S, d, generator=gen, device=dev).to(dt)
        sched = make_schedule([S], Hkv, tile, sm_count)
        seg_ctx = torch.full((Hkv,), S, dtype=torch.int32, device=dev)
        route = ops._dense_route(sched, S, dev)
        args = (q.reshape(Hkv, g, d).contiguous(), k.reshape(Hkv * S // tile, tile, d),
                v.reshape(Hkv * S // tile, tile, d), seg_ctx, route, sched, 1.0 / math.sqrt(d))
        ring0 = ld.fused_ring_launches
        o, lse = ld.lean_decode_fused(*args)
        torch.cuda.synchronize()
        check(ld.fused_ring_launches == ring0 + 1, f"K2 at {S} keys did not run on the ring")
        err = None
        if S == SP_K2_KEYS[0]:
            o_ref, lse_ref = ld.lean_decode_fused_plain(*args)
            err = max((o - o_ref).abs().max().item(), (lse - lse_ref).abs().max().item())
            check(torch.allclose(o, o_ref, atol=BF16_TOL, rtol=BF16_TOL)
                  and torch.allclose(lse, lse_ref, atol=BF16_TOL, rtol=BF16_TOL),
                  f"K2 (d 256, {S} keys) disagrees with its plain version: max |err| {err}")
            del o_ref, lse_ref
        ms = gpu_ms(lambda: ld.lean_decode_fused(*args))
        plain_ms = gpu_ms(lambda: ld.lean_decode_fused_plain(*args), reps=3, warmup=1)
        qf = q.reshape(1, Hkv, g, d)
        lib_ms = gpu_ms(lambda: sdpa(qf, k, v))
        tokens = S * Hkv
        nbytes = 2 * tokens * d * elem + q.numel() * elem + 4 * (o.numel() + lse.numel())
        b_ms, b_by = bound(dev_name, "bfloat16", nbytes, 4 * g * d * tokens)
        out[S] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
                  "bound_by": b_by, "max_abs_err": err, "pieces": sched.num_pieces}
        print(f"  K2 dense @ {SP_ARCH} (4, 256), {S} keys ({smi}): {ms:.4f} ms (bound "
              f"{b_ms:.4f} ms by {b_by}; plain {plain_ms:.3f} ms; SDPA {lib_ms:.4f} ms); "
              + (f"max|err| vs plain {err:.3e}" if err is not None else "timed only")
              + f"; {sched.num_pieces} pieces on {sm_count} workers", flush=True)
        del q, k, v, args, o, lse
    return out


SP_TRACED_STEPS = 2


def sp_traced_steps(torch, cfg, params, cache, step, smi: str) -> dict:
    """Where a step of run (b) goes: ``SP_TRACED_STEPS`` more steps (after
    the run's 8, at the next positions) under ``torch.profiler``: device
    busy per step, device kernels and host launch calls per step, the
    device's idle share, the kernels with the most device time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    tok = torch.full((1, 1), SP_TOKEN, dtype=torch.int32, device="cuda")
    walls = []
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for t in range(SP_TRACED_STEPS):
            t0 = time.perf_counter()
            step(params, cache, tok, SP_FILL + SP_NEW_TOKENS + t)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    kernels, busy_ms, by_name = device_time(prof)
    calls = sum(host_launch_calls(prof).values())
    n = SP_TRACED_STEPS
    out = {"wall_ms": statistics.median(walls), "busy_ms": busy_ms / n,
           "kernels": len(kernels) / n, "host_launch_calls": calls / n,
           "idle_traced": 1 - busy_ms / sum(walls)}
    print(f"sp (b) traced ({smi}): {n} steps, wall p50 {out['wall_ms']:.2f} ms; device busy "
          f"{out['busy_ms']:.2f} ms/step; {out['kernels']:.0f} device kernels and "
          f"{out['host_launch_calls']:.0f} host launch calls a step; device idle share "
          f"{out['idle_traced']:.3f}", flush=True)
    print_top(by_name, n, "step", 8)
    return out


def bf16_ulps(torch, got, ref) -> float:
    """The largest |got - ref| in bf16 ulps of ref, the ulp taken at each
    element's magnitude floored at 2**-8 of the tensor's root mean square
    (an element next to 0 is held to the float32 noise of the row's
    scale, not to its own ulp)."""
    ref = ref.float()
    mag = ref.abs().clamp_min(2.0 ** -8 * ref.pow(2).mean().sqrt().item())
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return ((got.float() - ref).abs() / ulp).max().item()


def sp_oracle(torch, q, k_full, v_full):
    """The first global layer's attention over the 524,288-position cache
    with ``SP_FILL + 1`` valid keys, plain and float32 throughout: one
    ``chunk_partial`` over every position, finalized."""
    from repro_torch.core.attention import chunk_partial
    from repro_torch.core.merge import finalize

    B, Hq, d = q.shape
    Hkv = k_full.shape[1]
    qg = q.to("cuda").float().reshape(B, Hkv, Hq // Hkv, d)
    part = chunk_partial(qg, k_full.float(), v_full.float(), 1.0 / math.sqrt(d),
                         valid_len=SP_FILL + 1)
    return finalize(part).reshape(B, Hq, d)


def sp_streams(ref, run, what: str) -> list:
    """Greedy streams equal, or parting only where the reference's top-2
    logits are an exact tie; returns the parting steps."""
    parts = []
    for t, (a, b) in enumerate(zip(ref["tokens"], run["tokens"])):
        if a != b:
            top2 = ref["logits"][t - 1].topk(2).values
            check(t > 0 and top2[0].item() == top2[1].item(),
                  f"{what}: the greedy stream parts from (a)'s at step {t} (top-2 "
                  f"{top2.tolist()})")
            parts.append(t)
            break
    return parts


def sp_phase(torch, sm_count: int, smi: str) -> dict:
    """Sequence-parallel decode: gemma3-4b at full width and depth with
    long_500k's 524,288-position cache, its 6 global layers' K/V filled
    with seeded values to ``SP_FILL``, the 28 window rings too; 8 greedy
    tokens in three runs on the same weights and cache contents: (a) world
    1, ``mesh=None`` (the plain ``decode_step``); (b) world 1 over NCCL,
    plan ``seq_all`` (K2 over all 524,288 keys, a trivial merge); (c) world
    4 on the one card over gloo, ``decode_plan``'s ``seq_all`` on a (2, 2)
    mesh (K2 over each rank's 131,072 keys, the merge as two all-reduces).
    Four ranks share the card's SMs: (c)'s times say nothing of scaling."""
    import shutil
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.launch.serve_step import make_serve_step
    from repro_torch.models import count_params, init_cache, layer_kinds

    dev_name = torch.cuda.get_device_name(0)
    print(f"sp phase ({smi}): K2 at {SP_ARCH}'s global layers", flush=True)
    k2 = sp_k2(torch, sm_count, dev_name, smi)
    cfg = get_config(SP_ARCH)
    S = SHAPES["long_500k"].seq_len
    kinds = layer_kinds(cfg)
    first_global = kinds.index("attn")
    n_global = kinds.count("attn")
    params = sp_model(torch, cfg)
    cache = init_cache(cfg, 1, S, device="cuda")
    runs = {}

    def fresh():
        sp_fill(torch, cfg, cache, 0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    clock("sp phase (a)")
    fresh()
    runs["a"] = sp_serve(torch, cfg, params, cache, plain_step(torch, cfg))
    runs["a"]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    check(runs["a"]["K2"] == 0 and not runs["a"]["others"],
          f"(a) the plain step launched kernels: {runs['a']}")
    print(f"sp (a) world 1, mesh=None ({smi}): {count_params(cfg)} parameters, {cfg.n_layers} "
          f"layers ({n_global} global over {S} positions), step ms "
          + ", ".join(f"{t:.1f}" for t in runs["a"]["ms"])
          + f"; p50 {runs['a']['step_ms_p50']:.2f}; peak {runs['a']['peak_gb']:.2f} GB; tokens "
          f"{runs['a']['tokens']}", flush=True)

    clock("sp phase (b)")
    fresh()
    init_distributed(0, 1, free_port(), "nccl")
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        plan = {"mode": "seq_all", "seq_axes": ("data", "model"), "batch_spec": None}
        probe = SpProbe(torch)
        step = make_serve_step(cfg, mesh, plan)
        try:
            runs["b"] = sp_serve(torch, cfg, params, cache, step)
            runs["b"]["merge_ms"] = probe.merge_ms()
            b_first = probe.first
        finally:
            probe.close()
        runs["b"]["traced"] = sp_traced_steps(torch, cfg, params, cache, step, smi)
    finally:
        dist.destroy_process_group()
    runs["b"]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    k_full = cache[first_global]["k"].clone()
    v_full = cache[first_global]["v"].clone()
    del params, cache
    clock("sp phase (b): the oracle")
    oracle_b = sp_oracle(torch, b_first[0], k_full, v_full)
    ulps_b = bf16_ulps(torch, b_first[1], oracle_b)
    b = runs["b"]
    print(f"sp (b) world 1, NCCL, plan seq_all ({smi}): step ms "
          + ", ".join(f"{t:.1f}" for t in b["ms"]) + f"; p50 {b['step_ms_p50']:.2f}; K2 "
          f"{b['K2']} launches ({b['K2_ring']} on the ring); merge per global layer p50 "
          f"{statistics.median(b['merge_ms']):.3f} ms; peak {b['peak_gb']:.2f} GB; first "
          f"global layer against the float32 oracle: {ulps_b:.3f} bf16 ulps", flush=True)
    check(b["K2"] == n_global * SP_NEW_TOKENS == b["K2_ring"] and not b["others"],
          f"(b): K2 launched {b['K2']} times ({b['K2_ring']} on the ring), expected "
          f"{n_global} x {SP_NEW_TOKENS}; others {b['others']}")

    clock("sp phase (c)")
    world = SP_MESH[0] * SP_MESH[1]
    out_dir = tempfile.mkdtemp(prefix="sp_ranks_")
    try:
        t0 = time.perf_counter()
        mp.spawn(sp_rank, args=(world, free_port(), out_dir), nprocs=world, join=True)
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                 for r in range(world)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    owner = next(r for r in ranks if "row" in r)
    kr, vr = owner["row"]
    k_full[:, :, SP_FILL] = kr.to("cuda")
    v_full[:, :, SP_FILL] = vr.to("cuda")
    q_c = ranks[0]["first"][0]
    oracle_c = sp_oracle(torch, q_c, k_full, v_full)
    ulps_c = [bf16_ulps(torch, r["first"][1].cuda(), oracle_c) for r in ranks]
    fault_ulps = [bf16_ulps(torch, r["fault"]["first"][1].cuda(),
                            sp_oracle(torch, r["fault"]["first"][0], k_full, v_full))
                  for r in ranks]
    del k_full, v_full
    for r, res in enumerate(ranks):
        print(f"sp (c) rank {r} at {tuple(res['coord'])}, plan {res['plan']['mode']}, keys "
              f"[{res['offset']}, {res['offset'] + S // world}) ({smi}): step ms "
              + ", ".join(f"{t:.1f}" for t in res["ms"]) + f"; p50 {res['step_ms_p50']:.2f}; "
              f"K2 {res['K2']} launches ({res['K2_ring']} on the ring); merge per global layer "
              f"p50 {statistics.median(res['merge_ms']):.3f} ms; peak {res['peak_gb']:.2f} GB; "
              f"first global layer {ulps_c[r]:.3f} bf16 ulps from the oracle; planted fault "
              f"(offsets reversed) {fault_ulps[r]:.1f} ulps", flush=True)
    print(f"sp (c): four ranks share the card's SMs and gloo stages every all-reduce through "
          f"the host: these times say nothing about scaling; spawn + run {spawn_s:.1f} s",
          flush=True)
    for r, res in enumerate(ranks):
        check(res["plan"]["mode"] == "seq_all",
              f"decode_plan gave {res['plan']} for batch 1 on {SP_MESH}")
        check(res["K2"] == n_global * SP_NEW_TOKENS == res["K2_ring"] and not res["others"],
              f"(c) rank {r}: K2 launched {res['K2']} times ({res['K2_ring']} on the ring), "
              f"others {res['others']}")
        check(torch.equal(res["logits"], ranks[0]["logits"]) and res["tokens"] ==
              ranks[0]["tokens"], f"(c): rank {r}'s logits differ from rank 0's")
    check(all(u <= SP_ULPS for u in [ulps_b] + ulps_c),
          f"the first global layer's attention: (b) {ulps_b}, (c) {ulps_c} bf16 ulps from the "
          f"float32 oracle (allowed {SP_ULPS})")
    check(all(u > SP_ULPS for u in fault_ulps),
          f"the planted fault (offsets reversed) passed the oracle check: {fault_ulps} ulps")

    a, c = runs["a"], ranks[0]
    ref0 = a["logits"][0]
    typical = ref0.abs().median().item()
    atol = LOGIT_ATOL_FRAC * typical
    gaps = {}
    for name, run in (("b", b), ("c", c), ("fault", {"logits": c["fault"]["logits"]})):
        gaps[name] = (run["logits"][0] - ref0).abs().max().item()
    print(f"sp first-token logits against (a) (median |logit| {typical:.4f}, allowed "
          f"{atol:.4f} + {LOGIT_RTOL} |ref|): (b) {gaps['b']:.4f}, (c) {gaps['c']:.4f}; the "
          f"planted fault {gaps['fault']:.4f}", flush=True)
    for name, run in (("b", b), ("c", c)):
        check(torch.allclose(run["logits"][0], ref0, rtol=LOGIT_RTOL, atol=atol),
              f"({name})'s first-token logits differ from (a)'s by {gaps[name]}")
    parts = {name: sp_streams(a, run, f"({name})") for name, run in (("b", b), ("c", c))}
    print(f"sp streams: (a) {a['tokens']}; (b) {b['tokens']}; (c) {c['tokens']}; parting "
          f"{parts}", flush=True)
    res = {
        "card": smi, "arch": SP_ARCH, "positions": S, "cur_len": SP_FILL,
        "new_tokens": SP_NEW_TOKENS, "world4_mesh": list(SP_MESH),
        "step_ms_p50": {"a": a["step_ms_p50"], "b": b["step_ms_p50"],
                        "c": [r["step_ms_p50"] for r in ranks]},
        "merge_ms_p50": {"b": statistics.median(b["merge_ms"]),
                         "c": [statistics.median(r["merge_ms"]) for r in ranks]},
        "peak_gb": {"a": a["peak_gb"], "b": b["peak_gb"], "c": [r["peak_gb"] for r in ranks]},
        "traced_b": b["traced"],
        "ulps": {"b": ulps_b, "c": ulps_c, "fault": fault_ulps},
        "first_token_logit_gap": gaps, "parts": parts,
        "launches": {"K2_524288": b["K2"], "K2_131072": sum(r["K2"] for r in ranks)},
        "k2": {str(S_): r for S_, r in k2.items()},
    }
    print(json.dumps({"sp": res}), flush=True)
    return res


# ---------------------------------------------------------- tensor-parallel serving
TP_ARCH = "mistral-nemo-12b"
TP_MOE_ARCH = "qwen3-moe-30b-a3b"
TP_MOE_DEPTH = 16        # of qwen3-moe's 48: at model 2 the four ranks hold the model twice
TP_BATCH, TP_PROMPT, TP_CACHE, TP_NEW_TOKENS = 4, 1024, 4096, 16
TP_SEED = 30
# run -> (architecture, mesh over (data, model)); world 4 on the one card, gloo
TP_RUNS = {"b": (TP_ARCH, (1, 4)), "c": (TP_ARCH, (2, 2)), "d": (TP_MOE_ARCH, (2, 2))}
# each rank's first-layer K/V after prefill against its block of the world-1
# run's, in bf16 ulps (bf16_ulps): the same projections of the same
# embeddings, a GEMM over a block of the columns
TP_KV_ULPS = 2
TP_TIMED_STEPS = 2       # steps after the run with every reduction timed (synced)
TP_K2_KEYS = TP_PROMPT + TP_NEW_TOKENS


def plain_step(torch, cfg):
    """``decode_step`` with the plain attention (no ``attn_fn``): the oracle
    runs' serve step, every row at ``cur``."""
    from repro_torch.models import decode_step

    def step(params, cache, tok, cur):
        ctx = torch.full((tok.shape[0],), int(cur), dtype=torch.int32, device=tok.device)
        return decode_step(params, cfg, cache, tok, ctx_lens=ctx, cur_len=int(cur))

    return step


def tp_config(arch: str, layers: int):
    from repro_torch.configs import get_config

    return arch_config(get_config(arch), layers)


def tp_prompts(torch, cfg):
    g = torch.Generator().manual_seed(TP_SEED)
    return torch.randint(0, cfg.vocab_size, (TP_BATCH, TP_PROMPT), generator=g,
                         dtype=torch.int32)


def tp_params(torch, cfg, shard=None):
    """Seeded bf16 weights (float32 norms), drawn on the card leaf by leaf;
    with ``shard`` each rank keeps its block of a leaf as it is drawn."""
    from repro_torch.models import init_params

    gen = torch.Generator(device="cuda")
    gen.manual_seed(TP_SEED)
    return init_params(cfg, gen, device="cuda", dtype=torch.bfloat16, shard=shard)


def tp_serve(torch, params, prefill, step, prompts) -> tuple:
    """Prefill ``prompts`` (synced ms, K7's launches), then
    ``TP_NEW_TOKENS`` greedy steps (synced ms each, K2's launches); the
    first logits, each step's logits and tokens, the first layer's K/V over
    the prompt. Returns ``(run, cache, cur)``."""
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first, cache, cur = prefill(params, prompts)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    pre = launch_counts()
    kv = [cache[0][n][:, :, :TP_PROMPT].contiguous() for n in ("k", "v")]
    reset_launch_counts()
    tok = first.argmax(-1)[:, None].to(torch.int32)
    logits, tokens, ms = [], [], []
    for t in range(TP_NEW_TOKENS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = step(params, cache, tok, cur + t)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        tokens.append(tok[:, 0].cpu())
        logits.append(lg.float().cpu())
        tok = lg.argmax(-1)[:, None].to(torch.int32)
    dec = launch_counts()
    run = {"first": first.float().cpu(), "logits": torch.stack(logits),
           "tokens": torch.stack(tokens), "prefill_ms": prefill_ms, "ms": ms,
           "step_ms_p50": statistics.median(ms), "K7": pre["K7"], "K2": dec["K2"],
           "others": {k: v for k, v in dec.items() if k != "K2" and v},
           "prefill_others": {k: v for k, v in pre.items() if k != "K7" and v}, "kv": kv}
    return run, cache, cur


def tp_reduce_ms(torch, params, cache, step, cur, tok) -> list:
    """``TP_TIMED_STEPS`` more steps with every row-parallel reduction
    timed on the host clock between two syncs: ms per reduction."""
    from repro_torch.distributed import tensor_parallel as tpm

    saved, times = tpm.TensorParallel.row_sum, []

    def timed(self, x):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = saved(self, x)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return y

    tpm.TensorParallel.row_sum = timed
    try:
        for t in range(TP_TIMED_STEPS):
            step(params, cache, tok, cur + TP_NEW_TOKENS + t)
    finally:
        tpm.TensorParallel.row_sum = saved
    return times


def tp_rank(rank: int, world: int, port: int, out_dir: str, arch: str, layers: int, shape):
    """One rank of a tensor-parallel run: gloo over CUDA tensors, a (data,
    model) mesh on the one card, ``decode_plan``'s plan (it must be
    ``heads``); its blocks of the weights (each leaf drawn whole from the
    shared seed, its block kept, the rest freed, one leaf at a time), its
    rows of the prompts; the prefill and greedy run, its first-layer K/V
    against its block of the world-1 run's (``cache_specs`` +
    ``shard_of``), and the planted fault: the model group's KV-head blocks
    rotated by one rank."""
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    from repro_torch.core.distributed import shard_of
    from repro_torch.distributed.sharding import (P, cache_specs, choose_layout, decode_plan,
                                                  param_specs, spec_paths)
    from repro_torch.distributed.tensor_parallel import abstract_params
    from repro_torch.launch.mesh import axis_group, axis_index, init_distributed, make_mesh
    from repro_torch.launch.serve_step import make_prefill_step, make_serve_step

    init_distributed(rank, world, port, "gloo")
    try:
        cfg = tp_config(arch, layers)
        mesh = make_mesh(shape, ("data", "model"), "cuda")
        layout = choose_layout(cfg)
        plan = decode_plan(cfg, mesh, TP_BATCH, layout)
        if plan["mode"] != "heads":
            raise RuntimeError(f"decode_plan gave {plan} for {arch} at batch {TP_BATCH} on {shape}")
        specs = spec_paths(param_specs(abstract_params(cfg), mesh, cfg, layout, mode="serve"))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = tp_params(torch, cfg, shard=lambda path, t: shard_of(t, specs[path], mesh).clone())
        torch.cuda.synchronize()
        weights = {"s": time.perf_counter() - t0, "gb": torch.cuda.memory_allocated() / 1e9,
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        rows = shard_of(tp_prompts(torch, cfg), P(plan["batch_spec"], None), mesh).cuda()
        step = make_serve_step(cfg, mesh, plan, layout)
        prefill = make_prefill_step(cfg, TP_CACHE, mesh, plan, layout)
        if cfg.moe is not None and rank == 0:
            # the prefill's MoE calls (every data rank's rows: the global
            # batch's routing), for the router witness against world 1
            done = {}
            calls = router_calls(torch, cfg, lambda: done.update(
                zip(("run", "cache", "cur"), tp_serve(torch, params, prefill, step, rows))))
            run, cache, cur = done["run"], done["cache"], done["cur"]
            torch.save(tp_router_record(torch, calls, cfg), os.path.join(out_dir, "calls.pt"))
            del calls
        else:
            run, cache, cur = tp_serve(torch, params, prefill, step, rows)
        tok = run["tokens"][-1][:, None].cuda()
        run["reduce_ms"] = tp_reduce_ms(torch, params, cache, step, cur, tok)
        run["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        # the first layer's K/V over the prompt against (a)'s block
        want = torch.load(os.path.join(out_dir, "a_kv.pt"))
        spec = cache_specs([{"k": want[0]}], mesh, TP_BATCH, layout, plan,
                           cache_len=TP_PROMPT)[0]["k"]
        group = axis_group(mesh, "model")
        ulps, fault = [], []
        for got, whole in zip(run.pop("kv"), want):
            mine = shard_of(whole, spec, mesh).cuda()
            ulps.append(bf16_ulps(torch, got, mine))
            blocks = [torch.empty_like(got) for _ in range(mesh.size(1))]
            dist.all_gather(blocks, got, group=group)
            m = axis_index(mesh, "model")
            fault.append(bf16_ulps(torch, blocks[(m + 1) % len(blocks)], mine))
        run.update(plan=plan, spec=tuple(spec), kv_ulps=max(ulps), fault_ulps=min(fault),
                   weights=weights, coord=(axis_index(mesh, "data"), axis_index(mesh, "model")),
                   rows=tuple(rows.shape))
        torch.save(run, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def tp_router_record(torch, calls, cfg) -> list:
    """The prefill's MoE calls of :func:`router_calls` (its first
    ``n_layers``), on the host, the inputs in bf16."""
    return [(x.to("cpu", dtype=torch.bfloat16), p.cpu(), i.cpu())
            for x, p, i in calls[:cfg.n_layers]]


def tp_k2_k7(torch, sm_count: int, dev_name: str, smi: str) -> dict:
    """K2 (dense form) and K7 at a ``(1, 4)`` rank's geometry of
    Mistral-NeMo-12B (Hq 8, Hkv 2, d 128, batch 4): K2 over ``TP_K2_KEYS``
    keys of a ``TP_CACHE``-position cache, K7 causal over the 1024-token
    prompts; each against its plain version, timed beside the plain
    version, SDPA on the same inputs and the bound."""
    from repro_torch.core.leantile import make_schedule
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import lean_decode as ld
    from repro_torch.kernels import ops

    B, Hq, Hkv, d, tile = TP_BATCH, 8, 2, 128, 128
    g, dt, elem = Hq // Hkv, torch.bfloat16, 2
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda")
    gen.manual_seed(TP_SEED)
    dev = torch.device("cuda")
    out = {}
    # K2: the serve step's decode of one global layer after the 16th token
    S, n = TP_CACHE, TP_K2_KEYS
    q = torch.randn(B, Hq, d, generator=gen, device=dev).to(dt)
    k = torch.randn(B, Hkv, S, d, generator=gen, device=dev).to(dt)
    v = torch.randn(B, Hkv, S, d, generator=gen, device=dev).to(dt)
    sched = make_schedule([n] * B, Hkv, tile, sm_count)
    seg_ctx = torch.full((B * Hkv,), n, dtype=torch.int32, device=dev)
    route = ops._dense_route(sched, S, dev)
    args = (q.reshape(B * Hkv, g, d).contiguous(), k.reshape(B * Hkv * S // tile, tile, d),
            v.reshape(B * Hkv * S // tile, tile, d), seg_ctx, route, sched, 1.0 / math.sqrt(d))
    o, lse = ld.lean_decode_fused(*args)
    o_ref, lse_ref = ld.lean_decode_fused_plain(*args)
    torch.cuda.synchronize()
    err = max((o - o_ref).abs().max().item(), (lse - lse_ref).abs().max().item())
    check(torch.allclose(o, o_ref, atol=BF16_TOL, rtol=BF16_TOL)
          and torch.allclose(lse, lse_ref, atol=BF16_TOL, rtol=BF16_TOL),
          f"K2 at the tensor-parallel rank geometry disagrees with its plain version: {err}")
    ms = gpu_ms(lambda: ld.lean_decode_fused(*args))
    plain_ms = gpu_ms(lambda: ld.lean_decode_fused_plain(*args), reps=3, warmup=1)
    qf = q.reshape(B, Hkv, g, d)
    kn, vn = k[:, :, :n], v[:, :, :n]
    lib_ms = gpu_ms(lambda: sdpa(qf, kn, vn))
    nbytes = 2 * B * Hkv * n * d * elem + q.numel() * elem + 4 * (o.numel() + lse.numel())
    b_ms, b_by = bound(dev_name, "bfloat16", nbytes, 4 * g * d * n * B * Hkv)
    out["K2"] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
                 "bound_by": b_by, "max_abs_err": err}
    print(f"  K2 dense @ {TP_ARCH} (1, 4) rank (B {B}, Hq {Hq}, Hkv {Hkv}, d {d}), {n} of {S} "
          f"keys ({smi}): {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}; plain {plain_ms:.3f} ms; "
          f"SDPA {lib_ms:.4f} ms); max|err| vs plain {err:.3e}; {sched.num_pieces} pieces on "
          f"{sm_count} workers", flush=True)
    del q, k, v, args, o, lse, o_ref, lse_ref
    # K7: the rank's causal prefill of the prompts
    L = TP_PROMPT
    q = torch.randn(B, Hq, L, d, generator=gen, device=dev).to(dt)
    k = torch.randn(B, Hkv, L, d, generator=gen, device=dev).to(dt)
    v = torch.randn(B, Hkv, L, d, generator=gen, device=dev).to(dt)
    fp.reset_launch_counts()
    o = fp.flash_prefill(q, k, v, causal=True)
    o_ref = fp.flash_prefill_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    check(fp.dense_tc_launches == fp.dense_launches == 1,
          "K7 at the tensor-parallel rank geometry did not take the tensor cores")
    err = (o.float() - o_ref.float()).abs().max().item()
    step = torch.finfo(torch.bfloat16).eps * o_ref.float().abs()
    check(bool(((o.float() - o_ref.float()).abs() <= step + BF16_TOL).all()),
          f"K7 at the tensor-parallel rank geometry disagrees with its plain version: {err}")
    ms = gpu_ms(lambda: fp.flash_prefill(q, k, v, causal=True))
    plain_ms = gpu_ms(lambda: fp.flash_prefill_plain(q, k, v, causal=True), reps=3, warmup=1)
    lib_ms = gpu_ms(lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True))
    flops = 4 * B * Hq * d * visible_keys(L, L, True, None)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * elem
    b_ms, b_by = bound(dev_name, "bfloat16", nbytes, flops)
    out["K7"] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
                 "bound_by": b_by, "max_abs_err": err}
    print(f"  K7 @ {TP_ARCH} (1, 4) rank (B {B}, Hq {Hq}, Hkv {Hkv}, d {d}), causal {L} "
          f"({smi}): {ms:.4f} ms, {flops / ms / 1e9:.1f} TFLOP/s (bound {b_ms:.4f} ms by "
          f"{b_by}; plain {plain_ms:.3f} ms; SDPA {lib_ms:.4f} ms); max|err| vs plain "
          f"{err:.3e}", flush=True)
    return out


def tp_streams(ref, run, rows, what: str, hold: bool = True) -> list:
    """``run``'s greedy streams against ``ref``'s rows: equal, or parting
    first where the logits that chose the token had a top-2 gap within
    GUARD_NEAR_TIE. Returns ``[(row, step, gap)]`` of the partings."""
    parts = []
    want = ref["tokens"][:, rows]
    for b in range(want.shape[1]):
        diff = (run["tokens"][:, b] != want[:, b]).nonzero()
        if not len(diff):
            continue
        t = int(diff[0])
        lg = ref["first"][rows][b] if t == 0 else ref["logits"][t - 1][rows][b]
        top2 = lg.topk(2).values
        gap = (top2[0] - top2[1]).item()
        parts.append((b, t, gap))
        check(not hold or gap <= GUARD_NEAR_TIE,
              f"{what}: row {b}'s greedy stream parts from the world-1 run's at step {t}, top-2 "
              f"gap {gap} (allowed {GUARD_NEAR_TIE})")
    return parts


def tp_world4(torch, arch: str, layers: int, shape, a_kv) -> tuple:
    """Spawn the four ranks of a run; their results by rank, the wall s and
    (a MoE model) rank 0's prefill MoE calls."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    out_dir = tempfile.mkdtemp(prefix="tp_ranks_")
    try:
        torch.save([t.cpu() for t in a_kv], os.path.join(out_dir, "a_kv.pt"))
        t0 = time.perf_counter()
        mp.spawn(tp_rank, args=(4, free_port(), out_dir, arch, layers, shape), nprocs=4,
                 join=True)
        wall = time.perf_counter() - t0
        path = os.path.join(out_dir, "calls.pt")
        calls = torch.load(path) if os.path.exists(path) else None
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(4)], wall, calls
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def tp_phase(torch, sm_count: int, smi: str, depths=None) -> dict:
    """Tensor-parallel serving (plan ``heads``): K2 and K7 at a (1, 4)
    rank's geometry, then Mistral-NeMo-12B at full width and depth, batch 4,
    1024-token prompts, a 4096-position cache, 16 greedy tokens: (a) world
    1, the whole weights, ``make_prefill_step`` + ``decode_step`` with the
    plain attention (the oracle); (b) world 4 on the one card over gloo,
    mesh (1, 4); (c) mesh (2, 2), the rows split over data; and
    qwen3-moe-30b-a3b at full width, ``TP_MOE_DEPTH`` layers: its world-1
    run, then (d) mesh (2, 2) (EP: 64 experts a rank). Each world-4 run:
    the first-token logits against its world-1 run's, the streams, the
    model groups' logits bit for bit, each rank's first-layer K/V against
    its block of the world-1 run's and the planted head rotation, K2's and
    K7's launches per rank. Four ranks share the card's SMs and gloo stages
    through the host: the world-4 times say nothing about scaling.
    ``depths`` ({architecture: layers}) cuts the models' depths (the full
    run's ``FULL_RUN_DEPTH``); by default Mistral-NeMo-12B's 40 and
    qwen3-moe's ``TP_MOE_DEPTH``."""
    from repro_torch.launch.serve_step import make_prefill_step

    dev_name = torch.cuda.get_device_name(0)
    print(f"tp phase ({smi}): K2 and K7 at the (1, 4) rank geometry", flush=True)
    kern = tp_k2_k7(torch, sm_count, dev_name, smi)
    res = {"card": smi, "kernels": kern, "runs": {}}
    depths = depths or {TP_ARCH: 40, TP_MOE_ARCH: TP_MOE_DEPTH}
    for arch in (TP_ARCH, TP_MOE_ARCH):
        cfg = tp_config(arch, depths[arch])
        clock(f"tp phase: {arch} world 1")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = tp_params(torch, cfg)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        prompts = tp_prompts(torch, cfg).cuda()
        done = {}
        serve = lambda: done.update(zip(("a", "cache"), tp_serve(
            torch, params, make_prefill_step(cfg, TP_CACHE), plain_step(torch, cfg), prompts)))
        a_calls = None
        if cfg.moe is not None:
            a_calls = tp_router_record(torch, router_calls(torch, cfg, serve), cfg)
        else:
            serve()
        a, cache = done["a"], done["cache"]
        a["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        a_kv = [t.cpu() for t in a.pop("kv")]
        del params, cache
        torch.cuda.empty_cache()
        name = "a" if arch == TP_ARCH else "a_moe"
        check(a["K2"] == 0 and not a["others"],
              f"({name}) the plain decode launched kernels: K2 {a['K2']}, {a['others']}")
        print(f"tp ({name}) world 1, {arch} at {cfg.n_layers} layers ({smi}): weights {init_s:.1f} "
              f"s; prefill {a['prefill_ms']:.1f} ms (K7 {a['K7']} launches); step p50 "
              f"{a['step_ms_p50']:.2f} ms; peak {a['peak_gb']:.2f} GB; tokens "
              f"{a['tokens'].T.tolist()}", flush=True)
        ref0 = a["first"]
        typical = ref0.abs().median().item()
        atol = LOGIT_ATOL_FRAC * typical
        res["runs"][name] = {"arch": arch, "layers": cfg.n_layers,
                             "prefill_ms": a["prefill_ms"], "step_ms_p50": a["step_ms_p50"],
                             "peak_gb": a["peak_gb"], "K7": a["K7"]}
        for run_name, (run_arch, shape) in TP_RUNS.items():
            if run_arch != arch:
                continue
            clock(f"tp phase ({run_name})")
            ranks, wall, calls = tp_world4(torch, arch, cfg.n_layers, shape, a_kv)
            # each rank's rows of the batch: its data index's block
            rows_of = [slice(x["coord"][0] * x["rows"][0], (x["coord"][0] + 1) * x["rows"][0])
                       for x in ranks]
            gaps = [(x["first"] - ref0[rows]).abs().max().item()
                    for x, rows in zip(ranks, rows_of)]
            witness = None
            if calls is not None and max(gaps) > atol:
                # a MoE run parting from world 1 past the bound: the first
                # routing difference must be a router near tie
                witness = router_witness(torch, cfg, [tuple(t.cuda() for t in c) for c in calls],
                                         [tuple(t.cuda() for t in c) for c in a_calls],
                                         f"({run_name}) rank 0 against ({name})", 0)
            parts = []
            for r, (x, rows, gap) in enumerate(zip(ranks, rows_of, gaps)):
                d = x["coord"][0]
                check(x["plan"]["mode"] == "heads", f"({run_name}) rank {r}: plan {x['plan']}")
                check(x["K7"] == cfg.n_layers and not x["prefill_others"],
                      f"({run_name}) rank {r}: K7 launched {x['K7']} times in the prefill, "
                      f"expected {cfg.n_layers}; others {x['prefill_others']}")
                check(x["K2"] == cfg.n_layers * TP_NEW_TOKENS and not x["others"],
                      f"({run_name}) rank {r}: K2 launched {x['K2']} times, expected "
                      f"{cfg.n_layers} x {TP_NEW_TOKENS}; others {x['others']}")
                peer = next(y for y in ranks if y["coord"][0] == d)
                check(all(torch.equal(x[k], peer[k]) for k in ("first", "logits", "tokens")),
                      f"({run_name}) rank {r}'s logits differ from its model group's")
                if witness is None:
                    check(torch.allclose(x["first"], ref0[rows], rtol=LOGIT_RTOL, atol=atol),
                          f"({run_name}) rank {r}'s first-token logits differ from the world-1 "
                          f"run's by {gap} (allowed {atol:.4f} + {LOGIT_RTOL} |ref|)")
                else:      # past a router flip: the MoE phase's bound for lean against ref
                    check(gap <= QWEN3_FIRST_LOGIT_GAP,
                          f"({run_name}) rank {r}'s first-token logits differ from the world-1 "
                          f"run's by {gap} past a router flip (bound {QWEN3_FIRST_LOGIT_GAP})")
                parts.append(tp_streams(a, x, rows, f"({run_name}) rank {r}",
                                        hold=witness is None))
                check(x["kv_ulps"] <= TP_KV_ULPS,
                      f"({run_name}) rank {r}'s first-layer K/V are {x['kv_ulps']} bf16 ulps "
                      f"from its block of the world-1 run's (allowed {TP_KV_ULPS})")
                check(x["fault_ulps"] > TP_KV_ULPS,
                      f"({run_name}) rank {r}: the rotated head blocks passed the K/V check "
                      f"({x['fault_ulps']} ulps)")
                red = statistics.median(x["reduce_ms"])
                per_step = len(x["reduce_ms"]) / TP_TIMED_STEPS
                print(f"tp ({run_name}) rank {r} at {tuple(x['coord'])} of {shape}, rows "
                      f"{rows.start}-{rows.stop - 1} ({smi}): weights {x['weights']['gb']:.2f} GB "
                      f"in {x['weights']['s']:.1f} s (peak {x['weights']['peak_gb']:.2f} GB); "
                      f"prefill {x['prefill_ms']:.1f} ms (K7 {x['K7']}); step p50 "
                      f"{x['step_ms_p50']:.2f} ms (K2 {x['K2']}); reduction p50 {red:.3f} ms, "
                      f"{per_step:.0f} a step ({red * per_step / cfg.n_layers:.3f} ms a layer); "
                      f"peak {x['peak_gb']:.2f} GB; first-token gap {gap:.4f}; K/V "
                      f"{x['kv_ulps']:.3f} ulps, rotated {x['fault_ulps']:.1f}", flush=True)
            streams = torch.cat([x["tokens"] for x in ranks[::shape[1]]], 1).T.tolist()
            print(f"tp ({run_name}): four ranks share the card's SMs and gloo stages every "
                  f"collective through the host: these times say nothing about scaling; spawn + "
                  f"run {wall:.1f} s; streams {streams}; partings {parts}; first-token logits "
                  f"allowed {atol:.4f} + {LOGIT_RTOL} |ref|", flush=True)
            res["runs"][run_name] = {
                "arch": arch, "mesh": list(shape), "wall_s": wall,
                "prefill_ms": [x["prefill_ms"] for x in ranks],
                "step_ms_p50": [x["step_ms_p50"] for x in ranks],
                "reduce_ms_p50": [statistics.median(x["reduce_ms"]) for x in ranks],
                "peak_gb": [x["peak_gb"] for x in ranks],
                "weights_gb": [x["weights"]["gb"] for x in ranks],
                "K2": [x["K2"] for x in ranks], "K7": [x["K7"] for x in ranks],
                "first_token_gap": gaps, "kv_ulps": [x["kv_ulps"] for x in ranks],
                "fault_ulps": [x["fault_ulps"] for x in ranks], "partings": parts,
                "router_witness": witness}
    res["launches"] = {"K2": sum(res["runs"]["b"]["K2"]), "K7": sum(res["runs"]["b"]["K7"])}
    print(json.dumps({"tp": res}), flush=True)
    return res


# ------------------------------------------------- FSDP x TP training
FSDP_ARCH = "mistral-nemo-12b"
# of 40 (2.43 B parameters; four ranks share the card's 80 GB): the
# embedding's lookup gathers only the rows the tokens hit, and the loss keeps
# the gathered unembedding in bf16 with one float32 gradient
FSDP_LAYERS = 4
# the train phase's data-pipeline batches of 2048 tokens, 4 rows: with
# grad_accum 2 a micro-batch of 2 rows splits over data=2 in (b); over
# data=4 in (c) it does not split, so (c) runs every row on every rank and
# sums no gradient
FSDP_BATCH, FSDP_SEQ, FSDP_ACCUM, FSDP_STEPS = 4, TRAIN_SEQ, 2, 2
FSDP_OPT = TRAIN_OPT
FSDP_SEED = 31
FSDP_MESHES = {"b": (2, 2), "c": (4, 1), "d": (2, 2)}
# (d): xlstm-350m under dp_only, 4 rows of 128 tokens in one micro-batch:
# one row a rank over (data, model). Its world-1 oracle runs the same rows
# one a micro-batch (grad_accum 4, the same function): sLSTM's recurrence
# amplifies a GEMM's rounding, and a 4-row product rounds otherwise than a
# rank's 1-row one (world 1 at grad_accum 1 parts by 2e-3 in the loss)
FSDP_XLSTM, FSDP_XLSTM_BATCH = "xlstm-350m", 4
FSDP_SAMPLES = 16        # elements a leaf, whole-leaf coordinates, seeded
FSDP_PLANTED = "layers/0/ln1"
# tests/_torch_train.py's tolerances
FSDP_LOSS_RTOL, FSDP_GNORM_RTOL, FSDP_GRAD_NORM, FSDP_GRAD_ELEM = 2e-4, 5e-3, 0.02, 2.0 ** -4
FSDP_PARAM_ATOL, FSDP_FIRM_M = 1e-6, 1e-5
# (e): pipeline_forward over pod=4, one decoder layer a stage
PIPE_M, PIPE_MB, PIPE_SEQ = 6, 1, 512
PIPE_TOL = 2.0 ** -8     # of the largest |output|: one rounding of a bf16 product's size


def _sync(torch, dev: str):
    if dev == "cuda":
        torch.cuda.synchronize()


def fsdp_samples(shape, seed: int):
    """FSDP_SAMPLES whole-leaf coordinates of a leaf of ``shape``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, n, FSDP_SAMPLES) for n in shape], 1) if shape else \
        np.zeros((1, 0), dtype=np.int64)


class FsdpRecorder:
    """Wraps ``train_loop.adamw_update`` to record, per step and leaf, the
    gradient's sum of squares (float64, over the blocks this rank owns)
    and largest |element| (over its blocks), and its sampled elements this
    rank holds; after the update the sampled parameters and moments and
    the first moment's largest |element|. With ``fs`` (the rank's FSDP
    context) the leaves are its blocks, else whole. ``planted`` also
    records the planted leaf's gradient summed over ``model`` (the fault)."""

    def __init__(self, torch, like, fs=None, planted=None):
        import numpy as np

        from repro_torch.launch.mesh import axis_index, axis_size
        from repro_torch.training.tree import flatten

        self.torch, self.fs, self.planted, self.steps = torch, fs, planted, []
        self.where = {}
        for k, (path, leaf) in enumerate(zip(*flatten(like))):
            idx = fsdp_samples(tuple(leaf.shape), 1000 + k)
            local, held = idx.copy(), np.ones(len(idx), bool)
            if fs is not None:
                for d, axes in enumerate(fs.train[path]):
                    if axes is None:
                        continue
                    b = leaf.shape[d] // axis_size(fs.mesh, axes)
                    held &= idx[:, d] // b == axis_index(fs.mesh, axes)
                    local[:, d] = idx[:, d] % b
            self.where[path] = (np.nonzero(held)[0], local[held])

    def _take(self, t, path):
        rows, local = self.where[path]
        if not len(rows):
            return rows, []
        return rows, t[tuple(self.torch.from_numpy(local.T.copy()).to(t.device))].double().cpu() \
            .tolist()

    def wrap(self, update):
        from repro_torch.training.tree import flatten

        torch = self.torch

        def recorded(grads, opt, params, cfg, shards=None):
            rec = {"g": {}}
            for path, g in zip(*flatten(grads)):
                own = self.fs is None or self.fs.owns(path)
                rec["g"][path] = {"sq": float(g.double().square().sum()) if own else 0.0,
                                  "amax": float(g.abs().max()), "at": self._take(g, path)}
                if self.planted and path == self.planted and self.fs.model_group is not None:
                    bad = g.clone()
                    torch.distributed.all_reduce(bad, group=self.fs.model_group)
                    rec["planted"] = {"sq": float(bad.double().square().sum()) if own else 0.0,
                                      "at": self._take(bad, path)}
            params, opt, m = update(grads, opt, params, cfg, shards)
            rec["p"] = {p: self._take(t, p) for p, t in zip(*flatten(params))}
            rec["m"] = {p: self._take(t, p) + (float(t.abs().max()),)
                        for p, t in zip(*flatten(opt["m"]))}
            rec["v"] = {p: self._take(t, p) + (float(t.abs().max()),)
                        for p, t in zip(*flatten(opt["v"]))}
            rec["lr"] = float(m["lr"])
            self.steps.append(rec)
            return params, opt, m

        return recorded


@contextlib.contextmanager
def recording(rec):
    from repro_torch.training import train_loop

    saved = train_loop.adamw_update
    train_loop.adamw_update = rec.wrap(saved)
    try:
        yield rec
    finally:
        train_loop.adamw_update = saved


def fsdp_batches(cfg, batch: int, seq: int, n: int, dev: str):
    import torch

    from repro_torch.data.pipeline import DataConfig, batch_at

    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch, seed=7)
    return [{k: torch.from_numpy(v).to(dev) for k, v in batch_at(dc, i).items()} for i in range(n)]


def fsdp_run(torch, cfg, params, opt, step, batches, rec, dev: str, stats_from: int = 99) -> dict:
    """``len(batches)`` steps; each one's metrics and synced ms, and
    (from step ``stats_from``) the collectives' breakdown."""
    from repro_torch.distributed import tensor_parallel as tpm

    out = {"metrics": [], "ms": [], "collectives": []}
    with recording(rec):
        for i, batch in enumerate(batches):
            tpm.collective_stats = {} if i >= stats_from else None
            _sync(torch, dev)
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            _sync(torch, dev)
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            out["metrics"].append({k: float(v) for k, v in m.items()})
            out["collectives"].append(tpm.collective_stats)
            tpm.collective_stats = None
    out["steps"] = rec.steps
    return out, params, opt


def fsdp_world1(torch, cfg, batches, accum: int, seed: int, dev: str, ckpt=None) -> dict:
    """The oracle: ``make_train_step`` on one device (the train phase's), its
    gradients and updates recorded; with ``ckpt`` its state after step 1
    saved there (a one-device save)."""
    from repro_torch.training import (OptConfig, init_train_state, make_train_step,
                                      save_checkpoint, train_state_to_numpy)

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    params, opt = init_train_state(cfg, gen, dev)
    rec = FsdpRecorder(torch, params)
    step = make_train_step(cfg, OptConfig(**FSDP_OPT), grad_accum=accum)
    out, params, opt = fsdp_run(torch, cfg, params, opt, step, batches[:1], rec, dev)
    if ckpt is not None:
        save_checkpoint(ckpt, 1, train_state_to_numpy(params, opt, cfg), extra={"data_step": 1})
    rest, params, opt = fsdp_run(torch, cfg, params, opt, step, batches[1:], rec, dev)
    for k in ("metrics", "ms", "collectives"):
        out[k] += rest[k]
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9 if dev == "cuda" else 0.0
    del params, opt
    return out


def leaf_fingerprint(torch, x, offsets, whole_shape) -> int:
    """Sum of every element's bits times a hash of its whole-leaf flat
    index, mod 2**64: the blocks of a tiling add up to the whole leaf's,
    whatever the tiling."""
    strides = [1] * len(whole_shape)
    for d in range(len(whole_shape) - 2, -1, -1):
        strides[d] = strides[d + 1] * whole_shape[d + 1]
    dev = x.device
    if x.ndim == 0:
        x, offsets, strides = x.reshape(1, 1), (0, 0), (1, 1)
    elif x.ndim == 1:
        x, offsets, strides = x.reshape(-1, 1), (offsets[0], 0), (strides[0], 1)
    inner = torch.zeros((), dtype=torch.int64, device=dev)
    for d in range(1, x.ndim):
        ar = (torch.arange(x.shape[d], device=dev) + offsets[d]) * strides[d]
        inner = (inner.unsqueeze(-1) + ar)
    inner = inner.reshape(-1)
    flat = x.reshape(x.shape[0], -1)
    total = torch.zeros((), dtype=torch.int64, device=dev)
    chunk = max(1, (1 << 24) // max(1, flat.shape[1]))
    for r0 in range(0, flat.shape[0], chunk):
        rows = torch.arange(r0, min(r0 + chunk, flat.shape[0]), device=dev)
        idx = (rows + offsets[0])[:, None] * strides[0] + inner[None, :] + 1
        h = idx * -7046029254386353131
        h = h ^ (h >> 31)
        total += (flat[r0:r0 + len(rows)].contiguous().view(torch.int32).to(torch.int64) * h).sum()
    return int(total) % (1 << 64)


def state_fingerprints(torch, fs, params, opt) -> dict:
    """Each leaf's fingerprint over the blocks this rank owns (its first
    replica), for the parameters and both moments."""
    from repro_torch.launch.mesh import axis_index, axis_size
    from repro_torch.training.tree import flatten

    out = {}
    for name, tree in (("params", params), ("m", opt["m"]), ("v", opt["v"])):
        for path, t in zip(*flatten(tree)):
            if not fs.owns(path):
                continue
            spec = fs.train[path]
            whole = [n * (axis_size(fs.mesh, a) if a else 1) for n, a in zip(t.shape, spec)]
            offs = [(axis_index(fs.mesh, a) * n if a else 0) for n, a in zip(t.shape, spec)]
            out[f"{name}/{path}"] = leaf_fingerprint(torch, t, offs, whole)
    return out


def fsdp_config(arch: str, layers, smoke: bool):
    from repro_torch.configs import get_config, get_smoke_config

    if smoke:
        return get_smoke_config(arch)
    return arch_config(get_config(arch), layers) if layers else get_config(arch)


def pipe_config(smoke: bool):
    """(e)'s model: the architecture's first four layers (attention)."""
    import dataclasses

    base = fsdp_config(FSDP_ARCH, None, smoke)
    return dataclasses.replace(base, n_layers=4, stages=(((base.stages[0][0][0],), 4),))


def _stage_layer(stage: int):
    """The shard hook that keeps layer ``stage``'s leaves (and no other)."""
    prefix = f"layers/{stage}/"
    return lambda path, t: t if path.startswith(prefix) else t.new_empty(0)


def pipe_stage_fn(cfg):
    """A stage of (e): one decoder layer's whole-sequence forward (the
    plain attention, bf16 weights), no gradient."""
    import torch

    from repro_torch.models.transformer import _layer_forward, _plain_attn

    attn = _plain_attn(cfg, PIPE_SEQ)

    def fn(lp, x, stage):
        with torch.no_grad():
            return _layer_forward(lp, x, "attn", cfg, None, attn)[0]

    return fn


def pipe_input(torch, cfg, dev):
    g = torch.Generator(device=dev)
    g.manual_seed(FSDP_SEED + 2)
    return torch.randn(PIPE_M, PIPE_MB, PIPE_SEQ, cfg.d_model, generator=g, device=dev)


def pipe_params(torch, cfg, dev, shard=None):
    from repro_torch.models import init_params

    g = torch.Generator(device=dev)
    g.manual_seed(FSDP_SEED + 1)
    return init_params(cfg, g, device=dev, dtype=torch.bfloat16, shard=shard)


def fsdp_rank(rank: int, world: int, port: int, out_dir: str, layers: int, dev: str,
              smoke: bool, b_steps: int = FSDP_STEPS, xlstm_layers=None):
    """One rank of the FSDP phase: (b) FSDP x TP on (2, 2), its state
    after step 1 saved; (c) restored onto (4, 1) and its step 2; (d)
    xlstm-350m under dp_only on (2, 2); (e) pipeline_forward over pod=4."""
    import torch
    import torch.distributed as dist

    if dev == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.set_device(0)
    else:
        torch.set_num_threads(1)
    from repro_torch.distributed.fsdp import FSDP
    from repro_torch.distributed.pipeline import bubble_fraction, pipeline_forward
    from repro_torch.distributed.tensor_parallel import abstract_params
    from repro_torch.launch.mesh import axis_index, init_distributed, make_mesh
    from repro_torch.training import (OptConfig, init_train_state, make_train_step,
                                      restore_checkpoint, save_checkpoint,
                                      train_state_from_numpy, train_state_shardings)

    init_distributed(rank, world, port, "gloo")
    try:
        res = {}
        cfg = fsdp_config(FSDP_ARCH, layers, smoke)
        batches = fsdp_batches(cfg, FSDP_BATCH, FSDP_SEQ, FSDP_STEPS, dev)
        like = abstract_params(cfg)
        opt_cfg = OptConfig(**FSDP_OPT)
        # (b) FSDP x TP on (data=2, model=2)
        mesh = make_mesh(FSDP_MESHES["b"], ("data", "model"), dev)
        fs = FSDP(cfg, mesh, "2d")
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=dev)
        gen.manual_seed(FSDP_SEED)
        t0 = time.perf_counter()
        params, opt = init_train_state(cfg, gen, dev, shard=fs.block)
        _sync(torch, dev)
        init_s = time.perf_counter() - t0
        state_gb = torch.cuda.memory_allocated() / 1e9 if dev == "cuda" else 0.0
        rec = FsdpRecorder(torch, like, fs, planted=FSDP_PLANTED)
        step = make_train_step(cfg, opt_cfg, grad_accum=FSDP_ACCUM, mesh=mesh, layout="2d")
        b, params, opt = fsdp_run(torch, cfg, params, opt, step, batches[:1], rec, dev,
                                  stats_from=0 if b_steps == 1 else 1)
        fp_saved = state_fingerprints(torch, fs, params, opt)
        ckpt = os.path.join(out_dir, "ckpt")
        _sync(torch, dev)
        t0 = time.perf_counter()
        state, shardings = train_state_shardings(params, opt, cfg, fs.train_specs)
        save_checkpoint(ckpt, 1, state, shardings=shardings, mesh=mesh, extra={"data_step": 1})
        save_s = time.perf_counter() - t0
        del state
        b2, params, opt = fsdp_run(torch, cfg, params, opt, step, batches[1:b_steps], rec, dev,
                                   stats_from=0)
        for k in ("metrics", "ms", "collectives"):
            b[k] += b2[k]
        b.update(steps=rec.steps, init_s=init_s, state_gb=state_gb, save_s=save_s,
                 peak_gb=torch.cuda.max_memory_allocated() / 1e9 if dev == "cuda" else 0.0,
                 coord=(axis_index(mesh, "data"), axis_index(mesh, "model")))
        res["b"] = b
        del params, opt, step, rec
        if dev == "cuda":
            torch.cuda.empty_cache()
        # (c) restored onto (data=4, model=1): pure FSDP, its step 2
        mesh_c = make_mesh(FSDP_MESHES["c"], ("data", "model"), dev)
        fc = FSDP(cfg, mesh_c, "2d")
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        meta = {"m": like, "v": like, "step": torch.zeros((), dtype=torch.int32, device="meta")}
        like_state, specs_c = train_state_shardings(like, meta, cfg, fc.train_specs)
        t0 = time.perf_counter()
        restored, extra = restore_checkpoint(ckpt, like_state, device=dev, shardings=specs_c,
                                             mesh=mesh_c)
        params, opt = train_state_from_numpy(restored, cfg, dev)
        _sync(torch, dev)
        restore_s = time.perf_counter() - t0
        del restored
        fp_restored = state_fingerprints(torch, fc, params, opt)
        rec = FsdpRecorder(torch, like, fc)
        step = make_train_step(cfg, opt_cfg, grad_accum=FSDP_ACCUM, mesh=mesh_c, layout="2d")
        c, params, opt = fsdp_run(torch, cfg, params, opt, step,
                                  batches[extra["data_step"]:extra["data_step"] + 1], rec, dev,
                                  stats_from=0)
        c.update(restore_s=restore_s, step_count=1, fp_saved=fp_saved, fp_restored=fp_restored,
                 peak_gb=torch.cuda.max_memory_allocated() / 1e9 if dev == "cuda" else 0.0,
                 coord=(axis_index(mesh_c, "data"), axis_index(mesh_c, "model")))
        res["c"] = c
        del params, opt, step, rec
        if dev == "cuda":
            torch.cuda.empty_cache()
        dist.barrier()
        if rank == 0:
            import shutil

            shutil.rmtree(ckpt, ignore_errors=True)
        # (d) xlstm-350m under dp_only on (2, 2)
        cfg_d = fsdp_config(FSDP_XLSTM, xlstm_layers, smoke)
        fd = FSDP(cfg_d, mesh, "dp_only")
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=dev)
        gen.manual_seed(FSDP_SEED)
        params, opt = init_train_state(cfg_d, gen, dev, shard=fd.block)
        like_d = abstract_params(cfg_d)
        rec = FsdpRecorder(torch, like_d, fd)
        step = make_train_step(cfg_d, opt_cfg, grad_accum=1, mesh=mesh, layout="dp_only")
        batches_d = fsdp_batches(cfg_d, FSDP_XLSTM_BATCH, XLSTM_TRAIN_SEQ, FSDP_STEPS, dev)
        d, params, opt = fsdp_run(torch, cfg_d, params, opt, step, batches_d[:1], rec, dev)
        # step 2 from world 1's state after its step 1 (its one-device
        # checkpoint, restored onto this mesh): one step from one state
        # on both sides (sLSTM's recurrence amplifies any difference)
        del params, opt
        meta = {"m": like_d, "v": like_d, "step": torch.zeros((), dtype=torch.int32,
                                                              device="meta")}
        like_state, specs_d = train_state_shardings(like_d, meta, cfg_d, fd.train_specs)
        restored, _ = restore_checkpoint(os.path.join(out_dir, "d_ckpt"), like_state,
                                         device=dev, shardings=specs_d, mesh=mesh)
        params, opt = train_state_from_numpy(restored, cfg_d, dev)
        del restored
        d2, params, opt = fsdp_run(torch, cfg_d, params, opt, step, batches_d[1:], rec, dev,
                                   stats_from=0)
        for k in ("metrics", "ms", "collectives"):
            d[k] += d2[k]
        d.update(steps=rec.steps,
                 peak_gb=torch.cuda.max_memory_allocated() / 1e9 if dev == "cuda" else 0.0)
        res["d"] = d
        del params, opt, step, rec
        if dev == "cuda":
            torch.cuda.empty_cache()
        # (e) pipeline_forward over pod=4, one decoder layer a stage
        cfg_e = pipe_config(smoke)
        mesh_e = make_mesh((4,), ("pod",), dev)
        stage = axis_index(mesh_e, "pod")
        lp = pipe_params(torch, cfg_e, dev, shard=_stage_layer(stage))["layers"][stage]
        x = pipe_input(torch, cfg_e, dev)
        fn = pipe_stage_fn(cfg_e)
        _sync(torch, dev)
        dist.barrier()
        t0 = time.perf_counter()
        out = pipeline_forward(fn, lp, x, mesh_e, axis="pod")
        _sync(torch, dev)
        res["e"] = {"ms": (time.perf_counter() - t0) * 1e3, "stage": stage,
                    "out": out.cpu() if rank == 0 else None, "bubble": bubble_fraction(4, PIPE_M)}
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def fsdp_worst(steps, ref, lrs, start: int = 0, grads_only: bool = False) -> dict:
    """A sharded run's recorded steps (every rank's records) against the
    oracle's, each check's worst ratio to its tolerance (above 1 fails):
    per leaf the gradient's norm within FSDP_GRAD_NORM and each sampled
    element within FSDP_GRAD_ELEM of the leaf's largest; the sampled first
    and second moments within FSDP_GRAD_ELEM (twice for the second) of their
    leaves' largest; the sampled parameters by Adam's first-step rule at
    step 1 (firm elements within FSDP_PARAM_ATOL, all within 2 lr) and
    within 2 lr a step since the first after. ``steps[r][i]``: rank r's
    record of the oracle's step ``start + i``; ``ref``, ``lrs``: the
    oracle's steps and learning rates; ``grads_only``: the gradients'
    checks alone."""
    worst = {"g_norm": 0.0, "g_elem": 0.0}
    if not grads_only:
        worst.update(m_elem=0.0, v_elem=0.0, p_firm=0.0, p_bound=0.0)
    for i in range(len(steps[0])):
        want, t = ref[start + i], start + i
        move = 2 * sum(lrs[:t + 1]) * (1 + 1e-3) + FSDP_PARAM_ATOL
        for path in steps[0][i]["g"]:
            g = want["g"][path]
            sq = sum(r[i]["g"][path]["sq"] for r in steps)
            na, nb = math.sqrt(g["sq"]), math.sqrt(sq)
            if na > 0:
                worst["g_norm"] = max(worst["g_norm"], abs(nb / na - 1) / FSDP_GRAD_NORM)
            vals = dict(zip(*g["at"]))
            for r in steps:
                for k, x in zip(*r[i]["g"][path]["at"]):
                    worst["g_elem"] = max(worst["g_elem"], abs(x - vals[int(k)]) /
                                          (FSDP_GRAD_ELEM * g["amax"] or 1.0))
            if grads_only:
                continue
            m_rows, m_vals, m_amax = want["m"][path]
            v_rows, v_vals, v_amax = want["v"][path]
            p_vals = dict(zip(*want["p"][path]))
            m_at, v_at = dict(zip(m_rows, m_vals)), dict(zip(v_rows, v_vals))
            for r in steps:
                for k, x in zip(*r[i]["m"][path][:2]):
                    worst["m_elem"] = max(worst["m_elem"], abs(x - m_at[int(k)]) /
                                          (FSDP_GRAD_ELEM * m_amax or 1.0))
                for k, x in zip(*r[i]["v"][path][:2]):
                    worst["v_elem"] = max(worst["v_elem"], abs(x - v_at[int(k)]) /
                                          (2 * FSDP_GRAD_ELEM * v_amax or 1.0))
                for k, x in zip(*r[i]["p"][path]):
                    gap = abs(x - p_vals[int(k)])
                    worst["p_bound"] = max(worst["p_bound"], gap / move)
                    if t == 0 and abs(m_at[int(k)]) > max(FSDP_GRAD_ELEM * m_amax, FSDP_FIRM_M):
                        worst["p_firm"] = max(worst["p_firm"], gap / FSDP_PARAM_ATOL)
    return worst


def fsdp_metrics(runs, ref, what, start: int = 0) -> list:
    """Each step's loss, ce and grad_norm (the same on every rank) against
    the oracle's: the relative gaps."""
    gaps = []
    for i, got in enumerate(runs[0]["metrics"]):
        want = ref["metrics"][start + i]
        check(all(r["metrics"][i] == got for r in runs), f"{what}: ranks' metrics differ")
        gap = {k: abs(got[k] - want[k]) / abs(want[k]) for k in ("loss", "ce", "grad_norm")}
        check(gap["loss"] <= FSDP_LOSS_RTOL and gap["ce"] <= FSDP_LOSS_RTOL,
              f"{what} step {start + i + 1}: loss {got['loss']} against {want['loss']}")
        check(gap["grad_norm"] <= FSDP_GNORM_RTOL, f"{what} step {start + i + 1}: grad_norm "
              f"{got['grad_norm']} against {want['grad_norm']}")
        gaps.append({"step": start + i + 1, "loss": got["loss"], "want_loss": want["loss"],
                     "grad_norm": got["grad_norm"], "want_grad_norm": want["grad_norm"], **{
                         f"{k}_gap": v for k, v in gap.items()}})
    return gaps


def fsdp_collectives(run, step: int) -> dict:
    """A step's collectives: ms and GB per category."""
    st = run["collectives"][step] or {}
    return {k: {"calls": v[0], "gb": v[1] / 1e9, "ms": v[2] * 1e3} for k, v in st.items()}


def fsdp_phase(torch, smi: str, layers: int = FSDP_LAYERS, dev: str = "cuda",
               smoke: bool = False, b_steps: int = FSDP_STEPS, xlstm_layers=None) -> dict:
    """FSDP x TP training and the pipeline (item 16.1, 16.2), four ranks
    over gloo on the one card: (a) the world-1 oracle, Mistral-NeMo-12B at
    full width and ``layers`` deep, two steps of the one-device
    make_train_step;
    (b) the same on (data=2, model=2), layout "2d"; (c) (b)'s state after
    step 1 saved and restored onto (4, 1), its step 2; (d) xlstm-350m under
    dp_only on (2, 2) against its world-1 run; (e) pipeline_forward over
    pod=4, a decoder layer a stage, against the layers in sequence. Four
    ranks share the card's SMs and gloo stages every collective through the
    host: the times say nothing of scaling across cards. ``b_steps`` 1 (the
    full run) runs (b)'s first step alone; ``xlstm_layers`` cuts (d)'s
    depth (None: all 24)."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    from repro_torch.models import count_params

    t_phase = time.perf_counter()
    cfg = fsdp_config(FSDP_ARCH, layers, smoke)
    clock("fsdp phase (a)")
    a = fsdp_world1(torch, cfg, fsdp_batches(cfg, FSDP_BATCH, FSDP_SEQ, FSDP_STEPS, dev),
                    FSDP_ACCUM, FSDP_SEED, dev)
    n = count_params(cfg)
    tokens = FSDP_BATCH * FSDP_SEQ
    print(f"fsdp (a) world 1 ({smi}): {cfg.name} full width, {cfg.n_layers} of "
          f"{fsdp_config(FSDP_ARCH, None, smoke).n_layers} layers ({n:,} parameters), batch "
          f"{FSDP_BATCH} x {FSDP_SEQ}, grad_accum {FSDP_ACCUM}, OptConfig({FSDP_OPT}): loss "
          + ", ".join(f"{m['loss']:.6f}" for m in a["metrics"]) + "; grad norm "
          + ", ".join(f"{m['grad_norm']:.5f}" for m in a["metrics"]) + "; step ms "
          + ", ".join(f"{t:.1f}" for t in a["ms"]) + f"; peak {a['peak_gb']:.2f} GB", flush=True)
    cfg_d = fsdp_config(FSDP_XLSTM, xlstm_layers, smoke)
    clock("fsdp phase (d) world 1")
    out_dir = tempfile.mkdtemp(prefix="fsdp_ranks_")
    a_d = fsdp_world1(torch, cfg_d, fsdp_batches(cfg_d, FSDP_XLSTM_BATCH, XLSTM_TRAIN_SEQ,
                                                 FSDP_STEPS, dev), FSDP_XLSTM_BATCH, FSDP_SEED,
                      dev, ckpt=os.path.join(out_dir, "d_ckpt"))
    cfg_e = pipe_config(smoke)
    params = pipe_params(torch, cfg_e, dev)
    fn, x = pipe_stage_fn(cfg_e), pipe_input(torch, cfg_e, dev)
    _sync(torch, dev)
    t0 = time.perf_counter()
    seq = torch.stack([fn(params["layers"][3], fn(params["layers"][2], fn(
        params["layers"][1], fn(params["layers"][0], x[m], 0), 1), 2), 3) for m in range(PIPE_M)])
    _sync(torch, dev)
    seq_ms = (time.perf_counter() - t0) * 1e3
    seq = seq.cpu()
    del params, x
    if dev == "cuda":
        torch.cuda.empty_cache()
    clock("fsdp phase (b)-(e): four ranks")
    if dev == "cuda":
        print(f"fsdp phase: this process holds {torch.cuda.memory_allocated() / 1e9:.2f} GB "
              f"({torch.cuda.memory_reserved() / 1e9:.2f} reserved) as the ranks start", flush=True)
    # the ranks' allocators grow segments in place: four processes share the card
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        t0 = time.perf_counter()
        mp.spawn(fsdp_rank, args=(4, free_port(), out_dir, layers, dev, smoke, b_steps,
                                  xlstm_layers), nprocs=4, join=True)
        wall = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                 for r in range(4)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
        if alloc is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF", None)
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
    res = {"card": smi, "layers": cfg.n_layers, "params": n, "batch": [FSDP_BATCH, FSDP_SEQ],
           "grad_accum": FSDP_ACCUM, "wall_s": wall,
           "a": {"metrics": a["metrics"], "ms": a["ms"], "peak_gb": a["peak_gb"]}}
    lrs = [s["lr"] for s in a["steps"]]
    for name in ("b", "c", "d"):
        runs = [r[name] for r in ranks]
        ref = a_d if name == "d" else a
        gaps = fsdp_metrics(runs, ref, f"fsdp ({name})", start=int(name == "c"))
        worst = fsdp_worst([r["steps"] for r in runs], ref["steps"],
                           [s["lr"] for s in ref["steps"]], start=int(name == "c"))
        step_ms = [statistics.median(r["ms"]) for r in runs]
        tok = (FSDP_XLSTM_BATCH * XLSTM_TRAIN_SEQ) if name == "d" else tokens
        last = len(runs[0]["ms"]) - 1
        coll = [fsdp_collectives(r, last) for r in runs]
        res[name] = {"mesh": list(FSDP_MESHES[name]), "metric_gaps": gaps, "worst": worst,
                     "step_ms": [r["ms"] for r in runs], "step_ms_p50": step_ms,
                     "tokens_per_s": [tok / (t / 1e3) for t in step_ms],
                     "collectives_last_step": coll, "peak_gb": [r["peak_gb"] for r in runs]}
        for i, (r, c) in enumerate(zip(runs, coll)):
            print(f"fsdp ({name}) rank {i} on {tuple(FSDP_MESHES[name])} ({smi}): step ms "
                  + ", ".join(f"{t:.1f}" for t in r["ms"]) + f" (p50 {step_ms[i]:.1f}, "
                  f"{tok / (step_ms[i] / 1e3):.0f} tokens/s); the last step's collectives (each "
                  f"between two syncs): " + "; ".join(
                      f"{k} {v['calls']} calls, {v['gb']:.3f} GB, {v['ms']:.1f} ms"
                      for k, v in sorted(c.items())) + f"; peak {r['peak_gb']:.2f} GB",
                  flush=True)
        print(f"fsdp ({name}) against its world-1 run: " + "; ".join(
            f"step {g['step']}: loss {g['loss']:.6f} / {g['want_loss']:.6f} (gap {g['loss_gap']:.2e}, "
            f"allowed {FSDP_LOSS_RTOL}), grad_norm {g['grad_norm']:.5f} / "
            f"{g['want_grad_norm']:.5f} (gap {g['grad_norm_gap']:.2e}, allowed "
            f"{FSDP_GNORM_RTOL})" for g in gaps) + "; worst sample ratios to "
            "their tolerances " + ", ".join(f"{k} {v:.3f}" for k, v in worst.items()),
            flush=True)
        for k, v in worst.items():
            check(v <= 1.0, f"fsdp ({name}): {k} at {v:.3f} of its tolerance")
    b = [r["b"] for r in ranks]
    res["b"].update(init_s=[r["init_s"] for r in b], state_gb=[r["state_gb"] for r in b],
                    save_s=b[0]["save_s"])
    # the planted fault: the whole norm's gradient summed over model too
    planted = [[{"g": {FSDP_PLANTED: s["planted"]}} for s in r["steps"][:1]] for r in b]
    fault = fsdp_worst(planted, a["steps"], lrs, grads_only=True)
    check(max(fault.values()) > 1.0, f"fsdp: the planted wrong-axis gradient sum passed the "
          f"check: {fault}")
    res["planted"] = fault
    # (c)'s restored blocks against (b)'s saved state, leaf by leaf, bit for bit
    saved, restored = {}, {}
    for r in ranks:
        for k, v in r["c"]["fp_saved"].items():
            saved[k] = (saved.get(k, 0) + v) % (1 << 64)
        for k, v in r["c"]["fp_restored"].items():
            restored[k] = (restored.get(k, 0) + v) % (1 << 64)
    same = sum(saved[k] == restored.get(k) for k in saved)
    check(same == len(saved) == len(restored),
          f"fsdp (c): {len(saved) - same} of {len(saved)} restored leaves differ from the saved")
    res["c"].update(leaves_equal=same, leaves=len(saved), restore_s=ranks[0]["c"]["restore_s"])
    # (e)
    e = ranks[0]["e"]
    err = (e["out"] - seq).abs().max().item()
    scale = seq.abs().max().item()
    check(err <= PIPE_TOL * scale, f"fsdp (e): the pipeline's output is {err} from the "
          f"sequential layers' (allowed {PIPE_TOL} x {scale})")
    res["e"] = {"max_abs_err": err, "scale": scale, "ms": [r["e"]["ms"] for r in ranks],
                "sequential_ms": seq_ms, "bubble_fraction": e["bubble"]}
    print(f"fsdp (b) ({smi}): {cfg.name} weights drawn and cut in "
          + ", ".join(f"{t:.1f}" for t in res["b"]["init_s"]) + " s a rank, state "
          + ", ".join(f"{t:.2f}" for t in res["b"]["state_gb"]) + " GB a rank; planted fault ("
          f"{FSDP_PLANTED}'s gradient also summed over model) fails: worst ratios to the "
          "tolerances " + ", ".join(f"{k} {v:.2f}" for k, v in fault.items()), flush=True)
    print(f"fsdp (c) ({smi}): sharded save of step 1's state {res['b']['save_s']:.1f} s, restore "
          f"onto (4, 1) {res['c']['restore_s']:.1f} s; {same} of {len(saved)} leaves (parameters "
          f"and moments) bit for bit", flush=True)
    print(f"fsdp (e) ({smi}): pipeline_forward over pod=4, {PIPE_M} micro-batches of {PIPE_MB} x "
          f"{PIPE_SEQ}, one {cfg.name} layer a stage: max |pipeline - sequential| {err:.3e} "
          f"(allowed {PIPE_TOL} x {scale:.3f}); ms by rank " + ", ".join(
              f"{t:.1f}" for t in res["e"]["ms"]) + f", sequential {seq_ms:.1f}; bubble_fraction"
          f"(4, {PIPE_M}) = {e['bubble']:.4f}", flush=True)
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"fsdp phase: {res['phase_s']:.1f} s (four ranks {wall:.1f} s); four ranks share the "
          "card's SMs and gloo stages every collective through the host: these times say "
          "nothing of scaling across cards", flush=True)
    print(json.dumps({"fsdp": res}), flush=True)
    return res


# Depths the full run cuts to stay inside its 1200 s on a slow host: at the
# full depths (qwen3-moe's 48 layers, the recurrent models' 38 and 24, the
# captured-step bit checks at 20 of 40) one full run reached its summary at
# 889.2 s and another, on a slower host (build 221 s against 136), at 1222.9
# s; with qwen3 at 24, the recurrent models at 16 and the bit checks at 10,
# a third slow host (build 197 s) at 1134.4 s. So the full run also takes
# xlstm-350m's exact resume (train phase (c)) at 8 of its 24 layers and
# serves Mistral-NeMo-12B's spec, admission, obs and guards phases at 20 of
# its 40 layers ("mistral_late"). The phases alone (``--qwen3-step``,
# ``--recurrent-step``, ``--train-step``, ``--spec-step``,
# ``--admission-step``, ``--obs-step``, ``--guards-step``) keep their
# depths. With the tensor-parallel phase at its own depths (Mistral-NeMo-12B's
# 40 layers, qwen3-moe's 16) a full run reached its summary at 970.3 s, so
# the full run serves that phase at 10 and 8 layers ("tp", "tp_moe");
# ``--tp-step`` keeps 40 and 16. The FSDP phase took 288.4 s alone (2 layers,
# (b) two steps, xlstm-350m at 24 layers) and 183.4 s at 1 layer with (b)'s
# first step alone, before its lookup gathered only the rows its tokens hit
# and its loss gathered the unembedding as bf16; the full run takes it at 1
# layer, (b)'s first step, and (d)'s xlstm-350m at 8 of 24 layers (one whole
# unit of its 7 mLSTM and 1 sLSTM layers).
FULL_RUN_DEPTH = {"qwen3": 24, "recurrent": 8, "resume": 8, "mistral_late": 20, "tp": 10,
                  "tp_moe": 8, "fsdp": 1, "fsdp_xlstm": 8}

TICK_SOURCES = ("lean_decode.cu", "flash_prefill.cu")


def tick_p50(torch, sm_count) -> dict:
    """Mistral-NeMo-12B at full width and depth on the engine phase's paged
    lean engine: the decode tick p50 over its 4 requests (16 new tokens),
    eager and captured, the sources that engine launches (K7, K2) built
    first. ``--tick-p50 SRC`` imports the port from SRC: run parent,
    change, change, parent, one process each, to compare two trees' ticks
    on one card."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import init_params
    from repro_torch.serving.engine import DecodeEngine, Request

    build_s = build.build(TICK_SOURCES)
    cfg = get_config("mistral-nemo-12b")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = init_params(cfg, gen, device="cuda", dtype=torch.bfloat16)
    out = {"build_s": round(build_s, 1)}
    for captured in (False, True):
        eng = DecodeEngine(cfg, params, engine_config("lean", sm_count), device="cuda")
        eng.capture_decode = captured
        _, ticks, _ = drive(torch, eng, make_requests(Request, cfg.vocab_size, 16))
        out["captured_ms" if captured else "eager_ms"] = statistics.median(
            dt for dt, _ in ticks) * 1e3
        del eng
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] in (["--decode-kernel-times"], ["--prefill-kernel-times"]):
        src = os.path.abspath(sys.argv[2]) if len(sys.argv) > 2 else os.path.join(ROOT, "src")
        sys.path.insert(0, src)
        torch.backends.cuda.matmul.allow_tf32 = False
        sm_count = torch.cuda.get_device_properties(0).multi_processor_count
        if sys.argv[1] == "--decode-kernel-times":
            times = decode_kernel_times(torch, sm_count, src)
        else:
            times = prefill_kernel_times(torch, src)
        print(json.dumps({"card": nvidia_smi_line(), **times}))
        return 0
    if sys.argv[1:2] == ["--decode-ring-clocks"]:
        sm_count = torch.cuda.get_device_properties(0).multi_processor_count
        clocks = decode_ring_clocks(torch, sm_count)
        sm_clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                                   "--format=csv,noheader"], capture_output=True, text=True,
                                  timeout=60).stdout.strip()
        print(json.dumps({"card": nvidia_smi_line(), "sm clock (now, max)": sm_clock, **clocks}))
        return 0
    if sys.argv[1:2] in (["--row-kernel-outputs"], ["--decode-kernel-outputs"]):
        src = os.path.abspath(sys.argv[2])
        sys.path.insert(0, src)
        torch.backends.cuda.matmul.allow_tf32 = False
        if sys.argv[1] == "--row-kernel-outputs":
            row_kernel_outputs(torch, src, sys.argv[3])
        else:
            decode_kernel_outputs(torch, torch.cuda.get_device_properties(0).multi_processor_count,
                                  src, sys.argv[3])
        return 0
    if sys.argv[1:2] in (["--row-kernel-bits"], ["--decode-kernel-bits"]):
        which = sys.argv[1].split("-")[2]
        print(json.dumps({"card": nvidia_smi_line(),
                          **kernel_bits(torch, os.path.abspath(sys.argv[2]), which)}))
        return 0
    if sys.argv[1:2] == ["--tick-p50"]:
        if len(sys.argv) > 2:
            sys.path.insert(0, os.path.abspath(sys.argv[2]))
        torch.backends.cuda.matmul.allow_tf32 = False
        sm_count = torch.cuda.get_device_properties(0).multi_processor_count
        print(json.dumps({"card": nvidia_smi_line(), "src": sys.argv[2] if len(sys.argv) > 2
                          else "src", **tick_p50(torch, sm_count)}))
        return 0
    try:
        from repro_torch.configs import get_config
        from repro_torch.kernels import build
        from repro_torch.kernels import lean_decode as ld
        from repro_torch.models import init_params
        from repro_torch.serving.engine import DecodeEngine, Request
    except ImportError as exc:
        print(f"chip_smoke: the port's package is missing ({exc}); run from a "
              "checkout of the repository", file=sys.stderr)
        return 2

    if sys.argv[1:2] == ["--train-resume-child"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(json.dumps(train_resume_child(
            torch, int(sys.argv[2]) if len(sys.argv) > 2 else None)))
        return 0
    arch_alone = {"--arch-kernels", "--qwen3-step", "--gemma-step", "--arch-sweep",
                  "--recurrent-step", "--train-step", "--sp-step", "--tp-step"}
    if sys.argv[1:2] == ["--fsdp-step"]:
        # training launches no kernel: nothing to build
        torch.backends.cuda.matmul.allow_tf32 = False
        smi = nvidia_smi_line()
        print(f"device: {smi}; the FSDP phase launches no kernel (no build)", flush=True)
        clock("fsdp phase")
        fsdp_phase(torch, smi, int(sys.argv[2]) if len(sys.argv) > 2 else FSDP_LAYERS)
        clock("done")
        return 0
    if sys.argv[1:2] and sys.argv[1] in arch_alone:
        torch.backends.cuda.matmul.allow_tf32 = False
        sm_count = torch.cuda.get_device_properties(0).multi_processor_count
        smi = nvidia_smi_line()
        build_s = build.build()
        print(f"device: {smi}; build {build_s:.1f} s (" + ", ".join(
            f"{src} {t:.1f}" for src, t in sorted(build.source_seconds.items(),
                                                  key=lambda kv: kv[1])) + ")", flush=True)
        depth = int(sys.argv[2]) if len(sys.argv) > 2 else None
        if sys.argv[1] == "--arch-kernels":
            arch_kernel_phase(torch, sm_count, torch.cuda.get_device_name(0))
        elif sys.argv[1] == "--qwen3-step":
            qwen3_phase(torch, sm_count, smi, depth)
        elif sys.argv[1] == "--gemma-step":
            gemma_phase(torch, sm_count, smi, depth)
        elif sys.argv[1] == "--recurrent-step":
            recurrent_phase(torch, sm_count, smi, depth)
        elif sys.argv[1] == "--train-step":
            clock("train phase (a)")
            train_phase(torch, sm_count, smi)
        elif sys.argv[1] == "--sp-step":
            clock("sp phase")
            sp_phase(torch, sm_count, smi)
        elif sys.argv[1] == "--tp-step":
            clock("tp phase")
            tp_phase(torch, sm_count, smi)
        else:
            sweep_phase(torch, sm_count, smi)
        clock("done")
        return 0
    if sys.argv[1:2] == ["--prefix-step"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        sm_count = torch.cuda.get_device_properties(0).multi_processor_count
        smi = nvidia_smi_line()
        try:   # the engine's kernels load even where another source failed
            print(f"device: {smi}; build {build.build():.1f} s", flush=True)
        except RuntimeError as exc:
            print(f"device: {smi}; build failed: {str(exc)[:4000]}", flush=True)
        depth = int(sys.argv[2]) if len(sys.argv) > 2 else 24
        prefix_fault_phase(torch, sm_count, smi, depth)
        clock("done")
        return 0
    alone = {"--captured-step", "--chunk-step", "--spec-step", "--admission-step", "--obs-step",
             "--guards-step", "--f8-step"}
    if sys.argv[1:2] and sys.argv[1] in alone:
        torch.backends.cuda.matmul.allow_tf32 = False
        sm_count = torch.cuda.get_device_properties(0).multi_processor_count
        smi = nvidia_smi_line()
        print(f"device: {smi}; build {build.build():.1f} s", flush=True)
        cfg = get_config("mistral-nemo-12b")
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        params = init_params(cfg, gen, device="cuda", dtype=torch.bfloat16)
        if sys.argv[1] == "--captured-step":
            captured_step_phase(torch, cfg, params, sm_count, 16, smi)
        elif sys.argv[1] == "--chunk-step":
            ref = exact_prefill_reference(torch, cfg, params)
            chunk_step_phase(torch, cfg, params, sm_count, 16, {None: ref, "int8": ref}, smi)
        elif sys.argv[1] == "--spec-step":
            spec_phase(torch, cfg, params, sm_count, smi)
        elif sys.argv[1] == "--obs-step":
            obs_phase(torch, cfg, params, sm_count, 16, smi)
        elif sys.argv[1] == "--guards-step":
            guards_phase(torch, cfg, params, sm_count, 16, smi)
        elif sys.argv[1] == "--f8-step":
            # the bf16 engine's streams and rows, and blocking prefill's, first
            eng = DecodeEngine(cfg, params, engine_config("lean", sm_count), device="cuda")
            reqs = make_requests(Request, cfg.vocab_size, 16)
            _, _, rows = drive(torch, eng, reqs)
            del eng
            bf16 = {"streams": [list(r.generated) for r in reqs], "rows": rows,
                    "prefill_rows": exact_prefill_reference(torch, cfg, params)["rows"]}
            clock("f8 phases")
            f8res, launches = f8_phase(torch, cfg, params, sm_count, 16,
                                       torch.cuda.get_device_name(0), bf16)
            print(json.dumps({"card": smi, "f8": {name: {**r, "launches": launches[name]}
                                                  for (name, _), r in f8res.items()}}))
        else:
            admission_phase(torch, cfg, params, sm_count, smi)
        clock("done")
        return 0

    # 1. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev_name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"device: {dev_name} ({smi}), {sm_count} SMs, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    clock("build")
    # 2. build
    build_s = build.build()
    print(f"build: {build_s:.1f} s (" + ", ".join(
        f"{src} {t:.1f}" for src, t in sorted(build.source_seconds.items(), key=lambda kv: kv[1]))
        + ")", flush=True)
    for source in build.SOURCES:
        for line in build.ptxas_report(source).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {source}: {line.strip()}")
    tc_lines = (tc_ptxas_lines(build.ptxas_report("flash_prefill.cu"))
                + tc_ptxas_lines(build.ptxas_report("lean_prefill_tc.cu")))
    # K7 at d 64, 128, 256; K8 at 64 and 128 on bf16 and e4m3 pools; the
    # fused K4 at 64 and 128 on bf16, int8 and e4m3 pages
    check(len(tc_lines) == 13, f"ptxas reported {len(tc_lines)} tensor-core kernels, expected 13")
    for kernel, regs, spill in tc_lines:
        print(f"  ptxas tensor-core {kernel}: {regs}; {spill}", flush=True)
        # the d-256 row block's register plan (O split by columns) leaves no spill
        check(not kernel.startswith("row_block_kernel<256") or
              " 0 bytes spill stores" in f" {spill}", f"ptxas spills in {kernel}: {spill}")

    clock("kernel phases")
    # 3. kernels
    kres = kernel_phase(torch, sm_count, dev_name)
    kres.update(prefill_kernel_phase(torch, sm_count, dev_name))
    k6res = fixed_decode_phase(torch, sm_count, dev_name)
    k7res = prefill_k7_phase(torch, dev_name)
    k5res = cascade_kernel_phase(torch, sm_count, dev_name)
    merge_counts = merge_plan_drive(torch, sm_count)
    i8res = int8_kernel_phase(torch, sm_count, dev_name)
    page_size_phase(torch, sm_count)

    clock("engine phase")
    # 4. engine, full width, K2
    cfg = get_config("mistral-nemo-12b")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    print(f"engine phase: {cfg.name} full width, all {cfg.n_layers} layers "
          f"(d_model {cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}), "
          f"bf16 weights in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.1f} GB", flush=True)
    new_tokens = 16
    eng = DecodeEngine(cfg, params, engine_config("lean", sm_count), device="cuda")
    reqs = make_requests(Request, cfg.vocab_size, new_tokens)
    blocking = {"prompts": [r.prompt.copy() for r in reqs]}
    reset_launch_counts()
    first_s, ticks, paged_rows = drive(torch, eng, reqs)
    lean_logits = paged_rows[0]
    counts = launch_counts()
    k2_launches, k1_in_main = counts["K2"], counts["K1"]
    check(counts["K3"] == counts["K4"] == counts["K4f"] == counts["K5"] == counts["K6"]
          == counts["K8"] == 0, f"blocking engine ran other kernels: {counts}")
    check(counts["K7"] == cfg.n_layers * eng.stats.prefills == cfg.n_layers * len(reqs),
          f"K7 launched {counts['K7']} times, expected {cfg.n_layers} x {len(reqs)} admissions")
    tc = path_counts("engine phase")
    decode_steps = eng.stats.ticks
    check(all(len(r.generated) == new_tokens for r in reqs), "a request did not finish")
    check(tuple(lean_logits.shape) == (len(reqs), cfg.vocab_size)
          and bool(torch.isfinite(lean_logits).all()), "lean logits malformed or not finite")
    check(k2_launches == cfg.n_layers * decode_steps and k2_launches > 0,
          f"K2 launched {k2_launches} times, expected {cfg.n_layers} x {decode_steps}")
    check(k1_in_main == 0, f"K1 ran {k1_in_main} times on the fused path")
    check(eng.stats.decode_replays > 0, "engine phase: no decode tick replayed a captured step")
    eng.pool.check()
    check(eng.pool.num_allocated == 0, f"{eng.pool.num_allocated} pages leaked")
    p50 = statistics.median(dt for dt, _ in ticks)
    tok_s = sum(n for _, n in ticks) / sum(dt for dt, _ in ticks)
    print(f"  {len(reqs)} requests (prompts {list(PROMPT_LENS)}, {new_tokens} new tokens "
          f"each): admission + first decode tick {first_s * 1e3:.1f} ms; decode tick "
          f"p50 {p50 * 1e3:.2f} ms over {len(ticks)} ticks, {tok_s:.1f} tokens/s; "
          f"K2 launches {k2_launches} = {cfg.n_layers} layers x {decode_steps} steps; "
          f"K7 launches {counts['K7']} = {cfg.n_layers} layers x {len(reqs)} admissions "
          f"({tc['K7']} on the tensor cores); captured step: {eng.stats.decode_captures} "
          f"captures, {eng.stats.decode_replays} of {decode_steps} ticks replayed; pool clean",
          flush=True)
    paged = {"streams": [list(r.generated) for r in reqs], "rows": paged_rows}
    traced_ticks(torch, eng, make_requests(Request, cfg.vocab_size, TRACED_TICKS + 6), p50)
    del eng

    clock("two-phase phase")
    # 5. two-phase (K1 + merge)
    eng = DecodeEngine(cfg, params, engine_config("lean", sm_count, fused=False), device="cuda")
    reqs2 = make_requests(Request, cfg.vocab_size, 4)
    reset_launch_counts()
    drive(torch, eng, reqs2)
    k1_launches, k2_in_two = ld.partials_launches, ld.fused_launches
    check(k1_launches == cfg.n_layers * eng.stats.ticks and k1_launches > 0,
          f"K1 launched {k1_launches} times, expected {cfg.n_layers} x {eng.stats.ticks}")
    check(k2_in_two == 0, "K2 ran on the fused=False path")
    path_counts("two-phase phase")
    check(bool(torch.isfinite(eng.last_logits).all()), "two-phase logits are not finite")
    eng.pool.check()
    print(f"two-phase phase: {eng.stats.ticks} decode steps, K1 launches {k1_launches} "
          f"({ld.partials_ring_launches} on the decode ring), logits finite, pool clean",
          flush=True)
    del eng

    clock("ref cross-check")
    # 6. 'ref' backend against lean on the first decode tick
    eng = DecodeEngine(cfg, params, engine_config("ref", sm_count), device="cuda")
    for r in make_requests(Request, cfg.vocab_size, new_tokens):
        eng.submit(r)
    eng.tick()
    ref_logits = eng.last_logits
    typical = ref_logits.abs().median().item()
    atol = LOGIT_ATOL_FRAC * typical
    delta = (ref_logits - lean_logits).abs()
    at = int(delta.argmax())
    diff, ref_at = delta.flatten()[at].item(), ref_logits.flatten()[at].item()
    agree = int((ref_logits.argmax(-1) == lean_logits.argmax(-1)).sum())
    print(f"ref cross-check: first decode tick, median |ref logit| {typical:.4f}; "
          f"max |logit lean - ref| {diff:.4f} where ref = {ref_at:.4f} (allowed "
          f"{atol:.4f} + {LOGIT_RTOL} |ref|); greedy tokens agreeing "
          f"{agree}/{len(PROMPT_LENS)}", flush=True)
    check(typical > 0 and torch.allclose(lean_logits, ref_logits, rtol=LOGIT_RTOL, atol=atol),
          f"lean and ref logits differ by up to {diff} (ref {ref_at}, typical |logit| {typical})")
    del eng

    clock("scheduler phases")
    # 7. scheduler phases: chunked prefill on the lean and fixed backends,
    # against the blocking engine's first tokens and prefill at the exact length
    blocking["first"] = [r.generated[0] for r in reqs]
    blocking["rows"] = exact_prefill_reference(torch, cfg, params)["rows"]
    # in turns (lean, fixed, fixed, lean), so that the backends' wall times
    # compare on one card without the first phase's warm-up in either
    sched_runs, walls = {}, []
    for b in ("lean", "fixed", "fixed", "lean"):
        run = scheduler_phase(torch, cfg, params, b, sm_count, new_tokens, blocking)
        sched_runs.setdefault(b, run)
        walls.append(run["wall"])
    print("scheduler phases, wall s in turns (lean, fixed, fixed, lean): "
          + ", ".join(f"{w:.2f}" for w in walls), flush=True)
    # the lean phase is traced in the chunk step phase (12), eager and captured
    syncs = traced_fixed_phase(torch, cfg, params, sm_count, new_tokens)
    print(f"scheduler phases: host syncs (aten::item) fixed {syncs} (traced at "
          f"{TRACED_FIXED_LAYERS} of {cfg.n_layers} layers)", flush=True)

    clock("prefix serving")
    # 8. prefix-sharing serving: radix cache, copy-on-write, cascade (K5)
    prefix_counts = prefix_serving_phase(torch, cfg, params, sm_count, new_tokens)

    clock("dense engine")
    # 9. the dense-cache engine: K7 admissions, K2 / K6 decode, the legacy step
    dense_counts = dense_engine_phase(torch, cfg, params, sm_count, new_tokens, paged)

    clock("int8 phases")
    # 10. int8 pages: the blocking engine (K2-int8, K1-int8, ref), the
    # Scheduler on lean (K4-int8) and fixed (K8 + K6 on dequantized K/V) in
    # turns, prefix serving with cascade (K5-int8)
    i8_counts, i8_k1, i8_blocking = int8_engine_phase(
        torch, cfg, params, sm_count, new_tokens,
        {"streams": paged["streams"], "rows": paged["rows"], "prefill_rows": blocking["rows"]})
    scheduler_phase(torch, cfg, params, "ref", sm_count, new_tokens, i8_blocking,
                    kv_dtype="int8")
    i8_runs, walls = {}, []
    for b in ("lean", "fixed", "fixed", "lean"):
        run = scheduler_phase(torch, cfg, params, b, sm_count, new_tokens, i8_blocking,
                              kv_dtype="int8")
        i8_runs.setdefault(b, run)
        walls.append(run["wall"])
    print("int8 scheduler phases, wall s in turns (lean, fixed, fixed, lean): "
          + ", ".join(f"{w:.2f}" for w in walls), flush=True)
    syncs = traced_fixed_phase(torch, cfg, params, sm_count, new_tokens, kv_dtype="int8")
    print(f"int8 scheduler phases: host syncs (aten::item) fixed {syncs} (traced at "
          f"{TRACED_FIXED_LAYERS} of {cfg.n_layers} layers)", flush=True)
    i8_prefix = prefix_serving_phase(torch, cfg, params, sm_count, new_tokens, kv_dtype="int8")

    clock("f8 phases")
    # 11. f8 pages: the six f8 forms against their bf16 forms on the widened
    # K/V and their plain versions, the blocking engine (K2-f8, K1-f8), the
    # Scheduler on lean (fused K4-f8) and fixed (K8-f8, K6-f8), a prefix
    # wave with cascade (K5-f8), f16 and f32
    f8res, f8_launches = f8_phase(
        torch, cfg, params, sm_count, new_tokens, dev_name,
        {"streams": paged["streams"], "rows": paged["rows"], "prefill_rows": blocking["rows"]})

    clock("chunk step phase")
    # 12. the captured chunk step against the eager one: the lean Scheduler's
    # wall and TTFT in turns, idle share and host launch calls traced
    chunk_step_phase(torch, cfg, params, sm_count, new_tokens,
                     {None: blocking, "int8": i8_blocking}, smi, full=False)

    # the later Mistral-NeMo-12B phases but the captured-step one at
    # FULL_RUN_DEPTH["mistral_late"] of its layers (the same weights)
    cfg_l = arch_config(cfg, FULL_RUN_DEPTH["mistral_late"])
    params_l = dict(params, layers=params["layers"][:cfg_l.n_layers])
    print(f"full run: the spec, admission, obs and guards phases at {cfg_l.n_layers} of "
          f"{cfg.n_layers} layers (FULL_RUN_DEPTH)", flush=True)

    clock("spec phase")
    # 13. speculative decode, its verify step captured (the fused K4)
    k4_verify = spec_phase(torch, cfg_l, params_l, sm_count, smi)

    clock("admission phase")
    # 14. blocking admission at the bucket length, captured, against eager
    admission_phase(torch, cfg_l, params_l, sm_count, smi)

    clock("captured step phase")
    # 15. the captured decode step against the eager one: tick p50 in
    # turns, traced ticks, bits on every configuration and step kind it
    # captures
    captured_step_phase(torch, cfg, params, sm_count, new_tokens, smi)

    clock("obs phase")
    # 16. observability: every ObsConfig sink on the lean Scheduler, traced
    # against untraced, the CLI on the card's trace and flight dump
    obs_phase(torch, cfg_l, params_l, sm_count, new_tokens, smi)

    clock("guards phase")
    # 17. guards and fault injection: NaN isolation on every decode path,
    # the guard's cost, the degraded levels' passes, chaos under the Scheduler
    guard_counts = guards_phase(torch, cfg_l, params_l, sm_count, new_tokens, smi)

    del params_l
    # 18. the attention-family architectures, after Mistral-NeMo-12B's
    # weights are released: the kernels at their geometries, qwen3-moe at
    # full width (depth as fits), gemma3 at full width and depth, and the
    # geometry sweep
    del params
    clock("arch kernel phase")
    arch_k = arch_kernel_phase(torch, sm_count, dev_name)
    clock("qwen3 phase")
    qwen3 = qwen3_phase(torch, sm_count, smi, depth=FULL_RUN_DEPTH["qwen3"])
    clock("gemma phase")
    gemma = gemma_phase(torch, sm_count, smi)
    clock("sweep phase")
    sweep = sweep_phase(torch, sm_count, smi)
    # 19. the recurrent architectures: K7 at recurrentgemma's window layers,
    # recurrentgemma-9b and xlstm-350m at full width and depth
    clock("recurrent phase")
    recurrent = recurrent_phase(torch, sm_count, smi, depth=FULL_RUN_DEPTH["recurrent"])
    # 20. training: Mistral-NeMo-12B at full width (8 layers), the card's
    # gradients against the CPU's, exact resume, the trained weights served,
    # one step of every configuration
    clock("train phase (a)")
    train = train_phase(torch, sm_count, smi, resume_layers=FULL_RUN_DEPTH["resume"])
    # 21. sequence-parallel decode: gemma3-4b at long_500k, world 1 (plain
    # and over NCCL) and world 4 on the one card (gloo), K2 on each shard
    clock("sp phase")
    sp = sp_phase(torch, sm_count, smi)
    # 22. tensor-parallel serving: K2 and K7 at a (1, 4) rank's geometry,
    # Mistral-NeMo-12B world 1 and world 4 on (1, 4) and (2, 2), qwen3-moe
    # at 16 layers on (2, 2)
    clock("tp phase")
    tp = tp_phase(torch, sm_count, smi, depths={TP_ARCH: FULL_RUN_DEPTH["tp"],
                                                TP_MOE_ARCH: FULL_RUN_DEPTH["tp_moe"]})
    # 23. FSDP x TP training and the pipeline: Mistral-NeMo-12B at full width,
    # world 1 against (data=2, model=2), its state restored onto (4, 1),
    # xlstm-350m under dp_only, pipeline_forward over pod=4
    clock("fsdp phase")
    fsdp = fsdp_phase(torch, smi, FULL_RUN_DEPTH["fsdp"], b_steps=1,
                      xlstm_layers=FULL_RUN_DEPTH["fsdp_xlstm"])

    clock("summary")
    # 24. summary: kernel times in bf16 at the main path's shapes; launches
    # from the run of the path each kernel serves
    k6 = k6res[(DECODE_SHAPES[0], "bfloat16")]
    kres[("flash_decode_partials", "bfloat16")] = k6
    kres[("lean_cascade_fused", "bfloat16")] = k5res[(next(iter(CASCADE_CASES)), "bfloat16")]
    kres[("flash_prefill", "bfloat16")] = k7res[(next(iter(K7_CASES)), "bfloat16")]
    launches = {"lean_decode_fused": k2_launches, "lean_decode_partials": k1_launches,
                "lean_prefill_fused": sched_runs["lean"]["counts"]["K4f"],
                "lean_prefill_chunk_partials": merge_counts["verify"]["K4"],
                "flash_decode_partials": sched_runs["fixed"]["counts"]["K6"],
                "flash_prefill_paged": sched_runs["fixed"]["counts"]["K8"],
                "lean_merge": sum(c["K3"] for c in merge_counts.values()),
                "lean_cascade_fused": prefix_counts["K5"],
                "flash_prefill": dense_counts["K7"],
                "lean_decode_fused_int8": i8_counts["K2"], "lean_decode_partials_int8": i8_k1,
                "lean_prefill_fused_int8": i8_runs["lean"]["counts"]["K4f"],
                "lean_prefill_chunk_partials_int8": merge_counts["verify int8"]["K4"],
                "lean_cascade_fused_int8": i8_prefix["K5"], **f8_launches}
    kres.update(i8res)
    kres.update(f8res)
    where = {
        "lean_decode_fused": ("lean_decode.cu", "src/repro/kernels/lean_decode.py:302"),
        "lean_decode_partials": ("lean_decode.cu", "src/repro/kernels/lean_decode.py:117"),
        "lean_prefill_fused": ("lean_prefill_tc.cu", "src/repro/kernels/lean_prefill.py:51"),
        "lean_prefill_chunk_partials": ("lean_prefill.cu",
                                        "src/repro/kernels/lean_prefill.py:51"),
        "flash_decode_partials": ("flash_decode.cu", "src/repro/kernels/flash_decode.py:25"),
        "flash_prefill_paged": ("flash_prefill.cu", "src/repro/kernels/flash_prefill.py:162"),
        "lean_merge": ("lean_merge.cu", "src/repro/kernels/lean_decode.py:813"),
        "lean_cascade_fused": ("lean_cascade.cu", "src/repro/kernels/lean_decode.py:604"),
        "flash_prefill": ("flash_prefill.cu", "src/repro/kernels/flash_prefill.py:24"),
        **INT8_REPLACES,
        **F8_REPLACES,
    }
    kernels = []
    for name, (source, replaces) in where.items():
        r = kres[(name, "bfloat16")]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            # SDPA computes the attention K1 (+ merge), K2, the fused K4, K4
            # (+ merge), K5, K6 (+ merge_n), K7 and K8 do, on the same
            # inputs (the int8 forms': the K/V dequantized to bf16; the f8
            # forms': widened to bf16); no one PyTorch call computes K3's
            # merge of partials
            "library_ms": r["library_ms"],
        })
    # the kernels at the attention-family geometries, launches from the lean
    # run of each architecture's phase (K8 and K6: its fixed run; K5: qwen3's
    # prefix-sharing run; K7 on qwen3: its blocking admissions in the spec run)
    arch_launches = {
        ("lean_decode_fused", "qwen3-moe-30b-a3b"): qwen3["launches"]["lean"]["K2"],
        ("lean_prefill_fused", "qwen3-moe-30b-a3b"): qwen3["launches"]["lean"]["K4f"],
        ("flash_prefill_paged", "qwen3-moe-30b-a3b"): qwen3["launches"]["fixed"]["K8"],
        ("flash_decode_partials", "qwen3-moe-30b-a3b"): qwen3["launches"]["fixed"]["K6"],
        ("lean_cascade_fused", "qwen3-moe-30b-a3b"): qwen3["launches"]["cascade"]["K5"],
        ("flash_prefill", "qwen3-moe-30b-a3b"): qwen3["launches"]["spec"]["K7"],
        ("lean_decode_fused", "gemma3-4b"): gemma["launches"]["lean"]["K2"],
        ("flash_decode_partials", "gemma3-4b"): gemma["launches"]["fixed"]["K6"],
        ("flash_prefill", "gemma3-4b"): gemma["launches"]["lean"]["K7"],
    }
    for arch in ("nemotron-4-15b", "qwen2-moe-a2.7b", "musicgen-large"):
        arch_launches[("lean_decode_fused", arch)] = sweep[arch]["K2"]
        if arch in ARCH_CHUNKED:       # the sweep's lean runs: chunked or blocking
            arch_launches[("lean_prefill_fused", arch)] = sweep[arch]["K4f"]
        else:
            arch_launches[("flash_prefill", arch)] = sweep[arch]["K7"]
    for (name, arch), r in arch_k.items():
        if (name, arch) not in arch_launches:
            continue
        source, replaces = where[name]
        kernels.append({
            "name": arch_name(name, arch), "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}", "replaces": replaces,
            "launches": arch_launches[(name, arch)], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    # K7 at recurrentgemma's window layers (3000 keys), launches from its
    # first captured run; xlstm-350m launches no kernel
    # K2 at gemma3-4b's global layers under sequence-parallel decode: launches
    # from the sp phase's runs (524,288 keys: (b); 131,072: (c), all four ranks)
    for keys in SP_K2_KEYS:
        r = sp["k2"][str(keys)]
        source, replaces = where["lean_decode_fused"]
        kernels.append({
            "name": f"lean_decode_fused@{SP_ARCH} long_500k {keys} keys", "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}", "replaces": replaces,
            "launches": sp["launches"][f"K2_{keys}"], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    # K2 and K7 at a (1, 4) tensor-parallel rank's geometry, launches from
    # the tp phase's run (b), all four ranks
    for kernel, name in (("K2", "lean_decode_fused"), ("K7", "flash_prefill")):
        r = tp["kernels"][kernel]
        source, replaces = where[name]
        kernels.append({
            "name": f"{name}@{TP_ARCH} tensor-parallel rank (1, 4)", "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}", "replaces": replaces,
            "launches": tp["launches"][kernel], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    r = recurrent["k7"][RG_K7_KEYS[0]]
    source, replaces = where["flash_prefill"]
    kernels.append({
        "name": rg_k7_name(), "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{source}",
        "replaces": replaces, "launches": recurrent["launches"]["recurrentgemma-9b"]["K7"],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(f"attention-family phases: qwen3-moe at {qwen3['depth']} layers; captured against "
          f"eager bit for bit: qwen3 {qwen3['bits']}, gemma3 {gemma['bits']}; launches "
          f"(lean runs) " + "; ".join(f"{arch_name(n, a)} {v}" for (n, a), v
                                      in arch_launches.items()), flush=True)
    print("recurrent phase: launches (first captured runs) " + "; ".join(
        f"{arch} " + (", ".join(f"{k} {v}" for k, v in c.items() if v) or "none")
        for arch, c in recurrent["launches"].items())
        + f"; captured against eager bit for bit: {recurrent['bits']}", flush=True)
    print(f"train phase ({smi}): Mistral-NeMo-12B at {train['a']['layers']} layers, step p50 "
          f"{train['a']['step_ms_p50']:.1f} ms, MFU {train['a']['mfu']:.4f}, peak "
          f"{train['a']['peak_gb']:.2f} GB; trained weights served: K7 {train['d']['K7']}, K2 "
          f"{train['d']['K2']} launches", flush=True)
    print(f"sp phase ({smi}): step p50 (a) {sp['step_ms_p50']['a']:.2f} ms, (b) "
          f"{sp['step_ms_p50']['b']:.2f} ms, (c) " + ", ".join(
              f"{t:.2f}" for t in sp["step_ms_p50"]["c"]) + f" ms; K2 launches "
          f"{sp['launches']}", flush=True)
    b, c, d_ = (tp["runs"][k] for k in ("b", "c", "d"))
    print(f"tp phase ({smi}): step p50 (a) {tp['runs']['a']['step_ms_p50']:.2f} ms, (b) "
          + ", ".join(f"{t:.2f}" for t in b["step_ms_p50"]) + " ms, (c) "
          + ", ".join(f"{t:.2f}" for t in c["step_ms_p50"]) + " ms, (d) "
          + ", ".join(f"{t:.2f}" for t in d_["step_ms_p50"]) + f" ms; launches (b) "
          f"{tp['launches']}", flush=True)
    print(f"fsdp phase ({smi}): {fsdp['phase_s']:.1f} s; step p50 (a) "
          + ", ".join(f"{t:.1f}" for t in fsdp["a"]["ms"]) + " ms, (b) " + ", ".join(
              f"{t:.1f}" for t in fsdp["b"]["step_ms_p50"]) + " ms, (c) " + ", ".join(
              f"{t:.1f}" for t in fsdp["c"]["step_ms_p50"]) + " ms; kernels launched: none "
          "(training runs the plain attention)", flush=True)
    print(f"fused K4 launches from the spec phase's verify steps (bf16 pages, oracle): "
          f"{k4_verify}", flush=True)
    print(f"launches in the guards phase's chaos run (bf16 pages; K1 from level-2 passes, K2 "
          f"also from level-1 ones): {guard_counts}", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
