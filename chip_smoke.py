#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. **card**: the card's name and power limit (``nvidia-smi``), the torch,
   CUDA and nvcc versions.
2. **build**: every CUDA source under ``src/repro_torch/kernels/csrc`` is
   compiled for ``sm_90a`` (one ``nvcc`` per source, all started together).
3. **kernels**: each hand-written kernel is held against its plain PyTorch
   version on the card, at the shapes the serving paths of full-width
   Qwen3-0.6B give it, within a stated tolerance, and timed with CUDA
   events beside its bound and the nearest single PyTorch call.  The two
   sparse matmul kernels (bf16 and f32 activations) are held at M = 9, 16,
   20, 256 and a ragged 300, their time at the 20-row verify panel and
   the 256-row prefill chunk also read from a profiler trace (and the
   host's enqueue time).  The int8 and int4 kernels are held bit-equal to
   their plain versions at M = 1, 4, 8, 16, 20, 256 and 300, traced at
   the 4-row decode tick and the 256-row prefill chunk.  For all four, the
   first rows of one x must be the same bits in calls of M = 9, 20, 128,
   256 and 300 (128 and 256: the prefill chunk's width classes).  The
   sparse gemv is held at M = 1, 4 and 8 and traced at the 4-row decode
   tick; its calls of M = 1 and 4 (bf16, and f32 x) must give
   the first rows of the 8-row call bit for bit.  The tied unembedding is
   held, timed and traced at M = 1, 4, 16 and 20 (bf16) and 4 and 36
   (f32), each call's rows bit-equal to the largest call's.  The flat and
   paged attention kernels are held at panels of
   Q = 1, 2, the verify panel, 9 and 17 queries (up to 34 query rows),
   with a NaN-poisoned dead page and an all-empty slot, timed (and
   traced) at three panel widths and at a 4096-token prefix; every query
   of a Q-query panel (Q = 1, 5, 9, 17) must be the same bits as a
   one-query panel at the tail length that query sees.  The prefix-only
   partial (the same kernel with no tail panel, ``o`` and ``lse``) is held
   at the serving shape with an empty slot and NaN-poisoned dead blocks,
   at a 34-row panel whose first rows must be the same bits as the
   decode tick's, and at a 4096-token prefix, bf16 and f32; timed and
   traced at the serving shape and at 4096 tokens.
4. **serve** full-width Qwen3-0.6B (random weights from seed 0, pruned,
   packed and quantised on the card) through ``ContinuousEngine``, with
   every kernel's launch counter zeroed just before each path and read just
   after (graph replays counted), and decode-tick logits through the
   kernels held against the same ticks through the plain versions.  Each
   engine runs its decode (or verify) forward, its prefill chunks (one
   graph per width class, the chunk padded to whole blocks), its refreeze
   and its prefix-hit assignment as captured CUDA graphs, all captured
   when the engine is built: every serve phase must hold exactly one
   capture per entry (the chunk: one per width class), the attention
   kernel's counter must equal one launch a layer per decode replay, the
   graph's decode and verify logits (Q = 1 and Q = k+1), a full-width and
   a ragged chunk's logits and state, and a refreeze with one slot full
   and one not must be bit-equal to the eager calls on copies of the same
   state (flat bf16, paged int8, paged int4), every non-final chunk,
   refreeze and assignment must run under
   ``torch.cuda.set_sync_debug_mode("error")`` (a host sync fails it),
   and one tick, one 256-token chunk and one refreeze (one slot of four
   full) are traced both as a graph replay and eagerly (launches, device
   busy time, idle share; the captures' time and memory, and those of an
   unchunked engine's width classes).  The flat bf16, spec k=4, paged int8 and paged int8 k=3 traffic
   is also served overlapped (``overlap=True``), its greedy tokens gated
   identical to the serial run's, and tok/s, TPOT and TTFT reported for
   both beside the last eager-tick figures (``EAGER_TICKS``):

   * flat pool, bf16 sparse weights: six requests; the traced decode tick
     must run the gemv as one launch per linear (no ``sum_partials``);
   * speculative decoding, flat bf16, ``SpecConfig(k=4)``: four prompts of
     a repeated motif and two random ones, timed beside the same traffic
     without speculation, every verify tick's attention launch at
     ``(k+1) * G`` query rows, and accepted drafts required;
   * the two-pass decode at f32 (the prefix-only partial kernel, a grouped
     tail partial and an lse merge, this script's own dispatch) against
     the fused f32 engine: logits from one shared state per tick, and
     greedy tokens identical but where the fused path's top-1 margin is a
     near-tie; then flat f32 ``k=4`` and ``k=8`` (a verify panel of 18
     query rows) each against flat f32 without speculation under the same
     rule;
   * paged shared-prefix pool, int8 sparse weights: eight requests sharing
     a 512-token prefix (prefix-cache hits and shared blocks required; one
     decode tick and one 256-token prefill chunk traced), then the same
     requests on the flat pool, whose greedy tokens must be identical;
   * paged int8 ``k=3`` against paged int8 without speculation on the
     shared-prefix requests, under the near-tie rule, with prefix-cache
     hits;
   * paged pool, int4 sparse weights: four requests sharing the prefix;
   * the server: paged int8 ``k=3``, overlapped, behind ``ServerFrontend``
     on ``127.0.0.1`` with load shedding, degraded mode, telemetry (a
     metrics port and a trace file) and a seeded ``FaultPlan``, driven by
     ``http.client`` threads (a client cancel, an expiring deadline, a
     burst past the queue bound): every request ends with a valid reason,
     every fault site fires, one capture per entry (``release`` and
     ``set_lane`` included), refcounts back to zero, ``/metrics`` and the
     trace hold what happened, the untouched requests' greedy tokens equal
     an in-process serial run's (near-tie rule), and one overlapped tick
     after a cancel runs under ``set_sync_debug_mode("error")``; its TTFT
     and TPOT (obs's percentiles) are printed beside the in-process ones.
     ``--server-only`` runs the build and this phase alone;
   * warm restart (``snapshot``), paged int8: engine A serves a wave on the
     shared prefix, saves a snapshot (``save_snapshot``) and serves a
     follow-up wave of new requests on the same prefix; a fresh engine B
     (every entry captured when built) loads it and serves the follow-up
     wave: the pages restored, B's device refcounts and tables zero, its
     arena tensors where they were, one capture per entry, a prefix hit on
     every follow-up admission and B's greedy tokens identical to A's; a
     truncated snapshot raises a readable ``ValueError`` and leaves a fresh
     engine cold and serving; the snapshot's bytes and the save and load
     seconds are reported;
   * the sanitized pool (``checkify``), paged int8, overlapped: the paged
     int8 requests through an unchecked and a checked engine, tokens
     identical to each other and to the paged int8 run's first tokens,
     one capture per entry, chunks, refreezes and assignments sync-free and
     one overlapped decode tick under ``set_sync_debug_mode("error")``; the
     decode step and the decode graph's replay with and without the checks;
     a planted device double free raises at a following token read, naming
     its check;
   * the one-shot ``Engine`` (``one_shot``), bf16: 4 prompts of 512 tokens,
     160 new (a refreeze grows the prefix from 4 to 5 blocks), eager: the
     gemv, fused attention, sparse matmul (the prefill at M = 2048) and
     unembedding launched exactly once per linear, layer and step; the
     first 8 decode ticks' logits within 5e-2 of the plain range of the
     same ticks through the plain versions; greedy tokens equal to the
     all-plain engine's but at bf16 near-ties; at f32 with KV sparsity 0
     the sparse-KV and dense-KV engines within 1e-3 of the range; tok/s
     and the median decode and prefill step reported.  The kernel phase
     also holds, times and row-gates the bf16 sparse matmul at M = 2048.
     ``--only one_shot,snapshot,checkify`` runs the build and these
     phases alone.
5. **the other dense configs and the VLM** at their published widths:
   * ``wide_kernels``: the kernels at Llama-3-8B's shapes (the paper's
     model): its seven linears through the gemv at M = 1 (the paper's
     Table 2, batch 1, with a "sparse against dense ``torch.matmul``" line
     per projection) and M = 4, through the sparse matmul at the 256-row
     chunk and through the int8 / int4 kernels at M = 1 and 4, the gemv's
     and the int kernels' rows bit-equal across M = 1, 4 and 8; its untied
     head (``lm_head [4096, 128256]`` laid out column-major by the
     engine's ``params_to``) at M = 1, 4 and 20 beside ``torch.matmul``;
     the flat and paged attention at QG = 4 and 20 (and 36 and 68 held),
     the row-independence gate and a 4096-token prefix; Phi-3-mini's
     attention at D = 96, QG = 1 and its untied head; InternVL2's at D =
     64, QG = 8, its tied 151655-row table, and the gemv and sparse matmul
     at its ragged K = 896 (its decode batch and one-shot prefill rows);
   * ``llama3_8b``: Llama-3-8B at full width and depth (32 layers), bf16
     sparse weights from seed 0 on the card, the flat pool, every entry
     captured when the engine is built, overlapped ticks: 6 requests of
     200-1000 tokens, 64 new, one seeded, through 4 slots and 256-token
     chunks.  Gates: decode logits within 5e-2 of the plain range and
     top-1 where the margin is clear; greedy tokens equal to an all-plain
     engine's (serial, eager) but at bf16 near-ties (below ``TOP1_CLEAR``,
     as the one-shot phase); one capture per entry; per decode tick 224
     gemv and 32 attention launches, one head launch a tick and a chunk;
     graphs bit-equal to eager.  Reported: tok/s, TPOT, TTFT, a traced
     decode tick (device busy, idle share) and 256-token chunk, the
     weights' GB, the graph pools and the peak memory;
   * ``phi3_mini``: Phi-3-mini at full width, 8 of its 32 layers (MHA, D =
     96, the untied 32064-row head), 4 requests, 32 new, the same gates;
   * ``internvl2``: InternVL2-1B at full width and depth through the
     one-shot ``Engine`` (a frontend config has no pooled path): 2 x (256
     seeded frontend embeddings + 128 prompt tokens), 32 new; exact launch
     counts, the prefill's and the first decode ticks' logits and the
     greedy tokens against the plain versions.
   ``--only wide_kernels,llama3_8b,phi3_mini,internvl2`` runs the build and
   these phases alone.
   The MoE family (the fourteenth slice), each with the same gates and
   reports as ``llama3_8b``:
   * ``phi35_moe``: Phi-3.5-MoE at full width (d 4096, 16 experts of d_ff
     6400, top-2, 32/8 heads, untied 32064-row head), 8 of its 32 layers
     (its dense bf16 experts take 2.52 GB a layer), 6 requests of 200-600
     tokens, 32 new, one seeded; per decode tick 4 gemv launches a layer
     (the attention; the router and the expert stacks stay dense, as in
     the reference, and run as torch products);
   * ``scout``: Llama-4-Scout at full width (d 5120, 16 experts of d_ff
     8192, top-1 and a sparse shared expert, 40/8 heads padded to 48, so
     G = 6, untied 202048-row head), 4 of its 48 layers, 4 requests, 32
     new; 7 gemv launches a layer.
   Each first holds its kernel rows (the gemv at its sparse linears, M = 1
   and 4; the sparse matmul at them, M = 20 and 256; the head at M = 1, 4
   and 20; Scout's attention at QG = 6 and 30), then serves; the logits
   check runs its plain forward on the kernel forward's routing (every
   decision it moves within ``ROUTER_TIE`` of a tie); the kernels also
   serve the traffic on the all-plain engine's routing, whose greedy
   tokens must be the all-plain engine's but at top-1 near-ties, and the
   served engine's divergences are excused only at top-1 near-ties or
   after a routing decision shown to differ; ``moe_layer`` times layer 0's
   MoE alone at 4 and 256 rows beside its bounds and reports whether its
   rows keep their bits across the two.
   ``--only phi35_moe,scout`` runs the build and these alone.
   The recurrent, hybrid and encoder-decoder families (the fifteenth
   slice), all through the one-shot ``Engine`` (the reference serves them
   only there), each gated as ``internvl2`` is (launches exact, counted
   from the port's forward; the prefill's and the first 8 decode steps'
   logits within 5e-2 of the plain range and top-1 agreement where the
   plain margin is clear; greedy tokens equal to the all-plain engine's
   but at bf16 near-ties) and reporting tok/s, the median decode and
   prefill step, the weights' GB, the peak memory and one traced decode
   step (device busy, idle share, top kernels):
   * ``rwkv6``: RWKV-6-7B at full width and depth (32 layers, d 4096, 64
     heads of 64, d_ff 14336, untied 65536-row head), 4 prompts of 512
     tokens, 32 new: 256 gemv launches a decode step (8 a layer) and one
     head launch, no attention; the prefill's 256 sparse matmuls at
     M = 2048 and its recurrences (plain torch, a loop over time).  Its
     kernel rows first: the gemv at its linears at M = 1 and 4, the sparse
     matmul at M = 2048, the head at M = 1 and 4, and the dense kernel at
     ``w_cv``'s K = 14336 (x streamed in K panels) at M = 1, 4, 16, 64 and
     300, each row bit-equal across M.  Random weights make its 32 layers
     chaotic in bf16 (two correct bf16 paths end about 5e-2 of the range
     apart), so its logits and token gates run on the same traffic served
     again at f32 activations (the f32 gemv, matmul and head kernels),
     within 1e-3 of the range and tokens equal but at f32 near-ties
     (``TIE_MARGIN``); the bf16 run keeps its exact launches and every
     kernel launch of its logits check held to its plain version;
   * ``seamless``: SeamlessM4T-medium at full width and depth (12 encoder
     and 12 decoder layers, d 1024, 16 heads of 64, untied 256206-row
     head, held first at M = 1 and 4), 4 x (256 seeded ``src_embeds``
     frames + 128 prompt tokens), 32 new: 12 attention launches a decode
     step (the cross attention is plain torch, as in the reference);
   * ``jamba``: Jamba-1.5-Large ``reduced()`` (a Mamba and an attention
     layer a period, MoE every other layer), 4 x 256 tokens, 32 new;
   * ``jamba_mamba``: one Mamba mixer at Jamba's full width (d 8192,
     d_inner 16384; sparse ``w_in`` and ``w_out``, dense ``w_bcdt``
     [16384, 544]): the gemv and sparse matmul rows at ``w_in`` / ``w_out``
     (M = 1, 4 and 1024), the dense kernel at K = 16384, then
     ``mamba_apply`` over 4 x 256 rows with its state and 8 decode steps,
     outputs and states within 1e-2 of the plain range, launches exact.
   ``--only rwkv6,seamless,jamba,jamba_mamba`` runs the build and these
   alone.  ``seamless`` also holds its kernel rows first: the gemv at the
   9 linears a decoder layer runs a decode step (M = 4) and the attention
   at D = 64, G = 1 (QG = 1), each beside its bound, plain version and
   library call.
6. **train** (the sixteenth slice): full-width, full-depth Qwen3-0.6B
   trains 8 steps of 8 x 1024 tokens through ``launch.train.train_loop``
   (bf16 params, f32 master and moments, remat): the loss falls, every
   leaf's gradient is finite, every param keeps its layout (the dense
   linears column-major), and the dense kernel launches exactly the count
   worked out from ``launch_rows`` each step (the forward and the remat
   replay of every linear, and the tied head), no other kernel; the
   median step, tok/s, peak memory and a traced step of 1 x 1024 tokens
   (idle share, the dense kernel's and the backward ``torch.matmul``
   products' shares).
   Then the dense kernel at the step's M = 8192 ([1024 -> 2048 / 1024 /
   3072], [2048 -> 1024], [3072 -> 1024], the tied head) beside its bound,
   plain version and ``torch.matmul``; the gradients of one step through
   the kernels against the plain versions (full width and depth, 2 x 256
   tokens: f32 loss within 1e-5 and every leaf within 1e-3 of its range,
   bf16 loss within 1e-2); ``microbatch=4`` against the batch of 8 x 256;
   restart (4 steps straight against 2, a checkpoint, a restore and 2
   more, at 4 layers); one step of 1 x 8192 tokens in each blocked
   attention schedule (losses and the table's gradient norms agree,
   launches exact, timed); a one-shot prefill of one 8192-token prompt on
   packed bf16 weights against the plain versions (5e-2 of the range);
   one step of every other family's reduced config at f32 against the
   plain versions.  ``--only train`` runs the build and this phase alone.
7. **mesh** (the seventeenth slice): full-width, full-depth Qwen3-0.6B
   (bf16, 50 % sparse, KV 30 % / 50 %, 4 slots, chunk 256) served by one
   spawn of 4 ``torch.distributed`` ranks that share the card (gloo: eager
   entries, collectives staged through host memory) through
   ``ContinuousEngine(mesh=...)`` on the (data, model) meshes (4, 1),
   (2, 2) and (1, 4): the reference worker's two waves at full width (4
   lockstep requests of 24 new tokens; 6 staggered ones of 115 + 3 i
   tokens and 20 - 2 i new, as the worker's, five of them refreezing),
   greedy tokens identical on every rank to the one-rank eager engine on
   the same card; then at (2, 2) speculation with k = 3 (a draft
   accepted) and paged int8 with 8 requests on a shared 512-token prefix,
   identical likewise; then at (1, 4) the one-shot decode of a 4096-token
   prompt context-parallel over the model axis (the split kernel's partial
   mode on each rank's 8 of 32 blocks), its logits within 5e-2 (bf16) and
   1e-3 (f32) of the range of the one-rank kernels' logits teacher-forced
   with the ranks' tokens, top-1 equal where the margin is clear.  The
   one-rank references run before the spawn, so neither side's times are
   taken with the card shared.  First, the flat, paged and partial
   attention over each model shard's KV heads must equal those heads of
   the full launch bit for bit.  Every rank's launches are counted per path (each path's kernels
   at least once on every rank; ``mesh_launches`` in the kernel table);
   tok/s, tick times and a tick's collective calls, bytes and seconds are
   printed per mesh.  ``--only mesh`` runs the build and this phase alone.
8. **train_mesh** (the eighteenth slice): full-width, full-depth
   Qwen3-0.6B trained by one spawn of 4 gloo ranks sharing the card
   through ``launch.train.train_loop(mesh=)`` (params at
   ``tree_param_specs``, ZeRO-1 ``master`` / ``m`` / ``v``, each rank's
   data shard of 8 x 256 tokens a step): 3 f32 steps on (2, 2), (4, 1)
   and (1, 4), losses within rtol 1e-4, atol 1e-4 of one rank's on the
   same card; the first step's gradient (layers 0 and 27, the norms, 512
   table rows a model shard) within 1e-3 of each leaf's range of one
   rank's, and the ZeRO-1 update of it within ROADMAP Queue 3's AdamW bar
   of one rank's step on the same gradient; every ZeRO-1 block 1/dp of
   its param block; a checkpoint of (2, 2) after two steps restored onto
   (1, 4), the third loss one rank's; 3 bf16 steps on (2, 2) (1e-2); every
   dense kernel call of these runs held to its plain version (2^-7 of its
   output) and its launches counted per rank; the compressed gradients
   at (4, 1) (bf16 within a bf16 ulp of ``bf16(sum q_i) / 4``, int8
   equal to the oracle, error rows the residuals, from the gradients the
   four ranks reduced, which lie within 1e-3 of each leaf's range of one
   rank's gradients of the same rows); Phi-3.5-MoE's layer 0 MoE at full width, f32, forward and
   backward, expert-parallel at (4, 1) and ``d_ff`` over the model axis
   at (1, 4), against one rank's ``moe_apply`` on all the tokens.  Step
   time, tok/s, peak memory per rank and a step's collectives are printed
   per mesh: placement and collectives, not speed.  The dense kernel at
   the shard shapes is timed first (``mesh_kernel_rows``).  ``--only
   train_mesh`` runs the build and this phase alone.

Each phase's seconds are printed as it ends (``[phase] name``) and
together before the kernel table.  ``--profile`` also runs what only
measures by reading a trace: the traced ticks, chunks and refreezes of
every serve phase (without it only the flat serve run's decode tick is
traced, graph and eager: its gemv kernel counts are a gate), the kernels'
traced device times and the train phase's traced step.  Every traced tick
and chunk reports the unembedding's and the gemv's device time and
launches.  The lines before the last carry the kernel
table (one JSON object) and the serving numbers; the last line is the
device JSON.  ``--out PATH`` also
writes every measurement (per-shape kernel rows, serving, the decode
profiles) to a JSON file.  It needs one CUDA card and this repository's
``src/`` beside it.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRC = HERE / "src"

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
BF16_OPS_PER_S = 989e12         # H100 SXM dense bf16 tensor cores
INT8_OPS_PER_S = 1979e12        # H100 SXM dense int8 tensor cores
F32_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
SLOTS = 4
PREFILL_CHUNK = 256
N_REQUESTS = 6
NEW_TOKENS = 160
PROMPT_RANGE = (200, 600)
# the paged phases: a shared system prefix plus each request's own suffix
SHARED_PREFIX = 512
SUFFIX_RANGE = (40, 200)
PAGED_REQUESTS, PAGED_NEW_TOKENS = 8, 96
IDENTITY_TOKENS = 32
INT4_REQUESTS, INT4_NEW_TOKENS = 4, 32
LOGIT_TICKS = 25
# the two-pass phase (f32): prompts whose remainder past the last 128-token
# block is over 80 tokens, so 48 new tokens fill the ring and refreeze
TWO_PASS_LENS = (230, 360, 490, 240)
TWO_PASS_TOKENS = 48
TWO_PASS_TICKS = 16
TWO_PASS_TOL = 1e-5         # max|two-pass - fused| / max|fused logit|
# a greedy divergence between two f32 paths is a near-tie, not a fault,
# only where the reference's top-1 margin is below this share of its
# largest |logit| (random-weight top-1 margins reach down to about 1e-3)
TIE_MARGIN = 1e-4
# the spec phase: 4 prompts of a 24-token motif repeated 8 times (n-gram
# hits) and 2 random ones (misses)
SPEC_K, SPEC_TOKENS, SPEC_IDENTITY_TOKENS = 4, 128, 48
SPEC_LOGIT_TICKS = 10       # verify ticks of the spec phase's logits check
SPEC_F32_K = (SPEC_K, 8)    # the f32 spec phases' windows (8: 18 rows)
MOTIF, MOTIF_REPEATS, N_MOTIF, N_RANDOM = 24, 8, 4, 2
PAGED_SPEC_K, PAGED_SPEC_TOKENS = 3, 32
# the server phase: the paged int8 k=3 engine behind the HTTP frontend,
# overlapped, with load shedding past SERVER_QUEUE queued requests, no
# drafting while SERVER_DEGRADE or more wait, telemetry and a seeded fault
# plan over its first SERVER_FAULT_TICKS ticks.  Four requests fill the
# slots (one the client cancels mid-stream, one with a deadline that
# expires), then a burst of SERVER_BURST arrives at once; waves of SLOTS
# more follow while the plan still has faults to fire
SERVER_QUEUE, SERVER_DEGRADE, SERVER_BURST = 8, 3, 14
SERVER_TOKENS, SERVER_LONG_TOKENS, SERVER_DEADLINE_S = 48, 160, 0.25
SERVER_FAULT_SEED, SERVER_FAULT_TICKS, SERVER_WAVES = 0, 40, 4
# the warm-restart phase: engine A serves a wave of SLOTS requests on the
# shared prefix, snapshots, then serves a follow-up wave of SLOTS new requests
# on the same prefix; a fresh engine B restores the snapshot and serves the
# follow-up wave again (SNAP_TOKENS new tokens each)
SNAP_TOKENS = 32
# the sanitized phase: the paged int8 requests, CHECK_TOKENS new tokens each
# (the first tokens of the paged int8 run's), served overlapped by an
# unchecked and a checked engine
CHECK_TOKENS = 64
CHECK_REPLAYS = 50          # decode graph replays per engine for the A/B time
# the one-shot phase: the legacy Engine on ONESHOT_BATCH prompts of
# ONESHOT_PROMPT tokens (its prefill linears run at M = ONESHOT_M rows),
# ONESHOT_TOKENS new tokens (159 decode steps: the 128-token tail fills once
# and the refreeze grows the prefix from 4 to 5 blocks); logits held to the
# plain versions over the first ONESHOT_LOGIT_TICKS decode ticks, and the
# f32 sparse-KV and dense-KV engines over ONESHOT_F32_TICKS
ONESHOT_BATCH, ONESHOT_PROMPT, ONESHOT_TOKENS = 4, 512, 160
ONESHOT_M = ONESHOT_BATCH * ONESHOT_PROMPT
ONESHOT_LOGIT_TICKS, ONESHOT_F32_TICKS = 8, 4
ONESHOT_TOL = {"bf16": 5e-2, "f32": 1e-3}   # max|diff| over the plain range
# the prefill chunk's width classes at bs = 128: a chunk runs padded to the
# next whole block, one captured graph per class
CHUNK_WIDTHS = tuple(range(128, PREFILL_CHUNK + 1, 128))
# the slot capacity at which an unchunked engine's width classes
# (power-of-two block counts) are captured and their memory reported
UNCHUNKED_TOKENS = 4096
# the sparse matmul's row counts: the first past the gemv's 8, one whole
# 16-row MMA tile (the paged verify panel), the flat verify panel, each
# prefill chunk width class (the full chunk the last), and a ragged 300
# (four 64-row chunks and a partial fifth)
MATMUL_M = (9, SLOTS * (PAGED_SPEC_K + 1), SLOTS * (SPEC_K + 1)) \
    + CHUNK_WIDTHS + (300,)
# the ragged chunk of the prefill graph-vs-eager gate (padded to 128 rows)
RAGGED_CHUNK = 77
# the row-independence gate: these first rows of one x, computed in calls of
# every M of ROW_GATE_M, must be the same bits (a verify row must equal the
# decode row of the same token; a padded chunk's rows, the unpadded ones)
ROW_GATE_ROWS = 9
ROW_GATE_M = (9, SLOTS * (SPEC_K + 1)) + CHUNK_WIDTHS + (300,)
# the int8 / int4 kernels' row counts: a single row, the decode tick, the
# gemv's largest, then the sparse matmul's; traced at the decode tick and
# the prefill chunk
INT_M = (1, SLOTS, 8) + MATMUL_M[1:]
INT_TRACED = (SLOTS, PREFILL_CHUNK)
# the fused attention's panel widths Q (query rows Q * G): held to the plain
# versions at the decode tick, a 2-query panel, each spec phase's verify
# panel and two past the first kernel's 16-row cap; timed at the decode
# tick, the verify panel and Q = 9; the attention row-independence gate's
# panel widths; the prefix blocks of the long-context timing (4096 tokens)
ATTN_Q = {"flat": (1, 2, SPEC_K + 1, 9, 17),
          "paged": (1, 2, PAGED_SPEC_K + 1, 9, 17)}
ATTN_TIMED_Q = {"flat": (1, SPEC_K + 1, 9), "paged": (1, PAGED_SPEC_K + 1, 9)}
ROW_GATE_Q = (1, 5, 9, 17)
LONG_SB = 32
# the gemv's row-independence gate: calls of these M, whose rows must equal
# the first rows of the largest call bit for bit (served: bf16, f32 x)
GEMV_GATE_M = (1, SLOTS, 8)
# the unembedding's row counts per weight dtype: the last prefill token,
# the decode tick, the paged and flat verify panels (bf16), the f32 engine's
# decode tick and its k=8 verify panel; every call's rows must equal the
# first rows of the largest call of its dtype bit for bit
UNEMBED_M = {"bf16": (1, SLOTS, SLOTS * (PAGED_SPEC_K + 1),
                      SLOTS * (SPEC_K + 1)),
             "f32": (SLOTS, SLOTS * (max(SPEC_F32_K) + 1))}
# the thirteenth slice: the other dense configs and the VLM at their
# published widths.  Kernel rows at Llama-3-8B's shapes (the paper's
# model; its Table 2 times the projections at batch 1): the seven linears
# at the decode rows through the gemv and the int kernels and at the
# prefill chunk through the sparse matmul, the untied head at the last
# prefill token, the decode tick and the flat verify panel, the attention
# at QG = 4 and 20 (and a 4096-token prefix); Phi-3-mini's D = 96 at
# QG = 1 and InternVL2's D = 64 at QG = 8 (the one-shot decode); a gemv
# and a sparse matmul at InternVL2's ragged K = 896 (its decode batch and
# one-shot prefill rows)
WIDE_LINEARS = {"sparse_gemv": ((1, SLOTS), SLOTS, (SLOTS,)),
                "sparse_matmul": ((PREFILL_CHUNK,), PREFILL_CHUNK,
                                  (PREFILL_CHUNK,)),
                "sparse_matmul_int8": ((1, SLOTS), SLOTS, ()),
                "sparse_matmul_int4": ((1, SLOTS), SLOTS, ())}
WIDE_ROW_GATE_M = (1, SLOTS, 8)
WIDE_UNEMBED_M = (1, SLOTS, SLOTS * (SPEC_K + 1))
WIDE_ATTN_Q = {"flat": (1, 2, SPEC_K + 1, 9, 17),
               "paged": (1, 2, SPEC_K + 1, 9, 17)}
WIDE_ATTN_TIMED_Q = {"flat": (1, SPEC_K + 1), "paged": (1, SPEC_K + 1)}
# Llama-3-8B served at full width and depth: 6 requests of 200-1000
# tokens, 64 new, one seeded; Phi-3-mini at full width, PHI_LAYERS of its
# 32 layers, 4 requests, 32 new; InternVL2-1B at full width and depth
# through the one-shot engine: VLM_BATCH prompts of VLM_PROMPT tokens after
# its 256 seeded frontend embeddings, VLM_TOKENS new
LLAMA_REQUESTS, LLAMA_NEW_TOKENS, LLAMA_PROMPT_RANGE = 6, 64, (200, 1000)
PHI_LAYERS, PHI_REQUESTS, PHI_NEW_TOKENS = 8, 4, 32
PHI_PROMPT_RANGE = PROMPT_RANGE
VLM_BATCH, VLM_PROMPT, VLM_TOKENS = 2, 128, 32
WIDE_CHECKS = (("bf16", "bf16", (), True),)
# the MoE family: Phi-3.5-MoE at full width, 8 of its 32 layers (its dense
# bf16 experts take 2.52 GB a layer), 6 requests of 200-600 tokens, 32 new,
# one seeded; Llama-4-Scout at full width, 4 of its 48 layers (4.03 GB of
# experts a layer; 40 heads padded to 48, so G = 6), 4 requests, 32 new;
# their heads at M = 1, the slots and the 20-row verify panel, Scout's
# attention at its decode tick and verify panel, the MoE layer alone at the
# decode tick's and the chunk's rows
MOE_LAYERS = {"phi3.5-moe-42b-a6.6b": 8, "llama4-scout-17b-a16e": 4}
PHI_MOE_REQUESTS, PHI_MOE_NEW_TOKENS = 6, 32
SCOUT_REQUESTS, SCOUT_NEW_TOKENS = 4, 32
# the recurrent, hybrid and encoder-decoder families (one-shot only):
# RWKV-6-7B at full width and depth, 4 prompts of 512 tokens, 32 new;
# SeamlessM4T-medium at full width and depth, 4 x (256 seeded frames of
# src_embeds + 128 prompt tokens), 32 new; Jamba reduced, 4 x 256, 32 new;
# one Mamba mixer at Jamba's full width: mamba_apply over 4 x 256 rows,
# then MAMBA_STEPS decode steps from its state
RWKV_BATCH, RWKV_PROMPT, RWKV_TOKENS = 4, 512, 32
SEAMLESS_BATCH, SEAMLESS_FRAMES, SEAMLESS_PROMPT, SEAMLESS_TOKENS = \
    4, 256, 128, 32
JAMBA_BATCH, JAMBA_PROMPT, JAMBA_TOKENS = 4, 256, 32
MAMBA_BATCH, MAMBA_ROWS, MAMBA_STEPS = 4, 256, 8
MAMBA_TOL = 1e-2            # max|diff| over the plain range, one layer
# the kernels of a one-shot forward, each launch held to its plain version
# on the live state at the kernel phase's tolerances (of the largest
# output): the linears two bf16 ulps (both round an f32 sum to bf16 once;
# the dense kernel's bf16 output is Mamba's w_bcdt, its f32 head lands far
# inside), the attention 1e-3
HELD_TOL = {"sparse_gemv": 2.0 ** -7, "_sparse_matmul_kernel": 2.0 ** -7,
            "_dense_kernel": 2.0 ** -7, "sparse_decode_attention_fused": 1e-3}
# the dense kernel at the K that stages x in panels: RWKV-6's w_cv under
# --dense (also Llama-3-8B's w_down) and Jamba's Mamba w_bcdt
WIDE_K = {"rwkv6-7b": (14336, 4096), "jamba-1.5-large-398b": (16384, 544)}
WIDE_K_M = (1, 4, 16, 64, 300)
NEW_HEAD_M = (1, 4)
MOE_HEAD_M = (1, SLOTS, SLOTS * (SPEC_K + 1))
# the sparse linears (the attention; Scout's shared expert too) through the
# gemv at the decode tick and below, and through the sparse matmul at the
# verify panel and the prefill chunk, the chunk also traced
MOE_LINEARS = {"sparse_gemv": ((1, SLOTS), SLOTS, (SLOTS,)),
               "sparse_matmul": ((SLOTS * (SPEC_K + 1), PREFILL_CHUNK),
                                 PREFILL_CHUNK, (PREFILL_CHUNK,))}
MOE_ROWS = (SLOTS, PREFILL_CHUNK)
# the training slice: full-width Qwen3-0.6B trained TRAIN_STEPS steps of
# TRAIN_BATCH x TRAIN_SEQ tokens (the dense kernel at M = 8192); its
# gradients held against the plain versions at TRAIN_CHECK_BATCH x
# TRAIN_CHECK_SEQ (full width and depth), microbatches of TRAIN_MICRO;
# restart at TRAIN_RESTART_LAYERS layers of full width (a checkpoint of
# the whole model and its f32 state would take 8.4 GB); one step and one
# one-shot prefill of TRAIN_LONG tokens (past full_attn_max: the blocked
# attention); one step of each other family's reduced config
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_MICRO = 8, 1024, 8, 4
# the traced step: 1 x 1024 tokens (on an H100 80GB HBM3 at 700 W, reading
# the trace of a whole 8 x 1024 step, 160 K kernel records, took 84.7 s of
# a 181 s phase, and of a 2 x 1024 step 35 s); the microbatch check at
# TRAIN_BATCH x TRAIN_MICRO_SEQ
TRAIN_TRACE_BATCH, TRAIN_MICRO_SEQ = 1, 256
TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ = 2, 256
TRAIN_RESTART_LAYERS, TRAIN_RESTART_BATCH, TRAIN_RESTART_SEQ = 4, 2, 256
TRAIN_LONG = 8192
# f32: the kernels and cuBLAS sum f32 products in other orders; bf16: the
# loss of two correct bf16 paths; the blocked schedules at 8192 tokens
# differ only by pairs whose whole block is masked
TRAIN_TOL = {"loss_f32": 1e-5, "grad_f32": 1e-3, "loss_bf16": 1e-2,
             "long_loss": 1e-5, "long_head": 1e-3}
TRAIN_FAMILIES = ("phi3.5-moe-42b-a6.6b", "rwkv6-7b", "jamba-1.5-large-398b",
                  "seamless-m4t-medium", "internvl2-1b")
# kernels a traced tick reports by name: (substring of the trace's kernel
# name); the flat decode tick must hold one gemv launch per linear and no
# sum_partials
TRACED_KERNELS = {"unembed": "unembed_", "gemv": "sparse_gemv<",
                  "sum_partials": "sum_partials"}
# a traced tick's device time by class: a kernel counts in the first class
# one of whose substrings its name holds; cuBLAS's GEMMs (the MoE's expert
# products and router, the chunk's f32 attention) in "library_gemm"
TRACE_CLASSES = (("gemv", ("sparse_gemv<",)),
                 ("attention", ("split_decode_attention",)),
                 ("head", ("unembed_",)),
                 ("sparse_matmul", ("sparse_matmul", "sum_partials",
                                    "int_epilogue")),
                 ("library_gemm", ("gemm", "gemv", "nvjet", "cutlass",
                                   "xmma")))
# the decode-logits checks a serve phase runs: (name, dtype, kernels the
# plain path keeps, gated).  On the int paths the attention kernel's f32
# sums, in another order than its plain version's, round to bf16 a ulp
# apart here and there; one bf16 ulp of an activation is up to half an int8
# step, so the next linear's quantised input moves by whole steps and the
# following layers amplify that (measured: 5.6e-2 of the logit range over
# 25 ticks, 5.2e-2 within single ticks).  So the gated int comparison runs
# the attention kernel in both paths, holding each of its launches to its
# plain version on the same inputs, and the all-plain comparison is
# reported beside it.
FLAT_CHECKS = (("bf16", "bf16", (), True), ("f32", "f32", (), True))
INT_CHECKS = (("bf16, attention launches held one by one", "bf16",
               ("sparse_decode_attention_fused_paged",), True),
              ("bf16, all plain", "bf16", (), False))
# decode logits, kernels vs plain versions on one state: max |diff| over
# max |plain|.  In bf16 a one-ulp rounding difference anywhere in 28 layers
# moves the logits of a random-weight model by about 2 % of their range;
# widened to f32 the two paths differ only in summation order.
LOGIT_TOL = {"bf16": 5e-2, "f32": 1e-3}
# top-1 agreement across slot-ticks: over all of them in f32; in bf16 over
# those whose plain top-1 margin exceeds TOP1_CLEAR of the row's largest
# |logit| (below the bf16 noise of up to 2 % of the range, so a flip there
# is possible from rounding alone, and above it a kernel fault shows), of
# which there must be at least TOP1_MIN_COUNTED
TOP1_MIN = 0.99
# host entry points that enqueue work, as the profiler names them
LAUNCH_CALLS = ("cudaGraphLaunch", "cudaLaunchKernel", "cuLaunchKernel",
                "cudaMemcpyAsync", "cudaMemsetAsync")
TOP1_CLEAR = 1e-2
TOP1_MIN_COUNTED = 50
# an MoE's routing is a discontinuity: where a row's router logits of its
# k-th and (k+1)-th expert lie within the bf16 noise of each other, the
# kernels and the plain versions may pick different experts, and the row's
# output then differs by a whole expert.  The logits check therefore runs
# its plain forward on the kernel forward's routing (its own router
# probabilities at those experts), which leaves the kernels' error alone;
# every routing decision that the plain forward would have made otherwise
# must lie within ROUTER_TIE of a tie (router logit gap).  On the H100 the
# largest gap at which such a decision moved was 0.040 (Phi-3.5-MoE, 8
# layers: 13 of 800 decisions moved; Scout 3 of 400, at most 0.003).  The
# greedy identity gate holds the kernels on the plain engine's routing
# (``forced_replay``) and excuses a divergence of the served engine only
# after a routing decision shown to differ
ROUTER_TIE = 5e-2


# --profile: the traced profiles, the kernels' traced device times and
# the training step's traced step (measurements that read a trace); off,
# only the decode tick traces whose kernel counts gate the flat serve run
PROFILE = False
PHASE_S = {}                    # the seconds of each phase of this run


def run_phase(name: str, fn, *args):
    """``fn(*args)``, its seconds added to ``PHASE_S[name]`` and printed."""
    t0 = time.perf_counter()
    try:
        return fn(*args)
    finally:
        PHASE_S[name] = PHASE_S.get(name, 0.0) + time.perf_counter() - t0
        say(f"[phase] {name}: {PHASE_S[name]:.1f} s")


def fail(msg: str, code: int = 1) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(code)


CARD = []                       # "name, power limit" once read


def say(msg: str) -> None:
    """One progress line; every line after the card phase carries the
    card's name and power limit."""
    tag = f" [{CARD[0]}]" if CARD else ""
    print(f"[chip_smoke] {msg}{tag}", flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

class Timer:
    """Median CUDA-event time of one call, the L2 flushed before each."""

    def __init__(self, torch, reps: int = 20, warmup: int = 3):
        self.torch = torch
        self.reps, self.warmup = reps, warmup
        # twice the 50 MB L2: weights are cold on the serving path
        self.flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32,
                                 device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        times = []
        for i in range(self.warmup + self.reps):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            if i >= self.warmup:
                times.append(a.elapsed_time(b))
        return statistics.median(times)


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float = BF16_OPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def block_nnz(bitmap, length: int, cap: int):
    """Packed values a decompressing kernel must read per block: the set
    bits, at most the block's capacity (the gather clamps there)."""
    from repro_torch.core.sparse_format import unpack_bits
    return unpack_bits(bitmap, length).sum(-1).clamp(max=cap)


def values_read(bitmap, length: int, cap: int, valid=None) -> int:
    """Packed values over all blocks; ``valid`` masks the blocks a kernel
    skips."""
    nnz = block_nnz(bitmap, length, cap)
    if valid is not None:
        nnz = nnz * valid
    return int(nnz.sum())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def card_phase(torch, build) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    CARD.append(card)
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60)
    nvcc_v = (nvcc.stdout.strip().splitlines() or ["?"])[-1]
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"nvcc: {nvcc_v}, device {torch.cuda.get_device_name(0)}")
    return card


def build_phase(build) -> float:
    t0 = time.perf_counter()
    logs = build.build_all(extra_flags=("-Xptxas", "-v"))
    dt = time.perf_counter() - t0
    for src, text in logs.items():
        regs = [ln.split("ptxas info    : ")[-1].strip()
                for ln in text.splitlines() if "registers" in ln]
        say(f"build {src}: " + ("; ".join(regs) if regs else "ok"))
    say(f"build: {len(build.SOURCES)} sources in {dt:.1f} s "
        f"({'built' if logs else 'cached'})")
    return dt


def _packed(torch, k, n, gen, sparsity=0.5, mode="bf16"):
    """One random ``[k, n]`` weight packed as the converter packs it:
    bf16 values, or int8 / nibble-packed int4 with a per-channel scale."""
    from repro_torch.core.convert import _to_int4
    from repro_torch.core.pruning import make_mask
    from repro_torch.core.quant import (quantize_weight_int4,
                                        quantize_weight_int8)
    from repro_torch.core.sparse_format import (DEFAULT_BLOCK,
                                                balanced_capacity, pack)
    w = (torch.randn((k, n), generator=gen, device="cuda")
         / k ** 0.5).to(torch.bfloat16)
    mask = make_mask(w, sparsity, "balanced", DEFAULT_BLOCK)
    cap = balanced_capacity(1 - sparsity, DEFAULT_BLOCK)
    if mode == "bf16":
        return pack(w, mask, DEFAULT_BLOCK, capacity=cap)
    quant = quantize_weight_int8 if mode == "int8" else quantize_weight_int4
    q, scale = quant(torch.where(mask, w, torch.zeros_like(w)))
    sw = pack(q, mask, DEFAULT_BLOCK, capacity=cap, scale=scale)
    return _to_int4(sw) if mode == "int4" else sw


def _check(name, got, ref, tol, errs):
    """Max abs error against the plain version, held to ``tol``; returns
    it with the relative error (over the largest plain output)."""
    err = (got.float() - ref.float()).abs().max().item()
    if not (err <= tol):        # NaN fails too
        fail(f"{name}: max abs err {err:.3e} > tolerance {tol:.3e}")
    errs.append(err)
    return err, err / max(ref.float().abs().max().item(), 1e-30)


def _layer_linears(cfg, skip=()):
    """The sparse linears of one layer as (name, K, N), from the specs:
    the leaves ``convert_concrete`` packs (a dense layer's seven; an MoE's
    attention and Scout's shared expert, not its router or expert
    stacks), but those whose paths (``cross/wk``) ``skip`` names."""
    from repro_torch.distributed.convert_plan import _is_sparsifiable
    from repro_torch.models import lm
    from repro_torch.models import module as mod
    out = []
    mod.map_with_path(
        lambda p, s: out.append((p.rsplit("/", 1)[-1], s.shape[-2],
                                 s.shape[-1]))
        if _is_sparsifiable(p, s) and p not in skip else None,
        lm.model_specs(cfg)["blocks"]["l0"])
    return out


def linear_kernels(torch, cfg, timer, gen, detail, plan=None, linears=None):
    """Sparse gemv and matmul (bf16 values; bf16 or, for an engine served
    at f32, f32 activations) and the int8 / int4 kernels at every (K, N) of
    the layer (or of ``linears``, (name, K, N) triples); per-layer sums at
    the serving row counts.  ``plan`` maps a kernel to its (row counts, the
    row count of its summary, the row counts also traced); by default
    every kernel at Qwen3-0.6B's serving rows."""
    from repro_torch.core.quant import quantize_act_int8
    from repro_torch.core.sparse_format import unpack
    from repro_torch.kernels.sparse_gemv import sparse_gemv, \
        sparse_gemv_plain
    from repro_torch.kernels.sparse_matmul import sparse_matmul, \
        sparse_matmul_f32, sparse_matmul_plain
    from repro_torch.kernels.sparse_matmul_int4 import (
        sparse_matmul_int4, sparse_matmul_int4_plain)
    from repro_torch.kernels.sparse_matmul_int8 import (
        sparse_matmul_int8, sparse_matmul_int8_plain)

    linears = linears or _layer_linears(cfg)
    shapes = sorted({(k, n) for _, k, n in linears})

    def sparse_costs(x_rows, kn, sw, x_bytes, out_bytes):
        k, n = kn
        nnz = values_read(sw.bitmap, sw.block[0] * sw.block[1], sw.capacity)
        val_bytes = (nnz + 1) // 2 if sw.packed4 else \
            nnz * sw.values.element_size()
        scale = 0 if sw.scale is None else n * 4 + x_rows * 4
        n_bytes = (x_rows * k * x_bytes + sw.bitmap.numel() * 4 + val_bytes
                   + scale + x_rows * n * out_bytes)
        return n_bytes, 2.0 * x_rows * nnz

    def rows(name, mode, fn, plain, library, m_list, per_layer_m,
             traced=()):
        # f32 activations meet the served bf16 values
        weights = {kn: _packed(torch, *kn, gen,
                               mode="bf16" if mode == "f32" else mode)
                   for kn in shapes}
        dense_w = {kn: unpack(sw) for kn, sw in weights.items()}
        if mode == "f32":
            dense_w = {kn: w.float() for kn, w in dense_w.items()}
        elif mode != "bf16":
            # the library call multiplies int8 by int8 into int32: the
            # unpacked weight, column-major as cuBLASLt's int8 path wants it
            dense_w = {kn: w.t().contiguous().t() for kn, w in
                       dense_w.items()}
        errs, layer = [], {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                           "bytes": 0.0, "ops": 0.0}
        per_m = {}
        for m in m_list:
            pm = {"ms": 0.0, "bound_ms": 0.0, "plain_ms": 0.0,
                  "library_ms": 0.0, "bytes": 0.0, "ops": 0.0}
            for kn in shapes:
                sw, wd = weights[kn], dense_w[kn]
                x = torch.randn((m, kn[0]), generator=gen, device="cuda")
                if mode != "f32":
                    x = x.to(torch.bfloat16)
                if mode == "bf16":
                    args = (x, sw)
                    got, ref = fn(*args), plain(*args)
                    torch.cuda.synchronize()
                    # both accumulate in f32 and round once to bf16: two
                    # bf16 ulps of the largest output
                    tol = 2.0 ** -7 * ref.float().abs().max().item()
                    xb, ob, rate = 2, 2, BF16_OPS_PER_S
                elif mode == "f32":
                    args = (x, sw)
                    got, ref = fn(*args), plain(*args)
                    torch.cuda.synchronize()
                    if got.dtype != torch.float32:
                        fail(f"{name}: output is not f32")
                    # f32 products summed in another order over K <= 3072
                    tol = 1e-4 * ref.abs().max().item()
                    xb, ob, rate = 4, 4, F32_OPS_PER_S
                else:
                    xq, sx = quantize_act_int8(x)
                    args = (xq, sx, sw, torch.bfloat16)
                    got, ref = fn(*args), plain(*args)
                    torch.cuda.synchronize()
                    # exact int32 sums on both sides, the same f32 epilogue
                    # in the same order, one rounding to bf16: bit-equal
                    tol = 0.0
                    xb, ob, rate = 1, 2, INT8_OPS_PER_S
                err, rel = _check(f"{name} M={m} K,N={kn}", got, ref, tol,
                                  errs)
                t = timer(lambda: fn(*args))
                tp = timer(lambda: plain(*args))
                tl = timer(library(args, wd, m))
                nb, no = sparse_costs(m, kn, sw, xb, ob)
                b, by = bound_ms(nb, no, rate)
                row = {"kernel": name, "config": cfg.name, "M": m,
                       "K": kn[0], "N": kn[1],
                       "max_abs_err": err, "tol": tol, "ms": t,
                       "plain_ms": tp, "library_ms": tl, "bound_ms": b,
                       "bound_by": by}
                traced_txt = ""
                if m in traced:
                    # every kernel of one call (partials and their sum),
                    # and the host's enqueue time of one call
                    dev = device_ms_per_call(torch, lambda: fn(*args))
                    row["device_ms"] = dev
                    row["host_ms"] = host_ms_per_call(torch,
                                                      lambda: fn(*args))
                    traced_txt = (f", traced device {dev * 1e3:.1f} us"
                                  if isinstance(dev, float) else f", {dev}")
                    traced_txt += (f", host enqueue "
                                   f"{row['host_ms'] * 1e3:.1f} us")
                detail.append(row)
                say(f"{cfg.name} {name} M={m} K={kn[0]} N={kn[1]}: err "
                    f"{err:.2e} (rel "
                    f"{rel:.1e}, tol {tol:.2e}) kernel {t * 1e3:.1f} us"
                    f"{traced_txt}, plain {tp * 1e3:.1f} us, library "
                    f"{tl * 1e3:.1f} us, bound {b * 1e3:.2f} us")
                count = sum(1 for _, k, n in linears if (k, n) == kn)
                for key in ("device_ms", "host_ms"):
                    if isinstance(row.get(key), float):
                        pm[key] = pm.get(key, 0.0) + count * row[key]
                for key, val in (("ms", t), ("plain_ms", tp),
                                 ("library_ms", tl), ("bytes", nb),
                                 ("ops", no)):
                    pm[key] += count * val
            pm["bound_ms"], pm["bound_by"] = bound_ms(pm["bytes"], pm["ops"],
                                                      rate)
            per_m[m] = pm
            dev_txt = (f" (traced device {pm['device_ms'] * 1e3:.1f} us, "
                       f"host enqueue {pm['host_ms'] * 1e3:.1f} us)"
                       if "device_ms" in pm else "")
            say(f"{cfg.name} {name} per layer at M={m}: kernel "
                f"{pm['ms'] * 1e3:.1f} us"
                f"{dev_txt}, plain {pm['plain_ms'] * 1e3:.1f} us, library "
                f"{pm['library_ms'] * 1e3:.1f} us, bound "
                f"{pm['bound_ms'] * 1e3:.2f} us ({pm['bound_by']})")
        layer = dict(per_m[per_layer_m])
        layer["max_abs_err"] = max(errs)
        layer["per_layer"] = {str(m): v for m, v in per_m.items()}
        return layer

    def mm_library(args, wd, m):
        x = args[0]
        return lambda: torch.matmul(x, wd)

    def int_library(args, wd, m):
        # torch._int_mm needs more than 16 rows: pad decode rows to 32
        xq = args[0]
        if m <= 16:
            xq = torch.nn.functional.pad(xq, (0, 0, 0, 32 - m))
        return lambda: torch._int_mm(xq, wd)

    # the prefill chunk, the verify panels of the spec phases, the first
    # row count past the gemv and a ragged chunk; the flat verify panel and
    # the prefill chunk also traced
    traced = (SLOTS * (SPEC_K + 1), PREFILL_CHUNK)
    if plan is None:
        plan = {"sparse_gemv": ((1, 4, 8), SLOTS, (SLOTS,)),
                # bf16 also at the one-shot engine's prefill, M = B * S rows
                "sparse_matmul": (MATMUL_M + (ONESHOT_M,), PREFILL_CHUNK,
                                  traced),
                "sparse_matmul_f32": (MATMUL_M, PREFILL_CHUNK, traced),
                # the int kernels carry every row count of the int paths:
                # the decode tick and below, both verify panels, the prefill
                # chunk and a ragged chunk; the decode tick and the prefill
                # chunk also traced
                "sparse_matmul_int8": (INT_M, SLOTS, INT_TRACED),
                "sparse_matmul_int4": (INT_M, SLOTS, INT_TRACED)}
    kinds = {"sparse_gemv": ("bf16", sparse_gemv, sparse_gemv_plain,
                             mm_library),
             "sparse_matmul": ("bf16", sparse_matmul, sparse_matmul_plain,
                               mm_library),
             "sparse_matmul_f32": ("f32", sparse_matmul_f32,
                                   sparse_matmul_plain, mm_library),
             "sparse_matmul_int8": ("int8", sparse_matmul_int8,
                                    sparse_matmul_int8_plain, int_library),
             "sparse_matmul_int4": ("int4", sparse_matmul_int4,
                                    sparse_matmul_int4_plain, int_library)}
    out = {}
    for name, (m_list, summary_m, traced_m) in plan.items():
        mode, fn, plain, library = kinds[name]
        out[name] = rows(name, mode, fn, plain, library, m_list, summary_m,
                         traced=traced_m)
    return out


def row_independence(torch, cfg, gen):
    """The first ROW_GATE_ROWS rows of one random x through each sparse
    matmul kernel (the int kernels: of one random quantised x), in calls of
    every M of ROW_GATE_M, at every (K, N) of the layer: bit-equal, or the
    run fails.  The same for the gemv at GEMV_GATE_M, every row of every
    call against the largest call."""
    from repro_torch.core.quant import quantize_act_int8
    from repro_torch.kernels.sparse_matmul import sparse_matmul, \
        sparse_matmul_f32
    from repro_torch.kernels.sparse_matmul_int4 import sparse_matmul_int4
    from repro_torch.kernels.sparse_matmul_int8 import sparse_matmul_int8
    from repro_torch.kernels.sparse_gemv import sparse_gemv
    shapes = sorted({(k, n) for _, k, n in _layer_linears(cfg)})
    checked = {}
    for name, fn, mode in (("sparse_matmul", sparse_matmul, "bf16"),
                           ("sparse_matmul_f32", sparse_matmul_f32, "f32"),
                           ("sparse_matmul_int8", sparse_matmul_int8,
                            "int8"),
                           ("sparse_matmul_int4", sparse_matmul_int4,
                            "int4")):
        # bf16 also at the one-shot engine's prefill rows
        ms = ROW_GATE_M + ((ONESHOT_M,) if name == "sparse_matmul" else ())
        for kn in shapes:
            sw = _packed(torch, *kn, gen,
                         mode="bf16" if mode == "f32" else mode)
            x = torch.randn((max(ms), kn[0]), generator=gen, device="cuda")
            if mode in ("int8", "int4"):
                xq, sx = quantize_act_int8(x.to(torch.bfloat16))
                first = [fn(xq[:m], sx[:m], sw, torch.bfloat16)
                         [:ROW_GATE_ROWS].clone() for m in ms]
            else:
                x = x.to(torch.float32 if mode == "f32" else torch.bfloat16)
                first = [fn(x[:m], sw)[:ROW_GATE_ROWS].clone() for m in ms]
            torch.cuda.synchronize()
            for m, got in zip(ms[1:], first[1:]):
                if not torch.equal(got, first[0]):
                    diff = (got.float() - first[0].float()).abs().max()
                    fail(f"{name} K,N={kn}: the first {ROW_GATE_ROWS} rows "
                         f"differ between M={ms[0]} and M={m} "
                         f"(max |diff| {diff.item():.3e})")
        checked[name] = len(shapes)
        say(f"{name}: the first {ROW_GATE_ROWS} rows are bit-equal across "
            f"M={ms} at {len(shapes)} (K, N) shapes")
    for label, dtype in (("bf16", torch.bfloat16), ("f32 x", torch.float32)):
        for kn in shapes:
            sw = _packed(torch, *kn, gen)
            x = torch.randn((max(GEMV_GATE_M), kn[0]), generator=gen,
                            device="cuda").to(dtype)
            outs = {m: sparse_gemv(x[:m], sw).clone() for m in GEMV_GATE_M}
            torch.cuda.synchronize()
            _gate_rows(torch, f"sparse_gemv ({label}) K,N={kn}", outs)
        checked[f"sparse_gemv ({label})"] = len(shapes)
        say(f"sparse_gemv ({label}): every row of the calls of M="
            f"{GEMV_GATE_M} is bit-equal to the same row of the "
            f"{max(GEMV_GATE_M)}-row call at {len(shapes)} (K, N) shapes")
    return checked


def _gate_rows(torch, name, outs):
    """``outs`` maps M to one call's output on the first M rows of one x:
    each must equal the first rows of the largest call bit for bit."""
    big = max(outs)
    for m, got in outs.items():
        if not torch.equal(got, outs[big][:m]):
            diff = (got.float() - outs[big][:m].float()).abs().max()
            fail(f"{name}: the {m}-row call differs from the first rows of "
                 f"the {big}-row call (max |diff| {diff.item():.3e})")


def _attention_library(torch, q, k_pre, v_pre, tails, n_blocks, tail_len,
                       bs, sm, qn=1):
    """SDPA over the unpacked cache (prefix + ring) with a validity mask per
    panel query: the yardstick of both attention kernels (the port never
    calls it).  q ``[B, Hkv, Q*G, D]`` rows query-major."""
    import torch.nn.functional as F
    b, hkv, qg, hd = q.shape
    g = qg // qn
    sp, tp = k_pre.shape[2], tails.shape[3]
    k_all = torch.cat([k_pre, tails[0]], 2)
    v_all = torch.cat([v_pre, tails[1]], 2)
    pos = torch.arange(sp + tp, device="cuda")[None, None]
    see = tail_len[:, None, None] + torch.arange(qn, device="cuda")[None, :,
                                                                     None]
    valid = ((pos < n_blocks[:, None, None] * bs)
             | ((pos >= sp) & (pos - sp < see)))             # [B, Q, S]
    qs = q.reshape(b, hkv, qn, g, hd).transpose(2, 3).reshape(
        b, hkv * g, qn, hd)
    kr = k_all.repeat_interleave(g, 1)
    vr = v_all.repeat_interleave(g, 1)
    mask = valid[:, None]
    return lambda: F.scaled_dot_product_attention(qs, kr, vr, attn_mask=mask,
                                                  scale=sm)


def _attention_bound(q, qn, g, n_blocks, tail_len, bs, tp, prefix_bytes):
    """The least time of one call: q, the lengths, the f32 output, the
    prefix bytes the caller counts (bitmap words and set values of the
    valid blocks, and the paged table entries) and the tail tokens the
    panel's last query sees, against 4 * D flops per (row, visible token)."""
    b, hkv, qg, hd = q.shape
    nb, tl = n_blocks.tolist(), tail_len.tolist()
    seen = sum(min(t + qn - 1, tp) for t in tl)
    n_bytes = (q.numel() * q.element_size() + 8 * b + q.numel() * 4
               + prefix_bytes + hkv * seen * hd * 2 * q.element_size())
    toks = sum(n * bs + min(t + j, tp) for n, t in zip(nb, tl)
               for j in range(qn))
    return bound_ms(n_bytes, 4.0 * hd * g * hkv * toks)


def _attention_row(torch, timer, detail, name, shape, kernel, plain,
                   library, bound):
    """One timed shape of an attention kernel: CUDA-event time (L2
    flushed), traced device time per launch, the plain version's and the
    library call's event times, and the bound; into the detail rows."""
    bnd, bby = bound
    row = {"kernel": name, **shape, "ms": timer(kernel),
           "device_ms": device_ms_per_call(torch, kernel),
           "plain_ms": timer(plain), "library_ms": timer(library),
           "bound_ms": bnd, "bound_by": bby}
    detail.append(row)
    dev = row["device_ms"]
    say(f"{name} {shape}: kernel {row['ms'] * 1e3:.1f} us (traced device "
        + (f"{dev * 1e3:.1f} us" if isinstance(dev, float) else dev)
        + f"), plain {row['plain_ms'] * 1e3:.1f} us, SDPA "
        f"{row['library_ms'] * 1e3:.1f} us, bound {bnd * 1e3:.2f} us ({bby})")
    return row


def _flat_cache(torch, cfg, gen, b, sb, bs, pool):
    """A flat compressed cache of ``sb`` blocks per slot at the serving KV
    sparsity: (kbm, kvl, vbm, vvl) and the largest |V|."""
    from repro_torch.core.sparse_kv import freeze_chunk_blocks
    kv = torch.randn((2, b, cfg.n_kv, sb * bs, cfg.hd), generator=gen,
                     device="cuda").to(torch.bfloat16)
    return freeze_chunk_blocks(kv[0], kv[1], cfg.kv_k_sparsity,
                               cfg.kv_v_sparsity, bs, pool.cap_k,
                               pool.cap_v), kv[1].float().abs().max().item()


def _paged_arena(torch, cfg, gen, n_phys, bs, pool):
    """A paged arena of ``n_phys`` compressed pages ``[n_phys, Hkv, X]``."""
    from repro_torch.core.sparse_kv import freeze_chunk_blocks
    pk = torch.randn((2, n_phys, cfg.n_kv, bs, cfg.hd), generator=gen,
                     device="cuda").to(torch.bfloat16)
    return [a[:, :, 0] for a in freeze_chunk_blocks(
        pk[0], pk[1], cfg.kv_k_sparsity, cfg.kv_v_sparsity, bs, pool.cap_k,
        pool.cap_v)]


def _flat_prefix_bytes(kbm, kvl, vbm, vvl, n_blocks, bs, hd, pool):
    """The valid blocks' bitmap words and set values."""
    sb, hkv = kbm.shape[2], kbm.shape[1]
    valid = (kbm.new_tensor(range(sb))[None] < n_blocks[:, None])[:, None, :]
    nnz = (values_read(kbm, bs * hd, pool.cap_k, valid)
           + values_read(vbm, bs * hd, pool.cap_v, valid))
    return (hkv * int(n_blocks.sum()) * 2 * (bs * hd // 32) * 4
            + nnz * kvl.element_size())


def _paged_prefix_bytes(arena, table, n_blocks, bs, hd, pool):
    """Each live page once (shared pages are stored once) and the live
    table entries."""
    import torch
    live = sorted({int(table[s, i]) for s in range(table.shape[0])
                   for i in range(int(n_blocks[s]))})
    live_t = torch.tensor(live, device="cuda", dtype=torch.long)
    nnz = int(block_nnz(arena[0][live_t], bs * hd, pool.cap_k).sum()
              + block_nnz(arena[2][live_t], bs * hd, pool.cap_v).sum())
    hkv = arena[0].shape[1]
    return (4 * int(n_blocks.sum()) + hkv * len(live) * 2 * (bs * hd // 32)
            * 4 + nnz * arena[1].element_size()), len(live)


def attention_kernels(torch, cfg, timer, gen, detail, attn_q=ATTN_Q,
                      timed_q=ATTN_TIMED_Q, long=True):
    """The fused decode attention on the flat pool and on the paged arena,
    at the serving geometry (4 slots, bs 128, a 128-token ring): held to
    the plain versions at every panel width of ``attn_q`` (past the first
    kernel's 16-row cap), timed at the panel widths of ``timed_q`` and
    (``long``) at a LONG_SB-block prefix."""
    from repro_torch.core.sparse_format import unpack
    from repro_torch.core.sparse_kv import pooled_view
    from repro_torch.kernels.sparse_attention import (
        gather_paged, sparse_decode_attention_fused,
        sparse_decode_attention_fused_paged,
        sparse_decode_attention_fused_paged_plain,
        sparse_decode_attention_fused_plain)
    from repro_torch.serving.cache_pool import CachePool

    hkv, hd, g = cfg.n_kv, cfg.hd, cfg.padded_heads // cfg.n_kv
    bs, sb, tp = 128, 7, cfg.kv_tail
    b = SLOTS
    sm = 1.0 / hd ** 0.5
    pool = CachePool.build(cfg, SLOTS, LONG_SB * bs, bs=bs, device="cuda")
    tails = torch.randn((2, b, hkv, tp, hd), generator=gen,
                        device="cuda").to(torch.bfloat16)
    out = {}

    def query(qn):
        return torch.randn((b, hkv, qn * g, hd), generator=gen,
                           device="cuda").to(torch.bfloat16)

    # -- flat pool ---------------------------------------------------------
    (kbm, kvl, vbm, vvl), vmax = _flat_cache(torch, cfg, gen, b, sb, bs,
                                             pool)
    k_pre = unpack(pooled_view(kbm, kvl, bs, hd))
    v_pre = unpack(pooled_view(vbm, vvl, bs, hd))
    # empty prefix + 1 tail token; 3 blocks + full ring; full prefix + empty
    # ring; an all-empty slot
    n_blocks = torch.tensor([0, 3, sb, 0], dtype=torch.int32, device="cuda")
    tail_len = torch.tensor([1, tp, 0, 0], dtype=torch.int32, device="cuda")
    vmax = max(vmax, tails[1].float().abs().max().item())
    # f32 scores, weights and sums on both sides, in another order
    tol = 1e-3 * vmax
    pre_bytes = _flat_prefix_bytes(kbm, kvl, vbm, vvl, n_blocks, bs, hd, pool)
    errs, rows = [], {}
    for qn in attn_q["flat"]:
        q = query(qn)
        args = (q, kbm, kvl, vbm, vvl, tails[0], tails[1], bs, sm,
                n_blocks, tail_len, g)
        got = sparse_decode_attention_fused(*args)
        ref = sparse_decode_attention_fused_plain(*args)
        torch.cuda.synchronize()
        err, rel = _check(f"attention Q={qn}", got, ref, tol, errs)
        # panel query 0 of the all-empty slot sees nothing (query j sees j
        # tail tokens more)
        if (ref[3, :, :g].abs().max().item() != 0
                or got[3, :, :g].abs().max().item() != 0):
            fail("attention: the all-empty slot must return zeros")
        say(f"{cfg.name} attention Q={qn} (QG={qn * g}, D={hd}): err {err:.2e} (rel {rel:.1e}, "
            f"tol {tol:.2e})")
        if qn in timed_q["flat"]:
            rows[qn] = _attention_row(
                torch, timer, detail, "sparse_decode_attention_fused",
                {"config": cfg.name, "B": b, "QG": qn * g, "D": hd, "Sb": sb,
                 "n_blocks": n_blocks.tolist(),
                 "tail_len": tail_len.tolist()},
                lambda: sparse_decode_attention_fused(*args),
                lambda: sparse_decode_attention_fused_plain(*args),
                _attention_library(torch, q, k_pre, v_pre, tails, n_blocks,
                                   tail_len, bs, sm, qn),
                _attention_bound(q, qn, g, n_blocks, tail_len, bs, tp,
                                 pre_bytes))
    out["sparse_decode_attention_fused"] = {
        **{k: rows[1][k] for k in ("ms", "device_ms", "plain_ms",
                                   "library_ms", "bound_ms", "bound_by")},
        "max_abs_err": max(errs)}
    flat_case = (kbm, kvl, vbm, vvl, n_blocks, tail_len)

    # -- paged arena -------------------------------------------------------
    n_phys = 16
    arena = _paged_arena(torch, cfg, gen, n_phys, bs, pool)
    dead = 15
    # slot 0: a full private prefix; slot 1 shares slot 0's first three
    # blocks, then two of its own, then dead entries at the poisoned page;
    # slot 2: two blocks; slot 3: no prefix at all, every entry dead
    table = torch.tensor([[0, 1, 2, 3, 4, 5, 6],
                          [0, 1, 2, 7, 8, dead, dead],
                          [9, 10, dead, dead, dead, dead, dead],
                          [dead] * sb], dtype=torch.int32, device="cuda")
    n_blocks = torch.tensor([sb, 5, 2, 0], dtype=torch.int32, device="cuda")
    tail_len = torch.tensor([1, tp, 37, 0], dtype=torch.int32,
                            device="cuda")
    poisoned = [a.clone() for a in arena]
    for a in poisoned:            # NaN values, every bit set
        a[dead] = -1 if a.dtype == torch.int32 else float("nan")
    gk = gather_paged(table, arena[0], arena[1], n_blocks)
    gv = gather_paged(table, arena[2], arena[3], n_blocks)
    k_pre = unpack(pooled_view(*gk, bs, hd))
    v_pre = unpack(pooled_view(*gv, bs, hd))
    pre_bytes, n_live = _paged_prefix_bytes(arena, table, n_blocks, bs, hd,
                                            pool)
    errs, rows = [], {}
    for qn in attn_q["paged"]:
        q = query(qn)
        rest = (tails[0], tails[1], bs, sm, n_blocks, tail_len, g)
        got = sparse_decode_attention_fused_paged(q, *poisoned, table, *rest)
        clean = sparse_decode_attention_fused_paged(q, *arena, table, *rest)
        ref = sparse_decode_attention_fused_paged_plain(q, *arena, table,
                                                        *rest)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            fail(f"paged attention Q={qn}: a NaN-poisoned dead page reached "
                 "the output")
        if not torch.equal(got, clean):
            fail(f"paged attention Q={qn}: a poisoned dead page changed the "
                 "output")
        err, rel = _check(f"paged attention Q={qn}", got, ref, tol, errs)
        if got[3, :, :g].abs().max().item() != 0:
            fail("paged attention: the all-empty slot must return zeros")
        say(f"{cfg.name} paged attention Q={qn} (QG={qn * g}, D={hd}): err {err:.2e} (rel "
            f"{rel:.1e}, tol {tol:.2e}); finite and unchanged with NaN in "
            f"dead page {dead}")
        if qn in timed_q["paged"]:
            rows[qn] = _attention_row(
                torch, timer, detail, "sparse_decode_attention_fused_paged",
                {"config": cfg.name, "B": b, "QG": qn * g, "D": hd, "Sb": sb,
                 "live_pages": n_live,
                 "n_blocks": n_blocks.tolist(),
                 "tail_len": tail_len.tolist()},
                lambda: sparse_decode_attention_fused_paged(
                    q, *poisoned, table, *rest),
                lambda: sparse_decode_attention_fused_paged_plain(
                    q, *arena, table, *rest),
                _attention_library(torch, q, k_pre, v_pre, tails, n_blocks,
                                   tail_len, bs, sm, qn),
                _attention_bound(q, qn, g, n_blocks, tail_len, bs, tp,
                                 pre_bytes))
    out["sparse_decode_attention_fused_paged"] = {
        **{k: rows[1][k] for k in ("ms", "device_ms", "plain_ms",
                                   "library_ms", "bound_ms", "bound_by")},
        "max_abs_err": max(errs)}
    out["attention_row_independence"] = attention_row_independence(
        torch, cfg, gen, flat_case, (arena, table), tails)
    if long:
        long_context(torch, cfg, timer, gen, detail, pool, tails, tol)
    return out


def attention_row_independence(torch, cfg, gen, flat_case, paged_case,
                               tails):
    """Row r of a Q-row panel at tail lengths L must be the same bits as a
    one-row panel of the same query (its G rows) at L + r // G, for every Q
    of ROW_GATE_Q, flat and paged: a verify row equals the decode tick of
    the same token whatever the panel width."""
    from repro_torch.kernels.sparse_attention import (
        sparse_decode_attention_fused, sparse_decode_attention_fused_paged)
    hkv, hd, g = cfg.n_kv, cfg.hd, cfg.padded_heads // cfg.n_kv
    bs, sm, tp = 128, 1.0 / cfg.hd ** 0.5, cfg.kv_tail
    kbm, kvl, vbm, vvl, _, _ = flat_case
    arena, table = paged_case
    # tail lengths leave room for the widest panel's last query
    tail_len = torch.tensor([1, 50, 0, tp - max(ROW_GATE_Q)],
                            dtype=torch.int32, device="cuda")
    cases = {
        "sparse_decode_attention_fused": (
            lambda q, tl: sparse_decode_attention_fused(
                q, kbm, kvl, vbm, vvl, tails[0], tails[1], bs, sm,
                torch.tensor([0, 3, 7, 2], dtype=torch.int32,
                             device="cuda"), tl, g)),
        "sparse_decode_attention_fused_paged": (
            lambda q, tl: sparse_decode_attention_fused_paged(
                q, *arena, table, tails[0], tails[1], bs, sm,
                torch.tensor([7, 5, 2, 0], dtype=torch.int32,
                             device="cuda"), tl, g))}
    checked = {}
    for name, fn in cases.items():
        for qn in ROW_GATE_Q:
            q = torch.randn((SLOTS, hkv, qn * g, hd), generator=gen,
                            device="cuda").to(torch.bfloat16)
            panel = fn(q, tail_len)
            singles = [fn(q[:, :, j * g:(j + 1) * g].contiguous(),
                          tail_len + j) for j in range(qn)]
            torch.cuda.synchronize()
            for j, one in enumerate(singles):
                if not torch.equal(panel[:, :, j * g:(j + 1) * g], one):
                    diff = (panel[:, :, j * g:(j + 1) * g] - one).abs().max()
                    fail(f"{name}: query {j} of a {qn}-query panel differs "
                         f"from a one-query panel at tail length L + {j} "
                         f"(max |diff| {diff.item():.3e})")
        checked[name] = list(ROW_GATE_Q)
        say(f"{name}: every query of a Q-query panel is bit-equal to a "
            f"one-query panel at tail length L + j, Q = {ROW_GATE_Q}")
    return checked


def long_context(torch, cfg, timer, gen, detail, pool, tails, tol):
    """Both kernels at a LONG_SB-block (4096-token) prefix in every slot and
    a half-full ring, held to their plain versions and timed: how the time
    scales with context."""
    from repro_torch.core.sparse_format import unpack
    from repro_torch.core.sparse_kv import pooled_view
    from repro_torch.kernels.sparse_attention import (
        gather_paged, sparse_decode_attention_fused,
        sparse_decode_attention_fused_paged,
        sparse_decode_attention_fused_paged_plain,
        sparse_decode_attention_fused_plain)
    hkv, hd, g = cfg.n_kv, cfg.hd, cfg.padded_heads // cfg.n_kv
    bs, sb, tp, b = 128, LONG_SB, cfg.kv_tail, SLOTS
    sm = 1.0 / hd ** 0.5
    n_blocks = torch.full((b,), sb, dtype=torch.int32, device="cuda")
    tail_len = torch.full((b,), tp // 2, dtype=torch.int32, device="cuda")
    q = torch.randn((b, hkv, g, hd), generator=gen,
                    device="cuda").to(torch.bfloat16)
    (kbm, kvl, vbm, vvl), _ = _flat_cache(torch, cfg, gen, b, sb, bs, pool)
    args = (q, kbm, kvl, vbm, vvl, tails[0], tails[1], bs, sm, n_blocks,
            tail_len, g)
    _check(f"attention Sb={sb}", sparse_decode_attention_fused(*args),
           sparse_decode_attention_fused_plain(*args), tol, [])
    shape = {"config": cfg.name, "B": b, "QG": g, "D": hd, "Sb": sb,
             "n_blocks": n_blocks.tolist(), "tail_len": tail_len.tolist()}
    _attention_row(
        torch, timer, detail, "sparse_decode_attention_fused", shape,
        lambda: sparse_decode_attention_fused(*args),
        lambda: sparse_decode_attention_fused_plain(*args),
        _attention_library(torch, q, unpack(pooled_view(kbm, kvl, bs, hd)),
                           unpack(pooled_view(vbm, vvl, bs, hd)), tails,
                           n_blocks, tail_len, bs, sm),
        _attention_bound(q, 1, g, n_blocks, tail_len, bs, tp,
                         _flat_prefix_bytes(kbm, kvl, vbm, vvl, n_blocks,
                                            bs, hd, pool)))
    del kbm, kvl, vbm, vvl
    # paged: every slot its own pages, in a shuffled order
    arena = _paged_arena(torch, cfg, gen, b * sb, bs, pool)
    table = torch.randperm(b * sb, generator=gen, device="cuda").to(
        torch.int32).reshape(b, sb)
    rest = (table, tails[0], tails[1], bs, sm, n_blocks, tail_len, g)
    _check(f"paged attention Sb={sb}",
           sparse_decode_attention_fused_paged(q, *arena, *rest),
           sparse_decode_attention_fused_paged_plain(q, *arena, *rest), tol,
           [])
    gk = gather_paged(table, arena[0], arena[1], n_blocks)
    gv = gather_paged(table, arena[2], arena[3], n_blocks)
    pre_bytes, n_live = _paged_prefix_bytes(arena, table, n_blocks, bs, hd,
                                            pool)
    _attention_row(
        torch, timer, detail, "sparse_decode_attention_fused_paged",
        {**shape, "live_pages": n_live},
        lambda: sparse_decode_attention_fused_paged(q, *arena, *rest),
        lambda: sparse_decode_attention_fused_paged_plain(q, *arena, *rest),
        _attention_library(torch, q, unpack(pooled_view(*gk, bs, hd)),
                           unpack(pooled_view(*gv, bs, hd)), tails, n_blocks,
                           tail_len, bs, sm),
        _attention_bound(q, 1, g, n_blocks, tail_len, bs, tp, pre_bytes))


def _partial_library(torch, q, k_pre, v_pre, n_blocks, bs, sm):
    """SDPA over the unpacked valid prefix (o only; it returns no lse): the
    partial's yardstick (the port never calls it).  q ``[B, Hkv, G, D]``."""
    import torch.nn.functional as F
    b, hkv, g, hd = q.shape
    kr, vr = (x.repeat_interleave(g, 1) for x in (k_pre, v_pre))
    mask = (torch.arange(k_pre.shape[2], device="cuda")[None]
            < n_blocks[:, None] * bs)[:, None, None, :]
    qs = q.reshape(b, hkv * g, 1, hd)
    return lambda: F.scaled_dot_product_attention(qs, kr, vr, attn_mask=mask,
                                                  scale=sm)


def partial_kernel(torch, cfg, timer, gen, detail):
    """The prefix-only partial (the split kernel in partial mode) at the
    live serving shape (4 slots, bs 128, the serving KV sparsity), one slot
    empty, one partial, one full, one a single block, in bf16 and widened
    to f32: o and live lse held to the plain version, the empty slot's
    o = 0 and lse <= -1e29, NaN in dead blocks never read; a QG = 34 panel
    (past the first design's QG * D <= 2048) held the same way, whose first
    G rows must equal a G-row call's on the same queries bit for bit; at
    LONG_SB blocks in every slot (4096 tokens) held too.  Both shapes timed
    (CUDA events, traced device time) beside the plain version, SDPA on the
    unpacked prefix (o only) and the bound."""
    from repro_torch.core.sparse_format import unpack
    from repro_torch.core.sparse_kv import freeze_chunk_blocks, pooled_view
    from repro_torch.kernels.sparse_attention import (
        sparse_decode_attention_partial,
        sparse_decode_attention_partial_plain)
    from repro_torch.serving.cache_pool import CachePool

    hkv, hd, g = cfg.n_kv, cfg.hd, cfg.padded_heads // cfg.n_kv
    bs, sb, b = 128, 7, SLOTS
    wide = g * ATTN_Q["flat"][-1]           # 34 rows
    sm = 1.0 / hd ** 0.5
    pool = CachePool.build(cfg, SLOTS, sb * bs, bs=bs, device="cuda")
    n_blocks = torch.tensor([0, 3, sb, 1], dtype=torch.int32, device="cuda")
    errs, lse_errs, res = [], [], {}

    def held(name, args):
        """One call held to the plain version: o within 1e-3 of its range
        (f32 expansion, scores and sums on both sides, in another order),
        live lse within 1e-4 + 1e-5 |lse|, empty slots o = 0 and lse <=
        -1e29 on both sides."""
        o, lse = sparse_decode_attention_partial(*args)
        po, plse = sparse_decode_attention_partial_plain(*args)
        torch.cuda.synchronize()
        tol = 1e-3 * po.abs().max().item()
        err, rel = _check(name, o, po, tol, errs)
        live = args[-1] > 0
        dl = (lse[live] - plse[live]).abs()
        if not bool((dl <= 1e-4 + 1e-5 * plse[live].abs()).all()):
            fail(f"{name}: live lse differs by {dl.max().item():.3e}")
        lse_errs.append(dl.max().item())
        for nm, oo, ll in (("kernel", o, lse), ("plain", po, plse)):
            if not bool(live.all()) and (
                    oo[~live].abs().max().item() != 0
                    or ll[~live].max().item() > -1e29):
                fail(f"{name}: the empty slot's {nm} output is not o = 0, "
                     "lse <= -1e29")
        say(f"{name}: o err {err:.2e} (rel {rel:.1e}, tol {tol:.2e}); live "
            f"lse err {dl.max().item():.2e} (tol 1e-4 + 1e-5 |lse|)"
            + ("" if bool(live.all()) else
               f"; empty slot o = 0, lse {lse[~live].max().item():.3e}"))
        return o, lse

    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split('.')[-1]
        kv = torch.randn((2, b, hkv, sb * bs, hd), generator=gen,
                         device="cuda").to(dt)
        kbm, kvl, vbm, vvl = freeze_chunk_blocks(
            kv[0], kv[1], cfg.kv_k_sparsity, cfg.kv_v_sparsity, bs,
            pool.cap_k, pool.cap_v)
        # the wide panel's first G rows are the decode tick's queries
        qw = torch.randn((b, hkv, wide, hd), generator=gen,
                         device="cuda").to(dt)
        q = qw[:, :, :g].contiguous()
        name = f"partial attention {dname}"
        args = (q, kbm, kvl, vbm, vvl, bs, sm, n_blocks)
        o, lse = held(name, args)
        # a NaN-poisoned block past n_blocks (every bitmap bit set, NaN
        # values) must never be read
        dead = 1
        kbm_p, kvl_p, vbm_p, vvl_p = (a.clone() for a in (kbm, kvl, vbm,
                                                           vvl))
        for a in (kbm_p, vbm_p):
            a[3, :, dead:] = -1
        for a in (kvl_p, vvl_p):
            a[3, :, dead:] = float("nan")
        o2, lse2 = sparse_decode_attention_partial(
            q, kbm_p, kvl_p, vbm_p, vvl_p, bs, sm, n_blocks)
        torch.cuda.synchronize()
        if not (torch.isfinite(o2).all() and torch.equal(o2, o)
                and torch.equal(lse2, lse)):
            fail(f"{name}: a NaN-poisoned dead block changed the output")
        say(f"{name}: finite and unchanged with NaN in dead blocks")
        ow, lsew = held(f"{name} QG={wide}",
                        (qw, kbm, kvl, vbm, vvl, bs, sm, n_blocks))
        _gate_rows(torch, f"{name} o rows", {g: o.permute(2, 0, 1, 3),
                                             wide: ow.permute(2, 0, 1, 3)})
        _gate_rows(torch, f"{name} lse rows", {g: lse.permute(2, 0, 1),
                                               wide: lsew.permute(2, 0, 1)})
        say(f"{name}: the first {g} rows of the QG={wide} call are "
            f"bit-equal to the QG={g} call (o and lse)")
        res[dt] = (args, kbm, kvl, vbm, vvl, q)
    del qw, ow, lsew

    def timed(shape, args):
        q, kbm, kvl, vbm, vvl, _, _, nb = args
        k_pre = unpack(pooled_view(kbm, kvl, bs, hd))
        v_pre = unpack(pooled_view(vbm, vvl, bs, hd))
        # q, n_blocks, o and lse (f32), the valid blocks' bitmap words and
        # set values, against 4 * D flops per (row, valid token)
        n_bytes = (q.numel() * q.element_size() + 4 * b + q.numel() * 4
                   + b * hkv * g * 4
                   + _flat_prefix_bytes(kbm, kvl, vbm, vvl, nb, bs, hd, pool))
        return _attention_row(
            torch, timer, detail, "sparse_decode_attention_partial",
            {"B": b, "Hkv": hkv, "QG": g, "bs": bs, **shape,
             "n_blocks": nb.tolist()},
            lambda: sparse_decode_attention_partial(*args),
            lambda: sparse_decode_attention_partial_plain(*args),
            _partial_library(torch, q, k_pre, v_pre, nb, bs, sm),
            bound_ms(n_bytes, 4.0 * hd * g * hkv * int(nb.sum()) * bs))

    row = timed({"Sb": sb}, res[torch.bfloat16][0])
    del res
    # LONG_SB blocks (4096 tokens) in every slot, bf16
    (kbm, kvl, vbm, vvl), _ = _flat_cache(torch, cfg, gen, b, LONG_SB, bs,
                                          pool)
    q = torch.randn((b, hkv, g, hd), generator=gen,
                    device="cuda").to(torch.bfloat16)
    full = torch.full((b,), LONG_SB, dtype=torch.int32, device="cuda")
    args = (q, kbm, kvl, vbm, vvl, bs, sm, full)
    held(f"partial attention bfloat16 Sb={LONG_SB}", args)
    held(f"partial attention float32 Sb={LONG_SB}",
         (q.float(), kbm, kvl.float(), vbm, vvl.float(), bs, sm, full))
    long_row = timed({"Sb": LONG_SB}, args)
    return {"ms": row["ms"], "device_ms": row["device_ms"],
            "plain_ms": row["plain_ms"], "library_ms": row["library_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "max_abs_err": max(errs), "max_lse_err": max(lse_errs),
            "long": {k: long_row[k] for k in ("ms", "device_ms", "plain_ms",
                                              "library_ms", "bound_ms")}}


def unembed_kernel(torch, cfg, timer, gen, detail):
    """The tied unembedding at every serving row count (UNEMBED_M), bf16
    and f32 tables (``head_kernel``).  The summary is the bf16 decode
    tick's row, with the largest error of both."""
    rows = {dname: head_kernel(torch, cfg, timer, gen, detail,
                               UNEMBED_M[dname], dtype)
            for dname, dtype in (("bf16", torch.bfloat16),
                                 ("f32", torch.float32))}
    errs = [r["max_abs_err"] for by_m in rows.values()
            for r in by_m.values()]
    return {**rows["bf16"][SLOTS], "max_abs_err": max(errs)}


def kernel_phase(torch, cfg):
    timer = Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    detail = []
    summary = linear_kernels(torch, cfg, timer, gen, detail)
    summary["row_independence"] = row_independence(torch, cfg, gen)
    summary.update(attention_kernels(torch, cfg, timer, gen, detail))
    summary["sparse_decode_attention_partial"] = partial_kernel(
        torch, cfg, timer, gen, detail)
    summary["dense_matmul"] = unembed_kernel(torch, cfg, timer, gen, detail)
    return summary, detail


@contextlib.contextmanager
def plain_kernels(keep=(), held=None, tol=None):
    """Route the ops layer through the plain versions, for the logits
    comparison only (the package itself has no such switch).  It wraps only
    ``logits_check``'s eager forwards: no graph is captured under it.  Kernels named
    in ``keep`` stay, each launch then also running its plain version on the
    same inputs: the largest error and output go into ``held``, and an error
    above ``tol[name]`` (default 1e-3: the kernel phase's attention
    tolerance) of the largest output fails the run."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.dense_matmul import dense_matmul_plain
    from repro_torch.kernels.sparse_attention import (
        sparse_decode_attention_fused_paged_plain,
        sparse_decode_attention_fused_plain)
    from repro_torch.kernels.sparse_gemv import sparse_gemv_plain
    from repro_torch.kernels.sparse_matmul import sparse_matmul_plain
    from repro_torch.kernels.sparse_matmul_int4 import \
        sparse_matmul_int4_plain
    from repro_torch.kernels.sparse_matmul_int8 import \
        sparse_matmul_int8_plain
    swap = {"_dense_kernel": dense_matmul_plain,
            "sparse_decode_attention_fused":
                sparse_decode_attention_fused_plain,
            "sparse_decode_attention_fused_paged":
                sparse_decode_attention_fused_paged_plain,
            "sparse_gemv": sparse_gemv_plain,
            "_sparse_matmul_kernel": sparse_matmul_plain,
            "_int8_kernel": sparse_matmul_int8_plain,
            "_int4_kernel": sparse_matmul_int4_plain}
    saved = {k: getattr(ops, k) for k in swap}
    for name in keep:
        def held_launch(*a, _kernel=saved[name], _plain=swap[name],
                        _name=name, _tol=(tol or {}).get(name, 1e-3), **kw):
            out, ref = _kernel(*a, **kw), _plain(*a, **kw)
            err = (out.float() - ref.float()).abs().max().item()
            top = ref.float().abs().max().item()
            if not (err <= _tol * top):
                fail(f"{_name} on the live state: max abs err {err:.3e} > "
                     f"{_tol:.1e} of its largest output {top:.3e}")
            held["launches"] = held.get("launches", 0) + 1
            held["max_abs_err"] = max(held.get("max_abs_err", 0.0), err)
            held["max_rel_err"] = max(held.get("max_rel_err", 0.0),
                                      err / max(top, 1e-30))
            return out
        swap[name] = held_launch
    for k, v in swap.items():
        setattr(ops, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(ops, k, v)


def _router_gaps(p, x, k):
    """Per row of ``x [T, d]``: the router logit of its k-th expert less
    that of its (k+1)-th, in f32 as ``moe.route`` computes them."""
    from repro_torch.models import moe
    with moe._exact_f32():
        lg = x.float() @ p["router"]
    s = lg.sort(-1, descending=True).values
    return s[:, k - 1] - s[:, k]


@contextlib.contextmanager
def moe_routing(log, replay=False):
    """Patch ``moe.route`` for ``logits_check``'s eager forwards (no graph
    is captured under it).  Recording: each call's expert ids go to
    ``log["calls"]``.  Replaying: call ``i`` returns the ids recorded by
    call ``i`` of the recording, weighted by this forward's own router
    probabilities at them; each row whose own top-k set differs is counted
    (``log["decisions"]``, ``log["flips"]``) with its own router gap
    (``log["flip_gaps"]``)."""
    import torch
    from repro_torch.models import moe
    route = moe.route
    calls = iter(list(log.get("calls", ()))) if replay else None

    def record(p, x, k):
        top_p, top_i = route(p, x, k)
        log.setdefault("calls", []).append(top_i)
        return top_p, top_i

    def follow(p, x, k):
        _, own = route(p, x, k)
        want = next(calls)
        with moe._exact_f32():
            probs = torch.softmax(x.float() @ p["router"], dim=-1)
        top_p = probs.gather(1, want)
        top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
        moved = (own.sort(-1).values != want.sort(-1).values).any(-1)
        log["decisions"] = log.get("decisions", 0) + moved.numel()
        log["flips"] = log.get("flips", 0) + int(moved.sum())
        log.setdefault("flip_gaps", []).extend(
            _router_gaps(p, x, k)[moved].tolist())
        return top_p, want

    moe.route = follow if replay else record
    try:
        yield log
    finally:
        moe.route = route


def _clone(tree, dtype=None):
    """Copy a state or params tree; ``dtype`` widens the floating leaves
    (sparse weights keep their packed values, bitmaps and scales)."""
    from repro_torch.core.sparse_format import BlockSparseWeight
    if isinstance(tree, dict):
        return {k: _clone(v, dtype) for k, v in tree.items()}
    if isinstance(tree, BlockSparseWeight):
        return tree
    if dtype is not None and tree.is_floating_point():
        return tree.to(dtype)
    return tree.clone()


def _refreeze_copies(eng, states, tail_len):
    """Fold the full tails of copies of the engine's state, as the engine
    would between ticks; on the paged pool onto pages that no table row of
    the copies references (the copies start equal, so they get the same
    pages).  ``tail_len`` is the host mirror, updated in place."""
    import numpy as np
    pool = eng.pool
    full = [s for s in range(pool.slots) if tail_len[s] >= pool.tail]
    if not full:
        return
    if pool.paged:
        tb = pool.tail // pool.bs
        free = (states[0]["refcount"] == 0).nonzero().flatten().tolist()
        if len(free) < len(full) * tb:
            fail("logits check: no free arena pages to fold the tails into")
        ids = np.zeros((pool.slots, tb), np.int64)
        for n, s in enumerate(full):
            ids[s] = free[n * tb:(n + 1) * tb]
        for st in states:
            pool.refreeze(st, ids)
    else:
        for st in states:
            pool.refreeze(st)
    for s in full:
        tail_len[s] = 0


def logits_check(torch, eng, cfg, dtype=None, n_ticks=LOGIT_TICKS, keep=()):
    """Teacher-forced ticks from the engine's live state, once through the
    kernels and once through the plain versions (but for the kernels in
    ``keep``, held launch by launch to their plain versions), in the serving
    dtype or (``dtype=torch.float32``) widened to f32.  A speculating
    engine's ticks are verify panels: ``k + 1`` rows of the last token and
    the drafter's proposals (clamped to the tail headroom, as the engine
    clamps them), accepted greedily against the plain logits, both states
    then rolled back alike.  Every row within the headroom is compared.
    Full tails are folded between ticks as the engine folds them.  An MoE's
    plain forward follows the kernel forward's routing (``moe_routing``)."""
    import dataclasses
    from repro_torch.models import lm
    slots, mask, tokens = _decode_inputs(torch, eng)
    pool, k = eng.pool, (eng._spec.k if eng._spec is not None else 0)
    sch = eng.scheduler
    hist = {s: list(sch.active[s].prompt) + list(sch.active[s].generated)
            for s in slots}
    params = eng.params
    if dtype is not None:
        name = str(dtype).split(".")[-1]
        cfg = dataclasses.replace(cfg, compute_dtype=name, param_dtype=name)
        params = _clone(params, dtype)
    st_k, st_p = _clone(eng.state, dtype), _clone(eng.state, dtype)
    tail_len = eng._tail_len.copy()
    worst, agree, margins, held = 0.0, [], [], {}
    routing = {} if cfg.n_experts else None

    def moe_ctx(replay):
        return (moe_routing(routing, replay) if routing is not None
                else contextlib.nullcontext())
    for _ in range(n_ticks):
        _refreeze_copies(eng, (st_k, st_p), tail_len)
        panel = torch.zeros((pool.slots, k + 1), dtype=torch.long,
                            device="cuda")
        panel[:, 0] = tokens[:, 0]
        drafts = {}
        for s in slots:
            cap = min(k, pool.tail - 1 - int(tail_len[s]))
            drafts[s] = eng.drafter.propose(hist[s], cap) if cap > 0 else []
            if drafts[s]:
                panel[s, 1:1 + len(drafts[s])] = torch.tensor(drafts[s])
        if routing is not None:
            routing.pop("calls", None)
        with moe_ctx(False):
            lk, st_k = lm.forward_panel_pooled(params, st_k, panel, mask,
                                               cfg, pool.bs)
        with plain_kernels(keep, held), moe_ctx(True):
            lp, st_p = lm.forward_panel_pooled(params, st_p, panel, mask,
                                               cfg, pool.bs)
        n_rows = [1 + min(k, pool.tail - 1 - int(tail_len[s]))
                  for s in slots]
        lk = torch.cat([lk[s, :n].float() for s, n in zip(slots, n_rows)])
        lp = torch.cat([lp[s, :n].float() for s, n in zip(slots, n_rows)])
        if not torch.isfinite(lk).all():
            fail("logits through the kernels are not finite")
        worst = max(worst, ((lk - lp).abs().max()
                            / lp.abs().max()).item())
        agree += (lk.argmax(-1) == lp.argmax(-1)).tolist()
        top2 = lp.topk(2, -1).values
        margins += ((top2[:, 0] - top2[:, 1])
                    / lp.abs().max(-1).values).tolist()
        # greedy acceptance against the plain logits
        best = lp.argmax(-1).tolist()
        roll = torch.zeros(pool.slots, dtype=torch.int32)
        row = 0
        for s, n in zip(slots, n_rows):
            d, am = drafts[s], best[row:row + n]
            a = next((i for i, t in enumerate(d) if t != am[i]), len(d))
            hist[s] += d[:a] + [am[a]]
            tokens[s, 0] = am[a]
            tail_len[s] += a + 1
            roll[s] = k - a
            row += n
        if k:
            pool.rollback(st_k, roll)
            pool.rollback(st_p, roll)
    clear = [a for a, m in zip(agree, margins) if m > TOP1_CLEAR]
    return {"dtype": "bf16" if dtype is None else "f32", "kept": keep,
            "panel": k + 1, "held": held, "rel_err": worst,
            "top1": sum(agree) / len(agree),
            "slot_ticks": len(agree),
            "top1_clear": sum(clear) / max(len(clear), 1),
            "clear_slot_ticks": len(clear),
            "top1_margin_min": min(margins),
            "flip_margins": sorted(m for a, m in zip(agree, margins)
                                   if not a),
            "routing": None if routing is None else {
                "decisions": routing.get("decisions", 0),
                "flips": routing.get("flips", 0),
                "flip_gaps": sorted(routing.get("flip_gaps", []))}}


def _decode_inputs(torch, eng):
    slots = eng.scheduler.decoding_slots()
    b = eng.pool.slots
    mask = torch.zeros(b, dtype=torch.bool, device="cuda")
    mask[slots] = True
    tokens = torch.zeros((b, 1), dtype=torch.long, device="cuda")
    for s in slots:
        tokens[s, 0] = eng._last_tok[s]
    return slots, mask, tokens


def decode_profile(torch, eng, cfg, n_ticks=8, trace=False):
    """Wall time per decode tick through the kernels (forward, sampler and
    the token sync, from a copy of the live state), and the device time of
    the same ticks from a ``torch.profiler`` trace: the device's busy and
    idle shares.  A speculating engine's tick is a verify panel of ``k + 1``
    rows (no drafts: the work does not depend on them) with the accept and
    a rollback of the whole panel, so the copy's state stays put."""
    from repro_torch.models import lm
    from repro_torch.serving import sampling
    slots, mask, tokens = _decode_inputs(torch, eng)
    live = mask.tolist()
    st = _clone(eng.state)
    k = eng._spec.k if eng._spec is not None else 0
    panel = tokens.repeat(1, k + 1)
    no_drafts = torch.zeros(len(live), dtype=torch.long)

    def tick():
        if not k:
            logits, _ = lm.forward_panel_pooled(eng.params, st, tokens, mask,
                                                cfg, eng.pool.bs)
            tok, _ = sampling.sample_step(logits[:, 0], eng.lanes,
                                          [None] * len(live), live)
            tok.tolist()
            return
        logits, _ = lm.forward_panel_pooled(eng.params, st, panel, mask, cfg,
                                            eng.pool.bs)
        tok, _, nc = sampling.accept_step(logits, panel, no_drafts,
                                          eng.lanes, [None] * len(live),
                                          live)
        eng.pool.rollback(st, (k + 1) * mask.to(torch.int32))
        tok.tolist(), nc.tolist()

    res = {"ticks": n_ticks, "slots": len(slots), "panel": k + 1}
    return _profiled(torch, tick, n_ticks, res, trace)


def graph_against_eager(torch, eng, cfg, qn, n_ticks=3):
    """The captured forward against the eager one, from two copies of the
    live state: ``n_ticks`` ticks of a ``[slots, qn]`` panel (each live
    slot's last token, then seeded random tokens), the logits and the whole
    state after each tick bit-equal; both copies are rolled back between
    ticks so every tick appends within the ring's headroom where it has
    it."""
    from repro_torch.models import lm
    from repro_torch.serving import panel_entry
    slots, mask, tokens = _decode_inputs(torch, eng)
    live = mask.tolist()
    st_g, st_e = _clone(eng.state), _clone(eng.state)
    fwd = panel_entry(eng.params, st_g, cfg, eng.pool.bs, qn)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(qn)
    grow = qn * mask.to(torch.int32)
    for t in range(n_ticks):
        panel = torch.randint(0, cfg.vocab, (eng.pool.slots, qn),
                              generator=gen, device="cuda")
        panel[:, 0] = tokens[:, 0]
        fwd.set(tokens=panel, mask=live)
        got = fwd.run().clone()
        want, _ = lm.forward_panel_pooled(eng.params, st_e, panel, mask, cfg,
                                          eng.pool.bs)
        torch.cuda.synchronize()
        if not torch.equal(got[slots], want[slots]):
            err = (got[slots] - want[slots]).abs().max().item()
            fail(f"graph vs eager at Q={qn}, tick {t}: logits differ (max "
                 f"|diff| {err:.3e}); a replay must give the eager bits")
        for a, b in zip(_flat_leaves(st_g), _flat_leaves(st_e)):
            if not torch.equal(a, b):
                fail(f"graph vs eager at Q={qn}, tick {t}: the states the "
                     "two forwards left differ")
        eng.pool.rollback(st_g, grow)
        eng.pool.rollback(st_e, grow)
    return {"qn": qn, "ticks": n_ticks, "slots": len(slots),
            "bit_equal": True, "held_launches": fwd.held}


def _flat_leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _flat_leaves(v)]
    return [tree]


def graph_profile(torch, eng, cfg, n_ticks=8, trace=False):
    """The engine's tick as the main path runs it, on a copy of the live
    state: one replay of a forward captured over the copy (``[slots, 1]``,
    or ``[slots, k+1]`` for a speculating engine, no drafts), the sampler
    (or the accept) and the token sync, the panel rolled back after each
    tick so the copy stays put.  Timed and traced like ``decode_profile``;
    also the CUDA-event time of the replay alone (the graph's device time,
    gaps between its kernels included)."""
    from repro_torch.serving import panel_entry, sampling
    slots, mask, tokens = _decode_inputs(torch, eng)
    live = mask.tolist()
    st = _clone(eng.state)
    k = eng._spec.k if eng._spec is not None else 0
    t0 = time.perf_counter()
    fwd = panel_entry(eng.params, st, cfg, eng.pool.bs, k + 1)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    fwd.set(tokens=tokens.repeat(1, k + 1), mask=live)
    grow = (k + 1) * mask.to(torch.int32)
    no_drafts = torch.zeros(len(live), dtype=torch.long)

    def tick():
        logits = fwd.run()
        if not k:
            tok, _ = sampling.sample_step(logits[:, 0], eng.lanes,
                                          [None] * len(live), live)
            tok.tolist()
        else:
            tok, _, nc = sampling.accept_step(logits, fwd.inputs["tokens"],
                                              no_drafts, eng.lanes,
                                              [None] * len(live), live)
            tok.tolist(), nc.tolist()
        eng.pool.rollback(st, grow)

    res = {"ticks": n_ticks, "slots": len(slots), "panel": k + 1,
           "capture_s": capture_s, "graph_held_launches": fwd.held}
    _profiled(torch, tick, n_ticks, res, trace)
    if "named" in res and fwd.held.get("dense_matmul") and \
            not res["named"]["unembed"]["per_tick"]:
        # every graph holds the unembedding: a trace without it lacks the
        # graph's kernels, and its busy time is the sampler's alone
        res["device"] = ("not measured: the trace holds none of the "
                         "graph's kernels")
        for key in ("device_ms", "idle_share"):
            res.pop(key, None)

    def replay():
        fwd.run()
        eng.pool.rollback(st, grow)
    reps = 20
    replay()
    res["replay_event_ms"] = _replay_ms(torch, fwd.run, reps)
    # the replay's span counted busy whole, gaps between its kernels too
    res["idle_share_replay_span"] = max(
        0.0, 1 - res["replay_event_ms"] / res["wall_ms"])
    eng.pool.rollback(st, reps * grow)
    return res


def _replay_ms(torch, replay, reps):
    """CUDA-event time of one call of ``replay`` (a captured entry's run),
    over ``reps`` back-to-back calls (its span: its kernels and the gaps
    between)."""
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _profiled(torch, fn, n, res, trace=False):
    """Wall time per call of ``fn`` (each ends in a sync), then, with
    ``--profile`` or ``trace``, a ``torch.profiler`` trace of ``n`` more
    calls: device busy time, idle share, the top device kernels and the top
    host ops by self CPU time (inflated by the profiler's own cost), all
    per call, into ``res``."""
    from repro_torch import kernels
    fn()
    torch.cuda.synchronize()
    before = kernels.launch_counts()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    res["wall_ms"] = (time.perf_counter() - t0) / n * 1e3
    # the wrappers' counters a call (graph replays included): exact, where
    # the trace below may lose a kernel record now and then
    res["wrapper_launches"] = {
        k: (v - before[k]) / n for k, v in kernels.launch_counts().items()}
    if not (PROFILE or trace):
        res["device"] = "not measured: traces run under --profile"
        return res
    # the profiler is a measurement, not a check: its own failures are
    # reported; a failing call fails the run
    try:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
    except Exception as e:
        res["device"] = f"not measured: {type(e).__name__}: {e}"
        return res
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    try:
        prof.stop()
        events = prof.key_averages()
        rows = [(e.key, e.self_device_time_total / n / 1e3, e.count // n)
                for e in events if "CUDA" in str(e.device_type)
                and e.self_device_time_total > 0]
        totals = {e.key: e.count for e in events
                  if "CUDA" in str(e.device_type)
                  and e.self_device_time_total > 0}
        host = [(e.key, e.self_cpu_time_total / n / 1e3, e.count // n)
                for e in events if "CPU" in str(e.device_type)
                and e.self_cpu_time_total > 0]
    except Exception as e:
        res["device"] = f"not measured: {type(e).__name__}: {e}"
        return res
    if not rows:
        res["device"] = "not measured: the trace holds no device time"
        return res
    rows.sort(key=lambda r: -r[1])
    host.sort(key=lambda r: -r[1])
    res["named"] = {
        label: {"ms_per_tick": sum(t for k, t, _ in rows if pat in k),
                "per_tick": sum(c for k, _, c in rows if pat in k),
                "traced": sum(c for k, c in totals.items() if pat in k)}
        for label, pat in TRACED_KERNELS.items()}
    # what the host enqueues a tick: graph launches and kernel launches
    # (the ``cuda*`` runtime and the lower ``cu*`` entry points), and what
    # the device runs (every kernel, those inside a graph included)
    res["host_launches"] = {k: c for k, _, c in host
                            if k.startswith(LAUNCH_CALLS)}
    res["device_kernels"] = sum(c for _, _, c in rows)
    by_class = {}
    for k, t, _ in rows:
        cls = next((c for c, pats in TRACE_CLASSES
                    if any(p in k for p in pats)), "other")
        by_class[cls] = by_class.get(cls, 0.0) + t
    res["by_class_ms"] = by_class
    busy = sum(r[1] for r in rows)
    res.update(device_ms=busy, idle_share=max(0.0, 1 - busy / res["wall_ms"]),
               top=[{"kernel": k[:80], "ms_per_tick": t, "per_tick": c}
                    for k, t, c in rows[:8]],
               host_top=[{"op": k[:60], "ms_per_tick": t, "per_tick": c}
                         for k, t, c in host[:8]])
    return res


def _empty_slot(states, slot=0):
    """Zero one slot's lengths in each state copy (its old table entries and
    pages stay, unread behind a zero prefix)."""
    for st in states:
        for key in ("pos", "prefix_blocks", "tail_len"):
            st[key][slot] = 0


def _free_pages(eng, n, what):
    """``n`` arena pages no table row of the engine's state references."""
    free = (eng.state["refcount"] == 0).nonzero().flatten().tolist()
    if len(free) < n:
        fail(f"{what}: {len(free)} free arena pages, {n} needed")
    return free[-n:]


def prefill_profile(torch, eng, cfg, n=4):
    """One full prefill chunk (PREFILL_CHUNK tokens into slot 0 of a copy of
    the live state, emptied before each call) through a prefill entry
    captured over the copy, timed and traced like a tick, with the CUDA
    event time of one replay, the capture's host time (synchronised) and
    its graph's memory; beside it the same chunk eagerly on another copy.
    On the paged pool the chunk's blocks freeze into free arena pages (the
    copies' other contents are never read again)."""
    from repro_torch.models import lm
    from repro_torch.serving import prefill_entry
    bs = eng.pool.bs
    st_g, st_e = _clone(eng.state), _clone(eng.state)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (1, PREFILL_CHUNK), generator=gen,
                         device="cuda")
    slot = torch.zeros(1, dtype=torch.long, device="cuda")
    length = torch.full((1,), PREFILL_CHUNK, device="cuda")
    ids = None
    if eng.pool.paged:
        ids = torch.tensor(_free_pages(eng, PREFILL_CHUNK // bs, "prefill"),
                           device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fwd = prefill_entry(eng.params, st_g, cfg, bs, PREFILL_CHUNK)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    fwd.set(tokens=toks, slot=slot, length=length,
            **({} if ids is None else {"ids": ids}))

    def graph_chunk():
        _empty_slot((st_g,))
        fwd.run()
        torch.cuda.synchronize()

    def eager_chunk():
        _empty_slot((st_e,))
        lm.forward_prefill_chunk(eng.params, st_e, toks, slot, cfg, bs,
                                 new_ids=ids, length=length)
        torch.cuda.synchronize()

    res = _profiled(torch, graph_chunk, n, {
        "tokens": PREFILL_CHUNK, "capture_s": capture_s,
        "graph_mib": fwd.graph_bytes / 2 ** 20,
        "graph_held_launches": fwd.held})
    if "named" in res and not res["named"]["unembed"]["per_tick"]:
        # the graph holds the unembedding: a trace without it lacks the
        # graph's kernels
        res["device"] = ("not measured: the trace holds none of the "
                         "graph's kernels")
        for key in ("device_ms", "idle_share"):
            res.pop(key, None)
    res["replay_event_ms"] = _replay_ms(torch, fwd.run, 10)
    res["eager"] = _profiled(torch, eager_chunk, n, {"tokens": PREFILL_CHUNK})
    return res


def chunk_graph_against_eager(torch, eng, cfg):
    """The captured prefill chunk against the eager call on the same padded
    operands, from two copies of the live state with slot 0 emptied: a
    full-width chunk (PREFILL_CHUNK tokens), then a ragged one
    (RAGGED_CHUNK tokens in its 128-row width class) behind it, each
    through a fresh entry of its width class; the logits and the whole
    state after each bit-equal.  On the paged pool the blocks freeze into
    free arena pages."""
    from repro_torch.models import lm
    from repro_torch.serving import prefill_entry
    bs, paged = eng.pool.bs, eng.pool.paged
    st_g, st_e = _clone(eng.state), _clone(eng.state)
    _empty_slot((st_g, st_e))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    lens = (PREFILL_CHUNK, RAGGED_CHUNK)
    widths = [-(-n // bs) * bs for n in lens]
    pages = (_free_pages(eng, sum(widths) // bs, "chunk gate") if paged
             else [])
    slot = torch.zeros(1, dtype=torch.long, device="cuda")
    for n, w in zip(lens, widths):
        toks = torch.zeros((1, w), dtype=torch.long, device="cuda")
        toks[0, :n] = torch.randint(0, cfg.vocab, (n,), generator=gen,
                                    device="cuda")
        length = torch.full((1,), n, device="cuda")
        vals = {"tokens": toks, "slot": slot, "length": length}
        ids = None
        if paged:
            ids = torch.tensor(pages[:w // bs], device="cuda")
            pages = pages[w // bs:]
            vals["ids"] = ids
        fwd = prefill_entry(eng.params, st_g, cfg, bs, w)
        fwd.set(**vals)
        got = fwd.run().clone()
        want, _ = lm.forward_prefill_chunk(eng.params, st_e, toks, slot, cfg,
                                           bs, new_ids=ids, length=length)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            err = (got - want).abs().max().item()
            fail(f"prefill graph vs eager, {n} tokens in a {w}-row chunk: "
                 f"logits differ (max |diff| {err:.3e})")
        if not all(torch.equal(x, y) for x, y in
                   zip(_flat_leaves(st_g), _flat_leaves(st_e))):
            fail(f"prefill graph vs eager, {n} tokens in a {w}-row chunk: "
                 "the states the two left differ")
    return {"lengths": lens, "widths": widths, "bit_equal": True}


def refreeze_graph_against_eager(torch, eng):
    """The captured refreeze against the eager one on two copies of the
    live state where the slot with the fewest prefix blocks is full and
    every other slot is not (on the paged pool onto free pages): the whole
    state bit-equal, and the slots that were not full unchanged."""
    from repro_torch.serving import refreeze_entry
    pool = eng.pool
    st_g, st_e = _clone(eng.state), _clone(eng.state)
    pb = eng.state["prefix_blocks"].tolist()
    full = min(range(pool.slots), key=lambda s: pb[s])
    tail = [min(int(t), pool.tail - 1) for t in eng.state["tail_len"]]
    tail[full] = pool.tail
    for st in (st_g, st_e):
        st["tail_len"].copy_(torch.tensor(tail))
    before = _clone(st_g)
    fwd = refreeze_entry(pool, st_g)
    ids = None
    if pool.paged:
        tb = pool.tail // pool.bs
        ids = torch.zeros((pool.slots, tb), dtype=torch.long, device="cuda")
        ids[full] = torch.tensor(_free_pages(eng, tb, "refreeze gate"))
        fwd.set(ids=ids)
    fwd.run()
    pool.refreeze(st_e, ids)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in
               zip(_flat_leaves(st_g), _flat_leaves(st_e))):
        fail("refreeze graph vs eager: the states the two left differ")
    others = [s for s in range(pool.slots) if s != full]
    for key in ("pos", "prefix_blocks", "tail_len"):
        if not torch.equal(st_g[key][others], before[key][others]):
            fail(f"refreeze: {key} of a slot that was not full changed")
    tb = pool.tail // pool.bs
    if int(st_g["prefix_blocks"][full]) != pb[full] + tb:
        fail("refreeze: the full slot did not fold its tail")
    return {"full_slot": full, "bit_equal": True}


def refreeze_profile(torch, eng, n=4):
    """One refreeze with one slot of the pool full and the others not (the
    usual case: slots fill their rings in turn), on a copy of the live
    state whose lengths, table and refcounts are put back before each
    call: through a refreeze entry captured over the copy, timed and
    traced like a tick, with the CUDA-event time of one replay (the put
    back included); beside it the same refreeze eagerly on another copy.
    On the paged pool the tail folds into free arena pages."""
    from repro_torch.serving import refreeze_entry
    pool = eng.pool
    st_g, st_e = _clone(eng.state), _clone(eng.state)
    pb = eng.state["prefix_blocks"].tolist()
    full = min(range(pool.slots), key=lambda s: pb[s])
    tail = [min(int(t), pool.tail - 1) for t in eng.state["tail_len"]]
    tail[full] = pool.tail
    for st in (st_g, st_e):
        st["tail_len"].copy_(torch.tensor(tail))
    keys = [k for k in ("pos", "prefix_blocks", "tail_len", "table",
                        "refcount") if k in st_g]
    saved = {k: st_g[k].clone() for k in keys}
    fwd = refreeze_entry(pool, st_g)
    ids = None
    if pool.paged:
        tb = pool.tail // pool.bs
        ids = torch.zeros((pool.slots, tb), dtype=torch.long, device="cuda")
        ids[full] = torch.tensor(_free_pages(eng, tb, "refreeze profile"))
        fwd.set(ids=ids)

    def put_back(st):
        for k in keys:
            st[k].copy_(saved[k])

    def graph_refreeze():
        put_back(st_g)
        fwd.run()
        torch.cuda.synchronize()

    def eager_refreeze():
        put_back(st_e)
        pool.refreeze(st_e, ids)
        torch.cuda.synchronize()

    res = _profiled(torch, graph_refreeze, n, {
        "full_slot": full, "capture_s": fwd.capture_s,
        "graph_mib": fwd.graph_bytes / 2 ** 20})

    def put_back_and_replay():
        put_back(st_g)
        fwd.run()
    res["replay_event_ms"] = _replay_ms(torch, put_back_and_replay, 10)
    res["eager"] = _profiled(torch, eager_refreeze, n, {})
    return res


@contextlib.contextmanager
def sync_free(torch, eng, gated):
    """Run every dispatch that must not wait for the device under
    ``torch.cuda.set_sync_debug_mode("error")``, where a host sync raises:
    a non-final prefill chunk whose width class is captured, a refreeze
    whose entry is captured (and that needs no pipeline drain, which the
    paged pool keeps for pages promised to others), an admission whose
    assignment entry is captured.  ``gated`` counts each kind."""
    def guarded(key, fn, ready):
        def run(*a, **k):
            if not ready():
                return fn(*a, **k)
            gated[key] += 1
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return run

    def chunk():
        req, sch = eng.scheduler.next_prefill(), eng.scheduler
        return (req is not None and sch.chunk is not None
                and len(req.prompt) - req.prefill_done > sch.chunk
                and ("prefill_chunk", sch.chunk) in eng._entries)

    def refreeze():
        n = sum(t >= eng.pool.tail for t in eng._tail_len)
        if not n or "refreeze" not in eng._entries:
            return False
        return eng._alloc is None or eng._inflight is None or (
            n * (eng.pool.tail // eng.pool.bs) + sum(eng._reserved.values())
            <= eng._alloc.free_blocks())

    names = ("_prefill_tick", "_refreeze_tick", "_admit_paged")
    saved = {n: eng.__dict__.get(n) for n in names}
    eng._prefill_tick = guarded("chunk", eng._prefill_tick, chunk)
    eng._refreeze_tick = guarded("refreeze", eng._refreeze_tick, refreeze)
    if eng._alloc is not None:
        eng._admit_paged = guarded("assign", eng._admit_paged,
                                   lambda: "assign" in eng._entries)
    try:
        yield gated
    finally:
        for n, fn in saved.items():
            if fn is None:
                eng.__dict__.pop(n, None)
            else:
                setattr(eng, n, fn)


def _model(torch, cfg, mode):
    from repro_torch.core.convert import convert_concrete
    from repro_torch.models import lm
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    params = convert_concrete(params, lm.model_specs(cfg), cfg, mode=mode,
                              device="cuda")
    torch.cuda.synchronize()
    say(f"serve: {cfg.name} (d {cfg.d_model}, {cfg.n_layers} layers), "
        f"{mode} weights initialised and packed on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    return params


def _engine(cfg, params, paused, max_tokens, paged=False, spec_k=0,
            overlap=False):
    from repro_torch.serving import ContinuousEngine, SpecConfig
    eng = ContinuousEngine(params, cfg, slots=SLOTS, max_tokens=max_tokens,
                           prefill_chunk=PREFILL_CHUNK, device="cuda",
                           paged=paged,
                           spec=SpecConfig(k=spec_k) if spec_k else None,
                           clock=lambda: time.perf_counter() - paused[0],
                           overlap=overlap)
    if eng.pool.bs != 128:
        fail(f"expected bs=128, got {eng.pool.bs}")
    return eng


def serve_stream(torch, eng, cfg, prompts, params_of, paused, ready=None,
                 checks=FLAT_CHECKS, on_step=None, lead=False,
                 check_ticks=LOGIT_TICKS, rows=None, prefill=False,
                 graph_qn=(), label="serve"):
    """Submit the requests and run the engine to completion (and drain its
    pipeline) with every kernel counter zeroed just before and read just
    after, every non-final chunk, refreeze and assignment through a
    captured entry under the sync-free guard (``sync_free``).  ``lead``
    submits the first request alone and the rest once it has its first
    token (so a shared prefix is frozen before the others arrive).  When
    ``ready(eng)`` first holds, the logits of ``check_ticks`` ticks are
    checked (each of ``checks``), the captured forward is held bit-equal to
    the eager one at each panel width of ``graph_qn`` (and then a
    full-width and a ragged prefill chunk and a refreeze too), and one tick
    is profiled, through a captured graph and eagerly (with ``prefill``,
    also one prefill chunk), outside the counted and timed run (``rows``, a
    ``panel_rows`` count, included).  Decode (or verify) ticks and prefill
    chunks are the engine's entry replays.  The engine captured every
    entry when it was built, before the timed run, and captures nothing
    more (``check_captures``).  Returns the results."""
    from repro_torch import kernels

    check = profile = graph = None
    steps = {"decode": [], "prefill": []}
    gated = {"chunk": 0, "refreeze": 0, "assign": 0}

    def replays(*names):
        n = eng.replay_counts()
        return sum(n.get(k, 0) for k in names)

    with sync_free(torch, eng, gated):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        ticks0 = replays("decode", "verify")
        chunks0 = replays("prefill_chunk")
        t0 = time.perf_counter()
        pending = list(zip(prompts, params_of))
        rids = [eng.submit(*pending.pop(0))] if lead else []
        while pending or not eng.scheduler.done():
            if pending and not (lead and not eng.scheduler.finished
                                and not any(r.generated for r in
                                            eng.scheduler.active.values())):
                rids += [eng.submit(p, sp) for p, sp in pending]
                pending = []
            if check is None and ready is not None and ready(eng):
                c0 = time.perf_counter()
                saved = kernels.launch_counts()
                saved_rows = dict(rows or {})
                check = {name: logits_check(
                    torch, eng, cfg,
                    None if dt == "bf16" else torch.float32,
                    n_ticks=check_ticks, keep=keep)
                    for name, dt, keep, _ in checks}
                for name, _, _, gated_ in checks:
                    check[name]["gated"] = gated_
                graph = [graph_against_eager(torch, eng, cfg, qn)
                         for qn in graph_qn]
                if graph_qn:
                    graph.append(chunk_graph_against_eager(torch, eng, cfg))
                    graph.append(refreeze_graph_against_eager(torch, eng))
                # measurements; the flat serve run's decode tick traces
                # gate its gemv launches, so they run without --profile
                if PROFILE or label == "serve":
                    profile = graph_profile(torch, eng, cfg,
                                            trace=label == "serve")
                    profile["eager"] = decode_profile(torch, eng, cfg,
                                                      trace=label == "serve")
                if PROFILE:
                    profile["refreeze"] = refreeze_profile(torch, eng)
                    if prefill:
                        profile["prefill"] = prefill_profile(torch, eng,
                                                             cfg)
                kernels.set_launch_counts(saved)
                if rows is not None:
                    rows.clear()
                    rows.update(saved_rows)
                paused[0] += time.perf_counter() - c0
            n_pre = replays("prefill_chunk")
            s0 = time.perf_counter()
            eng.step()
            steps["prefill" if replays("prefill_chunk") > n_pre
                  else "decode"].append(time.perf_counter() - s0)
            if on_step is not None:
                on_step(eng)
        eng.quiesce()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0 - paused[0]
        counts = kernels.launch_counts()
    ticks = {"decode": replays("decode", "verify") - ticks0,
             "prefill": replays("prefill_chunk") - chunks0}
    captures = eng.trace_counts()
    check_captures(label, captures, eng)
    out = {r: eng.scheduler.finished[r].output() for r in rids}
    entries = {"/".join(map(str, k)) if isinstance(k, tuple) else k:
               {"capture_s": e.capture_s, "graph_mib": e.graph_bytes / 2 ** 20}
               for k, e in eng._entries.items()}
    return {"rids": rids, "out": out, "seconds": dt, "counts": counts,
            "ticks": ticks, "steps": steps, "check": check,
            "profile": profile, "graph_check": graph, "captures": captures,
            "overlap": eng.overlap, "sync_free": gated, "entries": entries,
            "refreezes": replays("refreeze")}


def check_captures(label, captures, eng):
    """The captures the engine made when it was built, and no more: the
    forward its ticks use (``verify`` under speculation, else ``decode``)
    once, the other never; ``refreeze``, ``release``, ``set_lane`` and
    (paged) ``assign`` once; ``prefill_chunk`` once per width class."""
    used = "verify" if eng._spec is not None else "decode"
    want = {"decode": int(used == "decode"),
            "prefill_chunk": len(CHUNK_WIDTHS), "refreeze": 1,
            "release": 1, "set_lane": 1}
    if eng.pool.paged:
        want["assign"] = 1
    if eng._spec is not None:
        want["verify"] = 1
    if captures != want:
        fail(f"{label}: graph captures {captures}; {want} expected (every "
             "entry captured once when the engine was built)")


def check_replays(label, run, kernel, layers):
    """The attention kernel's counter holds every launch of the run: one a
    layer in each replay of the decode (or verify) entry (its warm-up ran
    when the engine was built, before the counters were zeroed, and the
    capture itself launches nothing).  Prefill chunks run another
    attention, so the count pins the replay accounting exactly."""
    want = layers * run["ticks"]["decode"]
    if run["counts"][kernel] != want:
        fail(f"{label}: {kernel} counted {run['counts'][kernel]} launches; "
             f"{layers} a layer x {run['ticks']['decode']} replays = {want} "
             "expected")


def check_sync_free(label, run, kinds):
    """Each dispatch kind of ``kinds`` ran at least once under the
    sync-free guard (none of them raised, or the run would have failed)."""
    missing = [k for k in kinds if run["sync_free"][k] < 1]
    if missing:
        fail(f"{label}: no {missing} dispatch ran through a captured entry "
             f"under the sync-free guard ({run['sync_free']})")


def check_outputs(label, run, cfg, n_tokens):
    total = 0
    for r in run["rids"]:
        o = run["out"][r]
        toks = o.token_ids
        if len(toks) != n_tokens or o.finish_reason != "length":
            fail(f"{label}: request {r} finished {o.finish_reason!r} with "
                 f"{len(toks)} tokens")
        if min(toks) < 0 or max(toks) >= cfg.vocab:
            fail(f"{label}: request {r} has a token out of range")
        total += len(toks)
    return total


def check_launches(label, counts, launched, idle=()):
    """Every kernel of the path launched on it; kernels of other paths
    not at all."""
    for name in launched:
        if counts[name] <= 0:
            fail(f"{label}: kernel {name} was never launched on the path")
    for name in idle:
        if counts[name] != 0:
            fail(f"{label}: kernel {name} ran {counts[name]} times on a path "
                 "that must not reach it")


def gate_logits(label, check):
    if check is None:
        fail(f"{label}: the logits comparison never ran")
    for name, c in check.items():
        tol = LOGIT_TOL[c["dtype"]]
        rows = ("slot-ticks" if c["panel"] == 1 else
                f"rows of {c['panel']}-query verify panels")
        say(f"{label}: {'decode' if c['panel'] == 1 else 'verify'} logits "
            f"kernels vs plain ({name}"
            f"{'' if c['gated'] else ', reported, not gated'}) over "
            f"{c['slot_ticks']} {rows}: max|diff|/max|plain| "
            f"{c['rel_err']:.2e} (tol {tol}), top-1 agreement "
            f"{c['top1']:.3f}; {c['top1_clear']:.3f} over the "
            f"{c['clear_slot_ticks']} with a top-1 margin above "
            f"{TOP1_CLEAR} of max|logit| (min {TOP1_MIN}); smallest margin "
            f"{c['top1_margin_min']:.2e}, margins of the flips "
            f"{[float(f'{m:.2e}') for m in c['flip_margins']]}"
            + (f"; {c['held']['launches']} launches of "
               f"{', '.join(c['kept'])} each within 1e-3 of its plain "
               f"version on the same inputs (worst {c['held']['max_rel_err']:.1e})"
               if c["kept"] else ""))
        r = c.get("routing")
        if r is not None:
            gaps = r["flip_gaps"]
            say(f"{label}: {name}: the plain forward followed the kernel "
                f"forward's routing; of its {r['decisions']} routing "
                f"decisions (rows x layers) {r['flips']} would have picked "
                f"other experts, at router logit gaps "
                f"{[float(f'{g:.2e}') for g in gaps[-8:]]} (largest last; "
                f"near-tie below {ROUTER_TIE})")
            if c["gated"] and gaps and not gaps[-1] < ROUTER_TIE:
                fail(f"{label}: {name}: a routing decision moved at a router "
                     f"logit gap of {gaps[-1]:.3e}, no near-tie")
        if not c["gated"]:
            continue
        if not (c["rel_err"] <= tol):
            fail(f"{label}: {name} decode logits through the kernels "
                 "disagree with the plain versions")
        if c["clear_slot_ticks"] < TOP1_MIN_COUNTED:
            fail(f"{label}: {name}: only {c['clear_slot_ticks']} slot-ticks "
                 f"with a top-1 margin above {TOP1_CLEAR}")
        if c["top1_clear"] < TOP1_MIN:
            fail(f"{label}: {name} top-1 agreement below {TOP1_MIN} where "
                 "the margin is clear of rounding noise")
    if "f32" in check and check["f32"]["top1"] < TOP1_MIN:
        fail(f"{label}: f32 top-1 agreement below {TOP1_MIN}")


# the last serial run with eager ticks on the same traffic, before the
# forwards were captured (PERF.md section 5, NVIDIA H100 80GB HBM3, 700.00
# W), printed beside this run's: tok/s, TPOT p50 ms, TTFT p50 s, median
# decode (verify) and prefill step ms, kernel launches a traced tick, its
# device busy ms and idle share
EAGER_TICKS = {"serve": (39.4, 71.8, 1.338, 70.0, 169.9, 3045, 7.68, 0.91),
        "spec": (39.5, 70.4, 0.677, 94.5, 228.0, 5112, 12.17, 0.88),
        "spec off": (40.5, 73.0, None, 67.4, 195.4, None, None, None),
        "paged int8": (36.6, 103.8, 5.832, 97.6, 265.3, 5005, 10.15, 0.88),
        "paged int4": (30.7, 96.5, 0.552, 82.2, 261.0, 5005, 10.27, 0.86)}
EAGER_KEYS = ("tok_s", "tpot_p50_ms", "ttft_p50_s", "decode_step_ms",
             "prefill_step_ms", "launches_per_tick", "device_ms",
             "idle_share")
# the last serial runs on the same traffic with eager prefill chunks
# (PERF.md section 5, NVIDIA H100 80GB HBM3, 700.00 W): tok/s, TTFT p50
# and max s, median prefill step ms; and their traced eager 256-token
# chunk: wall ms, device busy ms, idle share, host launch calls
EAGER_CHUNK_STREAM = {"serve": (218.8, 1.338, 2.992, 127.89),
                      "spec": (209.0, 0.773, 2.227, 135.94),
                      "paged int8": (192.7, 1.039, 1.991, 150.34),
                      "paged int4": (74.2, 0.331, 0.417, 145.23)}
EAGER_CHUNK = {"serve": (130.31, 34.03, 0.74, 7698),
               "paged int8": (147.82, 39.79, 0.73, 9747)}


def _tick_line(label, what, prof):
    """One traced tick's wall and device time, idle share, launches and
    top kernels, as a line."""
    dev = prof.get("device")
    launches = prof.get("host_launches", {})
    return (f"{label}: {what} ({prof['slots']} slots) wall "
            f"{prof['wall_ms']:.2f} ms, " + (dev if dev else
            f"device busy {prof['device_ms']:.2f} ms (idle share "
            f"{prof['idle_share']:.2f}); {prof['device_kernels']} device "
            f"kernels; host launch calls {launches}; top: " + ", ".join(
                f"{r['kernel'][:40]} {r['ms_per_tick']:.2f} ms "
                f"x{r['per_tick']}" for r in prof["top"][:5])))


def report(label, run, total, n_req):
    out = run["out"]
    ttft = sorted(o.metrics.ttft for o in out.values())
    tpot = sorted(o.metrics.tpot for o in out.values())
    step_ms = {k: statistics.median(v) * 1e3 for k, v in run["steps"].items()
               if v}
    dt, ticks, profile = run["seconds"], run["ticks"], run["profile"]
    res = {"requests": n_req, "tokens": total, "seconds": dt,
           "tok_s": total / dt, "ttft_p50_s": statistics.median(ttft),
           "ttft_max_s": ttft[-1], "tpot_p50_s": statistics.median(tpot),
           "decode_ticks": ticks["decode"],
           "prefill_chunks": ticks["prefill"], "launches": run["counts"],
           "median_step_ms": step_ms, "decode_profile": profile,
           "logits_check": run["check"], "graph_check": run["graph_check"],
           "captures": run["captures"], "overlap": run["overlap"],
           "refreezes": run["refreezes"]}
    mode = "overlapped" if run["overlap"] else "serial"
    say(f"[{label}] stream ({mode} ticks, captured forwards): {n_req} "
        f"requests, {total} tokens in {dt:.2f}s ({total / dt:.1f} tok/s) on "
        f"{SLOTS} slots; tpot p50 {res['tpot_p50_s'] * 1e3:.1f} ms; ttft "
        f"p50 {res['ttft_p50_s'] * 1e3:.0f} ms max {ttft[-1] * 1e3:.0f} ms; "
        f"{ticks['decode']} decode ticks, {ticks['prefill']} prefill chunks;"
        f" graph captures {run['captures']}")
    say(f"{label}: kernel launches (replays included) {run['counts']}; "
        f"median step ms {step_ms}")
    for g in run["graph_check"] or ():
        if "lengths" in g:
            say(f"{label}: prefill graph vs eager: logits and state "
                f"bit-equal for chunks of {g['lengths']} tokens in width "
                f"classes {g['widths']}")
        elif "full_slot" in g:
            say(f"{label}: refreeze graph vs eager: state bit-equal with "
                f"slot {g['full_slot']} full and the others not (those "
                f"unchanged)")
        else:
            say(f"{label}: graph vs eager at Q={g['qn']}: logits and state "
                f"bit-equal over {g['ticks']} ticks x {g['slots']} slots; "
                f"the graph holds {g['held_launches']}")
    now = {"tok_s": res["tok_s"], "tpot_p50_ms": res["tpot_p50_s"] * 1e3,
           "ttft_p50_s": res["ttft_p50_s"],
           "decode_step_ms": step_ms.get("decode"),
           "prefill_step_ms": step_ms.get("prefill")}
    if profile is not None:
        tick = ("decode tick" if profile["panel"] == 1 else
                f"verify tick of {profile['panel']} rows")
        say(_tick_line(label, f"graph {tick}", profile)
            + f"; one replay {profile['replay_event_ms']:.2f} ms (CUDA "
              f"events; idle share with the replay's span counted busy "
              f"{profile['idle_share_replay_span']:.2f}); capture "
              f"{profile['capture_s']:.2f} s")
        say(_tick_line(label, f"eager {tick}", profile["eager"]))
        if "device_ms" in profile:
            now.update(launches_per_tick=sum(
                profile["host_launches"].values()),
                device_ms=profile["device_ms"],
                idle_share=profile["idle_share"])
        pre = profile.get("prefill") or {}
        for what, prof in ((f"graph {tick}", profile),
                           (f"eager {tick}", profile["eager"]),
                           ("graph prefill chunk", pre),
                           ("eager prefill chunk", pre.get("eager"))):
            if prof and "named" in prof:
                say(f"{label}: {what}: " + ", ".join(
                    f"{k} {v['ms_per_tick']:.3f} ms x{v['per_tick']}"
                    for k, v in prof["named"].items()) + " of device time")
            if prof and "host_top" in prof:
                say(f"{label}: {what}: host self time under the profiler: "
                    + ", ".join(f"{r['op'][:32]} {r['ms_per_tick']:.2f} ms "
                                f"x{r['per_tick']}"
                                for r in prof["host_top"][:6]))
        if pre:
            say(_tick_line(label, f"graph prefill chunk of {pre['tokens']} "
                           "tokens", {**pre, "slots": 1})
                + f"; one replay {pre['replay_event_ms']:.2f} ms (CUDA "
                  f"events); capture {pre['capture_s']:.2f} s, graph pool "
                  f"{pre['graph_mib']:.1f} MiB")
            say(_tick_line(label, f"eager prefill chunk of {pre['tokens']} "
                           "tokens", {**pre["eager"], "slots": 1}))
            if label in EAGER_CHUNK:
                was = EAGER_CHUNK[label]
                g = pre if "device_ms" in pre else {}
                say(f"{label}: the 256-token chunk, graph (eager in this "
                    f"run; the last eager-chunk run): wall "
                    f"{pre['wall_ms']:.2f} "
                    f"({pre['eager']['wall_ms']:.2f}; {was[0]}) ms, device "
                    f"busy {_num(g.get('device_ms'))} "
                    f"({_num(pre['eager'].get('device_ms'))}; {was[1]}) ms, "
                    f"idle share {_num(g.get('idle_share'))} "
                    f"({_num(pre['eager'].get('idle_share'))}; {was[2]}), "
                    f"host launch calls "
                    f"{sum(pre.get('host_launches', {}).values())} "
                    f"({sum(pre['eager'].get('host_launches', {}).values())};"
                    f" {was[3]})")
    entries = run["entries"]
    res.update(entries=entries, sync_free=run["sync_free"],
               capture_s=sum(v["capture_s"] for v in entries.values()),
               graph_mib=sum(v["graph_mib"] for v in entries.values()))
    say(f"{label}: captures when the engine was built, before the run "
        f"(host s, graph pool MiB): " + ", ".join(
            f"{k} {v['capture_s']:.2f} s {v['graph_mib']:.1f} MiB"
            for k, v in entries.items())
        + f"; {res['capture_s']:.2f} s and {res['graph_mib']:.1f} MiB in "
          f"all; dispatches under the sync-free guard {run['sync_free']}")
    ref = (profile or {}).get("refreeze")
    if ref:
        share = run["refreezes"] * ref["wall_ms"] / 1e3 / dt
        res["refreeze_share"] = share
        say(f"{label}: refreeze, one slot of {SLOTS} full: graph wall "
            f"{ref['wall_ms']:.2f} ms, device busy "
            f"{_num(ref.get('device_ms'))} ms (idle share "
            f"{_num(ref.get('idle_share'))}), host launch calls "
            f"{sum(ref.get('host_launches', {}).values())}, one replay "
            f"{ref['replay_event_ms']:.2f} ms (CUDA events); eager: wall "
            f"{ref['eager']['wall_ms']:.2f} ms, device busy "
            f"{_num(ref['eager'].get('device_ms'))} ms, host launch calls "
            f"{sum(ref['eager'].get('host_launches', {}).values())}; "
            f"{run['refreezes']} refreezes in the run, at the graph's wall "
            f"time {share:.3f} of it")
    if label in EAGER_CHUNK_STREAM:
        was = dict(zip(("tok_s", "ttft_p50_s", "ttft_max_s",
                        "prefill_step_ms"), EAGER_CHUNK_STREAM[label]))
        res["vs_eager_chunks"] = was
        say(f"{label}: this run beside the last eager-chunk run "
            f"(PERF.md): tok/s "
            f"{res['tok_s']:.1f} ({was['tok_s']}); ttft p50 "
            f"{res['ttft_p50_s']:.3f} ({was['ttft_p50_s']}) s, max "
            f"{res['ttft_max_s']:.3f} ({was['ttft_max_s']}) s; median prefill "
            f"step {_num(step_ms.get('prefill'))} "
            f"({was['prefill_step_ms']}) ms")
    res["vs_eager_ticks"] = {"now": now}
    if label in EAGER_TICKS and not run["overlap"]:
        res["vs_eager_ticks"]["eager"] = dict(zip(EAGER_KEYS,
                                                  EAGER_TICKS[label]))
        say(f"{label}: this run beside the last eager-tick run (PERF.md): "
            + "; ".join(f"{k} {_num(now.get(k))} ({_num(v)})"
                        for k, v in res["vs_eager_ticks"]["eager"].items()))
    return res


def _num(x):
    return "n/a" if x is None else (f"{x:.3f}" if isinstance(x, float)
                                    else str(x))


def overlap_run(torch, label, make_engine, prompts, params_of, serial,
                lead=False):
    """The same traffic through a fresh overlapped engine: greedy tokens
    must equal the serial run's (the seeded request's are reported);
    returns its report."""
    paused = [0.0]
    eng = make_engine(paused)
    run = serve_stream(torch, eng, eng.cfg, prompts, params_of, paused,
                       lead=lead, label=f"{label} overlapped")
    total = sum(len(o.token_ids) for o in run["out"].values())
    same, seeded = 0, []
    for i, (a, b) in enumerate(zip(run["rids"], serial["rids"])):
        got = list(run["out"][a].token_ids)
        want = list(serial["out"][b].token_ids)
        if params_of[i].temperature > 0:
            seeded.append(got == want)
            continue
        if got != want:
            first = next((j for j, (x, y) in enumerate(zip(got, want))
                          if x != y), min(len(got), len(want)))
            fail(f"{label}: overlapped greedy request {i} differs from the "
                 f"serial run at token {first}")
        same += 1
    res = report(f"{label} overlapped", run, total, len(prompts))
    res.update(greedy_identical=same, seeded_identical=seeded)
    say(f"{label}: overlapped vs serial: {same} greedy requests "
        f"token-identical (gated); seeded requests identical {seeded} "
        f"(reported)")
    return res


def unchunked_captures(torch, cfg, params, max_tokens=UNCHUNKED_TOKENS):
    """An unchunked engine (the launcher's default) at ``max_tokens`` a
    slot, its every entry captured by ``warmup``: the prefill chunk's width
    classes (power-of-two block counts up to the slot's), each class's
    capture time and graph pool, and their sums."""
    from repro_torch.serving import ContinuousEngine
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = ContinuousEngine(params, cfg, slots=SLOTS, max_tokens=max_tokens,
                           device="cuda")
    eng.warmup()
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    classes = {k[1]: {"capture_s": e.capture_s,
                      "graph_mib": e.graph_bytes / 2 ** 20}
               for k, e in eng._entries.items()
               if isinstance(k, tuple)}
    want = sorted({eng._width(n) for n in range(1, max_tokens + 1)})
    if sorted(classes) != want or eng.trace_counts()["prefill_chunk"] != \
            len(want):
        fail(f"unchunked engine: width classes {sorted(classes)} captured, "
             f"{want} expected")
    res = {"max_tokens": max_tokens, "bs": eng.pool.bs, "classes": classes,
           "seconds": total_s,
           "chunk_graph_mib": sum(c["graph_mib"] for c in classes.values()),
           "all_graph_mib": sum(e.graph_bytes for e in eng._entries.values())
           / 2 ** 20}
    say(f"unchunked engine at {max_tokens} tokens a slot (bs "
        f"{eng.pool.bs}): {len(classes)} width classes, " + ", ".join(
            f"{w} {c['capture_s']:.2f} s {c['graph_mib']:.1f} MiB"
            for w, c in sorted(classes.items()))
        + f"; chunk graphs {res['chunk_graph_mib']:.1f} MiB, every entry "
          f"{res['all_graph_mib']:.1f} MiB; built and warmed up in "
          f"{total_s:.2f} s")
    del eng
    torch.cuda.empty_cache()
    return res


def serve_phase(torch, cfg):
    """The flat pool with bf16 sparse weights (the first slice's path)."""
    import numpy as np
    from repro_torch.data.pipeline import DataConfig, host_batch
    from repro_torch.serving import SamplingParams

    params = _model(torch, cfg, "bf16")
    lo, hi = PROMPT_RANGE
    paused = [0.0]            # the checks below stop the engine's clock
    eng = _engine(cfg, params, paused, hi + NEW_TOKENS + cfg.kv_tail)
    prompts = host_batch(DataConfig(vocab=cfg.vocab, seq_len=hi,
                                    global_batch=N_REQUESTS), 0)["tokens"]
    rng = np.random.default_rng(0)
    lens = rng.integers(lo, hi + 1, N_REQUESTS)
    params_of = [SamplingParams(max_new_tokens=NEW_TOKENS)] * (N_REQUESTS - 1)
    params_of.append(SamplingParams(temperature=0.8, top_k=50, top_p=0.95,
                                    seed=1234, max_new_tokens=NEW_TOKENS))

    def ready(e):
        # every slot decoding and one has crossed a refreeze: refreeze now
        # so the checked ticks start from fresh tails
        sch = e.scheduler
        slots = sch.decoding_slots()
        if (len(slots) == SLOTS and max(len(sch.active[s].generated)
                                        for s in slots) >= e.pool.tail + 12):
            e._refreeze_tick()
            return True
        return False

    reqs = [prompts[i][:lens[i]] for i in range(N_REQUESTS)]
    run = serve_stream(torch, eng, cfg, reqs, params_of, paused, ready,
                       checks=FLAT_CHECKS, prefill=True,
                       graph_qn=(1, SPEC_K + 1), label="serve")
    check_replays("serve", run, "sparse_decode_attention_fused",
                  cfg.n_layers)
    check_launches("serve", run["counts"],
                   ("sparse_gemv", "sparse_decode_attention_fused",
                    "sparse_matmul", "dense_matmul"),
                   ("sparse_decode_attention_fused_paged",
                    "sparse_matmul_int8", "sparse_matmul_int4",
                    "sparse_decode_attention_partial", "sparse_matmul_f32"))
    total = check_outputs("serve", run, cfg, NEW_TOKENS)
    check_sync_free("serve", run, ("chunk", "refreeze"))
    gate_logits("serve", run["check"])
    res = report("serve", run, total, N_REQUESTS)
    res["prompt_lens"] = [int(x) for x in lens]
    res["overlapped"] = overlap_run(
        torch, "serve", lambda p: _engine(cfg, params, p, hi + NEW_TOKENS
                                          + cfg.kv_tail, overlap=True),
        reqs, params_of, run)
    res["unchunked"] = unchunked_captures(torch, cfg, params)
    prof = run["profile"] or {}
    linears = len(_layer_linears(cfg)) * cfg.n_layers
    held = prof.get("graph_held_launches")
    if held is not None and held.get("sparse_gemv") != linears:
        fail(f"serve: the captured decode tick holds {held} launches; one "
             f"gemv launch per linear ({linears}) expected")
    for what, p in (("graph", prof), ("eager", prof.get("eager") or {})):
        # one gemv call per linear, counted exactly by the wrapper; on the
        # device, no more gemv kernels than calls and no sum_partials.  The
        # trace may drop a kernel record (it did once, 195 of 196 a tick),
        # so a shortfall there is reported, not taken for a missing launch
        calls = p.get("wrapper_launches", {}).get("sparse_gemv")
        if calls != linears:
            fail(f"serve: the {what} decode tick calls the gemv {calls} "
                 f"times; one call per linear ({linears}) expected")
        named = p.get("named")
        if named is None or (what == "graph" and "device_ms" not in p):
            continue
        n_ticks, traced = p["ticks"], named["gemv"]["traced"]
        if not 0 < traced <= linears * n_ticks or \
                named["sum_partials"]["traced"]:
            fail(f"serve: the traced {what} decode ticks hold {traced} gemv "
                 f"and {named['sum_partials']['traced']} sum_partials "
                 f"kernels over {n_ticks} ticks; one gemv kernel per call "
                 f"({linears * n_ticks}) and no second kernel expected")
        p["gemv_records_lost"] = linears * n_ticks - traced
        say(f"serve: the {what} decode tick runs the gemv as one launch per "
            f"linear ({linears} calls; {traced} of {linears * n_ticks} "
            f"kernels in the trace of {n_ticks} ticks), no sum_partials")
    return res, params


def _shared_prompts(cfg, n):
    """``n`` prompts: one shared 512-token system prefix, each with its own
    suffix of 40-200 tokens."""
    import numpy as np
    rng = np.random.default_rng(1)
    shared = rng.integers(0, cfg.vocab, SHARED_PREFIX).tolist()
    lo, hi = SUFFIX_RANGE
    return [shared + rng.integers(0, cfg.vocab,
                                  int(rng.integers(lo, hi + 1))).tolist()
            for _ in range(n)]


def paged_phase(torch, cfg, mode, n_req, new_tokens, kernel):
    """The paged shared-prefix pool with int8 or int4 sparse weights:
    prefix-cache hits and blocks shared by live requests required, every
    kernel of the path launched, decode logits held to the bf16 gates; one
    decode tick (and, for int8, one prefill chunk) traced."""
    from repro_torch.serving import SamplingParams

    params = _model(torch, cfg, mode)
    prompts = _shared_prompts(cfg, n_req)
    paused = [0.0]
    max_tokens = SHARED_PREFIX + SUFFIX_RANGE[1] + new_tokens + cfg.kv_tail
    eng = _engine(cfg, params, paused, max_tokens, paged=True)
    params_of = [SamplingParams(max_new_tokens=new_tokens)] * (n_req - 1)
    params_of.append(SamplingParams(temperature=0.8, top_k=50, top_p=0.95,
                                    seed=1234, max_new_tokens=new_tokens))
    label = f"paged {mode}"
    hits, shared = [], [0]
    admit = eng._admit_paged

    def admit_counting(now):
        req = admit(now)
        if req is not None:
            hits.append(req.prefill_done // eng.pool.bs)
        return req
    eng._admit_paged = admit_counting

    def on_step(e):
        shared[0] = max(shared[0], int(e._alloc._ref.max()))

    def ready(e):
        # every slot decoding (after this tick's refreeze)
        if len(e.scheduler.decoding_slots()) != SLOTS:
            return False
        e._refreeze_tick()
        # the device refcounts mirror the host allocator's
        rc = e.state["refcount"].cpu().numpy()
        if not (rc == e._alloc._ref).all():
            fail(f"{label}: device refcounts disagree with the allocator")
        return True

    run = serve_stream(torch, eng, cfg, prompts, params_of, paused, ready,
                       checks=INT_CHECKS, on_step=on_step, lead=True,
                       prefill=mode == "int8",
                       graph_qn=(1, PAGED_SPEC_K + 1), label=label)
    check_replays(label, run, "sparse_decode_attention_fused_paged",
                  cfg.n_layers)
    check_launches(label, run["counts"],
                   ("dense_matmul", "sparse_decode_attention_fused_paged",
                    kernel),
                   ("sparse_gemv", "sparse_matmul",
                    "sparse_decode_attention_fused",
                    "sparse_decode_attention_partial", "sparse_matmul_f32"))
    total = check_outputs(label, run, cfg, new_tokens)
    if mode == "int8":
        check_sync_free(label, run, ("chunk", "refreeze", "assign"))
    hit_blocks = sum(hits)
    say(f"{label}: prefix-cache hits on {sum(1 for h in hits if h)} of "
        f"{len(hits)} admissions ({hit_blocks} blocks of {eng.pool.bs} "
        f"tokens skipped); largest refcount {shared[0]}; trie "
        f"{len(eng._trie)} blocks, {eng._alloc.free_blocks()}/"
        f"{eng.pool.n_phys} pages reclaimable at the end")
    if hit_blocks <= 0:
        fail(f"{label}: no prefix-cache hit")
    if shared[0] < 2:
        fail(f"{label}: no block was shared by two live requests")
    gate_logits(label, run["check"])
    res = report(label, run, total, n_req)
    res.update(prefix_hit_blocks=hit_blocks, admissions=len(hits),
               max_refcount=shared[0], n_phys=eng.pool.n_phys)
    if mode == "int8":
        res["overlapped"] = overlap_run(
            torch, label, lambda p: _engine(cfg, params, p, max_tokens,
                                            paged=True, overlap=True),
            prompts, params_of, run, lead=True)
    return res, params, prompts, run


def identity_phase(torch, cfg, params, prompts, paged_run):
    """The paged int8 run's requests again on the flat pool (same int8
    weights), first 32 tokens: the greedy requests' tokens must equal the
    paged run's, since only the address of the prefix blocks differs."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import SamplingParams
    paused = [0.0]
    max_tokens = SHARED_PREFIX + SUFFIX_RANGE[1] + IDENTITY_TOKENS + \
        cfg.kv_tail
    eng = _engine(cfg, params, paused, max_tokens)
    n = len(prompts)
    params_of = [SamplingParams(max_new_tokens=IDENTITY_TOKENS)] * (n - 1)
    params_of.append(SamplingParams(temperature=0.8, top_k=50, top_p=0.95,
                                    seed=1234,
                                    max_new_tokens=IDENTITY_TOKENS))
    reset_launch_counts()
    rids = [eng.submit(p, sp) for p, sp in zip(prompts, params_of)]
    out = eng.run()
    torch.cuda.synchronize()
    counts = launch_counts()
    check_captures("flat int8", eng.trace_counts(), eng)
    check_launches("flat int8", counts,
                   ("dense_matmul", "sparse_decode_attention_fused",
                    "sparse_matmul_int8"),
                   ("sparse_decode_attention_fused_paged",))
    same = 0
    for i, (r, pr) in enumerate(zip(rids, paged_run["rids"])):
        flat = list(out[r].token_ids)
        paged = list(paged_run["out"][pr].token_ids[:IDENTITY_TOKENS])
        if i < n - 1 and flat != paged:
            first = next(j for j, (a, b) in enumerate(zip(flat, paged))
                         if a != b)
            fail(f"paged vs flat: greedy request {i} differs at token "
                 f"{first}: {flat[first]} vs {paged[first]}")
        same += flat == paged
    say(f"paged vs flat int8: the {n - 1} greedy requests' first "
        f"{IDENTITY_TOKENS} tokens are identical ({same} of {n} requests "
        f"identical, the seeded one included); flat launches {counts}")
    return {"identical_requests": same, "requests": n,
            "tokens": IDENTITY_TOKENS, "launches": counts}


# ---------------------------------------------------------------------------
# the two-pass decode and speculative decoding
# ---------------------------------------------------------------------------

def two_pass_attention(q, k_sp, v_sp, hkv, sm_scale, k_tail=None,
                       v_tail=None, tail_len=None, prefix_len=None):
    """This script's copy of the pre-fusion decode dispatch (as
    ``tests/test_fused_decode.py`` keeps one): the prefix-only partial
    kernel, the grouped tail partial and the lse merge.  Decode ticks only
    (a ``Q == 1`` panel squeezes)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.sparse_attention import (
        gqa_partial, len_valid, merge_attn, sparse_decode_attention_partial)
    if q.dim() == 4:
        if q.shape[1] != 1:
            fail(f"two-pass dispatch got a {q.shape[1]}-query panel")
        return two_pass_attention(q[:, 0], k_sp, v_sp, hkv, sm_scale, k_tail,
                                  v_tail, tail_len, prefix_len)[:, None]
    b, hq, d = q.shape
    g = hq // hkv
    bs = k_sp.block[0]
    words, sb = k_sp.bitmap.shape[-1], k_sp.bitmap.shape[2]
    qg = q.reshape(b, hkv, g, d)
    n_blocks = ops._n_blocks(b, sb, bs, prefix_len, q.device)
    o, lse = sparse_decode_attention_partial(
        qg, k_sp.bitmap.reshape(b, hkv, sb, words),
        k_sp.values.reshape(b, hkv, sb, k_sp.capacity),
        v_sp.bitmap.reshape(b, hkv, sb, words),
        v_sp.values.reshape(b, hkv, sb, v_sp.capacity), bs, sm_scale,
        n_blocks)
    # an empty prefix gives o = 0 and lse = -1e30 (the kernel's NEG_INF)
    o, lse = o.reshape(b, hq, d), lse.reshape(b, hq)
    if k_tail is not None and k_tail.shape[2] > 0:
        t = k_tail.shape[2]
        valid = len_valid(t, tail_len if tail_len is not None else t, b)
        o2, lse2 = gqa_partial(qg, k_tail, v_tail, sm_scale, valid)
        o2, lse2 = o2.reshape(b, hq, d), lse2.reshape(b, hq)
        empty = ~valid.any(-1)
        lse2 = torch.where(empty[:, None],
                           torch.full((), float("-inf"), device=q.device),
                           lse2)
        lse2 = torch.where(torch.isfinite(lse2), lse2, lse.min() - 60.0)
        o, _ = merge_attn(o, lse, o2, lse2)
    return o.to(q.dtype)


@contextlib.contextmanager
def patched(module, name, fn):
    """Swap one attribute of a package module for this script's run only
    (the package has no such switch)."""
    saved = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, saved)


def two_pass_dispatch():
    from repro_torch.kernels import ops
    return patched(ops, "sparse_decode_attention", two_pass_attention)


@contextlib.contextmanager
def record_margins(eng, margins, routes=None, force=None):
    """Record the top-1 margin (top-1 minus top-2 over the largest |logit|)
    of every token a serial engine samples (decode ticks, verify panels and
    final prefill chunks), keyed ``(request id, position)``.  The decode
    and verify logits are read where the engine's captured forward returns
    them (row ``j`` of a verify panel scores position ``generated + j``;
    rows past the accepted window are overwritten by the next tick's), a
    final chunk's from its width class's static logits after the tick.
    ``routes`` (an MoE): every row's routing, keyed ``(request id, row)``,
    the row being the position of its input token in the request's prompt
    and generated tokens (row ``len(prompt) - 1 + n`` scores token ``n``):
    per layer, the top-k expert ids in the router's order and the router
    logit gap (``_router_gaps``).  ``force`` (a function of a request id
    and a row, returning another engine's ``routes`` entry or None): such
    a row routes to that entry's experts, weighted by its own router
    probabilities at them, and ``routes`` records its own routing."""
    import torch
    from repro_torch.models import moe
    panel_logits = eng._panel_logits
    prefill_tick = eng._prefill_tick
    route = moe.route
    # the rows of the forward under way: (row of x, key), and its layer
    cur = {"keys": (), "layer": 0}

    def rec_route(p, x, k):
        layer, keys = cur["layer"], cur["keys"]
        cur["layer"] += 1
        top_p, top_i = route(p, x, k)
        if not keys:
            return top_p, top_i
        rows = [r for r, _ in keys]
        own = top_i[rows].tolist()
        gaps = _router_gaps(p, x, k)[rows].tolist()
        for (_, key), ids, g in zip(keys, own, gaps):
            routes.setdefault(key, {})[layer] = (tuple(ids), g)
        if force is None:
            return top_p, top_i
        sub = [(r, force(*key)) for r, key in keys]
        sub = [(r, e[layer][0]) for r, e in sub if e and layer in e]
        if not sub:
            return top_p, top_i
        want = top_i.clone()
        want[[r for r, _ in sub]] = torch.tensor(
            [ids for _, ids in sub], dtype=top_i.dtype, device=x.device)
        with moe._exact_f32():
            probs = torch.softmax(x.float() @ p["router"], dim=-1)
        top_p = probs.gather(1, want)
        return top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9), want

    def note(keys, logits):
        logits = logits.float()
        top2 = logits.topk(2, -1).values
        rel = (top2[:, 0] - top2[:, 1]) / logits.abs().amax(-1)
        margins.update(zip(keys, rel.tolist()))

    def rec_panel(name, tokens, mask):
        sch = eng.scheduler
        live = [(s, sch.active[s]) for s in sch.decoding_slots()]
        qn = tokens.shape[-1]
        cur.update(layer=0, keys=[
            (s * qn + j, (r.rid, len(r.prompt) - 1 + len(r.generated) + j))
            for s, r in live for j in range(qn)])
        try:
            logits = panel_logits(name, tokens, mask)
        finally:
            cur["keys"] = ()
        for j in range(qn if live else 0):
            note([(r.rid, len(r.generated) + j) for _, r in live],
                 logits[[s for s, _ in live], j])
        return logits

    def rec_prefill(events):
        sch = eng.scheduler
        req = sch.next_prefill()
        left = 0 if req is None else len(req.prompt) - req.prefill_done
        if req is not None:
            # the chunk the scheduler slices (Scheduler.prefill_chunk)
            take = left if sch.chunk is None else min(sch.chunk, left)
            if take < left:
                take = take // sch.bs * sch.bs
            start = req.prefill_done
            cur.update(layer=0, keys=[(r, (req.rid, start + r))
                                      for r in range(take)])
        try:
            prefill_tick(events)
        finally:
            cur["keys"] = ()
        if req is not None and req.prefill_done != start + take:
            fail("record_margins: the engine sliced another chunk than "
                 "Scheduler.prefill_chunk's")
        if req is not None and (sch.chunk is None or left <= sch.chunk):
            w = eng._width(left)
            note([(req.rid, 0)], eng._entries[("prefill_chunk", w)].out)

    if eng.overlap:
        fail("record_margins reads a serial engine's ticks")
    eng._panel_logits, eng._prefill_tick = rec_panel, rec_prefill
    if routes is not None:
        moe.route = rec_route
    try:
        yield margins
    finally:
        del eng._panel_logits, eng._prefill_tick
        moe.route = route


def first_moves(routes, want, prompt_len):
    """Per request id of ``want`` (an engine's ``record_margins`` routes),
    the first row, in row then layer order, whose top-k experts in
    ``routes`` differ from ``want``'s (as sets), given as the token it
    scores (``row - len(prompt) + 1``: at most 0 in the prompt), with the
    router gap of ``want`` there; the number of decisions compared and
    moved, and the gaps of the moved ones."""
    out = {}
    for (rid, row), layers in sorted(want.items()):
        got = routes.get((rid, row))
        if got is None:
            continue
        o = out.setdefault(rid, {"first": None, "decisions": 0, "moved": 0,
                                 "moved_gaps": []})
        for layer in sorted(layers):
            ids, gap = layers[layer]
            if layer not in got:
                continue
            o["decisions"] += 1
            if sorted(got[layer][0]) != sorted(ids):
                o["moved"] += 1
                o["moved_gaps"].append(gap)
                if o["first"] is None:
                    o["first"] = {"token": row - prompt_len[rid] + 1,
                                  "layer": layer, "gap": gap}
    return out


def gate_identity(label, got, want, want_rids, margins, tie=TIE_MARGIN,
                  moves=None):
    """Greedy token lists of two paths: identical, or the first divergence
    of a request lies where the reference path's top-1 margin is below
    ``tie`` of its largest |logit| (an honest near-tie flip; ``TIE_MARGIN``
    between two f32 paths) or, for an MoE (``moves``: ``first_moves`` of
    the other path's routing against the reference path's), at or after
    a row where the two paths' experts were shown to differ."""
    same, flips = 0, []
    for i, (a, b) in enumerate(zip(got, want)):
        if a == b:
            same += 1
            continue
        j = next((n for n, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        m = margins.get((want_rids[i], j))
        mv = None if moves is None else \
            (moves.get(want_rids[i]) or {}).get("first")
        flips.append({"request": i, "position": j, "margin": m,
                      "first_routing_move": mv})
        say(f"{label}: request {i} first differs at token {j} "
            f"({a[j:j + 1]} vs {b[j:j + 1]}); the reference's top-1 margin "
            f"there is {m} of its largest |logit| (tie below {tie})"
            + ("" if moves is None else
               f"; the two paths' experts first differ at {mv} (token "
               f"scored by the row; at most 0 in the prompt)"))
        if mv is not None and mv["token"] <= j:
            continue
        if m is None or not m < tie:
            fail(f"{label}: request {i} differs at token {j} where the "
                 f"reference's margin {m} is no near-tie"
                 + ("" if moves is None else
                    " and no routing decision before it was shown to "
                    "differ"))
    say(f"{label}: {same} of {len(got)} requests token-identical; "
        f"{len(flips)} divergences at near-ties"
        + ("" if moves is None else " or after a shown routing move"))
    return {"identical": same, "requests": len(got), "divergences": flips}


@contextlib.contextmanager
def panel_rows():
    """Count the attention kernels' launches that a CUDA graph captures, by
    query rows (``Q * G``), for the verify-panel check: each replay of the
    graph runs exactly these launches (the kernels' own counters are
    unchanged).  Applied while the engine is built (and captures)."""
    import torch
    from repro_torch.kernels import ops
    rows = {}

    def counting(name):
        fn = getattr(ops, name)

        def run(q, *a, **k):
            if torch.cuda.is_current_stream_capturing():
                key = (name, q.shape[2])
                rows[key] = rows.get(key, 0) + 1
            return fn(q, *a, **k)
        return run
    names = ("sparse_decode_attention_fused",
             "sparse_decode_attention_fused_paged")
    saved = {n: getattr(ops, n) for n in names}
    for n in names:
        setattr(ops, n, counting(n))
    try:
        yield rows
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)


def device_ms_per_call(torch, fn, n=20):
    """Device time per call of ``fn`` from a ``torch.profiler`` trace (every
    kernel ``fn`` launches; under ``--profile``), or a "not measured"
    reason."""
    if not PROFILE:
        return "not measured: traces run under --profile"
    try:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if "CUDA" in str(e.device_type))
    except Exception as e:
        return f"not measured: {type(e).__name__}: {e}"
    if busy <= 0:
        return "not measured: the trace holds no device time"
    return busy / n / 1e3


def host_ms_per_call(torch, fn, n=50):
    """Host time to enqueue one call of ``fn``: ``n`` calls back to back
    from an idle device, timed on the host clock without a sync."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = (time.perf_counter() - t0) / n
    torch.cuda.synchronize()
    return dt * 1e3


def attention_times(torch, eng, cfg, timer):
    """One layer's decode attention on the live state, fused against the
    two-pass dispatch: CUDA-event time (L2 flushed) and traced device time
    per call."""
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    slots, mask, tokens = _decode_inputs(torch, eng)
    captured = []
    fused = ops.sparse_decode_attention

    def capture(*a, **k):
        if not captured:
            captured.append((a, k))
        return fused(*a, **k)
    with patched(ops, "sparse_decode_attention", capture):
        lm.forward_panel_pooled(eng.params, _clone(eng.state), tokens, mask,
                                cfg, eng.pool.bs)
    a, k = captured[0]
    res = {}
    for name, fn in (("fused", fused), ("two_pass", two_pass_attention)):
        res[name] = {"event_ms": timer(lambda: fn(*a, **k)),
                     "device_ms": device_ms_per_call(
                         torch, lambda: fn(*a, **k))}
    return res


def two_pass_logits(torch, eng, cfg, n_ticks=TWO_PASS_TICKS):
    """Teacher-forced decode ticks from the live state: each tick starts
    both paths from one shared state (the fused path's), and the two-pass
    logits are held to the fused ones within ``TWO_PASS_TOL`` of the
    largest |logit|."""
    from repro_torch.models import lm
    slots, mask, tokens = _decode_inputs(torch, eng)
    st = _clone(eng.state)
    tail_len = eng._tail_len.copy()
    worst = 0.0
    for _ in range(n_ticks):
        _refreeze_copies(eng, (st,), tail_len)
        tail_len[slots] += 1
        alt = _clone(st)
        with two_pass_dispatch():
            lp, _ = lm.forward_panel_pooled(eng.params, alt, tokens, mask,
                                            cfg, eng.pool.bs)
        lk, st = lm.forward_panel_pooled(eng.params, st, tokens, mask, cfg,
                                         eng.pool.bs)
        lk, lp = lk[slots, 0], lp[slots, 0]
        if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
            fail("two-pass: decode logits are not finite")
        worst = max(worst, ((lk - lp).abs().max()
                            / lk.abs().max()).item())
        tokens[slots, 0] = lk.argmax(-1)
    if not worst <= TWO_PASS_TOL:
        fail(f"two-pass: logits differ from the fused path's by {worst:.3e} "
             f"of the largest |logit| (tol {TWO_PASS_TOL})")
    return {"ticks": n_ticks, "slots": len(slots), "rel_err": worst}


def _widened(torch, cfg, params):
    """The served model widened to f32 (sparse weights keep their bf16
    values; activations, cache and dense leaves are f32)."""
    import dataclasses
    return (dataclasses.replace(cfg, compute_dtype="float32",
                                param_dtype="float32"),
            _clone(params, torch.float32))


def two_pass_phase(torch, cfg32, params32, timer):
    """The flat f32 engine decoding through the two-pass dispatch (the
    prefix-partial kernel, the grouped tail partial, the lse merge) against
    the fused f32 engine: logits from one shared state per tick, and greedy
    tokens under the near-tie rule."""
    import numpy as np
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import SamplingParams
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg32.vocab, n).tolist()
               for n in TWO_PASS_LENS]
    sp = SamplingParams(max_new_tokens=TWO_PASS_TOKENS)
    max_tokens = max(TWO_PASS_LENS) + TWO_PASS_TOKENS + cfg32.kv_tail
    eng = _engine(cfg32, params32, [0.0], max_tokens)
    margins, check, times = {}, None, None
    with record_margins(eng, margins):
        rids = [eng.submit(p, sp) for p in prompts]
        while not eng.scheduler.done():
            if check is None and \
                    len(eng.scheduler.decoding_slots()) == SLOTS:
                check = two_pass_logits(torch, eng, cfg32)
                times = attention_times(torch, eng, cfg32, timer)
            eng.step()
    if check is None:
        fail("two-pass: the slots never all decoded together")
    check_captures("two-pass: fused f32", eng.trace_counts(), eng)
    fused = [eng.scheduler.finished[r].generated for r in rids]

    # the two-pass dispatch is patched in before eng2 is built (and captures
    # its entries), so its captured decode forward holds the partial kernel
    # and the merge
    with two_pass_dispatch():
        eng2 = _engine(cfg32, params32, [0.0], max_tokens)
        refreezes = [0]
        refreeze = eng2._refreeze_tick

        def counting_refreeze(*a):
            refreezes[0] += int((eng2._tail_len >= eng2.pool.tail).sum())
            refreeze(*a)
        eng2._refreeze_tick = counting_refreeze
        torch.cuda.synchronize()
        reset_launch_counts()
        rids2 = [eng2.submit(p, sp) for p in prompts]
        eng2.run()
        torch.cuda.synchronize()
        counts = launch_counts()
    check_captures("two-pass", eng2.trace_counts(), eng2)
    check_launches("two-pass", counts,
                   ("sparse_decode_attention_partial", "sparse_gemv",
                    "sparse_matmul_f32", "dense_matmul"),
                   ("sparse_decode_attention_fused",
                    "sparse_decode_attention_fused_paged", "sparse_matmul",
                    "sparse_matmul_int8", "sparse_matmul_int4"))
    if refreezes[0] < 1:
        fail("two-pass: no slot refroze")
    two = [eng2.scheduler.finished[r].generated for r in rids2]
    ident = gate_identity("two-pass vs fused f32", two, fused, rids, margins)
    per_layer = {k: {"event_us": v["event_ms"] * 1e3,
                     "device_us": (v["device_ms"] * 1e3
                                   if isinstance(v["device_ms"], float)
                                   else v["device_ms"])}
                 for k, v in times.items()}
    say(f"two-pass: logits within {check['rel_err']:.2e} of the fused "
        f"path's over {check['ticks']} ticks x {check['slots']} slots (tol "
        f"{TWO_PASS_TOL}); {refreezes[0]} slot refreezes; launches {counts}")
    say(f"two-pass: one layer's decode attention on the live state (4 "
        f"slots, f32): fused {per_layer['fused']}, two-pass (partial kernel "
        f"+ tail + merge) {per_layer['two_pass']} (us)")
    return {"logits": check, "identity": ident, "launches": counts,
            "refreezes": refreezes[0], "attention_per_layer": per_layer,
            "prompt_lens": list(TWO_PASS_LENS), "tokens": TWO_PASS_TOKENS}


def _spec_prompts(cfg):
    import numpy as np
    rng = np.random.default_rng(3)
    motifs = [rng.integers(0, cfg.vocab, MOTIF).tolist() * MOTIF_REPEATS
              for _ in range(N_MOTIF)]
    rand = [rng.integers(0, cfg.vocab, MOTIF * MOTIF_REPEATS).tolist()
            for _ in range(N_RANDOM)]
    return motifs + rand


def _verify_rows(label, rows, name, qg, captures, layers):
    """The captured verify forward, which every verify tick replays,
    launches the attention kernel once per layer with ``Q * G = qg`` query
    rows, and no captured launch has another width."""
    want = {(name, qg): captures * layers}
    if rows != want:
        fail(f"{label}: attention launches by (kernel, Q*G) {rows}, "
             f"expected {want}")


@contextlib.contextmanager
def verify_tick_parts(eng):
    """Host time of each verify tick of ``eng`` and of two of its parts:
    the drafter's proposals and the verify call (the panel forward's
    enqueue, the accept and the rollback).  The rest is the token sync and
    the commits."""
    parts = {"tick": [], "draft": [], "verify": []}
    cur = {}

    def timed(key, fn):
        def run(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                if key in cur:
                    cur[key] += time.perf_counter() - t
        return run

    spec_tick = timed("tick", eng._spec_tick)

    def tick(*a, **k):
        cur.update(tick=0.0, draft=0.0, verify=0.0)
        try:
            return spec_tick(*a, **k)
        finally:
            for key in parts:
                parts[key].append(cur[key])
            cur.clear()

    eng._spec_tick, eng._verify = tick, timed("verify", eng._verify)
    eng.drafter.propose = timed("draft", eng.drafter.propose)
    try:
        yield parts
    finally:
        del eng._spec_tick, eng._verify, eng.drafter.propose


def spec_phase(torch, cfg, params):
    """Flat bf16 with ``SpecConfig(k=4)`` on motif and random traffic,
    timed beside the same traffic without speculation."""
    from repro_torch.serving import SamplingParams
    prompts = _spec_prompts(cfg)
    n = len(prompts)
    params_of = [SamplingParams(max_new_tokens=SPEC_TOKENS)] * n
    max_tokens = MOTIF * MOTIF_REPEATS + SPEC_TOKENS + cfg.kv_tail
    paused0 = [0.0]
    eng0 = _engine(cfg, params, paused0, max_tokens)
    off = serve_stream(torch, eng0, cfg, prompts, params_of, paused0,
                       label="spec off")
    total_off = check_outputs("spec off", off, cfg, SPEC_TOKENS)
    paused = [0.0]
    g = cfg.padded_heads // cfg.n_kv

    def ready(e):
        return len(e.scheduler.decoding_slots()) == SLOTS

    # the engine captures its verify forward when it is built
    with panel_rows() as rows:
        eng = _engine(cfg, params, paused, max_tokens, spec_k=SPEC_K)
    with verify_tick_parts(eng) as parts:
        run = serve_stream(torch, eng, cfg, prompts, params_of, paused,
                           ready, checks=FLAT_CHECKS,
                           check_ticks=SPEC_LOGIT_TICKS, rows=rows,
                           label="spec")
    gate_logits("spec", run["check"])
    verify_ticks = run["ticks"]["decode"]
    _verify_rows("spec", rows, "sparse_decode_attention_fused",
                 (SPEC_K + 1) * g, run["captures"]["verify"], cfg.n_layers)
    check_replays("spec", run, "sparse_decode_attention_fused",
                  cfg.n_layers)
    check_launches("spec", run["counts"],
                   ("sparse_decode_attention_fused", "sparse_matmul",
                    "dense_matmul"),
                   ("sparse_decode_attention_fused_paged",
                    "sparse_matmul_int8", "sparse_matmul_int4",
                    "sparse_decode_attention_partial", "sparse_matmul_f32"))
    total = check_outputs("spec", run, cfg, SPEC_TOKENS)
    hist = eng.spec_hist.tolist()
    if sum(hist[1:]) <= 0:
        fail("spec: no draft was ever accepted")
    per_tick = (sum((i + 1) * h for i, h in enumerate(hist))
                / max(sum(hist), 1))
    res = report("spec", run, total, n)
    res_off = report("spec off", off, total_off, n)
    same = sum(list(run["out"][a].token_ids) == list(off["out"][b].token_ids)
               for a, b in zip(run["rids"], off["rids"]))
    verify_ms = statistics.median(run["steps"]["decode"]) * 1e3
    decode_ms = statistics.median(off["steps"]["decode"]) * 1e3
    say(f"spec: k={SPEC_K}, {verify_ticks} verify ticks ({(SPEC_K + 1) * g} "
        f"query rows per attention launch on each); accepted-draft "
        f"histogram {hist}; {per_tick:.2f} tokens per slot per verify tick; "
        f"median verify tick {verify_ms:.1f} ms against the spec-off decode "
        f"tick {decode_ms:.1f} ms; {res['tok_s']:.1f} tok/s against "
        f"{res_off['tok_s']:.1f} tok/s without speculation; {same} of {n} "
        f"requests bf16-identical to spec off (reported, not gated)")
    host = {key: statistics.median(v) * 1e3 for key, v in parts.items()}
    host["rest"] = statistics.median(
        [t - d - v for t, d, v in zip(parts["tick"], parts["draft"],
                                      parts["verify"])]) * 1e3
    say(f"spec: host time of a verify tick, medians: the tick {host['tick']:.1f} "
        f"ms (of a {verify_ms:.1f} ms step), drafting {host['draft']:.2f} ms, "
        f"the verify call {host['verify']:.1f} ms, the rest (sync, "
        f"commits) {host['rest']:.1f} ms")
    res.update(spec_hist=hist, tokens_per_verify_tick=per_tick,
               verify_tick_host_ms=host,
               verify_tick_ms=verify_ms, spec_off_decode_tick_ms=decode_ms,
               spec_off=res_off, identical_to_spec_off=same,
               attention_rows=(SPEC_K + 1) * g)
    res["overlapped"] = overlap_run(
        torch, "spec", lambda p: _engine(cfg, params, p, max_tokens,
                                         spec_k=SPEC_K, overlap=True),
        prompts, params_of, run)
    return res


def spec_identity_f32(torch, cfg32, params32):
    """Flat f32 speculation at each k of SPEC_F32_K against flat f32 spec
    off on the spec traffic: greedy tokens under the near-tie rule, and
    every attention launch of the spec run at ``(k+1) * G`` query rows (k
    = 8: 18 rows, past the first attention kernel's 16; untimed).
    Returns ``{k: result}``."""
    from repro_torch.serving import SamplingParams
    prompts = _spec_prompts(cfg32)
    sp = SamplingParams(max_new_tokens=SPEC_IDENTITY_TOKENS)
    max_tokens = MOTIF * MOTIF_REPEATS + SPEC_IDENTITY_TOKENS + cfg32.kv_tail
    eng0 = _engine(cfg32, params32, [0.0], max_tokens)
    margins = {}
    with record_margins(eng0, margins):
        rids0 = [eng0.submit(p, sp) for p in prompts]
        eng0.run()
    check_captures("spec f32 off", eng0.trace_counts(), eng0)
    want = [eng0.scheduler.finished[r].generated for r in rids0]
    g = cfg32.padded_heads // cfg32.n_kv
    out = {}
    for k in SPEC_F32_K:
        with panel_rows() as rows:
            eng = _engine(cfg32, params32, [0.0], max_tokens, spec_k=k)
            rids = [eng.submit(p, sp) for p in prompts]
            eng.run()
        name = "sparse_decode_attention_fused"
        check_captures(f"spec f32 k={k}", eng.trace_counts(), eng)
        _verify_rows(f"spec f32 k={k}", rows, name, (k + 1) * g,
                     eng.trace_counts()["verify"], cfg32.n_layers)
        n = eng.replay_counts()["verify"]
        got = [eng.scheduler.finished[r].generated for r in rids]
        res = gate_identity(f"spec f32 k={k} vs spec off", got, want, rids0,
                            margins)
        res.update(spec_hist=eng.spec_hist.tolist(), attention_rows=(k + 1) * g,
                   verify_ticks=n)
        say(f"spec f32 k={k}: {n} verify ticks replaying one captured "
            f"forward at {(k + 1) * g} query rows; accepted-draft histogram "
            f"{res['spec_hist']}")
        out[k] = res
    return out


def spec_paged_phase(torch, cfg, params, prompts):
    """Paged int8 ``k=3`` against paged int8 spec off on the shared-prefix
    prompts (the first submitted alone): greedy tokens under the near-tie
    rule, prefix-cache hits, and every verify tick's paged attention launch
    at ``Q * G = 8`` rows (untimed)."""
    from repro_torch.serving import SamplingParams
    n = len(prompts)
    params_of = [SamplingParams(max_new_tokens=PAGED_SPEC_TOKENS)] * n
    max_tokens = SHARED_PREFIX + SUFFIX_RANGE[1] + PAGED_SPEC_TOKENS + \
        cfg.kv_tail
    eng0 = _engine(cfg, params, [0.0], max_tokens, paged=True)
    margins = {}
    with record_margins(eng0, margins):
        off = serve_stream(torch, eng0, cfg, prompts, params_of, [0.0],
                           lead=True, label="paged spec off")
    with panel_rows() as rows:
        eng = _engine(cfg, params, [0.0], max_tokens, paged=True,
                      spec_k=PAGED_SPEC_K)
    hits = []
    admit = eng._admit_paged

    def admit_counting(now):
        req = admit(now)
        if req is not None:
            hits.append(req.prefill_done // eng.pool.bs)
        return req
    eng._admit_paged = admit_counting
    run = serve_stream(torch, eng, cfg, prompts, params_of, [0.0],
                       lead=True, label="paged spec")
    g = cfg.padded_heads // cfg.n_kv
    _verify_rows("paged spec", rows, "sparse_decode_attention_fused_paged",
                 (PAGED_SPEC_K + 1) * g, run["captures"]["verify"],
                 cfg.n_layers)
    check_replays("paged spec", run, "sparse_decode_attention_fused_paged",
                  cfg.n_layers)
    check_launches("paged spec", run["counts"],
                   ("sparse_decode_attention_fused_paged",
                    "sparse_matmul_int8", "dense_matmul"),
                   ("sparse_decode_attention_fused", "sparse_gemv",
                    "sparse_matmul", "sparse_decode_attention_partial",
                    "sparse_matmul_f32"))
    if sum(hits) <= 0:
        fail("paged spec: no prefix-cache hit")
    got = [list(run["out"][r].token_ids) for r in run["rids"]]
    want = [list(off["out"][r].token_ids) for r in off["rids"]]
    res = gate_identity("paged int8 spec vs spec off", got, want,
                        off["rids"], margins)
    res.update(spec_hist=eng.spec_hist.tolist(), prefix_hit_blocks=sum(hits),
               verify_ticks=run["ticks"]["decode"],
               attention_rows=(PAGED_SPEC_K + 1) * g)
    say(f"paged spec: k={PAGED_SPEC_K}, {run['ticks']['decode']} verify "
        f"ticks at {(PAGED_SPEC_K + 1) * g} query rows; prefix-cache hits "
        f"{sum(hits)} blocks; accepted-draft histogram {res['spec_hist']}")
    res["overlapped"] = overlap_run(
        torch, "paged spec", lambda p: _engine(
            cfg, params, p, max_tokens, paged=True, spec_k=PAGED_SPEC_K,
            overlap=True), prompts, params_of, run, lead=True)
    return res


# ---------------------------------------------------------------------------
# the server path: lifecycle, faults, telemetry and the HTTP frontend
# ---------------------------------------------------------------------------

class _Client:
    """One streaming ``POST /v1/generate`` on a thread of its own (stdlib
    ``http.client``): the NDJSON frames it read, its first frame and its
    end as events."""

    def __init__(self, port, prompt, body):
        import threading
        self.port, self.prompt, self.body = port, prompt, body
        self.frames, self.error = [], None
        self.first, self.done = threading.Event(), threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        import http.client
        try:
            c = http.client.HTTPConnection("127.0.0.1", self.port,
                                           timeout=300)
            c.request("POST", "/v1/generate",
                      json.dumps({"prompt": self.prompt, **self.body}),
                      {"Content-Type": "application/json"})
            r = c.getresponse()
            if r.status != 200:
                self.error = f"HTTP {r.status}: {r.read()[:200]!r}"
                return
            while True:
                line = r.readline()
                if not line:
                    self.error = "the stream ended without a terminal frame"
                    return
                self.frames.append(json.loads(line))
                self.first.set()
                if self.frames[-1]["finished"]:
                    break
            c.close()
        except Exception as e:          # reported by the phase's gates
            self.error = repr(e)
        finally:
            self.first.set()
            self.done.set()

    @property
    def rid(self):
        return self.frames[0]["request_id"] if self.frames else None

    @property
    def tokens(self):
        return [tok for f in self.frames for tok in f["tokens"]]

    @property
    def reason(self):
        return self.frames[-1]["finish_reason"] if self.frames else None

    def streaming(self):
        return bool(self.frames) and not self.frames[-1]["finished"]


def _http(port, method, path, obj=None):
    import http.client
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    c.request(method, path, None if obj is None else json.dumps(obj),
              {"Content-Type": "application/json"})
    r = c.getresponse()
    body = r.read()
    c.close()
    return r.status, json.loads(body)


def _wait(events, what, timeout=300):
    t_end = time.perf_counter() + timeout
    for e in events:
        if not e.wait(max(t_end - time.perf_counter(), 0)):
            fail(f"server: timed out waiting for {what}")


def _prometheus(text):
    """Parse Prometheus text exposition into ``{series: value}``; fails on
    a malformed line."""
    import re
    series = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = re.fullmatch(r'([a-zA-Z_:][a-zA-Z0-9_:]*(?:\{[^}]*\})?) (\S+)',
                         line)
        if m is None:
            fail(f"server: /metrics line {line!r} does not parse")
        series[m.group(1)] = float(m.group(2))
    return series


def _latency(obs):
    """TTFT p50 / max and TPOT p50 (s) from obs's own histograms."""
    reg = obs.registry
    ttft, tpot = reg.histogram("repro_ttft_seconds"), \
        reg.histogram("repro_tpot_seconds")
    return {"ttft_p50_s": ttft.percentile(50),
            "ttft_max_s": ttft.percentile(100),
            "tpot_p50_s": tpot.percentile(50), "ttft_count": ttft.count}


def _server_engine(cfg, params, max_tokens, **kw):
    from repro_torch.serving import ContinuousEngine, SpecConfig
    return ContinuousEngine(params, cfg, slots=SLOTS, max_tokens=max_tokens,
                            prefill_chunk=PREFILL_CHUNK, device="cuda",
                            paged=True, spec=SpecConfig(k=PAGED_SPEC_K),
                            **kw)


def server_traffic(port, prompts):
    """Drive the server: a lead request (it freezes the shared prefix),
    three more to fill the slots, a burst past the queue bound, a client
    cancel; returns the clients in submission order and the cancelled
    one."""
    clients = []

    def send(**body):
        c = _Client(port, prompts[len(clients)],
                    {"max_new_tokens": SERVER_TOKENS, **body})
        clients.append(c)
        return c
    _wait([send().first], "the lead request's first frame")
    long_c = send(max_new_tokens=SERVER_LONG_TOKENS)
    send(deadline_s=SERVER_DEADLINE_S)
    other = send()
    _wait([long_c.first, other.first], "the slots to fill")
    for _ in range(SERVER_BURST):
        send()
    # cancel a request mid-stream through the endpoint (the long one,
    # unless the plan took it first)
    cancelled = None
    for c in [long_c, other] + clients[4:]:
        _wait([c.first], "a frame to cancel after")
        if not c.streaming():
            continue
        status, body = _http(port, "POST", "/v1/cancel",
                             {"request_id": c.rid})
        if status != 200:
            fail(f"server: /v1/cancel answered {status} {body}")
        if body["cancelled"]:
            cancelled = c
            break
    _wait([c.done for c in clients], "the traffic to finish")
    return clients, cancelled


def guarded_tick(torch, eng, prompts):
    """One overlapped tick with obs on, after a cancel between ticks, under
    ``torch.cuda.set_sync_debug_mode("error")``: the cancel's release, the
    admission's lane write, a non-final prefill chunk, the verify dispatch
    and the obs hooks must not wait for the device; only
    ``_sync_inflight``'s one token read is exempt."""
    import numpy as np
    from repro_torch.serving import SamplingParams
    sp = SamplingParams(max_new_tokens=SERVER_TOKENS)
    rids = [eng.submit(p, sp) for p in prompts[:SLOTS]]
    for _ in range(400):
        eng.step()
        if (len(eng.scheduler.decoding_slots()) == SLOTS
                and eng._inflight is not None):
            break
    else:
        fail("guarded tick: the slots never all decoded")
    # a request with no prefix hit, whose first chunk is not its last
    rng = np.random.default_rng(7)
    eng.submit(rng.integers(0, eng.cfg.vocab, 3 * PREFILL_CHUNK).tolist(),
               sp)
    victim = next(r for r in rids if any(q.rid == r for q in
                                         eng.scheduler.active.values()))
    before = eng.replay_counts()
    exempt = [0]
    sync = eng._sync_inflight

    def exempt_sync(events):
        exempt[0] += 1
        torch.cuda.set_sync_debug_mode("default")
        try:
            return sync(events)
        finally:
            torch.cuda.set_sync_debug_mode("error")
    eng._sync_inflight = exempt_sync
    torch.cuda.set_sync_debug_mode("error")
    try:
        if not eng.cancel(victim):
            fail("guarded tick: the cancel found nothing to cancel")
        eng.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
        del eng._sync_inflight
    after = eng.replay_counts()
    moved = {k: after[k] - before.get(k, 0) for k in after}
    for name in ("release", "set_lane", "prefill_chunk", "verify"):
        if moved.get(name, 0) < 1:
            fail(f"guarded tick: no {name} replay ran under the guard "
                 f"({moved})")
    if exempt[0] < 1:
        fail("guarded tick: the token read never ran")
    eng.run()
    say(f"server: guarded tick: a cancel between ticks and one overlapped "
        f"k={PAGED_SPEC_K} tick with obs on ran under "
        f"set_sync_debug_mode('error') (replays {moved}; the token read "
        f"exempt, {exempt[0]} call)")
    return {"replays": moved, "token_reads": exempt[0]}


def server_phase(torch, cfg, params):
    """Full-width Qwen3-0.6B on the paged int8 pool with ``k=3``, overlapped,
    with shedding, degraded mode, telemetry (a metrics port and a trace
    file) and a seeded fault plan, behind ``ServerFrontend`` on
    ``127.0.0.1``; clients are ``http.client`` threads.  Then the same
    requests served serially in-process with no faults (the tokens'
    baseline and the in-process figures), and the guarded tick."""
    import tempfile
    import threading
    import urllib.request
    from repro_torch import kernels
    from repro_torch.obs import MetricsServer, Observability
    from repro_torch.serving import (FaultPlan, SamplingParams,
                                     ServerFrontend, stable_trace_counts)
    from repro_torch.serving.faults import ENGINE_SITES

    tmp = tempfile.TemporaryDirectory()
    trace_path = str(Path(tmp.name) / "trace.json")
    obs = Observability(trace_path=trace_path)
    metrics = MetricsServer(obs.registry, port=0).start()
    plan = FaultPlan.generate(seed=SERVER_FAULT_SEED,
                              ticks=SERVER_FAULT_TICKS)
    prompts = _shared_prompts(cfg, 4 + SERVER_BURST + SERVER_WAVES * SLOTS)
    max_tokens = SHARED_PREFIX + SUFFIX_RANGE[1] + SERVER_LONG_TOKENS + \
        cfg.kv_tail
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = _server_engine(cfg, params, max_tokens, overlap=True,
                         max_queue=SERVER_QUEUE,
                         degrade_queue=SERVER_DEGRADE, faults=plan, obs=obs)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check_captures("server", eng.trace_counts(), eng)
    entries = {"/".join(map(str, k)) if isinstance(k, tuple) else k:
               {"capture_s": e.capture_s, "graph_mib": e.graph_bytes / 2 ** 20}
               for k, e in eng._entries.items()}

    front = ServerFrontend(eng, host="127.0.0.1", port=0)
    up, box = threading.Event(), {}

    def serve():
        try:
            front.run(lambda port: (box.update(port=port), up.set()))
        except BaseException as e:
            box["error"] = e
            up.set()
    server = threading.Thread(target=serve, daemon=True)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    server.start()
    _wait([up], "the server to listen", 60)
    if "error" in box:
        fail(f"server: the frontend failed to start: {box['error']!r}")
    port = box["port"]
    status, health = _http(port, "GET", "/healthz")
    if status != 200 or not health["ok"]:
        fail(f"server: /healthz answered {status} {health}")
    clients, cancelled = server_traffic(port, prompts)
    waves = 0
    while not plan.exhausted() and waves < SERVER_WAVES:
        wave = [_Client(port, prompts[len(clients) + j],
                        {"max_new_tokens": SERVER_TOKENS})
                for j in range(SLOTS)]
        clients += wave
        _wait([c.done for c in wave], "a wave to finish")
        waves += 1
    with urllib.request.urlopen(metrics.url, timeout=60) as resp:
        scraped = _prometheus(resp.read().decode())
    status, body = _http(port, "POST", "/v1/shutdown", {})
    server.join(timeout=300)
    serve_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    if server.is_alive() or not body.get("shutting_down"):
        fail("server: /v1/shutdown did not drain the server")
    if "error" in box or front.loop_thread.error is not None:
        fail(f"server: the engine thread failed: "
             f"{box.get('error') or front.loop_thread.error!r}")
    metrics.close()
    obs.close()

    # every request ended, with a reason, streaming what the engine holds
    allowed = {"length", "stop", "cancelled", "timeout", "shed"}
    for i, c in enumerate(clients):
        if c.error is not None or c.reason not in allowed:
            fail(f"server: request {i} ended {c.reason!r} ({c.error})")
        held = eng.scheduler.finished[c.rid].output()
        if c.tokens != list(held.token_ids) or c.reason != \
                held.finish_reason:
            fail(f"server: request {i} streamed {len(c.tokens)} tokens "
                 f"({c.reason}); the engine holds {len(held.token_ids)} "
                 f"({held.finish_reason})")
    reasons = [c.reason for c in clients]
    tally = {r: reasons.count(r) for r in sorted(set(reasons))}
    fc = dict(eng.fault_counters)
    if cancelled is None or cancelled.reason != "cancelled":
        fail("server: no request was cancelled mid-stream through "
             "/v1/cancel")
    deadline_c = clients[2]
    if deadline_c.reason not in ("timeout", "cancelled") or (
            deadline_c.reason == "cancelled" and deadline_c is cancelled):
        fail(f"server: the {SERVER_DEADLINE_S} s deadline request ended "
             f"{deadline_c.reason!r}")
    if tally.get("shed", 0) < 1 or fc["shed"] != tally["shed"]:
        fail(f"server: {tally.get('shed', 0)} requests shed past the queue "
             f"bound of {SERVER_QUEUE}; the engine counted {fc['shed']}")
    if fc["timeout"] != tally.get("timeout", 0) or \
            fc["cancelled"] != tally.get("cancelled", 0):
        fail(f"server: fault counters {fc} disagree with the finish "
             f"reasons {tally}")
    fired = [site for _, site in plan.fired]
    if not plan.exhausted() or set(fired) != set(ENGINE_SITES):
        fail(f"server: the fault plan fired {plan.fired}; pending "
             f"{plan.pending()}")
    stable = stable_trace_counts(eng.trace_counts())
    if any(v > 1 for v in stable.values()):
        fail(f"server: an entry was captured twice: {eng.trace_counts()}")
    check_captures("server", eng.trace_counts(), eng)
    check_launches("server", counts,
                   ("sparse_matmul_int8", "sparse_decode_attention_fused_paged",
                    "dense_matmul"),
                   ("sparse_gemv", "sparse_matmul",
                    "sparse_decode_attention_fused",
                    "sparse_decode_attention_partial", "sparse_matmul_f32",
                    "sparse_matmul_int4"))
    if int(eng._alloc._ref.sum()) or int(eng.state["refcount"].sum()) or \
            eng._slot_live.any():
        fail("server: refcounts or live slots left after the drain")
    finished = sum(v for k, v in scraped.items()
                   if k.startswith("repro_requests_finished_total"))
    if finished != len(clients):
        fail(f"server: /metrics counts {finished} finished requests; "
             f"{len(clients)} finished")
    events = json.loads(Path(trace_path).read_text())
    fault_events = sorted({e["name"] for e in events
                           if e["name"].startswith("fault:")})
    if fault_events != sorted(f"fault:{s}" for s in ENGINE_SITES):
        fail(f"server: the trace holds fault events {fault_events}")
    lat = _latency(obs)
    tokens = sum(len(c.tokens) for c in clients)
    say(f"server: {len(clients)} requests over HTTP ({SERVER_BURST} in one "
        f"burst, {waves} later waves) in {serve_s:.2f} s, {tokens} tokens; "
        f"finish reasons {tally}; fault counters {fc}; fault plan fired "
        f"{plan.fired}; captures {eng.trace_counts()}; launches {counts}; "
        f"/metrics parsed ({len(scraped)} series, {finished:.0f} "
        f"finished); trace {len(events)} events, {fault_events}")

    # the same requests (all but the shed ones) in-process, serially, with
    # no faults: the tokens' baseline and the in-process figures
    served = [i for i, c in enumerate(clients) if c.reason != "shed"]
    base_obs = Observability()
    base = _server_engine(cfg, params, max_tokens, obs=base_obs)
    margins = {}
    with record_margins(base, margins):
        sp = lambda i: SamplingParams(**{k: v for k, v in clients[i].body
                                         .items() if k != "deadline_s"})
        rids = {served[0]: base.submit(clients[served[0]].prompt,
                                       sp(served[0]))}
        while not any(r.generated for r in base.scheduler.active.values()):
            base.step()
        rids.update({i: base.submit(clients[i].prompt, sp(i))
                     for i in served[1:]})
        base.run()
    untouched = [i for i in served
                 if clients[i].reason == "length" and clients[i] is not
                 cancelled and i != 2]
    got = [clients[i].tokens for i in untouched]
    want = [base.scheduler.finished[rids[i]].generated for i in untouched]
    ident = gate_identity("server vs in-process serial (paged int8 k=3)",
                          got, want, [rids[i] for i in untouched], margins)
    base_lat = _latency(base_obs)
    guard = guarded_tick(torch, eng, prompts)
    if int(eng._alloc._ref.sum()) or int(eng.state["refcount"].sum()):
        fail("guarded tick: refcounts left after the drain")
    cap = {k: entries[k] for k in ("release", "set_lane")}
    say(f"server: TTFT p50 {lat['ttft_p50_s'] * 1e3:.1f} ms, max "
        f"{lat['ttft_max_s'] * 1e3:.1f} ms, TPOT p50 "
        f"{lat['tpot_p50_s'] * 1e3:.2f} ms over HTTP (obs percentiles, "
        f"{lat['ttft_count']} first tokens; open traffic with shedding, "
        f"faults and degraded ticks); in-process serial, the same requests "
        f"submitted at once: TTFT p50 {base_lat['ttft_p50_s'] * 1e3:.1f} "
        f"ms, max {base_lat['ttft_max_s'] * 1e3:.1f} ms, TPOT p50 "
        f"{base_lat['tpot_p50_s'] * 1e3:.2f} ms")
    say(f"server: the engine built and captured every entry in "
        f"{build_s:.2f} s: " + ", ".join(
            f"{k} {v['capture_s']:.3f} s {v['graph_mib']:.1f} MiB"
            for k, v in entries.items())
        + f"; {sum(v['graph_mib'] for v in entries.values()):.1f} MiB of "
          f"graph pools in all")
    tmp.cleanup()
    return {"requests": len(clients), "seconds": serve_s, "tokens": tokens,
            "finish_reasons": tally, "fault_counters": fc,
            "fault_plan_fired": plan.fired, "waves": waves,
            "captures": eng.trace_counts(), "launches": counts,
            "latency": lat, "in_process_serial": base_lat,
            "identity": ident, "entries": entries, "build_s": build_s,
            "release_set_lane_captures": cap, "metrics_series": len(scraped),
            "trace_events": len(events), "guarded_tick": guard}


# ---------------------------------------------------------------------------
# warm restart, the sanitized pool and the one-shot engine
# ---------------------------------------------------------------------------

def _followup_prompts(cfg, n):
    """``n`` new prompts on the shared-prefix phases' 512-token prefix, with
    suffixes drawn from another seed."""
    import numpy as np
    shared = _shared_prompts(cfg, 1)[0][:SHARED_PREFIX]
    rng = np.random.default_rng(2)
    lo, hi = SUFFIX_RANGE
    return [shared + rng.integers(0, cfg.vocab,
                                  int(rng.integers(lo, hi + 1))).tolist()
            for _ in range(n)]


def _serve_wave(torch, eng, prompts, n_tokens):
    """Greedy requests through a paged engine to the end; returns their
    token lists and the prefix blocks each admission skipped."""
    from repro_torch.serving import SamplingParams
    hits = []
    admit = eng._admit_paged

    def counting(now):
        req = admit(now)
        if req is not None:
            hits.append(req.prefill_done // eng.pool.bs)
        return req
    eng._admit_paged = counting
    try:
        sp = SamplingParams(max_new_tokens=n_tokens)
        rids = [eng.submit(p, sp) for p in prompts]
        out = eng.run()
        torch.cuda.synchronize()
    finally:
        del eng._admit_paged
    return [list(out[r].token_ids) for r in rids], hits


def _first_diff(a, b):
    return next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


def snapshot_phase(torch, cfg, params):
    """The warm restart on the paged int8 pool: engine A serves a wave on
    the shared prefix, saves a snapshot, then serves a follow-up wave of new
    requests on the same prefix; a fresh engine B (every entry captured
    when built) loads the snapshot and serves the follow-up wave.  Gates:
    the pages restored, B's device refcounts and tables zero after the load,
    its arena tensors where they were and one capture per entry, a prefix
    hit on every follow-up admission, B's greedy tokens identical to A's; a
    truncated snapshot raises a readable ValueError and leaves a fresh
    engine cold and serving."""
    import tempfile
    from repro_torch import kernels
    from repro_torch.serving import corrupt_snapshot
    label = "snapshot"
    wave = _shared_prompts(cfg, SLOTS)
    follow = _followup_prompts(cfg, SLOTS)
    max_tokens = SHARED_PREFIX + SUFFIX_RANGE[1] + SNAP_TOKENS + cfg.kv_tail
    paused = [0.0]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    a = _engine(cfg, params, paused, max_tokens, paged=True)
    _serve_wave(torch, a, wave, SNAP_TOKENS)
    pages = len(a._trie)
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step = a.save_snapshot(tmp)
        save_s = time.perf_counter() - t0
        npz = Path(tmp) / f"step_{step:010d}" / "arrays.npz"
        n_bytes = npz.stat().st_size
        want, hits_a = _serve_wave(torch, a, follow, SNAP_TOKENS)
        n_phys = a.pool.n_phys
        del a
        torch.cuda.empty_cache()
        b = _engine(cfg, params, paused, max_tokens, paged=True)
        ptrs = [t.data_ptr() for d in b.pool.arena_leaves(b.state).values()
                for t in d.values()]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored = b.load_snapshot(tmp)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        if restored != pages or len(b._trie) != pages:
            fail(f"{label}: restored {restored} pages (trie "
                 f"{len(b._trie)}); A's trie held {pages}")
        if int(b.state["refcount"].abs().sum()) or \
                int(b.state["table"].abs().sum()):
            fail(f"{label}: device refcounts or tables not zero after the "
                 "load")
        if [t.data_ptr() for d in b.pool.arena_leaves(b.state).values()
                for t in d.values()] != ptrs:
            fail(f"{label}: the load replaced an arena tensor")
        check_captures(label, b.trace_counts(), b)
        got, hits_b = _serve_wave(torch, b, follow, SNAP_TOKENS)
        counts = kernels.launch_counts()
        check_captures(label, b.trace_counts(), b)
        if min(hits_b) <= 0:
            fail(f"{label}: a follow-up admission skipped no prefix block "
                 f"({hits_b})")
        for i, (x, y) in enumerate(zip(got, want)):
            if x != y:
                fail(f"{label}: follow-up request {i} differs from the "
                     f"never-restarted engine at token {_first_diff(x, y)}")
        del b
        torch.cuda.empty_cache()
        corrupt_snapshot(tmp, mode="truncate")
        c = _engine(cfg, params, paused, max_tokens, paged=True)
        try:
            c.load_snapshot(tmp)
        except ValueError as e:
            err = str(e)
        else:
            fail(f"{label}: a truncated snapshot loaded")
        if "corrupt" not in err or len(c._trie) or \
                c._alloc.free_blocks() != c.pool.n_phys:
            fail(f"{label}: the truncated snapshot's error ({err[:80]}) or "
                 "the engine's state after it is wrong")
        cold, cold_hits = _serve_wave(torch, c, follow[:1], SNAP_TOKENS)
        if len(cold[0]) != SNAP_TOKENS or cold_hits != [0]:
            fail(f"{label}: the cold engine served {len(cold[0])} tokens "
                 f"with {cold_hits} prefix blocks skipped")
        del c
        torch.cuda.empty_cache()
    check_launches(label, counts,
                   ("dense_matmul", "sparse_decode_attention_fused_paged",
                    "sparse_matmul_int8"),
                   ("sparse_gemv", "sparse_matmul",
                    "sparse_decode_attention_fused",
                    "sparse_decode_attention_partial", "sparse_matmul_f32"))
    res = {"pages": pages, "n_phys": n_phys, "bytes": n_bytes,
           "bytes_per_phys_block": n_bytes / n_phys, "save_s": save_s,
           "load_s": load_s, "hits_a": hits_a, "hits_b": hits_b,
           "identical_requests": len(got), "tokens": SNAP_TOKENS,
           "cold_error": err[:200], "cold_identical": cold[0] == want[0],
           "launches": counts}
    say(f"{label}: A froze {pages} prefix pages; snapshot step {step}: "
        f"{n_bytes / 1e6:.1f} MB for the {n_phys}-block arena "
        f"({n_bytes / n_phys / 1e6:.2f} MB a block), saved in {save_s:.3f} s "
        f"and loaded into a fresh engine in {load_s:.3f} s; the load kept "
        f"the arena tensors, zero refcounts and one capture per entry; the "
        f"{len(got)} follow-up requests skipped {hits_b} blocks and are "
        f"token-identical to the never-restarted engine ({SNAP_TOKENS} "
        f"tokens); a truncated snapshot: '{err[:60]}...', the cold engine "
        f"served (its first request identical to A's: {cold[0] == want[0]});"
        f" launches {counts}")
    return res


def guarded_decode_tick(torch, eng, prompts):
    """One overlapped decode tick under ``set_sync_debug_mode("error")``
    (the token read, which carries the error word, exempt)."""
    from repro_torch.serving import SamplingParams
    sp = SamplingParams(max_new_tokens=CHECK_TOKENS)
    for p in prompts[:SLOTS]:
        eng.submit(p, sp)
    for _ in range(400):
        eng.step()
        if (len(eng.scheduler.decoding_slots()) == SLOTS
                and eng._inflight is not None):
            break
    else:
        fail("checkify: the slots never all decoded")
    before = eng.replay_counts().get("decode", 0)
    exempt = [0]
    sync = eng._sync_inflight

    def exempt_sync(events):
        exempt[0] += 1
        torch.cuda.set_sync_debug_mode("default")
        try:
            return sync(events)
        finally:
            torch.cuda.set_sync_debug_mode("error")
    eng._sync_inflight = exempt_sync
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
        del eng._sync_inflight
    if eng.replay_counts()["decode"] - before != 1 or exempt[0] != 1:
        fail("checkify: the guarded tick ran no decode replay or no token "
             "read")
    eng.run()


def planted_violation(torch, eng, prompts):
    """Zero the device refcounts of a live slot's pages and cancel its
    request: the release underflows on the device, and a token read within
    the next ticks must raise naming the check."""
    from repro_torch.serving import SamplingParams
    from repro_torch.serving.cache_pool import PoolCheckError
    sp = SamplingParams(max_new_tokens=CHECK_TOKENS)
    for p in prompts[:2]:
        eng.submit(p, sp)
    for _ in range(400):
        eng.step()
        if len(eng.scheduler.decoding_slots()) == 2:
            break
    else:
        fail("checkify: the planted run never decoded")
    victim = next(iter(eng.scheduler.active.values()))
    ids = eng._blocks[victim.slot]
    eng.state["refcount"][torch.tensor(ids, device="cuda")] = 0
    eng.cancel(victim.rid)
    ticks = 0
    try:
        for ticks in range(1, 5):
            eng.step()
    except PoolCheckError as e:
        msg = str(e)
    else:
        fail("checkify: a device double free raised nothing at the token "
             "reads")
    if "release: refcount underflow" not in msg:
        fail(f"checkify: the planted violation raised {msg!r}")
    return {"message": msg, "raised_at_tick": ticks, "pages_zeroed": len(ids)}


def checkify_phase(torch, cfg, params, prompts, paged_run=None):
    """The sanitized paged int8 pool, overlapped, on the shared-prefix
    requests: the same traffic through an unchecked and a checked engine
    (every chunk, refreeze and assignment through a captured entry under the
    sync-free guard, one capture per entry); greedy tokens identical to the
    unchecked engine's and to the paged int8 run's first tokens; one
    overlapped decode tick under ``set_sync_debug_mode("error")``; the
    decode graph's replay time with and without the checks; a planted
    device double free raising at the next token read."""
    from repro_torch.serving import ContinuousEngine, SamplingParams
    label = "checkify"
    max_tokens = SHARED_PREFIX + SUFFIX_RANGE[1] + CHECK_TOKENS + cfg.kv_tail
    params_of = [SamplingParams(max_new_tokens=CHECK_TOKENS)] * len(prompts)
    runs, engines = {}, {}
    for chk in (False, True):
        paused = [0.0]
        eng = ContinuousEngine(
            params, cfg, slots=SLOTS, max_tokens=max_tokens,
            prefill_chunk=PREFILL_CHUNK, device="cuda", paged=True,
            checkify=chk, overlap=True,
            clock=lambda p=paused: time.perf_counter() - p[0])
        if eng.pool.checkify != chk:
            fail(f"{label}: the pool's checkify flag is "
                 f"{eng.pool.checkify}")
        name = "checked" if chk else "unchecked"
        runs[name] = serve_stream(torch, eng, cfg, prompts, params_of,
                                  paused, lead=True, label=f"{label} {name}")
        check_sync_free(f"{label} {name}", runs[name],
                        ("chunk", "refreeze", "assign"))
        check_outputs(f"{label} {name}", runs[name], cfg, CHECK_TOKENS)
        engines[name] = eng
    chk_eng = engines["checked"]
    if chk_eng.state["err"].tolist() != [0]:
        fail(f"{label}: the clean run set error bits "
             f"{chk_eng.state['err'].tolist()}")
    check_launches(label, runs["checked"]["counts"],
                   ("dense_matmul", "sparse_decode_attention_fused_paged",
                    "sparse_matmul_int8"),
                   ("sparse_gemv", "sparse_matmul",
                    "sparse_decode_attention_fused",
                    "sparse_decode_attention_partial", "sparse_matmul_f32"))
    toks = {n: [list(r["out"][i].token_ids) for i in r["rids"]]
            for n, r in runs.items()}
    for i, (x, y) in enumerate(zip(toks["checked"], toks["unchecked"])):
        if x != y:
            fail(f"{label}: request {i} differs from the unchecked engine at "
                 f"token {_first_diff(x, y)}")
    vs_paged = None
    if paged_run is not None:
        # the paged run's last request was seeded; its greedy ones gate
        vs_paged = 0
        for i, (x, r) in enumerate(zip(toks["checked"][:-1],
                                       paged_run["rids"][:-1])):
            y = list(paged_run["out"][r].token_ids[:CHECK_TOKENS])
            if x != y:
                fail(f"{label}: request {i} differs from the paged int8 "
                     f"run at token {_first_diff(x, y)}")
            vs_paged += 1
    guarded_decode_tick(torch, chk_eng, prompts)
    # the decode graph with and without the checks, all slots masked (a
    # replay then writes nothing), in turns
    times = {"unchecked": [], "checked": []}
    for name in ("unchecked", "checked", "checked", "unchecked"):
        fwd = engines[name]._entries["decode"]
        fwd.set(mask=[False] * SLOTS)
        times[name].append(_replay_ms(torch, fwd.run, CHECK_REPLAYS))
    replay_ms = {n: statistics.median(v) for n, v in times.items()}
    del engines["unchecked"]
    torch.cuda.empty_cache()
    planted = planted_violation(torch, chk_eng, prompts)
    step_ms = {n: statistics.median(r["steps"]["decode"]) * 1e3
               for n, r in runs.items()}
    tok_s = {n: sum(len(t) for t in toks[n]) / r["seconds"]
             for n, r in runs.items()}
    res = {"step_ms": step_ms, "tok_s": tok_s, "replay_ms": replay_ms,
           "replays": CHECK_REPLAYS, "identical_requests": len(toks["checked"]),
           "identical_to_paged_run": vs_paged, "planted": planted,
           "captures": runs["checked"]["captures"],
           "sync_free": runs["checked"]["sync_free"],
           "launches": runs["checked"]["counts"]}
    say(f"{label}: {len(prompts)} requests x {CHECK_TOKENS} tokens "
        f"overlapped: checked tokens identical to the unchecked engine's "
        f"(and the paged int8 run's first {CHECK_TOKENS}: {vs_paged} greedy "
        f"requests); median decode step {step_ms['checked']:.2f} ms checked "
        f"vs {step_ms['unchecked']:.2f} ms unchecked; tok/s "
        f"{tok_s['checked']:.1f} vs {tok_s['unchecked']:.1f}; decode graph "
        f"replay {replay_ms['checked']:.3f} vs {replay_ms['unchecked']:.3f} "
        f"ms (CUDA events, {CHECK_REPLAYS} replays each, in turns unchecked, "
        f"checked, checked, unchecked, all slots masked); "
        f"captures {runs['checked']['captures']}; sync-free "
        f"{runs['checked']['sync_free']} and one guarded overlapped tick; "
        f"the planted double free raised at tick {planted['raised_at_tick']}"
        f": {planted['message']!r}")
    return res


@contextlib.contextmanager
def _timed_calls(torch, module, name, times):
    """Time every call of ``module.name`` (a module's function or an
    object's method; host clock between two syncs)."""
    fn = getattr(module, name)

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out
    with patched(module, name, timed):
        yield


def _range_err(got, ref):
    """max |got - ref| over the plain logits' range."""
    ref = ref.float()
    return ((got.float() - ref).abs().max()
            / (ref.max() - ref.min())).item()


def _dense_weights(torch, cfg, batch):
    """The baseline of ``launch.serve --one-shot --dense``: dense bf16
    weights (each layer's linears stored column-major by the engine, so
    the dense kernel reads them as rows in place) and the dense KV cache.
    One prefill and one decode tick through the kernels, their logits
    within 5e-2 of the range of the same calls through the plain versions,
    and every linear through the dense kernel: one launch per
    ``launch_rows(K)`` rows."""
    from repro_torch import kernels
    from repro_torch.kernels.dense_matmul import launch_rows
    from repro_torch.models import lm
    from repro_torch.serving import Engine
    eng = Engine(lm.init_params(cfg, seed=0, device="cuda"), cfg,
                 kv_mode="dense", device="cuda")
    kernels.reset_launch_counts()
    cache, lk = eng.prefill(batch)
    counts = kernels.launch_counts()
    with plain_kernels():
        cache_p, lp = eng.prefill(batch)
    errs = [_range_err(lk, lp)]
    tok = lp.argmax(-1)[:, None]
    dk, _ = lm.forward_decode(eng.params, cache, tok, cfg)
    with plain_kernels():
        dp, _ = lm.forward_decode(eng.params, cache_p, tok, cfg)
    errs.append(_range_err(dk, dp))
    # one launch per launch_rows(K) rows: 64 at K = 1024, fewer for wo and
    # w_down, whose x rows would not fit shared memory whole
    want = cfg.n_layers * sum(-(-ONESHOT_M // launch_rows(k))
                              for _, k, _ in _layer_linears(cfg)) + 1
    if counts["dense_matmul"] != want or sum(counts.values()) != want:
        fail(f"one_shot dense weights: launches {counts}; {want} dense "
             "kernel launches and no other expected")
    if not max(errs) <= ONESHOT_TOL["bf16"]:
        fail(f"one_shot dense weights: logits through the kernels differ "
             f"from the plain versions by {max(errs):.3e} of the range")
    del eng, cache, cache_p
    torch.cuda.empty_cache()
    say(f"one_shot dense weights and KV: the prefill ran {want} dense "
        f"kernel launches (every linear at M = {ONESHOT_M}, 64, 32 or 16 "
        f"rows a launch by K, and the unembedding); prefill and one decode "
        f"tick's logits {max(errs):.2e} of the range from the plain "
        f"versions")
    return {"launches": counts, "logits_rel_range": max(errs)}


def _oneshot_against_plain(torch, label, eng, params, cfg, batch, sp, got,
                           dtype="bf16", held=None, top1=None, gated=True):
    """The one-shot engine ``eng`` against the plain versions: the first
    ONESHOT_LOGIT_TICKS decode ticks, teacher-forced from one prefill, on
    copies of the same cache (the prefill's logits too), within
    ``ONESHOT_TOL[dtype]`` of the plain range; and its greedy tokens
    ``got`` equal to an all-plain engine's but where that engine's top-1
    margin is a near-tie (below ``TOP1_CLEAR`` of its largest |logit| in
    bf16, the logits gates' rounding-noise bar; ``TIE_MARGIN`` in f32).
    With ``held`` (a dict, filled in), every kernel launch of the kernel
    forwards is also held to its plain version on the same live inputs
    (``HELD_TOL``).  With ``top1`` (a dict, filled in), the rows whose plain
    top-1 margin clears that near-tie bar are counted with the kernels'
    top-1 agreement on them.  ``gated=False`` reports the logits and skips
    the all-plain engine (identity ``None``).  Returns the logit errors
    and the identity result."""
    import copy
    from repro_torch.models import lm
    from repro_torch.serving import Engine
    tol = ONESHOT_TOL[dtype]
    tie = TOP1_CLEAR if dtype == "bf16" else TIE_MARGIN
    pairs = []

    def kernels_on():
        if held is None:
            return contextlib.nullcontext()
        return plain_kernels(keep=tuple(HELD_TOL), held=held, tol=HELD_TOL)
    with kernels_on():
        cache_k, logits = eng.prefill(batch)
    cache_p = copy.deepcopy(cache_k)
    with plain_kernels():
        _, logits_p = eng.prefill(batch)
    pairs.append((logits.float(), logits_p.float()))
    tok = logits_p.argmax(-1)
    for _ in range(ONESHOT_LOGIT_TICKS):
        with kernels_on():
            lk, cache_k = lm.forward_decode(eng.params, cache_k,
                                            tok[:, None], cfg)
        with plain_kernels():
            lp, cache_p = lm.forward_decode(eng.params, cache_p,
                                            tok[:, None], cfg)
        pairs.append((lk.float(), lp.float()))
        tok = lp.argmax(-1)
    del cache_k, cache_p
    errs = [_range_err(lk, lp) for lk, lp in pairs]
    if gated and not max(errs) <= tol:
        fail(f"{label}: decode logits through the kernels differ from the "
             f"plain versions by {max(errs):.3e} of the range (tolerance "
             f"{tol})")
    if top1 is not None:
        top1.update(clear=0, agree=0, tie=tie)
        for lk, lp in pairs:
            top2 = lp.topk(2, -1).values
            clear = (top2[:, 0] - top2[:, 1]) >= tie * lp.abs().amax(-1)
            same = lk.argmax(-1) == lp.argmax(-1)
            top1["clear"] += int(clear.sum())
            top1["agree"] += int((clear & same).sum())
    if not gated:
        return errs, None
    # greedy tokens against the all-plain engine, near-ties excused
    margins = {}

    def note(step, logits):
        top2 = logits.float().topk(2, -1).values
        rel = (top2[:, 0] - top2[:, 1]) / logits.float().abs().amax(-1)
        margins.update(((b, step), m) for b, m in enumerate(rel.tolist()))
    plain_eng = Engine(params, cfg, device="cuda")
    prefill, decode = plain_eng.prefill, lm.forward_decode

    def prefill_noted(b):
        c, lg = prefill(b)
        note(0, lg)
        return c, lg

    n_dec = [0]

    def decode_noted(*a, **k):
        lg, c = decode(*a, **k)
        n_dec[0] += 1
        note(n_dec[0], lg)
        return lg, c
    plain_eng.prefill = prefill_noted
    with plain_kernels(), patched(lm, "forward_decode", decode_noted):
        ref, _ = plain_eng.generate(batch, sp)
    ident = gate_identity(label, got.tolist(), ref.cpu().tolist(),
                          list(range(got.shape[0])), margins, tie=tie)
    del plain_eng
    return errs, ident


def _oneshot_generate(torch, label, eng, cfg, batch, sp, want=None):
    """One eager ``generate`` through the one-shot engine, every counter
    zeroed before and read after, each decode step and the prefill timed
    (a sync after each).  Gates the launches exactly (``want``, by
    default: the prefill's linears once at M = B * S, the decode's once a
    step, the attention once a layer a step, the unembedding once a step)
    and the tokens' shape and range.  Returns the host tokens, the cache,
    the counts, the seconds and the median step ms."""
    from repro_torch import kernels
    from repro_torch.models import lm
    steps = {"decode": [], "prefill": []}
    with _timed_calls(torch, lm, "forward_decode", steps["decode"]), \
            _timed_calls(torch, eng, "prefill", steps["prefill"]):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        got, cache = eng.generate(batch, sp)
        got = got.cpu()
        dt = time.perf_counter() - t0
        counts = kernels.launch_counts()
    n = sp.max_new_tokens
    if want is None:
        linears = len(_layer_linears(cfg)) * cfg.n_layers
        want = {"sparse_matmul": linears, "sparse_gemv": linears * (n - 1),
                "sparse_decode_attention_fused": cfg.n_layers * (n - 1),
                "dense_matmul": n}
    check_launches(label, counts, tuple(k for k, v in want.items() if v),
                   tuple(k for k in counts if not want.get(k)))
    if any(counts[k] != c for k, c in want.items()):
        fail(f"{label}: launches {counts}; {want} expected (the prefill's "
             "linears once at M = B * S, the decode's once a step, the "
             "attention once a layer a step, the unembedding once a step)")
    b = len(batch["tokens"])
    if got.shape != (b, n) or int(got.min()) < 0 or \
            int(got.max()) >= cfg.vocab:
        fail(f"{label}: tokens of shape {tuple(got.shape)} or out of range")
    step_ms = {k: statistics.median(v) * 1e3 for k, v in steps.items()}
    return got, cache, counts, dt, step_ms


def oneshot_phase(torch, cfg, params, cfg32, params32):
    """The legacy one-shot ``Engine`` on bf16 sparse weights: ``ONESHOT_BATCH``
    prompts of ``ONESHOT_PROMPT`` tokens, ``ONESHOT_TOKENS`` new tokens,
    eager.  Gates: the gemv, fused attention, sparse matmul and unembedding
    counters at exactly one launch per linear, layer and row block; a
    refreeze grew the prefix to 5 blocks; the first decode ticks' logits
    through the kernels within 5e-2 of the plain range of the same ticks
    through the plain versions; greedy tokens equal to the all-plain
    engine's but where its top-1 margin is a bf16 near-tie (below
    ``TOP1_CLEAR``, the logits gates' rounding-noise bar); at f32 with KV
    sparsity 0 the sparse-KV and dense-KV engines' logits within 1e-3 of
    the range."""
    import dataclasses
    from repro_torch.data.pipeline import DataConfig, host_batch
    from repro_torch.models import lm
    from repro_torch.serving import Engine, SamplingParams
    label = "one_shot"
    toks = host_batch(DataConfig(vocab=cfg.vocab, seq_len=ONESHOT_PROMPT,
                                 global_batch=ONESHOT_BATCH), 0)["tokens"]
    batch = {"tokens": toks}
    sp = SamplingParams(max_new_tokens=ONESHOT_TOKENS)
    eng = Engine(params, cfg, device="cuda")
    got, cache, counts, dt, step_ms = _oneshot_generate(torch, label, eng,
                                                         cfg, batch, sp)
    decodes = ONESHOT_TOKENS - 1
    sb = cache["layers"]["l0"]["kv"].k_sp.bitmap.shape[3]
    if sb != ONESHOT_PROMPT // 128 + 1:
        fail(f"{label}: the prefix holds {sb} blocks after {decodes} decode "
             "steps; one refreeze to 5 expected")
    del cache
    errs, ident = _oneshot_against_plain(torch, label, eng, params, cfg,
                                         batch, sp, got)
    # f32, KV sparsity 0: the sparse-KV and dense-KV engines
    c0 = dataclasses.replace(cfg32, kv_k_sparsity=0.0, kv_v_sparsity=0.0)
    caches, lgs = {}, {}
    for mode in ("sparse", "dense"):
        e = Engine(params32, c0, kv_mode=mode, device="cuda")
        caches[mode], lgs[mode] = e.prefill(batch)
        p32 = e.params
    f32_errs = [_range_err(lgs["sparse"], lgs["dense"])]
    tok = lgs["dense"].argmax(-1)
    for _ in range(ONESHOT_F32_TICKS):
        l_s, _ = lm.forward_decode(p32, caches["sparse"], tok[:, None], c0)
        l_d, _ = lm.forward_decode(p32, caches["dense"], tok[:, None], c0)
        f32_errs.append(_range_err(l_s, l_d))
        tok = l_d.argmax(-1)
    del caches, e
    torch.cuda.empty_cache()
    if not max(f32_errs) <= ONESHOT_TOL["f32"]:
        fail(f"{label}: f32 sparse-KV and dense-KV logits differ by "
             f"{max(f32_errs):.3e} of the range")
    dense = _dense_weights(torch, cfg, batch)
    res = {"batch": ONESHOT_BATCH, "prompt": ONESHOT_PROMPT,
           "tokens": ONESHOT_TOKENS, "seconds": dt,
           "tok_s": ONESHOT_BATCH * ONESHOT_TOKENS / dt,
           "median_step_ms": step_ms, "launches": counts,
           "logits_rel_range": max(errs), "identity": ident,
           "f32_sparse_vs_dense": max(f32_errs), "prefix_blocks": sb,
           "dense_weights": dense}
    say(f"{label}: {ONESHOT_BATCH} x {ONESHOT_PROMPT}-token prompts, "
        f"{ONESHOT_TOKENS} new tokens in {dt:.2f} s ({res['tok_s']:.1f} "
        f"tok/s, eager, a sync after each step for its time); median decode "
        f"step {step_ms['decode']:.2f} ms, prefill {step_ms['prefill']:.2f} "
        f"ms; launches {counts}; prefix {ONESHOT_PROMPT // 128} -> {sb} "
        f"blocks; logits kernels vs plain over {ONESHOT_LOGIT_TICKS} ticks "
        f"{max(errs):.2e} of the range (tol {ONESHOT_TOL['bf16']}); f32 "
        f"sparse-KV vs dense-KV over the prefill and {ONESHOT_F32_TICKS} "
        f"ticks {max(f32_errs):.2e} (tol {ONESHOT_TOL['f32']})")
    return res


# ---------------------------------------------------------------------------
# the other dense configs and the VLM (the thirteenth slice)
# ---------------------------------------------------------------------------

def _wide_config(name):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(name)
    layers = {"phi3-mini-3.8b": PHI_LAYERS, **MOE_LAYERS}.get(name)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg


def dense_rows(torch, timer, detail, label, w, xs, m_list, info):
    """``ops.dense_matmul(x, w)`` for the first M rows of ``xs`` at every M
    of ``m_list`` (``w [K, N]`` as the model hands it over: a tied table's
    ``tok.T`` or a column-major dense weight): held to the plain version
    (1e-4 of the range: the same f32 products summed in another order),
    timed (CUDA events, L2 flushed) and traced beside its bound, the plain
    version and ``torch.matmul``, each call's rows bit-equal to the first
    rows of the largest call.  ``info`` goes into every row; returns the
    rows by M."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.dense_matmul import (dense_matmul_plain,
                                                  dense_plan, launch_rows)
    k, n = w.shape
    size = w.element_size()
    step = launch_rows(k, size)
    outs, rows = {}, {}
    for m in m_list:
        x = xs[:m]
        got = ops.dense_matmul(x, w, torch.float32)
        ref = dense_matmul_plain(x, w.t(), torch.float32)
        torch.cuda.synchronize()
        outs[m] = got.clone()
        tol = 1e-4 * ref.abs().max().item()
        err, rel = _check(f"{label} M={m}", got, ref, tol, [])
        t = timer(lambda: ops.dense_matmul(x, w, torch.float32))
        t_plain = timer(lambda: dense_matmul_plain(x, w.t(), torch.float32))
        t_lib = timer(lambda: torch.matmul(x, w))
        dev = device_ms_per_call(
            torch, lambda: ops.dense_matmul(x, w, torch.float32))
        n_bytes = (w.numel() + x.numel()) * size + m * n * 4
        bnd, bby = bound_ms(n_bytes, 2.0 * m * w.numel(),
                            BF16_OPS_PER_S if size == 2 else F32_OPS_PER_S)
        rows[m] = {"kernel": "dense_matmul", **info, "M": m, "K": k, "N": n,
                   "launches": -(-m // step),
                   "xstream": dense_plan(min(m, step), k, n, size).xstream,
                   "max_abs_err": err, "tol": tol, "ms": t,
                   "device_ms": dev, "plain_ms": t_plain,
                   "library_ms": t_lib, "bound_ms": bnd, "bound_by": bby}
        detail.append(rows[m])
        dev_txt = (f"traced device {dev * 1e3:.1f} us"
                   if isinstance(dev, float) else dev)
        say(f"{label} M={m} ({rows[m]['launches']} launches"
            f"{', x streamed in K panels' if rows[m]['xstream'] else ''}): "
            f"err {err:.2e} (rel {rel:.1e}, tol {tol:.2e}) kernel "
            f"{t * 1e3:.1f} us, {dev_txt}, plain {t_plain * 1e3:.1f} us, "
            f"torch.matmul {t_lib * 1e3:.1f} us, bound {bnd * 1e3:.2f} us "
            f"({bby})")
    _gate_rows(torch, label, outs)
    say(f"{label}: every row of the calls of M={tuple(m_list)} is "
        f"bit-equal to the same row of the {max(m_list)}-row call")
    return rows


def head_kernel(torch, cfg, timer, gen, detail, m_list,
                dtype=None):
    """The LM head of ``cfg`` through ``dense_rows`` as the model calls it:
    a tied table's ``tok.T``, or an untied ``lm_head [K, N]`` laid out
    column-major by the engine's ``params_to`` (once, as an engine stores
    it); bf16 (or ``dtype``) weights and x.  Returns the rows by M."""
    from repro_torch.serving.engine import params_to
    dtype = dtype or torch.bfloat16
    dname = "bf16" if dtype == torch.bfloat16 else "f32"
    d, v = cfg.d_model, cfg.vocab
    if cfg.tie_embeddings:
        tok = (torch.randn((v, d), generator=gen, device="cuda")
               * 0.02).to(dtype)
        w, kind = tok.T, "tied tok.T"
    else:
        w = (torch.randn((d, v), generator=gen, device="cuda")
             / d ** 0.5).to(dtype)
        w = params_to({"lm_head": w}, torch.device("cuda"))["lm_head"]
        kind = "untied lm_head"
        if w.is_cuda and w.stride(0) != 1:
            fail(f"{cfg.name}: params_to left the untied head row-major")
    xs = torch.randn((max(m_list), d), generator=gen,
                     device="cuda").to(dtype)
    rows = dense_rows(torch, timer, detail,
                      f"{cfg.name} {kind} [{d}, {v}] {dname}", w, xs, m_list,
                      {"config": cfg.name, "head": kind, "dtype": dname})
    del w, xs
    return rows


def wide_row_gates(torch, cfg, gen):
    """The gemv and the int8 / int4 kernels at every (K, N) of ``cfg``'s
    layer: each call of WIDE_ROW_GATE_M rows bit-equal to the first rows
    of the largest call."""
    from repro_torch.core.quant import quantize_act_int8
    from repro_torch.kernels.sparse_gemv import sparse_gemv
    from repro_torch.kernels.sparse_matmul_int4 import sparse_matmul_int4
    from repro_torch.kernels.sparse_matmul_int8 import sparse_matmul_int8
    shapes = sorted({(k, n) for _, k, n in _layer_linears(cfg)})
    ms = WIDE_ROW_GATE_M
    for name, fn, mode in (("sparse_gemv", sparse_gemv, "bf16"),
                           ("sparse_matmul_int8", sparse_matmul_int8,
                            "int8"),
                           ("sparse_matmul_int4", sparse_matmul_int4,
                            "int4")):
        for kn in shapes:
            sw = _packed(torch, *kn, gen, mode=mode)
            x = torch.randn((max(ms), kn[0]), generator=gen,
                            device="cuda").to(torch.bfloat16)
            if mode == "bf16":
                outs = {m: fn(x[:m], sw).clone() for m in ms}
            else:
                xq, sx = quantize_act_int8(x)
                outs = {m: fn(xq[:m], sx[:m], sw, torch.bfloat16).clone()
                        for m in ms}
            torch.cuda.synchronize()
            _gate_rows(torch, f"{cfg.name} {name} K,N={kn}", outs)
        say(f"{cfg.name} {name}: every row of the calls of M={ms} is "
            f"bit-equal to the same row of the {max(ms)}-row call at "
            f"{len(shapes)} (K, N) shapes")
    return {"M": list(ms), "shapes": len(shapes)}


def wide_kernels(torch, timer):
    """The kernels at the shapes of the new configs (WIDE_LINEARS and
    friends): Llama-3-8B's linears, untied head and attention (with a
    batch-1 "sparse against dense" line per projection, the paper's Table
    2 shape), Phi-3-mini's D = 96 and InternVL2's D = 64 attention and
    untied / tied heads, and the gemv and sparse matmul at InternVL2's
    ragged K = 896.  Each held to its plain version as the Qwen3 kernel
    phase holds it; returns the summary and the detail rows."""
    import dataclasses
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    detail, out = [], {}
    llama = _wide_config("llama3-8b")
    res = {"linears": linear_kernels(torch, llama, timer, gen, detail,
                                     plan=WIDE_LINEARS)}
    table2 = {}
    for name, k, n in _layer_linears(llama):
        row = next(r for r in detail if r["kernel"] == "sparse_gemv"
                   and r["M"] == 1 and (r["K"], r["N"]) == (k, n))
        table2[name] = {"K": k, "N": n, "sparse_ms": row["ms"],
                        "dense_ms": row["library_ms"],
                        "bound_ms": row["bound_ms"],
                        "speedup": row["library_ms"] / row["ms"]}
        say(f"llama3-8b {name} [{k}, {n}] at batch 1 (Table 2's shape): "
            f"sparse gemv {row['ms'] * 1e3:.1f} us against dense "
            f"torch.matmul {row['library_ms'] * 1e3:.1f} us "
            f"({table2[name]['speedup']:.2f}x), bound "
            f"{row['bound_ms'] * 1e3:.2f} us")
    res["table2"] = table2
    res["row_gates"] = wide_row_gates(torch, llama, gen)
    res["head"] = head_kernel(torch, llama, timer, gen, detail,
                              WIDE_UNEMBED_M)
    res["attention"] = attention_kernels(torch, llama, timer, gen, detail,
                                         WIDE_ATTN_Q, WIDE_ATTN_TIMED_Q)
    out["llama3-8b"] = res
    phi = _wide_config("phi3-mini-3.8b")
    out["phi3-mini-3.8b"] = {
        "attention": attention_kernels(
            torch, phi, timer, gen, detail, WIDE_ATTN_Q,
            {"flat": (1,), "paged": (1,)}, long=False),
        "head": head_kernel(torch, phi, timer, gen, detail, (SLOTS,))}
    vlm = _wide_config("internvl2-1b")
    vlm_m = VLM_BATCH * (vlm.frontend_tokens + VLM_PROMPT)
    # the kernel's shapes are the backbone's (the pool sizing the cache
    # refuses a frontend config, whose serving is one-shot)
    backbone = dataclasses.replace(vlm, frontend="", frontend_tokens=0)
    out["internvl2-1b"] = {
        "attention": attention_kernels(
            torch, backbone, timer, gen, detail, WIDE_ATTN_Q,
            {"flat": (1,), "paged": (1,)}, long=False),
        "head": head_kernel(torch, vlm, timer, gen, detail, (VLM_BATCH,)),
        "linears": linear_kernels(
            torch, vlm, timer, gen, detail,
            plan={"sparse_gemv": ((VLM_BATCH,), VLM_BATCH, ()),
                  "sparse_matmul": ((vlm_m,), vlm_m, ())})}
    return out, detail


def _tree_bytes(tree):
    from repro_torch.core.sparse_format import BlockSparseWeight
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, BlockSparseWeight):
        return tree.nbytes_compressed()
    return tree.numel() * tree.element_size()


@contextlib.contextmanager
def kept_outputs(eng):
    """An engine built with ``graphs=False`` runs its entries eagerly, and
    an eager entry returns a fresh output each run; keep the last one as
    its ``out``, which ``record_margins`` reads for a final chunk."""
    entry = eng._entry

    def kept(name, width=0):
        e = entry(name, width)
        if e.eager and not hasattr(e, "_fresh"):
            e._fresh = e.run

            def run(e=e):
                e.out = e._fresh()
                return e.out
            e.run = run
        return e
    eng._entry = kept
    try:
        yield eng
    finally:
        del eng._entry


def wide_serve_phase(torch, name, n_req, new_tokens, prompt_range):
    """``name`` at full width (Phi-3-mini at PHI_LAYERS layers), bf16
    sparse weights from seed 0 on the card, the flat pool, every entry
    captured when the engine is built, overlapped ticks as by default: 4
    slots, prefill chunk 256, ``n_req`` requests of ``prompt_range``
    tokens, ``new_tokens`` new, the last one seeded.  Gates: the logits of
    LOGIT_TICKS teacher-forced ticks through the kernels within 5e-2 of the
    plain range, top-1 where the margin is clear; the greedy requests'
    tokens equal to an all-plain engine's (serial, eager) but at bf16
    near-ties (below ``TOP1_CLEAR``, as the one-shot phase); one capture
    per entry; per decode tick one gemv launch per linear and one attention
    launch per layer; one head launch per decode tick and per chunk.
    Reports the stream (tok/s, TPOT, TTFT), a traced decode tick and
    256-token chunk (and their device time by ``TRACE_CLASSES``), the
    weights' bytes, the graph pools and the peak memory.  An MoE config
    (Phi-3.5-MoE, Scout at MOE_LAYERS layers) also runs ``moe_layer`` on
    the served weights, and its greedy gate runs ``forced_replay``."""
    import numpy as np
    from repro_torch.data.pipeline import DataConfig, host_batch
    from repro_torch.serving import ContinuousEngine, SamplingParams
    cfg = _wide_config(name)
    label = name
    torch.cuda.reset_peak_memory_stats()
    params = _model(torch, cfg, "bf16")
    init_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    lo, hi = prompt_range
    max_tokens = hi + new_tokens + cfg.kv_tail
    paused = [0.0]
    torch.cuda.reset_peak_memory_stats()
    eng = _engine(cfg, params, paused, max_tokens, overlap=True)
    # the engine's tree holds the head laid out for the kernel; drop ours
    params = eng.params
    weight_gb = _tree_bytes(params) / 1e9
    prompts = host_batch(DataConfig(vocab=cfg.vocab, seq_len=hi,
                                    global_batch=n_req), 0)["tokens"]
    rng = np.random.default_rng(0)
    lens = rng.integers(lo, hi + 1, n_req)
    params_of = [SamplingParams(max_new_tokens=new_tokens)] * (n_req - 1)
    params_of.append(SamplingParams(temperature=0.8, top_k=50, top_p=0.95,
                                    seed=1234, max_new_tokens=new_tokens))
    reqs = [prompts[i][:lens[i]] for i in range(n_req)]

    def ready(e):
        # every slot decoding: drain the overlapped pipeline so the checks
        # start from the committed state
        if len(e.scheduler.decoding_slots()) == SLOTS:
            e.quiesce()
            return True
        return False

    run = serve_stream(torch, eng, cfg, reqs, params_of, paused, ready,
                       checks=WIDE_CHECKS, prefill=True, graph_qn=(1,),
                       label=label)
    check_replays(label, run, "sparse_decode_attention_fused", cfg.n_layers)
    check_launches(label, run["counts"],
                   ("sparse_gemv", "sparse_decode_attention_fused",
                    "sparse_matmul", "dense_matmul"),
                   ("sparse_decode_attention_fused_paged",
                    "sparse_matmul_int8", "sparse_matmul_int4",
                    "sparse_decode_attention_partial", "sparse_matmul_f32"))
    linears = len(_layer_linears(cfg)) * cfg.n_layers
    ticks = run["ticks"]
    want = {"sparse_gemv": linears * ticks["decode"],
            "dense_matmul": ticks["decode"] + ticks["prefill"]}
    if any(run["counts"][k] != n for k, n in want.items()):
        fail(f"{label}: launches {run['counts']}; {want} expected (one gemv "
             f"launch per linear, {linears} a decode tick; one head launch "
             "a decode tick and a chunk)")
    total = check_outputs(label, run, cfg, new_tokens)
    check_sync_free(label, run, ("chunk",))
    gate_logits(label, run["check"])
    res = report(label, run, total, n_req)
    prof = run["profile"] or {}
    res["by_class_ms"] = {}
    for what, p in (("graph decode tick", prof),
                    ("graph prefill chunk", prof.get("prefill") or {})):
        # a trace that dropped the graph's kernel records has classes but
        # no device time ("not measured" above)
        if "by_class_ms" in p and "device_ms" in p:
            res["by_class_ms"][what] = p["by_class_ms"]
            say(f"{label}: {what}: device ms by class " + ", ".join(
                f"{k} {v:.3f}" for k, v in sorted(
                    p["by_class_ms"].items(), key=lambda kv: -kv[1]))
                + f" of {p['device_ms']:.3f}")
    if cfg.n_experts:
        res["moe_layer"] = moe_layer(torch, cfg, params, Timer(torch))
    res.update(prompt_lens=[int(x) for x in lens], weight_gb=weight_gb,
               init_peak_gib=init_peak,
               serve_peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               layers=cfg.n_layers, launches_per_tick={
                   "sparse_gemv": linears,
                   "sparse_decode_attention_fused": cfg.n_layers,
                   "dense_matmul": 1})
    experts = (f", {cfg.n_experts} experts top-{cfg.top_k}"
               + (" and a shared expert" if cfg.shared_expert else "")
               if cfg.n_experts else "")
    say(f"{label}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.padded_heads}/{cfg.n_kv} heads of {cfg.hd}, d_ff {cfg.d_ff}"
        f"{experts}, "
        f"vocab {cfg.vocab} ({'tied' if cfg.tie_embeddings else 'untied'}); "
        f"weights {weight_gb:.2f} GB on the card; peak allocated "
        f"{init_peak:.2f} GiB while initialised and packed, "
        f"{res['serve_peak_gib']:.2f} GiB while served; graph pools "
        f"{res['graph_mib']:.1f} MiB; per decode tick {linears} gemv, "
        f"{cfg.n_layers} attention and 1 head launches")
    # the all-plain engine on the same traffic: serial and eager (a graph
    # of the plain versions would capture their host-built constants)
    del eng
    torch.cuda.empty_cache()
    plain = ContinuousEngine(params, cfg, slots=SLOTS, max_tokens=max_tokens,
                             prefill_chunk=PREFILL_CHUNK, device="cuda",
                             graphs=False)
    margins = {}
    routes = {} if cfg.n_experts else None
    t0 = time.perf_counter()
    with plain_kernels(), kept_outputs(plain), \
            record_margins(plain, margins, routes):
        rids = [plain.submit(p, sp) for p, sp in zip(reqs, params_of)]
        ref = plain.run()
    torch.cuda.synchronize()
    res["plain_engine_s"] = time.perf_counter() - t0
    say(f"{label}: the all-plain engine served the same traffic in "
        f"{res['plain_engine_s']:.1f} s (serial, eager)")
    del plain
    greedy = [i for i, sp in enumerate(params_of) if sp.temperature == 0]
    want = [list(ref[rids[i]].token_ids) for i in greedy]
    moves = None
    if cfg.n_experts:
        moves, res["forced"] = forced_replay(
            torch, label, cfg, params, max_tokens, reqs, params_of, rids,
            routes, margins, greedy, want)
    res["identity"] = gate_identity(
        f"{label} against the all-plain engine",
        [list(run["out"][run["rids"][i]].token_ids) for i in greedy],
        want, [rids[i] for i in greedy], margins, tie=TOP1_CLEAR,
        moves=moves)
    del params
    torch.cuda.empty_cache()
    return res


def forced_replay(torch, label, cfg, params, max_tokens, reqs, params_of,
                  rids, routes, margins, greedy, want):
    """An MoE's kernels on the all-plain engine's routing: the same traffic
    through a serial, eager engine of the kernels in which every row
    routes to the experts the all-plain engine's row chose
    (``record_margins(force=...)``).  Gate: its greedy tokens equal the
    all-plain engine's but at top-1 near-ties (below ``TOP1_CLEAR``), so
    a kernel fault cannot hide behind the routing.  Reported: the routing
    decisions its rows would have made themselves, up to each request's
    first divergence, and the router gaps at which they differ.  Returns
    ``first_moves`` of its own routing against the all-plain engine's (the
    rows agree bit for bit with the served engine's up to the first move:
    graphs are bit-equal to eager and a row's kernels do not depend on its
    co-tenants) and the report."""
    from repro_torch.serving import ContinuousEngine
    eng = ContinuousEngine(params, cfg, slots=SLOTS, max_tokens=max_tokens,
                           prefill_chunk=PREFILL_CHUNK, device="cuda",
                           graphs=False)
    own, marg, ids = {}, {}, {}
    t0 = time.perf_counter()
    with kept_outputs(eng), record_margins(
            eng, marg, own, force=lambda rid, row: routes.get(
                (ids[rid], row))):
        for p, sp, rid in zip(reqs, params_of, rids):
            ids[eng.submit(p, sp)] = rid
        out = eng.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    back = {v: k for k, v in ids.items()}
    got = [list(out[back[rids[i]]].token_ids) for i in greedy]
    say(f"{label}: the kernels on the all-plain engine's routing served the "
        f"same traffic in {dt:.1f} s (serial, eager)")
    ident = gate_identity(f"{label} kernels on the plain routing against "
                          f"the all-plain engine", got, want,
                          [rids[i] for i in greedy], margins, tie=TOP1_CLEAR)
    plen = {rid: len(r) for rid, r in zip(rids, reqs)}
    # compare rows up to each greedy request's first divergence
    stop = {rids[i]: next((n for n, (a, b) in enumerate(zip(g, w))
                           if a != b), len(w)) + plen[rids[i]] - 1
            for i, g, w in zip(greedy, got, want)}
    mine = {(ids[r], row): v for (r, row), v in own.items()
            if ids[r] in stop and row <= stop[ids[r]]}
    moves = first_moves(mine, routes, plen)
    gaps = sorted(g for m in moves.values() for g in m["moved_gaps"])
    rep = {"seconds": dt, "identity": ident,
           "decisions": sum(m["decisions"] for m in moves.values()),
           "moved": len(gaps), "moved_gaps_top": gaps[-8:],
           "first_moves": {str(r): m["first"] for r, m in moves.items()}}
    say(f"{label}: of the {rep['decisions']} routing decisions (rows x "
        f"layers) of the greedy requests up to their first divergence, the "
        f"kernels would have moved {len(gaps)}, at all-plain router gaps "
        f"{[float(f'{g:.2e}') for g in gaps[-8:]]} (largest last); first "
        f"moves {rep['first_moves']}")
    del eng
    torch.cuda.empty_cache()
    return moves, rep


def moe_layer(torch, cfg, params, timer):
    """Layer 0's MoE FFN of the served weights (``moe.moe_apply``: the f32
    router, the dispatch, the expert products in cuBLAS, the weighted sum;
    Scout's shared expert through the gemv or the sparse matmul) alone, at
    the decode tick's and the chunk's rows (MOE_ROWS) of seeded bf16 x:
    CUDA-event and traced device time beside two bounds, every expert's
    weights read once (the reference's semantics: its einsums read all of
    them) and only those of the experts this call routes to.  And the row
    rule, reported and not gated (the products are cuBLAS's): the first
    SLOTS rows' router logits and outputs in the decode tick's call (C =
    8) against the same rows at the head of the chunk's call (C = 40 for
    Phi-3.5-MoE), bit for bit."""
    from repro_torch.models import lm, moe
    gen = torch.Generator(device="cuda")
    gen.manual_seed(24)
    p = lm._layer(params["blocks"], 0)["l0"]["ffn"]
    d, e, k = cfg.d_model, cfg.n_experts, cfg.top_k
    xs = torch.randn((max(MOE_ROWS), d), generator=gen,
                     device="cuda").to(torch.bfloat16)
    expert = sum(p[w].numel() * p[w].element_size()
                 for w in ("w_gate", "w_up", "w_down"))
    shared = _tree_bytes(p["shared"]) if cfg.shared_expert else 0
    res, outs = {}, {}
    for t in MOE_ROWS:
        x = xs[:t][None]

        def call(x=x):
            return moe.moe_apply(p, x, cfg)
        outs[t] = call()[0].clone()
        _, top_i = moe.route(p, x[0], k)
        used = int(top_i.unique().numel())
        # x in, the output out, the f32 router; each routed row through
        # three d x d_ff products per expert it takes (and the shared one)
        io = 2 * t * d * 2 + d * e * 4
        ops = 2.0 * t * (k + int(cfg.shared_expert)) * 3 * d * cfg.d_ff
        b_all, by = bound_ms(expert + shared + io, ops)
        b_used, _ = bound_ms(expert * used / e + shared + io, ops)
        row = {"T": t, "C": moe._capacity(t, k, e, cfg.capacity_factor),
               "experts_used": used, "ms": timer(call),
               "device_ms": device_ms_per_call(torch, call),
               "bound_ms": b_all, "bound_by": by, "bound_used_ms": b_used,
               "expert_gb": expert / 1e9}
        res[str(t)] = row
        dev = row["device_ms"]
        say(f"{cfg.name} MoE layer at T={t} (C={row['C']}, {used} of {e} "
            f"experts routed to): {row['ms'] * 1e3:.1f} us, "
            + (f"traced device {dev * 1e3:.1f} us"
               if isinstance(dev, float) else dev)
            + f"; bound {b_all * 1e3:.1f} us ({by}; every expert's "
              f"{expert / 1e9:.2f} GB read once), {b_used * 1e3:.1f} us "
              f"(the routed experts' only)")
    with moe._exact_f32():
        la = xs[:SLOTS].float() @ p["router"]
        lb = (xs.float() @ p["router"])[:SLOTS]
    small, big = outs[SLOTS], outs[max(MOE_ROWS)][:SLOTS]
    res["row_rule"] = {
        "rows": SLOTS, "T": list(MOE_ROWS),
        "router_bit_equal": bool(torch.equal(la, lb)),
        "router_max_abs_diff": (la - lb).abs().max().item(),
        "output_bit_equal": bool(torch.equal(small, big)),
        "output_max_abs_diff": (small.float() - big.float()).abs().max()
        .item(),
        "output_max_abs": small.float().abs().max().item()}
    rr = res["row_rule"]
    say(f"{cfg.name} MoE row rule (reported, not gated): the first {SLOTS} "
        f"rows at T={SLOTS} against the same rows at T={max(MOE_ROWS)}: "
        f"router logits bit-equal {rr['router_bit_equal']} (max |diff| "
        f"{rr['router_max_abs_diff']:.2e}), outputs bit-equal "
        f"{rr['output_bit_equal']} (max |diff| "
        f"{rr['output_max_abs_diff']:.2e} of max |out| "
        f"{rr['output_max_abs']:.2e})")
    return res


# MoE configs whose attention geometry no earlier kernel row holds:
# Scout's G = 6 (Phi-3.5-MoE's G = 4, D = 128 is Llama-3-8B's)
MOE_ATTENTION = ("llama4-scout-17b-a16e",)


def moe_phase(torch, name, n_req, new_tokens):
    """An MoE config at MOE_LAYERS layers: its kernel rows (MOE_LINEARS: the
    gemv at a layer's sparse linears at M = 1 and the slots, the sparse
    matmul at the verify panel's and the chunk's rows; the untied head at
    MOE_HEAD_M rows, Scout's attention at its decode tick and verify panel
    on the flat pool and at its decode tick on the paged one), each held
    to its plain version beside its bound and library call, then the
    served stream (``wide_serve_phase``).  Returns the results and the
    kernel rows."""
    cfg = _wide_config(name)
    timer = Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    detail = []
    kern = {"linears": linear_kernels(torch, cfg, timer, gen, detail,
                                      plan=MOE_LINEARS),
            "head": head_kernel(torch, cfg, timer, gen, detail, MOE_HEAD_M)}
    if name in MOE_ATTENTION:
        q = {"flat": (1, SPEC_K + 1), "paged": (1,)}
        kern["attention"] = attention_kernels(torch, cfg, timer, gen, detail,
                                              q, q, long=False)
    res = wide_serve_phase(torch, name, n_req, new_tokens, PROMPT_RANGE)
    res["kernels"] = kern
    return res, detail


def vlm_phase(torch):
    """InternVL2-1B at full width and depth through the one-shot
    ``Engine``: VLM_BATCH prompts of VLM_PROMPT tokens after the stub
    frontend's 256 seeded embeddings, VLM_TOKENS new, eager; ragged K =
    896 in every linear of the prefill (the sparse matmul at M = B * (256 +
    S)) and the decode (the gemv), G = 8 and D = 64 in the fused attention,
    the tied 151655-row table.  Gates: one launch per linear, layer and
    step; the prefill's and the first decode ticks' logits within 5e-2 of
    the plain range; greedy tokens equal to the all-plain engine's but at
    bf16 near-ties."""
    from repro_torch.data.pipeline import DataConfig, host_batch
    from repro_torch.serving import Engine, SamplingParams
    label = "internvl2-1b"
    cfg = _wide_config(label)
    params = _model(torch, cfg, "bf16")
    toks = host_batch(DataConfig(vocab=cfg.vocab, seq_len=VLM_PROMPT,
                                 global_batch=VLM_BATCH), 0)["tokens"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    fe = torch.randn((VLM_BATCH, cfg.frontend_tokens, cfg.d_model),
                     generator=gen, device="cuda") * 0.02
    batch = {"tokens": toks, "frontend_embeds": fe}
    sp = SamplingParams(max_new_tokens=VLM_TOKENS)
    eng = Engine(params, cfg, device="cuda")
    got, cache, counts, dt, step_ms = _oneshot_generate(torch, label, eng,
                                                         cfg, batch, sp)
    decodes = VLM_TOKENS - 1
    seq = cfg.frontend_tokens + VLM_PROMPT
    if int(cache["pos"]) != seq + decodes:
        fail(f"{label}: the cache is at position {int(cache['pos'])}; the "
             f"frontend's {cfg.frontend_tokens} and the prompt's "
             f"{VLM_PROMPT} tokens and {decodes} decodes expected")
    del cache
    errs, ident = _oneshot_against_plain(torch, label, eng, params, cfg,
                                         batch, sp, got)
    res = {"batch": VLM_BATCH, "frontend": cfg.frontend_tokens,
           "prompt": VLM_PROMPT, "tokens": VLM_TOKENS, "seconds": dt,
           "tok_s": VLM_BATCH * VLM_TOKENS / dt, "median_step_ms": step_ms,
           "launches": counts, "logits_rel_range": max(errs),
           "identity": ident}
    say(f"{label}: {VLM_BATCH} x ({cfg.frontend_tokens} frontend + "
        f"{VLM_PROMPT} prompt) tokens, {VLM_TOKENS} new in {dt:.2f} s "
        f"({res['tok_s']:.1f} tok/s, eager, a sync after each step for its "
        f"time); median decode step {step_ms['decode']:.2f} ms, prefill "
        f"{step_ms['prefill']:.2f} ms; launches {counts}; logits kernels vs "
        f"plain over the prefill and {ONESHOT_LOGIT_TICKS} ticks "
        f"{max(errs):.2e} of the range (tol {ONESHOT_TOL['bf16']})")
    del eng, params
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# the recurrent, hybrid and encoder-decoder families (the fifteenth slice)
# ---------------------------------------------------------------------------

def _oneshot_launches(cfg, rows, n):
    """Kernel launches of one ``Engine.generate`` of ``n`` new tokens after
    a prefill of ``rows`` (= B * S) rows, counted from the port's forward:
    every sparse linear once at the prefill (the sparse matmul; at f32
    activations its f32 launcher) and once a decode step (the gemv); an
    attention layer's kernel once a decode step;
    a Mamba layer's dense ``w_bcdt`` once per ``launch_rows`` prefill rows
    and once a step; the head once a step and once at the prefill (its
    last row).  An MoE's expert stacks and router are torch products, the
    recurrences plain torch.  Where the port departs from the reference's
    calls: an encoder-decoder's cross K/V are projected once, by the
    prefill's cross attention (the reference projects them again for the
    cache), and its decode runs the cross attention's ``wq`` and ``wo``
    only (the reference's ``cross_attn_decode`` does the same)."""
    from repro_torch.kernels.dense_matmul import launch_rows
    from repro_torch.models import lm
    kinds = lm._kinds(cfg)
    periods = cfg.n_layers // len(kinds)
    cross = cfg.family == "encdec"
    f32 = cfg.compute_dtype == "float32"
    matmul = "sparse_matmul_f32" if f32 else "sparse_matmul"
    want = dict.fromkeys((matmul, "sparse_gemv",
                          "sparse_decode_attention_fused"), 0)
    want["dense_matmul"] = n
    for mixer, ffn in kinds:
        if mixer == "rwkv":
            pre, dec = 8, 8
        else:
            pre = dec = {"attn": 4, "mamba": 2}[mixer] + \
                (3 if ffn == "mlp" else 0)
            pre, dec = pre + 4 * cross, dec + 2 * cross
        want[matmul] += periods * pre
        want["sparse_gemv"] += periods * dec * (n - 1)
        if mixer == "attn":
            want["sparse_decode_attention_fused"] += periods * (n - 1)
        if mixer == "mamba":
            want["dense_matmul"] += periods * (
                -(-rows // launch_rows(cfg.d_inner, 4 if f32 else 2)) + n - 1)
    if cross:           # the encoder: attention and MLP, prefill only
        want[matmul] += cfg.enc_layers * 7
    return want


def dense_wide_k(torch, timer, gen, detail, k, n, m_list=WIDE_K_M):
    """The dense kernel at an inner dimension whose x does not fit shared
    memory whole (x streamed in 64-k panels), through ``dense_rows``: a
    random bf16 ``[k, n]`` weight laid out column-major, as the engine's
    ``params_to`` stores a dense linear."""
    w = (torch.randn((n, k), generator=gen, device="cuda")
         / k ** 0.5).to(torch.bfloat16).t()          # [k, n], column-major
    xs = torch.randn((max(m_list), k), generator=gen,
                     device="cuda").to(torch.bfloat16)
    rows = dense_rows(torch, timer, detail, f"dense_matmul [{k}, {n}] bf16",
                      w, xs, m_list, {"dtype": "bf16"})
    del w, xs
    return rows


def _oneshot_profile(torch, eng, cfg, batch):
    """One decode step of the one-shot engine traced (``_profiled``): wall
    time, device busy time, idle share and the top kernels, on the cache of
    a fresh prefill (advanced in place by each traced step)."""
    from repro_torch.models import lm
    cache, logits = eng.prefill(batch)
    tok = logits.argmax(-1)[:, None]

    def step():
        lm.forward_decode(eng.params, cache, tok, cfg)
        torch.cuda.synchronize()
    res = _profiled(torch, step, 4, {})
    del cache
    return res


def _profile_line(label, prof):
    if not isinstance(prof.get("device_ms"), float):
        return f"{label}: traced decode step: {prof.get('device')}"
    top = "; ".join(f"{r['kernel'][:48]} {r['ms_per_tick']:.2f} ms x "
                    f"{r['per_tick']}" for r in prof["top"][:4])
    return (f"{label}: traced decode step {prof['wall_ms']:.2f} ms wall, "
            f"device busy {prof['device_ms']:.2f} ms, idle share "
            f"{prof['idle_share']:.2f}; top: {top}")


def new_family_phase(torch, name, cfg, batch, sp, gate_dtype="bf16"):
    """``cfg`` (bf16 sparse weights from seed 0, packed on the card)
    through the one-shot ``Engine`` on ``batch``: the launches exactly
    (``_oneshot_launches``); every kernel launch of the logits check's
    kernel forwards held to its plain version on the live state
    (``HELD_TOL``); and, with ``gate_dtype`` "bf16", the prefill's and the
    first ONESHOT_LOGIT_TICKS decode steps' logits within 5e-2 of the plain
    range, top-1 agreement of at least TOP1_MIN over the rows whose plain
    margin clears ``TOP1_CLEAR`` (at least one such row) and greedy tokens
    equal to the all-plain engine's but at bf16 near-ties
    (``_oneshot_against_plain``).  With "f32" those three gates move to the
    same traffic served again at f32 activations (the same sparse weights,
    the f32 gemv, matmul and head kernels), at the f32 bars (1e-3 of the
    range, ``TIE_MARGIN``), its launches exact too, and the bf16 logits are
    reported: RWKV-6-7B's random weights make its 32 layers chaotic in
    bf16, two correct bf16 paths ending about 5e-2 of the range apart.
    Reported: tok/s, the median decode and prefill step, the weights' GB,
    the peak memory and one traced decode step."""
    from repro_torch.serving import Engine
    torch.cuda.reset_peak_memory_stats()
    params = _model(torch, cfg, "bf16")
    weights_gb = _tree_bytes(params) / 1e9
    eng = Engine(params, cfg, device="cuda")
    rows = len(batch["tokens"]) * len(batch["tokens"][0])
    n = sp.max_new_tokens
    want = _oneshot_launches(cfg, rows, n)
    got, cache, counts, dt, step_ms = _oneshot_generate(
        torch, name, eng, cfg, batch, sp, want=want)
    if int(cache["pos"]) != len(batch["tokens"][0]) + n - 1:
        fail(f"{name}: the cache is at position {int(cache['pos'])}")
    del cache
    held, top1 = {}, {}
    bf16 = gate_dtype == "bf16"
    errs, ident = _oneshot_against_plain(
        torch, name, eng, params, cfg, batch, sp, got, held=held,
        top1=top1 if bf16 else None, gated=bf16)
    prof = _oneshot_profile(torch, eng, cfg, batch)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    b = len(batch["tokens"])
    res = {"batch": b, "prompt": len(batch["tokens"][0]), "tokens": n,
           "seconds": dt, "tok_s": b * n / dt, "median_step_ms": step_ms,
           "launches": counts, "want": want,
           "logits_rel_range": max(errs), "logits_rel_ticks": errs,
           "held": held, "gated_at": gate_dtype, "weights_gb": weights_gb,
           "peak_gib": peak, "decode_profile": prof}
    say(f"{name}: {b} x {res['prompt']} tokens, {n} new in {dt:.2f} s "
        f"({res['tok_s']:.1f} tok/s, eager, a sync after each step for its "
        f"time); median decode step {step_ms['decode']:.2f} ms, prefill "
        f"{step_ms['prefill']:.2f} ms; launches {counts} (exact); logits "
        f"kernels vs plain over the prefill and {ONESHOT_LOGIT_TICKS} ticks "
        f"{max(errs):.2e} of the range ("
        + (f"tol {ONESHOT_TOL['bf16']}" if bf16 else "reported; gated at "
           "f32 below") + f"); {held['launches']} kernel launches of that "
        f"check held to their plain versions on the live state, largest "
        f"error {held['max_rel_err']:.2e} of the output; weights "
        f"{weights_gb:.2f} GB, peak {peak:.2f} GiB")
    say(_profile_line(name, prof))
    del eng
    if not bf16:
        cfg32, params32 = _widened(torch, cfg, params)
        eng = Engine(params32, cfg32, device="cuda")
        label = f"{name} f32"
        want32 = _oneshot_launches(cfg32, rows, n)
        got, cache, counts32, dt32, step32 = _oneshot_generate(
            torch, label, eng, cfg32, batch, sp, want=want32)
        del cache
        errs, ident = _oneshot_against_plain(
            torch, label, eng, params32, cfg32, batch, sp, got, dtype="f32",
            top1=top1)
        res["f32"] = {"seconds": dt32, "tok_s": b * n / dt32,
                      "median_step_ms": step32, "launches": counts32,
                      "logits_rel_range": max(errs),
                      "logits_rel_ticks": errs}
        say(f"{label}: the same traffic at f32 activations in {dt32:.2f} s "
            f"({b * n / dt32:.1f} tok/s); launches {counts32} (exact); "
            f"logits kernels vs plain {max(errs):.2e} of the range (tol "
            f"{ONESHOT_TOL['f32']})")
        del eng, params32
    share = top1["agree"] / max(top1["clear"], 1)
    if not top1["clear"] or share < TOP1_MIN:
        fail(f"{name}: top-1 agreement {share:.3f} over {top1['clear']} "
             f"rows of a clear margin (at least one and {TOP1_MIN} "
             "expected)")
    res.update(top1=top1, identity=ident)
    say(f"{name}: gated at {gate_dtype}: top-1 agreement {share:.3f} over "
        f"the {top1['clear']} rows whose plain margin is {top1['tie']} of "
        f"the largest |logit| or more; {ident['identical']} of "
        f"{ident['requests']} requests token-identical to the all-plain "
        "engine")
    del params
    torch.cuda.empty_cache()
    return res


def rwkv_phase(torch):
    """RWKV-6-7B at full width and depth (32 layers, d 4096, 64 heads of
    64, d_ff 14336, untied 65536-row head): its kernel rows first (the
    gemv at its eight linears at M = 1 and 4, the sparse matmul at the
    prefill's M = 2048, the head at M = 1 and 4, the dense kernel at
    ``w_cv``'s K = 14336, x streamed in K panels), then the one-shot
    engine on RWKV_BATCH x RWKV_PROMPT tokens, RWKV_TOKENS new: per decode
    step 256 gemv launches (8 a layer) and one head launch, no attention;
    the prefill's 256 sparse matmuls at M = 2048 and its 16 K recurrence
    steps (plain torch, as the reference's ``lax.scan``).  Its logits and
    token gates run on the same traffic served at f32 activations
    (``new_family_phase``)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, host_batch
    from repro_torch.serving import SamplingParams
    cfg = get_config("rwkv6-7b")
    timer = Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)
    detail = []
    m = RWKV_BATCH * RWKV_PROMPT
    kern = {"linears": linear_kernels(
                torch, cfg, timer, gen, detail,
                plan={"sparse_gemv": ((1, RWKV_BATCH), RWKV_BATCH,
                                      (RWKV_BATCH,)),
                      "sparse_matmul": ((m,), m, ())}),
            "head": head_kernel(torch, cfg, timer, gen, detail, NEW_HEAD_M),
            "dense_wide_k": dense_wide_k(torch, timer, gen, detail,
                                         *WIDE_K["rwkv6-7b"])}
    toks = host_batch(DataConfig(vocab=cfg.vocab, seq_len=RWKV_PROMPT,
                                 global_batch=RWKV_BATCH), 0)["tokens"]
    res = new_family_phase(torch, "rwkv6", cfg, {"tokens": toks},
                           SamplingParams(max_new_tokens=RWKV_TOKENS),
                           gate_dtype="f32")
    if res["launches"]["sparse_gemv"] != 8 * cfg.n_layers * (RWKV_TOKENS - 1):
        fail("rwkv6: 8 gemv launches a layer and decode step expected")
    res["kernels"] = kern
    return res, detail


def seamless_phase(torch):
    """SeamlessM4T-medium at full width and depth (12 encoder and 12
    decoder layers, d 1024, 16 heads of 64, G = 1, untied 256206-row head,
    the first N not a multiple of 4): its kernel rows first (the gemv at
    the 9 linears a decoder layer runs a decode step, M = SEAMLESS_BATCH;
    the flat and paged attention at D = 64, G = 1, QG = 1; the head at
    M = 1 and 4), then the one-shot engine on SEAMLESS_BATCH x
    (SEAMLESS_FRAMES seeded ``src_embeds`` frames + SEAMLESS_PROMPT
    tokens), SEAMLESS_TOKENS new
    (``kv_tail`` 128 is a multiple of bs = 128, so a refreeze is legal):
    per decode step 12 attention launches (the self-attention only: the
    cross attention is plain torch over the encoder's dense K/V, as in the
    reference) and 9 gemv launches a layer (``wq``, ``wk``, ``wv``, ``wo``,
    the cross attention's ``wq`` and ``wo``, the MLP)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, host_batch
    from repro_torch.serving import SamplingParams
    cfg = get_config("seamless-m4t-medium")
    timer = Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(16)
    detail = []
    one = {"flat": (1,), "paged": (1,)}
    kern = {"linears": linear_kernels(
                torch, cfg, timer, gen, detail,
                plan={"sparse_gemv": ((SEAMLESS_BATCH,), SEAMLESS_BATCH,
                                      (SEAMLESS_BATCH,))},
                # a decode step's: the cross K/V are projected once, at
                # the prefill
                linears=_layer_linears(cfg, skip=("cross/wk",
                                                  "cross/wv"))),
            # the attention's shapes are a decoder layer's self-attention
            # (the pool sizing refuses an encoder-decoder config)
            "attention": attention_kernels(
                torch, dataclasses.replace(cfg, family="dense",
                                           enc_layers=0),
                timer, gen, detail, one, one, long=False),
            "head": head_kernel(torch, cfg, timer, gen, detail, NEW_HEAD_M)}
    toks = host_batch(DataConfig(vocab=cfg.vocab, seq_len=SEAMLESS_PROMPT,
                                 global_batch=SEAMLESS_BATCH), 0)["tokens"]
    src = torch.randn((SEAMLESS_BATCH, SEAMLESS_FRAMES, cfg.d_model),
                      generator=gen, device="cuda")
    res = new_family_phase(torch, "seamless", cfg,
                           {"tokens": toks, "src_embeds": src},
                           SamplingParams(max_new_tokens=SEAMLESS_TOKENS))
    if res["launches"]["sparse_decode_attention_fused"] != \
            cfg.n_layers * (SEAMLESS_TOKENS - 1):
        fail("seamless: one attention launch a layer and decode step "
             "expected")
    res["kernels"] = kern
    return res, detail


def jamba_phase(torch):
    """Jamba-1.5-Large ``reduced()`` through the one-shot engine (at full
    width one period of 8 layers holds 77.3 GB of dense bf16 experts, more
    than a card): the hybrid interleave on the card, a Mamba and an
    attention layer a period, MoE every other layer, on JAMBA_BATCH x
    JAMBA_PROMPT tokens, JAMBA_TOKENS new, with the same gates."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, host_batch
    from repro_torch.models import lm
    from repro_torch.serving import SamplingParams
    cfg = get_config("jamba-1.5-large-398b").reduced()
    if {k[0] for k in lm._kinds(cfg)} != {"mamba", "attn"}:
        fail("jamba: the reduced period holds no Mamba and attention pair")
    toks = host_batch(DataConfig(vocab=cfg.vocab, seq_len=JAMBA_PROMPT,
                                 global_batch=JAMBA_BATCH), 0)["tokens"]
    return new_family_phase(torch, "jamba", cfg, {"tokens": toks},
                            SamplingParams(max_new_tokens=JAMBA_TOKENS))


def jamba_mamba_phase(torch):
    """One Mamba mixer at Jamba's full width (d 8192, d_inner 16384,
    d_state 16, d_conv 4, dt rank 512): packed as the model packs it
    (sparse ``w_in [8192, 32768]`` and ``w_out [16384, 8192]``, dense
    ``w_bcdt [16384, 544]`` laid out column-major by ``params_to``).  Its
    kernel rows first (the gemv at ``w_in`` and ``w_out`` at M = 1 and 4,
    the sparse matmul at the prefill's M = 1024, the dense kernel at
    ``w_bcdt``'s K = 16384, x streamed in K panels), then ``mamba_apply``
    over MAMBA_BATCH x MAMBA_ROWS rows with ``return_state`` and
    MAMBA_STEPS ``mamba_decode`` steps from that state, held (outputs and
    states within MAMBA_TOL of the plain range) against the same calls
    through the plain versions; launches exact (the prefill: 2 sparse
    matmuls and 1024 / 64 = 16 dense launches; a step: 2 gemv and 1 dense
    launch).  Reported: the layer's GB, the prefill's and a step's time, a
    traced step."""
    import copy
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.convert import convert_concrete
    from repro_torch.models import lm, ssm
    from repro_torch.models import module as mod
    from repro_torch.serving.engine import params_to
    cfg = get_config("jamba-1.5-large-398b")
    timer = Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    detail = []
    di, d = cfg.d_inner, cfg.d_model
    m = MAMBA_BATCH * MAMBA_ROWS
    kern = {"linears": linear_kernels(
                torch, cfg, timer, gen, detail,
                plan={"sparse_gemv": ((1, MAMBA_BATCH), MAMBA_BATCH,
                                      (MAMBA_BATCH,)),
                      "sparse_matmul": ((m,), m, ())},
                linears=[("w_in", d, 2 * di), ("w_out", di, d)]),
            "dense_wide_k": dense_wide_k(
                torch, timer, gen, detail,
                *WIDE_K["jamba-1.5-large-398b"])}
    specs = lm._stack_specs(ssm.mamba_specs(cfg), 1)
    t0 = time.perf_counter()
    p = params_to(convert_concrete(mod.initialize(specs, 0,
                                                  torch.device("cuda")),
                                   specs, cfg, device="cuda"),
                  torch.device("cuda"))
    p = lm._layer(p, 0)
    torch.cuda.synchronize()
    layer_gb = _tree_bytes(p) / 1e9
    if p["w_bcdt"].stride(0) != 1 or not hasattr(p["w_in"], "bitmap"):
        fail("jamba_mamba: w_bcdt not column-major or w_in not packed")
    x = torch.randn((MAMBA_BATCH, MAMBA_ROWS, d), generator=gen,
                    device="cuda").to(torch.bfloat16)
    xt = torch.randn((MAMBA_STEPS, MAMBA_BATCH, d), generator=gen,
                     device="cuda").to(torch.bfloat16)

    def run():
        out, st = ssm.mamba_apply(p, x, cfg, return_state=True)
        outs, states = [out], [copy.deepcopy(st)]
        for i in range(MAMBA_STEPS):
            o, st = ssm.mamba_decode(p, xt[i], st, cfg)
            outs.append(o)
            states.append(copy.deepcopy(st))
        return outs, states
    kernels.reset_launch_counts()
    outs, states = run()
    counts = kernels.launch_counts()
    with plain_kernels():
        outs_p, states_p = run()
    want = {"sparse_matmul": 2, "sparse_gemv": 2 * MAMBA_STEPS,
            "dense_matmul": m // 64 + MAMBA_STEPS}
    check_launches("jamba_mamba", counts, tuple(want),
                   tuple(k for k in counts if k not in want))
    if any(counts[k] != v for k, v in want.items()):
        fail(f"jamba_mamba: launches {counts}; {want} expected")
    errs = [_range_err(a, b) for a, b in zip(outs, outs_p)]
    errs += [_range_err(a[k], b[k]) for a, b in zip(states, states_p)
             for k in a]
    if not max(errs) <= MAMBA_TOL:
        fail(f"jamba_mamba: outputs or states through the kernels differ "
             f"from the plain versions by {max(errs):.3e} of the range")
    if not all(torch.isfinite(o).all() for o in outs):
        fail("jamba_mamba: a non-finite output")
    steps = {"prefill": [], "decode": []}
    st0 = states[0]
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ssm.mamba_apply(p, x, cfg, return_state=True)
        torch.cuda.synchronize()
        steps["prefill"].append(time.perf_counter() - t1)
    st = copy.deepcopy(st0)

    def step():
        nonlocal st
        _, st = ssm.mamba_decode(p, xt[0], st, cfg)
        torch.cuda.synchronize()
    for _ in range(8):
        t1 = time.perf_counter()
        step()
        steps["decode"].append(time.perf_counter() - t1)
    step_ms = {k: statistics.median(v) * 1e3 for k, v in steps.items()}
    prof = _profiled(torch, step, 4, {})
    res = {"layer_gb": layer_gb, "launches": counts, "rel_err": max(errs),
           "median_ms": step_ms, "decode_profile": prof, "kernels": kern,
           "init_s": time.perf_counter() - t0}
    say(f"jamba_mamba: one Mamba mixer at d {d}, d_inner {di}: "
        f"{layer_gb:.3f} GB; mamba_apply over {MAMBA_BATCH} x {MAMBA_ROWS} "
        f"rows {step_ms['prefill']:.2f} ms, a decode step "
        f"{step_ms['decode']:.3f} ms; launches {counts} (exact); outputs "
        f"and states of the prefill and {MAMBA_STEPS} steps "
        f"{max(errs):.2e} of the plain range (tol {MAMBA_TOL})")
    say(_profile_line("jamba_mamba", prof))
    del p, x, xt, outs, outs_p, states, states_p
    torch.cuda.empty_cache()
    return res, detail


NEW_FAMILY_PHASES = (("rwkv6", rwkv_phase), ("seamless", seamless_phase),
                     ("jamba", lambda torch: (jamba_phase(torch), [])),
                     ("jamba_mamba", jamba_mamba_phase))


WIDE_PHASES = ("wide_kernels", "llama3_8b", "phi3_mini", "internvl2",
               "phi35_moe", "scout", "rwkv6", "seamless", "jamba",
               "jamba_mamba")


def wide_phases(torch, only=WIDE_PHASES):
    """The thirteenth to fifteenth slices' phases: the kernel rows at the
    new shapes, then Llama-3-8B, Phi-3-mini and InternVL2-1B served, then
    the MoE family (Phi-3.5-MoE, Llama-4-Scout) with its kernel rows, then
    RWKV-6-7B, SeamlessM4T-medium, Jamba reduced and Jamba's Mamba mixer
    at full width (each with its kernel rows)."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    res, detail = {}, []
    t0 = time.perf_counter()
    if "wide_kernels" in only:
        res["wide_kernels"], detail = wide_kernels(torch, Timer(torch))
        PHASE_S["wide_kernels"] = time.perf_counter() - t0
        say(f"wide_kernels: every kernel agrees with its plain version at "
            f"the new configs' shapes ({PHASE_S['wide_kernels']:.1f} s)")
    for phase, args in (("llama3_8b", ("llama3-8b", LLAMA_REQUESTS,
                                       LLAMA_NEW_TOKENS, LLAMA_PROMPT_RANGE)),
                        ("phi3_mini", ("phi3-mini-3.8b", PHI_REQUESTS,
                                       PHI_NEW_TOKENS, PHI_PROMPT_RANGE))):
        if phase in only:
            t0 = time.perf_counter()
            res[phase] = wide_serve_phase(torch, *args)
            gc.collect()
            torch.cuda.empty_cache()
            PHASE_S[phase] = time.perf_counter() - t0
            say(f"{phase}: passed ({PHASE_S[phase]:.1f} s)")
    if "internvl2" in only:
        t0 = time.perf_counter()
        res["internvl2"] = vlm_phase(torch)
        PHASE_S["internvl2"] = time.perf_counter() - t0
        say(f"internvl2: passed ({PHASE_S['internvl2']:.1f} s)")
    for phase, args in (("phi35_moe", ("phi3.5-moe-42b-a6.6b",
                                       PHI_MOE_REQUESTS, PHI_MOE_NEW_TOKENS)),
                        ("scout", ("llama4-scout-17b-a16e", SCOUT_REQUESTS,
                                   SCOUT_NEW_TOKENS))):
        if phase in only:
            t0 = time.perf_counter()
            res[phase], rows = moe_phase(torch, *args)
            detail += rows
            gc.collect()
            torch.cuda.empty_cache()
            PHASE_S[phase] = time.perf_counter() - t0
            say(f"{phase}: passed ({PHASE_S[phase]:.1f} s)")
    for phase, fn in NEW_FAMILY_PHASES:
        if phase in only:
            t0 = time.perf_counter()
            res[phase], rows = fn(torch)
            detail += rows
            gc.collect()
            torch.cuda.empty_cache()
            PHASE_S[phase] = time.perf_counter() - t0
            say(f"{phase}: passed ({PHASE_S[phase]:.1f} s)")
    return res, detail


# ---------------------------------------------------------------------------
# the training slice
# ---------------------------------------------------------------------------

def _train_batch(torch, cfg, b, s, gen=None):
    """The data pipeline's first batch on the card, with seeded
    ``src_embeds`` / ``frontend_embeds`` where ``cfg`` takes them."""
    from repro_torch.data.pipeline import DataConfig, host_batch
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in host_batch(
        DataConfig(vocab=cfg.vocab, seq_len=s, global_batch=b), 0).items()}
    if cfg.family == "encdec":
        batch["src_embeds"] = torch.randn((b, s, cfg.d_model), generator=gen,
                                          device="cuda")
    if cfg.frontend:
        batch["frontend_embeds"] = torch.randn(
            (b, cfg.frontend_tokens, cfg.d_model), generator=gen,
            device="cuda")
    return batch


def train_launches(cfg, b, s):
    """Dense kernel launches of one train step of ``b x s`` tokens of a
    dense model (``cfg.remat``): each layer's linears once per
    ``launch_rows(K)`` rows in the forward and again in the backward's
    replay, and the tied head once per ``launch_rows(d)`` rows of each
    loss chunk (1024 positions, or the whole sequence), with no replay
    (the loss keeps its logits, as the reference's scan does)."""
    from repro_torch.kernels.dense_matmul import launch_rows
    w = 4 if cfg.param_dtype == "float32" else 2
    rows = b * s
    layer = sum(-(-rows // launch_rows(k, w)) for _, k, _ in
                _layer_linears(cfg))
    chunk = 1024 if s % 1024 == 0 else s
    head = (s // chunk) * -(-(b * chunk) // launch_rows(cfg.d_model, w))
    return (2 if cfg.remat else 1) * cfg.n_layers * layer + head


@contextlib.contextmanager
def train_watch(torch, steps, grads=None):
    """Wrap ``launch.train.make_train_step``'s step for this script's run:
    per step its wall time (between two syncs), the dense kernel's
    launches (read before and after; the counters are not reset), whether
    every new param kept its old strides, whether every leaf's gradient
    was finite (each checked on the card, read once a step), the loss and
    the grad norm; ``grads`` collects each step's tied-table gradient
    norm."""
    from repro_torch import kernels
    from repro_torch.launch import train as train_mod
    from repro_torch.models.module import tree_leaves, tree_map
    from repro_torch.train import step as step_mod
    make, vg = train_mod.make_train_step, step_mod.value_and_grad
    finite = []

    def checked(*a, **k):
        loss, g = vg(*a, **k)
        finite.append(torch.stack([torch.isfinite(t).all()
                                   for t in tree_leaves(g)]).all())
        if grads is not None:
            grads.append(g["embed"]["tok"].float().norm())
        return loss, g

    def watched_make(*a, **k):
        fn = make(*a, **k)

        def step(params, opt, batch):
            strides = tree_map(lambda t: t.stride(), params)
            torch.cuda.synchronize()
            before = kernels.launch_counts()
            t0 = time.perf_counter()
            out = fn(params, opt, batch)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            after = kernels.launch_counts()
            steps.append({
                "s": dt, "dense": after["dense_matmul"]
                - before["dense_matmul"],
                "other": sum(after[n] - before[n] for n in after
                             if n != "dense_matmul"),
                "layout_kept": tree_map(lambda t: t.stride(), out[0])
                == strides,
                "finite": bool(finite[-1]), "loss": float(out[2]["loss"]),
                "grad_norm": float(out[2]["grad_norm"])})
            return out
        return step
    with patched(train_mod, "make_train_step", watched_make), \
            patched(step_mod, "value_and_grad", checked):
        yield


def train_profile(torch, fn, step_s, n=1):
    """One train step (``fn``, ending in a sync) traced by
    ``torch.profiler`` after one untraced call: wall time, device busy
    time, the dense kernel's device time and launches (its kernels are
    named ``unembed_*``), and the device time of the backward's
    ``torch.matmul`` products (each wrapped in a ``record_function`` range
    for this run only), all per step.  The profiler stretches the traced
    step's wall time several times over, so the idle share is taken
    against the untraced median step ``step_s`` (and reported against the
    traced wall too)."""
    from repro_torch.kernels import dense_matmul as dm
    res = {}
    fn()
    product = dm._product

    def ranged(*a, **k):
        with torch.profiler.record_function("dense_backward_matmul"):
            return product(*a, **k)
    t0 = time.perf_counter()
    try:
        from torch.profiler import ProfilerActivity, profile
        with patched(dm, "_product", ranged), profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        res["wall_ms"] = (time.perf_counter() - t0) / n * 1e3
        events = prof.key_averages()
        kern = [(e.key, e.self_device_time_total / n / 1e3, e.count / n)
                for e in events if "CUDA" in str(e.device_type)
                and e.self_device_time_total > 0]
        bwd = [e.device_time_total / n / 1e3 for e in events
               if e.key == "dense_backward_matmul"]
    except Exception as e:
        res["device"] = f"not measured: {type(e).__name__}: {e}"
        return res
    if not kern:
        res["device"] = "not measured: the trace holds no device time"
        return res
    busy = sum(t for _, t, _ in kern)
    dense = [(t, c) for k, t, c in kern if "unembed_" in k]
    kern.sort(key=lambda r: -r[1])
    res.update(
        device_ms=busy, idle_share=max(0.0, 1 - busy / (step_s * 1e3)),
        idle_share_traced=max(0.0, 1 - busy / res["wall_ms"]),
        dense_ms=sum(t for t, _ in dense),
        dense_traced_launches=sum(c for _, c in dense),
        backward_matmul_ms=(bwd[0] if bwd and bwd[0] > 0 else
                            "not measured: no device time under the range"),
        top=[{"kernel": k[:80], "ms": t, "count": c}
             for k, t, c in kern[:8]])
    res["dense_share"] = res["dense_ms"] / busy
    if isinstance(res["backward_matmul_ms"], float):
        res["backward_matmul_share"] = res["backward_matmul_ms"] / busy
    return res


def _grads_against_plain(torch, label, params, batch, cfg, loss_tol,
                         grad_tol=None, attn_impl=None):
    """One step's loss and gradients (``train.step.value_and_grad``)
    through the kernels and again with every kernel on its plain version
    (``plain_kernels``), the same params and batch: the loss within
    ``loss_tol`` relative and, with ``grad_tol``, every leaf's gradient
    within ``grad_tol`` of its largest plain magnitude.  The kernel run
    must launch the dense kernel.  Returns the errors and launches."""
    from repro_torch import kernels
    from repro_torch.models.module import tree_leaves
    from repro_torch.train.step import value_and_grad
    kernels.reset_launch_counts()
    loss_k, g_k = value_and_grad(params, batch, cfg, attn_impl)
    torch.cuda.synchronize()
    launched = kernels.launch_counts()
    if launched["dense_matmul"] == 0:
        fail(f"{label}: the step launched no dense kernel")
    with plain_kernels():
        loss_p, g_p = value_and_grad(params, batch, cfg, attn_impl)
    rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    if not rel <= loss_tol:
        fail(f"{label}: loss through the kernels {float(loss_k):.6f} against "
             f"the plain versions' {float(loss_p):.6f} ({rel:.2e} > "
             f"{loss_tol:.0e} relative)")
    worst = 0.0
    if grad_tol is not None:
        for a, b in zip(tree_leaves(g_k), tree_leaves(g_p)):
            top = b.float().abs().max().item()
            err = (a.float() - b.float()).abs().max().item()
            worst = max(worst, err / max(top, 1e-30))
        if not worst <= grad_tol:
            fail(f"{label}: a leaf's gradient is {worst:.2e} of its largest "
                 f"plain magnitude from the plain versions' (> {grad_tol})")
    return {"loss": float(loss_k), "loss_plain": float(loss_p),
            "loss_rel": rel, "grad_rel": worst,
            "launches": launched["dense_matmul"]}


def train_kernel_rows(torch, cfg, timer, gen, detail):
    """The dense kernel at the training shapes of ``cfg`` (one train step
    of TRAIN_BATCH x TRAIN_SEQ rows): each distinct (K, N) of a layer's
    linears, a random bf16 weight laid out column-major as ``params_to``
    stores it, and the tied head, through ``dense_rows`` (held to the
    plain version, timed beside its bound, the plain version and
    ``torch.matmul``); each row with its launches a step.  Returns the
    rows and the layer's sum."""
    from repro_torch.kernels.dense_matmul import launch_rows
    m = TRAIN_BATCH * TRAIN_SEQ
    lin = _layer_linears(cfg)
    out, layer = {}, {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                      "bound_ms": 0.0, "max_abs_err": 0.0}
    replay = 2 if cfg.remat else 1
    for k, n in sorted({(k, n) for _, k, n in lin}):
        count = sum(1 for _, kk, nn in lin if (kk, nn) == (k, n))
        w = (torch.randn((n, k), generator=gen, device="cuda")
             / k ** 0.5).to(torch.bfloat16).t()
        xs = torch.randn((m, k), generator=gen,
                         device="cuda").to(torch.bfloat16)
        row = dense_rows(torch, timer, detail,
                         f"train dense_matmul [{k}, {n}] x {count} a layer",
                         w, xs, (m,), {"config": cfg.name, "train": True})[m]
        row["per_layer"] = count
        row["launches_per_step"] = replay * cfg.n_layers * count * \
            -(-m // launch_rows(k))
        out[f"{k}x{n}"] = row
        for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
            layer[key] += count * row[key]
        layer["max_abs_err"] = max(layer["max_abs_err"], row["max_abs_err"])
        del w, xs
    head = head_kernel(torch, cfg, timer, gen, detail, (m,))[m]
    head["launches_per_step"] = -(-m // launch_rows(cfg.d_model))
    out["head"] = head
    layer["bound_by"] = "bytes" if all(
        r["bound_by"] == "bytes" for r in out.values()) else "operations"
    say(f"train: a layer's seven linears at M={m}: kernel "
        f"{layer['ms'] * 1e3:.1f} us, plain {layer['plain_ms'] * 1e3:.1f} "
        f"us, torch.matmul {layer['library_ms'] * 1e3:.1f} us, bound "
        f"{layer['bound_ms'] * 1e3:.1f} us; the head "
        f"{head['ms'] * 1e3:.1f} us ({head['launches_per_step']} launches a "
        f"step), torch.matmul {head['library_ms'] * 1e3:.1f} us, bound "
        f"{head['bound_ms'] * 1e3:.1f} us")
    return out, layer


def _train_traced_step(torch, cfg, optc, params, opt, res):
    """A traced train step of TRAIN_TRACE_BATCH x TRAIN_SEQ tokens after
    three untraced ones (``train_profile``), into ``res["train"]``."""
    from repro_torch.train import make_train_step
    batch = _train_batch(torch, cfg, TRAIN_TRACE_BATCH, TRAIN_SEQ)
    step_fn = make_train_step(cfg, optc)

    def one_step():
        step_fn(params, opt, batch)
        torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        one_step()
        times.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    prof = train_profile(torch, one_step, statistics.median(times))
    prof.update(seconds=time.perf_counter() - t0, batch=TRAIN_TRACE_BATCH,
                untraced_step_s=times,
                launches=train_launches(cfg, TRAIN_TRACE_BATCH, TRAIN_SEQ))
    res["train"]["profile"] = prof
    if isinstance(prof.get("device_ms"), float):
        bwd = prof.get("backward_matmul_share")
        say(f"train: traced step of {TRAIN_TRACE_BATCH} x {TRAIN_SEQ} tokens "
            f"(untraced median {statistics.median(times) * 1e3:.1f} ms): "
            f"{prof['wall_ms']:.1f} ms wall under the profiler "
            f"({prof['seconds']:.1f} s with the trace's reading), device "
            f"busy {prof['device_ms']:.1f} ms: idle share "
            f"{prof['idle_share']:.3f} of the untraced median step "
            f"({prof['idle_share_traced']:.3f} of the traced wall); dense "
            f"kernel ({prof['launches']} launches a step) "
            f"{prof['dense_ms']:.1f} ms ({prof['dense_share']:.3f} of busy, "
            f"{prof['dense_traced_launches']:.0f} launches traced); backward "
            "torch.matmul "
            + (f"{prof['backward_matmul_ms']:.1f} ms ({bwd:.3f} of busy)"
               if bwd is not None else str(prof["backward_matmul_ms"])))
    else:
        say(f"train: traced step: {prof.get('device')}")


def train_phase(torch):
    """The training stack on the card (the sixteenth slice):

    * full-width, full-depth Qwen3-0.6B (bf16 params, f32 master) trains
      TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ tokens through
      ``launch.train.train_loop`` (params drawn from seed 28, its key; one
      step of lr warm-up): the last loss below the first, every leaf's
      gradient finite, every param's layout kept, the dense kernel's
      launches a step exactly ``train_launches`` and no other kernel;
      the median step, tok/s, peak memory and a traced step of
      TRAIN_TRACE_BATCH x TRAIN_SEQ tokens (busy, idle share, the dense
      kernel's share and launches, the backward ``torch.matmul``
      products' share);
    * the dense kernel at the training shapes (``train_kernel_rows``);
    * gradients through the kernels against the plain versions on the
      card (params from seed 0, TRAIN_CHECK_BATCH x TRAIN_CHECK_SEQ, full
      width and depth): at f32 the loss within 1e-5 relative and every
      leaf within 1e-3 of its largest magnitude; at bf16 the loss within
      1e-2;
    * ``microbatch=TRAIN_MICRO`` against the full batch of TRAIN_BATCH x
      TRAIN_MICRO_SEQ tokens at the same params (loss within 1e-4, the
      master copy within rtol 2e-2, atol 5e-5);
    * restart: 4 steps straight against 2, a checkpoint, a restore and 2
      more (losses within rtol 1e-4, atol 1e-5), at TRAIN_RESTART_LAYERS
      layers (full width);
    * past 4096 tokens: one step of 1 x TRAIN_LONG tokens in each blocked
      schedule (losses within 1e-5 relative, the tied table's gradient
      norms within 1e-3, launches exact), timed; a one-shot ``Engine``
      prefill of one TRAIN_LONG-token prompt on packed bf16 weights
      against the same prefill on the plain versions (5e-2 of the range);
    * one step of every other family's reduced config at f32, kernels
      against plain versions (loss 1e-5, every leaf 1e-3)."""
    import dataclasses
    import gc
    import tempfile
    from repro_torch import kernels
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch import train as train_mod
    from repro_torch.models import lm
    from repro_torch.models.module import tree_leaves
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.serving import Engine
    from repro_torch.serving.engine import params_to
    from repro_torch.train import make_train_step
    cuda = torch.device("cuda")
    cfg = get_config("qwen3-0.6b")
    # a call at M = 8192 takes milliseconds: fewer repetitions do
    timer = Timer(torch, reps=5, warmup=1)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(26)
    detail, res = [], {}
    t_phase = time.perf_counter()

    # -- the main path: train_loop, TRAIN_STEPS steps ----------------------
    want = train_launches(cfg, TRAIN_BATCH, TRAIN_SEQ)
    steps = []
    dc = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                    global_batch=TRAIN_BATCH)
    optc = OptConfig(peak_lr=1e-3, warmup_steps=1, decay_steps=TRAIN_STEPS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with train_watch(torch, steps):
        params, opt, losses = train_mod.train_loop(cfg, TRAIN_STEPS, dc,
                                                   optc=optc, device="cuda")
    total = time.perf_counter() - t0
    launched = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if len(steps) != TRAIN_STEPS:
        fail(f"train: {len(steps)} steps watched, {TRAIN_STEPS} run")
    if not losses[-1] < losses[0]:
        fail(f"train: the loss did not fall ({losses})")
    for i, s in enumerate(steps):
        if not s["finite"]:
            fail(f"train: step {i} has a gradient that is not finite")
        if not s["layout_kept"]:
            fail(f"train: step {i} changed a param's layout")
        if s["dense"] != want or s["other"]:
            fail(f"train: step {i} launched the dense kernel {s['dense']} "
                 f"times ({want} worked out from launch_rows) and "
                 f"{s['other']} other kernels")
    if launched["dense_matmul"] != TRAIN_STEPS * want or \
            sum(launched.values()) != launched["dense_matmul"]:
        fail(f"train: the run's launches {launched}, "
             f"{TRAIN_STEPS * want} dense expected")
    wq = params["blocks"]["l0"]["mixer"]["wq"]
    if wq.stride(-2) != 1 or opt["step"].item() != TRAIN_STEPS:
        fail("train: the trained linears are not column-major")
    step_s = statistics.median(s["s"] for s in steps[1:])
    rows = TRAIN_BATCH * TRAIN_SEQ
    res["train"] = {"steps": TRAIN_STEPS, "batch": TRAIN_BATCH,
                    "seq": TRAIN_SEQ, "losses": losses, "seconds": total,
                    "step_s": [s["s"] for s in steps],
                    "median_step_s": step_s, "tok_s": rows / step_s,
                    "peak_gib": peak, "launches": launched,
                    "launches_per_step": want,
                    "grad_norms": [s["grad_norm"] for s in steps]}
    say(f"train: qwen3-0.6b full width and depth, {TRAIN_STEPS} steps of "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens in {total:.1f} s; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; median step "
        f"{step_s * 1e3:.1f} ms ({rows / step_s:.0f} tok/s; first step "
        f"{steps[0]['s'] * 1e3:.1f} ms); peak allocated {peak:.2f} GiB; "
        f"dense kernel {want} launches a step (exact, every step; "
        f"{launched['dense_matmul']} in the run), every gradient finite, "
        f"every layout kept")

    # -- a traced step (under --profile) ------------------------------------
    if PROFILE:
        _train_traced_step(torch, cfg, optc, params, opt, res)
    else:
        say("train: the traced step runs under --profile")
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()

    # -- the kernel at the training shapes ---------------------------------
    res["kernel_rows"], res["kernel_layer"] = train_kernel_rows(
        torch, cfg, timer, gen, detail)

    # -- gradients against the plain versions -------------------------------
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    check = _train_batch(torch, cfg, TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ)
    p32 = params_to(lm.init_params(cfg32, seed=0, device=cuda), cuda)
    res["grads_f32"] = _grads_against_plain(
        torch, "train f32", p32, check, cfg32, TRAIN_TOL["loss_f32"],
        TRAIN_TOL["grad_f32"])
    del p32
    p16 = params_to(lm.init_params(cfg, seed=0, device=cuda), cuda)
    res["grads_bf16"] = _grads_against_plain(
        torch, "train bf16", p16, check, cfg, TRAIN_TOL["loss_bf16"])
    g32, g16 = res["grads_f32"], res["grads_bf16"]
    say(f"train: gradients through the kernels against the plain versions "
        f"({TRAIN_CHECK_BATCH} x {TRAIN_CHECK_SEQ} tokens, full width and "
        f"depth): f32 loss {g32['loss_rel']:.2e} relative (tol "
        f"{TRAIN_TOL['loss_f32']:.0e}), worst leaf {g32['grad_rel']:.2e} of "
        f"its range (tol {TRAIN_TOL['grad_f32']:.0e}), {g32['launches']} "
        f"dense launches; bf16 loss {g16['loss_rel']:.2e} (tol "
        f"{TRAIN_TOL['loss_bf16']:.0e})")

    # -- microbatches against the full batch --------------------------------
    big = _train_batch(torch, cfg, TRAIN_BATCH, TRAIN_MICRO_SEQ)
    optm = OptConfig(peak_lr=1e-3)
    opt0 = init_opt_state(p16)
    _, o1, m1 = make_train_step(cfg, optm)(p16, opt0, big)
    _, o2, m2 = make_train_step(cfg, optm, microbatch=TRAIN_MICRO)(
        p16, opt0, big)
    dl = abs(float(m1["loss"]) - float(m2["loss"]))
    worst = 0.0
    for a, b in zip(tree_leaves(o1["master"]), tree_leaves(o2["master"])):
        excess = ((a - b).abs() - (5e-5 + 2e-2 * b.abs())).max().item()
        worst = max(worst, excess)
    if not (dl < 1e-4 and worst <= 0):
        fail(f"train: microbatch {TRAIN_MICRO} against the full batch: loss "
             f"{dl:.2e} apart (tol 1e-4), master past rtol 2e-2 / atol "
             f"5e-5 by {worst:.2e}")
    res["microbatch"] = {"loss_diff": dl, "loss": float(m1["loss"])}
    say(f"train: microbatch {TRAIN_MICRO} of the batch of {TRAIN_BATCH} x "
        f"{TRAIN_MICRO_SEQ}: "
        f"loss {dl:.2e} from the full batch's (tol 1e-4), every master "
        "leaf within rtol 2e-2, atol 5e-5")
    del o1, o2, opt0, big
    gc.collect()
    torch.cuda.empty_cache()

    # -- restart against an unbroken run -----------------------------------
    cfg4 = dataclasses.replace(cfg, n_layers=TRAIN_RESTART_LAYERS)
    dc4 = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_RESTART_SEQ,
                     global_batch=TRAIN_RESTART_BATCH)
    opt4 = OptConfig(peak_lr=1e-3, warmup_steps=1, decay_steps=4)

    def run(steps, **kw):
        return train_mod.train_loop(cfg4, steps, dc4, optc=opt4,
                                    device="cuda", **kw)
    _, _, straight = run(4)
    with tempfile.TemporaryDirectory() as d:
        ck = CheckpointManager(d)
        t0 = time.perf_counter()
        run(2, ckpt=ck, ckpt_every=2)
        p_r, _, resumed = run(4, ckpt=ck)
        t_restart = time.perf_counter() - t0
    if not all(abs(a - b) <= 1e-5 + 1e-4 * abs(b)
               for a, b in zip(resumed, straight[2:])) or len(resumed) != 2:
        fail(f"train: restart {resumed} against the unbroken run's "
             f"{straight[2:]} (rtol 1e-4, atol 1e-5)")
    if p_r["blocks"]["l0"]["ffn"]["w_down"].stride(-2) != 1:
        fail("train: the restored linears are not column-major")
    res["restart"] = {"straight": straight, "resumed": resumed,
                      "seconds": t_restart}
    say(f"train: restart at {TRAIN_RESTART_LAYERS} layers: losses "
        f"{resumed} after a checkpoint and a restore, {straight[2:]} "
        f"unbroken (rtol 1e-4, atol 1e-5); save, restore and 4 steps "
        f"{t_restart:.1f} s")
    del p_r
    gc.collect()

    # -- past 4096 tokens ---------------------------------------------------
    long = _train_batch(torch, cfg, 1, TRAIN_LONG)
    want_long = train_launches(cfg, 1, TRAIN_LONG)
    res["long"] = {}
    opt16 = init_opt_state(p16)
    for impl in ("masked", "triangular"):
        watched, heads = [], []
        with train_watch(torch, watched, heads):
            train_mod.make_train_step(cfg, optm, attn_impl=impl)(
                p16, opt16, long)
        w = watched[0]
        if not w["finite"] or w["dense"] != want_long or w["other"]:
            fail(f"train: the {TRAIN_LONG}-token {impl} step: finite "
                 f"{w['finite']}, {w['dense']} dense launches "
                 f"({want_long} expected), {w['other']} others")
        res["long"][impl] = {"s": w["s"], "loss": w["loss"],
                             "head_grad_norm": float(heads[0])}
    m_, t_ = res["long"]["masked"], res["long"]["triangular"]
    dl = abs(m_["loss"] - t_["loss"]) / abs(m_["loss"])
    dh = abs(m_["head_grad_norm"] - t_["head_grad_norm"]) / \
        m_["head_grad_norm"]
    if not (dl <= TRAIN_TOL["long_loss"] and dh <= TRAIN_TOL["long_head"]):
        fail(f"train: the blocked schedules at {TRAIN_LONG} tokens: losses "
             f"{dl:.2e} apart, head-gradient norms {dh:.2e}")
    say(f"train: one step of 1 x {TRAIN_LONG} tokens (blocked attention): "
        f"masked {m_['s'] * 1e3:.0f} ms, triangular {t_['s'] * 1e3:.0f} ms; "
        f"losses {dl:.2e} apart (tol {TRAIN_TOL['long_loss']:.0e}), the "
        f"tied table's gradient norms {dh:.2e} (tol "
        f"{TRAIN_TOL['long_head']:.0e}); {want_long} dense launches each")
    del p16, opt16, long
    gc.collect()
    torch.cuda.empty_cache()
    packed = _model(torch, cfg, "bf16")
    eng = Engine(packed, cfg, device="cuda")
    toks = _train_batch(torch, cfg, 1, TRAIN_LONG)["tokens"]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    cache, logits = eng.prefill({"tokens": toks})
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    pre_launch = kernels.launch_counts()
    if int(cache["pos"]) != TRAIN_LONG or \
            pre_launch["sparse_matmul"] != 7 * cfg.n_layers or \
            pre_launch["dense_matmul"] != 1:
        fail(f"train: the {TRAIN_LONG}-token prefill: position "
             f"{int(cache['pos'])}, launches {pre_launch}")
    del cache
    with plain_kernels():
        cache, plain = eng.prefill({"tokens": toks})
    del cache
    err = _range_err(logits, plain)
    if not err <= ONESHOT_TOL["bf16"]:
        fail(f"train: the {TRAIN_LONG}-token one-shot prefill's logits "
             f"{err:.2e} of the plain range from the plain versions' (tol "
             f"{ONESHOT_TOL['bf16']})")
    res["long_prefill"] = {"seconds": t_pre, "logits_rel_range": err,
                           "launches": pre_launch}
    say(f"train: one-shot prefill of one {TRAIN_LONG}-token prompt (packed "
        f"bf16, blocked attention) in {t_pre:.2f} s; logits {err:.2e} of "
        f"the plain range (tol {ONESHOT_TOL['bf16']}); launches "
        f"{ {k: v for k, v in pre_launch.items() if v} }")
    del eng, packed
    gc.collect()
    torch.cuda.empty_cache()

    # -- every family --------------------------------------------------------
    res["families"] = {}
    for name in TRAIN_FAMILIES:
        cf = dataclasses.replace(get_config(name).reduced(),
                                 param_dtype="float32",
                                 compute_dtype="float32")
        pf = params_to(lm.init_params(cf, seed=0, device=cuda), cuda)
        bf = _train_batch(torch, cf, TRAIN_CHECK_BATCH, 32, gen=gen)
        r = _grads_against_plain(torch, f"train {name}", pf, bf, cf,
                                 TRAIN_TOL["loss_f32"], TRAIN_TOL["grad_f32"])
        res["families"][name] = r
        say(f"train: {name} reduced at f32, one step: loss "
            f"{r['loss_rel']:.2e} relative from the plain versions' (tol "
            f"{TRAIN_TOL['loss_f32']:.0e}), worst leaf {r['grad_rel']:.2e} "
            f"(tol {TRAIN_TOL['grad_f32']:.0e}), {r['launches']} dense "
            "launches")
    res["seconds"] = time.perf_counter() - t_phase
    return res, detail


# ---------------------------------------------------------------------------
# the serving mesh (the seventeenth slice)
# ---------------------------------------------------------------------------

MESH_WORLD = 4              # ranks of the one spawn, sharing the card (gloo)
MESH_SHAPES = ((4, 1), (2, 2), (1, 4))      # (data, model)
MESH_PROMPT = 200           # wave 1: SLOTS lockstep prompts of this length
MESH_WAVE1_TOKENS = 24
MESH_WAVE2 = 6              # wave 2: request i has 115 + 3 i prompt tokens
MESH_MAX_TOKENS = 512       # and 20 - 2 i new ones (5 tails fill: refreezes)
MESH_SPEC_K = 3
MESH_PAGED_REQUESTS = 8     # on the shared 512-token prefix, int8 weights
MESH_PAGED_TOKENS = 16
MESH_PAGED_MAX_TOKENS = 1024
MESH_CP_PROMPT = 4096       # the one-shot context-parallel decode
MESH_CP_TICKS = 4
MESH_RANK_THREADS = 1       # torch CPU threads a rank (the host's 8 cores)
# kernels each driven mesh path must launch on every rank
MESH_PATHS = {
    "flat": ("sparse_gemv", "sparse_matmul", "sparse_decode_attention_fused",
             "dense_matmul"),
    "spec": ("sparse_matmul", "sparse_decode_attention_fused",
             "dense_matmul"),
    "paged_int8": ("sparse_matmul_int8", "sparse_decode_attention_fused_paged",
                   "dense_matmul"),
    "cp": ("sparse_decode_attention_partial", "sparse_gemv", "dense_matmul"),
}


def _mesh_label(shape):
    return f"{shape[0]}x{shape[1]}"


def mesh_prompts(cfg):
    """The reference worker's two waves at full width: SLOTS lockstep
    prompts, then MESH_WAVE2 staggered ones (admissions, evictions, ragged
    prompts, tails that fill and refreeze)."""
    import numpy as np
    toks = np.random.default_rng(7).integers(0, cfg.vocab,
                                             (SLOTS, MESH_PROMPT))
    wave1 = [(row.tolist(), MESH_WAVE1_TOKENS) for row in toks]
    wave2 = [(toks[i % SLOTS][:115 + 3 * i].tolist(), 20 - 2 * i)
             for i in range(MESH_WAVE2)]
    return [wave1, wave2]


def mesh_drive(torch, eng, waves):
    """Serve the waves (each submitted whole, then run to the end), every
    tick timed with a sync after it; the kernel counters and the
    collective statistics zeroed before and read after."""
    from repro_torch import kernels
    from repro_torch.distributed.sharding import STATS, reset_stats
    from repro_torch.serving import SamplingParams
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    reset_stats()
    ticks, out = [], []
    t0 = time.perf_counter()
    for wave in waves:
        rids = [eng.submit(p, SamplingParams(max_new_tokens=n))
                for p, n in wave]
        while not eng.scheduler.done():
            t = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            ticks.append(time.perf_counter() - t)
        eng.quiesce()
        fin = eng.scheduler.finished
        out.append([list(fin[r].output().token_ids) for r in rids])
    dt = time.perf_counter() - t0
    n_tok = sum(len(t) for w in out for t in w)
    n = max(len(ticks), 1)
    return {"tokens": out, "seconds": dt, "tok_s": n_tok / dt,
            "ticks": len(ticks), "refreezes": eng.replay_counts().get(
                "refreeze", 0),
            "tick_ms_p50": statistics.median(ticks) * 1e3,
            "tick_ms_p90": sorted(ticks)[int(0.9 * (len(ticks) - 1))] * 1e3,
            "launches": kernels.launch_counts(),
            "collectives_per_tick": {"calls": STATS["calls"] / n,
                                     "bytes": STATS["bytes"] / n,
                                     "seconds": STATS["seconds"] / n,
                                     "staged": STATS["staged"] / n}}


def _mesh_engine(cfg, params, mesh=None, spec_k=0, paged=False):
    from repro_torch.serving import ContinuousEngine, SpecConfig
    return ContinuousEngine(
        params, cfg, slots=SLOTS,
        max_tokens=MESH_PAGED_MAX_TOKENS if paged else MESH_MAX_TOKENS,
        prefill_chunk=PREFILL_CHUNK, device="cuda", paged=paged,
        spec=SpecConfig(k=spec_k) if spec_k else None, mesh=mesh,
        graphs=False)


def mesh_cp_logits(torch, cfg, params, toks, forced=None, ctx=None):
    """The one-shot engine on ``toks`` (one MESH_CP_PROMPT-token prompt),
    then MESH_CP_TICKS decode steps fed ``forced`` (the mesh ranks' greedy
    tokens) or, without it, its own greedy tokens: the f32 decode logits
    and the tokens fed.  ``ctx`` with ``cfg.cp_decode`` decodes
    context-parallel; the counters are zeroed before the decode."""
    from repro_torch import kernels
    from repro_torch.models import lm
    from repro_torch.serving import Engine
    eng = Engine(params, cfg, device="cuda", ctx=ctx)
    cache, logits = eng.prefill({"tokens": toks})
    tok = logits.argmax(-1) if forced is None else forced[0]
    fed, rows = [tok.cpu()], []
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    for i in range(MESH_CP_TICKS):
        logits, cache = lm.forward_decode(eng.params, cache, tok[:, None],
                                          cfg, ctx)
        rows.append(logits.float().cpu())
        tok = logits.argmax(-1) if forced is None else forced[i + 1]
        fed.append(tok.cpu())
    torch.cuda.synchronize()
    return torch.stack(rows), torch.stack(fed), kernels.launch_counts()


def _quiet_model(torch, cfg, mode):
    """``_model`` without its progress line (four ranks build it)."""
    from repro_torch.core.convert import convert_concrete
    from repro_torch.models import lm
    params = lm.init_params(cfg, seed=0, device="cuda")
    return convert_concrete(params, lm.model_specs(cfg), cfg, mode=mode,
                            device="cuda")


def mesh_rank(rank, world, spec):
    """One rank of the mesh phase (gloo, sharing the card): the same
    traffic through ``ContinuousEngine(mesh=...)`` on every mesh of
    MESH_SHAPES, speculation and paged int8 at (2, 2), and the
    context-parallel one-shot decode at (1, 4).  Returns what it served,
    its timings and its launches per path."""
    import dataclasses
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(MESH_RANK_THREADS)
    from repro_torch.configs import get_config
    from repro_torch.distributed import ShardCtx, default_rules
    from repro_torch.launch.mesh import make_mesh
    dev = torch.cuda.current_device()
    cfg = get_config("qwen3-0.6b")
    params = _quiet_model(torch, cfg, "bf16")
    waves = spec["waves"]
    out = {"flat": {}}
    meshes = {shape: make_mesh(shape, ("data", "model"), dev)
              for shape in MESH_SHAPES}
    for shape, mesh in meshes.items():
        eng = _mesh_engine(cfg, params, mesh)
        out["flat"][_mesh_label(shape)] = mesh_drive(torch, eng, waves)
        del eng
    eng = _mesh_engine(cfg, params, meshes[(2, 2)], spec_k=MESH_SPEC_K)
    out["spec"] = mesh_drive(torch, eng, waves)
    out["spec"]["accepted"] = int(eng.spec_hist[1:].sum())
    del eng
    cp = dataclasses.replace(cfg, cp_decode=True)
    cp32, p32 = _widened(torch, cp, params)
    ctx = ShardCtx(meshes[(1, 4)], default_rules(False, cp))
    toks = torch.tensor(spec["cp_toks"], device="cuda")
    out["cp"] = {}
    for dtype, (c, p) in (("bf16", (cp, params)), ("f32", (cp32, p32))):
        logits, fed, counts = mesh_cp_logits(torch, c, p, toks, ctx=ctx)
        out["cp"][dtype] = {"logits": logits, "fed": fed,
                            "launches": counts}
    del params, p32
    torch.cuda.empty_cache()
    p8 = _quiet_model(torch, cfg, "int8")
    eng = _mesh_engine(cfg, p8, meshes[(2, 2)], paged=True)
    out["paged_int8"] = mesh_drive(torch, eng, spec["paged"])
    out["paged_int8"]["trie"] = len(eng._trie)
    return out


def _mesh_head_gate(torch, cfg, gen):
    """The local heads' launch equals those heads of the full launch, bit
    for bit (flat, paged, the partial), for every model shard of the mesh
    phase: a mesh rank attends over its KV heads alone."""
    from repro_torch.kernels.sparse_attention import (
        sparse_decode_attention_fused, sparse_decode_attention_fused_paged,
        sparse_decode_attention_partial)
    from repro_torch.serving import CachePool
    hkv, hd, g = cfg.n_kv, cfg.hd, cfg.padded_heads // cfg.n_kv
    bs, sm, sb, tp = 128, 1.0 / cfg.hd ** 0.5, 7, cfg.kv_tail
    pool = CachePool.build(cfg, SLOTS, sb * bs, bs=bs, device="cuda")
    (kbm, kvl, vbm, vvl), _ = _flat_cache(torch, cfg, gen, SLOTS, sb, bs,
                                          pool)
    arena = _paged_arena(torch, cfg, gen, SLOTS * sb, bs, pool)
    table = torch.randperm(SLOTS * sb, generator=gen, device="cuda").reshape(
        SLOTS, sb).to(torch.int32)
    tails = [torch.randn((SLOTS, hkv, tp, hd), generator=gen,
                         device="cuda").to(torch.bfloat16) for _ in range(2)]
    nb = torch.tensor([0, 3, 7, 5], dtype=torch.int32, device="cuda")
    tl = torch.tensor([1, 50, 0, 127], dtype=torch.int32, device="cuda")
    q = torch.randn((SLOTS, hkv, g, hd), generator=gen,
                    device="cuda").to(torch.bfloat16)
    h = lambda t, a, b: t[:, a:b].contiguous()
    cases = {
        "sparse_decode_attention_fused": lambda a, b: (
            sparse_decode_attention_fused(
                h(q, a, b), h(kbm, a, b), h(kvl, a, b), h(vbm, a, b),
                h(vvl, a, b), h(tails[0], a, b), h(tails[1], a, b), bs, sm,
                nb, tl, g),),
        "sparse_decode_attention_fused_paged": lambda a, b: (
            sparse_decode_attention_fused_paged(
                h(q, a, b), *(x[:, a:b].contiguous() for x in arena), table,
                h(tails[0], a, b), h(tails[1], a, b), bs, sm, nb, tl, g),),
        "sparse_decode_attention_partial": lambda a, b:
            sparse_decode_attention_partial(
                h(q, a, b), h(kbm, a, b), h(kvl, a, b), h(vbm, a, b),
                h(vvl, a, b), bs, sm, nb)}
    shards = sorted({shape[1] for shape in MESH_SHAPES} - {1})
    for name, fn in cases.items():
        full = fn(0, hkv)
        for n in shards:
            w = hkv // n
            for i in range(n):
                part = fn(i * w, (i + 1) * w)
                for f, p in zip(full, part):
                    if not torch.equal(f[:, i * w:(i + 1) * w], p):
                        fail(f"{name}: the launch over KV heads "
                             f"[{i * w}, {(i + 1) * w}) differs from those "
                             "heads of the full launch")
    say(f"mesh: the flat, paged and partial attention over each model "
        f"shard's KV heads ({', '.join(f'{hkv // n} of {hkv}' for n in shards)}"
        f") are bit-equal to those heads of the full launch")
    return {"model_shards": shards}


def mesh_phase(torch):
    """The serving mesh: full-width, full-depth Qwen3-0.6B (bf16, 50 %
    sparse, KV 30 % / 50 %, SLOTS slots, chunk PREFILL_CHUNK) served by one
    spawn of MESH_WORLD gloo ranks sharing the card, on the meshes
    MESH_SHAPES, held token for token against the one-rank eager engine on
    the same card; speculation (k = 3) and paged int8 on a shared 512-token
    prefix at (2, 2); the context-parallel one-shot decode of a
    MESH_CP_PROMPT-token prompt over the model axis at (1, 4) held to the
    one-rank kernels' logits (bf16 and f32).  Every rank's launches are
    counted per path."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import spawn
    t_phase = time.perf_counter()
    cfg = get_config("qwen3-0.6b")
    gen = torch.Generator(device="cuda").manual_seed(17)
    res = {"head_gate": _mesh_head_gate(torch, cfg, gen)}
    waves = mesh_prompts(cfg)
    paged = [[(p, MESH_PAGED_TOKENS)
              for p in _shared_prompts(cfg, MESH_PAGED_REQUESTS)]]
    cp_toks = torch.randint(0, cfg.vocab, (1, MESH_CP_PROMPT), generator=gen,
                            device="cuda")
    # the one-rank references first: the ranks then have the card alone
    params = _model(torch, cfg, "bf16")
    one = {"flat": mesh_drive(torch, _mesh_engine(cfg, params), waves)}
    eng = _mesh_engine(cfg, params, spec_k=MESH_SPEC_K)
    one["spec"] = mesh_drive(torch, eng, waves)
    one["spec"]["accepted"] = int(eng.spec_hist[1:].sum())
    del eng
    p8 = _model(torch, cfg, "int8")
    one["paged_int8"] = mesh_drive(torch, _mesh_engine(cfg, p8, paged=True),
                                   paged)
    del p8
    torch.cuda.empty_cache()
    say(f"mesh: one-rank eager references (flat "
        f"{one['flat']['tok_s']:.1f} tok/s, spec k={MESH_SPEC_K} "
        f"{one['spec']['tok_s']:.1f} tok/s, paged int8 "
        f"{one['paged_int8']['tok_s']:.1f} tok/s)")
    t0 = time.perf_counter()
    recs = spawn(mesh_rank, MESH_WORLD, ({
        "waves": waves, "paged": paged, "cp_toks": cp_toks.cpu().tolist()},),
        backend="gloo", device="cuda", timeout=900)
    spawn_s = time.perf_counter() - t0
    # the one-rank kernels' decode logits, teacher-forced with the tokens
    # rank 0's context-parallel decode fed itself (every rank feeds the same)
    cp = dataclasses.replace(cfg, cp_decode=True)
    cp32, p32 = _widened(torch, cp, params)
    one["cp"] = {}
    for dtype, (c, p) in (("bf16", (cp, params)), ("f32", (cp32, p32))):
        fed = recs[0]["cp"][dtype]["fed"]
        if any(not torch.equal(r["cp"][dtype]["fed"], fed) for r in recs):
            fail(f"mesh cp {dtype}: the ranks' context-parallel decodes fed "
                 "different tokens")
        logits, _, counts = mesh_cp_logits(torch, c, p, cp_toks,
                                           fed.cuda())
        one["cp"][dtype] = {"logits": logits, "launches": counts}
    del params, p32
    torch.cuda.empty_cache()
    res["spawn_s"] = spawn_s
    # gates: tokens, accepts, logits, launches
    for path in ("flat", "spec", "paged_int8"):
        want = one[path]["tokens"]
        for rank, rec in enumerate(recs):
            runs = rec[path].items() if path == "flat" else \
                [(_mesh_label((2, 2)), rec[path])]
            for label, run in runs:
                if run["tokens"] != want:
                    fail(f"mesh {path} {label}: rank {rank}'s greedy tokens "
                         "differ from the one-rank eager engine's")
    if one["spec"]["accepted"] <= 0 or any(
            r["spec"]["accepted"] <= 0 for r in recs):
        fail("mesh spec: no draft accepted")
    if one["flat"]["refreezes"] <= 0 or any(
            run["refreezes"] <= 0 for r in recs for run in r["flat"].values()):
        fail("mesh flat: the waves refroze no tail")
    cp_err = {}
    for dtype, tol in ONESHOT_TOL.items():
        ref = one["cp"][dtype]["logits"]
        errs, top1 = [], 0
        for rank, rec in enumerate(recs):
            got = rec["cp"][dtype]["logits"]
            for t in range(MESH_CP_TICKS):
                errs.append(_range_err(got[t], ref[t]))
                top2 = ref[t, 0].topk(2).values
                clear = (top2[0] - top2[1]) / (ref[t].max() - ref[t].min())
                if clear > TOP1_CLEAR:
                    top1 += 1
                    if got[t, 0].argmax() != ref[t, 0].argmax():
                        fail(f"mesh cp {dtype}: rank {rank} tick {t}: top-1 "
                             "differs where the one-rank margin is clear")
        cp_err[dtype] = max(errs)
        if not cp_err[dtype] <= tol:
            fail(f"mesh cp {dtype}: context-parallel logits differ from the "
                 f"one-rank kernels' by {cp_err[dtype]:.3e} of the range "
                 f"(tol {tol})")
        res[f"cp_top1_gated_{dtype}"] = top1
    mesh_launches = []
    for rank, rec in enumerate(recs):
        total = {}
        paths = {**{f"flat {k}": v for k, v in rec["flat"].items()},
                 "spec": rec["spec"], "paged_int8": rec["paged_int8"],
                 "cp": {"launches": rec["cp"]["bf16"]["launches"]}}
        for label, run in paths.items():
            for name in MESH_PATHS[label.split()[0]]:
                if run["launches"][name] <= 0:
                    fail(f"mesh {label}: rank {rank} never launched {name}")
            for k, v in run["launches"].items():
                total[k] = total.get(k, 0) + v
        for k, v in rec["cp"]["f32"]["launches"].items():
            total[k] = total.get(k, 0) + v
        mesh_launches.append(total)
    res.update({"one_rank": {k: {kk: vv for kk, vv in v.items()
                                 if kk not in ("tokens", "logits", "fed")}
                             for k, v in one.items() if k != "cp"},
                "cp_rel_range": cp_err, "launches": mesh_launches})
    res["ranks"] = [{path: ({lab: {k: v for k, v in run.items()
                                   if k != "tokens"}
                             for lab, run in rec[path].items()}
                            if path == "flat" else
                            {k: v for k, v in rec[path].items()
                             if k != "tokens"})
                     for path in ("flat", "spec", "paged_int8")}
                    for rec in recs]
    for label in [_mesh_label(s) for s in MESH_SHAPES]:
        r0 = recs[0]["flat"][label]
        c = r0["collectives_per_tick"]
        say(f"mesh {label}: tokens identical to one rank on all "
            f"{MESH_WORLD} ranks; rank 0 {r0['tok_s']:.1f} tok/s over "
            f"{r0['ticks']} ticks, {r0['refreezes']} refreezes (one rank "
            f"eager {one['flat']['tok_s']:.1f}), "
            f"tick p50 {r0['tick_ms_p50']:.1f} ms p90 {r0['tick_ms_p90']:.1f} "
            f"ms; a tick's collectives {c['calls']:.1f} calls, "
            f"{c['bytes'] / 1e3:.1f} kB, {c['seconds'] * 1e3:.2f} ms "
            f"({c['staged']:.1f} staged through host memory)")
    for path in ("spec", "paged_int8"):
        r0 = recs[0][path]
        c = r0["collectives_per_tick"]
        say(f"mesh 2x2 {path}: tokens identical to one rank on all ranks"
            + (f", {r0['accepted']} drafts accepted" if path == "spec"
               else f", trie {r0['trie']} blocks")
            + f"; rank 0 {r0['tok_s']:.1f} tok/s (one rank eager "
            f"{one[path]['tok_s']:.1f}), tick p50 {r0['tick_ms_p50']:.1f} ms;"
            f" a tick's collectives {c['calls']:.1f} calls, "
            f"{c['bytes'] / 1e3:.1f} kB, {c['seconds'] * 1e3:.2f} ms")
    say(f"mesh 1x4 cp: one-shot decode of a {MESH_CP_PROMPT}-token prompt "
        f"over the model axis, {MESH_CP_TICKS} ticks: logits within "
        f"{cp_err['bf16']:.2e} (bf16, tol {ONESHOT_TOL['bf16']}) and "
        f"{cp_err['f32']:.2e} (f32, tol {ONESHOT_TOL['f32']}) of the range "
        f"of the one-rank kernels'; top-1 gated at "
        f"{res['cp_top1_gated_bf16']} + {res['cp_top1_gated_f32']} clear "
        f"ticks")
    res["seconds"] = time.perf_counter() - t_phase
    for rank, total in enumerate(mesh_launches):
        say(f"mesh: rank {rank} launched every kernel of each mesh path; "
            f"its launches over the phase "
            f"{ {k: v for k, v in total.items() if v} }")
    say(f"mesh: passed (spawn of {MESH_WORLD} ranks {spawn_s:.1f} s, phase "
        f"{res['seconds']:.1f} s)")
    return res


# ---------------------------------------------------------------------------
# the training mesh (the eighteenth slice)
# ---------------------------------------------------------------------------

TM_SHAPES = ((2, 2), (4, 1), (1, 4))        # (data, model)
TM_STEPS, TM_BATCH, TM_SEQ = 3, 8, 256      # f32 and bf16 runs, each mesh
TM_ROWS = 512           # tied-table rows sampled from each model shard
TM_STRIDE = 97          # of those slices, every TM_STRIDE-th element
TM_MOE = "phi3.5-moe-42b-a6.6b"             # layer 0's MoE, full width
TM_MOE_BATCH, TM_MOE_SEQ, TM_MOE_SAMPLE = 4, 256, 64
# losses (rtol, atol: the reference test's own bar); a gradient leaf of
# the first step (of its range: the kernels sum f32 products in other
# orders, as TRAIN_TOL["grad_f32"]); the MoE's output and input gradient
# (of the range) and its expert gradients (of each leaf's range)
TM_TOL = {"loss": (1e-4, 1e-4), "grad": 1e-3, "moe_out": 1e-5,
          "moe_w": 1e-3}
TM_EPS = 1e-8           # OptConfig().eps: the AdamW bar's |g| threshold


def _f32(cfg):
    import dataclasses
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def _tm_rows(v: int, m: int):
    """The tied-table rows of the sample: the first TM_ROWS of each of the
    ``m`` model shards of a ``v``-row table."""
    return [s * (v // m) + i for s in range(m) for i in range(TM_ROWS)]


def _tm_sample(torch, tree, m, path=""):
    """The sample of a full (one-rank) tree a mesh of model size ``m``
    returns: of layers 0 and -1 of every layer-stacked leaf, the tied
    table's ``_tm_rows`` and every other leaf whole, every TM_STRIDE-th
    element in row-major order; on the host."""
    if isinstance(tree, dict):
        return {k: _tm_sample(torch, v, m, f"{path}/{k}")
                for k, v in tree.items()}
    if path.startswith("/blocks"):
        tree = tree[[0, -1]]
    elif path == "/embed/tok":
        tree = tree[_tm_rows(tree.shape[0], m)]
    return tree.detach().reshape(-1)[::TM_STRIDE].float().cpu()


def _tm_local_sample(torch, tree, pspecs, mesh, data_sum=False, path=""):
    """``_tm_sample`` of a placed tree, cut from this rank's blocks and
    gathered over the model axis (every rank takes part; ``data_sum``
    sums gradient shares over the data axis first)."""
    from repro_torch.distributed.sharding import all_gather, all_reduce
    if isinstance(tree, dict):
        return {k: _tm_local_sample(torch, v, pspecs[k], mesh, data_sum,
                                    f"{path}/{k}") for k, v in tree.items()}
    t = tree.detach()
    if path.startswith("/blocks"):
        t = t[[0, -1]]
    elif path == "/embed/tok":
        t = t[:TM_ROWS]
    t = t.float().contiguous()
    if data_sum:
        t = all_reduce(t, mesh, ("data",))
    for dim, entry in enumerate(pspecs):
        t = all_gather(t.contiguous(), mesh, entry, dim)
    return t.reshape(-1)[::TM_STRIDE].cpu()


def tm_run(torch, cfg, dc, optc, mesh, ckpt_dir=None, ckpt_every=0,
           sample=False):
    """``launch.train.train_loop`` on ``mesh`` (the main path), every step
    timed between syncs with its collectives; with ``sample``, the first
    step's gradient (summed over data) and params sampled; the dense
    kernel's launches zeroed before and read after."""
    from repro_torch import kernels
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed import ShardCtx, default_rules
    from repro_torch.distributed.sharding import (STATS, reset_stats,
                                                  zero1_dim)
    from repro_torch.launch import train as train_mod
    from repro_torch.models.module import tree_leaves
    from repro_torch.train import step as step_mod
    from repro_torch.train.step import train_specs
    pspecs, zspecs = train_specs(cfg, ShardCtx(mesh, default_rules(False,
                                                                   cfg)))
    make, vg = train_mod.make_train_step, step_mod.value_and_grad
    steps, first = [], {}

    def quiet(fn):
        saved = dict(STATS)
        out = fn()
        STATS.update(saved)
        return out

    def watched_vg(*a, **k):
        loss, g = vg(*a, **k)
        if sample and "grads" not in first:
            first["grads"] = quiet(lambda: _tm_local_sample(
                torch, g, pspecs, mesh, data_sum=True))
        return loss, g

    def watched_make(*a, **k):
        fn = make(*a, **k)

        def step(params, opt, batch):
            torch.cuda.synchronize()
            reset_stats()
            t0 = time.perf_counter()
            out = fn(params, opt, batch)
            torch.cuda.synchronize()
            steps.append({"s": time.perf_counter() - t0,
                          "loss": float(out[2]["loss"]),
                          "grad_norm": float(out[2]["grad_norm"]),
                          "lr": float(out[2]["lr"]),
                          "collectives": dict(STATS)})
            if sample and "params" not in first:
                first["params"] = quiet(lambda: _tm_local_sample(
                    torch, out[0], pspecs, mesh))
            return out
        return step
    ck = CheckpointManager(ckpt_dir) if ckpt_dir else None
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with patched(train_mod, "make_train_step", watched_make), \
            patched(step_mod, "value_and_grad", watched_vg):
        params, opt, losses = train_mod.train_loop(
            cfg, TM_STEPS, dc, ckpt=ck, ckpt_every=ckpt_every, mesh=mesh,
            optc=optc)
    torch.cuda.synchronize()
    launched = kernels.launch_counts()
    nbytes, wrong = 0, []
    for i, (mst, p, ps, zs) in enumerate(zip(
            tree_leaves(opt["master"]), tree_leaves(params),
            tree_leaves(pspecs), tree_leaves(zspecs))):
        nbytes += 3 * mst.numel() * 4
        dim, axes = zero1_dim(ps, zs)
        want = p.numel() // (mesh.shape["data"] if dim is not None else 1)
        if mst.numel() != want:
            wrong.append(i)
    import torch.distributed as dist
    # the samples are whole on every rank: rank 0 returns them
    return {"losses": losses, "steps": steps,
            "first": first if dist.get_rank() == 0 else None,
            "seconds": time.perf_counter() - t0, "launches": launched,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "state_bytes": nbytes, "zero1_wrong": wrong,
            "coord": {a: mesh.coordinate(a) for a in mesh.axis_names}}


def tm_compressed(torch, cfg, dc, mesh):
    """``make_compressed_grads`` at ``mesh`` (data only) in both schemes
    from the launcher's params: the loss, this rank's own gradient (its
    sample and every leaf's largest magnitude, as the reduction saw it),
    the samples of ``g_hat`` and of this rank's error row, the seconds and
    the collectives."""
    from repro_torch.data.pipeline import sharded_batch
    from repro_torch.distributed import ShardCtx, default_rules, place
    from repro_torch.distributed.sharding import STATS, reset_stats
    from repro_torch.models import lm
    from repro_torch.models.module import tree_leaves, tree_map
    from repro_torch.serving.engine import params_to
    from repro_torch.train import init_dp_error_state, make_compressed_grads
    from repro_torch.train import step as step_mod
    from repro_torch.train.step import train_specs
    dev = mesh.device
    pspecs, _ = train_specs(cfg, ShardCtx(mesh, default_rules(False, cfg)))
    params = params_to(place(lm.init_params(cfg, seed=cfg.n_layers,
                                            device=dev), pspecs, mesh), dev)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in sharded_batch(dc, 0, mesh).items()}
    vg, seen = step_mod.value_and_grad, {}

    def watched_vg(*a, **k):
        loss, g = vg(*a, **k)
        seen.update(grads=_tm_sample(torch, g, 1),
                    amax=[float(t.abs().max()) for t in tree_leaves(g)])
        return loss, g
    out = {}
    for scheme in ("bf16", "int8"):
        fn = make_compressed_grads(cfg, scheme, mesh=mesh)
        torch.cuda.synchronize()
        reset_stats()
        t0 = time.perf_counter()
        with patched(step_mod, "value_and_grad", watched_vg):
            loss, g_hat, err = fn(params, init_dp_error_state(params), batch)
        torch.cuda.synchronize()
        out[scheme] = {"loss": float(loss),
                       "seconds": time.perf_counter() - t0,
                       "collectives": dict(STATS), **seen,
                       "g_hat": _tm_sample(torch, g_hat, 1),
                       "err": _tm_sample(torch, tree_map(lambda e: e[0],
                                                         err), 1)}
        del g_hat, err
    return out


def _tm_moe_inputs(torch, mcfg, dev):
    from repro_torch.models import moe
    from repro_torch.models import module as mod
    gen = torch.Generator(device=dev).manual_seed(28)
    x = torch.randn((TM_MOE_BATCH, TM_MOE_SEQ, mcfg.d_model), generator=gen,
                    device=dev)
    r = torch.randn(x.shape, generator=gen, device=dev)
    return mod.initialize(moe.moe_specs(mcfg), 24, dev), x, r


def _tm_moe_grads(torch, fn, p, x, r):
    """``fn(p, x)`` and the gradients of ``sum(fn(p, x) * r)`` in ``x``
    and every leaf of ``p``; the forward and backward's seconds."""
    from repro_torch.models.module import tree_map
    p = tree_map(lambda t: t.detach().requires_grad_(), p)
    x = x.detach().clone().requires_grad_()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(p, x)
    (out * r).sum().backward()
    torch.cuda.synchronize()
    return (out.detach(), x.grad, tree_map(lambda t: t.grad, p),
            time.perf_counter() - t0)


def tm_moe(torch, mesh, ep):
    """Layer 0's MoE of TM_MOE at full width, f32, forward and backward:
    expert-parallel (``ep``; 4 experts a rank at (4, 1)) or with ``d_ff``
    over the model axis; this rank's rows of the output and the input
    gradient, the router's gradient, every expert leaf's gradient norm and
    its first TM_MOE_SAMPLE rows."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.distributed import (ShardCtx, default_rules, place,
                                         tree_param_specs)
    from repro_torch.models import moe
    from repro_torch.models import module as mod
    # the layer alone, FSDP off (cfg.fsdp under a mesh is ROADMAP item 4)
    mcfg = dataclasses.replace(_f32(get_config(TM_MOE)), ep_moe=ep,
                               fsdp=False)
    dev = mesh.device
    full, x, r = _tm_moe_inputs(torch, mcfg, dev)
    ctx = ShardCtx(mesh, default_rules(False, mcfg))
    specs = moe.moe_specs(mcfg)
    pspecs = tree_param_specs(ctx, specs, mod.abstract(specs))
    p = place(full, pspecs, mesh)
    del full
    rows = TM_MOE_BATCH // mesh.shape["data"]
    r0 = mesh.coordinate("data") * rows
    out, gx, gp, dt = _tm_moe_grads(
        torch, lambda pp, xx: moe.moe_apply(pp, xx, mcfg, ctx), p,
        x[r0:r0 + rows], r[r0:r0 + rows])
    return {"rows": (r0, rows), "seconds": dt,
            "coord": {a: mesh.coordinate(a) for a in mesh.axis_names},
            "specs": {k: tuple(pspecs[k]) for k in ("w_gate", "w_up",
                                                     "w_down")},
            "out": out.cpu(), "gx": gx.cpu(), "router": gp["router"].cpu(),
            "norms": {k: float(gp[k].double().square().sum())
                      for k in ("w_gate", "w_up", "w_down")},
            "sample": {k: gp[k][:, :TM_MOE_SAMPLE].cpu()
                       for k in ("w_gate", "w_up", "w_down")}}


@contextlib.contextmanager
def held_dense(torch, held):
    """Every call of the dense kernel (``ops._dense_kernel``, under
    autograd too) also runs its plain version on the same inputs; the
    largest error over the largest plain output stays on the device, read
    once when the block ends (no sync a call), into ``held`` with the
    calls."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.dense_matmul import dense_matmul_plain
    kernel = ops._dense_kernel
    worst = [torch.zeros((), device="cuda")]

    def launch(x, w_nk, out_dtype=None):
        out = kernel(x, w_nk, out_dtype)
        ref = dense_matmul_plain(x, w_nk, out_dtype).float()
        err = (out.float() - ref).abs().max() / ref.abs().max().clamp(
            min=1e-30)
        worst[0] = torch.maximum(worst[0], err)
        held["calls"] = held.get("calls", 0) + 1
        return out
    try:
        with patched(ops, "_dense_kernel", launch):
            yield
    finally:
        held["max_rel_err"] = float(worst[0])


def train_mesh_rank(rank, world, spec):
    """One rank of the train_mesh phase (gloo, sharing the card): the f32
    runs on every mesh of TM_SHAPES (the (2, 2) run saving a checkpoint
    after two steps), the restore onto (1, 4), the bf16 run at (2, 2),
    every dense launch held to the plain version; then the compressed
    gradients at (4, 1) and the MoE layer, expert-parallel at (4, 1) and
    tensor-parallel at (1, 4)."""
    import torch
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(MESH_RANK_THREADS)
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import OptConfig
    dev = torch.cuda.current_device()
    cfg = get_config("qwen3-0.6b")
    cfg32 = _f32(cfg)
    dc = DataConfig(vocab=cfg.vocab, seq_len=TM_SEQ, global_batch=TM_BATCH)
    optc = OptConfig(peak_lr=1e-3, warmup_steps=1, decay_steps=TM_STEPS)
    meshes = {shape: make_mesh(shape, ("data", "model"), dev)
              for shape in TM_SHAPES}
    runs = [("f32 2x2", cfg32, (2, 2), dict(ckpt_dir=spec["ckpt"],
                                            ckpt_every=2, sample=True)),
            ("f32 4x1", cfg32, (4, 1), dict(sample=True)),
            ("f32 1x4", cfg32, (1, 4), dict(sample=True)),
            ("elastic 1x4", cfg32, (1, 4), dict(ckpt_dir=spec["ckpt"])),
            ("bf16 2x2", cfg, (2, 2), {})]
    out = {"runs": {}, "seconds": {"start": time.perf_counter() - t0}}

    def timed(key, fn, *args, **kw):
        t = time.perf_counter()
        out[key] = fn(*args, **kw)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        out["seconds"][key] = time.perf_counter() - t
    for label, c, shape, kw in runs:
        held = {}
        with held_dense(torch, held):
            out["runs"][label] = tm_run(torch, c, dc, optc, meshes[shape],
                                        **kw)
        out["runs"][label]["held"] = held
        out["seconds"][label] = out["runs"][label]["seconds"]
    timed("compressed", tm_compressed, torch, cfg32, dc, meshes[(4, 1)])
    timed("moe_ep", tm_moe, torch, meshes[(4, 1)], ep=True)
    timed("moe_tp", tm_moe, torch, meshes[(1, 4)], ep=False)
    return out


def mesh_kernel_rows(torch, cfg, timer, gen, detail):
    """The dense kernel at the shard shapes of the training mesh (f32, as
    the phase's f32 runs give it): for model 2 and 4, each distinct (K, N)
    of a layer's linears with the model axis cut (``wq``, ``wk`` / ``wv``,
    ``w_gate`` / ``w_up`` over N; ``wo``, ``w_down`` over K) and the tied
    table's shard, at the rank's rows (TM_BATCH * TM_SEQ over the data
    axis), through ``dense_rows``; each row with its launches a step.
    Returns the rows and the (1, 4) layer's sum."""
    from repro_torch.kernels.dense_matmul import launch_rows
    out, layer = {}, {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                      "bound_ms": 0.0, "max_abs_err": 0.0}
    lin = _layer_linears(cfg)
    cut = {"wq": 1, "wk": 1, "wv": 1, "w_gate": 1, "w_up": 1, "wo": 0,
           "w_down": 0}
    for data, model in ((2, 2), (1, 4)):
        m = TM_BATCH * TM_SEQ // data
        shapes = {}
        for name, k, n in lin:
            kn = (k // model, n) if cut[name] == 0 else (k, n // model)
            shapes[kn] = shapes.get(kn, 0) + 1
        shapes[(cfg.d_model, cfg.vocab // model)] = 0      # the tied head
        for (k, n), count in sorted(shapes.items()):
            w = (torch.randn((n, k), generator=gen, device="cuda")
                 / k ** 0.5).t()
            xs = torch.randn((m, k), generator=gen, device="cuda")
            what = (f"[{k}, {n}] x {count} a layer" if count else
                    f"tied head shard [{k}, {n}]")
            row = dense_rows(torch, timer, detail,
                             f"train_mesh {data}x{model} dense_matmul "
                             f"{what}", w, xs, (m,),
                             {"config": cfg.name, "train_mesh":
                              f"{data}x{model}", "f32": True})[m]
            row["per_layer"] = count
            row["launches_per_step"] = (
                2 * cfg.n_layers * count * -(-m // launch_rows(k, 4))
                if count else -(-m // launch_rows(k, 4)))
            out[f"{data}x{model} {k}x{n}"] = row
            if model == 4 and count:
                for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
                    layer[key] += count * row[key]
                layer["max_abs_err"] = max(layer["max_abs_err"],
                                           row["max_abs_err"])
            del w, xs
    layer["bound_by"] = "bytes" if all(
        r["bound_by"] == "bytes" for k, r in out.items()
        if k.startswith("1x4")) else "operations"
    return out, layer


def _tm_one_rank(torch, cfg, dc, optc):
    """One rank's run of the launcher's params (seed ``cfg.n_layers``):
    TM_STEPS steps through ``value_and_grad`` and ``adamw_step`` (the
    train step's own pieces), the losses, the first step's gradient and
    the params before it sampled for each model size, the first step's
    ``lr``."""
    from repro_torch.models import lm
    from repro_torch.optim import adamw_step, init_opt_state
    from repro_torch.serving.engine import params_to
    from repro_torch.train import value_and_grad
    from repro_torch.data.pipeline import host_batch
    cuda = torch.device("cuda")
    params = params_to(lm.init_params(cfg, seed=cfg.n_layers, device=cuda),
                       cuda)
    opt = init_opt_state(params)
    models = sorted({m for _, m in TM_SHAPES})
    res = {"losses": [], "p0": {m: _tm_sample(torch, params, m)
                                for m in models}}
    for i in range(TM_STEPS):
        batch = {k: torch.as_tensor(v, device=cuda)
                 for k, v in host_batch(dc, i).items()}
        loss, g = value_and_grad(params, batch, cfg)
        if i == 0:
            res["grads"] = {m: _tm_sample(torch, g, m) for m in models}
        params, opt, mets = adamw_step(g, opt, optc, params_like=params)
        res["losses"].append(float(loss))
        if i == 0:
            res["lr"] = float(mets["lr"])
        del g
    del params, opt
    return res


def _tm_shard_grads(torch, cfg, dc):
    """One rank's gradients of each data shard of (4, 1) (the launcher's
    params), sampled."""
    from repro_torch.data.pipeline import host_batch
    from repro_torch.models import lm
    from repro_torch.serving.engine import params_to
    from repro_torch.train import value_and_grad
    cuda = torch.device("cuda")
    params = params_to(lm.init_params(cfg, seed=cfg.n_layers, device=cuda),
                       cuda)
    full = {k: torch.as_tensor(v, device=cuda)
            for k, v in host_batch(dc, 0).items()}
    rows = TM_BATCH // 4
    samples = []
    for j in range(4):
        _, g = value_and_grad(params, {k: v[j * rows:(j + 1) * rows]
                                       for k, v in full.items()}, cfg)
        samples.append(_tm_sample(torch, g, 1))
        del g
    del params
    return samples


def _bf16_ulp(torch, x):
    e = torch.floor(torch.log2(x.abs().clamp(min=2.0 ** -126)))
    return torch.pow(2.0, e - 7)


def _tm_gate_compressed(torch, recs, one):
    """Per scheme, the oracle from the gradients the four data ranks
    reduced: each leaf of ``g_hat``'s sample within one bf16 ulp of
    ``bf16(sum q_i) / 4`` (bf16) and equal to it (int8: the scale from the
    ranks' largest magnitudes over the whole leaf); each rank's error row
    its residual; and those gradients within TM_TOL["grad"] of each leaf's
    range of one rank's gradients of the same rows (``one``).  The oracle
    runs on the card, as the ranks' arithmetic did (there the int8 scale's
    division by 127 rounds as it does in the ranks)."""
    from repro_torch.models.module import tree_leaves
    worst = {"bf16": 0.0, "int8": 0.0, "err": 0.0, "grad": 0.0}
    n = len(recs)
    for scheme in ("bf16", "int8"):
        grads = [tree_leaves(r["compressed"][scheme]["grads"]) for r in recs]
        for li in range(len(grads[0])):
            g = [gr[li].cuda() for gr in grads]
            if scheme == "bf16":
                q = [t.to(torch.bfloat16).float() for t in g]
                tot = q[0]
                for t in q[1:]:
                    tot = tot + t
                want = tot.to(torch.bfloat16).float() / n
                res = [a - b for a, b in zip(g, q)]
            else:
                amax = max(r["compressed"][scheme]["amax"][li] for r in recs)
                scale = torch.clamp(torch.tensor(amax, device="cuda"),
                                    min=1e-12) / 127.0
                q = [torch.clamp(torch.round(t / scale), -127, 127)
                     .to(torch.int8) for t in g]
                tot = q[0].int()
                for t in q[1:]:
                    tot = tot + t.int()
                want = tot.float() * scale / n
                res = [a - b.float() * scale for a, b in zip(g, q)]
            for rank, rec in enumerate(recs):
                c = rec["compressed"][scheme]
                d = (tree_leaves(c["g_hat"])[li].cuda() - want).abs()
                if scheme == "bf16":
                    d = d / _bf16_ulp(torch, want)
                worst[scheme] = max(worst[scheme], float(d.max()))
                worst["err"] = max(worst["err"], float(
                    (tree_leaves(c["err"])[li].cuda() - res[rank]).abs()
                    .max()))
                ref = tree_leaves(one[rank])[li].cuda()
                worst["grad"] = max(worst["grad"], float(
                    (g[rank] - ref).abs().max() / ref.abs().max()))
    if not (worst["bf16"] <= 1.0 and worst["int8"] == 0.0
            and worst["err"] == 0.0 and worst["grad"] <= TM_TOL["grad"]):
        fail(f"train_mesh compressed: g_hat {worst['bf16']:.2f} bf16 ulps "
             f"from bf16(sum q_i)/4 (tol 1), int8 {worst['int8']:.3e} from "
             f"the oracle (exact), error rows {worst['err']:.3e} from the "
             f"ranks' residuals (exact), the ranks' gradients "
             f"{worst['grad']:.2e} of the range from one rank's (tol "
             f"{TM_TOL['grad']})")
    return worst


def _tm_local(t, spec, shape, coord):
    """A rank's block of a full tensor under ``spec`` (mesh sizes
    ``shape``, the rank's ``coord``)."""
    for dim, entry in enumerate(spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        n, idx = 1, 0
        for a in axes:
            n *= shape[a]
            idx = idx * shape[a] + coord[a]
        if n > 1:
            size = t.shape[dim] // n
            t = t.narrow(dim, idx * size, size)
    return t


def _tm_gate_moe(torch, label, recs, key, one, shape):
    """The MoE ranks against one rank's ``moe_apply`` on all the tokens:
    output and input gradient rows (of the range), the router's gradient
    (the ranks' shares summed, or each rank's where it is whole), every
    expert leaf's gradient sample (of the leaf's range) and norm."""
    out, gx, gp = one
    errs = {"out": 0.0, "gx": 0.0, "w": 0.0, "norm": 0.0, "router": 0.0}
    rng = lambda t: float(t.max() - t.min())
    router = torch.zeros_like(gp["router"])
    norms = {k: 0.0 for k in ("w_gate", "w_up", "w_down")}
    for rank, rec in enumerate(recs):
        m = rec[key]
        r0, n = m["rows"]
        errs["out"] = max(errs["out"], float(
            (m["out"] - out[r0:r0 + n]).abs().max()) / rng(out))
        errs["gx"] = max(errs["gx"], float(
            (m["gx"] - gx[r0:r0 + n]).abs().max()) / rng(gx))
        router = router + m["router"] if key == "moe_ep" else m["router"]
        if key == "moe_tp":
            errs["router"] = max(errs["router"], float(
                (m["router"] - gp["router"]).abs().max()) / rng(gp["router"]))
        for k in norms:
            norms[k] += m["norms"][k]
            want = _tm_local(gp[k], m["specs"][k], shape,
                             m["coord"])[:, :TM_MOE_SAMPLE]
            errs["w"] = max(errs["w"], float(
                (m["sample"][k] - want).abs().max())
                / float(gp[k].abs().max()))
    if key == "moe_ep":
        errs["router"] = float((router - gp["router"]).abs().max()) / \
            rng(gp["router"])
    for k, v in norms.items():
        want = float(gp[k].double().square().sum())
        errs["norm"] = max(errs["norm"], abs(v - want) / want)
    if not (errs["out"] <= TM_TOL["moe_out"] and errs["gx"] <= TM_TOL[
            "moe_out"] and errs["w"] <= TM_TOL["moe_w"] and errs["norm"]
            <= TM_TOL["moe_w"] and errs["router"] <= TM_TOL["moe_w"]):
        fail(f"train_mesh {label}: output {errs['out']:.2e} and input "
             f"gradient {errs['gx']:.2e} of the range (tol "
             f"{TM_TOL['moe_out']}), expert gradients {errs['w']:.2e} of "
             f"their range, norms {errs['norm']:.2e}, router "
             f"{errs['router']:.2e} (tol {TM_TOL['moe_w']}) from one rank's")
    return errs


def train_mesh_phase(torch):
    """The training mesh: full-width, full-depth Qwen3-0.6B trained by one
    spawn of MESH_WORLD gloo ranks sharing the card through
    ``launch.train.train_loop(mesh=)``, held against one rank on the same
    card; the compressed gradients and the MoE layer's mesh paths."""
    import gc
    import shutil
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import spawn
    from repro_torch.models import moe
    from repro_torch.models.module import tree_leaves, tree_map
    from repro_torch.optim import OptConfig, adamw_step, init_opt_state
    t_phase = time.perf_counter()
    cfg = get_config("qwen3-0.6b")
    cfg32 = _f32(cfg)
    dc = DataConfig(vocab=cfg.vocab, seq_len=TM_SEQ, global_batch=TM_BATCH)
    optc = OptConfig(peak_lr=1e-3, warmup_steps=1, decay_steps=TM_STEPS)
    gen = torch.Generator(device="cuda").manual_seed(18)
    detail, res = [], {}
    t0 = time.perf_counter()
    res["kernel_rows"], res["kernel_layer"] = mesh_kernel_rows(
        torch, cfg, Timer(torch, reps=3, warmup=1), gen, detail)
    res["kernel_rows_s"] = time.perf_counter() - t0
    # one rank first: the ranks then have the card alone
    t0 = time.perf_counter()
    one = _tm_one_rank(torch, cfg32, dc, optc)
    _, _, one_bf16 = train_mod.train_loop(cfg, TM_STEPS, dc, optc=optc,
                                          device="cuda")
    shard_grads = _tm_shard_grads(torch, cfg32, dc)
    mcfg = _f32(get_config(TM_MOE))
    p, x, r = _tm_moe_inputs(torch, mcfg, torch.device("cuda"))
    *moe_one, moe_s = _tm_moe_grads(
        torch, lambda pp, xx: moe.moe_apply(pp, xx, mcfg), p, x, r)
    moe_one = [t.cpu() if torch.is_tensor(t) else
               {k: v.cpu() for k, v in t.items()} for t in moe_one]
    del p, x, r
    gc.collect()
    torch.cuda.empty_cache()
    res["one_rank_s"] = time.perf_counter() - t0
    say(f"train_mesh: one-rank references in {res['one_rank_s']:.1f} s: "
        f"f32 losses {one['losses']}, bf16 {one_bf16}; the MoE layer "
        f"forward and backward {moe_s * 1e3:.0f} ms")
    ckpt = tempfile.mkdtemp(prefix="train_mesh_ckpt_")
    try:
        t0 = time.perf_counter()
        recs = spawn(train_mesh_rank, MESH_WORLD, ({"ckpt": ckpt},),
                     backend="gloo", device="cuda", timeout=900)
        res["spawn_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    res["rank_seconds"] = [rec["seconds"] for rec in recs]
    say(f"train_mesh: the dense kernel's rows {res['kernel_rows_s']:.1f} s, "
        f"one-rank references {res['one_rank_s']:.1f} s, the spawn "
        f"{res['spawn_s']:.1f} s; rank 0's parts (s): "
        + json.dumps({k: round(v, 1) for k, v in recs[0]["seconds"].items()}))
    # gates: losses, the first step's gradient and AdamW update, ZeRO-1,
    # launches and held launches
    rtol, atol = TM_TOL["loss"]
    close = lambda a, b: len(a) == len(b) and all(
        abs(x - y) <= atol + rtol * abs(y) for x, y in zip(a, b))
    res["runs"] = {}
    for label in recs[0]["runs"]:
        want = (one_bf16 if label.startswith("bf16") else
                one["losses"][2:] if label.startswith("elastic") else
                one["losses"])
        for rank, rec in enumerate(recs):
            run = rec["runs"][label]
            got = run["losses"]
            ok = (all(abs(x - y) <= TRAIN_TOL["loss_bf16"] * abs(y)
                      for x, y in zip(got, want)) and len(got) == len(want)
                  if label.startswith("bf16") else close(got, want))
            if not ok:
                fail(f"train_mesh {label}: rank {rank}'s losses {got} "
                     f"against one rank's {want}")
            # every call of the dense kernel goes through the held wrapper
            held = run["held"]
            if run["launches"]["dense_matmul"] <= 0 or \
                    held.get("calls", 0) <= 0 or not \
                    held["max_rel_err"] <= HELD_TOL["_dense_kernel"]:
                fail(f"train_mesh {label}: rank {rank} launched the dense "
                     f"kernel {run['launches']['dense_matmul']} times in "
                     f"{held.get('calls', 0)} calls, each held to the plain "
                     f"version: largest error {held.get('max_rel_err')} of "
                     f"its output (tol {HELD_TOL['_dense_kernel']})")
            if run["zero1_wrong"]:
                fail(f"train_mesh {label}: rank {rank}'s ZeRO-1 blocks of "
                     f"leaves {run['zero1_wrong']} are not 1/dp of their "
                     "param blocks")
        r0 = recs[0]["runs"][label]
        steps = r0["steps"]
        step_s = statistics.median(s["s"] for s in steps) if steps else 0.0
        coll = steps[-1]["collectives"] if steps else {}
        res["runs"][label] = {
            "losses": r0["losses"], "step_s": [s["s"] for s in steps],
            "median_step_s": step_s,
            "tok_s": TM_BATCH * TM_SEQ / step_s if step_s else None,
            "peak_gib": [rec["runs"][label]["peak_gib"] for rec in recs],
            "state_gb": [rec["runs"][label]["state_bytes"] / 1e9
                         for rec in recs],
            "collectives_per_step": coll, "seconds": r0["seconds"],
            "launches": [rec["runs"][label]["launches"]["dense_matmul"]
                         for rec in recs],
            "held_max_rel_err": max(rec["runs"][label]["held"][
                "max_rel_err"] for rec in recs)}
        say(f"train_mesh {label}: losses {r0['losses']} equal one rank's "
            f"{want} on every rank; the run {r0['seconds']:.1f} s, median "
            f"step {step_s * 1e3:.0f} ms "
            f"({res['runs'][label]['tok_s'] or 0:.0f} tok/s, placement and "
            f"collectives, not speed: 4 ranks share the card and stage "
            f"through host memory); a step's collectives "
            f"{coll.get('calls', 0)} calls, {coll.get('bytes', 0) / 1e9:.3f}"
            f" GB, {coll.get('seconds', 0.0):.2f} s; peak per rank "
            f"{max(res['runs'][label]['peak_gib']):.2f} GiB; master + m + v "
            f"{res['runs'][label]['state_gb'][0]:.3f} GB a rank; dense "
            f"launches {res['runs'][label]['launches']} (each call held to "
            f"the plain version, max "
            f"{res['runs'][label]['held_max_rel_err']:.1e} of its output)")
    # the first step: gradient and the ZeRO-1 AdamW update
    one_state = OptConfig(peak_lr=optc.peak_lr, warmup_steps=1,
                          decay_steps=TM_STEPS, clip_norm=0.0)
    res["first_step"] = {}
    for label in ("f32 2x2", "f32 4x1", "f32 1x4"):
        model = int(label[-1])
        first = recs[0]["runs"][label]["first"]
        g_err = 0.0
        for a, b in zip(tree_leaves(first["grads"]),
                        tree_leaves(one["grads"][model])):
            g_err = max(g_err, float((a - b).abs().max())
                        / float(b.abs().max()))
        if not g_err <= TM_TOL["grad"]:
            fail(f"train_mesh {label}: the first step's gradient is "
                 f"{g_err:.2e} of a leaf's range from one rank's (tol "
                 f"{TM_TOL['grad']})")
        gn = recs[0]["runs"][label]["steps"][0]["grad_norm"]
        scale = min(1.0, optc.clip_norm / max(gn, 1e-9))
        g = tree_map(lambda t: t * scale, first["grads"])
        p0 = one["p0"][model]
        want, _, _ = adamw_step(g, init_opt_state(p0), one_state,
                                params_like=p0)
        lr = one["lr"]
        worst_big, worst = 0.0, 0.0
        for gg, got, w in zip(tree_leaves(first["grads"]),
                              tree_leaves(first["params"]),
                              tree_leaves(want)):
            d = (got - w).abs()
            big = gg.abs() > 100 * TM_EPS
            if big.any():
                worst_big = max(worst_big, float(d[big].max()) / lr)
            worst = max(worst, float(d.max()) / lr)
        if not (worst_big <= 1e-3 and worst <= 5e-2):
            fail(f"train_mesh {label}: the first ZeRO-1 step moved the "
                 f"sampled params {worst_big:.2e} of lr from one rank's "
                 f"AdamW step on the same gradient where |g| > 100 eps "
                 f"(tol 1e-3), {worst:.2e} anywhere (tol 5e-2)")
        res["first_step"][label] = {"grad_rel_range": g_err,
                                    "adamw_lr_big": worst_big,
                                    "adamw_lr_any": worst}
    say(f"train_mesh: the first step's gradient (layers 0 and "
        f"{cfg.n_layers - 1}, the norms, the sampled table rows) within "
        f"{max(v['grad_rel_range'] for v in res['first_step'].values()):.2e}"
        " of each leaf's range of one rank's on every mesh; the ZeRO-1 "
        "update within "
        f"{max(v['adamw_lr_big'] for v in res['first_step'].values()):.2e} "
        "of lr of one rank's AdamW step on it where |g| > 100 eps")
    res["compressed"] = _tm_gate_compressed(torch, recs, shard_grads)
    c = recs[0]["compressed"]
    say(f"train_mesh compressed 4x1: bf16 g_hat within "
        f"{res['compressed']['bf16']:.2f} bf16 ulp of bf16(sum q_i)/4, int8 "
        f"equal to the oracle, error rows the ranks' residuals (from the "
        f"gradients the ranks reduced, "
        f"{res['compressed']['grad']:.2e} of the range from one rank's "
        f"gradients of the same rows); bf16 "
        f"{c['bf16']['seconds']:.2f} s "
        f"({c['bf16']['collectives']['bytes'] / 1e9:.2f} GB), int8 "
        f"{c['int8']['seconds']:.2f} s "
        f"({c['int8']['collectives']['bytes'] / 1e9:.2f} GB)")
    res["moe_ep"] = _tm_gate_moe(torch, "moe ep 4x1", recs, "moe_ep",
                                 moe_one, {"data": 4, "model": 1})
    res["moe_tp"] = _tm_gate_moe(torch, "moe tp 1x4", recs, "moe_tp",
                                 moe_one, {"data": 1, "model": 4})
    say(f"train_mesh moe: {TM_MOE} layer 0 at full width, f32, "
        f"{TM_MOE_BATCH} x {TM_MOE_SEQ} tokens: expert-parallel at 4x1 "
        f"(output {res['moe_ep']['out']:.1e}, input gradient "
        f"{res['moe_ep']['gx']:.1e} of the range, experts "
        f"{res['moe_ep']['w']:.1e}) and d_ff over the model axis at 1x4 "
        f"({res['moe_tp']['out']:.1e}, {res['moe_tp']['gx']:.1e}, "
        f"{res['moe_tp']['w']:.1e}) against one rank's; forward and "
        f"backward {recs[0]['moe_ep']['seconds'] * 1e3:.0f} / "
        f"{recs[0]['moe_tp']['seconds'] * 1e3:.0f} ms a rank, one rank "
        f"{moe_s * 1e3:.0f} ms")
    res["mesh_launches"] = [sum(r["launches"]["dense_matmul"]
                                for r in rec["runs"].values())
                            for rec in recs]
    res["seconds"] = time.perf_counter() - t_phase
    say(f"train_mesh: passed (spawn of {MESH_WORLD} ranks "
        f"{res['spawn_s']:.1f} s, phase {res['seconds']:.1f} s)")
    return res, detail


SOURCES = {
    "sparse_gemv": ("src/repro_torch/kernels/csrc/sparse_gemv.cu",
                    "src/repro/kernels/sparse_gemv.py:47"),
    "sparse_decode_attention_fused": (
        "src/repro_torch/kernels/csrc/sparse_attention.cu",
        "src/repro/kernels/sparse_attention.py:236"),
    "sparse_matmul": ("src/repro_torch/kernels/csrc/sparse_matmul.cu",
                      "src/repro/kernels/sparse_matmul.py:46"),
    "dense_matmul": ("src/repro_torch/kernels/csrc/dense_matmul.cu",
                     "src/repro/kernels/dense_matmul.py:40"),
    "sparse_decode_attention_fused_paged": (
        "src/repro_torch/kernels/csrc/sparse_attention.cu",
        "src/repro/kernels/sparse_attention.py:226"),
    "sparse_matmul_int8": ("src/repro_torch/kernels/csrc/sparse_matmul_int8.cu",
                           "src/repro/kernels/sparse_matmul_int8.py:42"),
    "sparse_matmul_int4": ("src/repro_torch/kernels/csrc/sparse_matmul_int8.cu",
                           "src/repro/kernels/sparse_matmul_int4.py:49"),
    "sparse_decode_attention_partial": (
        "src/repro_torch/kernels/csrc/sparse_attention.cu",
        "src/repro/kernels/sparse_attention.py:108"),
    # row 3's TPU kernel at f32 activations (an engine served at f32)
    "sparse_matmul_f32": ("src/repro_torch/kernels/csrc/sparse_matmul.cu",
                          "src/repro/kernels/sparse_matmul.py:46"),
}
# the path whose run each kernel's launch count is read from
PATH_OF = {"sparse_gemv": "serve", "sparse_decode_attention_fused": "serve",
           "sparse_matmul": "serve", "dense_matmul": "serve",
           "sparse_decode_attention_fused_paged": "paged_int8",
           "sparse_matmul_int8": "paged_int8",
           "sparse_matmul_int4": "paged_int4",
           "sparse_decode_attention_partial": "two_pass",
           "sparse_matmul_f32": "two_pass"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    ap.add_argument("--server-only", action="store_true",
                    help="build, then run the server phase alone (on its "
                         "own int8 weights) and print no result line")
    ap.add_argument("--only", default="",
                    help="build, then run these of the phases one_shot, "
                         "snapshot, checkify, wide_kernels, llama3_8b, "
                         "phi3_mini, internvl2, phi35_moe, scout, rwkv6, "
                         "seamless, jamba, jamba_mamba, train, mesh and "
                         "train_mesh alone (comma-separated; "
                         "checkify without the paged int8 run to compare "
                         "with) and print no result line")
    ap.add_argument("--profile", action="store_true",
                    help="also run the traced profiles, the kernels' traced "
                         "device times and the train phase's traced step")
    args = ap.parse_args()
    global PROFILE
    PROFILE = args.profile
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             "a checkout of the repository", code=2)
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card", code=2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    card = card_phase(torch, build)
    t_build = build_phase(build)
    cfg = get_config("qwen3-0.6b")
    if args.server_only:
        res = server_phase(torch, cfg, _model(torch, cfg, "int8"))
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(res, indent=1, default=str))
        say(f"server phase alone passed; total "
            f"{time.perf_counter() - t_start:.1f} s")
        return 0
    if args.only:
        res = {}
        only = set(args.only.split(","))
        unknown = only - {"one_shot", "snapshot", "checkify", "train",
                          "mesh", "train_mesh", *WIDE_PHASES}
        if unknown:
            fail(f"--only: no phase {sorted(unknown)}")
        if "one_shot" in only:
            params = _model(torch, cfg, "bf16")
            cfg32, params32 = _widened(torch, cfg, params)
            res["one_shot"] = oneshot_phase(torch, cfg, params, cfg32,
                                            params32)
            del params, params32
        if only & {"snapshot", "checkify"}:
            params8 = _model(torch, cfg, "int8")
            if "snapshot" in only:
                res["snapshot"] = snapshot_phase(torch, cfg, params8)
            if "checkify" in only:
                res["checkify"] = checkify_phase(
                    torch, cfg, params8,
                    _shared_prompts(cfg, PAGED_REQUESTS))
            del params8
        if only & set(WIDE_PHASES):
            res["wide"], res["wide_detail"] = wide_phases(torch, only)
        if "train" in only:
            res["train"], res["train_detail"] = train_phase(torch)
            say(f"train: passed ({res['train']['seconds']:.1f} s)")
        if "mesh" in only:
            res["mesh"] = run_phase("mesh", mesh_phase, torch)
        if "train_mesh" in only:
            res["train_mesh"], res["train_mesh_detail"] = run_phase(
                "train_mesh", train_mesh_phase, torch)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(res, indent=1, default=str))
        say(f"phases {sorted(only)} alone passed; total "
            f"{time.perf_counter() - t_start:.1f} s")
        return 0
    PHASE_S["build"] = t_build
    summary, detail = run_phase("kernels", kernel_phase, torch, cfg)
    say(f"kernels: all {len(SOURCES)} agree with their plain versions")
    serve = {}
    serve["serve"], params = run_phase("serve", serve_phase, torch, cfg)
    serve["spec"] = run_phase("spec", spec_phase, torch, cfg, params)
    cfg32, params32 = _widened(torch, cfg, params)
    serve["two_pass"] = run_phase("two_pass", two_pass_phase, torch, cfg32,
                                  params32, Timer(torch))
    spec_f32 = run_phase("spec_f32", spec_identity_f32, torch, cfg32,
                         params32)
    serve["spec_f32"], serve["spec_f32_k8"] = spec_f32[SPEC_K], spec_f32[8]
    serve["one_shot"] = run_phase("one_shot", oneshot_phase, torch, cfg,
                                  params, cfg32, params32)
    del params, params32
    serve["paged_int8"], params8, prompts, run8 = run_phase(
        "paged_int8", paged_phase, torch, cfg, "int8", PAGED_REQUESTS,
        PAGED_NEW_TOKENS, "sparse_matmul_int8")
    serve["identity"] = run_phase("identity", identity_phase, torch, cfg,
                                  params8, prompts, run8)
    serve["spec_paged_int8"] = run_phase("spec_paged_int8", spec_paged_phase,
                                         torch, cfg, params8, prompts)
    serve["server"] = run_phase("server", server_phase, torch, cfg, params8)
    serve["snapshot"] = run_phase("snapshot", snapshot_phase, torch, cfg,
                                  params8)
    serve["checkify"] = run_phase("checkify", checkify_phase, torch, cfg,
                                  params8, prompts, run8)
    del params8, run8
    serve["paged_int4"] = run_phase(
        "paged_int4", paged_phase, torch, cfg, "int4", INT4_REQUESTS,
        INT4_NEW_TOKENS, "sparse_matmul_int4")[0]
    wide, wide_detail = run_phase("wide", wide_phases, torch)
    serve.update(wide)
    detail += wide_detail
    serve["train"], train_detail = run_phase("train", train_phase, torch)
    detail += train_detail
    say(f"train: passed ({serve['train']['seconds']:.1f} s)")
    serve["mesh"] = run_phase("mesh", mesh_phase, torch)
    serve["train_mesh"], tm_detail = run_phase("train_mesh",
                                               train_mesh_phase, torch)
    detail += tm_detail

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        s = summary[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": serve[PATH_OF[name]]["launches"][name],
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": s["library_ms"],
            "mesh_launches": [t.get(name, 0)
                              for t in serve["mesh"]["launches"]]})
    # the dense kernel on the training path: launches of the train run, its
    # numbers a layer's seven linears at the step's M = 8192
    layer = serve["train"]["kernel_layer"]
    kernels.append({
        "name": "dense_matmul (train)", "route": "cuda",
        "source": SOURCES["dense_matmul"][0],
        "replaces": SOURCES["dense_matmul"][1],
        "launches": serve["train"]["train"]["launches"]["dense_matmul"],
        "max_abs_err": layer["max_abs_err"], "ms": layer["ms"],
        "plain_ms": layer["plain_ms"], "bound_ms": layer["bound_ms"],
        "bound_by": layer["bound_by"], "library_ms": layer["library_ms"],
        "mesh_launches": [0] * MESH_WORLD})
    # the dense kernel on the training mesh's path: launches of the phase's
    # runs over every rank, its numbers a (1, 4) rank's layer of seven
    # linears at f32 (M = TM_BATCH * TM_SEQ, the model axis cut)
    tm = serve["train_mesh"]
    layer = tm["kernel_layer"]
    kernels.append({
        "name": "dense_matmul (train_mesh)", "route": "cuda",
        "source": SOURCES["dense_matmul"][0],
        "replaces": SOURCES["dense_matmul"][1],
        "launches": sum(tm["mesh_launches"]),
        "max_abs_err": layer["max_abs_err"], "ms": layer["ms"],
        "plain_ms": layer["plain_ms"], "bound_ms": layer["bound_ms"],
        "bound_by": layer["bound_by"], "library_ms": layer["library_ms"],
        "mesh_launches": tm["mesh_launches"]})
    say("phase seconds: " + json.dumps({k: round(v, 1)
                                        for k, v in PHASE_S.items()}))
    say(f"total {time.perf_counter() - t_start:.1f} s")
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(
            {"card": card, "build_s": t_build, "kernels": kernels,
             "summary": summary, "detail": detail, "serve": serve},
            indent=1, default=str))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
