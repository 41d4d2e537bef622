"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

  python3 chip_smoke.py            # from the root of a checkout, one GPU
  python3 chip_smoke.py --parent DIR   # also time DIR's B5 and B3 beside
                                       # this tree's (DIR: another checkout)
  python3 chip_smoke.py --split-sweep  # only B6's, B4's and B3's split
                                       # sweeps and B5's regime sweep

Phases, each printed as one JSON line; any failed check raises and the
script exits non-zero before the final line:

1. The card (``nvidia-smi``) and the parallel build of every CUDA kernel
   from the sources in ``src/repro_torch/csrc`` (one nvcc per source).
2. One phase per kernel: the CUDA kernel against its plain PyTorch version
   on the same inputs on the card, at the main path's shapes (smollm-135m:
   8 lanes, 9 query / 3 KV heads, head dim 64, page 16, contexts up to
   about 2k, prefill chunks of 512; and the replay's commonest shapes, one
   lane decoding over 1861 keys and one lane's 8-row prefill bucket with 2
   live rows after 477 keys), at head dim 32 and 128 (qwen3-1.7b, GQA 2,
   sliding window 4096 over a 6000-token context), at whisper's decoder
   (GQA 1, a 28-page table), at phi4-mini's heads (24 query / 8 KV of
   128: GQA 3, a 64-page table), at zamba2-7b's shared attention (32 / 32
   heads of 112; its replay's commonest decode step and prefill group
   timed beside an eight-lane step and four 128-row chunks) and at
   phi3.5-moe's (32 / 8 heads of 128: GQA 4), with masked lanes, mid-page
   chunk starts, and
   both one block per query tile and keys split over blocks with a merge
   launch.  Outputs agree within the limit on valid rows (``ATOL`` +
   ``RTOL`` x max |plain|: each line prints its reading, max |plain| and
   limit), pools are bit-equal after the write, poisoned pages unchanged.
   Every case of B1, B2 and B3 runs again over bfloat16 pools
   (``EngineConfig.dtype``: the kernels' bf16 instantiations; the same
   normal draws rounded to bf16), the main and replay shapes of B1 and B2
   and B3's two timed shapes timed, with the bytes bound counting K/V at
   2 bytes and SDPA over the gathered pages converted to float32; each
   bf16 line of B2 and B3 also gives how far the plain arithmetic moves
   when the chunk attends over its unrounded rows, and ``self_midpage``
   (a 60-row chunk over 5 keys of history) must carry that past the
   limit, so a kernel that attended over the unrounded k_new would fail
   it.  At the timed shapes each
   version is timed with CUDA events around the call (the L2 cache flushed
   before every launch; the wrapper's host time included), the kernel also
   by ``torch.profiler`` (its own launches' device time, split and merge
   summed), beside the least time the card could take and one PyTorch
   ``scaled_dot_product_attention`` call over the gathered K/V (the
   yardstick; the port never calls it), timed both ways too (its device
   time: every kernel of the call but the L2 flush's fill).  The verify
   kernel (B3)
   is held the same way at qwen3-1.7b's heads (16 query / 8 KV, head dim
   128; one lane, an 8- or 16-row window with 1 to 9 live rows, histories
   of 0 to about 2000 keys, a 4096-token window over 6000 keys) and at
   smollm's group with a masked lane, and timed at the spec replay's shape
   (an 8-row window with 2 live rows: the last token and one draft) and
   over 1995 keys; with ``--parent`` the other tree's B3 is checked and
   timed beside it (its split and merge launches apart).
3. Greedy streams of the full-width engine against plain full-causal
   generation on the card: three requests of different prompt lengths in
   one padded prefill group, mid-page second chunks, and padded decode
   groups whose lanes freeze at uneven budgets (a difference counts only
   if the reference's top-2 logit margin there is at least 1e-4).
4. The main path: ``repro_torch.launch.serve`` replays 16 chatbot requests
   at their own lengths on full-width smollm-135m, its 30 layers cut to 3
   (``--layers``, ``MAIN_LAYERS``; random weights from the seed,
   float32).  The kernel launch counts are zeroed just before and read
   just after: every decode step must launch the decode kernel once per
   layer, every prefill group the prefill kernel once per layer (a call
   counts once, with or without its merge launch), B6 and the plain
   versions never.  The line lists the shapes the replay gave B2 and B1
   ((B, S) buckets, live rows and pos0 of the prefill groups; batch and
   longest seq_len of the decode steps), which must include the replay
   shapes of step 2.
5. The multi-replica cluster (§4.2): ``ClusterFrontend.build`` stands up
   two replicas of the main path's smollm-135m (3 layers) on the card,
   sharing its parameter tensors and one page budget (256 pages a
   replica over 384, page 16), with the host spill tier on (64 pages a
   replica) and ``ClusterTelemetry`` enabled.  Twelve requests at chatbot
   prompt lengths arrive at once, four long guaranteed ones (all opening
   with a shared 512-token system prompt, as do four of the first) once
   best-effort KV is resident, replica 1 drains once its first-wave
   requests have finished (its chains spill into replica 0's host tier),
   and two requests then re-send the prompts replica 0 holds there;
   outputs cut to 32 tokens.  Routing, best-effort demotion, preemption,
   prefix affinity, spill and prefetch must each happen; the shared
   budget must equal the replicas' used pages after every step; launch
   counts zeroed just before and read just after: B1 once per layer per
   decode step and B2 once per layer per prefill group over every replica
   that lived, no other kernel, no plain version; every spilled or
   exported page bit-equal to the page its chain's prefetch lands on;
   ``ClusterStats`` equal to the telemetry registry; every stream equal to
   plain generation under the tie rule.
6. Speculative decoding at the full width of qwen3-1.7b, its 28 layers
   cut to 14 (``SPEC_LAYERS``; random weights from the seed): three
   prompts decoded by spec cycles of draft
   length 1, 3 and 8, with the 1-layer draft of the reference's tests and
   with the target as its own draft, each stream held against plain
   greedy generation under the same tie rule.
7. The spec path: ``ServingFrontend`` over ``ServingEngine(draft=...)``
   (the target as its own draft) with a speculation-planning
   ``SLOsServeScheduler`` serves eight requests (prompt 512, output 64) in
   a tight and a loose TPOT tier.  Counts zeroed just before and read just
   after: the verify kernel launches once per layer per verify, the
   prefill kernel once per layer per prefill group and draft catch-up,
   the decode kernel once per layer per target decode step and draft
   step, and the plain versions never.  The line lists the verify windows
   the replay ran (rows / live rows), which must include the shape at
   which step 2 timed the verify kernel.
8. The MLA kernel (B4) against its plain version at deepseek-v2's full
   widths (128 heads, latent rank 512, rope 64, page 16): a chunk that
   straddles pages from a mid-page start, a chunk from position 0, masked
   and partial lanes, a long history, every unreachable row and unmapped
   page poisoned, and chunks of few rows whose keys the kernel splits over
   blocks (one with a split whose share is empty).  Outputs agree within
   the limit on valid rows, pools bit-equal, unwritten pages unchanged,
   padded rows zeros; each line names the key splits.  Timed at the mla
   replay's prefill shape (one lane, a 16-row bucket with 15 live rows
   after 120 tokens of history; 2 key splits) and at a 256-token chunk
   (none).
9. DeepSeek-V2 at full width cut to three layers (``mla``, ``mla_moe``,
   ``mla_moe``; random weights from the seed, 34.8 GiB in float32): three
   greedy streams of the engine against plain full-causal generation, as
   in step 3.
10. The MLA path: ``ServingFrontend`` with ``SLOsServeScheduler`` serves 8
   chatbot requests (lengths scaled by 0.25, 2/s) on the cut model.
   Counts zeroed just before and read just after: B4 launches once per
   layer per prefill group, B1-B3 never (MLA uses none of them), plain
   versions never.  Then one decode step of eight lanes is timed whole and
   by part (an MLA layer's naive decode, an MoE layer).
11. The SSD kernel (B5) against its plain version at mamba2's widths (80
    heads, head dim 64, state 128): one chunk of 8, 16, 32 (from a carried
    state, lanes padded with dt = 0) and 200 tokens, four 128-token chunks
    carried, a nonzero initial state, lanes of 1 and 4; y and the final
    state within the limit, a lane of length 0 keeps its state exactly;
    each
    line names whether C.B^T came from the workspace launch and the
    workspace's size.  Timed at the ssm replay's commonest prefill shape,
    at 512 tokens in chunks of 128 and at a 763-token prompt as one
    chunk; with ``--parent`` the other tree's
    B5 is checked and timed beside it.
12. mamba2-2.7b at its published width and depth (64 layers, random
    weights from the seed, 10.5 GiB in float32): three greedy streams of a
    two-slot engine against plain full-causal generation, the third in the
    slot the first one freed (its lane rows zero after the admission).
13. The SSM path: ``ServingFrontend`` with ``SLOsServeScheduler`` serves 8
    chatbot requests (lengths scaled by 0.25, 2/s) on mamba2 with 4 slots.
    Counts zeroed just before and read just after: B5 launches once per
    layer per prefill group, B1-B4 never, plain versions never; the timed
    shape must be among the prefill groups.  Then B5 is checked and timed
    at the replay's commonest prefill group above 32 tokens (or, as the
    replay runs none, its commonest other than the timed 32-token one),
    as the replay ran it (``ssd_replay_group``).  The replay's line also
    splits one prefill group at the timed shape into host and device time
    (``prefill_breakdown``).  With ``--parent`` the replay then runs eight
    more times, with the other tree's B5 wrapper and kernel and with this
    tree's in turns, other-this-this-other and then this-other-other-this
    (the ``ssm_ab`` line: spans, prefill-group time and each turn's
    ``prefill_breakdown``).
14. The dense flash attention kernel (B6) against its plain version
    through the GQA wrapper ``attention``: one whisper encoder layer (20
    heads, 1500 x 1500 frames, head dim 64, bidirectional), cross decode
    steps of 8 lanes and of one lane (Sq 1 over 1500 keys), cross prefill
    chunks of 16, 32 and 128 rows, causal from q_offset 0 and beyond with
    kv_len < Sk, head dim 32 and 128 (llama-3.2-vision's cross shape: 32
    query / 8 KV heads over 1600 image tokens; qwen3-1.7b's no-cache
    causal shape), Sq and Sk no multiples of the tile, head dim 112
    (zamba2-7b's plain generation: a 763-token causal prompt over 32
    heads, timed, and a few rows at an offset); outputs within
    the limit, keys no row may see poisoned.  Each line names the regime the
    wrapper chose: warps per 16-row group (8 at one row, 1 from 65 rows)
    and key splits (none when the query tiles give every SM a block).
    Timed at the encoder and the 8-lane cross-decode shape, at the
    whisper replay's commonest cross shapes (one lane's decode step and
    its 16-row prefill bucket), at llama-3.2-vision's cross shape and at
    its replay's commonest (the same over 1600 image tokens, 32 / 8
    heads of 128).
15. whisper-large-v3 at its published width and depth (32 encoder and 32
    decoder layers, random weights from the seed, 5.9 GiB in float32):
    each request's frames come from a numpy seed and go through
    ``encoder_forward`` on the card (B6 in its 128-row regime); three
    greedy streams of the engine, each lane with its own encoder states
    (B6 over few rows, keys split, at every cross layer), against plain
    generation (``model_forward(cache=None, enc_states=...)``) under the
    tie rule.
16. The whisper path: ``ServingFrontend`` with ``SLOsServeScheduler``
    serves 8 chatbot requests (lengths scaled by 0.25, 2/s, max_len 448),
    each submitted with ``enc_states`` from ``encoder_forward``.  Counts
    zeroed just before the encoder calls and read just after the replay:
    B6 once per encoder layer per encoder call and once per decoder layer
    per prefill group and per decode step, B2 once per layer per prefill
    group, B1 once per layer per decode step, B3-B5 never, plain versions
    never.  The line lists the (BH, Sq, Sk) of every B6 call, which must
    include the replay shapes step 14 timed.  Then one decode step of
    eight lanes is timed whole and by part (one layer's cross K/V
    projection, which the reference's design repeats in every step, its
    cross-attention, its self-attention).
17. zamba2-7b (``hybrid``): B5 against its plain version at its widths
    (112 heads, head dim 64, state 64; the hybrid replay's 32-token
    chunk, a 128-token chunk, padded lanes, 512 tokens in chunks of 128
    and a 763-token prompt as one chunk; timed at the first, second and
    last); then the model at its published width and depth (81 layers:
    68 Mamba2 layers and one shared attention block at 13 depths, each
    occurrence over its own pools; random weights from the seed, 21.4 GiB
    in float32): the SSM stream script's greedy streams against plain
    generation (B5 over the whole prompt, B6 at head dim 112), and the
    chatbot replay of the SSM path (8 requests, 4 slots, 1024 pages):
    B2 once per occurrence per prefill group, B1 once per occurrence per
    decode step, B5 once per Mamba2 layer per prefill group, B3, B4, B6
    and the plain versions never; the shapes it gave B1, B2 and B5, which
    must hold the timed replay shapes; a decode step and a prefill group
    split into the Mamba2 layers', the shared attention's and the
    device's time.
18. phi3.5-moe-42b-a6.6b (``attn_moe``) at its published widths (d_model
    4096, 32 / 8 heads of 128, 16 experts top-2 of 6400, vocab 32064),
    its 32 layers cut to 4 (20.4 GiB in float32): three greedy streams
    against plain generation, and the 8-request chatbot replay: B2 once
    per layer per prefill group, B1 once per layer per decode step,
    nothing else.
19. The serving surface: ``repro_torch.launch.serve.http_gateway`` (the
    launcher's ``--http`` cluster) stands up two replicas of phi4-mini-3.8b
    at its published width, its 32 layers cut to 2 (24 query / 8 KV heads
    of 128, vocab 200064; random weights from the seed, float32) sharing
    one parameter copy, 512 pages a replica over 1024 (page 16; the
    launcher's 1 GiB a replica, capped by what 8 slots can fill), max_len
    1024, 8 slots, behind the HTTP/SSE gateway.  The traffic
    is the paper's six-scenario trace (``core/trace.py``; 18 entries,
    stage lengths scaled by 0.25 and capped at 128), saved with
    ``save_trace`` and replayed from ``load_trace``.  Part 1: every entry
    posted over real TCP to an ``autostep=False`` gateway, then pumped
    until idle; every SSE stream equal to the same trace driven in process
    on a fresh identical cluster (a difference only where the top-2
    margin of plain generation over that request's history is below
    1e-4), every emitted token held against plain generation over the
    history the engine recorded (tool contexts included), the short
    single-stage streams also against ``greedy_reference``; ``done``
    events equal to ``ClusterStats`` and the telemetry registry; counts
    zeroed just before the pump: B1 once per layer per decode step and B2
    once per layer per prefill group over both replicas, no other kernel,
    no plain version.  Part 2: the entries posted open loop at their
    arrival offsets to a gateway on its own thread (``run_in_thread``),
    one client leaving after its first token (its request cancelled, its
    pages released), replica 1 drained by ``POST /admin/drain``, ``GET
    /metrics`` parsed, ``shutdown(drain=True)`` completing every other
    stream, the shared budget equal to the replicas' used pages after
    every step; the client's median TTFT and TPOT in wall seconds.
20. bf16 KV serving (``EngineConfig(dtype=torch.bfloat16)``), run right
    after the float32 phases of its path on the same parameters: B4's
    cases over bf16 latent pools (the main shape timed); the spec stream
    script with the one-layer draft (B1, B2, B3) and the MLA stream script
    (B4) through an engine over bf16 pools, each against the same script
    through an engine over bf16 pools whose attention calls the kernels'
    plain versions (swapped in for that run alone): equal streams under
    the tie rule (the yardstick's margin), and, reported only, how many
    tokens each agrees with float32 plain generation; then the spec and
    MLA replays in bf16 with the float32 replays' parameters and page
    counts: launches equal layers x the engine's counters as in float32,
    no plain call, no B5 or B6, pool bytes half the float32 replay's, and
    the float32 replay's served / attained / tokens printed beside.
21. The kernels line (each kernel once, its launches summed over every
    path's replay, with ``launches_by_path``; the bf16 and fp16
    instantiations of B1-B4 as ``*_bf16`` and ``*_f16`` entries with the
    16-bit replays' launches, B1's bf16 queries as
    ``paged_decode_attention_bf16q`` (no path passes them: 0 launches),
    B5's and B6's bf16 inputs as ``ssd_scan_bf16`` and
    ``flash_attention_bh_bf16`` with ``bf16_launch_steps``' launches), the
    card line, and ``{"ok": true, "device": ...}``.

22. ``dense_cache`` (run right after the cluster phase, on its weights):
    the main path's smollm-135m generates 32 tokens greedily after a 48-token
    prompt through the dense fixed-buffer caches (``init_cache``: the
    prompt in one call, then one token a call, attended by the masked
    ``sdpa``), against plain generation under the tie rule; no kernel and
    no plain version runs.
23. Training (run after the phi3.5-moe replay, before the gateway), each
    phase with the launch counts of all six kernels and their plain
    versions unchanged over it, its step time (from the second logged
    step to the last), tokens per second, peak memory and the card line:
    ``train_dense``: smollm-135m at its published width and depth through
    ``launch.train.main`` (8 x 1024 of the Markov stream at the seed, 200
    steps, AdamW at lr 3e-3): every loss finite and the last logged below
    the first by 0.25; then one step (2 x 256) from CPU-drawn weights on
    the CPU and on the card with remat off and on, loss within rel 1e-5
    and gradient norm within rel 1e-4 of the CPU's and of each other.
    ``train_ssm``: mamba2-2.7b at its published widths cut to 16 layers:
    one step at 2 layers (1 x 256) against the CPU; then it fits one 4 x
    512 batch of the stream (``SSM_TRAIN``: 10 steps at lr 1e-3), the
    loss falling by ``FIT_DROP`` (5 nats), the peak under 60 GiB.
    ``train_moe``: phi3.5-moe at its published widths cut to 2 layers:
    one step at 1 layer (1 x 64) against the CPU, remat on and off agree
    on one step at 4 x 512, the load-balance loss is finite and above 0;
    then it fits one 4 x 512 batch (``MOE_TRAIN``: 10 steps at lr 3e-4),
    the loss falling by 5 nats.
24. Meshes: ``mesh_kernel`` (right after the bf16 kernel phases) holds
    B1-B4 at a mesh shard's heads against their plain versions;
    ``mesh_replay`` (after training) serves each mesh case sharded and
    unsharded (streams equal, launches shards x layers x counters);
    ``train_mesh`` (before it, ``TRAIN_MESH``) trains qwen3-1.7b at its
    published widths cut to 4 layers for 3 AdamW steps (8 x 512 of the
    Markov stream, lr 1e-3, float32) unsharded and over a data 2 x model
    2 mesh on four shards of the card (``launch.steps``'
    ``sharded_train_step``): step 1's loss and every gathered gradient
    leaf against the unsharded step's (the gate at ``MESH_GRAD_RTOL``),
    later losses within 1e-4, parameters within 2 x 3 x lr, replicated
    parts bit-equal across shards after each step, each shard's resting
    bytes those its specs predict, each shard's collectives of a step
    those ``launch/dryrun.py``'s one-shard run of the same shapes counts,
    no kernel or plain version launched; it prints the step times, the
    peak and the phase's seconds.

25. The kernels' remaining dtypes.  float16 KV (``EngineConfig(dtype=
    torch.float16)``): every B1-B4 case again over fp16 pools (right after
    the bf16 ones; held at the float32 limit, pools bit-equal as 16-bit
    patterns, poisoned keys unread, ``self_midpage`` carried past the
    limit by the unrounded chunk; the main shapes timed and B1's and B2's
    replay shapes), ``fp16_streams`` (the spec and MLA stream scripts over
    fp16 pools against the plain attention, as ``bf16_streams``; B5 and B6
    never launch) and ``fp16_spec_replay`` / ``fp16_mla_replay`` (after
    their bf16 replays: launches = layers x counters, pool bytes half of
    float32's).  bf16 inputs (``lowp_kernel_phase``, with the kernel
    phases): B1 with bf16 queries over bf16 pages, B6 and B5 over bf16
    inputs, at the reference tests' shapes and the launch layer's
    (whisper's encoder, cross prefill and cross decode of two lanes;
    mamba2's 2 x 512-token prefill in chunks of 128), every element within
    one bf16 rounding of the plain version's float32 result (``LOWP_RTOL``,
    ``LOWP_ATOL``); timed at B1's main shape, the encoder and the prefill.
    ``bf16_launch_steps`` (after the whisper replay): the launch layer's
    bf16 prefill and serve steps on real tensors (``LAUNCH_STEPS``:
    whisper-large-v3 and mamba2-2.7b at their published widths and depth,
    2 lanes, 8 serve steps), B6 once per encoder and cross layer per step,
    B5 once per SSM layer per prefill, against the same steps through the
    plain versions (the gate read against a control run in the same call).
    A ``new_phase_seconds`` line gives these phases' seconds, step 26's
    and 27's, and the script's total.

26. llama-3.2-vision-11b at its published widths, its 40 layers cut to
    10 (``VLM_LAYERS``; ``cross_attn`` blocks 3 and 8 among them; random
    weights from the seed, float32), every cross gate set to 1 (0 at
    init: the image would add nothing), each request's image embeddings
    (1, 1600, 4096) from a numpy seed (the vision encoder is a stub).
    ``vlm_stream`` (after the whisper replay): one prompt's first-step
    logits under two images differ by at least ``VLM_IMAGE_MOVES``, then
    the stream script's greedy streams, each lane with its own image,
    against plain generation under the tie rule (with the peak GiB).
    ``vlm_replay``: ``ServingFrontend`` over
    ``ServingEngine(VLM_ENGINE)`` serves the whisper replay's 8 chatbot
    requests, each submitted with its image as ``enc_states``; counts
    zeroed just before the replay: B6 = 2 x (prefill groups + decode
    steps), B2 = 10 x prefill groups and B1 = 10 x decode steps (every
    block has self-attention), no other kernel, no plain call, the B6
    shapes (which must hold step 14's VLM replay shapes), spans, peak, and
    a decode step of eight lanes by part (the cross K/V projection of
    every step and cross layer, as in the reference).
27. ``examples`` (after ``mesh_replay``, before the gateway): each
    ``examples/torch_*.py`` through its ``main()`` at its defaults (the
    card; smollm-135m at its published width where it serves or trains),
    one line each with its numbers, launches, wall seconds, peak GiB and
    the card line: the served examples launch B1 and B2 and no plain
    version, the spec demo B3; the multi-replica example's page budgets
    drain to 0 and prefix affinity saves at least as many prompt tokens as
    round-robin; the training example's checkpoint lands (in a temporary
    directory under ``build/``, removed after) and its losses are finite,
    and run again at the reduced config (the reference example's) its
    loss falls by ``TRAIN_LOSS_DROP`` (the means of the first and of the
    last three logged losses).

Every earlier replay also checks that B6 never launched: only the
no-cache attention of plain generation (steps 3, 5, 6, 15, 17-19, 22,
26), the encoder / cross-attention of steps 15-16 and 26 and step 25's
launch steps run it.

It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import functools
import gc
import importlib.util
import io
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

# a kernel case passes when max |kernel - plain| over its valid outputs is
# at most ATOL + RTOL * max |plain| there (``limit``): the fp32 sums of the
# kernels and their plain versions run in other orders, and their
# difference grows with the outputs (B5's y reaches |y| 179 on mamba2's
# draws).  Set from readings of sound runs over several draws of every
# case (PERF.md).
ATOL = 5e-5
RTOL = 1e-6
TIE = 1e-4                     # a top-2 logit margin below it is a tie
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOP_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
TF32_FLOP_PER_S = 495e12       # H100 SXM TF32 tensor cores, dense
BF16_FLOP_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
BF16 = torch.bfloat16
# the 16-bit KV pool dtypes and the tags of their phases and paths
DTYPE_TAG = {torch.bfloat16: "bf16", torch.float16: "fp16"}
N_TIMED = 20


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also gets ``t_s``, the seconds since
    the script started, so that each phase's share of the time limit
    shows."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


def limit(want) -> float:
    """The largest |kernel - plain| a case may show over the outputs
    ``want`` (the plain version's, valid rows only)."""
    return ATOL + RTOL * want.abs().max().item()


def free_device_memory() -> None:
    """Drop the previous phase's engines (the engine and its speculative
    decoder refer to each other, so only the cycle collector frees them)
    before the next phase allocates and measures its peak."""
    gc.collect()
    torch.cuda.empty_cache()


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# ------------------------------ timing --------------------------------- #
_FLUSH = None
# the name the profiler gives the flush's fill (float64: nothing timed
# here fills float64, so every other kernel of a timed call is counted)
FLUSH_KERNEL = "FillFunctor<double>"


def flush_l2() -> None:
    """A 200 MB write that evicts the 50 MB L2 cache (the main path reads
    each layer's pages cold)."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(25_000_000, dtype=torch.float64, device="cuda")
    _FLUSH.fill_(1.0)


def time_ms(fn) -> float:
    """Mean time of ``fn`` over N_TIMED launches, each after the L2 flush,
    by CUDA events around the call (the host's dispatch included)."""
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(N_TIMED):
        flush_l2()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1)
    return total / N_TIMED


# the CUDA kernels of each port kernel (split and merge launches), by a
# substring of their names in the profiler
KERNEL_NAMES = {
    "paged_decode_attention": ("paged_decode_kernel", "split_merge_kernel"),
    "paged_prefill_attention": ("paged_prefill_kernel", "split_merge_kernel"),
    "paged_verify_attention": ("paged_verify", "split_merge_kernel"),
    "mla_paged_prefill_attention": ("mla_prefill_kernel",
                                    "split_merge_kernel"),
    "ssd_scan": ("ssd_kernel", "ssd_cb_kernel"),
    "flash_attention_bh": ("flash_attention_kernel", "split_merge_kernel"),
}


def cuda_profile(fn, n: int = N_TIMED, flush: bool = True):
    """``torch.profiler``'s reading of n calls of ``fn`` (each after the L2
    flush when ``flush``): {kernel name: (launches per call, mean device ms
    per launch, launches recorded)}, the flush's own fill left out.  The
    profiler does not record every launch (19 of 20 flushes in one
    reading on an H100), so a kernel's time is its mean over the launches
    it recorded times its launches per call, ceil(recorded / n), never its
    recorded total over n.  None if the profiler saw no device time, or
    with ``flush`` no flush (then its fill could not be told apart: "not
    measured")."""
    fn()
    torch.cuda.synchronize()
    prof = torch.profiler
    with prof.profile(activities=[prof.ProfilerActivity.CUDA]) as tr:
        for _ in range(n):
            if flush:
                flush_l2()
            fn()
        torch.cuda.synchronize()
    out, flushes = {}, 0
    for e in tr.key_averages():
        if getattr(e, "device_type", None) != prof.DeviceType.CUDA \
                or e.count == 0:
            continue
        if flush and FLUSH_KERNEL in e.key:
            flushes += e.count
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        out[e.key] = (-(-e.count // n), us / 1e3 / e.count, e.count)
    if not out or (flush and flushes == 0):
        return None
    return out


def cuda_sum(reading, names=None):
    """(device ms, launches) per call of the kernels of a ``cuda_profile``
    reading whose names hold one of ``names`` (all of them when None);
    (None, None) when there is no reading."""
    if reading is None:
        return None, None
    picked = [v for k, v in reading.items()
              if names is None or any(n in k for n in names)]
    return sum(c * ms for c, ms, _ in picked), sum(c for c, _, _ in picked)


def device_ms(fn, kernel: str):
    """The kernel's own device time per call, without the wrapper's host
    time: the launches named in KERNEL_NAMES (a key split's merge
    included) in a ``cuda_profile`` of N_TIMED calls.  Returns (ms,
    {launch name: ms}, {launch name: launches recorded of N_TIMED}); ms is
    None if the profiler saw no such launch (then "not measured")."""
    reading = cuda_profile(fn)
    parts, seen = {}, {}
    for n in KERNEL_NAMES[kernel]:
        ms, _ = cuda_sum(reading, (n,))
        if ms:
            parts[n] = ms
            seen[n] = sum(v[2] for k, v in reading.items() if n in k)
    total = sum(parts.values())
    return (total if total > 0 else None), parts, seen


def library_device_ms(fn):
    """The device time per call of every kernel a library call launches
    (the flush's fill left out), from a ``cuda_profile`` of N_TIMED calls:
    the yardstick read the same way as ``device_ms`` reads a kernel."""
    return cuda_sum(cuda_profile(fn))[0]


class ParentKernels:
    """B5 and B3 as another tree of the repo builds them (``--parent DIR``,
    DIR a checkout such as a ``git archive`` of the parent commit), called
    through that tree's own wrapper modules and the C interfaces they have
    there (before their redesign: B5 without the C.B^T workspace, B3 with its merge as a second launch), and timed beside this
    tree's at the same inputs in the same run."""
    _P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    SIGNATURES = {
        "ssd_scan": ("repro_ssd_scan_f32", [_P] * 8 + [_I] * 6 + [_P]),
        "paged_verify": ("repro_paged_verify_f32",
                         [_P] * 12 + [_I] * 7 + [_F, _I, _I, _P]),
    }

    def __init__(self, root: str):
        from repro_torch.kernels import build
        out = build.BUILD_DIR.parent / "parent_kernels"
        out.mkdir(parents=True, exist_ok=True)
        self.root = Path(root).resolve()
        csrc = self.root / "src" / "repro_torch" / "csrc"
        procs = {name: subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o",
             str(out / f"lib{name}.so"), str(csrc / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for name in self.SIGNATURES}
        self.fns, self.ptxas = {}, {}
        for name, proc in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise SystemExit(
                    f"parent csrc/{name}.cu does not build:\n{log}")
            self.ptxas[name] = [ln.strip() for ln in log.splitlines()
                                if "registers" in ln or "spill" in ln]
            fn_name, argtypes = self.SIGNATURES[name]
            fn = getattr(ctypes.CDLL(str(out / f"lib{name}.so")), fn_name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            self.fns[name] = fn

    @contextlib.contextmanager
    def wrapper(self, name: str):
        """The other tree's wrapper module ``kernels/<name>.py``, launching
        its kernel, while the context lasts (this tree's module is left as
        it is; the other tree's launcher stands in ``build._FNS[name]``).
        Yields the module (its ``COUNTS`` count the launches)."""
        from repro_torch.kernels import build
        spec = importlib.util.spec_from_file_location(
            f"parent_{name}",
            self.root / "src" / "repro_torch" / "kernels" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        saved = build.load(name)
        build._FNS[name] = self.fns[name]
        try:
            yield mod
        finally:
            build._FNS[name] = saved

    def _measure(self, name, call, kernel, err):
        """ms, device ms (with its parts: B3's split and merge launches)
        and the error against the plain version of ``call(module)``."""
        with self.wrapper(name) as mod:
            out = call(mod)
            torch.cuda.synchronize()
            dev, parts, seen = device_ms(lambda: call(mod), kernel)
            return {"ms": time_ms(lambda: call(mod)), "device_ms": dev,
                    "device_ms_parts": parts, "device_launches_seen": seen,
                    "max_abs_err": err(out)}

    def verify(self, q, kn, vn, kp, vp, table, p0, cl, window, want, valid):
        kp, vp = kp.clone(), vp.clone()
        return self._measure(
            "paged_verify", lambda m: m.paged_verify_attention(
                q, kn, vn, kp, vp, table, p0, cl, window=window)[0],
            "paged_verify_attention",
            lambda got: (got - want).abs()[valid].max().item())

    def ssd(self, xh, dt, A, Bm, Cm, h0, chunk, wy, wh):
        return self._measure(
            "ssd_scan", lambda m: m.ssd_scan(xh, dt, A, Bm, Cm, chunk=chunk,
                                             init_state=h0),
            "ssd_scan", lambda got: max((got[0] - wy).abs().max().item(),
                                        (got[1] - wh).abs().max().item()))


def bound(n_bytes: float, n_flops: float, flop_rate: float = None):
    """The least time (ms) of moving ``n_bytes`` or doing ``n_flops`` at
    ``flop_rate`` (the float32 peak unless given), and which binds."""
    t_b = n_bytes / HBM_BYTES_PER_S
    t_f = n_flops / (flop_rate or FP32_FLOP_PER_S)
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def tf32x3_floor_ms(n_bytes: float, n_flops: float) -> float:
    """The least time of the same work done as 3xTF32 tensor-core products
    (three TF32 products per float32 one, at the tensor cores' dense TF32
    peak) or by moving its bytes, whichever is longer: the floor of the
    tensor-core kernels (B2, B4, B5, B6), beside the float32 bound."""
    return max(n_bytes / HBM_BYTES_PER_S,
               3 * n_flops / TF32_FLOP_PER_S) * 1e3


# ------------------------------ inputs --------------------------------- #
def pools_and_tables(gen, B, KVH, hd, page, max_pages, dtype=torch.float32):
    """K/V pools of ``dtype`` (normal draws, rounded to it) and a
    permuted block table."""
    n_pages = B * max_pages + 5
    kp = torch.randn(n_pages, page, KVH, hd, generator=gen, device="cuda")
    vp = torch.randn(n_pages, page, KVH, hd, generator=gen, device="cuda")
    perm = torch.randperm(n_pages, generator=gen, device="cuda")
    table = perm[:B * max_pages].reshape(B, max_pages).to(torch.int32)
    return kp.to(dtype), vp.to(dtype), table.contiguous()


def pages_visited(lo_pos, hi_pos, page):
    """Pages holding positions [lo_pos, hi_pos)."""
    return max(0, (hi_pos + page - 1) // page - max(lo_pos, 0) // page)


# ---------------------------- decode phase ----------------------------- #
# "main" keeps the shape PRs 11-15 timed; "replay" is the smollm replay's
# commonest decode step (one lane; 1861 keys, the median over the one-lane
# steps of a CPU rehearsal of the replay at the card's engine config; the
# main path checks that it ran one-lane steps); "whisper" is
# whisper-large-v3's decoder self-attention (G 1 over a 448-token table);
# "phi4" is phi4-mini-3.8b behind the gateway (G 3 at head dim 128, which
# takes the kernel's group-4 instantiation with one row masked; a 1024-
# token table, lengths from one key to full, and a padded lane: a length
# of 0 in a case makes a lane alias lane 0's table and length, as the
# engine pads a decode group); "zamba2*" are zamba2-7b's shared attention
# (32 query over 32 KV heads of 112: G 1 at the head dim whose rows take
# 28 of a stream's 32 lanes) over its 64-page table: eight lanes (2 key
# splits), twelve (one split) and the hybrid replay's commonest decode
# step (one lane over 338 keys: 151 of its 294 decode steps in a CPU
# rehearsal of the replay at the card's engine config; 9 splits);
# "phi35_moe" is phi3.5-moe's attention (32 query / 8 KV heads of 128:
# G 4).
DECODE_CASES = [   # name, B, H, KVH, hd, page, max_pages, lens, window
    ("main", 8, 9, 3, 64, 16, 256,
     [1, 17, 333, 780, 1024, 1500, 1999, 2048], None),
    ("replay", 1, 9, 3, 64, 16, 256, [1861], None),
    ("hd32", 8, 6, 2, 32, 8, 64, [1, 8, 9, 100, 200, 300, 500, 512], None),
    ("hd128_window", 4, 16, 8, 128, 16, 400, [6000, 4097, 4096, 37], 4096),
    ("whisper", 8, 20, 20, 64, 16, 28, [1, 15, 16, 17, 100, 250, 447, 448],
     None),
    ("phi4", 8, 24, 8, 128, 16, 64, [1, 17, 130, 256, 531, 700, 1024, 0],
     None),
    ("zamba2", 8, 32, 32, 112, 16, 64, [1, 17, 130, 256, 531, 700, 1024, 0],
     None),
    ("zamba2_unsplit", 12, 32, 32, 112, 16, 64,
     [1, 16, 17, 33, 100, 338, 512, 763, 900, 1000, 1024, 0], None),
    ("zamba2_replay", 1, 32, 32, 112, 16, 64, [338], None),
    ("phi35_moe", 8, 32, 8, 128, 16, 64, [1, 17, 130, 256, 531, 700, 1024,
                                          0], None),
]
DECODE_TIMED = ("main", "replay", "zamba2", "zamba2_replay")
# every case runs again over bfloat16 pools (EngineConfig.dtype); these
# are timed
BF16_DECODE_TIMED = ("main", "replay")


def decode_phase(pa, dtype=torch.float32, cases=None, timed=DECODE_TIMED,
                 seed=1, case_list=DECODE_CASES, split_heads=None):
    """B1 against its plain version on the same pools of ``dtype`` (the
    cases of ``case_list`` named in ``cases``, every case when None); then
    every key no query may see is set to 1e4 and the output must not
    move.  ``split_heads``: the KV head count handed to the wrapper's
    split rule, as a mesh shard hands it the unsharded count."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    kw = {} if split_heads is None else {"split_heads": split_heads}
    results = {}
    for name, B, H, KVH, hd, page, max_pages, lens, window in case_list:
        if cases is not None and name not in cases:
            continue
        kp, vp, table = pools_and_tables(gen, B, KVH, hd, page, max_pages,
                                         dtype)
        padded = [b for b, n in enumerate(lens) if n == 0]
        if padded:
            lens = [lens[0] if n == 0 else n for n in lens]
            table[padded] = table[0].clone()
        q = torch.randn(B, H, hd, generator=gen, device="cuda")
        sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        scale = hd ** -0.5
        got = pa.paged_decode_attention(q, kp, vp, table, sl, window=window,
                                        **kw)
        want = pa.paged_decode_plain(q, kp, vp, table, sl, scale=scale,
                                     window=window)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        lim = limit(want)
        # poison every key the queries may not see: the output must not move
        kpp, vpp = kp.clone(), vp.clone()
        mapped = torch.zeros(kp.shape[0], dtype=torch.bool, device="cuda")
        mapped[table.long().flatten()] = True
        kpp[~mapped] = 1e4
        vpp[~mapped] = 1e4
        pos = torch.arange(max_pages * page, device="cuda")
        bad = pos[None] >= sl[:, None]
        if window is not None:
            bad |= pos[None] < sl[:, None] - window
        flat = (table.long()[:, :, None] * page
                + torch.arange(page, device="cuda")).reshape(B, -1)
        kpp.view(-1, KVH, hd)[flat[bad]] = 1e4
        vpp.view(-1, KVH, hd)[flat[bad]] = 1e4
        poisoned = pa.paged_decode_attention(q, kpp, vpp, table, sl,
                                             window=window, **kw)
        perr = (poisoned - got).abs().max().item()
        ok = err <= lim and perr <= lim and bool(torch.isfinite(got).all())
        rec = {"phase": "kernel", "kernel": "paged_decode_attention",
               "case": name, "page_dtype": str(dtype).split(".")[-1],
               "B": B, "H": H, "KVH": KVH, "hd": hd,
               "page": page, "seq_lens": lens, "padded_lanes": padded,
               "window": window,
               "splits": pa.n_splits(B, split_heads or KVH, page, max_pages,
                                     window, n_sms),
               "max_abs_err": err, "max_abs_plain": want.abs().max().item(),
               "limit": lim, "poisoned_err": perr, "ok": ok}
        if name in timed:
            rec.update(decode_timing(pa, q, kp, vp, table, sl, lens, window,
                                     kw))
            results[name] = rec
        emit(rec)
        if not ok:
            raise SystemExit(f"paged_decode_attention disagrees ({name})")
    return results


def gathered_kv(kp, vp, table, n_keys, G, dtype=torch.float32):
    """K/V of each lane's first ``n_keys`` positions, gathered from its
    pages, converted to ``dtype`` (the queries') and repeated over the
    query heads: (B, H, T, hd) for SDPA."""
    B = table.shape[0]
    _, page, KVH, hd = kp.shape
    idx = table.long()[:, :(n_keys + page - 1) // page]

    def one(pool):
        return pool[idx].to(dtype).reshape(B, -1, KVH, hd).transpose(1, 2) \
            .repeat_interleave(G, 1).contiguous()
    return one(kp), one(vp)


def decode_timing(pa, q, kp, vp, table, sl, lens, window, kw=None,
                  lib_dtype=torch.float32):
    """Times and bounds of B1 at one case; ``lib_dtype``: the dtype of the
    yardstick's SDPA call (the queries'), float32 but for bf16 queries,
    whose flops the bound also takes at the bf16 rate."""
    kw = kw or {}
    B, H, hd = q.shape
    _, page, KVH, _ = kp.shape
    G = H // KVH
    scale = hd ** -0.5
    # the yardstick sees only the pages up to the longest lane
    k, v = gathered_kv(kp, vp, table, max(lens), G, lib_dtype)
    pos = torch.arange(k.shape[2], device="cuda")
    mask = pos[None] < sl[:, None]
    if window is not None:
        mask &= pos[None] >= sl[:, None] - window
    mask = mask[:, None, None, :]
    qs = q[:, :, None, :]
    F = torch.nn.functional
    kernel_ms = time_ms(lambda: pa.paged_decode_attention(
        q, kp, vp, table, sl, window=window, **kw))
    kernel_dev_ms, dev_parts, dev_seen = device_ms(
        lambda: pa.paged_decode_attention(q, kp, vp, table, sl,
                                          window=window, **kw),
        "paged_decode_attention")
    plain_ms = time_ms(lambda: pa.paged_decode_plain(
        q, kp, vp, table, sl, scale=scale, window=window))

    def library():
        return F.scaled_dot_product_attention(
            qs, k, v, attn_mask=mask, scale=scale)

    library_ms = time_ms(library)
    library_dev_ms = library_device_ms(library)
    # bytes: q read and out written once, seq_lens, and per lane the table
    # entries of the pages it visits and the K/V rows of the keys it sees
    # (one KV head's row is hd contiguous elements of the pools' dtype, so
    # no whole pages); flops: 4*hd per (query head, visible key)
    kv_size = kp.element_size()
    n_bytes = q.element_size() * 2 * B * H * hd + 4 * B
    n_flops = 0
    for n in lens:
        lo = 0 if window is None else max(n - window, 0)
        n_bytes += 4 * pages_visited(lo, n, page)
        n_bytes += kv_size * 2 * (n - lo) * KVH * hd
        n_flops += 4 * H * hd * (n - lo)
    bound_ms, bound_by = bound(
        n_bytes, n_flops, BF16_FLOP_PER_S if q.dtype == BF16 else None)
    return {"ms": kernel_ms, "device_ms": kernel_dev_ms,
            "device_ms_parts": dev_parts, "device_launches_seen": dev_seen,
            "plain_ms": plain_ms,
            "library_ms": library_ms, "library_device_ms": library_dev_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_call": "scaled_dot_product_attention over K/V gathered "
                            "up to the longest lane (converted to "
                            f"{str(lib_dtype).split('.')[-1]})"}


# -------------------- prefill and verify phases ------------------------ #
# B2 (fused prefill) and B3 (fused verify) compute the same function of the
# same arguments; one phase holds each against its plain version.
# "main" keeps the shape PRs 11-15 timed; "replay" is the smollm replay's
# commonest prefill group (one lane, an 8-row bucket: 849 of 1156 groups
# in a CPU rehearsal of the replay at the card's engine config, with 2.3
# live rows on average after a median 477 keys of history; the main path
# checks that it ran one-lane 8-row groups); "g1" is whisper-large-v3's
# decoder (20 query over 20 KV heads, a 448-token table); "phi4" is
# phi4-mini-3.8b behind the gateway (24 query over 8 KV heads, head dim
# 128: a GQA group of 3; 128-row chunks from mid-page starts and a masked
# lane, over its 64-page table); "zamba2*" are zamba2-7b's shared
# attention (32 over 32 heads of 112) over its 64-page table: 128-row
# chunks from mid-page starts with a masked lane (3 key splits), 256-row
# ones (192 query tiles: one split) and the hybrid replay's commonest
# prefill group (one lane's 32-row bucket with 17 live rows: 27 of its 61
# groups in a CPU rehearsal at the card's engine config; pos0 99, the
# median of that bucket's; 9 splits); "phi35_moe" is phi3.5-moe's
# attention (32 over 8 heads of 128, G 4).
PREFILL_CASES = [  # name, B, S, H, KVH, hd, page, max_pages, pos0, clen, win
    ("main", 8, 512, 9, 3, 64, 16, 256,
     [0, 0, 7, 512, 1000, 1480, 0, 0], [512, 300, 512, 512, 488, 512, 1, 0],
     None),
    ("replay", 1, 8, 9, 3, 64, 16, 256, [477], [2], None),
    ("g1", 4, 64, 20, 20, 64, 16, 28, [0, 100, 37, 380], [64, 30, 64, 0],
     None),
    ("hd32", 8, 64, 6, 2, 32, 8, 32,
     [0, 3, 8, 100, 77, 0, 0, 0], [64, 64, 64, 1, 40, 0, 0, 0], None),
    ("hd128_window", 4, 512, 16, 8, 128, 16, 400,
     [5488, 4000, 9, 0], [512, 300, 512, 0], 4096),
    ("phi4", 4, 128, 24, 8, 128, 16, 64, [0, 130, 375, 896],
     [128, 106, 128, 0], None),
    ("zamba2", 4, 128, 32, 32, 112, 16, 64, [0, 130, 375, 896],
     [128, 106, 128, 0], None),
    ("zamba2_unsplit", 3, 256, 32, 32, 112, 16, 64, [0, 37, 500],
     [256, 250, 0], None),
    ("zamba2_replay", 1, 32, 32, 32, 112, 16, 64, [99], [17], None),
    ("phi35_moe", 4, 128, 32, 8, 128, 16, 64, [0, 130, 375, 896],
     [128, 106, 128, 0], None),
    ("self_midpage", 1, 64, 9, 3, 64, 16, 16, [5], [60], None),
]
# "self_midpage": a chunk of 60 rows from position 5 (mid-page) over 5
# keys of history, so its rows attend mostly over the chunk's own keys:
# over bf16 pools a kernel that attended over the unrounded k_new / v_new
# in place of the rows it writes would miss the limit (the phase reports
# by how much, ``unrounded_chunk_err``).
# B3 at qwen3-1.7b's heads (16 query, 8 KV, head dim 128; one lane, an 8-
# or 16-row window with 1 to 9 live rows) over histories of 0, 37, 524,
# 555 and 1995 keys (one split with keys, a few, and all of them), a
# 4096-token window over 6000 keys, and smollm's group (head dim 64, G 3)
# with a masked lane.  "main" is the spec replay's shape: its planner
# drafts one token per verify, so the window holds 2 live rows padded to
# 8, at positions 512 to 536 after a 512-token prompt (the replay checks
# that it ran this window and prints the positions).
VERIFY_CASES = [
    ("main", 1, 8, 16, 8, 128, 16, 64, [524], [2], None),
    ("hist0", 1, 16, 16, 8, 128, 16, 64, [0], [9], None),
    ("hist37_clen1", 1, 16, 16, 8, 128, 16, 64, [37], [1], None),
    ("hist37_clen5", 1, 16, 16, 8, 128, 16, 64, [37], [5], None),
    ("hist555_clen9", 1, 16, 16, 8, 128, 16, 64, [555], [9], None),
    ("hist2000", 1, 16, 16, 8, 128, 16, 160, [1995], [7], None),
    ("window", 1, 16, 16, 8, 128, 16, 400, [6000], [8], 4096),
    ("smollm", 2, 16, 9, 3, 64, 16, 64, [300, 0], [4, 0], None),
]


PREFILL_TIMED = ("main", "replay", "zamba2", "zamba2_replay")
# B3 is timed at the spec replay's window and over a 2000-key history
VERIFY_TIMED = ("main", "hist2000")
# the bf16 cases timed
BF16_PREFILL_TIMED = ("main", "replay")
BF16_VERIFY_TIMED = ("main", "hist2000")


def prefill_phase(pp, dtype=torch.float32, cases=None, timed=PREFILL_TIMED,
                  seed=2, case_list=PREFILL_CASES, split_heads=None):
    """B2's cases (``split_heads`` as in ``decode_phase``)."""
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    kw = {} if split_heads is None else {"split_heads": split_heads}
    return chunk_phase(
        "paged_prefill_attention",
        functools.partial(pp.paged_prefill_attention, **kw),
        pp.paged_prefill_plain, case_list, seed=seed, timed=timed,
        extra=lambda B, S, H, KVH, page, max_pages, window: {
            "splits": pp.n_splits(B, S, H // KVH, split_heads or KVH, page,
                                  max_pages, window, n_sms)},
        dtype=dtype, only=cases)


def verify_phase(pv, parent=None, dtype=torch.float32, cases=None,
                 timed=VERIFY_TIMED, seed=3, case_list=VERIFY_CASES,
                 split_heads=None):
    """B3's cases (``split_heads`` as in ``decode_phase``)."""
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    kw = {} if split_heads is None else {"split_heads": split_heads}
    return chunk_phase(
        "paged_verify_attention",
        functools.partial(pv.paged_verify_attention, **kw),
        pv.paged_verify_plain, case_list, seed=seed, timed=timed,
        extra=lambda B, S, H, KVH, page, max_pages, window: {
            "splits": pv.n_splits(B, split_heads or KVH, page, max_pages,
                                  window, n_sms)},
        parent=None if parent is None else parent.verify, dtype=dtype,
        only=cases)


def chunk_phase(kernel_name, kernel, plain, cases, seed, timed, extra=None,
                parent=None, dtype=torch.float32, only=None):
    """Each case (of those named in ``only``, every one when None): the
    kernel against its plain version on the same pools of ``dtype``, with
    every key no live row may see poisoned (unmapped pages; in each lane's
    pages the positions at or past pos0, whose keys come from k_new /
    v_new, and those below the widest window).  Outputs agree on valid
    rows, pools bit-equal, pages outside the write set unchanged, padded
    rows zeros.  Over bf16 pools each line also gives how far the plain
    arithmetic moves when the chunk attends over its unrounded rows
    (float32 pools holding the same history), which the ``self_midpage``
    case must carry past the limit.  The cases named in ``timed`` are
    timed, and with ``parent`` (``ParentKernels.verify``) the other tree's
    kernel beside; returns their records by name."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    results = {}
    for (name, B, S, H, KVH, hd, page, max_pages, pos0, clen,
         window) in cases:
        if only is not None and name not in only:
            continue
        kp, vp, table = pools_and_tables(gen, B, KVH, hd, page, max_pages,
                                         dtype)
        q = torch.randn(B, S, H, hd, generator=gen, device="cuda")
        kn = torch.randn(B, S, KVH, hd, generator=gen, device="cuda")
        vn = torch.randn(B, S, KVH, hd, generator=gen, device="cuda")
        p0 = torch.tensor(pos0, dtype=torch.int32, device="cuda")
        cl = torch.tensor(clen, dtype=torch.int32, device="cuda")
        # masked lanes alias lane 0's table, as engine padding does
        for b in range(B):
            if clen[b] == 0:
                table[b] = table[0]
        scale = hd ** -0.5
        mapped = torch.zeros(kp.shape[0], dtype=torch.bool, device="cuda")
        mapped[table.long().flatten()] = True
        kp[~mapped] = 1e4
        vp[~mapped] = 1e4
        pos = torch.arange(max_pages * page, device="cuda")
        flat = (table.long()[:, :, None] * page
                + torch.arange(page, device="cuda")).reshape(B, -1)
        for b in range(B):
            if clen[b] == 0:
                continue
            bad = pos >= pos0[b]
            if window is not None:
                bad |= pos <= pos0[b] - window
            kp.view(-1, KVH, hd)[flat[b][bad]] = 1e4
            vp.view(-1, KVH, hd)[flat[b][bad]] = 1e4
        kp_k, vp_k = kp.clone(), vp.clone()
        got, _, _ = kernel(q, kn, vn, kp_k, vp_k, table, p0, cl,
                           window=window)
        kp_p, vp_p = kp.clone(), vp.clone()
        want, _, _ = plain(q, kn, vn, kp_p, vp_p, table, p0, cl, scale=scale,
                           window=window)
        torch.cuda.synchronize()
        valid = (torch.arange(S, device="cuda")[None] < cl[:, None])
        err = (got - want).abs()[valid].max().item()
        lim = limit(want[valid])
        pools_equal = bit_equal(kp_k, kp_p) and bit_equal(vp_k, vp_p)
        written = torch.zeros(kp.shape[0], dtype=torch.bool, device="cuda")
        for b in range(B):
            for slot in range(pos0[b] // page,
                              (pos0[b] + clen[b] + page - 1) // page):
                if clen[b]:
                    written[int(table[b, slot])] = True
        untouched = bool(torch.equal(kp_k[~written], kp[~written])
                         and torch.equal(vp_k[~written], vp[~written]))
        padded_zero = not bool(got[~valid].any())
        ok = (err <= lim and pools_equal and untouched and padded_zero
              and bool(torch.isfinite(got).all()))
        rec = {"phase": "kernel", "kernel": kernel_name, "case": name,
               "page_dtype": str(dtype).split(".")[-1],
               "B": B, "S": S, "H": H, "KVH": KVH, "hd": hd,
               "page": page, "pos0": pos0, "chunk_len": clen,
               "window": window}
        if extra is not None:
            rec.update(extra(B, S, H, KVH, page, max_pages, window))
        if dtype != torch.float32:
            unrounded, _, _ = plain(q, kn, vn, kp.float(), vp.float(), table,
                                    p0, cl, scale=scale, window=window)
            rec["unrounded_chunk_err"] = (unrounded - want).abs()[valid] \
                .max().item()
            if name == "self_midpage":
                ok = ok and rec["unrounded_chunk_err"] > lim
        rec.update({"max_abs_err": err,
                    "max_abs_plain": want[valid].abs().max().item(),
                    "limit": lim, "pools_bit_equal": pools_equal,
                    "unwritten_pages_unchanged": untouched,
                    "padded_rows_zero": padded_zero, "ok": ok})
        if name in timed:
            rec.update(chunk_timing(kernel_name, kernel, plain, q, kn, vn,
                                    kp, vp, table, p0, cl, pos0, clen,
                                    window))
            if parent is not None:
                rec["parent"] = parent(q, kn, vn, kp, vp, table, p0, cl,
                                       window, want, valid)
            results[name] = rec
        emit(rec)
        if not ok:
            raise SystemExit(f"{kernel_name} disagrees ({name})")
    return results


def chunk_timing(kernel_name, kernel, plain, q, kn, vn, kp, vp, table, p0,
                 cl, pos0, clen, window):
    B, S, H, hd = q.shape
    _, page, KVH, _ = kp.shape
    G = H // KVH
    scale = hd ** -0.5
    F = torch.nn.functional
    # SDPA over the K/V gathered after the write, up to the longest lane's
    # end, with the kernel's mask
    kpw, vpw = kp.clone(), vp.clone()
    plain(q, kn, vn, kpw, vpw, table, p0, cl, scale=scale, window=window)
    end = max(p + n for p, n in zip(pos0, clen))
    k, v = gathered_kv(kpw, vpw, table, end, G)
    qs = q.transpose(1, 2).contiguous()
    q_pos = p0.long()[:, None, None] + torch.arange(S, device="cuda")[None, :,
                                                                      None]
    k_pos = torch.arange(k.shape[2], device="cuda")[None, None, :]
    mask = ((k_pos <= q_pos) & (k_pos < (p0 + cl).long()[:, None, None]))
    if window is not None:
        mask &= k_pos > q_pos - window
    mask |= (k_pos == 0)          # keep padded rows finite; not compared
    mask = mask[:, None]
    kernel_ms = time_ms(lambda: kernel(q, kn, vn, kp, vp, table, p0, cl,
                                       window=window))
    kernel_dev_ms, dev_parts, dev_seen = device_ms(lambda: kernel(
        q, kn, vn, kp, vp, table, p0, cl, window=window), kernel_name)
    plain_ms = time_ms(lambda: plain(q, kn, vn, kp, vp, table, p0, cl,
                                     scale=scale, window=window))

    def library():
        return F.scaled_dot_product_attention(
            qs, k, v, attn_mask=mask, scale=scale)

    library_ms = time_ms(library)
    library_dev_ms = library_device_ms(library)
    # bytes: out written in full (padded rows are zeros), pos0 and
    # chunk_len, and per real lane its valid q / k_new / v_new rows, the
    # table entries of the pages it visits, the visible history read once
    # and the chunk's rows written once (both in the pools' dtype); flops:
    # 4*hd per visible (q, k) pair
    kv_size = kp.element_size()
    n_bytes = 4 * (B * S * H * hd + 2 * B)
    n_flops = 0
    for b in range(B):
        n, p = clen[b], pos0[b]
        if n == 0:
            continue
        lo = 0 if window is None else max(p - window + 1, 0)
        n_bytes += 4 * n * (H + 2 * KVH) * hd               # q, k_new, v_new
        n_bytes += 4 * pages_visited(lo, p + n, page)       # table entries
        n_bytes += kv_size * 2 * max(p - lo, 0) * KVH * hd  # history read
        n_bytes += kv_size * 2 * n * KVH * hd               # rows written
        for i in range(n):
            qp = p + i
            vis = qp + 1 if window is None else min(qp + 1, window)
            n_flops += 4 * H * hd * vis
    bound_ms, bound_by = bound(n_bytes, n_flops)
    out = {"ms": kernel_ms, "device_ms": kernel_dev_ms,
           "device_ms_parts": dev_parts, "device_launches_seen": dev_seen,
           "plain_ms": plain_ms,
           "library_ms": library_ms, "library_device_ms": library_dev_ms,
           "bound_ms": bound_ms,
           "bound_by": bound_by,
           "library_call": "scaled_dot_product_attention over K/V gathered "
                           "up to the longest lane, converted to float32 "
                           "(write not included)"}
    if kernel_name == "paged_prefill_attention":    # B2's 3xTF32 products
        out["tf32x3_floor_ms"] = tf32x3_floor_ms(n_bytes, n_flops)
    return out


# ---------------------------- stream check ----------------------------- #
def greedy_reference(params, cfg, prompt, n, dev, enc=None):
    """Plain full-causal greedy generation: n tokens and the top-2 logit
    margin at each.  MoE layers run with the engine's dropless capacity
    factor E / k (exact inference; the model's default 2.0 is the
    reference's training setting, which drops units).  ``enc``: the
    request's encoder states for a cross-attending model."""
    from repro_torch.models import logits_fn, model_forward
    from repro_torch.models.moe import dropless_capacity_factor
    moe_cf = dropless_capacity_factor(cfg)
    toks, margins = list(prompt), []
    with torch.no_grad():
        for _ in range(n):
            h, _, _ = model_forward(params, cfg,
                                    torch.tensor([toks], device=dev),
                                    moe_cf=moe_cf, enc_states=enc)
            lg = logits_fn(params, cfg, h[0, -1])
            top = torch.topk(lg, 2).values
            margins.append((top[0] - top[1]).item())
            toks.append(int(torch.argmax(lg)))
    return toks[len(prompt):], margins


def compare_stream(got, want, margins):
    """Equal, or first different where the reference's top-2 margin is
    below 1e-4 (a tie)."""
    first = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                 None)
    tie = first is not None and margins[first] < TIE
    return {"tokens": len(got), "equal": first is None,
            "first_difference": first, "tie": tie,
            "min_top2_margin": min(margins[:len(got)], default=None),
            "ok": len(got) <= len(want) and (first is None or tie)}


# Three requests of different prompt lengths through the engine: the
# first prefill group holds three lanes (chunks 24, 29 and 20 in the
# 32-token bucket, padded to four lanes with a masked one); the second
# chunks of rids 1 and 3 start mid-page while rid 2 decodes; the decode
# groups pad three lanes to four and freeze them at uneven budgets.
STREAM_PROMPTS = {1: 40, 2: 29, 3: 53}
STREAM_SCRIPT = [
    "admit 1 2 3",
    [(1, "P", 24), (2, "P", 29), (3, "P", 20)],
    [(1, "P", 16), (2, "D", 3), (3, "P", 33)],
    [(1, "D", 5), (2, "D", 2), (3, "D", 7)],
    [(1, "D", 1), (2, "D", 4), (3, "D", 2)],
]


def stream_phase(seed: int):
    """Greedy streams of the engine (chunked lane-batched prefill through
    the fused kernel, padded multi-lane decode through the decode kernel)
    against plain full-causal generation with the same full-width
    weights.  A difference counts only where the reference's top-2 logit
    margin is below 1e-4 (a tie)."""
    from repro_torch.configs import get_config
    from repro_torch.device import generator
    from repro_torch.models import init_params

    cfg = get_config("smollm-135m")
    dev = torch.device("cuda")
    params = init_params(cfg, generator(dev, seed), device=dev)
    engine_streams({"phase": "stream"}, cfg, params, max_len=4096,
                   prompt_seed=seed)


def script_prompts(cfg, prompt_seed, prompt_lens=STREAM_PROMPTS):
    """The stream script's prompts: random tokens from ``prompt_seed``."""
    g = torch.Generator().manual_seed(prompt_seed)
    return {rid: torch.randint(1, cfg.vocab, (n,), generator=g).tolist()
            for rid, n in prompt_lens.items()}


def engine_streams(rec, cfg, params, *, max_len: int, prompt_seed: int,
                   max_slots: int = 8, prompt_lens=STREAM_PROMPTS,
                   script=STREAM_SCRIPT, encs=None):
    """``script`` through a fresh engine (``run_script``), then each
    stream against plain generation; emits ``rec`` with the results and
    fails on a difference that is not a tie.  ``encs``: each request's
    encoder states (1, T, D), for a cross-attending model.  ``rec`` also
    gets the device's peak GiB so far.  Returns the plain generation of
    each request, {rid: tokens}."""
    encs = encs or {}
    dev = torch.device("cuda")
    prompts = script_prompts(cfg, prompt_seed, prompt_lens)
    got, want_len, counters, reused = run_script(
        cfg, params, prompts, script, max_len=max_len, max_slots=max_slots,
        encs=encs)
    rec.update({"requests": len(prompts), "max_slots": max_slots,
                "prefill_calls": counters["prefill_calls"],
                "decode_calls": counters["decode_calls"],
                "reused_slots": reused})
    free_device_memory()
    ok, wants = True, {}
    for rid, prompt in prompts.items():
        want, margins = greedy_reference(params, cfg, prompt, len(got[rid]),
                                         dev, encs.get(rid))
        wants[rid] = want
        r = {"prompt": len(prompt), **compare_stream(got[rid], want, margins)}
        r["ok"] = r["ok"] and len(got[rid]) == want_len[rid]
        ok = ok and r["ok"]
        rec[f"rid{rid}"] = r
        if not r["ok"]:
            r.update(got=got[rid], want=want)
    ok = ok and all(r["lane_rows_zero"] for r in reused.values())
    rec["ok"] = ok
    rec["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    emit(rec)
    if not ok:
        raise SystemExit(f"{rec['phase']}: engine streams differ from plain "
                         "generation (or a reused slot kept lane rows)")
    return wants


def run_script(cfg, params, prompts, script, *, max_len: int,
               max_slots: int = 8, encs=None, dtype=torch.float32):
    """``script`` through a fresh engine over KV pools of ``dtype``
    (``"admit r ..."`` and ``"finish r"`` steps between batches).
    Returns ({rid: stream}, {rid: tokens the script asks for}, the
    engine's counters, reused slots): an admission into a slot that a
    finished request freed is listed with whether the slot's lane rows
    (SSM models) were all zero after the admission."""
    encs = encs or {}
    from repro_torch.core.batch import Batch
    from repro_torch.core.slo import StageKind
    from repro_torch.serving.engine import EngineConfig, ServingEngine

    dev = torch.device("cuda")
    eng = ServingEngine(cfg, params, EngineConfig(max_slots=max_slots,
                                                  max_len=max_len,
                                                  total_pages=64,
                                                  dtype=dtype),
                        device=dev)
    kinds = {"P": StageKind.PREFILL, "D": StageKind.DECODE}
    got = {rid: [] for rid in prompts}
    # one prefill emission + the decode steps
    want_len = {rid: 1 for rid in prompts}
    freed, reused = set(), {}
    for step in script:
        if isinstance(step, str):
            verb, *rids = step.split()
            for rid in map(int, rids):
                if verb == "finish":
                    freed.add(eng.kv.seq_of[rid])
                    eng.finish(rid)
                    continue
                assert eng.add_request(rid, prompts[rid], expected_total=96,
                                       enc_states=encs.get(rid))
                slot = eng.kv.seq_of[rid]
                if slot in freed:
                    rows = [leaf.select(ax, slot) for pool, ax in zip(
                        eng.kv.pools, eng.kv.lane_select_axes()) if ax >= 0
                        for leaf in pool.values()]
                    reused[rid] = {"slot": slot, "lane_rows_zero":
                                   not any(bool(r.any()) for r in rows)}
            continue
        b = Batch()
        for rid, kind, n in step:
            b.add(rid, kinds[kind], n)
            if kind == "D":
                want_len[rid] += n
        for rid, toks in eng.execute(b).items():
            got[rid] += toks
    return got, want_len, dict(eng.counters), reused


# --------------------------- spec-decode phases ------------------------- #
SPEC_ARCH = "qwen3-1.7b"
# its 28 layers cut to 14 for the script's time limit (the spec, bf16 and
# fp16 spec phases share the model; their counts follow the depth)
SPEC_LAYERS = 14
SPEC_PROMPTS = {1: 40, 2: 51, 3: 60}
SPEC_CYCLES = [    # draft length per request per batch (one verify each)
    {1: 3, 2: 8, 3: 1}, {1: 8, 2: 1, 3: 3}, {1: 1, 2: 3, 3: 8},
    {1: 3, 2: 8, 3: 3},
]


def one_layer_draft(cfg, dev, seed):
    """The reference tests' draft recipe: the target's config cut to one
    ``attn`` layer, with its own seed."""
    import dataclasses

    from repro_torch.device import generator
    from repro_torch.models import init_params
    dcfg = dataclasses.replace(cfg, name=cfg.name + "-draft", n_layers=1,
                               block_pattern=("attn",))
    return dcfg, init_params(dcfg, generator(dev, seed), device=dev)


def spec_model(seed: int):
    """qwen3-1.7b at its published width, cut to SPEC_LAYERS, and its
    random weights, shared by the spec phases in float32 and 16 bits."""
    from repro_torch.configs import get_config
    from repro_torch.device import generator
    from repro_torch.models import init_params
    dev = torch.device("cuda")
    cfg = cut_depth(get_config(SPEC_ARCH), SPEC_LAYERS)
    return cfg, init_params(cfg, generator(dev, seed), device=dev)


def spec_prompts(cfg, seed: int):
    g = torch.Generator().manual_seed(seed + 1)
    return {rid: torch.randint(1, cfg.vocab, (n,), generator=g).tolist()
            for rid, n in SPEC_PROMPTS.items()}


def spec_script(cfg, params, prompts, draft, dtype=torch.float32,
                mesh=None):
    """The spec stream script through a fresh engine over KV pools of
    ``dtype`` with ``draft`` (over ``mesh`` when given): the prompts
    prefilled in one group, then the spec cycles of SPEC_CYCLES.  Returns
    ({rid: stream}, the engine's counters)."""
    from repro_torch.core.batch import Batch
    from repro_torch.core.slo import StageKind
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    eng = ServingEngine(cfg, params, EngineConfig(
        max_slots=4, max_len=256, total_pages=64, dtype=dtype, mesh=mesh),
        draft=draft, device=None if mesh is not None else
        torch.device("cuda"))
    b = Batch()
    for rid, prompt in prompts.items():
        assert eng.add_request(rid, prompt, expected_total=128)
        b.add(rid, StageKind.PREFILL, len(prompt))
    got = {rid: list(t) for rid, t in eng.execute(b).items()}
    for cycle in SPEC_CYCLES:
        b = Batch(spec_step=max(cycle.values()))
        for rid, k in cycle.items():
            b.add(rid, StageKind.DECODE, k + 1)
        for rid, toks in eng.execute(b).items():
            got[rid] += toks
    return got, dict(eng.counters)


def spec_stream_phase(cfg, params, seed: int):
    """Speculative decoding of the full-width target (random weights from
    the seed) against plain greedy generation, with the 1-layer draft
    (mostly rejected: rollback of both caches) and with the target as its
    own draft (whole windows accepted, bonus tokens).  Three prompts are
    prefilled, then decoded by spec cycles of draft length 1, 3 and 8.
    Returns the plain generation of each prompt, {rid: tokens}."""
    dev = torch.device("cuda")
    prompts = spec_prompts(cfg, seed)
    drafts = {"one_layer": one_layer_draft(cfg, dev, seed + 7),
              "self": (cfg, params)}
    got = {}
    rec = {"phase": "spec_stream", "model": cfg.name, "layers": cfg.n_layers,
           "prompts": {r: len(p) for r, p in prompts.items()}}
    for name, draft in drafts.items():
        got[name], c = spec_script(cfg, params, prompts, draft)
        rec[name] = {"accepted": c["spec_accepted_tokens"],
                     "drafted": c["spec_drafted_tokens"],
                     "verify_calls": c["spec_verify_calls"]}
    del drafts
    free_device_memory()
    ok = (rec["one_layer"]["accepted"] < rec["one_layer"]["drafted"]
          and rec["self"]["accepted"] > 0)
    wants = {}
    for rid, prompt in prompts.items():
        n = max(len(got[d][rid]) for d in got)
        want, margins = greedy_reference(params, cfg, prompt, n, dev)
        wants[rid] = want
        for name in got:
            r = compare_stream(got[name][rid], want, margins)
            rec[name][f"rid{rid}"] = r
            ok = ok and r["ok"]
            if not r["ok"]:
                r.update(got=got[name][rid], want=want)
    rec["ok"] = ok
    emit(rec)
    if not ok:
        raise SystemExit("spec-decoded streams differ from plain generation")
    return wants


SPEC_REPLAY = dict(requests=8, prompt=512, output=64, tight=0.0125,
                   loose=0.1, ttft_slowdown=8.0)


def spec_replay_phase(cfg, params, kernels, seed: int,
                      dtype=torch.float32, f32=None):
    """The spec path end to end: ``ServingFrontend`` over ``ServingEngine``
    with the target as its own draft and a speculation-planning
    ``SLOsServeScheduler`` (the JAX demo's recipe), eight requests (prompt
    512, output 64) at t = 0, four in a tight TPOT tier and four in a
    loose one, over KV pools of ``dtype``.  The kernel launch counts are
    zeroed just before the replay and checked just after against the
    engine's counters; the verify windows the replay ran must include the
    shape the verify phase timed.  With ``f32`` (the float32 replay's
    record) the pools must hold half its bytes, and its served / attained
    / tokens are printed beside (equal up to the scheduler's ``id()``
    tie-break; not checked).  Returns the phase's record."""
    from repro_torch.core.perf_model import opt_perf_model
    from repro_torch.core.request import simple_request
    from repro_torch.core.scheduler import SchedulerConfig, SLOsServeScheduler
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    from repro_torch.serving.frontend import ServingFrontend

    dev = torch.device("cuda")
    eng = ServingEngine(cfg, params, EngineConfig(
        max_slots=8, max_len=1024, page_size=16, total_pages=2048,
        dtype=dtype), draft=(cfg, params), device=dev)
    sched = SLOsServeScheduler(opt_perf_model(7e9, spec=True), SchedulerConfig(
        page_size=16, prefill_emits_first_token=True, spec_alpha=0.7))
    fe = ServingFrontend(eng, sched)
    timer = SpanTimer()
    eng.tracer = timer
    # the verify windows this run gives B3: "rows/live rows" -> count
    windows: dict[str, int] = {}
    verify_pos0: list[int] = []
    verify_forward = eng._verify_forward

    def seen_verify(cache, tokens, pos0, true_len, *rest):
        key = f"{tokens.shape[1]}/{int(true_len[0])}"
        windows[key] = windows.get(key, 0) + 1
        verify_pos0.append(int(pos0[0]))
        return verify_forward(cache, tokens, pos0, true_len, *rest)
    eng._verify_forward = seen_verify
    R = SPEC_REPLAY
    g = torch.Generator().manual_seed(seed + 2)
    for rid in range(R["requests"]):
        tpot = R["tight"] if rid < R["requests"] // 2 else R["loose"]
        req = simple_request(rid, 0.0, prompt=R["prompt"], output=R["output"],
                             ttft_slowdown=R["ttft_slowdown"], tpot=tpot)
        fe.submit(req, prompt=torch.randint(1, cfg.vocab, (R["prompt"],),
                                            generator=g).tolist())
    planned: dict[str, dict[int, int]] = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for m in kernels.values():
        m.COUNTS["kernel"] = m.COUNTS["plain"] = 0
    t0 = time.perf_counter()
    steps = 0
    while not fe.idle and steps < 2000:
        fe.step()
        steps += 1
        tiers, sls, _ = sched.last_spec_plan or ((), None, None)
        for tier, sl in zip(tiers, sls or [0] * len(tiers)):
            hist = planned.setdefault(str(tier), {})
            hist[sl] = hist.get(sl, 0) + 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: dict(m.COUNTS) for k, m in kernels.items()}
    s, c = fe.stats, eng.counters
    L, Ld = cfg.n_layers, eng.spec.cfg.n_layers
    timed = next(f"{S}/{clen[0]}" for (name, _, S, *_, clen, _)
                 in VERIFY_CASES if name == "main")
    checks = {
        "served_all": s.served == s.submitted == R["requests"],
        "verified": c["spec_verify_calls"] > 0,
        "verify_launches":
            launches["verify"]["kernel"] == L * c["spec_verify_calls"],
        "prefill_launches": launches["prefill"]["kernel"]
            == L * c["prefill_calls"] + Ld * c["spec_catch_up_calls"],
        "decode_launches": launches["decode"]["kernel"]
            == L * c["decode_steps"] + Ld * c["spec_draft_steps"],
        "no_mla_ssd_flash_kernel": all(launches[k]["kernel"] == 0 for k in
                                       ("mla_prefill", "ssd", "flash")),
        "no_plain": not any(v["plain"] for v in launches.values()),
        "timed_verify_window_ran": timed in windows,
    }
    pools = pool_bytes(eng.kv) + pool_bytes(eng.spec.kv)
    if f32 is not None:
        checks["pool_bytes_half"] = 2 * pools == f32["pool_bytes"]
    rec = {"phase": ("spec_replay" if f32 is None
                     else f"{DTYPE_TAG[dtype]}_spec_replay"),
           "page_dtype": str(dtype).split(".")[-1], "pool_bytes": pools,
           "model": cfg.name, "layers": L,
           "draft": "self", "draft_layers": Ld, "submitted": s.submitted,
           "served": s.served, "attained": s.attained, "dropped": s.dropped,
           "tokens_out": s.tokens_out, "steps": steps,
           "accepted": c["spec_accepted_tokens"],
           "drafted": c["spec_drafted_tokens"],
           "planned_sl_per_tier": planned,
           "verify_windows": windows, "timed_verify_window": timed,
           "verify_pos0_range": [min(verify_pos0, default=None),
                                 max(verify_pos0, default=None)],
           "counters": {k: c[k] for k in (
               "prefill_calls", "decode_calls", "decode_steps",
               "decode_tokens", "spec_draft_calls", "spec_verify_calls",
               "spec_draft_steps", "spec_catch_up_calls",
               "verify_fused_ops")},
           "launches": launches, "wall_s": wall, "span_s": timer.seconds,
           "spans": timer.count,
           "outside_spans_s": wall - sum(timer.seconds.values()),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "checks": checks}
    if f32 is not None:
        rec["float32"] = {k: f32[k] for k in (
            "served", "attained", "tokens_out", "wall_s", "peak_mem_gib",
            "pool_bytes")}
    emit(rec)
    if not all(checks.values()):
        raise SystemExit(f"{rec['phase']} checks failed: {checks}")
    return rec


def tree_leaves(tree):
    """The tensors of a (nested) dict / list tree."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [t for x in items for t in tree_leaves(x)]


def pool_bytes(kv) -> int:
    """Device bytes of a KV manager's pools (write-off pages included)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(kv.pools))


# --------------------------- bf16 KV serving ---------------------------- #
# The spec and MLA paths again with EngineConfig(dtype=torch.bfloat16):
# their stream scripts against the same scripts through an engine over
# bf16 pools whose attention calls the kernels' plain versions, and their
# replays on the float32 phases' parameters and page counts.
@contextlib.contextmanager
def plain_paged_attention():
    """The paged branches of ``models/attention.py`` calling the plain
    versions of B1-B4 in place of their wrappers, for one run: the
    yardstick of the bf16 streams (the package has no such switch)."""
    from repro_torch.kernels import mla_paged_prefill as mk
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_prefill as pp
    from repro_torch.kernels import paged_verify as pv
    from repro_torch.models import attention as at

    # split_heads (a mesh shard's split rule) means nothing to a plain
    # version, which does not split
    def decode(q, kp, vp, table, lens, *, scale=None, window=None,
               split_heads=None):
        return pa.paged_decode_plain(
            q, kp, vp, table, lens, window=window,
            scale=q.shape[-1] ** -0.5 if scale is None else scale)

    def chunk(plain):
        def run(q, kn, vn, kp, vp, table, p0, cl, *, scale=None,
                window=None, split_heads=None):
            return plain(q, kn, vn, kp, vp, table, p0, cl, window=window,
                         scale=q.shape[-1] ** -0.5 if scale is None
                         else scale)
        return run

    def mla(*args, scale, split_heads=None):
        return mk.mla_paged_prefill_plain(*args, scale=scale)
    swap = {"paged_decode_attention": decode,
            "paged_prefill_attention": chunk(pp.paged_prefill_plain),
            "paged_verify_attention": chunk(pv.paged_verify_plain),
            "mla_paged_prefill_attention": mla}
    saved = {name: getattr(at, name) for name in swap}
    for name, fn in swap.items():
        setattr(at, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(at, name, fn)


def kv_margin(cfg, params, tokens, dtype) -> float:
    """The yardstick's top-2 logit margin for the token after ``tokens``:
    one prefill of them through an engine over ``dtype`` pools with the
    plain attention (a position's K/V do not depend on how the stream was
    chunked, up to the order of float32 sums)."""
    from repro_torch.core.batch import Batch
    from repro_torch.core.slo import StageKind
    from repro_torch.serving import engine as em
    seen = []
    logits_fn = em.logits_fn

    def capture(p, c, h):
        seen.append(logits_fn(p, c, h))
        return seen[-1]
    em.logits_fn = capture
    try:
        with plain_paged_attention():
            eng = em.ServingEngine(cfg, params, em.EngineConfig(
                max_slots=1, max_len=len(tokens) + 16,
                total_pages=len(tokens) // 16 + 2, dtype=dtype),
                device=torch.device("cuda"))
            assert eng.add_request(0, tokens, expected_total=len(tokens) + 1)
            b = Batch()
            b.add(0, StageKind.PREFILL, len(tokens))
            eng.execute(b)
    finally:
        em.logits_fn = logits_fn
    top = torch.topk(seen[-1][0].float(), 2).values
    return (top[0] - top[1]).item()


def bf16_compare(got, want, f32_want, margin):
    """A bf16 stream against the plain-kernel engine's (equal, or first
    different where ``margin(i)``, the yardstick's top-2 margin there, is
    below 1e-4) and, reported only, how many tokens it agrees with float32
    plain generation before their first difference."""
    first = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                 None)
    tie = first is not None and margin(first) < TIE
    agree = next((i for i, (a, b) in enumerate(zip(got, f32_want))
                  if a != b), min(len(got), len(f32_want)))
    return {"tokens": len(got), "equal": first is None,
            "first_difference": first, "tie": tie,
            "agrees_with_float32_for": agree,
            "ok": len(got) == len(want) and (first is None or tie)}


def kv16_streams_phase(kind, cfg, params, prompts, run, f32_wants, dtype):
    """``run(dtype)`` (a stream script, {rid: stream}) over pools of
    ``dtype`` through the kernels and again with the plain attention
    swapped in: the streams must be equal under the tie rule; each also
    gives how many tokens it agrees with float32 plain generation
    (``f32_wants``).  The kernels' launch counts show the first run
    launched them and the second none, and neither B5 nor B6 launched."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mla_paged_prefill as mk
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_prefill as pp
    from repro_torch.kernels import paged_verify as pv
    from repro_torch.kernels import ssd_scan as sk
    mods = {"decode": pa, "prefill": pp, "verify": pv, "mla_prefill": mk,
            "ssd": sk, "flash": fa}
    for m in mods.values():
        m.COUNTS["kernel"] = m.COUNTS["plain"] = 0
    got = run(dtype)
    kernel_run = {k: dict(m.COUNTS) for k, m in mods.items()}
    free_device_memory()
    for m in mods.values():
        m.COUNTS["kernel"] = m.COUNTS["plain"] = 0
    with plain_paged_attention():
        want = run(dtype)
    plain_run = {k: dict(m.COUNTS) for k, m in mods.items()}
    free_device_memory()
    rec = {"phase": f"{DTYPE_TAG[dtype]}_streams", "path": kind,
           "model": cfg.name, "layers": cfg.n_layers,
           "launches_kernel_run": kernel_run,
           "launches_plain_run": plain_run}
    ok = (not any(v["plain"] for v in kernel_run.values())
          and not any(v["kernel"] for v in plain_run.values())
          and any(v["kernel"] for v in kernel_run.values())
          and not any(r[k]["kernel"] + r[k]["plain"]
                      for r in (kernel_run, plain_run)
                      for k in ("ssd", "flash")))
    for rid, prompt in prompts.items():
        r = bf16_compare(got[rid], want[rid], f32_wants[rid],
                         lambda i: kv_margin(cfg, params,
                                             prompt + want[rid][:i], dtype))
        rec[f"rid{rid}"] = r
        ok = ok and r["ok"]
        if not r["ok"]:
            r.update(got=got[rid], want=want[rid])
    rec["ok"] = ok
    emit(rec)
    if not ok:
        raise SystemExit(f"{rec['phase']} ({kind}): the kernels' streams "
                         "differ from the plain attention's")


# ------------------------------ MLA phases ------------------------------ #
MLA_ARCH = "deepseek-v2-236b"
MLA_CUT = dict(n_layers=3, block_pattern=("mla", "mla_moe", "mla_moe"))
MLA_H, MLA_R, MLA_ROPE = 128, 512, 64
# name, B, S, page, max_pages, pos0, chunk_len.  "main" is the mla
# replay's prefill shape: its planner cuts prompts into chunks of 9 to 15
# tokens (one lane, the 16-row bucket) at positions up to about 250
# (rehearsed on the CPU at reduced width with the same engine and trace;
# the replay checks that it ran this exact chunk, so it is also the
# replay's row).  "split_empty_share" and "few_rows_split4" split the keys
# as "main" does, one with a split whose share of the keys is empty.
MLA_CASES = [
    ("main", 1, 16, 16, 64, [120], [15]),
    ("straddle_midpage", 2, 64, 16, 64, [8, 37], [64, 50]),
    ("pos0_zero_256", 1, 256, 16, 32, [0], [256]),
    ("masked_partial", 4, 32, 16, 64, [37, 0, 300, 0], [32, 0, 17, 0]),
    ("long_history", 2, 16, 16, 80, [1000, 497], [16, 9]),
    ("split_empty_share", 1, 16, 16, 64, [0], [5]),
    ("few_rows_split4", 1, 8, 16, 64, [300], [7]),
]
MLA_TIMED = ("main", "pos0_zero_256")
# the bf16 case timed
BF16_MLA_TIMED = ("main",)


def mla_prefill_phase(mk, dtype=torch.float32, cases=None, timed=MLA_TIMED,
                      seed=4, case_list=MLA_CASES, H=MLA_H,
                      split_heads=None):
    """B4 against its plain version on the same pools of ``dtype`` at
    full-width heads (the cases named in ``cases``, every case when None),
    with every key no live row may see poisoned: unmapped pages, and in
    each live lane's pages the positions at or past pos0 (the chunk's keys
    come from ckv_new / krope_new).  Each line names the key splits the
    wrapper chose.  ``H``: the query heads (a mesh shard's fewer);
    ``split_heads`` as in ``decode_phase``."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    r, rope = MLA_R, MLA_ROPE
    scale = (128 + rope) ** -0.5          # (qk_nope + rope)^-0.5
    kw = {} if split_heads is None else {"split_heads": split_heads}
    results = {}
    for name, B, S, page, max_pages, pos0, clen in case_list:
        if cases is not None and name not in cases:
            continue
        n_pages = B * max_pages + 5
        cp = torch.randn(n_pages, page, r, generator=gen,
                         device="cuda").to(dtype)
        rp = torch.randn(n_pages, page, rope, generator=gen,
                         device="cuda").to(dtype)
        perm = torch.randperm(n_pages, generator=gen, device="cuda")
        table = perm[:B * max_pages].reshape(B, max_pages).to(torch.int32)
        for b in range(B):
            if clen[b] == 0:
                table[b] = table[0]   # masked lanes alias lane 0, as padding
        table = table.contiguous()
        ql = torch.randn(B, S, H, r, generator=gen, device="cuda")
        qr = torch.randn(B, S, H, rope, generator=gen, device="cuda")
        cn = torch.randn(B, S, r, generator=gen, device="cuda")
        rn = torch.randn(B, S, rope, generator=gen, device="cuda")
        p0 = torch.tensor(pos0, dtype=torch.int32, device="cuda")
        cl = torch.tensor(clen, dtype=torch.int32, device="cuda")
        mapped = torch.zeros(n_pages, dtype=torch.bool, device="cuda")
        mapped[table.long().flatten()] = True
        cp[~mapped] = 1e4
        rp[~mapped] = 1e4
        pos = torch.arange(max_pages * page, device="cuda")
        flat = (table.long()[:, :, None] * page
                + torch.arange(page, device="cuda")).reshape(B, -1)
        for b in range(B):
            if clen[b]:
                cp.view(-1, r)[flat[b][pos >= pos0[b]]] = 1e4
                rp.view(-1, rope)[flat[b][pos >= pos0[b]]] = 1e4
        cp_k, rp_k = cp.clone(), rp.clone()
        got, _, _ = mk.mla_paged_prefill_attention(
            ql, qr, cn, rn, cp_k, rp_k, table, p0, cl, scale=scale, **kw)
        cp_p, rp_p = cp.clone(), rp.clone()
        want, _, _ = mk.mla_paged_prefill_plain(
            ql, qr, cn, rn, cp_p, rp_p, table, p0, cl, scale=scale)
        torch.cuda.synchronize()
        valid = torch.arange(S, device="cuda")[None] < cl[:, None]
        err = (got - want).abs()[valid].max().item()
        lim = limit(want[valid])
        pools_equal = bit_equal(cp_k, cp_p) and bit_equal(rp_k, rp_p)
        written = torch.zeros(n_pages, dtype=torch.bool, device="cuda")
        for b in range(B):
            for slot in range(pos0[b] // page,
                              (pos0[b] + clen[b] + page - 1) // page):
                if clen[b]:
                    written[int(table[b, slot])] = True
        untouched = bool(torch.equal(cp_k[~written], cp[~written])
                         and torch.equal(rp_k[~written], rp[~written]))
        padded_zero = not bool(got[~valid].any())
        ok = (err <= lim and pools_equal and untouched and padded_zero
              and bool(torch.isfinite(got).all()))
        rec = {"phase": "kernel", "kernel": "mla_paged_prefill_attention",
               "case": name, "page_dtype": str(dtype).split(".")[-1],
               "B": B, "S": S, "H": H, "r": r, "rope": rope,
               "page": page, "pos0": pos0, "chunk_len": clen,
               "splits": mk.n_splits(B, S, split_heads or H, page,
                                     max_pages, n_sms),
               "max_abs_err": err,
               "max_abs_plain": want[valid].abs().max().item(), "limit": lim,
               "unrounded_chunk_err": None if dtype == torch.float32 else (
                   mk.mla_paged_prefill_plain(
                       ql, qr, cn, rn, cp.float(), rp.float(), table, p0, cl,
                       scale=scale)[0] - want).abs()[valid].max().item(),
               "pools_bit_equal": pools_equal,
               "unwritten_pages_unchanged": untouched,
               "padded_rows_zero": padded_zero, "ok": ok}
        if name in timed:
            rec.update(mla_timing(mk, ql, qr, cn, rn, cp, rp, table, p0, cl,
                                  pos0, clen, scale, kw))
        if name == "main":
            results = rec
        emit(rec)
        if not ok:
            raise SystemExit(f"mla_paged_prefill_attention disagrees ({name})")
    return results


def mla_timing(mk, ql, qr, cn, rn, cp, rp, table, p0, cl, pos0, clen, scale,
               kw=None):
    kw = kw or {}
    B, S, H, r = ql.shape
    _, page, rope = rp.shape
    F = torch.nn.functional
    # SDPA over [ckv | krope] keys (dim 576) and ckv values (dim 512),
    # gathered after the write up to the longest lane's end and expanded to
    # the H heads, with the kernel's causal offset mask
    cpw, rpw = cp.clone(), rp.clone()
    mk.mla_paged_prefill_plain(ql, qr, cn, rn, cpw, rpw, table, p0, cl,
                               scale=scale)
    end = max(p + n for p, n in zip(pos0, clen))
    idx = table.long()[:, :(end + page - 1) // page]
    ck = cpw[idx].reshape(B, -1, r).float()
    keys = torch.cat([ck, rpw[idx].reshape(B, -1, rope).float()], -1)
    k = keys[:, None].expand(B, H, keys.shape[1], r + rope)
    v = ck[:, None].expand(B, H, ck.shape[1], r)
    q = torch.cat([ql, qr], -1).transpose(1, 2)            # (B, H, S, 576)
    q_pos = p0.long()[:, None, None] + torch.arange(S, device="cuda")[
        None, :, None]
    k_pos = torch.arange(k.shape[2], device="cuda")[None, None, :]
    mask = (k_pos <= q_pos) & (k_pos < (p0 + cl).long()[:, None, None])
    mask = (mask | (k_pos == 0))[:, None]    # padded rows finite; unread
    kernel_ms = time_ms(lambda: mk.mla_paged_prefill_attention(
        ql, qr, cn, rn, cp, rp, table, p0, cl, scale=scale, **kw))
    kernel_dev_ms, dev_parts, dev_seen = device_ms(
        lambda: mk.mla_paged_prefill_attention(
            ql, qr, cn, rn, cp, rp, table, p0, cl, scale=scale, **kw),
        "mla_paged_prefill_attention")
    plain_ms = time_ms(lambda: mk.mla_paged_prefill_plain(
        ql, qr, cn, rn, cp, rp, table, p0, cl, scale=scale))

    def library():
        return F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale)

    library_ms = time_ms(library)
    library_dev_ms = library_device_ms(library)
    # bytes: out written in full (padded rows are zeros), pos0 / chunk_len,
    # and per live lane its live q_lat / q_rope / ckv_new / krope_new rows,
    # the table entries of the pages it visits, the history's latent rows
    # read once and the chunk's rows written once (both in the pools'
    # dtype); flops: 2 (r + rope) for the logit and 2 r for the context per
    # (query row, visible key)
    n_bytes = 4 * (B * S * H * r + 2 * B)
    n_flops = 0
    for n, p in zip(clen, pos0):
        if n == 0:
            continue
        n_bytes += 4 * n * (H * (r + rope) + r + rope)
        n_bytes += 4 * pages_visited(0, p + n, page)
        n_bytes += cp.element_size() * (p + n) * (r + rope)
        n_flops += (2 * (r + rope) + 2 * r) * H * sum(p + i + 1
                                                      for i in range(n))
    bound_ms, bound_by = bound(n_bytes, n_flops)
    return {"ms": kernel_ms, "device_ms": kernel_dev_ms,
            "device_ms_parts": dev_parts, "device_launches_seen": dev_seen,
            "plain_ms": plain_ms,
            "library_ms": library_ms, "library_device_ms": library_dev_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "tf32x3_floor_ms": tf32x3_floor_ms(n_bytes, n_flops),
            "library_call": "scaled_dot_product_attention, keys [ckv | "
                            "krope] and values ckv gathered up to the "
                            "longest lane, converted to float32, expanded "
                            "to H heads (write not included)"}


def mla_model(seed: int):
    """The cut deepseek-v2 at full width and its random weights."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.device import generator
    from repro_torch.models import init_params
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(MLA_ARCH), **MLA_CUT)
    return cfg, init_params(cfg, generator(dev, seed), device=dev)


def mla_stream_phase(cfg, params, seed: int):
    """The engine's greedy streams on the cut deepseek-v2 (B4 for every
    prefill chunk, the naive MLA decode, MoE in every step) against plain
    full-causal generation, as in the stream phase.  Returns the plain
    generation of each request."""
    return engine_streams({"phase": "mla_stream", "model": cfg.name,
                    "layers": cfg.n_layers,
                    "block_pattern": list(cfg.block_pattern)},
                   cfg, params, max_len=256, prompt_seed=seed + 3)


MLA_REPLAY = ["--arch", MLA_ARCH, "--scenario", "chatbot", "--rate", "2.0",
              "--time-scale", "0.25", "--max-requests", "8",
              "--duration", "10"]


def mla_replay_phase(cfg, params, kernels, seed: int, dtype=torch.float32,
                     f32=None):
    """The MLA path end to end: ``ServingFrontend`` with the launcher's
    ``SLOsServeScheduler`` and virtual perf model over ``ServingEngine`` on
    the cut deepseek-v2 (page 16, 8 slots, max_len 1024, 512 pages, KV
    pools of ``dtype``), serving the launcher's chatbot trace.  Launch
    counts are zeroed just before and read just after; the prefill groups
    the replay ran must include the shape the B4 phase timed.  With
    ``f32`` (the float32 replay's record) the pools must hold half its
    bytes and its served / attained / tokens are printed beside; the
    decode breakdown runs in float32 only.  Returns the phase's record."""
    from repro_torch.core.scheduler import SchedulerConfig, SLOsServeScheduler
    from repro_torch.launch import serve
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    from repro_torch.serving.frontend import ServingFrontend

    dev = torch.device("cuda")
    eng = ServingEngine(cfg, params, EngineConfig(
        max_slots=8, max_len=1024, page_size=16, total_pages=512,
        dtype=dtype), device=dev)
    sched = SLOsServeScheduler(serve.VIRTUAL_PERF, SchedulerConfig(
        prefill_emits_first_token=True))
    fe = ServingFrontend(eng, sched, seed=seed)
    args = serve.parse_args(MLA_REPLAY + ["--seed", str(seed)])
    for req in serve.trace(args):
        fe.submit(req)
    timer = SpanTimer()
    eng.tracer = timer
    # the prefill groups this run gives B4: "lanes/bucket" -> count, and
    # the exact (pos0, chunk_len) of the timed shape's bucket
    groups: dict[str, int] = {}
    exact: list = []
    prefill_forward = eng._prefill_forward

    def seen_prefill(cache, tokens, pos0, true_len, *rest):
        key = f"{tokens.shape[0]}/{tokens.shape[1]}"
        groups[key] = groups.get(key, 0) + 1
        exact.append((pos0.tolist(), true_len.tolist()))
        return prefill_forward(cache, tokens, pos0, true_len, *rest)
    eng._prefill_forward = seen_prefill
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in kernels.values():
        c.COUNTS["kernel"] = c.COUNTS["plain"] = 0
    wall = serve.replay(fe)
    launches = {k: dict(m.COUNTS) for k, m in kernels.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    s, c = fe.stats, eng.counters
    L = cfg.n_layers
    main = next(case for case in MLA_CASES if case[0] == "main")
    timed = f"{main[1]}/{main[2]}"
    checks = {
        "served_all": s.served == s.submitted == 8,
        "tokens_out": s.tokens_out > 0,
        "mla_prefill_launches":
            launches["mla_prefill"]["kernel"] == L * c["prefill_calls"],
        "no_gqa_kernel": all(launches[k]["kernel"] == 0
                             for k in ("decode", "prefill", "verify")),
        "no_flash_kernel": launches["flash"]["kernel"] == 0,
        "no_ssd_kernel": launches["ssd"]["kernel"] == 0,
        "no_plain": not any(v["plain"] for v in launches.values()),
        "timed_prefill_shape_ran": timed in groups,
    }
    pools = pool_bytes(eng.kv)
    if f32 is not None:
        checks["pool_bytes_half"] = 2 * pools == f32["pool_bytes"]
    rec = {"phase": ("mla_replay" if f32 is None
                     else f"{DTYPE_TAG[dtype]}_mla_replay"),
           "page_dtype": str(dtype).split(".")[-1], "pool_bytes": pools,
           "model": cfg.name, "layers": L,
           "submitted": s.submitted, "served": s.served,
           "attained": s.attained, "dropped": s.dropped,
           "tokens_out": s.tokens_out,
           "counters": {k: c[k] for k in (
               "prefill_calls", "decode_calls", "decode_steps",
               "decode_tokens", "prefill_fused_ops")},
           "prefill_groups": groups, "timed_prefill_shape": timed,
           "timed_exact_ran": ([main[5], main[6]] in
                               [list(e) for e in exact]),
           "prefill_pos0_range": [min(min(p) for p, _ in exact),
                                  max(max(p) for p, _ in exact)],
           "launches": launches, "wall_s": wall, "span_s": timer.seconds,
           "spans": timer.count,
           "outside_spans_s": wall - sum(timer.seconds.values()),
           "decode_step_ms": (1e3 * timer.seconds.get("decode", 0.0)
                              / max(c["decode_steps"], 1)),
           "peak_mem_gib": peak, "checks": checks}
    eng.tracer = None
    if f32 is None:
        rec["decode_breakdown"] = mla_decode_breakdown(cfg, params, eng)
    else:
        rec["float32"] = {k: f32[k] for k in (
            "served", "attained", "tokens_out", "wall_s", "peak_mem_gib",
            "pool_bytes")}
    emit(rec)
    if not all(checks.values()):
        raise SystemExit(f"{rec['phase']} checks failed: {checks}")
    return rec


def mla_decode_breakdown(cfg, params, eng):
    """Device time of one decode step of eight lanes over the replay's
    table width (every lane at position 900; chunk_len 0, so every write
    goes to the write-off page and the pools keep their state), whole and
    by part: the first layer's MLA (the naive expansion of every cached
    latent into per-head keys and values), one MoE FFN, the unembedding."""
    from repro_torch.models import attention, logits_fn, model_forward, moe
    from repro_torch.models.layers import apply_norm

    dev = torch.device("cuda")
    B, width = 8, eng.kv.max_pages_per_seq
    table = (torch.arange(B * width, device=dev, dtype=torch.int32)
             % eng.ecfg.total_pages).reshape(B, width)
    pos0 = torch.full((B,), 900, dtype=torch.int32, device=dev)
    none = torch.zeros(B, dtype=torch.int32, device=dev)
    tok = torch.ones(B, 1, dtype=torch.long, device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(B, 1, cfg.d_model, generator=g, device=dev)
    p0, p1 = params["segments"][0]["p"], params["segments"][1]["p"]
    cache0 = eng.kv.pools[0]["self"]
    moe_p = {k: t[0] for k, t in p1["moe"].items()}
    positions = pos0[:, None]

    def step():
        h, _, _ = model_forward(params, cfg, tok, cache=eng.kv.pools,
                                pos0=pos0, block_tables=table,
                                chunk_len=none, moe_cf=eng._moe_cf)
        return logits_fn(params, cfg, h[:, -1])
    parts = {
        "step_ms": step,
        "mla_layer_ms": lambda: attention.mla_forward(
            p0["attn"], apply_norm(p0["norm1"], x), cfg, positions=positions,
            cache=cache0, pos0=pos0, block_tables=table, chunk_len=none),
        "moe_layer_ms": lambda: moe.moe_forward(moe_p, x, cfg,
                                                capacity_factor=eng._moe_cf),
        "unembed_ms": lambda: logits_fn(params, cfg, x[:, 0]),
    }
    out = {"lanes": B, "keys_per_lane": width * eng.ecfg.page_size}
    with torch.no_grad():
        for name, fn in parts.items():
            out[name] = time_ms(fn)
    out["mla_share_of_step"] = (cfg.n_layers * out["mla_layer_ms"]
                                / out["step_ms"])
    return out


# ------------------------------ SSM phases ------------------------------ #
SSM_ARCH = "mamba2-2.7b"
SSM_H, SSM_P, SSM_N = 80, 64, 128
# name, B, S, chunk, init_state, chunk_len per lane (dt = 0 from there on,
# as the engine pads a bucket; None: every row live).  "main" is the ssm
# replay's commonest prefill shape: one lane, a 32-token bucket with 17
# live rows, from the lane's carried state (rehearsed on the CPU at
# reduced width with the same engine, scheduler and trace: 33 of its 61
# groups).  "S512_c128" carries the state over four 128-token chunks;
# "S763_one_chunk" is a chatbot prompt of the trace's mean length as plain
# generation runs it, one chunk (the longest C.B^T workspace of the cases).
SSD_CASES = [
    ("main", 1, 32, 32, True, [17]),
    ("S8", 1, 8, 8, False, None),
    ("S16_B4", 4, 16, 16, False, None),
    ("S512_c128", 1, 512, 128, True, None),
    ("S200_one_chunk", 1, 200, 200, False, None),
    ("init_state_B4", 4, 64, 64, True, None),
    ("padded_lanes", 4, 16, 16, True, [16, 11, 0, 0]),
    ("S763_one_chunk", 1, 763, 763, False, None),
]
SSD_TIMED = ("main", "S512_c128", "S763_one_chunk")


def ssd_inputs(gen, B, S, clen, with_init, widths=(SSM_H, SSM_P, SSM_N)):
    """Inputs at the main path's scales: x, B and C as silu outputs of
    normals, dt = softplus(normal) (zero past each lane's chunk_len),
    A = -linspace(1, 16) (the init's A_log), a state of std 0.3; widths
    (H, P, N), mamba2's unless given."""
    H, P, N = widths
    F = torch.nn.functional

    def silu(*shape):
        return F.silu(torch.randn(*shape, generator=gen, device="cuda"))
    xh, Bm, Cm = silu(B, S, H, P), silu(B, S, N), silu(B, S, N)
    dt = F.softplus(torch.randn(B, S, H, generator=gen, device="cuda"))
    if clen is not None:
        live = (torch.arange(S, device="cuda")[None]
                < torch.tensor(clen, device="cuda")[:, None])
        dt = torch.where(live[..., None], dt, 0.0).contiguous()
    A = -torch.linspace(1.0, 16.0, H, device="cuda")
    h0 = (0.3 * torch.randn(B, H, P, N, generator=gen, device="cuda")
          if with_init else None)
    return xh, dt, A, Bm, Cm, h0


def ssd_phase(sk, parent=None, cases=SSD_CASES, timed=SSD_TIMED, seed=6,
              widths=(SSM_H, SSM_P, SSM_N)):
    """B5 against its plain version on the same inputs at ``widths`` (H,
    P, N; mamba2's 80 heads, head dim 64, state 128 unless given): y and
    the final state within the limit (and allclose at atol and rtol
    1e-4), finite.  A
    lane with chunk_len 0 must keep its initial state exactly.  The cases
    named in ``timed`` are timed, and with ``parent`` the other tree's
    kernel beside; returns the record of the first."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    results = {}
    H, P, N = widths
    for name, B, S, chunk, with_init, clen in cases:
        xh, dt, A, Bm, Cm, h0 = ssd_inputs(gen, B, S, clen, with_init, widths)
        y, hT = sk.ssd_scan(xh, dt, A, Bm, Cm, chunk=chunk, init_state=h0)
        wy, wh = sk.ssd_chunked_plain(xh, dt, A, Bm, Cm, chunk, h0)
        torch.cuda.synchronize()
        err_y = (y - wy).abs().max().item()
        err_h = (hT - wh).abs().max().item()
        lim_y, lim_h = limit(wy), limit(wh)
        kept = all(bool(torch.equal(hT[b], h0[b])) for b in range(B)
                   if clen is not None and clen[b] == 0)
        ok = (err_y <= lim_y and err_h <= lim_h and kept
              and torch.allclose(y, wy, atol=1e-4, rtol=1e-4)
              and torch.allclose(hT, wh, atol=1e-4, rtol=1e-4)
              and bool(torch.isfinite(y).all() and torch.isfinite(hT).all()))
        rec = {"phase": "kernel", "kernel": "ssd_scan", "case": name,
               "B": B, "S": S, "chunk": chunk, "H": H, "P": P, "N": N,
               "init_state": with_init, "chunk_len": clen,
               "cb_workspace": sk.cb_workspace(chunk),
               "workspace_mib": (4 * sk.workspace_floats(B, S, chunk) / 2**20
                                 if sk.cb_workspace(chunk) else 0.0),
               "max_abs_err": max(err_y, err_h), "max_abs_err_y": err_y,
               "max_abs_err_state": err_h, "max_abs_y": wy.abs().max().item(),
               "max_abs_state": wh.abs().max().item(),
               "limit_y": lim_y, "limit_state": lim_h,
               "padded_lanes_keep_state": kept, "ok": ok}
        if name in timed:
            rec.update(ssd_timing(sk, xh, dt, A, Bm, Cm, h0, chunk))
            if parent is not None:
                rec["parent"] = parent.ssd(xh, dt, A, Bm, Cm, h0, chunk, wy,
                                           wh)
        if not results:
            results = rec
        emit(rec)
        if not ok:
            raise SystemExit(f"ssd_scan disagrees ({name})")
    return results


def ssd_timing(sk, xh, dt, A, Bm, Cm, h0, chunk):
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    kernel_ms = time_ms(lambda: sk.ssd_scan(xh, dt, A, Bm, Cm, chunk=chunk,
                                            init_state=h0))
    kernel_dev_ms, dev_parts, dev_seen = device_ms(lambda: sk.ssd_scan(
        xh, dt, A, Bm, Cm, chunk=chunk, init_state=h0), "ssd_scan")
    plain_ms = time_ms(lambda: sk.ssd_chunked_plain(xh, dt, A, Bm, Cm, chunk,
                                                    h0))
    # bytes: x and dt, A, B and C read once, y written once, the initial
    # state read and the final state written once; flops per lane and
    # chunk of L: per head P L (L + 1) for the two masked products (2 P
    # per pair m <= l) and 4 L N P for the incoming state's output term
    # and the state update, and N L (L + 1) once for C . B (shared by the
    # heads); padded rows (dt = 0) are computed like live ones
    # (x, B, C, y and the states in their dtype; dt and A float32, and
    # the flops of bf16 data at the bf16 rate)
    e = xh.element_size()
    n_bytes = (e * (2 * B * S * H * P + 2 * B * S * N
                    + (2 if h0 is not None else 1) * B * H * P * N)
               + 4 * (B * S * H + H))
    L, nc = chunk, S // chunk
    n_flops = B * nc * (H * (P * L * (L + 1) + 4 * L * N * P)
                        + N * L * (L + 1))
    bound_ms, bound_by = bound(
        n_bytes, n_flops, BF16_FLOP_PER_S if xh.dtype == BF16 else None)
    return {"ms": kernel_ms, "device_ms": kernel_dev_ms,
            "device_ms_parts": dev_parts, "device_launches_seen": dev_seen,
            "plain_ms": plain_ms,
            "library_ms": None, "library_device_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "tf32x3_floor_ms": tf32x3_floor_ms(n_bytes, n_flops),
            "library_call": "none: no single PyTorch call computes "
                            "chunked SSD"}


def ssm_model(seed: int):
    """mamba2-2.7b at its published width and depth and its random
    weights (2.83 B parameters, 10.5 GiB in float32)."""
    from repro_torch.configs import get_config
    from repro_torch.device import generator
    from repro_torch.models import init_params
    dev = torch.device("cuda")
    cfg = get_config(SSM_ARCH)
    return cfg, init_params(cfg, generator(dev, seed), device=dev)


# rids 1 and 2 share a prefill group (their whole prompts, 24 and 29
# tokens in the 32-token bucket) and a decode group; rid 1 finishes and
# rid 3 is admitted into its slot, prefills in two chunks (20, then 33
# from a mid-chunk state) while rid 2 decodes, and the two decode together
# at uneven budgets (a frozen lane)
SSM_STREAM_PROMPTS = {1: 24, 2: 29, 3: 53}
SSM_STREAM_SCRIPT = [
    "admit 1 2",
    [(1, "P", 24), (2, "P", 29)],
    [(1, "D", 5), (2, "D", 2)],
    "finish 1",
    "admit 3",
    [(3, "P", 20), (2, "D", 3)],
    [(3, "P", 33), (2, "D", 1)],
    [(2, "D", 4), (3, "D", 7)],
    [(3, "D", 2)],
]


def ssm_stream_phase(cfg, params, seed: int):
    """The engine's greedy streams on full-width mamba2 (B5 for every
    prefill chunk, the recurrent decode step, lane rows gathered and
    scattered per call) against plain full-causal generation (B5 over the
    whole sequence as one chunk when its length is no multiple of 128),
    with two slots, so that the third stream runs in the slot the first
    one freed."""
    engine_streams({"phase": "ssm_stream", "model": cfg.name,
                    "layers": cfg.n_layers}, cfg, params, max_len=256,
                   prompt_seed=seed + 4, max_slots=2,
                   prompt_lens=SSM_STREAM_PROMPTS, script=SSM_STREAM_SCRIPT)


SSM_REPLAY = ["--arch", SSM_ARCH, "--scenario", "chatbot", "--rate", "2.0",
              "--time-scale", "0.25", "--max-requests", "8",
              "--duration", "10"]


def ssm_replay_phase(cfg, params, kernels, seed: int):
    """The SSM path end to end: ``ServingFrontend`` with the launcher's
    scheduler and virtual perf model over ``ServingEngine`` on full-width
    mamba2 with 4 slots (so slots are reused), serving the launcher's
    chatbot trace.  Launch counts are zeroed just before and read just
    after; the prefill groups the replay ran must include the shape the
    B5 phase timed."""
    from repro_torch.core.scheduler import SchedulerConfig, SLOsServeScheduler
    from repro_torch.launch import serve
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    from repro_torch.serving.frontend import ServingFrontend

    dev = torch.device("cuda")
    eng = ServingEngine(cfg, params, EngineConfig(
        max_slots=4, max_len=1024, page_size=16, total_pages=512),
        device=dev)
    sched = SLOsServeScheduler(serve.VIRTUAL_PERF, SchedulerConfig(
        prefill_emits_first_token=True))
    fe = ServingFrontend(eng, sched, seed=seed)
    for req in serve.trace(serve.parse_args(SSM_REPLAY
                                            + ["--seed", str(seed)])):
        fe.submit(req)
    timer = SpanTimer()
    eng.tracer = timer
    groups: dict[str, int] = {}
    exact: dict[str, list] = {}      # "B/S" -> each group's live rows
    prefill_forward = eng._prefill_forward

    def seen_prefill(cache, tokens, pos0, true_len, *rest):
        key = f"{tokens.shape[0]}/{tokens.shape[1]}"
        groups[key] = groups.get(key, 0) + 1
        exact.setdefault(key, []).append(tuple(true_len.tolist()))
        return prefill_forward(cache, tokens, pos0, true_len, *rest)
    eng._prefill_forward = seen_prefill
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in kernels.values():
        c.COUNTS["kernel"] = c.COUNTS["plain"] = 0
    wall = serve.replay(fe)
    launches = {k: dict(m.COUNTS) for k, m in kernels.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    del eng._prefill_forward
    s, c = fe.stats, eng.counters
    L = cfg.n_layers
    main = next(case for case in SSD_CASES if case[0] == "main")
    timed = f"{main[1]}/{main[2]}"
    checks = {
        "served_all": s.served == s.submitted == 8,
        "tokens_out": s.tokens_out > 0,
        "ssd_launches": launches["ssd"]["kernel"] == L * c["prefill_calls"],
        "no_attention_kernel": all(launches[k]["kernel"] == 0 for k in (
            "decode", "prefill", "verify", "mla_prefill", "flash")),
        "no_plain": not any(v["plain"] for v in launches.values()),
        "timed_prefill_shape_ran": timed in groups,
    }
    rec = {"phase": "ssm_replay", "model": cfg.name, "layers": L,
           "slots": eng.ecfg.max_slots, "submitted": s.submitted,
           "served": s.served, "attained": s.attained, "dropped": s.dropped,
           "tokens_out": s.tokens_out,
           "counters": {k: c[k] for k in (
               "prefill_calls", "decode_calls", "decode_steps",
               "decode_tokens")},
           "prefill_groups": groups, "timed_prefill_shape": timed,
           "timed_exact_ran": tuple(main[5]) in exact.get(timed, []),
           "launches": launches, "wall_s": wall, "span_s": timer.seconds,
           "spans": timer.count,
           "outside_spans_s": wall - sum(timer.seconds.values()),
           "prefill_group_ms": (1e3 * timer.seconds.get("prefill", 0.0)
                                / max(c["prefill_calls"], 1)),
           "decode_step_ms": (1e3 * timer.seconds.get("decode", 0.0)
                              / max(c["decode_steps"], 1)),
           "peak_mem_gib": peak, "checks": checks}
    eng.tracer = None
    rec["prefill_breakdown"] = ssm_prefill_breakdown(eng)
    rec["decode_breakdown"] = ssm_decode_breakdown(cfg, params, eng)
    emit(rec)
    if not all(checks.values()):
        raise SystemExit(f"ssm replay checks failed: {checks}")
    return launches, groups, exact


def ssm_prefill_breakdown(eng):
    """One prefill group at the B5 phase's timed shape (one lane, a
    32-token bucket with 17 live rows, from slot 0's state) as the engine
    runs it (the lane rows' gather and ``_prefill_forward``; its new rows
    are dropped): CUDA events around the call (the host's dispatch
    included), and ``torch.profiler``'s device time of all the call's
    kernels and of B5's own, so the group's time splits into the device's
    and the host's."""
    (_, B, S, _, _, (live,)), = [c for c in SSD_CASES if c[0] == "main"]
    dev, slots = eng.device, [0] * B
    tok = torch.ones(B, S, dtype=torch.long, device=dev)
    pos0 = torch.zeros(B, dtype=torch.int32, device=dev)
    clen = torch.full((B,), live, dtype=torch.int32, device=dev)
    table = eng.kv.table_rows(slots)

    def call():
        return eng._prefill_forward(eng.kv.lane_cache(slots), tok, pos0,
                                    clen, table, [])
    with torch.no_grad():
        call_ms = time_ms(call)
        reading = cuda_profile(call, n=1, flush=False)
    total, ops = cuda_sum(reading)
    return {"B": B, "S": S, "live": live, "call_ms": call_ms,
            "device_ms": total, "device_ops": ops,
            "ssd_device_ms": cuda_sum(reading, KERNEL_NAMES["ssd_scan"])[0],
            "host_ms": None if total is None else call_ms - total}


SSM_AB_TURNS = ("parent", "this", "this", "parent",
                "this", "parent", "parent", "this")


def ssm_ab_phase(cfg, params, kernels, parent, seed: int):
    """With ``--parent``: the ssm replay with the other tree's B5 (its
    wrapper module and kernel) and with this tree's, in turns in this
    process (SSM_AB_TURNS: other, this, this, other, and then the same
    swapped, so a drift over the process that favours a turn's place
    shows as the two halves disagreeing): the end-to-end A/B of a B5
    change on one host, read off the prefill span that B5 runs in, and
    each turn's ``prefill_breakdown``."""
    from repro_torch.models import ssm
    turns = []
    for turn in SSM_AB_TURNS:
        ctx = parent.wrapper("ssd_scan") if turn == "parent" \
            else contextlib.nullcontext(kernels["ssd"])
        out = io.StringIO()
        with ctx as sk:
            saved, ssm._ssd = ssm._ssd, sk
            try:
                with contextlib.redirect_stdout(out):
                    ssm_replay_phase(cfg, params, dict(kernels, ssd=sk), seed)
            finally:
                ssm._ssd = saved
        rec = json.loads(out.getvalue().strip().splitlines()[-1])
        turns.append({"b5": turn, "wall_s": rec["wall_s"],
                      "prefill_s": rec["span_s"].get("prefill"),
                      "decode_s": rec["span_s"].get("decode"),
                      "prefill_group_ms": rec["prefill_group_ms"],
                      "ssd_launches": rec["launches"]["ssd"]["kernel"],
                      "tokens_out": rec["tokens_out"],
                      "prefill_breakdown": rec["prefill_breakdown"],
                      "checks_ok": all(rec["checks"].values())})
        free_device_memory()
    half = len(turns) // 2
    mean = {f"{tree}_{part}": statistics.fmean(
        t["prefill_s"] for t in turns[lo:lo + half] if t["b5"] == tree)
        for tree in ("parent", "this")
        for part, lo in (("first_half", 0), ("second_half", half))}
    emit({"phase": "ssm_ab", "turns": turns, "mean_prefill_s": mean})


def ssd_replay_group_phase(sk, cfg, groups, exact, parent=None):
    """B5 checked and timed (``ssd_phase``) at a second shape the ssm
    replay ran, as it ran it: its (B, S) bucket, the model's chunk
    (``ssm_forward``'s rule), its commonest live rows, from a carried
    state.  The shape is the replay's commonest prefill group above 32
    tokens, or, when the replay runs none (its scheduler's chunks of this
    trace stop at 32: 1/32, 1/16, 2/8 and 1/8 on an H100), its commonest
    group other than the 32-token one the B5 phase timed."""
    main = next(case for case in SSD_CASES if case[0] == "main")
    timed = f"{main[1]}/{main[2]}"
    long = {k: n for k, n in groups.items() if int(k.split("/")[1]) > 32}
    pool = long or {k: n for k, n in groups.items() if k != timed}
    key = max(pool, key=pool.get)
    B, S = map(int, key.split("/"))
    lives = exact[key]
    live = list(max(set(lives), key=lives.count))
    chunk = min(cfg.ssm.chunk_size, S)
    if S % chunk:
        chunk = S
    ssd_phase(sk, parent, cases=[("replay_group", B, S, chunk, True, live)],
              timed=("replay_group",), seed=7)
    emit({"phase": "ssd_replay_group", "group": key, "groups": pool[key],
          "above_32_tokens": bool(long), "prefill_groups": groups,
          "chunk": chunk, "chunk_len": live})


def ssm_decode_breakdown(cfg, params, eng):
    """Device time (CUDA events, so host gaps between launches count) of
    one decode step over all the engine's slots, whole and by part: the
    first layer's mixer step, its lane-row write-back (``where`` over the
    conv and state rows), the unembedding; and the ops one step launches
    on the card (``torch.profiler``), if it traces the card.  The replay
    has ended, so every lane is frozen (chunk_len 0) and the rows keep
    their state."""
    from repro_torch.models import logits_fn, model_forward, ssm
    from repro_torch.models.layers import apply_norm

    dev = torch.device("cuda")
    slots = list(range(eng.ecfg.max_slots))
    B = len(slots)
    cache = eng.kv.lane_cache(slots)
    frozen = torch.zeros(B, dtype=torch.int32, device=dev)
    pos0 = torch.zeros(B, dtype=torch.int32, device=dev)
    tok = torch.ones(B, 1, dtype=torch.long, device=dev)
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(B, 1, cfg.d_model, generator=g, device=dev)
    p0 = {k: t[0] for k, t in params["segments"][0]["p"]["ssm"].items()}
    rows0 = {k: t[0] for k, t in cache[0].items()}
    h = apply_norm({"scale": params["segments"][0]["p"]["norm1"]["scale"][0]},
                   x)
    _, new = ssm.ssm_decode_step(p0, h, cfg, rows0)
    keep = frozen > 0

    def step():
        hid, _, _ = model_forward(params, cfg, tok, cache=cache, pos0=pos0,
                                  chunk_len=frozen)
        return logits_fn(params, cfg, hid[:, -1])
    parts = {
        "step_ms": step,
        "mixer_layer_ms": lambda: ssm.ssm_decode_step(p0, h, cfg, rows0),
        "lane_row_writeback_ms": lambda: ssm.write_lane_rows(rows0, new,
                                                             keep),
        "unembed_ms": lambda: logits_fn(params, cfg, x[:, 0]),
    }
    out = {"lanes": B}
    with torch.no_grad():
        for name, fn in parts.items():
            out[name] = time_ms(fn)
        out["mixer_share_of_step"] = (cfg.n_layers * out["mixer_layer_ms"]
                                      / out["step_ms"])
        out["profiled_device_ms"], out["profiled_device_ops"] = cuda_sum(
            cuda_profile(step, n=1, flush=False))
    return out


# ----------------------------- whisper phases ---------------------------- #
WHISPER_ARCH = "whisper-large-v3"
# name, B, Sq, Sk, H, KV, hd, causal, q_offset, kv_len, through the GQA
# wrapper (B6 runs on (B H, Sq, hd)).  "encoder" is one whisper encoder
# layer for one request, "cross_decode" one cross-attention layer of an
# eight-lane decode step; "replay_cross_decode" and "replay_cross_prefill"
# are the whisper replay's commonest cross-attention shapes (a CPU
# rehearsal of the replay at the card's engine config: 168 of its 306
# decode steps had one lane, 72 of its 89 prefill groups were one lane's
# 16-row bucket; the replay checks that it ran them); the cross prefill
# chunks are the 16-row bucket over three lanes, a 32-row one and a
# 128-row one; then causal from q_offset 0 (once with keys split, the
# first query tile's share of one split empty), a chunk at an offset whose
# last rows meet kv_len < Sk, head dim 32 (once over 160 heads of 20 rows,
# 4 warps to a row group), head dim 128 at llama-3.2-vision's cross shape,
# at its replay's commonest cross shapes (one lane's decode step and its
# 16-row prefill bucket over 1600 image tokens: the vlm replay checks that
# it ran them) and at qwen3-1.7b's no-cache causal shape, and Sq, Sk and
# kv_len that are no multiples of the tiles; at head dim 112 zamba2-7b's
# shared
# attention in plain generation (32 heads, G 1): a 763-token prompt (the
# chatbot trace's mean) and a few rows at an offset with kv_len < Sk (8
# warps to a row group, keys split).
FLASH_CASES = [
    ("encoder", 1, 1500, 1500, 20, 20, 64, False, 0, None),
    ("cross_decode", 8, 1, 1500, 20, 20, 64, False, 0, None),
    ("replay_cross_decode", 1, 1, 1500, 20, 20, 64, False, 0, None),
    ("replay_cross_prefill", 1, 16, 1500, 20, 20, 64, False, 0, None),
    ("cross_prefill_16", 3, 16, 1500, 20, 20, 64, False, 0, None),
    ("cross_prefill_32", 2, 32, 1500, 20, 20, 64, False, 0, None),
    ("cross_prefill_128", 1, 128, 1500, 20, 20, 64, False, 0, None),
    ("causal_q0", 1, 300, 300, 20, 20, 64, True, 0, None),
    ("causal_split_empty", 1, 700, 700, 4, 4, 64, True, 0, None),
    ("causal_offset_kv_len", 2, 77, 500, 4, 4, 64, True, 200, 260),
    ("hd32_causal", 2, 45, 101, 6, 2, 32, True, 56, 101),
    ("hd32_many_heads", 8, 20, 200, 20, 20, 32, True, 180, None),
    ("hd128_vlm_cross", 2, 37, 1600, 32, 8, 128, False, 0, None),
    ("vlm_replay_cross_decode", 1, 1, 1600, 32, 8, 128, False, 0, None),
    ("vlm_replay_cross_prefill", 1, 16, 1600, 32, 8, 128, False, 0, None),
    ("hd128_qwen3_causal", 1, 200, 200, 16, 8, 128, True, 0, None),
    ("ragged", 2, 65, 129, 3, 3, 64, False, 0, 100),
    ("hd112_zamba2_causal", 1, 763, 763, 32, 32, 112, True, 0, None),
    ("hd112_few_rows", 2, 9, 300, 32, 32, 112, True, 250, 255),
]
FLASH_TIMED = ("encoder", "cross_decode", "replay_cross_decode",
               "replay_cross_prefill", "hd112_zamba2_causal",
               "hd128_vlm_cross", "vlm_replay_cross_decode",
               "vlm_replay_cross_prefill")


def flat_heads(q, k, v):
    """(B, S, H | KV, hd) -> (B H, S, hd), K/V repeated over their query
    groups, as ``attention`` hands them to B6."""
    B, Sq, H, hd = q.shape
    G = H // k.shape[2]

    def flat(t):
        return t.transpose(1, 2).reshape(B * H, t.shape[1], hd).contiguous()
    return (flat(q), flat(k.repeat_interleave(G, 2)),
            flat(v.repeat_interleave(G, 2)))


def visible_keys(Sq, Sk, causal, q_offset, kv_len):
    """Keys each query row sees: min(kv_len, q_offset + i + 1) or kv_len."""
    lim = min(Sk if kv_len is None else kv_len, Sk)
    return [min(lim, q_offset + i + 1) if causal else lim
            for i in range(Sq)]


def flash_phase(fa, timed=FLASH_TIMED, seed=8):
    """B6 through its GQA wrapper against its plain version on the same
    flattened inputs; then the keys no row may see (past kv_len, past the
    last row's causal limit) are set to 1e4 and the kernel's output must
    not move.  Outputs within the limit, finite.  Each line names the
    regime the wrapper chose (warps per 16-row group, key splits)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    results = {}
    for (name, B, Sq, Sk, H, KV, hd, causal, q_offset,
         kv_len) in FLASH_CASES:
        q = torch.randn(B, Sq, H, hd, generator=gen, device="cuda")
        k = torch.randn(B, Sk, KV, hd, generator=gen, device="cuda")
        v = torch.randn(B, Sk, KV, hd, generator=gen, device="cuda")
        kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
        got = fa.attention(q, k, v, **kw)
        qf, kf, vf = flat_heads(q, k, v)
        want_flat = fa.flash_attention_plain(
            qf, kf, vf, causal=causal, q_offset=q_offset,
            kv_len=Sk if kv_len is None else kv_len, scale=hd ** -0.5)
        want = want_flat.reshape(B, H, Sq, hd).transpose(1, 2)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        seen = max(visible_keys(Sq, Sk, causal, q_offset, kv_len))
        kp, vp = k.clone(), v.clone()
        kp[:, seen:] = 1e4
        vp[:, seen:] = 1e4
        perr = (fa.attention(q, kp, vp, **kw) - got).abs().max().item()
        lim = limit(want)
        ok = err <= lim and perr <= lim and bool(torch.isfinite(got).all())
        rec = {"phase": "kernel", "kernel": "flash_attention_bh", "case": name,
               "B": B, "Sq": Sq, "Sk": Sk, "H": H, "KV": KV, "hd": hd,
               "BH": B * H, "causal": causal, "q_offset": q_offset,
               "kv_len": kv_len, "warps_per_rows": fa.warps_per_rows(Sq),
               "splits": fa.n_splits(B * H, Sq, seen, n_sms),
               "keys_poisoned": Sk - seen,
               "max_abs_err": err, "max_abs_plain": want.abs().max().item(),
               "limit": lim, "poisoned_err": perr, "ok": ok}
        if name in timed:
            rec.update(flash_timing(fa, qf, kf, vf, causal, q_offset, kv_len))
            results[name] = rec
        emit(rec)
        if not ok:
            raise SystemExit(f"flash_attention_bh disagrees ({name})")
    return results


def flash_timing(fa, qf, kf, vf, causal, q_offset, kv_len):
    BH, Sq, hd = qf.shape
    Sk = kf.shape[1]
    scale = hd ** -0.5
    F = torch.nn.functional
    n_vis = visible_keys(Sq, Sk, causal, q_offset, kv_len)
    mask = None
    if causal or max(n_vis) < Sk:
        mask = (torch.arange(Sk, device="cuda")[None, :]
                < torch.tensor(n_vis, device="cuda")[:, None])
    lim = Sk if kv_len is None else kv_len
    kernel_ms = time_ms(lambda: fa.flash_attention_bh(
        qf, kf, vf, causal=causal, q_offset=q_offset, kv_len=kv_len))
    kernel_dev_ms, dev_parts, dev_seen = device_ms(
        lambda: fa.flash_attention_bh(qf, kf, vf, causal=causal,
                                      q_offset=q_offset, kv_len=kv_len),
        "flash_attention_bh")
    plain_ms = time_ms(lambda: fa.flash_attention_plain(
        qf, kf, vf, causal=causal, q_offset=q_offset, kv_len=lim,
        scale=scale))

    def library():
        return F.scaled_dot_product_attention(
            qf[None], kf[None], vf[None], attn_mask=mask, scale=scale)

    library_ms = time_ms(library)
    library_dev_ms = library_device_ms(library)
    # bytes: q read and out written once, each visible key's K and V rows
    # read once; flops: 4 hd per visible (row, key) pair
    n_bytes = qf.element_size() * BH * hd * (2 * Sq + 2 * max(n_vis))
    n_flops = 4 * hd * BH * sum(n_vis)
    bound_ms, bound_by = bound(
        n_bytes, n_flops, BF16_FLOP_PER_S if qf.dtype == BF16 else None)
    return {"ms": kernel_ms, "device_ms": kernel_dev_ms,
            "device_ms_parts": dev_parts, "device_launches_seen": dev_seen,
            "plain_ms": plain_ms,
            "library_ms": library_ms, "library_device_ms": library_dev_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "tf32x3_floor_ms": tf32x3_floor_ms(n_bytes, n_flops),
            "library_call": "scaled_dot_product_attention on (1, BH, S, hd)"}


# the shapes that chose B6's and B4's key-split counts: B6 over 1500 keys
# at head dim 64, (BH, Sq): whisper's cross-decode of 1 and 8 lanes, one
# lane's 16-, 32- and 128-row buckets, three lanes' 16-row one, the
# encoder; B4 at 128 heads, (S, pos0, chunk_len, max_pages): the mla
# replay's chunk, an 8-row one, a 256-token chunk
SWEEP_FLASH = [(20, 1), (160, 1), (20, 16), (60, 16), (40, 32), (20, 128),
               (20, 1500)]
SWEEP_MLA = [(16, 120, 15, 64), (8, 300, 7, 64), (256, 0, 256, 32)]
# B3 at its timed cases' shapes; B5 at the ssm replay's chunk, a 64-token
# chunk, 512 tokens in chunks of 128 and a 763-token prompt as one chunk
SWEEP_VERIFY = ("main", "hist2000")
SWEEP_VERIFY_COUNTS = (1, 2, 4, 8, 12, 16, 24, 33, 48, 66)
SWEEP_SSD = [("main", 1, 32, 32), ("S64", 1, 64, 64),
             ("S512_c128", 1, 512, 128), ("S763_one_chunk", 1, 763, 763)]


def split_sweep(fa, mk, pv, sk):
    """Device time of B6 and B4 at every key-split count from 1 up (to 14,
    or 3 where the wrapper chooses none), of B3 at the split counts of
    SWEEP_VERIFY_COUNTS, each count forced on the wrapper, beside the
    count the wrapper chooses; and of B5 with and without the C.B^T
    workspace (``--split-sweep``)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(10)

    def sweep(module, call, counts, kernel):
        chosen = module.n_splits
        res = {}
        try:
            for ns in counts:
                module.n_splits = lambda *_, ns=ns: ns
                res[ns] = device_ms(call, kernel)[0]
        finally:
            module.n_splits = chosen
        return res

    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    for BH, Sq in SWEEP_FLASH:
        q = torch.randn(BH, Sq, 64, generator=gen, device="cuda")
        k = torch.randn(BH, 1500, 64, generator=gen, device="cuda")
        v = torch.randn(BH, 1500, 64, generator=gen, device="cuda")
        own = fa.n_splits(BH, Sq, 1500, n_sms)
        emit({"phase": "split_sweep", "kernel": "flash_attention_bh",
              "BH": BH, "Sq": Sq, "Sk": 1500, "hd": 64,
              "warps_per_rows": fa.warps_per_rows(Sq), "chosen": own,
              "device_ms": sweep(fa, lambda: fa.flash_attention_bh(
                  q, k, v, causal=False),
                  range(1, 4 if own == 1 else 15), "flash_attention_bh")})
    for S, p0, n, max_pages in SWEEP_MLA:
        H, r, rope, page = MLA_H, MLA_R, MLA_ROPE, 16
        cp = torch.randn(max_pages + 5, page, r, generator=gen, device="cuda")
        rp = torch.randn(max_pages + 5, page, rope, generator=gen,
                         device="cuda")
        table = torch.arange(max_pages, dtype=torch.int32,
                             device="cuda")[None].contiguous()
        ql = torch.randn(1, S, H, r, generator=gen, device="cuda")
        qr = torch.randn(1, S, H, rope, generator=gen, device="cuda")
        cn = torch.randn(1, S, r, generator=gen, device="cuda")
        rn = torch.randn(1, S, rope, generator=gen, device="cuda")
        pos0 = torch.tensor([p0], dtype=torch.int32, device="cuda")
        clen = torch.tensor([n], dtype=torch.int32, device="cuda")
        own = mk.n_splits(1, S, H, page, max_pages, n_sms)
        emit({"phase": "split_sweep", "kernel": "mla_paged_prefill_attention",
              "S": S, "H": H, "pos0": p0, "chunk_len": n, "chosen": own,
              "device_ms": sweep(mk, lambda: mk.mla_paged_prefill_attention(
                  ql, qr, cn, rn, cp, rp, table, pos0, clen,
                  scale=(128 + rope) ** -0.5),
                  range(1, 4 if own == 1 else 7),
                  "mla_paged_prefill_attention")})
    for name, B, S, H, KVH, hd, page, max_pages, pos0, clen, window in [
            c for c in VERIFY_CASES if c[0] in SWEEP_VERIFY]:
        kp, vp, table = pools_and_tables(gen, B, KVH, hd, page, max_pages)
        q = torch.randn(B, S, H, hd, generator=gen, device="cuda")
        kn = torch.randn(B, S, KVH, hd, generator=gen, device="cuda")
        vn = torch.randn(B, S, KVH, hd, generator=gen, device="cuda")
        p0 = torch.tensor(pos0, dtype=torch.int32, device="cuda")
        cl = torch.tensor(clen, dtype=torch.int32, device="cuda")
        emit({"phase": "split_sweep", "kernel": "paged_verify_attention",
              "case": name, "pos0": pos0, "chunk_len": clen,
              "chosen": pv.n_splits(B, KVH, page, max_pages, window, n_sms),
              "device_ms": sweep(pv, lambda: pv.paged_verify_attention(
                  q, kn, vn, kp, vp, table, p0, cl, window=window),
                  SWEEP_VERIFY_COUNTS, "paged_verify_attention")})
    chosen = sk.cb_workspace
    for name, B, S, chunk in SWEEP_SSD:
        xh, dt, A, Bm, Cm, h0 = ssd_inputs(gen, B, S, None, True)
        res = {}
        try:
            for ws in (False, True):
                sk.cb_workspace = lambda *_, ws=ws: ws
                res["ws" if ws else "block"] = device_ms(
                    lambda: sk.ssd_scan(xh, dt, A, Bm, Cm, chunk=chunk,
                                        init_state=h0), "ssd_scan")[0]
        finally:
            sk.cb_workspace = chosen
        emit({"phase": "split_sweep", "kernel": "ssd_scan", "case": name,
              "B": B, "S": S, "chunk": chunk,
              "chosen": "ws" if sk.cb_workspace(chunk) else "block",
              "device_ms": res})


def whisper_model(seed: int):
    """whisper-large-v3 at its published width and depth and its random
    weights (encoder and decoder)."""
    from repro_torch.configs import get_config
    from repro_torch.device import generator
    from repro_torch.models import init_encdec_params
    dev = torch.device("cuda")
    cfg = get_config(WHISPER_ARCH)
    return cfg, init_encdec_params(cfg, generator(dev, seed), device=dev)


def whisper_frames(cfg, seed: int, rid: int):
    """One request's frame embeddings (1, 1500, 1280), the conv frontend's
    stub output, from a numpy seed."""
    import numpy as np
    a = np.random.default_rng([seed, rid]).standard_normal(
        (1, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    return torch.from_numpy(a).to("cuda")


def whisper_stream_phase(cfg, params, seed: int):
    """The engine's greedy streams on full-width whisper (B2 and B1 for the
    decoder's self-attention, B6 for every cross-attention and for the
    encoder), each request with its own encoder states, against plain
    generation, as in the stream phase."""
    from repro_torch.models import encoder_forward
    with torch.no_grad():
        encs = {rid: encoder_forward(params["encoder"], cfg,
                                     whisper_frames(cfg, seed, rid))
                for rid in STREAM_PROMPTS}
    engine_streams({"phase": "whisper_stream", "model": cfg.name,
                    "layers": cfg.n_layers,
                    "encoder_layers": cfg.encoder.n_layers,
                    "enc_abs_max": {r: e.abs().max().item()
                                    for r, e in encs.items()}},
                   cfg, params, max_len=448, prompt_seed=seed + 5, encs=encs)


WHISPER_REPLAY = ["--scenario", "chatbot", "--rate", "2.0",
                  "--time-scale", "0.25", "--max-requests", "8",
                  "--duration", "10"]


def whisper_replay_phase(cfg, params, kernels, seed: int):
    """The whisper path end to end: ``ServingFrontend`` with the launcher's
    scheduler and virtual perf model over ``ServingEngine`` on full-width
    whisper (page 16, 8 slots, max_len 448, whisper's decoder context),
    serving the launcher's chatbot trace; each request is submitted with
    the ``enc_states`` of its own frames.  Launch counts are zeroed just
    before the encoder calls and read just after the replay."""
    from repro_torch.core.scheduler import SchedulerConfig, SLOsServeScheduler
    from repro_torch.launch import serve
    from repro_torch.models import encoder_forward
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    from repro_torch.serving.frontend import ServingFrontend

    dev = torch.device("cuda")
    eng = ServingEngine(cfg, params, EngineConfig(
        max_slots=8, max_len=448, page_size=16, total_pages=256),
        device=dev)
    sched = SLOsServeScheduler(serve.VIRTUAL_PERF, SchedulerConfig(
        prefill_emits_first_token=True))
    fe = ServingFrontend(eng, sched, seed=seed)
    reqs = serve.trace(serve.parse_args(WHISPER_REPLAY
                                        + ["--seed", str(seed)]))
    frames = {r.rid: whisper_frames(cfg, seed + 1, r.rid) for r in reqs}
    timer = SpanTimer()
    eng.tracer = timer
    # the (BH, Sq, Sk) of every B6 call of the run: "BH/Sq/Sk" -> calls
    fa = kernels["flash"]
    shapes: dict[str, int] = {}
    flash_bh = fa.flash_attention_bh

    def seen_flash(q, k, v, **kw):
        key = f"{q.shape[0]}/{q.shape[1]}/{k.shape[1]}"
        shapes[key] = shapes.get(key, 0) + 1
        return flash_bh(q, k, v, **kw)
    fa.flash_attention_bh = seen_flash
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in kernels.values():
        c.COUNTS["kernel"] = c.COUNTS["plain"] = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        for r in reqs:
            fe.submit(r, enc_states=encoder_forward(params["encoder"], cfg,
                                                    frames[r.rid]))
    torch.cuda.synchronize()
    encoder_s = time.perf_counter() - t0
    wall = serve.replay(fe)
    launches = {k: dict(m.COUNTS) for k, m in kernels.items()}
    fa.flash_attention_bh = flash_bh
    peak = torch.cuda.max_memory_allocated() / 2**30
    s, c = fe.stats, eng.counters
    L, Le = cfg.n_layers, cfg.encoder.n_layers
    n_cross = sum(kind == "cross_attn" for kind in cfg.block_pattern)
    # the shapes the B6 phase timed as the replay's commonest
    timed = {name: f"{B * H}/{Sq}/{Sk}"
             for name, B, Sq, Sk, H, *_ in FLASH_CASES
             if name in ("replay_cross_decode", "replay_cross_prefill")}
    checks = {
        "served_all": s.served == s.submitted == 8,
        "tokens_out": s.tokens_out > 0,
        "flash_launches": launches["flash"]["kernel"]
            == Le * len(reqs) + n_cross * (c["prefill_calls"]
                                           + c["decode_steps"]),
        "prefill_launches":
            launches["prefill"]["kernel"] == L * c["prefill_calls"],
        "decode_launches":
            launches["decode"]["kernel"] == L * c["decode_steps"],
        "no_other_kernel": all(launches[k]["kernel"] == 0
                               for k in ("verify", "mla_prefill", "ssd")),
        "no_plain": not any(v["plain"] for v in launches.values()),
        "flash_shapes_counted":
            sum(shapes.values()) == launches["flash"]["kernel"],
        "timed_cross_decode_ran": timed["replay_cross_decode"] in shapes,
        "timed_cross_prefill_ran": timed["replay_cross_prefill"] in shapes,
    }
    rec = {"phase": "whisper_replay", "model": cfg.name, "layers": L,
           "encoder_layers": Le, "submitted": s.submitted,
           "served": s.served, "attained": s.attained, "dropped": s.dropped,
           "tokens_out": s.tokens_out, "encoder_calls": len(reqs),
           "encoder_s": encoder_s,
           "counters": {k: c[k] for k in (
               "prefill_calls", "decode_calls", "decode_steps",
               "decode_tokens", "prefill_fused_ops")},
           "launches": launches,
           "flash_shapes": dict(sorted(shapes.items(),
                                       key=lambda kv: -kv[1])),
           "timed_flash_shapes": timed,
           "wall_s": wall, "span_s": timer.seconds,
           "spans": timer.count,
           "outside_spans_s": wall - sum(timer.seconds.values()),
           "prefill_group_ms": (1e3 * timer.seconds.get("prefill", 0.0)
                                / max(c["prefill_calls"], 1)),
           "decode_step_ms": (1e3 * timer.seconds.get("decode", 0.0)
                              / max(c["decode_steps"], 1)),
           "peak_mem_gib": peak, "checks": checks}
    eng.tracer = None
    rec["decode_breakdown"] = whisper_decode_breakdown(cfg, params, eng,
                                                       frames)
    emit(rec)
    if not all(checks.values()):
        raise SystemExit(f"whisper replay checks failed: {checks}")
    return launches


def whisper_decode_breakdown(cfg, params, eng, frames):
    """``cross_decode_breakdown`` over the encoder states of the first
    eight requests' frames."""
    from repro_torch.models import encoder_forward
    with torch.no_grad():
        enc = torch.cat([encoder_forward(params["encoder"], cfg, f)
                         for f in list(frames.values())[:8]])
    return cross_decode_breakdown(cfg, params, eng, enc)


def cross_decode_breakdown(cfg, params, eng, enc):
    """Device time of one decode step of ``len(enc)`` lanes over the
    replay's table width (every lane at position 400; chunk_len 0, so
    every write goes to the write-off page and the pools keep their
    state), whole and by part: the first cross layer's cross K/V
    projection of the lanes' encoder (or image) states ``enc`` (the
    reference's design repeats it in every step of every cross layer),
    its cross-attention (q projection, B6, output projection, the VLM's
    gate), its self-attention (the page write and B1), the unembedding;
    and the step's device time and B6's own (its split kernel; the merge
    launches are B1's and B6's together) from the profiler."""
    from repro_torch.models import attention, logits_fn, model_forward
    from repro_torch.models.layers import apply_norm

    dev = torch.device("cuda")
    B, width = enc.shape[0], eng.kv.max_pages_per_seq
    table = (torch.arange(B * width, device=dev, dtype=torch.int32)
             % eng.ecfg.total_pages).reshape(B, width)
    pos0 = torch.full((B,), 400, dtype=torch.int32, device=dev)
    none = torch.zeros(B, dtype=torch.int32, device=dev)
    tok = torch.ones(B, 1, dtype=torch.long, device=dev)
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(B, 1, cfg.d_model, generator=g, device=dev)
    # the first layer of the first segment of cross_attn blocks (a
    # segment of one layer is not stacked)
    i_seg, n_seg = next((i, n) for i, (k, n) in enumerate(cfg.segments())
                        if k == "cross_attn")
    seg = params["segments"][i_seg]["p"]

    def first(tree):
        return {k: t if n_seg == 1 else t[0] for k, t in tree.items()}
    p0 = {"attn": first(seg["attn"]), "cross": first(seg["cross"]),
          "norm1": first(seg["norm1"])}
    cache0 = first(eng.kv.pools[i_seg]["self"])
    gated = cfg.arch_type == "vlm"
    n_cross = cfg.block_pattern.count("cross_attn")
    with torch.no_grad():
        ekv = attention.project_cross_kv(p0["cross"], enc)
        h = apply_norm(p0["norm1"], x, cfg.norm)

    def step():
        hid, _, _ = model_forward(params, cfg, tok, cache=eng.kv.pools,
                                  pos0=pos0, block_tables=table,
                                  chunk_len=none, enc_states=enc)
        return logits_fn(params, cfg, hid[:, -1])
    parts = {
        "step_ms": step,
        "cross_kv_projection_ms": lambda: attention.project_cross_kv(
            p0["cross"], enc),
        "cross_attention_ms": lambda: attention.cross_attn_forward(
            p0["cross"], x, ekv, gated=gated),
        "self_attention_ms": lambda: attention.attn_forward(
            p0["attn"], h, cfg, positions=pos0[:, None], cache=cache0,
            pos0=pos0, block_tables=table, chunk_len=none),
        "unembed_ms": lambda: logits_fn(params, cfg, x[:, 0]),
    }
    out = {"lanes": B, "keys_per_lane": width * eng.ecfg.page_size,
           "encoder_frames": enc.shape[1], "cross_layers": n_cross}
    with torch.no_grad():
        for name, fn in parts.items():
            out[name] = time_ms(fn)
        reading = cuda_profile(step, n=1, flush=False)
    out["step_device_ms"], out["step_device_ops"] = cuda_sum(reading)
    out["step_b6_device_ms"] = cuda_sum(reading,
                                        ("flash_attention_kernel",))[0]
    out["cross_kv_projection_share_of_step"] = (
        n_cross * out["cross_kv_projection_ms"] / out["step_ms"])
    out["cross_attention_share_of_step"] = (
        n_cross * out["cross_attention_ms"] / out["step_ms"])
    return out


# ------------------------ llama-3.2-vision phases ----------------------- #
VLM_ARCH = "llama-3.2-vision-11b"
# every cross_attn block's gate (0 at init, so with random weights the
# image would add exactly nothing): tanh(1) = 0.76 of the cross output
VLM_GATE = 1.0
VLM_ENGINE = dict(max_slots=8, max_len=1024, page_size=16, total_pages=512)
VLM_STREAM_MAX_LEN = 256
# the first-step logits of one prompt under two images must differ by at
# least this much (100 ties): the image moves the result
VLM_IMAGE_MOVES = 100 * TIE
VLM_PUBLISHED = dict(d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
                     d_ff=14336, vocab=128256, n_image_tokens=1600)
# the VLM's first 10 of its 40 layers, widths unchanged: cross blocks 3
# and 8 among them.  With all 40 the whole script took 661-747 s on an
# H100 host, and a host that runs the host-bound phases 1.3-1.9x slower
# takes it past 1000 s of its 1200 s limit; the 40-layer VLM phases took
# 47-51 s of it.  With the VLM cut and the earlier paths at their
# depths it still took 790 s, hence MAIN_LAYERS, GATEWAY["layers"] and
# SPEC_LAYERS.
VLM_LAYERS = 10


def vlm_config():
    """llama-3.2-vision-11b at its published widths, its first
    VLM_LAYERS layers (its ``cross_attn`` blocks among them at depths 3
    and 8, as in the published pattern)."""
    from repro_torch.configs import get_config
    return cut_depth(get_config(VLM_ARCH), VLM_LAYERS)


def vlm_model(seed: int):
    """``vlm_config()`` with random weights from the seed, every cross
    gate set to VLM_GATE."""
    from repro_torch.device import generator
    from repro_torch.models import init_params
    dev = torch.device("cuda")
    cfg = vlm_config()
    return cfg, set_vlm_gates(init_params(cfg, generator(dev, seed),
                                          device=dev))


def set_vlm_gates(params):
    """Every cross block's gate set to VLM_GATE, in place."""
    for seg in params["segments"]:
        if "cross" in seg["p"]:
            seg["p"]["cross"]["gate"].fill_(VLM_GATE)
    return params


def vlm_image(cfg, seed: int, rid: int):
    """One request's image embeddings (1, 1600, 4096), the vision
    encoder's stub output, from a numpy seed."""
    import numpy as np
    a = np.random.default_rng([seed, rid]).standard_normal(
        (1, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return torch.from_numpy(a).to(torch.device("cuda"))


def vlm_gates(cfg, params) -> list:
    return [float(g) for seg in params["segments"] if "cross" in seg["p"]
            for g in seg["p"]["cross"]["gate"].reshape(-1).tolist()]


def vlm_stream_phase(cfg, params, seed: int):
    """The image moves the result: one prompt's first-step logits under
    two images (plain generation's forward) differ by at least
    VLM_IMAGE_MOVES.  Then the engine's greedy streams (B2 and B1 for
    every layer's self-attention, B6 for the cross-attention of the cross
    blocks over 1600 image tokens), each request with its own image,
    against plain generation under the tie rule, as in the stream
    phase."""
    from repro_torch.models import logits_fn, model_forward
    dev = torch.device("cuda")
    prompt = script_prompts(cfg, seed + 8, {0: 40})[0]
    first = []
    with torch.no_grad():
        for rid in (0, 1):
            h, _, _ = model_forward(params, cfg,
                                    torch.tensor([prompt], device=dev),
                                    enc_states=vlm_image(cfg, seed + 2, rid))
            first.append(logits_fn(params, cfg, h[0, -1]))
    moved = (first[0] - first[1]).abs().max().item()
    tops = [torch.topk(lg, 2).values for lg in first]
    image = {"max_abs_logit_change": moved, "limit": VLM_IMAGE_MOVES,
             "top2_margins": [(t[0] - t[1]).item() for t in tops],
             "argmax_changed": int(first[0].argmax()) != int(
                 first[1].argmax()),
             "gates": vlm_gates(cfg, params)}
    del first, h
    encs = {rid: vlm_image(cfg, seed, rid) for rid in STREAM_PROMPTS}
    image_ok = moved >= VLM_IMAGE_MOVES and all(
        g == VLM_GATE for g in image["gates"])
    if not image_ok:
        emit({"phase": "vlm_stream", "image": image, "ok": False})
        raise SystemExit(f"vlm_stream: the image does not move the logits "
                         f"({moved} < {VLM_IMAGE_MOVES})")
    weights = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    engine_streams({"phase": "vlm_stream", "model": cfg.name,
                    "layers": cfg.n_layers,
                    "cross_layers": cfg.block_pattern.count("cross_attn"),
                    "weights_gib": weights / 2**30, "image": image},
                   cfg, params, max_len=VLM_STREAM_MAX_LEN,
                   prompt_seed=seed + 9, encs=encs)


def vlm_replay_phase(cfg, params, kernels, seed: int):
    """The VLM path end to end: ``ServingFrontend`` with the launcher's
    scheduler and virtual perf model over ``ServingEngine`` (VLM_ENGINE:
    page 16, 8 slots) serving the launcher's chatbot trace
    (WHISPER_REPLAY's arguments); each request is submitted with
    ``enc_states`` its own image embeddings.  Launch counts are zeroed
    just before the replay and read just after: B6 once per cross block
    per prefill group and per decode step (no encoder), B2 and B1 once
    per layer (every block, the cross blocks too, has self-attention) per
    prefill group and per decode step, B3-B5 never, no plain version.  The
    line lists the (BH, Sq, Sk) of every B6 call, which must include the
    VLM replay shapes the B6 phase timed, and a decode step of eight
    lanes by part (``cross_decode_breakdown``)."""
    from repro_torch.core.scheduler import SchedulerConfig, SLOsServeScheduler
    from repro_torch.launch import serve
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    from repro_torch.serving.frontend import ServingFrontend

    dev = torch.device("cuda")
    eng = ServingEngine(cfg, params, EngineConfig(**VLM_ENGINE), device=dev)
    sched = SLOsServeScheduler(serve.VIRTUAL_PERF, SchedulerConfig(
        prefill_emits_first_token=True))
    fe = ServingFrontend(eng, sched, seed=seed)
    reqs = serve.trace(serve.parse_args(WHISPER_REPLAY
                                        + ["--seed", str(seed)]))
    images = {r.rid: vlm_image(cfg, seed + 1, r.rid) for r in reqs}
    for r in reqs:
        fe.submit(r, enc_states=images[r.rid])
    timer, shapes = SpanTimer(), ShapeLog(eng)
    eng.tracer = timer
    fa = kernels["flash"]
    flash_shapes: dict[str, int] = {}
    flash_bh = fa.flash_attention_bh

    def seen_flash(q, k, v, **kw):
        key = f"{q.shape[0]}/{q.shape[1]}/{k.shape[1]}"
        flash_shapes[key] = flash_shapes.get(key, 0) + 1
        return flash_bh(q, k, v, **kw)
    fa.flash_attention_bh = seen_flash
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in kernels.values():
        c.COUNTS["kernel"] = c.COUNTS["plain"] = 0
    try:
        wall = serve.replay(fe)
    finally:
        fa.flash_attention_bh = flash_bh
    launches = {k: dict(m.COUNTS) for k, m in kernels.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    eng.tracer = None
    s, c = fe.stats, eng.counters
    L = cfg.n_layers
    n_cross = cfg.block_pattern.count("cross_attn")
    timed = {name: f"{B * H}/{Sq}/{Sk}"
             for name, B, Sq, Sk, H, *_ in FLASH_CASES
             if name in ("vlm_replay_cross_decode",
                         "vlm_replay_cross_prefill")}
    pub = VLM_PUBLISHED
    checks = {
        "model_published_widths": (
            cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab, cfg.n_image_tokens)
        == tuple(pub[k] for k in ("d_model", "n_heads", "n_kv_heads",
                                  "head_dim", "d_ff", "vocab",
                                  "n_image_tokens")),
        "depth": (L, cfg.block_pattern) == (VLM_LAYERS,
                                             vlm_config().block_pattern)
                 and n_cross > 0,
        "gates_set": all(g == VLM_GATE for g in vlm_gates(cfg, params)),
        "served_all": s.served == s.submitted == len(reqs) == 8,
        "tokens_out": s.tokens_out > 0,
        "flash_launches": launches["flash"]["kernel"]
            == n_cross * (c["prefill_calls"] + c["decode_steps"]),
        "prefill_launches":
            launches["prefill"]["kernel"] == L * c["prefill_calls"],
        "decode_launches":
            launches["decode"]["kernel"] == L * c["decode_steps"],
        "no_other_kernel": all(launches[k]["kernel"] == 0
                               for k in ("verify", "mla_prefill", "ssd")),
        "no_plain": not any(v["plain"] for v in launches.values()),
        "flash_shapes_counted":
            sum(flash_shapes.values()) == launches["flash"]["kernel"],
        "timed_cross_decode_ran":
            timed["vlm_replay_cross_decode"] in flash_shapes,
        "timed_cross_prefill_ran":
            timed["vlm_replay_cross_prefill"] in flash_shapes,
    }
    rec = replay_record("vlm_replay", cfg, fe, eng, wall, launches, shapes,
                        timer, peak)
    rec.update({"cross_layers": n_cross, "image_tokens": cfg.n_image_tokens,
                "flash_shapes": dict(sorted(flash_shapes.items(),
                                            key=lambda kv: -kv[1])),
                "timed_flash_shapes": timed})
    with torch.no_grad():
        enc = torch.cat([images[r.rid] for r in reqs[:8]])
    rec["decode_breakdown"] = cross_decode_breakdown(cfg, params, eng, enc)
    rec["checks"] = checks
    emit(rec)
    if not all(checks.values()):
        raise SystemExit(f"vlm replay checks failed: "
                         f"{[k for k, v in checks.items() if not v]}")
    return launches


# ------------------------------- examples ------------------------------- #
# each example of the port (examples/torch_*.py) through its main() on the
# card, at its defaults (CUDA, smollm-135m at its published width where it
# serves or trains), with the arguments added here (the training example
# also gets a checkpoint directory).  The training example runs twice: at
# the published width, where the reference's 200 steps of 512 tokens see
# each of the 49152 tokens about twice as a context, too few to learn its
# successors, so its loss only has to stay finite; and at the reduced
# config the reference example trains, whose loss must fall by
# TRAIN_LOSS_DROP.
EXAMPLES = [("torch_quickstart", []), ("torch_serve_e2e", []),
            ("torch_spec_decode_demo", []), ("torch_multi_replica", []),
            ("torch_train_small", []), ("torch_train_small", ["--reduced"])]
# nats between the means of the first and of the last three logged losses
# (every 10th step; 6.19 -> 3.86 on the CPU over 200 steps)
TRAIN_LOSS_DROP = 1.0


def load_example(name: str):
    path = Path(__file__).resolve().parent / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def example_checks(name: str, argv: list, res: dict,
                   launches: dict) -> dict:
    """What each example's story must show on the card."""
    kernel = {k: v["kernel"] for k, v in launches.items()}
    plain = sum(v["plain"] for v in launches.values())
    served = {"kernels_launched": kernel["decode"] > 0
              and kernel["prefill"] > 0, "no_plain": plain == 0}
    if name == "torch_quickstart":
        return {"admitted": res["admitted"] == [2, 0, 1],
                "declined": res["declined"] == [3],
                "no_kernel": not any(kernel.values()), "no_plain": plain == 0}
    if name == "torch_serve_e2e":
        return {**served, "served_all": res["served"] == res["submitted"] > 0,
                "device": res["device"].startswith("cuda")}
    if name == "torch_spec_decode_demo":
        return {**served, "verify_launched": kernel["verify"] > 0,
                "served_all": res["served"] == res["submitted"] == 3,
                "drafted": res["drafted"] > 0,
                "accepted_le_drafted": res["accepted"] <= res["drafted"]}
    if name == "torch_multi_replica":
        return {**served,
                "budgets_drained": res["real"]["budget_used_after"]
                == res["round_robin"]["budget_used_after"]
                == res["affinity"]["budget_used_after"] == 0,
                "affinity_saves_at_least_round_robin":
                    res["affinity"]["prefix_hit_tokens"]
                    >= res["round_robin"]["prefix_hit_tokens"],
                "served": res["real"]["served"] > 0}
    losses = res["losses"]
    learn = ({"loss_falls": sum(losses[-3:]) / 3
              <= sum(losses[:3]) / 3 - TRAIN_LOSS_DROP}
             if "--reduced" in argv else {})
    return {**learn,
            "losses_finite": all(math.isfinite(x) for x in losses),
            "checkpoint_written": res["checkpoint_step"] == res["steps"],
            "no_kernel": not any(kernel.values()), "no_plain": plain == 0}


def examples_phase(kernels, card: str) -> dict:
    """Every example's ``main`` on the card, one line each: its returned
    numbers, the kernel launches it made (counts zeroed just before, read
    just after), its wall seconds and peak GiB beside the card's name and
    power limit, and its checks (``example_checks``).  The examples'
    own printing goes to a buffer; its last lines are in the record.
    Returns the launches summed over the examples."""
    import shutil
    import tempfile
    total = {k: {"kernel": 0, "plain": 0} for k in kernels}
    build_dir = Path(__file__).resolve().parent / "build"
    build_dir.mkdir(exist_ok=True)
    for name, extra in EXAMPLES:
        ckpt = None
        if name == "torch_train_small":
            ckpt = tempfile.mkdtemp(prefix="example_ckpt_", dir=build_dir)
            extra = [*extra, "--checkpoint-dir", ckpt]
        mod = load_example(name)
        free_device_memory()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in kernels.values():
            c.COUNTS["kernel"] = c.COUNTS["plain"] = 0
        out = io.StringIO()
        t = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                res = mod.main(list(extra))
            torch.cuda.synchronize()
        finally:
            if ckpt is not None:
                shutil.rmtree(ckpt, ignore_errors=True)
        wall = time.perf_counter() - t
        launches = {k: dict(m.COUNTS) for k, m in kernels.items()}
        for k, v in launches.items():
            for kind in ("kernel", "plain"):
                total[k][kind] += v[kind]
        checks = example_checks(name, extra, res, launches)
        emit({"phase": "examples", "example": name, "argv": extra,
              "result": res, "launches": launches, "wall_s": wall,
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
              "gpu": card, "printed_tail": out.getvalue().splitlines()[-4:],
              "checks": checks})
        if not all(checks.values()):
            raise SystemExit(f"example {name} checks failed: "
                             f"{[k for k, v in checks.items() if not v]}")
        del mod, res
    return total


# ----------------------- the kernels' remaining dtypes ------------------ #
# float16 pools (EngineConfig.dtype = torch.float16): every case of B1-B4
# runs again over fp16 pools (the same normal draws rounded to fp16), held
# at the float32 limit with pools bit-equal as 16-bit patterns; the main
# shape of each is timed, and the replay shape of B1 and B2.
F16_DECODE_TIMED = ("main", "replay")
F16_PREFILL_TIMED = ("main", "replay")
F16_VERIFY_TIMED = ("main",)
F16_MLA_TIMED = ("main",)
# bf16 inputs (B1's queries over bf16 pages, B5 and B6 whole): the kernel
# and its plain version widen the same bf16 inputs, sum in float32 and
# round once, so every output element must lie within one bf16 rounding
# of the plain version's float32 result over the same widened inputs:
# |kernel - plain32| <= 2^-8 |plain32| + 1e-5 (bf16 keeps 8 significant
# bits: a rounding moves a value by at most 2^-8 of it), far inside the
# reference's own bf16 tolerances (3e-2, 5e-2, 2e-2:
# tests/test_kernels.py).  Each line also gives the kernel's distance from
# the plain version's own bf16 output (at most one bf16 step apart).
LOWP_RTOL, LOWP_ATOL = 2.0 ** -8, 1e-5
# B1 over bf16 queries and pages: the reference test's shapes (seq_lens
# drawn in [1, max_pages page) as it draws them) and the main shape
# (timed).  No engine path passes bf16 queries: the engine's activations
# are float32.
BF16Q_CASES = [   # name, B, H, KVH, hd, page, max_pages, lens (None: drawn)
    ("ref_mha", 2, 4, 4, 64, 16, 4, None),
    ("ref_gqa4", 3, 8, 2, 32, 8, 6, None),
    ("ref_mqa", 1, 2, 1, 128, 32, 3, None),
    ("main", 8, 9, 3, 64, 16, 256, [1, 17, 333, 780, 1024, 1500, 1999, 2048]),
]
# B6 over bf16 q, k, v through the GQA wrapper: the reference test's four
# causal shapes (q at the cache's tail) and the launch layer's whisper
# shapes (two lanes: the encoder over 1500 frames, a 64-row cross prefill
# chunk, a cross decode step); the encoder timed
FLASH_BF16_CASES = [  # name, B, Sq, Sk, H, KV, hd, causal, q_offset, kv_len
    ("ref_128", 1, 128, 128, 2, 2, 64, True, 0, None),
    ("ref_gqa", 2, 64, 64, 4, 2, 32, True, 0, None),
    ("ref_mqa_256", 1, 256, 256, 2, 1, 64, True, 0, None),
    ("ref_chunk_384", 2, 128, 384, 2, 2, 64, True, 256, None),
    ("launch_encoder", 2, 1500, 1500, 20, 20, 64, False, 0, None),
    ("launch_cross_prefill", 2, 64, 1500, 20, 20, 64, False, 0, None),
    ("launch_cross_decode", 2, 1, 1500, 20, 20, 64, False, 0, None),
]
FLASH_BF16_TIMED = ("launch_encoder",)
# B5 over bf16 x, B, C and state: the reference test's draws (x, B, C
# normal, dt = softplus(normal) / 2, A = -exp(0.3 normal)) and its
# S / chunk / heads at the kernel's widths (head dim 64, state 64 or 128:
# the test's 16 / 32 are not built), one from a drawn state; and the
# launch layer's mamba2 prefill (two lanes, 512 tokens in chunks of 128
# from the zero state init_cache gives, at its widths and draws), timed
SSD_BF16_CASES = [  # name, B, S, chunk, state ("zero", "drawn", None), widths
    ("ref_S64_c16", 1, 64, 16, None, (2, 64, 64)),
    ("ref_S128_c32", 2, 128, 32, None, (4, 64, 128)),
    ("ref_S96_c32_state", 1, 96, 32, "drawn", (1, 64, 64)),
    ("launch_prefill", 2, 512, 128, "zero", (SSM_H, SSM_P, SSM_N)),
]
SSD_BF16_TIMED = ("launch_prefill",)


def bit_equal(a, b) -> bool:
    """Equal bit for bit (compared as integers of the elements' width)."""
    ints = {8: torch.int64, 4: torch.int32, 2: torch.int16}
    it = ints[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.view(it), b.view(it))


def lowp_reading(got, want32, want16) -> dict:
    """A bf16 output against the plain version's float32 result and its
    own bf16 output (``LOWP_RTOL``, ``LOWP_ATOL``)."""
    gf = got.float()
    err = (gf - want32).abs()
    excess = (err - (LOWP_RTOL * want32.abs() + LOWP_ATOL)).max().item()
    return {"max_abs_err": err.max().item(),
            "max_abs_plain": want32.abs().max().item(),
            "worst_excess_over_limit": excess,
            "max_abs_err_vs_plain_bf16": (gf - want16.float()).abs().max()
            .item(),
            "elements_off_plain_bf16": int((got != want16).sum().item()),
            "elements": got.numel(), "ok": excess <= 0.0}


def lowp_kernel_phase(pa, fa, sk, seed=12):
    """B1 with bf16 queries over bf16 pages, B6 and B5 over bf16 inputs,
    each against its plain version (``lowp_reading``), with the keys no
    query may see poisoned for B1 and B6.  Returns the timed records by
    kernel."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    out = {}
    for name, B, H, KVH, hd, page, max_pages, lens in BF16Q_CASES:
        kp, vp, table = pools_and_tables(gen, B, KVH, hd, page, max_pages,
                                         BF16)
        if lens is None:
            lens = torch.randint(1, max_pages * page, (B,), generator=gen,
                                 device="cuda").tolist()
        q = torch.randn(B, H, hd, generator=gen, device="cuda").to(BF16)
        sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        scale = hd ** -0.5
        got = pa.paged_decode_attention(q, kp, vp, table, sl)
        want32 = pa.paged_decode_plain(q.float(), kp, vp, table, sl,
                                       scale=scale)
        want16 = pa.paged_decode_plain(q, kp, vp, table, sl, scale=scale)
        kpp, vpp = kp.clone(), vp.clone()
        mapped = torch.zeros(kp.shape[0], dtype=torch.bool, device="cuda")
        mapped[table.long().flatten()] = True
        kpp[~mapped] = 1e4
        vpp[~mapped] = 1e4
        pos = torch.arange(max_pages * page, device="cuda")
        flat = (table.long()[:, :, None] * page
                + torch.arange(page, device="cuda")).reshape(B, -1)
        bad = pos[None] >= sl[:, None]
        kpp.view(-1, KVH, hd)[flat[bad]] = 1e4
        vpp.view(-1, KVH, hd)[flat[bad]] = 1e4
        poisoned = pa.paged_decode_attention(q, kpp, vpp, table, sl)
        torch.cuda.synchronize()
        rec = {"phase": "kernel", "kernel": "paged_decode_attention",
               "case": name, "query_dtype": "bfloat16",
               "page_dtype": "bfloat16", "B": B, "H": H, "KVH": KVH,
               "hd": hd, "page": page, "seq_lens": lens,
               "out_dtype": str(got.dtype).split(".")[-1],
               **lowp_reading(got, want32, want16),
               "poisoned_unread": bit_equal(poisoned, got)}
        rec["ok"] = (rec["ok"] and rec["poisoned_unread"]
                     and got.dtype == BF16)
        if name == "main":
            rec.update(decode_timing(pa, q, kp, vp, table, sl, lens, None,
                                     lib_dtype=BF16))
            out["bf16q"] = rec
        emit(rec)
        if not rec["ok"]:
            raise SystemExit(f"paged_decode_attention (bf16 q) disagrees "
                             f"({name})")
    for (name, B, Sq, Sk, H, KV, hd, causal, q_offset,
         kv_len) in FLASH_BF16_CASES:
        q, k, v = (torch.randn(B, S, n, hd, generator=gen, device="cuda")
                   .to(BF16) for S, n in ((Sq, H), (Sk, KV), (Sk, KV)))
        if name.startswith("ref_chunk"):
            q_offset = Sk - Sq
        kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
        got = fa.attention(q, k, v, **kw)
        qf, kf, vf = flat_heads(q, k, v)
        n_k = Sk if kv_len is None else kv_len
        want = [fa.flash_attention_plain(
            *ts, causal=causal, q_offset=q_offset, kv_len=n_k,
            scale=hd ** -0.5).reshape(B, H, Sq, hd).transpose(1, 2)
            for ts in ((qf.float(), kf.float(), vf.float()), (qf, kf, vf))]
        seen = max(visible_keys(Sq, Sk, causal, q_offset, kv_len))
        kp, vp = k.clone(), v.clone()
        kp[:, seen:] = 1e4
        vp[:, seen:] = 1e4
        poisoned = fa.attention(q, kp, vp, **kw)
        torch.cuda.synchronize()
        rec = {"phase": "kernel", "kernel": "flash_attention_bh",
               "case": name, "dtype": "bfloat16", "B": B, "Sq": Sq,
               "Sk": Sk, "H": H, "KV": KV, "hd": hd, "BH": B * H,
               "causal": causal, "q_offset": q_offset, "kv_len": kv_len,
               "warps_per_rows": fa.warps_per_rows(Sq),
               "splits": fa.n_splits(B * H, Sq, seen, torch.cuda
                                     .get_device_properties(0)
                                     .multi_processor_count),
               "keys_poisoned": Sk - seen,
               "out_dtype": str(got.dtype).split(".")[-1],
               **lowp_reading(got, *want),
               "poisoned_unread": bit_equal(poisoned, got)}
        rec["ok"] = (rec["ok"] and rec["poisoned_unread"]
                     and got.dtype == BF16)
        if name in FLASH_BF16_TIMED:
            rec.update(flash_timing(fa, qf, kf, vf, causal, q_offset, kv_len))
            out["flash"] = rec
        emit(rec)
        if not rec["ok"]:
            raise SystemExit(f"flash_attention_bh (bf16) disagrees ({name})")
    F = torch.nn.functional
    for name, B, S, chunk, state, (H, P, N) in SSD_BF16_CASES:
        if name.startswith("ref_"):
            def normal(*shape):
                return torch.randn(*shape, generator=gen, device="cuda")
            xh, Bm, Cm = normal(B, S, H, P), normal(B, S, N), normal(B, S, N)
            dt = F.softplus(normal(B, S, H)) * 0.5
            A = -torch.exp(normal(H) * 0.3)
            h0 = normal(B, H, P, N) * 0.3 if state == "drawn" else None
        else:
            xh, dt, A, Bm, Cm, h0 = ssd_inputs(gen, B, S, None, False,
                                               (H, P, N))
            h0 = torch.zeros(B, H, P, N, device="cuda")
        xh, Bm, Cm = xh.to(BF16), Bm.to(BF16), Cm.to(BF16)
        h0 = None if h0 is None else h0.to(BF16)
        y, hT = sk.ssd_scan(xh, dt, A, Bm, Cm, chunk=chunk, init_state=h0)
        w32 = sk.ssd_chunked_plain(xh.float(), dt, A, Bm.float(), Cm.float(),
                                   chunk, None if h0 is None else h0.float())
        w16 = sk.ssd_chunked_plain(xh, dt, A, Bm, Cm, chunk, h0)
        torch.cuda.synchronize()
        ry = lowp_reading(y, w32[0], w16[0])
        rh = lowp_reading(hT, w32[1], w16[1])
        rec = {"phase": "kernel", "kernel": "ssd_scan", "case": name,
               "dtype": "bfloat16", "B": B, "S": S, "chunk": chunk, "H": H,
               "P": P, "N": N, "init_state": state,
               "cb_workspace": sk.cb_workspace(chunk),
               "out_dtypes": [str(t.dtype).split(".")[-1] for t in (y, hT)],
               "max_abs_err": max(ry["max_abs_err"], rh["max_abs_err"]),
               "y": ry, "state": rh,
               "ok": ry["ok"] and rh["ok"] and y.dtype == hT.dtype == BF16}
        if name in SSD_BF16_TIMED:
            rec.update(ssd_timing(sk, xh, dt, A, Bm, Cm, h0, chunk))
            out["ssd"] = rec
        emit(rec)
        if not rec["ok"]:
            raise SystemExit(f"ssd_scan (bf16) disagrees ({name})")
    return out


# ------------------------ the launch layer in bf16 ----------------------- #
# ``launch/steps.make_prefill_step`` and ``make_serve_step`` at their
# default bf16, on real tensors on the card: params from ``init_params`` /
# ``init_encdec_params`` at bf16, the dense caches of ``init_cache`` at
# bf16.  whisper-large-v3 at its published width and depth runs its
# encoder over 1500 frames and its cross attention through B6 (the serve
# step re-encodes, as the reference's does); mamba2-2.7b at its published
# widths runs its prefill through B5 (4 chunks of 128 from a zero state).
LAUNCH_STEPS = {   # arch: lanes, prompt tokens, serve steps
    "whisper-large-v3": dict(lanes=2, prompt=64, steps=8),
    "mamba2-2.7b": dict(lanes=2, prompt=512, steps=8),
}
# Each step's last-position logits are held against the same step with B5
# and B6 swapped for their plain versions (fed the kernel run's tokens).
# Both runs round every bf16 product and activation, and a kernel's output
# may round one bf16 step away from its plain version's (the kernel
# phase's check); the layers after it carry such a step, and at depth
# they grow it: a CPU rehearsal (scripts/rehearse_lowp_phase.py) whose
# stand-in kernels moved the plain float32 results by 1e-6 relative
# before rounding put mamba2's logits 1.42 x 2^-5 of their largest apart
# at 64 layers (whisper's 0.67 x at 32).  So the gate is read in the same
# call: a control run of the plain versions with their float32 results
# moved by ``LAUNCH_CONTROL_REL`` x a normal draw before rounding (the
# 3xTF32 kernels' float32 error) diverges from the plain run by some
# reading; the kernel run may diverge by at most twice that, and never
# less than 2^-5 of the largest logit (a few bf16 steps).  The greedy
# tokens must be equal unless the plain run's top-2 margin there is below
# that gate (a tie).
LAUNCH_LOGIT_RTOL = 2.0 ** -5
LAUNCH_CONTROL_REL = 1e-6


@contextlib.contextmanager
def plain_b5_b6(rel: float = 0.0, seed: int = 0):
    """The model's calls of B5 and B6 through their plain versions, for
    one run: the yardstick of the bf16 launch steps (the package has no
    such switch).  ``models/ssm.py`` calls ``kernels.ssd_scan.ssd_scan``
    and the GQA wrapper ``attention`` calls ``flash_attention_bh``, each
    looked up in its module at call time.  Each computes the plain
    version's float32 result over the widened inputs and rounds it to the
    inputs' dtype, as the plain version does; ``rel`` > 0 first moves it
    by ``rel`` x a normal draw (the control run)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as sk
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def moved(t, dtype):
        if rel:
            t = t * (1 + rel * torch.randn(t.shape, generator=g,
                                           device=t.device))
        return t.to(dtype)

    def ssd(xh, dt, A, Bm, Cm, *, chunk, init_state=None):
        y, h = sk.ssd_chunked_plain(
            xh.float(), dt, A, Bm.float(), Cm.float(), chunk,
            None if init_state is None else init_state.float())
        return moved(y, xh.dtype), moved(h, xh.dtype)

    def flash(q, k, v, *, causal=True, q_offset=0, kv_len=None, scale=None):
        return moved(fa.flash_attention_plain(
            q.float(), k.float(), v.float(), causal=causal,
            q_offset=int(q_offset),
            kv_len=k.shape[1] if kv_len is None else int(kv_len),
            scale=q.shape[-1] ** -0.5 if scale is None else float(scale)),
            q.dtype)
    saved = sk.ssd_scan, fa.flash_attention_bh
    sk.ssd_scan, fa.flash_attention_bh = ssd, flash
    try:
        yield
    finally:
        sk.ssd_scan, fa.flash_attention_bh = saved


def launch_steps_run(cfg, params, tokens, enc, n_steps, forced=None):
    """``make_prefill_step`` over ``tokens`` (lanes, prompt), then
    ``n_steps`` of ``make_serve_step`` from its greedy token (or the
    tokens of ``forced``, (lanes, n_steps + 1), as a second run is fed the
    first's).  Returns (each step's last-position logits as float32,
    (lanes, n_steps + 1) greedy tokens, the bf16 dtypes seen)."""
    from repro_torch.launch import steps
    from repro_torch.models.transformer import init_cache
    lanes, S = tokens.shape
    dev = tokens.device
    cache = init_cache(cfg, lanes, S + n_steps, BF16, dev)
    logits, orig = [], steps.logits_fn

    def record(p, c, h):
        out = orig(p, c, h)
        logits.append(out[:, -1].float())
        return out
    steps.logits_fn = record
    try:
        with torch.no_grad():
            lg, cache = steps.make_prefill_step(cfg)(params, tokens, cache,
                                                     enc)
            dtypes = {"prefill_logits": str(lg.dtype).split(".")[-1]}
            tok = lg[:, -1].float().argmax(-1).to(torch.int32)
            toks = [tok]
            serve = steps.make_serve_step(cfg)
            for i in range(n_steps):
                if forced is not None:
                    tok = forced[:, i]
                pos0 = torch.full((lanes,), S + i, dtype=torch.int32,
                                  device=dev)
                tok, cache = serve(params, tok[:, None], cache, pos0, enc)
                toks.append(tok)
            dtypes["cache"] = sorted({str(t.dtype).split(".")[-1]
                                      for t in tree_leaves(cache)})
    finally:
        steps.logits_fn = orig
    return logits, torch.stack(toks, 1), dtypes


def launch_step_case(arch, kernels, seed, dev):
    """One arch of ``LAUNCH_STEPS``: the steps through the kernels, then
    through the plain B5 / B6 fed the same tokens; logits, tokens and
    launch counts checked.  Returns the case's record."""
    from repro_torch.configs import get_config
    from repro_torch.device import generator
    from repro_torch.models import init_encdec_params, init_params
    spec = LAUNCH_STEPS[arch]
    cfg = get_config(arch)
    init = init_encdec_params if cfg.arch_type == "encdec" else init_params
    params = init(cfg, generator(dev, seed), BF16, dev)
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 13)
    lanes, S, n = spec["lanes"], spec["prompt"], spec["steps"]
    tokens = torch.randint(1, cfg.vocab, (lanes, S), generator=g,
                           device=dev, dtype=torch.int32)
    enc = None
    if cfg.arch_type == "encdec":
        enc = torch.randn(lanes, cfg.encoder.n_frames, cfg.d_model,
                          generator=g, device=dev).to(BF16)
    zero_counts(kernels)
    t0 = time.perf_counter()
    got, toks, dtypes = launch_steps_run(cfg, params, tokens, enc, n)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kernel_run = kernel_counts(kernels)
    zero_counts(kernels)
    with plain_b5_b6():
        want, ptoks, _ = launch_steps_run(cfg, params, tokens, enc, n,
                                          forced=toks)
    torch.cuda.synchronize()
    plain_run = kernel_counts(kernels)
    with plain_b5_b6(LAUNCH_CONTROL_REL, seed):
        ctrl, _, _ = launch_steps_run(cfg, params, tokens, enc, n,
                                      forced=toks)

    def spread(run):       # the worst step's distance over 2^-5 max |plain|
        return max((a - b).abs().max().item()
                   / (LAUNCH_LOGIT_RTOL * b.abs().max().item())
                   for a, b in zip(run, want))
    worst, control = spread(got), spread(ctrl)
    gate = max(1.0, 2.0 * control)
    ties, equal = [], True
    for i, b in enumerate(want):
        tol = gate * LAUNCH_LOGIT_RTOL * b.abs().max().item()
        top = torch.topk(b, 2, dim=-1).values
        for lane in range(lanes):
            if int(toks[lane, i]) != int(ptoks[lane, i]):
                margin = (top[lane, 0] - top[lane, 1]).item()
                ties.append({"step": i, "lane": lane, "margin": margin,
                             "tol": tol})
                equal = equal and margin < tol
    n_cross = sum(n for kind, n in cfg.segments() if kind == "cross_attn")
    n_ssm = sum(n for kind, n in cfg.segments() if kind == "ssm")
    flash_calls = ((cfg.encoder.n_layers if cfg.encoder else 0) + n_cross) \
        * (n + 1)
    others = [k for k in kernel_run if k not in ("ssd", "flash")]
    checks = {
        "logits_within_gate": worst <= gate,
        "tokens_equal_or_tie": equal,
        "flash_launches": kernel_run["flash"]["kernel"] == flash_calls,
        "ssd_launches": kernel_run["ssd"]["kernel"] == n_ssm,
        "no_plain_in_kernel_run": not any(v["plain"]
                                          for v in kernel_run.values()),
        "no_kernel_in_plain_run": not any(v["kernel"]
                                          for v in plain_run.values()),
        "no_paged_kernel": not any(kernel_run[k]["kernel"] for k in others),
        "bf16_dtypes": dtypes == {"prefill_logits": "bfloat16",
                                  "cache": ["bfloat16"]},
    }
    rec = {"arch": arch, "layers": cfg.n_layers, "lanes": lanes,
           "prompt": S, "serve_steps": n, "dtypes": dtypes,
           "worst_logit_err_over_tol": worst,
           "control_logit_err_over_tol": control, "gate": gate,
           "token_differences": ties,
           "tokens": toks.tolist(), "kernel_run": kernel_run,
           "plain_run": plain_run, "wall_s": wall, "checks": checks}
    del params
    return rec


def bf16_launch_steps_phase(kernels, seed: int):
    """The launch layer's bf16 prefill and serve steps on the card
    (``LAUNCH_STEPS``): B6 once per encoder layer and cross layer per
    step, B5 once per SSM layer per prefill, nothing else, against the
    plain versions.  Returns {"bf16_launch_steps": its launches} for the
    kernels line."""
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cases, launches = {}, None
    for arch in LAUNCH_STEPS:
        cases[arch] = launch_step_case(arch, kernels, seed, dev)
        free_device_memory()
        run = cases[arch]["kernel_run"]
        launches = run if launches is None else {
            k: {c: launches[k][c] + run[k][c] for c in run[k]} for k in run}
    ok = all(all(c["checks"].values()) for c in cases.values())
    rec = {"phase": "bf16_launch_steps", "cases": cases,
           "launches": launches, "seconds": time.perf_counter() - t0,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "ok": ok}
    emit(rec)
    if not ok:
        raise SystemExit("bf16_launch_steps checks failed")
    return launches


# ------------------------- hybrid and MoE phases ------------------------ #
HYBRID_ARCH = "zamba2-7b"
HYBRID_H, HYBRID_P, HYBRID_N = 112, 64, 64
# The hybrid path's engine: page 16, 4 slots (so slots are reused), 1024
# pages (16 tokens x 372,736 B over the 13 shared-attention occurrences:
# 5.7 GiB of pools), max_len 1024.
HYBRID_ENGINE = dict(max_slots=4, max_len=1024, page_size=16,
                     total_pages=1024)
# B5 at zamba2's widths (112 heads, head dim 64, state 64): the hybrid
# replay's commonest prefill group (one lane's 32-token bucket with 17 live
# rows, from the lane's carried state: 27 of its 61 groups in a CPU
# rehearsal at the card's engine config), a 128-token chunk (the model's
# chunk) from a state, lanes padded with dt = 0 (one all padding), 512
# tokens in chunks of 128, and a 763-token prompt as one chunk (plain
# generation runs a whole prompt whose length 128 does not divide so).
SSD_HYBRID_CASES = [
    ("zamba2_replay", 1, 32, 32, True, [17]),
    ("zamba2_c128", 1, 128, 128, True, None),
    ("zamba2_padded_lanes", 4, 16, 16, True, [16, 11, 0, 0]),
    ("zamba2_S512_c128", 1, 512, 128, True, None),
    ("zamba2_S763_one_chunk", 1, 763, 763, False, None),
]
SSD_HYBRID_TIMED = ("zamba2_replay", "zamba2_c128", "zamba2_S763_one_chunk")
CHATBOT_REPLAY = ["--scenario", "chatbot", "--rate", "2.0", "--time-scale",
                  "0.25", "--max-requests", "8", "--duration", "10"]


def hybrid_model(seed: int):
    """zamba2-7b at its published width and depth and its random weights
    (5.74 B parameters, 21.4 GiB in float32): 68 Mamba2 layers and one
    shared attention block (32 heads of 112) run at 13 depths."""
    from repro_torch.configs import get_config
    from repro_torch.device import generator
    from repro_torch.models import init_params
    dev = torch.device("cuda")
    cfg = get_config(HYBRID_ARCH)
    return cfg, init_params(cfg, generator(dev, seed), device=dev)


def hybrid_stream_phase(cfg, params, seed: int):
    """The engine's greedy streams on full-width zamba2 (B5 in every
    Mamba2 layer and B2 / B1 at every shared-attention occurrence, each
    over its own pools; lane rows gathered and scattered per call) against
    plain full-causal generation (B5 over the whole sequence as one chunk,
    B6 at head dim 112), in the SSM stream phase's script: two slots, a
    frozen decode lane, a second prefill from a mid-chunk state and a slot
    reused."""
    engine_streams({"phase": "hybrid_stream", "model": cfg.name,
                    "layers": cfg.n_layers}, cfg, params, max_len=256,
                   prompt_seed=seed + 5, max_slots=2,
                   prompt_lens=SSM_STREAM_PROMPTS, script=SSM_STREAM_SCRIPT)


def serve_replay(cfg, params, kernels, arch_args, ecfg, seed: int):
    """``ServingFrontend`` with the launcher's ``SLOsServeScheduler`` and
    virtual perf model over a fresh ``ServingEngine(ecfg)``, serving the
    launcher's trace for ``arch_args``; the kernel launch counts are
    zeroed just before and read just after.  Returns (frontend, engine,
    wall s, launches, ShapeLog, SpanTimer, peak GiB)."""
    from repro_torch.core.scheduler import SchedulerConfig, SLOsServeScheduler
    from repro_torch.launch import serve
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    from repro_torch.serving.frontend import ServingFrontend

    eng = ServingEngine(cfg, params, EngineConfig(**ecfg),
                        device=torch.device("cuda"))
    sched = SLOsServeScheduler(serve.VIRTUAL_PERF, SchedulerConfig(
        prefill_emits_first_token=True))
    fe = ServingFrontend(eng, sched, seed=seed)
    for req in serve.trace(serve.parse_args(arch_args
                                            + ["--seed", str(seed)])):
        fe.submit(req)
    timer, shapes = SpanTimer(), ShapeLog(eng)
    eng.tracer = timer
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in kernels.values():
        c.COUNTS["kernel"] = c.COUNTS["plain"] = 0
    wall = serve.replay(fe)
    launches = {k: dict(m.COUNTS) for k, m in kernels.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    eng.tracer = None
    return fe, eng, wall, launches, shapes, timer, peak


def replay_record(phase, cfg, fe, eng, wall, launches, shapes, timer, peak):
    s, c = fe.stats, eng.counters
    return {"phase": phase, "model": cfg.name, "layers": cfg.n_layers,
            "slots": eng.ecfg.max_slots, "pages": eng.ecfg.total_pages,
            "submitted": s.submitted, "served": s.served,
            "attained": s.attained, "dropped": s.dropped,
            "tokens_out": s.tokens_out,
            "counters": {k: c[k] for k in (
                "prefill_calls", "decode_calls", "decode_steps",
                "decode_tokens")},
            "launches": launches, "shapes": shapes.summary(),
            "wall_s": wall, "span_s": timer.seconds, "spans": timer.count,
            "outside_spans_s": wall - sum(timer.seconds.values()),
            "prefill_group_ms": (1e3 * timer.seconds.get("prefill", 0.0)
                                 / max(c["prefill_calls"], 1)),
            "decode_step_ms": (1e3 * timer.seconds.get("decode", 0.0)
                               / max(c["decode_steps"], 1)),
            "peak_mem_gib": peak}


def hybrid_replay_phase(cfg, params, kernels, seed: int):
    """The hybrid path end to end: the chatbot replay (8 requests, lengths
    scaled by 0.25, 2/s) on full-width zamba2 with HYBRID_ENGINE.  Launch
    counts zeroed just before and read just after: B2 once per
    shared-attention occurrence per prefill group, B1 once per occurrence
    per decode step, B5 once per Mamba2 layer per prefill group, B3, B4,
    B6 and the plain versions never.  The line lists the shapes the replay
    gave B2 and B1 (and B5: the prefill buckets), which must include the
    "zamba2_replay" shapes the kernel phases timed, and where a decode step
    and a prefill group spend their time (``hybrid_breakdown``)."""
    fe, eng, wall, launches, shapes, timer, peak = serve_replay(
        cfg, params, kernels, ["--arch", HYBRID_ARCH] + CHATBOT_REPLAY,
        HYBRID_ENGINE, seed)
    s, c = fe.stats, eng.counters
    n_attn = cfg.block_pattern.count("shared_attn")
    n_ssm = cfg.block_pattern.count("ssm")
    (_, dB, *_, (d_len,), _), = [k for k in DECODE_CASES
                                 if k[0] == "zamba2_replay"]
    (_, pB, pS, *_, p_live, _), = [k for k in PREFILL_CASES
                                   if k[0] == "zamba2_replay"]
    (_, sB, sS, _, _, s_live), = [k for k in SSD_HYBRID_CASES
                                  if k[0] == "zamba2_replay"]

    def ran(B, S, live):
        return any(lv == tuple(live)
                   for _, lv in shapes.exact.get(f"{B}/{S}", []))
    checks = {
        "model_full_width": (cfg.n_layers, cfg.d_model, cfg.n_heads,
                             cfg.n_kv_heads, cfg.head_dim, cfg.ssm.d_state,
                             cfg.ssm.head_dim, n_attn, n_ssm)
        == (81, 3584, 32, 32, 112, 64, 64, 13, 68),
        "served_all": s.served == s.submitted == 8,
        "tokens_out": s.tokens_out > 0,
        "decode_launches":
            launches["decode"]["kernel"] == n_attn * c["decode_steps"],
        "prefill_launches":
            launches["prefill"]["kernel"] == n_attn * c["prefill_calls"],
        "ssd_launches":
            launches["ssd"]["kernel"] == n_ssm * c["prefill_calls"],
        "no_other_kernel": all(launches[k]["kernel"] == 0
                               for k in ("verify", "mla_prefill", "flash")),
        "no_plain": not any(v["plain"] for v in launches.values()),
        "timed_decode_shape_ran": d_len in shapes.longest.get(str(dB), ()),
        "timed_prefill_shape_ran": ran(pB, pS, p_live),
        "timed_ssd_shape_ran": ran(sB, sS, s_live),
    }
    rec = replay_record("hybrid_replay", cfg, fe, eng, wall, launches, shapes,
                        timer, peak)
    rec.update({"shared_attn_occurrences": n_attn, "ssm_layers": n_ssm,
                "breakdown": hybrid_breakdown(cfg, params, eng),
                "checks": checks})
    emit(rec)
    if not all(checks.values()):
        raise SystemExit(f"hybrid replay checks failed: "
                         f"{[k for k, v in checks.items() if not v]}")
    return launches


def hybrid_breakdown(cfg, params, eng):
    """Where a zamba2 step's time goes, at the replay's commonest shapes:
    a decode step of the engine's 4 lanes (every lane at position 337,
    chunk_len 0, so the pools and lane rows keep their state) and a
    prefill group of one lane's 32-row bucket with 17 live rows at
    position 99 (slot 0's lane rows, gathered, its new rows dropped).
    Each: CUDA events around the call (the host's dispatch included),
    ``torch.profiler``'s device time of all its kernels, of B5's and of
    B1's or B2's, so the card's idle share in the call is 1 - device /
    call; and one Mamba2 block and the shared attention block alone
    (CUDA events), times their 68 and 13 occurrences."""
    from repro_torch.models import logits_fn, model_forward
    from repro_torch.models.transformer import _layer, block_forward

    dev = eng.device
    segs = cfg.segments()
    ia = next(i for i, (k, _) in enumerate(segs) if k == "shared_attn")
    ssm_p = _layer(params["segments"][0]["p"], 0)
    n_attn = cfg.block_pattern.count("shared_attn")
    n_ssm = cfg.block_pattern.count("ssm")
    width = eng.kv.max_pages_per_seq
    g = torch.Generator(device=dev).manual_seed(9)
    out = {}
    with torch.no_grad():
        for name, B, S, pos, live, attn_kernel in (
                ("decode", eng.ecfg.max_slots, 1, 337, 0,
                 "paged_decode_attention"),
                ("prefill", 1, 32, 99, 17, "paged_prefill_attention")):
            tok = torch.ones(B, S, dtype=torch.long, device=dev)
            pos0 = torch.full((B,), pos, dtype=torch.int32, device=dev)
            clen = torch.full((B,), live, dtype=torch.int32, device=dev)
            table = (torch.arange(B * width, device=dev, dtype=torch.int32)
                     % eng.ecfg.total_pages).reshape(B, width)
            lanes = eng.kv.lane_cache(list(range(B)))
            x = torch.randn(B, S, cfg.d_model, generator=g, device=dev)
            positions = pos0[:, None] + torch.arange(S, device=dev)[None]
            rows = {k: t[0] for k, t in lanes[0].items()}

            def step():
                hid, _, _ = model_forward(params, cfg, tok, cache=lanes,
                                          pos0=pos0, block_tables=table,
                                          chunk_len=clen)
                return logits_fn(params, cfg, hid[:, -1])

            def ssm_block():
                return block_forward(ssm_p, "ssm", cfg, x,
                                     positions=positions, cache=rows,
                                     chunk_len=clen)

            def attn_block():
                return block_forward(params["shared_attn"], "shared_attn",
                                     cfg, x, positions=positions,
                                     cache=lanes[ia]["self"], pos0=pos0,
                                     block_tables=table, chunk_len=clen)
            rec = {"B": B, "S": S, "pos0": pos, "live": live,
                   "call_ms": time_ms(step),
                   "ssm_block_ms": time_ms(ssm_block),
                   "shared_attn_block_ms": time_ms(attn_block)}
            reading = cuda_profile(step, n=1, flush=False)
            total, ops = cuda_sum(reading)
            rec.update({
                "ssm_layers_ms": n_ssm * rec["ssm_block_ms"],
                "shared_attn_ms": n_attn * rec["shared_attn_block_ms"],
                "device_ms": total, "device_ops": ops,
                "ssd_device_ms": cuda_sum(reading,
                                          KERNEL_NAMES["ssd_scan"])[0],
                "attention_kernel_device_ms": cuda_sum(
                    reading, KERNEL_NAMES[attn_kernel])[0],
                "device_idle_share": (None if total is None
                                      else 1 - total / rec["call_ms"])})
            out[name] = rec
    return out


MOE_ARCH = "phi3.5-moe-42b-a6.6b"
# the published widths, 32 layers cut to 4 (20.4 GiB in float32; the
# whole model is 156 GiB)
MOE_CUT = dict(n_layers=4, block_pattern=("attn_moe",) * 4)
MOE_ENGINE = dict(max_slots=8, max_len=1024, page_size=16, total_pages=512)


def moe_model(seed: int):
    """phi3.5-moe-42b-a6.6b at its published widths (d_model 4096, 32 / 8
    heads of 128, 16 experts top-2 of d_ff 6400, vocab 32064 untied), its
    32 layers cut to 4, random weights from the seed."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.device import generator
    from repro_torch.models import init_params
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(MOE_ARCH), **MOE_CUT)
    return cfg, init_params(cfg, generator(dev, seed), device=dev)


def moe_stream_phase(cfg, params, seed: int):
    """The engine's greedy streams on the cut phi3.5-moe (B2 and B1 at G 4,
    head dim 128; the MoE FFN with the dropless capacity factor) against
    plain full-causal generation, in the stream phase's script."""
    engine_streams({"phase": "moe_stream", "model": cfg.name,
                    "layers": cfg.n_layers}, cfg, params, max_len=256,
                   prompt_seed=seed + 6)


def moe_replay_phase(cfg, params, kernels, seed: int):
    """The ``attn_moe`` path end to end: the chatbot replay (8 requests)
    on the cut phi3.5-moe with MOE_ENGINE.  Launch counts zeroed just
    before and read just after: B2 once per layer per prefill group, B1
    once per layer per decode step, nothing else, no plain version."""
    fe, eng, wall, launches, shapes, timer, peak = serve_replay(
        cfg, params, kernels, ["--arch", MOE_ARCH] + CHATBOT_REPLAY,
        MOE_ENGINE, seed)
    s, c = fe.stats, eng.counters
    L = cfg.n_layers
    m = cfg.moe
    checks = {
        "model_published_widths": (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.head_dim, m.n_experts, m.top_k,
                                   m.d_ff_expert, cfg.vocab,
                                   cfg.tie_embeddings)
        == (4096, 32, 8, 128, 16, 2, 6400, 32064, False),
        "depth_cut": cfg.block_pattern == ("attn_moe",) * 4,
        "served_all": s.served == s.submitted == 8,
        "tokens_out": s.tokens_out > 0,
        "decode_launches":
            launches["decode"]["kernel"] == L * c["decode_steps"],
        "prefill_launches":
            launches["prefill"]["kernel"] == L * c["prefill_calls"],
        "no_other_kernel": all(launches[k]["kernel"] == 0 for k in (
            "verify", "mla_prefill", "ssd", "flash")),
        "no_plain": not any(v["plain"] for v in launches.values()),
    }
    rec = replay_record("moe_replay", cfg, fe, eng, wall, launches, shapes,
                        timer, peak)
    rec["checks"] = checks
    emit(rec)
    if not all(checks.values()):
        raise SystemExit(f"moe replay checks failed: "
                         f"{[k for k, v in checks.items() if not v]}")
    return launches


# ----------------------------- main path ------------------------------- #
class SpanTimer:
    """Engine tracer (the duck type of the telemetry StepTracer): wall
    seconds per span name, with the device synchronised at each span's
    end so that its work is counted in its span."""

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self.count: dict[str, int] = {}

    @contextlib.contextmanager
    def span(self, name, **attrs):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            torch.cuda.synchronize()
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.perf_counter() - t0)
            self.count[name] = self.count.get(name, 0) + 1


class ShapeLog:
    """The shapes the replay gives B2 and B1, read off the engine's two
    device programs: per prefill group its (B, S) bucket, each real lane's
    live rows and pos0; per decode loop its batch bucket B, its steps and
    the longest seq_len B1 got in each step (a lane's position + 1; a lane
    advances only in the steps it emits a token, read from the loop's
    output).  Reading the small position tensors is one extra host sync
    per group and per loop."""

    def __init__(self, eng):
        self.prefill: dict[str, int] = {}      # "B/S" -> groups
        self.exact: dict[str, list] = {}       # "B/S" -> (pos0s, lives)
        self.live: list[int] = []              # live rows per real lane
        self.pos0: list[int] = []
        self.decode: dict[str, int] = {}       # "B" -> decode steps
        self.longest: dict[str, list] = {}     # "B" -> per step, B1's
                                               # longest seq_len
        prefill_forward, decode_loop = eng._prefill_forward, eng._decode_loop

        def prefill(cache, tokens, pos0, true_len, *rest):
            key = f"{tokens.shape[0]}/{tokens.shape[1]}"
            self.prefill[key] = self.prefill.get(key, 0) + 1
            self.exact.setdefault(key, []).append(
                (tuple(pos0.tolist()), tuple(true_len.tolist())))
            for p, n in zip(pos0.tolist(), true_len.tolist()):
                if n:
                    self.live.append(n)
                    self.pos0.append(p)
            return prefill_forward(cache, tokens, pos0, true_len, *rest)

        def decode(cache, tokens0, pos0, steps, eos, bt, n_steps, *rest):
            key = str(tokens0.shape[0])
            self.decode[key] = self.decode.get(key, 0) + n_steps
            pos = pos0.tolist()
            out = decode_loop(cache, tokens0, pos0, steps, eos, bt, n_steps,
                              *rest)
            longest = self.longest.setdefault(key, [])
            for row in (out != -1).T.tolist():     # step by step
                longest.append(max(pos) + 1)
                pos = [p + a for p, a in zip(pos, row)]
            return out
        eng._prefill_forward, eng._decode_loop = prefill, decode

    def summary(self) -> dict:
        def spread(v):
            v = sorted(v)
            return [v[0], v[len(v) // 2], v[-1]] if v else None
        return {"prefill_buckets": self.prefill,
                "prefill_live_rows_mean":
                    sum(self.live) / max(len(self.live), 1),
                "prefill_pos0_min_median_max": spread(self.pos0),
                "decode_batch_steps": self.decode,
                "decode_longest_seq_len_min_median_max": {
                    k: spread(v) for k, v in self.longest.items()}}


def main_step_breakdown(cfg, params, eng):
    """A decode step and a prefill group through ``model_forward`` and the
    unembedding, at the shapes the kernel phases time: the decode steps of
    the "main" B1 case (eight lanes, at position 1000 here) and of the
    replay's commonest shape (one lane over 1861 keys), and one prefill
    group of the replay's commonest shape (one lane, 8 rows, 2 live at
    position 477).  Decode steps run with chunk_len 0, so their page
    writes go to the write-off page.  CUDA events around the call (the
    host's dispatch included), and ``torch.profiler``'s device time of all
    the call's kernels and of B1's or B2's own.  The device is idle for
    the rest of the call."""
    from repro_torch.models import logits_fn, model_forward

    dev = eng.device
    width = eng.kv.max_pages_per_seq

    def shape(B, S, pos0, live):
        table = (torch.arange(B * width, device=dev, dtype=torch.int32)
                 % eng.ecfg.total_pages).reshape(B, width)
        return (torch.ones(B, S, dtype=torch.long, device=dev),
                torch.full((B,), pos0, dtype=torch.int32, device=dev),
                torch.full((B,), live, dtype=torch.int32, device=dev), table)
    (_, dB, *_, (d_len,), _), = [
        cs for cs in DECODE_CASES if cs[0] == "replay"]
    (_, pB, pS, *_, (p_pos0,), (p_live,), _), = [
        cs for cs in PREFILL_CASES if cs[0] == "replay"]
    out = {}
    with torch.no_grad():
        for name, (tok, pos0, clen, table), kernel in (
                ("decode_B8_pos1000", shape(8, 1, 1000, 0),
                 "paged_decode_attention"),
                (f"decode_B{dB}_pos{d_len - 1}", shape(dB, 1, d_len - 1, 0),
                 "paged_decode_attention"),
                (f"prefill_B{pB}_S{pS}_live{p_live}_pos{p_pos0}",
                 shape(pB, pS, p_pos0, p_live), "paged_prefill_attention")):
            def call():
                hid, _, _ = model_forward(params, cfg, tok, cache=eng.kv.pools,
                                          pos0=pos0, block_tables=table,
                                          chunk_len=clen)
                return logits_fn(params, cfg, hid[:, -1])
            call_ms = time_ms(call)
            reading = cuda_profile(call, n=1, flush=False)
            total, ops = cuda_sum(reading)
            out[name] = {"call_ms": call_ms, "device_ms": total,
                         "device_ops": ops,
                         "kernel_device_ms": cuda_sum(
                             reading, KERNEL_NAMES[kernel])[0],
                         "device_idle_share": (None if total is None
                                               else 1 - total / call_ms)}
    return out


# The main path's depth: smollm-135m's 30 layers cut to 3 (6 until the
# VLM and the examples joined the script), which the cluster and
# dense-cache phases inherit, so that the script keeps within its time
# limit on a slow host (each host-bound step's time grows with
# the layers; the planner's virtual clock and the page counts, not the
# depth, set the schedule, so the shapes are the uncut replay's).
MAIN_LAYERS = 3


def main_path(pa, pp, fa, seed: int):
    from repro_torch.launch import serve
    args = serve.parse_args(["--time-scale", "1.0", "--max-requests", "16",
                             "--duration", "10", "--seed", str(seed),
                             "--layers", str(MAIN_LAYERS)])
    fe, eng = serve.build(args)
    timer = SpanTimer()
    eng.tracer = timer
    shapes = ShapeLog(eng)
    torch.cuda.reset_peak_memory_stats()
    for c in (pa.COUNTS, pp.COUNTS, fa.COUNTS):
        c["kernel"] = c["plain"] = 0
    wall = serve.replay(fe)
    launches = {"decode": dict(pa.COUNTS), "prefill": dict(pp.COUNTS),
                "flash": dict(fa.COUNTS)}
    s, c = fe.stats, eng.counters
    L = eng.cfg.n_layers
    # the replay ran the shapes the kernel phases timed as "replay"
    (_, pB, pS, *_), = [cs for cs in PREFILL_CASES if cs[0] == "replay"]
    (_, dB, *_), = [cs for cs in DECODE_CASES if cs[0] == "replay"]
    checks = {
        "served_all": s.served == s.submitted == 16,
        "timed_prefill_bucket_ran": f"{pB}/{pS}" in shapes.prefill,
        "timed_decode_batch_ran": str(dB) in shapes.decode,
        "tokens_out": s.tokens_out > 0,
        "decode_launches":
            launches["decode"]["kernel"] == L * c["decode_steps"],
        "prefill_launches":
            launches["prefill"]["kernel"] == L * c["prefill_calls"],
        "no_flash_kernel": launches["flash"]["kernel"] == 0,
        "no_plain": not any(v["plain"] for v in launches.values()),
    }
    emit({"phase": "main_path", "model": eng.cfg.name,
          "layers": L, "submitted": s.submitted, "served": s.served,
          "attained": s.attained, "dropped": s.dropped,
          "tokens_out": s.tokens_out, "prefill_calls": c["prefill_calls"],
          "decode_calls": c["decode_calls"], "decode_steps": c["decode_steps"],
          "decode_tokens": c["decode_tokens"], "launches": launches,
          "shapes": shapes.summary(),
          "step_breakdown": main_step_breakdown(eng.cfg, eng.params, eng),
          "wall_s": wall, "span_s": timer.seconds, "spans": timer.count,
          "outside_spans_s": wall - sum(timer.seconds.values()),
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "checks": checks})
    if not all(checks.values()):
        raise SystemExit(f"main path checks failed: {checks}")
    return launches, eng.cfg, eng.params


# ---------------------------- cluster phase ---------------------------- #
# Two replicas of full-width smollm-135m on the one card, sharing one page
# budget below the sum of their pools, so that a burst overflows one
# replica's fair share.  Requests at chatbot prompt lengths (outputs cut
# to 32 tokens, so that plain generation can check every stream); the
# ``shared`` rids open with one 512-token system prompt.  Wave 1 (12)
# arrives at t = 0; wave 2 (the 4 longest, guaranteed) once best-effort KV
# is resident, which makes admission preempt it; replica 1 drains once
# its wave-1 requests have finished, spilling its chains into replica 0's
# host tier; wave 3 re-sends the ``resend`` prompts of which replica 0
# then holds the most pages there, served by prefetch.  At 320 pages a
# replica over 512 this traffic routes, demotes and preempts nothing
# (``scripts/rehearse_cluster_phase.py`` runs this phase's control flow on
# the CPU, where it is the same: it depends on page counts and the
# virtual clock only); 256 over 384 does all.
CLUSTER = dict(replicas=2, total_pages=384, replica_pages=256, page=16,
               max_slots=8, max_len=4096, host_spill_pages=64, requests=16,
               first_wave=12, output=32, system_prompt=512,
               shared=(0, 2, 4, 6, 12, 13, 14, 15),
               resend=2, ttft_slowdown=8.0, tpot=0.15, max_steps=3000)


def cluster_traffic(vocab: int, seed: int):
    """{rid: prompt} of the requests: lengths from the chatbot trace's
    prompt distribution (``core/workload.py``, mean 763) by a numpy seed,
    the longest ones in the second wave; ``CLUSTER["shared"]`` rids open
    with the shared system prompt (and are at least one page longer)."""
    import numpy as np
    from repro_torch.core.workload import TABLE4

    rng = np.random.default_rng(seed)
    n, w1, sp = CLUSTER["requests"], CLUSTER["first_wave"], \
        CLUSTER["system_prompt"]
    lens = [int(x) for x in TABLE4["chatbot"]["prompt"].sample(rng, n)]
    order = sorted(range(n), key=lambda i: lens[i])
    lens = [lens[i] for i in order[:w1]] + [lens[i] for i in order[w1:]]
    rng.shuffle(lens[:w1])
    system = rng.integers(1, vocab, sp).tolist()
    out = {}
    for rid, L in enumerate(lens):
        if rid in CLUSTER["shared"]:
            L = max(L, sp + CLUSTER["page"])
            out[rid] = system + rng.integers(1, vocab, L - sp).tolist()
        else:
            out[rid] = rng.integers(1, vocab, L).tolist()
    return out


class KVCopyLog:
    """The spill tier's device copies on every replica's manager: CUDA
    events around each ``flush_prefetch`` that copied and each
    ``_page_to_host`` (the host's staging between the events included),
    and the bytes of each published page copied to the host (a spill, or a
    drain's export to the survivor), read on the card just before the
    copy, held bit for bit against the page the same chain lands on when
    its prefetch is flushed (chain hashes are the same on every
    replica)."""

    def __init__(self, drivers):
        self.events = {"flush_prefetch": [], "page_to_host": []}
        self.snaps: dict[int, list] = {}
        self.compared = self.equal = 0
        for d in drivers:
            self._wrap(d.engine.kv)

    @staticmethod
    def _leaves(kv, p):
        # whole pages, concatenated over a mesh's shards
        return [leaf for page in kv.page_view(p) if page is not None
                for leaf in page.values()]

    def _timed(self, key, fn, *a):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn(*a)
        e1.record()
        self.events[key].append((e0, e1))
        return out

    def _wrap(self, kv):
        flush, to_host = kv.flush_prefetch, kv._page_to_host

        def spy_to_host(p):
            # a spill or an export reads a published page: its chain's
            # bytes, which every later prefetch of the chain must restore
            key = kv.page_key.get(p)
            if key is not None and key not in self.snaps:
                self.snaps[key] = [x.clone() for x in self._leaves(kv, p)]
            return self._timed("page_to_host", to_host, p)

        def spy_flush():
            pend = [q for q, _ in kv._pending_prefetch]
            if not pend:
                return flush()
            n = self._timed("flush_prefetch", flush)
            for q in pend:
                snap = self.snaps.get(kv.page_key.get(q))
                if snap is not None:
                    self.compared += 1
                    self.equal += all(torch.equal(a, b) for a, b in
                                      zip(self._leaves(kv, q), snap))
            return n

        kv.flush_prefetch = spy_flush
        kv._page_to_host = spy_to_host

    def summary(self) -> dict:
        torch.cuda.synchronize()
        return {key: {"calls": len(v),
                      "ms": sum(a.elapsed_time(b) for a, b in v)}
                for key, v in self.events.items()}


def cluster_phase(cfg, params, kernels, seed: int):
    """The §4.2 cluster on the card: ``ClusterFrontend.build`` with two
    replicas of ``cfg`` sharing ``params`` (not copied), one shared page
    budget, the host spill tier on and ``ClusterTelemetry`` enabled;
    routing, best-effort demotion, preemption, prefix affinity, spill and
    prefetch, and a drain that migrates and spills to the survivor.
    Launch counts zeroed just before the traffic and read just after."""
    from repro_torch.core.perf_model import cpu_scale_perf_model
    from repro_torch.core.request import simple_request
    from repro_torch.core.router import RoutingPolicy
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.serving.cluster import ClusterFrontend
    from repro_torch.telemetry import ClusterTelemetry, parse_prometheus

    dev = torch.device("cuda")
    c = CLUSTER
    torch.cuda.reset_peak_memory_stats()
    tel = ClusterTelemetry(enabled=True)
    cl = ClusterFrontend.build(
        cfg, params, c["replicas"], cpu_scale_perf_model(),
        sched_cfg=SchedulerConfig(page_size=c["page"],
                                  prefill_emits_first_token=True),
        policy=RoutingPolicy(max_hops=1), total_pages=c["total_pages"],
        replica_pages=c["replica_pages"], page_size=c["page"],
        max_slots=c["max_slots"], max_len=c["max_len"], seed=seed,
        host_spill_pages=c["host_spill_pages"], telemetry=tel, device=dev)
    drivers = list(cl.drivers)          # every replica that ever lived
    copies = KVCopyLog(drivers)
    traffic = cluster_traffic(cfg.vocab, seed)
    reqs, got, hits, where = {}, {}, set(), {}

    def submit(rid, t):
        reqs[rid] = simple_request(rid, t, prompt=len(traffic[rid]),
                                   output=c["output"],
                                   ttft_slowdown=c["ttft_slowdown"],
                                   tpot=c["tpot"])
        cl.submit(reqs[rid], prompt=traffic[rid],
                  on_token=lambda r, toks: got.setdefault(r, []).extend(toks))

    for d in drivers:
        enqueue = d.enqueue             # the replica a request was routed to

        def spy_enqueue(req, *a, _d=d, _enqueue=enqueue, **k):
            where[req.rid] = _d.idx
            return _enqueue(req, *a, **k)
        d.enqueue = spy_enqueue
        share = d.engine.kv._share_pages  # requests served via the host tier

        def spy_share(rid, tokens, _kv=d.engine.kv, _share=share):
            n = _kv.prefetched_pages
            out = _share(rid, tokens)
            if _kv.prefetched_pages > n:
                hits.add(rid)
            return out
        d.engine.kv._share_pages = spy_share

    conserved = []

    def step():
        cl.step()
        conserved.append(cl.budget.used == sum(
            d.engine.kv.used_pages for d in cl.drivers))

    for mod in kernels.values():
        mod.COUNTS["kernel"] = mod.COUNTS["plain"] = 0
    t0 = time.perf_counter()
    for rid in range(c["first_wave"]):
        submit(rid, 0.0)
    steps = 0
    while steps < c["max_steps"] and not cl.idle and not any(
            e.req.kv_resident for d in cl.drivers for e in d.be.entries):
        step()
        steps += 1
    wave2_at = cl.clock
    for rid in range(c["first_wave"], c["requests"]):
        submit(rid, cl.clock)
    drained, migrated, resent = None, [], {}
    served_by_1 = set()
    while steps < c["max_steps"] and (not cl.idle or cl.draining
                                      or (drained is not None
                                          and not resent)):
        step()
        steps += 1
        served_by_1.update(r for r, i in where.items() if i == 1)
        mine = [r for r in served_by_1 if r < c["first_wave"]]
        if drained is None and mine and all(reqs[r].finished for r in mine):
            migrated = [e.req.rid for e in cl.drivers[1].be.entries]
            drained = cl.clock
            cl.drain_replica(1)
        elif drained is not None and not resent and not cl.draining:
            # wave 3: the survivor holds replica 1's chains in its host
            # tier; re-send the prompts with the most pages there
            kv = cl.drivers[0].engine.kv
            best = sorted(served_by_1, key=lambda r: (
                -kv.prefix_discounts(traffic[r])[2], r))[:c["resend"]]
            for k, r in enumerate(best):
                resent[c["requests"] + k] = r
                traffic[c["requests"] + k] = traffic[r]
                submit(c["requests"] + k, cl.clock)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: dict(mod.COUNTS) for name, mod in kernels.items()}
    stats = cl.stats
    spans: dict[str, float] = {}
    for r in tel.tracer.records("span"):
        spans[r["name"]] = spans.get(r["name"], 0.0) + r["dur"]
    counters = {k: sum(d.engine.counters[k] for d in drivers)
                for k in ("prefill_calls", "decode_calls", "decode_steps",
                          "decode_tokens", "preemptions")}
    kvs = [d.engine.kv for d in drivers]
    peak = torch.cuda.max_memory_allocated() / 2**30
    parsed = parse_prometheus(tel.prometheus())

    def registry(event):
        return sum(v for (name, labels), v in parsed.items()
                   if name == "repro_engine_events_total"
                   and ("event", event) in labels)

    def routing(outcome):
        return parsed.get(("repro_routing_total", (("outcome", outcome),)),
                          0)
    tel_match = {
        "routed": routing("routed") == stats.routed,
        "affinity_routed": routing("affinity") == stats.affinity_routed,
        "best_effort": routing("best_effort") == stats.best_effort,
        "dropped": routing("dropped") == stats.dropped,
        "preempted": registry("preemptions") == stats.preempted,
        "prefix_hit_tokens":
            registry("prefix_hit_tokens") == stats.prefix_hit_tokens,
        **{k: registry(k) == getattr(stats, k)
           for k in ("prefix_evictions", "spilled_pages", "prefetched_pages",
                     "host_evictions", "spilled_hit_tokens")},
        "served": sum(v for (name, _), v in parsed.items()
                      if name == "repro_requests_finished_total")
        == stats.served,
    }
    L = cfg.n_layers
    other = [k for k in kernels if k not in ("decode", "prefill")]
    checks = {
        "all_terminal": cl.idle and all(r.finished for r in reqs.values()),
        "served_all": stats.served == stats.submitted
        == c["requests"] + c["resend"],
        "routed": stats.routed >= 1,
        "best_effort": stats.best_effort >= 1,
        "preempted": stats.preempted >= 1,
        "affinity_routed": stats.affinity_routed >= 1,
        "spilled_pages": stats.spilled_pages >= 1,
        "prefetched_pages": stats.prefetched_pages >= 1,
        "drained_replica_retired": drained is not None
        and [d.idx for d in cl.drivers] == [0],
        "budget_conserved_every_step": all(conserved),
        "budget_empty_at_end": cl.budget.used == 0,
        "decode_launches":
            launches["decode"]["kernel"] == L * counters["decode_steps"],
        "prefill_launches":
            launches["prefill"]["kernel"] == L * counters["prefill_calls"],
        "no_other_kernel": not any(launches[k]["kernel"] for k in other),
        "no_plain": not any(v["plain"] for v in launches.values()),
        "spilled_page_bytes_equal": copies.compared >= 1
        and copies.equal == copies.compared,
        "telemetry_equals_stats": all(tel_match.values()),
    }
    preempted = set().union(*(d.preempted_rids for d in drivers))
    streams = {}
    for rid, prompt in sorted(traffic.items()):
        want, margins = greedy_reference(params, cfg, prompt,
                                         len(got.get(rid, [])), dev)
        streams[rid] = {"prompt": len(prompt), "replica": where.get(rid),
                        **compare_stream(got.get(rid, []), want, margins)}
        streams[rid]["ok"] = (streams[rid]["ok"]
                              and len(got.get(rid, [])) == c["output"])
    checks["streams_match_plain"] = all(s["ok"] for s in streams.values())
    emit({"phase": "cluster_replay", "model": cfg.name, "layers": L,
          **{k: v for k, v in c.items() if k != "max_steps"},
          "steps": steps, "wave2_at": wave2_at, "drained_at": drained,
          "wall_s": wall, "span_s": spans,
          "stats": stats.as_dict(), "counters": counters,
          "spill_pages": stats.spilled_pages,
          "prefetch_pages": stats.prefetched_pages,
          "prefetch_flushes": sum(kv.prefetch_flushes for kv in kvs),
          "kv_copies": copies.summary(),
          "spilled_pages_compared": copies.compared,
          "preempted_rids": sorted(preempted), "migrated_rids": migrated,
          "resent_rids": resent,
          "spill_hit_rids": sorted(hits), "launches": launches,
          "peak_mem_gib": peak, "gpu": card_line(),
          "telemetry_vs_stats": tel_match, "streams": streams,
          "checks": checks})
    if not all(checks.values()):
        raise SystemExit(f"cluster checks failed: {checks}")
    return launches


# ---------------------------- gateway phase ---------------------------- #
# The serving surface on the card: phi4-mini-3.8b at its published width
# and depth (random weights from the seed, float32, about 15.3 GB), two
# replicas sharing one parameter copy behind the HTTP/SSE gateway,
# built by the launcher's own ``http_gateway`` (page 16, 256 pages a
# replica over 512, max_len 1024, 8 slots).  The traffic is the paper's
# six-scenario mix (``core/trace.py``): 18 entries at 4/s over 4 s, stage
# lengths scaled by 0.25 and capped at 128, token ids over the model's
# whole vocabulary; 2612 prefill and 1272 decode tokens, at most 532 in
# one request (a tool loop of six stages).
# phi4-mini's 32 layers cut to 2 (its widths unchanged; 4 until the VLM
# and the examples joined the script): the launcher
# sizes each replica's pools to 1 GiB over the cut model's bytes a page,
# which its 8 slots of 1024 tokens cap at 512 pages.
GATEWAY = dict(arch="phi4-mini-3.8b", layers=2, replicas=2, rate=4.0,
               duration=4.0, time_scale=0.25, max_stage_tokens=128,
               entries=18, page=16, replica_pages=512, total_pages=1024,
               max_len=1024, max_slots=8, greedy_max_tokens=32,
               max_steps=20_000)


def gateway_model(seed: int):
    from repro_torch.configs import get_config
    from repro_torch.device import generator
    from repro_torch.models import init_params

    cfg = cut_depth(get_config(GATEWAY["arch"]), GATEWAY["layers"])
    dev = torch.device("cuda")
    return cfg, init_params(cfg, generator(dev, seed), device=dev)


class HistoryLog:
    """What each request of a cluster was sampled from: the engine's token
    history (the exact tokens its KV pages hold) at the request's finish,
    and for every emitted token the length of the history it followed (a
    prefill emission follows the whole history; a decode group's k
    tokens the history before the group plus 1..k, as the engine writes
    the group's start token and all but its last emission).  Each token
    can then be held against plain generation over that history, tool
    contexts included."""

    def __init__(self, cluster):
        self.cluster = cluster
        self.history: dict[int, list] = {}
        self.prefix: dict[int, list] = {}
        self.tokens: dict[int, list] = {}
        for d in cluster.drivers:
            self._wrap(d.engine)

    def _wrap(self, eng):
        finish = eng.finish

        def spy(rid, *a, **k):
            ctx = eng.reqs.get(rid)
            if ctx is not None:
                self.history[rid] = list(ctx.history)
            return finish(rid, *a, **k)
        eng.finish = spy

    def on_token(self, rid, toks) -> None:
        ctx = next(d.engine.reqs[rid] for d in self.cluster.drivers
                   if rid in d.engine.reqs)
        H, k = len(ctx.history), len(toks)
        self.prefix.setdefault(rid, []).extend(H - k + 1 + i
                                               for i in range(k))
        self.tokens.setdefault(rid, []).extend(int(t) for t in toks)


def plain_over_history(params, cfg, log: HistoryLog, rid: int, dev):
    """Every token ``rid`` emitted against plain full-causal generation
    over the history the engine recorded: one forward over the history,
    the logits only at the rows that sampled.  A token may differ from the
    argmax only where the top-2 margin there is below the tie bound."""
    from repro_torch.models import logits_fn, model_forward

    if rid not in log.tokens:            # dropped before any token
        return {"tokens": 0, "history": 0, "differ": 0, "ties": 0,
                "min_top2_margin": None, "ok": True}, []
    hist, pre, toks = log.history[rid], log.prefix[rid], log.tokens[rid]
    with torch.no_grad():
        h, _, _ = model_forward(params, cfg, torch.tensor([hist], device=dev))
        rows = torch.tensor([p - 1 for p in pre], device=dev)
        lg = logits_fn(params, cfg, h[0, rows])
        top = torch.topk(lg, 2, dim=-1).values
        margins = (top[:, 0] - top[:, 1]).tolist()
        arg = torch.argmax(lg, dim=-1).tolist()
    diff = [i for i, (a, t) in enumerate(zip(arg, toks)) if a != t]
    return {"tokens": len(toks), "history": len(hist),
            "differ": len(diff), "ties": sum(margins[i] < TIE for i in diff),
            "min_top2_margin": min(margins),
            "ok": (max(pre) <= len(hist) and len(arg) == len(toks)
                   and all(margins[i] < TIE for i in diff))}, margins


def gateway_phase(cfg, params, kernels, seed: int):
    """The serving surface on the card, in two parts.  Part 1
    (conformance): every trace entry posted over real TCP to an
    ``autostep=False`` gateway, accepted, then pumped until idle; each SSE
    stream against the same trace driven in process on a fresh identical
    cluster, every stream against plain generation over its recorded
    history, the short single-stage ones also against
    ``greedy_reference``; the ``done`` events against ``ClusterStats`` and
    the telemetry registry; launch counts zeroed just before the pump.
    Part 2 (live traffic): the same entries posted open loop at their
    arrival offsets to a gateway on its own thread (``run_in_thread``),
    one client leaving after its first token, replica 1 drained through
    ``POST /admin/drain`` mid-trace, ``GET /metrics`` parsed, and
    ``shutdown(drain=True)`` completing every accepted stream; the shared
    budget checked after every step."""
    import asyncio
    import numpy as np
    from repro_torch.core.trace import generate_trace, load_trace, save_trace
    from repro_torch.launch import serve
    from repro_torch.serving.gateway import (collect_stream, http_get,
                                             http_post, open_sse,
                                             request_from_payload,
                                             run_in_thread, sse_events)
    from repro_torch.telemetry import parse_prometheus

    g = GATEWAY
    dev = torch.device("cuda")
    L = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    entries = generate_trace(g["rate"], g["duration"], seed=seed,
                             time_scale=g["time_scale"],
                             max_stage_tokens=g["max_stage_tokens"],
                             vocab=cfg.vocab)
    path = Path(__file__).resolve().parent / "build" / "gateway_trace.jsonl"
    path.parent.mkdir(parents=True, exist_ok=True)
    save_trace(entries, str(path))
    loaded = load_trace(str(path))
    decode_of = {e.rid: sum(n for k, n, _ in e.stages if k == "decode")
                 for e in loaded}
    trace_info = {
        "entries": len(loaded), "scenarios": sorted({e.scenario
                                                     for e in loaded}),
        "prefill_tokens": sum(n for e in loaded for k, n, _ in e.stages
                              if k == "prefill"),
        "decode_tokens": sum(decode_of.values()),
        "max_request_tokens": max(e.total_tokens() for e in loaded),
        "max_stages": max(len(e.stages) for e in loaded),
        "vocab": cfg.vocab, "file_bytes": path.stat().st_size}

    def gateway(autostep):
        gw = serve.http_gateway(cfg, params, g["replicas"], reduced=False,
                                device=dev, autostep=autostep, seed=seed)
        return gw, gw.cluster

    def sizes(cl):
        e = cl.drivers[0].engine
        return {"page": e.ecfg.page_size, "replica_pages": e.kv.total_pages,
                "total_pages": cl.budget.total_pages,
                "max_len": e.ecfg.max_len, "max_slots": e.ecfg.max_slots,
                "params_shared": all(d.engine.params is params
                                     for d in cl.drivers)}

    # ---- part 1: conformance over real TCP, then in process ---------- #
    gw, cl = gateway(autostep=False)
    shape = sizes(cl)
    log = HistoryLog(cl)
    relay = gw._on_token

    def spy_token(rid, toks):
        log.on_token(rid, toks)
        relay(rid, toks)
    gw._on_token = spy_token

    async def conformance():
        await gw.start()
        try:
            tasks = [asyncio.create_task(collect_stream(
                gw.host, gw.port, e.to_payload())) for e in loaded]
            for _ in range(3000):
                if gw.stats.accepted >= len(loaded):
                    break
                await asyncio.sleep(0.01)
            for mod in kernels.values():
                mod.COUNTS["kernel"] = mod.COUNTS["plain"] = 0
            t0 = time.perf_counter()
            steps = await gw.pump_until_idle(max_steps=g["max_steps"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {name: dict(mod.COUNTS)
                        for name, mod in kernels.items()}
            return await asyncio.gather(*tasks), steps, wall, launches
        finally:
            await gw.shutdown(drain=True)

    results, steps1, wall1, launches1 = asyncio.run(conformance())
    counters1 = {k: sum(d.engine.counters[k] for d in cl.drivers)
                 for k in ("prefill_calls", "decode_calls", "decode_steps",
                           "decode_tokens", "preemptions")}
    stats1 = cl.stats
    parsed = parse_prometheus(cl.telemetry.prometheus())
    finished = {a: sum(v for (name, labels), v in parsed.items()
                       if name == "repro_requests_finished_total"
                       and ("attained", a) in labels)
                for a in ("true", "false")}
    entry_of = {r["rid"]: e for r, e in zip(results, loaded)}
    sse = {r["rid"]: r for r in results}

    # the same trace in process on a fresh identical cluster
    _, ref = gateway(autostep=True)
    ref_log = HistoryLog(ref)
    ref_streams: dict[int, list] = {}

    def ref_token(rid, toks):
        ref_log.on_token(rid, toks)
        ref_streams.setdefault(rid, []).extend(int(t) for t in toks)
    for rid in sorted(entry_of):
        req, prompt = request_from_payload(entry_of[rid].to_payload(), rid,
                                           0.0)
        ref.submit(req, prompt=prompt, on_token=ref_token)
    t0 = time.perf_counter()
    ref.run_until_idle(max_steps=g["max_steps"])
    torch.cuda.synchronize()
    wall_ref = time.perf_counter() - t0

    # every stream against plain generation over its history; the SSE
    # stream against the in-process one under the tie rule
    streams, min_margin = {}, None
    for rid in sorted(sse):
        got = sse[rid]["tokens"]
        plain, margins = plain_over_history(params, cfg, log, rid, dev)
        want = ref_streams.get(rid, [])
        first = next((i for i, (a, b) in enumerate(zip(got, want))
                      if a != b), None)
        if first is None and len(got) != len(want):
            first = min(len(got), len(want))
        tie = (first is not None and first < len(margins)
               and margins[first] < TIE)
        rec = {"scenario": entry_of[rid].scenario,
               "stages": len(entry_of[rid].stages), "plain": plain,
               "equal_inprocess": first is None, "first_difference": first,
               "tie": tie, "ok": plain["ok"] and (first is None or tie)
               and (sse[rid]["done"]["dropped"]
                    or len(got) == decode_of[entry_of[rid].rid])}
        if first is not None and not tie:
            rec["history_equal"] = log.history.get(rid) == \
                ref_log.history.get(rid)
        if plain["min_top2_margin"] is not None:
            min_margin = min(m for m in (min_margin, plain["min_top2_margin"])
                             if m is not None)
        streams[rid] = rec
    greedy = {}
    for rid in sorted(sse):
        e = entry_of[rid]
        got = sse[rid]["tokens"]
        if len(e.stages) == 2 and 0 < len(got) <= g["greedy_max_tokens"]:
            want, margins = greedy_reference(params, cfg, list(e.prompt),
                                             len(got), dev)
            greedy[rid] = {"scenario": e.scenario,
                           **compare_stream(got, want, margins)}
            min_margin = min(min_margin, greedy[rid]["min_top2_margin"])
    done = [r["done"] for r in results]
    kernel_checks1 = {
        "decode_launches":
            launches1["decode"]["kernel"] == L * counters1["decode_steps"],
        "prefill_launches":
            launches1["prefill"]["kernel"] == L * counters1["prefill_calls"],
        "no_other_kernel": not any(
            launches1[k]["kernel"] for k in launches1
            if k not in ("decode", "prefill")),
        "no_plain": not any(v["plain"] for v in launches1.values()),
    }
    part1 = {"wall_s": wall1, "inprocess_wall_s": wall_ref,
             "steps": steps1, **counters1, "launches": launches1,
             "stats": stats1.as_dict(), "finished_registry": finished,
             "streams": streams, "greedy": greedy,
             "streams_compared_plain": len(streams) + len(greedy),
             "min_top2_margin": min_margin}
    del gw, cl, ref, log, ref_log
    free_device_memory()

    # ---- part 2: live open-loop traffic on the gateway's own thread --- #
    gw2, cl2 = gateway(autostep=True)
    drivers2 = list(cl2.drivers)
    conserved = []
    step = cl2.step

    def checked_step(*a, **k):
        n = step(*a, **k)
        conserved.append(cl2.budget.used == sum(
            d.engine.kv.used_pages for d in cl2.drivers))
        return n
    cl2.step = checked_step
    leaver = max(loaded, key=lambda e: (decode_of[e.rid], -e.rid))
    drain_after = len(loaded) // 2
    handle = run_in_thread(cl2, seed=seed)
    host, port = handle.host, handle.port
    clients: dict[int, dict] = {}

    async def client(e, t_post):
        rec = {"entry": e.rid, "post": t_post, "times": [], "tokens": 0,
               "done": None, "rid": None}
        reader, writer = await open_sse(host, port, e.to_payload())
        try:
            async for ev, data in sse_events(reader):
                now = time.perf_counter()
                if ev == "start":
                    rec["rid"] = data["rid"]
                elif ev == "token":
                    rec["times"].append(now)
                    rec["tokens"] += len(data["tokens"])
                    if e is leaver:
                        break            # walk away after the first token
                elif ev == "done":
                    rec["done"] = data
                    break
        finally:
            writer.close()
        clients[e.rid] = rec

    async def live():
        loop = asyncio.get_running_loop()
        t0 = time.perf_counter()
        tasks, drain, metrics = [], None, None
        for i, e in enumerate(loaded):
            await asyncio.sleep(max(0.0, t0 + e.arrival
                                    - time.perf_counter()))
            tasks.append(asyncio.create_task(client(e, time.perf_counter())))
            if i == drain_after:
                drain = await http_post(host, port, "/admin/drain",
                                        {"replica": 1})
        for _ in range(6000):
            if handle.gateway.stats.accepted >= len(loaded):
                break
            await asyncio.sleep(0.01)
        metrics = await http_get(host, port, "/metrics")
        accepted = handle.gateway.stats.accepted
        await loop.run_in_executor(None, handle.shutdown, True, 1200.0)
        await asyncio.gather(*tasks)
        return time.perf_counter() - t0, drain, metrics, accepted

    wall2, drain, metrics, accepted2 = asyncio.run(live())
    for _ in range(100):                # retire the drained replica
        if not cl2.draining:
            break
        cl2.step()
    torch.cuda.synchronize()
    stats2 = cl2.stats
    gws = handle.gateway.stats
    left = clients[leaver.rid]["rid"]
    parsed2 = parse_prometheus(metrics[1]) if metrics[0] == 200 else {}
    ttft = [c["times"][0] - c["post"] for c in clients.values()
            if c["times"]]
    tpot = [(c["times"][-1] - c["times"][0]) / (c["tokens"] - 1)
            for c in clients.values()
            if c["done"] is not None and len(c["times"]) >= 2
            and c["tokens"] >= 2]
    completed = [c for e, c in clients.items() if e != leaver.rid]
    part2 = {"wall_s": wall2, "accepted": accepted2,
             "completed": gws.completed, "disconnected": gws.disconnected,
             "left_rid": left, "drain_response": drain,
             "steps_checked": len(conserved), "stats": stats2.as_dict(),
             "replicas_left": [d.idx for d in cl2.drivers],
             "metrics_series": sorted({name for name, _ in parsed2}),
             "ttft_wall_s": statistics.median(ttft) if ttft else None,
             "tpot_wall_s": statistics.median(tpot) if tpot else None}
    checks = {
        "model_full_width": (L, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                             cfg.head_dim, cfg.vocab)
        == (g["layers"], 3072, 24, 8, 128, 200064),
        "cluster_shape": shape == {
            "page": g["page"], "replica_pages": g["replica_pages"],
            "total_pages": g["total_pages"], "max_len": g["max_len"],
            "max_slots": g["max_slots"], "params_shared": True},
        "trace_roundtrip": loaded == entries and len(loaded)
        == g["entries"] and len(trace_info["scenarios"]) == 6,
        "all_accepted": len(results) == len(loaded)
        and all(r["done"] is not None for r in results),
        "streams_match_inprocess_or_tie": all(s["ok"]
                                              for s in streams.values()),
        "streams_match_plain": all(s["plain"]["ok"]
                                   for s in streams.values())
        and all(s["ok"] for s in greedy.values()),
        "greedy_streams": len(greedy) >= 3,
        "multi_stage_toolllm_held": any(
            s["scenario"] == "toolllm" and s["stages"] > 2 and s["plain"]["ok"]
            for s in streams.values()),
        "done_attained_equals_stats":
            sum(d["attained"] for d in done) == stats1.attained
            == finished["true"],
        "done_dropped_equals_stats":
            sum(d["dropped"] for d in done) == stats1.dropped,
        "done_count_equals_served": len(done) == stats1.served
        == finished["true"] + finished["false"],
        **kernel_checks1,
        "live_all_accepted": accepted2 == len(loaded),
        "live_disconnect_cancelled": gws.disconnected == 1
        and stats2.cancelled == 1
        and all(left not in d.engine.reqs and left not in d.engine.kv.tables
                for d in drivers2),
        "live_budget_conserved_every_step": bool(conserved) and all(conserved)
        and cl2.budget.used == 0,
        "live_drain_completed": drain is not None and drain[0] == 200
        and [d.idx for d in cl2.drivers] == [0],
        "live_metrics_parse": metrics[0] == 200
        and "repro_step_series" in part2["metrics_series"],
        "live_every_stream_done": gws.completed == accepted2 - 1
        and all(c["done"] is not None for c in completed),
        "live_tokens": all(c["done"]["dropped"]
                           or c["tokens"] == decode_of[e]
                           for e, c in clients.items() if e != leaver.rid),
    }
    emit({"phase": "gateway_replay", "model": cfg.name, "layers": L,
          "replicas": g["replicas"], **shape, "trace": trace_info,
          "part1": part1, "part2": part2,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "gpu": card_line(), "checks": checks})
    if not all(checks.values()):
        raise SystemExit(f"gateway checks failed: "
                         f"{[k for k, v in checks.items() if not v]}")
    return part1["launches"]


# -------------------------- dense-cache phase --------------------------- #
DENSE_CACHE = dict(prompt=48, new=32, max_len=128)


def dense_cache_phase(cfg, params, kernels, seed: int):
    """Greedy generation of full-width smollm-135m through the dense
    fixed-buffer caches (``init_cache``: the prompt in one prefill, then
    one token a call, each written at its position and attended by the
    masked ``sdpa``) against plain full-causal generation
    (``greedy_reference``, B6) under the tie rule.  No kernel and no plain
    version may run on the dense path."""
    from repro_torch.models import init_cache, logits_fn, model_forward

    dev = torch.device("cuda")
    prompt = script_prompts(cfg, seed + 12, {1: DENSE_CACHE["prompt"]})[1]
    want, margins = greedy_reference(params, cfg, prompt,
                                     DENSE_CACHE["new"], dev)
    before = kernel_counts(kernels)
    cache = init_cache(cfg, 1, DENSE_CACHE["max_len"], device=dev)
    got, x, pos = [], torch.tensor([prompt], device=dev), 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        for _ in range(DENSE_CACHE["new"]):
            h, _, _ = model_forward(params, cfg, x, cache=cache,
                                    pos0=torch.tensor([pos], device=dev,
                                                      dtype=torch.int32))
            got.append(int(torch.argmax(logits_fn(params, cfg, h[0, -1]))))
            pos += x.shape[1]
            x = torch.tensor([[got[-1]]], device=dev)
    wall = time.perf_counter() - t0
    cmp = compare_stream(got, want, margins)
    checks = {"stream_equals_plain": cmp["ok"],
              "no_kernel_no_plain": kernel_counts(kernels) == before}
    emit({"phase": "dense_cache", "model": cfg.name, "layers": cfg.n_layers,
          **DENSE_CACHE, "stream": cmp, "wall_s": wall,
          "ms_per_token": 1e3 * wall / DENSE_CACHE["new"], "checks": checks})
    if not all(checks.values()):
        raise SystemExit(f"dense_cache checks failed: {checks}")


# ------------------------------ training -------------------------------- #
# Training takes the reference's plain branches (``model_forward(train=
# True)``: the masked ``sdpa`` or ``sdpa_chunked``, the SSM's
# ``ssd_chunked``): the hand kernels have no backward and every wrapper
# refuses an input that requires grad.  Each phase checks that neither a
# kernel nor a kernel's plain version ran.
# 200 steps: on the card the loss fell 0.141 in 120 and 0.373 in 200
# (PERF.md)
TRAIN_DENSE_ARGS = ["--arch", "smollm-135m", "--full-config", "--steps",
                    "200", "--batch", "8", "--seq-len", "1024", "--lr",
                    "3e-3"]
TRAIN_DROP = 0.25             # the margin of tests/test_training.py
LOG_EVERY = 10                # train()'s default
# one step on the card against the port on the CPU (same weights, same
# batch; float32 sums in other orders, TF32 off), and remat on against off
LOSS_RTOL, GNORM_RTOL = 1e-5, 1e-4
# mamba2-2.7b and phi3.5-moe fit one batch of the stream (``fit``).  On
# the stream itself, in 40 steps, neither loss fell by more than 0.11 at
# a rate at which it did not climb, against rises of up to 0.05 from one
# step to the next (``scripts/sweep_train_schedule.py``; PERF.md): a
# batch of 2048 tokens holds a sliver of a 32k- or 50k-token
# vocabulary's transitions.  One batch trained on again falls by several
# nats in ten steps.  The rates: the largest at which the stream's loss
# did not climb (phi3.5-moe's climbed at 1e-3, 2e-3 and 3e-3 with a
# warmup of 10; mamba2's jumped by up to 1.3 at 3e-3).
FIT_DROP = 5.0
# mamba2-2.7b at its published widths, 64 layers cut to 16 (this script's
# time limit bounds it; the peak stays under 60 GiB)
SSM_TRAIN = dict(layers=16, batch=4, seq_len=512, steps=10, lr=1e-3,
                 warmup=2)
# phi3.5-moe at its published widths cut to 2 layers (1.26 B parameters a
# layer; AdamW's 16 bytes a parameter make 46 GiB with the embeddings);
# its one step against the CPU at 1 layer, 64 tokens
MOE_TRAIN = dict(layers=2, batch=4, seq_len=512, steps=10, lr=3e-4,
                 warmup=2, cpu_layers=1, cpu_seq_len=64)


def kernel_counts(kernels) -> dict:
    return {k: dict(m.COUNTS) for k, m in kernels.items()}


def cut_depth(cfg, n: int):
    return dataclasses.replace(cfg, n_layers=n,
                               block_pattern=cfg.block_pattern[:n])


def rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def grad_reading(cfg, params, batch) -> dict:
    """One step's loss, MoE aux loss and gradient norm (no update)."""
    from repro_torch.training import optimizer, train_loop
    loss, parts, grads = train_loop.loss_and_grads(params, cfg, batch)
    return {"loss": float(loss), "aux": float(parts["aux"]),
            "grad_norm": float(optimizer.global_norm(grads))}


def markov_batch(cfg, batch: int, seq_len: int, seed: int, dev) -> dict:
    from repro_torch.training.data import batches
    return {k: torch.from_numpy(v).long().to(dev) for k, v in
            next(batches(cfg.vocab, batch, seq_len, seed)).items()}


def remat_readings(cfg, params, batch) -> dict:
    """``grad_reading`` with remat off and on, and their relative
    differences."""
    off, on = (grad_reading(dataclasses.replace(cfg, remat=r), params, batch)
               for r in (False, True))
    return {"off": off, "on": on, "loss_rel": rel(on["loss"], off["loss"]),
            "grad_norm_rel": rel(on["grad_norm"], off["grad_norm"])}


def card_vs_cpu(cfg, seed: int, batch: int, seq_len: int,
                remats=(False,)) -> dict:
    """One step's loss and gradient norm on the CPU, and on the card for
    each remat setting, each against the CPU's: the same seeded weights
    (drawn on the card, copied to the CPU, where drawing a billion takes
    tens of seconds) and the same Markov batch.  The CPU runs once,
    without remat (the CPU tests hold remat on and off equal there)."""
    from repro_torch.device import generator
    from repro_torch.models import init_params
    from repro_torch.training.train_loop import trainable
    from repro_torch.training.tree import tree_map

    cpu, dev = torch.device("cpu"), torch.device("cuda")
    card = trainable(init_params(cfg, generator(dev, seed), device=dev))
    params = trainable(tree_map(lambda t: t.detach().to(cpu), card))
    b = markov_batch(cfg, batch, seq_len, seed, cpu)
    bd = {k: v.to(dev) for k, v in b.items()}
    t0 = time.perf_counter()
    on_cpu = grad_reading(cfg, params, b)
    out = {"layers": cfg.n_layers, "batch": batch, "seq_len": seq_len,
           "cpu": on_cpu, "cpu_s": time.perf_counter() - t0}
    for remat in remats:
        on_card = grad_reading(dataclasses.replace(cfg, remat=remat), card,
                               bd)
        out[f"card_remat_{remat}"] = {
            **on_card, "loss_rel": rel(on_card["loss"], on_cpu["loss"]),
            "grad_norm_rel": rel(on_card["grad_norm"], on_cpu["grad_norm"])}
    return out


def agree(name: str, r: dict) -> dict:
    return {f"{name}_loss": r["loss_rel"] <= LOSS_RTOL,
            f"{name}_grad_norm": r["grad_norm_rel"] <= GNORM_RTOL}


def train_run(phase: str, cfg, res, batch: int, seq_len: int, peak: float,
              before: dict, after: dict, drop: float,
              log_every: int = LOG_EVERY):
    """The phase's record and checks of a training run: steady step time
    from the second logged step to the last (reading a logged loss waits
    for the device to finish that step), tokens per second, peak memory;
    every loss finite, the last logged below the first by ``drop``, no
    kernel and no plain version launched."""
    step_s = ((res.logged_at[-1] - res.logged_at[1])
              / (res.steps - 1 - log_every))
    rec = {"phase": phase, "model": cfg.name, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab, "batch": batch,
           "seq_len": seq_len, "steps": res.steps, "losses": res.losses,
           "wall_s": res.wallclock, "step_ms": 1e3 * step_s,
           "tokens_per_s": batch * seq_len / step_s, "peak_mem_gib": peak,
           "launches_before": before, "launches_after": after}
    checks = {"losses_finite": all(math.isfinite(x) for x in res.losses),
              "loss_falls": res.losses[-1] < res.losses[0] - drop,
              "no_kernel_no_plain": before == after}
    return rec, checks


def finish(rec: dict, checks: dict, card: str) -> None:
    rec.update({"gpu": card, "checks": checks})
    emit(rec)
    if not all(checks.values()):
        raise SystemExit(f"{rec['phase']} checks failed: "
                         f"{[k for k, v in checks.items() if not v]}")


def fit(cfg, spec: dict, seed: int):
    """``spec["steps"]`` AdamW steps of ``make_train_step`` (``train``'s
    step) on the card, each on the Markov stream's first batch at the
    seed, fresh seeded weights, every step's loss read.  Returns
    (TrainResult, peak GiB)."""
    from repro_torch.device import generator
    from repro_torch.models import init_params
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_loop import (TrainResult,
                                                 make_train_step, trainable)
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    params = trainable(init_params(cfg, generator(dev, seed), device=dev))
    state = init_opt_state(params)
    step = make_train_step(cfg, AdamWConfig(
        lr=spec["lr"], total_steps=spec["steps"],
        warmup_steps=spec["warmup"]))
    b = markov_batch(cfg, spec["batch"], spec["seq_len"], seed, dev)
    losses, at = [], []
    t0 = time.perf_counter()
    for _ in range(spec["steps"]):
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))
        at.append(time.perf_counter() - t0)
    res = TrainResult(losses=losses, steps=spec["steps"], wallclock=at[-1],
                      logged_at=at)
    return res, torch.cuda.max_memory_allocated() / 2**30


def train_dense_phase(kernels, card: str, seed: int):
    """smollm-135m at its published width and depth trained through the
    launcher (``launch.train.main``: the Markov stream from the seed,
    AdamW at lr 3e-3), then one step (2 x 256) against the port on the CPU
    with remat off and on, and remat on against off on the card."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train

    cfg = get_config("smollm-135m")
    args = TRAIN_DENSE_ARGS + ["--seed", str(seed), "--device", "cuda"]
    batch, seq_len = (int(args[args.index(k) + 1])
                      for k in ("--batch", "--seq-len"))
    before = kernel_counts(kernels)
    torch.cuda.reset_peak_memory_stats()
    res = launch_train.main(args)
    peak = torch.cuda.max_memory_allocated() / 2**30
    free_device_memory()
    cmp = card_vs_cpu(cfg, seed, 2, 256, (False, True))
    off, on = cmp["card_remat_False"], cmp["card_remat_True"]
    cmp["card_remat_on_off"] = {
        "loss_rel": rel(on["loss"], off["loss"]),
        "grad_norm_rel": rel(on["grad_norm"], off["grad_norm"])}
    rec, checks = train_run("train_dense", cfg, res, batch, seq_len, peak,
                            before, kernel_counts(kernels), TRAIN_DROP)
    rec.update({"lr": float(args[args.index("--lr") + 1]),
                "card_vs_cpu": cmp})
    checks.update({
        "model_published": (cfg.n_layers, cfg.d_model, cfg.n_heads,
                            cfg.n_kv_heads, cfg.head_dim, cfg.vocab)
        == (30, 576, 9, 3, 64, 49152),
        "steps_at_least_60": res.steps >= 60,
        **agree("card_cpu", cmp["card_remat_False"]),
        **agree("card_remat_cpu", cmp["card_remat_True"]),
        **agree("card_remat_on_off", cmp["card_remat_on_off"])})
    finish(rec, checks, card)


def train_ssm_phase(kernels, card: str, seed: int):
    """mamba2-2.7b (d 2560, 80 heads of 64, state 128) cut in depth to
    ``SSM_TRAIN["layers"]``: one step (1 x 256, two chunks of 128) at 2
    layers against the port on the CPU; then it fits one batch on the
    card (``fit``)."""
    from repro_torch.configs import get_config

    full = get_config(SSM_ARCH)
    cfg = cut_depth(full, SSM_TRAIN["layers"])
    before = kernel_counts(kernels)
    cmp = card_vs_cpu(cut_depth(full, 2), seed, 1, 256)
    free_device_memory()
    res, peak = fit(cfg, SSM_TRAIN, seed)
    rec, checks = train_run("train_ssm", cfg, res, SSM_TRAIN["batch"],
                            SSM_TRAIN["seq_len"], peak, before,
                            kernel_counts(kernels), FIT_DROP, log_every=1)
    rec.update({"lr": SSM_TRAIN["lr"], "warmup": SSM_TRAIN["warmup"],
                "fit_one_batch": True, "card_vs_cpu": cmp})
    s = cfg.ssm
    checks.update({
        "model_published_widths": (cfg.d_model, s.expand * cfg.d_model
                                   // s.head_dim, s.head_dim, s.d_state)
        == (2560, 80, 64, 128),
        "peak_under_60_gib": peak < 60,
        **agree("card_cpu", cmp["card_remat_False"])})
    finish(rec, checks, card)


def train_moe_phase(kernels, card: str, seed: int):
    """phi3.5-moe at its published widths cut to 2 layers: one step
    (``MOE_TRAIN``'s 1 layer, 64 tokens) against the port on the CPU;
    remat on and off agree on one step's loss and gradient norm (fresh
    weights, the training batch), the load-balance loss is finite and
    above 0; then it fits one batch on the card (``fit``)."""
    from repro_torch.configs import get_config
    from repro_torch.device import generator
    from repro_torch.models import init_params
    from repro_torch.training.train_loop import trainable

    dev = torch.device("cuda")
    full = get_config(MOE_ARCH)
    cfg = cut_depth(full, MOE_TRAIN["layers"])
    before = kernel_counts(kernels)
    cmp = card_vs_cpu(cut_depth(full, MOE_TRAIN["cpu_layers"]), seed, 1,
                      MOE_TRAIN["cpu_seq_len"])
    free_device_memory()
    params = trainable(init_params(cfg, generator(dev, seed), device=dev))
    remat = remat_readings(cfg, params, markov_batch(
        cfg, MOE_TRAIN["batch"], MOE_TRAIN["seq_len"], seed, dev))
    del params
    free_device_memory()
    res, peak = fit(cfg, MOE_TRAIN, seed)
    rec, checks = train_run("train_moe", cfg, res, MOE_TRAIN["batch"],
                            MOE_TRAIN["seq_len"], peak, before,
                            kernel_counts(kernels), FIT_DROP, log_every=1)
    rec.update({"lr": MOE_TRAIN["lr"], "warmup": MOE_TRAIN["warmup"],
                "fit_one_batch": True, "remat": remat, "card_vs_cpu": cmp})
    m = cfg.moe
    checks.update({
        "model_published_widths": (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                   m.n_experts, m.top_k, m.d_ff_expert,
                                   cfg.vocab)
        == (4096, 32, 8, 16, 2, 6400, 32064),
        "aux_finite_positive": all(
            math.isfinite(r["aux"]) and r["aux"] > 0
            for r in (remat["off"], remat["on"], cmp["cpu"])),
        **agree("card_cpu", cmp["card_remat_False"]),
        **agree("remat_on_off", remat)})
    finish(rec, checks, card)


# ------------------------------ mesh replay ------------------------------ #
# Mesh-sharded serving (EngineConfig.mesh) with MESH_SHARDS shards sharing
# cuda:0: each case serves the same requests through an unsharded engine
# and then through a sharded one, on the same weights.  The prompts arrive
# in two chunks (the second from mid-page) and then decode in one burst.
MESH_SHARDS = 2
MESH_ENGINE = dict(max_slots=4, max_len=1024, page_size=16, total_pages=256)
# name, arch, layers kept (None: uncut), requests, prompt, chunks, decode
# tokens, the plan flags the case must turn on
MESH_CASES = [
    ("qwen3", "qwen3-1.7b", None, 4, 512, (263, 249), 32, ("heads", "mlp")),
    ("phi35_moe", "phi3.5-moe-42b-a6.6b", 2, 4, 160, (87, 73), 16,
     ("heads", "experts")),
    ("deepseek_v2", "deepseek-v2-236b", 2, 4, 160, (87, 73), 16,
     ("mla_heads", "experts")),
    ("mamba2", "mamba2-2.7b", 8, 4, 160, (87, 73), 16, ("ssm_lanes",)),
]
MESH_SPEC_LAYERS = 4        # qwen3-1.7b cut, with the spec phase's draft
# the 2 x 2 carve: two replicas of qwen3-1.7b cut to 4 layers, each over
# two shards of a [cuda:0] * 4 device list, the host tier on
MESH_CLUSTER = dict(layers=4, total_pages=24, replica_pages=12, page=4,
                    max_slots=8, max_len=64, spill=16, shared=12)
# the kernels at their shard shapes: B1 and B2 at qwen3-1.7b's 8 / 4
# heads of 128 a shard (its four 512-token prompts: the second chunk of
# 249 rows from 263, decode lanes past 512 keys), B3 at the spec replay's
# window with those heads, B4 at deepseek-v2's 64 of 128 heads a shard
# (the mla replay's chunk); each wrapper is handed the unsharded heads
MESH_DECODE_CASES = [
    ("qwen3_shard", 4, 8, 4, 128, 16, 64, [513, 530, 544, 520], None)]
MESH_PREFILL_CASES = [
    ("qwen3_shard", 4, 256, 8, 4, 128, 16, 64, [263] * 4, [249] * 4, None)]
MESH_VERIFY_CASES = [
    ("qwen3_shard", 1, 8, 8, 4, 128, 16, 64, [524], [2], None)]
MESH_MLA_CASES = [("deepseek_shard", 1, 16, 16, 64, [120], [15])]


def mesh_kernel_phase(pa, pp, pv, mk):
    """B1-B4 at their shard shapes against their plain versions, timed,
    each wrapper told the unsharded head count for its key splits as the
    engine's shards tell it."""
    decode_phase(pa, case_list=MESH_DECODE_CASES, timed=("qwen3_shard",),
                 split_heads=8)
    prefill_phase(pp, case_list=MESH_PREFILL_CASES, timed=("qwen3_shard",),
                  split_heads=8)
    verify_phase(pv, case_list=MESH_VERIFY_CASES, timed=("qwen3_shard",),
                 split_heads=8)
    mla_prefill_phase(mk, case_list=MESH_MLA_CASES, timed=("deepseek_shard",),
                      H=64, split_heads=128)


class LogitsLog:
    """Every ``logits_fn`` output of the engine module while it is on,
    per thread: the unsharded engine's on the caller's thread, each mesh
    shard's on its own."""

    def __init__(self):
        import threading

        from repro_torch.serving import engine
        self._engine, self._lock = engine, threading.Lock()
        self.rows: dict[str, list] = {}
        self._inner = engine.logits_fn

        def rec(params, cfg, hidden):
            out = self._inner(params, cfg, hidden)
            with self._lock:
                self.rows.setdefault(threading.current_thread().name,
                                     []).append(out.detach().clone())
            return out
        engine.logits_fn = rec

    def close(self) -> dict:
        self._engine.logits_fn = self._inner
        return self.rows


def mesh_expected(cfg, c, shards, draft_layers=0) -> dict:
    """Each kernel's launches for an engine's counters ``c``: every shard
    launches a paged kernel once per layer per call (B1 per decode step),
    the SSM scan too (its compute replicates); a draft's layers launch on
    one device."""
    L, kinds = cfg.n_layers, set(cfg.block_pattern)
    exp = dict.fromkeys(("decode", "prefill", "verify", "mla_prefill",
                         "ssd", "flash"), 0)
    if kinds & {"attn", "attn_moe", "shared_attn"}:
        exp["prefill"] = shards * L * c["prefill_calls"]
        exp["decode"] = shards * L * c["decode_steps"]
    if kinds & {"mla", "mla_moe"}:
        exp["mla_prefill"] = shards * L * c["prefill_calls"]
    if "ssm" in kinds:
        exp["ssd"] = shards * L * c["prefill_calls"]
    exp["verify"] = shards * L * c["spec_verify_calls"]
    exp["prefill"] += draft_layers * c["spec_catch_up_calls"]
    exp["decode"] += draft_layers * c["spec_draft_steps"]
    return exp


def launches_ok(kernels, expected) -> bool:
    return all(m.COUNTS["kernel"] == expected[k] and m.COUNTS["plain"] == 0
               for k, m in kernels.items())


def zero_counts(kernels) -> None:
    for m in kernels.values():
        m.COUNTS["kernel"] = m.COUNTS["plain"] = 0


def mesh_script(cfg, params, mesh, prompts, chunks, n_decode):
    """The mesh case's requests through a fresh engine (over ``mesh``, on
    one device when None): every prompt admitted, the first chunks
    prefilled in one group, the second (from mid-page) in another, then
    one decode burst for all.  Returns (streams, counters, per-thread
    logits rows, the engine's shard count)."""
    from repro_torch.core.batch import Batch
    from repro_torch.core.slo import StageKind
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    eng = ServingEngine(cfg, params, EngineConfig(mesh=mesh, **MESH_ENGINE),
                        device=None if mesh is not None else
                        torch.device("cuda"))
    log = LogitsLog()
    try:
        got = {rid: [] for rid in prompts}
        for rid, p in prompts.items():
            assert eng.add_request(rid, p, expected_total=len(p) + n_decode)
        for i, n in enumerate(chunks):
            b = Batch()
            for rid in prompts:
                b.add(rid, StageKind.PREFILL, n)
            for rid, t in eng.execute(b).items():
                got[rid] += t
        b = Batch()
        for rid in prompts:
            b.add(rid, StageKind.DECODE, n_decode)
        for rid, t in eng.execute(b).items():
            got[rid] += t
    finally:
        rows = log.close()
    return got, dict(eng.counters), rows


def top2_margins(rows, rids) -> dict:
    """The top-2 logit margin behind each emitted token: token 0 from the
    second prefill group's row of the lane, token i from decode step
    i - 1 (lanes in request order)."""
    seq = rows[1:]
    out = {}
    for lane, rid in enumerate(rids):
        out[rid] = []
        for lg in seq:
            top = torch.topk(lg[lane].float(), 2).values
            out[rid].append((top[0] - top[1]).item())
    return out


def logits_reading(rows, want) -> dict:
    """Each shard's logits, call for call, against the unsharded engine's:
    bit-equal, or the largest difference."""
    out = {}
    for name, seq in sorted(rows.items()):
        same_len = len(seq) == len(want)
        diff = max(((a.float() - b.float()).abs().max().item()
                    for a, b in zip(seq, want)), default=0.0)
        out[name] = {"calls": len(seq), "calls_equal": same_len,
                     "bit_equal": same_len and all(
                         torch.equal(a, b) for a, b in zip(seq, want)),
                     "max_abs_diff": diff}
    return out


def mesh_case(name, cfg, params, kernels, prompts, chunks, n_decode, flags,
              mesh):
    """One mesh case: the unsharded engine, then the sharded one."""
    from repro_torch.distributed.sharding import serving_shard_plan
    plan = serving_shard_plan(cfg, mesh, max_seqs=MESH_ENGINE["max_slots"])
    t0 = time.perf_counter()
    zero_counts(kernels)
    want, wc, wrows = mesh_script(cfg, params, None, prompts, chunks,
                                  n_decode)
    base_launch = launches_ok(kernels, mesh_expected(cfg, wc, 1))
    (want_rows,) = wrows.values()
    margins = top2_margins(want_rows, list(prompts))
    del wrows
    free_device_memory()
    zero_counts(kernels)
    got, gc, rows = mesh_script(cfg, params, mesh, prompts, chunks, n_decode)
    launches = {k: dict(m.COUNTS) for k, m in kernels.items()}
    expected = mesh_expected(cfg, gc, mesh.size)
    streams = {rid: compare_stream(got[rid], want[rid], margins[rid])
               for rid in prompts}
    checks = {
        "plan_flags": all(getattr(plan, f) for f in flags),
        "streams": all(s["ok"] for s in streams.values()),
        "shards_emit_equal_tokens": True,   # the engine raises otherwise
        "counters_equal": all(gc[k] == wc[k] for k in
                              ("prefill_calls", "decode_calls",
                               "decode_steps", "decode_tokens")),
        "launches_unsharded": base_launch,
        "launches_sharded": launches_ok(kernels, expected),
        "shards_reported": sorted(rows) == [f"mesh-shard-{i}" for i in
                                            range(mesh.size)],
    }
    rec = {"phase": "mesh_case", "case": name, "arch": cfg.name,
           "layers": cfg.n_layers, "shards": mesh.size,
           "plan": dataclasses.asdict(plan), "requests": len(prompts),
           "prompt": len(next(iter(prompts.values()))), "chunks": chunks,
           "decode": n_decode, "streams": streams,
           "logits": logits_reading(rows, want_rows),
           "counters": {k: gc[k] for k in ("prefill_calls", "decode_calls",
                                           "decode_steps")},
           "launches": launches, "expected_launches": expected,
           "seconds": time.perf_counter() - t0, "checks": checks,
           "ok": all(checks.values())}
    emit(rec)
    if not rec["ok"]:
        raise SystemExit(f"mesh case {name} failed: "
                         f"{[k for k, v in checks.items() if not v]}")
    return launches


def mesh_spec_case(cfg, params, draft, kernels, prompts, mesh):
    """Spec decoding over the mesh: the verify through B3 at shard widths
    on every shard, the draft unsharded on shard 0's device."""
    t0 = time.perf_counter()
    zero_counts(kernels)
    want, wc = spec_script(cfg, params, prompts, draft)
    Ld = draft[0].n_layers
    base_launch = launches_ok(kernels, mesh_expected(cfg, wc, 1, Ld))
    zero_counts(kernels)
    got, gc = spec_script(cfg, params, prompts, draft, mesh=mesh)
    launches = {k: dict(m.COUNTS) for k, m in kernels.items()}
    expected = mesh_expected(cfg, gc, mesh.size, Ld)
    fused = ("prefill_fused_ops", "verify_fused_ops")
    checks = {"streams_equal": got == want,
              "counters_equal": all(gc[k] == wc[k] for k in gc
                                    if k not in fused),
              "verify_ran": gc["spec_verify_calls"] > 0,
              "launches_unsharded": base_launch,
              "launches_sharded": launches_ok(kernels, expected)}
    rec = {"phase": "mesh_case", "case": "qwen3_spec", "arch": cfg.name,
           "layers": cfg.n_layers, "shards": mesh.size,
           "accepted": gc["spec_accepted_tokens"],
           "drafted": gc["spec_drafted_tokens"], "launches": launches,
           "expected_launches": expected,
           "seconds": time.perf_counter() - t0, "checks": checks,
           "ok": all(checks.values())}
    emit(rec)
    if not rec["ok"]:
        raise SystemExit(f"mesh spec case failed: "
                         f"{[k for k, v in checks.items() if not v]}")
    return launches


def mesh_cluster_case(cfg, params, kernels, seed: int):
    """``ClusterFrontend.build(devices_per_replica=2, devices=[cuda:0] *
    4)``: two replicas, each over its own 2-shard slice, the host tier
    on, against the same cluster unsharded.  Three waves of requests (odd
    ones sharing a prefix); the third re-sends the first, whose evicted
    pages were spilled.  Every prefetched page must hold, bit for bit,
    the bytes its chain had when it was spilled."""
    from repro_torch.core.perf_model import cpu_scale_perf_model
    from repro_torch.core.request import simple_request
    from repro_torch.core.router import RoutingPolicy
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.serving.cluster import ClusterFrontend
    C = MESH_CLUSTER
    g = torch.Generator().manual_seed(seed + 9)

    def draw(n):
        return torch.randint(1, cfg.vocab, (n,), generator=g).tolist()
    shared = draw(C["shared"])
    prompts = {rid: (shared if rid % 2 else draw(C["shared"]))
               + draw(4 + rid) for rid in range(1, 7)}
    dev = torch.device("cuda")

    def run(**kw):
        cl = ClusterFrontend.build(
            cfg, params, 2, cpu_scale_perf_model(),
            policy=RoutingPolicy(max_hops=1), total_pages=C["total_pages"],
            replica_pages=C["replica_pages"], page_size=C["page"],
            max_slots=C["max_slots"], max_len=C["max_len"],
            host_spill_pages=C["spill"],
            sched_cfg=SchedulerConfig(page_size=C["page"],
                                      prefill_emits_first_token=True), **kw)
        copies = KVCopyLog(cl.drivers)
        got: dict[int, list] = {}
        for w, wave in enumerate(((1, 2, 3), (4, 5, 6), (1, 2, 3))):
            for rid in wave:
                cl.submit(simple_request(rid + 10 * w, cl.clock,
                                         prompt=len(prompts[rid]), output=4,
                                         ttft_slowdown=8.0, tpot=0.15),
                          prompt=prompts[rid],
                          on_token=lambda r, t: got.setdefault(
                              r, []).extend(t))
            cl.run_until_idle()
        kv = [d.engine.kv for d in cl.drivers]
        return cl, got, copies, [(k.spilled_pages, k.prefetched_pages)
                                 for k in kv]
    t0 = time.perf_counter()
    _, want, _, want_spill = run(device=dev)
    free_device_memory()
    zero_counts(kernels)
    cl, got, copies, spill = run(devices_per_replica=2, devices=[dev] * 4)
    launches = {k: dict(m.COUNTS) for k, m in kernels.items()}
    meshes = [d.engine.mesh for d in cl.drivers]
    prefill = sum(d.engine.counters["prefill_calls"] for d in cl.drivers)
    steps = sum(d.engine.counters["decode_steps"] for d in cl.drivers)
    L = cfg.n_layers
    checks = {
        "streams_equal": got == want and len(got) == 9,
        "slices": all(m is not None and m.size == 2 for m in meshes)
        and meshes[0] is not meshes[1],
        "spill_equal": spill == want_spill,
        "spilled_and_prefetched": sum(s for s, _ in spill) > 0
        and sum(p for _, p in spill) > 0,
        "prefetched_bit_equal": copies.compared > 0
        and copies.equal == copies.compared,
        "launches": (launches["prefill"]["kernel"] == 2 * L * prefill
                     and launches["decode"]["kernel"] == 2 * L * steps
                     and all(m["plain"] == 0 for m in launches.values())),
    }
    rec = {"phase": "mesh_case", "case": "cluster_2x2", "arch": cfg.name,
           "layers": L, "replicas": 2, "shards_per_replica": 2,
           "spilled_prefetched": spill, "prefetch_compared": copies.compared,
           "launches": launches, "seconds": time.perf_counter() - t0,
           "checks": checks, "ok": all(checks.values())}
    emit(rec)
    if not rec["ok"]:
        raise SystemExit(f"mesh cluster case failed: "
                         f"{[k for k, v in checks.items() if not v]}")
    return launches


def mesh_replay_phase(kernels, seed: int, cfg_of=None) -> dict:
    """Every mesh case at published widths (``cfg_of(arch)``: the card's
    configs; the CPU rehearsal passes reduced ones): streams against the
    unsharded engine's with the tie rule, every shard's tokens equal (the
    engine raises otherwise), logits bit-equal or the largest
    difference, and every launch count shards x layers x the engine's
    counters.  Returns the kernels' launches summed over the cases."""
    from repro_torch.configs import get_config
    from repro_torch.device import generator
    from repro_torch.distributed.sharding import make_serving_mesh
    from repro_torch.models import init_params
    cfg_of = cfg_of or get_config
    dev = torch.device("cuda")
    mesh = make_serving_mesh([dev] * MESH_SHARDS)
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    total = {k: {"kernel": 0, "plain": 0} for k in kernels}

    def add(launches):
        for k, v in launches.items():
            for kk in v:
                total[k][kk] += v[kk]
    for name, arch, layers, n_req, n_prompt, chunks, n_dec, flags in \
            MESH_CASES:
        cfg = cfg_of(arch)
        if layers is not None and layers < cfg.n_layers:
            cfg = cut_depth(cfg, layers)
        params = init_params(cfg, generator(dev, seed), device=dev)
        g = torch.Generator().manual_seed(seed + 5)
        prompts = {rid: torch.randint(1, cfg.vocab, (n_prompt,),
                                      generator=g).tolist()
                   for rid in range(1, n_req + 1)}
        add(mesh_case(name, cfg, params, kernels, prompts, chunks, n_dec,
                      flags, mesh))
        if name == "qwen3":
            n = min(MESH_SPEC_LAYERS, cfg.n_layers)
            cut = cut_depth(cfg, n)
            cut_params = {**params, "segments": [
                {"p": _slice_layers(params["segments"][0]["p"], n)}]}
            draft = one_layer_draft(cut, dev, seed + 7)
            add(mesh_spec_case(cut, cut_params, draft, kernels,
                               spec_prompts(cut, seed), mesh))
            add(mesh_cluster_case(cut, cut_params, kernels, seed))
            del cut_params, draft
        del params
        free_device_memory()
    torch.cuda.synchronize()
    emit({"phase": "mesh_replay", "shards": MESH_SHARDS,
          "cases": [c[0] for c in MESH_CASES] + ["qwen3_spec",
                                                 "cluster_2x2"],
          "seconds": time.perf_counter() - t0,
          "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
          "launches": total, "ok": True})
    return total


def _slice_layers(tree, n):
    """The first n layers of a stacked segment's parameter tree."""
    if isinstance(tree, dict):
        return {k: _slice_layers(v, n) for k, v in tree.items()}
    return tree[:n]


# sharded training: qwen3-1.7b at its published widths (16 / 8 heads of
# 128, d_ff 6144, vocab 151936) cut to 4 of its 28 layers, float32 with
# TF32 off, over a data 2 x model 2 mesh of four shards on one card (the
# model axis splits heads and FFN columns), three AdamW steps on the
# Markov stream against the unsharded step on the same card
TRAIN_MESH = dict(arch="qwen3-1.7b", layers=4, mesh=(2, 2), batch=8,
                  seq_len=512, steps=3, lr=1e-3)
# step 1's loss and gradients within rtol 1e-4, later losses within 1e-4
# relative: sums in other orders (cuBLAS picks other kernels at half
# widths; the data mean adds two halves).  A gradient leaf's atol is
# MESH_GRAD_ATOL x max |g| of the leaf, or twice the largest |difference|
# / max |g| that the unsharded step's own gradient moves by when only its
# batch is summed as the data shards' halves (the phase's control), if
# that is larger, but at most MESH_GRAD_ATOL_CAP x max |g|: at qwen3-1.7b's
# widths on the card that control alone moved w_gate by 9.65e-6 of its
# max |g| (PERF.md, PR 25), so 1e-6 cannot hold for any data-parallel
# step there.  After the steps every parameter within 2 x steps x lr:
# AdamW's normalised step can flip on a near-zero gradient.
MESH_GRAD_RTOL, MESH_GRAD_ATOL, MESH_LOSS_RTOL = 1e-4, 1e-6, 1e-4
MESH_GRAD_ATOL_CAP = 1e-4
# seconds a shard waits in a collective before the phase fails
TRAIN_MESH_TIMEOUT = 300.0


def train_mesh_phase(kernels, card: str, seed: int, dev=None, cfg=None,
                     spec=TRAIN_MESH):
    """``TRAIN_MESH``: the unsharded port step (``launch.steps``'
    ``make_train_step``) from the seed's weights, then the same weights
    (drawn again from the seed) resting over the mesh as
    ``params_shardings`` cuts them, stepped by ``sharded_train_step`` on
    one worker thread a shard.  Checks the gates above, that the shards'
    replicated parts stay bit-equal, that each shard rests on the bytes
    its specs predict, that each shard's collectives of a step are those
    ``launch/dryrun.py``'s one-shard run of the same shapes counts, and
    that no kernel or plain version launched."""
    from repro_torch.configs import get_config
    from repro_torch.device import generator
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.cost_analysis import collective_counts
    from repro_torch.models import init_params
    from repro_torch.training.data import batches
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_loop import loss_and_grads, trainable
    from repro_torch.training.tree import flatten, tree_map

    dev = dev or torch.device("cuda")
    cuda = dev.type == "cuda"
    cfg = cfg or cut_depth(get_config(spec["arch"]), spec["layers"])
    t0 = time.perf_counter()
    before = kernel_counts(kernels)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    opt = AdamWConfig(lr=spec["lr"], warmup_steps=1, total_steps=10)
    it = batches(cfg.vocab, spec["batch"], spec["seq_len"], seed)
    data = [{k: torch.from_numpy(v).long().to(dev) for k, v in
             next(it).items()} for _ in range(spec["steps"])]
    cpu = torch.device("cpu")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    # unsharded: step 1's gradients and the final parameters kept on the
    # host
    up = trainable(init_params(cfg, generator(dev, seed), device=dev))
    _, _, g0 = loss_and_grads(up, cfg, data[0])
    g0 = [g.detach().to(cpu) for g in flatten(g0)[1]]
    # control: the same unsharded step's gradient as the mean of the data
    # shards' row slices' gradients (the data axis's order of sums, no
    # sharding code)
    n_data = spec["mesh"][0]
    rows = spec["batch"] // n_data
    split = None
    for j in range(n_data):
        _, _, gj = loss_and_grads(up, cfg, {k: v[j * rows:(j + 1) * rows]
                                            for k, v in data[0].items()})
        gj = [g.detach() for g in flatten(gj)[1]]
        split = gj if split is None else [a + b for a, b in zip(split, gj)]
    split = [(g / n_data).to(cpu) for g in split]
    del gj
    uo = init_opt_state(up)
    ustep = steps.make_train_step(cfg, opt)
    ulosses, ums = [], []
    for b in data:
        sync()
        ts = time.perf_counter()
        up, uo, m = ustep(up, uo, b)
        ulosses.append(float(m["loss"]))
        ums.append(1e3 * (time.perf_counter() - ts))
    paths, ufinal = flatten(up)
    ufinal = [p.detach().to(cpu) for p in ufinal]
    del up, uo, m
    free_device_memory()

    mesh = shd.make_mesh(spec["mesh"], ("data", "model"),
                         [dev] * (spec["mesh"][0] * spec["mesh"][1]))
    plan = shd.serving_shard_plan(cfg, mesh)
    params = init_params(cfg, generator(dev, seed), device=dev)
    pspecs = shd.params_shardings(params, cfg, mesh)
    ospecs = {"mu": pspecs, "nu": pspecs, "step": ()}
    meta = tree_map(lambda t: t.to("meta"), params)
    predicted = (shd.shard_nbytes(meta, pspecs, mesh)
                 + shd.shard_nbytes(init_opt_state(meta), ospecs, mesh))
    sp = shd.shard_tree(params, pspecs, mesh, copy=True)
    del params
    so = [init_opt_state(p) for p in sp]
    rest = [sum(t.numel() * t.element_size()
                for t in flatten(p)[1] + flatten(o)[1])
            for p, o in zip(sp, so)]
    workers = shd.ShardWorkers(mesh, timeout=TRAIN_MESH_TIMEOUT)
    prog = steps.sharded_train_step(cfg, mesh, pspecs, opt, keep_grads=True)
    slosses, sms, per_step, replicas = [], [], [], []
    grad_read = None
    for k, b in enumerate(data):
        bb = steps.shard_batch(prog, b, mesh)
        before_stats = [workers.comm.stats(i) for i in range(mesh.size)]
        sync()
        ts = time.perf_counter()
        outs = workers.run(lambda i, ms: prog(ms, sp[i], so[i], bb[i]))
        sync()
        sms.append(1e3 * (time.perf_counter() - ts))
        sp, so = [o[0] for o in outs], [o[1] for o in outs]
        slosses.append(float(outs[0][2]["loss"]))
        per_step.append([_stats_diff(workers.comm.stats(i), before_stats[i])
                         for i in range(mesh.size)])
        replicas.append(shd.replicas_equal(sp, pspecs, mesh)
                        and shd.replicas_equal(so, ospecs, mesh)
                        and len({float(o[2]["loss"]) for o in outs}) == 1)
        if k == 0:
            full = shd.unshard_tree([o[2]["grads"] for o in outs], pspecs,
                                    mesh, device=cpu)
            got = flatten(full)[1]
            control = _grad_reading(split, g0, paths)
            atol = min(max(MESH_GRAD_ATOL, 2 * control["worst_rel_to_max"]),
                       MESH_GRAD_ATOL_CAP)
            grad_read = _grad_reading(got, g0, paths, atol)
            grad_read["ok_at_atol_1e-6"] = _grad_reading(
                got, g0, paths)["ok"]
            grad_read["split_control"] = control
            grad_read["vs_split_control"] = _grad_reading(got, split, paths)
            del full, got
        del outs
    sfinal = flatten(shd.unshard_tree(sp, pspecs, mesh, device=cpu))[1]
    diffs = [(a - b).abs() for a, b in zip(sfinal, ufinal)]
    bound = 2 * spec["steps"] * spec["lr"]
    dry = dryrun.analyze_step(cfg, dict(seq_len=spec["seq_len"],
                                        global_batch=spec["batch"],
                                        kind="train"),
                              shd.make_mesh(spec["mesh"], ("data", "model")),
                              dtype=torch.float32)
    shard_colls = [[collective_counts(s) for s in step] for step in per_step]
    after = kernel_counts(kernels)
    rec = {"phase": "train_mesh", "model": cfg.name, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
           "d_ff": cfg.d_ff, "vocab": cfg.vocab,
           "mesh": "x".join(map(str, spec["mesh"])),
           "devices": f"{dev} x {mesh.size}",
           "splits": [f for f in ("heads", "mla_heads", "experts", "mlp")
                      if getattr(plan, f)],
           "batch": spec["batch"], "seq_len": spec["seq_len"],
           "lr": spec["lr"], "unsharded_losses": ulosses,
           "sharded_losses": slosses,
           "loss_rel": [rel(a, b) for a, b in zip(slosses, ulosses)],
           "grads_step1": grad_read,
           "param_max_abs_diff": max(float(d.max()) for d in diffs),
           "param_bound": bound,
           "param_elems_over_1e-5": int(sum(int((d > 1e-5).sum())
                                            for d in diffs)),
           "param_elems": int(sum(d.numel() for d in diffs)),
           "rest_bytes": rest, "rest_bytes_predicted": predicted,
           "collectives_per_step_shard0": shard_colls[0][0],
           "dryrun_collectives": dry["collectives"],
           "step_ms_unsharded": ums, "step_ms_sharded": sms,
           "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                        if cuda else None),
           "seconds": time.perf_counter() - t0,
           "launches_before": before, "launches_after": after}
    checks = {
        "model_axis_splits": bool(rec["splits"]),
        "loss_step1": rec["loss_rel"][0] <= MESH_GRAD_RTOL,
        "grads_step1": grad_read["ok"],
        "losses_later": all(r <= MESH_LOSS_RTOL for r in rec["loss_rel"][1:]),
        "params_within_bound": rec["param_max_abs_diff"] <= bound,
        "replicas_bit_equal": all(replicas),
        "rest_bytes": all(r == predicted for r in rest),
        "collectives_match_dryrun": all(c == dry["collectives"]
                                        for step in shard_colls
                                        for c in step),
        "no_kernel_no_plain": before == after}
    del sp, so, workers
    finish(rec, checks, card)
    return rec


def _stats_diff(now: dict, then: dict) -> dict:
    out = {}
    for kind, c in now.items():
        t = then.get(kind, {"count": 0, "bytes": 0})
        out[kind] = {"count": c["count"] - t["count"],
                     "bytes": c["bytes"] - t["bytes"]}
    return out


def _grad_reading(got, want, paths, atol: float = MESH_GRAD_ATOL) -> dict:
    """Every gradient leaf of ``got`` against ``want``'s within
    ``MESH_GRAD_RTOL`` with atol ``atol`` x max |g| of the leaf; the
    worst leaf's largest |difference| / max |g|."""
    ok, worst = True, (0.0, None)
    for path, g, w in zip(paths, got, want):
        scale = float(w.abs().max())
        d = (g - w).abs()
        if not bool((d <= atol * scale + MESH_GRAD_RTOL * w.abs()).all()):
            ok = False
        r = float(d.max()) / scale if scale else float(d.max())
        if r > worst[0]:
            worst = (r, path)
    return {"ok": ok, "atol_rel_to_max": atol, "worst_rel_to_max": worst[0],
            "worst_leaf": worst[1], "leaves": len(paths)}


def main(argv=()) -> int:
    ap = argparse.ArgumentParser(description="Smoke test of the port on one "
                                 "NVIDIA card.")
    ap.add_argument("--parent", metavar="DIR", default=None,
                    help="another checkout of the repo (for example a git "
                         "archive of the parent commit): its B5 and B3 are "
                         "built and timed beside this tree's at the timed "
                         "shapes, and the ssm replay runs with its B5 and "
                         "this tree's in turns")
    ap.add_argument("--split-sweep", action="store_true",
                    help="only build the kernels and time B6, B4 and B3 at "
                         "every key-split count and B5 with and without "
                         "its C.B^T workspace, at the "
                         "shapes that chose them (no check phases, no final "
                         "line)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.device import set_precision
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_prefill as pp
    from repro_torch.kernels import mla_paged_prefill as mk
    from repro_torch.kernels import paged_verify as pv
    from repro_torch.kernels import ssd_scan as sk

    set_precision()
    seed = 0
    t0 = time.perf_counter()
    card = card_line()
    info = build.build_all()
    ptxas = {k: [ln.strip() for ln in v.splitlines()
                 if "registers" in ln or "spill" in ln]
             for k, v in info["ptxas"].items()}
    if args.split_sweep:
        emit({"phase": "setup", "gpu": card, "build_s": info["seconds"]})
        split_sweep(fa, mk, pv, sk)
        return 0
    parent = None if args.parent is None else ParentKernels(args.parent)
    emit({"phase": "setup", "gpu": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": info["seconds"],
          "ptxas": ptxas,
          "parent": None if parent is None else {"dir": args.parent,
                                                 "ptxas": parent.ptxas}})
    # the seconds of each phase the last two slices added (the fp16
    # pools', the bf16 inputs', the VLM's and the examples'), printed
    # before the "done" line
    new_s: dict[str, float] = {}

    def new_phase(name, fn, *a, **k):
        t = time.perf_counter()
        out = fn(*a, **k)
        new_s[name] = new_s.get(name, 0.0) + time.perf_counter() - t
        return out

    dec = decode_phase(pa)
    pre = prefill_phase(pp)
    ver = verify_phase(pv, parent)
    bf16, f16 = torch.bfloat16, torch.float16
    dec16 = decode_phase(pa, bf16, timed=BF16_DECODE_TIMED)
    pre16 = prefill_phase(pp, bf16, timed=BF16_PREFILL_TIMED)
    ver16 = verify_phase(pv, None, bf16, timed=BF16_VERIFY_TIMED)
    dech = new_phase("fp16_kernels", decode_phase, pa, f16,
                     timed=F16_DECODE_TIMED)
    preh = new_phase("fp16_kernels", prefill_phase, pp, f16,
                     timed=F16_PREFILL_TIMED)
    verh = new_phase("fp16_kernels", verify_phase, pv, None, f16,
                     timed=F16_VERIFY_TIMED)
    free_device_memory()
    lowp = new_phase("bf16_input_kernels", lowp_kernel_phase, pa, fa, sk)
    free_device_memory()
    # early, beside the other kernel phases: late in the process the
    # profiler dropped its launch records (row 3m of PERF.md)
    mesh_kernel_phase(pa, pp, pv, mk)
    free_device_memory()
    stream_phase(seed)
    launches, cfg, params = main_path(pa, pp, fa, seed)
    free_device_memory()
    kernels = {"decode": pa, "prefill": pp, "verify": pv, "mla_prefill": mk,
               "ssd": sk, "flash": fa}
    paths = {"main_path": launches}
    paths["cluster_replay"] = cluster_phase(cfg, params, kernels, seed)
    dense_cache_phase(cfg, params, kernels, seed)
    del params
    free_device_memory()
    cfg, params = spec_model(seed)
    spec_wants = spec_stream_phase(cfg, params, seed)
    free_device_memory()
    spec = spec_replay_phase(cfg, params, kernels, seed)
    paths["spec_replay"] = spec["launches"]
    free_device_memory()
    prompts = spec_prompts(cfg, seed)
    draft = one_layer_draft(cfg, torch.device("cuda"), seed + 7)
    def spec_run(dtype):
        return spec_script(cfg, params, prompts, draft, dtype)[0]
    kv16_streams_phase("spec", cfg, params, prompts, spec_run, spec_wants,
                       bf16)
    new_phase("fp16_streams", kv16_streams_phase, "spec", cfg, params,
              prompts, spec_run, spec_wants, f16)
    del draft
    paths["bf16_spec_replay"] = spec_replay_phase(
        cfg, params, kernels, seed, bf16, f32=spec)["launches"]
    free_device_memory()
    paths["fp16_spec_replay"] = new_phase(
        "fp16_spec_replay", spec_replay_phase, cfg, params, kernels, seed,
        f16, f32=spec)["launches"]
    del params
    free_device_memory()
    mla = mla_prefill_phase(mk)
    mla16 = mla_prefill_phase(mk, bf16, timed=BF16_MLA_TIMED)
    mlah = new_phase("fp16_kernels", mla_prefill_phase, mk, f16,
                     timed=F16_MLA_TIMED)
    free_device_memory()
    cfg, params = mla_model(seed)
    mla_wants = mla_stream_phase(cfg, params, seed)
    free_device_memory()
    mla_rec = mla_replay_phase(cfg, params, kernels, seed)
    paths["mla_replay"] = mla_rec["launches"]
    free_device_memory()
    prompts = script_prompts(cfg, seed + 3)
    def mla_run(dtype):
        return run_script(cfg, params, prompts, STREAM_SCRIPT, max_len=256,
                          dtype=dtype)[0]
    kv16_streams_phase("mla", cfg, params, prompts, mla_run, mla_wants,
                       bf16)
    new_phase("fp16_streams", kv16_streams_phase, "mla", cfg, params,
              prompts, mla_run, mla_wants, f16)
    paths["bf16_mla_replay"] = mla_replay_phase(
        cfg, params, kernels, seed, bf16, f32=mla_rec)["launches"]
    free_device_memory()
    paths["fp16_mla_replay"] = new_phase(
        "fp16_mla_replay", mla_replay_phase, cfg, params, kernels, seed, f16,
        f32=mla_rec)["launches"]
    del params
    free_device_memory()
    ssd = ssd_phase(sk, parent)
    free_device_memory()
    cfg, params = ssm_model(seed)
    ssm_stream_phase(cfg, params, seed)
    free_device_memory()
    paths["ssm_replay"], groups, lives = ssm_replay_phase(cfg, params,
                                                          kernels, seed)
    ssd_replay_group_phase(sk, cfg, groups, lives, parent)
    if parent is not None:
        free_device_memory()
        ssm_ab_phase(cfg, params, kernels, parent, seed)
    del params
    free_device_memory()
    flash = flash_phase(fa)
    free_device_memory()
    cfg, params = whisper_model(seed)
    whisper_stream_phase(cfg, params, seed)
    free_device_memory()
    paths["whisper_replay"] = whisper_replay_phase(cfg, params, kernels,
                                                   seed)
    del params
    free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    cfg, params = vlm_model(seed)
    new_phase("vlm_stream", vlm_stream_phase, cfg, params, seed)
    free_device_memory()
    paths["vlm_replay"] = new_phase("vlm_replay", vlm_replay_phase, cfg,
                                    params, kernels, seed)
    del params
    free_device_memory()
    paths["bf16_launch_steps"] = new_phase(
        "bf16_launch_steps", bf16_launch_steps_phase, kernels, seed)
    free_device_memory()
    ssd_phase(sk, cases=SSD_HYBRID_CASES, timed=SSD_HYBRID_TIMED, seed=11,
              widths=(HYBRID_H, HYBRID_P, HYBRID_N))
    free_device_memory()
    cfg, params = hybrid_model(seed)
    hybrid_stream_phase(cfg, params, seed)
    free_device_memory()
    paths["hybrid_replay"] = hybrid_replay_phase(cfg, params, kernels, seed)
    del params
    free_device_memory()
    cfg, params = moe_model(seed)
    moe_stream_phase(cfg, params, seed)
    free_device_memory()
    paths["moe_replay"] = moe_replay_phase(cfg, params, kernels, seed)
    del params
    free_device_memory()
    train_dense_phase(kernels, card, seed)
    free_device_memory()
    train_ssm_phase(kernels, card, seed)
    free_device_memory()
    train_moe_phase(kernels, card, seed)
    free_device_memory()
    train_mesh_phase(kernels, card, seed)
    free_device_memory()
    paths["mesh_replay"] = mesh_replay_phase(kernels, seed)
    free_device_memory()
    paths["examples"] = new_phase("examples", examples_phase, kernels, card)
    free_device_memory()
    # last: run ahead of the kernel phases, it left the profiler
    # recording no launch at all in several of their readings
    cfg, params = gateway_model(seed)
    paths["gateway_replay"] = gateway_phase(cfg, params, kernels, seed)
    del params
    free_device_memory()
    torch.cuda.synchronize()
    emit({"phase": "new_phase_seconds", "seconds": new_s,
          "sum_s": sum(new_s.values()), "total_s": time.perf_counter() - t0})
    emit({"phase": "done", "total_s": time.perf_counter() - t0})

    def entry(name, source, replaces, rec, key, pages="float32", tag=None,
              **extra):
        # launches: the kernel's over every path's replay whose name has
        # the prefix ``tag`` + "_" (the 16-bit runs: "bf16_", "fp16_"),
        # or none of those for the float32 entries
        def tag_of(path):
            return next((t for t in DTYPE_TAG.values()
                         if path.startswith(t + "_")), None)
        by_path = {p: v[key]["kernel"] for p, v in paths.items()
                   if key in v and tag_of(p) == tag}
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "device_ms": rec["device_ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
                "library_device_ms": rec["library_device_ms"],
                "page_dtype": pages, **extra}
    emit({"kernels": [
        entry("paged_decode_attention", "src/repro_torch/csrc/paged_decode.cu",
              "src/repro/kernels/paged_attention.py:73", dec["main"],
              "decode"),
        entry("paged_prefill_attention",
              "src/repro_torch/csrc/paged_prefill.cu",
              "src/repro/kernels/paged_prefill.py:125", pre["main"],
              "prefill"),
        entry("paged_verify_attention",
              "src/repro_torch/csrc/paged_verify.cu",
              "src/repro/kernels/paged_prefill.py:308", ver["main"],
              "verify"),
        entry("mla_paged_prefill_attention",
              "src/repro_torch/csrc/mla_paged_prefill.cu",
              "src/repro/kernels/paged_prefill.py:255", mla,
              "mla_prefill"),
        entry("ssd_scan", "src/repro_torch/csrc/ssd_scan.cu",
              "src/repro/kernels/ssd_scan.py:59", ssd, "ssd"),
        entry("flash_attention_bh", "src/repro_torch/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:66", flash["encoder"],
              "flash"),
        entry("paged_decode_attention_bf16",
              "src/repro_torch/csrc/paged_decode.cu",
              "src/repro/kernels/paged_attention.py:73", dec16["main"],
              "decode", "bfloat16", "bf16"),
        entry("paged_prefill_attention_bf16",
              "src/repro_torch/csrc/paged_prefill.cu",
              "src/repro/kernels/paged_prefill.py:125", pre16["main"],
              "prefill", "bfloat16", "bf16"),
        entry("paged_verify_attention_bf16",
              "src/repro_torch/csrc/paged_verify.cu",
              "src/repro/kernels/paged_prefill.py:308", ver16["main"],
              "verify", "bfloat16", "bf16"),
        entry("mla_paged_prefill_attention_bf16",
              "src/repro_torch/csrc/mla_paged_prefill.cu",
              "src/repro/kernels/paged_prefill.py:255", mla16,
              "mla_prefill", "bfloat16", "bf16"),
        entry("paged_decode_attention_f16",
              "src/repro_torch/csrc/paged_decode.cu",
              "src/repro/kernels/paged_attention.py:73", dech["main"],
              "decode", "float16", "fp16"),
        entry("paged_prefill_attention_f16",
              "src/repro_torch/csrc/paged_prefill.cu",
              "src/repro/kernels/paged_prefill.py:125", preh["main"],
              "prefill", "float16", "fp16"),
        entry("paged_verify_attention_f16",
              "src/repro_torch/csrc/paged_verify.cu",
              "src/repro/kernels/paged_prefill.py:308", verh["main"],
              "verify", "float16", "fp16"),
        entry("mla_paged_prefill_attention_f16",
              "src/repro_torch/csrc/mla_paged_prefill.cu",
              "src/repro/kernels/paged_prefill.py:255", mlah,
              "mla_prefill", "float16", "fp16"),
        # no path passes bf16 queries (the engine's activations are
        # float32): its launches are the kernel phase's alone, not counted
        entry("paged_decode_attention_bf16q",
              "src/repro_torch/csrc/paged_decode.cu",
              "src/repro/kernels/paged_attention.py:73", lowp["bf16q"],
              "decode", "bfloat16", "bf16q", query_dtype="bfloat16"),
        entry("ssd_scan_bf16", "src/repro_torch/csrc/ssd_scan.cu",
              "src/repro/kernels/ssd_scan.py:59", lowp["ssd"], "ssd",
              None, "bf16", dtype="bfloat16"),
        entry("flash_attention_bh_bf16",
              "src/repro_torch/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:66", lowp["flash"],
              "flash", None, "bf16", dtype="bfloat16"),
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
