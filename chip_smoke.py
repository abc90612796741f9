#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the GeoLayer store once on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

or, for phases 1, 2 and 20 alone, ``python3 chip_smoke.py --phase ragged``.

Phases, each of which fails the run with a nonzero exit:

1. Device: CUDA must be present; prints the card's name and power limit.
2. Build: compiles ``src/repro_torch/csrc/*.cu`` with ``nvcc`` (sm_90a) and
   prints each kernel's registers, spill bytes and ptxas warnings.
3. Main path at full size, with every kernel's launch count set to 0 just
   before and read just after: a 530,175-item store (community graph of
   26,000 vertices, the paper's five-DC environment, 160 five-hop patterns,
   ``PlacementConfig()`` defaults) is built on the card, serves batches of
   64, 256 and 1024 requests, and runs ``maintain()``.  Every batch must be
   request-identical to the numpy router, a batch launches the ragged route
   expansion exactly when its items reach the router's item gate, and
   every kernel of that path (batched DHD count + flow, the ragged route
   expansion) must have run.  Each launch must read the store's route
   tables on the card (item ids over tables keyed by item id); its inputs
   (ids, the tables, offsets, origins, the tables' byte shift) are
   recorded.
4. Kernels against their plain PyTorch versions on the card: the ragged
   route expansion on the inputs phase 3 recorded (also against a launch
   over the rows its ids stand for; every output equal, and its int64 byte
   sums, served-DC masks and unresolved counts equal to the router's host
   f64 epilogue over its picks), and on ``SWEEP`` (31
   DCs, all-tie reads, reads with no items, and lengths around a warp's 32
   lanes and its share of 256 slots, and past 1,024); DHD on the inputs of the 8th step (or the last) of each kind the
   main path ran (placement arenas with per-field vals, pre-caching,
   ``maintain``), recorded during phase 3, on two seeded shapes the lane
   lacks (7 fields, kmax 150; 6 fields with per-field vals), and on a
   sweep of the batched count's branches (``DHD_SWEEP``: heat on 4 levels,
   pad rows, B 1/5/7/6, kmax 71/80/150/37, n 10,007 and 3): counts and
   other integer outputs exact, DHD floats within atol 1e-5 / rtol 1e-4.
5. Streaming updates on the same store, counts set to 0 just before and
   read just after: two churn batches at rate 0.01 (global warm-DHD sweeps)
   and two at 2e-5 (a trickle whose frontier takes the pre-solve), each
   also applied to a CPU mirror of the store; then a migration flush on
   both, and on the card ``maintain()``, ``compact()`` and a served batch of
   1024 requests.  Report integers, replica sets and routes must equal the
   mirror's, heat within atol 1e-5 / rtol 1e-4; the served batch must be
   request-identical to the numpy router; at least one batch must take the
   pre-solve and both single-field DHD kernels must have run.  Flush plans
   may differ from the mirror's on heat near-ties: counted, not failed.
6. The single-field DHD kernels against their plain versions on the card,
   on the inputs of real sweeps recorded in phase 5 (global and pre-solve),
   and on a sweep of the flow pass's instances (``DHD_SINGLE_SWEEP``: 8, 16
   and 32 lanes a row, 16-byte or scalar loads, a misaligned base, kmax up
   to 400), with tie-heavy heat and pad rows.
7. A CPU build of the same store: replica rows that differ from the card's.
   The store is freed after this phase.
8. LM serving at full width, counts set to 0 just before and read just
   after: ``deepseek-v2-lite-16b`` (MLA + MoE, 16 B parameters, bf16,
   random weights drawn on the card from seed 0) behind the
   continuous-batching ``Engine`` (4 slots, 1,024 positions) serves 8
   requests of 64-700 prompt tokens, 16 new tokens each.  Every request must
   complete with 16 tokens and finite logits, and every prefill must run the
   flash-attention kernel in each of its 27 layers.  Prints init seconds,
   prefill and decode-step times, tokens/s, peak memory, and one prefill and
   one decode step under the profiler.
9. End to end: the prefill with the kernel against the same prefill with
   ``kernels.ops.attention`` swapped for its plain version, on a 2-layer
   model at full width in f32 (within atol/rtol 1e-3), and reported (not
   failed) on the full-depth bf16 model beside two controls (SDPA, and the
   f32 kernel on upcast inputs), each with its layer-0 outputs' count of
   differences from the plain version and RMS distance to f64.
10. The flash-attention kernel against its plain version on the card on
    layer 0's q, k, v recorded from the longest and the shortest prefill:
    bf16 within 2e-2, the same inputs in f32 within 2e-5; timed in turns
    with ``scaled_dot_product_attention`` beside its bound.  Then a sweep of shapes the
    LM path never gives it (GQA, a window, suffix-aligned and fully masked
    rows, widths 16-256, lengths 1-1,024, a transposed v, two batch rows),
    each in bf16 and f32 within the same tolerances; fully masked rows must
    be exactly 0, and a bf16 view the kernel cannot copy must raise.
11. Embedding bags, counts set to 0 just before and read just after: BST's
    item table (2^22 x 32, f32) and Zipf ids, 20 a bag, at batches of 512
    and 262,144, weighted, in sum and mean, through
    ``models.recsys.embedding.bag_lookup``: within 1e-4 of the plain
    version; timed beside the bound and ``F.embedding_bag``, with the
    instance that ran (``embedding_bag.instance``).  Then ``BAG_SWEEP``
    within 1e-4: f32 and bf16, D 16-256 and 33 (one element a load), L 0-64,
    a partial last block, no weights, zero weights in mean, a misaligned
    table view.

12. Competitor stores at full size (paper Figs. 7 and 16) on the lane's
    inputs, with 40 held-out test patterns drawn as
    ``benchmarks/common.py:50-69`` draws them: GeoLayer, then Random-3 and
    Top-3 with random routing, ADP and DCD with greedy set-cover routing,
    and LP+RR (GeoLayer's placement, random routing), each built on the
    card, with its build seconds and its mean modelled online latency (65%
    home origins) normalised to GeoLayer's.  Then RP+SR
    (random placement, stepwise routing), counts set to 0 just before and
    read just after its build, batches of 64, 256 and 1024 requests and
    ``maintain()``: every batch request-identical to the numpy router and
    to a CPU mirror, replica sets and routes after ``maintain()`` equal to
    the mirror's, ``route_expand_ragged`` launched by each batch over the
    item gate (over the store's route tables) and both batched DHD kernels
    launched; both held against their plain versions on the inputs RP+SR's
    own launches took (phase 4's checks, the route sums against the host
    epilogue too).
13. Offline routing and layouts at full size (Figs. 13-15): ``plan_offline``
    over all 26,000 vertices of the phase-12 GeoLayer store, the
    consolidated-or-in-place choice of ``bench_offline.py:27-55``, and the
    RAGraph, RAGraph+ and GrapH layouts; the plan's fields and every layout
    must equal a CPU mirror's.  Each layout is priced by the BSP model for
    PageRank (15 supersteps), SSSP (10), HITS (20), LPA (10) and k-core
    (its peel rounds): time, WAN bytes, speedup against RAGraph.
14. Graph analytics on the card: PageRank (15 iterations), SSSP (10,
    weights ``edge_size``, source 0), HITS (20) and LPA (10) on the lane
    graph (26,000 vertices, 504,175 edges; k-core on the host beside them)
    and on ``rmat_graph(20, edge_factor=16, a=0.57, b=0.19, c=0.19)``
    (1,048,576 vertices, about 16.1 M edges), each against the same
    function run on the host: SSSP and LPA equal, PageRank and HITS within
    rtol 1e-4 / atol 1e-7.  Prints ms an iteration (CUDA events around the
    whole call after a warm-up), edges a second, the byte bound of an
    iteration and the device's busy share under the profiler.
15. The serving control plane over the sharded store (slices C and E) at
    full width: a ``ShardedGeoGraphStore`` of the lane's inputs (5 shards,
    int8 transfers, payload reads) beside an unsharded store from fresh
    inputs of the same seeds, both on the card.  (a) Equal replica sets,
    shard partitions equal to the coordinator, exact payloads; batches of
    64, 256 and 1024 through the thread pool and serially, each
    request-identical to the unsharded store and the numpy router; two
    churn batches at 0.01, a flush in tight waves (``bench_scheduler.py``'s
    window and thresholds) and ``maintain()``, with equal states, adds and
    waves and payloads within 1/127.  (b) ``bench_scheduler.py``'s control
    plane (adaptive batching, a migration flush, periodic ``maintain``)
    over its bursty trace (8,192 requests) on each store: byte-identical
    Chrome traces, equal batches and results, a wave applied on each.
    (c) Per-shard AIMD on the sharded store over the mixed trace (8,192
    requests), counts set to 0 just before and read just after, with the
    route fast path pinned from 1 item up (the one-shard drains of that
    trace hold 1-3 requests on the lane, far under the default gate): every
    drain request-identical to the numpy router, and the route expansion,
    the batched and the single-field DHD pairs launched and held to their
    plain versions on inputs recorded from the path.  Prints drain sizes
    and wall times, sim-clock latencies by class, misses by cause, waves,
    int8 against fp32 wire bytes by link, shard busy seconds, the
    ``_sync_payloads`` time and one drain's device share, each beside the
    card's name and power limit.
16. Slice F2, dense/GQA LM serving and BST (between phases 10 and 11;
    F1's model is released first), counts set to 0 just before each
    engine runs and read just after.  (a) ``gemma3-27b`` at full width (62
    layers, GQA 32/16, head width 128, a 1,024-token window on five of
    every six layers, 27.0 B parameters, bf16, seed 0) behind
    ``Engine(4, 2048)``: 8 requests of 96-1,900 prompt tokens (four past
    the window), 16 new tokens each; every request completes with finite
    logits and every prefill launches ``flash_attention`` once a layer
    (496, 416 of them windowed).  Prints tokens/s, prefill ms by length,
    decode-step ms beside the weights-read floor, peak memory, and one
    1,900-token prefill and one decode step under the profiler.  (b) A
    6-layer full-width f32 gemma3 (5 local, 1 global), one 1,300-token
    prefill with the kernel against the plain attention, within
    atol/rtol 1e-3.  (d) ``qwen3-0.6b``, ``yi-6b`` and
    ``granite-moe-3b-a800m`` at full width, each in ``Engine(4, 1024)``
    serving 4 requests of 64-605 tokens, 8 new tokens each, with a launch
    in every prefill layer.  (c) The kernel at every shape those
    prefills launched it on, on the q, k, v recorded there (gemma3's
    layers 0, windowed, and 5, global, at each of its 8 prompt lengths;
    layer 0 of each other arch at each of its 4), within phase 10's
    tolerances, graph-replayed in turns with SDPA (``enable_gqa``; an
    explicit mask for the window) beside its bound, weighted by the
    launches at each shape, so launches x (ms - bound) sums over the path.
    (e) BST at full width (2^22 x 32 items, 16,384 categories, Zipf(1.1)
    ids): ``bst_forward`` at 512 and 262,144, user state and retrieval
    over 1,000,448 candidates, held against the host (batch 512,
    retrieval) and the bulk batch's first rows against batch 512 within
    2e-2; ms a call and peak memory.
17. Slice G, training (after phase 16), counts set to 0 just before each
    run and read just after.  (a) ``qwen3-0.6b`` at full width and depth
    (0.596 B parameters, f32 at rest, bf16 compute, remat) trained by
    ``Trainer`` for 6 steps of 8 ``TokenPipeline`` sequences of 4,096
    tokens (``train_4k``'s length; its 256-sequence batch cut to 8) in 4
    microbatches, AdamW with 2 warm-up steps, a checkpoint at step 3 in a
    temporary directory under ``build/`` and a failure at step 5 that
    restores it: every loss finite, the restored params and moments equal
    to the step-3 state bit for bit, ``flash_attention`` launched steps x
    4 x 28 x 2 times (forward and remat recompute) and nothing else, peak
    memory under 80 GB; step ms, tokens/s, checkpoint seconds, the loss
    trajectory, and one step under the profiler (busy share; flash kernel,
    GEMM and other time), with the plain attention backward and the CE
    chunks timed alone at the step's shapes.  (b) Its gradient at 2 layers
    in f32 on one 4,096-token sequence with the kernel against the same
    step with the plain attention: loss and every gradient leaf within
    atol/rtol 1e-3, each q/k/v projection with a gradient; the bf16 step's
    relative loss gap reported.  (c) The same for ``deepseek-v2-lite-16b``
    at 1 MoE layer (MLA 192/128, a strided v, the aux loss in the loss).
    (d) BST at full width on ``RecsysPipeline`` batches of 65,536: the
    first step's loss and gradients on the card within 2e-2 of the host's
    (the loss relatively, each leaf by its relative RMS gap), then 4
    ``Trainer`` steps, no kernel launched (plain gathers).  (e) The flash
    kernel at (a)'s shape against its plain version, graph-replayed in
    turns with SDPA beside its bound, and the plain backward's time.

18. Slice H, the GNNs and the halo executor (last), counts set to 0 just
    before each part and read just after: none may launch (the GNN path
    reaches no kernel; its segment sums are ``index_add_``).  At
    ``configs/base.py``'s GNN shapes and the configs' ``_FULL`` widths:
    (a) ``equiformer-v2`` (12 layers, 128 channels, l_max 6, m_max 2, 8
    heads, f32) trained by ``Trainer`` for 4 steps on ``molecule`` (128
    seeded molecules of 30 atoms, 64 edges each, in 4,096 nodes and 8,192
    edges), one step profiled, and one layer by ``layer_apply_chunked`` at
    4 chunks against ``layer_apply`` within 1e-5; (b) ``schnet`` on
    ``molecule``, ``egnn`` on ``full_graph_sm`` and ``meshgraphnet`` (bf16
    messages) on ``minibatch_lg`` (``NeighborSampler`` blocks of 1,024
    seeds at fanouts 15 and 10 over a 233,472-vertex community graph, a
    resident 233,472 x 602 feature table on the card), 4 steps each:
    every loss finite, peak memory under 80 GB; (c) each arch at 2
    layers in f32, the first step's loss and every gradient leaf on the
    card within atol/rtol 1e-3 of the host's and each leaf's relative RMS
    gap within 1e-5, and ``equiformer-v2``'s outputs under a random
    rotation of the positions within 2e-5; (d) phase 14's R-MAT graph in 8
    ``balanced_bfs_partition`` shards, ``build_halo_program``, and 3
    layers of ``run_message_passing`` at d = 100 in halo and allgather
    mode on ``mesh_devices(8)``, each within 1e-4 of the dense message
    passing on the card, the halo wire bytes equal to ``exchange_stats``'
    x 8; ``plan_gnn_halo``'s resolve fractions at 4 budgets.

19. Slice I, the production mesh (last).  (a) The dry run
    (``repro_torch.launch.dryrun``) of one cell a family on the
    single-pod ``(16, 16)`` mesh, in this process as rank 0 of a ``fake``
    process group of 256 ranks with a CUDA mesh, the state and inputs
    fake DTensors: ``qwen3-0.6b/train_4k``, ``deepseek-v2-lite-16b/
    prefill_32k`` (MLA, MoE), ``gemma3-27b/decode_32k``,
    ``schnet/full_graph_sm`` and ``bst/train_batch``.  Each record must be
    complete, with a collective census; prints state GiB a device, FLOPs a
    device against ``model_flops / 256``, and collective counts and wire
    bytes by kind.  (b) A real one-rank mesh: an NCCL process group of one
    rank, a ``(1, 1)`` ``("data", "model")`` mesh on the card, and one
    training step of ``qwen3-0.6b`` at full width and depth on phase 17's
    batch (8 sequences of 4,096 tokens in 4 microbatches) with the params,
    the AdamW state and the batch as DTensors under ``param_partition``
    and the step under ``use_mesh``, counts set to 0 just before and read
    just after: ``flash_attention`` launched 4 x 28 x 2 times through the
    registered op; the loss, every gradient leaf and every updated param
    held to the same step on plain tensors bit for bit (one rank computes
    what the plain step does, op for op; on a difference the phase fails,
    printing the relative RMS gaps beside ``BF16_TRAIN_GAP``).
    (c) Rank 0 of the production mesh on the card: a fake group of 256
    ranks, a ``(16, 16)`` CUDA mesh, and ``qwen3-0.6b/train_4k``'s step on
    rank 0's real local shards (16 sequences of 4,096 tokens); the fake
    collectives write nothing, so it yields the step's wall time, its
    device-busy share and ``max_memory_allocated`` beside (a)'s state and
    argument bytes for the cell.  (d) The roofline's two measured
    constants: a cuBLAS bf16 GEMM of 8192^3 (a yardstick, no port of a
    kernel) and a device-to-device copy of 4 GiB.
20. The ragged route expansion (right after phase 7): the kernel against
    its plain version on the card on ``RAGGED_SWEEP`` (reads of 0, 1,
    31-33, 256-257, 25,824, 25,825 and 40,000 items, 31 DCs, all ties, no
    layer, 2,000 short reads, 64 long ones), then on a recorded drain of
    256 reads of ``snb3s-nbr-over`` (seed ``RAGGED_SEED``) holding its
    longest read (26,182 items), one launch an origin's sub-batch:
    every output equal (picks, layers, missing counts, the int64 byte sums,
    served-DC masks and unresolved counts), the sums equal the router's
    host f64 fold, over the store's route tables, and
    ``route_online_batch`` on the card over the tables (folding on the
    card) request-identical to the numpy router; the store's
    ``serve_batch`` of the drain launches the kernel once a sub-batch over
    the item gate.  Prints each launch's graph-replayed time beside its
    bound, and numpy against fused routing over the tables, timed in turns,
    of one-origin sub-batches of 2 to 64 reads drawn as the cell draws them
    and of short reads up to 65,536 items (the item gate's crossover,
    reported, not applied).

Kernel times (``ms``, and ``library_ms`` for the PyTorch calls beside them)
come from CUDA-graph replay: 20 launches captured in one graph, replayed
between two CUDA events, so the host's launch rate does not set them; the
old host-loop figure stands beside each as ``host_loop_ms``, and
``launch_floor_ms`` is the replayed time of a launch that does no work.
``flash_attention`` and SDPA are replayed in turns within one call.

Prints the kernel table as one JSON line, the card's name and power limit,
and as the last line ``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import gc
import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
DHD_TOL = dict(atol=1e-5, rtol=1e-4)
BATCHES = (64, 256, 1024)
# (rate, batches): bench_streaming's churn rate, then a trickle of single
# edits whose touched frontier stays under the pre-solve's 20% gate
CHURN = ((0.01, 2), (2e-5, 2))
# the kernels slice A's path (build, serve, maintain) launches
MAIN_KERNELS = ("dhd_count", "dhd_flow", "route_expand_ragged")
SINGLE_KERNELS = ("dhd_count_single", "dhd_flow_single")
DEVICE = "cuda"  # the card every phase runs on
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak, NVIDIA data sheet
# LM serving: the repo's MLA + MoE arch at full width, its engine's slots
LM_ARCH = "deepseek-v2-lite-16b"
LM_SLOTS, LM_MAX_LEN, LM_REQUESTS, LM_NEW = 4, 1024, 8, 16
ATTN_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# phase 10's sweep: name, B, Hq, Hkv, Sq, Skv, Dqk, Dv, causal, window, v transposed
ATTN_SWEEP = (
    ("GQA 8/2", 1, 8, 2, 256, 256, 64, 64, True, None, False),
    ("window 128", 1, 4, 4, 605, 605, 128, 128, True, 128, False),
    ("suffix-aligned Sq < Skv", 1, 4, 4, 100, 300, 64, 64, True, None, False),
    ("one query of 1,024 keys", 1, 4, 4, 1, 1024, 192, 128, True, None, True),
    ("causal Sq > Skv", 1, 4, 4, 300, 100, 64, 64, True, None, False),
    ("not causal", 1, 4, 4, 200, 150, 64, 64, False, None, False),
    ("widths 24/16", 1, 4, 4, 128, 128, 24, 16, True, None, False),
    ("widths 64/64", 1, 4, 4, 128, 128, 64, 64, True, None, False),
    ("widths 128/128", 1, 4, 4, 128, 128, 128, 128, True, None, False),
    ("widths 256/256", 1, 4, 4, 128, 128, 256, 256, True, None, False),
    ("widths 64/256", 1, 4, 4, 128, 128, 64, 256, True, None, False),
    ("widths 192/128", 1, 4, 4, 128, 128, 192, 128, True, None, False),
    ("length 1", 1, 16, 16, 1, 1, 192, 128, True, None, True),
    ("length 63", 1, 16, 16, 63, 63, 192, 128, True, None, True),
    ("length 65", 1, 16, 16, 65, 65, 192, 128, True, None, True),
    ("length 605", 1, 16, 16, 605, 605, 192, 128, True, None, True),
    ("length 1,024", 1, 16, 16, 1024, 1024, 192, 128, True, None, True),
    ("window 128, length 1,024", 1, 16, 16, 1024, 1024, 192, 128, True, 128, True),
    ("batch 2, GQA 4/2", 2, 4, 2, 130, 130, 64, 64, True, None, False),
)
E2E_TOL = dict(atol=1e-3, rtol=1e-3)
# BST's item table (configs/bst.py) and the serving batches of RECSYS_SHAPES
BAG_V, BAG_D, BAG_L = 1 << 22, 32, 20
BAG_BATCHES = (512, 262_144)
BAG_TOL = dict(atol=1e-4, rtol=1e-4)
# phase 16, slice F2: gemma3-27b (GQA, 5 local : 1 global) at full width,
# 8 prompts of which four outrun the 1,024-token window
GQA_ARCH = "gemma3-27b"
GQA_SLOTS, GQA_MAX_LEN, GQA_NEW = 4, 2048, 16
GQA_PROMPTS = (1900, 96, 1300, 605, 1025, 350, 1717, 777)
GQA_E2E_LAYERS, GQA_E2E_TOKENS = 6, 1300
# the other GQA archs, each in its own engine
GQA_OTHERS = ("qwen3-0.6b", "yi-6b", "granite-moe-3b-a800m")
GQA_OTHER_SLOTS, GQA_OTHER_MAX_LEN, GQA_OTHER_NEW = 4, 1024, 8
GQA_OTHER_PROMPTS = (605, 64, 389, 235)
# BST at RECSYS_SHAPES' serving batches and retrieval candidates (pad_to 512)
BST_BATCHES = (512, 262_144)
BST_CANDIDATES = 1_000_448
BST_TOL = dict(atol=2e-2, rtol=2e-2)
# phase 17, slice G: training.  qwen3-0.6b at full width and depth on
# train_4k's sequence length (configs/base.py:87); its global batch of 256
# sequences cut to 8 (32,768 tokens a step), accumulated in 4 microbatches
TRAIN_ARCH = "qwen3-0.6b"
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICROBATCH = 4096, 8, 4
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 6, 3, 5
TRAIN_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS)
GRAD_TOL = E2E_TOL  # the LM gate, on the loss and every gradient leaf in f32
# beside it, each leaf's relative RMS gap (its difference's RMS over its
# RMS), in f32 and in the bf16 step; set about 15x and 6x over the worst
# leaves read on an H100 (6.8e-7, MLA's wq; 3.3e-3, qwen3's embedding)
GRAD_REL_RMS, BF16_TRAIN_GAP = 1e-5, 2e-2
GRAD_LAYERS, MLA_ARCH, MLA_GRAD_LAYERS = 2, "deepseek-v2-lite-16b", 1
CARD_BYTES = 80e9  # H100 SXM device memory
# BST at full width on RECSYS_SHAPES' train_batch (configs/base.py:140)
BST_TRAIN_BATCH, BST_TRAIN_STEPS = 65_536, 4
BST_GRAD_GAP = 2e-2  # phase 16 (e)'s gate, on the loss and each leaf's relative RMS gap


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def gpu_query(fields: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def gpu_line() -> str:
    return gpu_query("name,power.limit")


def host_loop_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Mean time of ``fn`` in ms over ``iters`` calls issued by Python
    between two CUDA events.  Where one call takes the host longer to issue
    than the card to run, this reads the host's launch interval."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _capture(fn, warmup: int, iters: int):
    """``iters`` calls of ``fn`` in one CUDA graph, after ``warmup`` calls
    on a side stream.  ``fn`` must read the current stream when it
    launches, so that its launches land on the capturing stream."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def _replay_ms(graph, iters: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms_in_turns(fns, warmup: int = 3, iters: int = 20, reps: int = 7) -> list:
    """Device time in ms of one call of each of ``fns``: each function's
    ``iters`` calls are captured in one CUDA graph, the graphs are replayed
    in turns ``reps`` times between two events each, and each time is the
    median replay over ``iters``.  The host issues one replay for
    ``iters`` launches, so its launch rate does not set the figure."""
    import numpy as np

    graphs = [_capture(fn, warmup, iters) for fn in fns]
    times = [[] for _ in fns]
    for _ in range(reps):
        for graph, t in zip(graphs, times):
            t.append(_replay_ms(graph, iters))
    del graphs
    return [float(np.median(t)) for t in times]


def cuda_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Device time in ms of one call of ``fn``, by CUDA-graph replay."""
    return cuda_ms_in_turns([fn], warmup, iters)[0]


def kernel_ms(fn) -> dict:
    """A kernel launch's graph-replayed time (``ms``) and the old host-loop
    figure beside it (``host_loop_ms``)."""
    return {"ms": cuda_ms(fn), "host_loop_ms": host_loop_ms(fn)}


def launch_floor_ms() -> float:
    """Graph-replayed time of a launch that does no work: the batched count
    kernel on a 1-row graph with one pad slot."""
    import torch

    from repro_torch.kernels.cuda_lib import library, stream_ptr

    lib = library().get()
    heat = torch.zeros((1, 1), device=DEVICE)
    cols = torch.zeros((1, 1), dtype=torch.int32, device=DEVICE)
    vals = torch.zeros((1, 1), device=DEVICE)
    nout = torch.empty_like(heat)
    return cuda_ms(lambda: lib.dhd_count_batch(
        heat.data_ptr(), cols.data_ptr(), vals.data_ptr(), nout.data_ptr(), 1, 1, 1, 0,
        stream_ptr(heat.device)))


def request_stream(store, n: int, seed: int):
    """Sampled pattern requests with a 65% home / 35% remote origin mix."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pats = [p for p in store.workload.patterns if len(p.items)]
    reqs = []
    for _ in range(n):
        p = pats[int(rng.integers(0, len(pats)))]
        home = int(np.argmax(p.r_py))
        origin = home if rng.random() < 0.65 else int(rng.integers(0, store.env.n_dcs))
        reqs.append((p.items, origin))
    return reqs


def same_results(got, want) -> bool:
    import numpy as np

    return len(got) == len(want) and all(
        np.array_equal(x.served_by, y.served_by)
        and x.latency_s == y.latency_s
        and x.per_dc_latency == y.per_dc_latency
        for x, y in zip(got, want)
    )


def launch_counts() -> dict:
    """Every kernel's launch count so far, by name."""
    from repro_torch.kernels.cuda_lib import launch_counters

    return {k: c.n for k, c in launch_counters().items()}


def build_inputs():
    from repro_torch.core.graph import build_csr
    from repro_torch.core.latency import make_paper_env
    from repro_torch.core.patterns import Workload, generate_khop_patterns
    from repro_torch.data.synthetic import community_graph

    g = community_graph(26_000, n_communities=20, p_in=0.02, p_out=0.0005, seed=0, n_dcs=5)
    env = make_paper_env()
    csr = build_csr(g.n_nodes, g.src, g.dst, symmetrize=True)
    pats = generate_khop_patterns(
        g, csr, 160, hops=5, branch=2, seed=1, n_dcs=env.n_dcs, n_hot_sources=64
    )
    return g, env, Workload.from_patterns(pats, g.n_items, env.n_dcs)


class DHDRecorder:
    """Keeps the inputs of the main path's DHD steps, one call per kind.

    Installed over ``kernels.ops.dhd_ell_step_batch`` (the name
    ``diffuse_batch`` calls) for the main path's run, it passes every call
    on unchanged and keeps, for each (phase, fields, shared or per-field
    vals), the tensors of its ``KEEP_AT``-th call, or of its last when the
    loop is shorter.  The step loop never writes into its inputs, so
    references suffice.

    ``KEEP_AT`` is 8 because the placement arenas' fields diverge, in the
    JAX package as here: their super-node weights (graph-edge counts, up to
    636 on this store) break Theorem 1's bound, the heat grows about 300x a
    step and overflows f32 after about 17 of its 32 steps.  A check of 4
    chained steps from call 8 stays finite."""

    KEEP_AT = 8
    ATTR = "dhd_ell_step_batch"

    def __init__(self, ops) -> None:
        self.ops = ops
        self.step = getattr(ops, self.ATTR)
        self.phase = "build"
        self.calls: dict = {}
        self.kept: dict = {}
        self.by_shape: dict = {}  # (phase, [B,] n, kmax, per-field vals) -> calls

    def key(self, heat, cols, vals) -> tuple:
        return (self.phase, int(heat.shape[0]), vals.dim() == 3)

    def keep(self, heat, cols, vals, q) -> tuple:
        return heat, cols, vals, q

    def __call__(self, heat, cols, vals, q, alpha=0.5, gamma=0.1, beta=0.3):
        key = self.key(heat, cols, vals)
        n = self.calls[key] = self.calls.get(key, 0) + 1
        shape = (self.phase, *heat.shape, int(cols.shape[1]), vals.dim() == 3)
        self.by_shape[shape] = self.by_shape.get(shape, 0) + 1
        if n <= self.KEEP_AT:
            self.kept[key] = (*self.keep(heat, cols, vals, q), (alpha, gamma, beta))
        return self.step(heat, cols, vals, q, alpha=alpha, gamma=gamma, beta=beta)

    def __enter__(self) -> "DHDRecorder":
        setattr(self.ops, self.ATTR, self)
        return self

    def __exit__(self, *exc) -> None:
        setattr(self.ops, self.ATTR, self.step)


class SweepRecorder(DHDRecorder):
    """The same over ``kernels.ops.dhd_ell_step`` (one heat field: the warm
    DHD sweeps of ``store``'s ``StreamingHeat``), keyed by (phase, global
    or pre-solve sweep, rows): a global sweep runs over the field's own
    device adjacency, a pre-solve sweep over a sub-ELL of the frontier.  It
    keeps copies of ``cols`` and ``vals``: a later batch patches the
    field's device adjacency in place (``index_copy_``)."""

    ATTR = "dhd_ell_step"

    def __init__(self, ops, store) -> None:
        super().__init__(ops)
        self.store = store

    def key(self, heat, cols, vals) -> tuple:
        sweep = "global" if cols is self.store._heat._cols_j else "pre-solve"
        return (self.phase, sweep, int(heat.shape[0]))

    def __call__(self, heat, cols, vals, q, alpha=0.5, gamma=0.1, beta=0.3):
        if heat.device.type != self.store.device.type:  # the host mirror's sweeps
            return self.step(heat, cols, vals, q, alpha=alpha, gamma=gamma, beta=beta)
        return super().__call__(heat, cols, vals, q, alpha=alpha, gamma=gamma, beta=beta)

    def keep(self, heat, cols, vals, q) -> tuple:
        return heat, cols.clone(), vals.clone(), q


def main_path(report: dict):
    """Phase 3: build, serve and maintain on the card, with the DHD steps'
    inputs recorded; returns the store, the inputs, the built replica sets,
    the launch counts and the recorder."""
    from repro_torch.kernels import ops

    inputs = build_inputs()
    with DHDRecorder(ops) as rec, RouteRecorder(ops) as route:
        rec.routes = {}  # batch size -> the inputs of its launch (ids over tables)
        return (*_drive_main_path(report, inputs, rec, route), rec)


def gated_launch(label: str, reqs, launched: int) -> bool:
    """Whether the router's item gate sends ``reqs`` (one routing call) to
    the card; fails the run unless ``launched`` says the same."""
    from repro_torch.core.routing import FUSED_MIN_ITEMS as gate

    items = sum(len(it) for it, _ in reqs)
    want = int(len(reqs) > 1 and items >= gate)
    if launched != want:
        fail(f"{label}: {launched} ragged launches for {len(reqs)} reads of {items} items, "
             f"the item gate of {gate} says {want}")
    return bool(want)


def _drive_main_path(report: dict, inputs, rec: DHDRecorder, route: "RouteRecorder"):
    import numpy as np
    import torch

    from repro_torch.core.placement import PlacementConfig
    from repro_torch.core.routing import route_online_batch
    from repro_torch.core.store import GeoGraphStore
    from repro_torch.kernels.cuda_lib import reset_launch_counters

    counts = launch_counts
    g, env, wl = inputs
    reset_launch_counters()
    t0 = time.perf_counter()
    store = GeoGraphStore(g, env, wl, config=PlacementConfig(), device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    built_delta = store.state.delta.copy()  # maintain() evicts from it later
    launches = {"build": counts()}
    print(f"store: {store.g.n_items} items, {store.lg.n_layers} layers, "
          f"built on the card in {build_s:.3f} s", flush=True)
    serve = []
    for bs in BATCHES:
        reqs = request_stream(store, bs, seed=bs)
        before = counts()
        got = store.serve_batch(reqs, observe=False)
        launches[f"serve_{bs}"] = {k: v - before[k] for k, v in counts().items()}
        if gated_launch(f"serve_batch({bs})", reqs,
                        launches[f"serve_{bs}"]["route_expand_ragged"]):
            rec.routes[bs] = route.last
        want = route_online_batch(store.lg, store.state, reqs, fast=False)
        if not same_results(got, want):
            fail(f"serve_batch({bs}) on the card differs from the numpy router")
        times, numpy_times = [], []
        for _ in range(5):
            t = time.perf_counter()
            store.serve_batch(reqs, observe=False)
            times.append(time.perf_counter() - t)
            t = time.perf_counter()
            route_online_batch(store.lg, store.state, reqs, fast=False)
            numpy_times.append(time.perf_counter() - t)
        med = float(np.median(times))
        med_np = float(np.median(numpy_times))
        store.serve_batch(reqs, observe=True)  # deposit the batch's heat once
        items = int(sum(len(it) for it, _ in reqs))
        serve.append({"batch": bs, "items": items, "median_s": med, "rps": bs / med,
                      "times_s": times, "numpy_median_s": med_np,
                      "numpy_rps": bs / med_np})
        print(f"serve_batch({bs}): {items} items, median {med * 1e3:.3f} ms, "
              f"{bs / med:.1f} routed requests/s, identical to the numpy router "
              f"(numpy router alone: {med_np * 1e3:.3f} ms, {bs / med_np:.1f}/s)",
              flush=True)
    before = counts()
    rec.phase = "maintain"
    t = time.perf_counter()
    m = store.maintain()
    torch.cuda.synchronize()
    maintain_s = time.perf_counter() - t
    launches["maintain"] = {k: v - before[k] for k, v in counts().items()}
    total = counts()
    print(f"maintain: evicted {m['evicted']} replicas in {maintain_s:.3f} s", flush=True)
    print(f"launches on the main path: {total} (per phase: {launches})", flush=True)
    by_shape = {", ".join(map(str, k)): v for k, v in sorted(rec.by_shape.items())}
    print(f"batched DHD steps (one count + one flow launch each) by phase, B, n, kmax, "
          f"per-field vals: {by_shape}", flush=True)
    for name in MAIN_KERNELS:
        if total[name] <= 0:
            fail(f"kernel {name} was not launched on the main path")
    report["main_path"] = {
        "n_items": int(store.g.n_items), "n_layers": int(store.lg.n_layers),
        "build_s": build_s, "serve": serve, "maintain_s": maintain_s,
        "evicted": int(m["evicted"]), "launches": total, "launches_by_phase": launches,
        "dhd_steps_by_shape": by_shape,
    }
    return store, inputs, built_delta, total


def profiled(fn, reps: int = 1, host: dict = None):
    """``(wall ms, device busy ms, device ms by kernel or copy, fn's last
    result)`` per call of ``fn`` over ``reps`` calls under the profiler;
    ``host``, when given, receives the 8 host ops of most self CPU ms.

    Only the profiler's device events count: a kernel launched by an aten
    op also appears as that CPU op's self device time, and summing both
    would count it twice."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / reps
    busy_us = 0.0
    by_kind = {}
    events = prof.key_averages()
    if host is not None:
        cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
        for e in sorted(cpu, key=lambda e: -e.self_cpu_time_total)[:8]:
            host[e.key[:60]] = {"self_cpu_ms": e.self_cpu_time_total / reps / 1e3,
                                "calls": e.count // reps}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.self_device_time_total
        if us:
            busy_us += us
            # kernels whose names share 60 characters (cuBLAS tile variants) add up
            by_kind[e.key[:60]] = by_kind.get(e.key[:60], 0.0) + us / reps / 1e3
    return wall_ms, busy_us / reps / 1e3, by_kind, out


def device_busy(store, report: dict) -> None:
    """Device time per call of serve_batch(1024) and maintain(), from the
    profiler's CUDA events (kernels and copies), beside the host clock."""
    import torch

    reqs = request_stream(store, BATCHES[-1], seed=BATCHES[-1])
    out = {}
    for name, fn, reps in (
        ("serve_batch_1024", lambda: store.serve_batch(reqs, observe=False), 5),
        ("maintain_no_evict", lambda: store.maintain(evict=False), 2),
    ):
        fn()
        torch.cuda.synchronize()
        wall_ms, busy_ms, by_kind, _ = profiled(fn, reps)
        out[name] = {"device_ms": busy_ms, "wall_ms_profiled": wall_ms,
                     "device_share": busy_ms / wall_ms, "by_kind_ms": by_kind}
        print(f"{name}: device busy {busy_ms:.4f} ms of {wall_ms:.3f} ms "
              f"(profiled wall), share {busy_ms / wall_ms:.4f}; "
              + ", ".join(f"{k.strip()} {v:.4f}" for k, v in by_kind.items()), flush=True)
    report["device_busy"] = out


def rand_route_problem(rng, R, k_lo, k_hi, D, L, p_rep=0.35, all_ties=False,
                       single_origin=False, empty_layers=False, pin_max=False,
                       empty_rows=False):
    """A random packed batch; ``pin_max`` makes row 0 ``k_hi`` long (so K is
    exactly ``k_hi``), ``empty_rows`` gives every third row no items."""
    import numpy as np

    lens = rng.integers(k_lo, k_hi + 1, R)
    if pin_max:
        lens[0] = k_hi
    if empty_rows:
        lens[1::3] = 0
    K = int(lens.max())
    bits = np.zeros((R, K), np.int32)
    sizes = np.zeros((R, K), np.float32)
    pow2 = 1 << np.arange(D, dtype=np.int64)
    for r in range(R):
        k = int(lens[r])
        rep = np.ones((k, D), bool) if all_ties else rng.random((k, D)) < p_rep
        bits[r, :k] = (rep * pow2).sum(axis=1)
        sizes[r, :k] = (rng.random(k) + 0.25).astype(np.float32)
    origin = np.zeros(R, np.int64) if single_origin else rng.integers(0, D, R)
    comp = np.zeros((L + 1, D), np.int64)
    comp[0] = np.arange(D)
    prev = np.arange(D)
    for layer in range(1, L + 1):
        if empty_layers and layer == 1:
            comp[layer] = prev
            continue
        groups = max(1, D // (layer + 1))
        prev = rng.integers(0, groups, int(prev.max()) + 1)[prev]
        comp[layer] = prev
    return (bits, sizes, lens.astype(np.int32), origin.astype(np.int32),
            comp.astype(np.int32))


SWEEP_FLAGS = ("all_ties", "single_origin", "empty_layers", "pin_max", "empty_rows")
SWEEP = [
    # R, k_lo, k_hi, D, L, p_rep, then SWEEP_FLAGS (False where left out)
    (8, 1, 24, 5, 3, 0.35, False, False, False),
    (16, 2, 40, 4, 1, 0.5, False, False, False),
    (8, 1, 16, 8, 5, 0.2, False, False, False),
    (8, 4, 20, 5, 3, 0.0, True, False, False),
    (8, 1, 24, 5, 3, 0.35, False, True, False),
    (8, 1, 24, 6, 4, 0.3, False, False, True),
    (4, 1, 8, 5, 2, 0.05, False, False, False),
    (4, 496, 500, 5, 3, 0.35, False, False, False),
    (4, 596, 600, 5, 3, 0.35, False, False, False),
    (256, 1, 160, 31, 4, 0.1, False, False, False),  # 31 DCs: every mask bit
    # reads around a warp's 32 lanes, its share of 256 slots, and past 1,024
    (16, 1, 32, 5, 3, 0.35, False, False, False, True),
    (16, 1, 33, 5, 3, 0.35, False, False, False, True),
    (16, 1, 64, 5, 3, 0.35, False, False, False, True),
    (16, 1, 65, 5, 3, 0.35, False, False, False, True),
    (16, 1, 128, 6, 4, 0.3, False, False, False, True),
    (16, 1, 129, 6, 4, 0.3, False, False, False, True),
    (64, 1, 256, 5, 3, 0.35, False, False, False, True),
    (64, 1, 257, 5, 3, 0.35, False, False, False, True),
    (64, 200, 256, 31, 4, 0.1, False, False, False, True),
    (64, 200, 257, 31, 4, 0.1, False, False, False, True),
    (8, 1000, 1100, 5, 3, 0.35, False, False, False, True),  # past 1,024 slots
    (8, 256, 256, 5, 3, 0.0, True, False, False, True),  # all ties, a warp's share
    # reads with no items, with every read a warp's and with some a block's
    (24, 1, 40, 5, 3, 0.35, False, False, False, True, True),
    (24, 1, 300, 5, 3, 0.35, False, False, False, True, True),
]


def flat_of_tiles(prob):
    """A padded ``(bits, sizes, lens, origin, comp)`` batch as the flat item
    stream the ragged kernel takes, ``(bits, sizes, offsets, origin,
    comp)``."""
    import numpy as np

    bits, sizes, lens, origin, comp = prob
    keep = np.arange(bits.shape[1])[None, :] < lens[:, None]
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    return bits[keep], sizes[keep], offsets, origin, comp


def check_dhd(name, heat, cols, vals, q, params, timed: bool = True) -> dict:
    """Count and flow kernels vs their plain versions on the card, one
    step from the same input at a time over 4 chained steps; ``params`` is
    the step's ``(alpha, gamma, beta)``.  Counts must be equal, flows
    within ``DHD_TOL``."""
    import torch

    from repro_torch.kernels.cuda_lib import library, stream_ptr
    from repro_torch.kernels.dhd_spmv import dhd_ell_step_batch
    from repro_torch.kernels.ref import (
        dhd_ell_count_ref,
        dhd_ell_flow_ref,
        dhd_ell_ref_batch,
    )

    lib = library().get()
    B, n = heat.shape
    kmax = cols.shape[1]
    per_field = int(vals.dim() == 3)
    alpha, gamma, beta = (float(x) for x in params)
    p = dict(alpha=alpha, gamma=gamma, beta=beta)
    nout = torch.empty_like(heat)
    out = torch.empty_like(heat)

    # the two C entry points straight, so each kernel is checked and timed
    # on its own (these launches are outside the main path's counts); the
    # stream is read at launch, so a graph capture takes the launches
    def count(h):
        lib.dhd_count_batch(h.data_ptr(), cols.data_ptr(), vals.data_ptr(),
                            nout.data_ptr(), B, n, kmax, per_field, stream_ptr(h.device))

    def flow(h):
        lib.dhd_flow_batch(h.data_ptr(), nout.data_ptr(), cols.data_ptr(),
                           vals.data_ptr(), q.data_ptr(), out.data_ptr(), B, n, kmax,
                           per_field, alpha, 1.0 - gamma, beta, stream_ptr(h.device))

    err_count = err_flow = 0.0
    for _ in range(4):
        count(heat)
        want_n = dhd_ell_count_ref(heat, cols, vals)
        flow(heat)
        want = dhd_ell_flow_ref(heat, want_n, cols, vals, q, **p)
        step = dhd_ell_step_batch(heat, cols, vals, q, **p)
        full = dhd_ell_ref_batch(heat, cols, vals, q, **p)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(want).all()):
            fail(f"dhd {name}: the plain version overflowed; check an earlier step")
        if not torch.equal(nout, want_n):
            fail(f"dhd count kernel {name}: |N_out| differs from the plain version")
        for got in (out, step):
            if not torch.allclose(got, want, **DHD_TOL):
                fail(f"dhd flow kernel {name}: outside atol 1e-5 / rtol 1e-4")
        if not torch.allclose(step, full, **DHD_TOL):
            fail(f"dhd step {name}: outside atol 1e-5 / rtol 1e-4")
        err_count = max(err_count, float((nout - want_n).abs().max()))
        err_flow = max(err_flow, float((out - want).abs().max()))
        heat = want  # next step from the plain version's field
    row = {"case": name, "shape": [B, n, kmax], "per_field_vals": bool(per_field),
           "count": {"max_abs_err": err_count}, "flow": {"max_abs_err": err_flow}}
    if not timed:
        return row
    count(heat)
    vbytes = vals.numel() * 4
    cbytes = cols.numel() * 4
    field = B * n * 4
    count_bytes = field + cbytes + vbytes + field
    flow_bytes = 3 * field + cbytes + vbytes + field
    # what the passes gather: h[b, c] of every live slot and field (both
    # passes), nout[b, c] where heat flows in (the flow pass); how far a
    # live slot's column lies from its row
    live = (vals > 0).expand(B, n, kmax)
    inflow = live & (heat[:, cols.long()] > heat[:, :, None])
    rows = torch.arange(n, device=cols.device)[:, None]
    dist = (cols.long() - rows).abs()[(vals[0] if per_field else vals) > 0]
    row.update({
        "count_gathers": int(live.sum()),
        "flow_gathers": int(live.sum()) + int(inflow.sum()),
        "median_col_distance": float(dist.float().median()) if dist.numel() else 0.0,
    })
    row["count"].update(
        **kernel_ms(lambda: count(heat)),
        plain_ms=host_loop_ms(lambda: dhd_ell_count_ref(heat, cols, vals)),
        bytes=count_bytes, bound_ms=count_bytes / HBM_BYTES_PER_S * 1e3)
    row["flow"].update(
        **kernel_ms(lambda: flow(heat)),
        plain_ms=host_loop_ms(lambda: dhd_ell_flow_ref(heat, nout, cols, vals, q, **p)),
        bytes=flow_bytes, bound_ms=flow_bytes / HBM_BYTES_PER_S * 1e3)
    return row


def tie_problem(gen, B: int, n: int, kmax: int, per_field: bool, single: bool = False):
    """Seeded DHD inputs on the card where the new designs branch: heat on
    4 levels (h_u == h_c is frequent, so both strict masks are exercised),
    about 45% pad slots (weight 0, column = the row), every 17th row pad
    slots only, per-field vals with their own zero patterns."""
    import torch

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=DEVICE)

    rows = torch.arange(n, device=DEVICE, dtype=torch.int32)[:, None]
    cols = torch.randint(0, n, (n, kmax), generator=gen, device=DEVICE, dtype=torch.int32)
    pad = rand(n, kmax) < 0.45
    pad[::17] = True
    cols = torch.where(pad, rows, cols)
    shape = (B, n, kmax) if per_field else (n, kmax)
    vals = (rand(*shape) + 0.05) * ~pad
    if per_field:
        vals *= rand(*shape) < 0.8  # edges switched off per field
    heat = torch.floor(rand(B, n) * 4) / 4
    q = rand(B, n) * 0.1
    if single:
        return heat[0].contiguous(), cols, vals, q[0].contiguous()
    return heat, cols, vals, q


# the new designs' branches: B with FB 1 and 5 and none up to 5 (7), per-field
# vals in groups of 3 (6 fields); kmax 71 (3 sweeps of a warp), 80, 150 (past
# one sweep), 37 (not a multiple of 4); a prime n, which no block size
# divides, and rows fewer than the SMs
DHD_SWEEP = (
    # B, n, kmax, per-field vals
    (1, 10_007, 71, False),
    (5, 10_007, 80, False),
    (7, 10_007, 150, False),
    (6, 10_007, 37, True),
    (5, 10_007, 71, True),
    (1, 10_007, 150, True),
    (5, 3, 37, False),
)
# the single-field flow pass's instances: 8, 16 and 32 lanes a row, 16-byte
# loads (kmax % 4 == 0, aligned) or scalar ones, one sweep or two (kmax 400)
DHD_SINGLE_SWEEP = (
    # n, kmax, base 16-byte aligned
    (10_007, 80, True),
    (10_007, 80, False),
    (10_007, 71, True),
    (10_007, 150, True),
    (10_007, 37, True),
    (10_007, 32, True),
    (10_007, 400, True),
    (3, 80, True),
)


def ptxas_of(report: dict, prefix: str) -> str:
    return "; ".join(f"{k}: {v.get('registers')} registers, spill bytes {v.get('spill_bytes')}"
                     for k, v in sorted(report["ptxas"].items()) if k.startswith(prefix))


def dhd_sweep(report: dict) -> None:
    """Phase 4's sweep: the batched count and flow kernels against their
    plain versions on every ``DHD_SWEEP`` case (tie-heavy heat, pad rows)."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(5)
    rows = []
    for B, n, kmax, per_field in DHD_SWEEP:
        name = f"sweep: {B} fields, n {n}, kmax {kmax}, {'per-field' if per_field else 'shared'} vals"
        rows.append(check_dhd(name, *tie_problem(gen, B, n, kmax, per_field),
                              (0.5, 0.1, 0.3), timed=False))
    report["dhd_sweep"] = rows
    print(f"dhd sweep: {len(rows)} cases (B 1/5/7/6, kmax 71/80/150/37, n 10,007 and 3, "
          f"tie-heavy heat, pad rows): counts equal, flows within atol 1e-5 / rtol 1e-4, "
          f"max abs err {max(r['flow']['max_abs_err'] for r in rows):.3g}", flush=True)
    print(f"  ptxas: {ptxas_of(report, 'dhd_count_kernel')}", flush=True)


def kernel_checks(store, rec: DHDRecorder, report: dict) -> dict:
    """Phase 4; returns the kernel table rows by name.  The DHD kernels are
    checked on the inputs the main path gave them (``rec``)."""
    import numpy as np
    import torch

    routes = []
    for bs, prob in sorted(rec.routes.items()):
        routes.append(check_ragged(f"store batch {bs}", prob, timed=True))
        r = routes[-1]
        print(f"route_expand_ragged {r['case']}: {r['reads']} reads, {r['items']} items, D "
              f"{r['D']}, L {r['L']}: exact, max abs err {r['max_abs_err']:.3g}, kernel "
              f"{r['ms']:.4f} ms (host loop {r['host_loop_ms']:.4f}, through the wrapper "
              f"{r['wrapper_ms']:.4f}), plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.5f} ms", flush=True)
    n_store = len(routes)
    for i, case in enumerate(SWEEP):
        rng = np.random.default_rng(1000 + i)
        prob = rand_route_problem(rng, *case[:6], **dict(zip(SWEEP_FLAGS, case[6:])))
        routes.append(check_ragged(f"sweep {case}", flat_of_tiles(prob), timed=False))
    sweep = routes[n_store:]
    print(f"route_expand_ragged: {len(SWEEP)} sweep cases exact (31 DCs, longest reads "
          f"{sorted({r['longest'] for r in sweep})}, reads with no items)", flush=True)
    print(f"  ptxas: {ptxas_of(report, 'route_expand_ragged')}", flush=True)

    if not any(per_field for _, _, per_field in rec.kept):
        fail("the main path ran no DHD step with per-field vals (placement arena)")
    if ("maintain", 5, False) not in rec.kept:
        fail("maintain() ran no DHD step over the 5 per-DC heat fields")
    dhds = []
    for key in sorted(rec.kept, key=lambda k: (k[0] != "maintain", k)):
        phase, B, per_field = key
        heat, cols, vals, q, params = rec.kept[key]
        name = (f"{phase}, call {min(rec.calls[key], rec.KEEP_AT)} of "
                f"{rec.calls[key]}: {B} field(s), "
                f"{'per-field' if per_field else 'shared'} vals")
        d = check_dhd(name, heat, cols, vals, q, params)
        dhds.append(d)
        c, f = d["count"], d["flow"]
        print(f"dhd {name} {d['shape']}: count kernel {c['ms']:.4f} ms (host loop "
              f"{c['host_loop_ms']:.4f}, plain {c['plain_ms']:.4f}, bound {c['bound_ms']:.5f}), "
              f"flow kernel {f['ms']:.4f} ms (host loop {f['host_loop_ms']:.4f}, plain "
              f"{f['plain_ms']:.4f}, bound {f['bound_ms']:.5f}), max abs err "
              f"{f['max_abs_err']:.3g}; gathers count {d['count_gathers']}, flow "
              f"{d['flow_gathers']}, median |col - row| {d['median_col_distance']:.0f}",
              flush=True)
    # shapes the lane's recorded steps do not have: B with no divisor up to
    # 5 (one field a block), per-field vals in groups of 3, kmax past 96
    # (the flow kernel's slot loop)
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    for B, n, kmax, per_field in ((7, 3000, 150, False), (6, 2000, 40, True)):
        shape = (B, n, kmax) if per_field else (n, kmax)
        vals = torch.rand(shape, generator=gen, device=DEVICE)
        vals *= torch.rand(shape, generator=gen, device=DEVICE) < 0.6
        cols = torch.randint(0, n, (n, kmax), generator=gen, device=DEVICE, dtype=torch.int32)
        heat, q = (torch.rand((B, n), generator=gen, device=DEVICE) for _ in range(2))
        name = (f"synthetic: {B} fields, {'per-field' if per_field else 'shared'} vals, "
                f"kmax {kmax}")
        d = check_dhd(name, heat, cols, vals, q, (0.5, 0.1, 0.3))
        dhds.append(d)
        print(f"dhd {name} {d['shape']}: count and flow within atol 1e-5 / rtol 1e-4, count "
              f"kernel {d['count']['ms']:.4f} ms, flow kernel {d['flow']['ms']:.4f} ms",
              flush=True)
    dhd_sweep(report)
    report["route_expand_checks"] = routes
    report["dhd_checks"] = dhds
    return {"route": routes[n_store - 1], "dhd": dhds[0]}


def streaming_phase(store, report: dict):
    """Phase 5; returns the streaming launch counts and the sweep recorder."""
    from repro_torch.kernels import ops

    with SweepRecorder(ops, store) as rec:
        return _drive_streaming(store, report, rec), rec


def _drive_streaming(store, report: dict, rec: SweepRecorder) -> dict:
    import numpy as np
    import torch

    from repro_torch.convert import store_arrays, store_from_numpy
    from repro_torch.core.routing import route_online_batch
    from repro_torch.kernels.cuda_lib import reset_launch_counters
    from repro_torch.obs import Tracer
    from repro_torch.streaming import DeltaGraph, random_churn_batch

    counts = launch_counts

    def since(before):
        return {k: v - before[k] for k, v in counts().items() if v - before[k]}

    t = time.perf_counter()
    mirror = store_from_numpy(store_arrays(store), device="cpu")
    print(f"streaming: CPU mirror of the store built in "
          f"{time.perf_counter() - t:.3f} s", flush=True)
    store.tracer = Tracer(enabled=True)  # spans split apply_updates' host work
    store._delta_graph = DeltaGraph(store.g)
    mirror._delta_graph = DeltaGraph(mirror.g)
    rng = np.random.default_rng(7)
    ints = ("n_add_vertices", "n_del_vertices", "n_add_edges", "n_del_edges",
            "n_touched_vertices", "compacted")
    warm_ints = ("frontier_size", "halo_size", "local_iters", "global_iters")
    out: dict = {"batches": []}
    reset_launch_counters()
    for rate, n_batches in CHURN:
        for i in range(n_batches):
            rec.phase = f"apply {rate:g}"
            batch = random_churn_batch(store._delta_graph, rate, rng)
            before = counts()
            store.tracer.reset()
            if i == n_batches - 1:  # the warm batch of each rate, profiled
                wall_ms, busy_ms, by_kind, r = profiled(lambda: store.apply_updates(batch))
                wall_s, prof = wall_ms / 1e3, {"wall_ms": wall_ms, "device_ms": busy_ms,
                                               "device_share": busy_ms / wall_ms,
                                               "by_kind_ms": by_kind}
            else:
                t = time.perf_counter()
                r = store.apply_updates(batch)
                torch.cuda.synchronize()
                wall_s, prof = time.perf_counter() - t, None
            launches = since(before)
            spans = {sp.name: sp.dur_s for sp in store.tracer.records}
            t = time.perf_counter()
            m = mirror.apply_updates(batch)
            mirror_s = time.perf_counter() - t
            if [getattr(r, f) for f in ints] != [getattr(m, f) for f in ints]:
                fail(f"apply_updates({rate:g}) report differs from the CPU mirror's")
            if [getattr(r.heat, f) for f in warm_ints[:2]] != [
                getattr(m.heat, f) for f in warm_ints[:2]
            ]:
                fail(f"apply_updates({rate:g}): warm-DHD frontier differs from the mirror's")
            if not (np.array_equal(store.state.delta, mirror.state.delta)
                    and np.array_equal(store.route_index.nearest, mirror.route_index.nearest)):
                fail(f"apply_updates({rate:g}): replica sets or routes differ from the mirror's")
            heat_err = float(np.abs(store._heat.heat - mirror._heat.heat).max())
            if not np.allclose(store._heat.heat, mirror._heat.heat, **DHD_TOL):
                fail(f"apply_updates({rate:g}): heat outside atol 1e-5 / rtol 1e-4 of the "
                     f"mirror's (max abs err {heat_err:.3g})")
            row = {
                "rate": rate, "n_ops": int(batch.n_ops), "apply_s": wall_s,
                "mirror_apply_s": mirror_s, "spans_s": spans, "profiled": prof,
                "report": {f: int(getattr(r, f)) for f in ints},
                "warm": {f: int(getattr(r.heat, f)) for f in warm_ints},
                "mirror_warm": {f: int(getattr(m.heat, f)) for f in warm_ints},
                "residual": r.heat_residual, "heat_max_abs_err": heat_err,
                "n_rows": int(store._heat.cols.shape[0]),
                "kmax": int(store._heat.cols.shape[1]), "launches": launches,
            }
            out["batches"].append(row)
            w = row["warm"]
            print(f"apply_updates(rate {rate:g}, {batch.n_ops} ops): "
                  f"{wall_s:.3f} s{' (profiled)' if prof else ''}, mirror {mirror_s:.3f} s; "
                  f"touched {r.n_touched_vertices}, frontier {w['frontier_size']}, "
                  f"halo {w['halo_size']}, local iters {w['local_iters']}, global iters "
                  f"{w['global_iters']} (mirror {row['mirror_warm']['global_iters']}), "
                  f"residual {r.heat_residual:.3g}, heat max abs err {heat_err:.3g}; "
                  f"ELL {row['n_rows']} x {row['kmax']}; launches {launches}; spans "
                  + ", ".join(f"{k} {v:.3f}" for k, v in spans.items()), flush=True)
            if prof:
                print(f"  device busy {busy_ms:.4f} ms of {wall_ms:.3f} ms, share "
                      f"{busy_ms / wall_ms:.5f}; "
                      + ", ".join(f"{k.strip()} {v:.4f}" for k, v in by_kind.items()),
                      flush=True)
    if not any(b["warm"]["local_iters"] > 0 for b in out["batches"]):
        fail("no streaming batch took the frontier pre-solve")

    rec.phase = "flush"
    before = counts()
    t = time.perf_counter()
    plan = store.flush_migrations()
    flush_s = time.perf_counter() - t
    flush_launches = since(before)
    t = time.perf_counter()
    mplan = mirror.flush_migrations()
    mirror_flush_s = time.perf_counter() - t
    moves = {(x.item, x.dc, x.kind) for x in plan.moves}
    mmoves = {(x.item, x.dc, x.kind) for x in mplan.moves}
    rows = int((store.state.delta != mirror.state.delta).any(axis=1).sum())
    out["flush"] = {"moves": len(plan.moves), "adds": plan.n_adds,
                    "waves": plan.schedule.n_waves, "flush_s": flush_s,
                    "mirror_flush_s": mirror_flush_s, "moves_differing": len(moves ^ mmoves),
                    "delta_rows_differing": rows, "launches": flush_launches}
    print(f"flush_migrations: {len(plan.moves)} moves ({plan.n_adds} adds) in "
          f"{plan.schedule.n_waves} waves, {flush_s:.3f} s (mirror {mirror_flush_s:.3f} s); "
          f"{len(moves ^ mmoves)} moves and {rows} state.delta rows differ from the "
          f"mirror's; launches {flush_launches}", flush=True)

    for phase, fn in (("maintain", store.maintain), ("compact", store.compact)):
        rec.phase = phase
        before = counts()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out[phase] = {"s": time.perf_counter() - t, "launches": since(before),
                      "result": res}
        print(f"{phase}: {res} in {out[phase]['s']:.3f} s, launches "
              f"{out[phase]['launches']}", flush=True)
    if store._heat.n_nodes != store.g.n_nodes or store.tombstone_ratio() != 0.0:
        fail("compact() left tombstones or a stale heat field")

    reqs = request_stream(store, BATCHES[-1], seed=BATCHES[-1])
    got = store.serve_batch(reqs, observe=False)
    want = route_online_batch(store.lg, store.state, reqs, fast=False)
    if not same_results(got, want):
        fail("serve_batch(1024) after churn differs from the numpy router")
    times = []
    for _ in range(5):
        t = time.perf_counter()
        store.serve_batch(reqs, observe=False)
        times.append(time.perf_counter() - t)
    med = float(np.median(times))
    out["serve_1024"] = {"median_s": med, "rps": BATCHES[-1] / med, "times_s": times,
                         "n_items": int(store.g.n_items)}
    total = counts()
    out["launches"] = total
    print(f"serve_batch(1024) after churn, flush and compaction ({store.g.n_items} "
          f"items): identical to the numpy router, median {med * 1e3:.3f} ms, "
          f"{BATCHES[-1] / med:.1f} routed requests/s", flush=True)
    print(f"launches on the streaming path: {total}", flush=True)
    by_shape = {", ".join(map(str, k)): v for k, v in sorted(rec.by_shape.items())}
    out["dhd_steps_by_shape"] = by_shape
    print(f"single-field DHD steps (one count + one flow launch each) by phase, n, kmax: "
          f"{by_shape}", flush=True)
    differ = [i for i, b in enumerate(out["batches"]) if b["warm"] != b["mirror_warm"]]
    out["warm_stats_differing"] = differ
    print(f"warm-DHD stats (frontier, halo, local and global iterations) differ from the "
          f"mirror's in {len(differ)} of {len(out['batches'])} batches"
          + (": " + "; ".join(f"batch {i + 1}: {out['batches'][i]['warm']} vs mirror "
                              f"{out['batches'][i]['mirror_warm']}" for i in differ)
             if differ else ""), flush=True)
    for name in SINGLE_KERNELS:
        if total[name] <= 0:
            fail(f"kernel {name} was not launched on the streaming path")
    report["streaming"] = out
    return total


def check_dhd_single(name, heat, cols, vals, q, params, timed: bool = True) -> dict:
    """The single-field count and flow kernels vs their plain versions on
    the card, over 4 chained steps from a recorded sweep input."""
    import torch

    from repro_torch.kernels.cuda_lib import library, stream_ptr
    from repro_torch.kernels.dhd_spmv import dhd_ell_step
    from repro_torch.kernels.ref import dhd_ell_count_ref, dhd_ell_flow_ref, dhd_ell_ref

    lib = library().get()
    n, kmax = cols.shape
    alpha, gamma, beta = (float(x) for x in params)
    p = dict(alpha=alpha, gamma=gamma, beta=beta)
    nout = torch.empty_like(heat)
    out = torch.empty_like(heat)

    def count(h):
        lib.dhd_count_single(h.data_ptr(), cols.data_ptr(), vals.data_ptr(),
                             nout.data_ptr(), n, kmax, stream_ptr(h.device))

    def flow(h):
        lib.dhd_flow_single(h.data_ptr(), nout.data_ptr(), cols.data_ptr(),
                            vals.data_ptr(), q.data_ptr(), out.data_ptr(), n, kmax,
                            alpha, 1.0 - gamma, beta, stream_ptr(h.device))

    def count_ref(h):
        return dhd_ell_count_ref(h[None], cols, vals)[0]

    def flow_ref(h, n_out):
        return dhd_ell_flow_ref(h[None], n_out[None], cols, vals, q[None], **p)[0]

    err_count = err_flow = 0.0
    for _ in range(4):
        count(heat)
        want_n = count_ref(heat)
        flow(heat)
        want = flow_ref(heat, want_n)
        step = dhd_ell_step(heat, cols, vals, q, **p)
        full = dhd_ell_ref(heat, cols, vals, q, **p)
        torch.cuda.synchronize()
        if not torch.equal(nout, want_n):
            fail(f"dhd_count_single {name}: |N_out| differs from the plain version")
        for got in (out, step):
            if not torch.allclose(got, want, **DHD_TOL):
                fail(f"dhd_flow_single {name}: outside atol 1e-5 / rtol 1e-4")
        if not torch.allclose(step, full, **DHD_TOL):
            fail(f"dhd_ell_step {name}: outside atol 1e-5 / rtol 1e-4")
        err_count = max(err_count, float((nout - want_n).abs().max()))
        err_flow = max(err_flow, float((out - want).abs().max()))
        heat = want
    row = {"case": name, "shape": [n, kmax], "count": {"max_abs_err": err_count},
           "flow": {"max_abs_err": err_flow}}
    if not timed:
        return row
    count(heat)
    ell = cols.numel() * 4 + vals.numel() * 4
    count_bytes = ell + 2 * n * 4  # heat in, |N_out| out
    flow_bytes = ell + 4 * n * 4  # heat, |N_out|, q in, heat out
    live = vals > 0
    inflow = live & (heat[cols.long()] > heat[:, None])
    row.update(count_gathers=int(live.sum()), flow_gathers=int(live.sum()) + int(inflow.sum()))
    row["count"].update(
        **kernel_ms(lambda: count(heat)), plain_ms=host_loop_ms(lambda: count_ref(heat)),
        bytes=count_bytes, bound_ms=count_bytes / HBM_BYTES_PER_S * 1e3)
    row["flow"].update(
        **kernel_ms(lambda: flow(heat)), plain_ms=host_loop_ms(lambda: flow_ref(heat, nout)),
        bytes=flow_bytes, bound_ms=flow_bytes / HBM_BYTES_PER_S * 1e3)
    return row


def dhd_single_sweep(report: dict) -> None:
    """Phase 6's sweep: the single-field kernels against their plain
    versions on every ``DHD_SINGLE_SWEEP`` case (tie-heavy heat, pad rows;
    a base that is not 16-byte aligned takes the scalar loads)."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(6)
    rows = []
    for n, kmax, aligned in DHD_SINGLE_SWEEP:
        heat, cols, vals, q = tie_problem(gen, 1, n, kmax, False, single=True)
        if not aligned:  # the same values one element past an aligned base
            cols = torch.empty(n * kmax + 1, dtype=cols.dtype, device=DEVICE)[1:].view(
                n, kmax).copy_(cols)
            vals = torch.empty(n * kmax + 1, device=DEVICE)[1:].view(n, kmax).copy_(vals)
        name = f"sweep: n {n}, kmax {kmax}{'' if aligned else ', base not 16-byte aligned'}"
        rows.append(check_dhd_single(name, heat, cols, vals, q, (0.5, 0.1, 0.3), timed=False))
    report["dhd_single_sweep"] = rows
    print(f"dhd single sweep: {len(rows)} cases (kmax 80/71/150/37/32/400, n 10,007 and 3, "
          f"a misaligned base, tie-heavy heat, pad rows): counts equal, flows within atol "
          f"1e-5 / rtol 1e-4, max abs err {max(r['flow']['max_abs_err'] for r in rows):.3g}",
          flush=True)
    print(f"  ptxas: {ptxas_of(report, 'dhd_flow_single_kernel')}", flush=True)


def streaming_kernel_checks(rec: SweepRecorder, report: dict) -> dict:
    """Phase 6; returns the single-field kernels' rows: the last recorded
    global sweep of the 0.01 batches (``"global"``) and the first pre-solve
    sweep (``"presolve"``).  Every recorded kind is checked."""
    glob = sorted(k for k in rec.kept if k[:2] == (f"apply {CHURN[0][0]:g}", "global"))
    pre = sorted(k for k in rec.kept if k[1] == "pre-solve")
    if not glob or not pre:
        fail(f"a global or a pre-solve sweep was not recorded: {sorted(rec.kept)}")
    checks, rows = [], {}
    for key in sorted(rec.kept):
        heat, cols, vals, q, params = rec.kept[key]
        name = (f"{key[0]}, {key[1]} sweep, call {min(rec.calls[key], rec.KEEP_AT)} "
                f"of {rec.calls[key]}: {key[2]} rows")
        d = check_dhd_single(name, heat, cols, vals, q, params)
        checks.append(d)
        if key == glob[-1]:
            rows["global"] = d
        if key == pre[0]:
            rows["presolve"] = d
        c, f = d["count"], d["flow"]
        print(f"dhd single {name} {d['shape']}: count kernel {c['ms']:.4f} ms (host loop "
              f"{c['host_loop_ms']:.4f}, plain {c['plain_ms']:.4f}, bound {c['bound_ms']:.5f}), "
              f"flow kernel {f['ms']:.4f} ms (host loop {f['host_loop_ms']:.4f}, plain "
              f"{f['plain_ms']:.4f}, bound {f['bound_ms']:.5f}), max abs err "
              f"{f['max_abs_err']:.3g}; gathers count {d['count_gathers']}, flow "
              f"{d['flow_gathers']}", flush=True)
    report["dhd_single_checks"] = checks
    dhd_single_sweep(report)
    return rows


def cpu_build_diff(inputs, built_delta, report: dict) -> None:
    """Phase 5: the same store built with the plain versions on the host
    (edge-form DHD), against the card's replica sets as built."""
    from repro_torch.core.placement import PlacementConfig
    from repro_torch.core.store import GeoGraphStore

    g, env, wl = inputs
    t = time.perf_counter()
    cpu = GeoGraphStore(g, env, wl, config=PlacementConfig(), device="cpu")
    cpu_s = time.perf_counter() - t
    rows = (cpu.state.delta != built_delta).any(axis=1)
    diff = int(rows.sum())
    report["cpu_build"] = {"build_s": cpu_s, "delta_rows_differing": diff,
                           "replicas_card": int(built_delta.sum()),
                           "replicas_cpu": int(cpu.state.delta.sum())}
    print(f"CPU build of the same store: {cpu_s:.3f} s, {diff} state.delta rows "
          f"differ from the card's build", flush=True)


# ---------------------------------------------------------------- slice F1
class AttentionRecorder:
    """Installed over ``kernels.ops.attention`` (the name every LM prefill
    calls on the card) for an LM serving run: passes every call on
    unchanged, counts the calls by (layer, window), and keeps q, k, v of
    layer 0 of each prefill (every ``n_layers``-th call) in ``kept`` and
    those of each of ``layers`` in ``kept_by_layer``, keyed by prompt
    length.  Prefill never writes into them."""

    def __init__(self, ops, n_layers: int, layers=(0,)) -> None:
        import collections

        self.ops = ops
        self.fn = ops.attention
        self.n_layers = n_layers
        self.calls = 0
        self.kept_by_layer: dict = {layer: {} for layer in layers}
        self.kept = self.kept_by_layer.setdefault(0, {})
        self.by_layer_window = collections.Counter()

    def __call__(self, q, k, v, causal=True, window=None):
        layer = self.calls % self.n_layers
        if layer in self.kept_by_layer:
            self.kept_by_layer[layer][int(q.shape[2])] = (q, k, v, causal, window)
        self.by_layer_window[(layer, window)] += 1
        self.calls += 1
        return self.fn(q, k, v, causal=causal, window=window)

    def __enter__(self) -> "AttentionRecorder":
        self.ops.attention = self
        return self

    def __exit__(self, *exc) -> None:
        self.ops.attention = self.fn


class StepTimer:
    """Installed over ``models.transformer.prefill`` and ``decode`` (the
    names the engine calls): times each call to a synchronised device and
    fails on a non-finite logit."""

    def __init__(self, tf) -> None:
        self.tf = tf
        self.prefill, self.decode = tf.prefill, tf.decode
        self.prefills: list = []
        self.decodes: list = []

    def _timed(self, fn, args, log: list, row: dict):
        import torch

        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, caches = fn(*args)
        finite = bool(torch.isfinite(logits).all())  # synchronises
        row["ms"] = (time.perf_counter() - t) * 1e3
        log.append(row)
        if not finite:
            fail(f"non-finite logits in {row}")
        return logits, caches

    def _prefill(self, params, tokens, cfg):
        return self._timed(self.prefill, (params, tokens, cfg), self.prefills,
                           {"tokens": int(tokens.shape[1])})

    def _decode(self, params, token, caches, position, cfg):
        return self._timed(self.decode, (params, token, caches, position, cfg),
                           self.decodes, {})

    def __enter__(self) -> "StepTimer":
        self.tf.prefill, self.tf.decode = self._prefill, self._decode
        return self

    def __exit__(self, *exc) -> None:
        self.tf.prefill, self.tf.decode = self.prefill, self.decode


def _leaves(tree):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


def _tree_to(tree, device):
    """A copy of nested dicts of tensors on ``device``."""
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def lm_serving_phase(report: dict) -> dict:
    """Phase 8: ``deepseek-v2-lite-16b`` at full width in bf16 (random
    weights drawn on the card from seed 0), served through ``Engine`` with
    4 slots and 1,024 positions: 8 requests of 64-700 prompt tokens, 16 new
    tokens each.  Counts set to 0 just before the engine runs, read just
    after: every prefill must take the flash-attention kernel in each
    layer.  Then one prefill and one decode step under the profiler."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch

    cfg = get_arch(LM_ARCH).cfg
    rng = np.random.default_rng(0)  # lengths, then token ids, from one stream
    lens = [int(n) for n in rng.integers(64, 701, LM_REQUESTS)]
    if not (any(n % 64 for n in lens) and any(n >= 512 for n in lens)):
        fail(f"prompt lengths {lens} miss a ragged or a >= 512-token prompt")
    run = _serve_arch(cfg, LM_SLOTS, LM_MAX_LEN, lens, LM_NEW, seed=0, rng=rng)
    out = run["report"]
    out["profiled"] = _profile_steps(run, cfg, LM_SLOTS, host=True)
    report["lm_serving"] = out
    longest = run["prompts"][int(np.argmax(lens))]
    return {"cfg": cfg, "params": run["params"], "kept": run["rec"].kept,
            "tokens": torch.as_tensor(longest[None], device=DEVICE),
            "launches": run["launches"]}


def _profile_steps(run: dict, cfg, slots: int, host: bool = False) -> dict:
    """One prefill of the longest prompt of ``run`` (:func:`_serve_arch`)
    and one decode step over its engine's caches under the profiler:
    device busy against wall time, the top device ops and, with ``host``,
    the top host ops."""
    import numpy as np
    import torch

    from repro_torch.models import transformer as tf

    params, eng = run["params"], run["engine"]
    longest = run["prompts"][int(np.argmax([len(p) for p in run["prompts"]]))]
    tok = torch.as_tensor(longest[None], device=DEVICE)
    token = torch.zeros(slots, dtype=torch.long, device=DEVICE)
    pos = torch.as_tensor(eng.pos, dtype=torch.long, device=DEVICE)
    prof = {}
    with torch.inference_mode():
        for name, fn in (("prefill", lambda: tf.prefill(params, tok, cfg)),
                         ("decode", lambda: tf.decode(params, token, eng.caches, pos, cfg))):
            fn()
            host_ops: dict = {}
            wall_ms, busy_ms, by_kind, _ = profiled(fn, host=host_ops if host else None)
            top = dict(sorted(by_kind.items(), key=lambda kv: -kv[1])[:8])
            prof[name] = {"wall_ms": wall_ms, "device_ms": busy_ms,
                          "device_share": busy_ms / wall_ms, "top_ms": top}
            print(f"  {name} ({len(longest) if name == 'prefill' else slots} tokens) "
                  f"profiled: device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms, share "
                  f"{busy_ms / wall_ms:.4f}; top: "
                  + ", ".join(f"{k.strip()[:40]} {v:.3f}" for k, v in top.items()), flush=True)
            if host:
                prof[name]["host_top"] = host_ops
                print("    host ops by self CPU ms: " + ", ".join(
                    f"{k.strip()[:30]} {v['self_cpu_ms']:.2f} ({v['calls']} calls)"
                    for k, v in host_ops.items()), flush=True)
    return prof


def lm_end_to_end_check(lm: dict, report: dict) -> None:
    """Phase 9: the prefill with the kernel against the same prefill with
    ``ops.attention`` swapped for its plain version.  A 2-layer model at
    full width in f32 must agree within atol/rtol 1e-3; on the full-depth
    bf16 model the last position's logits are reported (max abs and
    relative RMS difference, top-1 agreement), not failed, beside
    controls: the same prefill with SDPA, and with the f32 kernel on
    upcast inputs, in the kernel's place, against the plain version, which
    read how far sound bf16 attentions drift apart over the full depth; and
    for each, layer 0's outputs on their recorded inputs: how many differ
    from the plain version's and their RMS distance to f64."""
    import dataclasses

    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_ref
    from repro_torch.models import transformer as tf

    def plain(q, k, v, causal=True, window=None):
        return attention_ref(q, k, v, causal=causal, window=window)

    def sdpa(q, k, v, causal=True, window=None):
        if window is not None:
            fail("the SDPA control covers no sliding window")
        return _sdpa(q, k, v, causal)

    def f32_kernel(q, k, v, causal=True, window=None):
        return flash_attention(q.float(), k.float(), v.float(), causal=causal,
                               window=window).to(q.dtype)

    def prefill_with(params, cfg, tokens, fn=None):
        """Last logits of one prefill, with ``fn`` in ``ops.attention``'s
        place when given."""
        kernel_fn = ops.attention
        ops.attention = fn or kernel_fn
        try:
            with torch.inference_mode():
                return tf.prefill(params, tokens, cfg)[0].float()
        finally:
            ops.attention = kernel_fn

    def gap(got, want) -> dict:
        diff = got - want
        rms = float(want.pow(2).mean().sqrt())
        return {"max_abs_diff": float(diff.abs().max()),
                "rel_rms_diff": float(diff.pow(2).mean().sqrt()) / rms,
                "top1_agreement": float((got.argmax(-1) == want.argmax(-1)).float().mean()),
                "logit_rms": rms}

    cfg2 = dataclasses.replace(lm["cfg"], n_layers=2, dtype=torch.float32)
    params2 = tf.init_params(cfg2, torch.Generator(device=DEVICE).manual_seed(1), DEVICE)
    got = prefill_with(params2, cfg2, lm["tokens"])
    want = prefill_with(params2, cfg2, lm["tokens"], plain)
    del params2
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, **E2E_TOL))
    print(f"end to end, 2 layers at full width in f32, {lm['tokens'].shape[1]}-token prefill: "
          f"last logits max abs diff kernel vs plain {err:.3g} "
          f"({'within' if ok else 'OUTSIDE'} atol/rtol 1e-3)", flush=True)
    if not ok:
        fail("the f32 2-layer prefill with the flash kernel differs from the plain version")
    want = prefill_with(lm["params"], lm["cfg"], lm["tokens"], plain)
    # layer 0's attention alone, on its recorded inputs: how many bf16
    # outputs differ from the plain version's, and the RMS distance to the
    # same attention in f64 (the plain version's own is bf16 rounding)
    q, k, v, causal, window = lm["kept"][max(lm["kept"])]
    exact = attention_ref(q.double(), k.double(), v.double(), causal=causal, window=window)
    base = plain(q, k, v, causal, window).float()
    rows = {}
    for name, fn in (("kernel", flash_attention), ("control, SDPA", sdpa),
                     ("control, f32 kernel", f32_kernel), ("plain", plain)):
        o = fn(q, k, v, causal=causal, window=window).float()
        g = gap(prefill_with(lm["params"], lm["cfg"], lm["tokens"], fn), want)
        g.update(layer0_outputs_differing=int((o != base).sum()), layer0_outputs=o.numel(),
                 layer0_rms_vs_f64=float((o.double() - exact).pow(2).mean().sqrt()))
        rows[name] = g
        print(f"end to end, full depth in bf16, {name} vs plain: last logits max abs diff "
              f"{g['max_abs_diff']:.4g}, relative RMS diff {g['rel_rms_diff']:.4g} "
              f"(logit RMS {g['logit_rms']:.4g}), top-1 agreement {g['top1_agreement']:.3f}; "
              f"layer 0: {g['layer0_outputs_differing']} of {o.numel()} outputs differ from "
              f"the plain version's, RMS vs f64 {g['layer0_rms_vs_f64']:.4g}", flush=True)
    report["lm_end_to_end"] = {"f32_2_layers": {"max_abs_diff": err, "ok": ok},
                               "bf16_full_depth": rows}


def attention_bound(q, k, v, causal: bool, window) -> tuple:
    """``(bound ms, bound_by, flops, bytes)`` of one attention call: the
    unmasked q.k pairs times 2 (Dqk + Dv) flops at the bf16 dense peak
    against q, k, v read and the output written once at 3.35 TB/s."""
    B, Hq, Sq, dqk = q.shape
    Skv, dv = k.shape[2], v.shape[3]
    pairs = 0
    for i in range(Sq):
        pos = i + Skv - Sq
        hi = min(Skv, pos + 1) if causal else Skv
        lo = max(0, pos - window + 1) if window is not None else 0
        pairs += max(0, hi - lo)
    flops = 2 * B * Hq * pairs * (dqk + dv)
    size = q.element_size()
    nbytes = (q.numel() + k.numel() + v.numel() + B * Hq * Sq * dv) * size
    t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes"), flops, nbytes


def hold_to_plain(label: str, q, k, v, causal: bool, window) -> dict:
    """The flash kernel against its plain version on recorded bf16 inputs
    and on the same inputs cast to f32, each within ``ATTN_TOL``; returns
    the max abs errors."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_ref

    errs = {}
    for dtype, cast in (("bfloat16", lambda x: x), ("float32", lambda x: x.float())):
        qc, kc, vc = cast(q), cast(k), cast(v)
        got = flash_attention(qc, kc, vc, causal=causal, window=window)
        want = attention_ref(qc, kc, vc, causal=causal, window=window)
        torch.cuda.synchronize()
        tol = ATTN_TOL[dtype]
        err = float((got.float() - want.float()).abs().max())
        if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
            fail(f"flash_attention {label} in {dtype}: max abs err {err:.3g} outside {tol}")
        errs[f"max_abs_err_{dtype}"] = err
    return errs


def flash_launch(q, k, v, causal: bool, window):
    """A function that launches the bf16 flash kernel through its C entry
    point on q, k, v into an output it holds, on the stream current when
    it is called (so a graph capture takes it)."""
    import torch

    from repro_torch.kernels.cuda_lib import library, stream_ptr

    lib = library().get()
    out = torch.empty((q.shape[0], q.shape[1], q.shape[2], v.shape[3]), dtype=q.dtype,
                      device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), q.shape[0],
            q.shape[1], k.shape[1], q.shape[2], k.shape[2], q.shape[3], v.shape[3],
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(q.shape[3] ** -0.5), int(causal), int(window is not None),
            int(window or 0), 1)

    def launch():
        lib.flash_attention_fwd(*args, stream_ptr(q.device))

    launch.out = out  # keeps the output referenced while the launch lives
    return launch


def _sdpa(q, k, v, causal: bool):
    import torch.nn.functional as F

    gqa = {"enable_gqa": True} if q.shape[1] != k.shape[1] else {}
    return F.scaled_dot_product_attention(q, k, v, is_causal=causal, **gqa)


def attention_kernel_checks(lm: dict, report: dict) -> dict:
    """Phase 10: the flash kernel against its plain version on the card on
    layer 0's q, k, v of the longest and the shortest prompt, in bf16
    (2e-2) and cast to f32 (2e-5).  On layer 0's inputs of every prompt
    length, the kernel (its C entry point) and SDPA graph-replayed in
    turns beside the bound; the plain version and the host-loop figures at
    the longest and the shortest.  Returns the kernel table row (longest
    prompt, bf16)."""
    import torch
    from torch.nn.attention import SDPBackend

    from repro_torch.kernels.ref import attention_ref

    kept = lm["kept"]
    if len(kept) != LM_REQUESTS:
        fail(f"recorded layer-0 attention inputs of {len(kept)} prefills, want {LM_REQUESTS}")
    checks, by_length, err_bf16 = [], [], 0.0
    for S in sorted(kept, reverse=True):
        q, k, v, causal, window = kept[S]
        launch = flash_launch(q, k, v, causal, window)

        def sdpa():
            _sdpa(q, k, v, causal)

        bound_ms, bound_by, flops, nbytes = attention_bound(q, k, v, causal, window)
        # each a graph of 20 calls, replayed in turns: medians of 9 replays
        ms, sdpa_ms = cuda_ms_in_turns([launch, sdpa], reps=9)
        by_length.append({"tokens": S, "ms": ms, "sdpa_ms": sdpa_ms, "bound_ms": bound_ms})
        if S not in (max(kept), min(kept)):
            continue
        row = {"tokens": S, "shape": {"q": list(q.shape), "k": list(k.shape),
                                      "v": list(v.shape)},
               **hold_to_plain(f"at {S} tokens", q, k, v, causal, window)}
        err_bf16 = max(err_bf16, row["max_abs_err_bfloat16"])
        backend = SDPBackend(torch._fused_sdp_choice(q, k, v, is_causal=causal)).name
        row.update(
            ms=ms, host_loop_ms=host_loop_ms(launch),
            plain_ms=host_loop_ms(lambda: attention_ref(q, k, v, causal=causal)),
            sdpa_ms=sdpa_ms, sdpa_host_loop_ms=host_loop_ms(sdpa), sdpa_backend=backend,
            flops=flops, bytes=nbytes, bound_ms=bound_ms, bound_by=bound_by,
        )
        checks.append(row)
        print(f"flash_attention layer 0 at {S} tokens q {tuple(q.shape)} v {tuple(v.shape)} "
              f"bf16: max abs err {row['max_abs_err_bfloat16']:.3g} (f32 "
              f"{row['max_abs_err_float32']:.3g}); kernel {ms:.4f} ms, SDPA ({backend}) "
              f"{sdpa_ms:.4f} ms in turns (host loop: kernel {row['host_loop_ms']:.4f}, SDPA "
              f"{row['sdpa_host_loop_ms']:.4f}), plain {row['plain_ms']:.4f} ms; bound "
              f"{bound_ms:.5f} ms by {bound_by} ({flops / 1e9:.3f} GFLOP, "
              f"{nbytes / 1e6:.2f} MB)", flush=True)
    # launches x (time - bound) at every prefill's own shape
    print("flash_attention by prompt length, graph-replayed in turns with SDPA (tokens: "
          "kernel / SDPA / bound ms): " + ", ".join(
              f"{r['tokens']}: {r['ms']:.4f} / {r['sdpa_ms']:.4f} / {r['bound_ms']:.5f}"
              for r in by_length[::-1]), flush=True)
    report["flash_attention_checks"] = checks
    report["flash_attention_by_length"] = by_length
    top = checks[0]
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:29",
            "launches": lm["launches"]["flash_attention"], "max_abs_err": err_bf16,
            "ms": top["ms"], "host_loop_ms": top["host_loop_ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["sdpa_ms"]}


def attention_sweep(report: dict) -> None:
    """Phase 10's sweep: the flash kernel against its plain version on
    seeded inputs of every ``ATTN_SWEEP`` case, in bf16 (2e-2) and f32
    (2e-5).  Query rows that see no key must come out exactly 0, and a bf16
    view whose rows the kernel cannot copy in 16-byte pieces must raise
    before a launch."""
    import torch

    from repro_torch.kernels.flash_attention import LAUNCHES, flash_attention
    from repro_torch.kernels.ref import attention_ref

    gen = torch.Generator(device=DEVICE).manual_seed(3)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE)

    rows = []
    for name, B, Hq, Hkv, Sq, Skv, dqk, dv, causal, window, v_t in ATTN_SWEEP:
        q, k = randn(B, Hq, Sq, dqk), randn(B, Hkv, Skv, dqk)
        v = randn(B, Skv, Hkv, dv).transpose(1, 2) if v_t else randn(B, Hkv, Skv, dv)
        row = {"case": name, "shape": [B, Hq, Hkv, Sq, Skv, dqk, dv], "causal": causal,
               "window": window, "v_transposed": v_t}
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            qc, kc, vc = q.to(dt), k.to(dt), v.to(dt)
            got = flash_attention(qc, kc, vc, causal=causal, window=window)
            want = attention_ref(qc, kc, vc, causal=causal, window=window)
            torch.cuda.synchronize()
            tol = ATTN_TOL[dtype]
            err = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
            if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
                fail(f"flash_attention sweep '{name}' in {dtype}: max abs err {err:.3g} "
                     f"outside {tol}")
            if causal and Sq > Skv and got[:, :, : Sq - Skv].any():
                fail(f"flash_attention sweep '{name}' in {dtype}: a fully masked row is not 0")
            row[f"max_abs_err_{dtype}"] = err
        rows.append(row)
    before = LAUNCHES.n
    base = torch.zeros((1, 2, 64, 25), dtype=torch.bfloat16, device=DEVICE)
    try:
        flash_attention(base[..., :24], base[..., :24], base[..., :24])
    except ValueError:
        pass
    else:
        fail("flash_attention took a bf16 view with a 25-element row stride")
    if LAUNCHES.n != before:
        fail("flash_attention launched on a view it refused")
    print(f"flash_attention sweep: {len(rows)} cases within {ATTN_TOL['bfloat16']} (bf16) and "
          f"{ATTN_TOL['float32']} (f32), max abs err bf16 "
          f"{max(r['max_abs_err_bfloat16'] for r in rows):.3g}, f32 "
          f"{max(r['max_abs_err_float32'] for r in rows):.3g}; fully masked rows 0; a "
          f"misaligned bf16 view raises", flush=True)
    report["flash_attention_sweep"] = rows


def _serve_arch(cfg, slots: int, max_len: int, prompt_lens, new: int, seed: int,
                layers=(0,), rng=None) -> dict:
    """One arch at full width in bf16 (random weights drawn on the card from
    ``seed``) behind ``Engine(slots, max_len)``: ``prompt_lens`` requests of
    ``new`` tokens each (token ids drawn from ``rng``, by default a new
    generator seeded with ``seed``), with the launch counts set to 0 just
    before the run and read just after.  Every request must complete with its tokens
    and finite logits, and every prefill must launch ``flash_attention``
    in each layer and nothing else.  Returns the engine, params, timings,
    launches and the recorder."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.cuda_lib import launch_counters, reset_launch_counters
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import Engine, Request, ServeConfig

    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = tf.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(seed), DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    weight_bytes = sum(x.numel() * x.element_size() for x in _leaves(params))
    rng = np.random.default_rng(seed) if rng is None else rng
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in prompt_lens]
    eng = Engine(params, cfg, ServeConfig(n_slots=slots, max_len=max_len), device=DEVICE)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=new))
    with AttentionRecorder(ops, cfg.n_layers, layers) as rec, StepTimer(tf) as timer:
        reset_launch_counters()
        t = time.perf_counter()
        done = eng.run_to_completion()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
        launches = {k: c.n for k, c in launch_counters().items() if c.n}
    peak = torch.cuda.max_memory_allocated()
    n = len(prompt_lens)
    if sorted(r.rid for r in done) != list(range(n)):
        fail(f"{cfg.name}: the engine completed {sorted(r.rid for r in done)} of {n} requests")
    if any(len(r.out_tokens) != new for r in done):
        fail(f"{cfg.name}: a request completed without its {new} new tokens")
    if launches.get("flash_attention", 0) <= 0:
        fail(f"{cfg.name}: kernel flash_attention was not launched on the GQA prefill path")
    want = cfg.n_layers * n
    if launches.get("flash_attention") != want or set(launches) != {"flash_attention"}:
        fail(f"{cfg.name}: launches {launches}, want flash_attention {want} and nothing else")
    # a local layer's window is the config's; a global layer passes none
    want_calls = {(i, w if w == cfg.sliding_window else None): n
                  for i, w in enumerate(cfg.layer_windows())}
    if dict(rec.by_layer_window) != want_calls:
        fail(f"{cfg.name}: attention calls by (layer, window) {dict(rec.by_layer_window)}, "
             f"want {want_calls}")
    dec_ms = [d["ms"] for d in timer.decodes]
    gen = n * new
    print(f"{cfg.name}: {sum(x.numel() for x in _leaves(params)) / 1e9:.3f} B parameters "
          f"({weight_bytes / 1e9:.2f} GB) drawn in {init_s:.2f} s; {n} requests, {gen} new "
          f"tokens in {wall_s:.3f} s ({gen / wall_s:.1f} tokens/s); launches {launches}; "
          f"peak memory {peak / 1e9:.2f} GB", flush=True)
    print("  prefill ms by prompt length: " + ", ".join(
        f"{p['tokens']}: {p['ms']:.2f}" for p in sorted(timer.prefills, key=lambda p: p["tokens"])),
        flush=True)
    print(f"  decode step ({slots} slots): median {float(np.median(dec_ms)):.2f} ms, min "
          f"{min(dec_ms):.2f}, max {max(dec_ms):.2f} ms over {len(dec_ms)} steps", flush=True)
    return {"params": params, "engine": eng, "prompts": prompts, "rec": rec,
            "launches": launches, "report": {
                "arch": cfg.name, "n_params": sum(x.numel() for x in _leaves(params)),
                "weight_bytes": weight_bytes, "init_s": init_s,
                "prompt_lens": list(prompt_lens), "wall_s": wall_s, "tokens_per_s": gen / wall_s,
                "prefills": timer.prefills, "decode_ms": dec_ms,
                "decode_median_ms": float(np.median(dec_ms)), "peak_memory_bytes": peak,
                "launches": launches,
                "attention_calls_windowed": sum(c for (_, w), c in rec.by_layer_window.items()
                                                if w is not None),
                "attention_calls_global": sum(c for (_, w), c in rec.by_layer_window.items()
                                              if w is None)}}


def gqa_serving(report: dict) -> tuple:
    """Phase 16 (a): ``gemma3-27b`` at full width (62 layers, GQA 32/16, a
    1,024-token window on five of every six layers, 27.0 B parameters in
    bf16) behind ``Engine(4, 2048)``: 8 requests of 96-1,900 prompt tokens,
    four past the window, 16 new tokens each.  Then one 1,900-token prefill
    and one decode step under the profiler.  Returns the recorded
    attention inputs of layers 0 and 5 at the longest prompt and the
    launches."""
    from repro_torch.configs import get_arch

    cfg = get_arch(GQA_ARCH).cfg
    if sum(n > cfg.sliding_window for n in GQA_PROMPTS) < 3:
        fail(f"prompts {GQA_PROMPTS} hold fewer than three past the window")
    run = _serve_arch(cfg, GQA_SLOTS, GQA_MAX_LEN, GQA_PROMPTS, GQA_NEW, seed=0,
                      layers=(0, 5))
    out = run["report"]
    cache_bytes = sum(c.numel() * c.element_size() for c in run["engine"].caches.values())
    floor_ms = out["weight_bytes"] / HBM_BYTES_PER_S * 1e3
    out.update(cache_bytes=cache_bytes, decode_floor_ms=floor_ms)
    print(f"  weights {out['weight_bytes'] / 1e9:.2f} GB + cache {cache_bytes / 1e9:.2f} GB; "
          f"peak {out['peak_memory_bytes'] / 1e9:.2f} GB; decode floor (weights read once at "
          f"3.35 TB/s) {floor_ms:.2f} ms against the median step {out['decode_median_ms']:.2f} "
          f"ms; attention calls windowed {out['attention_calls_windowed']}, global "
          f"{out['attention_calls_global']}", flush=True)
    out["profiled"] = _profile_steps(run, cfg, GQA_SLOTS)
    report["gqa_serving"] = out
    # layer 0 is windowed and layer 5 global; every prefill layer of one
    # kind launches at its prompt's shape
    windows = cfg.layer_windows()
    n_windowed = sum(w == cfg.sliding_window for w in windows)
    kept = []
    for layer, kind, n in ((0, "windowed", n_windowed), (5, "global", len(windows) - n_windowed)):
        kept += [{"arch": GQA_ARCH, "kind": kind, "tokens": S, "inputs": inputs,
                  "launches": n * GQA_PROMPTS.count(S)}
                 for S, inputs in sorted(run["rec"].kept_by_layer[layer].items())]
    return cfg, kept, run["launches"]["flash_attention"]


def gqa_end_to_end_check(cfg, report: dict) -> None:
    """Phase 16 (b): a 6-layer ``gemma3-27b`` at full width in f32 (5 local
    layers, 1 global; seed 1), one 1,300-token prefill with the flash
    kernel against the same prefill with ``ops.attention`` swapped for its
    plain version: last logits within atol/rtol 1e-3, and 6 launches, 5 of
    them windowed."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.cuda_lib import launch_counters, reset_launch_counters
    from repro_torch.kernels.ref import attention_ref
    from repro_torch.models import transformer as tf

    cfg6 = dataclasses.replace(cfg, n_layers=GQA_E2E_LAYERS, dtype=torch.float32)
    params = tf.init_params(cfg6, torch.Generator(device=DEVICE).manual_seed(1), DEVICE)
    tok = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size,
                                                            (1, GQA_E2E_TOKENS)), device=DEVICE)
    kernel_fn = ops.attention
    with torch.inference_mode(), AttentionRecorder(ops, GQA_E2E_LAYERS) as rec:
        reset_launch_counters()
        got = tf.prefill(params, tok, cfg6)[0].float()
        torch.cuda.synchronize()
        launches = {k: c.n for k, c in launch_counters().items() if c.n}
    ops.attention = lambda q, k, v, causal=True, window=None: attention_ref(
        q, k, v, causal=causal, window=window)
    try:
        with torch.inference_mode():
            want = tf.prefill(params, tok, cfg6)[0].float()
    finally:
        ops.attention = kernel_fn
    del params
    windowed = sum(c for (_, w), c in rec.by_layer_window.items() if w is not None)
    if launches != {"flash_attention": GQA_E2E_LAYERS} or windowed != GQA_E2E_LAYERS - 1:
        fail(f"the f32 {GQA_E2E_LAYERS}-layer prefill launched {launches} ({windowed} windowed)")
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, **E2E_TOL))
    print(f"end to end, {GQA_ARCH} {GQA_E2E_LAYERS} layers at full width in f32, "
          f"{GQA_E2E_TOKENS}-token prefill ({windowed} windowed layers): last logits max abs "
          f"diff kernel vs plain {err:.3g} ({'within' if ok else 'OUTSIDE'} atol/rtol 1e-3)",
          flush=True)
    report["gqa_end_to_end"] = {"layers": GQA_E2E_LAYERS, "tokens": GQA_E2E_TOKENS,
                                "max_abs_diff": err, "ok": ok, "launches": launches}
    if not ok:
        fail(f"the f32 {GQA_E2E_LAYERS}-layer {GQA_ARCH} prefill with the flash kernel "
             "differs from the plain version")


def gqa_other_archs(report: dict) -> tuple:
    """Phase 16 (d): ``qwen3-0.6b`` (group 2, qk-norm), ``yi-6b`` (group 8)
    and ``granite-moe-3b-a800m`` (group 3, head width 64, 48 padded experts
    of which 40 are active) at full width, each in its own
    ``Engine(4, 1024)`` serving 4 requests of 64-605 tokens, 8 new tokens
    each, released before the next.  Returns layer 0's recorded attention
    inputs at every prompt length of each (every layer launches at its
    prompt's shape) and the launches."""
    import gc

    import torch

    from repro_torch.configs import get_arch

    kept, launches, out = [], {}, {}
    for i, arch in enumerate(GQA_OTHERS):
        cfg = get_arch(arch).cfg
        run = _serve_arch(cfg, GQA_OTHER_SLOTS, GQA_OTHER_MAX_LEN, GQA_OTHER_PROMPTS,
                          GQA_OTHER_NEW, seed=10 + i)
        out[arch] = run["report"]
        kept += [{"arch": arch, "kind": "global", "tokens": S, "inputs": inputs,
                  "launches": cfg.n_layers * GQA_OTHER_PROMPTS.count(S)}
                 for S, inputs in sorted(run["rec"].kept.items())]
        launches[arch] = run["launches"]["flash_attention"]
        del run
        gc.collect()
        torch.cuda.empty_cache()
    report["gqa_other_archs"] = out
    return kept, launches


def _sdpa_window(q, k, v, window):
    """SDPA of a causal sliding-window attention, by an explicit mask
    (suffix-aligned positions, as the kernel masks)."""
    import torch
    import torch.nn.functional as F

    Sq, Skv = q.shape[2], k.shape[2]
    q_pos = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = (k_pos <= q_pos) & (k_pos > q_pos - window)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)


def gqa_kernel_checks(kept: list, launches: dict, report: dict) -> dict:
    """Phase 16 (c): the flash kernel at every shape the GQA prefills
    launched it on (gemma3's windowed and global layers at each of its 8
    prompt lengths, layer 0 of each other arch at each of its 4), on the q,
    k and v recorded there: held against its plain version in bf16 (2e-2)
    and cast to f32 (2e-5), graph-replayed in turns with
    ``scaled_dot_product_attention(..., enable_gqa=True)`` (a windowed
    layer by an explicit mask) beside its bound, and weighted by the
    launches at that shape, so launches x (ms - bound) sums over the whole
    GQA path.  Returns the kernel table's "LM GQA prefill" path."""
    from repro_torch.kernels.ref import attention_ref

    if sum(r["launches"] for r in kept) != sum(launches.values()):
        fail(f"the recorded GQA shapes cover {sum(r['launches'] for r in kept)} launches, the "
             f"path made {sum(launches.values())}")
    rows = []
    for r in kept:
        q, k, v, causal, window = r["inputs"]
        name = f"{r['arch']} {r['kind']} at {r['tokens']}"
        row = {"input": name, "arch": r["arch"], "kind": r["kind"], "tokens": r["tokens"],
               "launches": r["launches"], "shape": {"q": list(q.shape), "k": list(k.shape),
                                                    "v": list(v.shape)}, "window": window,
               **hold_to_plain(f"on {name}", q, k, v, causal, window)}
        launch = flash_launch(q, k, v, causal, window)
        sdpa = _sdpa_window(q, k, v, window) if window else (lambda: _sdpa(q, k, v, causal))
        ms, sdpa_ms = cuda_ms_in_turns([launch, sdpa], reps=9)
        bound_ms, bound_by, flops, nbytes = attention_bound(q, k, v, causal, window)
        row.update(ms=ms, sdpa_ms=sdpa_ms, bound_ms=bound_ms, bound_by=bound_by, flops=flops,
                   bytes=nbytes, gap_ms=r["launches"] * (ms - bound_ms),
                   plain_ms=host_loop_ms(lambda: attention_ref(q, k, v, causal=causal,
                                                               window=window), iters=5))
        if r is kept[0]:
            row["host_loop_ms"] = host_loop_ms(launch)
        rows.append(row)
    for r in rows:
        print(f"flash_attention on {r['input']} q {tuple(r['shape']['q'])} window "
              f"{r['window']}, {r['launches']} launches: max abs err bf16 "
              f"{r['max_abs_err_bfloat16']:.3g} (f32 {r['max_abs_err_float32']:.3g}); kernel "
              f"{r['ms']:.4f} ms, SDPA {r['sdpa_ms']:.4f} ms in turns, plain {r['plain_ms']:.4f} "
              f"ms; bound {r['bound_ms']:.5f} ms by {r['bound_by']}", flush=True)
    gap = sum(r["gap_ms"] for r in rows)
    sdpa_total = sum(r["launches"] * r["sdpa_ms"] for r in rows)
    kernel_total = sum(r["launches"] * r["ms"] for r in rows)
    print(f"flash_attention over the GQA path: {sum(r['launches'] for r in rows)} launches at "
          f"{len(rows)} shapes, kernel {kernel_total:.2f} ms, SDPA {sdpa_total:.2f} ms, "
          f"launches x (ms - bound) {gap:.2f} ms", flush=True)
    report["gqa_flash_attention_checks"] = rows
    top = rows[0]
    return {"launches": sum(launches.values()), "launches_by_arch": launches,
            "max_abs_err": max(r["max_abs_err_bfloat16"] for r in rows),
            "ms": top["ms"], "host_loop_ms": top["host_loop_ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["sdpa_ms"], "gap_ms": gap, "kernel_total_ms": kernel_total,
            "sdpa_total_ms": sdpa_total, "rows": {r["input"]: {
                k: r[k] for k in ("launches", "ms", "sdpa_ms", "bound_ms", "plain_ms")}
                for r in rows}}


def bst_phase(report: dict) -> None:
    """Phase 16 (e): BST at full width (``configs/bst.py``: 2^22 x 32 item
    table, 16,384 categories; seed 4) with Zipf(1.1) ids: ``bst_forward``
    at 512 and 262,144, then ``bst_user_state`` + ``retrieval_score`` at
    1 x 1,000,448 candidates.  Batch 512 and the retrieval are held against
    the same calls on the host (the port on the CPU), and the bulk batch's
    first 512 rows against batch 512, within 2e-2.  ms a call by CUDA
    events around 10 calls; peak memory."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models.recsys.bst import (
        bst_forward, bst_init, bst_user_state, retrieval_score,
    )

    spec = get_arch("bst").spec
    torch.cuda.reset_peak_memory_stats()
    params = bst_init(torch.Generator(device=DEVICE).manual_seed(4), spec, DEVICE)
    host_params = _tree_to(params, "cpu")
    rng = np.random.default_rng(4)
    B = max(BST_BATCHES)

    def zipf(n, shape):
        return torch.as_tensor(rng.zipf(1.1, shape) % n, dtype=torch.long)

    host = {"hist_items": zipf(spec.n_items, (B, spec.seq_len)),
            "hist_cats": zipf(spec.n_cats, (B, spec.seq_len)),
            "target_item": zipf(spec.n_items, (B,)), "target_cat": zipf(spec.n_cats, (B,))}
    cand = torch.as_tensor(rng.integers(0, spec.n_items, (1, BST_CANDIDATES)))
    batches = {n: {k: v[:n].to(DEVICE) for k, v in host.items()} for n in BST_BATCHES}
    small = min(BST_BATCHES)
    cand_dev = cand.to(DEVICE)

    def retrieve(p, batch, c):
        user = bst_user_state(p, {k: v[:1] for k, v in batch.items()}, spec)
        return retrieval_score(p, user, c)

    out = {}
    with torch.inference_mode():
        logits = {n: bst_forward(params, batches[n], spec) for n in BST_BATCHES}
        scores = retrieve(params, batches[small], cand_dev)
        torch.cuda.synchronize()
        host_logits = bst_forward(host_params, {k: v[:small] for k, v in host.items()}, spec)
        host_scores = retrieve(host_params, {k: v[:small] for k, v in host.items()}, cand)
        checks = {
            f"forward {small} vs host": (logits[small].cpu(), host_logits),
            f"forward {B} first {small} rows vs forward {small}": (logits[B][:small].cpu(),
                                                                   logits[small].cpu()),
            "retrieval vs host": (scores.cpu(), host_scores),
        }
        for name, (got, want) in checks.items():
            err = float((got - want).abs().max())
            if not (torch.isfinite(got).all() and torch.allclose(got, want, **BST_TOL)):
                fail(f"BST {name}: max abs diff {err:.3g} outside {BST_TOL}")
            out[f"max_abs_diff, {name}"] = err
        for n in BST_BATCHES:
            out[f"forward_{n}_ms"] = host_loop_ms(lambda: bst_forward(params, batches[n], spec),
                                                  warmup=2, iters=10)
        out["retrieval_ms"] = host_loop_ms(lambda: retrieve(params, batches[small], cand_dev),
                                           warmup=2, iters=10)
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    out["table_bytes"] = params["item_table"].numel() * 4
    print(f"BST at full width (item table {spec.n_items} x {spec.embed_dim}): forward "
          + ", ".join(f"{n}: {out[f'forward_{n}_ms']:.4f} ms" for n in BST_BATCHES)
          + f"; user state + retrieval over {BST_CANDIDATES} candidates "
          f"{out['retrieval_ms']:.4f} ms; peak memory {out['peak_memory_bytes'] / 1e9:.2f} GB; "
          + "; ".join(f"{k} {v:.3g}" for k, v in out.items() if k.startswith("max_abs")),
          flush=True)
    report["bst"] = out


def gqa_phase(report: dict) -> dict:
    """Phase 16, slice F2 on the card: (a) ``gemma3-27b`` served at full
    width, (b) its f32 6-layer prefill against the plain attention, (d)
    the other three GQA archs served at full width, (c) the flash kernel on
    the inputs recorded from (a) and (d), (e) BST at full width.  Returns
    the kernel table's "LM GQA prefill" path of ``flash_attention``."""
    import gc

    import torch

    t = time.perf_counter()
    cfg, kept, n_gemma = gqa_serving(report)
    gc.collect()
    torch.cuda.empty_cache()
    gqa_end_to_end_check(cfg, report)
    gc.collect()
    torch.cuda.empty_cache()
    kept_others, launches = gqa_other_archs(report)
    path = gqa_kernel_checks(kept + kept_others, {GQA_ARCH: n_gemma, **launches}, report)
    del kept
    gc.collect()
    torch.cuda.empty_cache()
    bst_phase(report)
    report["gqa_phase_s"] = time.perf_counter() - t
    print(f"phase 16 (slice F2: GQA serving, BST) wall {report['gqa_phase_s']:.1f} s", flush=True)
    return path


def _kind_of(kernel: str) -> str:
    """A device event's share of a training step: the flash kernel, a GEMM
    (cuBLAS names its H100 GEMMs nvjet, sm90_xmma or cutlass), a copy or
    fill, or another kernel (elementwise, reductions, softmax)."""
    n = kernel.lower()
    if "flash_attn" in n:
        return "flash_attention"
    if any(w in n for w in ("gemm", "nvjet", "xmma", "cutlass")):
        return "gemm"
    if "memcpy" in n or "memset" in n:
        return "copy/fill"
    return "other"


def train_lm(report: dict) -> dict:
    """Phase 17 (a): ``qwen3-0.6b`` at full width and depth (28 layers,
    GQA 16/8, width 128, qk-norm, tied 151,936-token vocabulary), f32
    params at rest and bf16 compute, remat on, trained by ``Trainer`` for 6
    steps of 8 ``TokenPipeline`` sequences of 4,096 tokens in 4
    microbatches (AdamW, lr 1e-3, 2 warm-up steps), a checkpoint at step 3
    in a temporary directory under ``build/`` (removed at the end) and a
    failure at step 5 that restores it.  Launch counts are set to 0 just
    before the run and read just after: ``flash_attention`` must launch
    steps x microbatches x 28 x 2 times (each layer's forward and its
    remat recompute) and nothing else; every loss finite; the restored
    params and moments equal to the step-3 state bit for bit; peak memory
    under the card's 80 GB.  Then one more step under the profiler, with
    layer q, k, v recorded for (e), and the plain backward's recompute and
    the CE chunks timed alone at the step's shapes."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.distributed.fault import FailureSimulator
    from repro_torch.kernels import ops
    from repro_torch.kernels.cuda_lib import launch_counters, reset_launch_counters
    from repro_torch.kernels.ref import attention_ref
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import tree_paths
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_arch(TRAIN_ARCH).cfg
    if not cfg.remat or cfg.dtype != torch.bfloat16:
        fail(f"{cfg.name}: training wants remat on and bf16 compute, got {cfg.remat}, {cfg.dtype}")
    (ROOT / "build").mkdir(exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="train_ckpt_", dir=ROOT / "build")
    out = {"arch": cfg.name, "seq": TRAIN_SEQ, "batch": TRAIN_BATCH,
           "microbatch": TRAIN_MICROBATCH, "steps": TRAIN_STEPS,
           "disk_free_gb": shutil.disk_usage(ckpt_dir).free / 1e9}
    try:
        torch.cuda.reset_peak_memory_stats()
        params = tf.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0), DEVICE,
                                at_rest=torch.float32)
        out["n_params"] = sum(p.numel() for _, p in tree_paths(params))
        if any(p.dtype != torch.float32 for _, p in tree_paths(params)):
            fail("training params are not f32 at rest")
        tcfg = TrainerConfig(total_steps=TRAIN_STEPS, ckpt_every=TRAIN_CKPT_EVERY,
                             ckpt_dir=ckpt_dir, microbatch=TRAIN_MICROBATCH,
                             opt=OptConfig(**TRAIN_OPT))
        tr = Trainer(lambda p, b: tf.train_loss(p, b, cfg), params, tcfg,
                     failure_sim=FailureSimulator([(TRAIN_FAIL_AT, 1)]), device=DEVICE)
        del params
        pipe = TokenPipeline(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=0)
        snap, restore = {}, {}

        def batches():
            """The pipeline's batches.  The draw for step index
            ``TRAIN_CKPT_EVERY`` comes after step 3 and its save: it keeps
            the trainer's state.  The draw for ``TRAIN_FAIL_AT`` comes just
            after the restore: it holds the state to the kept one."""
            for i, b in enumerate(pipe):
                now = dict(tree_paths({"params": tr.params, "opt": tr.opt_state}))
                if i == TRAIN_CKPT_EVERY:
                    snap.update((k, v.clone()) for k, v in now.items())
                elif i == TRAIN_FAIL_AT:
                    restore["leaves"] = len(now)
                    restore["differing"] = sorted(
                        k for k in set(snap) | set(now)
                        if k not in snap or k not in now or now[k].dtype != snap[k].dtype
                        or not torch.equal(now[k], snap[k]))
                    snap.clear()
                del now
                yield b

        reset_launch_counters()
        t = time.perf_counter()
        metrics = tr.run(batches())
        torch.cuda.synchronize()
        out["run_s"] = time.perf_counter() - t
        launches = {k: c.n for k, c in launch_counters().items() if c.n}
        peak = torch.cuda.max_memory_allocated()
        snap.clear()
        saves = []  # each checkpoint's write seconds, from its manifest
        for step in tr.ckpt.all_steps():
            with open(pathlib.Path(ckpt_dir) / f"step_{step:08d}" / "MANIFEST.json") as f:
                saves.append({"step": step, "write_s": json.load(f)["save_s"]})
        losses = metrics["loss"]
        steps_run = len(losses)
        want = steps_run * TRAIN_MICROBATCH * cfg.n_layers * 2
        rec = metrics.get("recoveries", [])
        if steps_run != TRAIN_STEPS or not all(np.isfinite(losses)):
            fail(f"{cfg.name} training: {steps_run} steps, losses {losses}")
        if launches != {"flash_attention": want}:
            fail(f"{cfg.name} training launched {launches}, want flash_attention {want} "
                 f"({steps_run} steps x {TRAIN_MICROBATCH} microbatches x {cfg.n_layers} "
                 "layers x 2) and nothing else")
        if len(rec) != 1 or rec[0]["restored_step"] != TRAIN_CKPT_EVERY:
            fail(f"{cfg.name} training: recoveries {rec}, want one from step {TRAIN_CKPT_EVERY}")
        n_leaves = len(list(tree_paths({"params": tr.params, "opt": tr.opt_state})))
        if restore.get("differing") != [] or restore.get("leaves") != n_leaves:
            fail(f"{cfg.name} training: after the restore {restore.get('differing')} differ "
                 f"from the step-{TRAIN_CKPT_EVERY} checkpoint")
        if peak >= CARD_BYTES:
            fail(f"{cfg.name} training: peak memory {peak / 1e9:.2f} GB")
        step_ms = [x * 1e3 for x in metrics["step_time"]]
        med = float(np.median(step_ms))
        out.update(losses=losses, step_ms=step_ms, step_median_ms=med,
                   tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / med * 1e3, launches=launches,
                   peak_memory_bytes=peak, saves=saves, restore_s=rec[0]["restore_s"],
                   restored_leaves=restore["leaves"], recoveries=rec)
        print(f"{cfg.name} training: {out['n_params'] / 1e9:.3f} B parameters (f32 at rest, bf16 "
              f"compute, remat), {TRAIN_BATCH} x {TRAIN_SEQ} tokens a step in "
              f"{TRAIN_MICROBATCH} microbatches: step median {med:.1f} ms "
              f"({out['tokens_per_s']:.0f} tokens/s; steps "
              + ", ".join(f"{x:.0f}" for x in step_ms) + " ms); loss "
              + " -> ".join(f"{x:.4f}" for x in losses)
              + f"; launches {launches} (= {steps_run} x {TRAIN_MICROBATCH} x {cfg.n_layers} x 2)"
              f"; peak memory {peak / 1e9:.2f} GB; run {out['run_s']:.1f} s", flush=True)
        print("  checkpoints (params + mu + nu, write seconds from each manifest): "
              + ", ".join(f"step {x['step']} {x['write_s']:.2f} s" for x in saves)
              + f" (step {TRAIN_CKPT_EVERY} async, step {TRAIN_STEPS} blocking); restore at "
              f"step {TRAIN_FAIL_AT} {rec[0]['restore_s']:.2f} s, {restore['leaves']} "
              f"leaves equal to the step-{TRAIN_CKPT_EVERY} state bit for bit; disk free "
              f"{out['disk_free_gb']:.0f} GB", flush=True)

        # one more step under the profiler, layer inputs recorded for (e)
        batch = {k: torch.as_tensor(v, device=DEVICE)
                 for k, v in pipe.batch_at(TRAIN_STEPS).items()}
        with AttentionRecorder(ops, cfg.n_layers) as attn_rec:
            wall_ms, busy_ms, by_kind, _ = profiled(
                lambda: tr._update(tr.params, tr.opt_state, tr.comp_state, batch))
        kinds: dict = {}
        for name, ms in by_kind.items():
            kinds[_kind_of(name)] = kinds.get(_kind_of(name), 0.0) + ms
        q, k, v, causal, window = attn_rec.kept[TRAIN_SEQ]
        q, k, v = (x.detach() for x in (q, k, v))
        del attn_rec, batch
        # the plain backward of one attention call and one microbatch's CE
        # chunks, alone at the step's shapes (CUDA events)
        g_out = torch.randn(q.shape, device=DEVICE, dtype=q.dtype)

        def attn_backward():
            qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
            o = attention_ref(qq, kk, vv, causal=causal, window=window)
            torch.autograd.grad(o, (qq, kk, vv), g_out)

        x_mb = torch.randn((TRAIN_BATCH // TRAIN_MICROBATCH, TRAIN_SEQ, cfg.d_model),
                           device=DEVICE, dtype=cfg.dtype, requires_grad=True)
        lab = torch.as_tensor(pipe.batch_at(0)["labels"][:TRAIN_BATCH // TRAIN_MICROBATCH],
                              device=DEVICE)
        table = tr.params["embed"]["table"].detach().requires_grad_()

        def ce_chunks():
            loss = tf.chunked_ce_loss(x_mb, table.to(cfg.dtype), lab)
            torch.autograd.grad(loss, (x_mb, table))

        bwd_ms = host_loop_ms(attn_backward, warmup=1, iters=3)
        ce_ms = host_loop_ms(ce_chunks, warmup=1, iters=3)
        per_step = TRAIN_MICROBATCH * cfg.n_layers
        prof = {"wall_ms": wall_ms, "device_ms": busy_ms, "device_share": busy_ms / wall_ms,
                "by_kind_ms": kinds, "top_ms": dict(sorted(by_kind.items(),
                                                           key=lambda kv: -kv[1])[:10]),
                "attention_backward_ms": bwd_ms, "attention_backward_per_step": per_step,
                "attention_backward_share": per_step * bwd_ms / busy_ms,
                "ce_chunks_ms": ce_ms, "ce_chunks_per_step": TRAIN_MICROBATCH,
                "ce_chunks_share": TRAIN_MICROBATCH * ce_ms / busy_ms}
        out["profiled_step"] = prof
        print(f"  one step profiled: device busy {busy_ms:.1f} ms of {wall_ms:.1f} ms, share "
              f"{busy_ms / wall_ms:.4f}; by kind "
              + ", ".join(f"{k} {v:.1f} ms"
                          for k, v in sorted(kinds.items(), key=lambda kv: -kv[1]))
              + f"; plain attention backward {bwd_ms:.3f} ms a call x {per_step} = "
              f"{per_step * bwd_ms:.1f} ms ({prof['attention_backward_share']:.3f} of busy); CE "
              f"chunks fwd+bwd {ce_ms:.2f} ms a microbatch x {TRAIN_MICROBATCH} "
              f"({prof['ce_chunks_share']:.3f} of busy); top: "
              + ", ".join(f"{k.strip()[:40]} {v:.1f}" for k, v in prof["top_ms"].items()),
              flush=True)
        del tr, metrics, x_mb, table
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    report["train_lm"] = out
    return {"inputs": (q, k, v, causal, window), "launches": launches["flash_attention"],
            "attention_backward_ms": bwd_ms}


def train_grad_hold(arch: str, n_layers: int, seed: int, report: dict, bf16_gap: bool):
    """Phase 17 (b)/(c): ``arch`` at full width, depth cut to ``n_layers``,
    f32 params at rest and f32 compute (remat as the config has it): one
    value and gradient of ``train_loss`` on one ``TokenPipeline`` sequence
    of 4,096 tokens with ``ops.attention`` (the flash kernel under its
    autograd Function), against the same step with ``attention_ref`` in
    its place.  The loss, its parts and every gradient leaf within
    atol/rtol 1e-3, and each leaf's relative RMS gap (its difference's RMS
    over its RMS) within ``GRAD_REL_RMS``; the kernel launched n_layers x
    2 times; each layer's q, k and v projections with a non-zero gradient.
    With ``bf16_gap``, the same step in bf16 compute: its loss gap and each
    leaf's relative RMS gap against the plain attention's within
    ``BF16_TRAIN_GAP``."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.kernels.cuda_lib import launch_counters, reset_launch_counters
    from repro_torch.kernels.ref import attention_ref
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import tree_paths
    from repro_torch.train.trainer import value_and_grad

    cfg = dataclasses.replace(get_arch(arch).cfg, n_layers=n_layers, dtype=torch.float32)
    params = tf.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(seed), DEVICE,
                            at_rest=torch.float32)
    batch = {k: torch.as_tensor(v, device=DEVICE)
             for k, v in TokenPipeline(cfg.vocab_size, 1, TRAIN_SEQ, seed=seed).batch_at(0).items()}
    def plain(q, k, v, causal=True, window=None):
        return attention_ref(q, k, v, causal=causal, window=window)

    def step(c, fn=None):
        """One value and gradient, with ``fn`` in ``ops.attention``'s place
        when given."""
        kernel_fn = ops.attention
        ops.attention = fn or kernel_fn
        try:
            return value_and_grad(lambda p, b: tf.train_loss(p, b, c))(params, batch)
        finally:
            ops.attention = kernel_fn

    with AttentionRecorder(ops, n_layers) as rec:
        reset_launch_counters()
        (loss_k, aux_k), g_k = step(cfg)
        torch.cuda.synchronize()
        launches = {k: c.n for k, c in launch_counters().items() if c.n}
    q, k, v, _, _ = rec.kept[TRAIN_SEQ]
    shapes = {"q": list(q.shape), "v": list(v.shape), "v_contiguous": v.is_contiguous()}
    del rec, q, k, v
    (loss_p, aux_p), g_p = step(cfg, plain)
    want = n_layers * (2 if cfg.remat else 1)
    if launches != {"flash_attention": want}:
        fail(f"{arch} gradient hold launched {launches}, want flash_attention {want}")
    checks = {"loss": (loss_k, loss_p), "ce": (aux_k["ce"], aux_p["ce"]),
              "aux": (aux_k["aux"], aux_p["aux"])}
    gp = dict(tree_paths(g_p))
    for key, g in tree_paths(g_k):
        checks[key] = (g, gp[key])
    worst, bad = {}, []
    for key, (got, want_) in checks.items():
        err = float((got - want_).abs().max())
        worst[key] = err
        if not (torch.isfinite(got).all() and torch.allclose(got, want_, **GRAD_TOL)):
            bad.append(f"{key} (max abs diff {err:.3g})")
    rms, gaps = rel_rms_gaps(g_k, g_p)
    loose = [f"{key} ({gap:.3g})" for key, gap in gaps.items() if not gap <= GRAD_REL_RMS]
    attn = g_k["layers"]["attn"]
    proj = ["wq", "w_dkv", "w_krope", "w_uk", "w_uv"] if cfg.mla else ["wq", "wk", "wv"]
    dead = [n for n in proj if not (attn[n].reshape(n_layers, -1).abs().amax(1) > 0).all()]
    out = {"arch": arch, "layers": n_layers, "tokens": TRAIN_SEQ, "launches": launches,
           "loss": float(loss_k), "aux": float(aux_k["aux"]), "attention_shapes": shapes,
           "max_abs_diff": max(worst.values()), "worst_leaf": max(worst, key=worst.get),
           "n_leaves": len(checks) - 3, "grad_rms": rms, "rel_rms_gap": gaps,
           "max_rel_rms_gap": max(gaps.values())}
    del g_k, g_p, gp, checks
    if bf16_gap:
        c16 = dataclasses.replace(cfg, dtype=torch.bfloat16)
        (l16_k, _), g16_k = step(c16)
        (l16_p, _), g16_p = step(c16, plain)
        _, gaps16 = rel_rms_gaps(g16_k, g16_p)
        del g16_k, g16_p
        out["bf16_rel_loss_gap"] = abs(float(l16_k) - float(l16_p)) / abs(float(l16_p))
        out["bf16_rel_rms_gap"] = gaps16
        out["bf16_max_rel_rms_gap"] = max(gaps16.values())
        if not (out["bf16_rel_loss_gap"] <= BF16_TRAIN_GAP
                and out["bf16_max_rel_rms_gap"] <= BF16_TRAIN_GAP):
            loose.append(f"bf16 step: loss gap {out['bf16_rel_loss_gap']:.3g}, largest relative "
                         f"RMS gradient gap {out['bf16_max_rel_rms_gap']:.3g} at "
                         f"{max(gaps16, key=gaps16.get)} (limit {BF16_TRAIN_GAP})")
    del params
    print(f"gradient hold, {arch} at full width, {n_layers} layer(s), f32, one {TRAIN_SEQ}-token "
          f"sequence: loss {out['loss']:.6f} (aux {out['aux']:.4g}), launches {launches}, "
          f"q {shapes['q']} v {shapes['v']} (v contiguous: {shapes['v_contiguous']}); loss and "
          f"{out['n_leaves']} gradient leaves with the kernel vs the plain attention: max abs "
          f"diff {out['max_abs_diff']:.3g} at {out['worst_leaf']}, largest relative RMS gap "
          f"{out['max_rel_rms_gap']:.3g} at {max(gaps, key=gaps.get)}"
          + (f"; bf16 step relative loss gap {out['bf16_rel_loss_gap']:.3g}, largest relative "
             f"RMS gradient gap {out['bf16_max_rel_rms_gap']:.3g}" if bf16_gap else ""),
          flush=True)
    print("  each leaf: gradient RMS / relative RMS gap"
          + ("" if not bf16_gap else " / bf16 relative RMS gap") + ": "
          + ", ".join(f"{key} {rms[key]:.3g}/{gaps[key]:.3g}"
                      + (f"/{out['bf16_rel_rms_gap'][key]:.3g}" if bf16_gap else "")
                      for key in gaps), flush=True)
    if bad or loose or dead:
        fail(f"{arch} gradient hold: outside atol/rtol 1e-3: {bad}; relative RMS gap past "
             f"{GRAD_REL_RMS}: {loose}; projections without a gradient: {dead}")
    report[f"train_grad_hold_{arch}"] = out


def rel_rms_gaps(got: dict, want: dict) -> tuple:
    """Each gradient leaf's RMS in ``want`` and the RMS of ``got - want``
    over it, in f64 (the gap of a leaf that is 0 in ``want`` is its
    difference's RMS).  ``got`` may lie on another device."""
    import torch

    from repro_torch.train.optimizer import tree_paths

    flat = dict(tree_paths(want))
    rms, gaps = {}, {}
    for key, g in tree_paths(got):
        w = flat[key].double()
        rms[key] = float(w.pow(2).mean().sqrt())
        diff = float((g.to(w.device, torch.float64) - w).pow(2).mean().sqrt())
        gaps[key] = diff / rms[key] if rms[key] > 0 else diff
    return rms, gaps


def train_bst(report: dict) -> None:
    """Phase 17 (d): BST at full width (``configs/bst.py``: 2^22 x 32 items,
    16,384 categories), params drawn on the host from seed 5 and carried to
    the card and back to the host through ``convert.bst_params_from_numpy``;
    ``RecsysPipeline`` batches of ``RECSYS_SHAPES``' train_batch, 65,536.
    The first step's loss and every gradient leaf on the card are held to
    the same step on the host (both bf16 compute) within 2e-2 (the loss
    relatively, each leaf by its relative RMS gap); then ``Trainer`` runs 4
    steps on the card (the final blocking checkpoint in a temporary
    directory, removed after), whose first loss must be the held one."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.convert import bst_params_from_numpy
    from repro_torch.data.pipeline import RecsysPipeline
    from repro_torch.kernels.cuda_lib import launch_counters, reset_launch_counters
    from repro_torch.models.recsys.bst import bst_init, bst_loss
    from repro_torch.train.optimizer import OptConfig, tree_map
    from repro_torch.train.trainer import Trainer, TrainerConfig, value_and_grad

    spec = get_arch("bst").spec
    t = time.perf_counter()
    tree = tree_map(lambda x: x.numpy(), bst_init(torch.Generator().manual_seed(5), spec, "cpu"))
    params, host = bst_params_from_numpy(tree, DEVICE), bst_params_from_numpy(tree, "cpu")
    del tree
    pipe = RecsysPipeline(spec.n_items, spec.n_cats, BST_TRAIN_BATCH, spec.seq_len, seed=0)
    b0 = pipe.batch_at(0)

    def loss_fn(p, b):
        return bst_loss(p, b, spec), {}

    (lc, _), gc_ = value_and_grad(loss_fn)(params, {k: torch.as_tensor(v, device=DEVICE)
                                                   for k, v in b0.items()})
    torch.cuda.synchronize()
    t_host = time.perf_counter()
    (lh, _), gh = value_and_grad(loss_fn)(host, {k: torch.as_tensor(v) for k, v in b0.items()})
    host_s = time.perf_counter() - t_host
    _, gaps = rel_rms_gaps(gc_, gh)
    loss_gap = abs(float(lc) - float(lh)) / abs(float(lh))
    del gc_, gh, host
    (ROOT / "build").mkdir(exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="train_bst_", dir=ROOT / "build")
    try:
        tr = Trainer(loss_fn, params, TrainerConfig(
            total_steps=BST_TRAIN_STEPS, ckpt_every=BST_TRAIN_STEPS + 1, ckpt_dir=ckpt_dir,
            opt=OptConfig(lr=1e-3, warmup_steps=1, total_steps=BST_TRAIN_STEPS)), device=DEVICE)
        del params
        reset_launch_counters()
        metrics = tr.run(pipe.batch_at(step) for step in range(BST_TRAIN_STEPS))
        launches = {k: c.n for k, c in launch_counters().items() if c.n}
        batch = {k: torch.as_tensor(v, device=DEVICE)
                 for k, v in pipe.batch_at(BST_TRAIN_STEPS).items()}
        wall_ms, busy_ms, by_kind, _ = profiled(
            lambda: tr._update(tr.params, tr.opt_state, tr.comp_state, batch))
        del tr, batch
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    losses, step_ms = metrics["loss"], [x * 1e3 for x in metrics["step_time"]]
    out = {"batch": BST_TRAIN_BATCH, "loss_card": float(lc), "loss_host": float(lh),
           "rel_loss_gap": loss_gap, "max_rel_rms_grad_gap": max(gaps.values()),
           "worst_leaf": max(gaps, key=gaps.get), "host_step_s": host_s, "losses": losses,
           "step_ms": step_ms, "step_median_ms": float(np.median(step_ms)),
           "launches": launches, "phase_s": time.perf_counter() - t,
           "profiled_step": {"wall_ms": wall_ms, "device_ms": busy_ms,
                             "device_share": busy_ms / wall_ms, "top_ms": dict(
                                 sorted(by_kind.items(), key=lambda kv: -kv[1])[:8])}}
    report["train_bst"] = out
    print(f"BST training at full width, batch {BST_TRAIN_BATCH}: first step on the card vs the "
          f"host: loss {float(lc):.6f} vs {float(lh):.6f} (relative gap {loss_gap:.3g}), "
          f"largest relative RMS gradient gap {out['max_rel_rms_grad_gap']:.3g} at "
          f"{out['worst_leaf']} (host step {host_s:.1f} s); {BST_TRAIN_STEPS} steps, median "
          f"{out['step_median_ms']:.1f} ms (" + ", ".join(f"{x:.1f}" for x in step_ms)
          + " ms), loss " + " -> ".join(f"{x:.4f}" for x in losses)
          + f"; launches {launches}", flush=True)
    print(f"  one BST step profiled: device busy {busy_ms:.1f} ms of {wall_ms:.1f} ms, share "
          f"{busy_ms / wall_ms:.4f}; top: " + ", ".join(
              f"{k.strip()[:40]} {v:.2f}" for k, v in out["profiled_step"]["top_ms"].items()),
          flush=True)
    if not (loss_gap <= BST_GRAD_GAP and out["max_rel_rms_grad_gap"] <= BST_GRAD_GAP):
        fail(f"BST training: the card's first step is outside {BST_GRAD_GAP} of the host's")
    if not (np.isfinite(losses).all() and len(losses) == BST_TRAIN_STEPS):
        fail(f"BST training: losses {losses}")
    if abs(losses[0] - float(lc)) > 1e-6 * abs(float(lc)):
        fail(f"BST training: the trainer's first loss {losses[0]} is not the held {float(lc)}")
    if launches:
        fail(f"BST training launched {launches}; it trains through plain gathers")


def train_kernel_timing(lm: dict, report: dict) -> dict:
    """Phase 17 (e): the flash kernel on q, k, v recorded from (a)'s
    profiled step ([2, 16, 4,096, 128] bf16, causal, GQA group 2) against
    its plain version (bf16 2e-2, f32 2e-5), graph-replayed in turns with
    SDPA beside its bound; the plain backward's time (a)'s beside it.
    Returns the kernel table's "LM training" path."""
    from repro_torch.kernels.ref import attention_ref

    q, k, v, causal, window = lm["inputs"]
    row = {"shape": {"q": list(q.shape), "k": list(k.shape), "v": list(v.shape)},
           **hold_to_plain("at the training shape", q, k, v, causal, window)}
    launch = flash_launch(q, k, v, causal, window)
    ms, sdpa_ms = cuda_ms_in_turns([launch, lambda: _sdpa(q, k, v, causal)], reps=9)
    bound_ms, bound_by, flops, nbytes = attention_bound(q, k, v, causal, window)
    row.update(ms=ms, sdpa_ms=sdpa_ms, bound_ms=bound_ms, bound_by=bound_by, flops=flops,
               bytes=nbytes, host_loop_ms=host_loop_ms(launch),
               plain_ms=host_loop_ms(lambda: attention_ref(q, k, v, causal=causal), iters=5),
               plain_backward_ms=lm["attention_backward_ms"], launches=lm["launches"],
               gap_ms=lm["launches"] * (ms - bound_ms))
    report["train_flash_attention"] = row
    print(f"flash_attention at the training shape q {tuple(q.shape)} k {tuple(k.shape)}: max "
          f"abs err bf16 {row['max_abs_err_bfloat16']:.3g} (f32 {row['max_abs_err_float32']:.3g}); "
          f"kernel {ms:.4f} ms, SDPA {sdpa_ms:.4f} ms in turns, plain {row['plain_ms']:.3f} ms, "
          f"plain backward {row['plain_backward_ms']:.3f} ms; bound {bound_ms:.5f} ms by "
          f"{bound_by} ({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB); {lm['launches']} "
          f"launches x (ms - bound) {row['gap_ms']:.2f} ms", flush=True)
    return {"launches": lm["launches"], "max_abs_err": row["max_abs_err_bfloat16"], "ms": ms,
            "host_loop_ms": row["host_loop_ms"], "plain_ms": row["plain_ms"],
            "plain_backward_ms": row["plain_backward_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": sdpa_ms, "gap_ms": row["gap_ms"]}


def train_phase(report: dict) -> dict:
    """Phase 17, slice G on the card: (a) qwen3-0.6b trained at full width,
    (b) its gradient through the kernel held at 2 layers in f32, (c) the
    same for deepseek-v2-lite-16b's MLA at 1 MoE layer, (d) BST trained at
    full width, (e) the flash kernel at the training shape.  Returns the
    kernel table's "LM training" path of ``flash_attention``."""
    import gc

    import torch

    t = time.perf_counter()
    lm = train_lm(report)
    gc.collect()
    torch.cuda.empty_cache()
    path = train_kernel_timing(lm, report)
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    train_grad_hold(TRAIN_ARCH, GRAD_LAYERS, 1, report, bf16_gap=True)
    gc.collect()
    torch.cuda.empty_cache()
    train_grad_hold(MLA_ARCH, MLA_GRAD_LAYERS, 2, report, bf16_gap=False)
    gc.collect()
    torch.cuda.empty_cache()
    train_bst(report)
    report["train_phase_s"] = time.perf_counter() - t
    print(f"phase 17 (slice G: training) wall {report['train_phase_s']:.1f} s", flush=True)
    return path


def bag_inputs():
    """Phase 11's inputs: BST's item table (2^22 x 32, f32, seeded on the
    card) and, for each of ``BAG_BATCHES``, ``(B, ids, weights)`` with
    Zipf(1.1) ids, ``BAG_L`` a bag."""
    import numpy as np
    import torch

    from repro_torch.models.recsys.embedding import table_init

    table = table_init(torch.Generator(device=DEVICE).manual_seed(2), BAG_V, BAG_D,
                       device=DEVICE)
    rng = np.random.default_rng(1)
    bags = []
    for B in BAG_BATCHES:
        ids = torch.as_tensor((rng.zipf(1.1, (B, BAG_L)) % BAG_V).astype(np.int32),
                              device=DEVICE)
        w = torch.as_tensor(rng.random((B, BAG_L)).astype(np.float32), device=DEVICE)
        bags.append((B, ids, w))
    return table, bags


def bag_phase(report: dict) -> dict:
    """Phase 11: BST's item table (2^22 x 32, f32, seeded on the card) and
    Zipf(1.1) ids, 20 a bag, weighted, at the serving batches 512 and
    262,144, in sum and mean, through ``models.recsys.embedding.bag_lookup``
    with counts set to 0 just before and read just after: each result
    within 1e-4 of the plain version.  Times of the kernel (C entry point),
    the plain version and ``F.embedding_bag`` (sum mode) beside the bound.
    Returns the kernel table row (262,144 bags, sum)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.cuda_lib import (
        launch_counters,
        library,
        reset_launch_counters,
        stream_ptr,
    )
    from repro_torch.kernels.embedding_bag import instance
    from repro_torch.kernels.ref import embedding_bag_ref
    from repro_torch.models.recsys.embedding import bag_lookup

    table, bags = bag_inputs()
    reset_launch_counters()
    results = []
    for B, ids, w in bags:
        for mode in ("sum", "mean"):
            results.append((B, mode, bag_lookup(table, ids, w, mode=mode, dtype=torch.float32)))
    torch.cuda.synchronize()
    launches = {k: c.n for k, c in launch_counters().items() if c.n}
    if launches.get("embedding_bag", 0) <= 0:
        fail("kernel embedding_bag was not launched through bag_lookup")
    lib = library().get()
    rows, err_max = [], 0.0
    for (B, mode, got), (_, ids, w) in zip(results, [b for b in bags for _ in range(2)]):
        want = embedding_bag_ref(table, ids, w, mode=mode)
        err = float((got - want).abs().max())
        err_max = max(err_max, err)
        if not torch.allclose(got, want, **BAG_TOL):
            fail(f"embedding_bag B={B} {mode}: max abs err {err:.3g} outside 1e-4")
        uniq = int(torch.unique(ids).numel())
        nbytes = uniq * BAG_D * 4 + ids.numel() * 8 + B * BAG_D * 4
        out = torch.empty_like(got)
        args = (table.data_ptr(), ids.data_ptr(), w.data_ptr(), out.data_ptr(), B, BAG_L,
                BAG_V, BAG_D, int(mode == "mean"), 0)

        def launch():
            lib.embedding_bag_fwd(*args, stream_ptr(table.device))

        row = {"B": B, "mode": mode, "max_abs_err": err, "unique_rows": uniq, "bytes": nbytes,
               "instance": instance(table, ids),
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, **kernel_ms(launch),
               "plain_ms": host_loop_ms(lambda: embedding_bag_ref(table, ids, w, mode=mode))}
        if mode == "sum":
            ids64 = ids.long()
            row["library_ms"] = cuda_ms(lambda: F.embedding_bag(
                ids64, table, mode="sum", per_sample_weights=w))
            lib_out = F.embedding_bag(ids64, table, mode="sum", per_sample_weights=w)
            row["library_max_abs_diff"] = float((lib_out - got).abs().max())
        rows.append(row)
        print(f"embedding_bag B={B} L={BAG_L} {mode} (instance {row['instance']}: dtype, "
              f"bytes a load, lanes a row, rows a lane in flight): max abs err {err:.3g}; "
              f"{uniq} distinct "
              f"rows; kernel {row['ms']:.4f} ms (host loop {row['host_loop_ms']:.4f}), plain "
              f"{row['plain_ms']:.4f} ms"
              + (f", F.embedding_bag {row['library_ms']:.4f} ms" if mode == "sum" else "")
              + f"; bound {row['bound_ms']:.5f} ms ({nbytes / 1e6:.2f} MB)", flush=True)
    print(f"launches through bag_lookup: {launches}", flush=True)
    report["embedding_bag"] = {"launches": launches, "checks": rows}
    del table, bags
    err_max = max(err_max, bag_sweep(report))
    top = next(r for r in rows if r["B"] == BAG_BATCHES[-1] and r["mode"] == "sum")
    return {"name": "embedding_bag", "route": "cuda",
            "source": "src/repro_torch/csrc/embedding_bag.cu",
            "replaces": "src/repro/kernels/embedding_bag.py:27",
            "launches": launches["embedding_bag"], "max_abs_err": err_max,
            "ms": top["ms"], "host_loop_ms": top["host_loop_ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": "bytes", "library_ms": top["library_ms"]}


# phase 11's sweep: dtype, D, B, L, mode, weights ("rand", "none" or "zero"),
# base 16-byte aligned; the instances' branches: 16-byte loads by 4, 8, 16
# and 32 lanes a row, rows wider than 32 loads, one element a load (D = 33
# and a misaligned base), no ids, one id, more than one chunk of 32 ids, and
# a B that leaves the last block of 8 bags partial
BAG_SWEEP = (
    ("float32", 16, 1003, 20, "sum", "rand", True),
    ("float32", 32, 9, 0, "sum", "rand", True),
    ("float32", 32, 517, 1, "mean", "rand", True),
    ("float32", 32, 517, 33, "sum", "none", True),
    ("float32", 32, 1003, 20, "mean", "zero", True),
    ("float32", 32, 1003, 20, "sum", "rand", False),
    ("float32", 48, 1003, 64, "mean", "rand", True),
    ("float32", 64, 1003, 20, "sum", "rand", True),
    ("float32", 128, 517, 33, "mean", "rand", True),
    ("float32", 256, 517, 20, "sum", "rand", True),
    ("float32", 33, 1003, 20, "sum", "rand", True),
    ("float32", 33, 517, 64, "mean", "none", True),
    ("bfloat16", 32, 1003, 20, "sum", "rand", True),
    ("bfloat16", 16, 1003, 64, "sum", "rand", True),
    ("bfloat16", 48, 517, 33, "mean", "none", True),
    ("bfloat16", 64, 9, 0, "mean", "rand", True),
    ("bfloat16", 128, 517, 1, "mean", "rand", True),
    ("bfloat16", 33, 1003, 20, "sum", "rand", True),
    ("bfloat16", 32, 1003, 20, "mean", "zero", True),
    ("bfloat16", 32, 1003, 20, "sum", "rand", False),
)
BAG_SWEEP_V = 5000


def bag_sweep(report: dict) -> float:
    """Phase 11's sweep: the kernel (through the wrapper) against its plain
    version on every ``BAG_SWEEP`` case, within 1e-4; ids Zipf(1.1) with
    one past the end and -1 in the first bag (both clamp).  bf16 cases draw
    table entries k / 64 and weights j / 16: every product and sum is then
    exact in f32 in any order, so the kernel and the plain version round
    the same sums to bf16 and 1e-4 holds the kernel's indexing and packing,
    not the order of its adds.  Also checks that :func:`instance` names the
    instance the C entry point runs.  Returns the largest error."""
    import numpy as np
    import torch

    from repro_torch.kernels.cuda_lib import library
    from repro_torch.kernels.embedding_bag import _DTYPES, embedding_bag, instance
    from repro_torch.kernels.ref import embedding_bag_ref

    lib = library().get()
    rng = np.random.default_rng(11)
    rows, names = [], set()
    for dtype, D, B, L, mode, weights, aligned in BAG_SWEEP:
        dt = getattr(torch, dtype)
        V = BAG_SWEEP_V
        if dtype == "bfloat16":
            tab = rng.integers(-64, 65, (V, D)) / 64.0
            w = rng.integers(0, 17, (B, L)) / 16.0
        else:
            tab = rng.standard_normal((V, D))
            w = rng.random((B, L))
        if weights == "zero":
            w[:] = 0.0
        ids = (rng.zipf(1.1, (B, L)) % V).astype(np.int32)
        if L:
            ids[0, 0], ids[0, -1] = V, -1
        table = torch.as_tensor(tab, dtype=dt, device=DEVICE)
        if not aligned:  # the same values one element past an aligned base
            table = torch.empty(V * D + 1, dtype=dt, device=DEVICE)[1:].view(V, D).copy_(table)
        idx = torch.as_tensor(ids, device=DEVICE)
        wt = None if weights == "none" else torch.as_tensor(w, dtype=torch.float32,
                                                           device=DEVICE)
        got = embedding_bag(table, idx, wt, mode=mode)
        want = embedding_bag_ref(table, idx, wt, mode=mode)
        torch.cuda.synchronize()
        inst = instance(table, idx)
        code = lib.embedding_bag_instance(table.data_ptr(), got.data_ptr(), D, _DTYPES[dt])
        if (code >> 8, code & 255) != inst[1:3]:
            fail(f"embedding_bag sweep {dtype} D={D}: the kernel runs {code >> 8}-byte loads "
                 f"by {code & 255} lanes, instance() says {inst}")
        err = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
        name = f"{dtype} D={D} B={B} L={L} {mode} weights {weights}" + (
            "" if aligned else ", base not 16-byte aligned")
        if not torch.allclose(got.float(), want.float(), **BAG_TOL):
            fail(f"embedding_bag sweep {name}: max abs err {err:.3g} outside 1e-4")
        rows.append({"case": name, "instance": inst, "max_abs_err": err})
        names.add(inst[1:3])
    report["embedding_bag_sweep"] = rows
    print(f"embedding_bag sweep: {len(rows)} cases within 1e-4 of the plain version (f32 and "
          f"bf16, D 16-256 and 33, L 0-64, partial last block, no weights, zero weights in "
          f"mean, a misaligned base; (bytes a load, lanes a row) {sorted(names)}), max abs err "
          f"{max(r['max_abs_err'] for r in rows):.3g}", flush=True)
    print(f"  ptxas: {ptxas_of(report, 'embedding_bag')}", flush=True)
    return max(r["max_abs_err"] for r in rows)


def store_phases(report: dict) -> list:
    """Phases 3-7 (slices A and B); returns their kernel table rows.  The
    store and its mirrors are freed when this returns."""
    store, inputs, built_delta, launches, rec = main_path(report)
    device_busy(store, report)
    rows = kernel_checks(store, rec, report)
    stream_launches, sweep_rec = streaming_phase(store, report)
    single = streaming_kernel_checks(sweep_rec, report)["global"]
    cpu_build_diff(inputs, built_delta, report)

    def row(name, line, launched, t):
        return {"name": name, "route": "cuda", "source": "src/repro_torch/csrc/dhd_spmv.cu",
                "replaces": f"src/repro/kernels/dhd_spmv.py:{line}", "launches": launched,
                "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                "host_loop_ms": t["host_loop_ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": "bytes", "library_ms": None}

    route, dhd = rows["route"], rows["dhd"]
    return [
        row("dhd_count", 159, launches["dhd_count"], dhd["count"]),
        row("dhd_flow", 173, launches["dhd_flow"], dhd["flow"]),
        {"name": "route_expand_ragged", "route": "cuda",
         "source": "src/repro_torch/csrc/route_expand.cu",
         "replaces": "src/repro/kernels/route_expand.py:48",
         "launches": launches["route_expand_ragged"], "max_abs_err": route["max_abs_err"],
         "ms": route["ms"], "host_loop_ms": route["host_loop_ms"],
         "plain_ms": route["plain_ms"], "bound_ms": route["bound_ms"],
         "bound_by": "bytes", "library_ms": None},
        row("dhd_count_single", 70, stream_launches["dhd_count_single"], single["count"]),
        row("dhd_flow_single", 82, stream_launches["dhd_flow_single"], single["flow"]),
    ]


# ------------------------------------------------------ the ragged expansion
# phase 20's sweep: read lengths around a warp's edges, a warp's share (256),
# the most slots a warp's region of shared memory held (25,824), and past it
RAGGED_LENS = (0, 1, 31, 32, 33, 256, 257, 25_824, 25_825, 40_000)
RAGGED_SWEEP = (
    # name, read lengths, D, L, p_rep, all_ties
    ("lengths at every boundary", RAGGED_LENS, 5, 3, 0.35, False),
    ("lengths at every boundary, 31 DCs", RAGGED_LENS, 31, 4, 0.1, False),
    ("all ties", (1, 300, 5000), 5, 3, 0.0, True),
    ("no layer", (3, 500, 2), 5, 0, 0.35, False),
    ("2,000 short reads", tuple(range(1, 61)) * 33 + (7,) * 20, 5, 3, 0.35, False),
    ("64 long reads", tuple(257 + 43 * i for i in range(64)), 6, 4, 0.3, False),
)
RAGGED_CELL = "snb3s-nbr-over"  # the recorded drain's cell, seed and size
RAGGED_SEED = 2_148_031_001
RAGGED_DRAIN = 256
GATE_CELL = "snb3s-read-peak"  # the short reads the item gate is also timed on
GATE_ITEMS = (1024, 4096, 8192, 16384, 65536)
# reads a one-origin sub-batch of RAGGED_CELL holds, drawn as its traffic
# draws them (uniformly over the patterns), each size drawn twice
GATE_READS = (2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64)


def flat_route_problem(rng, lens, D, L, p_rep=0.35, all_ties=False):
    """A random flat batch ``(bits, sizes, offsets, origin, comp)`` with
    reads of the given lengths."""
    import numpy as np

    lens = np.asarray(lens, np.int64)
    comp = rand_route_problem(rng, 1, 1, 1, D, L)[4]
    N = int(lens.sum())
    rep = np.ones((N, D), bool) if all_ties else rng.random((N, D)) < p_rep
    bits = (rep * (1 << np.arange(D, dtype=np.int64))).sum(axis=1).astype(np.int32)
    sizes = (rng.random(N) + 0.25).astype(np.float32)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    origin = rng.integers(0, D, len(lens)).astype(np.int32)
    return bits, sizes, offsets, origin, comp


def host_fold_of(name, ids, sizes, offsets, got, shift) -> float:
    """The kernel's int64 sums, served-DC masks and unresolved counts held
    to the router's host epilogue (``routing._host_fold``) over its picks:
    ``units * 2**-shift`` equal to the f64 fold bit for bit.  Returns the
    largest absolute difference of the bytes (0.0, or the run fails)."""
    import numpy as np

    from repro_torch.core.routing import _card_fold, _host_fold

    served, units, _, _, served_dcs, n_miss = (t.cpu().numpy() for t in got)
    R, D = units.shape
    lens = np.diff(np.asarray(offsets, np.int64))
    req_id = np.repeat(np.arange(R), lens)
    host = _host_fold(np.take(sizes, ids), req_id, served.astype(np.int64), R, D)
    card = _card_fold((units, served_dcs, n_miss), shift, lens, D) if R else host
    if card is None:
        fail(f"route_expand_ragged {name}: sums past the exact range")
    err = float(np.abs(card[0] - host[0]).max(initial=0.0))
    for label, a, b in zip(("bytes", "served DCs", "unresolved"), card, host):
        if not np.array_equal(a, b):
            fail(f"route_expand_ragged {name}: the kernel's {label} differ from the host "
                 f"epilogue's (bytes max abs err {err:.3g})")
    return err


def check_ragged(name, prob, timed: bool) -> dict:
    """The ragged kernel against its plain version on the card, every
    output equal (picks, layers, missing counts, the int64 byte sums, the
    served-DC masks, the unresolved counts), and its sums held to the
    router's host epilogue (:func:`host_fold_of`); timed, its
    graph-replayed time beside its bound.  ``prob`` is ``(ids, table_bits,
    table_sizes, offsets, origin, comp, shift)``, item ids over tables keyed
    by item id and the tables' byte shift, as a store's router launches
    it, or the rows form ``(bits, sizes, offsets, origin, comp)``, taken as
    the tables over ids ``0 .. N - 1`` at their own shift.  A shift must be
    ``fold_shift`` of the tables' bytes.  A launch over a store's tables is
    also held to the launch over the rows its ids stand for (every output
    equal).  The bound counts 9 B a slot and 4 B x (7 + L + D) a read
    (``geobench.roofline.ragged_bytes``), 4 B more a read and DC (the sums
    are int64) and the 4 B an id."""
    import numpy as np
    import torch

    from geobench.roofline import ragged_bytes
    from repro_torch.core.route_tables import fold_shift
    from repro_torch.kernels.cuda_lib import library, stream_ptr
    from repro_torch.kernels.ref import route_expand_ragged_ids_ref
    from repro_torch.kernels.route_expand import (
        ragged_buffers,
        ragged_order,
        route_expand_ragged,
    )

    inputs = "ids" if len(prob) == 7 else "rows"
    if inputs == "rows":
        prob = (np.arange(len(prob[0]), dtype=np.int32), *prob, fold_shift(prob[1]))
    *arrays, shift = prob
    if shift is None or shift != fold_shift(arrays[2]):
        fail(f"route_expand_ragged {name}: shift {shift}, the tables' bytes take "
             f"{fold_shift(arrays[2])}")
    args = tuple(torch.as_tensor(np.ascontiguousarray(x), device="cuda") for x in arrays)
    got = route_expand_ragged(*args, shift)
    want = route_expand_ragged_ids_ref(*args, shift)
    rows = None
    if inputs == "ids":
        i = args[0].long()
        rows = route_expand_ragged(torch.arange(len(i), dtype=torch.int32, device="cuda"),
                                   args[1][i], args[2][i], *args[3:], shift)
    torch.cuda.synchronize()
    labels = ("served", "units", "layers_used", "miss_after", "served_dcs", "n_miss")
    for label, a, b in zip(labels, got, want):
        if not torch.equal(a, b):
            fail(f"route_expand_ragged {name}: {label} differs from the plain version")
    if rows is not None and not all(torch.equal(a, b) for a, b in zip(got, rows)):
        fail(f"route_expand_ragged {name}: differs from the launch over the rows its ids "
             "stand for")
    offsets, origin, comp = arrays[3:6]
    err = host_fold_of(name, np.asarray(arrays[0], np.int64), arrays[2], offsets, got, shift)
    lens = np.diff(offsets)
    order, n_long = ragged_order(lens)
    R, N, D, L = len(origin), len(arrays[0]), comp.shape[1], comp.shape[0] - 1
    out = {"case": name, "inputs": inputs, "max_abs_err": err, "reads": R, "items": N,
           "longest": int(lens.max(initial=0)), "blocks_alone": n_long, "D": D, "L": L,
           "shift": shift}
    if timed:
        lib = library().get()
        order_t = torch.as_tensor(order, device="cuda")
        bufs = ragged_buffers(N, R, D, L, args[0].device)
        ptrs = ([a.data_ptr() for a in args[:5]] + [order_t.data_ptr(), n_long]
                + [args[5].data_ptr(), shift] + [b.data_ptr() for b in bufs[1:]])

        # the C entry point straight, into the buffers above
        def launch():
            lib.route_expand_ragged_ids_launch(*ptrs, R, D, L, stream_ptr(args[0].device))

        nbytes = ragged_bytes(N, R, D, L) + 4 * R * D + 4 * N
        out.update(
            **kernel_ms(launch),
            wrapper_ms=host_loop_ms(lambda: route_expand_ragged(*args, shift)),
            plain_ms=host_loop_ms(lambda: route_expand_ragged_ids_ref(*args, shift), warmup=1,
                                  iters=3),
            bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
        )
    return out


def _tables_of(store):
    """``(host bytes, DeviceTables(bits, bytes, shift) on the card)``: the
    route tables the store hands its router on the card."""
    import torch

    host, tables = store.route_tables.handed(store.route_index, torch.device("cuda"))
    if tables is None:
        fail("the store keeps no route tables on the card")
    return host, tables


def _ids_of(store, sub):
    """The id-keyed inputs the router hands the card for a sub-batch."""
    import numpy as np

    items = np.concatenate([np.asarray(it, np.int64) for it, _ in sub]).astype(np.int32)
    bounds = np.concatenate([[0], np.cumsum([len(it) for it, _ in sub])]).astype(np.int32)
    _, (tb, tz, shift) = _tables_of(store)
    return (items, tb.cpu().numpy(), tz.cpu().numpy(), bounds,
            np.asarray([o for _, o in sub], np.int32),
            np.asarray(store.lg.comp_of_dc, np.int32), shift)


def _cell_store(name: str, seed: int):
    import numpy as np

    from geobench.harness import build_store, resolve_cell
    from geobench.inputs import make_inputs

    cell = resolve_cell(name)
    inputs = make_inputs(cell.config, seed)
    t = time.perf_counter()
    store = build_store(cell.config, inputs, "cuda")
    pats = inputs.patterns
    home = np.array([int(np.argmax(p.r_py)) for p in pats], np.int64)
    print(f"{name}: store of {store.g.n_items} items built in {time.perf_counter() - t:.1f} s",
          flush=True)
    return cell, inputs, store, home


def _in_turns_ms(fns: dict, reps: int = 9) -> dict:
    """Median wall ms of each of ``fns``, called in turns (the order
    reversed every other round), after one warm-up call each."""
    import numpy as np

    for fn in fns.values():
        fn()
    times = {k: [] for k in fns}
    for i in range(reps):
        for k in (list(fns) if i % 2 == 0 else list(fns)[::-1]):
            t = time.perf_counter()
            fns[k]()
            times[k].append(time.perf_counter() - t)
    return {k: float(np.median(v)) * 1e3 for k, v in times.items()}


def _gate_rows(store, pats, label: str, rng, uniform: bool) -> list:
    """Numpy against fused routing of one-origin sub-batches, as the sharded
    store routes them: ``uniform``, of ``GATE_READS`` reads drawn uniformly
    over the patterns; else of short reads up to ``GATE_ITEMS`` items."""
    import numpy as np

    from repro_torch.core.routing import route_online_batch

    lens = np.array([len(p.items) for p in pats])
    subs = []
    if uniform:
        nonempty = np.flatnonzero(lens > 0)
        for n in GATE_READS:
            for _ in range(2):
                subs.append([(pats[int(p)].items, 0) for p in rng.choice(nonempty, n)])
    else:
        for target in GATE_ITEMS:
            small = np.flatnonzero((lens > 0) & (lens <= max(target // 2, 1)))
            sub, n = [], 0
            while n < target or len(sub) < 2:
                p = int(small[rng.integers(0, len(small))])
                sub.append((pats[p].items, 0))
                n += int(lens[p])
            subs.append(sub)
    host, tables = _tables_of(store)
    rows = []
    for sub in subs:
        n = sum(len(it) for it, _ in sub)
        ms = _in_turns_ms({
            "numpy": lambda: route_online_batch(store.lg, store.state, sub, sizes=host,
                                                fast=False),
            "fused": lambda: route_online_batch(store.lg, store.state, sub, sizes=host,
                                                fast=True, device="cuda", tables=tables),
        })
        rows.append({"config": label, "reads": len(sub), "items": n, "numpy_ms": ms["numpy"],
                     "fused_ms": ms["fused"]})
        print(f"gate {label}: {len(sub)} reads, {n} items: numpy {ms['numpy']:.4f} ms, fused "
              f"{ms['fused']:.4f} ms", flush=True)
    return rows


def ragged_drain():
    """``(store, patterns, longest pattern, reads, reads by origin)``: a
    drain of ``RAGGED_DRAIN`` reads of ``RAGGED_CELL`` as its warm-up draws
    them (seed ``RAGGED_SEED``), its first read the cell's longest, on the
    cell's store built on the card."""
    import numpy as np

    from geobench.traffic import warmup_reads

    cell, inputs, store, home = _cell_store(RAGGED_CELL, RAGGED_SEED)
    pats = inputs.patterns
    eligible = np.array([i for i, p in enumerate(pats) if len(p.items)], np.int64)
    pat, org = warmup_reads(cell.mix["reads"], eligible, home, inputs.env.n_dcs, RAGGED_SEED,
                            RAGGED_DRAIN)
    big = int(np.argmax([len(p.items) for p in pats]))
    pat[0], org[0] = big, home[big]
    reqs = [(pats[p].items, int(o)) for p, o in zip(pat.tolist(), org.tolist())]
    subs = {}
    for it, o in reqs:
        subs.setdefault(o, []).append((it, o))
    return store, pats, big, reqs, dict(sorted(subs.items()))


def ragged_phase(report: dict) -> dict:
    """Phase 20: the ragged route expansion.  Returns its kernel table row."""
    import numpy as np
    import torch

    from repro_torch.core.routing import FUSED_MIN_ITEMS as gate
    from repro_torch.core.routing import route_online_batch
    from repro_torch.kernels.route_expand import RAGGED_LAUNCHES
    from repro_torch.obs import Tracer

    sweep = []
    for i, (name, lens, D, L, p_rep, ties) in enumerate(RAGGED_SWEEP):
        prob = flat_route_problem(np.random.default_rng(2000 + i), lens, D, L, p_rep, ties)
        sweep.append(check_ragged(name, prob, timed=True))
        r = sweep[-1]
        print(f"route_expand_ragged {name}: {r['reads']} reads, {r['items']} items (longest "
              f"{r['longest']}, {r['blocks_alone']} a block alone), D {D}, L {L}: exact, max "
              f"abs err {r['max_abs_err']:.3g}, kernel {r['ms']:.4f} ms (host loop "
              f"{r['host_loop_ms']:.4f}, wrapper {r['wrapper_ms']:.4f}), plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms", flush=True)
    print(f"  ptxas: {ptxas_of(report, 'route_expand_ragged')}", flush=True)

    # a recorded drain of the cell, holding its longest read, split by origin
    store, pats, big, reqs, subs = ragged_drain()
    drain, shapes = [], []
    host, tables = _tables_of(store)
    for o, sub in sorted(subs.items()):
        r = check_ragged(f"drain origin {o}", _ids_of(store, sub), timed=True)
        want = route_online_batch(store.lg, store.state, sub, fast=False)
        tracer = Tracer(enabled=True)
        got = route_online_batch(store.lg, store.state, sub, sizes=host, fast=True,
                                 device="cuda", tables=tables, tracer=tracer)
        if not same_results(got, want):
            fail(f"route_online_batch on the card differs from the numpy router (origin {o})")
        folds = {dict(k[1])["where"]: v for k, v in tracer.counters.items()
                 if k[0] == "route.fold"}
        if len(sub) > 1 and folds != {"card": 1}:
            fail(f"route_online_batch on the card folded {folds} (origin {o}), not on the card")
        r.update(origin=o, **_in_turns_ms({
            "numpy_ms": lambda: route_online_batch(store.lg, store.state, sub, sizes=host,
                                                   fast=False),
            "fused_ms": lambda: route_online_batch(store.lg, store.state, sub, sizes=host,
                                                   fast=True, device="cuda", tables=tables),
        }, reps=3))
        drain.append(r)
        shapes.append([r["reads"], r["items"], r["blocks_alone"]])
        print(f"drain origin {o}: {r['reads']} reads, {r['items']} items (longest "
              f"{r['longest']}): exact against the plain version and the numpy router; kernel "
              f"{r['ms']:.4f} ms, bound {r['bound_ms']:.5f} ms; route_online_batch fused "
              f"{r['fused_ms']:.3f} ms, numpy {r['numpy_ms']:.3f} ms", flush=True)
    if max(r["longest"] for r in drain) != len(pats[big].items):
        fail("the recorded drain lost its longest read")
    before = RAGGED_LAUNCHES.n
    store.serve_batch(reqs, observe=False)
    torch.cuda.synchronize()
    launched = RAGGED_LAUNCHES.n - before
    want_launches = sum(len(s) > 1 and sum(len(it) for it, _ in s) >= gate
                        for s in subs.values())
    if launched != want_launches:
        fail(f"serve_batch launched the ragged kernel {launched} times, the gate of {gate} "
             f"items says {want_launches}")
    print(f"serve_batch of the drain ({len(reqs)} reads, longest {len(pats[big].items)} "
          f"items): {launched} ragged launches, one a sub-batch over the gate", flush=True)

    rng = np.random.default_rng(RAGGED_SEED)
    gate_rows = _gate_rows(store, pats, RAGGED_CELL, rng, uniform=True)
    del store
    gc.collect()
    torch.cuda.empty_cache()
    _, small_inputs, small, _ = _cell_store(GATE_CELL, RAGGED_SEED)
    gate_rows += _gate_rows(small, small_inputs.patterns, GATE_CELL, rng, uniform=False)
    del small
    gc.collect()
    torch.cuda.empty_cache()
    for label in (RAGGED_CELL, GATE_CELL):
        rows = [r for r in gate_rows if r["config"] == label]
        wins = sorted(r["items"] for r in rows if r["fused_ms"] < r["numpy_ms"])
        loses = sorted(r["items"] for r in rows if r["fused_ms"] >= r["numpy_ms"])
        print(f"item gate, {label}: fused faster at {wins}, numpy at {loses}; the gate is "
              f"{gate}", flush=True)
    longest = max(drain, key=lambda r: r["longest"])
    report["ragged"] = {"sweep": sweep, "drain": drain, "gate": gate_rows, "launches": launched}
    return {"name": "route_expand_ragged", "route": "cuda",
            "source": "src/repro_torch/csrc/route_expand.cu",
            "replaces": "src/repro/kernels/route_expand.py:48", "launches": launched,
            "launches_by_shape": shapes, "max_abs_err": max(r["max_abs_err"] for r in drain),
            "ms": longest["ms"], "host_loop_ms": longest["host_loop_ms"],
            "plain_ms": longest["plain_ms"], "bound_ms": longest["bound_ms"],
            "bound_by": "bytes", "library_ms": None}


# ---------------------------------------------------------------- slice D
# name, placement, routing: the paper pairings of benchmarks/common.py:84-89
# (Fig. 7; Random-3 is also Fig. 16's RP+RR), then Fig. 16's LP+RR
COMPETITORS = (("Random-3", "random", "random"), ("Top-3", "top", "random"),
               ("ADP", "adp", "greedy"), ("DCD", "dcd", "greedy"),
               ("LP+RR", "geolayer", "random"))
N_TEST = 40  # held-out test patterns (bench_online.py's fast size)
# bench_offline.py:24 and :70-81: each algorithm's supersteps (k-core: its
# peel rounds), the message size and the per-DC edge rate the BSP model prices
OFFLINE_ALGOS = {"pagerank": 15, "sssp": 10, "hits": 20, "lpa": 10, "core": None}
OFFLINE_MSG_BYTES, OFFLINE_EDGE_RATE = 192.0, 5e8
# make_benchmark_graph's "tw" family at scale 20 instead of 12: the largest
# R-MAT graph whose host reference and generation fit the run's time limit
RMAT_TW = dict(scale=20, edge_factor=16, a=0.57, b=0.19, c=0.19, seed=0, n_dcs=5)
ANALYTICS_TOL = dict(rtol=1e-4, atol=1e-7)


def held_out_patterns(g, env, history, n_test: int = N_TEST, seed: int = 0):
    """Test patterns drawn as ``benchmarks/common.py:50-69`` draws them:
    revisits of history patterns (each item kept with probability 0.8) plus
    the first quarter of a fresh pattern, made with the lane's k-hop
    settings."""
    import numpy as np

    from repro_torch.core.graph import build_csr
    from repro_torch.core.patterns import Pattern, generate_khop_patterns

    csr = build_csr(g.n_nodes, g.src, g.dst, symmetrize=True)
    rng = np.random.default_rng(seed + 77)
    fresh = generate_khop_patterns(g, csr, n_test, hops=5, branch=2, seed=seed + 1000,
                                   n_dcs=env.n_dcs, n_hot_sources=64)
    test = []
    for i in range(n_test):
        base = history[int(rng.integers(0, len(history)))]
        keep = rng.random(len(base.items)) < 0.8
        tail = fresh[i].items[: max(2, len(fresh[i].items) // 4)]
        items = np.unique(np.concatenate([base.items[keep], tail]))
        test.append(Pattern(pid=10_000 + i, items=items, r_py=base.r_py,
                            w_py=base.w_py, eta=base.eta))
    return test


def mean_online_latency(store, patterns, seed: int = 0) -> float:
    """Mean modelled latency of ``serve_online`` over ``patterns``, each from
    an origin drawn as ``benchmarks/common.py:92-104`` draws it (65% home
    DC, 35% any)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lats = []
    for p in patterns:
        home = int(np.argmax(p.r_py))
        origin = home if rng.random() < 0.65 else int(rng.integers(0, store.env.n_dcs))
        lats.append(store.serve_online(p, origin).latency_s)
    return float(np.mean(lats))


def competitor_phase(report: dict, inputs):
    """Phase 12; returns the GeoLayer store it built (for phase 13) and the
    route-expansion and batched DHD rows checked on RP+SR's inputs, with
    RP+SR's launch counts."""
    import torch

    from repro_torch.core.placement import PlacementConfig
    from repro_torch.core.routing import route_online_batch
    from repro_torch.core.store import GeoGraphStore
    from repro_torch.kernels import ops
    from repro_torch.kernels.cuda_lib import reset_launch_counters

    t_phase = time.perf_counter()
    g, env, wl = inputs
    test = held_out_patterns(g, env, wl.patterns)
    out = {"n_test": len(test), "stores": {}}

    def build(placement, routing, device=DEVICE):
        t = time.perf_counter()
        store = GeoGraphStore(g, env, wl, config=PlacementConfig(), placement=placement,
                              routing=routing, seed=0, device=device)
        if store.device.type == "cuda":
            torch.cuda.synchronize()
        return store, time.perf_counter() - t

    geo, geo_s = build("geolayer", "stepwise")
    geo_lat = mean_online_latency(geo, test)
    out["stores"]["GeoLayer"] = {"build_s": geo_s, "mean_latency_s": geo_lat, "normalised": 1.0}
    print(f"GeoLayer (LP+SR): built in {geo_s:.3f} s, mean online latency over "
          f"{len(test)} held-out patterns {geo_lat * 1e3:.3f} ms", flush=True)
    for name, placement, routing in COMPETITORS:
        store, s = build(placement, routing)
        lat = mean_online_latency(store, test)
        out["stores"][name] = {"placement": placement, "routing": routing, "build_s": s,
                               "mean_latency_s": lat, "normalised": lat / geo_lat,
                               "replicas": int(store.state.delta.sum())}
        print(f"{name} ({placement} placement, {routing} routing): built in {s:.3f} s, "
              f"mean online latency {lat * 1e3:.3f} ms, {lat / geo_lat:.3f}x GeoLayer's",
              flush=True)
        del store

    # RP+SR, the ablation's random placement under stepwise routing: its
    # serving takes route_expand_ragged and its maintain() the batched DHD pair on
    # replica classes the GeoLayer lane never makes
    mirror, mirror_s = build("random", "stepwise", device="cpu")
    reset_launch_counters()
    with DHDRecorder(ops) as rec, RouteRecorder(ops) as route:
        rp, rp_s = build("random", "stepwise")
        launches = {"build": launch_counts()}
        # the same held-out traffic into both demand planes (host routing)
        rp_lat = mean_online_latency(rp, test)
        if rp_lat != mean_online_latency(mirror, test):
            fail("RP+SR serve_online: the card store and its CPU mirror differ")
        served, probs = {}, {}
        for bs in BATCHES:
            reqs = request_stream(rp, bs, seed=bs)
            before = launch_counts()
            t = time.perf_counter()
            got = rp.serve_batch(reqs)
            serve_s = time.perf_counter() - t
            launches[f"serve_{bs}"] = {k: v - before[k] for k, v in launch_counts().items()}
            if not same_results(got, route_online_batch(rp.lg, rp.state, reqs, fast=False)):
                fail(f"RP+SR serve_batch({bs}) on the card differs from the numpy router")
            served[bs] = (reqs, got, serve_s)
            if gated_launch(f"RP+SR serve_batch({bs})", reqs,
                            launches[f"serve_{bs}"]["route_expand_ragged"]):
                probs[bs] = route.last
        rec.phase = "maintain"
        before = launch_counts()
        t = time.perf_counter()
        m = rp.maintain()
        torch.cuda.synchronize()
        maintain_s = time.perf_counter() - t
        launches["maintain"] = {k: v - before[k] for k, v in launch_counts().items()}
    total = launch_counts()
    for k, n in (("route_expand_ragged",
                  sum(launches[f"serve_{b}"]["route_expand_ragged"] for b in BATCHES)),
                 ("dhd_count", launches["maintain"]["dhd_count"]),
                 ("dhd_flow", launches["maintain"]["dhd_flow"])):
        if n <= 0:
            fail(f"kernel {k} was not launched on RP+SR")
    for bs in BATCHES:
        reqs, got, _ = served[bs]
        if not same_results(got, mirror.serve_batch(reqs)):
            fail(f"RP+SR serve_batch({bs}): the card and its CPU mirror differ")
    m_cpu = mirror.maintain()
    rows_delta = int((rp.state.delta != mirror.state.delta).any(axis=1).sum())
    rows_route = int((rp.route_index.nearest != mirror.route_index.nearest).any(axis=1).sum())
    out["stores"]["RP+SR"] = {"placement": "random", "routing": "stepwise", "build_s": rp_s,
                              "mean_latency_s": rp_lat, "normalised": rp_lat / geo_lat}
    print(f"RP+SR: built on the card in {rp_s:.3f} s (CPU mirror {mirror_s:.3f} s), mean "
          f"online latency {rp_lat * 1e3:.3f} ms, {rp_lat / geo_lat:.3f}x GeoLayer's, "
          + ", ".join(f"serve_batch({bs}) {served[bs][2] * 1e3:.3f} ms" for bs in BATCHES)
          + f", each request-identical to the numpy router and the mirror; maintain() "
          f"{maintain_s:.3f} s evicted {m['evicted']} (mirror {m_cpu['evicted']}); "
          f"{rows_delta} replica rows and {rows_route} route rows differ from the mirror; "
          f"launches {total} (per step: {launches})", flush=True)
    if m != m_cpu or rows_delta or rows_route:
        fail("RP+SR maintain() on the card differs from its CPU mirror")

    busy = {}
    reqs = served[BATCHES[-1]][0]
    for name, fn, reps in (
        ("serve_batch_1024", lambda: rp.serve_batch(reqs, observe=False), 5),
        ("maintain_no_evict", lambda: rp.maintain(evict=False), 2),
    ):
        fn()
        torch.cuda.synchronize()
        wall_ms, busy_ms, by_kind, _ = profiled(fn, reps)
        busy[name] = {"device_ms": busy_ms, "wall_ms_profiled": wall_ms,
                      "device_share": busy_ms / wall_ms, "by_kind_ms": by_kind}
        print(f"RP+SR {name}: device busy {busy_ms:.4f} ms of {wall_ms:.3f} ms (profiled "
              f"wall), share {busy_ms / wall_ms:.4f}", flush=True)

    routes = []
    for bs, prob in sorted(probs.items()):
        r = check_ragged(f"RP+SR batch {bs}", prob, timed=True)
        routes.append(r)
        print(f"route_expand_ragged {r['case']}: {r['reads']} reads, {r['items']} items, D "
              f"{r['D']}, L {r['L']}: exact, max abs err {r['max_abs_err']:.3g}, kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms",
              flush=True)
    key = ("maintain", env.n_dcs, False)
    if key not in rec.kept:
        fail("RP+SR maintain() ran no DHD step over the per-DC heat fields")
    heat, cols, vals, q, params = rec.kept[key]
    dhd = check_dhd(f"RP+SR maintain, call {rec.calls[key]}", heat, cols, vals, q, params)
    print(f"dhd {dhd['case']} {dhd['shape']}: count kernel {dhd['count']['ms']:.4f} ms "
          f"(bound {dhd['count']['bound_ms']:.5f}), flow kernel {dhd['flow']['ms']:.4f} ms "
          f"(bound {dhd['flow']['bound_ms']:.5f}), counts equal, flows within atol 1e-5 / "
          f"rtol 1e-4, max abs err {dhd['flow']['max_abs_err']:.3g}", flush=True)
    rp_launches = {"route_expand_ragged": sum(launches[f"serve_{b}"]["route_expand_ragged"]
                                              for b in BATCHES),
                   "dhd_count": launches["maintain"]["dhd_count"],
                   "dhd_flow": launches["maintain"]["dhd_flow"]}
    out["rp_sr"] = {
        "build_s": rp_s, "mirror_build_s": mirror_s, "maintain_s": maintain_s,
        "serve_s": {bs: served[bs][2] for bs in BATCHES}, "evicted": int(m["evicted"]),
        "launches": total, "launches_by_step": launches, "device_busy": busy,
        "route_expand_checks": routes, "dhd_check": dhd,
        "max_replicas_per_item": int(rp.state.delta.sum(axis=1).max()),
    }
    del rp, mirror
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 12 (competitor stores) wall {out['wall_s']:.1f} s", flush=True)
    report["competitors"] = out
    return geo, rp_launches


def geo_layout(store, plan):
    """GeoLayer's offline layout as ``benchmarks/bench_offline.py:27-55``
    picks it: the consolidated plan is adopted only where the BSP model
    prices it below executing in place (or it trades time for WAN bytes);
    returns (vertex sites, assembly bytes charged)."""
    from repro_torch.core import analytics

    site = plan.item_site[: store.g.n_nodes].copy()
    site[site < 0] = store.g.partition[site < 0]
    inplace = store.g.partition.astype("int64")
    c_cons = analytics.simulate_execution(
        store.env, store.g, site, 15, msg_bytes=OFFLINE_MSG_BYTES,
        edge_rate=OFFLINE_EDGE_RATE, assembly_bytes=plan.wan_bytes)
    c_inpl = analytics.simulate_execution(
        store.env, store.g, inplace, 15, msg_bytes=OFFLINE_MSG_BYTES,
        edge_rate=OFFLINE_EDGE_RATE)
    # the reference's three branches reduce to two: its last is reached
    # only when the consolidated layout is no slower
    if c_cons.time_s > c_inpl.time_s and c_cons.wan_bytes >= c_inpl.wan_bytes:
        return inplace, 0.0
    return site, plan.wan_bytes


def offline_layouts(store, plan) -> tuple:
    """GeoLayer's layout (with the assembly bytes it carries) and the
    RAGraph, RAGraph+ and GrapH layouts of ``store``'s graph (traffic: each
    vertex's read rate summed over DCs), each with its host seconds."""
    from repro_torch.core.baselines import (
        layout_graph_h,
        layout_ragraph,
        layout_ragraph_plus,
    )

    g, env = store.g, store.env
    traffic = store.workload.r_xy[: g.n_nodes].sum(axis=1)
    t = time.perf_counter()
    site, assembly = geo_layout(store, plan)
    layouts, secs = {"geolayer": site}, {"geolayer": time.perf_counter() - t}
    for name, fn in (("ragraph", lambda: layout_ragraph(g, env)),
                     ("ragraph+", lambda: layout_ragraph_plus(g, env, traffic)),
                     ("graph_h", lambda: layout_graph_h(g, env, traffic))):
        t = time.perf_counter()
        layouts[name] = fn()
        secs[name] = time.perf_counter() - t
    return layouts, secs, assembly


def offline_phase(report: dict, geo) -> None:
    """Phase 13: offline routing and the competitor layouts on the lane
    store, against a CPU mirror; prices each layout under the BSP model."""
    import numpy as np

    from repro_torch.convert import store_arrays, store_from_numpy
    from repro_torch.core import analytics

    t_phase = time.perf_counter()
    mirror = store_from_numpy(store_arrays(geo), device="cpu")
    req = np.arange(geo.g.n_nodes)
    plans = {}
    for name, store in (("card", geo), ("cpu", mirror)):
        t = time.perf_counter()
        plans[name] = store.plan_offline(req, n_iters=15, msg_bytes=OFFLINE_MSG_BYTES)
        plans[name + "_s"] = time.perf_counter() - t
    plan, plan_cpu = plans["card"], plans["cpu"]
    for f in ("sites", "item_site", "migrated", "excluded"):
        if not np.array_equal(getattr(plan, f), getattr(plan_cpu, f)):
            fail(f"plan_offline: {f} differs from the CPU mirror's")
    if plan.wan_bytes != plan_cpu.wan_bytes:
        fail("plan_offline: wan_bytes differs from the CPU mirror's")
    wall_ms, busy_ms, _, _ = profiled(
        lambda: geo.plan_offline(req, n_iters=15, msg_bytes=OFFLINE_MSG_BYTES))
    print(f"plan_offline({len(req)} vertices): {plans['card_s']:.3f} s, sites "
          f"{plan.sites.tolist()}, excluded {plan.excluded.tolist()}, {len(plan.migrated)} "
          f"migrated, assembly {plan.wan_bytes / 1e6:.3f} MB; equal to the CPU mirror's; "
          f"device busy {busy_ms:.4f} ms of {wall_ms:.1f} ms", flush=True)
    layouts, secs, assembly = offline_layouts(geo, plan)
    layouts_cpu, _, assembly_cpu = offline_layouts(mirror, plan_cpu)
    for name, site in layouts.items():
        if not np.array_equal(site, layouts_cpu[name]):
            fail(f"offline layout {name} differs from the CPU mirror's")
    if assembly != assembly_cpu:
        fail("GeoLayer's assembly bytes differ from the CPU mirror's")
    print("layouts (host s): " + ", ".join(
        f"{k} {v:.3f} s, {float((layouts[k] != geo.g.partition).mean()):.4f} migrated"
        for k, v in secs.items()) + "; each equal to the CPU mirror's", flush=True)
    g, env = geo.g, geo.env
    priced = {}
    for algo, iters in OFFLINE_ALGOS.items():
        if iters is None:
            _, iters = analytics.core_decomposition(g.n_nodes, g.src, g.dst)
        stats = {}
        for name, site in layouts.items():
            ex = analytics.simulate_execution(
                env, g, site, n_iters=iters, msg_bytes=OFFLINE_MSG_BYTES,
                edge_rate=OFFLINE_EDGE_RATE,
                assembly_bytes=assembly if name == "geolayer" else 0.0)
            stats[name] = {"time_s": ex.time_s, "wan_bytes": ex.wan_bytes,
                           "sites": ex.n_sites, "cut_edges": ex.cut_edges}
        base = stats["ragraph"]
        for s in stats.values():
            s["speedup_vs_ragraph"] = base["time_s"] / s["time_s"]
            s["wan_vs_ragraph"] = s["wan_bytes"] / base["wan_bytes"] if base["wan_bytes"] else None
        priced[algo] = {"iters": int(iters), "layouts": stats}
        print(f"{algo} ({iters} supersteps): " + "; ".join(
            f"{k} {s['time_s']:.4f} s, {s['wan_bytes'] / 1e6:.2f} MB WAN, "
            f"{s['speedup_vs_ragraph']:.3f}x RAGraph" for k, s in stats.items()), flush=True)
    wall = time.perf_counter() - t_phase
    report["offline"] = {
        "plan_s": plans["card_s"], "plan_cpu_s": plans["cpu_s"],
        "sites": plan.sites.tolist(), "excluded": plan.excluded.tolist(),
        "migrated": int(len(plan.migrated)), "assembly_bytes": plan.wan_bytes,
        "plan_device_busy_ms": busy_ms, "plan_wall_ms_profiled": wall_ms,
        "layout_s": secs, "priced": priced, "wall_s": wall,
    }
    print(f"phase 13 (offline routing and layouts) wall {wall:.1f} s", flush=True)


def analytics_bytes(algo: str, n: int, m: int, index_bytes: int) -> int:
    """Bytes one iteration must move at the least: each index array read
    once a pass, vertex arrays read and written once (f32 or int32).
    PageRank: src, dst, rank and out-degree in, rank out.  SSSP: src, dst,
    weights, distances in and out.  HITS: two dependent passes (each pass's
    norm divides before the next), each reading src and dst.  LPA: one pass
    gives both minima, labels in and out."""
    per_pass = 2 * index_bytes * m
    return {"pagerank": per_pass + 12 * n, "sssp": per_pass + 4 * m + 8 * n,
            "hits": 2 * per_pass + 16 * n, "lpa": per_pass + 8 * n}[algo]


def run_analytics(label: str, g) -> dict:
    """PageRank (15), SSSP (10, weights ``edge_size``, source 0), HITS (20)
    and LPA (10) over ``g`` on the card and on the host; SSSP and LPA must
    be equal, PageRank and HITS within ``ANALYTICS_TOL``."""
    import torch

    from repro_torch.core import analytics

    n, m = int(g.n_nodes), int(len(g.src))
    algos = {
        "pagerank": (15, lambda s, d, w, dev: analytics.pagerank(s, d, n, 15, device=dev)),
        "sssp": (10, lambda s, d, w, dev: analytics.sssp(s, d, w, 0, n, 10, device=dev)),
        "hits": (20, lambda s, d, w, dev: analytics.hits(s, d, n, 20, device=dev)),
        "lpa": (10, lambda s, d, w, dev: analytics.label_propagation(s, d, n, 10, device=dev)),
    }
    on = {dev: (torch.as_tensor(g.src).to(dev, torch.int64),
                torch.as_tensor(g.dst).to(dev, torch.int64),
                torch.as_tensor(g.edge_size).to(dev, torch.float32))
          for dev in (DEVICE, "cpu")}
    rows = {}
    for algo, (iters, fn) in algos.items():
        def run(dev):
            return fn(*on[dev], dev)

        run(DEVICE)  # warm-up
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        got = run(DEVICE)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        wall_ms, busy_ms, by_kind, _ = profiled(lambda: run(DEVICE))
        t = time.perf_counter()
        want = run("cpu")
        cpu_s = time.perf_counter() - t
        pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
        err = 0.0
        for a, b in pairs:
            a = a.cpu()
            if algo in ("sssp", "lpa"):
                if not torch.equal(a, b):
                    fail(f"{algo} on {label}: the card's result is not equal to the host's")
            elif not torch.allclose(a, b, **ANALYTICS_TOL):
                fail(f"{algo} on {label}: the card's result is outside rtol 1e-4 / atol 1e-7 "
                     f"of the host's")
            finite = torch.isfinite(b)
            if bool(finite.any()):
                err = max(err, float((a[finite].double() - b[finite].double()).abs().max()))
        bound = {ib: analytics_bytes(algo, n, m, ib) / HBM_BYTES_PER_S * 1e3 for ib in (4, 8)}
        rows[algo] = {
            "iters": iters, "ms": ms, "ms_per_iter": ms / iters,
            "edges_per_s": m * iters / (ms / 1e3), "bound_ms_per_iter_i32": bound[4],
            "bound_ms_per_iter_i64": bound[8], "device_busy_ms": busy_ms,
            "wall_ms_profiled": wall_ms, "device_share": busy_ms / wall_ms,
            "by_kind_ms": by_kind, "cpu_s": cpu_s, "max_abs_err": err,
        }
        r = rows[algo]
        print(f"{algo} on {label} ({iters} iterations): {r['ms_per_iter']:.4f} ms an "
              f"iteration, {r['edges_per_s'] / 1e9:.3f} G edges/s, bound {bound[4]:.4f} ms "
              f"(int32 indices) / {bound[8]:.4f} ms (int64); device busy share "
              f"{r['device_share']:.3f} under the profiler; host {cpu_s:.3f} s; "
              f"{'equal' if algo in ('sssp', 'lpa') else 'within rtol 1e-4'} "
              f"(max abs err {err:.3g})", flush=True)
    del on
    return rows


def analytics_phase(report: dict, lane_graph):
    """Phase 14: the analytics on the lane graph (with k-core on the host)
    and on an R-MAT graph of the "tw" family at scale 20, which it returns
    (phase 18's halo lane runs on it)."""
    import numpy as np

    from repro_torch.core.analytics import core_decomposition
    from repro_torch.data.synthetic import rmat_graph

    t_phase = time.perf_counter()
    out = {}
    g = lane_graph
    t = time.perf_counter()
    core, rounds = core_decomposition(g.n_nodes, g.src, g.dst)
    core_s = time.perf_counter() - t
    print(f"lane graph: {g.n_nodes} vertices, {len(g.src)} edges; core_decomposition on "
          f"the host {core_s:.3f} s, max core {int(core.max())}, {rounds} peel rounds",
          flush=True)
    out["lane"] = {"n": int(g.n_nodes), "m": int(len(g.src)), "core_s": core_s,
                   "max_core": int(core.max()), "core_rounds": int(rounds),
                   "algos": run_analytics("the lane graph", g)}
    t = time.perf_counter()
    big = rmat_graph(**RMAT_TW)
    gen_s = time.perf_counter() - t
    indeg = int(np.bincount(big.dst, minlength=big.n_nodes).max())
    print(f"rmat_graph({RMAT_TW}): {big.n_nodes} vertices, {len(big.src)} edges, max "
          f"in-degree {indeg}, generated on the host in {gen_s:.1f} s", flush=True)
    out["rmat_tw_20"] = {"n": int(big.n_nodes), "m": int(len(big.src)), "gen_s": gen_s,
                         "max_in_degree": indeg,
                         "algos": run_analytics(f"R-MAT tw scale {RMAT_TW['scale']}", big)}
    out["wall_s"] = time.perf_counter() - t_phase
    report["analytics"] = out
    print(f"phase 14 (graph analytics) wall {out['wall_s']:.1f} s", flush=True)
    return big


# ------------------------------------------------------- slices C and E
# bench_scheduler.py's trace seed and flush thresholds; requests a trace,
# one shard a DC (the sharded store's default), phase 5's churn rate twice
CP_SEED, CP_REQUESTS, CP_SHARDS = 13, 8192, 5
CP_PLAN_KW = dict(theta_add=0.3, theta_drop=0.15)
CP_CHURN = (0.01, 2)
# the route fast path's item gate during path (c): one-shard drains of the
# mixed trace hold 1-3 requests on the lane, far under the default gate
CP_FAST_MIN_ITEMS = 1


def cp_trace(store, regime: str, n: int, seed: int = CP_SEED) -> list:
    """``benchmarks/bench_scheduler.py::make_trace``: ``(t, items, origin,
    priority, deadline)`` with the 65% home / 35% remote origin mix."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pats = [p for p in store.workload.patterns if len(p.items)]

    def pick():
        p = pats[int(rng.integers(0, len(pats)))]
        home = int(np.argmax(p.r_py))
        return p.items, home if rng.random() < 0.65 else int(rng.integers(0, store.env.n_dcs))

    out, t = [], 0.0
    if regime == "bursty":  # 80-request bursts every 0.5 s, spread over 1 ms
        while len(out) < n:
            for _ in range(min(80, n - len(out))):
                items, origin = pick()
                out.append((t + float(rng.random()) * 1e-3, items, origin, 0, 0.5))
            t += 0.5
    elif regime == "mixed":  # 4 ms gaps; 70% interactive (0.3 s), 30% bulk (3.0 s)
        for _ in range(n):
            t += float(rng.exponential(0.004))
            items, origin = pick()
            out.append((t, items, origin, 0, 0.3) if rng.random() < 0.7
                       else (t, items, origin, 1, 3.0))
    else:
        raise ValueError(regime)
    return out


def cp_window(store) -> float:
    """``bench_scheduler.py:166-168``: a transfer window of three median
    items over the slowest link, so a flush splits into many waves."""
    import numpy as np

    return 3.0 * float(np.median(store.g.item_size())) / float(store.env.bw_Bps_safe().min())


class RouteRecorder:
    """Installed over ``kernels.ops.route_expand_flat_ids`` (the name the
    routing fast path calls): passes every call on and keeps, as numpy, the
    inputs of the widest call (most items) and of the last, as
    :func:`check_ragged` takes them: ``(ids, table_bits, table_sizes,
    offsets, origin, comp, shift)``, the tables as they stood."""

    def __init__(self, ops) -> None:
        import threading

        self.ops = ops
        self.fn = ops.route_expand_flat_ids
        self.calls = 0
        self.widest = self.last = None
        self._lock = threading.Lock()  # shard threads may route at once

    @staticmethod
    def _host(x, dt):
        import numpy as np

        x = x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)
        return np.ascontiguousarray(x, dt)

    def __call__(self, ids, bounds, origin, tables, comp, device=None, shift=0):
        import numpy as np

        prob = tuple(self._host(x, dt) for x, dt in (
            (ids, np.int32), (tables[0], np.int32), (tables[1], np.float32),
            (bounds, np.int32), (origin, np.int32), (comp, np.int32))) + (shift,)
        with self._lock:
            self.calls += 1
            self.last = prob
            if self.widest is None or len(prob[0]) > len(self.widest[0]):
                self.widest = prob
        return self.fn(ids, bounds, origin, tables, comp, device=device, shift=shift)

    def __enter__(self) -> "RouteRecorder":
        self.ops.route_expand_flat_ids = self
        return self

    def __exit__(self, *exc) -> None:
        self.ops.route_expand_flat_ids = self.fn


class CheckedStore:
    """What the admission controller of path (c) drives: the sharded store,
    with every drain held to the numpy router on the state it was served
    from, and the drain's wall time, size and shard busy seconds kept.
    Every other attribute is the store's own."""

    def __init__(self, store, sync) -> None:
        self.store = store
        self.sync = sync
        self.wall_s, self.sizes, self.busy = [], [], {}
        self.largest = None

    def __getattr__(self, name):
        return getattr(self.store, name)

    def serve_batch(self, requests, observe: bool = True):
        from repro_torch.core.routing import route_online_batch

        t = time.perf_counter()
        got = self.store.serve_batch(requests, observe=observe)
        self.sync()
        self.wall_s.append(time.perf_counter() - t)
        self.sizes.append(len(requests))
        for sid, dt in self.store.last_shard_seconds.items():
            self.busy[sid] = self.busy.get(sid, 0.0) + dt
        if self.largest is None or len(requests) > len(self.largest):
            self.largest = list(requests)
        want = route_online_batch(self.store.lg, self.store.state, requests, fast=False)
        if not same_results(got, want):
            fail(f"control plane: a drain of {len(requests)} requests differs from the "
                 f"numpy router")
        return got


def link_bytes(snapshot: dict) -> dict:
    """``migration.device_bytes_link`` cells of a metrics snapshot by link."""
    return {tag: cell["value"]
            for tag, cell in snapshot.get("migration.device_bytes_link", {}).items()}


def run_controller(store, trace, config, window, waves: list):
    """The control plane of ``bench_scheduler.py:171-186`` over ``trace``:
    an ``AdmissionController`` with ``config`` and a ``MaintenancePolicy``
    (flush armed, periodic ``maintain``); ``waves`` receives each applied
    wave's per-link item counts.  Returns ``(controller, policy, handles)``."""
    from repro_torch.serve import (
        AdmissionController,
        MaintenanceConfig,
        MaintenancePolicy,
        StoreClient,
    )

    def measure(wave):  # the policy's own default: the Eq. 1 estimate
        waves.append([(b.src, b.dst, len(b.items)) for b in wave.links])
        return wave.makespan_s

    policy = MaintenancePolicy(
        store.store if isinstance(store, CheckedStore) else store,
        MaintenanceConfig(window_s=window, plan_kw=dict(CP_PLAN_KW), maintain_every_s=1.0,
                          maintain_cost_s=1e-4),
        measure_wave=measure)
    ctl = AdmissionController(store, config, policy=policy)
    client = StoreClient(ctl)
    policy.request_flush()
    for t, items, origin, prio, deadline in trace:
        client.submit(items, origin, deadline_s=deadline, priority=prio, at=t)
    done = ctl.run_until_idle()
    if len(done) != len(trace):
        fail(f"control plane: {len(done)} of {len(trace)} requests completed")
    return ctl, policy, done


def same_state(sh, flat, step: str, payload_tol: float) -> float:
    """Path (a)'s invariants after ``step``: equal replica sets and routes,
    every shard partition equal to its coordinator column, every held
    payload row within ``payload_tol`` of its content.  Returns the payload
    deviation."""
    import numpy as np

    if not np.array_equal(sh.state.delta, flat.state.delta):
        fail(f"control plane, {step}: replica sets of the sharded and unsharded stores differ")
    if not (np.array_equal(sh.route_table(), sh.state.route)
            and np.array_equal(sh.state.route, flat.state.route)):
        fail(f"control plane, {step}: route_table(), state.route or the unsharded routes differ")
    if not sh.verify_partitions():
        fail(f"control plane, {step}: a shard partition differs from its coordinator column")
    dev = sh.verify_payloads()
    if not dev <= payload_tol:
        fail(f"control plane, {step}: payload deviation {dev} above {payload_tol}")
    return dev


def _drive_control_plane(inputs_fn, device: str, n_req: int, say, recording) -> dict:
    """Paths (a)-(c) of phase 15 on ``device``; returns the stores, the
    results and what ``recording()`` (a context manager around path (c))
    gave.  Counts are set to 0 just before path (c) and read just after."""
    import hashlib

    import numpy as np
    import torch

    from repro_torch.core import routing
    from repro_torch.core.placement import PlacementConfig
    from repro_torch.core.routing import route_online_batch
    from repro_torch.core.store import GeoGraphStore
    from repro_torch.distributed import ShardedGeoGraphStore
    from repro_torch.kernels.cuda_lib import reset_launch_counters
    from repro_torch.obs import export_chrome_trace
    from repro_torch.serve import AdmissionConfig
    from repro_torch.streaming import DeltaGraph, random_churn_batch

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    out: dict = {}
    # (a) identity: build both stores from fresh inputs of the same seeds
    t = time.perf_counter()
    # parallel=True: (a) compares the pool with serial dispatch, and on one card
    # the store takes no pool by default
    sh = ShardedGeoGraphStore(*inputs_fn(), config=PlacementConfig(), n_shards=CP_SHARDS,
                              fetch_payload=True, telemetry=True, compress="int8",
                              parallel=True, device=device)
    sync()
    out["build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    flat = GeoGraphStore(*inputs_fn(), config=PlacementConfig(), device=device)
    sync()
    out["flat_build_s"] = time.perf_counter() - t
    if sh.verify_payloads() != 0.0:
        fail("control plane, build: a payload row differs from its content")
    same_state(sh, flat, "build", 0.0)
    say(f"sharded store ({CP_SHARDS} shards on {sorted({str(s.device) for s in sh.shards})}, "
        f"{sh.g.n_items} items, int8 transfers) built in {out['build_s']:.3f} s, unsharded "
        f"in {out['flat_build_s']:.3f} s: equal replica sets and routes, partitions equal "
        f"to the coordinator, payloads exact")
    serve = []
    pool = sh._pool
    for bs in BATCHES:
        reqs = request_stream(flat, bs, seed=bs)
        t = time.perf_counter()
        got = sh.serve_batch(reqs, observe=False)
        pool_s = time.perf_counter() - t
        busy = dict(sh.last_shard_seconds)
        sh._pool = None  # the same store dispatching its shards serially
        try:
            t = time.perf_counter()
            serial = sh.serve_batch(reqs, observe=False)
            serial_s = time.perf_counter() - t
            busy_serial = dict(sh.last_shard_seconds)
        finally:
            sh._pool = pool
        want = flat.serve_batch(reqs, observe=False)
        numpy = route_online_batch(flat.lg, flat.state, reqs, fast=False)
        for name, res in (("the thread pool", got), ("serial dispatch", serial),
                          ("the unsharded store", want)):
            if not same_results(res, numpy):
                fail(f"control plane: serve_batch({bs}) through {name} differs from the "
                     f"numpy router")
        row = {"batch": bs, "pool_s": pool_s, "serial_s": serial_s}
        # bench_sharded.py's rates from the shards' busy seconds, under the
        # pool (threads share the interpreter) and under serial dispatch
        for name, b in (("pool", busy), ("serial_dispatch", busy_serial)):
            row[name] = {"busy_sum_s": sum(b.values()), "busy_max_s": max(b.values()),
                         "serial_rps": bs / sum(b.values()),
                         "aggregate_rps": bs / max(b.values())}
        serve.append(row)
        say(f"serve_batch({bs}): request-identical to the numpy router through the thread "
            f"pool ({pool_s * 1e3:.3f} ms), serially ({serial_s * 1e3:.3f} ms) and on the "
            f"unsharded store; " + "; ".join(
                f"{name}: shard busy sum {r['busy_sum_s'] * 1e3:.3f} ms, max "
                f"{r['busy_max_s'] * 1e3:.3f} ms, serial {r['serial_rps']:.1f}, aggregate "
                f"{r['aggregate_rps']:.1f} requests/s"
                for name, r in ((k, row[k]) for k in ("pool", "serial_dispatch"))))
    out["serve"] = serve
    rate, n_batches = CP_CHURN
    streams = {}
    for s in (sh, flat):
        s._delta_graph = DeltaGraph(s.g)
        streams[id(s)] = np.random.default_rng(7)
    out["churn"] = []
    for i in range(n_batches):
        row = {}
        for name, s in (("sharded", sh), ("flat", flat)):
            batch = random_churn_batch(s._delta_graph, rate, streams[id(s)])
            t = time.perf_counter()
            s.apply_updates(batch)
            sync()
            row[f"{name}_apply_s"] = time.perf_counter() - t
        t = time.perf_counter()
        sh._sync_payloads()  # what apply_updates ran last, timed alone
        sync()
        row["sync_payloads_s"] = time.perf_counter() - t
        row["payload_dev"] = same_state(sh, flat, f"churn batch {i + 1}", 1.0 / 127)
        out["churn"].append(row)
        say(f"churn batch {i + 1} at {rate:g}: sharded apply_updates {row['sharded_apply_s']:.3f}"
            f" s, unsharded {row['flat_apply_s']:.3f} s; _sync_payloads "
            f"{row['sync_payloads_s'] * 1e3:.3f} ms ({len(sh.shards)} blocks of "
            f"{sh.g.n_items} x {sh.payload_width} f32); states equal")
    window = cp_window(flat)
    t = time.perf_counter()
    p_sh = sh.flush_migrations(window_s=window, **CP_PLAN_KW)
    sync()
    flush_s = time.perf_counter() - t
    p_flat = flat.flush_migrations(window_s=window, **CP_PLAN_KW)
    if (p_sh.n_adds, p_sh.schedule.n_waves) != (p_flat.n_adds, p_flat.schedule.n_waves):
        fail(f"control plane, flush: the sharded store planned {p_sh.n_adds} adds in "
             f"{p_sh.schedule.n_waves} waves, the unsharded {p_flat.n_adds} in "
             f"{p_flat.schedule.n_waves}")
    dev = same_state(sh, flat, "flush", 1.0 / 127)
    m_sh, m_flat = sh.maintain(), flat.maintain()
    if m_sh != m_flat:
        fail(f"control plane, maintain: {m_sh} against the unsharded store's {m_flat}")
    dev = max(dev, same_state(sh, flat, "maintain", 1.0 / 127))
    out["flush"] = {"window_s": window, "adds": p_sh.n_adds, "waves": p_sh.schedule.n_waves,
                    "flush_s": flush_s, "payload_dev": dev, "maintain": m_sh}
    say(f"flush (window {window:.3g} s): {p_sh.n_adds} adds in {p_sh.schedule.n_waves} "
        f"waves on both stores, {flush_s:.3f} s sharded; maintain() {m_sh} on both; payload "
        f"deviation {dev:.3g} (bound 1/127)")

    # (b) the control plane over each store on one bursty trace
    trace = cp_trace(flat, "bursty", n_req)
    runs = {}
    for name, s in (("flat", flat), ("sharded", sh)):
        before = link_bytes(s.merged_metrics()) if name == "sharded" else {}
        waves: list = []
        t = time.perf_counter()
        ctl, policy, done = run_controller(s, trace, AdmissionConfig(policy="adaptive"),
                                           window, waves)
        sync()
        wall = time.perf_counter() - t
        text = export_chrome_trace(ctl.tracer)
        runs[name] = (ctl, policy, done, text)
        if policy.n_waves < 1:
            fail(f"control plane, bursty trace on the {name} store: no migration wave applied")
        out[f"bursty_{name}"] = {
            "wall_s": wall, "sha256": hashlib.sha256(text.encode()).hexdigest(),
            "metrics": ctl.metrics(), "policy": policy.stats(),
            "waves_by_link_items": _items_by_link(waves)}
        if name == "sharded":
            out["bursty_sharded"]["device_bytes_link"] = _diff(
                link_bytes(s.merged_metrics()), before)
    (c1, p1, d1, t1), (c2, p2, d2, t2) = runs["flat"], runs["sharded"]
    if t1 != t2:
        fail("control plane, bursty trace: the chrome traces of the two stores differ")
    if [(h.rid, h.t_dispatch) for h in d1] != [(h.rid, h.t_dispatch) for h in d2] or [
            (b.t_dispatch, b.size, b.target) for b in c1.history] != [
            (b.t_dispatch, b.size, b.target) for b in c2.history]:
        fail("control plane, bursty trace: the formed batches of the two stores differ")
    same_state(sh, flat, "bursty trace", 1.0 / 127)
    alone, rel = bursty_results_match(d1, d2)
    out["bursty_alone_in_sub_batch"] = {"requests": alone, "max_rel_dev": rel}
    say(f"bursty trace ({n_req} requests, adaptive): chrome traces byte-identical (sha256 "
        f"{out['bursty_sharded']['sha256'][:16]}), {c2.metrics()['n_batches']} equal batches, "
        f"results equal (floats of the {alone} requests alone in their origin's sub-batch "
        f"within rtol {SCALAR_RTOL:g}, max {rel:.3g}: the scalar router sums bytes in f32), "
        f"{p2.n_waves} waves and {p2.n_maintains} maintains on each store (flush in progress "
        f"at the end: {p2.flush_in_progress}; int8 wire bytes by link "
        f"{out['bursty_sharded']['device_bytes_link']} against fp32 "
        f"{_fp32_bytes(out['bursty_sharded']['waves_by_link_items'], sh.payload_width)}); wall "
        f"{out['bursty_flat']['wall_s']:.2f} s unsharded, {out['bursty_sharded']['wall_s']:.2f}"
        f" s sharded")

    # (c) per-shard AIMD on the sharded store over the mixed trace: the
    # kernels' path, every drain held to the numpy router
    trace = cp_trace(flat, "mixed", n_req)
    checked = CheckedStore(sh, sync)
    before = link_bytes(sh.merged_metrics())
    wave_s0 = sh.registry.snapshot().get("migration.device_wave_s", {}).get("-", {})
    waves = []
    gate = routing.FUSED_MIN_ITEMS
    routing.FUSED_MIN_ITEMS = CP_FAST_MIN_ITEMS
    try:
        with recording(sh) as recorded:
            reset_launch_counters()
            t = time.perf_counter()
            ctl, policy, done = run_controller(
                checked, trace, AdmissionConfig(policy="adaptive", per_shard_aimd=True,
                                                max_batch=256), window, waves)
            sync()
            wall = time.perf_counter() - t
            launches = launch_counts()
    finally:
        routing.FUSED_MIN_ITEMS = gate
    m = ctl.metrics()
    sizes = np.asarray(checked.sizes)
    lat = {p: np.asarray([h.latency_s for h in done if h.priority == p]) for p in (0, 1)}
    wave_s1 = sh.registry.snapshot().get("migration.device_wave_s", {}).get("-", {})
    dev_wave_s = wave_s1.get("sum", 0.0) - wave_s0.get("sum", 0.0)
    busy = checked.busy
    c = {
        "wall_s": wall, "launches": launches, "metrics": m, "policy": policy.stats(),
        "drains": int(len(sizes)), "drain_median_wall_s": float(np.median(checked.wall_s)),
        "drain_wall_s_p99": float(np.quantile(checked.wall_s, 0.99)),
        "drain_sizes": {str(k): int(v) for k, v in zip(*np.unique(sizes, return_counts=True))},
        "sim_p50_p99_s": {("interactive", "bulk")[p]: [float(np.quantile(v, 0.5)),
                                                       float(np.quantile(v, 0.99))]
                          for p, v in lat.items() if len(v)},
        "device_wave_s": dev_wave_s,
        "waves_by_link_items": _items_by_link(waves),
        "device_bytes_link": _diff(link_bytes(sh.merged_metrics()), before),
        "busy_sum_s": sum(busy.values()), "busy_max_s": max(busy.values()),
        "serial_rps": len(done) / sum(busy.values()),
        "aggregate_rps": len(done) / max(busy.values()),
        "straggler": sh.straggler.snapshot(),
    }
    out["control_plane"] = c
    fp32 = _fp32_bytes(c["waves_by_link_items"], sh.payload_width)
    say(f"path (c), per-shard AIMD over the mixed trace ({n_req} requests): {c['drains']} "
        f"drains, each request-identical to the numpy router; drain wall median "
        f"{c['drain_median_wall_s'] * 1e3:.3f} ms (p99 {c['drain_wall_s_p99'] * 1e3:.3f}); "
        f"drain sizes {c['drain_sizes']} (the route fast path was pinned from "
        f"{CP_FAST_MIN_ITEMS} item up, under the default gate of {gate}); wall "
        f"{wall:.2f} s")
    say(f"path (c): sim-clock p50/p99 by class {c['sim_p50_p99_s']}; deadline misses "
        f"{m['deadline_misses']} by cause {m['misses_by_cause']}; targets by shard "
        f"{m.get('batch_target_by_shard')}; flagged shards {m.get('straggler_shards')}")
    say(f"path (c): {policy.n_waves} waves, {policy.n_maintains} maintains, device wave "
        f"seconds {dev_wave_s:.4f}; int8 wire bytes by link {c['device_bytes_link']} against "
        f"fp32 {fp32}; shard busy sum {c['busy_sum_s']:.3f} s, max {c['busy_max_s']:.3f} s: "
        f"serial {c['serial_rps']:.1f}, aggregate {c['aggregate_rps']:.1f} requests/s")
    say(f"path (c) launches: {launches}")
    return {"store": sh, "flat": flat, "out": out, "launches": launches,
            "recorded": recorded, "largest_drain": checked.largest}


# a request alone in its origin's sub-batch of a sharded drain takes the
# scalar router, which sums item bytes in f32 where the batch router's fold
# sums them in f64 (as in the JAX package): its latencies and WAN bytes
# agree with the unsharded batch to f32 summation, not to the bit
SCALAR_RTOL = 1e-5


def bursty_results_match(flat_done, sharded_done) -> tuple:
    """Path (b)'s results, request by request: picks, layers, misses and
    DCs equal; latencies and WAN bytes equal, except for requests alone in
    their origin's sub-batch of a drain of several requests, which hold
    within ``SCALAR_RTOL``.  Returns (how many such requests, their largest
    relative deviation)."""
    import numpy as np

    drains: dict = {}
    for h in sharded_done:
        drains.setdefault(h.t_dispatch, []).append(h.origin)
    alone, worst = 0, 0.0
    for hf, hs in zip(flat_done, sharded_done):
        a, b = hf.result, hs.result
        if not (np.array_equal(a.served_by, b.served_by) and a.layers_used == b.layers_used
                and a.n_missing == b.n_missing
                and np.array_equal(np.sort(a.dcs), np.sort(b.dcs))
                and sorted(a.per_dc_latency) == sorted(b.per_dc_latency)):
            fail(f"control plane, bursty trace: request {hs.rid}'s picks differ between "
                 f"the stores")
        floats = [(a.latency_s, b.latency_s), (a.wan_bytes, b.wan_bytes)] + [
            (a.per_dc_latency[d], b.per_dc_latency[d]) for d in a.per_dc_latency]
        if all(x == y for x, y in floats):
            continue
        origins = drains[hs.t_dispatch]
        if len(origins) < 2 or origins.count(hs.origin) != 1:
            fail(f"control plane, bursty trace: request {hs.rid}'s latencies differ between "
                 f"the stores, and it was not alone in its origin's sub-batch")
        rel = max(abs(x - y) / max(abs(x), 1e-30) for x, y in floats)
        if rel > SCALAR_RTOL:
            fail(f"control plane, bursty trace: request {hs.rid}, alone in its sub-batch, "
                 f"deviates by {rel:.3g} (rtol {SCALAR_RTOL:g})")
        alone, worst = alone + 1, max(worst, rel)
    return alone, worst


def _items_by_link(waves: list) -> dict:
    by: dict = {}
    for wave in waves:
        for src, dst, n in wave:
            key = f"src={src},dst={dst}"
            by[key] = by.get(key, 0) + n
    return by


def _fp32_bytes(items_by_link: dict, width: int) -> dict:
    """What the same transfers would put on the wire uncompressed."""
    return {k: n * width * 4 for k, n in items_by_link.items()}


def _diff(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0.0) for k, v in after.items() if v - before.get(k, 0.0)}


# the kernels path (c) must launch: the route expansion, the batched DHD
# pair (maintain's 5 heat fields) and the single-field pair (the warm field)
CP_KERNELS = MAIN_KERNELS + SINGLE_KERNELS


def control_plane_phase(report: dict, card: str) -> dict:
    """Phase 15: slices C and E at full width on the card.  Returns the
    control-plane path's launches by kernel."""
    import contextlib

    import torch

    from repro_torch.core import routing
    from repro_torch.kernels import ops

    def say(msg: str) -> None:
        print(f"[{card}] {msg}", flush=True)

    @contextlib.contextmanager
    def recording(store):
        with DHDRecorder(ops) as dhd, SweepRecorder(ops, store) as sweep, \
                RouteRecorder(ops) as route:
            dhd.phase = sweep.phase = "control plane"
            yield {"dhd": dhd, "sweep": sweep, "route": route}

    t_phase = time.perf_counter()
    res = _drive_control_plane(build_inputs, DEVICE, CP_REQUESTS, say, recording)
    sh, out, launches, rec = res["store"], res["out"], res["launches"], res["recorded"]
    for name in CP_KERNELS:
        if launches.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched on the control-plane path: {launches}")

    r = check_ragged("control plane, widest call", rec["route"].widest, timed=True)
    checks = {"route_expand_ragged": r}
    say(f"route_expand_ragged on path (c)'s widest call ({r['reads']} reads, {r['items']} "
        f"items): exact, max abs err {r['max_abs_err']:.3g}, kernel "
        f"{r['ms']:.4f} ms (host loop {r['host_loop_ms']:.4f}), plain {r['plain_ms']:.4f} ms, "
        f"bound {r['bound_ms']:.3g} ms; {rec['route'].calls} launches recorded")
    dkey = ("control plane", sh.env.n_dcs, False)
    if dkey not in rec["dhd"].kept:
        fail(f"path (c) ran no batched DHD step over the per-DC heat fields: "
             f"{sorted(rec['dhd'].kept)}")
    heat, cols, vals, q, params = rec["dhd"].kept[dkey]
    d = check_dhd(f"control plane maintain, call {min(rec['dhd'].calls[dkey], rec['dhd'].KEEP_AT)}"
                  f" of {rec['dhd'].calls[dkey]}", heat, cols, vals, q, params)
    checks["dhd"] = d
    say(f"dhd {d['case']} {d['shape']}: counts equal, flows within atol 1e-5 / rtol 1e-4 "
        f"(max abs err {d['flow']['max_abs_err']:.3g}); count kernel {d['count']['ms']:.4f} ms "
        f"(bound {d['count']['bound_ms']:.5f}), flow kernel {d['flow']['ms']:.4f} ms (bound "
        f"{d['flow']['bound_ms']:.5f})")
    skeys = sorted(k for k in rec["sweep"].kept if k[1] == "global")
    if not skeys:
        fail(f"path (c) ran no single-field sweep: {sorted(rec['sweep'].kept)}")
    skey = skeys[-1]
    heat, cols, vals, q, params = rec["sweep"].kept[skey]
    d1 = check_dhd_single(f"control plane, {skey[1]} sweep, call "
                          f"{min(rec['sweep'].calls[skey], rec['sweep'].KEEP_AT)} of "
                          f"{rec['sweep'].calls[skey]}", heat, cols, vals, q, params)
    checks["dhd_single"] = d1
    say(f"dhd single {d1['case']} {d1['shape']}: counts equal, flows within atol 1e-5 / "
        f"rtol 1e-4 (max abs err {d1['flow']['max_abs_err']:.3g}); count kernel "
        f"{d1['count']['ms']:.4f} ms (bound {d1['count']['bound_ms']:.5f}), flow kernel "
        f"{d1['flow']['ms']:.4f} ms (bound {d1['flow']['bound_ms']:.5f})")

    # one drain of path (c) under the profiler, with path (c)'s routing gate
    drain = res["largest_drain"]
    gate = routing.FUSED_MIN_ITEMS
    routing.FUSED_MIN_ITEMS = CP_FAST_MIN_ITEMS
    try:
        sh.serve_batch(drain, observe=False)
        torch.cuda.synchronize()
        wall_ms, busy_ms, by_kind, _ = profiled(lambda: sh.serve_batch(drain, observe=False),
                                                reps=5)
    finally:
        routing.FUSED_MIN_ITEMS = gate
    out["drain_profile"] = {"requests": len(drain), "wall_ms_profiled": wall_ms,
                            "device_ms": busy_ms, "device_share": busy_ms / wall_ms,
                            "by_kind_ms": by_kind}
    say(f"one drain of {len(drain)} requests under the profiler: device busy {busy_ms:.4f} ms "
        f"of {wall_ms:.3f} ms, share {busy_ms / wall_ms:.4f}; "
        + ", ".join(f"{k.strip()} {v:.4f}" for k, v in by_kind.items()))
    out["checks"] = checks
    out["wall_s"] = time.perf_counter() - t_phase
    report["control_plane"] = out
    say(f"phase 15 (control plane over the sharded store) wall {out['wall_s']:.1f} s")
    return {k: launches.get(k, 0) for k in CP_KERNELS}


# ------------------------------------------------------------- slice H
# phase 18: the GNNs at configs/base.py's GNN shapes and the configs'
# _FULL widths, then the halo executor on phase 14's R-MAT graph
GNN_STEPS = 4
# EquiformerV2's OC20 learning rate (arXiv:2306.12059), for every arch
GNN_OPT = dict(lr=2e-4, warmup_steps=1, total_steps=GNN_STEPS)
GNN_HOLD_DEPTH = 2  # layers, interactions or steps of the card-vs-host hold
# a gradient leaf whose host RMS is under this share of the largest leaf's
# is zero in exact arithmetic (equiformer-v2's attention logits' last bias:
# the segment softmax does not move when a destination's logits shift
# alike) and is held by its gap over the largest leaf's RMS
GNN_ZERO_LEAF = 1e-6
EQV2_CHUNKS, EQV2_CHUNK_TOL, EQV2_ROT_TOL = 4, 1e-5, 2e-5
# molecule: 128 graphs of 30 atoms, 64 edges each, atoms within 3 A of the
# molecule's centre (every edge under the 8 A cutoff), each molecule in its
# own frame near the origin as a QM9-style batch has it
MOLECULE_ATOMS, MOLECULE_EDGES, MOLECULE_RADIUS = 30, 64, 3.0
# minibatch_lg: NeighborSampler blocks over a community graph with the
# resident table's vertex count and a mean degree about 32 (symmetrized), so
# fanouts 15 and 10 fill; one block a training step, sampled ahead
MB_FANOUTS, MB_SEEDS = (15, 10), 1024
CITE_NODES, CITE_EDGES = 2708, 10556  # full_graph_sm's real (unpadded) Cora sizes
MB_GRAPH = dict(n_communities=64, p_in=0.0082, p_out=1e-5, seed=0)
HALO_SHARDS, HALO_D, HALO_LAYERS, HALO_TOL = 8, 100, 3, 1e-4
HALO_BUDGETS = (0.05, 0.1, 0.25, 0.5)


def gnn_shape(name: str):
    from repro_torch.configs import GNN_SHAPES

    return next(s for s in GNN_SHAPES if s.name == name)


def molecule_batch(seed: int) -> dict:
    """``molecule``: 128 molecules of 30 atoms (3,840 of the 4,096 padded
    nodes), 64 edges inside each (all 8,192 edges), 16 soft-species
    features (a Dirichlet(0.2) mix a real atom), per-graph ``energy``."""
    import numpy as np

    s = gnn_shape("molecule")
    rng = np.random.default_rng(seed)
    G, A, K = s.n_graphs, MOLECULE_ATOMS, MOLECULE_EDGES
    real = G * A
    if G * K != s.n_edges or real > s.n_nodes:
        fail(f"molecule batch: {G} x {A} atoms, {G} x {K} edges do not fit {s}")
    x = np.zeros((s.n_nodes, s.d_feat), np.float32)
    x[:real] = rng.dirichlet(np.full(s.d_feat, 0.2), real)
    centres = rng.uniform(-2.0, 2.0, (G, 3))
    u = rng.standard_normal((real, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    r = MOLECULE_RADIUS * rng.random(real) ** (1 / 3)
    pos = np.zeros((s.n_nodes, 3), np.float32)
    pos[:real] = np.repeat(centres, A, 0) + u * r[:, None]
    a = rng.integers(0, A, (G, K))
    b = (a + rng.integers(1, A, (G, K))) % A
    base = (np.arange(G) * A)[:, None]
    gid = np.zeros(s.n_nodes, np.int32)
    gid[:real] = np.repeat(np.arange(G), A)
    return {"x": x, "pos": pos, "edge_src": (base + a).reshape(-1).astype(np.int32),
            "edge_dst": (base + b).reshape(-1).astype(np.int32),
            "edge_mask": np.ones(s.n_edges, bool), "node_mask": np.arange(s.n_nodes) < real,
            "graph_id": gid, "energy": rng.standard_normal(G).astype(np.float32)}


def citation_batch(seed: int) -> dict:
    """``full_graph_sm`` (Cora's size): 2,708 of 3,072 nodes with 1,433
    binary word features (1.27% set, Cora's mean of 18 words), 10,556 of
    10,752 edges between distinct real nodes, 7 classes, random positions
    (EGNN's coordinates); padding masked."""
    import numpy as np

    s = gnn_shape("full_graph_sm")
    rng = np.random.default_rng(seed)
    n, e = CITE_NODES, CITE_EDGES
    x = (rng.random((s.n_nodes, s.d_feat)) < 0.0127).astype(np.float32)
    x[n:] = 0.0
    src = np.zeros(s.n_edges, np.int32)
    dst = np.zeros(s.n_edges, np.int32)
    src[:e] = rng.integers(0, n, e)
    dst[:e] = (src[:e] + rng.integers(1, n, e)) % n
    return {"x": x, "pos": rng.standard_normal((s.n_nodes, 3)).astype(np.float32),
            "edge_src": src, "edge_dst": dst, "edge_mask": np.arange(s.n_edges) < e,
            "node_mask": np.arange(s.n_nodes) < n,
            "labels": rng.integers(0, s.n_classes, s.n_nodes).astype(np.int32)}


def minibatch_blocks(seed: int, n_blocks: int) -> tuple:
    """``minibatch_lg``: a community graph of the resident table's 233,472
    vertices (``MB_GRAPH``), ``n_blocks`` ``NeighborSampler`` blocks of
    1,024 seeds at fanouts 15 and 10 (padded to 169,984 nodes and 168,960
    edges, ``block_capacity``), random positions and 41-class labels, and
    the resident 233,472 x 602 f32 feature table drawn on the card.
    Returns (blocks as numpy dicts, the table, facts)."""
    import numpy as np
    import torch

    from repro_torch.core.graph import build_csr
    from repro_torch.data.sampler import NeighborSampler, block_capacity
    from repro_torch.data.synthetic import community_graph

    s = gnn_shape("minibatch_lg")
    t = time.perf_counter()
    g = community_graph(s.resident_nodes, **MB_GRAPH)
    csr = build_csr(g.n_nodes, g.src, g.dst, symmetrize=True)
    gen_s = time.perf_counter() - t
    deg = np.diff(csr.indptr)
    if block_capacity(MB_SEEDS, MB_FANOUTS) != (s.n_nodes, s.n_edges):
        fail(f"minibatch blocks {block_capacity(MB_SEEDS, MB_FANOUTS)} do not match {s}")
    sampler = NeighborSampler(csr, MB_FANOUTS, seed=seed)
    rng = np.random.default_rng(seed)
    blocks, t = [], time.perf_counter()
    for _ in range(n_blocks):
        blk = sampler.sample(rng.choice(g.n_nodes, MB_SEEDS, replace=False))
        blocks.append({"node_ids": blk.node_ids, "node_mask": blk.node_mask,
                       "edge_src": blk.edge_src, "edge_dst": blk.edge_dst,
                       "edge_mask": blk.edge_mask,
                       "pos": rng.standard_normal((s.n_nodes, 3)).astype(np.float32),
                       "labels": rng.integers(0, s.n_classes, s.n_nodes).astype(np.int32)})
    sample_s = (time.perf_counter() - t) / n_blocks
    table = torch.randn((s.resident_nodes, s.d_feat), generator=torch.Generator(
        device=DEVICE).manual_seed(seed), device=DEVICE)
    facts = {"graph": f"community_graph({s.resident_nodes}, **{MB_GRAPH})", "n": int(g.n_nodes),
             "m": int(len(g.src)), "mean_degree_symmetrized": float(deg.mean()),
             "share_under_15": float((deg < 15).mean()), "graph_s": gen_s,
             "sample_s_per_block": sample_s,
             "filled_nodes": [int(b["node_mask"].sum()) for b in blocks],
             "filled_edges": [int(b["edge_mask"].sum()) for b in blocks]}
    return blocks, table, facts


def _gnn_kind(kernel: str) -> str:
    """A device event's kind in a GNN step: a gather or scatter (indexing,
    its sorted backward, ``index_add_``), else as :func:`_kind_of`."""
    n = kernel.lower()
    if any(w in n for w in ("index", "gather", "scatter")):
        return "gather/scatter"
    return _kind_of(kernel)


def no_launches(label: str) -> None:
    """Phase 18's path reaches no kernel of the library: every count 0."""
    launched = {k: n for k, n in launch_counts().items() if n}
    if launched:
        fail(f"{label} launched {launched}; the GNN path reaches no kernel")


def train_gnn(label: str, arch, shape: str, batches: list, report: dict,
              profile: bool = False):
    """``GNN_STEPS`` ``Trainer`` steps of ``arch`` at full width on
    ``batches`` (one a step; AdamW with one warm-up step, the final
    checkpoint in a temporary directory under ``build/``, removed after),
    counts set to 0 just before and read just after: every loss finite,
    peak memory under the card's, no kernel launched.  With ``profile``,
    one more step under the profiler.  Returns the trainer."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.kernels.cuda_lib import reset_launch_counters
    from repro_torch.train.optimizer import OptConfig, tree_paths
    from repro_torch.train.trainer import Trainer, TrainerConfig

    s = gnn_shape(shape)
    (ROOT / "build").mkdir(exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="train_gnn_", dir=ROOT / "build")
    torch.cuda.reset_peak_memory_stats()
    params = arch.init_fn(torch.Generator(device=DEVICE).manual_seed(0), s.d_feat,
                          arch._d_out(s), True, DEVICE)
    n_params = sum(p.numel() for _, p in tree_paths(params))
    try:
        tr = Trainer(arch.loss_fn(shape), params, TrainerConfig(
            total_steps=GNN_STEPS, ckpt_every=GNN_STEPS + 1, ckpt_dir=ckpt_dir,
            opt=OptConfig(**GNN_OPT)), device=DEVICE)
        del params
        reset_launch_counters()
        t = time.perf_counter()
        metrics = tr.run(batches[i % len(batches)] for i in range(GNN_STEPS))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t
        no_launches(f"{label} training")
        peak = torch.cuda.max_memory_allocated()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    losses, step_ms = metrics["loss"], [x * 1e3 for x in metrics["step_time"]]
    med = float(np.median(step_ms))
    out = {"arch": arch.name, "shape": shape, "n_params": n_params, "losses": losses,
           "step_ms": step_ms, "step_median_ms": med, "peak_memory_bytes": peak,
           "run_s": run_s}
    print(f"{label} on {shape} ({s.n_nodes} nodes, {s.n_edges} edges, {n_params / 1e6:.3f} M "
          f"parameters): {GNN_STEPS} steps, median {med:.2f} ms (" + ", ".join(
              f"{x:.2f}" for x in step_ms) + " ms), loss " + " -> ".join(
              f"{x:.5g}" for x in losses) + f"; peak memory {peak / 1e9:.3f} GB; no kernel "
          f"launched", flush=True)
    if len(losses) != GNN_STEPS or not np.isfinite(losses).all():
        fail(f"{label} training: losses {losses}")
    if peak >= CARD_BYTES:
        fail(f"{label} training: peak memory {peak / 1e9:.2f} GB")
    if profile:
        batch = {k: torch.as_tensor(v, device=DEVICE) for k, v in batches[0].items()}
        wall_ms, busy_ms, by_kind, _ = profiled(
            lambda: tr._update(tr.params, tr.opt_state, tr.comp_state, batch))
        top = dict(sorted(by_kind.items(), key=lambda kv: -kv[1])[:10])
        kinds: dict = {}
        for kname, ms in by_kind.items():
            kinds[_gnn_kind(kname)] = kinds.get(_gnn_kind(kname), 0.0) + ms
        out["profiled_step"] = {"wall_ms": wall_ms, "device_ms": busy_ms,
                                "device_share": busy_ms / wall_ms, "by_kind_ms": kinds,
                                "top_ms": top}
        print(f"  one {label} step profiled: device busy {busy_ms:.2f} ms of {wall_ms:.2f} ms, "
              f"share {busy_ms / wall_ms:.4f}; by kind " + ", ".join(
                  f"{k} {v:.2f}" for k, v in sorted(kinds.items(), key=lambda kv: -kv[1]))
              + "; top: " + ", ".join(f"{k.strip()[:48]} {v:.2f}" for k, v in top.items()),
              flush=True)
        del batch
    report.setdefault("gnn", {})[label] = out
    return tr


def gnn_rel_rms_gaps(got: dict, want: dict) -> dict:
    """Each gradient leaf's RMS gap over its ``want`` RMS (f64), over the
    largest leaf's RMS where its own is under ``GNN_ZERO_LEAF`` of that."""
    from repro_torch.train.optimizer import tree_paths

    flat = {k: w.double() for k, w in tree_paths(want)}
    rms = {k: float(w.pow(2).mean().sqrt()) for k, w in flat.items()}
    top = max(rms.values())
    gaps = {}
    for key, g in tree_paths(got):
        diff = float((g.to(flat[key].device, flat[key].dtype) - flat[key]).pow(2).mean().sqrt())
        gaps[key] = diff / (rms[key] if rms[key] >= GNN_ZERO_LEAF * top else top)
    return gaps


def gnn_variants() -> dict:
    """Each arch at ``GNN_HOLD_DEPTH`` layers, interactions or steps, full
    width, with its shape and whether its forward runs at full width in f32
    (``full``: meshgraphnet's full forward is bf16, so its hold runs the
    same params through the f32 forward)."""
    from repro_torch.configs import GNNArch, get_arch
    from repro_torch.configs import egnn as cfg_egnn
    from repro_torch.configs import schnet as cfg_schnet

    d = GNN_HOLD_DEPTH
    return {
        "equiformer-v2": (get_arch("equiformer-v2").variant(d), "molecule", True),
        "schnet": (GNNArch(f"schnet@L{d}", *cfg_schnet._variant(d)), "molecule", True),
        "egnn": (GNNArch(f"egnn@L{d}", *cfg_egnn._variant(d)), "full_graph_sm", True),
        "meshgraphnet": (get_arch("meshgraphnet").variant(d), "minibatch_lg", False),
    }


def gnn_grad_hold(name: str, batch: dict, report: dict, table=None) -> None:
    """Phase 18 (c): ``name`` at ``GNN_HOLD_DEPTH`` and full width in f32,
    params drawn on the host (seed 3) and carried to the card: the first
    step's loss and every gradient leaf on the card against the same step
    on the host, within atol/rtol 1e-3 and each leaf's relative RMS gap
    within ``GRAD_REL_RMS`` (phase 17's gates); no kernel launched."""
    import torch

    from repro_torch.kernels.cuda_lib import reset_launch_counters
    from repro_torch.train.optimizer import tree_map, tree_paths
    from repro_torch.train.trainer import value_and_grad

    arch, shape, full = gnn_variants()[name]
    s = gnn_shape(shape)
    host = arch.init_fn(torch.Generator().manual_seed(3), s.d_feat, arch._d_out(s), True, "cpu")
    card = tree_map(lambda p: p.to(DEVICE), host)
    grad = value_and_grad(arch.loss_fn(shape, full))

    def on(dev):
        b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if table is not None:
            b["feats_resident"] = table.to(dev)
        return b

    reset_launch_counters()
    (lc, _), gc_ = grad(card, on(DEVICE))
    torch.cuda.synchronize()
    no_launches(f"{name} gradient hold")
    t = time.perf_counter()
    (lh, _), gh = grad(host, on("cpu"))
    host_s = time.perf_counter() - t
    gaps = gnn_rel_rms_gaps(gc_, gh)
    flat = dict(tree_paths(gh))
    bad = [k for k, g in tree_paths(gc_)
           if not (torch.isfinite(g).all() and torch.allclose(g.cpu(), flat[k], **GRAD_TOL))]
    if not torch.allclose(lc.cpu(), lh, **GRAD_TOL):
        bad.append(f"loss {float(lc)} vs {float(lh)}")
    worst = max(gaps, key=gaps.get)
    out = {"arch": arch.name, "shape": shape, "loss_card": float(lc), "loss_host": float(lh),
           "n_leaves": len(gaps), "max_rel_rms_gap": gaps[worst], "worst_leaf": worst,
           "rel_rms_gap": gaps, "host_s": host_s}
    report.setdefault("gnn_grad_hold", {})[name] = out
    print(f"gradient hold, {arch.name} on {shape}, f32: loss {float(lc):.7g} on the card vs "
          f"{float(lh):.7g} on the host; {len(gaps)} leaves, largest relative RMS gap "
          f"{gaps[worst]:.3g} at {worst} (host step {host_s:.1f} s)", flush=True)
    loose = [f"{k} ({v:.3g})" for k, v in gaps.items() if not v <= GRAD_REL_RMS]
    if bad or loose:
        fail(f"{name} gradient hold: outside atol/rtol 1e-3: {bad}; relative RMS gap past "
             f"{GRAD_REL_RMS}: {loose}")


def eqv2_checks(tr, batch: dict, report: dict) -> None:
    """Phase 18 (a)'s chunk check and (c)'s rotation check: with the
    trained 12-layer params, layer 1 on layer 0's output by
    ``layer_apply_chunked`` at ``EQV2_CHUNKS`` chunks against
    ``layer_apply`` within ``EQV2_CHUNK_TOL``; then ``equiformer-v2`` at
    ``GNN_HOLD_DEPTH`` layers on the batch and on its positions under a
    random rotation, outputs within ``EQV2_ROT_TOL``."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.kernels.cuda_lib import reset_launch_counters
    from repro_torch.models.gnn import equiformer_v2 as eq
    from repro_torch.models.layers import unstack

    s = gnn_shape("molecule")
    spec = dataclasses.replace(eq.EqV2Spec(), n_species=s.d_feat)
    b = {k: torch.as_tensor(v, device=DEVICE) for k, v in batch.items()}
    reset_launch_counters()
    with torch.no_grad():
        lay = unstack(tr.params["layers"], spec.n_layers)
        x = b["x"].new_zeros((s.n_nodes, spec.dim, spec.channels))
        x[:, 0, :] = b["x"] @ tr.params["embed"]
        geom = eq.prepare_geometry(b, spec)
        x1 = eq.layer_apply(x, lay[0], geom, spec)
        want = eq.layer_apply(x1, lay[1], geom, spec)
        got = eq.layer_apply_chunked(x1, lay[1], b, spec, EQV2_CHUNKS)
        chunk_err = float((got - want).abs().max())
        arch, _, _ = gnn_variants()["equiformer-v2"]
        p = arch.init_fn(torch.Generator(device=DEVICE).manual_seed(5), s.d_feat, 1, True, DEVICE)
        q, _ = np.linalg.qr(np.random.default_rng(7).standard_normal((3, 3)))
        if np.linalg.det(q) < 0:
            q[:, 0] *= -1
        rot = dict(b, pos=b["pos"] @ torch.as_tensor(q.T, dtype=torch.float32, device=DEVICE))
        o1 = arch.forward_fn(p, b, True, "molecule")
        o2 = arch.forward_fn(p, rot, True, "molecule")
        rot_err = float((o1 - o2).abs().max())
        out_max = float(o1.abs().max())
    no_launches("equiformer-v2 chunk and rotation checks")
    report["gnn_eqv2_checks"] = {"chunks": EQV2_CHUNKS, "chunk_edges": s.n_edges // EQV2_CHUNKS,
                                 "chunk_max_abs_err": chunk_err,
                                 "layer_out_max": float(want.abs().max()),
                                 "rotation_max_abs_err": rot_err, "output_max": out_max}
    print(f"equiformer-v2 layer 1 of the trained params, {EQV2_CHUNKS} chunks of "
          f"{s.n_edges // EQV2_CHUNKS} edges vs unchunked: max abs err {chunk_err:.3g} (layer "
          f"output up to {float(want.abs().max()):.3g}); {GNN_HOLD_DEPTH} layers under a random "
          f"rotation of the positions: max abs err {rot_err:.3g} (outputs up to {out_max:.3g})",
          flush=True)
    if not chunk_err <= EQV2_CHUNK_TOL:
        fail(f"equiformer-v2: chunked layer off by {chunk_err:.3g} (limit {EQV2_CHUNK_TOL})")
    if not rot_err <= EQV2_ROT_TOL:
        fail(f"equiformer-v2: rotation moves the outputs by {rot_err:.3g} (limit {EQV2_ROT_TOL})")


def halo_phase(report: dict, big) -> None:
    """Phase 18 (d): ``big`` (phase 14's R-MAT graph) in ``HALO_SHARDS``
    ``balanced_bfs_partition`` shards; ``build_halo_program``; 3 layers of
    ``run_message_passing`` at d = 100 in halo and in allgather mode on
    ``mesh_devices(8)`` (every shard this card), each within ``HALO_TOL``
    of the dense message passing over the global edges on the card, and
    the wire bytes ``transfer_rows`` reports equal to ``exchange_stats``'
    per-device bytes x 8; ms a layer by CUDA events, one halo layer
    profiled; ``plan_gnn_halo``'s resolve fractions at ``HALO_BUDGETS``
    (``examples/gnn_halo_placement.py``'s heat and 15 layers)."""
    import numpy as np
    import torch

    from repro_torch.data.partition import balanced_bfs_partition, edge_cut, hash_partition
    from repro_torch.distributed.geo_sharding import mesh_devices, plan_gnn_halo
    from repro_torch.distributed.halo_exec import (
        build_halo_program, exchange_stats, run_message_passing,
    )
    from repro_torch.kernels.cuda_lib import reset_launch_counters

    P, d, L = HALO_SHARDS, HALO_D, HALO_LAYERS
    n, m = int(big.n_nodes), int(len(big.src))
    t = time.perf_counter()
    part = balanced_bfs_partition(n, big.src, big.dst, P)
    part_s = time.perf_counter() - t
    cut, hash_cut = edge_cut(part, big.src, big.dst), edge_cut(hash_partition(n, P), big.src,
                                                              big.dst)
    big.partition = part
    t = time.perf_counter()
    prog = build_halo_program(big, P)
    build_s = time.perf_counter() - t
    out = {"n": n, "m": m, "shards": P, "d": d, "layers": L, "partition_s": part_s,
           "edge_cut": cut, "hash_edge_cut": hash_cut, "build_s": build_s,
           "n_max": prog.n_max, "s_max": prog.s_max, "e_max": prog.e_max}
    print(f"halo lane: R-MAT {n} vertices, {m} edges in {P} shards: balanced_bfs_partition "
          f"{part_s:.1f} s on the host, edge cut {cut:.4f} (hash {hash_cut:.4f}); "
          f"build_halo_program {build_s:.2f} s, n_max {prog.n_max}, s_max {prog.s_max}, "
          f"e_max {prog.e_max}", flush=True)

    rng = np.random.default_rng(0)
    feats = rng.standard_normal((n, d)).astype(np.float32)
    w = torch.as_tensor((rng.standard_normal((d, d)) * 0.1).astype(np.float32), device=DEVICE)
    devices = mesh_devices(P, DEVICE)
    placed = prog.place(devices)
    sharded = torch.as_tensor(prog.scatter_features(feats), device=DEVICE)
    src = torch.as_tensor(big.src, device=DEVICE).long()
    dst = torch.as_tensor(big.dst, device=DEVICE).long()
    deg = torch.zeros(n, device=DEVICE).index_add_(0, dst, torch.ones(m, device=DEVICE))

    def dense(layers: int):
        x = torch.as_tensor(feats, device=DEVICE)
        for _ in range(layers):
            agg = torch.zeros_like(x).index_add_(0, dst, x[src] @ w)
            x = x + torch.tanh(agg / deg.clamp_min(1.0)[:, None])
        return x

    def timed(fn):
        fn(1)  # warm-up
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        reset_launch_counters()
        start.record()
        res = fn(L)
        end.record()
        end.synchronize()
        return res, start.elapsed_time(end) / L

    ref, dense_ms = timed(dense)
    no_launches("dense message passing")
    ids = [torch.as_tensor(i, device=DEVICE) for i in prog.local_ids]
    stats = exchange_stats(prog, d, L)
    out["dense_ms_per_layer"] = dense_ms
    out["exchange_stats"] = stats
    for mode in ("halo", "allgather"):
        (blocks, wire), ms = timed(lambda k: run_message_passing(
            prog, devices, sharded, w, n_layers=k, mode=mode, placed=placed))
        no_launches(f"{mode} message passing")
        err = max(float((b[: len(i)] - ref[i]).abs().max()) for b, i in zip(blocks, ids))
        want = stats[f"{mode}_bytes_per_device"] * P
        out[mode] = {"ms_per_layer": ms, "wire_bytes": wire, "wire_bytes_per_layer": wire / L,
                     "max_abs_err": err}
        print(f"{mode} mode, {L} layers at d = {d}: {ms:.3f} ms a layer (dense {dense_ms:.3f}); "
              f"wire {wire:.0f} bytes ({wire / L / 1e6:.1f} MB a layer; exchange_stats x {P}: "
              f"{want}); max abs err vs dense {err:.3g}", flush=True)
        if not err <= HALO_TOL:
            fail(f"{mode} message passing is {err:.3g} from the dense run (limit {HALO_TOL})")
        if wire != want:
            fail(f"{mode} message passing moved {wire} bytes; exchange_stats x {P} says {want}")
        del blocks
    wall_ms, busy_ms, by_kind, _ = profiled(lambda: run_message_passing(
        prog, devices, sharded, w, n_layers=1, mode="halo", placed=placed))
    top = dict(sorted(by_kind.items(), key=lambda kv: -kv[1])[:8])
    out["halo_layer_profiled"] = {"wall_ms": wall_ms, "device_ms": busy_ms,
                                  "device_share": busy_ms / wall_ms, "top_ms": top}
    print(f"  one halo layer profiled: device busy {busy_ms:.2f} ms of {wall_ms:.2f} ms, share "
          f"{busy_ms / wall_ms:.4f}; top: " + ", ".join(
              f"{k.strip()[:40]} {v:.2f}" for k, v in top.items()), flush=True)
    del ref, sharded, placed, src, dst, deg

    heat = np.minimum(np.random.default_rng(0).zipf(1.5, n).astype(float), 50)
    plans = {}
    for budget in HALO_BUDGETS:
        t = time.perf_counter()
        plan = plan_gnn_halo(big, P, vertex_heat=heat, n_layers=15, budget_frac=budget)
        plans[budget] = {"halo_vertices": int(sum(len(h) for h in plan.halo)),
                         "resolve_frac": plan.resolve_frac, "s": time.perf_counter() - t}
    out["plan_gnn_halo"] = plans
    print("plan_gnn_halo (zipf(1.5) heat capped at 50, 15 layers): " + "; ".join(
        f"budget {b:.2f}: {v['halo_vertices']} halo vertices, {100 * v['resolve_frac']:.1f}% "
        f"of cut edges resolved ({v['s']:.2f} s)" for b, v in plans.items()), flush=True)
    report["halo"] = out


def gnn_phase(report: dict, big=None) -> None:
    """Phase 18, slice H on the card: (a) equiformer-v2 at full width and
    depth trained on ``molecule``, one step profiled, its chunked layer
    against the unchunked; (b) schnet on ``molecule``, egnn on
    ``full_graph_sm``, meshgraphnet on ``minibatch_lg``; (c) each arch's
    gradient at 2 layers held against the host, and equiformer-v2's
    rotation invariance; (d) the halo executor on ``big`` (phase 14's R-MAT
    graph; generated here when None)."""
    import gc

    import torch

    from repro_torch.configs import get_arch

    t_phase = time.perf_counter()
    mol, cite = molecule_batch(0), citation_batch(1)
    tr = train_gnn("equiformer-v2", get_arch("equiformer-v2"), "molecule", [mol], report,
                   profile=True)
    eqv2_checks(tr, mol, report)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    train_gnn("schnet", get_arch("schnet"), "molecule", [mol], report, profile=True)
    train_gnn("egnn", get_arch("egnn"), "full_graph_sm", [cite], report, profile=True)
    blocks, table, facts = minibatch_blocks(2, GNN_STEPS)
    report.setdefault("gnn", {})["minibatch_lg_blocks"] = facts
    print(f"minibatch_lg: {facts['graph']}: {facts['m']} edges, mean degree "
          f"{facts['mean_degree_symmetrized']:.2f} symmetrized ({100 * facts['share_under_15']:.2f}"
          f"% of vertices under 15) in {facts['graph_s']:.1f} s; NeighborSampler "
          f"{facts['sample_s_per_block']:.2f} s a block, blocks fill {facts['filled_nodes']} "
          f"nodes and {facts['filled_edges']} edges", flush=True)
    train_gnn("meshgraphnet", get_arch("meshgraphnet"), "minibatch_lg",
              [dict(b, feats_resident=table) for b in blocks], report, profile=True)
    gc.collect()
    torch.cuda.empty_cache()
    for name, batch in (("equiformer-v2", mol), ("schnet", mol), ("egnn", cite)):
        gnn_grad_hold(name, batch, report)
    gnn_grad_hold("meshgraphnet", blocks[0], report, table=table)
    del blocks, table
    gc.collect()
    torch.cuda.empty_cache()
    if big is None:
        from repro_torch.data.synthetic import rmat_graph

        big = rmat_graph(**RMAT_TW)
    halo_phase(report, big)
    report["gnn_phase_s"] = time.perf_counter() - t_phase
    print(f"phase 18 (slice H: GNNs and the halo executor) wall {report['gnn_phase_s']:.1f} s",
          flush=True)


# phase 19, slice I: the production mesh.  One dry-run cell a family on the
# single-pod mesh; (b) and (c) take phase 17's arch, batch and microbatches
DRYRUN_CELLS = (("qwen3-0.6b", "train_4k"), ("deepseek-v2-lite-16b", "prefill_32k"),
                ("gemma3-27b", "decode_32k"), ("schnet", "full_graph_sm"),
                ("bst", "train_batch"))
PEAK_GEMM_N, HBM_COPY_BYTES = 8192, 4 << 30


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dryrun_cells(report: dict) -> dict:
    """Phase 19 (a): the dry run of ``DRYRUN_CELLS`` on the single-pod mesh
    in this process.  Returns the records by cell key."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.mesh import fake_world, make_production_mesh

    records = {}
    with fake_world(256):
        mesh = make_production_mesh(device_type=DEVICE)
        for name, shape in DRYRUN_CELLS:
            arch = get_arch(name)
            cell = next(c for c in arch.cells() if c.shape == shape)
            t = time.perf_counter()
            rec = dryrun.run_cell(cell, mesh, "single")
            rec["ok"], rec["wall_s"] = True, time.perf_counter() - t
            p = rec["production"]
            mem = p["memory"]
            if not (p["flops_per_device"] > 0 and p["state_bytes_per_device"] > 0
                    and p["collectives"] and mem["argument_bytes"] > 0):
                fail(f"dry run {cell.key}: incomplete record {p}")
            mf = roofline.model_flops(name, shape, arch.family) / 256
            a = roofline.analyze(rec)
            records[cell.key] = rec
            print(f"dry run {cell.key} on (16, 16) in {rec['wall_s']:.1f} s: state "
                  f"{p['state_bytes_per_device'] / 2**30:.3f} GiB a device, args "
                  f"{mem['argument_bytes'] / 2**30:.3f} GiB, temp {mem['temp_bytes'] / 2**30:.2f} "
                  f"GiB; {p['flops_per_device']:.4e} FLOPs a device against model_flops / 256 "
                  f"{mf:.4e} ({p['flops_per_device'] / mf:.2f}x); {p['local_ops']} local ops; "
                  f"dominant {a['dominant']}; collectives "
                  + ", ".join(f"{k} {int(v['count'])} ({v['wire_bytes']:.4e} wire B)"
                              for k, v in sorted(p["collectives"].items())), flush=True)
    out_dir = ROOT / "chiprun_out" / "dryrun"
    out_dir.mkdir(parents=True, exist_ok=True)
    for rec in records.values():
        cell = next(c for c in get_arch(rec["arch"]).cells() if c.shape == rec["shape"])
        (out_dir / pathlib.Path(dryrun.result_path("single", cell)).name).write_text(
            json.dumps(rec, indent=1))
    report["mesh_dryrun"] = records
    return records


def accumulated_grads(loss_fn, params, batch, microbatch: int):
    """Phase 17's step before the optimizer (``Trainer._update``): the
    batch in ``microbatch`` slices, each slice's loss and gradients summed
    in f32, then divided by ``microbatch``."""
    import torch

    from repro_torch.train.optimizer import tree_map
    from repro_torch.train.trainer import value_and_grad

    grad_fn = value_and_grad(loss_fn)
    loss = torch.zeros((), dtype=torch.float32, device=DEVICE)
    grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    for i in range(microbatch):
        sub = {k: x[i * (x.shape[0] // microbatch):(i + 1) * (x.shape[0] // microbatch)]
               for k, x in batch.items()}
        (l, _), g = grad_fn(params, sub)
        loss = loss + l
        grads = tree_map(torch.add, grads, g)
        del g
    return loss / microbatch, tree_map(lambda g: g / microbatch, grads)


def sharded_train_step(report: dict) -> dict:
    """Phase 19 (b): one ``qwen3-0.6b`` training step on a real one-rank
    mesh of DTensors against the same step on plain tensors.  Returns the
    kernel table's path entry."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import Cell
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.distributed.constraints import use_mesh
    from repro_torch.distributed.sharding import distribute_tree
    from repro_torch.kernels.cuda_lib import launch_counters, reset_launch_counters
    from repro_torch.launch.mesh import make_cpu_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import OptConfig, adamw_init, adamw_update, tree_paths

    arch = get_arch(TRAIN_ARCH)
    cfg = arch.cfg
    backend = "nccl" if DEVICE == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://localhost:{free_port()}", rank=0,
                            world_size=1)
    try:
        mesh = make_cpu_mesh((1, 1), device_type=DEVICE)
        params = tf.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0), DEVICE,
                                at_rest=torch.float32)
        opt = adamw_init(params)
        batch = {k: torch.as_tensor(v, device=DEVICE) for k, v in TokenPipeline(
            cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=0).batch_at(0).items()}
        loss_fn = lambda p, b: tf.train_loss(p, b, cfg)  # noqa: E731
        ocfg = OptConfig(**TRAIN_OPT)
        t = time.perf_counter()
        loss_u, grads_u = accumulated_grads(loss_fn, params, batch, TRAIN_MICROBATCH)
        new_u, _, _ = adamw_update(grads_u, opt, params, ocfg)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t

        pspec, ospec = arch.param_partition((params, opt))
        cell = Cell(TRAIN_ARCH, "train_4k", "train")
        (_,), (bspec,) = arch.inputs(cell, mesh)
        dparams = distribute_tree(params, mesh, pspec)
        dopt = distribute_tree(opt, mesh, ospec)
        dbatch = distribute_tree(batch, mesh, bspec)
        if not all(isinstance(x, DTensor) for _, x in tree_paths({"p": dparams, "o": dopt})):
            fail("phase 19 (b): a param or moment is not a DTensor")
        reset_launch_counters()
        t = time.perf_counter()
        with use_mesh(mesh):
            loss_s, grads_s = accumulated_grads(loss_fn, dparams, dbatch, TRAIN_MICROBATCH)
            new_s, _, _ = adamw_update(grads_s, dopt, dparams, ocfg)
        torch.cuda.synchronize()
        sharded_s = time.perf_counter() - t
        launches = {k: c.n for k, c in launch_counters().items() if c.n}
        want = TRAIN_MICROBATCH * cfg.n_layers * (2 if cfg.remat else 1)
        if DEVICE == "cuda" and launches != {"flash_attention": want}:
            fail(f"phase 19 (b) launched {launches}, want flash_attention {want}")
        local = lambda t_: t_.to_local() if isinstance(t_, DTensor) else t_  # noqa: E731
        got_g = {k: local(v) for k, v in tree_paths(grads_s)}
        got_p = {k: local(v) for k, v in tree_paths(new_s)}
        rms, gaps = rel_rms_gaps(got_g, dict(tree_paths(grads_u)))
        _, pgaps = rel_rms_gaps(got_p, dict(tree_paths(new_u)))
        want_g, want_p = dict(tree_paths(grads_u)), dict(tree_paths(new_u))
        equal_g = sum(bool(torch.equal(got_g[k], want_g[k])) for k in want_g)
        equal_p = sum(bool(torch.equal(got_p[k], want_p[k])) for k in want_p)
        lu, ls = float(loss_u), float(local(loss_s))
        loss_gap = abs(ls - lu) / abs(lu)
        bit_equal = (bool(torch.equal(local(loss_s), loss_u)) and equal_g == len(want_g)
                     and equal_p == len(want_p))
        out = {"arch": cfg.name, "mesh": [1, 1], "backend": backend, "batch": TRAIN_BATCH,
               "seq": TRAIN_SEQ, "microbatch": TRAIN_MICROBATCH, "launches": launches,
               "loss_plain": lu, "loss_sharded": ls, "rel_loss_gap": loss_gap,
               "grad_leaves": len(want_g), "grad_leaves_bit_equal": equal_g,
               "param_leaves_bit_equal": equal_p, "bit_equal": bit_equal,
               "max_rel_rms_gap": max(gaps.values()),
               "max_param_rel_rms_gap": max(pgaps.values()), "plain_step_s": plain_s,
               "sharded_step_s": sharded_s}
        print(f"{cfg.name} one training step on a (1, 1) {backend} mesh of DTensors vs plain "
              f"tensors ({TRAIN_BATCH} x {TRAIN_SEQ} tokens, {TRAIN_MICROBATCH} microbatches): "
              f"loss {ls:.6f} vs {lu:.6f} (relative gap {loss_gap:.3g}); gradient leaves "
              f"bit-equal {equal_g}/{len(want_g)}, largest relative RMS gap "
              f"{out['max_rel_rms_gap']:.3g}; updated params bit-equal {equal_p}/{len(want_p)}, "
              f"largest gap {out['max_param_rel_rms_gap']:.3g}; flash launches {launches}; step "
              f"{sharded_s:.2f} s (plain {plain_s:.2f} s)", flush=True)
        if not bit_equal:  # one rank computes what the plain step does, op for op
            within = max(loss_gap, out["max_rel_rms_gap"], out["max_param_rel_rms_gap"])
            fail(f"phase 19 (b): the (1, 1) sharded step is not bit-equal to the plain one "
                 f"(largest relative gap {within:.3g}, BF16_TRAIN_GAP {BF16_TRAIN_GAP}): {out}")
        del params, opt, dparams, dopt, grads_u, grads_s, new_u, new_s, got_g, got_p
    finally:
        dist.destroy_process_group()
    report["mesh_sharded_step"] = out
    return {"launches": sum(launches.values()), "step_s": sharded_s,
            "grad_leaves_bit_equal": equal_g, "grad_leaves": len(want_g)}


def rank0_step(report: dict, rec: dict) -> None:
    """Phase 19 (c): ``qwen3-0.6b/train_4k``'s step as rank 0 of the
    ``(16, 16)`` mesh, on the card, over a fake group of 256 ranks."""
    import torch
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import Cell
    from repro_torch.distributed.constraints import use_mesh
    from repro_torch.distributed.sharding import distribute_tree, placements
    from repro_torch.kernels.cuda_lib import launch_counters, reset_launch_counters
    from repro_torch.launch.mesh import fake_world, make_production_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import adamw_init, tree_map

    arch = get_arch(TRAIN_ARCH)
    cfg = arch.cfg
    cell = Cell(TRAIN_ARCH, "train_4k", "train")
    with fake_world(256):
        mesh = make_production_mesh(device_type=DEVICE)
        full = tf.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0), DEVICE,
                              at_rest=torch.float32)
        opt = adamw_init(full)
        pspec, ospec = arch.param_partition((full, opt))

        def own(d):  # rank 0's shard in storage of its own
            return DTensor.from_local(d.to_local().clone(), mesh, d.placements,
                                      shape=d.shape, stride=d.stride())

        params = tree_map(own, distribute_tree(full, mesh, pspec))
        dopt = tree_map(own, distribute_tree(opt, mesh, ospec))
        del full, opt
        (sds,), (bspec,) = arch.inputs(cell, mesh)
        gen = torch.Generator(device=DEVICE).manual_seed(1)
        batch = {}
        for k, s in sds.items():
            ids = torch.randint(0, cfg.vocab_size, s.shape, generator=gen, device=DEVICE,
                                dtype=s.dtype)
            batch[k] = own(distribute_tensor(ids, mesh, placements(bspec[k], mesh),
                                             src_data_rank=None))
        del ids
        gc.collect()
        torch.cuda.empty_cache()
        step = arch.make_step(cell)
        with use_mesh(mesh):
            step(params, dopt, batch)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counters()
            wall_ms, busy_ms, by_kind, _ = profiled(lambda: step(params, dopt, batch))
        peak = torch.cuda.max_memory_allocated()
        launches = {k: c.n for k, c in launch_counters().items() if c.n}
        local_tokens = tuple(batch["tokens"].to_local().shape)
        del params, dopt, batch
    p = rec["production"]
    top = sorted(by_kind.items(), key=lambda kv: -kv[1])[:6]
    out = {"wall_ms": wall_ms, "busy_ms": busy_ms, "busy_share": busy_ms / wall_ms,
           "peak_memory_bytes": peak, "launches": launches, "local_tokens": list(local_tokens),
           "dryrun_state_bytes": p["state_bytes_per_device"],
           "dryrun_argument_bytes": p["memory"]["argument_bytes"],
           "dryrun_temp_bytes": p["memory"]["temp_bytes"], "top_device_ms": dict(top)}
    print(f"rank 0 of (16, 16), {cell.key} on the card (fake collectives): local tokens "
          f"{list(local_tokens)}, step {wall_ms:.1f} ms wall, {busy_ms:.1f} ms device busy "
          f"(share {out['busy_share']:.3f}); max_memory_allocated {peak / 2**30:.3f} GiB beside "
          f"the dry run's state {p['state_bytes_per_device'] / 2**30:.4f} GiB, arguments "
          f"{p['memory']['argument_bytes'] / 2**30:.4f} GiB and peak live temp "
          f"{p['memory']['temp_bytes'] / 2**30:.3f} GiB; launches {launches}; top device: "
          + ", ".join(f"{k.strip()[:40]} {v:.1f} ms" for k, v in top), flush=True)
    if not launches.get("flash_attention"):
        fail(f"phase 19 (c): the step launched no flash kernel ({launches})")
    report["mesh_rank0_step"] = out


def roofline_constants(report: dict) -> None:
    """Phase 19 (d): the roofline's measured constants: a cuBLAS bf16
    GEMM of ``PEAK_GEMM_N``^3 and a device-to-device copy of
    ``HBM_COPY_BYTES`` (read once, written once)."""
    import torch

    n = PEAK_GEMM_N
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    a = torch.randn((n, n), generator=gen, device=DEVICE, dtype=torch.bfloat16)
    b = torch.randn((n, n), generator=gen, device=DEVICE, dtype=torch.bfloat16)
    c = torch.empty((n, n), device=DEVICE, dtype=torch.bfloat16)
    gemm_ms = cuda_ms(lambda: torch.mm(a, b, out=c), warmup=3, iters=10)
    del a, b, c
    src = torch.empty(HBM_COPY_BYTES, dtype=torch.uint8, device=DEVICE).fill_(1)
    dst = torch.empty_like(src)
    copy_ms = cuda_ms(lambda: dst.copy_(src), warmup=2, iters=5)
    del src, dst
    out = {"gemm_n": n, "gemm_ms": gemm_ms, "peak_flops": 2 * n ** 3 / (gemm_ms / 1e3),
           "copy_bytes": HBM_COPY_BYTES, "copy_ms": copy_ms,
           "hbm_bw": 2 * HBM_COPY_BYTES / (copy_ms / 1e3), "card": gpu_line()}
    print(f"roofline constants on {out['card']}: bf16 GEMM {n}^3 {gemm_ms:.4f} ms = "
          f"{out['peak_flops']:.6e} FLOP/s; copy of {HBM_COPY_BYTES} bytes {copy_ms:.4f} ms = "
          f"{out['hbm_bw']:.6e} B/s (read + write)", flush=True)
    report["roofline_constants"] = out


def mesh_phase(report: dict) -> dict:
    """Phase 19, slice I: the dry run, the one-rank sharded step, rank 0 of
    the production mesh and the roofline constants.  Returns the kernel
    table's path entry of (b)."""
    import torch

    t = time.perf_counter()
    records = dryrun_cells(report)
    gc.collect()
    path = sharded_train_step(report)
    gc.collect()
    torch.cuda.empty_cache()
    rank0_step(report, records["qwen3-0.6b/train_4k"])
    gc.collect()
    torch.cuda.empty_cache()
    roofline_constants(report)
    report["mesh_phase_s"] = time.perf_counter() - t
    print(f"phase 19 (slice I: the production mesh) wall {report['mesh_phase_s']:.1f} s",
          flush=True)
    return path


def kernel_name(mangled: str) -> str:
    """``flash_attn_wgmma_kernel<2>`` from its Itanium-mangled name: the last
    component of the nested name, with its template arguments (integers,
    booleans, ``float`` or named types)."""
    import re

    pos, name = 3 if mangled.startswith("_ZN") else 2, mangled
    while pos < len(mangled) and mangled[pos].isdigit():
        m = re.match(r"\d+", mangled[pos:])
        pos += m.end()
        name = mangled[pos: pos + int(m.group())]
        pos += int(m.group())
    if not mangled.startswith("I", pos):
        return name
    rest, args = mangled[pos + 1:], []
    while rest and not rest.startswith("E"):
        m = re.match(r"Li(\d+)E|Lb([01])E|(f)|(\d+)", rest)
        if m is None:
            break
        if m.group(4):  # a named type: its length, then its name
            size = int(m.group(4))
            args.append(rest[m.end(): m.end() + size])
            rest = rest[m.end() + size:]
            continue
        args.append(m.group(1) or ("float" if m.group(3) else ("false", "true")[int(m.group(2))]))
        rest = rest[m.end():]
    return f"{name}<{', '.join(args)}>"


def ptxas_report(log: str) -> dict:
    """Registers, spill bytes and warnings of each kernel from ``nvcc
    -Xptxas -v``, keyed by :func:`kernel_name`."""
    import re

    out: dict = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            name = kernel_name(m.group(1))
            out.setdefault(name, {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name]["spill_bytes"] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
        if "warning" in line:  # a warning may name its kernel
            m = re.search(r"'(_Z\w+)'", line)
            key = kernel_name(m.group(1)) if m else name or "(build)"
            out.setdefault(key, {}).setdefault("warnings", []).append(line.strip())
    return out


def main() -> None:
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError as e:
        fail(f"PyTorch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: chip_smoke needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels.cuda_lib import library
    except ImportError as e:
        fail(f"the repro_torch package is missing next to chip_smoke.py ({e})")
    card = gpu_line()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}", flush=True)

    lib = library()
    t = time.perf_counter()
    lib.get()
    print(f"kernels built in {time.perf_counter() - t:.2f} s -> {lib.path.name}", flush=True)
    ptxas = ptxas_report(lib.build_log)
    for fn, info in ptxas.items():
        print(f"  ptxas: {fn}: {info}", flush=True)

    floor_ms = launch_floor_ms()
    clocks = gpu_query("clocks.sm,clocks.max.sm")
    print(f"launch floor (graph-replayed launch of no work): {floor_ms:.5f} ms; SM clock, "
          f"max SM clock: {clocks}", flush=True)
    report: dict = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                    "build_s": lib.build_s, "ptxas": ptxas, "launch_floor_ms": floor_ms,
                    "sm_clocks": clocks}
    if sys.argv[1:] == ["--phase", "ragged"]:
        row = ragged_phase(report)
        row["launch_floor_ms"] = floor_ms
        report["kernels"] = [row]
        finish(report, t_start)
        return
    table = store_phases(report)
    nbr = ragged_phase(report)
    next(r for r in table if r["name"] == nbr["name"])["paths"] = {f"{RAGGED_CELL} drain": nbr}
    gc.collect()
    torch.cuda.empty_cache()
    gc.collect()
    torch.cuda.empty_cache()
    lm = lm_serving_phase(report)
    lm_end_to_end_check(lm, report)
    flash_row = attention_kernel_checks(lm, report)
    table.append(flash_row)
    del lm
    attention_sweep(report)
    gc.collect()
    torch.cuda.empty_cache()
    gqa_path = gqa_phase(report)
    flash_row["launches_by_path"] = {"lm_prefill": flash_row["launches"],
                                     "lm_gqa_prefill": gqa_path["launches"]}
    flash_row["paths"] = {"LM GQA prefill": gqa_path}
    gc.collect()
    torch.cuda.empty_cache()
    train_path = train_phase(report)
    flash_row["launches_by_path"]["lm_training"] = train_path["launches"]
    flash_row["paths"]["LM training"] = train_path
    gc.collect()
    torch.cuda.empty_cache()
    table.append(bag_phase(report))
    gc.collect()
    torch.cuda.empty_cache()
    inputs = build_inputs()
    geo, rp_launches = competitor_phase(report, inputs)
    for r in table:
        if r["name"] in rp_launches:
            r["launches_by_path"] = {"main": r["launches"], "rp_sr": rp_launches[r["name"]]}
    offline_phase(report, geo)
    del geo
    rmat = analytics_phase(report, inputs[0])
    gc.collect()
    torch.cuda.empty_cache()
    cp_launches = control_plane_phase(report, card)
    for r in table:
        if r["name"] in cp_launches:
            paths = r.setdefault("launches_by_path", {"streaming": r["launches"]})
            paths["control_plane"] = cp_launches[r["name"]]
    gc.collect()
    torch.cuda.empty_cache()
    gnn_phase(report, rmat)
    del rmat
    gc.collect()
    torch.cuda.empty_cache()
    mesh_path = mesh_phase(report)
    flash_row["launches_by_path"]["lm_sharded_training"] = mesh_path["launches"]
    flash_row["paths"]["LM sharded training (1 x 1 mesh)"] = mesh_path

    for r in table:
        r["launch_floor_ms"] = floor_ms
    report["kernels"] = table
    finish(report, t_start)


def finish(report: dict, t_start: float) -> None:
    """Write the report, print the kernel table and the last line."""
    import torch

    report["total_s"] = time.perf_counter() - t_start
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=float))
    print(f"chip_smoke: every phase passed in {report['total_s']:.1f} s", flush=True)
    print(json.dumps({"kernels": report["kernels"]}), flush=True)
    print(gpu_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    os.chdir(ROOT)
    main()
