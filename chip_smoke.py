#!/usr/bin/env python3
"""Drive the port's main path on one NVIDIA H100 and hold its kernels to
their plain versions.

Run from the repository root, on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught on the way out):

1. build the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all at once) and print the card's name and power limit;
2. each kernel against its plain PyTorch version on the card, at blocks
   16, 32, 64 and 128 with ragged edges, a ``pad_schedule``-padded schedule
   and an empty one, each also with B read in place (the dense operand
   through its block coordinates; contiguous, and in a view one float off
   16 bytes with rows wider than N, the 4-byte copies) bit for bit equal to
   the stack launch; then K1 on long runs and K2 on long columns (4 valid
   rows, block 128, ~36 entries a run or a column), with their chunk
   tables split and whole;
3. the main path: all nine Table 6 layers at their published M, N, K and
   sparsities, block-structured at block 32, through
   ``flexagon_plan(..., backend="cuda")`` with each of the six dataflows
   pinned and the dense escape off, each plan applied twice, then the
   ``auto`` choice at the default escape threshold; every result against an
   fp64 dense product;
4. ``CompressedFFN`` at the qwen2-1.5b width (d_model 1536, d_ff 8960),
   block 128 at block sparsity 0.5 — a chosen stand-in, since no config of
   the repo prunes its FFN — for 4 tokens (the 4-slot decode of
   ``examples/serve_batch.py``) and 128 (a prefill), against the masked
   dense FFN in fp64;
5. both kernels' launch counts over phases 3-4 must be > 0;
6. each distinct kernel launch of the main path, replayed as
   ``CudaBackend.kernel_call`` makes it and held bit for bit to the main
   path's own result: checked against its plain version on the same
   inputs, and timed beside the plain version, one ``torch.matmul`` on
   the densified inputs, and the least time the card could take; then
   (6b) each M-stationary launch of phase 3 again with B read in place,
   contiguous and in an unaligned wider view, bit for bit equal to the
   stack launch, and an R0-shaped product (ResNet-50's conv1 as im2col,
   M 64, K 147, 16 images, block 32, ``ip_m`` and ``gust_m``) through
   ``plan.apply``: the in-place route bit for bit equal to the gathered
   one, within ``REL_TOL`` of fp64, both applies and both launches timed;
7. K3 (the MoE grouped matmul) against its plain version and an fp64
   product: bm 16, 64 and 128, bf16 and fp32 inputs, empty groups, groups
   larger than one tile, and the idle tiles of the device padding; then
   granite's decode shapes, few-tile calls that take the K split, rows
   that are not 16-byte aligned, and jamba's decode shapes;
8. the serving path: granite-moe-1b-a400m at its published width (24
   layers, d_model 1024, 32 experts top-8, vocab 49155) with random bf16
   weights from a seed and the MoE dispatch set to ``sort``, serving 8
   requests (prompts of 32-128 tokens, 16 new tokens each) through
   ``repro_torch.serve.ServeEngine`` with 4 slots and ``max_seq`` 256.  K3's
   launches over that run must be 3 x 24 x (prefills + decode steps);
9. the path check: one prompt prefilled through ``sort`` (K3) and through
   ``scatter`` (``torch.einsum``, no kernel); their last-position logits
   must agree within a bf16 bound.  Every K3 call of that prefill and of
   one 4-slot decode step is replayed against its plain version and an
   fp64 product of its real rows, and timed beside the plain version,
   ``torch._grouped_mm`` on the real rows, and its bound.

After phase 9, three phases drive what the memory and policy layers add
(each counts K1/K2 launches from 0 and fails if a kernel it needs never
launched; each turns the dense escape off and restores it):

10. tiled plans under ``PAPER_BUDGET`` (Table 5: 256 KiB L1, 1 MiB L2),
    run tile by tile through K1/K2: the six Table 6 layers that tile at
    block 32 (R4, R6, S-R3, V0, V7, A2) with the six pinned dataflows and
    ``"mixed"``, and the qwen2-1.5b FFN's gate/up and down products at 4
    and 128 tokens for ip_m, op_m and gust_m.  Per case: tiles, the K1/K2
    launches of one apply (> 0), the error against fp64 and against the
    untiled plan (<= 1e-4 each), the device ms of the tiled and the
    untiled apply, and the tiled apply's CUDA-event time (host gaps
    included);
11. the ``simulator`` and ``autotune`` policies over the nine Table 6
    layers at block 32, beside the fastest pinned dataflow by phase 6's
    kernel timer and the fastest of autotune's candidates by autotune's
    own timer (whole applies by CUDA events, 20 reps); a second autotune
    select must hit its cache, K1/K2 must launch during the sweep; then
    one budgeted autotune on V0, with its host time;
12. ``FlexagonPipeline`` over the qwen2-1.5b FFN chain (1536 -> 8960 ->
    1536) at 4 tokens, ``policy="simulator"`` under ``PAPER_BUDGET`` on the
    cuda backend, within 1e-4 of the fp64 chain.

Phase 13 drives sharded plans (``repro_torch.dist``), escape off, with the
K1/K2 counts from 0 (both must launch):

13. (a) the serial path, on single-process meshes of the card
    (``make_virtual_mesh``): Table 6 at block 32 in all six dataflows and
    the qwen2-1.5b FFN's gate/up and down products at 4 and 128 tokens in
    ip_m, op_m and gust_m, each at 2 and 4 shards along the dataflow's
    default axis; then V0 under ``PAPER_BUDGET`` in op_m, gust_m and mixed
    at 2 and 4 shards, tiling inside each shard.  Per case: shards, axis,
    collective, ``ici_bytes``, the K1/K2 launches of one apply (> 0), the
    error against fp64 and against the unsharded plan (<= 1e-4 each), and
    the device ms of both on phase 10's timer (5 calls for Table 6, 20
    else).  Then the device time of one sharded qwen2 gate/up apply at 4
    tokens by kernel name beside the unsharded plan's, and its padded
    shard plans against each shard planned alone (op_m at 4 shards, ip_m
    at 2).
    (b) the collective path: 2, then 4 ranks (``chip_smoke.py --dist-rank
    R W DIR``, all on the one card, a gloo group: NCCL refuses two ranks
    on one device) each build the same ``ShardedPlan`` on a 1-D ``cuda``
    ``DeviceMesh`` with ``device=None`` (which must resolve to the rank's
    card) and run the qwen2 gate/up product at 4 tokens in ip_m (axis n),
    op_m (axis k) and gust_m (axis m), ``sparse_ffn_apply`` of a sharded
    ``compress_ffn``, then V0 under ``PAPER_BUDGET`` in op_m, gust_m and
    mixed (tiled and mixed shards).  Per rank: the path (collective), K1/K2
    launches (> 0 where its shard has work, and > 0 over the ranks of
    every case: gust_m's row bands leave a 4-token product's one block row
    to rank 0), the ``dist.collectives`` counter (> 0), and the error
    against fp64 and against (a)'s serial result (<= 1e-4).  Every rank
    must exit 0 within its timeout.

Phase 14 drives the analysis and tune layers (``repro_torch.analysis``,
``repro_torch.tune``) at full width, escape off where plans are applied:

14. (a) plans built with ``verify=True`` through the entry points: Table 6
    at block 32 in six dataflows, V0 under ``PAPER_BUDGET`` in six
    dataflows and ``mixed``, the qwen2 gate/up product at 4 tokens sharded
    2 and 4 ways (serial), the qwen2-width ``compress_ffn`` at 4 and 128
    tokens, and granite-moe-1b-a400m's ``MoEPlan`` (``sort``).  Per plan:
    its phase-1 host ms beside the host ms of a cold ``verify_plan`` (no
    ERROR, gated).  Each K1/K2 plan and the FFN are applied on the card
    (1e-4 of fp64; K1 and K2 launches > 0); every ``cuda`` leaf plan's
    ``DeviceSchedule`` is read back and audited (0 errors, gated); a gust
    plan given a pad entry inside its grid must raise
    ``PlanVerificationError`` with no K1/K2 launch.
    (b) one V7 apply per dataflow under ``trace_report`` (0 host syncs,
    one launch, gated), a ``RetraceDetector`` over three ``PlanCache``
    hits, and ``ServeEngine.verify_plans()`` over the FFN's plans (gated).
    (c) the quick corpus and its forest fitted in the phase, saved, and
    loaded through ``REPRO_TUNE_MODEL``; Table 6 and the four qwen2
    products planned with ``policy="learned"`` (picks in ``ctx.allowed``,
    1e-4, K1/K2 launches, gated) beside a cold ``SimulatorPolicy``, with
    the select µs of each.
    (d) ``AutotunePolicy(db=...)`` over Table 6, then a fresh policy on the
    same file: 9 DB hits, 0 sweeps, the same picks (gated).

Phase 15 drives the rest of the model zoo at full width, one model at a
time (each freed before the next is built), random bf16 weights from
``SEED``:

15. (a) jamba-v0.1-52b at its published widths and one of its four
    published 8-layer periods (7 mamba + 1 attention layers, 4 MoE layers
    of 16 experts top-2; 13.3 B parameters, the only cut), MoE dispatch
    ``sort``, serving 8 requests of 32-128 prompt tokens, 16 new tokens
    each, through a 4-slot ``ServeEngine`` (``max_seq`` 256).  K3's
    launches over that run must be 3 x 4 x (prefills + decode steps); then
    phase 9's path check on jamba (sort vs scatter logits within
    LOGIT_TOL; every K3 call of one prefill and one decode step replayed
    against its plain version and fp64, and timed beside
    ``torch._grouped_mm`` and its bound, summed per prefill and per
    decode; one profiled decode step's idle share), and a prompt
    prefilled to n-4 tokens and decoded over the last 4, against
    ``model.logits`` (top-16 ``scatter``, the same params) within
    DECODE_TOL.
    (b) rwkv6-3b at its published width and depth (32 layers, no kernel
    runs): the same 8 requests, fp32 recurrent states after serving, and
    the prefill-then-decode gate in bf16 (LOGIT_TOL) and in fp32
    (FP32_DECODE_TOL).
    (c) seamless-m4t-large-v2 (12 + 12 layers): frames (4, 96, 1024), a
    BOS prefill and 16 greedy decode steps, against the teacher-forced
    decoder within DECODE_TOL.

Phase 16 trains (``repro_torch.train``, ``repro_torch.launch.train``),
the MoE on K3 forward and backward and on K3w for the weight gradient:

16. (a) K3w and K3's backward (``GroupedMatmul``) against their plain
    versions on the card: bm 16, 64 and 128, bf16 and fp32, empty groups,
    groups of several tiles, partial tiles and the device padding's idle
    tiles, tiles in a shuffled order, rows not 16-byte aligned, a tile
    list longer than the TMA kernel's bitmap, then granite's training
    shapes (4096 tokens x top-8 over 32 experts, (K, N) = (1024, 512) and
    (512, 1024)), where the plan must pick the TMA kernel.  In bf16 K3w
    runs both of its kernels (``wgrad_plan``: the TMA one on aligned
    operands, the general one on copies whose bases lie one element off
    16 bytes), each launched twice for the same bits; the TMA kernel is
    launched 2 x WGRAD_REPEATS times more at both training shapes and at
    a small shape whose ring wraps often, half of them beside a matmul on
    another stream, every result bit-identical to the first.
    K3w against fp64 too, and ``gmm``'s dx and dw by autograd against
    autograd through ``gmm_plain`` and against fp64; one ``sort`` MoE
    layer of granite's
    width must have a grad_fn and gradients for x, the router and the three
    expert weights.
    (b) granite-moe-1b-a400m as published (width, depth and muP scalars)
    with MoE ``sort``, fp32 master params from SEED, remat, batch 8 x 512
    tokens of the port's ``SyntheticLM`` stream, peak LR TRAIN_LR with a
    warmup of TRAIN_STEPS // 10 steps, through ``launch.train.train`` for
    TRAIN_STEPS steps with a checkpoint every TRAIN_CKPT_EVERY: every
    loss and grad norm finite, the mean loss of the last 5 steps below the
    first, K3 launched exactly 3 x 24 x 3 and K3w 3 x 24 times each step;
    then a run resumed from the step-10 checkpoint, whose params must equal
    the uninterrupted run's at step 10 bit for bit and whose first batch
    must equal its batch at step 10.  Reports step-time p50/p99,
    tokens/s, peak memory, one profiled step's device busy time and idle
    share by kernel family, and the first MoE layer's K3/K3w calls of one
    step replayed against their plain versions and timed beside
    ``torch._grouped_mm`` and their bounds, with the dx transpose copies
    and, for K3w, the plan's kernel and tile, CUDA-event time (the host's
    tensor-map encode included) and a two-launch bit-identity gate.
    (c) one step's loss and per-leaf gradients at full width through
    ``sort`` and through ``scatter`` on the same params and a 2 x 128 token
    batch, scatter's routes pinned to sort's (``RouteRecorder``): in bf16
    within GRAD_TOL_BF16 and with the model in fp32 within GRAD_TOL_FP32 of
    each leaf's largest gradient.  Also reports scatter routing on its own
    (not gated): the tokens a layer it routes otherwise, and its worst
    leaf.
    (d) three steps with ``grad_compression``: finite losses and non-zero
    error-feedback residuals.

Phase 17 runs granite on DTensor meshes (``repro_torch.sharding``), MoE
``sort``, params from SEED placed by ``params_sharding`` and batches by
``batch_sharding``:

17. (a) one rank (a one-rank gloo group in this process), a (data 1,
    model 1) ``cuda`` mesh: a 4 x 128 forward in fp32 products and in bf16
    against the same params unsharded (SHARD_TOL_FP32 / SHARD_TOL_BF16 of
    the largest logit; K3 exactly 3 x 24 launches); 3 AdamW steps of 8 x
    512 tokens (``make_train_step``, fp32 master params) against 3
    unsharded steps from the same init (losses and grad norms within
    SHARD_TRAIN_TOL; K3 3 x 24 x 3 and K3w 3 x 24 launches a step); the
    unsharded run's params checkpointed and restored onto the mesh through
    ``Checkpointer.restore(..., shardings=...)``, bit for bit.
    (b) two gloo ranks on the one card (``chip_smoke.py --shard-rank R W
    DIR``), a (data 1, model 2) ``cuda`` mesh: each rank holds half the
    attention heads, each expert's d_ff half and half the router's
    columns, runs K3 on its (32, 1024, 256) / (32, 256, 1024) slabs, and
    its fp32 logits must lie within SHARD_TP_TOL of its own unsharded
    forward; K3 launches > 0 and collectives > 0 on each rank (all
    ``all_reduce``: gloo takes no ``all_gather`` on CUDA tensors).  Top-k
    is not continuous: a token whose 8th and 9th expert lie within the
    sums' rounding of each other may pick another expert on the mesh, so
    the logits are held to the unsharded forward routed as the sharded one
    was, the tokens routed otherwise are counted (at most SHARD_REROUTED
    of them in any layer) and the error of the freely routed forward is
    reported.
    (c) two gloo ranks on the one card (``chip_smoke.py --shard-dp-rank R
    W DIR``), a (data 2, model 1) ``cuda`` mesh, granite at SHARD_DP_LAYERS
    of its 24 layers at full width, params whole on each rank: 3 AdamW
    steps of a 4 x 128 batch in 4 microbatches, whose single rows do not
    divide over the 2 data ranks, each rank's share padded to one row
    (``trainer.loss_and_grads``), in fp32 products, against the same 3
    steps unsharded on the same microbatches: losses and params after
    step 3 within SHARD_TRAIN_TOL, only ``all_reduce`` (CommDebugMode),
    K3 9 x 12 x 4 and K3w 3 x 12 x 4 launches a step, and every forward K3
    call on one padded row's tokens x top-8 (padded per group), not the
    microbatch's two rows.
    Per case: the mesh, the first MoE layer's placements, the error, the
    launches, and the sharded forward's time beside the unsharded one's
    (device ms in (a), CUDA-event ms in (b), both ranks sharing the card);
    (c)'s step times on the host clock.

Phase 18 drives the launch and benchmark surfaces
(``repro_torch.benchmarks``, ``repro_torch.examples``,
``repro_torch.launch``):

18. (a) every section of ``python -m repro_torch.benchmarks.run``, the
    kernels section ``--quick`` on the card: K1/K2 launches > 0, every
    apply within TOL of fp64, the ``plan_apply`` µs logged; its rows go to
    ``chiprun_out/BENCH_kernels_h100.json``.
    (b) the four examples on the card: ``quickstart`` (six dataflows on
    ``reference`` and ``cuda``, K1/K2 launches > 0, every apply within
    1e-4), ``moe_dataflows`` (einsum, scatter and sort at 64, 1024 and
    8192 tokens: K3 3 launches a sort call, sort vs scatter within
    LOGIT_TOL), ``serve_batch`` (10 requests) and ``train_lm`` (20 steps,
    finite losses, the restart resumes at step 10).
    (c) meanwhile, on the host's CPU in four processes with no card
    visible: ``repro_torch.launch.dryrun`` and ``.roofline`` over
    granite-moe-1b-a400m's four cells on the single-pod mesh and its
    ``moe_sort`` ``train_4k`` cell (fake process group of 256 ranks, meta
    tensors): every cell ``ok``, and K3/K3w FLOPs counted in the
    ``moe_sort`` cell.  Artifacts under ``chiprun_out/launch/``.
    Phase 18's K1/K2/K3 launches (each > 0) add to the kernels line.

19. the fused attention kernel (``csrc/attention.cu``) at the callers'
    shapes (ATTN_CASES: granite's training call, llama-3.2-3b's head dim
    128, a window, a query offset, cross-attention, MQA, head dim 16):
    its output, dQ, dK and dV, and the forward's fp32 O, against the
    plain loop on the same bf16 values row by row (``attn_gaps`` within
    ATTN_LIMITS), every output bit-identical on a second run; at
    granite's and llama's shapes the forward and the backward timed
    against their bound (operations at BF16_FLOP_PER_S, bytes at
    HBM_BYTES_PER_S), the plain loop and SDPA (``library_ms`` only).
    Phase 16(b) gates the kernel's calls of every training step: 2 x 24
    forward (the recomputation under remat), 24 backward, 5 x 24 kernel
    launches, and no plain loop on CUDA.  Its row joins the kernels line,
    its launches those of phase 16(b)'s run and of phase 19.

Its last two lines are ``{"kernels": [...]}`` and
``{"ok": true, "device": {...}}``; the whole log is also written to
``chiprun_out/chip_smoke.log`` and the kernel summary to
``chiprun_out/chip_smoke.json`` (phase 13's rows under ``dist``, phase
14's under ``analysis`` and ``tune``, phase 15's under ``models``, phase
16's under ``train``, phase 17's under ``shard``, phase 18's under
``launch``; the kernel line's K3 row keeps granite's replayed serving
calls, and its ``launches`` add jamba's, the training run's, phase
17(a)'s and 17(c)'s (both ranks') sharded runs' and phase 18's; the
K1/K2 rows' ``launches`` add phase 18's to phases 3-4's; the K3w row
holds the training replay and the training runs' and phase 17's sharded
runs' launches).  With no CUDA device it exits 2 before printing any
result.

    python3 chip_smoke.py --sweeps

runs phases 1, 7 and 2 alone (the build, then each kernel against its
plain version: K3 first, then K1 and K2) and prints no result lines.

    python3 chip_smoke.py --stream

runs phases 1, 2, 3, 4, 6 and 6b alone (the build, the K1/K2 sweeps,
Table 6 and the FFN through the main path, the replayed launches timed,
and the in-place gate) and prints no result lines.

    python3 chip_smoke.py --serve

runs phases 1 and 8 alone (the build, then granite serving with its
decode-step p50/p99) and prints no result lines: a serving-only run to
alternate with another tree's in one call.

    python3 chip_smoke.py --dist

runs phases 1 and 13 alone (the build, then sharded plans, serial and
collective) and prints no result lines.

    python3 chip_smoke.py --analysis

runs phases 1 and 14 alone (the build, then analysis and tune) and
prints no result lines.

    python3 chip_smoke.py --train

runs phases 1 and 16 alone (the build, then K3's gradient and granite
training), writes ``chiprun_out/chip_smoke_train.json`` and prints no
result lines.

    python3 chip_smoke.py --shard

runs phases 1 and 17 alone (the build, then granite on DTensor meshes),
writes ``chiprun_out/chip_smoke_shard.json`` and prints no result lines.

    python3 chip_smoke.py --launch

runs phases 1 and 18 alone (the build, then the benchmarks, the examples
and granite's dry-run and roofline cells), writes
``chiprun_out/chip_smoke_launch.json`` and prints no result lines.

    python3 chip_smoke.py --grad

runs phases 1 and 16(a) alone (the build, then K3w and K3's backward
against their plain versions) and prints no result lines.

    python3 chip_smoke.py --attn

runs phases 1 and 19 alone (the build, then the fused attention kernel),
writes ``chiprun_out/chip_smoke_attn.json`` and prints no result lines.

    python3 chip_smoke.py --models

runs phases 1 and 15 alone (the build, then jamba, rwkv6 and seamless),
writes ``chiprun_out/chip_smoke_models.json`` and prints no result lines.
"""
from __future__ import annotations

import functools
import json
import subprocess
from concurrent.futures import ThreadPoolExecutor
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

#: NVIDIA H100 SXM data sheet (dense, no sparsity), at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12      # dense tensor-core peak

TOL = 1e-4          # rtol = atol for kernel vs plain, both fp32
REL_TOL = 1e-4      # max|out - ref| / max|ref| against the fp64 product
SEED = 0
REPS = 20
#: bf16 output of K3 against its plain version: the same fp32 sum in
#: another order, rounded once to bf16, lands at most one bf16 ulp
#: (2**-7 relative) apart
BF16_ULP = 2.0 ** -7
#: a bf16 result against an fp64 product: max|out - ref| / max|ref|, one
#: rounding to 8 significant bits (2**-8) plus the fp32 sum's error
BF16_REL_TOL = 5e-3
#: sort vs scatter last-position logits, max|d| / max|logits|: both run
#: the whole model in bf16 and round at different points in each of the
#: 24 MoE layers; a 24-layer granite at d_model 256 on the CPU differed by
#: 0.024-0.035, and the bound allows twice that for the full width
LOGIT_TOL = 0.08


#: every log line also goes here once the run has a card and the repo
_LOG = []


def log(*parts) -> None:
    print(*parts, flush=True)
    for f in _LOG:
        print(*parts, file=f, flush=True)


# -- phase 1 -----------------------------------------------------------------


def build_kernels():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    # one nvcc per source, all started together
    with ThreadPoolExecutor(len(build.SOURCES)) as pool:
        futures = {name: pool.submit(build.build, name)
                   for name in build.SOURCES}
        logs = {name: f.result()[1] for name, f in futures.items()}
    log(f"kernels built in {time.perf_counter() - t0:.2f} s "
        f"({', '.join(logs)}; nvcc {build.FLAGS[1]})")
    for name, text in logs.items():
        for kernel, info in _ptxas_usage(text):
            log(f"ptxas {name} {kernel}: {info}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    log(card)
    return card


def _ptxas_usage(text):
    """(kernel, "registers ...; spills") per compiled entry of
    ``nvcc -Xptxas -v`` output, kernel names demangled by ``c++filt``
    where the toolkit has it."""
    import re
    import shutil

    kernel, spill, out = None, "", []
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([^' ]+)'?", line)
        used = re.search(r"Used \d+ registers.*", line)
        if m:
            kernel = m.group(1)
        elif "spill" in line:
            spill = line.strip()
        elif used and kernel:
            out.append([kernel, f"{used.group(0)}; {spill}"])
            spill = ""
    if out and shutil.which("c++filt"):
        names = subprocess.run(
            ["c++filt"], input="\n".join(k for k, _ in out),
            capture_output=True, text=True, timeout=30).stdout.splitlines()
        if len(names) == len(out):
            for row, name in zip(out, names):
                row[0] = name.replace("(anonymous namespace)::",
                                      "").split("(")[0]
    return out


# -- phase 2 -----------------------------------------------------------------


def _block_sparse(rng, shape, block, density):
    """Dense values with exactly round(density x blocks) blocks present
    (at least one where density > 0), placed uniformly at random."""
    import numpy as np

    gm, gk = -(-shape[0] // block[0]), -(-shape[1] // block[1])
    keep = min(gm * gk, max(int(density > 0), round(density * gm * gk)))
    mask = np.zeros(gm * gk, bool)
    mask[rng.choice(gm * gk, size=keep, replace=False)] = True
    full = np.kron(mask.reshape(gm, gk), np.ones(block, bool))
    x = rng.standard_normal(shape).astype(np.float32)
    return np.where(full[: shape[0], : shape[1]], x, np.float32(0))


def _operands(rng, m, k, n, block, da, db, device):
    import torch

    a = _block_sparse(rng, (m, k), block[:2], da)
    b = _block_sparse(rng, (k, n), block[1:], db)
    return (torch.as_tensor(a, device=device),
            torch.as_tensor(b, device=device))


def _wide_view(t):
    """``t``'s values in a view one float past a 16-byte boundary whose
    rows are 3 floats wider than ``t``'s: a B the kernels read in place
    with 4-byte copies and a row stride other than N."""
    import torch

    buf = torch.empty((t.shape[0], t.shape[1] + 3), dtype=t.dtype,
                      device=t.device)
    view = buf[:, 1:t.shape[1] + 1]
    view.copy_(t)
    return view


def kernel_sweep(device, blocks=(16, 32, 64, 128)):
    """Each kernel vs its plain version at several blocks, padded, empty."""
    import numpy as np
    import torch

    from repro_torch.core import dataflows as df
    from repro_torch.core.formats import dense_to_bcsc, dense_to_bcsr
    from repro_torch.kernels import stream as ks

    rng = np.random.default_rng(SEED)
    worst = {"stream_spmm": 0.0, "stream_panel_spmm": 0.0}
    for blk in blocks:
        m, k, n = 3 * blk + 5, 4 * blk + 3, 5 * blk + 7      # ragged edges
        a, b = _operands(rng, m, k, n, (blk, blk, blk), 0.5, 0.5, device)
        bs = (blk, blk)
        a_r, a_c = dense_to_bcsr(a, bs), dense_to_bcsc(a, bs)
        b_r, b_c = dense_to_bcsr(b, bs), dense_to_bcsc(b, bs)
        mb, nb = a_r.grid[0], b_r.grid[1]
        cases = [
            ("stream_spmm", "ip", a_r, b_c,
             ks.schedule_from_ip(df.build_ip_plan(a_r, b_c))),
            ("stream_spmm", "op", a_c, b_r,
             ks.schedule_from_stream(df.build_op_plan(a_c, b_r),
                                     by_dest=True)),
            ("stream_panel_spmm", "gust", a_r, b_r,
             ks.schedule_from_stream(df.build_gust_plan(a_r, b_r),
                                     by_dest=False)),
        ]
        for name, label, x, y, sched in cases:
            padded = ks.pad_schedule(sched, sched.n_work + 5,
                                     sched.n_runs + 3, mb)
            empty = ks._empty_schedule(sched.kind)
            for tag, s in (("plain", sched), ("padded", padded),
                           ("empty", empty)):
                kernel = getattr(ks, name)
                plain = getattr(ks, name + "_plain")
                ds = ks.device_schedule(s, device)
                kw = dict(out_grid=(mb, nb), out_shape=(m, n))
                got = kernel(x.data, y.data, ds, **kw)
                want = plain(x.data, y.data, ds, **kw)
                coords = ks.block_coords(*_block_coords(y), y.shape,
                                         y.block_shape, device)
                for form, dense in (("in place", b),
                                    ("in place 4-byte", _wide_view(b))):
                    if not torch.equal(kernel(x.data, dense, ds,
                                              b_coords=coords, **kw), got):
                        raise SystemExit(f"{name} at block {blk} ({tag}): "
                                         f"B read {form} differs from the "
                                         "stack launch")
                torch.cuda.synchronize()
                err = float((got - want).abs().max()) if got.numel() else 0.
                rel = err / max(float(want.abs().max()), 1e-30) \
                    if got.numel() else 0.
                ok = torch.allclose(got, want, rtol=TOL, atol=TOL)
                if tag != "empty":
                    ref = (x.todense().double() @ y.todense().double())
                    ok = ok and torch.allclose(got.double(), ref, rtol=TOL,
                                               atol=TOL)
                log(f"sweep {name:17s} block={blk:3d} {label:4s} {tag:6s} "
                    f"W={s.n_work:5d} max|kernel-plain|={err:.3e} "
                    f"(/max|plain| {rel:.1e}) allclose rtol=atol={TOL:g} "
                    f"{'ok' if ok else 'FAIL'}; B in place (16- and 4-byte "
                    "copies) bit-equal")
                if not ok:
                    raise SystemExit(f"{name} disagrees with its plain "
                                     f"version at block {blk} ({tag})")
                worst[name] = max(worst[name], err)
    for name, err in long_run_sweep(device, rng).items():
        worst[name] = max(worst[name], err)
    return worst


def long_run_sweep(device, rng, blk=128, m=4, kb=40, nb=2):
    """K1 on long runs and K2 on long columns: 4 valid rows of a 128-row
    block times a 40-block depth, so each of K1's nb runs, and each of the
    nb column segments of K2's one run, has about 36 entries.  The plan's
    own chunking splits them (the second pass runs); the same schedule cut
    at its longest run does not.  Both against the plain version and fp64,
    and against each other.  Returns each kernel's worst
    max|kernel - plain|."""
    import torch

    from repro_torch.core import dataflows as df
    from repro_torch.core.formats import dense_to_bcsc, dense_to_bcsr
    from repro_torch.kernels import stream as ks

    k, n = kb * blk, nb * blk
    a, b = _operands(rng, m, k, n, (blk, blk, blk), 1.0, 0.9, device)
    bs = (blk, blk)
    a_r, a_c = dense_to_bcsr(a, bs), dense_to_bcsc(a, bs)
    b_r, b_c = dense_to_bcsr(b, bs), dense_to_bcsc(b, bs)
    ref = a.double() @ b.double()
    kw = dict(out_grid=(1, nb), out_shape=(m, n))
    worst = {"stream_spmm": 0.0, "stream_panel_spmm": 0.0}
    for name, label, x, y, sched in (
            ("stream_spmm", "ip", a_r, b_c,
             ks.schedule_from_ip(df.build_ip_plan(a_r, b_c))),
            ("stream_spmm", "op", a_c, b_r, ks.schedule_from_stream(
                df.build_op_plan(a_c, b_r), by_dest=True)),
            ("stream_panel_spmm", "gust", a_r, b_r, ks.schedule_from_stream(
                df.build_gust_plan(a_r, b_r), by_dest=False))):
        kernel = getattr(ks, name)
        plain = getattr(ks, name + "_plain")
        what = "long columns" if name == "stream_panel_spmm" else "long runs"
        outs = {}
        for tag, chunk in (("split", None), ("whole", sched.n_work)):
            ds = ks.device_schedule(sched, device, chunk=chunk)
            got = kernel(x.data, y.data, ds, **kw)
            want = plain(x.data, y.data, ds, **kw)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            ok = (torch.allclose(got, want, rtol=TOL, atol=TOL)
                  and torch.allclose(got.double(), ref, rtol=TOL, atol=TOL))
            walk = ds.cols or ds    # K2's column segments, K1's runs
            log(f"sweep {name} {what} {label} {tag:5s} M={m} block={blk} "
                f"W={ds.n_work} runs={ds.n_seg} segments={walk.n_seg} (~"
                f"{ds.n_work // max(walk.n_seg, 1)} entries) chunk={ds.chunk} "
                f"chunks={walk.n_chunk} split segments={walk.n_split} "
                f"rows={ks.dest_rows(blk, m)} max|kernel-plain|={err:.3e} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"{name} {what} {label} {tag} disagrees "
                                 "with its plain version")
            if (walk.n_split > 0) != (tag == "split"):
                raise SystemExit(f"{name} {what} {label} {tag}: "
                                 f"{walk.n_split} split segments")
            outs[tag] = got
            worst[name] = max(worst[name], err)
        if not torch.allclose(outs["split"], outs["whole"], rtol=TOL,
                              atol=TOL):
            raise SystemExit(f"{name} {what} {label}: split and whole "
                             "runs disagree")
    return worst


# -- phases 3 and 4 ----------------------------------------------------------


def _rel_err(out, ref) -> float:
    return float((out.double() - ref).abs().max() / ref.abs().max()
                 .clamp_min(1e-30))


def _table6_operands(device):
    """Every Table 6 layer's operands ``{name: (a, b)}`` at block 32, at
    its published M, N, K and sparsities (from SEED + 1)."""
    import numpy as np

    from repro_torch.core.workloads import PAPER_LAYERS

    rng = np.random.default_rng(SEED + 1)
    return {name: _operands(rng, L.m, L.k, L.n, (32, 32, 32), L.density_a,
                            L.density_b, device)
            for name, L in PAPER_LAYERS.items()}


def table6(device, calls):
    """Every Table 6 layer, six pinned dataflows x2 applies, then auto.

    Returns each layer's operands ``{name: (a, b)}``."""
    from repro_torch import flexagon_plan, get_backend
    from repro_torch.core.dataflows import DATAFLOWS
    from repro_torch.core.workloads import PAPER_LAYERS

    cuda = get_backend("cuda")
    default_threshold = cuda.dense_threshold
    bs = (32, 32, 32)
    operands = _table6_operands(device)
    for name, L in PAPER_LAYERS.items():
        a, b = operands[name]
        ref = a.double() @ b.double()
        worst = 0.0
        cuda.dense_threshold = 2.0            # escape off: kernels only
        try:
            for d in DATAFLOWS:
                plan = flexagon_plan(a, b, dataflow=d, block_shape=bs,
                                     backend="cuda")
                for _ in range(2):
                    out = plan.apply(a, b)
                    worst = max(worst, _rel_err(out, ref))
                calls.append((f"{name}", plan, a, b, out))
        finally:
            cuda.dense_threshold = default_threshold
        auto = flexagon_plan(a, b, block_shape=bs, backend="cuda")
        worst = max(worst, _rel_err(auto.apply(a, b), ref))
        log(f"table6 {name:6s} M={L.m} N={L.n} K={L.k} spA={L.sp_a}% "
            f"spB={L.sp_b}%: six dataflows x2 applies, max rel err "
            f"{worst:.2e} (tol {REL_TOL:g}); auto -> {auto.dataflow} "
            f"dense_escape={'dense' in auto.aux}")
        if worst > REL_TOL:
            raise SystemExit(f"table6 {name}: error {worst:.2e} > {REL_TOL}")
    return operands


#: the qwen2-1.5b FFN stand-in of phases 4, 10 and 12: block sparsity 0.5
#: at block 128 (no config of the repo prunes its FFN)
QWEN2_D, QWEN2_F, QWEN2_BLOCK, QWEN2_SPARSITY = 1536, 8960, 128, 0.5


def _qwen2_params(rng, device, d, f, block):
    """The pruned FFN's parameters (random, from ``rng``) and its masked
    fp32 weights ``(params, w_gate, w_up, w_down)``."""
    import numpy as np

    from repro_torch.convert import ffn_params_from_jax
    from repro_torch.models.ffn import _masked_weight

    scale = 1.0 / np.sqrt(d)
    tree = {
        "w_gate": {"w": rng.standard_normal((d, f), np.float32) * scale},
        "w_up": {"w": rng.standard_normal((d, f), np.float32) * scale},
        "w_down": {"w": rng.standard_normal((f, d), np.float32) * scale},
        "block_mask": (rng.random((d // block, f // block))
                       >= QWEN2_SPARSITY).astype(np.float32),
    }
    params = ffn_params_from_jax(tree, device=device)
    mask = params["block_mask"]
    return (params, _masked_weight(params["w_gate"]["w"], mask),
            _masked_weight(params["w_up"]["w"], mask),
            _masked_weight(params["w_down"]["w"], mask.T))


def qwen2_ffn(device, d=QWEN2_D, f=QWEN2_F, block=QWEN2_BLOCK):
    """CompressedFFN at qwen2-1.5b width, decode (4) and prefill (128).

    Returns (planned entry, input, output) of each token count."""
    import numpy as np
    import torch

    from repro_torch import compress_ffn, get_backend, sparse_ffn_apply

    sparsity = QWEN2_SPARSITY
    rng = np.random.default_rng(SEED + 2)
    params, wg, wu, wd = _qwen2_params(rng, device, d, f, block)
    wg, wu, wd = wg.double(), wu.double(), wd.double()

    cuda = get_backend("cuda")
    default_threshold = cuda.dense_threshold
    cuda.dense_threshold = 2.0    # escape off: 0.5 occupancy would take it
    try:
        comp = compress_ffn(params, tokens=4, block=block, backend="cuda",
                            device=device)
        runs = []
        for batch, seq in ((4, 1), (1, 128)):
            x = torch.as_tensor(rng.standard_normal((batch, seq, d),
                                                    np.float32),
                                device=device)
            out = sparse_ffn_apply(comp, x)
            out = sparse_ffn_apply(comp, x)
            x2 = x.reshape(-1, d).double()
            ref = ((torch.nn.functional.silu(x2 @ wg) * (x2 @ wu)) @ wd
                   ).reshape(batch, seq, d)
            err = _rel_err(out, ref)
            entry = comp.specialize(batch * seq)
            log(f"ffn qwen2-1.5b tokens={batch * seq:4d} "
                f"plan_in={entry.plan_in.dataflow} "
                f"plan_out={entry.plan_out.dataflow} rel err {err:.2e} "
                f"(tol {REL_TOL:g})")
            if err > REL_TOL:
                raise SystemExit(f"ffn tokens={batch * seq}: error {err:.2e}")
            runs.append((entry, x, out))
    finally:
        cuda.dense_threshold = default_threshold
    # tokens=4 is built at construction and hit by both applies and the
    # specialize above (3); tokens=128 is built by its first apply and hit
    # by the second and by specialize (2)
    log(f"ffn plan_builds={comp.plan_builds} plan_hits={comp.plan_hits} "
        f"(block sparsity {sparsity} at block {block}: chosen stand-in)")
    if comp.plan_builds != 2 or comp.plan_hits != 5:
        raise SystemExit("ffn plan cache did not plan once per token shape")
    return runs


def replay_ffn(runs, calls):
    """The three applies ``sparse_ffn_apply`` makes, replayed after the
    launch counts are read: they must give its result bit for bit, so the
    calls phase 6 times are its own."""
    import torch

    for entry, x, out in runs:
        tokens = out.shape[0] * out.shape[1]
        x2f = x.reshape(tokens, -1)
        g = entry.plan_in.apply(x2f, entry.w_gate)
        h = (torch.nn.functional.silu(g)
             * entry.plan_in.apply(x2f, entry.w_up))
        y = entry.plan_out.apply(h, entry.w_down)
        if not torch.equal(y.reshape(out.shape), out):
            raise SystemExit(f"ffn tokens={tokens}: the replayed applies "
                             "differ from sparse_ffn_apply")
        calls.append((f"ffn{tokens}_in", entry.plan_in, x2f, entry.w_gate,
                      g))
        calls.append((f"ffn{tokens}_out", entry.plan_out, h, entry.w_down,
                      y))


# -- phase 6 -----------------------------------------------------------------


def _block_coords(op):
    """(block row, block column) of each stored block of ``op``."""
    import numpy as np

    from repro_torch.core.formats import BlockCSR

    major = np.repeat(np.arange(op.indptr.size - 1), np.diff(op.indptr))
    minor = np.asarray(op.indices)
    return (major, minor) if isinstance(op, BlockCSR) else (minor, major)


def _bound_ms(call):
    """Least time the card could take for one launch's work: (bytes moved,
    operations done), each as ms at the data sheet's rates.

    Both count the valid extent of every block (rows past M, columns past
    N and depth past K are padding the function does not need): each input
    block the work list reads, once; the work list and segment table the
    kernel is passed, once; C written once; 2 operations per multiply-add
    of each work entry that lands in C.
    """
    import numpy as np

    x, y, ds = call.x, call.y, call.schedule
    (m, k), n = x.shape, y.shape[1]
    bm, bk, bn = x.data.shape[1], x.data.shape[2], y.data.shape[2]

    def host(t):
        return t.cpu().numpy().astype(np.int64)

    def valid(idx, blk, total):
        return np.clip(total - idx * blk, 0, blk)

    a_slot, b_slot = host(ds.a_slot), host(ds.b_slot)
    seg_start, seg_ci = host(ds.seg_start), host(ds.seg_ci)
    seg_of = np.repeat(np.arange(seg_ci.size), np.diff(seg_start))
    ci = seg_ci[seg_of]
    panel = call.kernel.__name__ == "stream_panel_spmm"
    cj = host(ds.cj) if panel else host(ds.seg_cj)[seg_of]
    keep = (ci >= 0) & (ci < x.grid[0])             # pad runs write nothing
    a_row, a_col = _block_coords(x)
    b_row, b_col = _block_coords(y)
    ops = 2.0 * np.sum(valid(ci[keep], bm, m)
                       * valid(a_col[a_slot[keep]], bk, k)
                       * valid(cj[keep], bn, n))
    a_used = np.unique(a_slot[keep])
    b_used = np.unique(b_slot[keep])
    values = (np.sum(valid(a_row[a_used], bm, m) * valid(a_col[a_used], bk, k))
              + np.sum(valid(b_row[b_used], bk, k)
                       * valid(b_col[b_used], bn, n)))
    index = (ds.a_slot, ds.b_slot, ds.seg_start, ds.seg_ci,
             ds.cj if panel else ds.seg_cj)
    nbytes = 4 * (int(values) + sum(t.numel() for t in index) + m * n)
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            float(ops) / FP32_FLOP_PER_S * 1e3)


def _device_ms(fn, reps=REPS):
    """Device time per call: the median over ``reps`` calls of the kernels
    and memsets each call launches, as the profiler records them.  A
    kernel counts for the call whose ``timed`` range holds it on the
    device timeline.  The profiler now and then drops a call's events (a
    mean over all events then reads low) or hands over events of an
    earlier profile (it then reads high), so the median is taken over the
    calls it saw; where it saw no more than half of them, the profile is
    taken again, and after three such profiles CUDA events around the
    ``reps`` calls give the mean instead (which includes the host's gaps
    between launches)."""
    import statistics

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):          # a profile that lost most calls is retaken
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                with record_function("timed"):
                    fn()
            torch.cuda.synchronize()
        device = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        # the "timed" range's device twin spans its call's first to last
        # kernel (with the host's gaps); the time is the kernels' own
        windows = [e.time_range for e in device if e.name == "timed"]
        kernels = [e for e in device if e.name != "timed"]
        seen = [t for t in (sum(e.device_time_total for e in kernels
                                if w.start <= e.time_range.start <= w.end)
                            for w in windows) if t > 0]
        if 2 * len(seen) > reps:
            return statistics.median(seen) / 1e3, \
                f"profiler, {len(seen)} of {reps} calls"
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, "events"


def time_main_path(calls, worst):
    """Replay each distinct kernel launch of the main path, as the cuda
    backend makes it, and time it beside its plain version, one
    ``torch.matmul`` on the densified inputs, and its bound.  Returns the
    per-kernel sums and each call's ms by ``(label, dataflow)``."""
    import torch

    from repro_torch import get_backend
    from repro_torch.kernels import stream as ks

    cuda = get_backend("cuda")
    totals = {}
    per_call = {}
    seen = set()
    fallbacks = []      # timings that fell back to CUDA events
    for label, plan, a, b, applied in calls:
        if "dense" in plan.aux:
            raise SystemExit(f"{label}/{plan.dataflow} took the dense escape")
        call = cuda.kernel_call(plan, plan.pack_a(a).unwrap(),
                                plan.pack_b(b).unwrap())
        if id(call.schedule) in seen:
            continue
        seen.add(id(call.schedule))
        name = call.kernel.__name__
        plain = getattr(ks, name + "_plain")
        got = call.run()
        want = call.run(plain)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=TOL, atol=TOL):
            raise SystemExit(f"{name} at {label}/{plan.dataflow}: kernel vs "
                             f"plain max|d|={err:.3e} > tol {TOL}")
        same = applied.T if call.transposed else applied
        if not torch.equal(got, same.contiguous()):
            raise SystemExit(f"{label}/{plan.dataflow}: replayed kernel "
                             "call differs from the main path's")
        worst[name] = max(worst[name], err)
        xd, yd = call.x.todense().float(), call.y.todense().float()
        ms, how = _device_ms(call.run)
        plain_ms, plain_how = _device_ms(lambda: call.run(plain))
        lib_ms, lib_how = _device_ms(lambda: torch.matmul(xd, yd))
        fallbacks += [h == "events" for h in (how, plain_how, lib_how)]
        per_call[(label, plan.dataflow)] = ms
        t_bytes, t_ops = _bound_ms(call)
        bound = max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        blk = "x".join(map(str, (*call.x.data.shape[1:],
                                 call.y.data.shape[2])))
        ds = call.schedule
        walk = ds.cols or ds        # K2's column segments, K1's runs
        log(f"time {name:17s} {label:9s} {plan.dataflow:6s} "
            f"W={ds.n_work:6d} tiles={walk.n_seg:5d} "
            f"chunks={walk.n_chunk:5d} "
            f"block={blk} ms={ms:.4f} ({how}) "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
            f"bound_ms={bound:.5f} ({by}; bytes {t_bytes:.5f}, "
            f"operations {t_ops:.5f}) max|kernel-plain|={err:.2e}")
        t = totals.setdefault(name, {"ms": 0.0, "plain_ms": 0.0,
                                     "library_ms": 0.0, "bound_ms": 0.0,
                                     "bytes": 0.0, "operations": 0.0,
                                     "calls": 0})
        t["ms"] += ms
        t["plain_ms"] += plain_ms
        t["library_ms"] += lib_ms
        t["bound_ms"] += bound
        t[by] += bound          # how much of the summed bound each side sets
        t["calls"] += 1
    log(f"main-path timings on CUDA events (with the host's gaps): "
        f"{sum(fallbacks)} of {len(fallbacks)}")
    return totals, per_call


#: ResNet-50's conv1 as an im2col product (the benchmark's R0): M, K, the
#: columns of one image, the sparsities of A and B (%)
R0 = (64, 147, 11881, 86.678086, 49.316827)


def in_place_gate(device, calls, images=16):
    """Phase 6b: every M-stationary launch of phase 3 with B read in place
    (contiguous, and in an unaligned wider view) bit for bit equal to the
    stack launch; then an R0-shaped product through ``plan.apply`` on both
    routes, timed.  Returns its rows."""
    import numpy as np
    import torch

    from repro_torch import flexagon_plan, get_backend

    cuda = get_backend("cuda")
    checked = 0
    for label, plan, a, b, _ in calls:
        if (label.startswith("ffn") or plan.dataflow.endswith("_n")
                or "dense" in plan.aux):
            continue
        a_p = plan.pack_a(a).unwrap()
        stack = cuda.kernel_call(plan, a_p, plan.pack_b(b).unwrap()).run()
        for form, dense in (("in place", b), ("in place 4-byte",
                                              _wide_view(b))):
            call = cuda.kernel_call(plan, a_p, dense)
            if call.b_coords is None or not torch.equal(call.run(), stack):
                raise SystemExit(f"in place {label}/{plan.dataflow}: B read "
                                 f"{form} differs from the stack launch")
        checked += 1
    log(f"in place: {checked} M-stationary Table 6 launches, B read in place "
        "(contiguous and an unaligned wider view) bit-equal to the stack "
        "launch")
    m, k, n1, sp_a, sp_b = R0
    rng = np.random.default_rng(SEED + 2)
    a, b = _operands(rng, m, k, n1 * images, (32, 32, 32), 1 - sp_a / 100,
                     1 - sp_b / 100, device)
    ref = a.double() @ b.double()
    rows = []
    with EscapeOff():
        for d in ("ip_m", "gust_m"):
            plan = flexagon_plan(a, b, dataflow=d, block_shape=(32, 32, 32),
                                 backend="cuda")
            a_p = plan.pack_a(a)
            in_place = plan.apply(a_p, b)
            gathered = plan.apply(a_p, plan.pack_b(b))
            err = _rel_err(in_place, ref)
            if not torch.equal(in_place, gathered) or err > REL_TOL:
                raise SystemExit(f"in place R0/{d}: differs from the "
                                 f"gathered route or from fp64 ({err:.2e})")
            b_p = plan.pack_b(b).unwrap()
            stack_call = cuda.kernel_call(plan, a_p.unwrap(), b_p)
            place_call = cuda.kernel_call(plan, a_p.unwrap(), b)
            row = {"dataflow": d, "m": m, "k": k, "n": n1 * images,
                   "rel_err": err,
                   "apply_in_place_ms": _device_ms(
                       lambda: plan.apply(a_p, b))[0],
                   "apply_gather_ms": _device_ms(
                       lambda: plan.apply(a_p, plan.pack_b(b)))[0],
                   "kernel_in_place_ms": _device_ms(place_call.run)[0],
                   "kernel_stack_ms": _device_ms(stack_call.run)[0]}
            log(f"in place R0 {d} M={m} K={k} N={n1 * images}: bit-equal "
                f"to the gathered route, rel err {err:.2e}; apply ms in "
                f"place {row['apply_in_place_ms']:.4f} / gathered "
                f"{row['apply_gather_ms']:.4f}; kernel ms in place "
                f"{row['kernel_in_place_ms']:.4f} / stack "
                f"{row['kernel_stack_ms']:.4f}")
            rows.append(row)
    return rows


# -- phases 10-12 ------------------------------------------------------------

#: the Table 6 layers that tile under PAPER_BUDGET at block 32
TILED_LAYERS = ("R4", "R6", "S-R3", "V0", "V7", "A2")


def _launches():
    from repro_torch.kernels import stream as ks

    return ks.stream_spmm.launches, ks.stream_panel_spmm.launches


def _reset_launches():
    from repro_torch.kernels import stream as ks

    ks.stream_spmm.launches = 0
    ks.stream_panel_spmm.launches = 0


def _events_ms(fn, reps=REPS):
    """Time per call with the host's gaps: CUDA events around ``reps``
    calls after 3 warm-up calls, the mean."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class EscapeOff:
    """The cuda backend's dense escape off for a block; the threshold is
    restored on the way out, whatever happens."""

    def __enter__(self):
        from repro_torch import get_backend

        self.cuda = get_backend("cuda")
        self.saved = self.cuda.dense_threshold
        self.cuda.dense_threshold = 2.0
        return self

    def __exit__(self, *exc):
        self.cuda.dense_threshold = self.saved


def _tiled_case(label, dataflow, a, b, bs, out):
    """One tiled plan under PAPER_BUDGET against fp64 and against the
    untiled plan of the same dataflow (the heuristic's pick for mixed):
    tiles, the K1/K2 launches of one apply, errors, device ms of each,
    and the tiled apply's CUDA-event ms."""
    import torch

    from repro_torch import PAPER_BUDGET, TiledPlan, flexagon_plan

    pinned = dataflow if dataflow != "mixed" else "auto"
    tiled = flexagon_plan(a, b, dataflow=dataflow, block_shape=bs,
                          backend="cuda", memory_budget=PAPER_BUDGET)
    untiled = flexagon_plan(a, b, dataflow=pinned, block_shape=bs,
                            backend="cuda")
    k1, k2 = _launches()
    got = tiled.apply(a, b)
    torch.cuda.synchronize()
    k1, k2 = (n - m for n, m in zip(_launches(), (k1, k2)))
    want = untiled.apply(a, b)
    ref = a.double() @ b.double()
    err64, err_untiled = _rel_err(got, ref), _rel_err(got, want.double())
    tiles = tiled.n_tiles if isinstance(tiled, TiledPlan) else 1
    hist = tiled.tile_histogram if isinstance(tiled, TiledPlan) \
        else {tiled.dataflow: 1}
    row = {"case": label, "dataflow": dataflow, "tiles": tiles,
           "tile_dataflows": hist, "untiled": untiled.dataflow,
           "k1": k1, "k2": k2, "rel_err_fp64": err64,
           "rel_err_untiled": err_untiled}
    row["ms"], how = _device_ms(lambda: tiled.apply(a, b))
    row["untiled_ms"], how_u = _device_ms(lambda: untiled.apply(a, b))
    row["events_ms"] = _events_ms(lambda: tiled.apply(a, b))
    log(f"tiled {label:14s} {dataflow:6s} tiles={tiles:4d} K1={k1:4d} "
        f"K2={k2:4d} rel err fp64 {err64:.2e} untiled({untiled.dataflow}) "
        f"{err_untiled:.2e} (tol {REL_TOL:g}) ms={row['ms']:.4f} "
        f"untiled_ms={row['untiled_ms']:.4f} events_ms="
        f"{row['events_ms']:.4f} ({how}; {how_u})"
        + (f" tiles by dataflow {hist}" if dataflow == "mixed" else ""))
    if k1 + k2 <= 0:
        raise SystemExit(f"tiled {label}/{dataflow}: no K1/K2 launch")
    if max(err64, err_untiled) > REL_TOL:
        raise SystemExit(f"tiled {label}/{dataflow}: error {err64:.2e} / "
                         f"{err_untiled:.2e} > {REL_TOL}")
    out.append(row)


def _families(fn):
    """Device time (ms) of one call of ``fn`` by kernel family, from the
    profiler, and its number of device events."""
    from collections import Counter

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        fn()
        torch.cuda.synchronize()
    fams, n = Counter(), 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        n += 1
        name = e.name.lower()
        fams["K1/K2" if "stream_" in name
             else "copy/fill" if any(w in name for w in (
                 "memcpy", "memset", "fill", "copy"))
             else "index" if ("index" in name or "gather" in name)
             else "other"] += e.device_time_total / 1e3
    return dict(fams), n


def tiled_phase(device, operands, layers=TILED_LAYERS, d=QWEN2_D,
                f=QWEN2_F, block=QWEN2_BLOCK, token_counts=(4, 128)):
    """Phase 10: budgeted plans (PAPER_BUDGET, Table 5) run tile by tile
    through K1/K2, escape off: the tiling Table 6 layers at block 32 with
    the six pinned dataflows and "mixed", then the qwen2-1.5b FFN's
    gate/up and down products at 4 and 128 tokens for ip_m, op_m, gust_m.
    Returns one row per case, and where one tiled apply's device time goes
    in the case with the most tiles (V0 ip_n)."""
    import numpy as np
    import torch

    from repro_torch import PAPER_BUDGET, flexagon_plan
    from repro_torch.core.dataflows import DATAFLOWS

    rows = []
    _reset_launches()
    with EscapeOff() as esc:
        log(f"tiled: cuda dense_threshold {esc.cuda.dense_threshold} "
            f"(escape off; restored to {esc.saved} after)")
        for name in layers:
            a, b = operands[name]
            for dataflow in DATAFLOWS + ("mixed",):
                _tiled_case(name, dataflow, a, b, (32, 32, 32), rows)
        rng = np.random.default_rng(SEED + 2)
        _, wg, _, wd = _qwen2_params(rng, device, d, f, block)
        for tokens in token_counts:
            x = torch.as_tensor(rng.standard_normal((tokens, d), np.float32),
                                device=device)
            h = torch.as_tensor(rng.standard_normal((tokens, f), np.float32),
                                device=device)
            for part, a, b in (("gate/up", x, wg), ("down", h, wd)):
                for dataflow in ("ip_m", "op_m", "gust_m"):
                    _tiled_case(f"qwen2 {part} {tokens}", dataflow, a, b,
                                (block,) * 3, rows)
        # where one tiled apply's device time goes, on the case with the
        # most tiles
        a, b = operands["V0"]
        plan = flexagon_plan(a, b, dataflow="ip_n", block_shape=(32,) * 3,
                             backend="cuda", memory_budget=PAPER_BUDGET)
        fams, n = _families(lambda: plan.apply(a, b))
    log(f"tiled V0 ip_n ({plan.n_tiles} tiles) one apply: {n} device events, "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in sorted(
            fams.items(), key=lambda kv: -kv[1])))
    k1, k2 = _launches()
    log(f"tiled-path kernel launches (one apply per case, then timing): "
        f"stream_spmm {k1}, stream_panel_spmm {k2}; restored "
        f"dense_threshold {esc.cuda.dense_threshold}")
    if min(sum(r["k1"] for r in rows), sum(r["k2"] for r in rows)) <= 0:
        raise SystemExit("tiled path: K1 or K2 never launched")
    return {"cases": rows, "V0 ip_n breakdown": {
        "tiles": plan.n_tiles, "device_events": n, "ms_by_family": fams}}


#: suffix of a candidate that takes the cuda backend's dense escape
ESCAPE = {False: "", True: "+escape"}


def _candidates_ms(backend, a, b, bs):
    """Autotune's candidate set on ``a @ b`` timed by autotune's own timer
    (CUDA events around whole applies) with a steadier estimator: each
    distinct (dataflow, dense escape) that a value of the backend's
    ``dense_threshold`` knob gives, the mean of REPS applies after 3
    warm-ups.  The knob is restored on the way out."""
    from repro_torch import flexagon_plan
    from repro_torch.core.dataflows import DATAFLOWS

    out = {}
    saved = backend.dense_threshold
    try:
        for knob in backend.tuning_knobs()["dense_threshold"]:
            backend.dense_threshold = knob
            for d in DATAFLOWS:
                plan = flexagon_plan(a, b, dataflow=d, block_shape=bs,
                                     backend=backend)
                key = (d, "dense" in plan.aux)
                if key not in out:
                    out[key] = _events_ms(lambda: plan.apply(a, b))
    finally:
        backend.dense_threshold = saved
    return out


def policy_phase(device, operands, pinned_ms, budgeted="V0"):
    """Phase 11: over the Table 6 layers at block 32, the ``simulator``
    and ``autotune`` policies' picks beside two yardsticks: the fastest of
    the six pinned dataflows by phase 6's kernel timer (escape off), and
    the fastest of autotune's own candidates (dataflow x escape) by
    autotune's timer, whole applies by CUDA events, with 20 reps where
    autotune takes the best of 2.  Autotune sweeps on a cuda backend of
    its own (its knob writes stay off the registered ``cuda``); a second
    select must hit its cache, and K1/K2 must launch during the sweep.
    Then one budgeted autotune on ``budgeted`` under PAPER_BUDGET."""
    import torch

    from repro_torch import PAPER_BUDGET, flexagon_plan, register_backend
    from repro_torch.backends import AutotunePolicy, CudaBackend

    tune = CudaBackend()
    tune.name = "cuda-autotune"
    register_backend(tune, overwrite=True)
    pol = AutotunePolicy()
    bs = (32, 32, 32)
    rows = []
    _reset_launches()
    t_sweep = 0.0
    for name, (a, b) in operands.items():
        sim = flexagon_plan(a, b, block_shape=bs, backend="cuda",
                            policy="simulator").dataflow
        t0 = time.perf_counter()
        plan = flexagon_plan(a, b, block_shape=bs, backend=tune, policy=pol)
        torch.cuda.synchronize()
        t_sweep += time.perf_counter() - t0
        auto, knob = plan.dataflow, tune.dense_threshold
        timings = dict(pol.last_timings)
        hits, sweeps = pol.hits, pol.measurements
        again = flexagon_plan(a, b, block_shape=bs, backend=tune,
                              policy=pol).dataflow
        if (pol.hits, pol.measurements) != (hits + 1, sweeps) \
                or again != auto:
            raise SystemExit(f"policy {name}: the second autotune select "
                             f"missed its cache ({pol.stats})")
        rows.append({"layer": name, "simulator": sim, "autotune": auto,
                     "autotune_dense_threshold": knob,
                     "autotune_escape": "dense" in plan.aux,
                     "autotune_ms": {k: v * 1e3 for k, v in timings.items()}})
    k1, k2 = _launches()
    if min(k1, k2) <= 0:
        raise SystemExit("policy: K1 or K2 never launched in the sweep")
    agree = {"autotune": {"kernel": 0, "apply": 0},
             "simulator": {"kernel": 0, "apply": 0}}
    for row in rows:
        a, b = operands[row["layer"]]
        pinned = {d: ms for (label, d), ms in pinned_ms.items()
                  if label == row["layer"]}
        kernel = min(pinned, key=lambda d: (pinned[d], d))
        cands = _candidates_ms(tune, a, b, bs)
        apply_d, apply_esc = min(cands, key=lambda c: (cands[c], c))
        for pick in ("autotune", "simulator"):
            agree[pick]["kernel"] += row[pick] == kernel
            agree[pick]["apply"] += row[pick] == apply_d
        row.update({"fastest_kernel": kernel, "pinned_ms": pinned,
                    "fastest_apply": apply_d, "fastest_apply_escape":
                    apply_esc, "apply_ms": {
                        d + ESCAPE[e]: ms for (d, e), ms in cands.items()}})
        log(f"policy {row['layer']:6s} simulator -> {row['simulator']:6s} "
            f"autotune -> {row['autotune']}{ESCAPE[row['autotune_escape']]}"
            f" (dense_threshold {row['autotune_dense_threshold']}); fastest "
            f"kernel (phase 6) -> {kernel} {pinned[kernel]:.4f} ms; fastest "
            f"apply by events -> {apply_d}{ESCAPE[apply_esc]} "
            f"{cands[apply_d, apply_esc]:.4f} ms; apply ms " + " ".join(
                f"{k}={v:.4f}" for k, v in sorted(row["apply_ms"].items()))
            + "; autotune ms " + " ".join(
                f"{k}={v:.4f}" for k, v in sorted(
                    row["autotune_ms"].items())))
    log(f"policy: over {len(rows)} layers autotune agrees with the fastest "
        f"kernel on {agree['autotune']['kernel']} and with the fastest "
        f"apply by its own timer on {agree['autotune']['apply']}; simulator "
        f"on {agree['simulator']['kernel']} and "
        f"{agree['simulator']['apply']}; sweep host time {t_sweep:.2f} s; "
        f"launches during the sweep: stream_spmm {k1}, stream_panel_spmm "
        f"{k2}; stats {pol.stats}")
    a, b = operands[budgeted]
    pol_b = AutotunePolicy()
    t0 = time.perf_counter()
    plan = flexagon_plan(a, b, block_shape=bs, backend=tune, policy=pol_b,
                         memory_budget=PAPER_BUDGET)
    torch.cuda.synchronize()
    t_budget = time.perf_counter() - t0
    err = _rel_err(plan.apply(a, b), a.double() @ b.double())
    log(f"policy {budgeted} under PAPER_BUDGET: autotune -> {plan.dataflow} "
        f"({getattr(plan, 'n_tiles', 1)} tiles, dense_threshold "
        f"{tune.dense_threshold}) in {t_budget:.2f} s of host time; rel err "
        f"{err:.2e}; autotune ms " + " ".join(
            f"{k}={v * 1e3:.4f}" for k, v in sorted(
                pol_b.last_timings.items())))
    if err > REL_TOL:
        raise SystemExit(f"policy {budgeted}: error {err:.2e}")
    return {"layers": rows, "agree": agree, "sweep_s": t_sweep,
            "budgeted": {"layer": budgeted, "dataflow": plan.dataflow,
                         "host_s": t_budget,
                         "autotune_ms": {k: v * 1e3 for k, v in
                                         pol_b.last_timings.items()}}}


def pipeline_phase(device, d=QWEN2_D, f=QWEN2_F, block=QWEN2_BLOCK,
                   tokens=4):
    """Phase 12: ``FlexagonPipeline`` over the qwen2-1.5b FFN chain gate
    -> down (d -> f -> d) at 4 tokens, ``policy="simulator"`` under
    PAPER_BUDGET on the cuda backend, escape off; against the fp64
    chain."""
    import numpy as np
    import torch

    from repro_torch import PAPER_BUDGET, FlexagonPipeline, TiledPlan

    rng = np.random.default_rng(SEED + 2)
    _, wg, _, wd = _qwen2_params(rng, device, d, f, block)
    x = torch.as_tensor(rng.standard_normal((tokens, d), np.float32),
                        device=device)
    with EscapeOff():
        pipe = FlexagonPipeline.from_weights(
            [wg, wd], tokens=tokens, block_shape=(block,) * 3,
            backend="cuda", policy="simulator", memory_budget=PAPER_BUDGET)
        _reset_launches()
        out = pipe.apply(x)
        torch.cuda.synchronize()
        k1, k2 = _launches()
        ms, how = _device_ms(lambda: pipe.apply(x))
    ref = (x.double() @ wg.double()) @ wd.double()
    err = _rel_err(out, ref)
    tiles = [p.n_tiles if isinstance(p, TiledPlan) else 1
             for p in pipe.plans]
    log(f"pipeline qwen2-1.5b {d}->{f}->{d} tokens={tokens}: dataflows "
        f"{pipe.dataflows} n_conversions={pipe.n_conversions} tiles "
        f"{tiles}; launches stream_spmm {k1} stream_panel_spmm {k2}; "
        f"ms={ms:.4f} ({how}); rel err vs fp64 chain {err:.2e} (tol "
        f"{REL_TOL:g})")
    if k1 + k2 <= 0:
        raise SystemExit("pipeline: no K1/K2 launch")
    if err > REL_TOL:
        raise SystemExit(f"pipeline: error {err:.2e} > {REL_TOL}")
    return {"dataflows": pipe.dataflows, "n_conversions": pipe.n_conversions,
            "tiles": tiles, "k1": k1, "k2": k2, "ms": ms,
            "rel_err_fp64": err}


# -- phase 13 ----------------------------------------------------------------

#: shard counts of the serial cases, and the world sizes of the collective
#: ones (ranks of one process group, all on the one card)
DIST_SHARDS = (2, 4)
#: device-time reps of a Table 6 case (phase 10's timer at fewer calls:
#: 108 sharded and 54 unsharded plans are timed)
DIST_TABLE6_REPS = 5
#: calls a rank times per case by CUDA events (after 3 warm-up calls)
DIST_RANK_REPS = 5
#: the dataflows of V0 under PAPER_BUDGET on a mesh (tiled, mixed shards)
DIST_BUDGET_DATAFLOWS = ("op_m", "gust_m", "mixed")
#: (dataflow, shards) of the sharded qwen2 gate/up applies profiled by
#: kernel, and measured padded against unpadded shard plans
DIST_BREAKDOWN = (("op_m", 4), ("ip_m", 2))
#: each rank's limit: a hung rendezvous fails the run, never hangs it
RANK_TIMEOUT_S = 240
#: rank inputs: the qwen2-1.5b FFN's parameters, then its 4-token input
DIST_SEED = SEED + 5


def _dist_inputs(device):
    """The qwen2 FFN parameters, masked weights and 4-token input that
    phase 13 and its ranks share (made from DIST_SEED in this order)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(DIST_SEED)
    params, wg, wu, wd = _qwen2_params(rng, device, QWEN2_D, QWEN2_F,
                                       QWEN2_BLOCK)
    x4 = torch.as_tensor(rng.standard_normal((4, QWEN2_D), np.float32),
                         device=device)
    return rng, params, (wg, wu, wd), x4


def _ffn64(x, ws):
    import torch

    wg, wu, wd = (w.double() for w in ws)
    x2 = x.reshape(-1, wg.shape[0]).double()
    return (torch.nn.functional.silu(x2 @ wg) * (x2 @ wu)) @ wd


def _dist_case(label, dataflow, plan, a, b, ref, want, untiled_ms, reps,
               out):
    """One sharded plan on the serial path: the K1/K2 launches of one
    apply, errors against fp64 and the unsharded plan, device ms."""
    import torch

    from repro_torch import TiledPlan

    k1, k2 = _launches()
    got = plan.apply(a, b)
    torch.cuda.synchronize()
    k1, k2 = (n - m for n, m in zip(_launches(), (k1, k2)))
    err64, err_u = _rel_err(got, ref), _rel_err(got, want.double())
    ms, how = _device_ms(lambda: plan.apply(a, b), reps)
    tiles = [p.n_tiles if isinstance(p, TiledPlan) else 1
             for p in plan.plans]
    row = {"case": label, "dataflow": dataflow, "shards": plan.n_shards,
           "axis": plan.axis, "collective": plan.collective,
           "ici_bytes": plan.ici_bytes, "path": plan.path,
           "tiles_per_shard": tiles, "k1": k1, "k2": k2,
           "rel_err_fp64": err64, "rel_err_unsharded": err_u, "ms": ms,
           "unsharded_ms": untiled_ms}
    log(f"dist serial {label:16s} {dataflow:6s} shards={plan.n_shards} "
        f"axis={plan.axis} collective={plan.collective} "
        f"ici_bytes={plan.ici_bytes:.0f} K1={k1:3d} K2={k2:3d} rel err "
        f"fp64 {err64:.2e} unsharded {err_u:.2e} (tol {REL_TOL:g}) "
        f"ms={ms:.4f} unsharded_ms={untiled_ms:.4f} ({how})"
        + (f" tiles per shard {tiles}" if max(tiles) > 1 else ""))
    if plan.path != "serial":
        raise SystemExit(f"dist {label}/{dataflow}: path {plan.path} on a "
                         "single-process mesh")
    if k1 + k2 <= 0:
        raise SystemExit(f"dist {label}/{dataflow}: no K1/K2 launch")
    if max(err64, err_u) > REL_TOL:
        raise SystemExit(f"dist {label}/{dataflow}: error {err64:.2e} / "
                         f"{err_u:.2e} > {REL_TOL}")
    out.append(row)
    return got


def _dist_serial(device, workdir):
    """Phase 13(a): sharded plans on a single-process mesh of the card.
    Saves the 4-token gate/up products and FFN outputs that the ranks of
    13(b) hold themselves to."""
    import numpy as np
    import torch

    from repro_torch import (PAPER_BUDGET, DistPartition, compress_ffn,
                             flexagon_plan, sparse_ffn_apply)
    from repro_torch.core.dataflows import DATAFLOWS
    from repro_torch.launch.mesh import make_virtual_mesh

    rows = []
    bs = (32, 32, 32)
    operands = _table6_operands(device)
    for name, (a, b) in operands.items():
        ref = a.double() @ b.double()
        for dataflow in DATAFLOWS:
            whole = flexagon_plan(a, b, dataflow=dataflow, block_shape=bs,
                                  backend="cuda")
            want = whole.apply(a, b)
            whole_ms, _ = _device_ms(lambda: whole.apply(a, b),
                                     DIST_TABLE6_REPS)
            for shards in DIST_SHARDS:
                plan = flexagon_plan(a, b, dataflow=dataflow, block_shape=bs,
                                     backend="cuda",
                                     mesh=make_virtual_mesh(shards))
                _dist_case(name, dataflow, plan, a, b, ref, want, whole_ms,
                           DIST_TABLE6_REPS, rows)

    rng, params, ws, x4 = _dist_inputs(device)
    wg, _, wd = ws
    x128 = torch.as_tensor(rng.standard_normal((128, QWEN2_D), np.float32),
                           device=device)
    h = {t: torch.as_tensor(rng.standard_normal((t, QWEN2_F), np.float32),
                            device=device) for t in (4, 128)}
    bs = (QWEN2_BLOCK,) * 3
    for tokens, x in ((4, x4), (128, x128)):
        for part, a, b in (("gate/up", x, wg), ("down", h[tokens], wd)):
            ref = a.double() @ b.double()
            for dataflow in ("ip_m", "op_m", "gust_m"):
                whole = flexagon_plan(a, b, dataflow=dataflow, block_shape=bs,
                                      backend="cuda")
                want = whole.apply(a, b)
                whole_ms, _ = _device_ms(lambda: whole.apply(a, b))
                for shards in DIST_SHARDS:
                    plan = flexagon_plan(a, b, dataflow=dataflow,
                                         block_shape=bs, backend="cuda",
                                         mesh=make_virtual_mesh(shards))
                    got = _dist_case(f"qwen2 {part} {tokens}", dataflow,
                                     plan, a, b, ref, want, whole_ms, REPS,
                                     rows)
                    if tokens == 4 and part == "gate/up":
                        torch.save(got.cpu(), workdir /
                                   f"serial_{dataflow}_{shards}.pt")

    # tiling inside each shard: V0 under PAPER_BUDGET, saved for 13(b)
    a, b = operands["V0"]
    ref = a.double() @ b.double()
    for dataflow in DIST_BUDGET_DATAFLOWS:
        whole = flexagon_plan(a, b, dataflow=dataflow, block_shape=(32,) * 3,
                              backend="cuda", memory_budget=PAPER_BUDGET)
        want = whole.apply(a, b)
        whole_ms, _ = _device_ms(lambda: whole.apply(a, b))
        for shards in DIST_SHARDS:
            plan = flexagon_plan(a, b, dataflow=dataflow,
                                 block_shape=(32,) * 3, backend="cuda",
                                 memory_budget=PAPER_BUDGET,
                                 partition=DistPartition(shards=shards))
            got = _dist_case("V0 PAPER_BUDGET", dataflow, plan, a, b, ref,
                             want, whole_ms, REPS, rows)
            torch.save(got.cpu(), workdir / f"v0_{dataflow}_{shards}.pt")

    # the sharded FFN at 4 tokens, on the serial path, for 13(b)
    for shards in DIST_SHARDS:
        comp = compress_ffn(params, tokens=4, block=QWEN2_BLOCK,
                            backend="cuda", mesh=make_virtual_mesh(shards))
        y = sparse_ffn_apply(comp, x4.reshape(1, 4, QWEN2_D))
        err = _rel_err(y.reshape(4, -1), _ffn64(x4, ws))
        log(f"dist serial qwen2 ffn tokens=4 shards={shards}: plan_in "
            f"{comp.dataflow_in} plan_out {comp.dataflow_out}, rel err "
            f"fp64 {err:.2e} (tol {REL_TOL:g})")
        if err > REL_TOL:
            raise SystemExit(f"dist serial ffn shards={shards}: error "
                             f"{err:.2e}")
        torch.save(y.cpu(), workdir / f"serial_ffn_{shards}.pt")
    return rows


def _has_work(plan):
    """Does a shard's plan (a FlexagonPlan or a TiledPlan) have an
    effectual block product?  (A shard that holds only the padding of the
    grid launches nothing.)"""
    from repro_torch import TiledPlan

    if isinstance(plan, TiledPlan):
        return any(_has_work(p) for p in plan.plans)
    ip = plan.index_plan
    if hasattr(ip, "npairs"):
        return int(ip.npairs.sum()) > 0
    return int(ip.seg_ptr[-1]) > 0


def _kernel_name(name):
    """A device event's short name: no return type, namespace, template
    or argument list (``stream_dest_kernel``, ``Memcpy DtoD``)."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("<")[0].split("(")[0].split("::")[-1].strip()


def _by_kernel(fn, reps=REPS, top=8):
    """Device time (ms) of one call of ``fn`` by kernel name: ``reps``
    calls profiled, each in its ``timed`` range as ``_device_ms`` does,
    and the call whose total is the median of those the profiler saw
    (it now and then drops a call's events).  Returns the ``top`` largest
    as (name, launches, ms) and that call's total."""
    import statistics
    from collections import Counter

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        for _ in range(reps):
            with record_function("timed"):
                fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    windows = [e.time_range for e in device if e.name == "timed"]
    calls = [[e for e in device if e.name != "timed"
              and w.start <= e.time_range.start <= w.end] for w in windows]
    calls = [c for c in calls if c]
    totals = [sum(e.device_time_total for e in c) for c in calls]
    call = calls[totals.index(statistics.median_low(totals))]
    by_name, launches = Counter(), Counter()
    for e in call:
        name = _kernel_name(e.name)
        by_name[name] += e.device_time_total / 1e3
        launches[name] += 1
    return ([(k, launches[k], v) for k, v in by_name.most_common(top)],
            sum(by_name.values()))


def _dist_breakdown(device, rows):
    """Where a sharded qwen2 gate/up apply at 4 tokens spends its device
    time, beside the unsharded plan's (by kernel name, the median call); and
    the padded shard plans' applies against each shard planned alone
    (unpadded) on the same contiguous shard operands, and against each
    shard planned alone at its operands' real extent."""
    import torch

    from repro_torch import flexagon_plan
    from repro_torch.launch.mesh import make_virtual_mesh

    _, _, ws, x4 = _dist_inputs(device)
    a, b = x4, ws[0]
    bs = (QWEN2_BLOCK,) * 3
    out = {}
    for dataflow, shards in DIST_BREAKDOWN:
        whole = flexagon_plan(a, b, dataflow=dataflow, block_shape=bs,
                              backend="cuda")
        plan = flexagon_plan(a, b, dataflow=dataflow, block_shape=bs,
                             backend="cuda", mesh=make_virtual_mesh(shards))
        key = f"qwen2 gate/up 4 {dataflow} shards={shards}"
        for label, fn in (("sharded", lambda: plan.apply(a, b)),
                          ("unsharded", lambda: whole.apply(a, b))):
            kernels, total = _by_kernel(fn)
            log(f"dist breakdown {key} {label} one apply: {total:.4f} ms "
                "of device time (the median of 20 calls); by kernel "
                + ", ".join(f"{k} x{c} {v:.4f}" for k, c, v in kernels))
            out[f"{key} {label}"] = {"total_ms": total, "kernels": kernels}
        mp, kp, np_ = plan.padded_grid
        a_d = torch.nn.functional.pad(a, (0, kp * bs[1] - a.shape[1],
                                          0, mp * bs[0] - a.shape[0]))
        b_d = torch.nn.functional.pad(b, (0, np_ * bs[2] - b.shape[1],
                                          0, kp * bs[1] - b.shape[0]))
        sl = [(a_d[t.i0 * bs[0]: t.i1 * bs[0],
                   t.k0 * bs[1]: t.k1 * bs[1]].contiguous(),
               b_d[t.k0 * bs[1]: t.k1 * bs[1],
                   t.j0 * bs[2]: t.j1 * bs[2]].contiguous())
              for t in plan.tiles]
        alone = [flexagon_plan(x, y, dataflow=dataflow, block_shape=bs,
                               backend="cuda") for x, y in sl]
        # the same shards cut to the operands' real extents (a 4-token
        # shard has 4 rows, not a padded block's 128)
        m, k = a.shape
        n = b.shape[1]
        sl_valid = [(a[t.i0 * bs[0]: min(t.i1 * bs[0], m),
                       t.k0 * bs[1]: min(t.k1 * bs[1], k)].contiguous(),
                     b[t.k0 * bs[1]: min(t.k1 * bs[1], k),
                       t.j0 * bs[2]: min(t.j1 * bs[2], n)].contiguous())
                    for t in plan.tiles]
        valid = [(flexagon_plan(x, y, dataflow=dataflow, block_shape=bs,
                                backend="cuda"), x, y)
                 for x, y in sl_valid if x.numel() and y.numel()]
        padded_ms, _ = _device_ms(
            lambda: [p.apply(x, y) for p, (x, y) in zip(plan.plans, sl)])
        alone_ms, _ = _device_ms(
            lambda: [p.apply(x, y) for p, (x, y) in zip(alone, sl)])
        valid_ms, _ = _device_ms(lambda: [p.apply(x, y) for p, x, y in valid])
        log(f"dist padding {key}: {shards} padded shard plans "
            f"{padded_ms:.4f} ms, each shard planned alone {alone_ms:.4f} "
            f"ms (device ms, contiguous shard operands padded to whole "
            f"blocks); cut to the real extents {valid_ms:.4f} ms")
        out[f"{key} padding"] = {"padded_ms": padded_ms,
                                 "alone_ms": alone_ms, "valid_ms": valid_ms}
    rows.append(out)


def dist_rank(rank, world, workdir, device):
    """One rank of phase 13(b) (``chip_smoke.py --dist-rank R W DIR``):
    the qwen2 gate/up product at 4 tokens in ip_m, op_m and gust_m, a
    sharded ``compress_ffn``, then V0 under PAPER_BUDGET (tiled and mixed
    shards), on a 1-D ``cuda`` DeviceMesh over a gloo group whose ranks
    share the one card; every plan takes ``device=None``, which must
    resolve to this rank's card.  Writes its rows to ``DIR/rank{R}.json``
    and exits non-zero on any failed gate."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import (PAPER_BUDGET, compress_ffn, flexagon_plan, obs,
                             sparse_ffn_apply)

    workdir = Path(workdir)
    # gloo: NCCL refuses two ranks of one communicator on one card, and
    # gloo's all_reduce takes CUDA tensors
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store",
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("shards",))
        _, params, ws, x4 = _dist_inputs(device)
        reg = obs.get_registry()
        rows = []

        def case(label, fn, plans, ref, serial):
            paths = {p.path for p in plans}
            devices = sorted({str(p.device) for p in plans})
            work = any(_has_work(p.plans[rank]) for p in plans)
            before = reg.value("dist.collectives")
            _reset_launches()
            got = fn()
            torch.cuda.synchronize()
            k1, k2 = _launches()
            coll = reg.value("dist.collectives") - before
            err64 = _rel_err(got.reshape(ref.shape), ref)
            err_s = _rel_err(got.reshape(ref.shape),
                             serial.to(device).reshape(ref.shape).double())
            # every rank times the same calls, so the merges line up; the
            # time holds the gloo all_reduce and its host copies
            events_ms = _events_ms(fn, DIST_RANK_REPS)
            row = {"world": world, "rank": rank, "case": label,
                   "paths": sorted(paths), "devices": devices,
                   "work": work, "k1": k1, "k2": k2,
                   "collectives": coll, "rel_err_fp64": err64,
                   "rel_err_serial": err_s, "events_ms": events_ms}
            print(f"dist collective world={world} rank={rank} {label:7s} "
                  f"path={'/'.join(sorted(paths))} device="
                  f"{'/'.join(devices)} shard work={work} "
                  f"K1={k1} K2={k2} "
                  f"dist.collectives={coll:.0f} rel err fp64 {err64:.2e} "
                  f"serial {err_s:.2e} (tol {REL_TOL:g}) events_ms="
                  f"{events_ms:.4f}", flush=True)
            rows.append(row)

        with EscapeOff():
            ref = x4.double() @ ws[0].double()
            for dataflow in ("ip_m", "op_m", "gust_m"):
                plan = flexagon_plan(x4, ws[0], dataflow=dataflow,
                                     block_shape=(QWEN2_BLOCK,) * 3,
                                     backend="cuda", mesh=mesh)
                case(dataflow, lambda: plan.apply(x4, ws[0]), [plan], ref,
                     torch.load(workdir / f"serial_{dataflow}_{world}.pt"))
            comp = compress_ffn(params, tokens=4, block=QWEN2_BLOCK,
                                backend="cuda", mesh=mesh)
            entry = comp.specialize(4)
            case("ffn", lambda: sparse_ffn_apply(
                comp, x4.reshape(1, 4, QWEN2_D)),
                [entry.plan_in, entry.plan_out], _ffn64(x4, ws),
                torch.load(workdir / f"serial_ffn_{world}.pt"))
            a, b = _table6_operands(device)["V0"]
            ref = a.double() @ b.double()
            for dataflow in DIST_BUDGET_DATAFLOWS:
                plan = flexagon_plan(a, b, dataflow=dataflow,
                                     block_shape=(32,) * 3, backend="cuda",
                                     memory_budget=PAPER_BUDGET, mesh=mesh)
                case(f"V0 {dataflow}", lambda: plan.apply(a, b), [plan], ref,
                     torch.load(workdir / f"v0_{dataflow}_{world}.pt"))
        (workdir / f"rank{rank}.json").write_text(json.dumps(rows))
    finally:
        dist.destroy_process_group()
    bad = [r for r in rows
           if r["paths"] != ["collective"] or r["collectives"] <= 0
           or r["devices"] != [str(device)]
           or (r["work"] and r["k1"] + r["k2"] <= 0)
           or max(r["rel_err_fp64"], r["rel_err_serial"]) > REL_TOL]
    if bad:
        print(f"dist collective world={world} rank={rank}: failed gates "
              f"{bad}", flush=True)
        return 1
    return 0


def _dist_collective(workdir, world):
    """Phase 13(b) at one world size: ``world`` ranks on the one card;
    every rank must exit 0 within RANK_TIMEOUT_S."""
    (workdir / "store").unlink(missing_ok=True)
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--dist-rank",
         str(r), str(world), str(workdir)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        outs.append(f"timed out after {RANK_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, text) in enumerate(zip(procs, outs)):
        for line in text.splitlines():
            if line.startswith("dist collective"):
                log(line)
        if p.returncode != 0:
            log(text[-4000:])
            raise SystemExit(f"dist collective world={world}: rank {r} "
                             f"exited {p.returncode}")
    if len(outs) < world:
        raise SystemExit(f"dist collective world={world}: a rank timed out")
    rows = []
    for r in range(world):
        rows += json.loads((workdir / f"rank{r}.json").read_text())
    for label in dict.fromkeys(row["case"] for row in rows):
        if sum(row["k1"] + row["k2"] for row in rows
               if row["case"] == label) <= 0:
            raise SystemExit(f"dist collective world={world} {label}: no "
                             "rank launched K1/K2")
    return rows


def dist_phase(device):
    """Phase 13: sharded plans.  (a) the serial path on single-process
    meshes of the card: Table 6 at block 32 in all six dataflows, the
    qwen2-1.5b FFN's gate/up and down products at 4 and 128 tokens in
    ip_m, op_m and gust_m, each at 2 and 4 shards; V0 under PAPER_BUDGET
    in op_m, gust_m and mixed at 2 and 4 shards, tiling inside each shard;
    two profiled qwen2 applies.  (b) the collective path: 2, then 4 gloo
    ranks on the card, each running its own shard and merging with one
    all_reduce; a rank whose shard has work must launch K1/K2, and so must
    some rank of every case.  K1/K2 launch counts run from 0 over (a)'s
    cases; both must launch."""
    import shutil

    from repro_torch import obs

    t0 = time.perf_counter()
    workdir = OUT_DIR / "dist"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    reg = obs.get_registry()
    coll0 = reg.value("dist.collectives")
    _reset_launches()
    try:
        with EscapeOff():
            serial = _dist_serial(device, workdir)
            k1, k2 = _launches()
            breakdown = []
            _dist_breakdown(device, breakdown)
        if reg.value("dist.collectives") != coll0:
            raise SystemExit("dist serial: a collective ran in one process")
        t_serial = time.perf_counter() - t0
        collective = []
        for world in DIST_SHARDS:
            collective += _dist_collective(workdir, world)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log(f"dist-path kernel launches (serial path, one apply per case, then "
        f"timing): stream_spmm {k1}, stream_panel_spmm {k2}")
    if min(k1, k2) <= 0:
        raise SystemExit("dist path: K1 or K2 never launched")
    seconds = time.perf_counter() - t0
    log(f"phase 13 (dist) took {seconds:.1f} s (serial {t_serial:.1f} s)")
    return {"serial": serial, "collective": collective, "k1": k1, "k2": k2,
            "breakdown": breakdown[0], "seconds": seconds}


# -- phase 14 ----------------------------------------------------------------

#: the quick corpus the learned policy fits in phase 14 (the JAX package's
#: payoff-gate recipe: 1600 synthetic patterns, labels 10% apart)
TUNE_CORPUS = dict(n_synthetic=1600, quick=True, seed=0, min_margin=0.1)


def _leaf_plans(plan):
    """The FlexagonPlans a plan applies through (itself, tiles, shards)."""
    from repro_torch import FlexagonPlan

    if isinstance(plan, FlexagonPlan):
        return [plan]
    return [leaf for sub in getattr(plan, "plans", ())
            for leaf in _leaf_plans(sub)]


def _verified(label, build, rows):
    """``build()`` a plan through an entry point with ``verify=True``,
    then verify it once more with the schedule memo cleared (the same work
    the build's gate did): the host ms of ``verify_plan`` beside the rest
    of the build's.  Any ERROR fails the run."""
    from repro_torch.analysis import errors_of, verify_plan
    from repro_torch.analysis import schedule as checker

    t0 = time.perf_counter()
    plan = build()
    t_build = time.perf_counter() - t0
    checker._MEMO.clear()
    t0 = time.perf_counter()
    diags = verify_plan(plan)
    t_verify = time.perf_counter() - t0
    errs = errors_of(diags)
    rows.append({"case": label, "kind": type(plan).__name__,
                 "dataflow": getattr(plan, "dataflow", None),
                 "phase1_ms": (t_build - t_verify) * 1e3,
                 "verify_ms": t_verify * 1e3,
                 "diagnostics": [f"{d.code}/{d.severity}" for d in diags]})
    if errs:
        raise SystemExit(f"verify {label}: " + "; ".join(map(str, errs)))
    return plan


def _selection_context(a, b, bs, backend):
    """The context phase 1 hands a policy for ``a @ b`` (for timing the
    policies' ``select`` alone)."""
    from repro_torch.api import _fingerprint, _pattern_of
    from repro_torch.backends import (SelectionContext, allowed_dataflows,
                                      get_backend)
    from repro_torch.core.selector import DeviceSpec, LayerShape

    (m, k), occ_a = _pattern_of(a, bs[:2])
    (_, n), occ_b = _pattern_of(b, bs[1:])
    be = get_backend(backend)
    return SelectionContext(
        shape=LayerShape(m=m, k=k, n=n, density_a=float(occ_a.mean()),
                         density_b=float(occ_b.mean()), block=bs),
        block_shape=bs, occ_a=occ_a, occ_b=occ_b,
        fingerprint=_fingerprint(occ_a, occ_b, (m, k, n), bs), backend=be,
        spec=DeviceSpec(), allowed=allowed_dataflows(be, bs),
        device=a.device)


def _median_us(fn, reps=5):
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e6)
    return sorted(ts)[len(ts) // 2]


def _analysis_verify(device, operands):
    """Phase 14(a): plans built with ``verify=True`` through the entry
    points, applied on the card; their device tables read back and
    audited; a corrupted plan caught before it launches anything."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import PAPER_BUDGET, compress_ffn, flexagon_plan
    from repro_torch import sparse_ffn_apply
    from repro_torch.analysis import (PlanVerificationError,
                                      check_device_schedule, verify_cache)
    from repro_torch.configs import get_config
    from repro_torch.core.dataflows import DATAFLOWS
    from repro_torch.launch.mesh import make_virtual_mesh
    from repro_torch.models.moe import plan_moe

    rows, applied = [], []
    bs32, bs128 = (32,) * 3, (QWEN2_BLOCK,) * 3
    rng = np.random.default_rng(SEED + 2)
    params, wg, wu, wd = _qwen2_params(rng, device, QWEN2_D, QWEN2_F,
                                       QWEN2_BLOCK)
    x4 = torch.as_tensor(rng.standard_normal((4, QWEN2_D), np.float32),
                         device=device)
    with EscapeOff():
        for name, (a, b) in operands.items():
            for d in DATAFLOWS:
                plan = _verified(f"{name} {d}", lambda: flexagon_plan(
                    a, b, dataflow=d, block_shape=bs32, backend="cuda",
                    verify=True), rows)
                applied.append((f"{name} {d}", plan, a, b))
        a, b = operands["V0"]
        for d in DATAFLOWS + ("mixed",):
            plan = _verified(f"V0 {d} PAPER_BUDGET", lambda: flexagon_plan(
                a, b, dataflow=d, block_shape=bs32, backend="cuda",
                memory_budget=PAPER_BUDGET, verify=True), rows)
            applied.append((f"V0 {d} PAPER_BUDGET", plan, a, b))
        for shards in DIST_SHARDS:
            for d in ("ip_m", "op_m", "gust_m"):
                label = f"qwen2 gate/up 4 {d} {shards} shards"
                plan = _verified(label, lambda: flexagon_plan(
                    x4, wg, dataflow=d, block_shape=bs128, backend="cuda",
                    mesh=make_virtual_mesh(shards, device), verify=True),
                    rows)
                if plan.path != "serial":
                    raise SystemExit(f"verify {label}: path {plan.path}")
                applied.append((label, plan, x4, wg))
        t0 = time.perf_counter()
        comp = compress_ffn(params, tokens=4, block=QWEN2_BLOCK,
                            backend="cuda", device=device, verify=True)
        comp.specialize(128)
        t_ffn = time.perf_counter() - t0
        from repro_torch.analysis import schedule as checker

        checker._MEMO.clear()
        t0 = time.perf_counter()
        ffn_diags = verify_cache(comp.plan_cache)
        t_cache = time.perf_counter() - t0
        rows.append({"case": "compress_ffn qwen2 (4, 128 tokens)",
                     "kind": "PlanCache", "dataflow": None,
                     "plans": len(comp.plan_cache),
                     "phase1_ms": (t_ffn - t_cache) * 1e3,
                     "verify_ms": t_cache * 1e3,
                     "diagnostics": [f"{d.code}/{d.severity}"
                                     for d in ffn_diags]})
        if any(d.is_error for d in ffn_diags):
            raise SystemExit(f"verify compress_ffn: {ffn_diags}")
        _verified("granite-moe-1b-a400m MoEPlan sort", lambda: plan_moe(
            get_config(GRANITE), 4, strategy="sort"), rows)

        # every K1/K2 plan on the card, against fp64
        _reset_launches()
        worst = 0.0
        for label, plan, a, b in applied:
            err = _rel_err(plan.apply(a, b), a.double() @ b.double())
            worst = max(worst, err)
            if err > REL_TOL:
                raise SystemExit(f"verify {label}: error {err:.2e}")
        xs = {4: x4.reshape(4, 1, QWEN2_D),
              128: torch.as_tensor(rng.standard_normal(
                  (1, 128, QWEN2_D), np.float32), device=device)}
        for tokens, x in xs.items():
            x2 = x.reshape(-1, QWEN2_D).double()
            ref = ((torch.nn.functional.silu(x2 @ wg.double())
                    * (x2 @ wu.double())) @ wd.double()).reshape(x.shape)
            err = _rel_err(sparse_ffn_apply(comp, x), ref)
            worst = max(worst, err)
            if err > REL_TOL:
                raise SystemExit(f"verify ffn {tokens}: error {err:.2e}")
        torch.cuda.synchronize()
        k1, k2 = _launches()
    if min(k1, k2) <= 0:
        raise SystemExit(f"verify: K1 {k1} / K2 {k2} launches")
    for r in rows:
        log(f"verify {r['case']:38s} {r['kind']:12s} phase1 "
            f"{r['phase1_ms']:9.2f} ms verify {r['verify_ms']:8.2f} ms "
            f"diagnostics {r['diagnostics'] or 'none'}")
    tot_p1 = sum(r["phase1_ms"] for r in rows)
    tot_v = sum(r["verify_ms"] for r in rows)
    log(f"verify: {len(rows)} builds, phase 1 {tot_p1:.1f} ms and "
        f"verify_plan {tot_v:.1f} ms of host time in all "
        f"({tot_v / max(tot_p1, 1e-9):.2f}x); {len(applied)} plans and the "
        f"FFN applied on the card: K1 {k1}, K2 {k2} launches, max rel err "
        f"vs fp64 {worst:.2e} (tol {REL_TOL:g})")

    # the device tables the kernels read, back from the card
    leaves = [leaf for _, plan, _, _ in applied for leaf in
              _leaf_plans(plan)]
    leaves += [leaf for plan in comp.plan_cache._plans.values()
               for leaf in _leaf_plans(plan)]
    t0 = time.perf_counter()
    table_errs = [d for leaf in leaves for d in check_device_schedule(leaf)]
    t_tables = time.perf_counter() - t0
    chunks = sum(leaf.aux["device_schedule"].n_chunk for leaf in leaves)
    cols = sum(leaf.aux["device_schedule"].cols.n_seg for leaf in leaves
               if leaf.aux["device_schedule"].cols is not None)
    log(f"verify device tables: {len(leaves)} cuda plans' DeviceSchedules "
        f"read back from {device} and audited ({chunks} K1/K2 chunks, "
        f"{cols} K2 column segments) in {t_tables * 1e3:.1f} ms: "
        f"{len(table_errs)} errors")
    if table_errs:
        raise SystemExit("verify device tables: "
                         + "; ".join(map(str, table_errs[:5])))

    # a caught fault: a pad entry aimed inside the grid (the reference's
    # pad-inbounds mutation), refused before anything launches
    _, plan, a, b = next(x for x in applied if x[1].dataflow == "gust_m")
    sp = plan.index_plan
    pad = lambda arr: np.append(np.asarray(arr), np.int32(0))  # noqa: E731
    bad = dataclasses.replace(plan, index_plan=dataclasses.replace(
        sp, ci=pad(sp.ci), cj=pad(sp.cj), a_slot=pad(sp.a_slot),
        b_slot=pad(sp.b_slot)))
    from repro_torch.analysis import verify_plan

    before = _launches()
    try:
        verify_plan(bad, raise_on_error=True)
    except PlanVerificationError as exc:
        caught = sorted({d.code for d in exc.diagnostics if d.is_error})
    else:
        raise SystemExit("verify: the corrupted plan was not caught")
    if _launches() != before or "pad-inbounds" not in caught:
        raise SystemExit(f"verify fault: codes {caught}, launches "
                         f"{before} -> {_launches()}")
    log(f"verify fault: a pad entry inside the {plan.dataflow} grid -> "
        f"PlanVerificationError {caught}; K1/K2 launches unchanged "
        f"{before}")
    return {"builds": rows, "k1": k1, "k2": k2, "max_rel_err": worst,
            "device_tables": {"plans": len(leaves), "chunks": chunks,
                              "column_segments": cols,
                              "ms": t_tables * 1e3,
                              "errors": len(table_errs)},
            "fault_codes": caught}, comp


def _analysis_trace(device, operands, comp):
    """Phase 14(b): one apply per dataflow under the dispatch recorder (no
    host sync), a RetraceDetector over PlanCache hits, and an engine's
    ``verify_plans``."""
    import torch

    from repro_torch import PlanCache, flexagon_plan
    from repro_torch.analysis import RetraceDetector, trace_report
    from repro_torch.configs import get_config
    from repro_torch.core.dataflows import DATAFLOWS
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine

    rows = []
    a, b = operands["V7"]
    with EscapeOff():
        for d in DATAFLOWS:
            plan = flexagon_plan(a, b, dataflow=d, block_shape=(32,) * 3,
                                 backend="cuda")
            plan.apply(a, b)                      # warm: build, first use
            rep = trace_report(plan, a, b)
            top = sorted(rep.ops.items(), key=lambda kv: -kv[1])[:4]
            rows.append({"dataflow": d, "host_syncs": rep.host_syncs,
                         "launches": {k: v for k, v in rep.launches.items()
                                      if v},
                         "aten_ops": rep.n_ops, "ops": rep.ops,
                         "flops": rep.flops, "op_hash": rep.op_hash})
            log(f"trace V7 {d:6s} host syncs {rep.host_syncs or 0} "
                f"launches {rows[-1]['launches']} aten ops {rep.n_ops} "
                f"(top {top}) flops {rep.flops:.3e} "
                f"hash {rep.op_hash[:12]}")
            if not rep.pure or sum(rep.launches.values()) != 1:
                raise SystemExit(f"trace {d}: syncs {rep.host_syncs}, "
                                 f"launches {rep.launches}")
        cache, det = PlanCache(), RetraceDetector()
        for _ in range(3):
            det.observe(cache.get(a, b, dataflow="ip_m",
                                  block_shape=(32,) * 3, backend="cuda"))
    if not det.stable or cache.stats["hits"] != 2:
        raise SystemExit(f"trace: retraced {det.retraces} / {cache.stats}")
    cfg = get_config("smollm-360m", smoke=True)
    model = build_model(cfg, device=device)
    engine = ServeEngine(model, model.init(seed=SEED, dtype=torch.bfloat16),
                         slots=4, max_seq=64, sparse_ffn=comp)
    diags = engine.verify_plans()
    log(f"trace RetraceDetector over 3 PlanCache hits: stable "
        f"{det.stable}; ServeEngine.verify_plans() over "
        f"{len(comp.plan_cache)} qwen2-width plans: "
        f"{[str(d) for d in diags] or 'no diagnostics'}")
    if any(d.is_error for d in diags):
        raise SystemExit(f"trace: verify_plans found {diags}")
    return {"per_dataflow": rows, "retrace_stable": det.stable,
            "engine_diagnostics": [str(d) for d in diags]}


def _tune_learned(device, operands):
    """Phase 14(c): the quick corpus and its forest, fitted here; Table 6
    and the qwen2 products planned with ``policy="learned"`` through
    ``REPRO_TUNE_MODEL``, applied on the card, beside a cold
    ``SimulatorPolicy``'s picks and the ``select`` latency of each."""
    import os

    import numpy as np
    import torch

    from repro_torch import flexagon_plan, get_policy, register_backend
    from repro_torch.backends import SimulatorBackend, SimulatorPolicy
    from repro_torch.backends import policies
    from repro_torch.tune import (corpus_matrices, fit_examples,
                                  generate_corpus, split_corpus)

    t0 = time.perf_counter()
    examples = generate_corpus(**TUNE_CORPUS)
    t_corpus = time.perf_counter() - t0
    train, held = split_corpus(examples, held_out=0.2, seed=0)
    t0 = time.perf_counter()
    fitted = fit_examples(train, model="forest")
    t_fit = time.perf_counter() - t0
    X, y = corpus_matrices(held)
    held_agree = float((fitted.model.predict_proba(X).argmax(1) == y).mean())
    path = OUT_DIR / "tune" / "model.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    fitted.save(str(path))
    os.environ["REPRO_TUNE_MODEL"] = str(path)
    policies._NAMED.pop("learned", None)
    learned = get_policy("learned")
    log(f"learned: quick corpus {len(examples)} examples in {t_corpus:.2f} "
        f"s, forest fit on {len(train)} in {t_fit:.2f} s, held-out "
        f"agreement with the simulator's labels {held_agree:.3f} over "
        f"{len(held)}; REPRO_TUNE_MODEL={path}")
    cold = SimulatorBackend()
    cold.name = "simulator-cold"
    register_backend(cold, overwrite=True)
    sim = SimulatorPolicy(backend=cold)

    rng = np.random.default_rng(SEED + 2)
    _, wg, _, wd = _qwen2_params(rng, device, QWEN2_D, QWEN2_F, QWEN2_BLOCK)
    cases = [(name, a, b, (32,) * 3) for name, (a, b) in operands.items()]
    for tokens in (4, 128):
        x = torch.as_tensor(rng.standard_normal((tokens, QWEN2_D),
                                                np.float32), device=device)
        h = torch.as_tensor(rng.standard_normal((tokens, QWEN2_F),
                                                np.float32), device=device)
        cases += [(f"qwen2 gate/up {tokens}", x, wg, (QWEN2_BLOCK,) * 3),
                  (f"qwen2 down {tokens}", h, wd, (QWEN2_BLOCK,) * 3)]
    rows, worst = [], 0.0
    _reset_launches()
    with EscapeOff():
        for label, a, b, bs in cases:
            ctx = _selection_context(a, b, bs, "cuda")
            fb = learned.fallbacks
            plan = flexagon_plan(a, b, block_shape=bs, backend="cuda",
                                 policy="learned", verify=True)
            fell = learned.fallbacks - fb
            err = _rel_err(plan.apply(a, b), a.double() @ b.double())
            worst = max(worst, err)
            t0 = time.perf_counter()
            sim_pick = sim.select(ctx)
            sim_us = (time.perf_counter() - t0) * 1e6
            learned_us = _median_us(lambda: learned.select(ctx))
            row = {"case": label, "learned": plan.dataflow,
                   "simulator": sim_pick, "fallback": bool(fell),
                   "learned_select_us": learned_us,
                   "simulator_select_us": sim_us, "rel_err_fp64": err}
            rows.append(row)
            log(f"learned {label:16s} -> {plan.dataflow:6s} "
                f"{'(fallback) ' if fell else ''}simulator -> "
                f"{sim_pick:6s} select {learned_us:8.1f} us vs simulator "
                f"{sim_us:10.1f} us (cold); rel err {err:.2e}")
            if plan.dataflow not in ctx.allowed or err > REL_TOL:
                raise SystemExit(f"learned {label}: {plan.dataflow} not in "
                                 f"{ctx.allowed} or error {err:.2e}")
        torch.cuda.synchronize()
        k1, k2 = _launches()
    agree = sum(r["learned"] == r["simulator"] for r in rows)
    med = lambda k: float(np.median([r[k] for r in rows]))  # noqa: E731
    log(f"learned: {len(rows)} products, agreement with SimulatorPolicy "
        f"{agree}/{len(rows)}, fallbacks "
        f"{sum(r['fallback'] for r in rows)}; median select "
        f"{med('learned_select_us'):.1f} us vs simulator "
        f"{med('simulator_select_us'):.1f} us "
        f"({med('simulator_select_us') / med('learned_select_us'):.0f}x); "
        f"K1 {k1}, K2 {k2} launches, max rel err {worst:.2e}")
    if min(k1, k2) <= 0:
        raise SystemExit(f"learned: K1 {k1} / K2 {k2} launches")
    return {"corpus": len(examples), "corpus_s": t_corpus, "fit_s": t_fit,
            "held_out_agreement": held_agree, "products": rows,
            "agreement": agree, "k1": k1, "k2": k2, "max_rel_err": worst}


def _tune_db(device, operands):
    """Phase 14(d): AutotunePolicy over Table 6 writing a TuneDB, then a
    fresh policy on the same file answering every layer from it."""
    import torch

    from repro_torch import flexagon_plan, register_backend
    from repro_torch.backends import AutotunePolicy, CudaBackend

    be = CudaBackend()
    be.name = "cuda-tunedb"
    register_backend(be, overwrite=True)
    path = OUT_DIR / "tune" / "tunedb.jsonl"
    path.parent.mkdir(parents=True, exist_ok=True)
    if path.exists():
        path.unlink()
    out = {}
    for run in ("sweep", "hit"):
        pol = AutotunePolicy(db=str(path))
        t0 = time.perf_counter()
        picks = {name: flexagon_plan(a, b, block_shape=(32,) * 3,
                                     backend=be, policy=pol).dataflow
                 for name, (a, b) in operands.items()}
        torch.cuda.synchronize()
        out[run] = {"s": time.perf_counter() - t0, "picks": picks,
                    "measurements": pol.measurements,
                    "db_hits": pol.db_hits, "entries": len(pol.db)}
        log(f"tunedb {run:5s}: {len(picks)} Table 6 layers in "
            f"{out[run]['s']:.3f} s, {pol.measurements} sweeps, "
            f"{pol.db_hits} db hits, {len(pol.db)} entries in {path.name} "
            f"(card {torch.cuda.get_device_name(device)!r} in the key)")
    n = len(operands)
    if out["sweep"]["measurements"] != n or out["hit"]["db_hits"] != n \
            or out["hit"]["measurements"] != 0 \
            or out["hit"]["picks"] != out["sweep"]["picks"]:
        raise SystemExit(f"tunedb: {out}")
    log(f"tunedb: the fresh policy answered all {n} layers from the file, "
        f"same picks, {out['sweep']['s'] / out['hit']['s']:.0f}x faster "
        f"than the sweep")
    return out


def analysis_phase(device):
    """Phase 14: verified plans, device tables, a caught fault, dispatch
    traces, the learned policy and the TuneDB, at full width."""
    t0 = time.perf_counter()
    operands = _table6_operands(device)
    verify, comp = _analysis_verify(device, operands)
    trace = _analysis_trace(device, operands, comp)
    learned = _tune_learned(device, operands)
    db = _tune_db(device, operands)
    seconds = time.perf_counter() - t0
    log(f"phase 14 (analysis, tune) took {seconds:.1f} s")
    return ({"verify": verify, "trace": trace, "seconds": seconds},
            {"learned": learned, "tunedb": db})


# -- phase 7 -----------------------------------------------------------------


def _gmm_ref64(x_real, w, sizes):
    """fp64 product of the real rows, grouped in order: (rows, N)."""
    import torch

    out, start = [], 0
    for g, size in enumerate(sizes):
        out.append(x_real[start:start + size].double() @ w[g].double())
        start += size
    return torch.cat(out) if out else torch.zeros(
        (0, w.shape[2]), dtype=torch.float64, device=w.device)


def _tensor_check(label, got, want, ref64=None, rows=None):
    """A kernel's tensor against its plain version (fp32 out: rtol = atol =
    TOL; bf16 out: one bf16 ulp) and, given ``ref64``, ``got``'s ``rows``
    (all rows by default) against fp64 (REL_TOL, or BF16_REL_TOL for bf16);
    raises on a miss.  Returns (max|kernel - plain|, the error relative to
    fp64)."""
    import torch

    err = float((got.float() - want.float()).abs().max()) \
        if got.numel() else 0.0
    if got.dtype == torch.float32:
        ok = torch.allclose(got, want, rtol=TOL, atol=TOL)
        rel_tol = REL_TOL
    else:
        ok = torch.allclose(got.float(), want.float(), rtol=BF16_ULP,
                            atol=TOL)
        rel_tol = BF16_REL_TOL
    rel = 0.0
    if ref64 is not None and ref64.numel():
        rel = _rel_err(got if rows is None else got[rows.long()], ref64)
    if not ok or rel > rel_tol:
        raise SystemExit(f"{label}: max|kernel-plain|={err:.3e}, rel err vs "
                         f"fp64 {rel:.2e} (tol {rel_tol:g})")
    return err, rel


def _gmm_case(device, rng, sizes, k, n, bm, dtypes, bk=8, bn=8,
              want_splits=None, w_scale=1.0):
    """One K3 sweep case on the device padding: each input type of
    ``dtypes`` with output in it and in fp32.  Operands of more than 2**24
    weights are drawn on the card (a generator seeded from ``rng``), the
    rest by ``rng``; the weights are standard normal times ``w_scale``.
    Returns the worst max|kernel - plain|."""
    import numpy as np
    import torch

    from repro_torch.kernels import moe_gmm as mg

    rows = sum(sizes)
    gids, scatter = mg.pad_groups_device(
        torch.tensor(sizes, device=device), bm, rows)
    real_tiles = sum(-(-s // bm) for s in sizes)
    if len(sizes) * k * n > 2 ** 24:
        gen = torch.Generator(device=device).manual_seed(
            int(rng.integers(2 ** 31)))
        x = torch.randn((rows, k), generator=gen, device=device)
        w = torch.randn((len(sizes), k, n), generator=gen,
                        device=device) * w_scale
    else:
        x = torch.as_tensor(rng.standard_normal((rows, k), np.float32),
                            device=device)
        w = torch.as_tensor(rng.standard_normal((len(sizes), k, n),
                                                np.float32),
                            device=device) * w_scale
    worst = 0.0
    for dt in dtypes:
        xd, wd = x.to(dt), w.to(dt)
        xp = torch.zeros((gids.numel() * bm, k), dtype=dt, device=device)
        xp[scatter.long()] = xd
        ref64 = _gmm_ref64(xd, wd, sizes)
        plan = mg.launch_plan(xp.shape[0], k, n, bm, dt)
        if want_splits is not None and dt == torch.bfloat16 \
                and (plan.splits > 1) != want_splits:
            raise SystemExit(f"moe_gmm sizes={sizes}: launch plan {plan}, "
                             f"want a K split: {want_splits}")
        for out_dt in sorted({dt, torch.float32}, key=str):
            kw = dict(bm=bm, bk=bk, bn=bn, out_dtype=out_dt)
            got = mg.gmm(xp, wd, gids, **kw)
            want = mg.gmm_plain(xp, wd, gids, **kw)
            torch.cuda.synchronize()
            label = (f"bm={bm} K={k} N={n} sizes={sizes} in={dt} "
                     f"out={out_dt}")
            err, rel = _tensor_check(f"moe_gmm {label}", got, want, ref64,
                                     scatter)
            if got[real_tiles * bm:].any():
                raise SystemExit(f"moe_gmm {label}: an idle tile wrote "
                                 "non-zero rows")
            log(f"sweep moe_gmm {label} tiles={gids.numel():3d} (real "
                f"{real_tiles:3d}) rows={plan.rows} grid={plan.grid} "
                f"max|kernel-plain|={err:.3e} rel vs fp64 {rel:.1e} ok")
            worst = max(worst, err)
    return worst


def gmm_sweep(device):
    """K3 vs its plain version and fp64: bm 16/64/128, bf16 and fp32 in,
    the group sizes of tests/test_kernels.py scaled to bm (empty groups,
    groups of several tiles) plus a ragged case, on the device padding
    (idle tiles after the real ones); then granite's decode shapes (32
    rows over ~21 of 32 groups, no K split), calls with few tiles that
    take the K split at bm 16 and 64, rows that are not 16-byte aligned
    (the element-wise load path), and jamba-v0.1-52b's decode shapes (8
    rows over 16 experts, K/N 4096/14336 and 14336/4096, bf16 in)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED + 3)
    both = (torch.bfloat16, torch.float32)
    worst = 0.0
    for bm in (16, 64, 128):
        cases = [[s * bm // 8 for s in sizes]
                 for sizes in ([8, 16, 0, 24], [0, 0, 8], [32])]
        cases.append([bm // 2 + 3, 0, 2 * bm + 1, 1])    # partial tiles
        for sizes in cases:
            worst = max(worst, _gmm_case(device, rng, sizes, 256, 200, bm,
                                         both))
    # decode: 4 slots x top-8 of 32 experts
    sizes = np.zeros(32, int)
    for _ in range(4):
        sizes[rng.choice(32, size=8, replace=False)] += 1
    sizes = sizes.tolist()
    log(f"sweep moe_gmm decode routing: {sum(sizes)} rows over "
        f"{sum(1 for s in sizes if s)} of 32 groups")
    for k, n in ((1024, 512), (512, 1024)):
        worst = max(worst, _gmm_case(device, rng, sizes, k, n, 16, both,
                                     want_splits=False))
    worst = max(worst, _gmm_case(device, rng, [9, 7], 1024, 512, 16, both,
                                 want_splits=True))
    worst = max(worst, _gmm_case(device, rng, [40, 70], 1024, 512, 64, both,
                                 want_splits=True))
    for bm in (16, 64):
        worst = max(worst, _gmm_case(device, rng, [5, 20, 0, 3], 260, 100,
                                     bm, both, bk=4, bn=4))
    # jamba decode: 4 slots x top-2 of 16 experts, at its widths, with
    # weights at moe_init's scale 1/sqrt(K) as the served model has them
    # (standard normal weights at these depths give rows in the hundreds,
    # and the kernel's and cuBLAS's fp32 sums, in two orders, then differ
    # on elements near zero by more than the fixed atol)
    sizes = np.zeros(16, int)
    for _ in range(4):
        sizes[rng.choice(16, size=2, replace=False)] += 1
    sizes = sizes.tolist()
    log(f"sweep moe_gmm jamba decode routing: {sum(sizes)} rows over "
        f"{sum(1 for s in sizes if s)} of 16 groups")
    for k, n in ((4096, 14336), (14336, 4096)):
        worst = max(worst, _gmm_case(device, rng, sizes, k, n, 16,
                                     (torch.bfloat16,), want_splits=False,
                                     w_scale=k ** -0.5))
        torch.cuda.empty_cache()
    return worst


# -- phases 8 and 9 ----------------------------------------------------------


GRANITE = "granite-moe-1b-a400m"


def _with_moe(cfg, **changes):
    import dataclasses

    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            **changes))


def _granite(device, strategy):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    return build_model(_with_moe(get_config(GRANITE), strategy=strategy),
                       device=device)


def _params(model, label):
    """Random bf16 params from SEED on the model's device, logged."""
    import torch

    t0 = time.perf_counter()
    params = model.init(seed=SEED, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"{label}: {n_params / 1e9:.3f} B random bf16 params (seed {SEED}) "
        f"made in {time.perf_counter() - t0:.2f} s")
    return params


def _prompts(vocab, seed, n=8):
    """``n`` prompts of 32-128 tokens drawn from ``seed``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(m))
            for m in rng.integers(32, 129, size=n)]


def _serve(model, params, prompts, label, new_tokens=16):
    """Serve ``prompts`` through a 4-slot ``ServeEngine`` (``max_seq``
    256), ``new_tokens`` each; gates every request's tokens.  Returns
    (engine, row)."""
    import torch

    from repro_torch.obs import default_buckets
    from repro_torch.serve import Request, ServeEngine

    vocab = model.cfg.vocab
    engine = ServeEngine(model, params, slots=4, max_seq=256)
    # fine buckets (1% wide) so the printed quantiles are read to 1%
    engine.metrics.histogram("serve.latency.decode_step_s",
                             buckets=default_buckets(1e-4, 1e1, 200))
    t0 = time.perf_counter()
    for rid, p in enumerate(prompts):
        engine.submit(Request(rid, p, max_new_tokens=new_tokens))
    results = engine.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    new = sum(len(v) for v in results.values())
    for rid in sorted(results):
        log(f"{label} req {rid}: prompt {len(prompts[rid]):3d} tokens -> "
            f"{results[rid]}")
    if sorted(results) != list(range(len(prompts))) or any(
            len(v) != new_tokens or not all(0 <= t < vocab for t in v)
            for v in results.values()):
        raise SystemExit(f"{label}: a request did not get {new_tokens} "
                         "tokens in the vocabulary")
    lat = engine.latency_stats()
    dec = lat["serve.latency.decode_step_s"]
    pre = lat["serve.latency.prefill_s"]
    log(f"{label}: {len(results)} requests, {new} new tokens in {wall:.3f} "
        f"s ({new / wall:.1f} tok/s, prefills included); decode step p50 "
        f"{dec['p50'] * 1e3:.2f} ms p99 {dec['p99'] * 1e3:.2f} ms (min "
        f"{dec['min'] * 1e3:.2f}, max {dec['max'] * 1e3:.2f}, "
        f"{dec['count']} steps); prefill mean {pre['mean'] * 1e3:.2f} ms "
        f"(min {pre['min'] * 1e3:.2f}, max {pre['max'] * 1e3:.2f}, "
        f"{pre['count']} prefills); stats {engine.stats}")
    row = {"requests": len(results), "new_tokens": new, "wall_s": wall,
           "tok_per_s": new / wall, "decode_p50_ms": dec["p50"] * 1e3,
           "decode_p99_ms": dec["p99"] * 1e3,
           "prefill_mean_ms": pre["mean"] * 1e3,
           "prefills": engine.stats["prefills"],
           "decode_steps": engine.stats["decode_steps"]}
    return engine, row


def serve_granite(device):
    """Serve 8 requests at granite's published width with sort dispatch.

    Returns (model, params, prompts, engine)."""
    model = _granite(device, "sort")
    cfg = model.cfg
    params = _params(model, f"serve {GRANITE}: {cfg.n_layers} layers, "
                     f"d_model {cfg.d_model}, {cfg.moe.num_experts} experts "
                     f"top-{cfg.moe.top_k}, d_ff {cfg.d_ff}, vocab "
                     f"{cfg.vocab}")
    prompts = _prompts(cfg.vocab, SEED + 4)
    engine, _ = _serve(model, params, prompts, "serve")
    return model, params, prompts, engine


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


class K3Recorder:
    """Records every K3 call ``_moe_sort`` makes while active, with the
    group sizes and scatter index of the padding it ran on.  It wraps the
    MoE module's names for the kernel and the padding, so the kernel's
    own launch counter is untouched."""

    def __enter__(self):
        from repro_torch.models import moe

        self.moe, self.gmm, self.pad = moe, moe.gmm, moe.pad_groups_device
        self.calls, last = [], {}

        def pad(group_sizes, bm, rows):
            out = self.pad(group_sizes, bm, rows)
            last["sizes"], last["scatter"] = group_sizes, out[1]
            return out

        def gmm(x, w, group_ids, **kw):
            out = self.gmm(x, w, group_ids, **kw)
            self.calls.append(dict(x=x, w=w, gids=group_ids, kw=kw, out=out,
                                   **last))
            return out

        moe.pad_groups_device, moe.gmm = pad, gmm
        return self

    def __exit__(self, *exc):
        self.moe.gmm, self.moe.pad_groups_device = self.gmm, self.pad


def _moe_layers(cfg) -> int:
    return sum(cfg.ffn_for_layer(i) == "moe" for i in range(cfg.n_layers))


def path_check(model, params, prompts):
    """Sort (K3) vs scatter (einsum) logits on one prompt; returns the K3
    calls of that prefill and of one 4-slot decode step."""
    import dataclasses

    import torch

    from repro_torch.serve import Request, ServeEngine

    prompt = prompts[0][None]
    with K3Recorder() as rec:
        sort = model.prefill(params, prompt, model.init_cache(1, 256))[0]
    scatter_model = dataclasses.replace(
        model, cfg=_with_moe(model.cfg, strategy="scatter"))
    scat = scatter_model.prefill(params, prompt,
                                 scatter_model.init_cache(1, 256))[0]
    a, b = sort[0, -1].float(), scat[0, -1].float()
    gap = float((a - b).abs().max() / b.abs().max())
    log(f"path check: prefill of {prompt.shape[1]} tokens, sort vs scatter "
        f"last-position logits max|d|/max|logits| = {gap:.4f} (tol "
        f"{LOGIT_TOL:g}); top-1 {int(a.argmax())} vs {int(b.argmax())}")
    if gap > LOGIT_TOL:
        raise SystemExit(f"sort and scatter logits differ by {gap:.4f}")
    engine = ServeEngine(model, params, slots=4, max_seq=256)
    for rid, p in enumerate(prompts[:4]):
        engine.submit(Request(rid, p, max_new_tokens=3))
    with K3Recorder() as dec:
        engine.step()
    torch.cuda.synchronize()
    _, breakdown = step_breakdown("decode step", engine.step)
    n = 3 * _moe_layers(model.cfg)
    if len(rec.calls) != n or len(dec.calls) != n:
        raise SystemExit(f"path check: {len(rec.calls)} prefill and "
                         f"{len(dec.calls)} decode K3 calls, want {n} each")
    return ([("prefill", c) for c in rec.calls]
            + [("decode", c) for c in dec.calls]), breakdown


def step_breakdown(label, fn, top=6):
    """Where one step's time goes: ``fn()`` under the profiler, its wall
    time on the host clock (ending in a sync), device time by kernel
    family and by name, and the device's idle share of the step.  Returns
    (``fn``'s result, row)."""
    from collections import Counter

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_family, by_name = Counter(), Counter()
    for e in events:
        name = e.name.lower()
        family = ("K3w wgrad" if "wgrad_" in name
                  else "K3 gmm" if "gmm_" in name
                  else "matmul" if ("gemm" in name or "cutlass" in name
                                    or "sm90" in name)
                  else "copy/fill" if ("memcpy" in name or "memset" in name
                                       or "fill" in name or "copy" in name)
                  else "other")
        by_family[family] += e.device_time_total / 1e3
        by_name[e.name[:60]] += e.device_time_total / 1e3
    busy = sum(by_family.values())
    log(f"{label} breakdown: wall {wall:.2f} ms, device busy "
        f"{busy:.3f} ms over {len(events)} device events (idle share "
        f"{1 - busy / wall:.3f}); by family "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in by_family.most_common()))
    log(f"{label} top kernels: " + "; ".join(
        f"{k} {v:.3f} ms" for k, v in by_name.most_common(top)))
    return out, {"wall_ms": wall, "busy_ms": busy, "events": len(events),
                 "idle_share": 1 - busy / wall,
                 "by_family_ms": dict(by_family),
                 "top_kernels_ms": dict(by_name.most_common(top))}


def time_k3(calls, worst, label=f"one {GRANITE} prefill"):
    """Replay each recorded K3 call: bit for bit against the main path's,
    against its plain version and fp64, then timed beside the plain
    version, ``torch._grouped_mm`` on the real rows, and its bound.
    ``t["by_phase"]`` splits the sums by prefill and decode."""
    import torch

    from repro_torch.kernels import moe_gmm as mg

    has_lib = hasattr(torch, "_grouped_mm")
    if not has_lib:
        log(f"library: none (torch {torch.__version__} has no "
            "torch._grouped_mm)")
    t = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0 if has_lib else None,
         "bound_ms": 0.0, "bytes": 0.0, "operations": 0.0,
         "calls": len(calls), "by_phase": {}}
    fallbacks = []      # timings that fell back to CUDA events
    for i, (phase, c) in enumerate(calls):
        x, w, gids, kw = c["x"], c["w"], c["gids"], c["kw"]
        sizes = c["sizes"].tolist()
        scatter = c["scatter"].long()
        got = mg.gmm(x, w, gids, **kw)
        want = mg.gmm_plain(x, w, gids, **kw)
        if not torch.equal(got, c["out"]):
            raise SystemExit(f"moe_gmm {phase} call {i}: the replay differs "
                             "from the main path's result")
        x_real = x[scatter]
        err, rel = _tensor_check(f"moe_gmm {phase} call {i}", got, want,
                                 _gmm_ref64(x_real, w, sizes), scatter)
        worst = max(worst, err)
        ms, how = _device_ms(functools.partial(mg.gmm, x, w, gids, **kw))
        fallbacks.append(how == "events")
        plain_ms, plain_how = _device_ms(
            functools.partial(mg.gmm_plain, x, w, gids, **kw))
        fallbacks.append(plain_how == "events")
        lib = ""
        if has_lib:
            lib_fn = functools.partial(
                torch._grouped_mm, x_real, w,
                offs=torch.cumsum(c["sizes"], 0).to(torch.int32))
            lib_err = float((lib_fn().float() - got[scatter].float())
                            .abs().max())
            lib_ms, lib_how = _device_ms(lib_fn)
            fallbacks.append(lib_how == "events")
            t["library_ms"] += lib_ms
            lib = f" library_ms={lib_ms:.4f} max|library-kernel|={lib_err:.2e}"
        # bytes: the real x rows, the slabs of groups with rows, the real
        # output rows, the tile ids; operations: the real rows' products
        (k, n), r = w.shape[1:], scatter.numel()
        active = sum(1 for s in sizes if s)
        nbytes = x.element_size() * (r * k + active * k * n + r * n) \
            + 4 * gids.numel()
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 2.0 * r * k * n / BF16_FLOP_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        log(f"time moe_gmm {phase:7s} call {i:3d} rows={r:4d} "
            f"tiles={gids.numel():3d} groups={active:2d} K={k} N={n} "
            f"ms={ms:.4f} ({how}) plain_ms={plain_ms:.4f} "
            f"bound_ms={bound:.5f} ({by}) max|kernel-plain|={err:.2e} "
            f"rel vs fp64 {rel:.1e}"
            + lib)
        t["ms"] += ms
        t["plain_ms"] += plain_ms
        t["bound_ms"] += bound
        t[by] += bound
        ph = t["by_phase"].setdefault(phase, {
            "calls": 0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
            "library_ms": 0.0 if has_lib else None})
        ph["calls"] += 1
        ph["ms"] += ms
        ph["plain_ms"] += plain_ms
        ph["bound_ms"] += bound
        if has_lib:
            ph["library_ms"] += lib_ms
    log(f"K3 times sum over {len(calls)} calls (each the median of {REPS} "
        f"calls after 3 warm-up calls): {label} and one 4-slot decode "
        f"step; timings on CUDA events (with the host's gaps): "
        f"{sum(fallbacks)} of {len(fallbacks)}")
    return t, worst


# -- phase 15 ----------------------------------------------------------------


JAMBA = "jamba-v0.1-52b"
RWKV = "rwkv6-3b"
SEAMLESS = "seamless-m4t-large-v2"
#: jamba on one card: one of its four published 8-layer periods (its 52 B
#: parameters take ~104 GB in bf16); every width is the published one
JAMBA_LAYERS = 8
#: prefill-then-decode (and seamless's decode) against the teacher-forced
#: forward, max|d| / max|logits|: the bound tests/test_models_decode.py
#: holds the JAX package to
DECODE_TOL = 3e-2
#: positions decoded after the prefill in the prefill-then-decode gate
DECODE_STEPS = 4
#: rwkv6-3b's gate runs in fp32 (fp32 params and products): in bf16 its
#: 32 layers amplify rounding, so that even two bf16 forwards of one
#: prompt at two lengths disagree at a shared position by more than
#: DECODE_TOL; the served bf16 model is held to LOGIT_TOL, the bound
#: phase 9 gives bf16 noise at full width
FP32_DECODE_TOL = 1e-4


def _free():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


class Fp32Compute:
    """While active, the port's ``dense`` and ``embedding_lookup`` compute
    in fp32 (their default is bf16); restores the default on exit."""

    def __enter__(self):
        import torch

        from repro_torch.models import layers

        self.fns = (layers.dense, layers.embedding_lookup)
        self.saved = [f.__defaults__ for f in self.fns]
        for f in self.fns:
            f.__defaults__ = (torch.float32,)
        return self

    def __exit__(self, *exc):
        for f, d in zip(self.fns, self.saved):
            f.__defaults__ = d


def _decode_gate(model, params, prompt, label, tol=DECODE_TOL):
    """Prefill all but the last DECODE_STEPS tokens of ``prompt``, decode
    those one by one, and hold each step's logits (the prefill's too) to
    ``model.logits`` of the whole prompt, the teacher-forced forward.
    Returns the errors, max|d| / max|logits| each."""
    n = len(prompt)
    s0 = n - DECODE_STEPS
    tokens = prompt[None]
    full = model.logits(params, tokens)[0].float()
    scale = float(full.abs().max())
    cache = model.init_cache(1, 256)
    logits, cache = model.prefill(params, tokens[:, :s0], cache)
    errs = [float((logits[0, -1].float() - full[s0 - 1]).abs().max())
            / scale]
    for t in range(s0, n):
        logits, cache = model.decode_step(params, cache, tokens[:, t:t + 1])
        errs.append(float((logits[0, -1].float() - full[t]).abs().max())
                    / scale)
    log(f"{label} prefill-then-decode: prompt {n} tokens, prefill {s0} then "
        f"{DECODE_STEPS} decode steps against the forward, max|d|/max|logits|"
        f" per position {[float(f'{e:.3g}') for e in errs]} (tol {tol:g})")
    if max(errs) > tol:
        raise SystemExit(f"{label}: decode differs from the forward by "
                         f"{max(errs):.4f}")
    return errs


def _jamba(device, worst):
    """jamba-v0.1-52b, one published period at full width, MoE on K3.
    Returns (row, K3 launches of its serving run, worst K3 error)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import moe_gmm as mg
    from repro_torch.models import build_model

    full = get_config(JAMBA)
    cfg = _with_moe(dataclasses.replace(full, n_layers=JAMBA_LAYERS),
                    strategy="sort")
    model = build_model(cfg, device=device)
    mixers = [cfg.mixer_for_layer(i) for i in range(cfg.n_layers)]
    log(f"models {JAMBA}: depth cut from {full.n_layers} to {cfg.n_layers} "
        f"layers, one of its {full.n_layers // len(full.pattern.mixers)} "
        f"published periods (the only cut): {mixers.count('mamba')} mamba "
        f"+ {mixers.count('attn')} attention layers, {_moe_layers(cfg)} MoE "
        f"layers of {cfg.moe.num_experts} experts top-{cfg.moe.top_k}; "
        f"d_model {cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, mamba "
        f"d_state {cfg.mamba_d_state} d_conv {cfg.mamba_d_conv} expand "
        f"{cfg.mamba_expand}; MoE dispatch sort (K3)")
    params = _params(model, f"models {JAMBA}")
    prompts = _prompts(cfg.vocab, SEED + 6)
    mg.gmm.launches = 0
    engine, row = _serve(model, params, prompts, f"models {JAMBA}")
    torch.cuda.synchronize()
    launches = mg.gmm.launches
    want = 3 * _moe_layers(cfg) * (row["prefills"] + row["decode_steps"])
    log(f"models {JAMBA}: K3 launched {launches} times; want 3 x "
        f"{_moe_layers(cfg)} x ({row['prefills']} prefills + "
        f"{row['decode_steps']} decode steps) = {want}")
    if launches <= 0 or launches != want:
        raise SystemExit(f"{JAMBA}: K3 launched {launches} times, want "
                         f"{want}")
    del engine
    calls, row["step"] = path_check(model, params, prompts)
    k3, worst = time_k3(calls, worst, label=f"one {JAMBA} prefill")
    del calls
    row["k3"] = {key: k3[key] for key in ("ms", "plain_ms", "library_ms",
                                          "bound_ms", "calls", "by_phase")}
    row["k3"]["launches"] = launches
    for phase, ph in k3["by_phase"].items():
        lib = ph["library_ms"]
        log(f"models {JAMBA} K3 per {phase}: {ph['calls']} calls, "
            f"{ph['ms']:.4f} ms (plain {ph['plain_ms']:.4f}, "
            f"torch._grouped_mm "
            f"{'none' if lib is None else format(lib, '.4f')}, bound "
            f"{ph['bound_ms']:.4f}; {ph['ms'] / ph['bound_ms']:.2f}x the "
            "bound)")
    # the decode gate at every expert and dense dispatch: the same params,
    # no top-2 route for a bf16 difference to flip (as JAX's own test)
    dense = dataclasses.replace(model, cfg=_with_moe(
        cfg, top_k=cfg.moe.num_experts, strategy="scatter"))
    row["decode_gate"] = _decode_gate(dense, params, prompts[0],
                                      f"models {JAMBA} (top-"
                                      f"{cfg.moe.num_experts}, scatter)")
    row["layers"] = cfg.n_layers
    row["params"] = sum(t.numel() for t in _leaves(params))
    return row, launches, worst


def _rwkv(device):
    """rwkv6-3b at its published width and depth (no kernel runs)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(RWKV)
    model = build_model(cfg, device=device)
    log(f"models {RWKV}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.d_model // cfg.rwkv_head_dim} heads of "
        f"{cfg.rwkv_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; "
        "published width and depth")
    params = _params(model, f"models {RWKV}")
    prompts = _prompts(cfg.vocab, SEED + 7)
    engine, row = _serve(model, params, prompts, f"models {RWKV}")
    states = [t for c in engine.cache["layers"] for t in c.values()]
    if any(t.dtype != torch.float32 or not bool(torch.isfinite(t).all())
           for t in states):
        raise SystemExit(f"{RWKV}: a recurrent state is not finite fp32 "
                         "after serving")
    log(f"models {RWKV}: {len(states)} recurrent state tensors, all fp32 "
        "and finite after serving")
    del engine
    row["decode_gate_bf16"] = _decode_gate(
        model, params, prompts[0], f"models {RWKV} bf16", tol=LOGIT_TOL)
    row["params"] = sum(t.numel() for t in _leaves(params))
    del params
    _free()
    params = model.init(seed=SEED)
    with Fp32Compute():
        row["decode_gate"] = _decode_gate(
            model, params, prompts[0], f"models {RWKV} fp32",
            tol=FP32_DECODE_TOL)
    return row


def _seamless(device):
    """seamless-m4t-large-v2 at its published width and depth: frames ->
    memory -> BOS prefill -> 16 greedy decode steps, against the
    teacher-forced decoder."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.layers import dense, embedding_lookup, rmsnorm

    cfg = get_config(SEAMLESS)
    model = build_model(cfg, device=device)
    log(f"models {SEAMLESS}: {model.n_enc} encoder + {model.n_dec} decoder "
        f"layers, d_model {cfg.d_model}, {cfg.n_heads} heads, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}; published width and depth")
    params = _params(model, f"models {SEAMLESS}")
    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    frames = torch.randn((4, 96, cfg.d_model), generator=gen,
                         device=device).to(torch.bfloat16)
    tokens = np.zeros((4, 1), np.int64)          # BOS
    cache = model.init_cache(4, 256)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {"frames": frames,
                                           "tokens": tokens}, cache)
    outs, steps = [logits.float()], []
    nxt = logits[:, -1].argmax(-1, keepdim=True).cpu().numpy()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    for _ in range(16):
        tokens = np.concatenate([tokens, nxt], axis=1)
        t0 = time.perf_counter()
        logits, cache = model.decode_step(params, cache, nxt)
        nxt = logits[:, -1].argmax(-1, keepdim=True).cpu().numpy()
        steps.append((time.perf_counter() - t0) * 1e3)
        outs.append(logits.float())
    dec = torch.cat(outs, dim=1)
    memory = model.encode(params, frames)
    x = embedding_lookup(params["embed"], torch.as_tensor(tokens,
                                                          device=device))
    x = model._decoder_pass(params, x, torch.arange(tokens.shape[1],
                                                    device=device), memory)
    forced = dense(params["lm_head"],
                   rmsnorm(params["final_norm"], x, cfg.norm_eps)).float()
    err = float((dec - forced).abs().max() / forced.abs().max())
    if not (0 <= tokens).all() or not (tokens < cfg.vocab).all():
        raise SystemExit(f"{SEAMLESS}: a token outside the vocabulary")
    log(f"models {SEAMLESS}: frames (4, 96, {cfg.d_model}), BOS prefill "
        f"{prefill_ms:.2f} ms, 16 greedy decode steps p50 "
        f"{float(np.median(steps)):.2f} ms (max {max(steps):.2f}); decode "
        f"against the teacher-forced decoder max|d|/max|logits| = "
        f"{err:.5f} (tol {DECODE_TOL:g}); tokens of row 0 "
        f"{tokens[0].tolist()}")
    if err > DECODE_TOL:
        raise SystemExit(f"{SEAMLESS}: decode differs from the "
                         f"teacher-forced decoder by {err:.4f}")
    return {"prefill_ms": prefill_ms,
            "decode_p50_ms": float(np.median(steps)),
            "decode_max_ms": max(steps), "decode_gate": err,
            "params": sum(t.numel() for t in _leaves(params))}


def models_phase(device, worst):
    """Phase 15: jamba (K3), rwkv6 and seamless at full width, each freed
    before the next is built.  Returns (rows, jamba's K3 launches, the
    worst K3 error)."""
    t_phase = time.perf_counter()
    rows = {}
    t0 = time.perf_counter()
    rows[JAMBA], launches, worst = _jamba(device, worst)
    _free()
    rows[JAMBA]["seconds"] = time.perf_counter() - t0
    log(f"phase 15(a) {JAMBA} took {rows[JAMBA]['seconds']:.1f} s")
    for name, fn in ((RWKV, _rwkv), (SEAMLESS, _seamless)):
        t0 = time.perf_counter()
        rows[name] = fn(device)
        _free()
        rows[name]["seconds"] = time.perf_counter() - t0
        log(f"phase 15 {name} took {rows[name]['seconds']:.1f} s")
    log(f"phase 15 (models) took {time.perf_counter() - t_phase:.1f} s")
    return rows, launches, worst


# -- phase 16 ----------------------------------------------------------------

#: the training run: steps of the uninterrupted run, and its checkpoint
#: period (the resumed run starts from the first checkpoint)
TRAIN_STEPS = 20
TRAIN_CKPT_EVERY = 10
#: its peak learning rate, ``TrainConfig``'s default.  At 3e-3 (the
#: launcher's default, which the CPU smoke runs use) the full-width model's
#: loss rose over these 20 steps on an H100; at 3e-4 it falls.  The
#: stream's next token is an affine map over granite's 49,155 tokens, too
#: many to learn in 20 steps of 4,096 tokens, so the loss falls slowly:
#: as published (its muP scalars) from 10.807 to 10.784 (the last 5
#: steps' mean), grad norms 0.22 to 0.20; without the scalars from 10.997
#: to 10.970, grad norms 1.49 to 1.20
TRAIN_LR = 3e-4
#: sort vs scatter gradients of one step, max|d| / max|g| per leaf, with
#: scatter's routes pinned to sort's.  fp32 (the MoE on K3's and K3w's fp32
#: kernels): the same sums in other orders; a 24-layer granite at d_model
#: 256 on the CPU differed by 4e-6.  bf16: both paths round at different
#: points.  Unpinned, a top-8 route that sits on a near tie flips between
#: them, and a flipped token's gradient differs by far more than rounding:
#: the published model (its muP scalars) read 0.531 on an H100
#: (blocks[3].ffn.w_up, median 0.054) with each path routing on its own,
#: 0 to 47 tokens a layer routed otherwise; pinned, 0.0315
#: (blocks[14].norm2.scale, median 0.016), and fp32 3.3e-6
GRAD_TOL_FP32 = 1e-4
GRAD_TOL_BF16 = 0.1


def _k3_launches():
    from repro_torch.kernels import moe_gmm as mg

    return {"moe_gmm": mg.gmm.launches,
            "moe_gmm_wgrad": mg.gmm_wgrad.launches}


def _wgrad_ref64(x_real, dy_real, sizes):
    """fp64 dw of the real rows, grouped in order: (G, K, N)."""
    import torch

    out = torch.zeros((len(sizes), x_real.shape[1], dy_real.shape[1]),
                      dtype=torch.float64, device=x_real.device)
    start = 0
    for g, size in enumerate(sizes):
        out[g] = (x_real[start:start + size].double().T
                  @ dy_real[start:start + size].double())
        start += size
    return out


def _routed_sizes(rng, tokens, experts, top_k):
    """Rows per expert of ``tokens`` tokens each routed to ``top_k``
    distinct experts drawn uniformly."""
    import numpy as np

    picks = np.argsort(rng.random((tokens, experts)), axis=1)[:, :top_k]
    return np.bincount(picks.ravel(), minlength=experts).tolist()


def _misaligned(t):
    """A contiguous copy of ``t`` whose base lies one element past a
    16-byte boundary."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _grad_case(device, rng, sizes, k, n, bm, dtypes, seen, shuffle=False,
               function=True):
    """K3w and the Function's backward on one device padding (idle tiles
    after the real ones; dy zero on the padding rows, as ``_moe_sort``'s
    backward gives it): K3w against its plain version and fp64 for each
    input type with output in it and in fp32, in bf16 through both of its
    kernels where the shape allows the TMA one, each launched twice for
    the same bits; then ``gmm``'s dx and dw by
    autograd against autograd through ``gmm_plain``, with the launches
    the backward makes (one K3 for dx, one K3w), unless ``function`` is
    False.  ``shuffle`` permutes the row tiles (ids and rows together), so
    a group's tiles are not adjacent.  Adds the K3w kernels it ran to
    ``seen``.  Returns the worst max|kernel - plain| of K3w and of dx."""
    import torch

    from repro_torch.kernels import moe_gmm as mg

    rows, groups = sum(sizes), len(sizes)
    gids, scatter = mg.pad_groups_device(
        torch.tensor(sizes, device=device), bm, rows)
    sc = scatter.long()
    gen = torch.Generator(device=device).manual_seed(
        int(rng.integers(2 ** 31)))
    # dy at 1/sqrt(the largest group's rows), so each dw element is O(1)
    # as the weights are: a dw element sums one group's rows, and at
    # training shapes (~1,000 rows a group) unit-normal x and dy give sums
    # near 30 whose fp32 sum-order differences pass the fixed atol (on an
    # H100 unit-normal dy gave 2.9e-4 against it, at 1.7e-6 of fp64)
    x = torch.randn((rows, k), generator=gen, device=device)
    dy = torch.randn((rows, n), generator=gen, device=device) \
        * max(sizes) ** -0.5
    w = torch.randn((groups, k, n), generator=gen, device=device) * k ** -0.5
    padded = gids.numel() * bm
    if shuffle:
        perm = torch.randperm(gids.numel(), generator=gen, device=device)
        gids = gids[perm].contiguous()
        # row r of tile t moves to tile perm^-1[t]
        where = torch.empty_like(perm)
        where[perm] = torch.arange(perm.numel(), device=device)
        sc = where[sc // bm] * bm + sc % bm
    worst_w = worst_dx = 0.0
    for dt in dtypes:
        xp = torch.zeros((padded, k), dtype=dt, device=device)
        dyp = torch.zeros((padded, n), dtype=dt, device=device)
        xp[sc], dyp[sc] = x.to(dt), dy.to(dt)
        ref64 = _wgrad_ref64(x.to(dt), dy.to(dt), sizes)
        # bf16 runs each kernel its plan can pick for this shape: as laid
        # out (the TMA kernel where the shape allows it) and from bases 2
        # bytes off 16 (the general kernel)
        operands = [(xp, dyp)]
        if mg.wgrad_plan(padded, k, n, groups, bm, dt).variant == "tma":
            operands.append((_misaligned(xp), _misaligned(dyp)))
        for out_dt in sorted({dt, torch.float32}, key=str):
            want = mg.gmm_wgrad_plain(xp, dyp, gids, groups, bm=bm,
                                      out_dtype=out_dt)
            for xo, dyo in operands:
                plan = mg.wgrad_plan(padded, k, n, groups, bm, dt,
                                     xo.data_ptr() % 16 == 0
                                     and dyo.data_ptr() % 16 == 0)
                got = mg.gmm_wgrad(xo, dyo, gids, groups, bm=bm,
                                   out_dtype=out_dt)
                again = mg.gmm_wgrad(xo, dyo, gids, groups, bm=bm,
                                     out_dtype=out_dt)
                torch.cuda.synchronize()
                label = (f"bm={bm} K={k} N={n} groups={groups} rows={rows} "
                         f"in={dt} out={out_dt} variant={plan.variant}")
                err, rel = _tensor_check(f"moe_gmm_wgrad {label}", got,
                                         want, ref64)
                for g, size in enumerate(sizes):
                    if size == 0 and got[g].any():
                        raise SystemExit(f"moe_gmm_wgrad {label}: empty "
                                         f"group {g} has a non-zero "
                                         "gradient")
                if not torch.equal(got, again):
                    raise SystemExit(f"moe_gmm_wgrad {label}: two launches "
                                     "on the same inputs differ")
                seen.add(plan.variant)
                log(f"sweep moe_gmm_wgrad {label} tiles={gids.numel()} "
                f"{'shuffled ' if shuffle else ''}"
                    f"tile={plan.tile[0]}x{plan.tile[1]} "
                    f"max|kernel-plain|={err:.3e} "
                    f"rel vs fp64 {rel:.1e}; two launches bit-identical ok")
                worst_w = max(worst_w, err)
        if not function:
            continue
        # the Function on the card against autograd through gmm_plain
        wd = w.to(dt)
        before = _k3_launches()
        leaves = [xp.clone().requires_grad_(True),
                  wd.clone().requires_grad_(True)]
        out = mg.gmm(*leaves, gids, bm=bm, bk=k, bn=n)
        if out.grad_fn is None:
            raise SystemExit("gmm on the card: the result has no grad_fn")
        out.backward(dyp)
        torch.cuda.synchronize()
        made = {key: v - before[key] for key, v in _k3_launches().items()}
        if made != {"moe_gmm": 2, "moe_gmm_wgrad": 1}:
            raise SystemExit(f"gmm forward + backward launched {made}, want "
                             "2 K3 (forward, dx) and 1 K3w")
        plain = [xp.clone().requires_grad_(True),
                 wd.clone().requires_grad_(True)]
        mg.gmm_plain(*plain, gids, bm=bm, bk=k, bn=n).backward(dyp)
        dx64 = mg.gmm_plain(dyp.double(), wd.double().transpose(1, 2)
                            .contiguous(), gids, bm=bm, bk=n, bn=k)
        for name, a, b, r64 in (
                ("dx", leaves[0].grad, plain[0].grad, dx64),
                ("dw", leaves[1].grad, plain[1].grad, ref64)):
            err, _ = _tensor_check(f"GroupedMatmul {name} bm={bm} K={k} "
                                   f"N={n} {dt}", a, b, r64)
            if name == "dx":
                worst_dx = max(worst_dx, err)
            else:
                worst_w = max(worst_w, err)
        log(f"sweep GroupedMatmul bm={bm} K={k} N={n} groups={groups} "
            f"{'shuffled ' if shuffle else ''}{dt}: dx, dw vs autograd through gmm_plain and vs fp64 ok; "
            f"backward launches {made}")
    return worst_w, worst_dx


def _wgrad_far_case(device, rng, seen):
    """K3w on a tile list longer than the TMA kernel's bitmap: 140,000
    tiles of 16 rows, nearly all idle (random rows the kernel must skip),
    with one group's tiles on both sides of the bitmap's edge, one only
    past it and one empty; bf16 through the TMA kernel, fp32 out, against
    its plain version and fp64, launched twice for the same bits; adds its
    kernel to ``seen``.  Returns max|kernel - plain|."""
    import torch

    from repro_torch.kernels import moe_gmm as mg

    bm, k, n, tiles = 16, 64, 48, 140_000
    # the TMA kernel's bitmap in shared memory holds the first tile ids;
    # past them its producer ballots the ids as it goes
    edge = mg.WGRAD_MAP_WORDS * 32
    gids = torch.full((tiles,), mg.IDLE, dtype=torch.int32, device=device)
    listed = {0: list(range(5, 12)) + list(range(edge - 3, edge + 4)),
              1: list(range(tiles - 9, tiles)) + [edge + 100]}
    for g, ts in listed.items():
        gids[torch.tensor(ts, device=device)] = g
    gen = torch.Generator(device=device).manual_seed(
        int(rng.integers(2 ** 31)))
    x = torch.randn((tiles * bm, k), generator=gen, device=device
                    ).to(torch.bfloat16)
    dy = (torch.randn((tiles * bm, n), generator=gen, device=device)
          * 0.1).to(torch.bfloat16)
    plan = mg.wgrad_plan(tiles * bm, k, n, 3, bm)
    if plan.variant != "tma":
        raise SystemExit(f"far-tiles K3w case: plan {plan}, want tma")
    got = mg.gmm_wgrad(x, dy, gids, 3, bm=bm, out_dtype=torch.float32)
    again = mg.gmm_wgrad(x, dy, gids, 3, bm=bm, out_dtype=torch.float32)
    want = mg.gmm_wgrad_plain(x, dy, gids, 3, bm=bm,
                              out_dtype=torch.float32)
    ref64 = mg.gmm_wgrad_plain(x.double(), dy.double(), gids, 3, bm=bm)
    torch.cuda.synchronize()
    label = (f"far tiles: {tiles} tiles (bitmap {edge}), "
             f"{sum(map(len, listed.values()))} listed")
    err, rel = _tensor_check(f"moe_gmm_wgrad {label}", got, want, ref64)
    if got[2].any():
        raise SystemExit(f"moe_gmm_wgrad {label}: the empty group has a "
                         "non-zero gradient")
    if not torch.equal(got, again):
        raise SystemExit(f"moe_gmm_wgrad {label}: two launches differ")
    seen.add(plan.variant)
    log(f"sweep moe_gmm_wgrad {label} variant={plan.variant} "
        f"max|kernel-plain|={err:.3e} rel vs fp64 {rel:.1e}; two launches "
        "bit-identical ok")
    return err


#: launches of the repeat gate, alone and beside a load on another stream
WGRAD_REPEATS = 64


def _wgrad_repeat_case(device, rng, sizes, k, n, bm):
    """K3w's TMA kernel launched WGRAD_REPEATS times on the same inputs
    back to back, then as often again while a matmul on a second stream
    takes SMs and memory from it (so its blocks start and wait on other
    schedules): every result must equal the first bit for bit.  A timing-
    dependent fault in the ring's ordering would show as a differing
    launch."""
    import torch

    from repro_torch.kernels import moe_gmm as mg

    groups = len(sizes)
    gids, scatter = mg.pad_groups_device(
        torch.tensor(sizes, device=device), bm, sum(sizes))
    gen = torch.Generator(device=device).manual_seed(
        int(rng.integers(2 ** 31)))
    padded = gids.numel() * bm
    x = torch.zeros((padded, k), dtype=torch.bfloat16, device=device)
    dy = torch.zeros((padded, n), dtype=torch.bfloat16, device=device)
    sc = scatter.long()
    x[sc] = torch.randn((sum(sizes), k), generator=gen, device=device
                        ).to(torch.bfloat16)
    dy[sc] = (torch.randn((sum(sizes), n), generator=gen, device=device)
              * max(sizes) ** -0.5).to(torch.bfloat16)
    plan = mg.wgrad_plan(padded, k, n, groups, bm)
    if plan.variant != "tma":
        raise SystemExit(f"K3w repeat gate: plan {plan}, want tma")
    first = mg.gmm_wgrad(x, dy, gids, groups, bm=bm)
    # launches that differ from the first, counted on the device (no sync)
    bad = torch.zeros((), dtype=torch.int64, device=device)

    def launches():
        nonlocal bad
        for _ in range(WGRAD_REPEATS):
            bad = bad + (mg.gmm_wgrad(x, dy, gids, groups, bm=bm)
                         != first).any()

    launches()
    side = torch.cuda.Stream(device)
    a = torch.randn((8192, 8192), generator=gen, device=device
                    ).to(torch.bfloat16)
    main = torch.cuda.current_stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        for _ in range(8):
            a = a @ a * 2.0 ** -7
    launches()
    main.wait_stream(side)
    torch.cuda.synchronize()
    label = (f"bm={bm} K={k} N={n} groups={groups} rows={sum(sizes)} "
             f"grid={plan.grid}")
    if int(bad):
        raise SystemExit(f"K3w repeat gate {label}: {int(bad)} of "
                         f"{2 * WGRAD_REPEATS} launches differ from the "
                         "first")
    log(f"sweep moe_gmm_wgrad repeat {label}: {2 * WGRAD_REPEATS} launches "
        f"({WGRAD_REPEATS} beside a matmul on another stream) "
        "bit-identical to the first")


def _moe_layer_grads(device):
    """One ``sort`` MoE layer of granite's width on the card, bf16: its
    output has a grad_fn and the gradient reaches x, the router and the
    three expert weights (finite, not all zero)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = _with_moe(get_config(GRANITE), strategy="sort")
    gen = torch.Generator(device=device).manual_seed(SEED + 17)
    p = moe.moe_init(gen, cfg, torch.bfloat16)
    for leaf in _leaves(p):
        leaf.requires_grad_(True)
    x = torch.randn((256, cfg.d_model), generator=gen, device=device
                    ).to(torch.bfloat16).requires_grad_(True)
    out = moe._moe_sort(p, cfg, x)
    if out.grad_fn is None:
        raise SystemExit("sort MoE on the card: the output has no grad_fn")
    out.float().square().sum().backward()
    grads = {"x": x.grad, "router": p["router"]["w"].grad,
             **{k: p[k].grad for k in ("w_gate", "w_up", "w_down")}}
    for name, g in grads.items():
        if g is None or not torch.isfinite(g).all() or not g.any():
            raise SystemExit(f"sort MoE on the card: no usable gradient for "
                             f"{name}")
    log(f"sort MoE layer on the card (256 tokens, bf16): grad_fn "
        f"{type(out.grad_fn).__name__}; gradients reach "
        + ", ".join(f"{k} (max|g| {float(g.float().abs().max()):.3g})"
                    for k, g in grads.items()))


def grad_sweep(device):
    """Phase 16(a): K3w and K3's backward against their plain versions on
    the card.  Returns the worst max|kernel - plain| of K3w and of K3's
    dx."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED + 16)
    both = (torch.bfloat16, torch.float32)
    worst_w = worst_dx = 0.0
    seen = set()        # K3w's kernels the sweep ran

    def run(sizes, k, n, bm, dtypes=both, **kw):
        nonlocal worst_w, worst_dx
        a, b = _grad_case(device, rng, sizes, k, n, bm, dtypes, seen, **kw)
        worst_w, worst_dx = max(worst_w, a), max(worst_dx, b)

    for bm in (16, 64, 128):
        for sizes in ([8, 16, 0, 24], [0, 0, 8], [32]):
            run([s * bm // 8 for s in sizes], 256, 200, bm)
        run([bm // 2 + 3, 0, 2 * bm + 1, 1], 256, 200, bm)   # partial tiles
        run([s * bm // 8 for s in (40, 8, 24, 56)], 256, 200, bm,
            shuffle=True)                                    # tiles apart
    run([5, 20, 0, 3], 260, 100, 16)          # rows not 16-byte aligned
    # 8-row tiles: the general kernel's 16-byte loads (K3w alone)
    run([5, 20, 0, 3], 256, 200, 8, function=False)
    worst_w = max(worst_w, _wgrad_far_case(device, rng, seen))
    # granite's training shapes: 4096 tokens x top-8 over 32 experts
    sizes = _routed_sizes(rng, 4096, 32, 8)
    log(f"sweep training routing: {sum(sizes)} rows over {len(sizes)} "
        f"experts, {min(sizes)}-{max(sizes)} each")
    from repro_torch.kernels import moe_gmm as mg

    for k, n in ((1024, 512), (512, 1024)):
        plan = mg.wgrad_plan(mg.tile_bound(sum(sizes), len(sizes), 16) * 16,
                             k, n, len(sizes), 16)
        if plan.variant != "tma":
            raise SystemExit(f"K3w's plan at granite's training shape "
                             f"(K, N) = ({k}, {n}) is {plan}, want the TMA "
                             "kernel")
        run(sizes, k, n, 16)
        _wgrad_repeat_case(device, rng, sizes, k, n, 16)
        torch.cuda.empty_cache()
    # a few blocks a call, each with many pieces: the ring wraps often
    _wgrad_repeat_case(device, rng, [3000, 0, 1700, 40], 256, 200, 64)
    if seen != {"tma", "mma", "fma"}:
        raise SystemExit(f"the sweep ran K3w's {sorted(seen)}, want tma, "
                         "mma and fma")
    _moe_layer_grads(device)
    return worst_w, worst_dx


def _train_cfg():
    from repro_torch.configs import get_config

    return _with_moe(get_config(GRANITE), strategy="sort")


class TrainRecorder:
    """While active, records the K3 forward calls of the first MoE layer
    of a step (the first three ``_moe_sort`` makes), the group sizes and
    scatter index of its padding, and the backward products of the last
    three ``GroupedMatmul`` backward passes (the first layer's, the last a
    backward reaches): each K3w call with the K3 ``dx`` call the same
    backward made just before it.  It wraps the MoE module's names and the
    kernel module's private ``_k3`` and ``_k3w``; the launch counters, on
    the public ``gmm`` and ``gmm_wgrad``, are untouched."""

    def __enter__(self):
        import collections

        from repro_torch.kernels import moe_gmm as mg
        from repro_torch.models import moe

        self.moe, self.mg = moe, mg
        self.gmm, self.pad = moe.gmm, moe.pad_groups_device
        self.k3, self.wgrad = mg._k3, mg._k3w
        self.forward, self.pads, last = [], [], {}
        self.backward = collections.deque(maxlen=3)

        def pad(group_sizes, bm, rows):
            out = self.pad(group_sizes, bm, rows)
            if not self.pads:
                self.pads.append((group_sizes, out[1]))
            return out

        def gmm(x, w, group_ids, **kw):
            out = self.gmm(x, w, group_ids, **kw)
            if len(self.forward) < 3:
                self.forward.append(dict(x=x.detach(), w=w.detach(),
                                         gids=group_ids, kw=kw,
                                         out=out.detach()))
            return out

        def k3(*args):
            last["k3"] = args
            return self.k3(*args)

        def wgrad(x, dy, group_ids, groups, bm, out_dtype):
            self.backward.append(dict(dx=last.pop("k3"), x=x, dy=dy,
                                      gids=group_ids, groups=groups,
                                      kw=dict(bm=bm, out_dtype=out_dtype)))
            return self.wgrad(x, dy, group_ids, groups, bm, out_dtype)

        moe.gmm, moe.pad_groups_device = gmm, pad
        mg._k3, mg._k3w = k3, wgrad
        return self

    def __exit__(self, *exc):
        self.moe.gmm, self.moe.pad_groups_device = self.gmm, self.pad
        self.mg._k3, self.mg._k3w = self.k3, self.wgrad


def _bound(r, k, n, active, tiles, elem=2):
    """(ms, side) of one grouped product of ``r`` real rows: bytes of the
    real rows in and out, the ``active`` groups' (K, N) slabs and the tile
    ids at HBM_BYTES_PER_S; 2 r K N bf16 operations at BF16_FLOP_PER_S."""
    nbytes = elem * (r * k + active * k * n + r * n) + 4 * tiles
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * r * k * n / BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _library(label, fn, check):
    """``torch._grouped_mm`` as a yardstick: (ms, max|library - kernel|),
    or (None, None) where the installed torch lacks it or refuses these
    operands (logged)."""
    import torch

    if not hasattr(torch, "_grouped_mm"):
        return None, None
    try:
        got = fn()
    except (RuntimeError, TypeError, ValueError) as e:
        log(f"library {label}: torch._grouped_mm refused: "
            f"{str(e).splitlines()[0][:160]}")
        return None, None
    return _device_ms(fn)[0], float((got.float() - check.float()).abs().max())


def time_train_k3(rec, n_moe):
    """Replay the recorded first-layer calls of one training step: the
    three K3 forwards (bit for bit against the step's own results), the
    three K3 ``dx`` products on the transposed weights (with the transpose
    copy timed on its own) and the three K3w products, each against its
    plain version and timed beside it, ``torch._grouped_mm`` on the real
    rows and its bound.  Returns per-kernel rows summed over the replayed
    calls and the per-step estimate (x ``n_moe`` layers; forwards twice,
    for the recompute under remat)."""
    import torch

    from repro_torch.kernels import moe_gmm as mg

    sizes_t, scatter = rec.pads[0]
    sizes = sizes_t.tolist()
    sc = scatter.long()
    offs = torch.cumsum(sizes_t, 0).to(torch.int32)
    r, active = sc.numel(), sum(1 for s in sizes if s)
    tiles = rec.forward[0]["gids"].numel()
    if not all(torch.equal(b["gids"], rec.forward[0]["gids"])
               for b in rec.backward):
        raise SystemExit("remat: the recomputed routing of the first MoE "
                         "layer differs from its forward")
    rows = {}

    def add(name, ms, plain_ms, lib_ms, bound, side, err, extra=""):
        t = rows.setdefault(name, {"ms": 0.0, "plain_ms": 0.0,
                                   "library_ms": 0.0, "bound_ms": 0.0,
                                   "bytes": 0.0, "operations": 0.0,
                                   "calls": 0, "max_abs_err": 0.0})
        t["ms"] += ms
        t["plain_ms"] += plain_ms
        t["library_ms"] = None if lib_ms is None or t["library_ms"] is None \
            else t["library_ms"] + lib_ms
        t["bound_ms"] += bound
        t[side] += bound
        t["calls"] += 1
        t["max_abs_err"] = max(t["max_abs_err"], err)
        log(f"time train {name:13s} call {t['calls']} rows={r} "
            f"tiles={tiles} groups={active} ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} bound_ms={bound:.5f} ({side}) "
            f"library_ms={'none' if lib_ms is None else f'{lib_ms:.4f}'} "
            f"max|kernel-plain|={err:.2e}{extra}")

    for c in rec.forward:
        x, w, gids, kw = c["x"], c["w"], c["gids"], c["kw"]
        got = mg.gmm(x, w, gids, **kw)
        if not torch.equal(got, c["out"]):
            raise SystemExit("train replay: K3 differs from the step's own "
                             "forward")
        err, _ = _tensor_check("train K3 forward", got,
                               mg.gmm_plain(x, w, gids, **kw))
        (k, n) = w.shape[1:]
        lib_ms, lib_err = _library(
            "forward", lambda: torch._grouped_mm(x[sc], w, offs=offs),
            got[sc])
        add("moe_gmm fwd", _device_ms(lambda: mg.gmm(x, w, gids, **kw))[0],
            _device_ms(lambda: mg.gmm_plain(x, w, gids, **kw))[0], lib_ms,
            *_bound(r, k, n, active, tiles), err,
            "" if lib_err is None else f" max|library-kernel|={lib_err:.2e}")
    for c in rec.backward:
        dyw, wt, gids, bm, bk, bn, out_dt = c["dx"]
        (n, k) = wt.shape[1:]
        # the transpose copy of the slab, the other way (the same bytes)
        t_ms = _device_ms(lambda: wt.transpose(1, 2).contiguous())[0]
        got = mg.gmm(dyw, wt, gids, bm=bm, bk=bk, bn=bn, out_dtype=out_dt)
        err, _ = _tensor_check("train K3 dx", got, mg.gmm_plain(
            dyw, wt, gids, bm=bm, bk=bk, bn=bn, out_dtype=out_dt))
        lib_ms, lib_err = _library(
            "dx", lambda: torch._grouped_mm(dyw[sc], wt, offs=offs), got[sc])
        add("moe_gmm dx", _device_ms(lambda: mg.gmm(
            dyw, wt, gids, bm=bm, bk=bk, bn=bn, out_dtype=out_dt))[0],
            _device_ms(lambda: mg.gmm_plain(
                dyw, wt, gids, bm=bm, bk=bk, bn=bn, out_dtype=out_dt))[0],
            lib_ms, *_bound(r, n, k, active, tiles), err,
            f" transpose_ms={t_ms:.4f}"
            + ("" if lib_err is None else
               f" max|library-kernel|={lib_err:.2e}"))
        rows["moe_gmm dx"]["transpose_ms"] = \
            rows["moe_gmm dx"].get("transpose_ms", 0.0) + t_ms
        x, dy, g, kw = c["x"], c["dy"], c["groups"], c["kw"]
        plan = mg.wgrad_plan(x.shape[0], x.shape[1], dy.shape[1], g,
                             kw["bm"], x.dtype, x.data_ptr() % 16 == 0
                             and dy.data_ptr() % 16 == 0)
        got = mg.gmm_wgrad(x, dy, gids, g, **kw)
        if not torch.equal(got, mg.gmm_wgrad(x, dy, gids, g, **kw)):
            raise SystemExit("train replay: two K3w launches on the same "
                             "inputs differ")
        err, _ = _tensor_check("train K3w", got,
                               mg.gmm_wgrad_plain(x, dy, gids, g, **kw))
        lib_ms, lib_err = _library(
            "dw", lambda: torch._grouped_mm(x[sc].t(), dy[sc], offs=offs),
            got)
        # the library's product alone, on rows gathered beforehand
        xs, dys = x[sc], dy[sc]
        bare_ms, _ = _library(
            "dw bare", lambda: torch._grouped_mm(xs.t(), dys, offs=offs),
            got)
        # CUDA events around whole calls: the host's tensor-map encode and
        # launch between the kernels included
        ev_ms = _events_ms(lambda: mg.gmm_wgrad(x, dy, gids, g, **kw))
        add("moe_gmm_wgrad",
            _device_ms(lambda: mg.gmm_wgrad(x, dy, gids, g, **kw))[0],
            _device_ms(lambda: mg.gmm_wgrad_plain(x, dy, gids, g, **kw))[0],
            lib_ms, *_bound(r, x.shape[1], dy.shape[1], active, tiles), err,
            f" variant={plan.variant} tile={plan.tile[0]}x{plan.tile[1]} "
            f"events_ms={ev_ms:.4f} bit-identical "
            f"library_bare_ms="
            f"{'none' if bare_ms is None else f'{bare_ms:.4f}'}"
            + ("" if lib_err is None else
               f" max|library-kernel|={lib_err:.2e}"))
        t = rows["moe_gmm_wgrad"]
        t["events_ms"] = t.get("events_ms", 0.0) + ev_ms
        t["library_bare_ms"] = None if bare_ms is None \
            or t.get("library_bare_ms", 0.0) is None \
            else t.get("library_bare_ms", 0.0) + bare_ms
        t["variants"] = sorted(set(t.get("variants", [])) | {plan.variant})
        t["tile"] = list(plan.tile)
    per_step = {
        "moe_gmm_ms": n_moe * (2 * rows["moe_gmm fwd"]["ms"]
                               + rows["moe_gmm dx"]["ms"]),
        "transpose_ms": n_moe * rows["moe_gmm dx"]["transpose_ms"],
        "moe_gmm_wgrad_ms": n_moe * rows["moe_gmm_wgrad"]["ms"]}
    log(f"train K3 replay of the first MoE layer ({REPS} timed calls each, "
        f"median): per step x {n_moe} layers (forwards twice, for the "
        f"recompute) K3 {per_step['moe_gmm_ms']:.3f} ms, transposes "
        f"{per_step['transpose_ms']:.3f} ms, K3w "
        f"{per_step['moe_gmm_wgrad_ms']:.3f} ms")
    return rows, per_step


def _quantiles(xs):
    import numpy as np

    return (float(np.percentile(xs, 50)), float(np.percentile(xs, 99)))


def train_granite(device):
    """Phase 16(b): granite-moe-1b-a400m at full width through
    ``launch.train.train``, MoE ``sort``, fp32 master params from SEED,
    remat; TRAIN_STEPS steps with a checkpoint every TRAIN_CKPT_EVERY, then
    a run resumed from the first checkpoint.  Returns (row, the K3 and
    K3w launches of the uninterrupted run, the last state)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.checkpoint.checkpointer import tree_flatten
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import make_batch_iterator
    from repro_torch.kernels import moe_gmm as mg
    from repro_torch.launch.train import train

    cfg = _train_cfg()
    tcfg = TrainConfig(global_batch=8, seq_len=512, lr=TRAIN_LR,
                       warmup_steps=TRAIN_STEPS // 10,
                       total_steps=TRAIN_STEPS, remat=True, seed=SEED)
    n_moe = _moe_layers(cfg)
    n_attn = _attn_layers(cfg)
    # attention: each layer's forward twice (the recomputation under
    # remat) and its backward once, all on the kernel
    want = {"moe_gmm": 3 * n_moe * 3, "moe_gmm_wgrad": 3 * n_moe,
            "attention_forward": 2 * n_attn, "attention_backward": n_attn,
            "attention_launches": 2 * n_attn + 3 * n_attn,
            "attention_plain_cuda": 0}
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        counts, seen = [], {}

        def on_step(step, state, batch):
            counts.append({**_k3_launches(), **_attn_calls()})
            if step == TRAIN_CKPT_EVERY:
                # the trainer makes new tensors each step: no copy needed
                seen["params"], seen["batch"] = state.params, batch

        log(f"train {GRANITE}: {cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, {cfg.moe.num_experts} experts top-"
            f"{cfg.moe.top_k} (sort), vocab {cfg.vocab}; batch "
            f"{tcfg.global_batch} x {tcfg.seq_len} tokens, fp32 master "
            f"params, remat, {TRAIN_STEPS} steps, checkpoint every "
            f"{TRAIN_CKPT_EVERY}")
        mg.gmm.launches = 0
        mg.gmm_wgrad.launches = 0
        _reset_attn_counters()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, hist = train(cfg, tcfg, steps=TRAIN_STEPS,
                            ckpt_dir=str(work / "run"),
                            ckpt_every=TRAIN_CKPT_EVERY, log_every=5,
                            device=device, on_step=on_step)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _k3_launches()
        peak = torch.cuda.max_memory_allocated()
        counts.append({**launches, **_attn_calls()})
        launches["attention"] = counts[-1]["attention_launches"]
        deltas = [{k: b[k] - a[k] for k in b} for a, b in
                  zip(counts, counts[1:])]
        log(f"train launches per step: {deltas[0]} (want {want}); total "
            f"{launches}")
        if any(d != want for d in deltas):
            raise SystemExit(f"train: per-step launches {deltas}, want "
                             f"{want} every step")
        losses = [h["loss"] for h in hist]
        gnorms = [h["grad_norm"] for h in hist]
        if not np.all(np.isfinite(losses + gnorms)):
            raise SystemExit(f"train: a loss or grad norm is not finite: "
                             f"{losses} {gnorms}")
        last5 = float(np.mean(losses[-5:]))
        log(f"train losses {[round(v, 4) for v in losses]}; grad norms "
            f"{[round(v, 3) for v in gnorms]}; mean of the last 5 "
            f"{last5:.4f} vs first {losses[0]:.4f}")
        if not last5 < losses[0]:
            raise SystemExit("train: the loss did not fall")
        steady = [h["dt"] for h in hist[1:]]
        p50, p99 = _quantiles(steady)
        tokens = tcfg.global_batch * tcfg.seq_len
        log(f"train step time p50 {p50 * 1e3:.1f} ms p99 {p99 * 1e3:.1f} ms "
            f"over steps 1-{TRAIN_STEPS - 1} (step 0 {hist[0]['dt']:.2f} s); "
            f"{tokens / p50:.0f} tokens/s at p50; run {wall:.1f} s with "
            f"checkpoints; peak memory {peak / 2 ** 30:.2f} GiB")
        del state

        # resume from the first checkpoint, in a directory of its own
        resumed = work / "resume"
        resumed.mkdir()
        name = f"step_{TRAIN_CKPT_EVERY:08d}"
        shutil.copytree(work / "run" / name, resumed / name)
        shutil.rmtree(work / "run")
        first = {}

        def on_first(step, state, batch):
            first.setdefault("at", (step, state.params, batch))

        t0 = time.perf_counter()
        state, hist2 = train(cfg, tcfg, steps=TRAIN_STEPS,
                             ckpt_dir=str(resumed),
                             ckpt_every=TRAIN_STEPS + 1, resume=True,
                             log_every=5, device=device, on_step=on_first)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        step, params, batch = first["at"]
        same = step == TRAIN_CKPT_EVERY and all(
            torch.equal(a, b) for a, b in zip(tree_flatten(params),
                                              tree_flatten(seen["params"])))
        same_batch = sorted(batch) == sorted(seen["batch"]) and all(
            batch[k].tobytes() == seen["batch"][k].tobytes() for k in batch)
        src = make_batch_iterator(cfg, tcfg, start_step=TRAIN_CKPT_EVERY)
        stream = next(src)
        src.close()
        same_stream = all(stream[k].tobytes() == batch[k].tobytes()
                          for k in stream)
        d_loss = hist2[0]["loss"] - losses[TRAIN_CKPT_EVERY]
        log(f"train resume: restored step {step}, params bit-equal to the "
            f"run's at step {TRAIN_CKPT_EVERY}: {same}; first batch equal "
            f"to the run's: {same_batch} (and to the stream's: "
            f"{same_stream}); its loss {hist2[0]['loss']:.6f} vs the run's "
            f"{losses[TRAIN_CKPT_EVERY]:.6f} (d {d_loss:.2e}); "
            f"{len(hist2)} steps in {resume_s:.1f} s")
        if not (same and same_batch and same_stream):
            raise SystemExit("train resume: the restored state or batch "
                             "differs from the uninterrupted run's")
        del params, seen
    finally:
        shutil.rmtree(work, ignore_errors=True)
    row = {"steps": TRAIN_STEPS, "tokens_per_step": tokens,
           "losses": losses, "grad_norms": gnorms, "step_p50_ms": p50 * 1e3,
           "step_p99_ms": p99 * 1e3, "first_step_s": hist[0]["dt"],
           "tokens_per_s_p50": tokens / p50, "run_s": wall,
           "peak_gib": peak / 2 ** 30, "launches": launches,
           "launches_per_step": want, "resume_s": resume_s,
           "resume_loss_diff": d_loss, "resume_losses":
           [h["loss"] for h in hist2]}
    return row, launches, state, tcfg


def train_profile(device, state, tcfg):
    """One recorded and one profiled step from ``state``; then the
    recorded first-layer K3/K3w calls replayed."""
    import torch

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.train import make_train_step

    cfg = _train_cfg()
    step_fn = make_train_step(build_model(cfg, device=device), tcfg)
    src = SyntheticLM(vocab=cfg.vocab, batch=tcfg.global_batch,
                      seq_len=tcfg.seq_len, seed=tcfg.seed)
    with TrainRecorder() as rec:
        state, _ = step_fn(state, src.batch_at(TRAIN_STEPS))
    batch = src.batch_at(TRAIN_STEPS + 1)
    (state, _), breakdown = step_breakdown(
        "train step", lambda: step_fn(state, batch), top=8)
    del state
    with torch.no_grad():
        rows, per_step = time_train_k3(rec, _moe_layers(cfg))
    return breakdown, rows, per_step


def grad_path_check(device):
    """Phase 16(c): one step's loss and per-leaf gradients of granite at
    full width through ``sort`` (K3, K3w) and through ``scatter``
    (``torch.einsum``, no kernel), on the same fp32 params from SEED and
    one batch of 2 x 128 tokens: in bf16 (the served compute) and with the
    model in fp32 (K3's and K3w's fp32 kernels)."""
    import contextlib
    import dataclasses
    import statistics

    import torch

    from repro_torch.checkpoint.checkpointer import tree_flatten
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.train.trainer import loss_and_grads

    cfg = _train_cfg()
    sort = build_model(cfg, device=device)
    scatter = dataclasses.replace(sort, cfg=_with_moe(cfg,
                                                      strategy="scatter"))
    params = sort.init(seed=SEED)
    batch = SyntheticLM(vocab=cfg.vocab, batch=2, seq_len=128,
                        seed=SEED + 16).batch_at(0)
    tcfg = TrainConfig(global_batch=2, seq_len=128)
    names = _leaf_names(params)
    rows = {}
    def gaps(gs, gc):
        """Each leaf's max|d| / max|g| of sort's gradients ``gs`` against
        scatter's ``gc``, with its name."""
        out = []
        for name, a, b in zip(names, tree_flatten(gs), tree_flatten(gc)):
            out.append((float((a.float() - b.float()).abs().max()
                              / b.float().abs().max().clamp_min(1e-30)),
                        name))
        return out

    for label, ctx, tol in (("bf16", contextlib.nullcontext(), GRAD_TOL_BF16),
                            ("fp32", Fp32Compute(), GRAD_TOL_FP32)):
        with ctx:
            before = _k3_launches()
            with RouteRecorder() as routed:
                ls, gs = loss_and_grads(sort, tcfg, params, batch)
            torch.cuda.synchronize()
            made = {k: v - before[k] for k, v in _k3_launches().items()}
            with RouteRecorder(pinned=routed.experts):
                lc, gc = loss_and_grads(scatter, tcfg, params, batch)
            with RouteRecorder() as own:
                lo, go = loss_and_grads(scatter, tcfg, params, batch)
            torch.cuda.synchronize()
        if min(made.values()) <= 0:
            raise SystemExit(f"grad path check {label}: sort launched "
                             f"{made}")
        for name, a in zip(names, tree_flatten(gs)):
            if "/ffn/" in name and (not torch.isfinite(a).all()
                                    or not a.any()):
                raise SystemExit(f"grad path check {label}: {name} has no "
                                 "usable sort gradient")
        pinned = gaps(gs, gc)
        worst, where = max(pinned)
        med = statistics.median(g for g, _ in pinned)
        d_loss = abs(float(ls) - float(lc)) / abs(float(lc))
        free, free_at = max(gaps(gs, go))
        n_layers = len(routed.experts) // 2
        moved = _rerouted(routed.experts[:n_layers], own.experts[:n_layers])
        log(f"grad path check {label}: sort vs scatter on sort's routes over "
            f"{len(pinned)} leaves, max|d|/max|g| worst {worst:.3e} "
            f"({where}), median {med:.3e} (tol {tol:g}); loss "
            f"{float(ls):.6f} vs {float(lc):.6f} (rel {d_loss:.1e}); sort "
            f"launches {made}; scatter on its own routes: tokens routed "
            f"otherwise by layer {moved}, worst {free:.3e} ({free_at}), "
            f"loss {float(lo):.6f}")
        if worst > tol:
            raise SystemExit(f"grad path check {label}: sort and scatter "
                             f"gradients differ by {worst:.3e} at {where}")
        rows[label] = {"worst": worst, "where": where, "median": med,
                       "loss_rel": d_loss, "tol": tol, "launches": made,
                       "own_routes": {"worst": free, "where": free_at,
                                      "rerouted": moved}}
    return rows


def _leaf_names(tree, prefix=""):
    """Leaf paths in the checkpointer's flatten order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _leaf_names(tree[k],
                                                             f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in _leaf_names(v, f"{prefix}[{i}]")]
    return [prefix]


def compression_run(device):
    """Phase 16(d): three steps with int8 gradient compression: finite
    losses and live error-feedback residuals."""
    import math

    import torch

    from repro_torch.checkpoint.checkpointer import tree_flatten
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.train import train

    tcfg = TrainConfig(global_batch=8, seq_len=512, lr=TRAIN_LR,
                       warmup_steps=1, total_steps=3, remat=True,
                       grad_compression=True, seed=SEED)
    state, hist = train(_train_cfg(), tcfg, steps=3, log_every=1,
                        device=device)
    live = sum(1 for e in tree_flatten(state.ef) if bool(e.abs().max() > 0))
    losses = [h["loss"] for h in hist]
    log(f"train --grad-compression: losses {losses}; error-feedback leaves "
        f"non-zero {live} of {len(tree_flatten(state.ef))}")
    if not all(math.isfinite(v) for v in losses) or live == 0:
        raise SystemExit("grad compression: a loss is not finite or the "
                         "error feedback is all zero")
    del state
    torch.cuda.empty_cache()
    return {"losses": losses, "ef_live_leaves": live}


def train_phase(device):
    """Phase 16: training on the card.  Returns (rows, the launches of the
    uninterrupted run, the K3w kernel row's timings and worst error, the
    worst dx error)."""
    t_phase = time.perf_counter()
    worst_w, worst_dx = grad_sweep(device)
    _free()
    log(f"phase 16(a) took {time.perf_counter() - t_phase:.1f} s")
    t0 = time.perf_counter()
    run, launches, state, tcfg = train_granite(device)
    breakdown, k3_rows, per_step = train_profile(device, state, tcfg)
    del state
    _free()
    log(f"phase 16(b) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths = grad_path_check(device)
    _free()
    log(f"phase 16(c) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    comp = compression_run(device)
    _free()
    log(f"phase 16(d) took {time.perf_counter() - t0:.1f} s")
    seconds = time.perf_counter() - t_phase
    log(f"phase 16 (train) took {seconds:.1f} s")
    worst_w = max(worst_w, k3_rows["moe_gmm_wgrad"]["max_abs_err"])
    worst_dx = max(worst_dx, k3_rows["moe_gmm dx"]["max_abs_err"])
    rows = {"run": run, "breakdown": breakdown, "k3_replay": k3_rows,
            "k3_per_step": per_step, "grad_paths": paths,
            "compression": comp, "worst_wgrad_err": worst_w,
            "worst_dx_err": worst_dx, "seconds": seconds}
    return rows, launches, k3_rows["moe_gmm_wgrad"], worst_w, worst_dx


# -- phase 17 ----------------------------------------------------------------

#: phase 17's forward batch (tokens) and its reps for the device times
SHARD_BATCH, SHARD_SEQ, SHARD_REPS = 4, 128, 3
#: phase 17(a)'s training: 3 AdamW steps of phase 16's batch
SHARD_STEPS = 3
#: the sharded forward against the unsharded one: max|d| / max|logits|
SHARD_TOL_FP32 = 1e-5
SHARD_TOL_BF16 = 2e-2
#: (b)'s ranks: fp32 products, d_ff and heads split in two, sums in
#: another order
SHARD_TP_TOL = 1e-4
#: (b)'s tokens routed otherwise than unsharded, per MoE layer, at most:
#: rounding moves a token whose 8th and 9th expert are near-tied (0-1 of
#: 512 a layer in the first runs); a fault in the router moves most
SHARD_REROUTED = 0.01
SHARD_TRAIN_TOL = 1e-4
SHARD_WORLD = 2
SHARD_SEED = SEED + 17
#: (c)'s ranks: granite at its published widths and SHARD_DP_LAYERS of its
#: 24 layers (two ranks each hold a sharded and an unsharded AdamW state:
#: at full depth ~37 GB a rank), a 4 x 128 batch in 4 microbatches over
#: (data 2, model 1): one row a microbatch, each rank's share padded to one
SHARD_DP_LAYERS = 12
SHARD_DP_BATCH, SHARD_DP_SEQ, SHARD_DP_MICRO = 4, 128, 4


def _shard_tokens(cfg):
    import numpy as np
    import torch

    rng = np.random.default_rng(SHARD_SEED)
    return torch.as_tensor(rng.integers(0, cfg.vocab,
                                        (SHARD_BATCH, SHARD_SEQ)))


def _moe_placements(placed):
    """The placements of the first MoE layer's four weights."""
    ffn = placed["blocks"][0]["ffn"]
    return {name: str(tuple((ffn[name]["w"] if name == "router"
                             else ffn[name]).placements))
            for name in ("w_gate", "w_up", "w_down", "router")}


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


class RouteRecorder:
    """While active, records each MoE layer's expert choice (``_route``'s
    top-k, in call order) or, with ``pinned`` (an earlier recording),
    routes each call to the recorded choice: the gates are the call's own
    probabilities at those experts, renormalised as ``_route`` does."""

    def __init__(self, pinned=None):
        self.pinned, self.experts = pinned, []

    def __enter__(self):
        import torch

        from repro_torch.models import moe

        self.moe, self.route = moe, moe._route

        def route(logits, top_k):
            if self.pinned is None:
                out = self.route(logits, top_k)
                self.experts.append(out[1].clone())
                return out
            experts = self.pinned[len(self.experts)]
            self.experts.append(experts)
            probs = torch.softmax(logits, dim=-1)
            gates = probs.gather(1, experts)
            return (gates / torch.clamp_min(gates.sum(-1, keepdim=True),
                                            1e-9), experts, probs)

        moe._route = route
        return self

    def __exit__(self, *exc):
        self.moe._route = self.route


def _rerouted(a, b):
    """Per MoE layer, the tokens whose expert set differs in ``a`` and
    ``b`` (two recordings)."""
    return [int((x.sort(dim=1).values != y.sort(dim=1).values).any(dim=1)
                .sum()) for x, y in zip(a, b)]


def _shard_forward(model, params, mesh, tokens, label, tol, rows):
    """Phase 17(a), one dtype: the unsharded forward, then the sharded one
    (K3 launches from 0: exactly 3 x n_layers), error and device ms."""
    import torch

    from repro_torch.kernels import moe_gmm as mg
    from repro_torch.sharding import (batch_sharding, distribute,
                                      params_sharding, use_mesh)

    n_moe = _moe_layers(model.cfg)
    with torch.no_grad():
        want = model.logits(params, tokens)
        placed = distribute(params, params_sharding(params, mesh, model.cfg))
        batch = distribute({"tokens": tokens},
                           batch_sharding({"tokens": tokens}, mesh))
        mg.gmm.launches = 0
        with use_mesh(mesh):
            out = model.logits(placed, batch["tokens"])
        torch.cuda.synchronize()
        k3 = mg.gmm.launches
        got = out.full_tensor()
        err = _rel(got, want)
        exact = bool(torch.equal(got, want))

        def sharded():
            with use_mesh(mesh):
                return model.logits(placed, batch["tokens"])

        ms_s = _events_ms(sharded, SHARD_REPS)
        ms = _events_ms(lambda: model.logits(params, tokens), SHARD_REPS)
    row = {"case": f"forward {label}", "mesh": "(data 1, model 1)",
           "placements": _moe_placements(placed),
           "logits_placements": str(tuple(out.placements)),
           "rel_err": err, "bit_identical": exact, "tol": tol,
           "k3": k3, "k3_want": 3 * n_moe, "events_ms": ms_s,
           "unsharded_events_ms": ms}
    log(f"shard (a) forward {label} {SHARD_BATCH}x{SHARD_SEQ}: mesh "
        f"{row['mesh']}, first MoE layer {row['placements']}, logits "
        f"{row['logits_placements']}; max|d|/max|logits| {err:.3e} (tol "
        f"{tol:g}), bit-identical {exact}; K3 {k3} (want 3 x {n_moe}); "
        f"events ms {ms_s:.3f} vs unsharded {ms:.3f}")
    rows.append(row)
    if err > tol or k3 != 3 * n_moe:
        raise SystemExit(f"shard (a) forward {label}: error {err:.3e}, K3 "
                         f"{k3}")
    del placed, out, got, want


def _shard_train(model, mesh, rows):
    """Phase 17(a)'s training: SHARD_STEPS AdamW steps unsharded, its
    params checkpointed and restored onto the mesh (bit for bit), then the
    same steps from the same init on the mesh; losses and grad norms
    within SHARD_TRAIN_TOL, K3 3 x 3 x n_layers and K3w 3 x n_layers a
    step on the mesh."""
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint.checkpointer import Checkpointer, tree_flatten
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import make_batch_iterator
    from repro_torch.sharding import (abstract_like, batch_sharding,
                                      distribute, params_sharding, use_mesh)
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.trainer import TrainState

    cfg = model.cfg
    n_moe = _moe_layers(cfg)
    tcfg = TrainConfig(global_batch=8, seq_len=512, lr=TRAIN_LR,
                       warmup_steps=0, total_steps=SHARD_STEPS, remat=True,
                       seed=SEED)
    it = make_batch_iterator(cfg, tcfg)
    batches = [{k: torch.as_tensor(v, device=model.device)
                for k, v in next(it).items()} for _ in range(SHARD_STEPS)]
    it.close()

    def run(state, on_mesh):
        step = make_train_step(model, tcfg)
        out = []
        for batch in batches:
            before = _k3_launches()
            t0 = time.perf_counter()
            if on_mesh:
                with use_mesh(mesh):
                    state, m = step(state, distribute(
                        batch, batch_sharding(batch, mesh)))
            else:
                state, m = step(state, batch)
            torch.cuda.synchronize()
            made = {k: v - before[k] for k, v in _k3_launches().items()}
            out.append({"loss": float(m["loss"]),
                        "grad_norm": float(m["grad_norm"]),
                        "s": time.perf_counter() - t0, "launches": made})
        return state, out

    state, plain = run(init_train_state(model, SEED, tcfg), False)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_shard_"))
    try:
        ckpt = Checkpointer(str(work))
        ckpt.save(SHARD_STEPS, state.params, blocking=True)
        shardings = params_sharding(state.params, mesh, cfg)
        t0 = time.perf_counter()
        restored, _ = ckpt.restore(abstract_like(state.params),
                                   shardings=shardings)
        restore_s = time.perf_counter() - t0
        exact = all(torch.equal(a.to_local(), b) and a.placements
                    == s.placements for a, b, s in zip(
                        tree_flatten(restored), tree_flatten(state.params),
                        tree_flatten(shardings)))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    del state, restored
    _free()
    log(f"shard (a) restore: the unsharded run's step-{SHARD_STEPS} params "
        f"restored onto the mesh in {restore_s:.1f} s, bit-identical "
        f"{exact}")
    if not exact:
        raise SystemExit("shard (a) restore: restored params differ")

    init = init_train_state(model, SEED, tcfg)
    params = distribute(init.params, params_sharding(init.params, mesh, cfg))
    del init
    state, sharded = run(TrainState(params, adamw_init(params), None), True)
    del state, params
    _free()
    want = {"moe_gmm": 3 * n_moe * 3, "moe_gmm_wgrad": 3 * n_moe}
    worst = 0.0
    for i, (a, b) in enumerate(zip(plain, sharded)):
        gaps = [abs(b[k] - a[k]) / abs(a[k]) for k in ("loss", "grad_norm")]
        worst = max(worst, *gaps)
        log(f"shard (a) train step {i}: loss {b['loss']:.6f} vs unsharded "
            f"{a['loss']:.6f}, grad norm {b['grad_norm']:.6f} vs "
            f"{a['grad_norm']:.6f} (rel {max(gaps):.2e}, tol "
            f"{SHARD_TRAIN_TOL:g}); launches {b['launches']} (want {want}); "
            f"host s {b['s']:.3f} vs {a['s']:.3f}")
        if b["launches"] != want:
            raise SystemExit(f"shard (a) train step {i}: launches "
                             f"{b['launches']}, want {want}")
    if worst > SHARD_TRAIN_TOL:
        raise SystemExit(f"shard (a) train: rel gap {worst:.2e}")
    rows.append({"case": "train", "mesh": "(data 1, model 1)",
                 "steps": sharded, "unsharded": plain, "worst_rel": worst,
                 "restore_exact": exact, "restore_s": restore_s})


def shard_rank(rank, world, workdir, device):
    """One rank of phase 17(b) (``chip_smoke.py --shard-rank R W DIR``):
    granite at full width on a (data 1, model 2) ``cuda`` mesh over gloo,
    in fp32 products; its logits against its own unsharded forward.
    Writes ``DIR/rank{R}.json``; exits non-zero on a failed gate."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.kernels import moe_gmm as mg
    from repro_torch.sharding import (batch_sharding, distribute,
                                      params_sharding, use_mesh)

    workdir = Path(workdir)
    # gloo: NCCL refuses two ranks of one communicator on one card; the
    # sharded forward's only collective is all_reduce, which gloo takes on
    # CUDA tensors
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store",
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cuda", (1, world),
                                mesh_dim_names=("data", "model"))
        model = _granite(device, "sort")
        params = model.init(seed=SEED)
        tokens = _shard_tokens(model.cfg).to(device)
        with Fp32Compute(), torch.no_grad():
            with RouteRecorder() as free:
                want = model.logits(params, tokens)
            placed = distribute(params, params_sharding(params, mesh,
                                                        model.cfg))
            batch = distribute({"tokens": tokens},
                               batch_sharding({"tokens": tokens}, mesh))
            ffn = placed["blocks"][0]["ffn"]
            local = {name: list((ffn[name]["w"] if name == "router"
                                 else ffn[name]).to_local().shape)
                     for name in ("w_gate", "w_down", "router")}

            def sharded():
                with use_mesh(mesh):
                    return model.logits(placed, batch["tokens"])

            mg.gmm.launches = 0
            comm = CommDebugMode()
            with comm, RouteRecorder() as routed:
                out = sharded()
            torch.cuda.synchronize()
            k3 = mg.gmm.launches
            kinds = {str(k): v for k, v in comm.get_comm_counts().items()}
            got = out.full_tensor()
            # the unsharded forward routed as the sharded one was: top-k
            # is not continuous, and a token whose 8th and 9th expert lie
            # within the sums' rounding of each other may pick another
            with RouteRecorder(routed.experts):
                pinned = model.logits(params, tokens)
            err = _rel(got, pinned)
            err_free = _rel(got, want)
            flips = _rerouted(free.experts, routed.experts)
            ms = _events_ms(sharded, SHARD_REPS)
            ms_plain = _events_ms(lambda: model.logits(params, tokens),
                                  SHARD_REPS)
        row = {"rank": rank, "world": world,
               "mesh": f"(data 1, model {world})",
               "placements": _moe_placements(placed),
               "local_shapes": local, "rel_err": err,
               "rel_err_free_routing": err_free, "rerouted_tokens": flips,
               "k3": k3, "collectives": kinds, "events_ms": ms,
               "unsharded_events_ms": ms_plain}
        print(f"shard (b) rank {rank}/{world}: mesh {row['mesh']}, first "
              f"MoE layer {row['placements']}, local {local}; max|d|/"
              f"max|logits| {err:.3e} vs its unsharded forward on the same "
              f"routing (tol {SHARD_TP_TOL:g}), {err_free:.3e} routed "
              f"freely; tokens routed otherwise per MoE layer {flips}; "
              f"K3 {k3}; collectives {kinds}; events ms {ms:.3f} vs "
              f"unsharded {ms_plain:.3f}", flush=True)
        (workdir / f"rank{rank}.json").write_text(json.dumps(row))
    finally:
        dist.destroy_process_group()
    moved = max(flips) / (SHARD_BATCH * SHARD_SEQ)
    if err > SHARD_TP_TOL or moved > SHARD_REROUTED or k3 <= 0 \
            or sum(kinds.values()) <= 0:
        print(f"shard (b) rank {rank}: failed gates", flush=True)
        return 1
    return 0


def _shard_ranks(workdir, world=SHARD_WORLD, part="b"):
    """Phase 17(``part``), (b) or (c): ``world`` ranks on the one card;
    every rank must exit 0 within RANK_TIMEOUT_S."""
    flag = {"b": "--shard-rank", "c": "--shard-dp-rank"}[part]
    (workdir / "store").unlink(missing_ok=True)
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), flag,
         str(r), str(world), str(workdir)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        outs.append(f"timed out after {RANK_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, text) in enumerate(zip(procs, outs)):
        for line in text.splitlines():
            if line.startswith(f"shard ({part})"):
                log(line)
        if p.returncode != 0:
            log(text[-4000:])
            raise SystemExit(f"shard ({part}): rank {r} exited "
                             f"{p.returncode}")
    if len(outs) < world:
        raise SystemExit(f"shard ({part}): a rank timed out")
    return [json.loads((workdir / f"rank{r}.json").read_text())
            for r in range(world)]


def shard_dp_rank(rank, world, workdir, device):
    """One rank of phase 17(c) (``chip_smoke.py --shard-dp-rank R W DIR``):
    granite at its published widths, SHARD_DP_LAYERS layers, MoE ``sort``,
    3 AdamW steps of a SHARD_DP_BATCH x SHARD_DP_SEQ batch in
    SHARD_DP_MICRO microbatches on a (data ``world``, model 1) ``cuda``
    mesh over gloo (params whole on each rank, the batch's rows split),
    in fp32 products, against the same 3 steps unsharded on this rank.  The microbatches' rows do not divide the data ranks:
    each rank pads its share to one row, so K3 must see one padded row's
    tokens x top-k a forward call, not the whole microbatch's.  The
    unsharded run takes the batch's rows in the order of the sharded
    microbatches (``trainer.microbatch_rows``), so both runs form the same
    microbatches.  Each sharded step also reports the host seconds spent in
    its collectives (each c10d op between two device synchronizations, so
    the step itself runs a little slower).  Writes ``DIR/rank{R}.json``;
    exits non-zero on a failed gate."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.checkpoint.checkpointer import tree_flatten, tree_map
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import make_batch_iterator
    from repro_torch.kernels.moe_gmm import tile_bound
    from repro_torch.models import build_model, moe
    from repro_torch.sharding import (NamedSharding, batch_sharding,
                                      distribute, use_mesh)
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.trainer import TrainState, microbatch_rows

    workdir = Path(workdir)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store",
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cuda", (world, 1),
                                mesh_dim_names=("data", "model"))
        cfg = dataclasses.replace(_train_cfg(), n_layers=SHARD_DP_LAYERS)
        model = build_model(cfg, device=device)
        n_moe = _moe_layers(cfg)
        tcfg = TrainConfig(global_batch=SHARD_DP_BATCH, seq_len=SHARD_DP_SEQ,
                           microbatches=SHARD_DP_MICRO, lr=TRAIN_LR,
                           warmup_steps=0, total_steps=SHARD_STEPS,
                           remat=True, seed=SEED)
        it = make_batch_iterator(cfg, tcfg)
        batches = [{k: torch.as_tensor(v, device=device)
                    for k, v in next(it).items()}
                   for _ in range(SHARD_STEPS)]
        it.close()
        order = torch.as_tensor(np.concatenate(microbatch_rows(
            SHARD_DP_BATCH, SHARD_DP_MICRO, world)), device=device)
        per_rank = -(-(SHARD_DP_BATCH // SHARD_DP_MICRO) // world)
        want_rows = tile_bound(per_rank * SHARD_DP_SEQ * cfg.moe.top_k,
                               cfg.moe.num_experts, moe.SORT_BM) \
            * moe.SORT_BM
        rows, gmm = [], moe.gmm

        def counted(x, w, group_ids, **kw):
            rows.append(int(x.shape[0]))
            return gmm(x, w, group_ids, **kw)

        class CollectiveClock(TorchDispatchMode):
            """Host seconds inside c10d ops (a collective, or the wait for
            one), the device synchronized before and after each.  A DTensor
            op is handed back to DTensor (as ``CommDebugMode`` does), so the
            collectives it desugars into come here."""
            seconds, calls = 0.0, 0

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                if getattr(func, "namespace", "") not in ("_c10d_functional",
                                                          "c10d"):
                    return func(*args, **(kwargs or {}))
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = func(*args, **(kwargs or {}))
                torch.cuda.synchronize()
                self.seconds += time.perf_counter() - t
                # a collective; not its wait or its autograd wrapper
                self.calls += not str(func).split(".")[1].startswith(
                    ("wait", "_"))
                return out

        clock = CollectiveClock()

        def run(state, on_mesh):
            step = make_train_step(model, tcfg)
            out = []
            for batch in batches:
                before = _k3_launches()
                comm_s, calls = clock.seconds, clock.calls
                t0 = time.perf_counter()
                if on_mesh:
                    with use_mesh(mesh), clock:
                        state, m = step(state, distribute(
                            batch, batch_sharding(batch, mesh)))
                else:
                    state, m = step(state, {k: v[order]
                                            for k, v in batch.items()})
                torch.cuda.synchronize()
                made = {k: v - before[k] for k, v in _k3_launches().items()}
                out.append({"loss": float(m["loss"]),
                            "s": time.perf_counter() - t0,
                            "collective_s": clock.seconds - comm_s,
                            "collective_calls": clock.calls - calls,
                            "launches": made})
            return state, out

        with Fp32Compute():
            state, plain = run(init_train_state(model, SEED, tcfg), False)
            want_params = [p.detach().clone() for p in
                           tree_flatten(state.params)]
            del state
            _free()
            # every param whole on both ranks (plain data parallelism):
            # params_sharding's FSDP split over "data" needs all_gather,
            # which gloo does not take on CUDA tensors
            init = init_train_state(model, SEED, tcfg)
            params = distribute(init.params, tree_map(
                lambda _: NamedSharding(mesh, ()), init.params))
            del init
            comm = CommDebugMode()
            moe.gmm = counted
            try:
                with comm:
                    state, sharded = run(
                        TrainState(params, adamw_init(params), None), True)
            finally:
                moe.gmm = gmm
            torch.cuda.synchronize()
        kinds = {str(k): v for k, v in comm.get_comm_counts().items()}
        loss_gap = max(abs(b["loss"] - a["loss"]) / abs(a["loss"])
                       for a, b in zip(plain, sharded))
        param_gap = max(float((b.full_tensor() - a).abs().max()
                              / a.abs().max().clamp_min(1e-30))
                        for a, b in zip(want_params,
                                        tree_flatten(state.params)))
        del state, params, want_params
        _free()
        k3_step = 9 * n_moe * SHARD_DP_MICRO
        want = {"moe_gmm": k3_step, "moe_gmm_wgrad": 3 * n_moe
                * SHARD_DP_MICRO}
        row = {"rank": rank, "world": world,
               "mesh": f"(data {world}, model 1)", "layers": cfg.n_layers,
               "steps": sharded, "unsharded": plain, "loss_gap": loss_gap,
               "param_gap": param_gap, "k3_rows": sorted(set(rows)),
               "k3_forward_calls": len(rows), "k3_rows_want": want_rows,
               "collectives": kinds, "launches_want": want}
        for i, (a, b) in enumerate(zip(plain, sharded)):
            print(f"shard (c) rank {rank}/{world} step {i}: loss "
                  f"{b['loss']:.6f} vs unsharded {a['loss']:.6f}; launches "
                  f"{b['launches']} (want {want}); host s {b['s']:.3f} "
                  f"({b['collective_s']:.3f} s in {b['collective_calls']} "
                  f"collectives) vs {a['s']:.3f}", flush=True)
        print(f"shard (c) rank {rank}/{world}: mesh {row['mesh']}, granite "
              f"at {cfg.n_layers} of 24 layers, {SHARD_DP_BATCH}x"
              f"{SHARD_DP_SEQ} tokens in {SHARD_DP_MICRO} microbatches; "
              f"worst loss gap {loss_gap:.2e}, params after step "
              f"{SHARD_STEPS} {param_gap:.2e} of each leaf's largest (tol "
              f"{SHARD_TRAIN_TOL:g}); rows into K3 a forward call "
              f"{row['k3_rows']} over {len(rows)} calls (want {want_rows}: "
              f"{per_rank} padded row of {SHARD_DP_SEQ} tokens x top-"
              f"{cfg.moe.top_k}); collectives {kinds}", flush=True)
        (workdir / f"rank{rank}.json").write_text(json.dumps(row))
    finally:
        dist.destroy_process_group()
    ok = (loss_gap <= SHARD_TRAIN_TOL and param_gap <= SHARD_TRAIN_TOL
          and set(rows) == {want_rows}
          and all(st["launches"] == want for st in sharded)
          and kinds and all("all_reduce" in k for k in kinds))
    if not ok:
        print(f"shard (c) rank {rank}: failed gates", flush=True)
        return 1
    return 0


def shard_phase(device):
    """Phase 17: granite-moe-1b-a400m at full width on DTensor meshes
    (``repro_torch.sharding``).  (a) one rank, a (data 1, model 1) ``cuda``
    mesh over a one-rank gloo group in this process: a 4 x 128 forward in
    fp32 and bf16 against the unsharded params, 3 training steps against 3
    unsharded ones, an unsharded checkpoint restored onto the mesh.  (b)
    two gloo ranks on the card, a (data 1, model 2) mesh."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint.checkpointer import tree_map

    t0 = time.perf_counter()
    rows = []
    store = Path(tempfile.mkdtemp(prefix="chip_smoke_pg_")) / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        model = _granite(device, "sort")
        tokens = _shard_tokens(model.cfg).to(device)
        params = model.init(seed=SEED)
        with Fp32Compute():
            _shard_forward(model, params, mesh, tokens, "fp32",
                           SHARD_TOL_FP32, rows)
        params = tree_map(lambda t: t.to(torch.bfloat16), params)
        _shard_forward(model, params, mesh, tokens, "bf16", SHARD_TOL_BF16,
                       rows)
        del params
        _free()
        _shard_train(model, mesh, rows)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store.parent, ignore_errors=True)
    log(f"phase 17(a) took {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    workdir = OUT_DIR / "shard"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    try:
        ranks = _shard_ranks(workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log(f"phase 17(b) took {time.perf_counter() - t1:.1f} s")
    t2 = time.perf_counter()
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    try:
        dp_ranks = _shard_ranks(workdir, part="c")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log(f"phase 17(c) took {time.perf_counter() - t2:.1f} s")
    seconds = time.perf_counter() - t0
    log(f"phase 17 (shard) took {seconds:.1f} s")
    # the launches of (a)'s sharded runs (rank 0 of its own group) and of
    # (c)'s sharded runs on both ranks
    steps = [st["launches"] for r in rows if r["case"] == "train"
             for st in r["steps"]] + [st["launches"] for r in dp_ranks
                                      for st in r["steps"]]
    launches = {
        "moe_gmm": sum(r["k3"] for r in rows if "k3" in r)
        + sum(st["moe_gmm"] for st in steps),
        "moe_gmm_wgrad": sum(st["moe_gmm_wgrad"] for st in steps)}
    return {"one_rank": rows, "ranks": ranks, "dp_ranks": dp_ranks,
            "seconds": seconds, "launches": launches}


SOURCES = {
    "stream_spmm": ("src/repro_torch/csrc/stream_spmm.cu",
                    "src/repro/kernels/stream.py:330"),
    "stream_panel_spmm": ("src/repro_torch/csrc/stream_spmm.cu",
                          "src/repro/kernels/stream.py:415"),
    "moe_gmm": ("src/repro_torch/csrc/moe_gmm.cu",
                "src/repro/kernels/moe_gmm.py:31"),
    "moe_gmm_wgrad": ("src/repro_torch/csrc/moe_gmm.cu",
                      "src/repro/models/moe.py:179 (no TPU kernel: XLA's "
                      "gradient of jax.lax.ragged_dot)"),
    "attention": ("src/repro_torch/csrc/attention.cu",
                  "src/repro/models/attention.py blockwise_attention (no "
                  "TPU kernel: plain JAX)"),
}


# -- phase 19: fused attention ------------------------------------------------

#: (label, B, Sq, Sk, Hq, Hkv, Dh, mask keywords): granite's training call
#: (4 x 4,096 tokens, 16 query heads on 8 of 64, muP scale), llama-3.2-3b's
#: shape (24 on 8 of 128), a window (mixtral's form, narrower), a query
#: offset (a prefill's second chunk), seamless's cross-attention (not
#: causal, Sk != Sq), granite-34b's MQA (48 on 1 of 128) and the smoke
#: models' head dim 16
ATTN_CASES = (
    ("granite", 4, 4096, 4096, 16, 8, 64, dict(causal=True, scale=0.015625)),
    ("llama3.2-3b", 1, 4096, 4096, 24, 8, 128, dict(causal=True)),
    ("window", 2, 2048, 2048, 16, 8, 64, dict(causal=True, window=512)),
    ("q_offset", 2, 1000, 3048, 16, 8, 128,
     dict(causal=True, q_offset=2048)),
    ("cross", 2, 1000, 1500, 16, 16, 64, dict(causal=False)),
    ("mqa", 1, 1024, 1024, 48, 1, 128, dict(causal=True)),
    ("dh16", 2, 300, 300, 4, 2, 16, dict(causal=True)),
)
#: The kernel against the plain loop on the same bf16 values (widened to
#: fp32, the plain loop's own arithmetic), row by row (``attn_gaps``).  A
#: row is one query row of one head (O, dQ) or one key of one kv head (dK,
#: dV), held to its own largest entry plus ATTN_FLOOR of the tensor's
#: largest: a late causal row (|O| ~ 1/sqrt(its keys)) is not judged by row
#: 0's scale, and a row whose exact value is 0 (dQ of a query that sees one
#: key) reads its fp32 noise against the floor.  Limits:
#: - ``o32.row``, the forward's fp32 O before its bf16 rounding: the split
#:   keeps ~16 bits of P (the kernel reads 7e-6-1.7e-5 on the H100); P
#:   rounded to bf16, its lo half dropped, reads 3.5e-3-4.5e-3;
#: - ``<output>.row`` of O, dQ, dK and dV in bf16: each side rounds once,
#:   2**-8 of the entry; a skipped key or query tile reads 0.07-4.9;
#: - ``<output>.miss``, the share of entries other than the plain value's
#:   own bf16 rounding, among those above ATTN_FLOOR of the tensor's
#:   largest (an exact 0 read as fp32 noise is no miss): 1e-3-5e-3 where
#:   the kernel is within ~2**-16 of the plain value, rising for dK and dV
#:   with the rows a key sums (the tensor cores' fp32 sums; MQA's 48 x
#:   1,024 rows read 0.02); 0.37-0.43 for a kernel that drops a lo half of
#:   P or dS, which the bf16 outputs' row readings cannot see.
ATTN_OUTPUTS = ("out", "dq", "dk", "dv")
ATTN_LIMITS = {"o32.row": 2.0 ** -12,
               **{f"{n}.row": 2.0 ** -7 for n in ATTN_OUTPUTS},
               **{f"{n}.miss": 2.0 ** -3.5 for n in ATTN_OUTPUTS}}
ATTN_FLOOR = 2.0 ** -12
ATTN_SEED = SEED + 19


def _attn_calls():
    from repro_torch.kernels import attention as kattn
    from repro_torch.models import attention as tattn

    return {"attention_forward": kattn.fused_attention.forward_calls,
            "attention_backward": kattn.fused_attention.backward_calls,
            "attention_launches": kattn.fused_attention.launches,
            "attention_plain_cuda":
                tattn.blockwise_attention.plain_cuda_calls}


def _reset_attn_counters():
    from repro_torch.kernels import attention as kattn
    from repro_torch.models import attention as tattn

    kattn.fused_attention.forward_calls = 0
    kattn.fused_attention.backward_calls = 0
    kattn.fused_attention.launches = 0
    tattn.blockwise_attention.plain_cuda_calls = 0


def attn_gaps(got, want, o32):
    """The readings that ATTN_LIMITS bound: the kernel's (O, dQ, dK, dV)
    in bf16 ``got`` and its forward's fp32 O ``o32`` against the plain
    loop's fp32 ``want``, all (B, S, H, Dh)."""
    import torch

    def row(g, w):
        err = (g.float() - w).abs().amax(-1)
        mag = w.abs()
        return float((err / (mag.amax(-1) + ATTN_FLOOR * mag.max())).max())

    with torch.no_grad():
        gaps = {"o32.row": row(o32, want[0])}
        for name, g, w in zip(ATTN_OUTPUTS, got, want):
            gaps[f"{name}.row"] = row(g, w)
            above = w.abs() > ATTN_FLOOR * w.abs().max()
            gaps[f"{name}.miss"] = float(
                (g != w.to(torch.bfloat16))[above].float().mean())
    return gaps


def attn_over(gaps):
    """The readings of ``gaps`` over their limits (a NaN is over)."""
    return {n: x for n, x in gaps.items() if not x <= ATTN_LIMITS[n]}


def _attn_layers(cfg) -> int:
    return sum(cfg.mixer_for_layer(i) in ("attn", "swa")
               for i in range(cfg.n_layers))


def _attn_inputs(device, b, sq, sk, hq, hkv, dh, seed):
    import torch

    g = torch.Generator(device=device).manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, generator=g, device=device).to(
            torch.bfloat16)

    return (draw(b, sq, hq, dh), draw(b, sk, hkv, dh), draw(b, sk, hkv, dh),
            draw(b, sq, hq, dh))


def _attn_work(b, sq, sk, hq, hkv, dh, kw):
    """(forward, backward) operations and bytes the algorithm needs: 4 and
    10 operations per visible (query, key) pair and head dim (QK^T and PV;
    the backward's S again, dP, dV, dK, dQ); q, k, v and O (bf16) and the
    log-sum-exp once each, and dO, dQ, dK, dV in the backward."""
    from repro_torch.kernels import attention as kattn

    pairs = int(kattn.visible(sq, sk, kw.get("causal", True),
                              kw.get("window"), kw.get("q_offset", 0)).sum())
    pairs *= b * hq
    qo = 2 * b * sq * hq * dh
    kv = 2 * 2 * b * sk * hkv * dh
    lse = 4 * b * hq * sq
    return ((4 * pairs * dh, qo * 2 + kv + lse),
            (10 * pairs * dh, qo * 4 + kv * 2 + lse))


def _bound_of(ops, nbytes):
    t_ops = ops / BF16_FLOP_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _attn_case(device, case, timed):
    """One case: the kernel's output and gradients, and its forward's fp32
    O, against the plain loop on the same bf16 values within ATTN_LIMITS,
    every output bit-identical on a second run; where ``timed``, the
    kernel's forward and backward against their bound, the plain loop and
    SDPA (the ``library_ms`` yardstick, never on the port's paths)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import attention as kattn
    from repro_torch.models import attention as tattn

    label, b, sq, sk, hq, hkv, dh, kw = case
    q, k, v, do = _attn_inputs(device, b, sq, sk, hq, hkv, dh, ATTN_SEED)
    scale = kw.get("scale", 1 / dh ** 0.5)
    causal, window = kw.get("causal", True), kw.get("window")
    q_offset = kw.get("q_offset", 0)
    args = (causal, window, q_offset, scale)
    runs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = tattn.blockwise_attention(*leaves, **kw)
        runs.append((out, *torch.autograd.grad(out, leaves, do)))
        del leaves, out
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(*runs))
    _, o32, lse = kattn._forward(q, k, v, *args, keep=True)
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    plain = tattn.blockwise_attention(*leaves, **kw)
    want = (plain.detach(), *torch.autograd.grad(plain, leaves, do.float()))
    del leaves, plain
    gaps = attn_gaps(runs[0], want, o32)
    over = attn_over(gaps)
    del want, runs
    row = {"case": label, "shape": [b, sq, sk, hq, hkv, dh],
           "mask": {n: kw[n] for n in kw if n != "scale"},
           "gaps": gaps, "bit_identical": same}
    log(f"attn {label}: (B, Sq, Sk, Hq, Hkv, Dh) = {(b, sq, sk, hq, hkv, dh)}"
        f" {row['mask']}; against the plain loop "
        + " ".join(f"{n} {e:.2e}" for n, e in gaps.items())
        + f" (limits o32.row {ATTN_LIMITS['o32.row']:.2e}, row "
        f"{ATTN_LIMITS['out.row']:.2e}, miss {ATTN_LIMITS['out.miss']:.2e})"
        f"; two runs bit-identical: {same}")
    if not same or over:
        raise SystemExit(f"attn {label}: over the limits {over}, "
                         f"bit-identical {same}")
    if not timed:
        return row
    fwd_ms, how = _device_ms(lambda: kattn._forward(q, k, v, *args,
                                                    keep=True))
    bwd_ms, _ = _device_ms(lambda: kattn._backward(q, k, v, o32, lse, do,
                                                   *args))
    (f_ops, f_bytes), (b_ops, b_bytes) = _attn_work(b, sq, sk, hq, hkv, dh,
                                                    kw)
    f_bound, f_side = _bound_of(f_ops, f_bytes)
    b_bound, b_side = _bound_of(b_ops, b_bytes)
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    do32 = do.float()

    def plain_fwd():
        return tattn.blockwise_attention(*leaves, **kw)

    def plain_both():
        return torch.autograd.grad(plain_fwd(), leaves, do32)

    # CUDA events (host gaps included): the backward's kernels are
    # launched from autograd's thread, outside the profiler's range
    plain_f = _events_ms(plain_fwd, reps=5)
    plain_fb = _events_ms(plain_both, reps=5)
    del leaves
    _free()
    lib_f = lib_fb = None
    if q_offset == 0 and window is None and (sq == sk or not causal):
        lq, lk, lv = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        ldo = do.transpose(1, 2)

        def lib_fwd():
            return F.scaled_dot_product_attention(
                lq, lk, lv, is_causal=causal, scale=scale,
                enable_gqa=hq != hkv)

        def lib_both():
            return torch.autograd.grad(lib_fwd(), (lq, lk, lv), ldo)

        try:
            lib_f = _events_ms(lib_fwd)
            lib_fb = _events_ms(lib_both)
        except RuntimeError as e:
            log(f"library attn {label}: SDPA refused: "
                f"{str(e).splitlines()[0][:160]}")
            lib_f = lib_fb = None
    row.update({
        "forward_ms": fwd_ms, "backward_ms": bwd_ms, "timer": how,
        "forward_bound_ms": f_bound, "forward_bound_by": f_side,
        "backward_bound_ms": b_bound, "backward_bound_by": b_side,
        "forward_tflops": f_ops / fwd_ms / 1e9,
        "backward_tflops": b_ops / bwd_ms / 1e9,
        "plain_forward_ms": plain_f, "plain_backward_ms": plain_fb - plain_f,
        "library_forward_ms": lib_f,
        "library_backward_ms": None if lib_f is None else lib_fb - lib_f,
        "operations": f_ops + b_ops, "bytes": f_bytes + b_bytes,
        # how much of the summed bound each side sets, in ms
        "bound_operations_ms": (f_bound if f_side == "operations" else 0.0)
        + (b_bound if b_side == "operations" else 0.0),
        "bound_bytes_ms": (f_bound if f_side == "bytes" else 0.0)
        + (b_bound if b_side == "bytes" else 0.0)})
    log(f"time attn {label}: forward {fwd_ms:.4f} ms (bound {f_bound:.4f}, "
        f"{f_side}; {f_ops / fwd_ms / 1e9:.1f} TFLOP/s), backward "
        f"{bwd_ms:.4f} ms (bound {b_bound:.4f}, {b_side}; "
        f"{b_ops / bwd_ms / 1e9:.1f} TFLOP/s) [{how}]; CUDA events: plain "
        f"forward {plain_f:.3f}, backward {plain_fb - plain_f:.3f} ms; "
        "library "
        + ("none" if lib_f is None else
           f"forward {lib_f:.4f}, backward {lib_fb - lib_f:.4f} ms"))
    return row


def attention_phase(device):
    """Phase 19: the fused attention kernel against the plain loop at the
    callers' shapes (ATTN_CASES), bit-identical twice, and timed at
    granite's and llama's shapes.  Returns (rows, the kernel-table row of
    granite's call, the worst row gap of a bf16 output); the counters
    start from 0."""
    t0 = time.perf_counter()
    _reset_attn_counters()
    rows = []
    for case in ATTN_CASES:
        rows.append(_attn_case(device, case,
                               timed=case[0] in ("granite", "llama3.2-3b")))
        _free()
    g = rows[0]
    total = {"ms": g["forward_ms"] + g["backward_ms"],
             "plain_ms": g["plain_forward_ms"] + g["plain_backward_ms"],
             "bound_ms": g["forward_bound_ms"] + g["backward_bound_ms"],
             "operations": g["bound_operations_ms"],
             "bytes": g["bound_bytes_ms"],
             "library_ms": (g["library_forward_ms"] + g["library_backward_ms"]
                            if g["library_forward_ms"] is not None
                            else None),
             "calls": 2}
    worst = max(x for r in rows for n, x in r["gaps"].items()
                if n.endswith(".row") and n != "o32.row")
    log(f"phase 19 (attention) took {time.perf_counter() - t0:.1f} s; "
        f"calls {_attn_calls()}")
    return rows, total, worst


# -- phase 18: the launch and benchmark surfaces ------------------------------

#: phase 18(c)'s CPU processes: the dry-run of granite's four cells on the
#: single-pod mesh and of its moe_sort train cell, then the roofline that
#: reads them; together they are given this long
LAUNCH_TIMEOUT_S = 600
LAUNCH_DIR = OUT_DIR / "launch"


def _launch_run(t0):
    """Phase 18(c)'s processes, on the host's CPU after (a)-(b) are done
    (no card: a fake process group of 256 ranks must not meet phase 17's
    gloo ranks, and the dry-run never touches a device): the two dry-runs
    at once, then the two rooflines."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    dry, roof = str(LAUNCH_DIR / "dryrun"), str(LAUNCH_DIR / "roofline")
    sort = ["--arch", GRANITE, "--shape", "train_4k", "--variant",
            "moe_sort"]
    stages = [
        [["-m", "repro_torch.launch.dryrun", "--arch", GRANITE, "--out",
          dry, "--jobs", "4"],
         ["-m", "repro_torch.launch.dryrun", *sort, "--out", dry]],
        [["-m", "repro_torch.launch.roofline", "--arch", GRANITE, "--out",
          roof, "--dryrun-dir", dry],
         ["-m", "repro_torch.launch.roofline", *sort, "--out", roof,
          "--dryrun-dir", dry]],
    ]
    LAUNCH_DIR.mkdir(exist_ok=True)
    i = 0
    for cmds in stages:
        procs = []
        try:
            for c in cmds:
                logf = open(LAUNCH_DIR / f"proc{i}.log", "w")
                i += 1
                procs.append((c, logf, subprocess.Popen(
                    [sys.executable, *c], cwd=ROOT, env=env, stdout=logf,
                    stderr=subprocess.STDOUT)))
            for c, logf, p in procs:
                left = LAUNCH_TIMEOUT_S - (time.perf_counter() - t0)
                rc = p.wait(timeout=max(1.0, left))
                logf.close()
                if rc:
                    tail = Path(logf.name).read_text()[-3000:]
                    raise SystemExit(f"launch (c): {' '.join(c)} exited "
                                     f"{rc}:\n{tail}")
        finally:
            for _, _, p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()


def _launch_cells(card):
    """Gate phase 18(c)'s artifacts: every cell ``ok``, and K3/K3w FLOPs
    counted in the moe_sort train cell."""
    rows = []
    for kind in ("dryrun", "roofline"):
        files = sorted((LAUNCH_DIR / kind).glob("*.json"))
        if len(files) != 5:
            raise SystemExit(f"launch (c): {len(files)} {kind} cells, want 5")
        for f in files:
            r = json.loads(f.read_text())
            if r["status"] != "ok":
                raise SystemExit(f"launch (c): {kind} {f.name} is "
                                 f"{r['status']}: {r.get('error')}")
            by_op = r.get("flops_by_op") or r["probe"]["flops_by_op"]
            flops = r["cost"]["flops"] if kind == "dryrun" \
                else r["per_chip"]["flops"]
            row = {"kind": kind, "cell": f.stem, "flops": flops,
                   "k3_flops": by_op.get("repro_torch.gmm", 0),
                   "k3w_flops": by_op.get("repro_torch.gmm_wgrad", 0),
                   "seconds": r["seconds"]}
            if kind == "dryrun":
                row["peak_bytes"] = r["memory"]["peak_bytes_per_device"]
                row["argument_bytes"] = r["memory"]["argument_bytes"]
                row["collective_bytes"] = r["collective_bytes_total"]
            else:
                row["dominant"] = r["dominant"]
                row["useful"] = r["useful_flops_ratio"]
            if "moe_sort" in f.stem and "train_4k" in f.stem and not (
                    row["k3_flops"] > 0 and row["k3w_flops"] > 0):
                raise SystemExit(f"launch (c): {kind} {f.stem} counted no "
                                 f"K3/K3w FLOPs: {by_op}")
            log(f"launch (c) {kind} {f.stem}: ok, flops/chip "
                f"{flops:.4e} (K3 {row['k3_flops']:.4e}, K3w "
                f"{row['k3w_flops']:.4e}), {r['seconds']} s on the host CPU "
                f"of the machine with {card} (counted on meta tensors, "
                f"not measured on the card)")
            rows.append(row)
    return rows


def _bench_rows(device, card):
    """Phase 18(a): every section of ``repro_torch.benchmarks.run``, the
    kernels section ``--quick`` on the card: K1/K2 must launch, and each
    apply must lie within TOL of the fp64 product (absolute, on operands
    of standard normal entries).  The kernels rows are also written to
    ``chiprun_out/BENCH_kernels_h100.json``."""
    import re

    from repro_torch.benchmarks import kernels_bench
    from repro_torch.benchmarks import run as bench_run
    from repro_torch.kernels import stream as ks

    rows, k12 = [], 0
    for name, mod in bench_run._sections():
        before = ks.stream_spmm.launches + ks.stream_panel_spmm.launches
        got = kernels_bench.run(quick=True, device=device) \
            if name == "kernels" else mod.run()
        k12 += ks.stream_spmm.launches + ks.stream_panel_spmm.launches \
            - before
        rows += got
        log(f"launch (a) bench {name}: {len(got)} rows on {card}")
    errs = [float(m.group(1)) for r in rows if r.name.startswith("kernels/")
            for m in [re.search(r"max_err=([0-9.e+-]+)", r.derived)] if m]
    worst = max(errs)
    for r in rows:
        if r.name.endswith("/plan_apply"):
            log(f"launch (a) {r.name}: {r.us_per_call:.1f} us "
                f"({r.derived}; K1/K2 launches "
                f"{r.extra['kernel_launches']}) on {card}")
    log(f"launch (a) K1/K2 launches {k12}; {len(errs)} applies, worst "
        f"|err| vs fp64 {worst:.2e} (tol {TOL:g}) on {card}")
    if k12 <= 0 or worst > TOL:
        raise SystemExit(f"launch (a): K1/K2 launches {k12}, worst error "
                         f"{worst:.2e}")
    snap = {"bench": "kernels", "quick": True,
            "device": kernels_bench._device_header(device),
            "rows": [r.json() for r in rows if r.name.startswith("kernels/")]}
    (OUT_DIR / "BENCH_kernels_h100.json").write_text(
        json.dumps(snap, indent=2))
    return [r.json() for r in rows], k12


def _example_runs(device, card):
    """Phase 18(b): the four examples on the card."""
    import math

    from repro_torch.examples import (moe_dataflows, quickstart,
                                      serve_batch, train_lm)
    from repro_torch.kernels import moe_gmm as mg
    from repro_torch.kernels import stream as ks

    out = {}
    k12 = ks.stream_spmm.launches + ks.stream_panel_spmm.launches
    q = quickstart.main(["--device", "cuda"])
    k12 = ks.stream_spmm.launches + ks.stream_panel_spmm.launches - k12
    log(f"launch (b) quickstart: worst |err| {q['worst_err']:.2e}, K1/K2 "
        f"launches {q['kernel_launches']} in its six-dataflow pass "
        f"({k12} in the whole script) on {card}")
    if q["kernel_launches"] <= 0:
        raise SystemExit("launch (b): quickstart launched no K1/K2")
    out["quickstart"] = q
    k3 = mg.gmm.launches
    moe = moe_dataflows.main(["--device", "cuda"])
    k3 = mg.gmm.launches - k3
    for r in moe:
        log(f"launch (b) moe_dataflows T={r['tokens']}: ms "
            + " ".join(f"{s}={v:.3f}" for s, v in r["ms"].items())
            + f"; sort vs scatter {r['rel_err']['sort']:.2e} (tol "
            f"{LOGIT_TOL}); K3 per sort call {r['k3_per_call']:g} on {card}")
        if r["k3_per_call"] != 3 or r["rel_err"]["sort"] > LOGIT_TOL:
            raise SystemExit(f"launch (b): moe_dataflows {r}")
    out["moe_dataflows"] = moe
    served = serve_batch.main(["--device", "cuda"])
    if len(served) != 10:
        raise SystemExit(f"launch (b): serve_batch served {len(served)}")
    first, second = train_lm.main(["--device", "cuda", "--steps", "20"])
    losses = [r["loss"] for r in first + second]
    if not all(math.isfinite(x) for x in losses) or second[0]["step"] != 10:
        raise SystemExit(f"launch (b): train_lm {losses}, resumed at "
                         f"{second[0]['step']}")
    log(f"launch (b) serve_batch: {len(served)} requests; train_lm: losses "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, resumed at step "
        f"{second[0]['step']} on {card}")
    out["train_lm"] = {"losses": losses, "resumed_at": second[0]["step"]}
    return out, k12, k3


def launch_phase(device, card):
    """Phase 18: the benchmarks, the examples, and granite's dry-run and
    roofline cells.  Returns its rows and the K1/K2 and K3 launches of
    (a) and (b)."""
    t0 = time.perf_counter()
    bench, k12_bench = _bench_rows(device, card)
    examples, k12_ex, k3 = _example_runs(device, card)
    t1 = time.perf_counter()
    log(f"launch (a)-(b) done in {t1 - t0:.1f} s on {card}")
    _launch_run(t1)
    cells = _launch_cells(card)
    log(f"launch (c) done in {time.perf_counter() - t1:.1f} s, on the "
        f"host's CPU after (a)-(b) (machine of {card})")
    return ({"bench": bench, "examples": examples, "cells": cells},
            {"stream_kernels": k12_bench + k12_ex, "moe_gmm": k3})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to measure",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails where the repo is absent)
    from repro_torch.kernels import moe_gmm as mg
    from repro_torch.kernels import stream as ks

    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products in fp32
    torch.backends.cudnn.allow_tf32 = False
    args = sys.argv[1:]
    if "--dist-rank" in args:
        # one rank of phase 13(b), started by dist_phase
        i = args.index("--dist-rank")
        device = torch.device("cuda:0")
        torch.cuda.set_device(device)
        return dist_rank(int(args[i + 1]), int(args[i + 2]), args[i + 3],
                         device)
    if "--shard-rank" in args or "--shard-dp-rank" in args:
        # one rank of phase 17(b) or 17(c), started by shard_phase
        flag = "--shard-rank" if "--shard-rank" in args else "--shard-dp-rank"
        i = args.index(flag)
        device = torch.device("cuda:0")
        torch.cuda.set_device(device)
        fn = shard_rank if flag == "--shard-rank" else shard_dp_rank
        return fn(int(args[i + 1]), int(args[i + 2]), args[i + 3], device)

    OUT_DIR.mkdir(exist_ok=True)
    _LOG.append(open(OUT_DIR / "chip_smoke.log", "w"))

    device = torch.device("cuda:0")
    torch.cuda.set_device(device)
    t_start = time.perf_counter()

    card = build_kernels()
    if "--sweeps" in sys.argv[1:]:
        # phases 1, 7 and 2 alone: the kernels against their plain
        # versions, K3 first; no main path, no result lines
        gmm_sweep(device)
        kernel_sweep(device)
        log(f"sweeps done in {time.perf_counter() - t_start:.1f} s on "
            f"{card}")
        return 0
    if "--stream" in sys.argv[1:]:
        # phases 1-4, 6 and 6b: K1/K2 on the main path, timed, and read
        # in place
        kernel_sweep(device)
        calls = []
        table6(device, calls)
        replay_ffn(qwen2_ffn(device), calls)
        totals, _ = time_main_path(calls, {"stream_spmm": 0.0,
                                           "stream_panel_spmm": 0.0})
        log(f"stream: replayed launches ms {json.dumps(totals)}")
        in_place = in_place_gate(device, calls)
        (OUT_DIR / "chip_smoke_stream.json").write_text(json.dumps(
            {"card": card, "totals": totals, "in_place": in_place},
            indent=1))
        log(f"stream done in {time.perf_counter() - t_start:.1f} s on "
            f"{card}")
        return 0
    if "--serve" in sys.argv[1:]:
        # phases 1 and 8 alone: the decode step's host-clock latency
        serve_granite(device)
        log(f"serve done in {time.perf_counter() - t_start:.1f} s on {card}")
        return 0
    if "--dist" in sys.argv[1:]:
        # phases 1 and 13 alone: sharded plans, serial and collective
        dist_phase(device)
        log(f"dist done in {time.perf_counter() - t_start:.1f} s on {card}")
        return 0
    if "--models" in sys.argv[1:]:
        # phases 1 and 15 alone: jamba, rwkv6 and seamless on the card
        models, _, _ = models_phase(device, 0.0)
        (OUT_DIR / "chip_smoke_models.json").write_text(json.dumps(
            {"card": card, "models": models}, indent=1, default=str))
        log(f"models done in {time.perf_counter() - t_start:.1f} s on "
            f"{card}")
        return 0
    if "--grad" in sys.argv[1:]:
        # phases 1 and 16(a) alone: K3w and K3's backward on the card
        grad_sweep(device)
        log(f"grad done in {time.perf_counter() - t_start:.1f} s on {card}")
        return 0
    if "--train" in sys.argv[1:]:
        # phases 1 and 16 alone: K3's gradient and granite training
        train, _, _, _, _ = train_phase(device)
        (OUT_DIR / "chip_smoke_train.json").write_text(json.dumps(
            {"card": card, "train": train}, indent=1, default=str))
        log(f"train done in {time.perf_counter() - t_start:.1f} s on {card}")
        return 0
    if "--shard" in sys.argv[1:]:
        # phases 1 and 17 alone: granite on DTensor meshes
        shard = shard_phase(device)
        (OUT_DIR / "chip_smoke_shard.json").write_text(json.dumps(
            {"card": card, "shard": shard}, indent=1, default=str))
        log(f"shard done in {time.perf_counter() - t_start:.1f} s on {card}")
        return 0
    if "--launch" in sys.argv[1:]:
        # phases 1 and 18 alone: benchmarks, examples, dry-run, roofline
        launch, _ = launch_phase(device, card)
        (OUT_DIR / "chip_smoke_launch.json").write_text(json.dumps(
            {"card": card, "launch": launch}, indent=1, default=str))
        log(f"launch done in {time.perf_counter() - t_start:.1f} s on "
            f"{card}")
        return 0
    if "--attn" in sys.argv[1:]:
        # phases 1 and 19 alone: the fused attention kernel
        rows, _, _ = attention_phase(device)
        (OUT_DIR / "chip_smoke_attn.json").write_text(json.dumps(
            {"card": card, "attention": rows}, indent=1, default=str))
        log(f"attn done in {time.perf_counter() - t_start:.1f} s on {card}")
        return 0
    if "--analysis" in sys.argv[1:]:
        # phases 1 and 14 alone: verification, traces, learned, TuneDB
        analysis_phase(device)
        log(f"analysis done in {time.perf_counter() - t_start:.1f} s on "
            f"{card}")
        return 0
    worst = kernel_sweep(device)

    calls = []
    ks.stream_spmm.launches = 0
    ks.stream_panel_spmm.launches = 0
    operands = table6(device, calls)
    ffn_runs = qwen2_ffn(device)
    torch.cuda.synchronize()
    launches = {"stream_spmm": ks.stream_spmm.launches,
                "stream_panel_spmm": ks.stream_panel_spmm.launches}
    log(f"main-path kernel launches: {launches}")
    if min(launches.values()) <= 0:
        raise SystemExit(f"a kernel of the main path never launched: "
                         f"{launches}")

    replay_ffn(ffn_runs, calls)
    totals, per_call = time_main_path(calls, worst)
    log(f"times above sum over the {sum(t['calls'] for t in totals.values())}"
        f" distinct kernel calls of one main-path pass (each the median of "
        f"{REPS} calls), on {card}; "
        f"bound = sum over calls of max(bytes at {HBM_BYTES_PER_S:g} B/s, "
        f"fp32 operations at {FP32_FLOP_PER_S:g}/s), bound_by = the side "
        "that sets most of it; library = torch.matmul on the densified "
        "inputs")
    in_place = in_place_gate(device, calls)
    log(f"phases 1-6 done at {time.perf_counter() - t_start:.1f} s")

    worst["moe_gmm"] = gmm_sweep(device)
    ks.stream_spmm.launches = 0
    ks.stream_panel_spmm.launches = 0
    mg.gmm.launches = 0
    model, params, prompts, engine = serve_granite(device)
    torch.cuda.synchronize()
    serving = {"moe_gmm": mg.gmm.launches,
               "stream_spmm": ks.stream_spmm.launches,
               "stream_panel_spmm": ks.stream_panel_spmm.launches}
    stats = engine.stats
    want = 3 * model.cfg.n_layers * (stats["prefills"]
                                     + stats["decode_steps"])
    log(f"serving-path kernel launches: {serving}; K3 want 3 x "
        f"{model.cfg.n_layers} x ({stats['prefills']} prefills + "
        f"{stats['decode_steps']} decode steps) = {want}")
    if serving["moe_gmm"] <= 0 or serving["moe_gmm"] != want:
        raise SystemExit(f"serving path: K3 launched {serving['moe_gmm']} "
                         f"times, want {want}")
    launches["moe_gmm"] = serving["moe_gmm"]
    totals["moe_gmm"], worst["moe_gmm"] = time_k3(
        path_check(model, params, prompts)[0], worst["moe_gmm"])
    del model, params, prompts, engine
    log(f"phases 7-9 done at {time.perf_counter() - t_start:.1f} s")

    tiled = tiled_phase(device, operands)
    policy = policy_phase(device, operands, per_call)
    pipeline = pipeline_phase(device)
    log(f"phases 10-12 done at {time.perf_counter() - t_start:.1f} s")
    dist = dist_phase(device)
    log(f"phase 13 done at {time.perf_counter() - t_start:.1f} s")
    analysis, tune = analysis_phase(device)
    log(f"phase 14 done at {time.perf_counter() - t_start:.1f} s")
    models, jamba_launches, worst["moe_gmm"] = models_phase(
        device, worst["moe_gmm"])
    launches["moe_gmm"] += jamba_launches
    log(f"phase 15 done at {time.perf_counter() - t_start:.1f} s; K3 "
        f"launches on the serving paths: granite {serving['moe_gmm']} + "
        f"{JAMBA} {jamba_launches} = {launches['moe_gmm']}")
    train, train_launches, totals["moe_gmm_wgrad"], \
        worst["moe_gmm_wgrad"], worst_dx = train_phase(device)
    worst["moe_gmm"] = max(worst["moe_gmm"], worst_dx)
    launches["moe_gmm"] += train_launches["moe_gmm"]
    launches["moe_gmm_wgrad"] = train_launches["moe_gmm_wgrad"]
    log(f"phase 16 done at {time.perf_counter() - t_start:.1f} s; K3 "
        f"launches of the training run {train_launches['moe_gmm']} (total "
        f"{launches['moe_gmm']}), K3w {launches['moe_gmm_wgrad']}")
    shard = shard_phase(device)
    for name, n in shard["launches"].items():
        launches[name] += n
    log(f"phase 17 done at {time.perf_counter() - t_start:.1f} s; its "
        f"sharded runs launched {shard['launches']} (totals K3 "
        f"{launches['moe_gmm']}, K3w {launches['moe_gmm_wgrad']})")

    ks.stream_spmm.launches = ks.stream_panel_spmm.launches = 0
    launch, launch_launches = launch_phase(device, card)
    launch_k1 = ks.stream_spmm.launches
    launch_k2 = ks.stream_panel_spmm.launches
    launches["stream_spmm"] += launch_k1
    launches["stream_panel_spmm"] += launch_k2
    launches["moe_gmm"] += launch_launches["moe_gmm"]
    if min(launch_k1, launch_k2, launch_launches["moe_gmm"]) <= 0:
        raise SystemExit(f"phase 18: K1 {launch_k1}, K2 {launch_k2}, K3 "
                         f"{launch_launches['moe_gmm']} launches")
    log(f"phase 18 done at {time.perf_counter() - t_start:.1f} s; K1 "
        f"{launch_k1}, K2 {launch_k2}, K3 {launch_launches['moe_gmm']} "
        f"launches (totals {launches})")
    attention, totals["attention"], worst["attention"] = \
        attention_phase(device)
    calls = _attn_calls()
    launches["attention"] = (train_launches["attention"]
                             + calls["attention_launches"])
    log(f"phase 19 done at {time.perf_counter() - t_start:.1f} s; "
        f"attention kernel launches: phase 16(b)'s run "
        f"{train_launches['attention']} + phase 19 "
        f"{calls['attention_launches']} = {launches['attention']}")

    kernels = []
    for name, t in totals.items():
        src, replaces = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": worst[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": "bytes" if t["bytes"] >= t["operations"]
            else "operations",
            "library_ms": t["library_ms"], "calls_timed": t["calls"],
        })
    log(f"moe_gmm: bound = sum over its calls of max(bytes at "
        f"{HBM_BYTES_PER_S:g} B/s, bf16 operations at {BF16_FLOP_PER_S:g}/s)"
        f"; library = torch._grouped_mm on the real rows; on {card}")
    log("moe_gmm_wgrad: the first MoE layer's three calls of one training "
        "step, replayed; bound and library as moe_gmm's (library: "
        "torch._grouped_mm's 2-D x 2-D form, none where it is missing or "
        "refuses the operands)")
    log("attention: granite's training call, forward and backward; its "
        "max_abs_err is the worst row gap of a bf16 output (ATTN_LIMITS); "
        "library = SDPA, never on the port's paths")
    log(f"chip_smoke wall time {time.perf_counter() - t_start:.1f} s")
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "kernels": kernels, "in_place": in_place,
         "tiled": tiled, "policy": policy,
         "pipeline": pipeline, "dist": dist, "analysis": analysis,
         "tune": tune, "models": models, "train": train, "shard": shard,
         "launch": launch, "attention": attention},
        indent=1,
        default=str))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
