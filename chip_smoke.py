#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root, with one card and no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each kernel against its plain PyTorch version on the card, and
drives at full width every path of the port: the dense, blockwise, raw
and landmark paths of ``one_shot_clustering`` (paper Algorithm 2),
membership serving, LM serving and the prefills of every model kind
(dense, hybrid, MoE, early-fusion VLM, encoder-decoder), then the MT-HFL
trainer (paper Algorithm 1), the IFCA baseline, the hierarchical
two-level protocol and the sharded paths:

  [3]  dense, on pre-featurised users: N=1024 x n=256 x d=512, T=4,
       top_k=8;
  [3b] blockwise (``block_users=128``) on the same users;
  [3c] raw data: the paper's CIFAR two-task layout, N=1024 users x
       n=252 rows x m=3072 pixels, T=2, through a shared random
       projection to d=512 (the paper's CIFAR feature width), streamed
       in 128-row chunks, with the top-k subspace iteration;
  [3d] the landmark (Nystrom) sketch on phase 3's users: every user
       scored against 128 landmark projectors by the assign wave kernel;
  [3e] membership serving: ``launch.membership.run_cell`` seeds a
       directory from 1024 users, then serves six waves of 128 arrivals
       with churn and task drift, re-clustering when drift trips;
  [3f] cluster-routed LM serving: ``ServeEngine`` on RWKV-6 1.6B at full
       width and depth (bf16, the wkv kernel on every prefill chunk), 16
       requests from 4 token tasks routed by ``route_requests`` over a
       ``MembershipEngine``, and one traced wave: the device's busy share
       (the union of kernel intervals over their span, ``busy_share``),
       the trace's kernel events required to cover the host's launches;
       then, at full width and 2 layers in fp32, its tokens against
       per-request ``greedy_decode``;
  [3g] dense prefill: Qwen3-1.7B at full width and depth (bf16, the flash
       kernel), ``forward(last_only=True)`` on 2 x 4096 tokens;
  [3h] hybrid prefill: RecurrentGemma-9B at full width and depth (bf16,
       the flash kernel with its 2048 window and the linear scan), on
       1 x 4096 tokens;
  [3m] MoE prefill: Phi-3.5-MoE at full width (16 experts, top-2), 4 of
       its 32 layers (bf16, the flash kernel), 2 x 4096 tokens; the
       dropped share of picks and, layer by layer, the picks that differ
       from the fp32 path; then 2 layers in fp32 with drop-free capacity,
       16 decode steps against the teacher-forced forward (the reference's
       bar, atol 5e-3 + rtol 1e-3);
  [3n] early-fusion VLM prefill: Llama-4-Scout at full width (16 experts,
       top-1, patch projection), 2 of its 48 layers, 1 x 4096 tokens of
       which 1024 random positions take patch embeddings;
  [3o] encoder-decoder: SeamlessM4T-v2 whole (24 + 24 layers), forward on
       frames (2, 1024, 1024) and tokens (2, 512), the flash kernel on the
       encoder's, the decoder's and the cross attention (512 x 1024,
       bidirectional); then in fp32 ``encode``,
       ``decode_state_from_memory`` and 16 decode steps against the
       teacher-forced forward, at the reference's bar;
  [3i] MT-HFL: ``train_mthfl`` on phase 3c's users and on-card labels,
       the paper CNN at CONFIG width with the Fig. 2 settings: (a) 32
       users a task over 2 rounds on the card and on the CPU, per-round
       train losses within 1e-4 x max(1, |loss|) and accuracies within one
       eval sample, or 4x the card's own spread where that is larger
       (the card run again from initial weights moved by one ulp), the
       first round's losses within 1e-4 alone, and a control run with
       TF32 allowed in the trainer's scope must miss that first-round bar;
       (b) every user with 10-class heads, the fused path against the
       loop on the card, to the same bar, and one traced fused round;
       (c) the paper's
       comparison over 5 rounds, the one-shot labels against random ones
       of the same cluster sizes: every loss finite and the one-shot
       run's mean loss falling are required, the accuracies reported;
  [3j] IFCA: ``run_ifca`` on 64 users a task, 3 rounds, 10-class global
       labels, on the card and on the CPU from the same initial models:
       assignments equal every round, final parameters within the larger
       of 1e-4 x max|param| and 4x the card's own spread; then timed
       with every user walked one by one, the reference's shape, beside
       the vmapped run.  The trainer and IFCA reach no hand-written kernel:
       their convolutions and products are library calls in IEEE fp32;
  [3k] the hierarchical protocol (``hierarchy_cfg``) on phase 3's users
       in 8 edge groups of 128, 4 clusters cut a group: accuracy 100%,
       agreement with phase 3's flat labels >= 0.95 after
       ``greedy_match_labels``, one ``gram``, ``eigproject`` and group
       NN-chain launch for the batch of groups plus the global chain, the
       stage ms; a small input against the CPU plain path;
  [3k(b)] the same at 10^5 users x 8 samples, d = 16, 500 groups in
       batches of 100 (the reference's scale point, where the flat R
       would be 37.3 GiB): ARI 1.0 against the tasks, wall and memory;
  [3l] the sharded paths over a ``torch.distributed`` NCCL group of one
       rank (NCCL takes one rank a card): the dense protocol on phase 3's
       users and the raw ingest on phase 3c's, R within 1e-5 of those
       phases' (and whether the bits are equal) and the same labels,
       their launches; ``assign_sharded`` on phase 3e's directory and
       last wave against ``assign`` in fp32 (labels equal, affinity
       within 1e-5); ``train_mthfl(backend="shard_map")`` on 3i(b)'s
       layout, losses within 1e-5 x max(1, |loss|) of the fused path and
       the same accuracies.  A failure to start NCCL fails the run;
  [3p] telemetry (``repro_torch.obs``) on the card: (a) the dense
       protocol at full width with 256 users (the batched ``eigh`` of 256
       Grams) with telemetry off, on and off again: R and the labels
       bit-equal, nothing recorded while off, the span tree
       ``oneshot.run`` > ``protocol.run`` > ``protocol.dispatch`` plus
       ``cluster.hac`` and ``cluster.cut``, ``kernel_calls`` and
       ``dispatch_count`` equal to the run's launches by tuning family,
       no ``retrace_count`` (no kernel build), and the dispatch span at
       least as long as the same call by CUDA events (the span
       synchronises); (b) phase 3e's serving cell with events on: the
       events by kind, ``assign_latency_us`` counting every wave, the
       same accuracies and re-cluster waves as phase 3e; (c) the
       overheads beside the reference's contract (<= 5% on, <= 0.5%
       off), reported only; (d) ``launch.obs profile`` over
       ``launch.membership --quick`` in a process of its own: every span
       name in the exported trace (its kernel events counted only).

Each path runs with the kernel launch counts set to 0 just before it
and read just after.  Phase [4] times each kernel beside its plain
version, one library call and its bound.  Its device times are CUDA
events around calls queued behind a spin kernel (``device_ms``), and it
requires every device time at or above its bound and every rate at most
1.05x the memory's peak.  The prefills (3g, 3h, 3m, 3n, 3o) hold the
kernel path's last-position logits to at most twice the bf16 plain
path's distance from an fp32 plain forward.  bf16 attention and bf16
assignment run on the tensor cores (``flash_attention_tc.cu``,
``assign_wave_tc.cu``); phases [2] and [4] also hold the flash kernel
with its output left in fp32 to 1e-5 of the fp32 function, at every head
dim the models use (16, 32, 64, 128, 256; phase [4] times hd 32 at the
REDUCED granite shape, both kernels, and holds and times the kernel at
phase 3o's three hd-64 shapes: the encoder's and the cross attention's,
bidirectional, the latter 512 x 1024, and the decoder's causal self
attention), and phase [1] prints every
kernel's registers and spills.  ``featurize_gram`` and
``gram_project`` run their fp32 products as 3xTF32 on the tensor cores:
phases [2] and [4] hold each to 1e-5 x max|plain| and to at most 1/8 of
the error of the plain 1xTF32 emulation (``kernels/tf32.py``) on the
same inputs, and phase [4] runs each twice and requires the same bits
(``featurize_gram`` in bf16 too, timed beside its fp32 entry).  ``gram``
runs one triangle of 128 x 128 tile pairs as 3xTF32 on ``wgmma``: phase
[2] holds it on both load routes (TMA, (64, 256, 512); 4-byte cp.async,
(8, 37, 130)) and phase [4] at the dense shape to 1e-5 x max|plain| and
1/8 of the 1xTF32 emulation's error, requires the output symmetric bit
for bit and two runs bit-equal, prints the block count (users x tile
pairs), and phase [2] holds its ``n_valid`` divisor to the division after
the kernel, bit for bit.  ``assign_one`` (bf16 on ``mma.sync``, split
over arrival groups x slices of P) is held to its plain version in
phase [2] also at (16, 3, 1024, 64), where V is staged in chunks of d;
phase [4] requires two runs bit-equal at the serving shape and
prints its device time and the library call's beside the wrapper-level
event times, as for ``assign_wave`` at its two
serving shapes.  ``eigproject`` runs 3xTF32 on ``wgmma`` with the stacked
signature matrix split once: phases [2] (both load routes of G, random
G that is not symmetric, NV k off the column slab) and [4] (the dense
shape) hold it to 1e-5 x max|plain| and 1/8 of the 1xTF32 emulation's
error, require two runs bit-equal and its split equal to the plain
layout, and phase [4] prints its device time.  ``wkv_chunked`` computes
the chunk form on the tensor cores: phase [2] holds fp32 compute to
1e-5 x max of the sequential oracle and of the plain chunk form, and
bf16 compute to 2^-8 x max of the plain chunk form with the same bf16
roundings (its gap to the fp32 oracle at most twice the plain chunk
form's), S from 1 to 200 and strong decays; phase [4] times both
compute dtypes at the serving chunk, with device times, and holds bf16
compute on 8 input draws (the phase's own and 7 from a generator of
their own, each printed): within 2^-8 of the plain chunk form, out and
state, and its gap to the fp32 oracle within twice the plain chunk
form's (the plain chunk form itself misses 2^-8 x max on one draw).  ``nn_chain``
caches every live row's nearest neighbour: phase [2] holds its merges,
heights and step count to the plain loop bit for bit and its counters
(iterations, rows rescanned) to the plain model of the cache on random,
1/8-grid and NaN R for all three linkages, and runs 20,000 leaves (the
per-leaf state in device scratch) to every merge and the blocks of R;
phase [4] prints its device time, iterations and us an iteration at the
dense cell's R.  Phase [4] also times the group-axis forms at phase 3k's
group shape (``eigproject_grouped``, ``linkage_grouped``), each held to 8
single calls and its plain version.  ``linear_scan`` streams through a TMA ring (4-byte
cp.async where TMA cannot read): phase [2] holds it bit for bit on both
routes, a misaligned view, B = 3 and S off the stage, two runs alike;
phase [4] prints its route, device time and GB/s.  Phase [5] times ``torch.linalg.eigh`` on 64 of the
dense cell's Grams under cuSOLVER, MAGMA and the host's LAPACK, each
compared with the default backend's and an fp64 spectrum and
projectors: it measures and reports, and requires no agreement.  Every
phase must pass; the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

preceded by a JSON line of what each path measured (walls, peak memory,
the serving cell's per-wave numbers, the LM phases' tokens/s, time to
first token and logit gaps, the trainer's and IFCA's times, gaps and
accuracies, each phase's seconds), the card's
name and power limit, and a ``{"kernels": [...]}`` line.  Without a CUDA device, or outside the repository, it exits
non-zero and prints no result.  It imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

# Main-path cell: the paper's CIFAR-10 feature width (pooled ResNet18).
N_USERS, N_SAMPLES, DIM, TASKS, TOP_K, SEED = 1024, 256, 512, 4, 8, 0
# Blockwise path: users per tile.
BLOCK_USERS = 128
# Raw path: the paper's CIFAR two-task layout (Fig. 2) at 512 users per
# task, raw 32x32x3 pixels, projected to d=512, streamed in row chunks.
RAW_USERS_PER_TASK, RAW_ROWS_PER_USER, RAW_CHUNK_ROWS = 512, 256, 128
# Landmark path: landmark projectors (128 x 512 x 512 f32 = 128 MiB).
LANDMARKS = 128
# Hierarchical path (phase 3k): phase 3's users in 8 edge groups of 128,
# 4 clusters cut a group.  At scale (3k(b)): the reference's N = 10^5
# point (benchmarks/bench_scale.py:56-58, HIER_PLAN), where the flat R
# alone would be 37.3 GiB.
HIER_GROUPS, HIER_GROUP_CLUSTERS = 8, 4
SCALE_USERS, SCALE_SAMPLES, SCALE_DIM = 100_000, 8, 16
SCALE_GROUPS, SCALE_BATCH = 500, 100
# Serving cell: launch.membership arguments, directory f32, bf16 compute.
SERVING_ARGS = ["--seed-users", "1024", "--samples", "256", "--dim", "512",
                "--tasks", "4", "--top-k", "8", "--waves", "6",
                "--wave-size", "128", "--evict", "32", "--scenario", "drift",
                "--drift-after", "3", "--unassigned-frac", "0.05",
                "--backend", "torch", "--device", "cuda"]
# The JAX reference on this exact cell (CPU, fp32 scoring): unassigned
# fraction after each wave, and the waves that re-clustered.
REF_SERVING_UNASSIGNED = {3: 0.044, 4: 0.081, 5: 0.039}
REF_SERVING_RECLUSTER_WAVES = [4]

# LM serving cell (phase 3f): ServeEngine shapes, and the token tasks the
# requests come from.  The served traffic is a named choice: sharper
# tasks (logit scale 8, where TokenTaskSpec defaults to 3) over 512
# tokens, signed with 8-token windows (route_requests defaults to 16),
# so that routing can be required to recover every task.  The phase
# also reports, and does not require, the routing accuracy of the same
# prompt lengths under the defaults (DEFAULT_TASK, DEFAULT_SIG).
LM_SERVE = dict(slots=8, wave=4, prefill_chunk=64, max_prompt=256,
                max_gen=32, max_len=288)
LM_REQUESTS, LM_TASKS, LM_SEED_STREAMS = 16, 4, 8
TOKEN_TASK = dict(vocab=512, logit_scale=8.0)
SIG = dict(d=32, k=2, window=8, vocab=512)
DEFAULT_TASK = dict(vocab=512)
DEFAULT_SIG = dict(vocab=512)
# Prefill cells (phases 3g, 3h): batch x sequence.
DENSE_PREFILL, HYBRID_PREFILL = (2, 4096), (1, 4096)
# The rest of the zoo (phases 3m-3o) at published widths: batch x sequence
# and the depth one 80 GB card holds (phi3_5_moe: 4 of 32 layers, 10.9 GB
# of bf16 weights; llama4_scout: 2 of 48, 12.5 GB); seamless_m4t_v2 whole,
# batch x frames and batch x tokens.
MOE_PREFILL, MOE_LAYERS = (2, 4096), 4
FUSION_PREFILL, FUSION_LAYERS = (1, 4096), 2
ENCDEC_FRAMES, ENCDEC_TOKENS = (2, 1024), (2, 512)
# Decode against the teacher-forced forward (3m at 2 layers, 3o whole,
# fp32), at the reference's bar for that check (tests/test_arch_smoke.py).
ZOO_DECODE_STEPS, ZOO_DECODE_LAYERS = 16, 2
DECODE_ATOL, DECODE_RTOL = 5e-3, 1e-3
# flash at head dim 32 (the REDUCED granite_8b, deepseek_67b,
# chameleon_34b and llama4_scout configs): timed at the dense prefill's
# batch and sequence with the REDUCED granite's 8 heads.
HD32_HEADS = 8
# MT-HFL cell (phase 3i): the paper's Fig. 2 settings
# (benchmarks/bench_fig2_cifar.py): 5 global rounds of 1 local round of 12
# momentum steps, batch 32, lr 0.01; evaluation sets of 50 samples a class
# (benchmarks/common.py::make_eval_spec).  3i(a) holds the card to the CPU
# on 32 users a task over 2 rounds; 3i(b) the fused path to the loop on
# every user over 2 rounds.
TRAIN_ROUNDS, TRAIN_CHECK_ROUNDS, TRAIN_CHECK_USERS = 5, 2, 32
TRAIN_EVAL_PER_CLASS, TRAIN_EVAL_SEED = 50, 999
# Card against CPU (3i(a), 3j) and fused against loop (3i(b)).  The
# floors: per-round train losses within TRAIN_LOSS_TOL x max(1, |loss|),
# accuracies within one eval sample, IFCA's final parameters within
# IFCA_PARAM_TOL x max|param|.  Both sides run IEEE fp32 on the same
# batches, but their sums run in other orders, and training through ReLUs
# and max-pools is chaotic at the last bit: a sample whose ReLU or pooling
# winner flips moves a weight by about lr / batch.  One part in 10^7 on
# the inputs moved IFCA's final parameters by 2.5e-3 x max|param| (a CPU
# run against itself on 32 of these users), and on an H100 the 3i(a)
# losses landed 1.557e-4 from the CPU's, two eval samples apart.  So each
# comparison also measures that spread on the card: the
# same run again from initial weights moved by one ulp (x (1 + 1e-7 r),
# r standard normal), NUDGE_RUNS times, and its bar is the larger of the
# floor and SPREAD_FACTOR times the largest gap a nudge made.
TRAIN_LOSS_TOL, IFCA_PARAM_TOL = 1e-4, 1e-4
NUDGE, NUDGE_RUNS, SPREAD_FACTOR = 1e-7, 2, 4.0
# IFCA cell (phase 3j): 64 users a task, 3 rounds, global 10-class labels.
IFCA_USERS, IFCA_ROUNDS = 64, 3
# Sharded paths (phase 3l): ranks of the NCCL group.  NCCL takes one rank
# a card, so on one card the group has one rank.
SHARD_WORLD = 1

# Short spin kernels that open a profiler session (phase 3f): a session in
# a process minutes old lost up to its first 9 kernel events on an H100.
GUARD_SPINS = 64

# Published H100 SXM peaks (NVIDIA data sheet, 700 W): fp32 outside the
# tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# bf16 dense tensor-core peak, for the assign kernels' bf16 products.
PEAK_BF16_FLOPS = 989e12
# TF32 dense tensor-core peak (H100 SXM data sheet), for the fp32
# products that featurize_gram and gram_project run as 3xTF32.
PEAK_TF32_FLOPS = 495e12
# Users a chunk of the plain 1xTF32 emulations (bounds their temporaries).
EMULATION_USERS = 64
# Grams of the dense cell that phase 5 hands to each eigh backend.
EIGH_GRAMS = 64
# bf16 assign kernels against their bf16 plain versions, x max|plain|.
# Both round the same bf16 operands (the wave kernel and its plain
# version form each s_ij with the same IEEE operations), so only fp32
# summation order separates them: on an H100, up to 1.1e-6 on phase 2's
# random inputs and 6.0e-6 at the landmark shape (a d = 512 affinity
# sums 262,144 terms), so the limit is about 3x the larger.  Skipping
# the bf16 rounding moves the result by 2e-3 to 4e-3 at d = 512, and
# phase 2 requires that gap to exceed 10x the limit.
ASSIGN_BF16_TOL = 2e-5
# wkv_chunked under bf16 compute against the fp32 oracle (phase 4): input
# draws at the serving prefill's shape, the first the phase's own, the
# rest from a generator of their own.
WKV_DRAWS, WKV_DRAW_SEED = 8, SEED + 1
# Telemetry (phase 3p): the dense protocol at full width with fewer users
# (the batched eigh of OBS_USERS Grams), and the assign path's overhead
# timed as the reference's benchmarks/bench_obs.py does (strictly
# alternating off/on calls, median of each, best of the trials; the
# disabled call bundle timed alone).
OBS_USERS = 256
OBS_PAIRS, OBS_TRIALS, OBS_BUNDLE_CALLS = 30, 2, 20_000
OBS_PIECE_CALLS = 200


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """Least time for the work on the card: the larger of operations over
    the fp32 peak and bytes over the memory rate."""
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def assign_bound_ms(ops_fp32: float, ops_product: float, compute_dtype: str,
                    nbytes: float) -> tuple[float, str, float]:
    """Bound of an assign kernel, each operation at the peak of its type:
    ``ops_fp32`` have fp32 inputs and sums (the fp32 cores), the
    ``ops_product`` run at the compute dtype's rate (bf16 tensor cores
    under bf16).  The two units run side by side, so the larger counts.
    Returns ``(bound_ms, bound_by, bound_fp32_ms)``, the last with every
    operation on the fp32 cores, as the fp32 kernels run them."""
    peak = PEAK_BF16_FLOPS if compute_dtype == "bf16" else PEAK_FP32_FLOPS
    t_ops = max(ops_fp32 / PEAK_FP32_FLOPS, ops_product / peak) * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_fp32 = max((ops_fp32 + ops_product) / PEAK_FP32_FLOPS * 1e3, t_bytes)
    if t_ops >= t_bytes:
        return t_ops, "operations", t_fp32
    return t_bytes, "bytes", t_fp32


def split_bound_ms(flops: float, nbytes: float) -> tuple[float, str, float]:
    """Bound of a kernel that runs its fp32 products as 3xTF32: three TF32
    products per fp32 product at the TF32 tensor-core peak, against the
    bytes moved once.  Returns ``(bound_ms, bound_by, bound_fp32_ms)``, the
    last with the products on the fp32 cores (``bound_ms``'s figure)."""
    t_ops = 3 * flops / PEAK_TF32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    b32, _ = bound_ms(flops, nbytes)
    if t_ops >= t_bytes:
        return t_ops, "operations", b32
    return t_bytes, "bytes", b32


def flash_bound_ms(bh: int, hd: int, pairs: int, nbytes: float
                   ) -> tuple[float, str, float]:
    """Bound of flash attention over ``pairs`` visible (query, key) pairs
    per head, as the tensor-core kernel computes it: q.k once and p.v
    twice (p's bf16 hi and lo parts), all at the bf16 tensor-core rate,
    against Q, K, V and O moved once.  Returns ``(bound_ms, bound_by,
    bound_fp32_pv_ms)``, the last with p.v at the fp32 rate, as the
    CUDA-core kernel (and the reference) compute it."""
    ops = 2.0 * bh * hd * pairs
    t_ops = 3 * ops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_fp32_pv = max(ops / PEAK_FP32_FLOPS * 1e3, t_bytes)
    if t_ops >= t_bytes:
        return t_ops, "operations", t_fp32_pv
    return t_bytes, "bytes", t_fp32_pv


def ptxas_report(log: str) -> list[dict]:
    """Registers and spills of each kernel from ``nvcc -Xptxas -v``'s
    output in ``build.log``: ``[{file, function, registers,
    spill_stores, spill_loads}]``, function names demangled where
    ``c++filt`` is on the path."""
    import re
    import shutil

    rows, source, fn, spills = [], None, None, (0, 0)
    for line in log.splitlines():
        if line.startswith("== "):
            source = line.split()[1]
        elif m := re.search(r"Compiling entry function '([^']+)'", line):
            fn = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", line):
            spills = (int(m.group(1)), int(m.group(2)))
        elif (m := re.search(r"Used (\d+) registers", line)) and fn:
            rows.append(dict(file=source, function=fn,
                             registers=int(m.group(1)),
                             spill_stores=spills[0], spill_loads=spills[1]))
            fn, spills = None, (0, 0)
    if rows and shutil.which("c++filt"):
        names = subprocess.run(
            ["c++filt"], input="\n".join(r["function"] for r in rows),
            capture_output=True, text=True, timeout=60).stdout.splitlines()
        if len(names) == len(rows):
            for r, name in zip(rows, names):
                r["function"] = name
    return rows


def visible_pairs(s: int, window: int) -> int:
    """(query, key) pairs a causal mask (with a window, if set) leaves."""
    if not window:
        return s * (s + 1) // 2
    w = min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def token_requests(np, sample_tokens, TokenTaskSpec, task=TOKEN_TASK):
    """The LM serving cell's traffic: seed streams per task (for the
    membership directory) and 16 requests, task ``i % 4``, prompts of
    64-256 tokens, 8-32 generated, half arriving at round 0 and half
    staggered over rounds 1-7; ``task`` sets the ``TokenTaskSpec``.
    Returns (seed streams, their tasks, prompts, gens, arrival rounds,
    request tasks)."""
    specs = [TokenTaskSpec(seed=t, **task) for t in range(LM_TASKS)]
    seeds, seed_tasks = [], []
    for t, spec in enumerate(specs):
        for j in range(LM_SEED_STREAMS):
            seeds.append(sample_tokens(spec, 600, seed=(1, t, j)))
            seed_tasks.append(t)
    rng = np.random.default_rng(SEED)
    prompts, gens, arrive, tasks = [], [], [], []
    for i in range(LM_REQUESTS):
        t = i % LM_TASKS
        prompts.append(sample_tokens(specs[t], int(rng.integers(64, 257)),
                                     seed=(2, i)))
        gens.append(int(rng.integers(8, 33)))
        arrive.append(0 if i < LM_REQUESTS // 2 else int(rng.integers(1, 8)))
        tasks.append(t)
    return seeds, seed_tasks, prompts, gens, arrive, tasks


def nudged(torch, params: dict, seed: int) -> dict:
    """``params`` moved by about one ulp: each weight times ``1 + NUDGE
    r``, ``r`` standard normal from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    return {k: v * (1 + NUDGE * torch.randn(v.shape, generator=gen))
            for k, v in params.items()}


def time_ms(torch, fn, reps: int, setup=None) -> float:
    """Mean device time of ``fn`` over ``reps`` launches, after a warm-up,
    by CUDA events.  ``setup`` (untimed) runs before each launch."""
    if setup is not None:
        setup()
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        if setup is not None:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def memory_line(torch, live_before: int) -> tuple[int, str]:
    """Peak device memory since the last reset, and the text that puts it
    beside what was already live when the path started."""
    peak = torch.cuda.max_memory_allocated()
    return peak, (f"peak device memory {peak / 2**30:.2f} GiB, "
                  f"{(peak - live_before) / 2**30:.2f} GiB above the "
                  f"{live_before / 2**30:.2f} GiB live before the call")


def max_err(torch, a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def check_close(torch, name, out, ref, tol) -> float:
    """``max|out - ref| <= tol * max|ref|``; returns the max abs error."""
    err = max_err(torch, out, ref)
    scale = float(ref.abs().max())
    print(f"  {name}: max_abs_err {err:.3e} (max|plain| {scale:.3e}, "
          f"tolerance {tol:g} x max|plain|)")
    require(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
    require(err <= tol * scale, f"{name}: kernel disagrees with plain")
    return err


def check_split(torch, name, out, ref, emulated, tol=1e-5
                ) -> tuple[float, float]:
    """A 3xTF32 kernel's ``out`` against the plain fp32 function ``ref``:
    within ``tol x max|ref|`` and at most 1/8 of the error of the plain
    1xTF32 emulation (``hi hi`` alone) on the same inputs, so a split
    whose lo products went missing fails here.  Returns both errors."""
    err = max_err(torch, out, ref)
    err_1x = max_err(torch, emulated, ref)
    scale = float(ref.abs().max())
    print(f"  {name}: live split: kernel max_abs_err {err:.3e} "
          f"({err / scale:.3e} x max|plain|), 1xTF32 emulation {err_1x:.3e} "
          f"({err_1x / scale:.3e}); ratio {err_1x / max(err, 1e-30):.1f} "
          f"(required >= 8), tolerance {tol:g} x max|plain|")
    require(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
    require(err <= tol * scale, f"{name}: kernel disagrees with plain")
    require(8 * err <= err_1x, f"{name}: kernel error {err:.3e} is not 8x "
            f"below the 1xTF32 emulation's {err_1x:.3e}")
    return err, err_1x


def featurize_1xtf32(torch, x, w):
    """``(x w)^T (x w)`` with both products as one TF32 product (``hi hi``
    of ``kernels/tf32.py``), in chunks of users."""
    from repro_torch.kernels.tf32 import matmul_1xtf32

    out = []
    for s in range(0, x.shape[0], EMULATION_USERS):
        f = matmul_1xtf32(x[s:s + EMULATION_USERS], w)
        out.append(matmul_1xtf32(f.transpose(1, 2), f))
    return torch.cat(out)


def gram_1xtf32(torch, x):
    """``x^T x`` as one TF32 product (``hi hi``), in chunks of users."""
    from repro_torch.kernels.tf32 import matmul_1xtf32

    return torch.cat([matmul_1xtf32(xs.transpose(1, 2), xs)
                      for xs in x.split(EMULATION_USERS)])


def spin_cycles(torch, seconds: float) -> int:
    """Cycles of ``torch.cuda._sleep`` that hold the stream for about
    ``seconds``, from one timed spin (measured once a process)."""
    if "rate" not in _SPIN:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10 ** 7)
        end.record()
        torch.cuda.synchronize()
        _SPIN["rate"] = 10 ** 7 / (start.elapsed_time(end) / 1e3)
    return int(min(seconds, 5.0) * _SPIN["rate"]) + 1


_SPIN: dict = {}


def device_ms(torch, fn, calls: int = 20) -> tuple[float, str]:
    """Device time of one call of ``fn`` on the card's own clock: a spin
    kernel holds the stream while the host enqueues ``calls`` calls
    between two CUDA events, so the events time the calls back to back on
    the device, without the host's gaps (the device's gaps between
    launches stay in).  ``torch.profiler`` is not used: on an H100, in a
    process that had run for minutes, its sessions dropped their first
    kernel events, so a sum over them read low.  If the spin runs out before the host has enqueued every call,
    it spins four times longer, up to three times; then the host's gaps
    are in, and ``how`` says so."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = spin_cycles(torch, 2 * host_s + 1e-3)
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        queued = not start.query()
        torch.cuda.synchronize()
        if queued:
            return (start.elapsed_time(end) / calls,
                    f"events behind a spin kernel, {calls} calls")
        cycles *= 4
    return (start.elapsed_time(end) / calls,
            f"events, {calls} calls, the host's gaps included")


def busy_share(spans: list) -> tuple[float, float]:
    """The share of the span of ``spans`` (``(start, end)`` pairs, us)
    that their union covers, and that span in seconds."""
    spans = sorted(spans)
    union, reach = 0.0, spans[0][0]
    for start, end in spans:
        union += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    return union / (reach - spans[0][0]), (reach - spans[0][0]) / 1e6


def check_physical(kernels: list) -> None:
    """No device time of the kernels line below its bound, and no rate
    above 1.05x the memory's peak: a profiler that under-counts would show
    both."""
    def walk(entry, where):
        if isinstance(entry, dict):
            bound = entry.get("bound_ms")
            for key in ("device_ms", "library_device_ms"):
                if bound is not None and entry.get(key) is not None:
                    require(entry[key] >= bound,
                            f"{where}: {key} {entry[key]:.4f} is below its "
                            f"bound {bound:.4f} ms")
            if entry.get("gb_per_s") is not None:
                require(entry["gb_per_s"] <= 1.05 * PEAK_BYTES_PER_S / 1e9,
                        f"{where}: {entry['gb_per_s']:.0f} GB/s exceeds "
                        f"the memory's {PEAK_BYTES_PER_S / 1e9:.0f}")
            for k, v in entry.items():
                walk(v, f"{where}.{k}")
        elif isinstance(entry, list):
            for v in entry:
                walk(v, where)

    for kern in kernels:
        walk(kern, kern["name"])


#: The NN-chain loop's phases, as a REPRO_NN_CHAIN_CLOCKS build of
#: ``csrc/linkage.cu`` marks them (thread 0's cycles; a barrier's phase is
#: the wait there for the slowest warp).
CHAIN_PHASES = ("extension", "merge head", "barrier before the pass",
                "row pass", "row argmax", "barrier after the pass",
                "partials and writes", "rescans (warp 0)",
                "barrier after the rescans")


def chain_probe_libs() -> dict:
    """``csrc/linkage.cu`` compiled alone into ``build/chain_probes`` once
    for each probe of its header, in parallel: ``{"scratch": lib,
    "clocks": lib}``."""
    import ctypes

    from repro_torch.kernels import build

    out = build.BUILD_DIR.parent / "chain_probes"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, define in (("scratch", "REPRO_NN_CHAIN_SCRATCH"),
                         ("clocks", "REPRO_NN_CHAIN_CLOCKS")):
        path = out / f"{name}.so"
        procs[name] = path, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, f"-D{define}", "-I",
             str(build.CSRC), "-shared", "-o", str(path),
             str(build.CSRC / "linkage.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, (path, proc) in procs.items():
        log, _ = proc.communicate()
        require(proc.returncode == 0,
                f"the {name} probe build of linkage.cu failed:\n{log}")
        libs[name] = ctypes.CDLL(str(path))
        libs[name].repro_nn_chain.argtypes = \
            build._SIGNATURES["repro_nn_chain"]
    libs["clocks"].repro_nn_chain_clocks.argtypes = (ctypes.c_void_p,)
    return libs


def probe_chain(torch, lib, s):
    """``nn_chain``'s launch (average linkage) through a probe build:
    ``(merge_rows, heights, counters)``."""
    from repro_torch.kernels import build, dispatch
    from repro_torch.kernels.linkage import chain_plan
    from repro_torch.kernels.linkage.ref import max_iterations

    n = s.shape[0]
    merges = torch.zeros((n - 1, 2), dtype=torch.int32, device=s.device)
    heights = torch.zeros((n - 1,), dtype=torch.float32, device=s.device)
    counters = torch.zeros((3,), dtype=torch.int32, device=s.device)
    scratch = torch.empty((chain_plan(n).scratch,), dtype=torch.uint8,
                          device=s.device)
    build.check(lib.repro_nn_chain(
        s.data_ptr(), 1, n, 0, max_iterations(n), merges.data_ptr(),
        heights.data_ptr(), counters.data_ptr(), scratch.data_ptr(),
        dispatch.stream_of(s)), "nn_chain (probe build)")
    return merges, heights, counters


def gram_project_1xtf32(torch, x, v, n_valid=None):
    """``||x^T (x v)|| / max(n_valid, 1)`` with both products as one TF32
    product, in chunks of users."""
    from repro_torch.kernels.tf32 import matmul_1xtf32

    out = torch.empty((x.shape[0], v.shape[1]), device=x.device)
    step = max(1, EMULATION_USERS // 4)
    for s in range(0, x.shape[0], step):
        xs = x[s:s + step]
        q = matmul_1xtf32(xs.transpose(1, 2), matmul_1xtf32(xs, v))
        out[s:s + step] = torch.linalg.vector_norm(q, dim=1)
    nv = x.shape[1] if n_valid is None else n_valid
    nv = torch.clamp_min(torch.as_tensor(nv, dtype=torch.float32,
                                         device=x.device), 1.0)
    return out / nv[..., None]


def eigh_backends(torch, grams, sim, scale: int) -> dict:
    """Time ``torch.linalg.eigh`` (through ``sim.spectrum``) on ``grams``
    under cuSOLVER, MAGMA and the host's LAPACK (copies counted), one
    warm-up then one synchronised pass each, and compare each backend's
    top-k ``lam`` and projectors ``V V^T`` with the default backend's and
    with an fp64 spectrum of the same Grams.  A backend is eligible for
    the dense path where it meets tests/test_torch_similarity.py's
    tolerances (1e-5 x max lam, 1e-4) against fp64.  Measurement only:
    ``core/similarity.py::spectrum`` keeps the default backend, and a
    backend this build does not offer, or one that is not eligible, is
    reported as such while the run goes on (on an H100 the default
    backend's own lam lie 1.65e-4 x max lam from fp64)."""
    linalg = torch.backends.cuda.preferred_linalg_library
    before = linalg()
    lam0, v0 = sim.spectrum(grams, TOP_K)
    proj0 = v0 @ v0.transpose(1, 2)
    lam64, v64 = sim.spectrum(grams.double(), TOP_K)
    proj64 = v64 @ v64.transpose(1, 2)
    full = torch.linalg.eigvalsh(grams.double())
    gap = float((full[:, -TOP_K] - full[:, -TOP_K - 1]).min())
    scale_lam = float(lam64.max())

    def gaps(lam, v):
        proj = v.double() @ v.double().transpose(1, 2)
        return (max_err(torch, lam, lam0) / scale_lam,
                max_err(torch, proj, proj0),
                max_err(torch, lam, lam64) / scale_lam,
                max_err(torch, proj, proj64))

    d_lam, d_proj = gaps(lam0, v0)[2:]
    print(f"  default backend ({before}) against fp64: lam within "
          f"{d_lam:.3e} x max lam, projectors within {d_proj:.3e} "
          f"(tolerances 1e-5, 1e-4: "
          f"{'met' if d_lam <= 1e-5 and d_proj <= 1e-4 else 'NOT met'}); "
          f"smallest gap below the top {TOP_K} eigenvalues {gap:.3e}, max "
          f"lam {scale_lam:.3e}")
    offered = {"cusolver": True, "magma": bool(torch.cuda.has_magma),
               "host": True}
    out = {"default_vs_fp64": dict(lam_rel_gap=d_lam, projector_gap=d_proj,
                                   min_eigen_gap=gap)}
    for name, ok in offered.items():
        if not ok:
            print(f"  {name}: not offered by this torch build")
            out[name] = None
            continue

        def run():
            if name == "host":
                lam, v = sim.spectrum(grams.cpu(), TOP_K)
                return lam.to(grams.device), v.to(grams.device)
            return sim.spectrum(grams, TOP_K)
        try:
            if name != "host":
                linalg(name)
            run()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lam, v = run()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            linalg(before)
        lam_gap, proj_gap, lam_64, proj_64 = gaps(lam, v)
        eligible = lam_64 <= 1e-5 and proj_64 <= 1e-4
        per = ms / grams.shape[0]
        print(f"  {name}: {per:.3f} ms a matrix ({ms:.1f} ms for "
              f"{grams.shape[0]}; x{scale} for the cell's "
              f"{grams.shape[0] * scale}: {ms * scale:.1f} ms); against the "
              f"default lam {lam_gap:.3e} x max lam, projectors "
              f"{proj_gap:.3e}; against fp64 lam {lam_64:.3e}, projectors "
              f"{proj_64:.3e} (tolerances 1e-5, 1e-4): "
              f"{'eligible' if eligible else 'NOT eligible'}")
        out[name] = dict(ms_per_matrix=per, ms=ms, ms_cell=ms * scale,
                         lam_rel_gap=lam_gap, projector_gap=proj_gap,
                         lam_rel_gap_fp64=lam_64, projector_gap_fp64=proj_64,
                         eligible=eligible)
    return out


def check_assign(torch, name, got, want, k, compute_dtype, quiet=False
                 ) -> tuple[float, float, float]:
    """An assign kernel's ``(aff / k, labels, margin / k)`` against its
    plain version's RAW outputs.  Affinities within tol x max|plain|,
    finite margins within 2 tol x max|plain| (best and second each move
    by at most the affinity error), dead prototypes, NaN and inf margins
    in the same places, labels equal (bf16: wherever the plain margin
    exceeds the tolerance).  Returns ``(max|err| / max|plain|`` of the
    affinities, of the margins, and the affinities' max abs error in
    the wrapper's units, divided by k)."""
    aff, labels, margin = got[0] * k, got[1], got[2] * k
    p_aff, p_labels, p_margin = want
    require(torch.equal(torch.isinf(aff), torch.isinf(p_aff)),
            f"{name}: dead prototypes differ")
    fin = torch.isfinite(p_aff)
    scale = float(p_aff[fin].abs().max())
    abs_err = float((aff[fin].double() - p_aff[fin].double()).abs().max())
    err = abs_err / scale
    require(torch.equal(torch.isnan(margin), torch.isnan(p_margin))
            and torch.equal(torch.isinf(margin), torch.isinf(p_margin)),
            f"{name}: NaN or inf margins differ from plain")
    m_fin = torch.isfinite(p_margin)
    m_err = float((margin[m_fin].double() - p_margin[m_fin].double()
                   ).abs().max()) / scale if bool(m_fin.any()) else 0.0
    tol = 1e-4 if compute_dtype == "fp32" else ASSIGN_BF16_TOL
    if not quiet:
        print(f"  {name}: max_abs_err / max|plain| {err:.3e}, margins "
              f"{m_err:.3e} (tolerance {tol:g}, margins {2 * tol:g})")
    require(err <= tol, f"{name}: kernel disagrees with plain ({err:.3e})")
    require(m_err <= 2 * tol,
            f"{name}: margins disagree with plain ({m_err:.3e})")
    decided = (p_margin > tol * scale) if compute_dtype == "bf16" \
        else torch.ones_like(p_labels, dtype=torch.bool)
    require(torch.equal(labels[decided], p_labels[decided]),
            f"{name}: labels differ from plain")
    return err, m_err, abs_err / k


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np

    import torch.distributed as tdist

    from repro_torch import obs
    from repro_torch.core import clustering as clu
    from repro_torch.core import distributed as mdist
    from repro_torch.core import engine as protocol_engine
    from repro_torch.core import similarity as sim
    from repro_torch.core.cluster_engine import (ClusterConfig, ClusterEngine,
                                                 cut_device,
                                                 cut_device_grouped)
    from repro_torch.core.oneshot import one_shot_clustering
    from repro_torch.core.signature_engine import (SignatureConfig,
                                                   SignatureEngine,
                                                   subspace_residual)
    from repro_torch.data.features import FeatureConfig
    from repro_torch.data.partition import (CIFAR_TASKS,
                                            paper_cifar_two_task)
    from repro_torch.data.synthetic import make_task_feature_mixture
    from repro_torch.kernels import build, dispatch
    from repro_torch.kernels.eigproject import (eig_plan, project_norms_all,
                                                project_norms_all_ref,
                                                project_norms_all_tf32,
                                                project_norms_grouped,
                                                project_norms_grouped_ref,
                                                split_w_ref)
    from repro_torch.kernels.eigproject.ops import kernel_plan as \
        eig_kernel_plan
    from repro_torch.kernels.eigproject.ops import split_w as eig_split_w
    from repro_torch.kernels.featurize_gram import (batched_featurize_gram,
                                                    featurize_gram_ref)
    from repro_torch.kernels.gram import (batched_gram_matrix, gram_plan,
                                          gram_ref)
    from repro_torch.kernels.gram_project import (batched_gram_project,
                                                  gram_project_ref)
    from repro_torch.kernels.linkage import (LINKAGES, chain_plan,
                                             linkage_step, linkage_step_ref,
                                             nn_chain, nn_chain_cached_ref,
                                             nn_chain_grouped,
                                             nn_chain_grouped_ref,
                                             nn_chain_ref)
    from repro_torch.kernels.linkage import ops as lk_ops
    from repro_torch.kernels import quant
    from repro_torch.kernels.assign import (assign, assign_looped,
                                            assign_looped_plain,
                                            assign_wave_plain)
    from repro_torch.kernels.assign import ops as assign_ops
    from repro_torch.launch import membership as launch_membership
    from repro_torch.core import hierarchy
    from repro_torch.core.engine import landmark_indices
    from repro_torch.core.hierarchy import (HierarchyConfig,
                                            greedy_match_labels)
    from repro_torch.core.membership_engine import (MembershipConfig,
                                                    MembershipEngine)
    from repro_torch.configs.base import get_arch
    from repro_torch.data.tokens import TokenTaskSpec, sample_tokens
    from repro_torch.kernels.flash_attention import (HEAD_DIMS,
                                                     flash_attention,
                                                     flash_ref)
    from repro_torch.kernels.flash_attention.ops import (
        _flash_attention_fp32_out)
    from repro_torch.kernels.recurrent_scan import (linear_scan,
                                                    linear_scan_plan,
                                                    linear_scan_ref,
                                                    wkv_chunked,
                                                    wkv_chunked_ref, wkv_ref)
    from repro_torch.kernels.recurrent_scan import ops as rs_ops
    from repro_torch.launch.decode_loop import (ClusterHeads, Request,
                                                ServeConfig, ServeEngine,
                                                cluster_logits_fn,
                                                greedy_decode,
                                                route_requests,
                                                token_signature)
    from repro_torch.models import encdec as lm_encdec
    from repro_torch.models import layers as lm_layers
    from repro_torch.models import moe as lm_moe
    from repro_torch.models import transformer as lm_T
    from repro_torch.models.registry import get_model
    from repro_torch.configs import paper_cnn
    from repro_torch.data.synthetic import CIFAR_LIKE, make_task_dataset
    from repro_torch.fed import client as fed_client
    from repro_torch.fed import ifca as fed_ifca
    from repro_torch.fed import partition as fed_part
    from repro_torch.fed.client import ClientConfig
    from repro_torch.fed.trainer import (MTHFLConfig, TaskModel,
                                         infer_cluster_classes, train_mthfl)
    from repro_torch.models import cnn

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    # The inputs of the checks that came with the rest of the LM zoo
    # (flash at hd 32, phases 3m-3o) come from a generator of their own,
    # so that every other check draws the inputs it drew before them.
    zoo_gen = torch.Generator(device="cpu").manual_seed(SEED)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    def zoo_randn(*shape):
        return torch.randn(*shape, generator=zoo_gen).to(dev)

    t_start = time.perf_counter()
    t_phase = [t_start]
    # What each path measured, printed as one JSON line at the end.
    summary = {"phase_s": {}, "paths": {}}

    def phase_done(name):
        now = time.perf_counter()
        print(f"    ({name} took {now - t_phase[0]:.1f} s)")
        summary["phase_s"][name] = now - t_phase[0]
        t_phase[0] = now

    def record(path, wall_s, live_before, **more):
        peak = torch.cuda.max_memory_allocated()
        summary["paths"][path] = dict(
            wall_s=wall_s, peak_gib=peak / 2**30,
            above_live_gib=(peak - live_before) / 2**30, **more)

    # -- Phase 1: device and build ---------------------------------------
    card = card_line()
    print(f"[1] card: {card}")
    print(f"    torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, devices "
          f"{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build.library()
    print(f"    kernel library ready in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {' '.join(build.NVCC_FLAGS)})")
    log = build.BUILD_DIR / "build.log"
    if log.is_file():
        summary["ptxas"] = ptxas_report(log.read_text())
        for r in summary["ptxas"]:
            print(f"    ptxas {r['file']}: {r['registers']} registers, "
                  f"spill stores {r['spill_stores']} B, loads "
                  f"{r['spill_loads']} B: {r['function'][:110]}")
    phase_done("phase 1")

    # -- Phase 2: each kernel against its plain version -------------------
    print("[2] kernels vs plain versions on the card")
    # gram: 3xTF32 on wgmma, one triangle of tile pairs.  Both load
    # routes (TMA where a row of X is a multiple of 16 bytes, 4-byte
    # cp.async else) held to 1e-5 and to 1/8 of the 1xTF32 emulation's
    # error, symmetric bit for bit; the divisor against the division
    # after the kernel.
    for shape in [(64, 256, 512), (8, 37, 130)]:
        x = randn(*shape)
        g = batched_gram_matrix(x)
        check_split(torch, f"gram {shape} ({gram_plan(shape[2]).route})", g,
                    gram_ref(x), gram_1xtf32(torch, x))
        require(torch.equal(g, g.mT), f"gram {shape}: not symmetric")
    x = randn(16, 300, 784)
    n_valid = torch.randint(1, 300, (16,), generator=gen).to(dev)
    x[torch.arange(300, device=dev)[None, :] >= n_valid[:, None]] = 0.0
    check_close(torch, "gram ragged (16, 300, 784)",
                sim.batched_gram(x, n_valid.float()),
                gram_ref(x) / n_valid.float()[:, None, None], 1e-5)
    nv = n_valid.float()
    nv[0] = 0.0
    g = batched_gram_matrix(x, nv)
    check_close(torch, "gram n_valid divisor (16, 300, 784)", g,
                gram_ref(x) / torch.clamp_min(nv, 1.0)[:, None, None], 1e-5)
    require(torch.equal(g, batched_gram_matrix(x)
                        / torch.clamp_min(nv, 1.0)[:, None, None]),
            "gram: the epilogue's divisor differs from the division after")
    # eigproject: 3xTF32 on wgmma with W split once.  Symmetric PSD Grams
    # with orthonormal V (the main path's inputs), then random G that is
    # not symmetric, on both load routes of G (TMA; 4-byte cp.async at d =
    # 9 and 130), NV k off the 128-column slab and NG != NV: each to 1e-5
    # x max|plain| and 1/8 of the 1xTF32 emulation's error, two runs
    # bit-equal, one launch a call, the split W^T equal to its plain
    # layout bit for bit.
    for n_g, n_v, d, k, psd in [(64, 64, 512, 8, True),
                                (33, 33, 784, 5, True),
                                (3, 4, 9, 2, False), (5, 33, 130, 5, False),
                                (6, 17, 512, 8, False)]:
        g = randn(n_g, d, d)
        v = randn(n_v, d, k)
        if psd:
            g = g @ g.transpose(1, 2) / d
            v = torch.linalg.qr(v)[0]
        before = dispatch.LAUNCHES["eigproject"]
        out = project_norms_all(g, v)
        require(dispatch.LAUNCHES["eigproject"] == before + 1,
                "eigproject: not one launch a call")
        check_split(torch, f"eigproject ({n_g}, {n_v}, {d}, {k}) "
                    f"({eig_plan(d).route}{', PSD' if psd else ''})", out,
                    project_norms_all_ref(g, v),
                    project_norms_all_tf32(g, v, 1))
        require(torch.equal(out, project_norms_all(g, v)),
                "eigproject: two runs on the same inputs differ")
        require(torch.equal(eig_split_w(v)[:, :, :d],
                            split_w_ref(v)[:, :, :d]),
                "eigproject: the split W^T differs from its plain layout")
    require(eig_kernel_plan(130) == eig_plan(130)
            and eig_kernel_plan(512) == eig_plan(512),
            "eigproject: the C side's plan differs from eig_plan")
    for linkage in LINKAGES:
        for n in (7, 1024, 3000):
            a = torch.randint(0, 4, (n,), generator=gen).float().to(dev) / 4
            b = torch.randint(0, 4, (n,), generator=gen).float().to(dev) / 4
            mask = (torch.rand(n, generator=gen) > 0.3).to(dev)
            out = linkage_step(a, b, 2.0, 3.0, mask, linkage)
            ref = linkage_step_ref(a, b, 2.0, 3.0, mask, linkage)
            require(all(torch.equal(p, q) for p, q in zip(out, ref)),
                    f"linkage_step {linkage} n={n} differs from plain")
        dead = torch.zeros(5, dtype=torch.bool, device=dev)
        _, idx, val = linkage_step(randn(5), randn(5), 1.0, 1.0, dead,
                                   linkage)
        require(int(idx) == 0 and float(val) == float("-inf"),
                "linkage_step: all-masked row must give (0, -inf)")
    print("  linkage_step: equal to plain (exact) for all three linkages, "
          "n in (7, 1024, 3000), ties and masked columns")
    # nn_chain with cached nearest neighbours: merges, heights and the
    # step count equal to the plain loop's, and its counters (iterations,
    # rows rescanned) to the plain model of the cache's, for all three
    # linkages on random R, ties on a 1/8 grid and NaN entries; past the
    # 19,370 leaves that shared memory once capped (the per-leaf state in
    # device scratch), every merge and the 4 blocks of R recovered.
    rng = np.random.default_rng(SEED)
    r = rng.uniform(size=(300, 300))
    s300 = torch.tensor((r + r.T) / 2, dtype=torch.float32, device=dev)
    r = rng.integers(0, 8, size=(300, 300)) / 8
    grid300 = torch.tensor(np.maximum(r, r.T), dtype=torch.float32,
                           device=dev)
    r = rng.uniform(size=(41, 41))
    nan41 = torch.tensor((r + r.T) / 2, dtype=torch.float32, device=dev)
    nan41[2, 7] = nan41[7, 2] = nan41[11, 30] = float("nan")
    for m in (s300, grid300, nan41):
        m.fill_diagonal_(float("-inf"))
    for name, m in (("random 300", s300), ("1/8 grid 300", grid300),
                    ("NaN 41", nan41)):
        for linkage in LINKAGES:
            m_k, h_k, c_k = lk_ops._nn_chain_counted(m.clone(), linkage)
            m_p, h_p, t_p = nn_chain_ref(m.clone(), linkage)
            model = nn_chain_cached_ref(m.cpu(), linkage)[3]
            require(int(c_k[0]) == int(t_p) and torch.equal(m_k, m_p)
                    and torch.equal(h_k, h_p),
                    f"nn_chain {name} {linkage}: differs from the plain loop")
            require(c_k.tolist()[1:] == [model["iterations"],
                                         model["rescans"]],
                    f"nn_chain {name} {linkage}: counters {c_k.tolist()} "
                    f"differ from the plain model's {model}")
            require(name.startswith("NaN") or int(t_p) == m.shape[0] - 1,
                    f"nn_chain {name} {linkage}: {int(t_p)} merges")
            if name == "random 300":
                for t in (1, 4, 300):
                    require(torch.equal(cut_device(m_k, h_k, 300, t),
                                        cut_device(m_p, h_p, 300, t)),
                            f"nn_chain {linkage}: labels differ at T={t}")
    require(all(lk_ops.kernel_chain_plan(n) == chain_plan(n)
                for n in (2, 1024, 11019, 11020, 20000)),
            "nn_chain: the C side's plan differs from chain_plan")
    print("  nn_chain (random and 1/8-grid R of 300 leaves, NaN R of 41): "
          "merges, heights and step counts equal to the plain loop (exact), "
          "iterations and rescans to the plain model of the cache, for all "
          "three linkages")
    # The group axis at phase 3k(b)'s batch shape: SCALE_BATCH groups of
    # 200 users at d = 16, where the 32-deep, 128-row TMA box is larger
    # than G.  eigproject against one single call a group (bit for bit)
    # and its plain version (1e-5 x max|plain|, 1/8 of the 1xTF32
    # emulation's error); the NN-chain against one single call a group
    # and, on two groups, the plain loop; one launch a grouped call.
    # Its own generator, so that the draws of the later checks stay as
    # they were.
    gen_s = torch.Generator(device="cpu").manual_seed(SEED + 11)
    ng_s = SCALE_USERS // SCALE_GROUPS
    g_s = torch.randn(SCALE_BATCH * ng_s, 8, SCALE_DIM,
                      generator=gen_s).to(dev)
    g_s = (g_s.transpose(1, 2) @ g_s / 8).view(SCALE_BATCH, ng_s, SCALE_DIM,
                                               SCALE_DIM)
    v_s = torch.linalg.qr(torch.randn(SCALE_BATCH, ng_s, SCALE_DIM, TOP_K,
                                      generator=gen_s).to(dev))[0]
    before = dict(dispatch.LAUNCHES)
    out_s = project_norms_grouped(g_s, v_s)
    require(dispatch.LAUNCHES["eigproject"] == before["eigproject"] + 1,
            "eigproject grouped: not one launch a call")
    require(torch.equal(out_s, torch.stack([project_norms_all(g_s[i], v_s[i])
                                            for i in range(SCALE_BATCH)])),
            "eigproject grouped differs from single calls at d = 16")
    check_split(torch, f"eigproject grouped ({SCALE_BATCH}, {ng_s}, "
                f"{SCALE_DIM}, {TOP_K})", out_s,
                project_norms_grouped_ref(g_s, v_s),
                torch.stack([project_norms_all_tf32(g_s[i], v_s[i], 1)
                             for i in range(SCALE_BATCH)]))
    r = torch.rand((SCALE_BATCH, ng_s, ng_s), generator=gen_s).to(dev)
    s_s = (r + r.transpose(1, 2)) / 2
    s_s.diagonal(dim1=1, dim2=2).fill_(float("-inf"))
    mg, hg, sg = nn_chain_grouped(s_s.clone())
    require(dispatch.LAUNCHES["linkage"] == before["linkage"] + 1,
            "nn_chain grouped: not one launch a call")
    singles_s = [nn_chain(s_s[i].clone()) for i in range(SCALE_BATCH)]
    require(all(torch.equal(mg[i], a_) and torch.equal(hg[i], b_)
                and int(sg[i]) == int(c_) == ng_s - 1
                for i, (a_, b_, c_) in enumerate(singles_s)),
            "nn_chain grouped differs from single calls")
    want = nn_chain_grouped_ref(s_s[:2].clone())
    require(all(torch.equal(a_[:2], b_) for a_, b_ in zip((mg, hg, sg), want)),
            "nn_chain grouped differs from the plain loop")
    print(f"  group axis ({SCALE_BATCH} groups of {ng_s}, d={SCALE_DIM}): "
          f"eigproject bit-equal to one single call a group, the NN-chain's "
          f"merges, heights and steps equal to single calls and the plain "
          f"loop; one launch a grouped call")
    del g_s, v_s, out_s, s_s
    n_big, blocks = 20000, 4
    lab = torch.arange(n_big, device=dev) * blocks // n_big
    big = torch.rand((n_big, n_big), generator=torch.Generator(
        device=dev).manual_seed(SEED), device=dev) * 0.1
    big = (big + big.T) / 2 + torch.where(lab[:, None] == lab[None, :], 0.8,
                                          0.1)
    big.fill_diagonal_(float("-inf"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m_k, h_k, c_k = lk_ops._nn_chain_counted(big)
    torch.cuda.synchronize()
    big_s = time.perf_counter() - t0
    del big
    big_ari = clu.adjusted_rand_index(
        cut_device(m_k, h_k, n_big, blocks).cpu().numpy(), lab.cpu().numpy())
    require(int(c_k[0]) == n_big - 1, f"nn_chain at {n_big} leaves: "
            f"{int(c_k[0])} merges")
    require(big_ari == 1.0, f"nn_chain at {n_big} leaves: the cut at "
            f"{blocks} misses the blocks (ARI {big_ari})")
    summary["phase2_nn_chain_20000"] = dict(
        route=chain_plan(n_big).route, s=big_s, iterations=int(c_k[1]),
        rescans=int(c_k[2]))
    print(f"  nn_chain ({n_big} leaves, block-structured R, "
          f"{chain_plan(n_big).route} route): {n_big - 1} merges in "
          f"{big_s:.3f} s ({int(c_k[1])} iterations, {int(c_k[2])} rows "
          f"rescanned), the {blocks} blocks recovered at T={blocks}")
    # featurize_gram: fp32 to 1e-5 x max; bf16 against the plain
    # bf16-rounding version at the reference's 2e-2 x max.  The first
    # case also holds the fp32 kernel to 1/8 of the 1xTF32 emulation's
    # error (the live-split check).
    for n_users, c, m, d in [(16, 128, 3072, 512), (16, 300, 784, 100)]:
        x = randn(n_users, c, m)
        counts = torch.randint(1, c + 1, (n_users,), generator=gen).to(dev)
        x[torch.arange(c, device=dev)[None, :] >= counts[:, None]] = 0.0
        w = randn(m, d) / d ** 0.5
        for cd, tol in (("fp32", 1e-5), ("bf16", 2e-2)):
            out = batched_featurize_gram(x, w, cd)
            name = (f"featurize_gram {cd} ragged ({n_users}, {c}, {m}) x "
                    f"({m}, {d})")
            ref = featurize_gram_ref(x, w, cd)
            check_close(torch, name, out, ref, tol)
            if cd == "fp32" and d == 512:
                check_split(torch, name, out, ref,
                            featurize_1xtf32(torch, x, w))
            require(torch.equal(out, out.transpose(1, 2)),
                    "featurize_gram: Gram not symmetric")
        acc = randn(n_users, d, d)
        expect = acc + featurize_gram_ref(x, w)
        check_close(torch, "featurize_gram accumulate in place",
                    batched_featurize_gram(x, w, out=acc), expect, 1e-5)
    # gram_project: ragged n_valid, K not a multiple of the column slab.
    for n_users, n, d, k_cols in [(16, 256, 512, 1000), (8, 100, 784, 50)]:
        x = randn(n_users, n, d)
        counts = torch.randint(1, n + 1, (n_users,), generator=gen).to(dev)
        x[torch.arange(n, device=dev)[None, :] >= counts[:, None]] = 0.0
        v = randn(d, k_cols)
        name = f"gram_project ragged ({n_users}, {n}, {d}) x ({d}, {k_cols})"
        out = batched_gram_project(x, v, counts.float())
        ref = gram_project_ref(x, v, counts.float())
        check_close(torch, name, out, ref, 1e-5)
        if d == 512:
            check_split(torch, name, out, ref, gram_project_1xtf32(
                torch, x, v, counts.float()))

    # assign_wave and assign_one: every directory dtype, both compute
    # dtypes, B = 1 and B not a multiple of the arrival tile (under fp32,
    # B = 200 and 300 take the 2- and 4-arrival blocks on a 132-SM card,
    # the others 1 or 8; under bf16 every B is off the 64-arrival tile),
    # T = 1 and T = 130, d in (100, 512), k in (3, 8), dead
    # prototypes.  fp32 is
    # held to the reference's 1e-4 x max|plain| (a d = 512 affinity sums
    # 262,144 terms); bf16 to ASSIGN_BF16_TOL x max|plain|: both sides
    # round the same bf16 operands, so only fp32 summation order
    # separates them.  Margins to twice the tolerance; labels equal
    # (bf16: wherever the plain margin exceeds the tolerance).
    assign_errs = {"fp32": [0.0, 0.0], "bf16": [0.0, 0.0]}

    def note(cd, errs):
        assign_errs[cd] = [max(a, b) for a, b in zip(assign_errs[cd],
                                                      errs[:2])]
    for b_, t_, d_, k_ in [(1, 4, 512, 8), (13, 130, 100, 3),
                           (9, 1, 512, 8), (20, 130, 512, 8),
                           (1, 1, 100, 3), (200, 5, 100, 8),
                           (300, 33, 100, 3), (1100, 2, 100, 8)]:
        v = randn(b_, d_, k_)
        p = randn(t_, d_, d_)
        p = (p + p.transpose(1, 2)) / 2
        live = (torch.rand(t_, generator=gen) > 0.2).float().to(dev)
        live[0] = 1.0
        for dt in quant.DIRECTORY_DTYPES:
            table, scales = quant.quantize_directory(p, dt)
            for cd in ("fp32", "bf16"):
                got = assign(v, table, live, cd, scales=scales)
                want = assign_wave_plain(v, table, scales, live, cd)
                note(cd, check_assign(
                    torch, f"assign_wave ({b_}, {t_}, {d_}, {k_}) {dt} {cd}",
                    got, want, k_, cd, quiet=True))
                if dt != "int8":
                    got = assign_looped(v, table, live, cd)
                    want = assign_looped_plain(v, table, live, cd)
                    note(cd, check_assign(
                        torch, f"assign_one ({b_}, {t_}, {d_}, {k_}) {dt} "
                        f"{cd}", got, want, k_, cd, quiet=True))
    # assign_one where V does not fit a block's shared memory (256 KB of
    # bf16 at d = 1024, k = 64): the kernel stages it in chunks of d.
    v = randn(16, 1024, 64)
    p = randn(3, 1024, 1024)
    p = (p + p.transpose(1, 2)) / 2
    for dt in ("f32", "bf16"):
        table, _ = quant.quantize_directory(p, dt)
        for cd in ("fp32", "bf16"):
            note(cd, check_assign(
                torch, f"assign_one (16, 3, 1024, 64) {dt} {cd}",
                assign_looped(v, table, None, cd),
                assign_looped_plain(v, table, None, cd), 64, cd))
    del v, p, table
    print(f"  assign_wave, assign_one: 8 shapes x 3 directory dtypes x 2 "
          f"compute dtypes (assign_one also at (16, 3, 1024, 64), V in "
          f"chunks of d), dead prototypes: "
          f"max|kernel - plain| / "
          f"max|plain|, affinities and margins: fp32 "
          f"{assign_errs['fp32'][0]:.3e} and {assign_errs['fp32'][1]:.3e} "
          f"(tolerance 1e-4, margins 2e-4), bf16 "
          f"{assign_errs['bf16'][0]:.3e} and {assign_errs['bf16'][1]:.3e} "
          f"(tolerance {ASSIGN_BF16_TOL:g}, margins {2 * ASSIGN_BF16_TOL:g}"
          f"), labels equal")
    # The bf16 checks can tell bf16 from fp32: at d = 512 the two compute
    # dtypes differ by far more than ASSIGN_BF16_TOL, so a kernel that
    # ignored compute_dtype would fail them.
    v = randn(16, 512, 8)
    p = randn(4, 512, 512)
    for fn in (assign, assign_looped):
        a32 = fn(v, p, None, "fp32")[0]
        gap = max_err(torch, fn(v, p, None, "bf16")[0], a32) / float(
            a32.abs().max())
        print(f"  {fn.__name__} (16, 4, 512, 8): |bf16 - fp32| / max|fp32| "
              f"{gap:.3e}, above the bf16 tolerance {ASSIGN_BF16_TOL:g}")
        require(gap > 10 * ASSIGN_BF16_TOL,
                f"{fn.__name__}: bf16 result within 10x the bf16 tolerance "
                f"of fp32 ({gap:.3e}): the compute dtype is not applied")
    v = randn(13, 512, 8)
    p = randn(3, 512, 512)
    tie = torch.cat([p[:1], p[:1]])
    for fn in (assign, assign_looped):
        for cd in ("fp32", "bf16"):
            _, lab, mar = fn(v, tie, None, cd)
            require(bool((lab == 0).all()) and bool((mar == 0).all()),
                    f"{fn.__name__} {cd}: tied prototypes must give label 0 "
                    f"and margin 0")
            _, lab, mar = fn(v, p, torch.zeros(3, device=dev), cd)
            require(bool((lab == 0).all()) and bool(torch.isnan(mar).all()),
                    f"{fn.__name__} {cd}: an all-dead directory must give "
                    f"label 0 and a NaN margin")
            _, lab, mar = fn(v, p, torch.tensor([0., 1., 0.], device=dev),
                             cd)
            require(bool((lab == 1).all()) and bool(torch.isinf(mar).all()),
                    f"{fn.__name__} {cd}: one live prototype must win with "
                    f"margin +inf")
            aff, lab, mar = fn(v, p[:1], None, cd)
            require(bool((lab == 0).all()) and torch.equal(mar, aff[:, 0]),
                    f"{fn.__name__} {cd}: T = 1 must give margin = affinity")
    print("  assign edges: ties (label 0, margin 0), all dead (label 0, "
          "NaN margin), one live (+inf margin), T = 1 (margin = affinity)")

    def rel_check(name, out, ref, tol) -> float:
        """``max|out - ref| <= tol * max|ref|``, finite; returns the
        relative error."""
        require(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
        err = max_err(torch, out, ref) / max(float(ref.abs().max()), 1e-30)
        require(err <= tol, f"{name}: kernel disagrees with plain "
                f"({err:.3e} > {tol:g})")
        return err

    def flash_check(name, out, ref) -> float:
        """The flash kernel against its plain version on the same inputs:
        fp32 to 1e-5 x max|plain| (another summation order); a bf16
        output element by element, ``|out - ref| <= 2^-8 |ref| +
        1e-5 max|ref|``: its own rounding (half a bf16 ulp) plus the fp32
        gap.  Returns the fp32 relative error, or for bf16 the largest
        share of its element's limit that an element uses (<= 1)."""
        if out.dtype == torch.float32:
            return rel_check(name, out, ref, 1e-5)
        require(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
        gap = (out.double() - ref.double()).abs()
        limit = 2 ** -8 * ref.double().abs() + 1e-5 * float(ref.abs().max())
        used = float((gap / limit).max())
        require(used <= 1.0, f"{name}: a bf16 element is off its plain "
                f"value by {used:.3f} x its limit 2^-8 |ref| + 1e-5 max|ref|")
        return used

    # flash_attention: every head dim the models use, S and Skv off the
    # kernels' 32- and 64-row and 32- and 64-key tiles, causal, windowed
    # (inside one key tile and across several) and bidirectional masks;
    # fp32 and bf16 inputs, each held to ``flash_check``.  bf16 inputs
    # also go through the tensor-core kernel with its output left in fp32,
    # against the fp32 function of the same values to 1e-5 x max|plain|
    # (the bf16 output's rounding would hide an error in p.v); and, as a
    # negative control, the plain version with p rounded to bf16 once
    # must miss that function by more than 10x the same limit.
    lm_errs = {"flash fp32": 0.0, "flash bf16": 0.0,
               "flash bf16 fp32-out": 0.0, "flash p-once control": None,
               "wkv fp32": 0.0, "wkv bf16": 0.0, "wkv state": 0.0,
               "wkv bf16 compute": 0.0}
    n_checks = 0
    for hd in HEAD_DIMS:
        draw = zoo_randn if hd == 32 else randn
        for b_, s_, skv_, h_ in [(2, 100, 100, 3), (1, 257, 257, 2),
                                 (1, 70, 130, 2)]:
            qkv32 = (draw(b_, s_, h_, hd), draw(b_, skv_, h_, hd),
                     draw(b_, skv_, h_, hd))
            for dt, key in ((torch.float32, "flash fp32"),
                            (torch.bfloat16, "flash bf16")):
                q_, k_, v_ = (t_.to(dt) for t_ in qkv32)
                for causal, window in [(True, 0), (True, 48), (True, 130),
                                       (False, 0), (False, 33),
                                       (False, 130)]:
                    out = flash_attention(q_, k_, v_, causal=causal,
                                          window=window)
                    want = flash_ref(q_.float(), k_.float(), v_.float(),
                                     causal, window)
                    require(out.dtype == dt, "flash: output dtype")
                    name = (f"flash hd={hd} ({b_}, {s_}, {skv_}, {h_}) {dt} "
                            f"causal={causal} window={window}")
                    lm_errs[key] = max(lm_errs[key], flash_check(
                        name, out.float() if dt == torch.float32 else out,
                        want))
                    n_checks += 1
                    if dt != torch.bfloat16:
                        continue
                    lm_errs["flash bf16 fp32-out"] = max(
                        lm_errs["flash bf16 fp32-out"], rel_check(
                            f"{name} fp32 out", _flash_attention_fp32_out(
                                q_, k_, v_, causal, window), want, 1e-5))
                    if causal and not window:
                        once = flash_ref(q_.float(), k_.float(), v_.float(),
                                         causal, window, p_rounding="bf16")
                        gap = max_err(torch, once, want) / float(
                            want.abs().max())
                        require(gap > 10 * 1e-5,
                                f"{name}: p rounded to bf16 once is within "
                                f"10x the fp32-out limit ({gap:.3e}): the "
                                f"check cannot see a bf16 p.v")
                        ctl = lm_errs["flash p-once control"]
                        lm_errs["flash p-once control"] = gap if ctl is None \
                            else min(ctl, gap)
    # A view whose storage offset leaves it off the kernel's 16-byte loads
    # is copied, not read misaligned.
    base = randn(1 * 70 * 2 * 64 + 1)
    q_ = base[1:].view(1, 70, 2, 64)
    require(q_.data_ptr() % 16 != 0, "flash: the view is aligned")
    out = flash_attention(q_, q_, q_)
    lm_errs["flash fp32"] = max(lm_errs["flash fp32"], flash_check(
        "flash misaligned view", out, flash_ref(q_, q_, q_, True, 0)))
    n_checks += 1
    print(f"  flash_attention: {n_checks} cases (hd "
          f"{'/'.join(map(str, HEAD_DIMS))}, S and "
          f"Skv off the tiles, causal / window 48 and 130 / bidirectional, "
          f"a misaligned view): fp32 max|kernel - plain| / max|plain| "
          f"{lm_errs['flash fp32']:.3e} (tolerance 1e-5); bf16 element by "
          f"element within 2^-8 |plain| + 1e-5 max|plain| of the fp32 "
          f"function, at most {lm_errs['flash bf16']:.3f} of that limit; "
          f"the tensor-core kernel with fp32 output "
          f"{lm_errs['flash bf16 fp32-out']:.3e} (tolerance 1e-5), p "
          f"rounded to bf16 once at least "
          f"{lm_errs['flash p-once control']:.3e} (must exceed 1e-4)")
    # wkv_chunked, the chunk form on the tensor cores: S of 1, under one
    # 16-token sub-chunk, ragged and whole sub-chunks, several 64-token
    # chunks; hd 32 and 64; fp32 and bf16 r, k, v; decays down to
    # -exp(randn + 2).  fp32 compute (3xTF32): out and state within 1e-5 x
    # max of the sequential oracle and of the plain chunk form (out
    # rounded to bf16: 2^-8).  bf16 compute (the reference's roundings):
    # out and state within 2^-8 x max of the plain chunk form with the
    # same roundings; its gap to the fp32 oracle is printed beside the
    # plain chunk form's, which the CPU tests hold within 2x the
    # reference's own bf16 kernel's, and may be at most twice that.
    n_checks = 0
    wkv_gaps = {"kernel": 0.0, "plain": 0.0}
    for hd in (32, 64):
        for b_, s_, h_, shift in [(1, 1, 2, 0.0), (2, 7, 3, 0.0),
                                  (1, 16, 2, 0.0), (2, 17, 3, 0.0),
                                  (2, 37, 3, 0.0), (4, 64, 32, 0.0),
                                  (2, 130, 2, 0.0), (2, 200, 2, 0.0),
                                  (2, 200, 2, 2.0)]:
            for dt in (torch.float32, torch.bfloat16):
                r_, k_, v_ = (randn(b_, s_, h_, hd).to(dt) for _ in range(3))
                logw_ = -torch.exp(randn(b_, s_, h_, hd) + shift)
                u_, st_ = randn(h_, hd), randn(b_, h_, hd, hd)
                want, want_st = wkv_ref(r_, k_, v_, logw_, u_, st_)
                name = (f"wkv ({b_}, {s_}, {h_}, {hd}) {dt}"
                        + (" strong decay" if shift else ""))
                for cd in ("fp32", "bf16"):
                    before = dispatch.LAUNCHES["wkv_chunked"]
                    out, new_st = wkv_chunked(r_, k_, v_, logw_, u_, st_,
                                              compute_dtype=cd)
                    require(dispatch.LAUNCHES["wkv_chunked"] == before + 1,
                            "wkv: not one launch a call")
                    require(out.dtype == dt and new_st.dtype == torch.float32,
                            "wkv: output dtypes")
                    plain, plain_st = wkv_chunked_ref(
                        r_, k_, v_, logw_, u_, st_, compute_dtype=cd)
                    if cd == "fp32":
                        tol = 1e-5 if dt == torch.float32 else 2 ** -8
                        key = "wkv fp32" if dt == torch.float32 \
                            else "wkv bf16"
                        for ref_o, ref_s in ((want, want_st),
                                             (plain, plain_st)):
                            lm_errs[key] = max(lm_errs[key], rel_check(
                                f"{name} fp32 compute", out.float(), ref_o,
                                tol))
                            lm_errs["wkv state"] = max(
                                lm_errs["wkv state"], rel_check(
                                    f"{name} fp32 compute state", new_st,
                                    ref_s, 1e-5))
                    else:
                        lm_errs["wkv bf16 compute"] = max(
                            lm_errs["wkv bf16 compute"],
                            rel_check(f"{name} bf16 compute", out.float(),
                                      plain, 2 ** -8),
                            rel_check(f"{name} bf16 compute state", new_st,
                                      plain_st, 2 ** -8))
                        scale = float(want.abs().max())
                        gap = max_err(torch, out.float(), want) / scale
                        plain_gap = max_err(torch, plain.to(dt).float(),
                                            want) / scale
                        wkv_gaps["kernel"] = max(wkv_gaps["kernel"], gap)
                        wkv_gaps["plain"] = max(wkv_gaps["plain"], plain_gap)
                        require(gap <= max(2 * plain_gap, 1e-5),
                                f"{name} bf16 compute: gap to the fp32 "
                                f"oracle {gap:.3e} is over twice the plain "
                                f"chunk form's {plain_gap:.3e}")
                    n_checks += 1
    summary["phase2_wkv_bf16_gap_to_oracle"] = wkv_gaps
    print(f"  wkv_chunked: {n_checks} cases (S 1/7/16/17/37/64/130/200, hd "
          f"32/64, fp32 and bf16 r/k/v and compute, strong decays): fp32 "
          f"compute out {lm_errs['wkv fp32']:.3e} (tolerance 1e-5; bf16 "
          f"out {lm_errs['wkv bf16']:.3e}, tolerance 2^-8), state "
          f"{lm_errs['wkv state']:.3e} (tolerance 1e-5) against the oracle "
          f"and the plain chunk form; bf16 compute "
          f"{lm_errs['wkv bf16 compute']:.3e} against the plain chunk form "
          f"(tolerance 2^-8); bf16 compute's gap to the fp32 oracle "
          f"{wkv_gaps['kernel']:.3e} x max, the plain chunk form's "
          f"{wkv_gaps['plain']:.3e}")
    # linear_scan: D off the 32-channel warp, S = 1 and long S, B = 3 with
    # S off the 128-token stage, D % 4 != 0 and a view 4 bytes off 16
    # (the 4-byte cp.async route); the plain version's separately rounded
    # multiply and add: equal, and two runs bit-equal.
    for b_, s_, d_, off in [(1, 1, 100, 0), (2, 77, 1000, 0),
                            (1, 4096, 4097, 0), (3, 77, 512, 0),
                            (2, 300, 1024, 1)]:
        n_el = b_ * s_ * d_
        buf = torch.empty(2 * n_el + off, device=dev)
        la_ = buf[off:off + n_el].view(b_, s_, d_).copy_(
            -torch.exp(randn(b_, s_, d_) - 1))
        x_ = buf[off + n_el:].view(b_, s_, d_).copy_(randn(b_, s_, d_))
        h0_ = randn(b_, d_)
        route = linear_scan_plan(b_, s_, d_, la_.data_ptr() % 16 == 0
                                 and x_.data_ptr() % 16 == 0).route
        got_h, got_last = linear_scan(la_, x_, h0_)
        want_h, want_last = linear_scan_ref(la_, x_, h0_)
        again_h, again_last = linear_scan(la_, x_, h0_)
        require(torch.equal(got_h, want_h) and torch.equal(got_last,
                                                           want_last),
                f"linear_scan ({b_}, {s_}, {d_}) {route} differs from plain")
        require(torch.equal(got_h, again_h)
                and torch.equal(got_last, again_last),
                f"linear_scan ({b_}, {s_}, {d_}): two runs differ")
        print(f"  linear_scan ({b_}, {s_}, {d_}){' misaligned' if off else ''}"
              f" ({route}): equal to plain (exact), two runs bit-equal")
    require(all(rs_ops.kernel_scan_plan(*a) == linear_scan_plan(*a)
                for a in [(1, 4096, 4096, True), (1, 4096, 4097, True),
                          (3, 77, 512, False), (1, 0, 8, True)]),
            "linear_scan: the C side's plan differs from linear_scan_plan")
    summary["phase2_lm_rel_err"] = lm_errs
    phase_done("phase 2")

    # -- Phase 3: the main path at full width -----------------------------
    print(f"[3] main path: one_shot_clustering N={N_USERS} n={N_SAMPLES} "
          f"d={DIM} T={TASKS} top_k={TOP_K}")
    small, small_tasks = make_task_feature_mixture(64, 64, 64, 4, seed=1)
    cfg_small = sim.SimilarityConfig(top_k=8)
    on_card = one_shot_clustering(small, 4, cfg=cfg_small,
                                  cluster_cfg=ClusterConfig(backend="torch"))
    on_cpu = one_shot_clustering(small, 4, cfg=cfg_small,
                                 cluster_cfg=ClusterConfig(backend="torch"),
                                 device="cpu")
    small_gap = max_err(torch, on_card.similarity.cpu(), on_cpu.similarity)
    require(small_gap <= 1e-4, f"small input: R on the card differs from "
            f"the CPU plain path by {small_gap:.3e}")
    require(clu.adjusted_rand_index(on_card.labels.cpu().numpy(),
                                    on_cpu.labels.numpy()) == 1.0,
            "small input: labels differ from the CPU plain path")
    print(f"  small input (64 users, d=64): R within {small_gap:.3e} of the "
          f"CPU plain path (tolerance 1e-4), same labels")

    t0 = time.perf_counter()
    feats, task_ids = make_task_feature_mixture(N_USERS, N_SAMPLES, DIM,
                                                TASKS, seed=SEED)
    x = torch.from_numpy(feats).to(dev)
    print(f"  data: {x.numel() * 4 / 2**20:.0f} MiB of features on the card "
          f"(made in {time.perf_counter() - t0:.1f} s)")
    cfg = sim.SimilarityConfig(top_k=TOP_K)
    ccfg = ClusterConfig(backend="torch")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    dispatch.reset_launches()
    t0 = time.perf_counter()
    res = one_shot_clustering(x, TASKS, cfg=cfg, cluster_cfg=ccfg,
                              device=dev)
    labels = res.labels.cpu().numpy()
    wall = time.perf_counter() - t0
    launches = dict(dispatch.LAUNCHES)
    peak, mem_text = memory_line(torch, live)
    acc = clu.clustering_accuracy(labels, task_ids)
    record("dense", wall, live, accuracy=acc, launches=launches)
    print(f"  launches: {launches}")
    print(f"  wall {wall:.3f} s, {mem_text}, "
          f"clustering accuracy {acc:.1%}, cluster sizes "
          f"{np.bincount(labels, minlength=TASKS).tolist()}")
    for name in ("gram", "eigproject", "linkage"):
        require(launches[name] > 0, f"main path never launched {name}")
    big_r = res.similarity
    require(tuple(big_r.shape) == (N_USERS, N_USERS)
            and bool(torch.isfinite(big_r).all())
            and torch.equal(big_r, big_r.T), "R is not a finite symmetric "
            "(N, N) matrix")
    require(labels.shape == (N_USERS,), "labels have the wrong shape")
    require(acc == 1.0, f"clustering accuracy {acc:.4f} < 1")

    # Per-stage times of the same path, one synchronised stage at a time.
    stages = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = (time.perf_counter() - t) * 1e3
        return out

    feats_d, nv = sim.prepare_user_batch(x, device=dev)
    grams = stage("gram", lambda: sim.batched_gram(feats_d, nv))
    lam, v = stage("eigh", lambda: sim.spectrum(grams, TOP_K))
    lam_hat = stage("cross_projection",
                    lambda: project_norms_all(grams, v))
    big_r2 = stage("relevance", lambda: sim.symmetrize(
        sim.relevance(lam[:, None, :], lam_hat, cfg.eig_floor)))
    cengine = ClusterEngine(ccfg, device=dev)
    dend = stage("hac", lambda: cengine.hac(big_r2))
    stage("cut", lambda: cengine.cut(dend, TASKS))
    print("  stage ms: " + ", ".join(f"{k} {v:.3f}"
                                      for k, v in stages.items()))
    dense_labels, dense_work = labels, peak - live
    phase_done("phase 3")

    # -- Phase 3b: the blockwise path at full width -----------------------
    print(f"[3b] blockwise path: one_shot_clustering block_users="
          f"{BLOCK_USERS} on the phase-3 users")
    cfg_b = sim.SimilarityConfig(top_k=TOP_K, block_users=BLOCK_USERS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    dispatch.reset_launches()
    t0 = time.perf_counter()
    res_b = one_shot_clustering(x, TASKS, cfg=cfg_b, cluster_cfg=ccfg,
                                device=dev)
    labels_b = res_b.labels.cpu().numpy()
    wall_b = time.perf_counter() - t0
    launches_b = dict(dispatch.LAUNCHES)
    _, mem_text = memory_line(torch, live)
    acc_b = clu.clustering_accuracy(labels_b, task_ids)
    record("blockwise", wall_b, live, accuracy=acc_b, launches=launches_b)
    gap_b = max_err(torch, res_b.similarity, big_r)
    print(f"  launches: {launches_b}")
    print(f"  wall {wall_b:.3f} s, {mem_text} (dense path: "
          f"{dense_work / 2**30:.2f} GiB above its live memory), clustering "
          f"accuracy {acc_b:.1%}")
    print(f"  R within {gap_b:.3e} of the dense R (tolerance 1e-4), labels "
          f"ARI {clu.adjusted_rand_index(labels_b, dense_labels):.3f} "
          f"against the dense labels, ledger mode {res_b.ledger.mode}")
    require(launches_b["gram_project"] > 0,
            "blockwise path never launched gram_project")
    require(bool(torch.isfinite(res_b.similarity).all())
            and torch.equal(res_b.similarity, res_b.similarity.T),
            "blockwise R is not finite and symmetric")
    require(gap_b <= 1e-4, f"blockwise R differs from the dense R by "
            f"{gap_b:.3e}")
    require(clu.adjusted_rand_index(labels_b, dense_labels) == 1.0,
            "blockwise labels differ from the dense labels")
    require(acc_b == 1.0, f"blockwise clustering accuracy {acc_b:.4f} < 1")
    v_flat = res_b.v.permute(1, 0, 2).reshape(DIM, -1).contiguous()
    phase_done("phase 3b")

    # -- Phase 3c: the raw-data path ---------------------------------------
    print("[3c] raw path: one_shot_clustering from raw data through the "
          "SignatureEngine")
    # A small input first, on the card and on the CPU plain path, for
    # every Phi kind, fp32 and bf16.
    raw_s, tasks_s = make_task_feature_mixture(32, 64, 192, 2, seed=3)
    probe = np.random.default_rng(4).standard_normal(
        (100, 192)).astype(np.float32)
    small_cfgs = [FeatureConfig(kind="identity"),
                  FeatureConfig(kind="random_projection", d=32),
                  FeatureConfig(kind="pca", d=32).bind_probe(probe),
                  FeatureConfig(kind="random_conv", d=64,
                                image_hw=(8, 8, 3))]
    for fc in small_cfgs:
        for cd, tol in (("fp32", 1e-4), ("bf16", 1e-3)):
            kw = dict(cfg=sim.SimilarityConfig(top_k=4), feature_cfg=fc,
                      probe=probe if fc.kind == "pca" else None,
                      signature_cfg=SignatureConfig(chunk_rows=24,
                                                    compute_dtype=cd),
                      cluster_cfg=ccfg)
            on_card = one_shot_clustering(raw_s, 2, device=dev, **kw)
            on_cpu = one_shot_clustering(raw_s, 2, device="cpu", **kw)
            gap = max_err(torch, on_card.similarity.cpu(),
                          on_cpu.similarity)
            same = clu.adjusted_rand_index(on_card.labels.cpu().numpy(),
                                           on_cpu.labels.numpy()) == 1.0
            print(f"  small input (32 users, m=192) {fc.kind} {cd}: R within "
                  f"{gap:.3e} of the CPU plain path (tolerance {tol:g}), "
                  f"same labels {same}")
            require(gap <= tol and same, f"small raw input {fc.kind} {cd}: "
                    f"card and CPU plain path disagree")

    t0 = time.perf_counter()
    users = paper_cifar_two_task(
        n_per_user=RAW_ROWS_PER_USER, seed=SEED,
        users_per_task=(RAW_USERS_PER_TASK, RAW_USERS_PER_TASK))
    raw_tasks = np.array([u.task_id for u in users])
    raw_np = np.stack([u.x for u in users])
    # Phases 3i and 3j train on these users: their x become views of the
    # stack, so the per-user copies can go.
    raw_users = [dataclasses.replace(u, x=raw_np[i])
                 for i, u in enumerate(users)]
    del users
    t_data = time.perf_counter() - t0
    t0 = time.perf_counter()
    raw_x = torch.from_numpy(raw_np).to(dev)
    torch.cuda.synchronize()
    n_raw, rows_raw, m_raw = raw_x.shape
    print(f"  data: paper_cifar_two_task, {n_raw} users x {rows_raw} rows x "
          f"m={m_raw}, {raw_x.numel() * 4 / 2**30:.2f} GiB (made in "
          f"{t_data:.1f} s on the host, put on the card in "
          f"{time.perf_counter() - t0:.1f} s)")
    fc_raw = FeatureConfig(kind="random_projection", d=DIM)
    sc_raw = SignatureConfig(chunk_rows=RAW_CHUNK_ROWS, check=True)
    cfg_raw = sim.SimilarityConfig(top_k=TOP_K)
    raw_kw = dict(cfg=cfg_raw, cluster_cfg=ccfg, feature_cfg=fc_raw,
                  signature_cfg=sc_raw, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    dispatch.reset_launches()
    t0 = time.perf_counter()
    res_r = one_shot_clustering(raw_x, 2, **raw_kw)
    labels_r = res_r.labels.cpu().numpy()
    wall_r = time.perf_counter() - t0
    launches_r = dict(dispatch.LAUNCHES)
    _, mem_text = memory_line(torch, live)
    acc_r = clu.clustering_accuracy(labels_r, raw_tasks)
    record("raw", wall_r, live, accuracy=acc_r, launches=launches_r)
    print(f"  launches: {launches_r}")
    print(f"  wall {wall_r:.3f} s (raw stack on the card, convergence "
          f"check on), {mem_text}, "
          f"clustering accuracy {acc_r:.1%}, cluster sizes "
          f"{np.bincount(labels_r, minlength=2).tolist()}")
    for name in ("featurize_gram", "eigproject", "linkage"):
        require(launches_r[name] > 0, f"raw path never launched {name}")
    r_raw = res_r.similarity
    require(tuple(r_raw.shape) == (n_raw, n_raw)
            and bool(torch.isfinite(r_raw).all())
            and torch.equal(r_raw, r_raw.T), "raw-path R is not a finite "
            "symmetric (N, N) matrix")
    require(acc_r == 1.0, f"raw-path clustering accuracy {acc_r:.4f} < 1")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_h = one_shot_clustering(raw_np, 2, **raw_kw)
    labels_h = res_h.labels.cpu().numpy()
    wall_h = time.perf_counter() - t0
    gap_h = max_err(torch, res_h.similarity, r_raw)
    print(f"  host-numpy streaming input (one chunk copied to the card per "
          f"step): wall {wall_h:.3f} s, R within {gap_h:.3e} of the "
          f"on-card run")
    require(gap_h <= 1e-5 and clu.adjusted_rand_index(labels_h, labels_r)
            == 1.0, "host-streamed raw input disagrees with the on-card run")
    del res_h

    engine = SignatureEngine(fc_raw, sc_raw, device=dev)
    nv_raw = torch.full((n_raw,), float(rows_raw), device=dev)
    stages_r = {}

    def raw_stage(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages_r[name] = (time.perf_counter() - t) * 1e3
        return out

    grams_r = raw_stage("featurize_accumulate", lambda: engine.accumulate_grams(
        raw_x, nv_raw, assume_full=True))
    lam_r, v_r = raw_stage("topk_spectrum",
                           lambda: engine.spectrum(grams_r, TOP_K))
    r_stage = raw_stage("relevance", lambda: sim.symmetrize(
        sim.relevance_matrix(grams_r, lam_r, v_r, cfg_raw.eig_floor)))
    dend_r = raw_stage("hac", lambda: cengine.hac(r_stage))
    raw_stage("cut", lambda: cengine.cut(dend_r, 2))
    print("  stage ms: " + ", ".join(f"{k} {v:.3f}"
                                      for k, v in stages_r.items()))
    resid = float(subspace_residual(grams_r, lam_r, v_r).max())
    print(f"  convergence check passed: max relative eigen-residual "
          f"{resid:.3e} (tolerance {sc_raw.resid_tol:g})")
    require(resid < sc_raw.resid_tol, "raw path: subspace iteration did "
            "not converge")
    print(f"  signature stage (featurize + top-k) "
          f"{stages_r['featurize_accumulate'] + stages_r['topk_spectrum']:.3f}"
          f" ms against the dense path's eigh {stages['eigh']:.3f} ms")
    del grams_r, r_stage, dend_r
    phase_done("phase 3c")

    # -- Phase 3d: the landmark (Nystrom) sketch --------------------------
    print(f"[3d] landmark path: one_shot_clustering landmarks={LANDMARKS} "
          f"on the phase-3 users")
    cfg_l = sim.SimilarityConfig(top_k=TOP_K, landmarks=LANDMARKS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    dispatch.reset_launches()
    t0 = time.perf_counter()
    res_l = one_shot_clustering(x, TASKS, cfg=cfg_l, cluster_cfg=ccfg,
                                device=dev)
    labels_l = res_l.labels.cpu().numpy()
    wall_l = time.perf_counter() - t0
    launches_l = dict(dispatch.LAUNCHES)
    _, mem_text = memory_line(torch, live)
    acc_l = clu.clustering_accuracy(labels_l, task_ids)
    record("landmarks", wall_l, live, accuracy=acc_l, launches=launches_l)
    r_l = res_l.similarity
    print(f"  launches: {launches_l}")
    print(f"  wall {wall_l:.3f} s, {mem_text}, clustering accuracy "
          f"{acc_l:.1%}, R in [{float(r_l.min()):.3e}, "
          f"{float(r_l.max()):.3e}]")
    require(launches_l["assign_wave"] == 1,
            f"landmark path launched assign_wave "
            f"{launches_l['assign_wave']} times, not once")
    require(launches_l["linkage"] >= 1, "landmark path never launched "
            "linkage")
    require(tuple(r_l.shape) == (N_USERS, N_USERS)
            and bool(torch.isfinite(r_l).all()) and torch.equal(r_l, r_l.T)
            and float(r_l.min()) >= 0.0 and float(r_l.max()) <= 1.0,
            "landmark R is not a finite symmetric matrix in [0, 1]")
    require(acc_l == 1.0, f"landmark clustering accuracy {acc_l:.4f} < 1")
    land_idx = torch.from_numpy(landmark_indices(N_USERS, LANDMARKS)).to(
        dev).long()
    v_land = res_l.v[land_idx]
    land_protos = torch.einsum("mdk,mek->mde", v_land, v_land)
    land_v = res_l.v.contiguous()
    del res_l, r_l
    phase_done("phase 3d")

    # -- Phase 3e: membership serving ---------------------------------------
    print("[3e] serving: launch.membership.run_cell " + " ".join(
        SERVING_ARGS))
    serve_args = launch_membership.build_parser().parse_args(SERVING_ARGS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    dispatch.reset_launches()
    t0 = time.perf_counter()
    cell, served, (lam_last, v_last) = launch_membership.run_cell(
        serve_args, serve_args.scenario, serve_args.arrivals, verbose=True,
        return_state=True)
    wall_s = time.perf_counter() - t0
    launches_s = dict(dispatch.LAUNCHES)
    _, mem_text = memory_line(torch, live)
    record("serving", wall_s, live, launches=launches_s, **cell)
    print(f"  launches: {launches_s}")
    print(f"  wall {wall_s:.3f} s (seed protocol {cell['seed_s']:.3f} s), "
          f"{mem_text}")
    print("  per-wave assign ms "
          + ", ".join(f"{t:.3f}" for t in cell["assign_ms"])
          + "; admit ms " + ", ".join(f"{t:.3f}" for t in cell["admit_ms"]))
    print(f"  re-clusters at waves {cell['recluster_waves']} (reference "
          f"{REF_SERVING_RECLUSTER_WAVES}), ms "
          + ", ".join(f"{t:.3f}" for t in cell["recluster_ms"])
          + f", members {cell['recluster_members']}")
    print("  unassigned after each wave "
          + ", ".join(f"{u:.1%}" for u in cell["unassigned_per_wave"])
          + " (reference " + ", ".join(
              f"wave {w}: {u:.1%}" for w, u in
              REF_SERVING_UNASSIGNED.items())
          + f"); {cell['n_members']} members at the end (reference 1600)")
    require(cell["seed_accuracy"] == 1.0,
            f"serving seed accuracy {cell['seed_accuracy']:.4f} < 1")
    require(all(a == 1.0 for a in cell["accuracy_per_wave"]),
            f"serving honest accuracy per wave {cell['accuracy_per_wave']}")
    require(cell["n_reclusters"] >= 1, "serving cell never re-clustered")
    require(launches_s["assign_wave"] == serve_args.waves,
            f"serving cell launched assign_wave "
            f"{launches_s['assign_wave']} times for {serve_args.waves} "
            f"waves")

    # The last wave scored again against bf16 and int8 directories.
    st = served.state
    f32_labels = served.assign(lam_last, v_last).labels
    agreement = {}
    for dt in ("bf16", "int8"):
        table, scales = quant.quantize_directory(st.protos_f32, dt)
        q_state = dataclasses.replace(st, protos=table, protos0=table,
                                      proto_scales=scales,
                                      proto0_scales=scales)
        q_engine = MembershipEngine(dataclasses.replace(
            served.cfg, directory_dtype=dt), device=dev)
        q_engine.state = q_state
        q_labels = q_engine.assign(lam_last, v_last).labels
        agreement[dt] = (float((q_labels == f32_labels).float().mean()),
                         st.directory_bytes / q_state.directory_bytes)
    print("  last wave re-scored: " + ", ".join(
        f"{dt} directory labels agree with f32 on {a:.1%}, f32 bytes / "
        f"{dt} bytes {r:.5f}" for dt, (a, r) in agreement.items()))
    summary["paths"]["serving"]["directory_agreement"] = agreement
    require(all(a >= 0.99 for a, _ in agreement.values()),
            "quantized directories disagree with f32 on more than 1%")
    require(agreement["bf16"][1] == 2.0 and 3.8 < agreement["int8"][1] <= 4.0,
            "directory byte ratios are off")
    # The per-arrival baseline on the same wave, through its public
    # entry point: one assign_one launch for the wave.
    dispatch.reset_launches()
    v_dev = torch.as_tensor(v_last).to(dev)
    base = assign_looped(v_dev, st.protos, st.counts > 0,
                         served.cfg.compute_dtype)
    launches_one = dispatch.LAUNCHES["assign_one"]
    wave_out = assign(v_dev, st.protos, st.counts > 0,
                      served.cfg.compute_dtype)
    same = float((base[1] == wave_out[1]).float().mean())
    print(f"  per-arrival baseline (assign_looped, {launches_one} launch): "
          f"argmax agrees with the wave kernel on {same:.1%}")
    require(launches_one == 1 and same >= 0.99,
            "assign_looped disagrees with assign on the last wave")
    serve_protos = st.protos
    phase_done("phase 3e")

    # -- Phase 3f: cluster-routed LM serving at full width ------------------
    cfg_f = dataclasses.replace(get_arch("rwkv6_1_6b"), rec_impl="pallas")
    print(f"[3f] LM serving: ServeEngine {LM_SERVE} on {cfg_f.name} CONFIG "
          f"({cfg_f.n_layers} layers, d={cfg_f.d_model}, vocab "
          f"{cfg_f.vocab}, {cfg_f.param_dtype}, rec_impl=pallas), "
          f"{LM_REQUESTS} requests from {LM_TASKS} token tasks, T="
          f"{LM_TASKS} cluster heads")
    def routed(task, sig):
        """Seed a directory on the task streams and route the requests:
        (prompts, gens, arrivals, request tasks, cluster ids)."""
        seeds, seed_tasks, prompts, gens, arrive, req_tasks = \
            token_requests(np, sample_tokens, TokenTaskSpec, task)
        sigs = [token_signature(t_, **sig) for t_ in seeds]
        router = MembershipEngine(MembershipConfig(), device=dev)
        router.seed(np.stack([g_[0] for g_ in sigs]),
                    np.stack([g_[1] for g_ in sigs]), np.asarray(seed_tasks),
                    n_clusters=LM_TASKS)
        return (prompts, gens, arrive, req_tasks,
                route_requests(router, prompts, **sig))

    *_, default_tasks, default_cids = routed(DEFAULT_TASK, DEFAULT_SIG)
    default_acc = float(np.mean(default_cids == np.asarray(default_tasks)))
    print(f"  routing at the defaults (logit scale 3, window 16), same "
          f"prompt lengths: {default_acc:.1%} of requests to their task "
          f"(reported, not required)")
    summary["lm_routing_default_accuracy"] = default_acc
    prompts, gens, arrive, req_tasks, cids = routed(TOKEN_TASK, SIG)
    print(f"  routing: {LM_TASKS * LM_SEED_STREAMS} seed streams -> "
          f"directory; request clusters {cids.tolist()} (tasks "
          f"{req_tasks})")
    require(cids.tolist() == req_tasks, "routing did not recover the tasks")
    reqs = [Request(tokens=p_, gen=g_, cluster=int(c_), arrive_round=a_)
            for p_, g_, c_, a_ in zip(prompts, gens, cids, arrive)]
    scfg_f = ServeConfig(**LM_SERVE)
    t0 = time.perf_counter()
    model_f = get_model(cfg_f)
    params_f = model_f.init(SEED, device=dev)
    heads_f = ClusterHeads.init(SEED + 1, params_f.head, n_clusters=LM_TASKS)
    torch.cuda.synchronize()
    print(f"  random weights on the card in {time.perf_counter() - t0:.1f} s")
    engine_f = ServeEngine(model_f, params_f, heads_f, scfg_f)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    dispatch.reset_launches()
    t0 = time.perf_counter()
    stats_f = engine_f.serve(reqs)
    torch.cuda.synchronize()
    wall_f = time.perf_counter() - t0
    launches_f = dict(dispatch.LAUNCHES)
    _, mem_text = memory_line(torch, live)
    n_chunks = scfg_f.max_prompt // scfg_f.prefill_chunk
    print(f"  launches: {launches_f}")
    print(f"  wall {wall_f:.3f} s, {stats_f.total_tokens} tokens, "
          f"{stats_f.aggregate_tok_per_s:.1f} tok/s aggregate, mean TTFT "
          f"{stats_f.mean_ttft_s * 1e3:.1f} ms, {stats_f.decode_rounds} "
          f"decode rounds, {stats_f.prefill_dispatches} prefill and "
          f"{stats_f.decode_dispatches} decode dispatches, slot utilization "
          f"{stats_f.slot_utilization:.3f}, {mem_text}")
    record("lm_serving", wall_f, live, launches=launches_f,
           total_tokens=stats_f.total_tokens,
           tok_per_s=stats_f.aggregate_tok_per_s,
           mean_ttft_s=stats_f.mean_ttft_s,
           decode_rounds=stats_f.decode_rounds,
           prefill_dispatches=stats_f.prefill_dispatches,
           decode_dispatches=stats_f.decode_dispatches,
           slot_utilization=stats_f.slot_utilization)
    # A second, traced run of the first wave's requests: the device's busy
    # share and the kernel launches the host issued.  The untraced run
    # above gives the end-to-end numbers; tracing slows the host.  Only
    # device activity (and the runtime's launch calls) is traced.  The
    # busy share is the union of the kernels' intervals over their span,
    # both on the profiler's clock (``busy_share``, as in 3i).  A session
    # in an old process can lose its first kernel events, so it opens
    # with GUARD_SPINS short spin kernels, which take no part in the
    # counts, and the traced kernel events must cover every launch the
    # host issued after them; the span is printed beside the span two
    # CUDA events give around the wave.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ev_start = torch.cuda.Event(enable_timing=True)
    ev_end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(GUARD_SPINS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        ev_start.record()
        t0 = time.perf_counter()
        engine_f.serve(reqs[:scfg_f.wave])
        ev_end.record()
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t0
    events_span = ev_start.elapsed_time(ev_end) / 1e3
    launch_calls = ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx",
                    "cudaLaunchKernelExC")
    all_events = prof.events()
    host_launches = sum(e.name in launch_calls
                        for e in all_events) - GUARD_SPINS
    kernel_spans = [(e.time_range.start, e.time_range.end)
                    for e in all_events
                    if e.device_type == DeviceType.CUDA
                    and "spin_kernel" not in e.name
                    and not e.name.startswith(("Memcpy", "Memset"))]
    copy_spans = [(e.time_range.start, e.time_range.end)
                  for e in all_events
                  if e.device_type == DeviceType.CUDA
                  and e.name.startswith(("Memcpy", "Memset"))]
    busy_f, span_f = busy_share(kernel_spans + copy_spans)
    print(f"  traced run: wall {traced_wall:.3f} s; device busy "
          f"{busy_f:.1%} of the kernels' span (idle {1 - busy_f:.1%}; "
          f"{len(kernel_spans)} kernels and {len(copy_spans)} copies over "
          f"{span_f:.3f} s on the profiler's clock, {events_span:.3f} s "
          f"between CUDA events); {host_launches} kernel launches from the "
          f"host")
    require(len(kernel_spans) >= host_launches,
            f"3f: the trace holds {len(kernel_spans)} kernel events for "
            f"{host_launches} launches: it lost events")
    summary["paths"]["lm_serving"].update(
        traced_wall_s=traced_wall, traced_busy_share=busy_f,
        traced_span_s=span_f, events_span_s=events_span,
        traced_kernels=len(kernel_spans), host_launches=host_launches)
    for r_, res in zip(reqs, stats_f.results):
        require(len(res.tokens) == r_.gen
                and bool(((res.tokens >= 0)
                          & (res.tokens < cfg_f.vocab)).all()),
                "a request did not get its gen tokens in the vocabulary")
    require(launches_f["wkv_chunked"] == stats_f.prefill_dispatches
            * n_chunks * cfg_f.n_layers,
            f"wkv_chunked launched {launches_f['wkv_chunked']} times, not "
            f"waves x chunks x layers = {stats_f.prefill_dispatches} x "
            f"{n_chunks} x {cfg_f.n_layers}")
    del engine_f, params_f, heads_f, model_f
    torch.cuda.empty_cache()
    # Depth cut for the reference's bar: full width, 2 layers, fp32; the
    # engine's tokens equal per-request greedy decode through the same
    # cluster heads.
    cfg_c = dataclasses.replace(cfg_f, n_layers=2, param_dtype="float32",
                                act_dtype="float32")
    model_c = get_model(cfg_c)
    params_c = model_c.init(SEED, device=dev)
    heads_c = ClusterHeads.init(SEED + 1, params_c.head, n_clusters=LM_TASKS)
    dispatch.reset_launches()
    stats_c = ServeEngine(model_c, params_c, heads_c, scfg_f).serve(reqs)
    require(dispatch.LAUNCHES["wkv_chunked"] == stats_c.prefill_dispatches
            * n_chunks * 2, "2-layer engine: wkv launches")
    t0 = time.perf_counter()
    for i, r_ in enumerate(reqs):
        base = greedy_decode(model_c, params_c,
                             torch.from_numpy(r_.tokens)[None].to(dev), r_.gen,
                             logits_fn=cluster_logits_fn(heads_c, r_.cluster))
        require(np.array_equal(base.tokens[0].cpu().numpy(),
                               stats_c.results[i].tokens),
                f"request {i}: engine tokens differ from greedy_decode")
    print(f"  depth cut (2 layers, fp32, full width): engine tokens equal "
          f"per-request greedy_decode for all {len(reqs)} requests "
          f"(greedy baseline {time.perf_counter() - t0:.1f} s)")
    summary["paths"]["lm_serving"]["greedy_identical_2_layers_fp32"] = True
    del params_c, heads_c, model_c
    torch.cuda.empty_cache()
    phase_done("phase 3f")

    # -- Phases 3g, 3h, 3m and 3n: prefill forwards at full width ---------
    def moe_flips(routes_a, routes_b) -> list:
        """Picks (token, k) whose expert differs between two routings,
        layer by layer."""
        return [int((ra["idx"] != rb["idx"]).sum())
                for ra, rb in zip(routes_a, routes_b)]

    @contextlib.contextmanager
    def recorded_routes(sink):
        """Each ``moe.dispatch_slots`` call's ``{"idx": expert ids,
        "keep": kept picks}`` appended to ``sink``, in call order."""
        slots = lm_moe.dispatch_slots

        def record_slots(gate_idx, mcfg, t):
            pos, keep = slots(gate_idx, mcfg, t)
            sink.append({"idx": gate_idx, "keep": keep})
            return pos, keep

        with mock.patch.object(lm_moe, "dispatch_slots", record_slots):
            yield sink

    @contextlib.contextmanager
    def replayed_routes(recorded):
        """``moe.route`` with each call's expert ids taken, in order, from
        ``recorded`` (one entry an MoE layer); the gates are the path's
        own probabilities at those ids, renormalised as ``route`` does."""
        calls = iter(recorded)
        route = lm_moe.route

        def replay(p_, mcfg, xt):
            probs, _, _ = route(p_, mcfg, xt)
            idx = next(calls)["idx"]
            vals = probs.gather(1, idx)
            return probs, vals / torch.clamp(vals.sum(-1, keepdim=True),
                                             min=1e-9), idx

        with mock.patch.object(lm_moe, "route", replay):
            yield

    def prefill_cell(path, arch, batch_seq, kernel_kw, plain_kw, expect,
                     cut=None, patches=False, draws=None):
        """``forward(last_only=True)`` through the kernels, then the same
        weights through the plain paths in bf16 and in fp32 (each layer's
        weights upcast as the fp32 forward reaches it, so no fp32 copy of
        the model is held).  The kernel path's gap to the fp32 logits may
        be at most twice the bf16 plain path's.  ``cut``: ``(layers,
        reason)`` keeps the first layers of the published depth, widths as
        published.  ``patches``: a fusion batch, ``patch_frac`` of the
        positions at random (a scattered mask) taking patch embeddings.
        An MoE config's routing is recorded on every path: the kernel
        path's dropped share of picks and, layer by layer, its picks that
        differ from the fp32 path's (and the bf16 plain path's).  A pick
        that flips changes its token's output wholesale, so the same bar
        is also held with the fp32 path's picks replayed on both bf16
        paths (``replayed_routes``), where only the arithmetic differs.
        ``draws``: the generator of the cell's inputs (default ``gen``)."""
        draws = gen if draws is None else draws
        cfg = dataclasses.replace(get_arch(arch), **kernel_kw)
        b_, s_ = batch_seq
        if cut is not None:
            full_gib = cfg.n_params() * 2 / 2**30
            cfg = dataclasses.replace(cfg, n_layers=cut[0])
            print(f"  depth cut from {get_arch(arch).n_layers} to {cut[0]} "
                  f"layers (all of them: {full_gib:.0f} GiB of bf16 "
                  f"weights; cut: {cfg.n_params() * 2 / 2**30:.1f} GiB): "
                  f"{cut[1]}")
        moe_cell = cfg.n_experts > 0
        print(f"  {cfg.name} CONFIG: {cfg.n_layers} layers, d="
              f"{cfg.d_model}, vocab {cfg.vocab}, {cfg.param_dtype}, "
              f"{kernel_kw}; forward(last_only=True) on {b_} x {s_} tokens")
        # The reckoning before the run: bf16 weights, one layer in fp32
        # (the fp32 pass), the bf16 plain path's (B, H, S, S) fp32 scores
        # with their bf16 probabilities.
        per_layer = (cfg.n_params() - 2 * cfg.vocab * cfg.d_model) \
            / cfg.n_layers
        reckon = (cfg.n_params() * 2 + per_layer * 4
                  + b_ * cfg.n_heads * s_ * s_ * 6.0) / 2**30
        print(f"  reckoned peak: {reckon:.1f} GiB above the live set "
              f"(weights {cfg.n_params() * 2 / 2**30:.1f}, one fp32 layer "
              f"{per_layer * 4 / 2**30:.1f}, plain scores "
              f"{b_ * cfg.n_heads * s_ * s_ * 6.0 / 2**30:.1f})")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        live0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        model = get_model(cfg)
        params = model.init(SEED, device=dev)
        n_par = sum(p_.numel() for p_ in params.parameters())
        torch.cuda.synchronize()
        print(f"  {n_par / 1e9:.2f} B random parameters "
              f"({n_par * params.embed.element_size() / 2**30:.1f} GiB) on "
              f"the card in {time.perf_counter() - t0:.1f} s")
        toks = torch.randint(0, cfg.vocab, (b_, s_), generator=draws).to(dev)
        batch = {"tokens": toks}
        if patches:
            n_pat = int(s_ * cfg.patch_frac)
            mask = torch.zeros((b_, s_), dtype=torch.bool)
            for row in range(b_):
                mask[row, torch.randperm(s_, generator=draws)[:n_pat]] = True
            batch["patch_mask"] = mask.to(dev)
            batch["patch_embeds"] = (0.1 * torch.randn(
                b_, n_pat, cfg.d_model, generator=draws).to(dev)).to(
                torch.bfloat16)
            first = int(mask[0].nonzero()[0])
            print(f"  fusion: {n_pat} patches a row at random positions "
                  f"(row 0's first at {first}), projected by patch_proj")
        model.forward(params, {"tokens": toks[:, :64]}, last_only=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
        dispatch.reset_launches()
        t0 = time.perf_counter()
        with recorded_routes([]) as routes_k:
            logits_k = model.forward(params, batch, last_only=True)[0]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(dispatch.LAUNCHES)
        _, mem_text = memory_line(torch, live)
        record(path, wall, live, launches=launches, tok_per_s=b_ * s_ / wall,
               n_params=n_par, n_layers=cfg.n_layers)
        print(f"  launches: {launches}")
        print(f"  wall {wall:.3f} s ({b_ * s_ / wall:.0f} tokens/s), "
              f"{mem_text}")
        for name, n in expect.items():
            require(launches[name] == n, f"{path}: {name} launched "
                    f"{launches[name]} times, not {n}")
        require(tuple(logits_k.shape) == (b_, 1, cfg.vocab)
                and bool(torch.isfinite(logits_k).all()),
                f"{path}: logits are not finite (B, 1, vocab)")
        plain_model = get_model(dataclasses.replace(cfg, **plain_kw))
        t0 = time.perf_counter()
        with recorded_routes([]) as routes_p:
            logits_p = plain_model.forward(params, batch, last_only=True)[0]
        torch.cuda.synchronize()
        wall_p = time.perf_counter() - t0
        cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                    act_dtype="float32", **plain_kw)
        h = lm_T.embed(cfg32, params, toks, batch.get("patch_embeds"),
                       batch.get("patch_mask"))
        positions = torch.arange(s_, device=dev)[None].expand(b_, s_)
        with recorded_routes([]) as routes_32:
            for block in params.layers:
                block32 = copy.deepcopy(block).float()
                h, _ = lm_T.block_apply(cfg32, block.kind, block32, h,
                                        positions)
                del block32
        h = lm_layers.rms_norm(h[:, -1:], params.final_norm.float())
        logits_32 = h @ params.head.float()
        scale = float(logits_32.abs().max())
        gap_k = max_err(torch, logits_k.float(), logits_32) / scale
        gap_p = max_err(torch, logits_p.float(), logits_32) / scale
        print(f"  last-position logits against the fp32 plain forward: "
              f"kernel path {gap_k:.4e}, bf16 plain path ({plain_kw}, "
              f"{wall_p:.3f} s) {gap_p:.4e} of max|logit| {scale:.3e}; the "
              f"kernel path's may be at most 2x the plain path's")
        summary["paths"][path].update(plain_wall_s=wall_p, gap_kernel=gap_k,
                                      gap_plain_bf16=gap_p)
        if moe_cell:
            picks = b_ * s_ * cfg.moe_top_k
            dropped = [1.0 - float(r["keep"].float().mean())
                       for r in routes_k]
            flips_k = moe_flips(routes_k, routes_32)
            flips_p = moe_flips(routes_p, routes_32)
            last = torch.arange(1, b_ + 1, device=dev) * s_ - 1
            last_k, last_p = (
                sum(int((ra["idx"][last] != rb["idx"][last]).sum())
                    for ra, rb in zip(routes, routes_32))
                for routes in (routes_k, routes_p))
            print(f"  MoE routing, {len(routes_k)} layers x {picks} picks "
                  f"(top-{cfg.moe_top_k} of {cfg.n_experts}, capacity "
                  f"{lm_moe.capacity_of(lm_T.moe_config(cfg), b_ * s_)[1]} "
                  f"a chunk): dropped share by layer "
                  f"{[round(d, 4) for d in dropped]}; picks that differ "
                  f"from the fp32 path by layer: kernel path {flips_k}, "
                  f"bf16 plain path {flips_p}; at the last positions (the "
                  f"logits compared), over all layers: {last_k} and "
                  f"{last_p}")
            with replayed_routes(routes_32):
                logits_kr = model.forward(params, batch, last_only=True)[0]
            with replayed_routes(routes_32):
                logits_pr = plain_model.forward(params, batch,
                                                last_only=True)[0]
            gap_kr = max_err(torch, logits_kr.float(), logits_32) / scale
            gap_pr = max_err(torch, logits_pr.float(), logits_32) / scale
            print(f"  with the fp32 path's picks replayed on both bf16 "
                  f"paths: kernel path {gap_kr:.4e}, bf16 plain path "
                  f"{gap_pr:.4e} of max|logit|; the kernel path's may be "
                  f"at most 2x the plain path's")
            require(gap_kr <= 2 * gap_pr, f"{path}: with the fp32 picks, "
                    f"kernel path {gap_kr:.3e} > 2 x plain {gap_pr:.3e}")
            summary["paths"][path].update(
                dropped_share=dropped, flips_kernel_vs_fp32=flips_k,
                flips_plain_vs_fp32=flips_p, last_flips_kernel=last_k,
                last_flips_plain=last_p, gap_kernel_fp32_picks=gap_kr,
                gap_plain_fp32_picks=gap_pr)
            del logits_kr, logits_pr
        require(gap_k <= 2 * gap_p, f"{path}: kernel path {gap_k:.3e} > 2 x "
                f"plain {gap_p:.3e} from the fp32 logits")
        del params, model, logits_k, logits_p, logits_32, h
        del routes_k, routes_p, routes_32
        torch.cuda.empty_cache()
        peak = torch.cuda.max_memory_allocated()
        summary["paths"][path]["cell_peak_above_live_gib"] = \
            (peak - live0) / 2**30
        summary["paths"][path]["reckoned_peak_gib"] = reckon
        print(f"  the cell's peak: {(peak - live0) / 2**30:.2f} GiB above "
              f"the {live0 / 2**30:.2f} GiB live before it (reckoned "
              f"{reckon:.1f})")
        return launches

    print("[3g] dense prefill: the flash kernel on every attention layer")
    launches_g = prefill_cell(
        "prefill_dense", "qwen3_1_7b", DENSE_PREFILL, {"attn_impl": "pallas"},
        {"attn_impl": "jnp"}, {"flash_attention": 28})
    phase_done("phase 3g")
    print("[3h] hybrid prefill: the linear scan on every rec layer, the "
          "flash kernel (window 2048) on every attention layer")
    launches_h = prefill_cell(
        "prefill_hybrid", "recurrentgemma_9b", HYBRID_PREFILL,
        {"attn_impl": "pallas", "rec_impl": "pallas"},
        {"attn_impl": "jnp", "rec_impl": "scan"},
        {"flash_attention": 12, "linear_scan": 26})
    phase_done("phase 3h")

    # -- Phases 3m-3o: the rest of the zoo at full width (inputs from
    # zoo_gen) ------------------------------------------------------------
    t_zoo = time.perf_counter()

    def decode_check(name, model, params, batch, step, state):
        """``ZOO_DECODE_STEPS`` decode steps against the teacher-forced
        forward of the same tokens, at the reference's bar
        (``tests/test_arch_smoke.py``: atol 5e-3, rtol 1e-3)."""
        toks = batch["tokens"]
        full = model.forward(params, batch)[0]
        outs = []
        for t in range(toks.shape[1]):
            lg, state = step(params, toks[:, t:t + 1], state)
            outs.append(lg)
        dec = torch.cat(outs, dim=1)
        gap = (dec - full).abs()
        worst = float((gap - DECODE_RTOL * full.abs()).max())
        print(f"  {name}: {toks.shape[1]} decode steps against the "
              f"teacher-forced forward: max|decode - forward| "
              f"{float(gap.max()):.3e} (max|logit| "
              f"{float(full.abs().max()):.3e}; bar atol {DECODE_ATOL:g} + "
              f"rtol {DECODE_RTOL:g} |forward|)")
        require(bool(torch.isfinite(dec).all()) and worst <= DECODE_ATOL,
                f"{name}: decode differs from the forward beyond the bar")
        return float(gap.max())

    print("[3m] MoE prefill: phi3_5_moe, the flash kernel on every "
          "attention layer, 16 experts top-2")
    launches_m = prefill_cell(
        "prefill_moe", "phi3_5_moe", MOE_PREFILL, {"attn_impl": "pallas"},
        {"attn_impl": "jnp"}, {"flash_attention": MOE_LAYERS},
        cut=(MOE_LAYERS, "one 80 GB card holds 4 layers with the fp32 "
             "layer copies and the plain path's attention scores"),
        draws=zoo_gen)
    cfg_md = dataclasses.replace(
        get_arch("phi3_5_moe"), n_layers=ZOO_DECODE_LAYERS,
        param_dtype="float32", act_dtype="float32", attn_impl="pallas",
        capacity_factor=float(get_arch("phi3_5_moe").n_experts))
    model_md = get_model(cfg_md)
    params_md = model_md.init(SEED, device=dev)
    toks_md = torch.randint(0, cfg_md.vocab, (2, ZOO_DECODE_STEPS),
                            generator=zoo_gen).to(dev)
    gap_md = decode_check(
        f"phi3_5_moe at full width, {ZOO_DECODE_LAYERS} layers, fp32, "
        f"drop-free capacity (capacity_factor {cfg_md.capacity_factor:g})",
        model_md, params_md, {"tokens": toks_md}, model_md.decode_step,
        model_md.init_decode_state(2, 2 * ZOO_DECODE_STEPS, device=dev))
    summary["paths"]["prefill_moe"]["decode_vs_forward_max_abs"] = gap_md
    del model_md, params_md
    torch.cuda.empty_cache()
    phase_done("phase 3m")

    print("[3n] early-fusion VLM prefill: llama4_scout, patches scattered "
          "over the tokens, 16 experts top-1, the flash kernel on every "
          "attention layer")
    launches_n = prefill_cell(
        "prefill_fusion", "llama4_scout", FUSION_PREFILL,
        {"attn_impl": "pallas"}, {"attn_impl": "jnp"},
        {"flash_attention": FUSION_LAYERS},
        cut=(FUSION_LAYERS, "one 80 GB card holds 2 layers with the "
             "202,048-token embedding and head, the fp32 layer copies and "
             "the plain path's attention scores"), patches=True,
        draws=zoo_gen)
    phase_done("phase 3n")

    print("[3o] encoder-decoder: seamless_m4t_v2 CONFIG whole (24 + 24 "
          "layers), the flash kernel on encoder, decoder and cross "
          "attention")
    cfg_o = dataclasses.replace(get_arch("seamless_m4t_v2"),
                                attn_impl="pallas")
    model_o = get_model(cfg_o)
    (fb, fs), (tb, ts) = ENCDEC_FRAMES, ENCDEC_TOKENS
    print(f"  {cfg_o.name} CONFIG: {cfg_o.encoder_layers} + "
          f"{cfg_o.n_layers} layers, d={cfg_o.d_model}, vocab "
          f"{cfg_o.vocab}, {cfg_o.param_dtype}; forward(last_only=True) on "
          f"frames ({fb}, {fs}, {cfg_o.d_model}) and tokens ({tb}, {ts})")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live0 = torch.cuda.memory_allocated()
    params_o = model_o.init(SEED, device=dev)
    n_par_o = sum(p_.numel() for p_ in params_o.parameters())
    print(f"  {n_par_o / 1e9:.2f} B random parameters "
          f"({n_par_o * 2 / 2**30:.1f} GiB); reckoned peak "
          f"{n_par_o * 6 / 2**30:.1f} GiB above the live set (the bf16 "
          f"weights and their fp32 copy)")
    batch_o = {"frames": (0.1 * zoo_randn(fb, fs, cfg_o.d_model)).to(
                   torch.bfloat16),
               "tokens": torch.randint(0, cfg_o.vocab, (tb, ts),
                                       generator=zoo_gen).to(dev)}
    model_o.forward(params_o, {"frames": batch_o["frames"][:, :64],
                               "tokens": batch_o["tokens"][:, :64]},
                    last_only=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    dispatch.reset_launches()
    t0 = time.perf_counter()
    logits_ok = model_o.forward(params_o, batch_o, last_only=True)[0]
    torch.cuda.synchronize()
    wall_o = time.perf_counter() - t0
    launches_o = dict(dispatch.LAUNCHES)
    _, mem_text = memory_line(torch, live)
    record("encdec", wall_o, live, launches=launches_o,
           tok_per_s=(fb * fs + tb * ts) / wall_o, n_params=n_par_o)
    print(f"  launches: {launches_o}")
    print(f"  wall {wall_o:.3f} s ({(fb * fs + tb * ts) / wall_o:.0f} frames "
          f"+ tokens/s), {mem_text}")
    n_flash_o = cfg_o.encoder_layers + 2 * cfg_o.n_layers
    require(launches_o["flash_attention"] == n_flash_o,
            f"3o: flash_attention launched {launches_o['flash_attention']} "
            f"times, not {n_flash_o}")
    require(tuple(logits_ok.shape) == (tb, 1, cfg_o.vocab)
            and bool(torch.isfinite(logits_ok).all()),
            "3o: logits are not finite (B, 1, vocab)")
    t0 = time.perf_counter()
    logits_op = get_model(dataclasses.replace(cfg_o, attn_impl="jnp")
                          ).forward(params_o, batch_o, last_only=True)[0]
    torch.cuda.synchronize()
    wall_op = time.perf_counter() - t0
    cfg_o32 = dataclasses.replace(cfg_o, param_dtype="float32",
                                  act_dtype="float32", attn_impl="jnp")
    params_o32 = copy.deepcopy(params_o).float()
    del params_o
    logits_o32 = get_model(cfg_o32).forward(params_o32, batch_o,
                                            last_only=True)[0]
    scale = float(logits_o32.abs().max())
    gap_ok = max_err(torch, logits_ok.float(), logits_o32) / scale
    gap_op = max_err(torch, logits_op.float(), logits_o32) / scale
    print(f"  last-position logits against the fp32 plain forward: kernel "
          f"path {gap_ok:.4e}, bf16 plain path ({wall_op:.3f} s) "
          f"{gap_op:.4e} of max|logit| {scale:.3e}; the kernel path's may "
          f"be at most 2x the plain path's")
    require(gap_ok <= 2 * gap_op, f"3o: kernel path {gap_ok:.3e} > 2 x plain "
            f"{gap_op:.3e} from the fp32 logits")
    summary["paths"]["encdec"].update(plain_wall_s=wall_op, gap_kernel=gap_ok,
                                      gap_plain_bf16=gap_op)
    del logits_ok, logits_op, logits_o32
    # fp32, whole depth: encode once, the cross memory of every decoder
    # layer, then decode steps against the teacher-forced forward (the
    # kernel path: the fp32 flash kernel).
    cfg_o32k = dataclasses.replace(cfg_o32, attn_impl="pallas")
    model_o32 = get_model(cfg_o32k)
    frames_d = batch_o["frames"][:, :fs].float()
    toks_d = batch_o["tokens"][:, :ZOO_DECODE_STEPS]
    state_o = lm_encdec.decode_state_from_memory(
        cfg_o32k, params_o32, lm_encdec.encode(cfg_o32k, params_o32,
                                               frames_d))
    gap_od = decode_check(
        f"seamless_m4t_v2 whole, fp32: encode, decode_state_from_memory "
        f"(frames {tuple(frames_d.shape)})", model_o32, params_o32,
        {"frames": frames_d, "tokens": toks_d}, model_o32.decode_step,
        state_o)
    summary["paths"]["encdec"]["decode_vs_forward_max_abs"] = gap_od
    del params_o32, state_o
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated()
    summary["paths"]["encdec"]["cell_peak_above_live_gib"] = \
        (peak - live0) / 2**30
    print(f"  the cell's peak: {(peak - live0) / 2**30:.2f} GiB above the "
          f"{live0 / 2**30:.2f} GiB live before it")
    phase_done("phase 3o")
    summary["zoo_s"] = time.perf_counter() - t_zoo
    print(f"  phases 3m-3o took {summary['zoo_s']:.1f} s")

    # -- Phase 3i: MT-HFL (Algorithm 1) on the raw cell's labels ----------
    print("[3i] MT-HFL: train_mthfl on phase 3c's users and on-card labels, "
          "the paper CNN at CONFIG width, Fig. 2 settings")
    fig2 = MTHFLConfig(global_rounds=TRAIN_ROUNDS, local_rounds=1,
                       local_steps=12, batch_size=32,
                       client=ClientConfig(lr=0.01, optimizer="momentum"))
    check_cfg = dataclasses.replace(fig2, global_rounds=TRAIN_CHECK_ROUNDS)
    task_of = {c: t for t, cs in CIFAR_TASKS.items() for c in cs}

    def cnn_model(n_classes):
        c = dataclasses.replace(paper_cnn.CONFIG, n_classes=n_classes)
        return TaskModel(
            init=lambda g, c=c: cnn.init(c, g), loss_fn=cnn.loss_fn(c),
            accuracy=lambda p, x, y, c=c: cnn.accuracy(c, p, x, y),
            is_common=fed_part.prefix_predicate(cnn.COMMON_PREFIXES))

    def eval_set(classes, local=True):
        x, y = make_task_dataset(CIFAR_LIKE, list(classes),
                                 TRAIN_EVAL_PER_CLASS, seed=TRAIN_EVAL_SEED,
                                 task_of_class={c: task_of[classes[0]]
                                                for c in classes})
        lut = {c: i for i, c in enumerate(classes)}
        return x, (np.asarray([lut[int(v)] for v in y], np.int32) if local
                   else y)

    def paper_setup(users, labels):
        """Per cluster, its members' majority task's classes (as the
        trainer infers them), a head of that width and its eval set."""
        classes = infer_cluster_classes(users, np.asarray(labels), 2)
        return (classes, [cnn_model(len(c)) for c in classes],
                [eval_set(c) for c in classes])

    def loss_gaps(a, b):
        """Per round, the largest train-loss gap x max(1, |loss|)."""
        return np.max(np.abs(a.train_loss - b.train_loss) / np.maximum(
            1.0, np.abs(b.train_loss)), axis=1)

    def train_gaps(a, b, n_eval):
        samples = np.abs(a.accuracy - b.accuracy) * np.asarray(n_eval)
        return float(np.max(loss_gaps(a, b))), float(np.max(samples))

    @contextlib.contextmanager
    def tf32_scope():
        """``fed/client.py::fp32_scope`` with TF32 allowed in cuDNN and
        cuBLAS: the negative control of 3i(a)'s first-round bar."""
        matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
        try:
            torch.backends.cuda.matmul.allow_tf32 = True
            with torch.backends.cudnn.flags(
                    enabled=True, benchmark=False, deterministic=True,
                    allow_tf32=True):
                yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul_tf32

    def nudged_models(models, seed):
        return [dataclasses.replace(
            m, init=lambda g, m=m, s=seed + i: nudged(torch, m.init(g), s))
            for i, m in enumerate(models)]

    def train_bars(base, n_eval, models, *args, **kw):
        """The spread of ``base`` (a card run) under NUDGE_RUNS runs from
        nudged initial weights, and the bars it sets: ``(loss spread,
        sample spread, loss limit, sample limit)``."""
        spread = [train_gaps(train_mthfl(args[0], args[1],
                                         nudged_models(models, 100 * r),
                                         *args[2:], **kw), base, n_eval)
                  for r in range(1, NUDGE_RUNS + 1)]
        loss_s = max(g[0] for g in spread)
        samples_s = max(g[1] for g in spread)
        return (loss_s, samples_s,
                max(TRAIN_LOSS_TOL, SPREAD_FACTOR * loss_s),
                max(1.0, SPREAD_FACTOR * samples_s))

    def timed_train(*args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        hist = train_mthfl(*args, **kw)
        torch.cuda.synchronize()
        return hist, time.perf_counter() - t

    dispatch.reset_launches()
    # (a) card against the port's CPU run, on 32 users a task.
    pick = np.concatenate([np.flatnonzero(raw_tasks == t)[:TRAIN_CHECK_USERS]
                           for t in (0, 1)])
    sub_users = [raw_users[i] for i in pick]
    sub_labels = labels_r[pick]
    classes_a, models_a, evals_a = paper_setup(sub_users, sub_labels)
    n_eval_a = [len(e[1]) for e in evals_a]
    hist_card, wall_card = timed_train(sub_users, sub_labels, models_a,
                                       evals_a, check_cfg, device=dev)
    t0 = time.perf_counter()
    hist_cpu = train_mthfl(sub_users, sub_labels, models_a, evals_a,
                           check_cfg, device="cpu")
    wall_cpu = time.perf_counter() - t0
    loss_gap_a, acc_gap_a = train_gaps(hist_card, hist_cpu, n_eval_a)
    rounds_a = loss_gaps(hist_card, hist_cpu)
    bars_a = train_bars(hist_card, n_eval_a, models_a, sub_users,
                        sub_labels, evals_a, check_cfg, device=dev)
    # The first round has had little room for the spread to grow, so it is
    # held to the floor alone (TRAIN_LOSS_TOL); with TF32 allowed in the
    # trainer's scope the same round must miss that floor.
    with mock.patch.object(fed_client, "fp32_scope", tf32_scope):
        hist_tf32 = train_mthfl(sub_users, sub_labels, models_a, evals_a,
                                check_cfg, device=dev)
    rounds_tf32 = loss_gaps(hist_tf32, hist_cpu)
    print(f"  (a) {len(pick)} users, {TRAIN_CHECK_ROUNDS} rounds, heads "
          f"{[len(c) for c in classes_a]}, fused {hist_card.fused}: card "
          f"{wall_card:.3f} s, CPU {wall_cpu:.3f} s; largest train-loss gap "
          f"{loss_gap_a:.3e} x max(1, |loss|) (limit {bars_a[2]:.3e}; the "
          f"card's own spread under a nudge {bars_a[0]:.3e}), largest "
          f"accuracy gap {acc_gap_a:.0f} eval samples (limit "
          f"{bars_a[3]:.0f}; spread {bars_a[1]:.0f})")
    print(f"      card losses {hist_card.train_loss.tolist()}")
    print(f"      train-loss gap by round {rounds_a.tolist()} (round 1 "
          f"limit {TRAIN_LOSS_TOL:g}); with TF32 allowed "
          f"{rounds_tf32.tolist()} (round 1 must exceed {TRAIN_LOSS_TOL:g})")
    require(loss_gap_a <= bars_a[2] and acc_gap_a <= bars_a[3] + 1e-6
            and rounds_a[0] <= TRAIN_LOSS_TOL,
            "3i(a): the card's train_mthfl disagrees with the CPU run")
    require(rounds_tf32[0] > TRAIN_LOSS_TOL,
            "3i(a): the first-round bar does not catch TF32 in training")
    # cuDNN runs with deterministic algorithms in the trainer's scope
    # (fed/client.py::fp32_scope): a second card run gives the same bits.
    hist_again, _ = timed_train(sub_users, sub_labels, models_a, evals_a,
                                check_cfg, device=dev)
    same_bits = (np.array_equal(hist_again.train_loss, hist_card.train_loss)
                 and np.array_equal(hist_again.accuracy, hist_card.accuracy))
    print(f"      a second card run gives the same history bit for bit: "
          f"{same_bits}")
    require(same_bits, "3i(a): two card runs of train_mthfl differ")

    # (b) fused against loop on the card: every user, 10-class heads.
    all_classes = [list(range(10))] * 2
    models_b = [cnn_model(10), cnn_model(10)]
    evals_b = [eval_set(c, local=False)
               for c in infer_cluster_classes(raw_users, labels_r, 2)]
    n_eval_b = [len(e[1]) for e in evals_b]
    hist_fused, wall_fused = timed_train(
        raw_users, labels_r, models_b, evals_b, check_cfg,
        cluster_classes=all_classes, fused=True, device=dev)
    hist_loop, wall_loop = timed_train(
        raw_users, labels_r, models_b, evals_b, check_cfg,
        cluster_classes=all_classes, fused=False, device=dev)
    loss_gap_b, acc_gap_b = train_gaps(hist_fused, hist_loop, n_eval_b)
    bars_b = train_bars(hist_fused, n_eval_b, models_b, raw_users, labels_r,
                        evals_b, check_cfg, cluster_classes=all_classes,
                        fused=True, device=dev)
    steps_b = n_raw * check_cfg.local_steps * TRAIN_CHECK_ROUNDS
    print(f"  (b) {n_raw} users, {TRAIN_CHECK_ROUNDS} rounds, 10-class heads: "
          f"fused {hist_fused.fused} {wall_fused:.3f} s "
          f"({steps_b / wall_fused:.0f} client-steps/s), loop "
          f"{hist_loop.fused} {wall_loop:.3f} s "
          f"({steps_b / wall_loop:.0f} client-steps/s); largest train-loss "
          f"gap {loss_gap_b:.3e} (limit {bars_b[2]:.3e}; the fused run's "
          f"own spread under a nudge {bars_b[0]:.3e}), largest accuracy gap "
          f"{acc_gap_b:.0f} eval samples (limit {bars_b[3]:.0f}; spread "
          f"{bars_b[1]:.0f})")
    require(hist_fused.fused and not hist_loop.fused
            and loss_gap_b <= bars_b[2] and acc_gap_b <= bars_b[3] + 1e-6,
            "3i(b): the fused trainer disagrees with the loop")
    # One traced fused round: the device's busy share and the kernels that
    # take its time (the vmapped convolutions run as grouped convolutions,
    # one group a client).  Only device activity is traced.  The busy share
    # is the union of the kernels' intervals over their span, both on the
    # profiler's clock, so that neither that clock's rate nor overlapping
    # kernels move it; the span is printed beside the span two CUDA events
    # give, which shows events the profiler dropped at the start.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    one_round = dataclasses.replace(check_cfg, global_rounds=1)
    ev_start = torch.cuda.Event(enable_timing=True)
    ev_end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ev_start.record()
        _, traced_wall_i = timed_train(raw_users, labels_r, models_b,
                                       evals_b, one_round,
                                       cluster_classes=all_classes,
                                       fused=True, device=dev)
        ev_end.record()
        torch.cuda.synchronize()
    events_span_i = ev_start.elapsed_time(ev_end) / 1e3
    spans = [(e.time_range.start, e.time_range.end)
             for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_share_i, span_i = busy_share(spans)
    kernels_i = sorted(
        ((getattr(e, "self_device_time_total",
                  getattr(e, "self_cuda_time_total", 0)) / 1e6, e.key)
         for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
        reverse=True)
    total_i = sum(sec for sec, _ in kernels_i)
    print(f"  traced fused round ({n_raw} users): wall {traced_wall_i:.3f} s; "
          f"device busy {busy_share_i:.1%} of the kernels' span "
          f"({len(spans)} kernels and copies over {span_i:.3f} s on the "
          f"profiler's clock, {events_span_i:.3f} s between CUDA events); "
          f"largest kernels by share of kernel time:")
    for sec, name in kernels_i[:6]:
        print(f"      {sec / total_i:6.1%} {name[:90]}")
    # (c) the paper's comparison: one-shot labels against random ones.
    sizes_r = np.bincount(labels_r, minlength=2)
    labels_rand = clu.random_clusters(n_raw, 2, rng=0,
                                      cluster_sizes=list(sizes_r))
    runs_c = {}
    for name, labels_c in (("one_shot", res_r.labels),
                           ("random", labels_rand)):
        classes_c, models_c, evals_c = paper_setup(
            raw_users, labels_c.cpu().numpy() if torch.is_tensor(labels_c)
            else labels_c)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
        hist, wall = timed_train(raw_users, labels_c, models_c, evals_c,
                                 fig2, fused="auto", device=dev)
        peak, mem_text = memory_line(torch, live)
        steps_c = n_raw * fig2.local_steps * fig2.local_rounds * TRAIN_ROUNDS
        runs_c[name] = dict(
            wall_s=wall, s_per_round=wall / TRAIN_ROUNDS,
            client_steps_per_s=steps_c / wall, fused=hist.fused,
            heads=[len(c) for c in classes_c],
            final_accuracy=hist.accuracy[-1].tolist(),
            mean_final_accuracy=float(np.mean(hist.accuracy[-1])),
            train_loss=hist.train_loss.tolist(),
            above_live_gib=(peak - live) / 2**30)
        print(f"  (c) {name} labels, {TRAIN_ROUNDS} rounds, heads "
              f"{runs_c[name]['heads']}, fused {hist.fused}: wall {wall:.3f} s"
              f", {wall / TRAIN_ROUNDS:.3f} s a global round, "
              f"{steps_c / wall:.0f} client-steps/s, {mem_text}")
        print(f"      final per-cluster accuracy "
              f"{hist.accuracy[-1].round(4).tolist()}, mean train loss by "
              f"round {hist.train_loss.mean(axis=1).round(4).tolist()}")
        require(np.isfinite(hist.train_loss).all(),
                f"3i(c): a {name} train loss is not finite")
    one_shot_loss = np.mean(runs_c["one_shot"]["train_loss"], axis=1)
    require(one_shot_loss[-1] < one_shot_loss[0],
            "3i(c): the one-shot run's mean train loss did not fall")
    beats = (runs_c["one_shot"]["mean_final_accuracy"]
             > runs_c["random"]["mean_final_accuracy"])
    print(f"  one-shot labels beat random ones (mean final accuracy): "
          f"{beats} (reported, not required)")
    launches_i = dict(dispatch.LAUNCHES)
    print(f"  hand-written kernel launches while training: {launches_i} "
          f"(the trainer's convolutions and products are library calls)")
    summary["mthfl"] = dict(
        card_vs_cpu=dict(users=len(pick), loss_gap=loss_gap_a,
                         acc_gap_samples=acc_gap_a, nudge_spread=bars_a[:2],
                         loss_gap_by_round=rounds_a.tolist(),
                         tf32_loss_gap_by_round=rounds_tf32.tolist(),
                         card_s=wall_card, cpu_s=wall_cpu),
        fused_vs_loop=dict(users=n_raw, loss_gap=loss_gap_b,
                           acc_gap_samples=acc_gap_b,
                           nudge_spread=bars_b[:2], fused_s=wall_fused,
                           loop_s=wall_loop,
                           fused_client_steps_per_s=steps_b / wall_fused,
                           loop_client_steps_per_s=steps_b / wall_loop,
                           traced_round_s=traced_wall_i,
                           traced_busy_share=busy_share_i,
                           traced_profiler_span_s=span_i,
                           traced_events_span_s=events_span_i,
                           top_kernels=[[name[:60], sec / total_i]
                                        for sec, name in kernels_i[:6]]),
        paper=runs_c, one_shot_beats_random=bool(beats))
    phase_done("phase 3i")

    # -- Phase 3j: the IFCA baseline --------------------------------------
    print(f"[3j] IFCA: run_ifca on {2 * IFCA_USERS} of phase 3c's users, the "
          f"paper CNN at CONFIG width, 10-class global labels, "
          f"{IFCA_ROUNDS} rounds, card against CPU")
    pick_j = np.concatenate([np.flatnonzero(raw_tasks == t)[:IFCA_USERS]
                             for t in (0, 1)])
    users_j = [raw_users[i] for i in pick_j]
    cfg_j = fed_ifca.IFCAConfig(n_clusters=2, rounds=IFCA_ROUNDS)
    init_j = [cnn.init(paper_cnn.CONFIG, torch.Generator().manual_seed(s))
              for s in range(2)]
    ifca_args = (users_j, lambda g: cnn.init(paper_cnn.CONFIG, g),
                 cnn.loss_fn(paper_cnn.CONFIG), lambda u: u.y, cfg_j)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_j = fed_ifca.run_ifca(*ifca_args, init_params=init_j, device=dev)
    torch.cuda.synchronize()
    wall_j = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_j_cpu = fed_ifca.run_ifca(*ifca_args, init_params=init_j,
                                  device="cpu")
    wall_j_cpu = time.perf_counter() - t0

    def param_gap(got, want):
        return max(float((a[k].cpu() - b[k].cpu()).abs().max())
                   / max(float(b[k].abs().max()) for k in b)
                   for a, b in zip(got.final_params, want.final_params)
                   for k in b)

    gap_j = param_gap(res_j, res_j_cpu)
    spread_j = max(param_gap(fed_ifca.run_ifca(
        *ifca_args, init_params=[nudged(torch, p, 100 * r + i)
                                 for i, p in enumerate(init_j)],
        device=dev), res_j) for r in range(1, NUDGE_RUNS + 1))
    limit_j = max(IFCA_PARAM_TOL, SPREAD_FACTOR * spread_j)
    # The reference's shape: every user walked one by one (``_alike``
    # false), timed beside the vmapped run (reported, not required).
    with mock.patch.object(fed_ifca, "_alike", lambda _: False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res_j_loop = fed_ifca.run_ifca(*ifca_args, init_params=init_j,
                                       device=dev)
        torch.cuda.synchronize()
        wall_j_loop = time.perf_counter() - t0
    gap_j_loop = param_gap(res_j_loop, res_j)
    same_assign = np.array_equal(res_j.assignments, res_j_cpu.assignments)
    acc_j = [clu.clustering_accuracy(a, raw_tasks[pick_j])
             for a in res_j.assignments]
    print(f"  card {wall_j:.3f} s ({wall_j / IFCA_ROUNDS:.3f} s a round), "
          f"CPU {wall_j_cpu:.3f} s; assignments equal every round "
          f"{same_assign}; final parameters within {gap_j:.3e} x "
          f"max|param| of the CPU run (limit {limit_j:.3e}; the card's own "
          f"spread under a nudge {spread_j:.3e}); clustering accuracy by "
          f"round "
          f"{[round(a, 4) for a in acc_j]}; per_user_bytes_per_round "
          f"{res_j.per_user_bytes_per_round}")
    print(f"  users walked one by one (the reference's shape): card "
          f"{wall_j_loop:.3f} s ({wall_j_loop / IFCA_ROUNDS:.3f} s a round, "
          f"{wall_j_loop / wall_j:.1f}x the vmapped run's); assignments "
          f"equal to it every round "
          f"{np.array_equal(res_j_loop.assignments, res_j.assignments)}, "
          f"final parameters within {gap_j_loop:.3e} x max|param|")
    require(same_assign and gap_j <= limit_j,
            "3j: the card's run_ifca disagrees with the CPU run")
    summary["ifca"] = dict(
        users=len(users_j), rounds=IFCA_ROUNDS, wall_s=wall_j,
        s_per_round=wall_j / IFCA_ROUNDS, cpu_s=wall_j_cpu,
        loop_s=wall_j_loop, loop_param_gap=gap_j_loop,
        param_gap=gap_j, nudge_spread=spread_j, clustering_accuracy=acc_j,
        per_user_bytes_per_round=res_j.per_user_bytes_per_round)
    del res_j, res_j_cpu, res_j_loop
    phase_done("phase 3j")

    # -- Phase 3k: the hierarchical two-level protocol --------------------
    print(f"[3k] hierarchical path: one_shot_clustering(hierarchy_cfg) on "
          f"phase 3's users, G={HIER_GROUPS} edge groups, "
          f"T_g={HIER_GROUP_CLUSTERS}")
    small_h = HierarchyConfig(n_groups=4)
    on_card = one_shot_clustering(small, 4, cfg=cfg_small,
                                  hierarchy_cfg=small_h)
    on_cpu = one_shot_clustering(small, 4, cfg=cfg_small,
                                 hierarchy_cfg=small_h, device="cpu")
    require(torch.equal(on_card.local_labels.cpu(), on_cpu.local_labels)
            and clu.adjusted_rand_index(on_card.labels.cpu().numpy(),
                                        on_cpu.labels.numpy()) == 1.0,
            "3k small input: labels differ from the CPU plain path")
    small_gap = max_err(torch, on_card.entry_lam.cpu(), on_cpu.entry_lam)
    require(small_gap <= 1e-4 * float(on_cpu.entry_lam.max()),
            f"3k small input: entry spectra {small_gap:.3e} from the CPU's")
    print(f"  small input (64 users, d=64, 4 groups): the CPU plain path's "
          f"partition and group-local labels, entry spectra within "
          f"{small_gap:.3e}")
    hcfg = HierarchyConfig(n_groups=HIER_GROUPS,
                           group_clusters=HIER_GROUP_CLUSTERS)
    ng_k = N_USERS // HIER_GROUPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    dispatch.reset_launches()
    t0 = time.perf_counter()
    res_k = one_shot_clustering(x, TASKS, cfg=cfg, cluster_cfg=ccfg,
                                device=dev, hierarchy_cfg=hcfg)
    labels_k = res_k.labels.cpu().numpy()
    wall_k = time.perf_counter() - t0
    launches_k = dict(dispatch.LAUNCHES)
    _, mem_text = memory_line(torch, live)
    acc_k = clu.clustering_accuracy(labels_k, task_ids)
    agree_k = float((greedy_match_labels(labels_k, dense_labels, TASKS)
                     == dense_labels).mean())
    n_entries = HIER_GROUPS * HIER_GROUP_CLUSTERS
    print(f"  launches: {launches_k}")
    print(f"  wall {wall_k:.3f} s, {mem_text} (dense path: "
          f"{dense_work / 2**30:.2f} GiB above its live memory), clustering "
          f"accuracy {acc_k:.1%}, agreement with phase 3's flat labels "
          f"{agree_k:.4f} (required >= 0.95), {HIER_GROUPS} groups -> "
          f"{n_entries} entries -> {TASKS} clusters")
    record("hierarchical", wall_k, live, accuracy=acc_k,
           flat_agreement=agree_k, launches=launches_k)
    require(acc_k == 1.0, f"3k: clustering accuracy {acc_k:.4f} < 1")
    require(agree_k >= 0.95, f"3k: agreement {agree_k:.4f} with the flat "
            "labels < 0.95")
    require(launches_k["eigproject"] == 1 and launches_k["gram"] == 1
            and launches_k["linkage"] == 2,
            "3k: not one gram, eigproject and group NN-chain launch for the "
            "one batch of groups, plus the global NN-chain")
    r_glob = res_k.global_similarity
    require(tuple(r_glob.shape) == (n_entries, n_entries)
            and bool(torch.isfinite(r_glob).all())
            and torch.equal(r_glob, r_glob.T)
            and int(res_k.entry_counts.sum()) == N_USERS
            and tuple(res_k.entry_v.shape) == (n_entries, DIM, TOP_K)
            and bool(torch.isfinite(res_k.entry_lam).all()),
            "3k: the directory is not finite or has the wrong shapes")
    # Stage times, one synchronised stage at a time (contiguous groups:
    # the group stacks are views of phase 3's users).
    stages_k = {}

    def stage_k(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages_k[name] = (time.perf_counter() - t) * 1e3
        return out

    feats_k = x.reshape(HIER_GROUPS * ng_k, N_SAMPLES, DIM)
    grams_k = stage_k("gram", lambda: sim.batched_gram(feats_k))
    lam_k, v_k = stage_k("eigh", lambda: sim.spectrum(grams_k, TOP_K))
    grams_kg = grams_k.view(HIER_GROUPS, ng_k, DIM, DIM)
    v_kg = v_k.view(HIER_GROUPS, ng_k, DIM, TOP_K)
    lam_hat_k = stage_k("cross_projection",
                        lambda: project_norms_grouped(grams_kg, v_kg))

    def group_relevance():
        r_ = sim.relevance(lam_k.view(HIER_GROUPS, ng_k, 1, TOP_K),
                           lam_hat_k, cfg.eig_floor)
        return (r_ + r_.transpose(1, 2)) / 2.0

    big_r_k = stage_k("relevance", group_relevance)
    local_k, _ = stage_k("group_hac_cut", lambda: hierarchy._batched_hac_cut(
        big_r_k, linkage=ccfg.linkage, n_clusters=HIER_GROUP_CLUSTERS))
    entry_k = (torch.arange(HIER_GROUPS, device=dev).repeat_interleave(ng_k)
               * HIER_GROUP_CLUSTERS + local_k.reshape(-1)).long()
    lam_e, v_e, _, _ = stage_k("compress", lambda: hierarchy._compress_entries(
        lam_k, v_k, entry_k, n_entries=n_entries, top_k=TOP_K))
    stage_k("global_stage", lambda: ClusterEngine(ccfg, device=dev).labels(
        sim.signature_relevance(lam_e, v_e, eig_floor=cfg.eig_floor), TASKS))
    print("  stage ms: " + ", ".join(f"{k} {v:.3f}"
                                      for k, v in stages_k.items()))
    summary["paths"]["hierarchical"]["stage_ms"] = stages_k
    del grams_k, grams_kg, lam_hat_k, res_k
    phase_done("phase 3k")

    # -- Phase 3k(b): the hierarchical path at 10^5 users -----------------
    print(f"[3k(b)] hierarchical path at scale: {SCALE_USERS} users x "
          f"{SCALE_SAMPLES} samples, d={SCALE_DIM}, {TASKS} tasks, "
          f"top_k={TOP_K}, G={SCALE_GROUPS}, group_batch={SCALE_BATCH}")
    t0 = time.perf_counter()
    feats_s, tasks_s = make_task_feature_mixture(
        SCALE_USERS, SCALE_SAMPLES, SCALE_DIM, TASKS, seed=SEED)
    x_s = torch.from_numpy(feats_s).to(dev)
    del feats_s
    print(f"  data: {x_s.numel() * 4 / 2**20:.0f} MiB of features on the "
          f"card (made in {time.perf_counter() - t0:.1f} s); the flat R "
          f"would be {4 * SCALE_USERS ** 2 / 2**30:.1f} GiB")
    batches_s = -(-SCALE_GROUPS // SCALE_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    dispatch.reset_launches()
    t0 = time.perf_counter()
    res_s = one_shot_clustering(
        x_s, TASKS, cfg=cfg, cluster_cfg=ccfg, device=dev,
        hierarchy_cfg=HierarchyConfig(n_groups=SCALE_GROUPS,
                                      group_batch=SCALE_BATCH))
    labels_s = res_s.labels.cpu().numpy()
    wall_scale = time.perf_counter() - t0
    launches_scale = dict(dispatch.LAUNCHES)
    _, mem_text = memory_line(torch, live)
    ari_s = clu.adjusted_rand_index(labels_s, tasks_s)
    print(f"  launches: {launches_scale}")
    print(f"  wall {wall_scale:.3f} s, {mem_text}, ARI against the tasks "
          f"{ari_s:.4f} (required 1.0), {SCALE_GROUPS} groups -> "
          f"{int(res_s.entry_counts.numel())} entries")
    record("hierarchical_scale", wall_scale, live, ari=ari_s,
           launches=launches_scale)
    require(labels_s.shape == (SCALE_USERS,) and ari_s == 1.0,
            f"3k(b): ARI {ari_s:.4f} against the tasks < 1")
    require(launches_scale["eigproject"] == batches_s
            and launches_scale["linkage"] == batches_s + 1,
            f"3k(b): not one eigproject and NN-chain launch a batch of "
            f"groups ({batches_s}) plus the global NN-chain")
    # Where the peak comes from: the batched eigh of one batch's Grams
    # alone (report only).
    users_b = SCALE_USERS // SCALE_GROUPS * SCALE_BATCH
    grams_s = sim.batched_gram(x_s[:users_b])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live_b = torch.cuda.memory_allocated()
    sim.spectrum(grams_s, TOP_K)
    eigh_gib = (torch.cuda.max_memory_allocated() - live_b) / 2**30
    print(f"  the batched eigh of one batch's {users_b} Grams alone: "
          f"{eigh_gib:.2f} GiB above live")
    summary["paths"]["hierarchical_scale"]["batch_eigh_gib"] = eigh_gib
    del x_s, res_s, grams_s
    torch.cuda.empty_cache()
    phase_done("phase 3k(b)")

    # -- Phase 3l: the sharded paths over a torch.distributed group ------
    # W = 1: one rank on this card over an NCCL group in this process (the
    # collectives copy).  Phase 3l's launches stay out of the kernels line.
    print(f"[3l] sharded paths over a {SHARD_WORLD}-rank NCCL group: the "
          f"protocol on phase 3's and 3c's users, assign_sharded on phase "
          f"3e's directory, the trainer on 3i(b)'s layout")
    store_l = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    tdist.init_process_group("nccl", init_method=f"file://{store_l}/store",
                             world_size=SHARD_WORLD, rank=0)
    try:
        mesh_l = mdist.make_user_mesh("data")
        require(tdist.get_backend(mesh_l.get_group("data")) == "nccl",
                "3l: the mesh's group is not an NCCL group")

        def sharded_run(fn):
            torch.cuda.synchronize()
            dispatch.reset_launches()
            t = time.perf_counter()
            out = fn()
            labels_run = out.labels.cpu().numpy()
            return out, labels_run, time.perf_counter() - t, \
                dict(dispatch.LAUNCHES)

        # (a) the dense protocol on phase 3's users.
        res_sh, labels_sh, wall_sh, launches_sh = sharded_run(
            lambda: one_shot_clustering(
                x, TASKS, cfg=dataclasses.replace(cfg, backend="shard_map"),
                cluster_cfg=ccfg, device=dev, mesh=mesh_l))
        gap_sh = max_err(torch, res_sh.similarity, big_r)
        bits_sh = torch.equal(res_sh.similarity, big_r)
        wall_3 = summary["paths"]["dense"]["wall_s"]
        wall_3c = summary["paths"]["raw"]["wall_s"]
        print(f"  (a) dense: wall {wall_sh:.3f} s (phase 3: {wall_3:.3f} s), "
              f"R within {gap_sh:.3e} of phase 3's (tolerance 1e-5), the "
              f"same bits {bits_sh}, labels equal to phase 3's "
              f"{np.array_equal(labels_sh, dense_labels)}; launches "
              + ", ".join(f"{k} {launches_sh[k]}"
                          for k in ("gram", "eigproject", "linkage")))
        require(gap_sh <= 1e-5, f"3l(a): R differs from phase 3's by "
                f"{gap_sh:.3e}")
        require(np.array_equal(labels_sh, dense_labels),
                "3l(a): labels differ from phase 3's")
        for name in ("gram", "eigproject", "linkage"):
            require(launches_sh[name] > 0, f"3l(a) never launched {name}")

        # (b) the raw ingest on phase 3c's users.
        raw_kw_sh = dict(
            raw_kw, cfg=dataclasses.replace(cfg_raw, backend="shard_map"),
            signature_cfg=dataclasses.replace(sc_raw, backend="shard_map"),
            mesh=mesh_l)
        res_rsh, labels_rsh, wall_rsh, launches_rsh = sharded_run(
            lambda: one_shot_clustering(raw_x, 2, **raw_kw_sh))
        gap_rsh = max_err(torch, res_rsh.similarity, r_raw)
        bits_rsh = torch.equal(res_rsh.similarity, r_raw)
        print(f"  (b) raw: wall {wall_rsh:.3f} s (phase 3c: {wall_3c:.3f} s), "
              f"R within {gap_rsh:.3e} of phase 3c's (tolerance 1e-5), the "
              f"same bits {bits_rsh}, labels equal to phase 3c's "
              f"{np.array_equal(labels_rsh, labels_r)}; launches "
              + ", ".join(f"{k} {launches_rsh[k]}" for k in
                          ("featurize_gram", "eigproject", "linkage")))
        require(gap_rsh <= 1e-5, f"3l(b): R differs from phase 3c's by "
                f"{gap_rsh:.3e}")
        require(np.array_equal(labels_rsh, labels_r),
                "3l(b): labels differ from phase 3c's")
        for name in ("featurize_gram", "eigproject", "linkage"):
            require(launches_rsh[name] > 0, f"3l(b) never launched {name}")
        del res_sh, res_rsh

        # (c) the directory sharded: phase 3e's last wave against its
        # final directory, held to assign in fp32 (the sharded product
        # runs in fp32, as the reference's einsum does).
        fp32_engine = MembershipEngine(dataclasses.replace(
            served.cfg, compute_dtype="fp32"), device=dev)
        fp32_engine.state = served.state
        one = fp32_engine.assign(lam_last, v_last)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        shd = served.assign_sharded(lam_last, v_last, mesh=mesh_l)
        torch.cuda.synchronize()
        wall_ash = time.perf_counter() - t0
        fin = torch.isfinite(one.affinity)
        gap_ash = max_err(torch, shd.affinity[fin], one.affinity[fin])
        same_ash = (torch.equal(shd.labels, one.labels)
                    and torch.equal(torch.isfinite(shd.affinity), fin))
        print(f"  (c) assign_sharded: {tuple(v_last.shape)[0]} arrivals, "
              f"T = {served.state.n_clusters}, {wall_ash * 1e3:.3f} ms; "
              f"labels equal to assign's (fp32) {same_ash}, affinity within "
              f"{gap_ash:.3e} (tolerance 1e-5)")
        require(same_ash and gap_ash <= 1e-5,
                "3l(c): assign_sharded disagrees with assign")

        # (d) the trainer with its cluster axis sharded, against 3i(b)'s
        # fused single-process run.
        mesh_c = mdist.make_user_mesh("clusters")
        hist_sh, wall_tsh = timed_train(
            raw_users, labels_r, models_b, evals_b,
            dataclasses.replace(check_cfg, backend="shard_map"),
            cluster_classes=all_classes, fused=True, device=dev, mesh=mesh_c)
        gap_tsh = float(np.max(loss_gaps(hist_sh, hist_fused)))
        same_acc = np.array_equal(hist_sh.accuracy, hist_fused.accuracy)
        print(f"  (d) train_mthfl shard_map, {n_raw} users, "
              f"{TRAIN_CHECK_ROUNDS} rounds: wall {wall_tsh:.3f} s (fused "
              f"{wall_fused:.3f} s), largest train-loss gap {gap_tsh:.3e} x "
              f"max(1, |loss|) (tolerance 1e-5), accuracies equal "
              f"{same_acc}")
        require(hist_sh.fused and gap_tsh <= 1e-5 and same_acc,
                "3l(d): the sharded trainer disagrees with the fused path")
        summary["sharded"] = dict(
            world=SHARD_WORLD,
            dense=dict(wall_s=wall_sh, flat_wall_s=wall_3, r_gap=gap_sh,
                       same_bits=bits_sh, launches=launches_sh),
            raw=dict(wall_s=wall_rsh, flat_wall_s=wall_3c, r_gap=gap_rsh,
                     same_bits=bits_rsh, launches=launches_rsh),
            assign=dict(ms=wall_ash * 1e3, affinity_gap=gap_ash),
            trainer=dict(wall_s=wall_tsh, fused_wall_s=wall_fused,
                         loss_gap=gap_tsh, same_accuracy=same_acc))
    finally:
        tdist.destroy_process_group()
        shutil.rmtree(store_l, ignore_errors=True)
    del raw_users
    phase_done("phase 3l")

    # -- Phase 3p: telemetry on the card ------------------------------------
    print(f"[3p] telemetry (repro_torch.obs) on the card: the dense protocol "
          f"N={OBS_USERS} x n={N_SAMPLES} x d={DIM} off, on and off again; "
          f"phase 3e's serving cell with events on; the overheads; "
          f"launch.obs profile")
    obs.disable()
    obs.reset()
    feats_p, tasks_p = make_task_feature_mixture(OBS_USERS, N_SAMPLES, DIM,
                                                 TASKS, seed=SEED)
    x_p = torch.from_numpy(feats_p).to(dev)
    del feats_p

    def kernel_calls_match(launches, what):
        """``kernel_calls{kernel=..}`` and ``dispatch_count`` against the
        run's launch counts, by the reference's tuning family."""
        want = {}
        for name, n in launches.items():
            family = dispatch.FAMILIES.get(name)
            if family is not None and n:
                want[family] = want.get(family, 0) + n
        got = {f: obs.counter_value("kernel_calls", kernel=f)
               for f in sorted(set(dispatch.FAMILIES.values()))}
        got = {f: n for f, n in got.items() if n}
        require(got == want, f"{what}: kernel_calls {got} differ from the "
                f"launches by family {want}")
        require(obs.counter_value("dispatch_count") == sum(want.values()),
                f"{what}: dispatch_count "
                f"{obs.counter_value('dispatch_count')} != "
                f"{sum(want.values())} launches")
        return want

    # (a) One CUDA-event pair around each dense protocol call, inside the
    # protocol.dispatch span.
    dense_events = []
    plain_dense = protocol_engine._dense_protocol

    def dense_with_events(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = plain_dense(*args, **kw)
        end.record()
        dense_events.append((start, end))
        return out

    def dense_run():
        torch.cuda.synchronize()
        dispatch.reset_launches()
        t = time.perf_counter()
        with mock.patch.object(protocol_engine, "_dense_protocol",
                               dense_with_events):
            r = one_shot_clustering(x_p, TASKS,
                                    cfg=sim.SimilarityConfig(top_k=TOP_K),
                                    cluster_cfg=ClusterConfig(backend="torch"),
                                    device=dev)
        lab = r.labels.cpu()
        torch.cuda.synchronize()
        return r, lab, time.perf_counter() - t, dict(dispatch.LAUNCHES)

    res_off, lab_off, wall_off, _ = dense_run()
    require(obs.snapshot() == {"counters": {}, "gauges": {},
                               "histograms": {}}
            and obs.trace_records() == [] and obs.events() == [],
            "3p(a): telemetry off recorded something")
    obs.enable()
    res_on, lab_on, wall_on, launches_on = dense_run()
    obs.disable()
    recs_p = obs.trace_records()
    snap_p = obs.snapshot()
    tree_p = obs.format_tree(recs_p)
    res_off2, lab_off2, wall_off2, _ = dense_run()
    require(obs.snapshot() == snap_p and obs.trace_records() == recs_p,
            "3p(a): telemetry off again recorded something")
    print("  trace of the run with telemetry on:")
    for line in tree_p.splitlines():
        print("    " + line)
    print(f"  launches {launches_on}; counters {snap_p['counters']}")
    require(tuple(res_on.similarity.shape) == (OBS_USERS, OBS_USERS)
            and bool(torch.isfinite(res_on.similarity).all()),
            "3p(a): R is not a finite (N, N) matrix")
    same_p = (torch.equal(res_off.similarity, res_on.similarity)
              and torch.equal(lab_off, lab_on)
              and torch.equal(res_off2.similarity, res_on.similarity)
              and torch.equal(lab_off2, lab_on))
    require(same_p, "3p(a): R or the labels differ between telemetry off "
            "and on")
    names_p = [r["name"] for r in recs_p]
    require(sorted(names_p) == sorted(
        ["oneshot.run", "protocol.run", "protocol.dispatch", "cluster.hac",
         "cluster.cut"]), f"3p(a): spans {names_p}")
    span_p = {r["name"]: r for r in recs_p}
    root_id = span_p["oneshot.run"]["id"]
    require(span_p["oneshot.run"]["parent"] == 0
            and span_p["protocol.run"]["parent"] == root_id
            and span_p["protocol.dispatch"]["parent"]
            == span_p["protocol.run"]["id"]
            and span_p["cluster.hac"]["parent"] == root_id
            and span_p["cluster.cut"]["parent"] == root_id,
            "3p(a): the span tree is not oneshot.run > protocol.run > "
            "protocol.dispatch, cluster.hac, cluster.cut")
    require(snap_p["counters"].get("protocol.dispatches{mode=dense}") == 1
            and snap_p["counters"].get("cluster.hac_runs") == 1,
            "3p(a): protocol.dispatches or cluster.hac_runs is not 1")
    families_p = kernel_calls_match(launches_on, "3p(a)")
    require(obs.counter_value("retrace_count") == 0,
            "3p(a): the kernel library was built again with telemetry on")
    start_p, end_p = dense_events[1]
    event_ms_p = start_p.elapsed_time(end_p)
    disp_ms_p = span_p["protocol.dispatch"]["dur_us"] / 1e3
    require(disp_ms_p >= event_ms_p, f"3p(a): protocol.dispatch lasted "
            f"{disp_ms_p:.3f} ms by its span, under the {event_ms_p:.3f} ms "
            f"of the same call by CUDA events: the span did not synchronise")
    acc_p = clu.clustering_accuracy(lab_on.numpy(), tasks_p)
    print(f"  R and labels bit-equal off / on / off; kernel_calls "
          f"{families_p} equal the launches; retrace_count 0; "
          f"protocol.dispatch {disp_ms_p:.3f} ms by its span, "
          f"{event_ms_p:.3f} ms by CUDA events; accuracy {acc_p:.1%}")

    # (b) Phase 3e's serving cell with events on.
    serve_args_p = launch_membership.build_parser().parse_args(SERVING_ARGS)
    obs.reset()
    dispatch.reset_launches()
    obs.enable()
    t0 = time.perf_counter()
    cell_p, served_p, (lam_p, v_p) = launch_membership.run_cell(
        serve_args_p, serve_args_p.scenario, serve_args_p.arrivals,
        verbose=False, return_state=True)
    wall_cell_p = time.perf_counter() - t0
    obs.disable()
    launches_cell_p = dict(dispatch.LAUNCHES)
    events_p = obs.events()
    kinds_p = {}
    for e in events_p:
        kinds_p[e["kind"]] = kinds_p.get(e["kind"], 0) + 1
    hist_p = obs.snapshot()["histograms"]["assign_latency_us"]
    cell_3e = summary["paths"]["serving"]
    print(f"  serving cell with events on: wall {wall_cell_p:.3f} s "
          f"(phase 3e {cell_3e['wall_s']:.3f} s), events by kind "
          f"{dict(sorted(kinds_p.items()))}, assign_latency_us count "
          f"{hist_p['count']} (mean {hist_p['mean']:.1f} us), re-clusters "
          f"at waves {cell_p['recluster_waves']} (phase 3e "
          f"{cell_3e['recluster_waves']})")
    print("  per-wave assign ms, events on "
          + ", ".join(f"{t:.3f}" for t in cell_p["assign_ms"])
          + "; phase 3e (off) "
          + ", ".join(f"{t:.3f}" for t in cell_3e["assign_ms"]))
    require(hist_p["count"] == serve_args_p.waves
            and kinds_p.get("assign_wave") == serve_args_p.waves,
            f"3p(b): assign_latency_us counted {hist_p['count']} and "
            f"{kinds_p.get('assign_wave')} assign_wave events for "
            f"{serve_args_p.waves} waves")
    require(kinds_p.get("seed") == 1
            and obs.counter_value("recluster_events")
            == cell_p["n_reclusters"] == kinds_p.get("recluster", 0),
            "3p(b): seed or re-cluster events disagree with the cell")
    require(cell_p["accuracy_per_wave"] == cell_3e["accuracy_per_wave"]
            and cell_p["recluster_waves"] == cell_3e["recluster_waves"],
            "3p(b): the serving cell with events on served differently")
    kernel_calls_match(launches_cell_p, "3p(b)")

    # (c) The overheads, beside the reference's contract (<= 5% on,
    # <= 0.5% off; src/repro/obs/core.py).  Reported, not required.
    def one_assign():
        torch.cuda.synchronize()
        t = time.perf_counter()
        served_p.assign(lam_p, v_p)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    def median(xs):
        xs = sorted(xs)
        return 0.5 * (xs[(len(xs) - 1) // 2] + xs[len(xs) // 2])

    one_assign()
    with obs.scope(True):
        one_assign()
    best = None
    for _ in range(OBS_TRIALS):
        obs.reset()
        offs, ons = [], []
        for _ in range(OBS_PAIRS):
            obs.disable()
            offs.append(one_assign())
            obs.enable()
            ons.append(one_assign())
        obs.disable()
        trial = (median(ons) / median(offs) - 1.0, median(offs),
                 median(ons))
        best = trial if best is None or trial[0] < best[0] else best
    t0 = time.perf_counter()
    for _ in range(OBS_BUNDLE_CALLS):
        obs.now()
        with obs.span("bundle", backend="torch") as sp:
            sp.sync(None)
        if obs.enabled():
            raise SmokeFailure("telemetry turned itself on")
    bundle_s = (time.perf_counter() - t0) / OBS_BUNDLE_CALLS
    # Where the enabled cost goes: each piece of the bookkeeping one
    # assign() adds, timed alone as the wave is (ending in a sync), beside
    # an empty call.
    labels_p = served_p.assign(lam_p, v_p).labels

    def timed(fn):
        xs = []
        for _ in range(OBS_PIECE_CALLS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            xs.append(time.perf_counter() - t)
        return median(xs) * 1e6

    def span_piece():
        with obs.span("membership.assign", backend="torch") as sp:
            sp.sync(labels_p)

    def record_piece():
        t = obs.now()
        obs.observe("assign_latency_us", (obs.now() - t) * 1e6)
        obs.count("membership.assign_waves")
        obs.event("assign_wave", n=128, n_unassigned=0, backend="torch")

    with obs.scope(True):
        pieces_us = dict(empty=timed(lambda: None), span=timed(span_piece),
                         records=timed(record_piece),
                         labels_to_host=timed(
                             lambda: labels_p.detach().cpu().numpy()))
    obs.reset()
    dense_over = wall_on / (0.5 * (wall_off + wall_off2)) - 1.0
    print(f"  overheads (reported, not required): dense protocol wall off "
          f"{wall_off:.4f} s, on {wall_on:.4f} s, off again "
          f"{wall_off2:.4f} s ({dense_over:+.2%} on); assign path "
          f"(B={v_p.shape[0]}, T={served_p.state.n_clusters}, d={DIM}, "
          f"{OBS_PAIRS} alternating pairs, best of {OBS_TRIALS}): off "
          f"{best[1] * 1e3:.4f} ms, on {best[2] * 1e3:.4f} ms "
          f"({best[0]:+.2%}; contract <= 5%); the disabled call bundle "
          f"{bundle_s * 1e9:.1f} ns = {bundle_s / best[1]:.4%} of a wave "
          f"(contract <= 0.5%); the enabled pieces alone, us a call ending "
          f"in a sync: " + ", ".join(f"{k} {v:.1f}"
                                      for k, v in pieces_us.items()))

    # (d) launch.obs profile over the membership launcher, in a process
    # of its own.  The kernel events are counted, not required: a
    # profiler session can lose its first kernel events (PERF.md).
    src_dir = str(Path(__file__).resolve().parent / "src")
    with tempfile.TemporaryDirectory() as logdir:
        prof = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.obs", "profile",
             "--logdir", logdir, "--", "repro_torch.launch.membership",
             "--quick"], capture_output=True, text=True, timeout=600,
            env=dict(os.environ, PYTHONPATH=src_dir))
        require(prof.returncode == 0, f"3p(d): launch.obs profile failed "
                f"(rc {prof.returncode}):\n{prof.stdout[-2000:]}"
                f"{prof.stderr[-2000:]}")
        traces_p = sorted(Path(logdir).glob("trace_*.json"))
        require(len(traces_p) == 1, f"3p(d): {len(traces_p)} trace files")
        trace_events = json.loads(traces_p[0].read_text())["traceEvents"]
    trace_names = {e.get("name") for e in trace_events}
    need_p = {"oneshot.run", "protocol.run", "protocol.dispatch",
              "cluster.hac", "cluster.cut", "membership.assign",
              "membership.admit", "membership.evict"}
    n_kernel_events = sum(1 for e in trace_events
                          if e.get("cat") == "kernel")
    print(f"  launch.obs profile -- repro_torch.launch.membership --quick: "
          f"{len(trace_events)} trace events, spans "
          f"{sorted(need_p & trace_names)}, {n_kernel_events} kernel events "
          f"(counted, not required)")
    require(need_p <= trace_names, f"3p(d): spans missing from the "
            f"profile: {sorted(need_p - trace_names)}")
    summary["telemetry"] = dict(
        dense=dict(users=OBS_USERS, wall_off_s=wall_off, wall_on_s=wall_on,
                   wall_off_again_s=wall_off2, same_bits=same_p,
                   launches=launches_on, kernel_calls=families_p,
                   dispatch_span_ms=disp_ms_p, dispatch_event_ms=event_ms_p,
                   spans=names_p, accuracy=acc_p),
        serving=dict(wall_s=wall_cell_p, events=kinds_p,
                     assign_latency_count=hist_p["count"],
                     assign_latency_mean_us=hist_p["mean"],
                     assign_ms=cell_p["assign_ms"],
                     recluster_waves=cell_p["recluster_waves"]),
        overheads=dict(dense_on=dense_over, assign_on=best[0],
                       assign_off_ms=best[1] * 1e3,
                       assign_on_ms=best[2] * 1e3,
                       disabled_bundle_ns=bundle_s * 1e9,
                       disabled_frac=bundle_s / best[1],
                       enabled_pieces_us=pieces_us),
        profile=dict(events=len(trace_events),
                     kernel_events=n_kernel_events))
    del x_p, res_off, res_on, res_off2, served_p
    phase_done("phase 3p")

    # -- Phase 4: kernel times at the main path's shapes ------------------
    print("[4] kernels vs plain versions and times at the main-path "
          "shapes (CUDA events)")
    n_, m_, d_, k_ = N_USERS, N_SAMPLES, DIM, TOP_K
    kernels = []

    g = batched_gram_matrix(x)
    gram_err, gram_err_1x = check_split(
        torch, f"gram ({n_}, {m_}, {d_})", g, gram_ref(x),
        gram_1xtf32(torch, x))
    require(torch.equal(g, g.mT), "gram: the Gram is not symmetric")
    require(torch.equal(g, batched_gram_matrix(x)),
            "gram: two runs on the same inputs differ")
    del g
    plan = gram_plan(d_)
    print(f"  gram: {n_} users x {len(plan.pairs)} tile pairs (I <= J of "
          f"{plan.tiles} x {plan.tiles}) = {n_ * len(plan.pairs)} blocks, "
          f"{plan.route} loads; symmetric bit for bit, two runs bit-equal")
    t_kernel = time_ms(torch, lambda: batched_gram_matrix(x), 5)
    t_plain = time_ms(torch, lambda: gram_ref(x), 5)
    t_lib = time_ms(torch, lambda: torch.bmm(x.transpose(1, 2), x), 5)
    # X^T X is symmetric: the function needs one triangle and its
    # diagonal, N * n * d * (d + 1) operations (a syrk's count), here as
    # 3xTF32; bound_fp32_ms has them on the fp32 cores.
    b, by, b32 = split_bound_ms(1.0 * n_ * m_ * d_ * (d_ + 1),
                                4.0 * (n_ * m_ * d_ + n_ * d_ * d_))
    kernels.append(dict(
        name="gram", route="cuda",
        source="src/repro_torch/kernels/csrc/gram.cu",
        replaces="src/repro/kernels/gram/gram.py:40",
        launches=launches["gram"], max_abs_err=gram_err,
        emulated_1xtf32_err=gram_err_1x, blocks=n_ * len(plan.pairs),
        ms=t_kernel, plain_ms=t_plain, bound_ms=b, bound_by=by,
        bound_fp32_ms=b32, library_ms=t_lib,
        library_call="torch.bmm(x^T, x) (fp32, TF32 off)"))

    def library_norms():
        out = torch.empty((n_, n_, k_), device=dev)
        for s in range(0, n_, 16):
            out[s:s + 16] = torch.linalg.vector_norm(
                torch.matmul(grams[s:s + 16, None], v[None]), dim=-2)
        return out

    # eigproject at the dense shape: 3xTF32 on wgmma, held to 1e-5 x
    # max|plain| and 1/8 of the 1xTF32 emulation's error, two runs
    # bit-equal.  2 N^2 d^2 k operations (G need not be symmetric), as
    # 3xTF32; bound_fp32_ms has them on the fp32 cores.
    proj_out = project_norms_all(grams, v)
    proj_err, proj_err_1x = check_split(
        torch, f"eigproject ({n_}, {d_}, {k_})", proj_out,
        project_norms_all_ref(grams, v), project_norms_all_tf32(grams, v, 1))
    require(torch.equal(proj_out, project_norms_all(grams, v)),
            "eigproject: two runs on the same inputs differ")
    del proj_out
    t_kernel = time_ms(torch, lambda: project_norms_all(grams, v), 3)
    t_dev, dev_how = device_ms(
        torch, lambda: project_norms_all(grams, v), 3)
    t_plain = time_ms(torch, lambda: project_norms_all_ref(grams, v), 3)
    t_lib = time_ms(torch, library_norms, 3)
    b, by, b32 = split_bound_ms(
        2.0 * n_ * n_ * d_ * d_ * k_,
        4.0 * (n_ * d_ * d_ + n_ * d_ * k_ + n_ * n_ * k_))
    print(f"  eigproject: {n_} users x {-(-n_ * k_ // 128)} slabs of 128 "
          f"stacked columns, {eig_plan(d_).route} loads; two runs bit-equal; "
          f"device time {t_dev:.3f} ms ({dev_how})")
    kernels.append(dict(
        name="eigproject", route="cuda",
        source="src/repro_torch/kernels/csrc/eigproject.cu",
        replaces="src/repro/kernels/eigproject/eigproject.py:53",
        launches=launches["eigproject"], max_abs_err=proj_err,
        emulated_1xtf32_err=proj_err_1x, ms=t_kernel, device_ms=t_dev,
        device_time_by=dev_how, plain_ms=t_plain, bound_ms=b, bound_by=by,
        bound_fp32_ms=b32, library_ms=t_lib,
        library_call="torch.matmul(G_i, V_j) per pair, vector_norm "
                     "(16 users a call, fp32, TF32 off)"))

    prepared = big_r.clone()
    prepared.fill_diagonal_(float("-inf"))
    work = prepared.clone()

    def reset():
        work.copy_(prepared)

    m_k, h_k, c_k = lk_ops._nn_chain_counted(prepared.clone())
    t_plain0 = time.perf_counter()
    m_p, h_p, t_p = nn_chain_ref(prepared.clone())
    torch.cuda.synchronize()
    t_plain = (time.perf_counter() - t_plain0) * 1e3
    require(int(c_k[0]) == int(t_p) == n_ - 1 and torch.equal(m_k, m_p)
            and torch.equal(h_k, h_p),
            "nn_chain at the main-path R differs from the plain loop")
    iters, rescans = int(c_k[1]), int(c_k[2])
    print(f"  nn_chain ({n_} leaves): merges, heights and step count equal "
          f"to the plain loop (exact); {iters} iterations ({n_ - 1} merges, "
          f"{iters - n_ + 1} chain extensions), {rescans} rows rescanned")
    chain_err = max_err(torch, h_k, h_p)
    t_kernel = time_ms(torch, lambda: nn_chain(work), 5, setup=reset)

    def chain_call():
        reset()
        lk_ops._nn_chain_counted(work)

    # The chain alone: the reset's copy of R, timed the same way, is
    # taken off.
    t_dev, dev_how = device_ms(torch, chain_call, 5)
    t_dev -= device_ms(torch, reset, 5)[0]
    dev_how += ", less the reset's copy of R"
    b, by = bound_ms(4.0 * n_ * (n_ - 1), 4.0 * n_ * n_ + 12.0 * (n_ - 1))
    # The probe builds of linkage.cu: the chain on the scratch route at
    # this n, timed as the wrapper is, and the loop's cycles by phase.
    probes = chain_probe_libs()
    for name in ("scratch", "clocks"):
        got = probe_chain(torch, probes[name], prepared.clone())
        require(all(torch.equal(x, y) for x, y in zip(got, (m_k, h_k, c_k))),
                f"nn_chain's {name} probe build differs from the kernel")
    t_scratch = time_ms(
        torch, lambda: probe_chain(torch, probes["scratch"], work), 5,
        setup=reset)
    clocks = torch.zeros((len(CHAIN_PHASES),), dtype=torch.int64)
    build.check(probes["clocks"].repro_nn_chain_clocks(clocks.data_ptr()),
                "nn_chain clocks")
    clocks = [int(c) for c in clocks]
    print(f"  nn_chain on the scratch route (probe build): {t_scratch:.3f} "
          f"ms a call against {t_kernel:.3f} in shared memory; cycles "
          f"(thread 0, probe build; an extension's a call, the rest a "
          f"merge, share of all): " + ", ".join(
              f"{name} {c / max(iters - n_ + 1 if k == 0 else n_ - 1, 1):.0f} "
              f"({c / sum(clocks):.1%})"
              for k, (name, c) in enumerate(zip(CHAIN_PHASES, clocks))))
    kernels.append(dict(
        name="linkage", route="cuda",
        source="src/repro_torch/kernels/csrc/linkage.cu",
        replaces="src/repro/kernels/linkage/linkage.py:68",
        launches=launches["linkage"], max_abs_err=chain_err, ms=t_kernel,
        device_ms=t_dev, device_time_by=dev_how, plain_ms=t_plain,
        bound_ms=b, bound_by=by, library_ms=None, iterations=iters,
        rescans=rescans, us_per_iteration=t_dev * 1e3 / iters,
        chain_plan=chain_plan(n_).route, scratch_route_ms=t_scratch,
        phase_cycles=dict(zip(CHAIN_PHASES, clocks))))
    print(f"  nn_chain: {t_kernel:.3f} ms a call, device time {t_dev:.4f} ms "
          f"({dev_how}), {t_dev * 1e3 / iters:.3f} us an iteration over "
          f"{iters}; "
          f"byte bound {b:.4f} ms")
    us_per_iter = t_dev * 1e3 / iters

    # The group axis at the hierarchical cell's group shape (phase 3k: 8
    # groups of 128 of the dense cell's users, whose Grams are phase 3's
    # in the same order).  eigproject: held to 8 single calls (1e-6 x
    # max|plain|, bit-equality reported) and to the plain version and the
    # 1xTF32 emulation as at the dense shape; 2 B Ng^2 d^2 k operations
    # as 3xTF32.  The library call: one batched matmul over the groups
    # (16 users of each group a call) and vector_norm.
    gg = grams.view(HIER_GROUPS, ng_k, d_, d_)
    vg = v.view(HIER_GROUPS, ng_k, d_, k_)
    gp_out = project_norms_grouped(gg, vg)
    single = torch.stack([project_norms_all(gg[i], vg[i])
                          for i in range(HIER_GROUPS)])
    gp_single_err = check_close(
        torch, f"eigproject grouped ({HIER_GROUPS}, {ng_k}, {d_}, {k_}) "
        f"against {HIER_GROUPS} single calls", gp_out, single, 1e-6)
    gp_bit_equal = torch.equal(gp_out, single)
    gp_err, gp_err_1x = check_split(
        torch, f"eigproject grouped ({HIER_GROUPS}, {ng_k}, {d_}, {k_})",
        gp_out, project_norms_grouped_ref(gg, vg),
        torch.stack([project_norms_all_tf32(gg[i], vg[i], 1)
                     for i in range(HIER_GROUPS)]))
    require(torch.equal(gp_out, project_norms_grouped(gg, vg)),
            "eigproject grouped: two runs on the same inputs differ")
    del gp_out, single

    def library_grouped():
        out = torch.empty((HIER_GROUPS, ng_k, ng_k, k_), device=dev)
        for s_ in range(0, ng_k, 16):
            out[:, s_:s_ + 16] = torch.linalg.vector_norm(
                torch.matmul(gg[:, s_:s_ + 16, None], vg[:, None]), dim=-2)
        return out

    t_kernel = time_ms(torch, lambda: project_norms_grouped(gg, vg), 5)
    t_dev, dev_how = device_ms(
        torch, lambda: project_norms_grouped(gg, vg), 5)
    t_plain = time_ms(torch, lambda: project_norms_grouped_ref(gg, vg), 3)
    t_lib = time_ms(torch, library_grouped, 3)
    b, by, b32 = split_bound_ms(
        2.0 * HIER_GROUPS * ng_k * ng_k * d_ * d_ * k_,
        4.0 * (HIER_GROUPS * ng_k * (d_ * d_ + d_ * k_ + ng_k * k_)))
    print(f"  eigproject grouped: {HIER_GROUPS * ng_k} users x "
          f"{-(-ng_k * k_ // 128)} slabs of their group's columns, one "
          f"launch; bit-equal to {HIER_GROUPS} single calls: {gp_bit_equal}; "
          f"{t_kernel:.3f} ms a call, device time {t_dev:.3f} ms "
          f"({dev_how}), split bound {b:.3f} ms; library {t_lib:.3f} ms")
    kernels.append(dict(
        name="eigproject_grouped", route="cuda",
        source="src/repro_torch/kernels/csrc/eigproject.cu",
        replaces="src/repro/kernels/eigproject/eigproject.py:53",
        launches=launches_k["eigproject"], max_abs_err=gp_err,
        emulated_1xtf32_err=gp_err_1x, single_calls_err=gp_single_err,
        bit_equal_to_single_calls=gp_bit_equal, ms=t_kernel,
        device_ms=t_dev, device_time_by=dev_how, plain_ms=t_plain,
        bound_ms=b, bound_by=by, bound_fp32_ms=b32, library_ms=t_lib,
        library_call="torch.matmul(G, V) batched over the groups, 16 users "
                     "of each a call, vector_norm (fp32, TF32 off)",
        shape=[HIER_GROUPS, ng_k, d_, k_]))

    # The NN-chain with its group axis on phase 3k's group R (8 chains of
    # 128 leaves, one block each): merges, heights and steps equal to 8
    # single calls and to the plain loop.  The chains run side by side, so
    # the longest group's dependent iterations set its time; its time an
    # iteration is printed beside the dense chain's.
    prepared_k = big_r_k.clone()
    prepared_k.diagonal(dim1=1, dim2=2).fill_(float("-inf"))
    work_k = prepared_k.clone()

    def reset_k():
        work_k.copy_(prepared_k)

    mg, hg, sg = nn_chain_grouped(prepared_k.clone())
    singles = [lk_ops._nn_chain_counted(prepared_k[i].clone())
               for i in range(HIER_GROUPS)]
    require(all(torch.equal(mg[i], m1) and torch.equal(hg[i], h1)
                and int(sg[i]) == int(c1[0]) == ng_k - 1
                for i, (m1, h1, c1) in enumerate(singles)),
            "nn_chain grouped differs from the single calls")
    t_plain0 = time.perf_counter()
    want = nn_chain_grouped_ref(prepared_k.clone())
    torch.cuda.synchronize()
    t_plain = (time.perf_counter() - t_plain0) * 1e3
    require(all(torch.equal(a_, b_) for a_, b_ in zip((mg, hg, sg), want)),
            "nn_chain grouped differs from the plain loop")
    iters_k = [int(c1[1]) for _, _, c1 in singles]
    t_kernel = time_ms(torch, lambda: nn_chain_grouped(work_k), 5,
                       setup=reset_k)

    def chain_call_k():
        reset_k()
        nn_chain_grouped(work_k)

    t_dev, dev_how = device_ms(torch, chain_call_k, 5)
    t_dev -= device_ms(torch, reset_k, 5)[0]
    dev_how += ", less the reset's copy of R"
    b, by = bound_ms(4.0 * HIER_GROUPS * ng_k * (ng_k - 1),
                     4.0 * HIER_GROUPS * ng_k * ng_k
                     + 12.0 * HIER_GROUPS * (ng_k - 1))
    us_group = t_dev * 1e3 / max(iters_k)
    print(f"  nn_chain grouped ({HIER_GROUPS} x {ng_k} leaves): equal to "
          f"{HIER_GROUPS} single calls and the plain loop (exact); "
          f"iterations by group {iters_k}; {t_kernel:.3f} ms a call, device "
          f"time {t_dev:.4f} ms ({dev_how}), {us_group:.3f} us an "
          f"iteration of the longest group's {max(iters_k)} (the dense "
          f"chain's: {us_per_iter:.3f}); byte bound {b:.4f} ms")
    kernels.append(dict(
        name="linkage_grouped", route="cuda",
        source="src/repro_torch/kernels/csrc/linkage.cu",
        replaces="src/repro/kernels/linkage/linkage.py:68",
        launches=launches_k["linkage"] - 1,
        max_abs_err=max_err(torch, hg, want[1]), ms=t_kernel,
        device_ms=t_dev, device_time_by=dev_how, plain_ms=t_plain,
        bound_ms=b, bound_by=by, library_ms=None, iterations=iters_k,
        us_per_iteration=us_group, shape=[HIER_GROUPS, ng_k]))
    del prepared_k, work_k

    # featurize_gram at the raw path's shapes, all rows in one launch:
    # fp32 (the main path's compute dtype) as 3xTF32, held to 1e-5 x
    # max|plain| and to 1/8 of the 1xTF32 emulation's error; then bf16.
    # Two runs of each are bit-equal, and each Gram symmetric bit for bit.
    w_raw = engine.params_for(m_raw)["w"]
    fg_name = f"featurize_gram ({n_raw}, {rows_raw}, {m_raw}) x ({m_raw}, {DIM})"
    fg_out = batched_featurize_gram(raw_x, w_raw)
    fg_ref = featurize_gram_ref(raw_x, w_raw)
    fg_err = check_close(torch, fg_name, fg_out, fg_ref, 1e-5)
    _, fg_err_1x = check_split(torch, fg_name, fg_out, fg_ref,
                               featurize_1xtf32(torch, raw_x, w_raw))
    require(torch.equal(fg_out, batched_featurize_gram(raw_x, w_raw))
            and torch.equal(fg_out, fg_out.transpose(1, 2)),
            "featurize_gram: two runs differ or the Gram is not symmetric")
    del fg_ref
    fg16_ref = featurize_gram_ref(raw_x, w_raw, "bf16")
    fg16_err = check_close(torch, f"{fg_name} bf16",
                           batched_featurize_gram(raw_x, w_raw, "bf16"),
                           fg16_ref, 2e-2)
    fg16_out = batched_featurize_gram(raw_x, w_raw, "bf16")
    require(torch.equal(fg16_out, batched_featurize_gram(raw_x, w_raw, "bf16"))
            and torch.equal(fg16_out, fg16_out.transpose(1, 2)),
            "featurize_gram bf16: two runs differ or the Gram is not "
            "symmetric")
    del fg16_ref, fg16_out, fg_out
    print("  featurize_gram fp32 and bf16 at the raw shape: two runs "
          "bit-equal, Grams symmetric bit for bit")
    t_kernel = time_ms(torch, lambda: batched_featurize_gram(raw_x, w_raw), 3)
    t_plain = time_ms(torch, lambda: featurize_gram_ref(raw_x, w_raw), 3)

    def library_featurize():
        f = raw_x @ w_raw
        return torch.bmm(f.transpose(1, 2), f)

    def library_featurize_bf16():
        f = raw_x.bfloat16() @ w_raw.bfloat16()
        return torch.bmm(f.transpose(1, 2), f)

    t_lib = time_ms(torch, library_featurize, 3)
    # The projection, then one triangle of the symmetric Gram.
    fg_ops = 1.0 * n_raw * (2.0 * rows_raw * m_raw * DIM
                            + rows_raw * DIM * (DIM + 1))
    fg_bytes = 4.0 * (n_raw * rows_raw * m_raw + m_raw * DIM
                      + n_raw * DIM * DIM)
    b, by, b32 = split_bound_ms(fg_ops, fg_bytes)
    b16, by16, _ = assign_bound_ms(0.0, fg_ops, "bf16", fg_bytes)
    fg_bf16 = dict(
        max_abs_err=fg16_err,
        ms=time_ms(torch, lambda: batched_featurize_gram(raw_x, w_raw,
                                                         "bf16"), 3),
        plain_ms=time_ms(torch, lambda: featurize_gram_ref(raw_x, w_raw,
                                                           "bf16"), 3),
        bound_ms=b16, bound_by=by16,
        library_ms=time_ms(torch, library_featurize_bf16, 3),
        library_call="f = x.bfloat16() @ w.bfloat16(); torch.bmm(f^T, f)")
    kernels.append(dict(
        name="featurize_gram", route="cuda",
        source="src/repro_torch/kernels/csrc/featurize_gram.cu",
        replaces="src/repro/kernels/featurize_gram/featurize_gram.py:94",
        launches=launches_r["featurize_gram"], max_abs_err=fg_err,
        emulated_1xtf32_err=fg_err_1x,
        ms=t_kernel, plain_ms=t_plain, bound_ms=b, bound_by=by,
        bound_fp32_ms=b32, library_ms=t_lib,
        library_call="f = x @ w; torch.bmm(f^T, f) (fp32, TF32 off)",
        bf16=fg_bf16))

    # gram_project at the blockwise path's shapes, all users in one launch.
    k_all = v_flat.shape[1]
    gp_name = f"gram_project ({n_}, {m_}, {d_}) x ({d_}, {k_all})"
    gp_out = batched_gram_project(x, v_flat)
    gp_ref = gram_project_ref(x, v_flat)
    gp_err = check_close(torch, gp_name, gp_out, gp_ref, 1e-5)
    _, gp_err_1x = check_split(torch, gp_name, gp_out, gp_ref,
                               gram_project_1xtf32(torch, x, v_flat))
    require(torch.equal(gp_out, batched_gram_project(x, v_flat)),
            "gram_project: two runs on the same inputs differ")
    print("  gram_project at the blockwise shape: two runs bit-equal")
    del gp_out, gp_ref
    t_kernel = time_ms(torch, lambda: batched_gram_project(x, v_flat), 3)
    t_plain = time_ms(torch, lambda: gram_project_ref(x, v_flat), 3)

    def library_gram_project():
        out = torch.empty((n_, k_all), device=dev)
        for s in range(0, n_, BLOCK_USERS):
            xs = x[s:s + BLOCK_USERS]
            p = xs @ v_flat
            out[s:s + BLOCK_USERS] = torch.linalg.vector_norm(
                torch.bmm(xs.transpose(1, 2), p), dim=1) / m_
        return out

    t_lib = time_ms(torch, library_gram_project, 3)
    b, by, b32 = split_bound_ms(4.0 * n_ * m_ * d_ * k_all,
                                4.0 * (n_ * m_ * d_ + d_ * k_all
                                       + n_ * k_all))
    kernels.append(dict(
        name="gram_project", route="cuda",
        source="src/repro_torch/kernels/csrc/gram_project.cu",
        replaces="src/repro/kernels/gram_project/gram_project.py:99",
        launches=launches_b["gram_project"], max_abs_err=gp_err,
        emulated_1xtf32_err=gp_err_1x,
        ms=t_kernel, plain_ms=t_plain, bound_ms=b, bound_by=by,
        bound_fp32_ms=b32, library_ms=t_lib,
        library_call="xs @ v, torch.bmm(xs^T, p), vector_norm, per "
                     "128-user tile (fp32, TF32 off)"))
    # assign_wave at the landmark path's shape (f32 table, bf16 inputs)
    # and at the serving cell's (f32 and int8 tables); assign_one at the
    # serving shape.  Library call: the reference's own formulation in
    # cuBLAS, S = einsum("bdk,bek->bde") then S @ P_flat^T in the compute
    # dtype.  Bounds (assign_bound_ms): each operation at the peak of its
    # type, the bf16 products on the tensor cores; bound_fp32_ms beside it
    # has every operation on the fp32 cores.

    def library_assign(v, p, cd):
        b_, d_, _ = v.shape
        dtype = torch.bfloat16 if cd == "bf16" else torch.float32
        s_ = torch.einsum("bdk,bek->bde", v, v).reshape(b_, d_ * d_)
        return s_.to(dtype) @ p.reshape(p.shape[0], -1).to(dtype).T

    def assign_entry(name, v, table, scales, cd, reps):
        b_, d_, k_ = v.shape
        t_ = table.shape[0]
        rel, m_rel, abs_err = check_assign(
            torch, f"{name} ({b_}, {t_}, {d_}, {k_}) {table.dtype} {cd}",
            assign(v, table, None, cd, scales=scales),
            assign_wave_plain(v, table, scales, None, cd), k_, cd)
        p_f = quant.dequantize_directory(table, scales)
        # Forming S (fp32), then the product in the compute dtype.
        nbytes = (4.0 * b_ * d_ * k_ + table.element_size() * t_ * d_ * d_
                  + 4.0 * b_ * t_)
        b, by, b32 = assign_bound_ms(2.0 * b_ * d_ * d_ * k_,
                                     2.0 * b_ * d_ * d_ * t_, cd, nbytes)
        return dict(
            max_abs_err=abs_err, rel_err=rel, margin_rel_err=m_rel,
            ms=time_ms(torch, lambda: assign(v, table, None, cd,
                                             scales=scales), reps),
            plain_ms=time_ms(torch, lambda: assign_wave_plain(
                v, table, scales, None, cd), reps),
            bound_ms=b, bound_by=by, bound_fp32_ms=b32,
            library_ms=time_ms(torch, lambda: library_assign(v, p_f, cd),
                               reps))

    wave = assign_entry("assign_wave", land_v, land_protos, None, "bf16", 3)
    # The bf16 wave kernel adds its per-slice partial sums in a fixed
    # order: two runs on the same inputs give the same bits.
    runs = [assign(land_v, land_protos, None, "bf16") for _ in range(2)]
    require(all(torch.equal(x, y) for x, y in zip(*runs)),
            "assign_wave: two runs on the same inputs differ")
    del runs
    print("  assign_wave landmark shape: two runs bit-equal")
    serve_v = torch.as_tensor(v_last).to(dev).contiguous()
    serve_f32 = quant.dequantize_directory(serve_protos)
    serving = {}
    for dt in ("f32", "int8"):
        table, scales = quant.quantize_directory(serve_f32, dt)
        serving[dt] = assign_entry("assign_wave", serve_v, table, scales,
                                   "bf16", 10)
        p_f = quant.dequantize_directory(table, scales)
        serving[dt]["device_ms"], serving[dt]["device_time_by"] = \
            device_ms(torch, lambda: assign(serve_v, table, None, "bf16",
                                            scales=scales))
        serving[dt]["library_device_ms"] = device_ms(
            torch, lambda: library_assign(serve_v, p_f, "bf16"))[0]
    kernels.append(dict(
        name="assign_wave", route="cuda",
        source="src/repro_torch/kernels/csrc/assign_wave_tc.cu",
        replaces="src/repro/kernels/assign/assign.py:85",
        launches=launches_l["assign_wave"] + launches_s["assign_wave"],
        launches_by_path={"landmarks": launches_l["assign_wave"],
                          "serving": launches_s["assign_wave"]},
        shape=[int(n) for n in (*land_v.shape, land_protos.shape[0])],
        **wave, serving=serving))

    b_, d_, k_ = serve_v.shape
    t_ = serve_f32.shape[0]
    one_out = assign_looped(serve_v, serve_f32, None, "bf16")
    one_rel, one_m_rel, one_err = check_assign(
        torch, f"assign_one ({b_}, {t_}, {d_}, {k_}) f32 bf16", one_out,
        assign_looped_plain(serve_v, serve_f32, None, "bf16"), k_, "bf16")
    require(all(torch.equal(a_, b2_) for a_, b2_ in zip(
        one_out, assign_looped(serve_v, serve_f32, None, "bf16"))),
        "assign_one: two runs on the same inputs differ")
    one_plan_ = assign_ops.one_plan(
        b_, t_, d_, k_, torch.cuda.get_device_properties(
            dev).multi_processor_count)
    print(f"  assign_one serving shape: two runs bit-equal; {one_plan_.blocks} "
          f"blocks ({one_plan_.n_groups} groups of {one_plan_.group} arrivals "
          f"x {one_plan_.n_slices} slices of {one_plan_.slice_rows} rows)")
    one_dev, one_how = device_ms(
        torch, lambda: assign_looped(serve_v, serve_f32, None, "bf16"))
    one_lib_dev = device_ms(torch, lambda: library_assign(
        serve_v, serve_f32, "bf16"))[0]
    print(f"  assign_one device time {one_dev:.4f} ms a call ({one_how}), "
          f"library call {one_lib_dev:.4f} ms")
    # P_t V in the compute dtype, then sum(W o V) in fp32.
    nbytes = 4.0 * (t_ * d_ * d_ + b_ * d_ * k_ + b_ * t_)
    b, by, b32 = assign_bound_ms(2.0 * b_ * t_ * d_ * k_,
                                 2.0 * b_ * t_ * d_ * d_ * k_, "bf16", nbytes)
    kernels.append(dict(
        name="assign_one", route="cuda",
        source="src/repro_torch/kernels/csrc/assign.cu",
        replaces="src/repro/kernels/assign/assign.py:192",
        launches=launches_one, max_abs_err=one_err, rel_err=one_rel,
        margin_rel_err=one_m_rel,
        ms=time_ms(torch, lambda: assign_looped(serve_v, serve_f32, None,
                                                "bf16"), 10),
        device_ms=one_dev, device_time_by=one_how,
        plain_ms=time_ms(torch, lambda: assign_looped_plain(
            serve_v, serve_f32, None, "bf16"), 10),
        bound_ms=b, bound_by=by, bound_fp32_ms=b32,
        library_ms=time_ms(torch, lambda: library_assign(serve_v, serve_f32,
                                                         "bf16"), 10),
        library_device_ms=one_lib_dev, shape=[b_, d_, k_, t_]))

    # flash_attention at the two prefill cells' shapes (bf16, as the
    # models run): Qwen3 (B=2, S=4096, H=16, hd=128, causal) and, nested,
    # RecurrentGemma (B=1, S=4096, H=16, hd=256, window 2048); hd 32 at
    # the REDUCED configs' head dim; and phase 3o's three attentions at
    # hd 64: the encoder's (bidirectional), the decoder's self (causal)
    # and the cross attention (bidirectional, S != Skv).  Library call:
    # scaled_dot_product_attention on the (B, H, S, hd) views, with the
    # window as a boolean mask.
    import torch.nn.functional as F

    def flash_entry(b_, s_, h_, hd_, window, reps, time_fp32=False,
                    draw=randn, causal=True, skv_=None):
        # The same inputs in fp32 first: the tile walk and its skips at
        # this shape to 1e-5 x max|plain|; then bf16 element by element.
        # ``time_fp32``: the CUDA-core kernel's time on the fp32 inputs
        # too, beside its plain version's.  ``skv_``: the keys' length
        # (default S).
        skv_ = s_ if skv_ is None else skv_
        qkv32 = [draw(b_, n_, h_, hd_) for n_ in (s_, skv_, skv_)]
        name = (f"flash ({b_}, {s_}, {h_}, {hd_}) Skv {skv_} window "
                f"{window} {'causal' if causal else 'bidirectional'}")
        rel32 = flash_check(f"{name} fp32", flash_attention(
            *qkv32, causal=causal, window=window), flash_ref(
            *qkv32, causal, window))
        fp32_times = {}
        if time_fp32:
            fp32_times = dict(
                fp32_ms=time_ms(torch, lambda: flash_attention(
                    *qkv32, causal=causal, window=window), reps),
                fp32_plain_ms=time_ms(torch, lambda: flash_ref(
                    *qkv32, causal, window), 2))
        q_, k_, v_ = (t_.to(torch.bfloat16) for t_ in qkv32)
        del qkv32
        out = flash_attention(q_, k_, v_, causal=causal, window=window)
        want = flash_ref(q_.float(), k_.float(), v_.float(), causal, window)
        used = flash_check(f"{name} bf16", out, want)
        rel = max_err(torch, out.float(), want) / float(want.abs().max())
        abs_err = max_err(torch, out.float(), want)
        rel_out32 = rel_check(f"{name} bf16 fp32 out",
                              _flash_attention_fp32_out(
                                  q_, k_, v_, causal, window), want, 1e-5)
        del want
        qt, kt, vt = (t_.transpose(1, 2) for t_ in (q_, k_, v_))
        if window:
            mask = torch.ones((s_, s_), dtype=torch.bool, device=dev).tril()
            mask &= ~torch.ones_like(mask).tril(-window)

            def library():
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=mask)
        else:
            def library():
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=causal)
        require(max_err(torch, library().transpose(1, 2).float(),
                        out.float()) <= 2 ** -6 * float(out.abs().max()),
                "flash: the library call computes another function")
        pairs = visible_pairs(s_, window) if causal else s_ * skv_
        b, by, b_pv32 = flash_bound_ms(b_ * h_, hd_, pairs,
                                       2.0 * 2 * b_ * h_ * hd_ * (s_ + skv_))
        return dict(
            max_abs_err=abs_err, rel_err=rel, bf16_limit_used=used,
            fp32_rel_err=rel32, fp32_out_rel_err=rel_out32,
            bound_fp32_pv_ms=b_pv32,
            ms=time_ms(torch, lambda: flash_attention(
                q_, k_, v_, causal=causal, window=window), reps),
            plain_ms=time_ms(torch, lambda: flash_ref(q_, k_, v_, causal,
                                                      window), 2),
            bound_ms=b, bound_by=by,
            library_ms=time_ms(torch, library, reps),
            shape=[b_, s_, h_, hd_], skv=skv_, causal=causal, window=window,
            **fp32_times)

    dense = flash_entry(*DENSE_PREFILL, 16, 128, 0, 5)
    hybrid = flash_entry(*HYBRID_PREFILL, 16, 256, 2048, 5)
    hd32 = flash_entry(*DENSE_PREFILL, HD32_HEADS, 32, 0, 5, time_fp32=True,
                       draw=zoo_randn)
    # phase 3o's shapes (24 launches each on the main path)
    h_o, hd_o = cfg_o.n_heads, cfg_o.head_dim
    encdec_flash = {
        "encdec_encoder": flash_entry(*ENCDEC_FRAMES, h_o, hd_o, 0, 5,
                                      draw=zoo_randn, causal=False),
        "encdec_self": flash_entry(*ENCDEC_TOKENS, h_o, hd_o, 0, 5,
                                   draw=zoo_randn),
        "encdec_cross": flash_entry(*ENCDEC_TOKENS, h_o, hd_o, 0, 5,
                                    draw=zoo_randn, causal=False,
                                    skv_=ENCDEC_FRAMES[1])}
    flash_by_path = {
        "prefill_dense": launches_g["flash_attention"],
        "prefill_hybrid": launches_h["flash_attention"],
        "prefill_moe": launches_m["flash_attention"],
        "prefill_fusion": launches_n["flash_attention"],
        "encdec": launches_o["flash_attention"]}
    kernels.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention_tc.cu",
        replaces="src/repro/kernels/flash_attention/flash.py:73",
        launches=sum(flash_by_path.values()),
        launches_by_path=flash_by_path, **dense, hybrid=hybrid, hd32=hd32,
        **encdec_flash))

    # wkv_chunked at the serving prefill's shape: one chunk of a wave
    # (B=4, S=64, H=32, hd=64), bf16 r, k, v, fp32 decay logs and state,
    # under both compute dtypes (3f passes bf16).  bf16 compute: out and
    # state within 2^-8 x max of the plain chunk form with its roundings,
    # and out within the existing 2^-8 x max of the fp32 oracle and within
    # twice the plain chunk form's gap to that oracle (phase 2's bar); fp32
    # compute: within 1e-5 of both (out rounded to bf16: 2^-8).  Bound:
    # about 4 hd^2 operations per token and head (the products at the
    # compute dtype's tensor-core rate, every one as fp32 in
    # bound_fp32_ms), or the bytes, whichever is larger.  No library call
    # computes it.
    wb, ws, wh, whd = scfg_f.wave, scfg_f.prefill_chunk, \
        cfg_f.d_model // cfg_f.rwkv_head_dim, cfg_f.rwkv_head_dim
    wr, wk, wv = (randn(wb, ws, wh, whd).to(torch.bfloat16)
                  for _ in range(3))
    wlogw = -torch.exp(randn(wb, ws, wh, whd))
    wu, wst = randn(wh, whd), randn(wb, wh, whd, whd)
    want, want_st = wkv_ref(wr, wk, wv, wlogw, wu, wst)
    n_tok = wb * ws * wh
    w_bytes = (n_tok * whd * (3 * 2 + 4 + 2) + 4.0 * wh * whd
               + 2 * 4.0 * wb * wh * whd * whd)
    wkv_rows = {}
    for cd in ("bf16", "fp32"):
        def call():
            return wkv_chunked(wr, wk, wv, wlogw, wu, wst, compute_dtype=cd)

        out, new_st = call()
        plain, plain_st = wkv_chunked_ref(wr, wk, wv, wlogw, wu, wst,
                                          compute_dtype=cd)
        name = f"wkv ({wb}, {ws}, {wh}, {whd}) bf16, {cd} compute"
        if cd == "bf16":
            # The gaps to the fp32 oracle are held below, on every draw.
            rel = rel_check(name, out.float(), plain, 2 ** -8)
            rel_st = rel_check(f"{name} state", new_st, plain_st, 2 ** -8)
            rel_oracle = max_err(torch, out.float(), want) / float(
                want.abs().max())
            b, by, b32 = assign_bound_ms(0.0, 4.0 * whd * whd * n_tok,
                                         "bf16", w_bytes)
        else:
            rel = max(rel_check(name, out.float(), plain, 2 ** -8),
                      rel_check(f"{name} oracle", out.float(), want, 2 ** -8))
            rel_st = max(rel_check(f"{name} state", new_st, plain_st, 1e-5),
                         rel_check(f"{name} state oracle", new_st, want_st,
                                   1e-5))
            rel_oracle = max_err(torch, out.float(), want) / float(
                want.abs().max())
            b, by, b32 = split_bound_ms(4.0 * whd * whd * n_tok, w_bytes)
        t_dev, dev_how = device_ms(torch, call)
        wkv_rows[cd] = dict(
            max_abs_err=max_err(torch, out.float(), plain), rel_err=rel,
            state_rel_err=rel_st, oracle_rel_err=rel_oracle,
            plain_oracle_rel_err=max_err(torch, plain, want) / float(
                want.abs().max()),
            plain_bf16_oracle_rel_err=max_err(
                torch, plain.to(out.dtype).float(), want) / float(
                want.abs().max()),
            ms=time_ms(torch, call, 20), device_ms=t_dev,
            device_time_by=dev_how,
            plain_ms=time_ms(torch, lambda: wkv_chunked_ref(
                wr, wk, wv, wlogw, wu, wst, compute_dtype=cd), 3),
            bound_ms=b, bound_by=by, bound_fp32_ms=b32, library_ms=None)
        print(f"  {name}: {wkv_rows[cd]['ms']:.4f} ms at the wrapper, "
              f"device time {t_dev:.4f} ms ({dev_how}); bound {b:.4f} by "
              f"{by}; out {rel:.3e} and state "
              f"{rel_st:.3e} x max of the plain chunk form; out "
              f"{rel_oracle:.3e} of the fp32 oracle (plain chunk form "
              f"{wkv_rows[cd]['plain_oracle_rel_err']:.3e}, its output "
              f"rounded to bf16 "
              f"{wkv_rows[cd]['plain_bf16_oracle_rel_err']:.3e})")
    # bf16 compute against the fp32 oracle over WKV_DRAWS input draws: the
    # draw above and WKV_DRAWS - 1 from a generator of their own (so that
    # no other check's inputs move).  On every draw the kernel is held to
    # the plain chunk form at 2^-8 (out and state), and its gap to the
    # oracle to at most twice the plain chunk form's (its output rounded
    # to bf16, as the kernel's is: the reference's own bf16 rounding).
    # No absolute bar on that gap: on an H100 the plain chunk form itself
    # missed 2^-8 on the fifth of these draws (3.970e-3 x max), so such a
    # bar tests the reference's bf16 arithmetic, not the port.  Every
    # draw is printed before any bar is applied.
    wkv_gen = torch.Generator(device="cpu").manual_seed(WKV_DRAW_SEED)

    def wkv_draw():
        def rn(*shape):
            return torch.randn(*shape, generator=wkv_gen).to(dev)

        r_, k_, v_ = (rn(wb, ws, wh, whd).to(torch.bfloat16)
                      for _ in range(3))
        return (r_, k_, v_, -torch.exp(rn(wb, ws, wh, whd)), rn(wh, whd),
                rn(wb, wh, whd, whd))

    draws = [(wr, wk, wv, wlogw, wu, wst)] + [wkv_draw()
                                              for _ in range(WKV_DRAWS - 1)]
    wkv_draw_rows = []
    for i, args in enumerate(draws):
        out, new_st = wkv_chunked(*args, compute_dtype="bf16")
        plain, plain_st = wkv_chunked_ref(*args, compute_dtype="bf16")
        want, _ = wkv_ref(*args)
        scale = float(want.abs().max())
        row = dict(
            oracle_rel_err=max_err(torch, out.float(), want) / scale,
            plain_bf16_oracle_rel_err=max_err(
                torch, plain.to(out.dtype).float(), want) / scale,
            plain_rel_err=max_err(torch, out.float(), plain) / float(
                plain.abs().max()),
            state_rel_err=max_err(torch, new_st, plain_st) / float(
                plain_st.abs().max()),
            finite=bool(torch.isfinite(out).all()
                        and torch.isfinite(new_st).all()))
        row["ratio"] = row["oracle_rel_err"] / max(
            row["plain_bf16_oracle_rel_err"], 1e-30)
        wkv_draw_rows.append(row)
        print(f"  wkv bf16 draw {i}: kernel {row['oracle_rel_err']:.3e} x "
              f"max of the fp32 oracle, plain chunk form rounded to bf16 "
              f"{row['plain_bf16_oracle_rel_err']:.3e}, ratio "
              f"{row['ratio']:.3f}; kernel against the plain chunk form: "
              f"out {row['plain_rel_err']:.3e}, state "
              f"{row['state_rel_err']:.3e}")
    for i, row in enumerate(wkv_draw_rows):
        require(row["finite"], f"wkv bf16 draw {i}: non-finite output")
        require(row["plain_rel_err"] <= 2 ** -8
                and row["state_rel_err"] <= 2 ** -8,
                f"wkv bf16 draw {i}: kernel disagrees with the plain chunk "
                f"form (out {row['plain_rel_err']:.3e}, state "
                f"{row['state_rel_err']:.3e} > 2^-8)")
        require(row["oracle_rel_err"] <= max(
                    2 * row["plain_bf16_oracle_rel_err"], 1e-5),
                f"wkv bf16 draw {i}: gap to the fp32 oracle "
                f"{row['oracle_rel_err']:.3e} is over twice the plain chunk "
                f"form's {row['plain_bf16_oracle_rel_err']:.3e}")
    wkv_rows["bf16"]["draws"] = wkv_draw_rows
    kernels.append(dict(
        name="wkv_chunked", route="cuda",
        source="src/repro_torch/kernels/csrc/recurrent_scan.cu",
        replaces="src/repro/kernels/recurrent_scan/recurrent_scan.py:97",
        launches=launches_f["wkv_chunked"], **wkv_rows["bf16"],
        shape=[wb, ws, wh, whd], compute_dtype="bf16",
        fp32_compute=wkv_rows["fp32"]))

    # linear_scan at the hybrid prefill's shape (B=1, S=4096, D=4096), on
    # its TMA route.
    lb, (ls, ld) = HYBRID_PREFILL[0], (HYBRID_PREFILL[1], 4096)
    la_ = -torch.exp(randn(lb, ls, ld) - 1)
    x_, h0_ = randn(lb, ls, ld), randn(lb, ld)
    got_h, got_last = linear_scan(la_, x_, h0_)
    want_h, want_last = linear_scan_ref(la_, x_, h0_)
    require(torch.equal(got_h, want_h) and torch.equal(got_last, want_last),
            "linear_scan at the prefill shape differs from plain")
    scan_plan = linear_scan_plan(lb, ls, ld)
    print(f"  linear_scan ({lb}, {ls}, {ld}): equal to plain (exact), "
          f"{scan_plan.route} route, {scan_plan.tokens} tokens x "
          f"{scan_plan.stages} stages, {scan_plan.blocks} blocks")
    scan_bytes = 4.0 * (3 * lb * ls * ld + 2 * lb * ld)
    b, by = bound_ms(2.0 * lb * ls * ld, scan_bytes)
    t_kernel = time_ms(torch, lambda: linear_scan(la_, x_, h0_), 10)
    t_dev, dev_how = device_ms(torch, lambda: linear_scan(la_, x_, h0_))
    kernels.append(dict(
        name="linear_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/recurrent_scan.cu",
        replaces="src/repro/kernels/recurrent_scan/recurrent_scan.py:166",
        launches=launches_h["linear_scan"], max_abs_err=0.0,
        ms=t_kernel, device_ms=t_dev, device_time_by=dev_how,
        plain_ms=time_ms(torch, lambda: linear_scan_ref(la_, x_, h0_), 2),
        bound_ms=b, bound_by=by, library_ms=None, shape=[lb, ls, ld],
        load_route=scan_plan.route, gb_per_s=scan_bytes / t_dev / 1e6))
    print(f"  linear_scan: {t_kernel:.4f} ms a call, device time "
          f"{t_dev:.4f} ms ({dev_how}), {scan_bytes / t_dev / 1e6:.0f} GB/s, "
          f"bound {b:.4f} by {by}")
    print(f"  flash_attention hd 32 {hd32['shape']} fp32 inputs (the "
          f"CUDA-core kernel): {hd32['fp32_ms']:.3f} ms (plain "
          f"{hd32['fp32_plain_ms']:.3f})")
    for e in (dense, hybrid, hd32, *encdec_flash.values()):
        print(f"  flash_attention shape {e['shape']} Skv {e['skv']} "
              f"{'causal' if e['causal'] else 'bidirectional'} window "
              f"{e['window']}: "
              f"{e['ms']:.3f} ms (plain {e['plain_ms']:.3f}, library "
              f"{e['library_ms']:.3f}, bound {e['bound_ms']:.4f} by "
              f"{e['bound_by']}, {e['bound_fp32_pv_ms']:.4f} with p.v at the "
              f"fp32 rate); fp32 inputs rel_err {e['fp32_rel_err']:.3e}"
              f" (tolerance 1e-5); bf16 max_abs_err {e['max_abs_err']:.3e}, "
              f"{e['bf16_limit_used']:.3f} of the element-wise limit, with "
              f"fp32 output rel_err {e['fp32_out_rel_err']:.3e} (tolerance "
              f"1e-5)")

    print(f"  assign_wave landmark shape {list(land_v.shape)} x "
          f"{land_protos.shape[0]}: {wave['ms']:.3f} ms (plain "
          f"{wave['plain_ms']:.3f}, library {wave['library_ms']:.3f}, bound "
          f"{wave['bound_ms']:.4f} by {wave['bound_by']}, "
          f"{wave['bound_fp32_ms']:.4f} all on the fp32 cores)")
    for dt, e in serving.items():
        print(f"  assign_wave serving shape ({b_}, {t_}, {d_}, {k_}) {dt} "
              f"table: {e['ms']:.3f} ms (plain {e['plain_ms']:.3f}, library "
              f"{e['library_ms']:.3f}, bound {e['bound_ms']:.4f} by "
              f"{e['bound_by']}, {e['bound_fp32_ms']:.4f} all on the fp32 "
              f"cores); device time {e['device_ms']:.4f} ms, library "
              f"{e['library_device_ms']:.4f} ({e['device_time_by']})")
    e = kernels[[k["name"] for k in kernels].index("assign_one")]
    print(f"  assign_one serving shape: device time {e['device_ms']:.4f} ms "
          f"a call, library {e['library_device_ms']:.4f} "
          f"({e['device_time_by']}); wrapper-level events {e['ms']:.4f}")
    e = kernels[[k["name"] for k in kernels].index("featurize_gram")]["bf16"]
    print(f"  featurize_gram bf16 at the raw shape: {e['ms']:.3f} ms (plain "
          f"{e['plain_ms']:.3f}, library {e['library_ms']:.3f} "
          f"({e['library_call']}), bound {e['bound_ms']:.4f} by "
          f"{e['bound_by']}), max_abs_err {e['max_abs_err']:.3e}")
    for kern in kernels:
        lib = kern["library_ms"]
        print(f"  {kern['name']}: {kern['ms']:.3f} ms (plain "
              f"{kern['plain_ms']:.3f}, library "
              f"{'none' if lib is None else f'{lib:.3f}'}, bound "
              f"{kern['bound_ms']:.4f} by {kern['bound_by']}"
              + (f", {kern['bound_fp32_ms']:.4f} all on the fp32 cores"
                 if "bound_fp32_ms" in kern else "") + "), "
              f"max_abs_err {kern['max_abs_err']:.3e}, launches "
              f"{kern['launches']}")
    check_physical(kernels)
    print("  every device time at or above its bound, every rate at most "
          "1.05x the memory's peak")

    phase_done("phase 4")

    # -- Phase 5: eigh backends (measurement only) -------------------------
    print(f"[5] torch.linalg.eigh on {EIGH_GRAMS} of the dense cell's Grams "
          f"({d_} x {d_}, fp32), by backend")
    summary["eigh_backends"] = eigh_backends(torch, grams[:EIGH_GRAMS], sim,
                                             n_ // EIGH_GRAMS)
    phase_done("phase 5")
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    summary["total_s"] = time.perf_counter() - t_start
    print(json.dumps(summary))
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
