#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root, with one card and no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each kernel against its plain PyTorch version on the card, and
drives the port's three paths of ``one_shot_clustering`` (paper
Algorithm 2) at full width:

  [3]  dense, on pre-featurised users: N=1024 x n=256 x d=512, T=4,
       top_k=8;
  [3b] blockwise (``block_users=128``) on the same users;
  [3c] raw data: the paper's CIFAR two-task layout, N=1024 users x
       n=252 rows x m=3072 pixels, T=2, through a shared random
       projection to d=512 (the paper's CIFAR feature width), streamed
       in 128-row chunks, with the top-k subspace iteration.

Each path runs with the kernel launch counts set to 0 just before it
and read just after.  Phase [4] times each kernel beside its plain
version, one library call and its bound.  Every phase must pass; the
last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

preceded by a ``{"kernels": [...]}`` line and the card's name and power
limit.  Without a CUDA device, or outside the repository, it exits
non-zero and prints no result.  It imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

# Main-path cell: the paper's CIFAR-10 feature width (pooled ResNet18).
N_USERS, N_SAMPLES, DIM, TASKS, TOP_K, SEED = 1024, 256, 512, 4, 8, 0
# Blockwise path: users per tile.
BLOCK_USERS = 128
# Raw path: the paper's CIFAR two-task layout (Fig. 2) at 512 users per
# task, raw 32x32x3 pixels, projected to d=512, streamed in row chunks.
RAW_USERS_PER_TASK, RAW_ROWS_PER_USER, RAW_CHUNK_ROWS = 512, 256, 128

# Published H100 SXM peaks (NVIDIA data sheet, 700 W): fp32 outside the
# tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np

    from repro_torch.core import clustering as clu
    from repro_torch.core import similarity as sim
    from repro_torch.core.cluster_engine import (ClusterConfig, ClusterEngine,
                                                 cut_device)
    from repro_torch.core.oneshot import one_shot_clustering
    from repro_torch.core.signature_engine import (SignatureConfig,
                                                   SignatureEngine,
                                                   subspace_residual)
    from repro_torch.data.features import FeatureConfig
    from repro_torch.data.partition import paper_cifar_two_task
    from repro_torch.data.synthetic import make_task_feature_mixture
    from repro_torch.kernels import build, dispatch
    from repro_torch.kernels.eigproject import (project_norms_all,
                                                project_norms_all_ref)
    from repro_torch.kernels.featurize_gram import (batched_featurize_gram,
                                                    featurize_gram_ref)
    from repro_torch.kernels.gram import batched_gram_matrix, gram_ref
    from repro_torch.kernels.gram_project import (batched_gram_project,
                                                  gram_project_ref)
    from repro_torch.kernels.linkage import (LINKAGES, linkage_step,
                                             linkage_step_ref, nn_chain,
                                             nn_chain_ref)

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cpu").manual_seed(SEED)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    t_start = time.perf_counter()
    t_phase = [t_start]

    def phase_done(name):
        now = time.perf_counter()
        print(f"    ({name} took {now - t_phase[0]:.1f} s)")
        t_phase[0] = now

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
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print("    ptxas:", line.strip())
    phase_done("phase 1")

    # -- Phase 2: each kernel against its plain version -------------------
    print("[2] kernels vs plain versions on the card")
    x = randn(64, 256, 512)
    check_close(torch, "gram (64, 256, 512)", batched_gram_matrix(x),
                gram_ref(x), 1e-5)
    x = randn(16, 300, 784)
    n_valid = torch.randint(1, 300, (16,), generator=gen).to(dev)
    x[torch.arange(300, device=dev)[None, :] >= n_valid[:, None]] = 0.0
    check_close(torch, "gram ragged (16, 300, 784)",
                sim.batched_gram(x, n_valid.float()),
                gram_ref(x) / n_valid.float()[:, None, None], 1e-5)
    for n, d, k in [(64, 512, 8), (33, 784, 5)]:
        g = randn(n, d, d)
        g = g @ g.transpose(1, 2) / d
        v = torch.linalg.qr(randn(n, d, k))[0]
        check_close(torch, f"eigproject ({n}, {d}, {k})",
                    project_norms_all(g, v), project_norms_all_ref(g, v), 1e-5)
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
    r = np.random.default_rng(SEED).uniform(size=(300, 300))
    s300 = torch.tensor((r + r.T) / 2, dtype=torch.float32, device=dev)
    s300.fill_diagonal_(float("-inf"))
    for linkage in LINKAGES:
        m_k, h_k, t_k = nn_chain(s300.clone(), linkage)
        m_p, h_p, t_p = nn_chain_ref(s300.clone(), linkage)
        require(int(t_k) == int(t_p) == 299,
                f"nn_chain {linkage}: merges {int(t_k)} vs {int(t_p)}")
        require(torch.equal(torch.sort(h_k)[0], torch.sort(h_p)[0]),
                f"nn_chain {linkage}: sorted heights differ")
        for t in (1, 4, 300):
            require(torch.equal(cut_device(m_k, h_k, 300, t),
                                cut_device(m_p, h_p, 300, t)),
                    f"nn_chain {linkage}: labels differ at T={t}")
    print("  nn_chain (300 leaves): merges, sorted heights and labels "
          "equal to the plain loop (exact) for all three linkages")
    # featurize_gram: fp32 to 1e-5 x max; bf16 against the plain
    # bf16-rounding version at the reference's 2e-2 x max.
    for n_users, c, m, d in [(16, 128, 3072, 512), (16, 300, 784, 100)]:
        x = randn(n_users, c, m)
        counts = torch.randint(1, c + 1, (n_users,), generator=gen).to(dev)
        x[torch.arange(c, device=dev)[None, :] >= counts[:, None]] = 0.0
        w = randn(m, d) / d ** 0.5
        for cd, tol in (("fp32", 1e-5), ("bf16", 2e-2)):
            out = batched_featurize_gram(x, w, cd)
            check_close(torch, f"featurize_gram {cd} ragged "
                        f"({n_users}, {c}, {m}) x ({m}, {d})", out,
                        featurize_gram_ref(x, w, cd), tol)
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
        check_close(torch, f"gram_project ragged ({n_users}, {n}, {d}) x "
                    f"({d}, {k_cols})",
                    batched_gram_project(x, v, counts.float()),
                    gram_project_ref(x, v, counts.float()), 1e-5)
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

    # -- Phase 4: kernel times at the main path's shapes ------------------
    print("[4] kernels vs plain versions and times at the main-path "
          "shapes (CUDA events)")
    n_, m_, d_, k_ = N_USERS, N_SAMPLES, DIM, TOP_K
    kernels = []

    gram_err = check_close(torch, f"gram ({n_}, {m_}, {d_})",
                           batched_gram_matrix(x), gram_ref(x), 1e-5)
    t_kernel = time_ms(torch, lambda: batched_gram_matrix(x), 5)
    t_plain = time_ms(torch, lambda: gram_ref(x), 5)
    t_lib = time_ms(torch, lambda: torch.bmm(x.transpose(1, 2), x), 5)
    # X^T X is symmetric: the function needs one triangle and its
    # diagonal, N * n * d * (d + 1) operations (a syrk's count).
    b, by = bound_ms(1.0 * n_ * m_ * d_ * (d_ + 1),
                     4.0 * (n_ * m_ * d_ + n_ * d_ * d_))
    kernels.append(dict(
        name="gram", route="cuda",
        source="src/repro_torch/kernels/csrc/gram.cu",
        replaces="src/repro/kernels/gram/gram.py:40",
        launches=launches["gram"], max_abs_err=gram_err, ms=t_kernel,
        plain_ms=t_plain, bound_ms=b, bound_by=by, library_ms=t_lib))

    def library_norms():
        out = torch.empty((n_, n_, k_), device=dev)
        for s in range(0, n_, 16):
            out[s:s + 16] = torch.linalg.vector_norm(
                torch.matmul(grams[s:s + 16, None], v[None]), dim=-2)
        return out

    proj_err = check_close(torch, f"eigproject ({n_}, {d_}, {k_})",
                           project_norms_all(grams, v),
                           project_norms_all_ref(grams, v), 1e-5)
    t_kernel = time_ms(torch, lambda: project_norms_all(grams, v), 3)
    t_plain = time_ms(torch, lambda: project_norms_all_ref(grams, v), 3)
    t_lib = time_ms(torch, library_norms, 3)
    b, by = bound_ms(2.0 * n_ * n_ * d_ * d_ * k_,
                     4.0 * (n_ * d_ * d_ + n_ * d_ * k_ + n_ * n_ * k_))
    kernels.append(dict(
        name="eigproject", route="cuda",
        source="src/repro_torch/kernels/csrc/eigproject.cu",
        replaces="src/repro/kernels/eigproject/eigproject.py:53",
        launches=launches["eigproject"], max_abs_err=proj_err, ms=t_kernel,
        plain_ms=t_plain, bound_ms=b, bound_by=by, library_ms=t_lib))

    prepared = big_r.clone()
    prepared.fill_diagonal_(float("-inf"))
    work = prepared.clone()

    def reset():
        work.copy_(prepared)

    m_k, h_k, t_k = nn_chain(prepared.clone())
    t_plain0 = time.perf_counter()
    m_p, h_p, t_p = nn_chain_ref(prepared.clone())
    torch.cuda.synchronize()
    t_plain = (time.perf_counter() - t_plain0) * 1e3
    require(int(t_k) == int(t_p) == n_ - 1 and torch.equal(m_k, m_p)
            and torch.equal(h_k, h_p),
            "nn_chain at the main-path R differs from the plain loop")
    print(f"  nn_chain ({n_} leaves): merges and heights equal to the "
          f"plain loop (exact)")
    chain_err = max_err(torch, h_k, h_p)
    t_kernel = time_ms(torch, lambda: nn_chain(work), 5, setup=reset)
    b, by = bound_ms(4.0 * n_ * (n_ - 1), 4.0 * n_ * n_ + 12.0 * (n_ - 1))
    kernels.append(dict(
        name="linkage", route="cuda",
        source="src/repro_torch/kernels/csrc/linkage.cu",
        replaces="src/repro/kernels/linkage/linkage.py:68",
        launches=launches["linkage"], max_abs_err=chain_err, ms=t_kernel,
        plain_ms=t_plain, bound_ms=b, bound_by=by, library_ms=None))

    # featurize_gram at the raw path's shapes, all rows in one launch.
    w_raw = engine.params_for(m_raw)["w"]
    fg_err = check_close(torch, f"featurize_gram ({n_raw}, {rows_raw}, "
                         f"{m_raw}) x ({m_raw}, {DIM})",
                         batched_featurize_gram(raw_x, w_raw),
                         featurize_gram_ref(raw_x, w_raw), 1e-5)
    t_kernel = time_ms(torch, lambda: batched_featurize_gram(raw_x, w_raw), 3)
    t_plain = time_ms(torch, lambda: featurize_gram_ref(raw_x, w_raw), 3)

    def library_featurize():
        f = raw_x @ w_raw
        return torch.bmm(f.transpose(1, 2), f)

    t_lib = time_ms(torch, library_featurize, 3)
    # The projection, then one triangle of the symmetric Gram.
    b, by = bound_ms(1.0 * n_raw * (2.0 * rows_raw * m_raw * DIM
                                    + rows_raw * DIM * (DIM + 1)),
                     4.0 * (n_raw * rows_raw * m_raw + m_raw * DIM
                            + n_raw * DIM * DIM))
    kernels.append(dict(
        name="featurize_gram", route="cuda",
        source="src/repro_torch/kernels/csrc/featurize_gram.cu",
        replaces="src/repro/kernels/featurize_gram/featurize_gram.py:94",
        launches=launches_r["featurize_gram"], max_abs_err=fg_err,
        ms=t_kernel, plain_ms=t_plain, bound_ms=b, bound_by=by,
        library_ms=t_lib))

    # gram_project at the blockwise path's shapes, all users in one launch.
    k_all = v_flat.shape[1]
    gp_err = check_close(torch, f"gram_project ({n_}, {m_}, {d_}) x "
                         f"({d_}, {k_all})", batched_gram_project(x, v_flat),
                         gram_project_ref(x, v_flat), 1e-5)
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
    b, by = bound_ms(4.0 * n_ * m_ * d_ * k_all,
                     4.0 * (n_ * m_ * d_ + d_ * k_all + n_ * k_all))
    kernels.append(dict(
        name="gram_project", route="cuda",
        source="src/repro_torch/kernels/csrc/gram_project.cu",
        replaces="src/repro/kernels/gram_project/gram_project.py:99",
        launches=launches_b["gram_project"], max_abs_err=gp_err,
        ms=t_kernel, plain_ms=t_plain, bound_ms=b, bound_by=by,
        library_ms=t_lib))
    for kern in kernels:
        lib = kern["library_ms"]
        print(f"  {kern['name']}: {kern['ms']:.3f} ms (plain "
              f"{kern['plain_ms']:.3f}, library "
              f"{'none' if lib is None else f'{lib:.3f}'}, bound "
              f"{kern['bound_ms']:.4f} by {kern['bound_by']}), "
              f"max_abs_err {kern['max_abs_err']:.3e}, launches "
              f"{kern['launches']}")

    phase_done("phase 4")
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
