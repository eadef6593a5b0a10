#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root, with one card and no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each kernel against its plain PyTorch version on the card, drives
the port's main path (``one_shot_clustering``, paper Algorithm 2) at
full width, N=1024 users x n=256 samples x d=512 features, T=4 tasks,
top_k=8, and times each kernel beside its plain version, one library
call and its bound.  Every phase must pass; the last line is

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
    from repro_torch.data.synthetic import make_task_feature_mixture
    from repro_torch.kernels import build, dispatch
    from repro_torch.kernels.eigproject import (project_norms_all,
                                                project_norms_all_ref)
    from repro_torch.kernels.gram import batched_gram_matrix, gram_ref
    from repro_torch.kernels.linkage import (LINKAGES, linkage_step,
                                             linkage_step_ref, nn_chain,
                                             nn_chain_ref)

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cpu").manual_seed(SEED)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    # -- Phase 1: device and build ---------------------------------------
    t_start = time.perf_counter()
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
    dispatch.reset_launches()
    t0 = time.perf_counter()
    res = one_shot_clustering(x, TASKS, cfg=cfg, cluster_cfg=ccfg,
                              device=dev)
    labels = res.labels.cpu().numpy()
    wall = time.perf_counter() - t0
    launches = dict(dispatch.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    acc = clu.clustering_accuracy(labels, task_ids)
    print(f"  launches: {launches}")
    print(f"  wall {wall:.3f} s, peak device memory {peak / 2**30:.2f} GiB, "
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
    for kern in kernels:
        lib = kern["library_ms"]
        print(f"  {kern['name']}: {kern['ms']:.3f} ms (plain "
              f"{kern['plain_ms']:.3f}, library "
              f"{'none' if lib is None else f'{lib:.3f}'}, bound "
              f"{kern['bound_ms']:.4f} by {kern['bound_by']}), "
              f"max_abs_err {kern['max_abs_err']:.3e}, launches "
              f"{kern['launches']}")

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
