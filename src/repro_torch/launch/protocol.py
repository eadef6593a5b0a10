"""Protocol launcher for the port: the one-shot clustering protocol on a
synthetic multi-task feature mixture.

  # dense, on the CUDA device (the default)
  PYTHONPATH=src python -m repro_torch.launch.protocol --users 256

  # plain PyTorch versions of the kernels, on the CPU
  PYTHONPATH=src python -m repro_torch.launch.protocol --device cpu

  # blockwise streaming: O(block * d^2) live Grams
  PYTHONPATH=src python -m repro_torch.launch.protocol --users 1024 \\
      --block-users 128

  # Nystrom-sketched relevance: every user scored against 64 landmark
  # projectors by the assign kernel, R completed from that block
  PYTHONPATH=src python -m repro_torch.launch.protocol --users 512 \\
      --landmarks 64

  # raw-data entry point: Phi + Gram streamed in row chunks, batched
  # top-k subspace iteration
  PYTHONPATH=src python -m repro_torch.launch.protocol --users 512 \\
      --raw-dim 256 --feature random_projection --dim 64 --chunk-rows 32

  # hierarchical two-level protocol: 16384 users in 64 edge groups,
  # O(G * (N/G)^2) relevance entries instead of O(N^2)
  PYTHONPATH=src python -m repro_torch.launch.protocol --users 16384 \\
      --groups 64 --group-clusters 8

  # users sharded over 4 ranks (one process a device: 4 cards over NCCL,
  # or 4 CPU processes over gloo with --device cpu)
  PYTHONPATH=src python -m repro_torch.launch.protocol --backend shard_map \\
      --devices 4

Prints the same ``clustering accuracy`` and ledger lines as
``repro.launch.protocol`` (under shard_map, rank 0 prints them).
"""
from __future__ import annotations

import argparse
import time


def main(argv: list[str] | None = None) -> float:
    """Run the launcher; returns the clustering accuracy."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--users", type=int, default=256)
    ap.add_argument("--samples", type=int, default=64)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--tasks", type=int, default=4)
    ap.add_argument("--top-k", type=int, default=8)
    ap.add_argument("--backend", default="torch",
                    choices=["torch", "shard_map"],
                    help="one device, or users sharded over --devices "
                         "ranks")
    ap.add_argument("--devices", type=int, default=1,
                    help="ranks of the shard_map backend, one process a "
                         "device (cuda:0..N-1 over NCCL, or the CPU over "
                         "gloo)")
    ap.add_argument("--cluster-backend", default="torch",
                    choices=["torch", "numpy"],
                    help="GPS decision layer: the NN-chain on --device "
                         "(keeps R there) or the host reference HAC")
    ap.add_argument("--linkage", default="average",
                    choices=["average", "single", "complete"])
    ap.add_argument("--block-users", type=int, default=0,
                    help="> 0 enables blockwise streaming")
    ap.add_argument("--landmarks", type=int, default=0,
                    help="> 0 enables the Nystrom-sketched path: users are "
                         "scored against this many landmark signatures")
    ap.add_argument("--groups", type=int, default=0,
                    help="> 0 enables the hierarchical two-level "
                         "protocol with this many edge groups")
    ap.add_argument("--group-clusters", type=int, default=0,
                    help="clusters cut per edge group (0 = --tasks)")
    ap.add_argument("--group-batch", type=int, default=0,
                    help="edge groups a batch of launches (0 = all at "
                         "once)")
    ap.add_argument("--raw-dim", type=int, default=0,
                    help="> 0 enables the RAW-DATA entry point: users hand "
                         "raw m-dim shards and the SignatureEngine "
                         "featurizes on the device (m = this value)")
    ap.add_argument("--feature", default="random_projection",
                    choices=["identity", "random_projection"],
                    help="shared Phi for the raw entry point")
    ap.add_argument("--chunk-rows", type=int, default=0,
                    help="> 0 streams raw ingest in row chunks of this "
                         "size (peak memory independent of --samples)")
    ap.add_argument("--eig", default="subspace",
                    choices=["subspace", "eigh"],
                    help="raw-path eigensolver: batched top-k subspace "
                         "iteration or exact eigh")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.devices < 1:
        ap.error(f"--devices must be >= 1, got {args.devices}")
    if args.backend != "shard_map" and args.devices != 1:
        ap.error("--devices > 1 shards users: pass --backend shard_map")
    if args.backend == "shard_map":
        from repro_torch.core.distributed import run_ranks

        return run_ranks(_shard_rank, args.devices, args.device,
                         args=(args,))[0]
    return _run(args)


def _shard_rank(rank: int, world: int, args) -> float:
    """One rank of the sharded run: the same protocol over the default
    process group's mesh; rank 0 prints."""
    from repro_torch.core.distributed import make_user_mesh

    return _run(args, mesh=make_user_mesh("data"), rank=rank, world=world)


def _run(args, mesh=None, rank: int = 0, world: int = 1) -> float:
    """The protocol on this process's device; returns the accuracy."""
    import numpy as np
    import torch

    from repro_torch.core import clustering as clu
    from repro_torch.core import oneshot
    from repro_torch.core.cluster_engine import ClusterConfig
    from repro_torch.core.hierarchy import HierarchyConfig
    from repro_torch.core.signature_engine import SignatureConfig
    from repro_torch.core.similarity import SimilarityConfig
    from repro_torch.data.features import FeatureConfig, phi_out_dim
    from repro_torch.data.synthetic import make_task_feature_mixture
    from repro_torch.kernels.dispatch import device_kind, resolve_device

    device = resolve_device(args.device)
    raw_mode = args.raw_dim > 0
    hier_mode = args.groups > 0
    mix_dim = args.raw_dim if raw_mode else args.dim
    feats, task_ids = make_task_feature_mixture(
        args.users, args.samples, mix_dim, args.tasks, seed=args.seed)
    cfg = SimilarityConfig(top_k=args.top_k, backend=args.backend,
                           block_users=args.block_users,
                           landmarks=args.landmarks)
    ccfg = ClusterConfig(backend=args.cluster_backend, linkage=args.linkage)
    hierarchy_cfg = None
    if hier_mode:
        hierarchy_cfg = HierarchyConfig(n_groups=args.groups,
                                        group_clusters=args.group_clusters,
                                        group_batch=args.group_batch)
    feature_cfg = signature_cfg = None
    shape = f"d={args.dim}"
    if raw_mode:
        feature_cfg = FeatureConfig(kind=args.feature, d=args.dim,
                                    seed=args.seed)
        signature_cfg = SignatureConfig(backend=args.backend,
                                        chunk_rows=args.chunk_rows,
                                        eig=args.eig)
        shape = (f"m={mix_dim} -> d={phi_out_dim(feature_cfg, mix_dim)} "
                 f"({args.feature})")
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"{args.users} users x {args.samples} samples x {shape}, "
        f"{args.tasks} tasks | backend={args.backend} "
        f"device={device_kind(device)} "
        f"cluster_backend={args.cluster_backend} "
        f"block_users={args.block_users} landmarks={args.landmarks} "
        f"groups={args.groups} raw={raw_mode} "
        f"chunk_rows={args.chunk_rows} devices={world}")

    t0 = time.perf_counter()
    res = oneshot.one_shot_clustering(
        feats if raw_mode else torch.from_numpy(feats),
        n_clusters=args.tasks, cfg=cfg, cluster_cfg=ccfg,
        feature_cfg=feature_cfg, signature_cfg=signature_cfg, device=device,
        hierarchy_cfg=hierarchy_cfg, mesh=mesh)
    labels = np.asarray(torch.as_tensor(res.labels).cpu())  # host sync
    dt = time.perf_counter() - t0
    acc = clu.clustering_accuracy(labels, task_ids)
    sizes = np.bincount(labels, minlength=args.tasks)
    say(f"protocol + HAC: {dt:.2f}s | clustering accuracy {acc:.1%} | "
        f"cluster sizes {sizes.tolist()}")
    led = res.ledger.summary()
    scope = (f"(per-user view WITHIN its {args.users // args.groups}-user "
             f"edge group) " if hier_mode else "")
    say(f"per-user upload {scope}"
        f"{led['per_user_upload_bytes'] / 1024:.1f} KiB, "
        f"download {led['per_user_download_bytes'] / 2**20:.2f} MiB, "
        f"GPS total {led['gps_total_bytes'] / 2**20:.2f} MiB")
    if hier_mode:
        entries = int(res.entry_counts.numel())
        say(f"directory: {args.groups} groups -> {entries} entries -> "
            f"{args.tasks} global clusters | global stage "
            f"{entries}x{entries} signature-only relevance")
    return acc


if __name__ == "__main__":
    main()
