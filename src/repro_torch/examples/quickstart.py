"""Quickstart: one-shot data-similarity clustering, the port's
counterpart of ``examples/quickstart.py``.

Builds the paper's CIFAR-10 two-task federation (synthetic stand-in),
runs Algorithm 2 (Gram spectra -> eigenvector exchange -> relevance ->
HAC) on the CUDA device, and prints the similarity matrix, the recovered
clusters and the communication ledger.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
    PYTHONPATH=src python -m repro_torch.examples.quickstart \\
        --cluster-backend numpy
    PYTHONPATH=src python -m repro_torch.examples.quickstart --host-ingest
    PYTHONPATH=src python -m repro_torch.examples.quickstart --arrivals 4

``--cluster-backend torch`` (the default) runs the NN-chain HAC on the
device; ``numpy`` the host reference HAC.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import clustering as clu
from repro_torch.core import oneshot
from repro_torch.core.cluster_engine import ClusterConfig
from repro_torch.core.membership_engine import (MembershipConfig,
                                                MembershipEngine)
from repro_torch.core.signature_engine import (SignatureConfig,
                                               SignatureEngine)
from repro_torch.core.similarity import SimilarityConfig
from repro_torch.data import features as feat
from repro_torch.data import partition as dpart
from repro_torch.examples.common import to_host
from repro_torch.kernels.dispatch import resolve_device


def main(argv=None) -> dict:
    """Run the quickstart; returns R, the labels, the accuracy, the
    ledger summary and, with ``--arrivals``, the newcomers' labels and
    margins."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--cluster-backend", default="torch",
                    choices=["torch", "numpy"],
                    help="GPS decision layer: the device NN-chain "
                         "ClusterEngine or the host reference HAC")
    ap.add_argument("--host-ingest", action="store_true",
                    help="featurize per user with host numpy instead of "
                         "the device SignatureEngine")
    ap.add_argument("--arrivals", type=int, default=0, metavar="B",
                    help="serve B streaming newcomers AFTER the one-shot "
                         "round via the MembershipEngine cluster directory "
                         "(no protocol re-run)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 10 users, 2 tasks (vehicles / animals), 10% minority labels.
    users = dpart.paper_cifar_two_task(n_per_user=400, seed=0)
    print(f"{len(users)} users; true tasks:", [u.task_id for u in users])

    # Phi: fixed shared random projection (ResNet18 surrogate)
    fc = feat.FeatureConfig(kind="random_projection", d=128)

    if args.host_ingest:
        # Host path: numpy Phi per user, the protocol sees feature
        # matrices.
        feats = [feat.feature_map(u.x, fc) for u in users]
        res = oneshot.one_shot_clustering(
            feats, n_clusters=2, cfg=SimilarityConfig(top_k=8),
            cluster_cfg=ClusterConfig(backend=args.cluster_backend),
            model_params=62_006, device=device)  # paper CNN size
    else:
        # Raw-data entry point: raw shards and the FeatureConfig; the
        # SignatureEngine featurizes on the device, streaming 128-row
        # chunks, and extracts top-k signatures by subspace iteration.
        res = oneshot.one_shot_clustering(
            [u.x for u in users], n_clusters=2,
            cfg=SimilarityConfig(top_k=8),
            cluster_cfg=ClusterConfig(backend=args.cluster_backend),
            feature_cfg=fc, signature_cfg=SignatureConfig(chunk_rows=128),
            model_params=62_006, device=device)

    big_r = to_host(res.similarity)
    labels = to_host(res.labels)
    np.set_printoptions(precision=2, suppress=True)
    print("\nSimilarity matrix R (paper Table I analogue):")
    print(big_r)
    print(f"\nClusters ({args.cluster_backend} backend):", labels)
    acc = clu.clustering_accuracy(labels, [u.task_id for u in users])
    print(f"Clustering accuracy vs oracle: {acc:.0%}")
    print("\nCommunication ledger (one-shot, before any training):")
    ledger = res.ledger.summary()
    for k, v in ledger.items():
        print(f"  {k}: {v}")
    out = {"similarity": big_r, "labels": labels, "accuracy": acc,
           "ledger": ledger}

    if args.arrivals:
        # Streaming arrivals: newcomers who missed the one-shot round.
        # Their cluster comes from the directory the GPS kept: one
        # (k x d) signature upload, one label download, no re-run.
        newcomers = dpart.paper_cifar_two_task(
            n_per_user=400, seed=1,
            users_per_task=(args.arrivals - args.arrivals // 2,
                            args.arrivals // 2))
        sig_engine = SignatureEngine(fc, SignatureConfig(chunk_rows=128),
                                     device=device)
        lam_w, v_w, _ = sig_engine.signatures([u.x for u in newcomers],
                                              top_k=8)
        engine = MembershipEngine.from_oneshot(
            res, MembershipConfig(backend=args.cluster_backend),
            device=device)
        assigned = engine.assign(lam_w, v_w)
        engine.admit(lam_w, v_w, assigned.labels)
        arr_labels = to_host(assigned.labels)
        margins = to_host(assigned.margin)
        print(f"\nStreaming arrivals ({args.arrivals} newcomers, no "
              f"protocol re-run):")
        for u, l, m in zip(newcomers, arr_labels, margins):
            print(f"  newcomer task {u.task_id} -> cluster {l} "
                  f"(margin {m:.3f})")
        led = res.ledger
        print(f"arrival upload {led.assign_upload} B vs protocol "
              f"per-user upload {led.per_user_upload} B; download "
              f"{led.assign_download} B (one label)")
        out.update(arrival_tasks=[u.task_id for u in newcomers],
                   arrival_labels=arr_labels, arrival_margins=margins)
    return out


if __name__ == "__main__":
    main()
