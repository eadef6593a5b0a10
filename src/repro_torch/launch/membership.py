"""Membership serving launcher for the port: seed protocol -> arrival waves.

Mirrors ``src/repro/launch/membership.py``.  Runs the one-shot protocol
on a seed population, builds the cluster directory, then streams
synthetic arrival waves with churn (evictions) and task drift, and
reports per-wave honest accuracy against the oracle, the unassigned
fraction and every drift-triggered re-cluster.  Each cell of the
scenario matrix is a (scenario, arrival pattern) pair:

  scenario      what is corrupted
  ------------  -----------------------------------------------------
  clean         nothing
  label-noise   ``--corrupt-frac`` of every arrival's feature rows come
                from a user of another task
  byzantine     ``--corrupt-frac`` of each wave uploads adversarial
                signatures (``--byzantine-mode``)
  drift         half of each late wave comes from a task the seed never
                saw

  arrivals      wave sizes
  ------------  -----------------------------------------------------
  steady        ``--wave-size`` every wave
  bursty        alternating half and one-and-a-half waves

  # one cell on the CUDA device (the default), full per-wave trace
  PYTHONPATH=src python -m repro_torch.launch.membership --scenario drift

  # the plain versions on the CPU, a small population
  PYTHONPATH=src python -m repro_torch.launch.membership --device cpu \\
      --quick

  # the 4 x 2 matrix, one summary row per cell
  PYTHONPATH=src python -m repro_torch.launch.membership --device cpu \\
      --matrix --quick --json /tmp/matrix.json

Accuracy counts honest arrivals from seed-known tasks only.  The loop
also keeps the trainer's ``(T, C_max)`` stack layout through
``fed.partition.admit_layout``, which never changes its shape.
``--seed-groups G`` seeds the directory from the hierarchical two-level
protocol over G edge groups.  ``--events`` (telemetry) waits for
ROADMAP Queue 1 item 12.
"""
from __future__ import annotations

import argparse
import json
import time
import zlib

import numpy as np

SCENARIOS = ("clean", "label-noise", "byzantine", "drift")
ARRIVAL_PATTERNS = ("steady", "bursty")


def wave_plan(pattern: str, waves: int, wave_size: int) -> list[int]:
    """Per-wave arrival counts; every pattern admits the same total."""
    if pattern == "steady":
        return [wave_size] * waves
    lo = wave_size // 2
    hi = 2 * wave_size - lo
    sizes = [lo if w % 2 == 0 else hi for w in range(waves)]
    sizes[-1] += waves * wave_size - sum(sizes)   # odd-length tail
    return sizes


def _host(x) -> np.ndarray:
    import torch

    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def run_cell(args, scenario: str, arrivals: str, verbose: bool = True,
             return_state: bool = False):
    """One (scenario, arrival-pattern) cell: seed -> waves -> summary.

    Besides the reference's summary keys it returns per-wave timings
    (``assign_ms``, ``admit_ms``; host clock around work that ends in a
    device sync), the unassigned fraction after each wave, and each
    re-cluster's time and member count.  ``return_state=True`` returns
    ``(summary, engine, (lam, v) of the last wave)`` instead.
    """
    import torch

    from repro_torch.core import clustering as clu
    from repro_torch.core import oneshot
    from repro_torch.core.cluster_engine import ClusterConfig
    from repro_torch.core.engine import ProtocolEngine
    from repro_torch.core.hierarchy import HierarchyConfig
    from repro_torch.core.membership_engine import (MembershipConfig,
                                                    MembershipEngine)
    from repro_torch.core.similarity import SimilarityConfig
    from repro_torch.data import synthetic as syn
    from repro_torch.fed import partition as fpart
    from repro_torch.kernels.dispatch import resolve_device

    device = resolve_device(args.device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # Corruption streams are decoupled from the data stream so every cell
    # serves the SAME population (crc32: stable across processes).
    cseed = zlib.crc32(f"{scenario}|{arrivals}|{args.seed}".encode())
    drift_frac = (args.drift_frac or 0.5) if scenario == "drift" else 0.0
    sizes = wave_plan(arrivals, args.waves, args.wave_size)

    # One mixture over tasks+1 subspaces: the extra task is the DRIFT
    # source; no seed user is drawn from it.
    n_total = args.seed_users + sum(sizes)
    feats_all, tids_all = syn.make_task_feature_mixture(
        2 * n_total, args.samples, args.dim, args.tasks + 1,
        seed=args.seed)
    seed_pool = np.flatnonzero(tids_all < args.tasks)
    drift_pool = np.flatnonzero(tids_all == args.tasks)
    seed_idx = seed_pool[:args.seed_users]
    arrival_pool = seed_pool[args.seed_users:]

    scfg = SimilarityConfig(top_k=args.top_k)
    hierarchy_cfg = (HierarchyConfig(n_groups=args.seed_groups)
                     if args.seed_groups else None)
    t0 = time.perf_counter()
    res = oneshot.one_shot_clustering(
        torch.from_numpy(feats_all[seed_idx]), n_clusters=args.tasks,
        cfg=scfg, cluster_cfg=ClusterConfig(backend="torch"), device=device,
        hierarchy_cfg=hierarchy_cfg)
    seed_labels = _host(res.labels)
    seed_time = time.perf_counter() - t0
    seed_tasks = tids_all[seed_idx]
    seed_acc = clu.clustering_accuracy(seed_labels, seed_tasks)
    if verbose:
        how = (f"hierarchical ({args.seed_groups} groups)"
               if args.seed_groups else "one-shot")
        print(f"seed: {args.seed_users} users, {how} protocol + HAC in "
              f"{seed_time:.2f}s, clustering accuracy {seed_acc:.1%}")

    # cluster id -> oracle task id (majority vote over the seed), and the
    # inverse map the colluding attack needs to aim at a neighbour.
    task_of_cluster = np.full(args.tasks, -1)
    for t in range(args.tasks):
        members = seed_tasks[seed_labels == t]
        if len(members):
            task_of_cluster[t] = np.bincount(members).argmax()
    cluster_of_task = np.arange(args.tasks)
    for t, tau in enumerate(task_of_cluster):
        if tau >= 0:
            cluster_of_task[tau] = t

    cfg = MembershipConfig(
        backend=args.backend, margin_floor=args.margin_floor,
        recluster_unassigned_frac=args.unassigned_frac,
        capacity=2 * n_total, aggregator=args.aggregator)
    engine = MembershipEngine.from_oneshot(res, cfg, device=device)
    led = res.ledger
    if verbose:
        print(f"directory: T={engine.state.n_clusters}, capacity "
              f"{engine.state.capacity}, backend={args.backend}, "
              f"device={device}, aggregator={args.aggregator} | arrival "
              f"upload {led.assign_upload / 1024:.1f} KiB vs protocol "
              f"per-user upload {led.per_user_upload / 1024:.1f} KiB")

    # Trainer-side layout with headroom for every arrival, so the
    # (T, C_max) stack shape survives all waves.  ``stack_coord`` maps
    # each directory slot to its stack cell.
    c_max = args.seed_users + sum(sizes)
    rows0, slots0, stack_mask = fpart.stack_layout(res.labels, args.tasks,
                                                   c_max=c_max)
    stack_shape = tuple(stack_mask.shape)
    stack_coord = {i: (int(r), int(c)) for i, (r, c)
                   in enumerate(zip(_host(rows0), _host(slots0)))}

    sig_engine = ProtocolEngine(scfg, device=device)
    rng = np.random.default_rng(args.seed)
    live_slots = list(range(args.seed_users))
    next_arrival = 0
    acc_traj: list[float] = []
    unassigned_traj: list[float] = []
    assign_ms: list[float] = []
    admit_ms: list[float] = []
    recluster_waves: list[int] = []
    recluster_ms: list[float] = []
    recluster_members: list[int] = []
    for w, wave_size in enumerate(sizes):
        n_drift = (int(drift_frac * wave_size)
                   if w >= args.drift_after else 0)
        take = wave_size - n_drift
        idx = list(arrival_pool[next_arrival:next_arrival + take])
        next_arrival += take
        idx += list(rng.choice(drift_pool, n_drift, replace=False))
        wave_f, wave_t = feats_all[idx], tids_all[idx]

        if scenario == "label-noise":
            wave_f = syn.label_noise_rows(wave_f, wave_t,
                                          args.corrupt_frac,
                                          seed=cseed + w)

        lam_w, v_w, _ = sig_engine.signatures(torch.from_numpy(wave_f))
        byz = np.zeros(wave_size, bool)
        if scenario == "byzantine":
            lam_w, v_w, byz = syn.byzantine_signatures(
                _host(lam_w), _host(v_w), args.corrupt_frac,
                mode=args.byzantine_mode, seed=cseed + w,
                labels=cluster_of_task[np.minimum(wave_t,
                                                  args.tasks - 1)])

        sync()
        t0 = time.perf_counter()
        out = engine.assign(lam_w, v_w)
        labels = _host(out.labels)
        assign_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        slots = engine.admit(lam_w, v_w, labels)
        sync()
        admit_ms.append((time.perf_counter() - t0) * 1e3)
        live_slots.extend(int(s) for s in slots)

        assigned = labels >= 0
        honest = assigned & (wave_t < args.tasks) & ~byz
        hits = task_of_cluster[labels[honest]] == wave_t[honest]
        acc = float(hits.mean()) if hits.size else float("nan")
        acc_traj.append(acc)
        rows, slot, stack_mask = fpart.admit_layout(stack_mask, labels)
        for s, r, c, lb in zip(slots, _host(rows), _host(slot), labels):
            if lb >= 0:                      # unassigned never enter it
                stack_coord[int(s)] = (int(r), int(c))
        stats = engine.drift_stats()
        unassigned_traj.append(float(stats["unassigned_frac"]))
        n_members = stats["n_members"]
        t0 = time.perf_counter()
        event = engine.maybe_recluster()
        sync()
        if event:
            recluster_waves.append(w)
            recluster_ms.append((time.perf_counter() - t0) * 1e3)
            recluster_members.append(int(n_members))
            # a relabel invalidates the column assignment: rebuild at the
            # SAME (T, C_max)
            live = _host(engine.state.valid) & (_host(engine.state.labels)
                                                >= 0)
            live_idx = np.flatnonzero(live)
            r2, c2, stack_mask = fpart.stack_layout(
                _host(engine.state.labels)[live_idx], args.tasks,
                c_max=c_max)
            stack_coord = {int(s): (int(r), int(c)) for s, r, c
                           in zip(live_idx, _host(r2), _host(c2))}
        if verbose:
            print(f"wave {w}: {wave_size} arrivals "
                  f"({n_drift} drift, {int(byz.sum())} byzantine) "
                  f"assigned in {assign_ms[-1]:.1f} ms | honest accuracy "
                  f"{acc:.1%} | unassigned "
                  f"{stats['unassigned_frac']:.1%} | proto shift "
                  f"{stats['proto_shift']:.3f}"
                  + (" | RECLUSTER (stack re-scattered, same shape)"
                     if event else ""))

        if args.evict and len(live_slots) > args.evict:
            gone = rng.choice(len(live_slots), args.evict, replace=False)
            evicted = [live_slots[g] for g in gone]
            engine.evict(evicted)
            for s in evicted:                # free the stack columns too
                if s in stack_coord:
                    stack_mask[stack_coord.pop(s)] = 0.0
            live_slots = [s for i, s in enumerate(live_slots)
                          if i not in set(gone.tolist())]

    assert tuple(stack_mask.shape) == stack_shape   # the shape never grew
    n_in_stack = int(_host(stack_mask).sum())
    final = engine.drift_stats()
    assert n_in_stack == final["n_members"] - engine.state.n_unassigned
    if verbose:
        print(f"final: {final['n_members']} members ({n_in_stack} in the "
              f"stack), {final['n_reclusters']} re-cluster events, stack "
              f"shape {stack_shape} unchanged")
    traj = np.asarray(acc_traj)
    summary = {
        "scenario": scenario,
        "arrivals": arrivals,
        "aggregator": args.aggregator,
        "backend": args.backend,
        "corrupt_frac": (args.corrupt_frac
                         if scenario in ("label-noise", "byzantine")
                         else 0.0),
        "byzantine_mode": (args.byzantine_mode
                           if scenario == "byzantine" else None),
        "seed_accuracy": float(seed_acc),
        "accuracy_per_wave": [float(a) for a in acc_traj],
        "mean_accuracy": (float(np.nanmean(traj))
                          if np.isfinite(traj).any() else float("nan")),
        "unassigned_frac": float(final["unassigned_frac"]),
        "recluster_waves": recluster_waves,
        "n_reclusters": int(final["n_reclusters"]),
        "n_members": int(final["n_members"]),
        "unassigned_per_wave": unassigned_traj,
        "assign_ms": assign_ms,
        "admit_ms": admit_ms,
        "recluster_ms": recluster_ms,
        "recluster_members": recluster_members,
        "seed_s": seed_time,
    }
    if return_state:
        return summary, engine, (lam_w, v_w)
    return summary


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed-users", type=int, default=64)
    ap.add_argument("--seed-groups", type=int, default=0,
                    help="> 0 clusters the seed via the hierarchical "
                         "two-level protocol (this many edge groups) "
                         "instead of the flat O(N^2) path")
    ap.add_argument("--samples", type=int, default=48)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--tasks", type=int, default=4)
    ap.add_argument("--top-k", type=int, default=8)
    ap.add_argument("--waves", type=int, default=6)
    ap.add_argument("--wave-size", type=int, default=16)
    ap.add_argument("--evict", type=int, default=4,
                    help="members evicted (churn) after each wave")
    ap.add_argument("--drift-frac", type=float, default=0.0,
                    help="fraction of each post --drift-after wave drawn "
                         "from a task the seed never saw (drift scenario "
                         "defaults to 0.5)")
    ap.add_argument("--drift-after", type=int, default=3)
    ap.add_argument("--backend", default="torch",
                    choices=["numpy", "torch"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--margin-floor", type=float, default=0.05)
    ap.add_argument("--unassigned-frac", type=float, default=0.25)
    ap.add_argument("--scenario", default="clean", choices=SCENARIOS)
    ap.add_argument("--arrivals", default="steady",
                    choices=ARRIVAL_PATTERNS)
    ap.add_argument("--matrix", action="store_true",
                    help="run every (scenario, arrivals) cell and print "
                         "one summary row per cell")
    ap.add_argument("--aggregator", default="mean",
                    choices=["mean", "trimmed", "medians"])
    ap.add_argument("--corrupt-frac", type=float, default=0.2,
                    help="corrupted fraction for label-noise (rows per "
                         "user) / byzantine (users per wave)")
    ap.add_argument("--byzantine-mode", default="colluding_copy",
                    choices=["sign_flip", "random_subspace",
                             "colluding_copy"])
    ap.add_argument("--quick", action="store_true",
                    help="CI-sized run: 32 seed users, 3 waves of 8")
    ap.add_argument("--json", default=None,
                    help="write cell summaries to this path")
    ap.add_argument("--events", default=None,
                    help="record the event stream (not ported yet)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv: list[str] | None = None) -> list[dict]:
    """Run the launcher; returns the cell summaries."""
    args = build_parser().parse_args(argv)
    if args.quick:
        args.seed_users, args.samples = 32, 16
        args.waves, args.wave_size, args.evict = 3, 8, 2
        args.drift_after = 1
    if args.events:
        raise NotImplementedError(
            "--events (the telemetry event stream) is not ported yet "
            "(ROADMAP Queue 1 item 12)")

    if args.matrix:
        cells = []
        for scenario in SCENARIOS:
            for arrivals in ARRIVAL_PATTERNS:
                cell = run_cell(args, scenario, arrivals, verbose=False)
                cells.append(cell)
                print(f"{scenario:>12} x {arrivals:<7} | honest acc "
                      f"{cell['mean_accuracy']:.1%} | unassigned "
                      f"{cell['unassigned_frac']:.1%} | reclusters "
                      f"{cell['n_reclusters']} (waves "
                      f"{cell['recluster_waves']})")
    else:
        cells = [run_cell(args, args.scenario, args.arrivals,
                          verbose=True)]

    if args.json:
        with open(args.json, "w") as fh:
            json.dump(cells, fh, indent=2)
        print(f"wrote {len(cells)} cell(s) to {args.json}")
    return cells


if __name__ == "__main__":
    main()
