"""Telemetry CLI for the port: render, diff and profile recorded runs.

Mirrors ``src/repro/launch/obs.py``.

  # run a tiny instrumented pipeline on the card and render its trace,
  # metrics and events (``--device cpu`` runs the plain versions)
  PYTHONPATH=src python -m repro_torch.launch.obs report --quick

  # render previously recorded artifacts (the reference's files too)
  PYTHONPATH=src python -m repro_torch.launch.obs report \\
      --trace trace.jsonl --metrics metrics.json --events events.jsonl

  # diff two metric snapshots (e.g. before/after a perf change)
  PYTHONPATH=src python -m repro_torch.launch.obs compare before.json \\
      after.json

  # run any launch entry point under torch.profiler, obs spans emitted as
  # record_function ranges, and export a Chrome trace
  PYTHONPATH=src python -m repro_torch.launch.obs profile \\
      --logdir /path/to/dir -- repro_torch.launch.membership --quick
"""
from __future__ import annotations

import argparse
import json
import runpy
import sys
import tempfile
from pathlib import Path

import numpy as np

from repro_torch import obs

_TMP = Path(tempfile.gettempdir())


def _quick_workload(outdir: Path, device: str = "cuda") -> dict[str, Path]:
    """A tiny instrumented end-to-end run: one-shot clustering, a
    membership assign/admit wave and a drift check (the reference's
    quick workload), recorded under ``outdir``.  Runs on ``device``;
    ``"cuda"`` raises without a card."""
    from repro_torch.core.membership_engine import (MembershipConfig,
                                                    MembershipEngine)
    from repro_torch.core.oneshot import one_shot_clustering
    from repro_torch.kernels.dispatch import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    feats = [rng.normal(size=(16, 6)).astype(np.float32) for _ in range(10)]
    obs.reset()
    with obs.scope(True):
        res = one_shot_clustering(feats, 2, device=dev)
        eng = MembershipEngine.from_oneshot(
            res, MembershipConfig(backend="torch", capacity=24), device=dev)
        lam, v = res.lam[:4], res.v[:4]
        wave = eng.assign(lam, v)
        eng.admit(lam, v, wave.labels)
        eng.drift_stats()
    outdir.mkdir(parents=True, exist_ok=True)
    return {
        "trace": obs.save_trace(outdir / "trace.jsonl"),
        "metrics": obs.save_snapshot(outdir / "metrics.json"),
        "events": obs.save_events(outdir / "events.jsonl"),
    }


def _metric_table(snap: dict) -> str:
    lines = []
    counters = snap.get("counters", {})
    if counters:
        lines.append("counters:")
        for k in sorted(counters):
            lines.append(f"  {k:<44s} {counters[k]:>12g}")
    gauges = snap.get("gauges", {})
    if gauges:
        lines.append("gauges:")
        for k in sorted(gauges):
            v = gauges[k]
            v = f"{v:g}" if isinstance(v, (int, float)) else str(v)
            lines.append(f"  {k:<44s} {v:>12s}")
    hists = snap.get("histograms", {})
    if hists:
        lines.append("histograms:")
        lines.append(f"  {'name':<34s} {'count':>7s} {'mean':>11s} "
                     f"{'min':>11s} {'max':>11s}")
        for k in sorted(hists):
            h = hists[k]
            lines.append(f"  {k:<34s} {h['count']:>7d} {h['mean']:>11.1f} "
                         f"{h['min']:>11.1f} {h['max']:>11.1f}")
    return "\n".join(lines) if lines else "(empty registry)"


def _event_summary(events: list[dict], show: int = 8) -> str:
    if not events:
        return "(no events)"
    by_kind: dict[str, int] = {}
    for e in events:
        by_kind[e["kind"]] = by_kind.get(e["kind"], 0) + 1
    lines = ["by kind: " + ", ".join(f"{k}={n}"
                                     for k, n in sorted(by_kind.items()))]
    for e in events[:show]:
        rest = {k: v for k, v in e.items()
                if k not in ("seq", "t_us", "kind")}
        lines.append(f"  [{e['seq']:>4d}] t={e['t_us'] / 1e3:9.2f}ms "
                     f"{e['kind']:<16s} {rest}")
    if len(events) > show:
        lines.append(f"  ... {len(events) - show} more")
    return "\n".join(lines)


def cmd_report(args) -> None:
    trace_p, metrics_p, events_p = args.trace, args.metrics, args.events
    if args.quick:
        paths = _quick_workload(Path(args.out), args.device)
        trace_p = trace_p or paths["trace"]
        metrics_p = metrics_p or paths["metrics"]
        events_p = events_p or paths["events"]
        print(f"recorded quick run under {args.out}")
    if not (trace_p or metrics_p or events_p):
        raise SystemExit("report: pass --trace/--metrics/--events or "
                         "--quick to record a run first")
    if trace_p:
        print("== trace ==")
        print(obs.format_tree(obs.load_trace(trace_p)))
    if metrics_p:
        print("== metrics ==")
        print(_metric_table(obs.load_snapshot(metrics_p)))
    if events_p:
        print("== events ==")
        print(_event_summary(obs.load_events(events_p)))


def cmd_compare(args) -> None:
    before = obs.load_snapshot(args.before)
    after = obs.load_snapshot(args.after)
    delta = obs.diff(before, after)
    if args.json:
        print(json.dumps(delta, indent=2, sort_keys=True))
        return
    if delta["counters"]:
        print("counter deltas:")
        for k, v in sorted(delta["counters"].items()):
            print(f"  {k:<44s} {v:>+12g}")
    if delta["gauges"]:
        print("gauge transitions:")
        for k, (old, new) in sorted(delta["gauges"].items()):
            print(f"  {k:<44s} {old} -> {new}")
    if delta["histograms"]:
        print("histogram growth:")
        for k, d in sorted(delta["histograms"].items()):
            print(f"  {k:<44s} +{d['count']} obs, +{d['total']:.1f} total")
    if not any(delta.values()):
        print("no differences")


def cmd_profile(args) -> None:
    module, mod_args = args.module[0], args.module[1:]
    obs.configure(profiler=True)
    obs.enable()
    sys.argv = [module] + mod_args
    print(f"profiling `{module} {' '.join(mod_args)}` -> {args.logdir}")
    try:
        with obs.profile_trace(args.logdir) as prof:
            runpy.run_module(module, run_name="__main__")
    finally:
        obs.disable()
        obs.configure(profiler=False)
    print(f"trace written to {prof.path}: open it in Perfetto "
          f"(ui.perfetto.dev) or chrome://tracing")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.obs")
    sub = ap.add_subparsers(dest="cmd", required=True)

    rp = sub.add_parser("report", help="render a run's trace tree + "
                                       "metric table + event summary")
    rp.add_argument("--trace", help="span JSONL (obs.save_trace)")
    rp.add_argument("--metrics", help="metrics snapshot JSON")
    rp.add_argument("--events", help="event JSONL (obs.save_events)")
    rp.add_argument("--quick", action="store_true",
                    help="record a tiny instrumented run first")
    rp.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device of the --quick run (cuda raises without "
                         "a card)")
    rp.add_argument("--out", default=str(_TMP / "repro_torch_obs_quick"),
                    help="artifact dir for --quick")
    rp.set_defaults(fn=cmd_report)

    cp = sub.add_parser("compare", help="diff two metric snapshots")
    cp.add_argument("before")
    cp.add_argument("after")
    cp.add_argument("--json", action="store_true")
    cp.set_defaults(fn=cmd_compare)

    pp = sub.add_parser("profile", help="run a module under "
                                        "torch.profiler.profile")
    pp.add_argument("--logdir", default=str(_TMP / "repro_torch_trace"))
    pp.add_argument("module", nargs=argparse.REMAINDER,
                    help="-- module [args...]")
    pp.set_defaults(fn=cmd_profile)

    args = ap.parse_args(argv)
    if args.cmd == "profile":
        args.module = [a for a in args.module if a != "--"]
        if not args.module:
            raise SystemExit("profile: give a module to run, e.g. "
                             "`profile -- repro_torch.launch.membership "
                             "--quick`")
    args.fn(args)


if __name__ == "__main__":
    main()
