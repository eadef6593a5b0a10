"""``repro_torch.obs``: zero-dependency observability: spans, metrics,
events.  The port of ``src/repro/obs/``.

Three pillars behind one module-level enable flag (off by default):

  * **tracing**: nested ``span()`` context managers with
    device-sync-aware timing (``torch.cuda.synchronize`` on the devices
    of registered tensors), JSONL export, pretty trees, and optional
    ``torch.profiler.record_function`` pass-through
    (``repro_torch.obs.trace``);
  * **metrics**: a process-global counter/gauge/histogram registry,
    snapshotable and diffable, with a kernel-build ``retrace_count``
    hook and a ``CommLedger`` feed (``repro_torch.obs.metrics``);
  * **events**: a structured log of membership lifecycle events
    (``repro_torch.obs.events``).

Disabled-path contract: every instrumentation call is a function call +
one flag check: no allocation, no locking, no registry mutation, no
device synchronisation.

Parity contract with the reference.  Given the same inputs, a run of the
port and a run of ``repro`` record the same span names in the same
parent tree with the same meta keys; the same counter keys and values;
the same gauge and histogram keys and histogram counts; the same event
kinds in the same order with the same field names; equal integer
fields; gauges and float fields within the tolerance the port's parity
test for that quantity uses (1e-5 for ``proto_shift``,
``unassigned_frac`` and ``label_agreement``); and ``comm.*`` gauges
exactly equal.  The port's own, and not compared: ``dur_us``, ``ts_us``,
``t_us``, ``seq``, span ids, thread names, event fields that are
seconds of a run's wall clock (serving's ``ttft_s`` and ``done_s``,
floats in both), and meta or event values that name a backend or impl
(``"torch"`` where the reference has ``"jnp"`` or ``"pallas"``).
``tests/test_torch_obs.py`` holds it.

    from repro_torch import obs
    obs.enable()
    with obs.span("protocol.run") as sp:
        labels = sp.sync(one_shot_clustering(...).labels)
    print(obs.format_tree())
    obs.save_trace("trace.jsonl"); obs.save_events("events.jsonl")
"""
from repro_torch.obs.core import (configure, disable, enable, enabled, epoch,
                                  now, scope)
from repro_torch.obs.events import (clear_events, event, events, load_events,
                                    save_events)
from repro_torch.obs.metrics import (clear_metrics, count, counter_total,
                                     counter_value, diff, gauge, gauge_value,
                                     install_retrace_hook, load_snapshot,
                                     observe, record_ledger, save_snapshot,
                                     snapshot, stamp)
from repro_torch.obs.trace import (Span, clear_trace, format_tree,
                                   load_trace, profile_trace, save_trace,
                                   span, trace_records)

__all__ = [
    "enabled", "enable", "disable", "scope", "now", "epoch", "configure",
    "span", "Span", "trace_records", "clear_trace", "save_trace",
    "load_trace", "format_tree", "profile_trace",
    "count", "gauge", "observe", "counter_value", "counter_total",
    "gauge_value", "snapshot", "diff", "clear_metrics", "save_snapshot",
    "load_snapshot", "record_ledger", "stamp", "install_retrace_hook",
    "event", "events", "clear_events", "save_events", "load_events",
    "reset",
]


def reset() -> None:
    """Clear all three pillars (trace records, metrics, events)."""
    clear_trace()
    clear_metrics()
    clear_events()
