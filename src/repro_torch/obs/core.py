"""Observability switchboard: the module-level enable flag and the
monotonic timer every other pillar (trace / metrics / events) builds on.

Mirrors ``src/repro/obs/core.py``.  The flag is deliberately a plain
module global read through ``enabled()``: every instrumentation call
site in the engines does one function call + one attribute read when
telemetry is off, and nothing else: no registry lookups, no allocations,
no device synchronisation.  The reference's contract for that cost is
<=5% hot-path overhead enabled and <=0.5% disabled
(``benchmarks/bench_obs.py``); ``chip_smoke.py`` phase 3p reports the
port's on the card.

``now()`` is ``time.perf_counter``: the monotonic clock all spans,
events and launch scripts time with (``time.time()`` is wall clock and
can step backwards under NTP).
"""
from __future__ import annotations

import contextlib
import time

__all__ = ["enabled", "enable", "disable", "scope", "now", "configure",
           "sync_default", "profiler_annotations", "epoch"]

#: Process epoch for relative timestamps (spans + events share it so the
#: two streams line up on one timeline).
_EPOCH = time.perf_counter()

_enabled = False
_sync_default = True
_profiler_annotations = False

#: The obs timer: monotonic, sub-microsecond, never steps backwards.
now = time.perf_counter


def epoch() -> float:
    """The perf_counter value all relative ``*_us`` timestamps key off."""
    return _EPOCH


def enabled() -> bool:
    """Is telemetry recording?  The one check every call site makes."""
    return _enabled


def enable() -> None:
    """Turn telemetry on (and lazily install the kernel-build hook that
    feeds ``retrace_count``)."""
    global _enabled
    from repro_torch.obs import metrics

    metrics.install_retrace_hook()
    _enabled = True


def disable() -> None:
    """Turn telemetry off: every obs call becomes a near-free no-op."""
    global _enabled
    _enabled = False


@contextlib.contextmanager
def scope(on: bool = True):
    """Temporarily enable (or disable) telemetry, restoring on exit."""
    global _enabled
    prev = _enabled
    if on:
        enable()
    else:
        disable()
    try:
        yield
    finally:
        _enabled = prev


def configure(*, sync: bool | None = None,
              profiler: bool | None = None) -> None:
    """Global span behaviour knobs.

    ``sync``      — default for ``span(..., sync=...)``: synchronise the
                    CUDA devices of registered values at span exit
                    (accurate device timing) vs leave them in flight
                    (async paths).
    ``profiler``  — wrap every span in ``torch.profiler.record_function``
                    so spans line up with kernels in a profiler trace.
    """
    global _sync_default, _profiler_annotations
    if sync is not None:
        _sync_default = bool(sync)
    if profiler is not None:
        _profiler_annotations = bool(profiler)


def sync_default() -> bool:
    return _sync_default


def profiler_annotations() -> bool:
    return _profiler_annotations
