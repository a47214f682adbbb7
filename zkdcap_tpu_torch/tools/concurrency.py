"""How far a call kept several cards busy at the same time.

``concurrency(fn)`` runs ``fn`` once under ``torch.profiler`` (device
activity only) and returns its wall time, each card's busy time (the union
of the intervals of the kernels and copies the trace holds for that card)
and the **concurrency ratio**: the sum over the cards of their busy time,
divided by the wall time. A ratio above 1 means that kernels of different
cards ran at the same time; at 1 or below they may or may not have, and the
overlap (the sum of the busy times less the time in which any card was
busy) says how long two or more cards ran at once.
Needs a CUDA card; every card is synchronised before and after the call.
"""

from __future__ import annotations

import time

import torch


def _union_ms(iv: list[tuple[float, float]]) -> float:
    """The length of the union of (start, end) intervals in us, in ms."""
    iv = sorted(iv)
    total, (cur_s, cur_e) = 0.0, iv[0]
    for s, e in iv[1:]:
        if s > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return (total + cur_e - cur_s) / 1e3


def _spans(prof) -> dict[int, list[tuple[float, float]]]:
    from torch.autograd import DeviceType

    spans: dict[int, list[tuple[float, float]]] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.name.startswith("Activity Buffer"):
            spans.setdefault(e.device_index, []).append((e.time_range.start, e.time_range.end))
    return spans


def busy_ms(prof) -> dict[int, float]:
    """Device index -> ms in which the card ran at least one of the trace's
    kernels or copies."""
    return {dev: _union_ms(iv) for dev, iv in sorted(_spans(prof).items())}


def any_busy_ms(prof) -> float:
    """The ms in which at least one card was busy: below the sum of
    :func:`busy_ms` by the time in which two or more cards ran at once."""
    return _union_ms([s for iv in _spans(prof).values() for s in iv])


def sync_all() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def concurrency(fn) -> dict:
    """One call of fn under the profiler: ``wall_ms``, ``busy_ms`` (per
    device index), ``ratio`` (their sum over the wall time), ``overlap_ms``
    (their sum less the time in which any card was busy: above 0, kernels
    of different cards ran at the same time) and ``result``."""
    from torch.profiler import ProfilerActivity, profile

    sync_all()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        sync_all()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = busy_ms(prof)
    if not busy:
        raise RuntimeError("the profiler traced no device activity")
    return {"wall_ms": wall_ms, "busy_ms": busy, "ratio": sum(busy.values()) / wall_ms,
            "overlap_ms": sum(busy.values()) - any_busy_ms(prof), "result": result}
