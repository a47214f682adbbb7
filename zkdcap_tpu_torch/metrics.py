"""Structured metrics: first-class per-phase / per-kernel measurements.

A copy of ``zkdcap_tpu/metrics.py`` (host Python, no device work); the
runtime writes its records to ``metrics.jsonl`` in each params dir.

The reference stack's observability is ad-hoc (ark-std start_timer! pairs
printed to stderr, the reference's `circuits/src/sgx_dcap_verifier.rs`
bench prints); this module makes the same signals machine-readable: every
timed phase and every measured kernel becomes a record

    {"name": ..., "seconds": ..., "items": ..., "bytes": ...,
     "items_per_s": ..., "gb_per_s": ..., ...attrs}

accumulated in a process-global registry and dumped as a JSON-lines
artifact (SURVEY.md §5.5: structured metrics as a first-class output).

Activation:
  * ZKDCAP_METRICS=<path>  — records are appended to <path> as JSON lines
                             on every `dump()` (and atexit);
  * ZKDCAP_METRICS=stderr  — records are printed to stderr as they land;
  * unset                  — recording is still on (cheap: a list append),
                             consumers call `dump(path)` / `snapshot()`.
"""

from __future__ import annotations

import atexit
import json
import os
import sys
import threading
import time
from contextlib import contextmanager

_LOCK = threading.Lock()
_RECORDS: list[dict] = []
_ENV = "ZKDCAP_METRICS"


def record(name: str, seconds: float, items: float | None = None,
           nbytes: float | None = None, **attrs) -> dict:
    """Append one measurement; derived rates are computed here."""
    rec: dict = {"name": name, "seconds": round(float(seconds), 6)}
    if items is not None:
        rec["items"] = items
        if seconds > 0:
            rec["items_per_s"] = round(items / seconds, 3)
    if nbytes is not None:
        rec["bytes"] = nbytes
        if seconds > 0:
            rec["gb_per_s"] = round(nbytes / seconds / 1e9, 3)
    rec.update(attrs)
    sink = os.environ.get(_ENV, "")
    with _LOCK:
        _RECORDS.append(rec)
    if sink == "stderr":
        print(f"[metrics] {json.dumps(rec)}", file=sys.stderr, flush=True)
    return rec


@contextmanager
def timer(name: str, items: float | None = None, nbytes: float | None = None,
          **attrs):
    """Context manager: times the body and records on exit."""
    t0 = time.time()
    try:
        yield
    finally:
        record(name, time.time() - t0, items=items, nbytes=nbytes, **attrs)


def snapshot() -> list[dict]:
    with _LOCK:
        return list(_RECORDS)


def clear() -> None:
    with _LOCK:
        _RECORDS.clear()


def dump(path: str | None = None) -> int:
    """Append all records to `path` (or $ZKDCAP_METRICS) as JSON lines and
    clear the registry. Returns the number of records written."""
    path = path or os.environ.get(_ENV, "")
    if not path or path == "stderr":
        return 0
    with _LOCK:
        recs, _RECORDS[:] = list(_RECORDS), []
    if not recs:
        return 0
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    return len(recs)


def _atexit_dump():
    sink = os.environ.get(_ENV, "")
    if sink and sink != "stderr":
        dump(sink)


atexit.register(_atexit_dump)
