"""ctypes binding of the C++ witness evaluator (``csrc_host/witness_eval.cpp``).

Port of ``zkdcap_tpu/witness/native.py``. The library is the port's own,
built by ``_build.witness_lib`` with g++ at first use; there is no Python
fallback: a missing compiler or an evaluator error raises (the Python
evaluator, ``WitnessTape.replay_py``, is called only by name). Output is the
raw (num_cells, 16) uint16 little-endian limb array, the layout
``mont.encode_ints`` builds, so the witness fill scatters rows without
Python int round trips.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import _build

LIMBS = 12  # must match witness_eval.cpp


def _pack_vals(values) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Python ints -> (limbs u64[n, LIMBS], n i32, neg i32)."""
    n = len(values)
    limbs = np.zeros((n, LIMBS), np.uint64)
    ns = np.zeros(n, np.int32)
    negs = np.zeros(n, np.int32)
    for i, v in enumerate(values):
        v = int(v)
        if v < 0:
            negs[i] = 1
            v = -v
        j = 0
        while v:
            limbs[i, j] = v & 0xFFFFFFFFFFFFFFFF
            v >>= 64
            j += 1
        ns[i] = j
    return limbs, ns, negs


class _TapeBuffers:
    """Per-tape C buffers, built once and reused across replays."""

    def __init__(self, tape):
        tr = tape.tracer
        self.n_nodes = len(tr.op)
        self.op = np.frombuffer(tr.op.tobytes(), np.int64).copy()
        self.a = np.frombuffer(tr.a.tobytes(), np.int64).copy()
        self.b = np.frombuffer(tr.b.tobytes(), np.int64).copy()
        self.c = np.frombuffer(tr.c.tobytes(), np.int64).copy()
        self.pool_limbs, self.pool_n, self.pool_neg = _pack_vals(tr.pool)
        offs = [0]
        data = []
        for t in tr.tables:
            data.extend(int(x) for x in t)
            offs.append(len(data))
        self.tbl_off = np.asarray(offs, np.int64)
        self.tbl_data = np.asarray(data if data else [0], np.int64)
        self.n_tables = len(tr.tables)
        self.cells = np.frombuffer(tape.cell_nodes.tobytes(), np.int64).copy()
        self.num_inputs = tr.num_inputs


_buf_cache: dict[int, _TapeBuffers] = {}
# completed native replays, so that a run can show the evaluator ran
replays = 0


def eval_tape_raw(tape, inputs) -> np.ndarray:
    """Replay the tape natively; returns (num_cells, 16) uint16 LE limbs.
    Raises when the evaluator cannot be built or reports an error."""
    lib = _build.witness_lib()
    buf = _buf_cache.get(id(tape))
    if buf is None:
        buf = _TapeBuffers(tape)
        _buf_cache[id(tape)] = buf
    assert len(inputs) == buf.num_inputs
    in_limbs, in_n, in_neg = _pack_vals(inputs)
    n_cells = len(buf.cells)
    out = np.zeros(n_cells * 32, np.uint8)

    def p(arr, t):
        return arr.ctypes.data_as(ctypes.POINTER(t))

    rc = lib.witness_eval(
        ctypes.c_int64(buf.n_nodes),
        p(buf.op, ctypes.c_int64),
        p(buf.a, ctypes.c_int64),
        p(buf.b, ctypes.c_int64),
        p(buf.c, ctypes.c_int64),
        ctypes.c_int64(len(buf.pool_n)),
        p(buf.pool_limbs, ctypes.c_uint64),
        p(buf.pool_n, ctypes.c_int32),
        p(buf.pool_neg, ctypes.c_int32),
        ctypes.c_int64(buf.n_tables),
        p(buf.tbl_off, ctypes.c_int64),
        p(buf.tbl_data, ctypes.c_int64),
        ctypes.c_int64(len(in_n)),
        p(in_limbs, ctypes.c_uint64),
        p(in_n, ctypes.c_int32),
        p(in_neg, ctypes.c_int32),
        ctypes.c_int64(n_cells),
        p(buf.cells, ctypes.c_int64),
        p(out, ctypes.c_uint8),
    )
    if rc != 0:
        raise RuntimeError(f"witness_eval: the native evaluator failed with code {rc}")
    global replays
    replays += 1
    return out.view(np.uint16).reshape(n_cells, 16)


def eval_tape(tape, inputs) -> list[int]:
    """Native replay returning Python ints (tape.replay contract)."""
    raw = eval_tape_raw(tape, inputs)
    by = raw.tobytes()
    return [int.from_bytes(by[i * 32 : (i + 1) * 32], "little") for i in range(len(raw))]
