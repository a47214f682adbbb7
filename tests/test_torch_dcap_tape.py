"""Port vs reference: the DCAP k = 17 circuit's witness tape and evaluator.

The tape that the port's ``DcapProver`` records on the demo input (one
traced run of ``circuits/dcap.py``: the SHA-256 and base64 chips' ops on
the replay DAG) must equal the JAX package's node for node, its
materialised trace the JAX package's, and the port's C++ evaluator
(``csrc_host/witness_eval.cpp``) must replay it on the demo input to the
JAX package's cells. The circuit's compile is held in
``test_torch_dcap.py``.
"""

import numpy as np
import pytest

from zkdcap_tpu.circuits import dcap as jdcap
from zkdcap_tpu.witness.tape import record as j_record
from zkdcap_tpu_torch.circuits import dcap as tdcap
from zkdcap_tpu_torch.witness import native
from zkdcap_tpu_torch.witness.tape import cells_u16, record

LOOKUP_BITS = 16
FIELDS = ("cells", "gate_offsets", "copies", "lookup_cells", "instance_cells",
          "constant_cells", "spread_pairs")


def _recorded(mod, rec):
    return rec(lambda tr: mod.build_dcap_trace(mod.load_demo_input(), LOOKUP_BITS, tracer=tr))


@pytest.fixture(scope="module")
def jax_side():
    return _recorded(jdcap, j_record)


@pytest.fixture(scope="module")
def port_side():
    return _recorded(tdcap, record)


def test_tape_matches_reference(jax_side, port_side):
    (jctx, jt), (tctx, tt) = jax_side, port_side
    for name in FIELDS:
        assert getattr(tctx, name) == getattr(jctx, name), name
    for name in ("op", "a", "b", "c"):
        assert getattr(tt.tracer, name) == getattr(jt.tracer, name), name
    assert tt.tracer.pool == jt.tracer.pool and tt.tracer.tables == jt.tracer.tables
    assert tt.cell_nodes == jt.cell_nodes


def test_native_evaluator_matches_reference(jax_side, port_side):
    """The port's evaluator replays its tape on the demo input to the JAX
    package's cells."""
    inp = tdcap.load_demo_input()
    raw = native.eval_tape_raw(port_side[1], tdcap.trace_inputs(inp))
    assert np.array_equal(raw, cells_u16(jax_side[0].cells))
