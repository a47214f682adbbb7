"""Port vs reference: the witness tape and the native evaluator.

A tape recorded by the port once, on the sample signature, must replay any
other signature to the cells of a fresh trace; the port's C++ evaluator
(``csrc_host/witness_eval.cpp``, built with g++ at first use) must equal the
Python evaluator; and a tape saved by the JAX package must load in the port
unchanged (the two packages share params dirs).
"""

import numpy as np
import pytest

from zkdcap_tpu.circuits.p256_ecdsa import build_ecdsa_trace as j_build_ecdsa_trace
from zkdcap_tpu.runtime.prover import SAMPLE_INPUT as J_SAMPLE
from zkdcap_tpu.witness.tape import record as j_record
from zkdcap_tpu_torch.circuits.p256_ecdsa import ECDSAInput, build_ecdsa_trace, trace_inputs
from zkdcap_tpu_torch.curves.host_curve import SECP256R1
from zkdcap_tpu_torch.runtime.prover import SAMPLE_INPUT
from zkdcap_tpu_torch.witness import native
from zkdcap_tpu_torch.witness.tape import WitnessTape, cells_u16, record

from test_p256_circuit import REF_MSGHASH, REF_PUBKEY, REF_SIG

LOOKUP_BITS = 17


@pytest.fixture(scope="module")
def tape():
    _, tape = record(lambda tr: build_ecdsa_trace(SAMPLE_INPUT, LOOKUP_BITS, tracer=tr))
    return tape


def _random_signature(seed: int) -> ECDSAInput:
    c = SECP256R1
    rng = np.random.default_rng(seed)
    d, k, z = (int.from_bytes(rng.bytes(32), "big") % (c.n - 1) + 1 for _ in range(3))
    pub = c.mul(d, c.g)
    r = c.mul(k, c.g)[0] % c.n
    s = pow(k, -1, c.n) * (z + r * d) % c.n
    inp = ECDSAInput(r=r, s=s, msghash=z, x=pub[0], y=pub[1])
    assert inp.verify_native()
    return inp


def test_tape_replays_fresh_signatures(tape):
    for inp in (_random_signature(5), ECDSAInput.from_hex(REF_MSGHASH, REF_SIG, REF_PUBKEY)):
        cells = build_ecdsa_trace(inp, LOOKUP_BITS).cells
        raw = native.eval_tape_raw(tape, trace_inputs(inp))
        assert np.array_equal(raw, cells_u16(cells))


def test_native_evaluator_equals_python(tape):
    inputs = trace_inputs(_random_signature(6))
    assert tape.replay(inputs) == tape.replay_py(inputs)


def test_jax_saved_tape_loads_in_port(tape, tmp_path):
    _, jtape = j_record(lambda tr: j_build_ecdsa_trace(J_SAMPLE, LOOKUP_BITS, tracer=tr))
    path = str(tmp_path / "tape_k18.npz")
    jtape.save(path)
    loaded = WitnessTape.load(path)
    for name in ("op", "a", "b", "c"):
        assert getattr(loaded.tracer, name) == getattr(tape.tracer, name), name
    assert loaded.tracer.pool == tape.tracer.pool
    assert loaded.tracer.tables == tape.tracer.tables
    assert loaded.cell_nodes == tape.cell_nodes
    inputs = trace_inputs(_random_signature(7))
    assert np.array_equal(native.eval_tape_raw(loaded, inputs), native.eval_tape_raw(tape, inputs))
    # and the port's save is the same format, read back by the port
    tape.save(str(tmp_path / "port_tape.npz"))
    again = WitnessTape.load(str(tmp_path / "port_tape.npz"))
    assert again.cell_nodes == tape.cell_nodes and again.tracer.op == tape.tracer.op
