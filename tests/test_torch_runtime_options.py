"""The prover services' options that this slice ports, end to end on the
CPU: ``multiopen="gwc"`` and ``create_proof(checkpoint=True)`` through
``CircuitProver`` (the base of ``DcapProver``, ``CertChainProver`` and
``QuoteProver``), on a tiny FlexGate/RangeChip circuit at k = 5.

A GWC service proves what its verifier accepts and the SHPLONK service
rejects (and the reverse); ``checkpoint=True`` keeps its round files in the
params dir, as the JAX package's ``CircuitProver`` does, resumes a proof
preempted there to the uninterrupted bytes, and leaves none behind.
"""

import os

import pytest
import torch

from zkdcap_tpu_torch.chips import Context, FlexGate, RangeChip
from zkdcap_tpu_torch.plonk import checkpoint
from zkdcap_tpu_torch.runtime import circuit_prover
from zkdcap_tpu_torch.runtime.circuit_prover import CircuitProver

INPUT = [3, 5, 7, 200]
SEED = b"runtime-options"


class TinyProver(CircuitProver):
    """Four range-checked bytes and one multiply-add."""

    NAME = "tiny"
    K_DEFAULT = 5
    LOOKUP_BITS = 4

    def build_trace(self, inp, tracer=None):
        ctx = Context(tracer=tracer)
        gate = FlexGate(ctx)
        rc = RangeChip(gate, self.lookup_bits)
        vals = [tracer.input(v) for v in inp] if tracer is not None else list(inp)
        cells = [ctx.push(v) for v in vals]
        for c in cells:
            rc.range_check(c, 8)
        gate.add(gate.mul(cells[0], cells[1]), cells[2])
        return ctx

    def structure_input(self):
        return INPUT

    def trace_inputs(self, inp):
        return list(inp)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def provers(tmp_path_factory):
    """A SHPLONK and a GWC service over one params dir, and a SHPLONK proof."""
    params_dir = str(tmp_path_factory.mktemp("params"))
    shplonk = TinyProver(params_dir=params_dir, device="cpu")
    proof = shplonk.create_proof(INPUT, timing=False, blinding_seed=SEED)
    return shplonk, TinyProver(params_dir=params_dir, device="cpu", multiopen="gwc"), proof


def test_gwc_service_proves_and_verifies(provers):
    shplonk, gwc, shplonk_proof = provers
    proof = gwc.create_proof(INPUT, timing=False, blinding_seed=SEED)
    assert len(proof) > len(shplonk_proof)
    assert gwc.verify(proof) and not shplonk.verify(proof)
    assert shplonk.verify(shplonk_proof) and not gwc.verify(shplonk_proof)


def test_unknown_multiopen_raises(tmp_path):
    with pytest.raises(ValueError, match="multiopen"):
        TinyProver(params_dir=str(tmp_path), multiopen="kzg")


def test_checkpoint_true_resumes_in_params_dir(provers, monkeypatch):
    shplonk, _, golden = provers
    create = circuit_prover.create_proof
    monkeypatch.setattr(circuit_prover, "create_proof",
                        lambda *a, **kw: create(*a, _abort_after="r3", **kw))
    with pytest.raises(checkpoint.Preempted):
        shplonk.create_proof(INPUT, timing=False, blinding_seed=SEED, checkpoint=True)
    monkeypatch.setattr(circuit_prover, "create_proof", create)
    assert sorted(f for f in os.listdir(shplonk.params_dir) if f.startswith("ck_")) == \
        ["ck_blake2b_r1.npz", "ck_blake2b_r2.npz", "ck_blake2b_r3.npz"]
    assert shplonk.create_proof(INPUT, timing=False, blinding_seed=SEED,
                                checkpoint=True) == golden
    assert not [f for f in os.listdir(shplonk.params_dir) if f.startswith("ck_")]
