"""Port vs reference: the full-quote circuit and ``QuoteProver``.

The port's copy of ``circuits/quote.py`` must lay the k = 17 circuit out
exactly as the JAX package does on the demo quote (``make_demo_quote``,
what the JAX CLI's ``quote-prove`` proves): the trace, the compile
(constraint system, fixed columns with the lookup tables, pinning), the
permutation mappings and the witness fill are held to the JAX package's,
one trace and compile per package (the recorded tape and its native replay
are in ``test_torch_quote_tape.py``). The cases of
``tests/test_roadmap_circuits.py`` run here; its MockProver case is
``slow``, as there. ``testdata/quote_vk.json`` holds the JAX keygen's vk of
this circuit and the card's proof of the demo quote, which both packages'
host verifiers must accept.
"""

import dataclasses

import pytest
import torch

import test_torch_service_circuits as svc
from test_torch_reference_proofs import structure_json
from zkdcap_tpu.circuits import quote as jquote
from zkdcap_tpu.runtime.chain_provers import QuoteProver as JQuoteProver
from zkdcap_tpu_torch.circuits import quote as tquote
from zkdcap_tpu_torch.runtime import QuoteProver

# (advice, lookup advice, spread advice, cells) of the demo quote's pinning
PINNING = (33, 3, 1, 4_263_076)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_side():
    return svc.jax_side(jquote.build_quote_trace, jquote.make_demo_quote())


@pytest.fixture(scope="module")
def port_side():
    return svc.port_side(tquote.build_quote_trace, tquote.make_demo_quote())


@pytest.fixture(scope="module")
def fixture():
    return svc.load_fixture("quote")


def test_demo_quote_native(fixture):
    q = tquote.make_demo_quote()
    assert q.verify_native()
    assert structure_json(q) == structure_json(jquote.make_demo_quote())
    assert structure_json(q) == fixture["structure"]
    assert tquote.trace_inputs(q) == jquote.trace_inputs(jquote.make_demo_quote())


def test_quote_rejects_bad_mrenclave():
    q = tquote.make_demo_quote()
    bad = dataclasses.replace(q, mrenclave=bytes(32))
    assert not bad.verify_native()
    with pytest.raises(AssertionError):
        tquote.build_quote_trace(bad)


def test_trace_matches_reference(jax_side, port_side):
    svc.check_trace(jax_side, port_side)


def test_compile_matches_reference(jax_side, port_side):
    svc.check_compile(jax_side, port_side, PINNING)


def test_permutation_mappings_match_reference(jax_side, port_side):
    svc.check_permutation_mappings(jax_side, port_side)


def test_witness_fill_matches_reference(jax_side, port_side):
    svc.check_witness_fill(jax_side, port_side)


def test_prover_matches_reference(tmp_path):
    port = QuoteProver(params_dir=str(tmp_path))
    ref = JQuoteProver(params_dir=str(tmp_path))
    assert (port.NAME, port.k, port.lookup_bits, port.transcript_kind) == \
        (ref.NAME, ref.k, ref.lookup_bits, ref.transcript_kind) == ("quote", 17, 16, "blake2b")
    for name in ("pk_path", "vk_path", "pinning_path", "tape_path"):
        assert getattr(port, name) == getattr(ref, name)
    assert port.structure_input() == tquote.make_demo_quote()


def test_params_dir_loads_in_reference(tmp_path, jax_side, port_side, fixture):
    """A vk and pinning that the port's prover wrote load in the JAX
    package's light verifier path."""
    port = QuoteProver(params_dir=str(tmp_path), k=svc.K)
    vk = port._vk_from_data(fixture["vk"], port_side["compiled"].cs)
    port._save_vk(vk, port_side["compiled"].pinning)
    ref = JQuoteProver(params_dir=str(tmp_path), k=svc.K)
    svc.cached_compile(ref, jax_side)
    jvk = ref.load_vk()
    assert jvk.transcript_repr() == vk.transcript_repr()
    assert ref._vk_data(jvk) == fixture["vk"]


def test_card_proof_verifies(tmp_path, jax_side, port_side, fixture):
    svc.check_card_proof(jax_side, port_side, fixture, JQuoteProver, QuoteProver, tmp_path)


@pytest.mark.slow
def test_quote_mock():
    from zkdcap_tpu_torch.chips import CircuitBuilder
    from zkdcap_tpu_torch.plonk.mock import MockProver

    trace = tquote.build_quote_trace(tquote.make_demo_quote())
    builder = CircuitBuilder(svc.K, lookup_bits=svc.LOOKUP_BITS)
    compiled = builder.compile(trace)
    advice = builder.witness_columns(compiled, trace)
    MockProver(svc.K, compiled.cs, compiled.fixed_values, advice, [],
               device="cpu").assert_satisfied()
