"""Port vs reference: the cert-chain circuit and ``CertChainProver``.

The port's copy of ``circuits/cert_chain.py`` must lay the k = 17 circuit
out exactly as the JAX package does, on the Intel chain that the JAX CLI's
``cert-chain-prove`` proves (``make_intel_demo_chain``: the real Intel PCK
leaf TBS re-signed by a synthetic CA): the trace, the compile (constraint
system, fixed columns with the lookup tables, pinning), the permutation
mappings and the witness fill are held to the JAX package's, one trace and
compile per package (the recorded tape and its native replay are in
``test_torch_cert_chain_tape.py``). The native checks of
``tests/test_roadmap_circuits.py`` run here; its MockProver case is
``slow``, as there. ``testdata/cert_chain_vk.json`` holds the JAX keygen's
vk of this circuit and the card's proof of the Intel chain, which both
packages' host verifiers must accept.
"""

import dataclasses

import pytest
import torch

import test_torch_service_circuits as svc
from test_torch_reference_proofs import structure_json
from zkdcap_tpu.circuits import cert_chain as jcc
from zkdcap_tpu.runtime.chain_provers import CertChainProver as JCertChainProver
from zkdcap_tpu_torch.circuits import cert_chain as tcc
from zkdcap_tpu_torch.runtime import CertChainProver

# (advice, lookup advice, spread advice, cells) of the Intel chain's pinning
PINNING = (37, 3, 2, 4_828_095)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_side():
    return svc.jax_side(jcc.build_cert_chain_trace, jcc.make_intel_demo_chain())


@pytest.fixture(scope="module")
def port_side():
    return svc.port_side(tcc.build_cert_chain_trace, tcc.make_intel_demo_chain())


@pytest.fixture(scope="module")
def fixture():
    return svc.load_fixture("cert_chain")


def test_demo_chain_native():
    chain = tcc.make_demo_chain()
    assert chain.verify_native()
    assert structure_json(chain) == structure_json(jcc.make_demo_chain())
    assert tcc.trace_inputs(chain) == jcc.trace_inputs(jcc.make_demo_chain())


def test_intel_chain_matches_reference(fixture):
    chain = tcc.make_intel_demo_chain()
    assert chain.verify_native()
    assert tcc.intel_leaf_tbs() == jcc.intel_leaf_tbs()
    assert chain.links[0].tbs == tcc.intel_leaf_tbs()
    assert structure_json(chain) == structure_json(jcc.make_intel_demo_chain()) == \
        fixture["structure"]
    assert tcc.trace_inputs(chain) == jcc.trace_inputs(jcc.make_intel_demo_chain())


def test_bad_signature_fails_native_check():
    chain = tcc.make_demo_chain()
    link = dataclasses.replace(chain.links[0], s=chain.links[0].s + 1)
    assert not dataclasses.replace(chain, links=[link] + chain.links[1:]).verify_native()


def test_trace_matches_reference(jax_side, port_side):
    svc.check_trace(jax_side, port_side)


def test_compile_matches_reference(jax_side, port_side):
    svc.check_compile(jax_side, port_side, PINNING)


def test_permutation_mappings_match_reference(jax_side, port_side):
    svc.check_permutation_mappings(jax_side, port_side)


def test_witness_fill_matches_reference(jax_side, port_side):
    svc.check_witness_fill(jax_side, port_side)


def test_prover_matches_reference(tmp_path):
    """Artifact names, sizes and the default structure (``make_demo_chain``,
    while the CLI proves the Intel chain) are the JAX package's."""
    port = CertChainProver(params_dir=str(tmp_path))
    ref = JCertChainProver(params_dir=str(tmp_path))
    assert (port.NAME, port.k, port.lookup_bits, port.transcript_kind) == \
        (ref.NAME, ref.k, ref.lookup_bits, ref.transcript_kind) == \
        ("cert_chain", 17, 16, "blake2b")
    for name in ("pk_path", "vk_path", "pinning_path", "tape_path"):
        assert getattr(port, name) == getattr(ref, name)
    assert structure_json(port.structure_input()) == structure_json(tcc.make_demo_chain())
    intel = tcc.make_intel_demo_chain()
    assert CertChainProver(params_dir=str(tmp_path), structure=intel).structure_input() is intel


def test_params_dir_loads_in_reference(tmp_path, jax_side, port_side, fixture):
    """A vk and pinning that the port's prover wrote load in the JAX
    package's light verifier path."""
    port = CertChainProver(params_dir=str(tmp_path), k=svc.K)
    vk = port._vk_from_data(fixture["vk"], port_side["compiled"].cs)
    port._save_vk(vk, port_side["compiled"].pinning)
    ref = JCertChainProver(params_dir=str(tmp_path), k=svc.K)
    svc.cached_compile(ref, jax_side)
    jvk = ref.load_vk()
    assert jvk.transcript_repr() == vk.transcript_repr()
    assert ref._vk_data(jvk) == fixture["vk"]


def test_card_proof_verifies(tmp_path, jax_side, port_side, fixture):
    svc.check_card_proof(jax_side, port_side, fixture, JCertChainProver, CertChainProver,
                         tmp_path)


@pytest.mark.slow
def test_cert_chain_mock():
    from zkdcap_tpu_torch.chips import CircuitBuilder
    from zkdcap_tpu_torch.plonk.mock import MockProver

    trace = tcc.build_cert_chain_trace(tcc.make_demo_chain())
    builder = CircuitBuilder(svc.K, lookup_bits=svc.LOOKUP_BITS)
    compiled = builder.compile(trace)
    advice = builder.witness_columns(compiled, trace)
    MockProver(svc.K, compiled.cs, compiled.fixed_values, advice, [],
               device="cpu").assert_satisfied()
