"""Port vs reference: the GWC19 multiopen (``commit/gwc.py``).

Mirrors ``tests/test_gwc.py`` on the port's CPU path (prove, verify, reject;
the GWC and SHPLONK wire formats are distinct), and holds the port's GWC
proofs of every ``REFERENCE_CASES`` circuit to the JAX package's bytes in
``testdata/reference_proofs.json`` (``gwc_proofs``), which the JAX verifier
must accept. Its EVM case, as in ``tests/test_gwc.py``: the port's keccak
GWC proof of the toy circuit executed by its generated GWC contract.
"""

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from zkdcap_tpu.commit import ParamsKZG as JParamsKZG  # noqa: E402
from zkdcap_tpu.commit import gen_srs as j_gen_srs  # noqa: E402
from zkdcap_tpu.commit.gwc import _group_by_point as j_group_by_point  # noqa: E402
from zkdcap_tpu.plonk import cs as jcs  # noqa: E402
from zkdcap_tpu.plonk.keygen import keygen as j_keygen  # noqa: E402
from zkdcap_tpu.plonk.verifier import verify_proof as j_verify_proof  # noqa: E402
from zkdcap_tpu_torch.commit import ParamsKZG, gen_srs  # noqa: E402
from zkdcap_tpu_torch.commit.gwc import _group_by_point  # noqa: E402
from zkdcap_tpu_torch.commit.shplonk import ProverQuery  # noqa: E402
from zkdcap_tpu_torch.fields import BN254_FR, mont  # noqa: E402
from zkdcap_tpu_torch.plonk import cs as tcs  # noqa: E402
from zkdcap_tpu_torch.plonk.keygen import keygen  # noqa: E402
from zkdcap_tpu_torch.plonk.prover import create_proof  # noqa: E402
from zkdcap_tpu_torch.plonk.verifier import verify_proof  # noqa: E402
from zkdcap_tpu_torch.testdata.circuits import REFERENCE_CASES, padded_advice  # noqa: E402
from zkdcap_tpu_torch.transcript import TranscriptWriter  # noqa: E402

FIXTURE = ROOT / "zkdcap_tpu_torch" / "testdata" / "reference_proofs.json"
PROOFS = [(name, kind) for name, case in REFERENCE_CASES.items() for kind in case[2]]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def fixture():
    return json.loads(FIXTURE.read_text())


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """The port's circuit, params, pk and advice of every case, built on
    first use."""
    srs_dir = str(tmp_path_factory.mktemp("port_srs"))
    cache = {}

    def get(name):
        if name not in cache:
            circ = REFERENCE_CASES[name][0](tcs)
            params = ParamsKZG(srs=gen_srs(circ.k, cache_dir=srs_dir, device="cpu"))
            pk = keygen(params, circ.cs, circ.fixed_values, device="cpu")
            advice = [mont.encode_ints(BN254_FR, col, device="cpu") for col in padded_advice(circ)]
            cache[name] = circ, params, pk, advice
        return cache[name]

    return get


@pytest.fixture(scope="module")
def ref_vk(tmp_path_factory):
    """The JAX package's params and vk of every case, built on first use."""
    srs_dir = str(tmp_path_factory.mktemp("jax_srs"))
    cache = {}

    def get(name):
        if name not in cache:
            circ = REFERENCE_CASES[name][0](jcs)
            params = JParamsKZG(srs=j_gen_srs(circ.k, cache_dir=srs_dir))
            cache[name] = params, j_keygen(params, circ.cs, circ.fixed_values).vk
        return cache[name]

    return get


def _prove(port, name, kind="blake2b", seed=b"gwc", multiopen="gwc", instances=None):
    circ, params, pk, advice = port(name)
    return create_proof(params, pk, advice, circ.instances if instances is None else instances,
                        TranscriptWriter(kind), blinding_seed=seed, multiopen=multiopen,
                        device="cpu")


def test_gwc_prove_verify_and_reject(port):
    circ, params, pk, _ = port("toy")
    proof = _prove(port, "toy")
    assert verify_proof(params, pk.vk, circ.instances, proof, multiopen="gwc")
    assert not verify_proof(params, pk.vk, [[9]], proof, multiopen="gwc")
    # a tampered byte in the opening proof must be rejected
    bad = bytearray(proof)
    bad[-7] ^= 1
    assert not verify_proof(params, pk.vk, circ.instances, bytes(bad), multiopen="gwc")


def test_gwc_and_shplonk_are_distinct_wire_formats(port):
    circ, params, pk, _ = port("toy")
    gwc = _prove(port, "toy", seed=b"x")
    shp = _prove(port, "toy", seed=b"x", multiopen="shplonk")
    # GWC writes one W per distinct point (>2), SHPLONK exactly two
    assert len(gwc) > len(shp)
    assert not verify_proof(params, pk.vk, circ.instances, gwc)
    assert not verify_proof(params, pk.vk, circ.instances, shp, multiopen="gwc")


def test_group_by_point_matches_reference():
    """First-appearance order of the points, names deduplicated per point."""
    r = BN254_FR.p
    spec = [("a", 5), ("b", 7), ("a", 5), ("c", 5 + r), ("b", 5), ("a", 9), ("b", 7)]
    queries = [ProverQuery(name, None, pt) for name, pt in spec]
    assert _group_by_point(queries) == j_group_by_point(queries) == \
        [(5, ["a", "c", "b"]), (7, ["b"]), (9, ["a"])]


def test_unknown_multiopen_raises(port):
    circ, params, pk, _ = port("toy")
    with pytest.raises(ValueError, match="multiopen"):
        _prove(port, "toy", multiopen="kzg")
    with pytest.raises(ValueError, match="multiopen"):
        verify_proof(params, pk.vk, circ.instances, b"", multiopen="kzg")


def test_gwc_evm_verifier_executes(port):
    """GWC Solidity emission + EVM execution: the contract accepts the
    port's keccak GWC proof and reverts on a changed instance and on
    flipped bytes."""
    from zkdcap_tpu_torch.evm.calldata import encode_calldata
    from zkdcap_tpu_torch.evm.interp import EvmRevert, deploy_and_call
    from zkdcap_tpu_torch.evm.solc import compile_solidity
    from zkdcap_tpu_torch.evm.solidity import gen_evm_verifier

    circ, params, pk, _ = port("toy")
    inst = circ.instances[0]
    proof = _prove(port, "toy", "keccak")
    assert verify_proof(params, pk.vk, circ.instances, proof, transcript_kind="keccak",
                        multiopen="gwc")
    code = compile_solidity(gen_evm_verifier(params, pk.vk, num_instances=1, multiopen="gwc"))
    assert deploy_and_call(code, encode_calldata(inst, proof)) == b"\x01"
    for frac in (0.1, 0.5, 0.9):
        bad = bytearray(proof)
        bad[int(len(bad) * frac)] ^= 1
        with pytest.raises(EvmRevert):
            deploy_and_call(code, encode_calldata(inst, bytes(bad)))
    with pytest.raises(EvmRevert):
        deploy_and_call(code, encode_calldata([inst[0] + 1], proof))


@pytest.mark.parametrize("name,kind", PROOFS)
def test_gwc_proof_equals_reference_bytes(port, ref_vk, fixture, name, kind):
    """The port's GWC proof is the JAX package's, byte for byte; the JAX
    verifier accepts it and the port's verifier rejects it with a byte
    flipped."""
    case = fixture[name]
    proof = _prove(port, name, kind, seed=case["seed"].encode())
    assert proof.hex() == case["gwc_proofs"][kind]
    circ, params, pk, _ = port(name)
    j_params, j_vk = ref_vk(name)
    assert j_verify_proof(j_params, j_vk, circ.instances, proof, transcript_kind=kind,
                          multiopen="gwc")
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    assert not verify_proof(params, pk.vk, circ.instances, bytes(bad), transcript_kind=kind,
                            multiopen="gwc")
