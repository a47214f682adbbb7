"""Port vs reference: the EVM verifier (``zkdcap_tpu_torch/evm/``).

The port's calldata layout, interpreter, Solidity generator and subset
compiler against the JAX package's ``zkdcap_tpu/evm/``, with exact equality:
calldata bytes, every interpreter case of ``tests/test_evm_exec.py`` (and
the modexp precompile) with equal outputs and reverts, the generated source
and its bytecode for the keccak toy circuit and for the real k=18 P-256 vk
(``assets/vk_k18.json`` + ``assets/pinning_k18.json``), SHPLONK and GWC.
The generated contracts are then executed: they accept the JAX package's
keccak proofs (``testdata/reference_proofs.json``, and the k=18
``proof_keccak`` of ``testdata/p256_proof.json``), the card's GWC keccak
proof of the k=18 circuit (``card_gwc_keccak``) and the port's own CPU
proof of the toy circuit, and revert on a changed instance and on flipped
bytes; the k=18 SHPLONK case is the port's run of
``tests/test_evm_exec.py``'s ``test_k18_real_verifier_*``.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from zkdcap_tpu.chips import CircuitBuilder as JCircuitBuilder  # noqa: E402
from zkdcap_tpu.chips import Pinning as JPinning  # noqa: E402
from zkdcap_tpu.circuits.p256_ecdsa import build_ecdsa_trace as j_build_ecdsa_trace  # noqa: E402
from zkdcap_tpu.commit.kzg import ParamsKZG as JParamsKZG  # noqa: E402
from zkdcap_tpu.commit.srs import SRS as JSRS  # noqa: E402
from zkdcap_tpu.curves import pairing as jpairing  # noqa: E402
from zkdcap_tpu.evm import calldata as jcalldata  # noqa: E402
from zkdcap_tpu.evm import interp as jinterp  # noqa: E402
from zkdcap_tpu.evm.solc import compile_solidity as j_compile_solidity  # noqa: E402
from zkdcap_tpu.evm.solidity import gen_evm_verifier as j_gen_evm_verifier  # noqa: E402
from zkdcap_tpu.plonk import cs as jcs  # noqa: E402
from zkdcap_tpu.plonk.keygen import VerifyingKey as JVerifyingKey  # noqa: E402
from zkdcap_tpu.runtime.prover import SAMPLE_INPUT as J_SAMPLE  # noqa: E402
from zkdcap_tpu_torch.chips import CircuitBuilder, Pinning  # noqa: E402
from zkdcap_tpu_torch.circuits.p256_ecdsa import build_ecdsa_trace  # noqa: E402
from zkdcap_tpu_torch.commit import ParamsKZG, gen_srs  # noqa: E402
from zkdcap_tpu_torch.commit.srs import SRS, _dev_tau  # noqa: E402
from zkdcap_tpu_torch.curves.host_curve import BN254_G1  # noqa: E402
from zkdcap_tpu_torch.curves.pairing import G2_GEN, g2_mul  # noqa: E402
from zkdcap_tpu_torch.evm import calldata as tcalldata  # noqa: E402
from zkdcap_tpu_torch.evm import interp as tinterp  # noqa: E402
from zkdcap_tpu_torch.evm.solc import compile_solidity  # noqa: E402
from zkdcap_tpu_torch.evm.solidity import gen_evm_verifier  # noqa: E402
from zkdcap_tpu_torch.fields import BN254_FR, mont  # noqa: E402
from zkdcap_tpu_torch.plonk import cs as tcs  # noqa: E402
from zkdcap_tpu_torch.plonk.keygen import VerifyingKey, keygen  # noqa: E402
from zkdcap_tpu_torch.plonk.prover import create_proof  # noqa: E402
from zkdcap_tpu_torch.runtime.prover import SAMPLE_INPUT  # noqa: E402
from zkdcap_tpu_torch.testdata.circuits import padded_advice, toy_circuit  # noqa: E402
from zkdcap_tpu_torch.transcript import TranscriptWriter  # noqa: E402
from zkdcap_tpu_torch.transcript.keccak import keccak256  # noqa: E402

ASSETS = ROOT / "assets"
TESTDATA = ROOT / "zkdcap_tpu_torch" / "testdata"
# where a tampered proof has one byte flipped (fractions of its length)
FLIPS = (0.2, 0.65, 0.95)
MULTIOPENS = ("shplonk", "gwc")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _w(v: int) -> bytes:
    return int(v).to_bytes(32, "big")


# ---------------------------------------------------------------------------
# calldata
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_calldata_equals_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 16))
    instances = [int.from_bytes(rng.bytes(32), "big") % BN254_FR.p for _ in range(n)]
    proof = rng.bytes(int(rng.integers(0, 2000)))
    data = tcalldata.encode_calldata(instances, proof)
    assert data == jcalldata.encode_calldata(instances, proof)
    assert tcalldata.decode_calldata(data, n) == jcalldata.decode_calldata(data, n) \
        == (instances, proof)


# ---------------------------------------------------------------------------
# interpreter: the cases of tests/test_evm_exec.py, and modexp
# ---------------------------------------------------------------------------

def _g2_bytes(pt) -> bytes:
    return _w(pt[0].c1) + _w(pt[0].c0) + _w(pt[1].c1) + _w(pt[1].c0)


def _interp_cases():
    g = BN254_G1.g
    neg_g = BN254_G1.neg_pt(g)
    gb = _w(g[0]) + _w(g[1])
    val = 0x1234_5678
    return {
        # PUSH1 5, PUSH1 7, ADD, PUSH1 0, MSTORE, PUSH1 32, PUSH1 0, RETURN
        "arithmetic and memory": ("execute", bytes([0x60, 5, 0x60, 7, 0x01, 0x60, 0, 0x52,
                                                    0x60, 32, 0x60, 0, 0xF3]), b""),
        # MSTORE val at 0, SHA3(0, 32), MSTORE 0, RETURN 32
        "keccak": ("execute", bytes([0x63]) + val.to_bytes(4, "big")
                   + bytes([0x60, 0, 0x52, 0x60, 32, 0x60, 0, 0x20, 0x60, 0, 0x52,
                            0x60, 32, 0x60, 0, 0xF3]), b""),
        # CALLDATALOAD 0, MSTORE 0, REVERT(0, 32)
        "revert": ("execute", bytes([0x60, 0, 0x35, 0x60, 0, 0x52, 0x60, 32, 0x60, 0, 0xFD]),
                   _w(0xDEAD)),
        "ecAdd": ("_ecadd_precompile", gb + gb),
        "ecAdd identity": ("_ecadd_precompile", bytes(64) + gb),
        "ecAdd off the curve": ("_ecadd_precompile", _w(1) + _w(3) + gb),
        "ecMul": ("_ecmul_precompile", gb + _w(2)),
        "ecMul by the order": ("_ecmul_precompile", gb + _w(BN254_G1.n)),
        "pairing e(G, Q) e(-G, Q)": ("_pairing_precompile", gb + _g2_bytes(G2_GEN)
                                     + _w(neg_g[0]) + _w(neg_g[1]) + _g2_bytes(G2_GEN)),
        "pairing e(G, Q) e(G, Q)": ("_pairing_precompile", gb + _g2_bytes(G2_GEN)
                                    + gb + _g2_bytes(G2_GEN)),
        "pairing bad length": ("_pairing_precompile", gb),
        "modexp": ("_modexp_precompile", _w(32) + _w(32) + _w(32) + _w(3)
                   + _w(BN254_FR.p - 2) + _w(BN254_FR.p)),
        "modexp short operands": ("_modexp_precompile", _w(2) + _w(1) + _w(3)
                                  + bytes([0x01, 0x00, 0x05, 0x00, 0x00, 0x61])),
        "modexp zero modulus": ("_modexp_precompile", _w(1) + _w(1) + _w(1) + b"\x07\x02\x00"),
    }


def _outcome(mod, case):
    """What `case` gives in the interpreter module `mod`: returned bytes, a
    revert's data, or the error's type."""
    target, *args = case
    fn = getattr(mod, target)
    try:
        return "ok", fn(*args)
    except mod.EvmRevert as e:
        return "revert", e.data
    except (ValueError, RuntimeError) as e:
        return type(e).__name__, str(e)


@pytest.mark.parametrize("name", list(_interp_cases()))
def test_interpreter_case_equals_reference(name):
    case = _interp_cases()[name]
    got = _outcome(tinterp, case)
    assert got == _outcome(jinterp, case)
    g = BN254_G1.g
    two_g = BN254_G1.add(g, g)
    expected = {
        "arithmetic and memory": ("ok", _w(12)),
        "keccak": ("ok", keccak256(_w(0x1234_5678))),
        "revert": ("revert", _w(0xDEAD)),
        "ecAdd": ("ok", _w(two_g[0]) + _w(two_g[1])),
        "ecAdd identity": ("ok", _w(g[0]) + _w(g[1])),
        "ecMul": ("ok", _w(two_g[0]) + _w(two_g[1])),
        "ecMul by the order": ("ok", bytes(64)),
        "pairing e(G, Q) e(-G, Q)": ("ok", _w(1)),
        "pairing e(G, Q) e(G, Q)": ("ok", _w(0)),
        "modexp": ("ok", _w(pow(3, BN254_FR.p - 2, BN254_FR.p))),
        "modexp short operands": ("ok", (pow(0x0100, 0x05, 0x61)).to_bytes(3, "big")),
        "modexp zero modulus": ("ok", b"\x00"),
    }
    if name in expected:
        assert got == expected[name]
    else:
        assert got[0] == "ValueError"


# ---------------------------------------------------------------------------
# the generated verifier: source and bytecode equal to the JAX package's
# ---------------------------------------------------------------------------

def _params(k: int, srs_cls, params_cls, g2_gen, mul):
    """Verifier params from the dev tau's host G2 points (no G1 powers), in
    one package's types."""
    return params_cls(srs=srs_cls(k=k, g1_powers=None, g2=g2_gen, s_g2=mul(_dev_tau(), g2_gen),
                                  g1=(1, 2)))


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """The toy circuit's port params and pk (CPU keygen), and the JAX
    package's vk over its own constraint system with the same commitments
    (``tests/test_torch_keygen.py`` holds the port's keygen to the JAX
    keygen's commitments) and its own host G2 points."""
    circ = toy_circuit(tcs)
    params = ParamsKZG(srs=gen_srs(circ.k, cache_dir=str(tmp_path_factory.mktemp("srs")),
                                   device="cpu"))
    pk = keygen(params, circ.cs, circ.fixed_values, device="cpu")
    j_vk = JVerifyingKey(k=circ.k, cs=toy_circuit(jcs).cs,
                         fixed_commitments=list(pk.vk.fixed_commitments),
                         permutation_commitments=list(pk.vk.permutation_commitments))
    j_params = _params(circ.k, JSRS, JParamsKZG, jpairing.G2_GEN, jpairing.g2_mul)
    return circ, params, pk, j_params, j_vk


@pytest.fixture(scope="module")
def toy_contracts(toy):
    circ, params, pk, j_params, j_vk = toy
    out = {}
    for multiopen in MULTIOPENS:
        src = gen_evm_verifier(params, pk.vk, 1, multiopen=multiopen)
        out[multiopen] = src, compile_solidity(src), j_gen_evm_verifier(
            j_params, j_vk, 1, multiopen=multiopen)
    return out


@pytest.fixture(scope="module")
def k18():
    """The real k=18 vk rebuilt from the committed assets in both packages
    with ``transcript_kind="keccak"`` (``tests/test_evm_exec.py``'s
    pattern), and each package's generated verifier under each multiopen:
    multiopen -> (source, bytecode, the JAX package's source)."""
    vk_data = json.loads((ASSETS / "vk_k18.json").read_text())
    pinning_json = (ASSETS / "pinning_k18.json").read_text()
    commitments = {key: [tuple(c) if c else None for c in vk_data[key]]
                   for key in ("fixed_commitments", "permutation_commitments")}
    compiled = CircuitBuilder(18, lookup_bits=17).compile(
        build_ecdsa_trace(SAMPLE_INPUT, lookup_bits=17), Pinning.from_json(pinning_json))
    vk = VerifyingKey(k=18, cs=compiled.cs, transcript_kind="keccak", **commitments)
    j_compiled = JCircuitBuilder(18, lookup_bits=17).compile(
        j_build_ecdsa_trace(J_SAMPLE, lookup_bits=17), JPinning.from_json(pinning_json))
    j_vk = JVerifyingKey(k=18, cs=j_compiled.cs, transcript_kind="keccak", **commitments)
    params = _params(18, SRS, ParamsKZG, G2_GEN, g2_mul)
    j_params = _params(18, JSRS, JParamsKZG, jpairing.G2_GEN, jpairing.g2_mul)
    out = {}
    for multiopen in MULTIOPENS:
        src = gen_evm_verifier(params, vk, num_instances=15, multiopen=multiopen)
        out[multiopen] = src, compile_solidity(src), j_gen_evm_verifier(
            j_params, j_vk, num_instances=15, multiopen=multiopen)
    return out


@pytest.mark.parametrize("multiopen", MULTIOPENS)
def test_toy_verifier_equals_reference(toy_contracts, multiopen):
    src, code, j_src = toy_contracts[multiopen]
    assert src == j_src
    assert code == j_compile_solidity(j_src)


@pytest.mark.parametrize("multiopen", MULTIOPENS)
def test_k18_verifier_equals_reference(k18, multiopen):
    src, code, j_src = k18[multiopen]
    assert src == j_src
    assert code == j_compile_solidity(j_src)
    assert "Verifies proofs of the k=18 circuit with 15 public inputs" in src


# ---------------------------------------------------------------------------
# the generated verifier, executed
# ---------------------------------------------------------------------------

def _accepts_and_rejects(code: bytes, instances: list[int], proof: bytes) -> None:
    """The contract accepts `proof`, and reverts on a changed first instance
    and on a byte flipped at each of FLIPS."""
    enc = tcalldata.encode_calldata
    assert tinterp.deploy_and_call(code, enc(instances, proof)) == b"\x01"
    with pytest.raises(tinterp.EvmRevert):
        tinterp.deploy_and_call(code, enc([instances[0] + 1] + instances[1:], proof))
    for frac in FLIPS:
        bad = bytearray(proof)
        bad[int(len(bad) * frac)] ^= 1
        with pytest.raises(tinterp.EvmRevert):
            tinterp.deploy_and_call(code, enc(instances, bytes(bad)))


@pytest.mark.parametrize("multiopen", MULTIOPENS)
def test_toy_verifier_executes_reference_proof(toy_contracts, multiopen):
    """The JAX package's keccak proofs of the toy circuit."""
    case = json.loads((TESTDATA / "reference_proofs.json").read_text())["toy"]
    key = "proofs" if multiopen == "shplonk" else "gwc_proofs"
    _accepts_and_rejects(toy_contracts[multiopen][1], case["instances"][0],
                         bytes.fromhex(case[key]["keccak"]))


def test_toy_verifier_executes_port_proof(toy, toy_contracts):
    """The port's own CPU proof of the toy circuit, with fresh blinding."""
    circ, params, pk, _, _ = toy
    advice = [mont.encode_ints(BN254_FR, col, device="cpu") for col in padded_advice(circ)]
    proof = create_proof(params, pk, advice, circ.instances, TranscriptWriter("keccak"),
                         device="cpu")
    _accepts_and_rejects(toy_contracts["shplonk"][1], circ.instances[0], proof)


@pytest.mark.parametrize("multiopen", MULTIOPENS)
def test_k18_verifier_executes_reference_proof(k18, multiopen):
    """The keccak proofs of the reference vector at k=18: the JAX package's
    (SHPLONK) and the card's (GWC, made by ``chip_smoke.py``)."""
    fixture = json.loads((TESTDATA / "p256_proof.json").read_text())
    proof = fixture["proof_keccak"] if multiopen == "shplonk" else \
        fixture["card_gwc_keccak"]["proof"]
    _accepts_and_rejects(k18[multiopen][1], fixture["instances"][0], bytes.fromhex(proof))
