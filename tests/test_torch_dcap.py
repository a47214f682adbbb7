"""Port vs reference: the DCAP k = 17 circuit and its prover's artifacts.

The port's copies of ``circuits/dcap.py`` (with its demo data), the SHA-256
and base64 chips and the builder's spread table must lay the DCAP circuit
out exactly as the JAX package does: the trace of the demo input, the
k = 17 compile (constraint system, fixed columns, pinning), the
permutation mappings and the witness fill are held to the JAX package's,
one module-scoped trace and compile per package (the recorded witness tape
and the native evaluator are in ``test_torch_dcap_tape.py``, so that the
two halves run on two workers).
A params dir whose vk and pinning the port's ``DcapProver`` wrote loads in
the JAX package's ``DcapProver`` (``load_vk``, host only), and the port's
verifier accepts the JAX package's seeded proof in
``zkdcap_tpu_torch/testdata/dcap_proof.json`` (whose vk commitments come
from the JAX package's keygen); both packages' verifiers accept the card's
GWC proof of the demo input in that file under ``multiopen="gwc"``.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from zkdcap_tpu.chips import CircuitBuilder as JBuilder
from zkdcap_tpu.circuits import dcap as jdcap
from zkdcap_tpu.plonk.keygen import permutation_mappings as j_permutation_mappings
from zkdcap_tpu.runtime.dcap_prover import DcapProver as JDcapProver
from zkdcap_tpu_torch.chips import CircuitBuilder as TBuilder
from zkdcap_tpu_torch.circuits import dcap as tdcap
from zkdcap_tpu_torch.plonk.keygen import permutation_mappings as t_permutation_mappings
from zkdcap_tpu_torch.runtime import DcapProver
from zkdcap_tpu_torch.witness.tape import cells_u16

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "zkdcap_tpu_torch" / "testdata" / "dcap_proof.json"
K, LOOKUP_BITS = 17, 16
FIELDS = ("cells", "gate_offsets", "copies", "lookup_cells", "instance_cells",
          "constant_cells", "spread_pairs")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _side(mod, builder_cls):
    """The demo input's trace and its k = 17 compile."""
    ctx = mod.build_dcap_trace(mod.load_demo_input(), LOOKUP_BITS)
    builder = builder_cls(K, lookup_bits=LOOKUP_BITS)
    return {"trace": ctx, "builder": builder, "compiled": builder.compile(ctx)}


@pytest.fixture(scope="module")
def jax_side():
    return _side(jdcap, JBuilder)


@pytest.fixture(scope="module")
def port_side():
    return _side(tdcap, TBuilder)


@pytest.fixture(scope="module")
def fixture():
    return json.loads(FIXTURE.read_text())


def _plain_copies(cs):
    return [tuple((c.kind, c.index, r) for c, r in pair) for pair in cs.copies]


def test_demo_input_matches_reference():
    t, j = tdcap.load_demo_input(), jdcap.load_demo_input()
    assert (t.cert_b64, t.qe3_report, t.r, t.s) == (j.cert_b64, j.qe3_report, j.r, j.s)
    assert tdcap.trace_inputs(t) == jdcap.trace_inputs(j)
    assert t.verify_native() and t.pubkey() == j.pubkey() and t.msghash() == j.msghash()


def test_trace_matches_reference(jax_side, port_side):
    for name in FIELDS:
        assert getattr(port_side["trace"], name) == getattr(jax_side["trace"], name), name


def test_compile_matches_reference(jax_side, port_side):
    j, t = jax_side["compiled"], port_side["compiled"]
    pin = t.pinning
    assert (pin.num_advice, pin.num_lookup_advice, pin.num_spread_advice, pin.num_cells) == \
        (16, 2, 1, 2_067_464)
    assert pin.to_json() == j.pinning.to_json()
    assert t.cs.canonical_bytes() == j.cs.canonical_bytes()
    assert t.cs.extended_k(K) == j.cs.extended_k(K) == 19
    assert [str(g) for g in t.cs.gates] == [str(g) for g in j.cs.gates]
    for kind, count in (("advice", t.cs.num_advice), ("fixed", t.cs.num_fixed)):
        assert [t.cs.column_name(kind, i) for i in range(count)] == \
            [j.cs.column_name(kind, i) for i in range(count)]
    assert _plain_copies(t.cs) == _plain_copies(j.cs)
    assert t.fixed_values == j.fixed_values


def test_permutation_mappings_match_reference(jax_side, port_side):
    n = 1 << K
    got = t_permutation_mappings(port_side["compiled"].cs, n)
    want = j_permutation_mappings(jax_side["compiled"].cs, n)
    assert got.shape == want.shape and np.array_equal(got, want)


def test_witness_fill_matches_reference(jax_side, port_side):
    raw = cells_u16(port_side["trace"].cells)
    got = port_side["builder"].witness_limbs(port_side["compiled"], port_side["trace"], raw)
    want = jax_side["builder"].witness_limbs(jax_side["compiled"], jax_side["trace"], raw)
    assert np.array_equal(got, want)


def _cached_compile(prover, side):
    """Give a prover the module's compile in place of a new trace and
    compile, after checking that the pinning it read from its params dir is
    the one that compile made."""
    def compile_(pinning=None):
        assert pinning is not None and pinning.to_json() == side["compiled"].pinning.to_json()
        prover._structure_ctx = side["trace"]
        return side["builder"], side["compiled"]
    prover._compile = compile_


def test_params_dir_loads_in_reference(tmp_path, jax_side, port_side, fixture):
    port = DcapProver(params_dir=str(tmp_path), k=K)
    vk = port._vk_from_data(fixture["vk"], port_side["compiled"].cs)
    port._save_vk(vk, port_side["compiled"].pinning)
    ref = JDcapProver(params_dir=str(tmp_path), k=K)
    for name in ("pk_path", "vk_path", "pinning_path", "tape_path"):
        assert getattr(port, name) == getattr(ref, name)
    assert (port.lookup_bits, port.transcript_kind) == (ref.lookup_bits, ref.transcript_kind)
    _cached_compile(ref, jax_side)
    jvk = ref.load_vk()
    assert ref._pk is None  # the light path loads no pk
    assert jvk.transcript_repr() == vk.transcript_repr()
    assert ref._vk_data(jvk) == fixture["vk"]


def test_fixture_proof_verifies(tmp_path, port_side, fixture):
    """The JAX package's seeded DCAP proof, which the port's proof on the
    card must equal, passes the port's light verifier; one flipped byte
    fails it."""
    assert (fixture["k"], fixture["lookup_bits"], fixture["instances"]) == (K, LOOKUP_BITS, [])
    (tmp_path / "dcap_vk_k17.json").write_text(json.dumps(fixture["vk"]))
    (tmp_path / "dcap_pinning_k17.json").write_text(port_side["compiled"].pinning.to_json())
    prover = DcapProver(params_dir=str(tmp_path), k=K)
    _cached_compile(prover, port_side)
    proof = bytes.fromhex(fixture["proof"])
    assert prover.verify(proof)
    assert prover._pk is None
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    assert not prover.verify(bytes(bad))


def test_card_gwc_proof_verifies(tmp_path, jax_side, port_side, fixture):
    """The card's GWC proof of the demo input (``card_gwc``, under the
    fixture's seed) passes the JAX package's host verifier with the JAX
    keygen's vk and the port's, both with ``multiopen="gwc"``; one flipped
    byte fails both, and the SHPLONK verifiers reject it."""
    card = fixture["card_gwc"]
    assert card["seed"] == fixture["seed"]
    proof = bytes.fromhex(card["proof"])
    assert len(proof) > len(bytes.fromhex(fixture["proof"]))
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    for cls, side, sub in ((JDcapProver, jax_side, "jax"), (DcapProver, port_side, "port")):
        (tmp_path / sub).mkdir()
        (tmp_path / sub / "dcap_vk_k17.json").write_text(json.dumps(fixture["vk"]))
        (tmp_path / sub / "dcap_pinning_k17.json").write_text(
            side["compiled"].pinning.to_json())
        gwc = cls(params_dir=str(tmp_path / sub), k=K, multiopen="gwc")
        shplonk = cls(params_dir=str(tmp_path / sub), k=K)
        for prover in (gwc, shplonk):
            _cached_compile(prover, side)
        assert gwc.verify(proof), sub
        assert not gwc.verify(bytes(bad)), sub
        assert not shplonk.verify(proof), sub


def test_unported_options_raise(tmp_path, monkeypatch):
    """``shards=2`` on a CPU DCAP service proves over a mesh of two CPU
    shards (the preparation and the proof stubbed: the mesh is checked)."""
    from types import SimpleNamespace

    from zkdcap_tpu_torch.parallel import Mesh
    from zkdcap_tpu_torch.runtime import circuit_prover

    meshes = []
    pk = SimpleNamespace(vk=SimpleNamespace(transcript_kind="blake2b"))
    monkeypatch.setattr(DcapProver, "prepare", lambda self, inp, timing=False: (pk, [], []))
    monkeypatch.setattr(DcapProver, "params", lambda self: None)
    monkeypatch.setattr(circuit_prover, "create_proof",
                        lambda *args, mesh=None, **kw: meshes.append(mesh) or b"\x01")
    prover = DcapProver(params_dir=str(tmp_path), device="cpu")
    assert prover.create_proof(tdcap.load_demo_input(), shards=2, timing=False) == b"\x01"
    (mesh,) = meshes
    assert isinstance(mesh, Mesh) and mesh.devices == [torch.device("cpu")] * 2
