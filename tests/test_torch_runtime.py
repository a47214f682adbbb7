"""The port's ``ECDSAProver`` against the JAX package's artifacts.

A params dir holding the committed vk and pinning (``assets/vk_k18.json``,
``assets/pinning_k18.json``, written by the JAX package) gives a port
prover whose light verifier path (``load_vk`` + ``verify``, host only)
accepts the committed golden proof ``assets/p256_proof.hex`` for the
reference test vector and rejects it with one instance changed, as
``tests/test_golden_proof.py`` does for the JAX package, and accepts the
JAX package's seeded proof in ``testdata/p256_proof.json``. The EVM half:
``gen_evm_verifier`` gives the JAX ``ECDSAProver``'s source on the same
params, ``verify(evm=True)`` executes the generated contract and accepts the
JAX package's keccak proof (``proof_keccak``), and the bytecode cached in the
params dir is the JAX package's file. ``shards=2`` on a CPU service proves
over a mesh of two CPU shards.
"""

import json
import shutil
from pathlib import Path

import pytest
import torch

from zkdcap_tpu_torch.circuits.p256_ecdsa import ECDSAInput
from zkdcap_tpu_torch.runtime import ECDSAProver

from test_p256_circuit import REF_MSGHASH, REF_PUBKEY, REF_SIG

ASSETS = Path(__file__).resolve().parent.parent / "assets"


@pytest.fixture(scope="module")
def prover(tmp_path_factory):
    params = tmp_path_factory.mktemp("params")
    shutil.copy(ASSETS / "vk_k18.json", params / "vk_k18.json")
    shutil.copy(ASSETS / "pinning_k18.json", params / "pinning.json")
    return ECDSAProver(params_dir=str(params), k=18)


@pytest.fixture(scope="module")
def jax_prover(tmp_path_factory):
    """The JAX package's ``ECDSAProver`` on a params dir of its own holding
    the same vk and pinning."""
    from zkdcap_tpu.runtime.prover import ECDSAProver as JECDSAProver

    params = tmp_path_factory.mktemp("jax_params")
    shutil.copy(ASSETS / "vk_k18.json", params / "vk_k18.json")
    shutil.copy(ASSETS / "pinning_k18.json", params / "pinning.json")
    return JECDSAProver(params_dir=str(params), k=18)


@pytest.fixture(scope="module")
def keccak_fixture():
    fixture = json.loads((Path(__file__).resolve().parent.parent / "zkdcap_tpu_torch"
                          / "testdata" / "p256_proof.json").read_text())
    return fixture["instances"][0], bytes.fromhex(fixture["proof_keccak"])


@pytest.fixture(scope="module")
def golden():
    proof = bytes.fromhex((ASSETS / "p256_proof.hex").read_text().strip().removeprefix("0x"))
    return ECDSAInput.from_hex(REF_MSGHASH, REF_SIG, REF_PUBKEY).as_instances(), proof


def test_golden_proof_verifies(prover, golden):
    instances, proof = golden
    assert prover.verify(instances, proof)
    vk = prover.load_vk()
    assert vk.k == 18 and vk.transcript_kind == "blake2b"
    assert prover._pk is None  # the light path loads no pk


def test_fixture_proof_verifies(prover):
    """The JAX package's seeded k=18 proof of the reference vector
    (``testdata/p256_proof.json``, which the port's proof on the card must
    equal) passes the port's verifier."""
    fixture = json.loads((Path(__file__).resolve().parent.parent / "zkdcap_tpu_torch"
                          / "testdata" / "p256_proof.json").read_text())
    assert fixture["k"] == prover.k
    assert fixture["instances"] == [ECDSAInput.from_hex(
        fixture["msghash"], fixture["signature"], fixture["pubkey"]).as_instances()]
    assert prover.verify(fixture["instances"][0], bytes.fromhex(fixture["proof"]))


def test_golden_proof_rejects_changed_instance(prover, golden):
    instances, proof = golden
    bad = list(instances)
    bad[3] ^= 1
    assert not prover.verify(bad, proof)
    flipped = bytearray(proof)
    flipped[len(flipped) // 2] ^= 1
    assert not prover.verify(instances, bytes(flipped))


def test_unported_options_raise(prover, monkeypatch):
    """``shards=2`` on a CPU service proves over a mesh of two CPU shards
    (the preparation and the proof stubbed: the mesh is what is checked)."""
    from zkdcap_tpu_torch.parallel import Mesh
    from zkdcap_tpu_torch.runtime import prover as runtime_prover

    meshes = []
    monkeypatch.setattr(ECDSAProver, "prepare",
                        lambda self, inp, timing=False: (None, [], [inp.as_instances()]))
    monkeypatch.setattr(ECDSAProver, "params", lambda self: None)
    monkeypatch.setattr(runtime_prover, "create_proof",
                        lambda *args, mesh=None, **kw: meshes.append(mesh) or b"\x01")
    cpu = ECDSAProver(params_dir=prover.params_dir, k=18, device="cpu")
    inp = ECDSAInput.from_hex(REF_MSGHASH, REF_SIG, REF_PUBKEY)
    assert cpu.create_proof(inp, shards=2, timing=False) == b"\x01"
    assert cpu.create_proof(inp, shards=1, timing=False) == b"\x01"
    mesh, single = meshes
    assert isinstance(mesh, Mesh) and mesh.devices == [torch.device("cpu")] * 2
    assert single is None


def test_gen_evm_verifier_equals_reference(prover, jax_prover):
    src = prover.gen_evm_verifier()
    assert src == jax_prover.gen_evm_verifier()
    assert prover._pk is None  # the vk and the host G2 points only


def test_evm_verify_accepts_keccak_fixture(prover, keccak_fixture):
    """``verify(evm=True)`` compiles the contract, caches its bytecode and
    executes it: the JAX package's keccak proof passes, the same proof with
    one instance changed does not, and the blake2b proof (another wire
    format) does not."""
    instances, proof = keccak_fixture
    assert prover.verify(instances, proof, evm=True)
    bad = list(instances)
    bad[3] ^= 1
    assert not prover.verify(bad, proof, evm=True)
    golden = bytes.fromhex((ASSETS / "p256_proof.hex").read_text().strip().removeprefix("0x"))
    assert not prover.verify(instances, golden, evm=True)


def test_evm_bytecode_cache_is_reference_file(prover, jax_prover):
    """The cached ``evm_verifier_k18_shplonk.bin`` holds the JAX package's
    bytes, under its name."""
    port_file = Path(prover.params_dir) / "evm_verifier_k18_shplonk.bin"
    code = prover._evm_bytecode()
    assert port_file.read_bytes() == code
    assert jax_prover._evm_bytecode() == code
    assert (Path(jax_prover.params_dir) / port_file.name).read_bytes() == code


def test_artifact_paths_match_reference(prover):
    from zkdcap_tpu.runtime.prover import ECDSAProver as JECDSAProver

    ref = JECDSAProver(params_dir=prover.params_dir, k=18)
    for name in ("pk_path", "vk_path", "pinning_path", "tape_path"):
        assert getattr(prover, name) == getattr(ref, name)
    assert (prover.lookup_bits, prover.transcript_kind) == (ref.lookup_bits, ref.transcript_kind)


def test_pk_file_is_the_reference_format(tmp_path):
    """The pk is written as np.savez_compressed writes it (a zip of deflated
    .npy members), at a lower deflate level; np.load reads it back."""
    import zipfile

    import numpy as np

    from zkdcap_tpu_torch.interop import savez_deflated

    rng = np.random.default_rng(3)
    arrays = {"fixed_lagrange": rng.integers(0, 1 << 16, (2, 64, 16), dtype=np.uint32),
              "l0_ext": rng.integers(0, 1 << 16, (256, 16), dtype=np.uint32)}
    savez_deflated(str(tmp_path / "port.npz"), arrays)
    np.savez_compressed(tmp_path / "numpy.npz", **arrays)
    with np.load(tmp_path / "port.npz") as data:
        assert sorted(data.files) == sorted(arrays)
        assert all(np.array_equal(data[k], v) and data[k].dtype == v.dtype
                   for k, v in arrays.items())
    members = [[(i.filename, i.compress_type) for i in zipfile.ZipFile(tmp_path / f).infolist()]
               for f in ("port.npz", "numpy.npz")]
    assert members[0] == members[1]


def test_pk_file_deflated_in_chunks(tmp_path):
    """Members deflated in many chunks (and an empty one) inflate to numpy's
    .npy bytes, and the zip checks clean."""
    import zipfile

    import numpy as np

    from zkdcap_tpu_torch.interop import savez_deflated

    rng = np.random.default_rng(4)
    arrays = {"sigma_extended": rng.integers(0, 1 << 16, (3, 4096, 16), dtype=np.uint32),
              "zh_inv_ext": rng.integers(0, 1 << 16, (1000, 16), dtype=np.uint32),
              "fixed_coeff": np.zeros((0, 16), np.uint32)}
    savez_deflated(str(tmp_path / "port.npz"), arrays, chunk=1 << 12)
    np.savez(tmp_path / "numpy.npz", **arrays)
    with zipfile.ZipFile(tmp_path / "port.npz") as port, \
            zipfile.ZipFile(tmp_path / "numpy.npz") as ref:
        assert port.testzip() is None
        assert [i.filename for i in port.infolist()] == [i.filename for i in ref.infolist()]
        for info in port.infolist():
            assert info.compress_type == zipfile.ZIP_DEFLATED
            assert port.read(info.filename) == ref.read(info.filename)
