"""Port vs reference: proofs over a mesh of virtual CPU shards.

The port's ``create_proof(mesh=...)`` on ``devices=["cpu"] * n`` must give
the JAX package's single-device bytes (``testdata/reference_proofs.json``,
``proofs`` for SHPLONK and ``gwc_proofs`` for GWC), which the JAX package's
own mesh tests show its mesh proofs equal (``tests/test_mesh_prover.py``,
``MULTICHIP_r05.json``). The cases cover every transcript of the toy
circuit and the flex circuit, 2 and 8 shards, both multiopens, and the row
sharder on and off (``ZKDCAP_SHARD_ROWS=0``), plus the toy proof on the
``(host=2, chip=4)`` mesh; the verifier accepts a mesh proof and rejects it
with a changed instance, as ``tests/test_mesh_prover.py`` does. A mesh
whose first shard is not the pk's device raises.
"""

import json
from pathlib import Path

import pytest
import torch

from zkdcap_tpu_torch.commit import ParamsKZG, gen_srs
from zkdcap_tpu_torch.fields import BN254_FR, mont
from zkdcap_tpu_torch.parallel import Mesh, multihost_mesh, proving_mesh
from zkdcap_tpu_torch.plonk import cs as tcs
from zkdcap_tpu_torch.plonk.keygen import keygen
from zkdcap_tpu_torch.plonk.prover import create_proof
from zkdcap_tpu_torch.plonk.verifier import verify_proof
from zkdcap_tpu_torch.testdata.circuits import REFERENCE_CASES, padded_advice
from zkdcap_tpu_torch.transcript import TranscriptWriter

FIXTURE = Path(__file__).resolve().parent.parent / "zkdcap_tpu_torch" / "testdata" / \
    "reference_proofs.json"

# (circuit, transcript, shards, multiopen, row sharder on)
CASES = [
    ("toy", "blake2b", 2, "shplonk", True),
    ("toy", "poseidon", 8, "gwc", True),
    ("toy", "keccak", 8, "shplonk", False),
    ("flex", "blake2b", 8, "shplonk", True),
    ("flex", "blake2b", 2, "gwc", False),
]


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
    srs_dir = str(tmp_path_factory.mktemp("srs"))
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


def _prove(port, fixture, name, kind, mesh: Mesh, multiopen: str) -> bytes:
    circ, params, pk, advice = port(name)
    return create_proof(params, pk, advice, circ.instances, TranscriptWriter(kind),
                        blinding_seed=fixture[name]["seed"].encode(), mesh=mesh,
                        multiopen=multiopen, device="cpu")


def _expected(fixture, name, kind, multiopen) -> str:
    return fixture[name]["proofs" if multiopen == "shplonk" else "gwc_proofs"][kind]


@pytest.mark.parametrize("name,kind,n_dev,multiopen,rows", CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}-{c[3]}-{'rows' if c[4] else 'norows'}"
                              for c in CASES])
def test_mesh_proof_equals_reference_bytes(port, fixture, monkeypatch, name, kind, n_dev,
                                           multiopen, rows):
    if not rows:
        monkeypatch.setenv("ZKDCAP_SHARD_ROWS", "0")
    mesh = proving_mesh(n_dev, devices=["cpu"] * n_dev)
    proof = _prove(port, fixture, name, kind, mesh, multiopen)
    assert proof.hex() == _expected(fixture, name, kind, multiopen)


def test_multihost_mesh_proof_verifies_and_rejects(port, fixture):
    mesh = multihost_mesh(num_hosts=2, devices=["cpu"] * 8)
    proof = _prove(port, fixture, "toy", "blake2b", mesh, "gwc")
    assert proof.hex() == _expected(fixture, "toy", "blake2b", "gwc")
    circ, params, pk, _ = port("toy")
    assert verify_proof(params, pk.vk, circ.instances, proof, multiopen="gwc")
    bad = [[circ.instances[0][0] + 1]]
    assert not verify_proof(params, pk.vk, bad, proof, multiopen="gwc")


def test_mesh_on_another_device_than_the_pk_raises(port):
    circ, params, pk, advice = port("toy")
    mesh = Mesh([torch.device("cuda", 0)] * 2, {"shard": 2})
    with pytest.raises(ValueError, match="not the pk's device"):
        create_proof(params, pk, advice, circ.instances, TranscriptWriter(), device="cpu",
                     mesh=mesh)
