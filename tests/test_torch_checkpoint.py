"""Port vs reference: per-transcript-round proof checkpoints
(``plonk/checkpoint.py``).

Mirrors ``tests/test_checkpoint.py`` on the port's CPU path with the toy
circuit of ``REFERENCE_CASES``: a proof preempted after each of r1-r6 and
resumed equals the uninterrupted proof, fresh blinding survives a resume,
and different inputs are refused. The file format is the JAX package's:
a round file that either package writes has the same members, dtypes,
arrays and ``__spec__``, and a checkpoint written by either package after
r2 resumes in the other to the JAX package's proof bytes
(``testdata/reference_proofs.json``).
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from zkdcap_tpu.commit import ParamsKZG as JParamsKZG  # noqa: E402
from zkdcap_tpu.commit import gen_srs as j_gen_srs  # noqa: E402
from zkdcap_tpu.fields import BN254_FR as J_FR  # noqa: E402
from zkdcap_tpu.fields import mont as jmont  # noqa: E402
from zkdcap_tpu.plonk import cs as jcs  # noqa: E402
from zkdcap_tpu.plonk.checkpoint import Preempted as JPreempted  # noqa: E402
from zkdcap_tpu.plonk.keygen import keygen as j_keygen  # noqa: E402
from zkdcap_tpu.plonk.prover import create_proof as j_create_proof  # noqa: E402
from zkdcap_tpu.transcript import TranscriptWriter as JTranscriptWriter  # noqa: E402
from zkdcap_tpu_torch.commit import ParamsKZG, gen_srs  # noqa: E402
from zkdcap_tpu_torch.fields import BN254_FR, mont  # noqa: E402
from zkdcap_tpu_torch.plonk import cs as tcs  # noqa: E402
from zkdcap_tpu_torch.plonk.checkpoint import Preempted  # noqa: E402
from zkdcap_tpu_torch.plonk.keygen import keygen  # noqa: E402
from zkdcap_tpu_torch.plonk.prover import create_proof  # noqa: E402
from zkdcap_tpu_torch.plonk.verifier import verify_proof  # noqa: E402
from zkdcap_tpu_torch.testdata.circuits import REFERENCE_CASES, padded_advice  # noqa: E402
from zkdcap_tpu_torch.transcript import TranscriptWriter  # noqa: E402

FIXTURE = ROOT / "zkdcap_tpu_torch" / "testdata" / "reference_proofs.json"
SEED = b"checkpoint-parity"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def toy():
    return json.loads(FIXTURE.read_text())["toy"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    circ = REFERENCE_CASES["toy"][0](tcs)
    params = ParamsKZG(srs=gen_srs(circ.k, cache_dir=str(tmp_path_factory.mktemp("srs")),
                                   device="cpu"))
    pk = keygen(params, circ.cs, circ.fixed_values, device="cpu")
    advice = [mont.encode_ints(BN254_FR, col, device="cpu") for col in padded_advice(circ)]
    return params, pk, advice, circ.instances


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX package's params, pk and advice of the same circuit."""
    circ = REFERENCE_CASES["toy"][0](jcs)
    params = JParamsKZG(srs=j_gen_srs(circ.k, cache_dir=str(tmp_path_factory.mktemp("jsrs"))))
    pk = j_keygen(params, circ.cs, circ.fixed_values)
    advice = [jmont.encode_ints(J_FR, col) for col in padded_advice(circ)]
    return params, pk, advice, circ.instances


def _prove(setup, seed=SEED, instances=None, **kw):
    params, pk, advice, inst = setup
    return create_proof(params, pk, advice, inst if instances is None else instances,
                        TranscriptWriter("blake2b"), blinding_seed=seed, device="cpu", **kw)


def _j_prove(ref, seed, **kw):
    params, pk, advice, inst = ref
    return j_create_proof(params, pk, advice, inst, JTranscriptWriter("blake2b"),
                          blinding_seed=seed, **kw)


def _npz_left(ckdir):
    return [f for f in os.listdir(ckdir) if f.endswith(".npz")]


@pytest.mark.parametrize("rnd", ["r1", "r2", "r3", "r4", "r5", "r6"])
def test_resume_after_each_round_bit_identical(setup, toy, tmp_path, rnd):
    golden = bytes.fromhex(toy["proofs"]["blake2b"])
    seed = toy["seed"].encode()
    ckdir = str(tmp_path / rnd)
    with pytest.raises(Preempted):
        _prove(setup, seed, checkpoint_dir=ckdir, _abort_after=rnd)
    assert sorted(_npz_left(ckdir)) == \
        [f"ck_blake2b_r{i}.npz" for i in range(1, int(rnd[1]) + 1)]
    resumed = _prove(setup, seed, checkpoint_dir=ckdir)
    assert resumed == golden, f"resume after {rnd} diverges"
    assert not _npz_left(ckdir), "checkpoints must be cleared after a finished proof"


def test_resume_preserves_fresh_blinding(setup, tmp_path):
    """With the default fresh-entropy blinding, the seed must persist in
    the round-1 checkpoint so later rounds blind consistently."""
    params, pk, _, inst = setup
    ckdir = str(tmp_path / "fresh")
    with pytest.raises(Preempted):
        _prove(setup, None, checkpoint_dir=ckdir, _abort_after="r3")
    resumed = _prove(setup, None, checkpoint_dir=ckdir)
    assert verify_proof(params, pk.vk, inst, resumed)


def test_checkpoint_rejects_different_inputs(setup, tmp_path):
    ckdir = str(tmp_path / "fp")
    with pytest.raises(Preempted):
        _prove(setup, checkpoint_dir=ckdir, _abort_after="r1")
    with pytest.raises(AssertionError, match="different proof inputs"):
        _prove(setup, instances=[[7]], checkpoint_dir=ckdir)


def test_round_files_are_the_reference_format(setup, ref, toy, tmp_path):
    """Round files r1-r2 that the two packages write for the same proof
    hold the same members with the same dtypes and arrays, and the same
    ``__spec__`` bytes."""
    seed = toy["seed"].encode()
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    with pytest.raises(JPreempted):
        _j_prove(ref, seed, checkpoint_dir=str(jdir), _abort_after="r2")
    with pytest.raises(Preempted):
        _prove(setup, seed, checkpoint_dir=str(tdir), _abort_after="r2")
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir)) == \
        ["ck_blake2b_r1.npz", "ck_blake2b_r2.npz"]
    for name in os.listdir(jdir):
        with np.load(jdir / name) as j, np.load(tdir / name) as t:
            assert sorted(j.files) == sorted(t.files)
            for member in j.files:
                assert j[member].dtype == t[member].dtype, (name, member)
                assert np.array_equal(j[member], t[member]), (name, member)


def test_reference_checkpoint_resumes_in_port(setup, ref, toy, tmp_path):
    """A checkpoint that the JAX package wrote after r2 resumes in the port
    to the JAX package's proof bytes."""
    seed = toy["seed"].encode()
    ckdir = str(tmp_path / "ck")
    with pytest.raises(JPreempted):
        _j_prove(ref, seed, checkpoint_dir=ckdir, _abort_after="r2")
    assert _prove(setup, seed, checkpoint_dir=ckdir).hex() == toy["proofs"]["blake2b"]
    assert not _npz_left(ckdir)


def test_port_checkpoint_resumes_in_reference(setup, ref, toy, tmp_path):
    """The reverse: the port writes after r2, the JAX package resumes to its
    own proof bytes."""
    seed = toy["seed"].encode()
    ckdir = str(tmp_path / "ck")
    with pytest.raises(Preempted):
        _prove(setup, seed, checkpoint_dir=ckdir, _abort_after="r2")
    assert _j_prove(ref, seed, checkpoint_dir=ckdir).hex() == toy["proofs"]["blake2b"]
    assert not _npz_left(ckdir)
