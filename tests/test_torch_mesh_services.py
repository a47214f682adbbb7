"""The sharded path end to end on the CPU: the dry run and a service.

``dryrun_multichip(8, device="cpu")`` (the port of the JAX package's
``__graft_entry__.dryrun_multichip``) passes its three checks on eight
virtual CPU shards: the sharded MSM against the host curve, the sharded NTT
against ``ntt``, and the toy proof over the mesh byte-identical to the
single-device proof and verified. A ``CircuitProver`` (the tiny k = 5
FlexGate/RangeChip circuit of ``tests/test_torch_runtime_options.py``)
proves the same bytes with ``shards=2`` as with ``shards=None``.
"""

import pytest
import torch

from zkdcap_tpu_torch.parallel.dryrun import dryrun_multichip

from test_torch_runtime_options import INPUT, SEED, TinyProver


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_dryrun_multichip_on_cpu_shards():
    seconds = dryrun_multichip(8, device="cpu")
    assert set(seconds) == {"msm", "ntt", "proof"}


def test_circuit_prover_shards_prove_the_same_bytes(tmp_path):
    prover = TinyProver(params_dir=str(tmp_path), device="cpu")
    single = prover.create_proof(INPUT, timing=False, blinding_seed=SEED)
    sharded = prover.create_proof(INPUT, timing=False, shards=2, blinding_seed=SEED)
    assert sharded == single
    assert prover.verify(sharded)
