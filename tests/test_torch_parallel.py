"""Port vs reference: the mesh, the sharded MSM and NTT, the row sharder.

The port's ``parallel/`` on virtual CPU shards (``devices=["cpu"] * n``,
the counterpart of the JAX tests' virtual CPU devices), held to the JAX
package's single-device results: the sharded MSM of ``tests/test_parallel.py``'s
64-point case against ``BN254_G1.msm``, and one whose blocks exceed the
ladder's 512 points (``msm_device`` per shard); the sharded NTT at 2^8 and
2^10 over 2, 4 and 8 shards against ``zkdcap_tpu.ntt.ntt`` array for array
(exact arithmetic: no tolerance). The mesh shapes and shard indices mirror
``tests/test_multihost.py``. A shard count that does not divide raises, as
the JAX package asserts. The row sharder's rounds 3 and 4 (the permutation
and lookup grand products, per row block with the blocks' totals carried)
equal the unsharded columns on the toy circuit over 2 and 8 shards, where a
block is 2 rows and the usable rows end inside one.
"""

import numpy as np
import pytest
import torch

from zkdcap_tpu.curves import BN254_G1 as J_G1
from zkdcap_tpu.fields import BN254_FR as J_FR
from zkdcap_tpu.fields import mont as jmont
from zkdcap_tpu.ntt import ntt as j_ntt
from zkdcap_tpu_torch import interop
from zkdcap_tpu_torch.commit import ParamsKZG, gen_srs
from zkdcap_tpu_torch.curves.device_g1 import G1_SPEC, decode_points, encode_points
from zkdcap_tpu_torch.fields import BN254_FR, mont
from zkdcap_tpu_torch.parallel import (
    Mesh, gather_rows, multihost_mesh, proving_mesh, sharded_msm, sharded_ntt)
from zkdcap_tpu_torch.parallel.mesh import axis_count, flat_axis_index
from zkdcap_tpu_torch.plonk import cs as tcs
from zkdcap_tpu_torch.plonk.keygen import keygen
from zkdcap_tpu_torch.plonk.prover import _lookup_z, _perm_z
from zkdcap_tpu_torch.testdata.circuits import padded_advice, toy_circuit

P = BN254_FR.p


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cpu_mesh(n: int) -> Mesh:
    return proving_mesh(n, devices=["cpu"] * n)


def test_mesh_shapes_and_shard_indices():
    mesh = _cpu_mesh(8)
    assert mesh.axis_names == ("shard",) and mesh.size == 8 and mesh.shape == {"shard": 8}
    assert [g for g, _ in mesh.local_shards()] == list(range(8))
    mh = multihost_mesh(num_hosts=2, devices=["cpu"] * 8)
    assert mh.axis_names == ("host", "chip")
    assert mh.shape["host"] == 2 and mh.shape["chip"] == 4
    assert axis_count(mh, ("host", "chip")) == 8 and axis_count(mh, "chip") == 4
    assert [flat_axis_index(mh, i) for i in range(8)] == list(range(8))
    assert mh.first == torch.device("cpu") and mh.processes == 1
    with pytest.raises(ValueError, match="divisible"):
        multihost_mesh(num_hosts=3, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="need 9 devices"):
        proving_mesh(9, devices=["cpu"] * 8)


def _msm_case(n: int, mul: int, add: int):
    pts_host = [J_G1.mul(mul * i + 1, J_G1.g) for i in range(n)]
    scalars = [(add * i + 7) for i in range(n)]
    return pts_host, scalars, J_G1.msm(scalars, pts_host)


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_msm_matches_reference(n_dev):
    pts_host, scalars, expect = _msm_case(64, 3, 5)
    for mesh in (_cpu_mesh(n_dev), multihost_mesh(num_hosts=2, devices=["cpu"] * n_dev)):
        R = sharded_msm(mesh, encode_points(G1_SPEC, pts_host, device="cpu"),
                        mont.encode_ints(BN254_FR, scalars, device="cpu"))
        assert decode_points(G1_SPEC, tuple(r.reshape(1, -1) for r in R))[0] == expect


def test_sharded_msm_device_branch_matches_reference():
    """Blocks of 520 points: each shard runs msm_device (padded to 1024)."""
    pts_host, scalars, expect = _msm_case(1040, 7, 11)
    R = sharded_msm(_cpu_mesh(2), encode_points(G1_SPEC, pts_host, device="cpu"),
                    mont.encode_ints(BN254_FR, scalars, device="cpu"))
    assert decode_points(G1_SPEC, tuple(r.reshape(1, -1) for r in R))[0] == expect


@pytest.mark.parametrize("log_n", [8, 10])
def test_sharded_ntt_matches_reference(log_n):
    n = 1 << log_n
    rng = np.random.default_rng(log_n)
    vals = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]
    ref = np.asarray(j_ntt(J_FR, jmont.encode_ints(J_FR, vals)))
    a = mont.encode_ints(BN254_FR, vals, device="cpu")
    for n_dev in (2, 4, 8):
        mesh = _cpu_mesh(n_dev)
        blocks = sharded_ntt(mesh, a)
        assert len(blocks) == n_dev and all(b.shape == (n // n_dev, 16) for b in blocks)
        assert np.array_equal(interop.to_numpy(gather_rows(mesh, blocks)), ref), n_dev


def test_shard_counts_that_do_not_divide_raise():
    a = mont.encode_ints(BN254_FR, list(range(64)), device="cpu")
    with pytest.raises(ValueError, match="divide both factors"):
        sharded_ntt(_cpu_mesh(16), a)  # 64 = 8 x 8
    pts = encode_points(G1_SPEC, [J_G1.g] * 12, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        sharded_msm(_cpu_mesh(8), pts, a[:12])
    with pytest.raises(TypeError, match="Mesh"):
        sharded_msm(object(), pts, a[:12])


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    circ = toy_circuit(tcs)
    params = ParamsKZG(srs=gen_srs(circ.k, cache_dir=str(tmp_path_factory.mktemp("srs")),
                                   device="cpu"))
    pk = keygen(params, circ.cs, circ.fixed_values, device="cpu")
    return circ, pk


def _rows(n: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return mont.encode_ints(BN254_FR, [int.from_bytes(rng.bytes(32), "little") % P
                                       for _ in range(n)], device="cpu")


@pytest.mark.parametrize("n_dev", [2, 8])
def test_row_sharded_grand_products_equal_unsharded(toy, n_dev):
    circ, pk = toy
    n = 1 << circ.k
    u = circ.cs.usable_rows(n)
    advice = [mont.encode_ints(BN254_FR, col, device="cpu") for col in padded_advice(circ)]
    instance = [mont.encode_ints(BN254_FR, col + [0] * (n - len(col)), device="cpu")
                for col in circ.instances]
    beta, gamma = _rows(1, 1), _rows(1, 2)
    chunks = -(-len(circ.cs.permutation_columns) // circ.cs.permutation_chunk_len)
    assert chunks == 2  # the chunk chaining carries z[u] across
    blinds = [_rows(n - u - 1, 10 + i) for i in range(chunks)]
    mesh = _cpu_mesh(n_dev)
    ref = _perm_z(pk, advice, instance, beta, gamma, blinds)
    got = _perm_z(pk, advice, instance, beta, gamma, blinds, mesh=mesh)
    assert len(got) == chunks and all(torch.equal(a, b) for a, b in zip(got, ref))
    lookup_data = [{key: _rows(n, 20 + i) for i, key in enumerate(("a", "s", "a_perm", "s_perm"))}]
    lk_blinds = [_rows(n - u - 1, 30)]
    ref = _lookup_z(pk, lookup_data, beta, gamma, lk_blinds)
    got = _lookup_z(pk, lookup_data, beta, gamma, lk_blinds, mesh=mesh)
    assert torch.equal(got[0], ref[0])
