"""Port vs reference, the slice as a whole: dev SRS and KZG commitments.

Each package generates its SRS into its own temporary cache directory, so
neither reads the other's file; the G1 powers must be equal bit for bit.
With the reference SRS carried across by ``srs_from_numpy``, ``commit``,
``commit_lagrange`` and ``commit_many`` must return the reference's points.
"""

import os

import numpy as np
import pytest
import torch

from zkdcap_tpu.commit import ParamsKZG as JParamsKZG
from zkdcap_tpu.commit import gen_srs as j_gen_srs
from zkdcap_tpu.fields import BN254_FR as J_FR
from zkdcap_tpu.fields import mont as jmont
from zkdcap_tpu_torch import interop
from zkdcap_tpu_torch.commit import gen_srs
from zkdcap_tpu_torch.curves import BN254_G1
from zkdcap_tpu_torch.interop import srs_from_numpy

K = 4
R = BN254_G1.n


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def ref_srs(tmp_path_factory):
    return j_gen_srs(K, cache_dir=str(tmp_path_factory.mktemp("jax_srs")))


def _polys(count: int, seed: int):
    rng = np.random.default_rng(seed)
    return [jmont.encode_ints(J_FR, [int.from_bytes(rng.bytes(32), "little") % R
                                     for _ in range(1 << K)]) for _ in range(count)]


def _t(x):
    return interop.to_torch(np.asarray(x), device="cpu")


def test_gen_srs_matches_reference(ref_srs, tmp_path):
    srs = gen_srs(K, cache_dir=str(tmp_path), device="cpu")
    assert np.array_equal(interop.to_numpy(srs.g1_powers), np.asarray(ref_srs.g1_powers))
    assert os.listdir(tmp_path) == [f"kzg_bn254_{K}.srs.npz"]
    cached = gen_srs(K, cache_dir=str(tmp_path), device="cpu")  # the port's own file
    assert torch.equal(cached.g1_powers, srs.g1_powers)
    tau = int.from_bytes(__import__("hashlib").blake2b(b"zkdcap-tpu-dev-srs-v1").digest(),
                         "little") % R
    from zkdcap_tpu_torch.curves.device_g1 import G1_SPEC, affine_to_projective, decode_points

    pts = decode_points(G1_SPEC, affine_to_projective(G1_SPEC, srs.g1_powers))
    assert pts[:3] == [BN254_G1.mul(pow(tau, i, R), BN254_G1.g) for i in range(3)]


def test_commitments_match_reference(ref_srs):
    jparams = JParamsKZG(srs=ref_srs)
    params = srs_from_numpy(np.asarray(ref_srs.g1_powers), device="cpu")
    assert params.k == K
    a, b, c = _polys(3, 9)
    assert params.commit(_t(a)) == jparams.commit(a)
    assert params.commit_lagrange(_t(b)) == jparams.commit_lagrange(b)
    assert params.commit_many([_t(x) for x in (a, b, c)]) == jparams.commit_many([a, b, c])
    assert params.commit_many([]) == []
