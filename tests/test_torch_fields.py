"""Port vs reference: BN254 Montgomery field ops, bit for bit.

Seeded numpy batches (with 0, 1, p-1 and p-2) go through
``zkdcap_tpu.fields.mont`` and ``zkdcap_tpu_torch.fields.mont`` on the CPU;
the canonical limb arrays must be equal (tolerance zero).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkdcap_tpu.fields import BN254_FQ as J_FQ
from zkdcap_tpu.fields import BN254_FR as J_FR
from zkdcap_tpu.fields import mont as jmont
from zkdcap_tpu_torch import interop
from zkdcap_tpu_torch.curves.device_g1 import G1_SPEC
from zkdcap_tpu_torch.fields import BN254_FQ, BN254_FR, mont
from zkdcap_tpu_torch.fields.params import R

FIELDS = {"fr": (J_FR, BN254_FR), "fq": (J_FQ, BN254_FQ)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ints(p: int, seed: int, n: int = 12) -> list[int]:
    rng = np.random.default_rng(seed)
    rand = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)]
    return [0, 1, p - 1, p - 2] + rand


def _limbs(vals) -> np.ndarray:
    buf = b"".join(v.to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, dtype=np.uint16).reshape(-1, 16).astype(np.uint32)


def _both(name):
    jp, tp = FIELDS[name]
    a = _limbs(_ints(jp.p, 1))
    b = _limbs(_ints(jp.p, 2)[::-1])
    return jp, tp, a, b


def _t(x):
    return interop.to_torch(x, device="cpu")


def _np(x):
    return interop.to_numpy(x)


BINARY = ["add", "sub", "mont_mul"]
UNARY = ["neg", "mont_sqr", "to_mont", "from_mont"]


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("op", BINARY)
def test_binary_ops(field, op):
    jp, tp, a, b = _both(field)
    ref = np.asarray(getattr(jmont, op)(jp, jnp.asarray(a), jnp.asarray(b)))
    got = _np(getattr(mont, op)(tp, _t(a), _t(b)))
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("op", UNARY)
def test_unary_ops(field, op):
    jp, tp, a, _ = _both(field)
    ref = np.asarray(getattr(jmont, op)(jp, jnp.asarray(a)))
    got = _np(getattr(mont, op)(tp, _t(a)))
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("field", FIELDS)
def test_pow_and_inverses(field):
    jp, tp, a, _ = _both(field)
    for e in (0, 1, 5, 0x1234567):
        ref = np.asarray(jmont.mont_pow(jp, jnp.asarray(a), e))
        assert np.array_equal(_np(mont.mont_pow(tp, _t(a), e)), ref)
    ref = np.asarray(jmont.mont_inv(jp, jnp.asarray(a)))
    assert np.array_equal(_np(mont.mont_inv(tp, _t(a))), ref)  # maps 0 -> 0
    nz = a[1:]  # batch_inv needs every row nonzero
    ref = np.asarray(jmont.batch_inv(jp, jnp.asarray(nz)))
    assert np.array_equal(_np(mont.batch_inv(tp, _t(nz))), ref)


@pytest.mark.parametrize("field", FIELDS)
def test_predicates_select_and_constants(field):
    jp, tp, a, b = _both(field)
    b[3] = a[3]
    cond = np.arange(a.shape[0]) % 3 == 0
    assert np.array_equal(mont.is_zero(_t(a)).numpy(), np.asarray(jmont.is_zero(jnp.asarray(a))))
    assert np.array_equal(mont.eq(_t(a), _t(b)).numpy(),
                          np.asarray(jmont.eq(jnp.asarray(a), jnp.asarray(b))))
    got = mont.select(torch.as_tensor(cond), _t(a), _t(b))
    assert np.array_equal(_np(got), np.asarray(jmont.select(jnp.asarray(cond), jnp.asarray(a),
                                                            jnp.asarray(b))))
    assert np.array_equal(_np(mont.one_mont(tp, (3,), "cpu")),
                          np.asarray(jmont.one_mont(jp, (3,))))


@pytest.mark.parametrize("field", FIELDS)
def test_encode_decode(field):
    jp, tp, _, _ = _both(field)
    vals = _ints(jp.p, 3) + [jp.p, 2 * jp.p + 5]  # reduced mod p on the way in
    enc = mont.encode_ints(tp, vals, device="cpu")
    assert np.array_equal(_np(enc), np.asarray(jmont.encode_ints(jp, vals)))
    assert mont.decode_ints(tp, enc) == jmont.decode_ints(jp, jmont.encode_ints(jp, vals))
    raw = mont.encode_ints(tp, vals, to_montgomery=False, device="cpu")
    assert mont.decode_ints(tp, raw, from_montgomery=False) == [v % jp.p for v in vals]


def test_cuda_header_constants_match_params():
    """The constants in csrc/bn254_mont.cuh are the fields' own, and its
    addition chain for b3 * a computes the curve's b3."""
    src = (Path(mont.__file__).parent.parent / "csrc" / "bn254_mont.cuh").read_text()

    def words(name, struct):
        body = src.split(f"struct {struct} {{")[1].split("\n};")[0]
        arr = re.search(rf"{name}\[8\] = \{{([^}}]*)\}}", body).group(1)
        return sum(int(w.strip().rstrip("u"), 16) << (32 * i)
                   for i, w in enumerate(arr.split(",")))

    def inv(struct):
        body = src.split(f"struct {struct} {{")[1].split("\n};")[0]
        return int(re.search(r"INV = (0x[0-9a-f]+)u", body).group(1), 16)

    for struct, params in (("Fq", BN254_FQ), ("Fr", BN254_FR)):
        assert words("P", struct) == params.p
        assert inv(struct) == (-pow(params.p, -1, 1 << 32)) % (1 << 32)
    assert words("ONE", "Fq") == R % BN254_FQ.p
    chain = src.split("Fe mul_b3(const Fe& a) {")[1].split("\n}")[0]
    add = "fe_add_cc<Fq>"  # the point formulas' (carry-chain) addition
    doublings = chain.count(f"{add}(a, a)") + chain.count(f"{add}(t, t)")
    assert chain.rstrip().endswith(f"return {add}(t, a);")
    assert 2 ** doublings + 1 == G1_SPEC.b3
