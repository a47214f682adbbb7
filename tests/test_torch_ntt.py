"""Port vs reference: NTT, four-step NTT, power tables and Domain, bit for bit.

On the CPU the port runs kernel A's plain version (one pass up to 2^11, the
four-step two-pass transform above); the JAX package runs its flat radix-2
``_ntt_impl``, which its own ``tests/test_ntt.py`` pins to its four-step
path. Tolerance zero.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkdcap_tpu import ntt as jntt
from zkdcap_tpu.ntt.ntt import power_table as j_power_table
from zkdcap_tpu.fields import BN254_FR as J_FR
from zkdcap_tpu.fields import mont as jmont
from zkdcap_tpu_torch import interop
from zkdcap_tpu_torch import ntt as tntt
from zkdcap_tpu_torch.fields import BN254_FR, mont
from zkdcap_tpu_torch.fields.ntt_kernels import ntt_pass, ntt_pass_plain
from zkdcap_tpu_torch.ntt.ntt import _pass_twiddles, _transform

P = BN254_FR.p


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _poly(n: int, seed: int) -> np.ndarray:
    """Seeded canonical Montgomery limbs (uint32[n, 16])."""
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]
    return np.asarray(jmont.encode_ints(J_FR, vals))


def _t(x):
    return interop.to_torch(x, device="cpu")


def _np(x):
    return interop.to_numpy(x)


@pytest.mark.parametrize("log_n", range(1, 14))
def test_ntt_intt_match_reference(log_n):
    """ntt against the reference at every size; intt against the reference
    up to 2^8 and, above, as the exact inverse of an ntt that matched (the
    reference's intt is that inverse too; its compiles at 2^9..2^13 would
    cost half a minute of XLA:CPU)."""
    x = _poly(1 << log_n, log_n)
    fwd = tntt.ntt(BN254_FR, _t(x))
    assert np.array_equal(_np(fwd), np.asarray(jntt.ntt(J_FR, jnp.asarray(x))))
    assert np.array_equal(_np(tntt.intt(BN254_FR, fwd)), x)
    if log_n <= 8:
        inv = _np(tntt.intt(BN254_FR, _t(x)))
        assert np.array_equal(inv, np.asarray(jntt.intt(J_FR, jnp.asarray(x))))


@pytest.mark.parametrize("log_n", [3, 12])
def test_ntt_many_intt_many_match_reference(log_n):
    xs = [_poly(1 << log_n, 100 + i) for i in range(3)]
    got = tntt.ntt_many(BN254_FR, [_t(x) for x in xs])
    ref = jntt.ntt_many(J_FR, [jnp.asarray(x) for x in xs])
    assert all(np.array_equal(_np(g), np.asarray(r)) for g, r in zip(got, ref))
    got = tntt.intt_many(BN254_FR, [_t(x) for x in xs])
    ref = jntt.intt_many(J_FR, [jnp.asarray(x) for x in xs])
    assert all(np.array_equal(_np(g), np.asarray(r)) for g, r in zip(got, ref))
    back = tntt.intt_many(BN254_FR, tntt.ntt_many(BN254_FR, [_t(x) for x in xs]))
    assert all(np.array_equal(_np(b), x) for b, x in zip(back, xs))


@pytest.mark.slow
@pytest.mark.parametrize("log_n", [12, 13])
def test_four_step_matches_reference_four_step(log_n):
    """The port's two plain kernel-A passes against the reference's
    ntt_four_step, whose Pallas passes run in interpret mode on the CPU (as
    tests/test_ntt.py runs them: minutes of XLA compile per size)."""
    from zkdcap_tpu.ntt.ntt import ntt_four_step

    x = _poly(1 << log_n, 7 * log_n)
    for inverse in (False, True):
        ref = np.asarray(ntt_four_step(J_FR, jnp.asarray(x), inverse))
        got = tntt.intt(BN254_FR, _t(x)) if inverse else tntt.ntt(BN254_FR, _t(x))
        assert np.array_equal(_np(got), ref)


def test_pass_with_post_multiply_and_batch():
    """Kernel A's plain version on a batch of rows with a per-element
    post-multiply equals the NTT of each row times that operand."""
    rows, log_s = 3, 4
    x = np.stack([_poly(1 << log_s, 50 + r) for r in range(rows)])
    ptw = _poly(rows << log_s, 60)
    tw = _pass_twiddles(log_s, False, torch.device("cpu"))
    got = ntt_pass(_t(x), tw, _t(ptw))
    assert torch.equal(got, ntt_pass_plain(_t(x), tw, _t(ptw)))
    for r in range(rows):
        ref = jmont.mont_mul(J_FR, jntt.ntt(J_FR, jnp.asarray(x[r])),
                             jnp.asarray(ptw[r << log_s : (r + 1) << log_s]))
        assert np.array_equal(_np(got[r]), np.asarray(ref))


def test_power_table_matches_reference():
    for base, n in ((5, 37), (BN254_FR.nth_root_of_unity(6), 64)):
        ref = np.asarray(j_power_table(J_FR, base, n))
        assert np.array_equal(_np(tntt.power_table(BN254_FR, base, n, "cpu")), ref)


def test_domain_matches_reference():
    k, ek = 5, 7
    jd, td = jntt.Domain(J_FR, k, ek), tntt.Domain(BN254_FR, k, ek)
    assert (td.omega, td.extended_omega, td.g_coset) == (jd.omega, jd.extended_omega, jd.g_coset)
    x = _poly(1 << k, 11)
    ext = td.coeff_to_extended(_t(x))
    assert np.array_equal(_np(ext), np.asarray(jd.coeff_to_extended(jnp.asarray(x))))
    back = td.extended_to_coeff(ext)
    assert np.array_equal(_np(back), np.asarray(jd.extended_to_coeff(jnp.asarray(_np(ext)))))
    assert np.array_equal(_np(back[: 1 << k]), x) and not _np(back[1 << k :]).any()
    lag = _poly(1 << k, 12)
    assert np.array_equal(_np(td.lagrange_to_coeff(_t(lag))),
                          np.asarray(jd.lagrange_to_coeff(jnp.asarray(lag))))
    assert np.array_equal(_np(td.coeff_to_lagrange(_t(lag))),
                          np.asarray(jd.coeff_to_lagrange(jnp.asarray(lag))))


def test_size_limits(monkeypatch):
    """2^23 points and more go to the flat radix-2 path (checked by its
    dispatch: a 2^23-point transform is not allocated on the CPU); sizes
    that are not powers of two raise; one point is its own transform."""
    ntt_module = importlib.import_module("zkdcap_tpu_torch.ntt.ntt")
    calls = []
    monkeypatch.setattr(ntt_module, "_flat",
                        lambda batch, log_n, inverse: calls.append((log_n, inverse)) or batch)
    big = torch.zeros(1, 1, 16, dtype=torch.int32).expand(1, 1 << 23, 16)
    assert _transform(BN254_FR, big, False) is big and calls == [(23, False)]
    with pytest.raises(ValueError):
        tntt.ntt(BN254_FR, torch.zeros(6, 16, dtype=torch.int32))
    one = mont.encode_ints(BN254_FR, [42], device="cpu")
    assert torch.equal(tntt.ntt(BN254_FR, one), one)
