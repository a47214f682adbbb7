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
from zkdcap_tpu_torch.fields.ntt_kernels import _bitrev, ntt_pass, ntt_pass_plain
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


@pytest.mark.parametrize("post", [False, True])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("log_s", [1, 4, 8, 11])
def test_pass_on_strided_views_matches_contiguous(log_s, inverse, post):
    """Kernel A's wrapper (its plain version on the CPU) on strided 4-D and
    3-D views, and into an ``out=`` view, equals the call on contiguous rows
    followed by the explicit transpose; the post-multiply follows the
    output's logical order."""
    size, rows, nb = 1 << log_s, 3 if log_s < 11 else 2, 2
    cpu = torch.device("cpu")
    # batch b holds a (size, rows) array; the transform runs down its columns
    base = _t(_poly(nb * rows * size, 70 + log_s)).view(nb, size, rows, 16)
    x = base.transpose(1, 2)  # (nb, rows, size, 16): batch and row strides apart
    tw = _pass_twiddles(log_s, inverse, cpu)
    ptw = _t(_poly(rows * size, 80 + log_s)) if post else None
    ref = ntt_pass(x.contiguous(), tw, ptw)
    assert torch.equal(ntt_pass(x, tw, ptw), ref)
    assert torch.equal(ntt_pass(x[1], tw, ptw), ntt_pass(x[1].contiguous(), tw, ptw))
    out = torch.empty(nb, size, rows, 16, dtype=torch.int32)
    got = ntt_pass(x, tw, ptw, out=out.transpose(1, 2))
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(out, ref.transpose(1, 2).contiguous())
    out3 = torch.empty(size, rows, 16, dtype=torch.int32)
    ntt_pass_plain(x[0], tw, ptw, out=out3.transpose(0, 1))
    assert torch.equal(out3, ref[0].transpose(0, 1))


@pytest.mark.parametrize("inverse", [False, True])
def test_four_step_reads_and_writes_views_without_copies(monkeypatch, inverse):
    """The four-step transform is two passes of kernel A: pass A reads the
    batch in place, pass B reads pass A's output in place and writes the
    result, and no contiguous copy or clone is made between them. The result
    equals the reference's ntt_many / intt_many."""
    ntt_module = importlib.import_module("zkdcap_tpu_torch.ntt.ntt")
    calls, copies, inside = [], [], []
    orig = ntt_module.ntt_pass

    def spy(x, tw, ptw=None, out=None):
        calls.append((x, out))
        inside.append(True)
        try:
            return orig(x, tw, ptw, out=out)
        finally:
            inside.pop()

    def counted(name):
        method = getattr(torch.Tensor, name)

        def run(self, *args, **kwargs):
            if not inside:
                copies.append(name)
            return method(self, *args, **kwargs)
        return run

    xs = [_poly(1 << 12, 100 + i) for i in range(3)]
    batch = _t(np.stack(xs))
    _transform(BN254_FR, batch, inverse)  # builds and caches the twiddle tables
    monkeypatch.setattr(ntt_module, "ntt_pass", spy)
    for name in ("contiguous", "clone", "reshape"):
        monkeypatch.setattr(torch.Tensor, name, counted(name))
    got = _transform(BN254_FR, batch, inverse)
    monkeypatch.undo()
    assert copies == [] and len(calls) == 2
    (xa, oa), (xb, ob) = calls
    assert xa.data_ptr() == batch.data_ptr() and not xa.is_contiguous()
    assert xb.data_ptr() == oa.data_ptr() and not xb.is_contiguous()
    assert ob.data_ptr() == got.data_ptr() and not ob.is_contiguous()
    ref = (jntt.intt_many if inverse else jntt.ntt_many)(J_FR, [jnp.asarray(x) for x in xs])
    assert all(np.array_equal(_np(g), np.asarray(r)) for g, r in zip(got, ref))


@pytest.mark.parametrize("log_rows", [0, 1, 3])
def test_pass_with_rev_rows_reads_rows_bit_reversed(log_rows):
    """``rev_rows``: output row r of each batch is the transform of x's row
    bitrev(r), on strided views as on contiguous ones."""
    cpu = torch.device("cpu")
    rows, log_s, nb = 1 << log_rows, 5, 2
    x = _t(_poly(nb * rows << log_s, 90 + log_rows)).view(nb, 1 << log_s, rows, 16).transpose(1, 2)
    tw = _pass_twiddles(log_s, False, cpu)
    rev = [int(r) for r in _bitrev(log_rows)] if log_rows else [0]
    ref = ntt_pass(x[:, rev].contiguous(), tw)
    assert torch.equal(ntt_pass(x, tw, rev_rows=True), ref)
    assert torch.equal(ntt_pass(x[0], tw, rev_rows=True), ref[0])
    with pytest.raises(ValueError, match="power-of-two"):
        ntt_pass(torch.zeros(3, 1 << log_s, 16, dtype=torch.int32), tw, rev_rows=True)


def test_pass_rejects_views_it_cannot_take():
    """Views the kernel cannot read or write raise ValueError before any
    work, on the CPU as on the card."""
    cpu = torch.device("cpu")
    tw = _pass_twiddles(3, False, cpu)
    x = torch.zeros(2, 8, 16, dtype=torch.int32)
    with pytest.raises(ValueError, match="limb dimension"):
        ntt_pass(torch.zeros(2, 16, 8, dtype=torch.int32).transpose(1, 2), tw)
    with pytest.raises(ValueError, match="16-byte"):
        ntt_pass(torch.zeros(2 * 8 * 16 + 2, dtype=torch.int32)[2:].view(2, 8, 16), tw)
    with pytest.raises(ValueError, match="16-byte"):
        ntt_pass(torch.zeros(2, 8, 18, dtype=torch.int32)[:, :, :16], tw)
    with pytest.raises(ValueError, match="overlap"):
        ntt_pass(x, tw, out=x)
    with pytest.raises(ValueError, match="overlap"):
        ntt_pass(x[:, :4], _pass_twiddles(2, False, cpu), out=x[:, 2:6])
    with pytest.raises(ValueError, match="overlap"):
        ntt_pass(x, tw, out=torch.zeros(1, 1, 16, dtype=torch.int32).expand(2, 8, 16))
    with pytest.raises(ValueError, match="out must be"):
        ntt_pass(x, tw, out=torch.zeros(2, 4, 16, dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        ntt_pass(x.to(torch.int64), tw)


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
