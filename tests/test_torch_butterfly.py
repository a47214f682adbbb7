"""Port vs reference: kernel G's stage and the flat radix-2 NTT, bit for bit.

``butterfly_plain`` (kernel G's plain version, which the CPU path runs) is
held to the arithmetic of the JAX package's CPU branch of ``_ntt_impl``
(``zkdcap_tpu/ntt/ntt.py:137-148``: ``mont.mont_mul`` of hi by the stage's
twiddles, then ``mont.add`` / ``mont.sub``). The Pallas kernel itself
(``pallas_mont.butterfly``) is not the oracle: in interpret mode on the CPU
one call at M = 1024 did not return within 150 s.

The port's flat path (``ZKDCAP_NO_FOUR_STEP=1`` at 2^12..2^14, and the
above-2^22 branch with the size limit lowered to 2^12) is held to the JAX
package's ``ntt`` / ``intt``, which on the CPU run the flat radix-2 DIT.
Tolerance zero.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkdcap_tpu import ntt as jntt
from zkdcap_tpu.ntt.ntt import twiddle_table as j_twiddle_table
from zkdcap_tpu.fields import BN254_FR as J_FR
from zkdcap_tpu.fields import mont as jmont
from zkdcap_tpu_torch import interop
from zkdcap_tpu_torch import ntt as tntt
from zkdcap_tpu_torch.fields import BN254_FR
from zkdcap_tpu_torch.fields.butterfly_kernels import butterfly, butterfly_plain

P = BN254_FR.p
CPU = torch.device("cpu")
ntt_module = importlib.import_module("zkdcap_tpu_torch.ntt.ntt")


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
    return interop.to_torch(x, device=CPU)


def _np(x):
    return interop.to_numpy(x)


def _jax_stage(a: np.ndarray, tw: np.ndarray, s: int) -> np.ndarray:
    """One stage of the JAX package's CPU branch of ``_ntt_impl`` on a
    (n, 16) array with the n-th root's table ``tw``."""
    n = a.shape[0]
    m = 1 << s
    w_stage = jnp.asarray(tw)[:: n >> (s + 1)][:m]
    A = jnp.asarray(a).reshape(n // (2 * m), 2, m, 16)
    lo, hi = A[:, 0], A[:, 1]
    t = jmont.mont_mul(J_FR, hi, jnp.broadcast_to(w_stage[None], hi.shape))
    out = jnp.stack([jmont.add(J_FR, lo, t), jmont.sub(J_FR, lo, t)], axis=1)
    return np.asarray(out.reshape(n, 16))


@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("log_m", [0, 5, 10])
def test_butterfly_plain_matches_reference_stage(rows, log_m):
    log_n = 11
    n = 1 << log_n
    tw = np.asarray(j_twiddle_table(J_FR, log_n, False))
    # kernel G's table of the flat path is the JAX package's twiddle table
    assert np.array_equal(_np(ntt_module._flat_twiddles(log_n, False, CPU)), tw)
    x = np.stack([_poly(n, 31 * log_m + r) for r in range(rows)])
    got = butterfly(_t(x), _t(tw), log_m, n >> (log_m + 1))
    assert torch.equal(got, butterfly_plain(_t(x), _t(tw), log_m, n >> (log_m + 1)))
    for r in range(rows):
        assert np.array_equal(_np(got[r]), _jax_stage(x[r], tw, log_m))
    # in place: the same values in the input's storage
    xt = _t(x)
    assert butterfly(xt, _t(tw), log_m, n >> (log_m + 1), out=xt) is xt
    assert torch.equal(xt, got)


def test_butterfly_checks_shapes():
    x = torch.zeros(1, 8, 16, dtype=torch.int32)
    tw = torch.zeros(4, 16, dtype=torch.int32)
    with pytest.raises(ValueError):
        butterfly(x, tw, 3)  # stage past log n
    with pytest.raises(ValueError):
        butterfly(x, tw, 2, tw_stride=2)  # no row 6
    with pytest.raises(ValueError):
        butterfly(torch.zeros(1, 6, 16, dtype=torch.int32), tw, 0)


@pytest.fixture(scope="module")
def reference():
    """The JAX package's ntt and intt of seeded polys at 2^12..2^14."""
    out = {}
    for log_n in (12, 13, 14):
        xs = [_poly(1 << log_n, 1000 * log_n + i) for i in range(2)]
        out[log_n] = (xs, [np.asarray(jntt.ntt(J_FR, jnp.asarray(x))) for x in xs],
                      [np.asarray(jntt.intt(J_FR, jnp.asarray(x))) for x in xs])
    return out


@pytest.mark.parametrize("log_n", [12, 13, 14])
def test_no_four_step_matches_reference(monkeypatch, reference, log_n):
    monkeypatch.setenv("ZKDCAP_NO_FOUR_STEP", "1")
    calls = []
    flat = ntt_module._flat
    monkeypatch.setattr(ntt_module, "_flat",
                        lambda b, ln, inv: calls.append(b.shape[0]) or flat(b, ln, inv))
    xs, fwd, inv = reference[log_n]
    for x, f, i in zip(xs, fwd, inv):
        assert np.array_equal(_np(tntt.ntt(BN254_FR, _t(x))), f)
        assert np.array_equal(_np(tntt.intt(BN254_FR, _t(x))), i)
    # batches go through as one array per stage
    got = tntt.ntt_many(BN254_FR, [_t(x) for x in xs])
    assert all(np.array_equal(_np(g), f) for g, f in zip(got, fwd))
    got = tntt.intt_many(BN254_FR, [_t(x) for x in xs])
    assert all(np.array_equal(_np(g), i) for g, i in zip(got, inv))
    assert calls == [1, 1, 1, 1, 2, 2]


def test_above_size_limit_takes_flat_path(monkeypatch, reference):
    """The branch for n > 2^22, run at 2^13 with the four-step limit lowered
    to 2^12 in this test alone; the switch is not set."""
    monkeypatch.delenv("ZKDCAP_NO_FOUR_STEP", raising=False)
    monkeypatch.setattr(ntt_module, "MAX_FOUR_STEP_LOG", 12)
    calls = []
    flat = ntt_module._flat
    monkeypatch.setattr(ntt_module, "_flat",
                        lambda b, ln, inv: calls.append(ln) or flat(b, ln, inv))
    xs, fwd, inv = reference[13]
    assert np.array_equal(_np(tntt.ntt(BN254_FR, _t(xs[0]))), fwd[0])
    assert np.array_equal(_np(tntt.intt(BN254_FR, _t(xs[1]))), inv[1])
    assert calls == [13, 13]
    # 2^12 stays on the four-step path
    assert np.array_equal(_np(tntt.ntt(BN254_FR, _t(reference[12][0][0]))), reference[12][1][0])
    assert calls == [13, 13]


def test_flat_path_reads_its_chunks_in_place(monkeypatch, reference):
    """The flat path gathers nothing: kernel A reads the 2^11-point chunks as
    the columns of the array, in bit-reversed column order (``rev_rows``),
    then kernel G runs each further stage; the result equals the
    reference's."""
    monkeypatch.setenv("ZKDCAP_NO_FOUR_STEP", "1")
    passes, stages = [], []
    ntt_pass, butterfly_ = ntt_module.ntt_pass, ntt_module.butterfly

    def pass_spy(x, tw, ptw=None, out=None, rev_rows=False):
        passes.append((tuple(x.shape), x.stride(), rev_rows, out is None))
        return ntt_pass(x, tw, ptw, out=out, rev_rows=rev_rows)

    def stage_spy(a, tw, s, tw_stride=1, out=None):
        stages.append(s)
        return butterfly_(a, tw, s, tw_stride, out=out)

    monkeypatch.setattr(ntt_module, "ntt_pass", pass_spy)
    monkeypatch.setattr(ntt_module, "butterfly", stage_spy)
    xs, fwd, inv = reference[13]
    assert np.array_equal(_np(tntt.ntt(BN254_FR, _t(xs[0]))), fwd[0])
    assert np.array_equal(_np(tntt.intt(BN254_FR, _t(xs[1]))), inv[1])
    # one poly of 2^13: 4 chunks, column c at element stride 4 rows of 16 words
    assert passes == [((1, 4, 1 << 11, 16), (1 << 17, 16, 64, 1), True, True)] * 2
    assert stages == [11, 12] * 2
