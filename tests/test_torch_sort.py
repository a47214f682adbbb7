"""Port vs reference: kernel F's plain version (the bitonic network).

The port's ``bitonic_sort`` and ``sort_rows_by_key`` on the CPU (the plain
torch network) against ``zkdcap_tpu.utils.device_sort`` in Pallas interpret
mode, array for array: the network is deterministic (ties never swap), so
the order of tied payloads must agree too. Keys are u32 in the JAX package
and int32 bit patterns in the port; keys at and above 2^31 check that the
port compares them as unsigned.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkdcap_tpu.utils import device_sort as jds
from zkdcap_tpu_torch.utils import device_sort as tds

RNG = np.random.default_rng(31)


def _u32(shape, hi):
    return RNG.integers(0, hi, shape, dtype=np.uint64).astype(np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _n(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


KEYS = {
    "ties": lambda shape: _u32(shape, 1 << 6),
    "below_2^30": lambda shape: _u32(shape, 1 << 30),
    "full_u32": lambda shape: _u32(shape, 1 << 32),
    "all_equal": lambda shape: np.full(shape, 0x9000_0001, np.uint32),
    "high_bit_split": lambda shape: (_u32(shape, 2) << np.uint32(31)) | _u32(shape, 4),
}


@pytest.mark.parametrize("log_n", [10, 11])
@pytest.mark.parametrize("keys", sorted(KEYS))
def test_bitonic_sort_matches_reference(log_n, keys):
    n = 1 << log_n
    key = KEYS[keys]((3, n))
    pay = np.broadcast_to(np.arange(n, dtype=np.uint32), (3, n)).copy()
    want = jds.bitonic_sort((jnp.asarray(key), jnp.asarray(pay)), interpret=True)
    got = tds.bitonic_sort((_t(key), _t(pay)))
    for g, w in zip(got, want):
        assert np.array_equal(_n(g), np.asarray(w))
    # ascending as unsigned, and a permutation of the payload
    assert (np.diff(_n(got[0]).astype(np.int64), axis=1) >= 0).all()
    assert (np.sort(_n(got[1]), axis=1) == pay).all()


def test_bitonic_sort_one_operand_and_1d():
    n = 1 << 10
    key = _u32((n,), 1 << 32)
    (want,) = jds.bitonic_sort((jnp.asarray(key),), interpret=True)
    (got,) = tds.bitonic_sort((_t(key),))
    assert got.shape == (n,) and np.array_equal(_n(got), np.asarray(want))
    assert np.array_equal(_n(got), np.sort(key))


@pytest.mark.parametrize("per_window", [False, True], ids=["shared", "per_window"])
@pytest.mark.parametrize("log_n", [10, 11])
def test_sort_rows_by_key_matches_reference(log_n, per_window):
    n, w, p = 1 << log_n, 3, 8
    key = _u32((w, n), 1 << 32)
    key[:, ::5] = key[:, 1::5]  # ties among the planes' rows
    key[1] = 0x8000_0000  # a window of equal keys at 2^31
    planes = _u32((w, p, n) if per_window else (p, n), 1 << 32)
    wk, wp = jds.sort_rows_by_key(jnp.asarray(key), jnp.asarray(planes), per_window,
                                  interpret=True)
    gk, gp = tds.sort_rows_by_key(_t(key), _t(planes), per_window)
    assert np.array_equal(_n(gk), np.asarray(wk))
    assert gp.shape == (w, p, n) and np.array_equal(_n(gp), np.asarray(wp))


def test_sort_rows_by_key_segments(monkeypatch):
    """N = 2 segments: each (window, segment) block sorts on its own, and
    the reference, with its segment set to the same width, agrees."""
    n, w, p = 1 << 11, 2, 8
    monkeypatch.setattr(tds, "ROWS_SORT_SEG", 1 << 10)
    monkeypatch.setattr(jds, "ROWS_SORT_SEG", 1 << 10)
    key = _u32((w, n), 1 << 32)
    planes = _u32((p, n), 1 << 32)
    wk, wp = jds.sort_rows_by_key(jnp.asarray(key), jnp.asarray(planes), False, interpret=True)
    gk, gp = tds.sort_rows_by_key(_t(key), _t(planes), False)
    assert np.array_equal(_n(gk), np.asarray(wk)) and np.array_equal(_n(gp), np.asarray(wp))
    half = 1 << 10
    assert np.array_equal(_n(gk)[:, :half], np.sort(key[:, :half], axis=1))
    assert np.array_equal(_n(gk)[:, half:], np.sort(key[:, half:], axis=1))


def test_sort_bounds_agree():
    assert (tds.MAX_LOG_N, tds.MIN_LOG_N, tds.ROWS_SORT_SEG) == \
        (jds.MAX_LOG_N, jds.MIN_LOG_N, jds.ROWS_SORT_SEG)
    for n in [1 << e for e in range(8, 24)] + [3 << 10, 1000]:
        for n_ops in (1, 2, 9, 17):
            assert tds.sort_supported(n, n_ops) == jds.sort_supported(n, n_ops), (n, n_ops)
        assert tds.rows_sort_segments(n) == jds.rows_sort_segments(n)


def _by_position(key: torch.Tensor, planes: torch.Tensor, per_window: bool):
    """Kernel F's row sort as it runs on the card: the network on the key and
    the position only, then one gather of the 8 planes by the final position."""
    w, n = key.shape
    skey, order = tds.bitonic_network_plain(
        [key, torch.arange(n, dtype=torch.int32).expand(w, n).contiguous()])
    src = planes if per_window else planes[None].expand(w, *planes.shape)
    return skey, torch.gather(src, 2, order.to(torch.int64)[:, None].expand(src.shape))


@pytest.mark.parametrize("per_window", [False, True], ids=["shared", "per_window"])
@pytest.mark.parametrize("log_n", [10, 11])
@pytest.mark.parametrize("keys", sorted(KEYS))
def test_key_and_position_network_moves_planes_as_the_full_network(keys, log_n, per_window):
    """The swaps read only the keys, so the network on (key, position) and one
    gather of the other operands give what the network on all 9 operands
    gives, the order of tied rows included."""
    n, w, p = 1 << log_n, 3, 8
    key = _t(KEYS[keys]((w, n)))
    planes = _t(_u32((w, p, n) if per_window else (p, n), 1 << 32))
    src = planes if per_window else planes[None].expand(w, p, n)
    want = tds.bitonic_network_plain([key] + [src[:, i] for i in range(p)])
    gk, gp = _by_position(key, planes, per_window)
    assert torch.equal(gk, want[0])
    assert torch.equal(gp, torch.stack(want[1:], 1))
    assert torch.equal(gp, tds.sort_rows_by_key(key, planes, per_window)[1])
