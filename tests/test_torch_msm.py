"""Port vs reference: MSM (ladder and Pippenger paths), compared as points.

The Pippenger cases call the port's ``msm_device`` directly on the CPU (the
plain versions of kernels B, C and D) and hold it against the host oracle
``BN254_G1.msm`` of the JAX package; the points are P0 + i*D with known
discrete logs, so the oracle is one scalar multiplication. The JAX
``msm_device`` is not compiled here (minutes of XLA:CPU per shape).
Sort ties differ between the packages, so only final points are compared.
"""

import functools

import numpy as np
import pytest
import torch

from zkdcap_tpu.curves import BN254_G1 as J_G1
from zkdcap_tpu.curves.device_g1 import G1_SPEC as J_SPEC
from zkdcap_tpu.curves.device_g1 import encode_points as j_encode_points
from zkdcap_tpu.fields import BN254_FR as J_FR
from zkdcap_tpu.fields import mont as jmont
from zkdcap_tpu.msm.pippenger import msm_host as j_msm_host
from zkdcap_tpu.msm.pippenger import msm_many_host as j_msm_many_host
from zkdcap_tpu_torch import interop
from zkdcap_tpu_torch.curves.device_g1 import G1_SPEC, decode_points
from zkdcap_tpu_torch.fields import BN254_FR, mont
from zkdcap_tpu_torch.msm import msm_device, msm_host, msm_many_host
from zkdcap_tpu_torch.msm.pippenger import _hs_levels

R = J_G1.n
RNG = np.random.default_rng(17)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _points(n: int, k0: int = 0x1234567, d: int = 0x9876543):
    """Points P_i = (k0 + i*d) G and their discrete logs."""
    step = J_G1.mul(d, J_G1.g)
    pts, logs, cur = [], [], J_G1.mul(k0, J_G1.g)
    for i in range(n):
        pts.append(cur)
        logs.append((k0 + i * d) % R)
        cur = J_G1.add(cur, step)
    return pts, logs


def _rand_scalars(n: int) -> list[int]:
    return [int.from_bytes(RNG.bytes(32), "little") % R for _ in range(n)]


def _device_msm(pts, scalars, lanes: int, c: int):
    dpts = interop.to_torch(np.asarray(j_encode_points(J_SPEC, pts)), device="cpu")
    std = mont.encode_ints(BN254_FR, scalars, to_montgomery=False, device="cpu")
    out = msm_device(G1_SPEC, dpts, std, lanes, c)
    return decode_points(G1_SPEC, tuple(r[None] for r in out))[0]


def _oracle(scalars, logs, pts):
    s = sum(a * b for a, b, p in zip(scalars, logs, pts) if p is not None) % R
    return J_G1.mul(s, J_G1.g)


def test_ladder_msm_host_matches_reference():
    pts, _ = _points(16)
    pts[3] = None  # encoded infinity
    scalars = _rand_scalars(16)
    scalars[0], scalars[1] = 0, R - 1
    jp = j_encode_points(J_SPEC, pts)
    js = jmont.encode_ints(J_FR, scalars)
    got = msm_host(interop.to_torch(np.asarray(jp), "cpu"), interop.to_torch(np.asarray(js), "cpu"))
    assert got == j_msm_host(jp, js) == J_G1.msm(scalars, pts)


def test_ladder_msm_many_host_matches_reference():
    pts, _ = _points(16)
    cols = [_rand_scalars(16), [7] * 16, [0] * 16]
    jp = j_encode_points(J_SPEC, pts)
    js = [jmont.encode_ints(J_FR, s) for s in cols]
    got = msm_many_host(interop.to_torch(np.asarray(jp), "cpu"),
                        [interop.to_torch(np.asarray(s), "cpu") for s in js])
    assert got == j_msm_many_host(jp, js)
    assert got == [J_G1.msm(s, pts) for s in cols]


def test_pippenger_edge_scalars_and_infinity():
    n = 1024
    pts, logs = _points(n)
    scalars = _rand_scalars(n)
    scalars[0] = 0
    pts[1] = None
    scalars[2] = R - 1
    scalars[3] = 1
    assert _device_msm(pts, scalars, 256, 8) == _oracle(scalars, logs, pts)


def test_pippenger_repeated_digits():
    n = 1024
    pts, logs = _points(n, 1, 1)
    scalars = [0x0101] * (n // 2) + [int(v) for v in RNG.integers(1, 1 << 16, n // 2)]
    assert _device_msm(pts, scalars, 256, 8) == _oracle(scalars, logs, pts)


def test_pippenger_all_equal_scalars():
    """One run spans every lane in each window: the Hillis-Steele scan must
    take its full static level count."""
    n = 1024
    pts, logs = _points(n)
    scalars = [0x1F2E3D4C5B6A79881726354453627180] * n
    assert _device_msm(pts, scalars, 256, 8) == _oracle(scalars, logs, pts)


def test_hs_level_count_is_data_dependent():
    lanes, K = 256, 384
    one_run = torch.zeros(2, K, dtype=torch.int64)
    one_run[:, :lanes] = 5  # a digit with a partial in every lane
    assert _hs_levels(one_run, lanes) == 8  # == the static bound
    pairs = torch.arange(K).repeat(2, 1) // 2 + 1  # runs of two
    assert _hs_levels(pairs, lanes) == 1
    assert _hs_levels(torch.zeros(1, K, dtype=torch.int64), lanes) == 0


def test_pippenger_uneven_window_groups():
    """c = 10: 26 windows, merged two at a time into the scan (the default
    widths 13 and 16 run on the card, where their 2^12- and 2^15-bucket
    tables are cheap)."""
    n = 1024
    pts, logs = _points(n, 77, 13)
    scalars = _rand_scalars(n)
    assert _device_msm(pts, scalars, 256, 10) == _oracle(scalars, logs, pts)


# --- the JAX package's sort switches (kernel F's plain version) -------------
#
# ZKDCAP_MSM_BITONIC=1 and ZKDCAP_MSM_ROWSORT=1 take effect on any device; on
# the CPU they run kernel F's plain version. monkeypatch keeps every switch
# inside its test.

SWITCHES = {
    "bitonic": {"ZKDCAP_MSM_BITONIC": "1"},
    "rowsort": {"ZKDCAP_MSM_ROWSORT": "1"},
    "both": {"ZKDCAP_MSM_BITONIC": "1", "ZKDCAP_MSM_ROWSORT": "1"},
}


def _switch(monkeypatch, name):
    for var in ("ZKDCAP_MSM_BITONIC", "ZKDCAP_MSM_ROWSORT"):
        monkeypatch.delenv(var, raising=False)
    if name != "default":
        for var, val in SWITCHES[name].items():
            monkeypatch.setenv(var, val)


@functools.cache
def _edge_case(n):
    """Zero and extreme scalars, infinities among the points, and the
    expected point, which the JAX package's host MSM confirms."""
    pts, logs = _points(n)
    rng = np.random.default_rng(n)
    scalars = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]
    scalars[0], scalars[2], scalars[3] = 0, R - 1, 1
    scalars[n // 2 : n // 2 + 76] = [5] * 76  # one bucket's run across the middle
    pts[1] = pts[700] = None
    want = _oracle(scalars, logs, pts)
    assert want == J_G1.msm(scalars, pts)
    return pts, scalars, want


@pytest.mark.parametrize("switch", sorted(SWITCHES))
def test_pippenger_switches_match_oracle(monkeypatch, switch):
    pts, scalars, want = _edge_case(1024)
    _switch(monkeypatch, switch)
    assert _device_msm(pts, scalars, 256, 8) == want


@pytest.mark.parametrize("switch", ["bitonic", "rowsort"])
def test_pippenger_switches_all_equal_scalars(monkeypatch, switch):
    n = 1024
    pts, logs = _points(n)
    scalars = [0x1F2E3D4C5B6A79881726354453627180] * n
    _switch(monkeypatch, switch)
    assert _device_msm(pts, scalars, 256, 8) == _oracle(scalars, logs, pts)


def test_pippenger_rowsort_two_segments(monkeypatch):
    """N > the row sort's segment: S = 2 segments per window, the tail per
    (window, segment) and the segment tables added at the end. The segment
    is set to 2^10 so that the CPU manages it (the card runs S = 4 at 2^20
    points with the real 2^18 segment)."""
    from zkdcap_tpu_torch.utils import device_sort

    from zkdcap_tpu_torch.msm.pippenger import _Sorts

    monkeypatch.setattr(device_sort, "ROWS_SORT_SEG", 1 << 10)
    pts, scalars, want = _edge_case(2048)
    _switch(monkeypatch, "rowsort")
    assert _Sorts(2048, 256).S == 2
    assert _device_msm(pts, scalars, 256, 8) == want


def _bucket_tables(pts, scalars, lanes, c):
    from zkdcap_tpu_torch.curves.ec_kernels import pack_affine_rows
    from zkdcap_tpu_torch.msm.pippenger import _group_buckets, _signed_digits, _Sorts

    dpts = interop.to_torch(np.asarray(j_encode_points(J_SPEC, pts)), device="cpu")
    std = mont.encode_ints(BN254_FR, scalars, to_montgomery=False, device="cpu")
    n = len(pts)
    digits = _signed_digits(std, c)[:3]
    T = _group_buckets(G1_SPEC, pack_affine_rows(dpts), digits, lanes, n // lanes,
                       1 << (c - 1), _Sorts(n, lanes))
    return decode_points(G1_SPEC, tuple(t.reshape(-1, 16) for t in T))


@pytest.mark.parametrize("switch", sorted(SWITCHES))
def test_pippenger_switches_bucket_tables(monkeypatch, switch):
    """Every bucket of three windows equals the default path's bucket (the
    row sort with S = 2 segments)."""
    from zkdcap_tpu_torch.utils import device_sort

    monkeypatch.setattr(device_sort, "ROWS_SORT_SEG", 1 << 10)
    pts, scalars, _ = _edge_case(2048)
    _switch(monkeypatch, "default")
    want = _bucket_tables(pts, scalars, 256, 8)
    _switch(monkeypatch, switch)
    assert _bucket_tables(pts, scalars, 256, 8) == want
