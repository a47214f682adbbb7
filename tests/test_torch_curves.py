"""Port vs reference: G1 formulas and the plain versions of kernels B, C, D.

Points are compared as decoded affine points (the projective representative
of a point is not unique); field arrays that are canonical on both sides
are compared bit for bit.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkdcap_tpu.curves import device_g1 as jg1
from zkdcap_tpu.curves import ec_kernels as jek
from zkdcap_tpu.fields import mont as jmont
from zkdcap_tpu_torch import interop
from zkdcap_tpu_torch.curves import BN254_G1
from zkdcap_tpu_torch.curves import device_g1 as tg1
from zkdcap_tpu_torch.curves import ec_kernels as tek

SPEC_J, SPEC_T = jg1.G1_SPEC, tg1.G1_SPEC
RNG = np.random.default_rng(5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pts(n: int):
    """n distinct points k*G with seeded k, by host arithmetic."""
    ks = [int(k) for k in RNG.integers(1, 1 << 62, n)]
    return [BN254_G1.mul(k, BN254_G1.g) for k in ks]


def _enc(pts) -> np.ndarray:
    return np.asarray(jg1.encode_points(SPEC_J, pts))


def _t(x):
    return interop.to_torch(np.asarray(x), device="cpu")


def _tp(P):
    return tuple(_t(c) for c in P)


def _jp(P):
    return tuple(jnp.asarray(interop.to_numpy(c)) for c in P)


def test_encode_and_affine_to_projective_match_reference():
    pts = _pts(5) + [None]
    enc = _enc(pts)
    assert np.array_equal(interop.to_numpy(tg1.encode_points(SPEC_T, pts, device="cpu")), enc)
    J = jg1.affine_to_projective(SPEC_J, jnp.asarray(enc))
    T = tg1.affine_to_projective(SPEC_T, _t(enc))
    assert all(np.array_equal(interop.to_numpy(t), np.asarray(j)) for t, j in zip(T, J))
    assert tg1.decode_points(SPEC_T, T) == pts


def test_add_double_neg_select_match_reference():
    ps = _pts(6)
    qs = _pts(3) + [ps[3], BN254_G1.neg_pt(ps[4]), None]  # P+Q, P+P, P+(-P), P+inf
    ps = ps[:5] + [None]  # and inf + inf
    qs[5] = None
    ps.append(None)
    qs.append(ps[0])  # inf + P
    P = jg1.affine_to_projective(SPEC_J, jnp.asarray(_enc(ps)))
    Q = jg1.affine_to_projective(SPEC_J, jnp.asarray(_enc(qs)))
    tP, tQ = _tp(P), _tp(Q)
    expect = [BN254_G1.add(a, b) for a, b in zip(ps, qs)]
    got = tg1.ec_add(SPEC_T, tP, tQ)
    assert tg1.decode_points(SPEC_T, got) == expect
    assert tg1.decode_points(SPEC_T, got) == jg1.decode_points(SPEC_J, jg1.ec_add(SPEC_J, P, Q))
    dbl = tg1.ec_double(SPEC_T, tP)
    assert tg1.decode_points(SPEC_T, dbl) == [BN254_G1.add(a, a) for a in ps]
    assert tg1.decode_points(SPEC_T, dbl) == jg1.decode_points(SPEC_J, jg1.ec_double(SPEC_J, P))
    neg = tg1.ec_neg(SPEC_T, tP)
    assert all(np.array_equal(interop.to_numpy(t), np.asarray(j))
               for t, j in zip(neg, jg1.ec_neg(SPEC_J, P)))
    cond = np.arange(len(ps)) % 2 == 0
    sel = tg1.ec_select(torch.as_tensor(cond), tP, tQ)
    ref = jg1.ec_select(jnp.asarray(cond), P, Q)
    assert all(np.array_equal(interop.to_numpy(t), np.asarray(j)) for t, j in zip(sel, ref))
    inf = tg1.ec_inf(SPEC_T, (2,), device="cpu")
    assert tg1.decode_points(SPEC_T, inf) == [None, None]
    assert bool(tg1.ec_is_inf(inf).all())


@pytest.mark.parametrize("fallback", ["p", "q"])
def test_kernel_c_plain_matches_reference(fallback):
    n = 8
    ps = _pts(n - 2) + [None, None]
    qs = _pts(n - 3) + [ps[0], None, ps[1]]
    P = jg1.affine_to_projective(SPEC_J, jnp.asarray(_enc(ps)))
    Q = jg1.affine_to_projective(SPEC_J, jnp.asarray(_enc(qs)))
    mask = (np.arange(n) % 3 != 1).astype(np.uint32)
    ref = jek.ec_add_select(SPEC_J, P, Q, jnp.asarray(mask), fallback)
    got = tek.ec_add_select(SPEC_T, _tp(P), _tp(Q), torch.as_tensor(mask.astype(np.int32)),
                            fallback)
    assert tg1.decode_points(SPEC_T, got) == jg1.decode_points(SPEC_J, ref)
    fb = qs if fallback == "q" else ps
    expect = [BN254_G1.add(a, b) if m else c for a, b, m, c in zip(ps, qs, mask, fb)]
    assert tg1.decode_points(SPEC_T, got) == expect


def test_pack_affine_rows_matches_reference():
    enc = _enc(_pts(4) + [None])
    ref = np.asarray(jek.pack_affine_rows(jnp.asarray(enc)))
    assert np.array_equal(interop.to_numpy(tek.pack_affine_rows(_t(enc))), ref)


def test_kernel_b_plain_matches_stepwise_reference():
    """M = 4 steps over B = 128 lanes: every (same, valid, negate) mask
    combination, encoded infinities on invalid rows, against a step-by-step
    composition of the reference's ec_add and ec_select with the kernel's
    select semantics."""
    M, B = 4, 128
    base = _pts(16)
    idx = RNG.integers(0, 16, (M, B))
    combos = np.array(list(itertools.product([0, 1], repeat=3)))  # same, valid, neg
    masks = np.stack([combos[(np.arange(B) + 3 * m) % 8] for m in range(M)]).transpose(0, 2, 1)
    masks[0, 0] = 0  # a lane's first step never continues a run
    rows = np.zeros((M, 16, B), np.uint32)
    pts = np.zeros((M, B, 2, 16), np.uint32)
    for m in range(M):
        step = [base[i] if masks[m, 1, b] or b % 5 else None for b, i in enumerate(idx[m])]
        pts[m] = _enc(step)
        rows[m] = np.asarray(jek.pack_affine_rows(jnp.asarray(pts[m]))).T
    got = tek.ec_madd_scan_full(SPEC_T, _t(rows), _t(masks.astype(np.int32)))

    one = jmont.one_mont(SPEC_J.field, (B,))
    inf = jg1.ec_inf(SPEC_J, (B,))
    acc = inf
    for m in range(M):
        same, valid, negate = (jnp.asarray(masks[m, i] > 0) for i in range(3))
        X2 = jnp.asarray(pts[m, :, 0])
        Y2 = jnp.asarray(pts[m, :, 1])
        Y2 = jnp.where(negate[:, None], jmont.neg(SPEC_J.field, Y2), Y2)
        Q = (X2, Y2, one)
        s = jg1.ec_add(SPEC_J, acc, Q)
        acc = jg1.ec_select(valid, jg1.ec_select(same, s, Q), jg1.ec_select(same, acc, inf))
        step = tuple(c[m].T.contiguous() for c in got)
        assert tg1.decode_points(SPEC_T, step) == jg1.decode_points(SPEC_J, acc), m


def test_kernel_d_plain_matches_host_oracle():
    W, c = 5, 6
    ts = _pts(W - 1) + [None]
    T = tg1.affine_to_projective(SPEC_T, tg1.encode_points(SPEC_T, ts, device="cpu"))
    got = tek.ec_window_join(SPEC_T, T, c)
    expect = BN254_G1.msm([1 << (c * w) for w in range(W)], ts)
    assert tg1.decode_points(SPEC_T, tuple(x[None] for x in got)) == [expect]
