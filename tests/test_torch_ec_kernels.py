"""Kernels B and C against their plain versions on the card, limb for limb.

Every case needs a CUDA card and skips without one; run them on the card
with ``python -m pytest --noconftest -q tests/test_torch_ec_kernels.py``
(``tests/conftest.py`` imports JAX, which the card's machine need not have).

Kernel C (``csrc/ec_add_select.cu``) has two designs, picked by the launch's
lane count; the sizes below sit on both sides of that threshold and cover a
ragged last block of either. Kernel B (``csrc/madd_scan.cu``) runs every
case of its scan at M = 1, 8 and 16 steps over lane counts that are not a
multiple of its block, below and above the lane count that one wave of its
blocks holds on an H100 (two register budgets). The CPU cases check that
the card cases' inputs are what they claim.
"""

import numpy as np
import pytest
import torch

from zkdcap_tpu_torch.curves import BN254_G1
from zkdcap_tpu_torch.curves import ec_kernels as ek
from zkdcap_tpu_torch.curves.device_g1 import (
    G1_SPEC, affine_to_projective, ec_inf, ec_neg, encode_points)
from zkdcap_tpu_torch.fields import BN254_FQ, mont

P_MOD = BN254_FQ.p
# the grouped design serves launches of at most this many lanes
# (kGroupMaxLanes in csrc/ec_add_select.cu)
GROUP_MAX_LANES = 32768


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _pool(n, seed, dev):
    """n affine points k*G, seeded k."""
    rng = np.random.default_rng(seed)
    pts = [BN254_G1.mul(int(k), BN254_G1.g) for k in rng.integers(1, 1 << 62, n)]
    return encode_points(G1_SPEC, pts, device=dev)


def _stored(values, dev):
    """Integers as stored Fq limbs (no conversion to Montgomery form)."""
    return mont.encode_ints(BN254_FQ, values, to_montgomery=False, device=dev)


def _scaled_to_p_minus_1(P, dev):
    """The same points with every Z scaled to the stored value p - 1 (X and
    Y scaled with it: another representative of each point)."""
    z = mont.decode_ints(BN254_FQ, P[2], from_montgomery=False)
    lam = [(P_MOD - 1) * pow(v, -1, P_MOD) % P_MOD for v in z]
    out = []
    for c in P:
        vals = mont.decode_ints(BN254_FQ, c, from_montgomery=False)
        out.append(_stored([v * s % P_MOD for v, s in zip(vals, lam)], dev))
    return tuple(out)


def _operands(n, dev):
    """P, Q of n lanes cycling through the edge cases: random points,
    P = Q, P = -Q, P or Q or both the identity, Z = p - 1 in either operand
    and every coordinate p - 1 (not a point; the formulas still agree)."""
    pool = affine_to_projective(G1_SPEC, _pool(64, n, dev))
    rng = np.random.default_rng(n + 1)
    ip, iq = (torch.as_tensor(rng.integers(0, 64, n), device=dev) for _ in range(2))
    P = tuple(c[ip] for c in pool)
    Q = tuple(c[iq] for c in pool)
    inf = ec_inf(G1_SPEC, (n,), dev)
    negP = ec_neg(G1_SPEC, P)
    scaled = _scaled_to_p_minus_1(P, dev)
    top = _stored([P_MOD - 1] * n, dev)
    case = torch.arange(n, device=dev) % 9
    for k, (src_p, src_q) in enumerate(((None, P), (None, negP), (inf, None), (None, inf),
                                       (inf, inf), (scaled, None), (None, scaled),
                                       ((top, top, top), None)), start=1):
        sel = (case == k)[:, None]
        if src_p is not None:
            P = tuple(torch.where(sel, s, c) for s, c in zip(src_p, P))
        if src_q is not None:
            Q = tuple(torch.where(sel, s, c) for s, c in zip(src_q, Q))
    return tuple(c.contiguous() for c in P), tuple(c.contiguous() for c in Q)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 1280, GROUP_MAX_LANES, GROUP_MAX_LANES + 1, 102401])
def test_kernel_c_matches_plain(cuda, n):
    P, Q = _operands(n, cuda)
    gen = torch.Generator().manual_seed(n)
    masks = {"none": torch.zeros(n, dtype=torch.int32),
             "all": torch.ones(n, dtype=torch.int32),
             "alternating": (torch.arange(n) % 2).to(torch.int32),
             "random": torch.randint(0, 2, (n,), generator=gen, dtype=torch.int32)}
    for label, mask in masks.items():
        mask = mask.to(cuda)
        for fb in ("p", "q"):
            got = ek.ec_add_select(G1_SPEC, P, Q, mask, fb)
            ref = ek.ec_add_select_plain(G1_SPEC, P, Q, mask, fb)
            assert all(torch.equal(a, b) for a, b in zip(got, ref)), (n, label, fb)


def _scan_inputs(M, B, dev):
    """Packed rows and masks of M steps over B lanes: random masks, lanes
    whose runs all start at step 0 and never continue, all-invalid lanes,
    lanes that negate every Y, and encoded infinities on invalid rows."""
    pts = _pool(M * B if M * B <= 256 else 256, M * 31 + B, dev)
    gen = torch.Generator().manual_seed(M * 1000 + B)
    idx = torch.randint(0, pts.shape[0], (M * B,), generator=gen).to(dev)
    rows = ek.pack_affine_rows(pts)[idx].reshape(M, B, 16)
    masks = torch.randint(0, 2, (M, 3, B), generator=gen, dtype=torch.int32)
    lane = torch.arange(B)
    masks[:, 0, lane % 7 == 1] = 0  # every step starts a run
    masks[:, 1, lane % 7 == 2] = 0  # never valid
    masks[:, 2, lane % 7 == 3] = 1  # always negated
    masks[:, :2, lane % 7 == 4] = 1  # one run over all steps
    masks[0, 0] = 0  # a lane's first step never continues a run
    masks = masks.to(dev)
    rows = torch.where((masks[:, 1] == 0)[..., None], 0, rows)  # infinities on invalid rows
    return rows.transpose(1, 2).contiguous(), masks.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("M, B, first_adds", [
    (1, 129, False), (8, 1000, False), (16, 333, False), (8, 81920 + 5, False),
    (2, 100003, False), (1, 1 << 20, True), (2, 1000, True)])
def test_kernel_b_matches_plain(cuda, M, B, first_adds):
    """first_adds: every lane's first step continues a run, so it adds onto
    the identity (the TPU's single-step kernel's work at M = 1)."""
    rows, masks = _scan_inputs(M, B, cuda)
    if first_adds:
        masks[0, :2] = 1
    got = ek.ec_madd_scan_full(G1_SPEC, rows, masks)
    ref = ek.ec_madd_scan_plain(G1_SPEC, rows, masks)
    assert all(torch.equal(a, b) for a, b in zip(got, ref)), (M, B)


def test_edge_operands_hold_their_cases():
    """On the CPU: the card cases' operands are what they claim (plain
    version, decoded against host arithmetic)."""
    from zkdcap_tpu_torch.curves.device_g1 import decode_points

    cpu = torch.device("cpu")
    n = 18
    P, Q = _operands(n, cpu)
    ps, qs = decode_points(G1_SPEC, P), decode_points(G1_SPEC, Q)
    assert ps[1] == qs[1] and qs[2] == BN254_G1.neg_pt(ps[2])
    assert ps[3] is None and qs[4] is None and ps[5] is None and qs[5] is None
    assert int(P[2][6].to(torch.int64)[0]) == (P_MOD - 1) & 0xFFFF
    assert mont.decode_ints(BN254_FQ, Q[2][7:8], from_montgomery=False) == [P_MOD - 1]
    assert mont.decode_ints(BN254_FQ, P[0][8:9], from_montgomery=False) == [P_MOD - 1]
    R = ek.ec_add_select_plain(G1_SPEC, P, Q, torch.ones(n, dtype=torch.int32), "p")
    sums = decode_points(G1_SPEC, R)
    for i in range(n):
        if i % 9 != 8:  # lane 8 of each 9 is not a point
            assert sums[i] == BN254_G1.add(ps[i], qs[i]), i


def test_scan_inputs_hold_their_cases():
    """On the CPU: the scan cases' masks and rows are what they claim."""
    rows, masks = _scan_inputs(8, 21, torch.device("cpu"))
    lane = torch.arange(21)
    assert not masks[:, 0, lane % 7 == 1].any() and not masks[:, 1, lane % 7 == 2].any()
    assert masks[:, 2, lane % 7 == 3].all() and masks[1:, :2, lane % 7 == 4].all()
    assert not masks[0, 0].any()
    assert not rows.transpose(1, 2)[masks[:, 1] == 0].any()


def test_ptxas_report_reads_registers_and_spills():
    from zkdcap_tpu_torch import _build

    log = ("ptxas info    : 0 bytes gmem\n"
           "ptxas info    : Compiling entry function '_Z9kernel_aPi' for 'sm_90a'\n"
           "ptxas info    : Function properties for _Z9kernel_aPi\n"
           "    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads\n"
           "ptxas info    : Used 96 registers, used 1 barriers, 1056 bytes smem\n"
           "ptxas info    : Compiling entry function '_Z9kernel_bPi' for 'sm_90a'\n"
           "ptxas info    : Function properties for _Z9kernel_bPi\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 124 registers, used 0 barriers\n")
    assert _build.ptxas_report(log) == {
        "_Z9kernel_aPi": {"stack": 8, "spill_stores": 4, "spill_loads": 12, "registers": 96},
        "_Z9kernel_bPi": {"stack": 0, "spill_stores": 0, "spill_loads": 0, "registers": 124}}
