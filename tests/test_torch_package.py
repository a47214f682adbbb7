"""Rules of the port package, and its kernels against their plain versions.

The kernel cases need a CUDA card and skip without one; run them on the
card with ``python -m pytest --noconftest tests/test_torch_package.py``
(``tests/conftest.py`` imports JAX, which the card's machine need not have).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from zkdcap_tpu_torch import interop
from zkdcap_tpu_torch.commit import gen_srs
from zkdcap_tpu_torch.curves import BN254_G1
from zkdcap_tpu_torch.curves import ec_kernels as ek
from zkdcap_tpu_torch.curves.device_g1 import (
    G1_SPEC, affine_to_projective, decode_points, ec_inf, encode_points)
from zkdcap_tpu_torch.fields import BN254_FR, mont
from zkdcap_tpu_torch.commit import ParamsKZG
from zkdcap_tpu_torch.fields import BN254_FQ, mul_kernels
from zkdcap_tpu_torch.fields.ntt_kernels import ntt_pass, ntt_pass_plain
from zkdcap_tpu_torch.fields.params import R, int_to_limbs
from zkdcap_tpu_torch.ntt.ntt import _pass_twiddles
from zkdcap_tpu_torch.plonk import cs as tcs
from zkdcap_tpu_torch.plonk.keygen import keygen
from zkdcap_tpu_torch.plonk.prover import create_proof
from zkdcap_tpu_torch.testdata.circuits import toy_circuit
from zkdcap_tpu_torch.transcript import TranscriptWriter

ROOT = Path(__file__).resolve().parent.parent


def test_import_pulls_in_no_jax():
    code = (
        "import sys\n"
        "import zkdcap_tpu_torch, zkdcap_tpu_torch.commit, zkdcap_tpu_torch.interop\n"
        "import zkdcap_tpu_torch.msm, zkdcap_tpu_torch.ntt, zkdcap_tpu_torch._build\n"
        "import zkdcap_tpu_torch.fields.mul_kernels, zkdcap_tpu_torch.poly\n"
        "import zkdcap_tpu_torch.commit.shplonk, zkdcap_tpu_torch.curves.pairing\n"
        "import zkdcap_tpu_torch.transcript, zkdcap_tpu_torch.transcript.keccak\n"
        "import zkdcap_tpu_torch.transcript.poseidon, zkdcap_tpu_torch.plonk.cs\n"
        "import zkdcap_tpu_torch.plonk.expression, zkdcap_tpu_torch.plonk.keygen\n"
        "import zkdcap_tpu_torch.plonk.prover, zkdcap_tpu_torch.plonk.verifier\n"
        "import zkdcap_tpu_torch.testdata.circuits, zkdcap_tpu_torch.utils.device_sort\n"
        "import zkdcap_tpu_torch.chips, zkdcap_tpu_torch.chips.bigint, zkdcap_tpu_torch.chips.ecc\n"
        "import zkdcap_tpu_torch.chips.ecdsa, zkdcap_tpu_torch.chips.range\n"
        "import zkdcap_tpu_torch.circuits.p256_ecdsa, zkdcap_tpu_torch.metrics\n"
        "import zkdcap_tpu_torch.witness.tape, zkdcap_tpu_torch.witness.native\n"
        "import zkdcap_tpu_torch.witness.replay, zkdcap_tpu_torch.runtime.prover\n"
        "import zkdcap_tpu_torch.fields.butterfly_kernels, zkdcap_tpu_torch.chips.sha256\n"
        "import zkdcap_tpu_torch.chips.base64, zkdcap_tpu_torch.chips.builder\n"
        "import zkdcap_tpu_torch.plonk.mock, zkdcap_tpu_torch.circuits.dcap\n"
        "import zkdcap_tpu_torch.runtime.circuit_prover, zkdcap_tpu_torch.runtime.dcap_prover\n"
        "import zkdcap_tpu_torch.tools.kernel_variants, zkdcap_tpu_torch.tools.kernel_ab\n"
        "import zkdcap_tpu_torch.tools.proof_ab, zkdcap_tpu_torch.commit.gwc\n"
        "import zkdcap_tpu_torch.plonk.checkpoint, zkdcap_tpu_torch.circuits.cert_chain\n"
        "import zkdcap_tpu_torch.circuits.quote, zkdcap_tpu_torch.runtime.chain_provers\n"
        "import zkdcap_tpu_torch.evm, zkdcap_tpu_torch.evm.calldata\n"
        "import zkdcap_tpu_torch.evm.interp, zkdcap_tpu_torch.evm.solc\n"
        "import zkdcap_tpu_torch.evm.solidity, zkdcap_tpu_torch.config, zkdcap_tpu_torch.cli\n"
        "import zkdcap_tpu_torch.parallel, zkdcap_tpu_torch.parallel.dryrun\n"
        "import zkdcap_tpu_torch.plonk.row_sharder\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'zkdcap_tpu' or m.startswith('zkdcap_tpu.')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_entry_points_refuse_to_fall_back_to_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: entry points run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gen_srs(2, cache_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mont.encode_ints(BN254_FR, [1, 2])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.to_torch(np.zeros((1, 16), np.uint32))
    # the prover's entry points: keygen and create_proof on the toy circuit
    circ = toy_circuit(tcs)
    params = ParamsKZG(srs=gen_srs(circ.k, cache_dir=str(tmp_path), device="cpu"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        keygen(params, circ.cs, circ.fixed_values)
    pk = keygen(params, circ.cs, circ.fixed_values, device="cpu")
    advice = [mont.encode_ints(BN254_FR, col, device="cpu") for col in circ.advice_values]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_proof(params, pk, advice, circ.instances, TranscriptWriter(), blinding_seed=b"s")
    # the prover services: keygen needs the card unless device="cpu"
    from zkdcap_tpu_torch.plonk.mock import MockProver
    from zkdcap_tpu_torch.runtime import CertChainProver, DcapProver, ECDSAProver, QuoteProver

    with pytest.raises(RuntimeError, match="no CUDA device"):
        ECDSAProver(params_dir=str(tmp_path / "params"), k=18).keygen()
    for cls in (DcapProver, CertChainProver, QuoteProver):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(params_dir=str(tmp_path / cls.NAME), k=17).keygen()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MockProver(circ.k, circ.cs, circ.fixed_values, circ.advice_values, circ.instances)


def test_interop_round_trip_keeps_bit_patterns():
    a = np.array([[0, 1, 0xFFFF, 0x80000000, 0xFFFFFFFF]], dtype=np.uint32)
    t = interop.to_torch(a, device="cpu")
    assert t.dtype == torch.int32 and np.array_equal(interop.to_numpy(t), a)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rand_fr(n, seed, dev):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % BN254_FR.p for _ in range(n)]
    return mont.encode_ints(BN254_FR, vals, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("log_s", [1, 5, 9, 11])
def test_kernel_a_matches_plain(cuda, log_s):
    rows = 4
    x = _rand_fr(rows << log_s, log_s, cuda).reshape(rows, 1 << log_s, 16)
    ptw = _rand_fr(rows << log_s, 99, cuda)
    for inverse in (False, True):
        tw = _pass_twiddles(log_s, inverse, cuda)
        for post in (None, ptw):
            got = ntt_pass(x, tw, post)
            ref = ntt_pass_plain(x, tw, post)
            assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("log_s", [1, 3, 4, 8, 9, 10, 11])
def test_kernel_a_strided_views_match_plain(cuda, log_s):
    """Kernel A reads columns and writes a transposed view (the four-step
    layouts), batched with separate batch and row strides, exactly as its
    plain version; edge values 0, 1, p - 1 and R included."""
    size, rows, nb = 1 << log_s, 40, 2
    x = _rand_fr(nb * rows * size, 7 + log_s, cuda).view(nb, size, rows, 16)
    # limb patterns 0, 1, p - 1 and R mod p (the Montgomery one) fill columns
    # 0-3; element 0 of every other column is p - 1
    edges = np.stack([int_to_limbs(v) for v in (0, 1, BN254_FR.p - 1, R % BN254_FR.p)])
    edges = torch.from_numpy(edges.astype(np.int32))
    x[:, :, :4] = edges.to(cuda)
    x[:, 0, 4:] = edges[2].to(cuda)
    cols = x.transpose(1, 2)
    ptw = _rand_fr(rows * size, 98, cuda)
    for inverse in (False, True):
        tw = _pass_twiddles(log_s, inverse, cuda)
        for post in (None, ptw):
            ref = ntt_pass_plain(cols, tw, post)
            assert torch.equal(ntt_pass(cols, tw, post), ref)
            out = torch.full((nb, size, rows, 16), -1, dtype=torch.int32, device=cuda)
            ntt_pass(cols, tw, post, out=out.transpose(1, 2))
            assert torch.equal(out.transpose(1, 2), ref)
            assert torch.equal(ntt_pass(cols[1], tw, post), ntt_pass_plain(cols[1], tw, post))


@pytest.mark.cuda
@pytest.mark.parametrize("log_rows", [1, 2, 5])
def test_kernel_a_rev_rows_matches_plain(cuda, log_rows):
    """The flat NTT's read: rows bit-reversed, columns of the array."""
    rows, nb = 1 << log_rows, 3
    x = _rand_fr(nb * rows << 11, 50 + log_rows, cuda).view(nb, 1 << 11, rows, 16).transpose(1, 2)
    for inverse in (False, True):
        tw = _pass_twiddles(11, inverse, cuda)
        assert torch.equal(ntt_pass(x, tw, rev_rows=True), ntt_pass_plain(x, tw, rev_rows=True))


@pytest.mark.cuda
def test_kernel_a_rejects_views_on_the_card(cuda):
    tw = _pass_twiddles(3, False, cuda)
    x = _rand_fr(16, 3, cuda).view(2, 8, 16)
    with pytest.raises(ValueError):
        ntt_pass(x, tw, out=x)
    with pytest.raises(ValueError):
        ntt_pass(torch.zeros(2, 16, 8, dtype=torch.int32, device=cuda).transpose(1, 2), tw)


def _points(n, dev):
    pts, cur = [], BN254_G1.g
    for _ in range(n):
        pts.append(cur)
        cur = BN254_G1.add(cur, BN254_G1.mul(3, cur))
    return encode_points(G1_SPEC, pts, device=dev)


@pytest.mark.cuda
def test_kernels_b_c_d_match_plain(cuda):
    n = 256
    P = affine_to_projective(G1_SPEC, _points(n, cuda))
    Q = tuple(c.roll(7, 0).contiguous() for c in P)
    mask = (torch.arange(n, device=cuda) % 3 != 0).to(torch.int32)
    for fb in ("p", "q"):
        got = ek.ec_add_select(G1_SPEC, P, Q, mask, fb)
        ref = ek.ec_add_select_plain(G1_SPEC, P, Q, mask, fb)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    M, B = 4, 128
    rows = ek.pack_affine_rows(_points(M * B, cuda)).reshape(M, B, 16).transpose(1, 2).contiguous()
    gen = torch.Generator().manual_seed(3)
    masks = torch.randint(0, 2, (M, 3, B), generator=gen, dtype=torch.int32).to(cuda)
    got = ek.ec_madd_scan_full(G1_SPEC, rows, masks)
    ref = ek.ec_madd_scan_plain(G1_SPEC, rows, masks)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    # kernel D: the proofs' shape (W = 20, c = 13), the 2^20 MSM's (16, 16),
    # one window, and windows at infinity (the top one, inner ones, all)
    inf = ec_inf(G1_SPEC, (), cuda)
    for W, c, at_inf in ((5, 7, ()), (20, 13, ()), (16, 16, ()), (1, 13, ()), (1, 13, (0,)),
                         (20, 13, (19, 4, 5)), (6, 9, tuple(range(6)))):
        T = tuple(c_[:W].clone() for c_ in P)
        for w in at_inf:
            for t, i in zip(T, inf):
                t[w] = i
        got = ek.ec_window_join(G1_SPEC, T, c)
        ref = ek.ec_window_join_plain(G1_SPEC, T, c)
        assert all(torch.equal(a, b) for a, b in zip(got, ref)), (W, c, at_inf)


@pytest.mark.cuda
@pytest.mark.parametrize("field", [BN254_FR, BN254_FQ], ids=["fr", "fq"])
def test_kernel_e_matches_plain(cuda, field):
    """Kernel E against its plain version: b in full, as one broadcast row,
    as rows each repeated over a run, and rows cycling."""
    a = _rand_fr(3 * 1000, 5, cuda).reshape(1000, 3, 16)
    b = _rand_fr(3 * 1000, 6, cuda).reshape(1000, 3, 16)
    for bb in (b, b[7, 1], b[:, :1], b[:1]):
        assert torch.equal(mul_kernels.mont_mul(field, a, bb),
                           mul_kernels.mont_mul_plain(field, a, bb))
        assert torch.equal(mul_kernels.mont_mul(field, bb, a), mul_kernels.mont_mul(field, a, bb))


@pytest.mark.cuda
def test_engine_on_card_matches_cpu(cuda):
    """NTT at every size up to 2^13 (one pass and four-step splits) and the
    MSM (ladder and Pippenger) agree between the card and the plain CPU path."""
    from zkdcap_tpu_torch.msm import msm_device, msm_host
    from zkdcap_tpu_torch.ntt import intt, ntt

    cpu = torch.device("cpu")
    for log_n in range(1, 14):
        x = _rand_fr(1 << log_n, 100 + log_n, cuda)
        assert torch.equal(ntt(BN254_FR, x).cpu(), ntt(BN254_FR, x.cpu()))
        assert torch.equal(intt(BN254_FR, x).cpu(), intt(BN254_FR, x.cpu()))
    for n, lanes, c in ((16, 0, 0), (1024, 256, 8)):
        pts = _points(n, cuda)
        rng = np.random.default_rng(n)
        vals = [int.from_bytes(rng.bytes(32), "little") % BN254_G1.n for _ in range(n)]
        if lanes:
            std = mont.encode_ints(BN254_FR, vals, to_montgomery=False, device=cuda)
            got = msm_device(G1_SPEC, pts, std, lanes, c)
            ref = msm_device(G1_SPEC, pts.to(cpu), std.to(cpu), lanes, c)
            assert (decode_points(G1_SPEC, tuple(r[None] for r in got))
                    == decode_points(G1_SPEC, tuple(r[None] for r in ref)))
        else:
            sc = mont.encode_ints(BN254_FR, vals, device=cuda)
            assert msm_host(pts, sc) == msm_host(pts.to(cpu), sc.to(cpu))


@pytest.mark.cuda
@pytest.mark.parametrize("log_n, batch", [(1, 3), (10, 3), (12, 3), (14, 3), (16, 3), (18, 3),
                                          (20, 1), (21, 3)])
def test_kernel_f_matches_plain(cuda, log_n, batch):
    """Kernel F against its plain version: 1 and 2 operands, keys at and
    above 2^31, ties; the row sort with 8 planes, shared and per window, over
    two segments. The sizes run every launch of its schedule: the tile alone
    (up to 2^14), one strided group per stage above the tile (2^16, 2^18,
    2^21), and two groups per stage (2^20 in one batch: a 2^11 tile)."""
    from zkdcap_tpu_torch.utils import device_sort as ds

    gen = torch.Generator().manual_seed(log_n)
    n = 1 << log_n
    key = torch.randint(-(1 << 31), 1 << 31, (batch, n), generator=gen, dtype=torch.int64)
    key[-1] = key[-1] % 5  # ties
    key = key.to(torch.int32).to(cuda)
    pay = torch.arange(batch * n, dtype=torch.int32, device=cuda).reshape(batch, n)
    for ops in ((key,), (key, pay)):
        got = ds.bitonic_sort(ops)
        ref = ds.bitonic_sort_plain(ops)
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
    if log_n < 10:
        return
    seg = max(n // 2, 1 << 10)
    for per_window in (False, True):
        planes = torch.randint(-(1 << 31), 1 << 31, (batch, 8, n) if per_window else (8, n),
                               generator=gen, dtype=torch.int64).to(torch.int32).to(cuda)
        old = ds.ROWS_SORT_SEG
        ds.ROWS_SORT_SEG = seg
        try:
            got = ds.sort_rows_by_key(key, planes, per_window)
            ref = ds.sort_rows_by_key_plain(key, planes, per_window)
        finally:
            ds.ROWS_SORT_SEG = old
        assert all(torch.equal(g, r) for g, r in zip(got, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("log_n", [1, 5, 12])
def test_kernel_g_matches_plain(cuda, log_n, monkeypatch):
    """Kernel G against its plain version at every stage of a transform,
    out of place and in place, forward and inverse tables; then the flat
    NTT (kernel A's chunk pass and kernel G's stages) on the card against
    the CPU path under ZKDCAP_NO_FOUR_STEP=1."""
    from zkdcap_tpu_torch.fields.butterfly_kernels import butterfly, butterfly_plain
    from zkdcap_tpu_torch.ntt import intt_many, ntt_many
    from zkdcap_tpu_torch.ntt.ntt import _flat_twiddles

    rows, n = 3, 1 << log_n
    x = _rand_fr(rows * n, 7 * log_n, cuda).reshape(rows, n, 16)
    for inverse in (False, True):
        tw = _flat_twiddles(log_n, inverse, cuda)
        for s in range(log_n):
            stride = n >> (s + 1)
            ref = butterfly_plain(x, tw, s, stride)
            assert torch.equal(butterfly(x, tw, s, stride), ref)
            y = x.clone()
            assert butterfly(y, tw, s, stride, out=y) is y and torch.equal(y, ref)
    if log_n < 12:
        return
    monkeypatch.setenv("ZKDCAP_NO_FOUR_STEP", "1")
    polys = list(x.unbind(0))
    for fn in (ntt_many, intt_many):
        got = fn(BN254_FR, polys)
        ref = fn(BN254_FR, [p.cpu() for p in polys])
        assert all(torch.equal(g.cpu(), r) for g, r in zip(got, ref))
