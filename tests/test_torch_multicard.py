"""The kernels and the sharded path on the card (marker ``cuda``).

Every case needs a CUDA card and skips without one; run them on the card
with ``python -m pytest --noconftest tests/test_torch_multicard.py``.

* Kernels A-G launched on ``cuda:1`` after ``cuda:0``, each equal to its
  plain version: a wrapper launches on its tensors' device and stream, and
  each kernel's one-time setup (the shared-memory opt-in of A, C and F, the
  SM counts and occupancy of A, B, C and F) is made per device. Needs two
  cards; skips on one.
* The sharded MSM and NTT over four virtual shards of one card equal the
  single-device results, and the toy proof over two shards equals the
  single-device proof.
* Over every card of the machine (two or more; skips on one): the sharded
  MSM and NTT and the flex proof in one process, and one NCCL process per
  card sharing a ``(cards, 1)`` mesh, equal to one device's results and
  to the fixture's bytes.
* The sharded 2^20 and 2^22 MSMs over every card equal the host curve's
  value, and their cards ran at the same time (a profiled call,
  ``tools/concurrency.py``): at 2^20 the concurrency ratio (the sum of the
  cards' busy time over the call's wall time) is above 1; at 2^22 two or
  more cards were busy at once for some of the call.
* A prover service on ``cuda:1`` proves with ``shards=2`` (its mesh puts
  ``cuda:1`` first): ``ECDSAProver`` gives the fixture's k = 18 bytes, and
  ``python -m zkdcap_tpu_torch.cli --device cuda:1 --shards 2 prove`` on its
  params dir exits 0 with a proof that verifies.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from zkdcap_tpu_torch.commit import ParamsKZG, gen_srs
from zkdcap_tpu_torch.curves import BN254_G1
from zkdcap_tpu_torch.curves import ec_kernels as ek
from zkdcap_tpu_torch.curves.device_g1 import (
    G1_SPEC, affine_to_projective, decode_points, encode_points)
from zkdcap_tpu_torch.fields import BN254_FR, mont, mul_kernels
from zkdcap_tpu_torch.fields.butterfly_kernels import butterfly, butterfly_plain
from zkdcap_tpu_torch.fields.ntt_kernels import ntt_pass, ntt_pass_plain
from zkdcap_tpu_torch.msm.pippenger import msm_host
from zkdcap_tpu_torch.ntt import ntt
from zkdcap_tpu_torch.ntt.ntt import _flat_twiddles, _pass_twiddles
from zkdcap_tpu_torch.parallel import gather_rows, proving_mesh, sharded_msm, sharded_ntt
from zkdcap_tpu_torch.plonk import cs as tcs
from zkdcap_tpu_torch.plonk.keygen import keygen
from zkdcap_tpu_torch.plonk.prover import create_proof
from zkdcap_tpu_torch.testdata.circuits import REFERENCE_CASES, padded_advice, toy_circuit
from zkdcap_tpu_torch.tools.concurrency import concurrency
from zkdcap_tpu_torch.transcript import TranscriptWriter
from zkdcap_tpu_torch.utils.device_sort import (
    bitonic_sort, bitonic_sort_plain, sort_rows_by_key, sort_rows_by_key_plain)


ROOT = Path(__file__).resolve().parent.parent
FIXTURE = json.loads((ROOT / "zkdcap_tpu_torch" / "testdata" / "reference_proofs.json")
                     .read_text())["flex"]

# one process of an NCCL group over the machine's cards: the sharded MSM and
# NTT at 2^12 and the flex proof over the group's (cards, 1) mesh
NCCL_RANK = r"""
import json, sys
sys.path.insert(0, %(root)r)
import torch
import torch.distributed as dist
from zkdcap_tpu_torch.commit import ParamsKZG, gen_srs
from zkdcap_tpu_torch.curves.device_g1 import G1_SPEC, decode_points
from zkdcap_tpu_torch.fields import BN254_FR, mont
from zkdcap_tpu_torch.msm import msm_host
from zkdcap_tpu_torch.ntt import ntt
from zkdcap_tpu_torch.parallel import (
    gather_rows, init_distributed, multihost_mesh, sharded_msm, sharded_ntt)
from zkdcap_tpu_torch.plonk import cs as tcs
from zkdcap_tpu_torch.plonk.keygen import keygen
from zkdcap_tpu_torch.plonk.prover import create_proof
from zkdcap_tpu_torch.testdata.circuits import REFERENCE_CASES, padded_advice
from zkdcap_tpu_torch.transcript import TranscriptWriter

assert init_distributed() is True
dev = torch.device("cuda", torch.cuda.current_device())
mesh = multihost_mesh()
srs_dir = %(srs)r + str(dist.get_rank())
srs = gen_srs(12, cache_dir=srs_dir, device=dev)
x = torch.randint(0, 1 << 16, (1 << 12, 16), generator=torch.Generator().manual_seed(5),
                  dtype=torch.int32)
x[:, 15] &= 0x2FFF
x = x.to(dev)
R = sharded_msm(mesh, srs.g1_powers, x)
out = {"rank": dist.get_rank(), "backend": dist.get_backend(), "device": str(dev),
       "shape": mesh.shape,
       "msm": decode_points(G1_SPEC, tuple(r.reshape(1, -1) for r in R))[0]
       == msm_host(srs.g1_powers, x),
       "ntt": torch.equal(gather_rows(mesh, sharded_ntt(mesh, x)), ntt(BN254_FR, x))}
circ = REFERENCE_CASES["flex"][0](tcs)
params = ParamsKZG(srs=gen_srs(circ.k, cache_dir=srs_dir, device=dev))
pk = keygen(params, circ.cs, circ.fixed_values, device=dev)
advice = [mont.encode_ints(BN254_FR, col, device=dev) for col in padded_advice(circ)]
out["proof"] = create_proof(params, pk, advice, circ.instances, TranscriptWriter("blake2b"),
                            blinding_seed=%(seed)r, mesh=mesh, device=dev).hex()
dist.destroy_process_group()
print("RESULT " + json.dumps(out), flush=True)
"""


def _rand_fr(n: int, seed: int, dev) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(0, 1 << 16, (n, 16), generator=g, dtype=torch.int32)
    x[:, 15] &= 0x2FFF
    return x.to(dev)


def _points(n: int, dev) -> torch.Tensor:
    pts, cur = [], BN254_G1.g
    for _ in range(64):
        pts.append(cur)
        cur = BN254_G1.add(cur, BN254_G1.mul(3, cur))
    return encode_points(G1_SPEC, pts, device=dev).repeat(-(-n // 64), 1, 1)[:n].contiguous()


def _kernels_match_plain(dev) -> None:
    # A: a 2^11 pass (the shared-memory opt-in) and a short one
    for log_s, rows in ((11, 64), (4, 1000)):
        x = _rand_fr(rows << log_s, log_s, dev).view(rows, 1 << log_s, 16)
        tw = _pass_twiddles(log_s, False, dev)
        assert torch.equal(ntt_pass(x, tw), ntt_pass_plain(x, tw))
    # B: a scan over one wave's lanes and more
    for M, B in ((2, 4096), (1, 200_000)):
        rows = ek.pack_affine_rows(_points(M * B, dev)).reshape(M, B, 16).transpose(1, 2)
        rows = rows.contiguous()
        masks = torch.randint(0, 2, (M, 3, B), generator=torch.Generator().manual_seed(3),
                              dtype=torch.int32).to(dev)
        got = ek.ec_madd_scan_full(G1_SPEC, rows, masks)
        assert all(torch.equal(a, b) for a, b in zip(got, ek.ec_madd_scan_plain(G1_SPEC, rows,
                                                                                  masks)))
    # C: the group kernel, and the tiled one above 32,768 lanes (its opt-in)
    for n in (1000, 40_000, 400_000):
        P = affine_to_projective(G1_SPEC, _points(n, dev))
        Q = tuple(c.roll(7, 0).contiguous() for c in P)
        mask = (torch.arange(n, device=dev) % 3 != 0).to(torch.int32)
        got = ek.ec_add_select(G1_SPEC, P, Q, mask, "p")
        assert all(torch.equal(a, b) for a, b in
                   zip(got, ek.ec_add_select_plain(G1_SPEC, P, Q, mask, "p")))
    # D
    T = tuple(c[:20].contiguous() for c in affine_to_projective(G1_SPEC, _points(20, dev)))
    assert all(torch.equal(a, b) for a, b in
               zip(ek.ec_window_join(G1_SPEC, T, 13), ek.ec_window_join_plain(G1_SPEC, T, 13)))
    # E
    a, b = _rand_fr(4096, 5, dev), _rand_fr(4096, 6, dev)
    assert torch.equal(mul_kernels.mont_mul(BN254_FR, a, b),
                       mul_kernels.mont_mul_plain(BN254_FR, a, b))
    # F: key + payload (its opt-in), and the row sort's 9 operands
    g = torch.Generator().manual_seed(9)
    key = torch.randint(0, 1 << 30, (5, 1 << 14), generator=g, dtype=torch.int32).to(dev)
    pay = torch.arange(5 << 14, dtype=torch.int32).view(5, 1 << 14).to(dev)
    assert all(torch.equal(x, y) for x, y in
               zip(bitonic_sort((key, pay)), bitonic_sort_plain((key, pay))))
    planes = torch.randint(0, 1 << 30, (8, 1 << 12), generator=g, dtype=torch.int32).to(dev)
    got = sort_rows_by_key(key[:, : 1 << 12].contiguous(), planes, False)
    ref = sort_rows_by_key_plain(key[:, : 1 << 12].contiguous(), planes, False)
    assert all(torch.equal(x, y) for x, y in zip(got, ref))
    # G: one stage of a 2^13 transform
    x = _rand_fr(4 << 13, 13, dev).view(4, 1 << 13, 16)
    tw = _flat_twiddles(13, False, dev)
    assert torch.equal(butterfly(x, tw, 12, 1), butterfly_plain(x, tw, 12, 1))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_kernels_on_a_second_card_match_plain(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    _kernels_match_plain(torch.device("cuda", 0))
    _kernels_match_plain(torch.device("cuda", 1))
    torch.cuda.synchronize(1)


@pytest.mark.cuda
def test_virtual_shards_on_one_card(cuda, tmp_path):
    mesh = proving_mesh(4, devices=[cuda] * 4)
    rng = np.random.default_rng(4)
    n = 1 << 12
    pts = _points(n, cuda)
    vals = [int.from_bytes(rng.bytes(32), "little") % BN254_G1.n for _ in range(n)]
    sc = mont.encode_ints(BN254_FR, vals, device=cuda)
    R = sharded_msm(mesh, pts, sc)
    assert decode_points(G1_SPEC, tuple(r.reshape(1, -1) for r in R))[0] == msm_host(pts, sc)
    a = _rand_fr(n, 11, cuda)
    assert torch.equal(gather_rows(mesh, sharded_ntt(mesh, a)), ntt(BN254_FR, a))
    circ = toy_circuit(tcs)
    params = ParamsKZG(srs=gen_srs(circ.k, cache_dir=str(tmp_path), device=cuda))
    pk = keygen(params, circ.cs, circ.fixed_values, device=cuda)
    advice = [mont.encode_ints(BN254_FR, col, device=cuda) for col in padded_advice(circ)]

    def prove(mesh_):
        return create_proof(params, pk, advice, circ.instances, TranscriptWriter(),
                            blinding_seed=b"multicard", mesh=mesh_, device=cuda)

    assert prove(proving_mesh(2, devices=[cuda] * 2)) == prove(None)


@pytest.fixture
def cards(cuda):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA cards")
    return [torch.device("cuda", i) for i in range(n)]


@pytest.mark.cuda
def test_sharded_path_over_distinct_cards(cards, tmp_path):
    mesh = proving_mesh(len(cards), devices=cards)
    dev = cards[0]
    n = 1 << 12
    pts = _points(n, dev)
    sc = _rand_fr(n, 12, dev)
    R = sharded_msm(mesh, pts, sc)
    assert decode_points(G1_SPEC, tuple(r.reshape(1, -1) for r in R))[0] == msm_host(pts, sc)
    assert torch.equal(gather_rows(mesh, sharded_ntt(mesh, sc)), ntt(BN254_FR, sc))
    circ = REFERENCE_CASES["flex"][0](tcs)
    params = ParamsKZG(srs=gen_srs(circ.k, cache_dir=str(tmp_path), device=dev))
    pk = keygen(params, circ.cs, circ.fixed_values, device=dev)
    advice = [mont.encode_ints(BN254_FR, col, device=dev) for col in padded_advice(circ)]
    proof = create_proof(params, pk, advice, circ.instances, TranscriptWriter(),
                         blinding_seed=FIXTURE["seed"].encode(), mesh=mesh, device=dev)
    assert proof.hex() == FIXTURE["proofs"]["blake2b"]


@pytest.mark.cuda
def test_nccl_processes_share_a_mesh(cards, tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "rank.py"
    script.write_text(NCCL_RANK % {"root": str(ROOT), "srs": str(tmp_path / "srs"),
                                   "seed": FIXTURE["seed"].encode()})
    procs = [subprocess.Popen(
        [sys.executable, str(script)], text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=dict(os.environ, ZKDCAP_COORDINATOR=f"127.0.0.1:{port}",
                 ZKDCAP_NUM_PROCESSES=str(len(cards)), ZKDCAP_PROCESS_ID=str(rank)))
        for rank in range(len(cards))]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
            assert p.returncode == 0 and lines, err[-3000:]
            results.append(json.loads(lines[-1][len("RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert sorted(r["device"] for r in results) == sorted(str(c) for c in cards)
    for r in results:
        assert r["backend"] == "nccl" and r["shape"] == {"host": len(cards), "chip": 1}
        assert r["msm"] and r["ntt"] and r["proof"] == FIXTURE["proofs"]["blake2b"]


def _msm_over_every_card(cards, log: int) -> dict:
    """The sharded 2^log MSM over every card, checked against the host
    curve, then one profiled call: tools.concurrency's readings."""
    mesh = proving_mesh(len(cards), devices=cards)
    dev = cards[0]
    pts = _points(1 << log, dev)  # point i is [4^(i mod 64)]G
    sc = _rand_fr(1 << log, log, dev)
    R = sharded_msm(mesh, pts, sc)
    weights = [pow(4, j, BN254_G1.n) for j in range(64)]
    total = sum(s * weights[i % 64] for i, s in enumerate(mont.decode_ints(BN254_FR, sc)))
    want = BN254_G1.mul(total % BN254_G1.n, BN254_G1.g)
    assert decode_points(G1_SPEC, tuple(r.reshape(1, -1) for r in R))[0] == want
    c = concurrency(lambda: sharded_msm(mesh, pts, sc))
    assert set(c["busy_ms"]) == set(range(len(cards)))
    return c


@pytest.mark.cuda
def test_msm_over_every_card_runs_the_cards_at_once(cards):
    # the cards' busy time summed exceeds the profiled call's wall time
    c = _msm_over_every_card(cards, 20)
    assert c["ratio"] > 1, c


@pytest.mark.cuda
def test_bigger_msm_over_every_card_overlaps_the_cards(cards):
    # 2^22 points (2^20 a card): two or more cards were busy at the same time
    c = _msm_over_every_card(cards, 22)
    assert c["overlap_ms"] > 0, c


@pytest.mark.cuda
def test_service_on_a_second_card_proves_over_shards(cards, tmp_path):
    from zkdcap_tpu_torch.circuits.p256_ecdsa import ECDSAInput
    from zkdcap_tpu_torch.runtime import ECDSAProver

    fix = json.loads((ROOT / "zkdcap_tpu_torch" / "testdata" / "p256_proof.json").read_text())
    params_dir = tmp_path / "params"
    prover = ECDSAProver(params_dir=str(params_dir), k=18, device="cuda:1")
    inp = ECDSAInput.from_hex(fix["msghash"], fix["signature"], fix["pubkey"])
    proof = prover.create_proof(inp, timing=False, shards=2,
                                blinding_seed=fix["seed"].encode())
    assert proof.hex() == fix["proof"]
    out = tmp_path / "proof.hex"
    res = subprocess.run(
        [sys.executable, "-m", "zkdcap_tpu_torch.cli", "--device", "cuda:1", "--shards", "2",
         "--params-dir", str(params_dir), "prove", "--msghash", fix["msghash"],
         "--signature", fix["signature"], "--pubkey", fix["pubkey"], "--output", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    cli_proof = bytes.fromhex(out.read_text().strip().removeprefix("0x"))
    assert prover.verify(inp.as_instances(), cli_proof)
