"""The mesh's executor and the service mesh's device order, on the CPU.

``Mesh.map`` issues a process's shards from one thread in lanes, one a
device: a shard whose work reads its card back runs as steps that end before
each read (``msm_device_steps``), and the lanes take turns step by step, so
that every card is given its work up to its next read before the thread
waits on any. Here every shard is the CPU, so the tests give each shard its
own lane (``Mesh._lane_key`` patched to the shard's index): the shards'
steps then interleave as the cards' do on a machine with several. Under it the sharded
MSM (blocks above the ladder's 512 points: ``msm_device`` per shard; and two
polynomials through the ladder), the sharded NTT and the toy circuit's
blake2b proof over 2 and 4 shards equal the JAX package's results
(``BN254_G1.msm``, ``zkdcap_tpu.ntt.ntt``, the proof bytes of
``testdata/reference_proofs.json``). An exception in one shard's item
reaches the caller with its traceback; the launch counts stay exact when
several threads launch (a stub in place of the kernel library). The
concurrency ratio's busy time merges each card's overlapping intervals, and
the time any card was busy merges all the cards'. A CUDA service's mesh
puts the service's own card first, then the other cards in index order
(``torch.cuda`` patched: no card is needed to build a mesh).
"""

import contextlib
import json
import sys
import threading
import traceback
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from zkdcap_tpu.curves import BN254_G1 as J_G1
from zkdcap_tpu.fields import BN254_FR as J_FR
from zkdcap_tpu.fields import mont as jmont
from zkdcap_tpu.ntt import ntt as j_ntt
from zkdcap_tpu_torch import _build, interop
from zkdcap_tpu_torch.commit import ParamsKZG, gen_srs
from zkdcap_tpu_torch.curves.device_g1 import G1_SPEC, decode_points, encode_points
from zkdcap_tpu_torch.fields import BN254_FR, mont
from zkdcap_tpu_torch.parallel import gather_rows, proving_mesh, sharded_ntt
from zkdcap_tpu_torch.parallel.mesh import Mesh, service_mesh
from zkdcap_tpu_torch.parallel.sharded_msm import sharded_msm_many
from zkdcap_tpu_torch.plonk import cs as tcs
from zkdcap_tpu_torch.plonk.keygen import keygen
from zkdcap_tpu_torch.plonk.prover import create_proof
from zkdcap_tpu_torch.testdata.circuits import REFERENCE_CASES, padded_advice
from zkdcap_tpu_torch.tools.concurrency import any_busy_ms, busy_ms
from zkdcap_tpu_torch.transcript import TranscriptWriter

FIXTURE = json.loads((Path(__file__).resolve().parent.parent / "zkdcap_tpu_torch" / "testdata"
                      / "reference_proofs.json").read_text())["toy"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def lane_a_shard(monkeypatch):
    """A mesh of n CPU shards with a lane a shard, as distinct cards have."""
    monkeypatch.setattr(Mesh, "_lane_key", lambda self, i, dev: i)
    return lambda n: proving_mesh(n, devices=["cpu"] * n)


def test_map_lanes_take_turns_step_by_step(lane_a_shard, monkeypatch):
    events = []

    def shard(i, x):  # two steps: each ends before a "host read"
        events.append((i, "a"))
        yield
        events.append((i, "b"))
        yield
        events.append((i, "c"))
        return i * x

    assert lane_a_shard(4).map(shard, range(4), [10, 20, 30, 40]) == [0, 20, 60, 120]
    assert events == [(i, s) for s in "abc" for i in range(4)]
    events.clear()
    monkeypatch.undo()
    one_lane = proving_mesh(4, devices=["cpu"] * 4)  # virtual shards: a loop
    assert one_lane.map(shard, range(4), [1, 1, 1, 1]) == [0, 1, 2, 3]
    assert events == [(i, s) for i in range(4) for s in "abc"]
    assert one_lane.map(lambda i: i + 1, range(4)) == [1, 2, 3, 4]  # plain items


def test_an_exception_in_a_shard_reaches_the_caller(lane_a_shard):
    mesh = lane_a_shard(4)

    def shard(i):
        yield
        if i == 2:
            raise KeyError("shard 2 failed")
        return i

    with pytest.raises(KeyError, match="shard 2 failed") as err:
        mesh.map(shard, range(4))
    frames = [f.name for f in traceback.extract_tb(err.value.__traceback__)]
    assert "shard" in frames  # the shard's own frame
    assert mesh.map(lambda i: i + 1, range(4)) == [1, 2, 3, 4]


def test_launch_counts_stay_exact_under_threads(monkeypatch):
    stub = SimpleNamespace(zk_mont_mul=lambda *args: 0)
    monkeypatch.setattr(_build, "lib", lambda: stub)
    monkeypatch.setattr(_build, "launches", dict.fromkeys(_build.launches, 0))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: SimpleNamespace(cuda_stream=0))
    threads, calls = 16, 2000
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [
            _build.launch("mont_mul", device=torch.device("cpu")) for _ in range(calls)])
            for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(prev)
    assert _build.launches["mont_mul"] == threads * calls


# (shards, points a shard, polynomials): 520 points a shard run msm_device
# (padded to 1024) in steps, in each shard's lane; 16 points a shard, one
# batched ladder for the shards of the device
@pytest.mark.parametrize("n_dev,per_shard,polys", [(2, 520, 1), (4, 16, 2)])
def test_sharded_msm_many_in_lanes_matches_reference(lane_a_shard, n_dev, per_shard, polys):
    n = per_shard * n_dev
    pts_host = [J_G1.mul(3 * i + 1, J_G1.g) for i in range(n)]
    scalars = [[(5 * i + 7) for i in range(n)], [(11 * i * i + 1) for i in range(n)]][:polys]
    R = sharded_msm_many(lane_a_shard(n_dev), encode_points(G1_SPEC, pts_host, device="cpu"),
                         [mont.encode_ints(BN254_FR, s, device="cpu") for s in scalars])
    got = [decode_points(G1_SPEC, tuple(c.reshape(1, -1) for c in r))[0] for r in R]
    assert got == [J_G1.msm(s, pts_host) for s in scalars]


def test_sharded_ntt_in_lanes_matches_reference(lane_a_shard):
    n = 1 << 8
    rng = np.random.default_rng(8)
    vals = [int.from_bytes(rng.bytes(32), "little") % BN254_FR.p for _ in range(n)]
    ref = np.asarray(j_ntt(J_FR, jmont.encode_ints(J_FR, vals)))
    a = mont.encode_ints(BN254_FR, vals, device="cpu")
    for n_dev in (2, 4):
        mesh = lane_a_shard(n_dev)
        assert np.array_equal(interop.to_numpy(gather_rows(mesh, sharded_ntt(mesh, a))), ref)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    circ = REFERENCE_CASES["toy"][0](tcs)
    params = ParamsKZG(srs=gen_srs(circ.k, cache_dir=str(tmp_path_factory.mktemp("srs")),
                                   device="cpu"))
    pk = keygen(params, circ.cs, circ.fixed_values, device="cpu")
    advice = [mont.encode_ints(BN254_FR, col, device="cpu") for col in padded_advice(circ)]
    return circ, params, pk, advice


@pytest.mark.parametrize("n_dev", [2, 4])
def test_toy_proof_in_lanes_equals_reference_bytes(lane_a_shard, toy, n_dev):
    circ, params, pk, advice = toy
    proof = create_proof(params, pk, advice, circ.instances, TranscriptWriter("blake2b"),
                         blinding_seed=FIXTURE["seed"].encode(), mesh=lane_a_shard(n_dev),
                         device="cpu")
    assert proof.hex() == FIXTURE["proofs"]["blake2b"]


@pytest.fixture
def four_cards(monkeypatch):
    """torch.cuda as a machine with four cards and card 2 current."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)


def test_service_mesh_puts_the_service_card_first(four_cards):
    def order(shards, device):
        return [str(d) for d in service_mesh(shards, device).devices]

    assert order(3, "cuda:2") == ["cuda:2", "cuda:0", "cuda:1"]
    assert order(4, "cuda:1") == ["cuda:1", "cuda:0", "cuda:2", "cuda:3"]
    assert order(2, "cuda:0") == ["cuda:0", "cuda:1"]
    assert order(2, "cuda") == ["cuda:2", "cuda:0"]  # the current card
    assert order(3, "cpu") == ["cpu"] * 3
    assert service_mesh(1, "cuda:3") is None and service_mesh(None, "cuda:3") is None
    with pytest.raises(ValueError, match="need 5 CUDA devices, have 4"):
        service_mesh(5, "cuda:1")
    with pytest.raises(ValueError, match="no CUDA device cuda:4"):
        service_mesh(2, "cuda:4")


def test_busy_ms_merges_each_cards_intervals():
    from torch.autograd import DeviceType

    def ev(dev, start, end, name="kernel", kind=DeviceType.CUDA):
        return SimpleNamespace(device_type=kind, device_index=dev, name=name,
                               time_range=SimpleNamespace(start=start, end=end))

    events = [ev(0, 0, 1000), ev(0, 500, 1500), ev(0, 3000, 3500), ev(1, 100, 200),
              ev(1, 0, 2000), ev(1, 0, 9000, "Activity Buffer Request"),
              ev(-1, 0, 9000, kind=DeviceType.CPU)]
    prof = SimpleNamespace(events=lambda: events)
    assert busy_ms(prof) == {0: 2.0, 1: 2.0}
    assert any_busy_ms(prof) == 2.5  # 0-2000 and 3000-3500 us: 1.5 ms of the 4 at once
