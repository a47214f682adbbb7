"""The port's multi-process path: ``init_distributed`` and ``multihost_mesh``.

As ``tests/test_multihost.py`` does for the JAX package: without a
coordinator ``init_distributed`` is a no-op; in a subprocess with one
process (gloo) it joins a group and ``multihost_mesh`` is ``(1, n)``. Then
two gloo processes, started with the ``ZKDCAP_*`` variables and a free port,
share a ``(host=2, chip=2)`` CPU mesh: each holds two shards, and both get
the sharded MSM and NTT equal to the single-device results and the toy
proof equal to the fixture's bytes (SPMD: every process calls the same
entry point with the same inputs). Mixing a CPU mesh with a NCCL group, or
the reverse, raises.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch.distributed as dist

from zkdcap_tpu_torch.parallel import init_distributed

ROOT = Path(__file__).resolve().parent.parent

WORKER = r"""
import json, sys
sys.path.insert(0, %(root)r)
import torch
torch.set_num_threads(1)
from zkdcap_tpu_torch.curves import BN254_G1
from zkdcap_tpu_torch.curves.device_g1 import G1_SPEC, decode_points, encode_points
from zkdcap_tpu_torch.fields import BN254_FR, mont
from zkdcap_tpu_torch.ntt import ntt
from zkdcap_tpu_torch.parallel import (
    gather_rows, init_distributed, multihost_mesh, sharded_msm, sharded_ntt)

assert init_distributed(device="cpu") is True
mesh = multihost_mesh(devices=["cpu"] * %(chips)d)
out = {"rank": mesh.rank, "shape": mesh.shape, "shards": [g for g, _ in mesh.local_shards()]}
if %(work)r:
    a = mont.encode_ints(BN254_FR, [(i * 7919 + 13) %% BN254_FR.p for i in range(256)], device="cpu")
    out["ntt"] = torch.equal(gather_rows(mesh, sharded_ntt(mesh, a)), ntt(BN254_FR, a))
    pts_host = [BN254_G1.mul(i + 1, BN254_G1.g) for i in range(64)]
    R = sharded_msm(mesh, encode_points(G1_SPEC, pts_host, device="cpu"),
                    mont.encode_ints(BN254_FR, [i + 2 for i in range(64)], device="cpu"))
    out["msm"] = (decode_points(G1_SPEC, tuple(r.reshape(1, -1) for r in R))[0]
                  == BN254_G1.msm([i + 2 for i in range(64)], pts_host))
    from zkdcap_tpu_torch.commit import ParamsKZG, gen_srs
    from zkdcap_tpu_torch.plonk import cs as tcs
    from zkdcap_tpu_torch.plonk.keygen import keygen
    from zkdcap_tpu_torch.plonk.prover import create_proof
    from zkdcap_tpu_torch.testdata.circuits import padded_advice, toy_circuit
    from zkdcap_tpu_torch.transcript import TranscriptWriter
    circ = toy_circuit(tcs)
    params = ParamsKZG(srs=gen_srs(circ.k, cache_dir=%(srs)r, device="cpu"))
    pk = keygen(params, circ.cs, circ.fixed_values, device="cpu")
    advice = [mont.encode_ints(BN254_FR, col, device="cpu") for col in padded_advice(circ)]
    out["proof"] = create_proof(params, pk, advice, circ.instances, TranscriptWriter("blake2b"),
                                blinding_seed=%(seed)r, mesh=mesh, device="cpu").hex()
print("RESULT " + json.dumps(out), flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(tmp_path, processes: int, chips: int, work: bool, seed: bytes = b"") -> list[dict]:
    script = tmp_path / "worker.py"
    srs = tmp_path / "srs"
    srs.mkdir(exist_ok=True)
    script.write_text(WORKER % {"root": str(ROOT), "chips": chips, "work": work,
                                "srs": str(srs), "seed": seed})
    port = _free_port()
    procs = []
    for rank in range(processes):
        env = dict(os.environ, ZKDCAP_COORDINATOR=f"127.0.0.1:{port}",
                   ZKDCAP_NUM_PROCESSES=str(processes), ZKDCAP_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen([sys.executable, str(script)], env=env, text=True,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE))
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
    return results


def test_init_distributed_without_coordinator_is_a_no_op(monkeypatch):
    monkeypatch.delenv("ZKDCAP_COORDINATOR", raising=False)
    assert init_distributed(device="cpu") is False
    assert not dist.is_initialized()


def test_one_process_group_gives_a_one_host_mesh(tmp_path):
    (r,) = _run(tmp_path, processes=1, chips=3, work=False)
    assert r["rank"] == 0 and r["shape"] == {"host": 1, "chip": 3} and r["shards"] == [0, 1, 2]


def test_two_gloo_processes_share_a_mesh(tmp_path):
    fixture = json.loads((ROOT / "zkdcap_tpu_torch" / "testdata" / "reference_proofs.json")
                         .read_text())["toy"]
    results = _run(tmp_path, processes=2, chips=2, work=True, seed=fixture["seed"].encode())
    assert [r["shards"] for r in results] == [[0, 1], [2, 3]]
    for r in results:
        assert r["shape"] == {"host": 2, "chip": 2}
        assert r["ntt"] and r["msm"]
        assert r["proof"] == fixture["proofs"]["blake2b"]


def test_collective_backend_must_match_the_shards(monkeypatch):
    from zkdcap_tpu_torch.parallel import Mesh

    monkeypatch.setattr(dist, "get_rank", lambda group=None: 0)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 1)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    with pytest.raises(ValueError, match="need a gloo process group"):
        Mesh(["cpu"], {"host": 1, "chip": 1}, group=object())
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "gloo")
    with pytest.raises(ValueError, match="need a nccl process group"):
        Mesh(["cuda:0"], {"host": 1, "chip": 1}, group=object())
