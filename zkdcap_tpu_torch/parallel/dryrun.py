"""The multi-shard dry run: the sharded MSM, NTT and a proof over a mesh.

Port of ``dryrun_multichip`` in the JAX package's ``__graft_entry__.py``,
which runs on n virtual CPU devices. Here the mesh is n shards on one
device (the card unless ``device`` names another), or the given
``devices``. Three checks, each raising AssertionError on a mismatch:

  * the sharded MSM of max(8n, 16) multiples of G against the host curve's
    MSM;
  * the sharded NTT of a 2^max(2 ceil(log2 n) + 2, 6)-point array against
    the single-device ``ntt``;
  * the k = 4 toy circuit's proof over the mesh byte-identical to the
    single-device proof, and accepted by the verifier.
"""

from __future__ import annotations

import tempfile
import time

import torch

from ..commit import ParamsKZG, gen_srs
from ..curves.device_g1 import G1_SPEC, decode_points, encode_points
from ..curves.host_curve import BN254_G1
from ..device import resolve
from ..fields import BN254_FR, mont
from ..ntt import ntt
from ..plonk import cs as cs_mod
from ..plonk.keygen import keygen
from ..plonk.prover import create_proof
from ..plonk.verifier import verify_proof
from ..testdata.circuits import padded_advice, toy_circuit
from ..transcript import TranscriptWriter
from .mesh import proving_mesh
from .sharded_msm import sharded_msm
from .sharded_ntt import gather_rows, sharded_ntt


def dryrun_multichip(n_devices: int, device=None, devices=None) -> dict:
    """Run the three checks on a mesh of ``n_devices`` shards: ``devices``,
    or that many shards on ``device``. Returns each check's seconds."""
    devs = devices if devices is not None else [resolve(device)] * n_devices
    mesh = proving_mesh(n_devices, devices=devs)
    dev = mesh.first
    seconds = {}

    t = time.perf_counter()
    n_pts = max(8 * n_devices, 16)
    pts_host = [BN254_G1.mul(i + 1, BN254_G1.g) for i in range(n_pts)]
    scalars = [i + 2 for i in range(n_pts)]
    R = sharded_msm(mesh, encode_points(G1_SPEC, pts_host, device=dev),
                    mont.encode_ints(BN254_FR, scalars, device=dev))
    got = decode_points(G1_SPEC, tuple(r.reshape(1, -1) for r in R))[0]
    expect = BN254_G1.msm(scalars, pts_host)
    assert got == expect, f"sharded MSM mismatch: {got} != {expect}"
    seconds["msm"] = time.perf_counter() - t

    t = time.perf_counter()
    log_n = max(2 * (n_devices - 1).bit_length() + 2, 6)
    n = 1 << log_n
    a = mont.encode_ints(BN254_FR, [(i * 7919 + 13) % BN254_FR.p for i in range(n)], device=dev)
    out = gather_rows(mesh, sharded_ntt(mesh, a))
    assert torch.equal(out, ntt(BN254_FR, a)), "sharded NTT mismatch"
    seconds["ntt"] = time.perf_counter() - t
    print(f"dryrun_multichip({n_devices}): sharded MSM + NTT OK on mesh {mesh.shape} "
          f"of {[str(d) for d in mesh.devices]}", flush=True)

    t = time.perf_counter()
    circ = toy_circuit(cs_mod)
    with tempfile.TemporaryDirectory() as d:
        params = ParamsKZG(srs=gen_srs(circ.k, cache_dir=d, device=dev))
    pk = keygen(params, circ.cs, circ.fixed_values, device=dev)
    advice = [mont.encode_ints(BN254_FR, col, device=dev) for col in padded_advice(circ)]
    seed = b"dryrun-parity"
    proof_mesh = create_proof(params, pk, advice, circ.instances, TranscriptWriter("blake2b"),
                              blinding_seed=seed, mesh=mesh, device=dev)
    proof_single = create_proof(params, pk, advice, circ.instances, TranscriptWriter("blake2b"),
                                blinding_seed=seed, device=dev)
    assert proof_mesh == proof_single, "mesh proof bytes diverge from single-device"
    assert verify_proof(params, pk.vk, circ.instances, proof_mesh), "mesh proof must verify"
    seconds["proof"] = time.perf_counter() - t
    print(f"dryrun_multichip({n_devices}): full sharded proof ({len(proof_mesh)} B) "
          "byte-identical + verified", flush=True)
    return seconds
