"""Generic circuit prover lifecycle (reference `PreCircuit` + prover
template, crates/p256-ecdsa/src/base.rs:50-283).

Port of ``zkdcap_tpu/runtime/circuit_prover.py``. A subclass supplies the
trace builder and a structure input; the base class owns the artifacts
(``{NAME}_pk_k{k}.npz``, ``{NAME}_vk_k{k}.json``, ``{NAME}_pinning_k{k}.json``,
``{NAME}_tape_k{k}.npz`` in the JAX package's formats, so a params dir
written by either package loads in the other), the witness tape (replayed
by the port's native evaluator, with no Python fallback), device encoding
and verification. Keygen and proofs run on the card unless ``device`` names
another device; ``verify`` is host only.

Subclass contract:
  NAME            artifact prefix (files: {NAME}_pk_k{k}.npz, ...)
  K_DEFAULT       default circuit degree
  LOOKUP_BITS     default range-table bits (clamped to k-1)
  build_trace(inp, tracer=None) -> Context
  structure_input()            -> sample input (fixed circuit structure)
  trace_inputs(inp)            -> flat int list for tape replay

``multiopen="gwc"`` selects the GWC19 multiopen for proofs and verify;
``create_proof(checkpoint=True)`` saves each round's state under the params
dir and resumes an interrupted proof; ``create_proof(shards=N)`` proves
over a mesh of N shards (``parallel/``), and ``prepare`` gives what a proof
proves (pk, advice, instances) for a caller's own mesh.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from .. import metrics
from ..chips import CircuitBuilder, Pinning
from ..commit import ParamsKZG, gen_srs
from ..device import resolve
from ..fields import BN254_FR, mont
from ..interop import load_pk, save_pk
from ..ntt import Domain
from ..parallel.mesh import service_mesh
from ..plonk.keygen import ProvingKey, VerifyingKey, keygen
from ..plonk.prover import create_proof
from ..plonk.verifier import verify_proof
from ..transcript import TranscriptWriter


class CircuitProver:
    NAME = "circuit"
    K_DEFAULT = 17
    LOOKUP_BITS = 16

    def __init__(self, params_dir: str = "params", k: int | None = None,
                 transcript: str = "blake2b", lookup_bits: int | None = None,
                 multiopen: str = "shplonk", device=None):
        if multiopen not in ("shplonk", "gwc"):
            raise ValueError(f"unknown multiopen {multiopen!r}")
        self.params_dir = params_dir
        self.k = k if k is not None else self.K_DEFAULT
        self.transcript_kind = transcript
        self.multiopen = multiopen
        self.lookup_bits = (lookup_bits if lookup_bits is not None
                            else min(self.LOOKUP_BITS, self.k - 1))
        self._device = device
        self._pk: ProvingKey | None = None
        self._vk: VerifyingKey | None = None
        self._params: ParamsKZG | None = None
        self._builder = None
        self._compiled = None
        self._structure_ctx = None
        self._tape = None
        # seconds of the last keygen's and the last proof's phases
        self.keygen_phases: dict[str, float] = {}
        self.last_phases: dict[str, float] = {}

    @property
    def device(self) -> torch.device:
        """Where keygen and proofs run: the card unless the caller named
        another device (raises without a card and without `device`)."""
        return resolve(self._device)

    # --- subclass hooks ---------------------------------------------------

    def build_trace(self, inp, tracer=None):
        raise NotImplementedError

    def structure_input(self):
        raise NotImplementedError

    def trace_inputs(self, inp) -> list[int]:
        raise NotImplementedError

    # --- artifact paths ---------------------------------------------------

    @property
    def pk_path(self):
        return os.path.join(self.params_dir, f"{self.NAME}_pk_k{self.k}.npz")

    @property
    def pinning_path(self):
        return os.path.join(self.params_dir, f"{self.NAME}_pinning_k{self.k}.json")

    @property
    def vk_path(self):
        return os.path.join(self.params_dir, f"{self.NAME}_vk_k{self.k}.json")

    @property
    def tape_path(self):
        return os.path.join(self.params_dir, f"{self.NAME}_tape_k{self.k}.npz")

    # --- keygen / artifacts ----------------------------------------------

    def params(self) -> ParamsKZG:
        if self._params is None:
            self._params = ParamsKZG(srs=gen_srs(self.k, cache_dir=self.params_dir,
                                                 device=self.device))
        return self._params

    def _compile(self, pinning: Pinning | None = None):
        trace = self.build_trace(self.structure_input())
        builder = CircuitBuilder(self.k, lookup_bits=self.lookup_bits)
        compiled = builder.compile(trace, pinning)
        self._structure_ctx = trace  # structural index lists for witness fill
        return builder, compiled

    def _get_tape(self):
        """Witness tape (compiled witness generation): load or record+cache."""
        if self._tape is not None:
            return self._tape
        from ..witness.tape import WitnessTape, record

        if os.path.exists(self.tape_path):
            try:
                self._tape = WitnessTape.load(self.tape_path)
                return self._tape
            except Exception:
                pass  # corrupt artifact: re-record (same policy as pk)
        _, tape = record(
            lambda tr: self.build_trace(self.structure_input(), tracer=tr)
        )
        os.makedirs(self.params_dir, exist_ok=True)
        tape.save(self.tape_path)
        self._tape = tape
        return tape

    def keygen(self, force: bool = False) -> ProvingKey:
        os.makedirs(self.params_dir, exist_ok=True)
        if not force and self._pk is not None:
            return self._pk
        if not force and os.path.exists(self.pk_path) and os.path.exists(self.pinning_path):
            try:
                return self._load()
            except Exception:
                # corrupt artifacts are regenerated, like read_pinning
                # (base.rs:102-114)
                pass
        self.keygen_phases.clear()
        t = time.perf_counter()

        def _p(name):
            nonlocal t
            now = time.perf_counter()
            self.keygen_phases[name] = now - t
            t = now

        params = self.params()
        _p("srs")
        builder, compiled = self._compile()
        _p("trace+compile")
        pk = keygen(params, compiled.cs, compiled.fixed_values, self.transcript_kind,
                    device=self.device)
        if pk.l0_ext.is_cuda:
            torch.cuda.synchronize(pk.l0_ext.device)
        _p("device keygen")
        self._pk, self._builder, self._compiled = pk, builder, compiled
        self._save(pk, compiled.pinning)
        _p("pk save")
        return pk

    def _save(self, pk: ProvingKey, pinning: Pinning) -> None:
        save_pk(self.pk_path, pk)
        self._save_vk(pk.vk, pinning)

    def _save_vk(self, vk: VerifyingKey, pinning: Pinning) -> None:
        """The light verifier's artifacts: the pinning and the vk."""
        with open(self.pinning_path, "w") as f:
            f.write(pinning.to_json())
        with open(self.vk_path, "w") as f:
            json.dump(self._vk_data(vk), f)

    def _vk_data(self, vk: VerifyingKey) -> dict:
        return {
            "k": vk.k,
            "transcript": vk.transcript_kind,
            "fixed_commitments": [list(c) if c else None for c in vk.fixed_commitments],
            "permutation_commitments": [
                list(c) if c else None for c in vk.permutation_commitments
            ],
        }

    def _vk_from_data(self, vk_data: dict, cs) -> VerifyingKey:
        assert vk_data["k"] == self.k
        return VerifyingKey(
            k=self.k,
            cs=cs,
            fixed_commitments=[tuple(c) if c else None for c in vk_data["fixed_commitments"]],
            permutation_commitments=[
                tuple(c) if c else None for c in vk_data["permutation_commitments"]
            ],
            transcript_kind=vk_data["transcript"],
        )

    def _load(self) -> ProvingKey:
        with open(self.pinning_path) as f:
            pinning = Pinning.from_json(f.read())
        builder, compiled = self._compile(pinning)
        with open(self.vk_path) as f:
            vk = self._vk_from_data(json.load(f), compiled.cs)
        domain = Domain(BN254_FR, self.k, compiled.cs.extended_k(self.k))
        pk = load_pk(self.pk_path, vk, domain, self.device)
        self._pk, self._builder, self._compiled = pk, builder, compiled
        return pk

    def load_vk(self) -> VerifyingKey:
        """Light verifier path: vk from vk.json + pinning WITHOUT the pk
        arrays."""
        if self._pk is not None:
            return self._pk.vk
        if self._vk is not None:
            return self._vk
        if not (os.path.exists(self.vk_path) and os.path.exists(self.pinning_path)):
            return self.keygen().vk
        with open(self.pinning_path) as f:
            pinning = Pinning.from_json(f.read())
        builder, compiled = self._compile(pinning)
        with open(self.vk_path) as f:
            self._vk = self._vk_from_data(json.load(f), compiled.cs)
        self._builder, self._compiled = builder, compiled
        return self._vk

    def verifier_params(self) -> ParamsKZG:
        """Verification needs only the host G2 points (derived from the
        deterministic dev tau) — not the 2^k G1 powers."""
        if self._params is not None:
            return self._params
        from ..commit.srs import SRS, _dev_tau
        from ..curves.pairing import G2_GEN, g2_mul

        tau = _dev_tau()
        return ParamsKZG(srs=SRS(k=self.k, g1_powers=None, g2=G2_GEN,
                                 s_g2=g2_mul(tau, G2_GEN), g1=(1, 2)))

    # --- proving ----------------------------------------------------------

    def _phase(self, name: str, t0: float, timing: bool) -> float:
        now = time.perf_counter()
        self.last_phases[name] = now - t0
        metrics.record(f"runtime.{self.NAME}.{name}", now - t0, k=self.k)
        if timing:
            print(f"[runtime] {name}: {now - t0:.2f}s", file=sys.stderr, flush=True)
        return now

    def prepare(self, inp, timing: bool = False):
        """What ``create_proof`` proves: (pk, advice columns on the device,
        instances), with the keygen (or load), the native tape replay, the
        witness fill and the device encode timed into ``last_phases``."""
        from ..witness.native import eval_tape_raw

        t = time.perf_counter()
        pk = self.keygen()
        t = self._phase("keygen(cached)", t, timing)
        # compiled witness generation: replay the recorded tape natively
        raw = eval_tape_raw(self._get_tape(), self.trace_inputs(inp))
        t = self._phase("witness replay", t, timing)
        sctx = self._structure_ctx
        limbs = self._builder.witness_limbs(self._compiled, sctx, raw)
        inst_cells = getattr(sctx, "instance_cells", [])
        instances = (
            [[int.from_bytes(raw[c].tobytes(), "little") for c in inst_cells]]
            if inst_cells else []
        )
        t = self._phase("witness fill", t, timing)
        adv = mont.to_mont(BN254_FR, torch.from_numpy(limbs.astype(np.int32)).to(self.device))
        advice_dev = [adv[i] for i in range(adv.shape[0])]
        self._phase("device encode", t, timing)
        return pk, advice_dev, instances

    def create_proof(self, inp, timing: bool = True,
                     shards: int | None = None,
                     checkpoint: bool = False,
                     self_verify: bool | None = None, *,
                     blinding_seed: bytes | None = None) -> bytes:
        """shards: prove over a mesh of N shards (``parallel.service_mesh``:
        N CPU shards on the CPU, else N cards, the service's own first,
        raising when there are fewer); the proof bytes equal the one-device
        proof's.
        blinding_seed: passed to ``plonk.prover.create_proof``; None draws
        fresh entropy (hiding proofs), a seed gives reproducible bytes.
        checkpoint: persist per-round state under params_dir for resumable
        proofs (a re-invoked proof with the same input resumes).
        Phase times land in ``last_phases`` and ``metrics``."""
        mesh = service_mesh(shards, self.device)
        self.last_phases.clear()
        pk, advice_dev, instances = self.prepare(inp, timing)
        t = time.perf_counter()
        proof = create_proof(self.params(), pk, advice_dev, instances,
                             TranscriptWriter(pk.vk.transcript_kind),
                             blinding_seed=blinding_seed, timing=timing, mesh=mesh,
                             checkpoint_dir=self.params_dir if checkpoint else None,
                             multiopen=self.multiopen, device=self.device)
        self._phase("create_proof", t, timing)
        metrics.dump(os.path.join(self.params_dir, "metrics.jsonl"))
        if self_verify is None:
            self_verify = os.environ.get("ZKDCAP_SELF_VERIFY", "") == "1"
        if self_verify:
            t = time.perf_counter()
            assert self.verify(proof, instances=instances), "self-verify failed"
            self._phase("self-verify", t, timing)
        return proof

    def verify(self, proof: bytes, instances: list | None = None) -> bool:
        vk = self.load_vk()
        return verify_proof(self.verifier_params(), vk, instances or [], proof,
                            transcript_kind=self.transcript_kind,
                            multiopen=self.multiopen)
