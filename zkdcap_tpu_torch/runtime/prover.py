"""Prover lifecycle + artifact cache (reference `ECDSAProver`, base.rs).

Port of ``zkdcap_tpu/runtime/prover.py``. keygen at k=18 writes
``pk_k{k}.npz``, ``vk_k{k}.json``, ``pinning.json`` (circuit shape +
deterministic layout) and ``tape_k{k}.npz`` (the recorded witness tape) in
the JAX package's formats, so a params dir written by either package loads
in the other; ``create_proof`` replays the tape natively against the frozen
pinning and proves on the card (or on the CPU with ``device="cpu"``) with
the chosen transcript (blake2b native / keccak EVM). ``verify`` is host-only;
``verify(evm=True)`` compiles the generated Solidity verifier
(``gen_evm_verifier``, cached as ``evm_verifier_k{k}_{multiopen}.bin`` in the
params dir) and executes it on the proof's calldata (``evm/``).

The circuit structure is witness-independent, so keygen traces a fixed
valid sample signature; proofs replay the tape with the real input.

``multiopen="gwc"`` selects the GWC19 multiopen for proofs and verify;
``create_proof(checkpoint=True)`` saves each round's state under the params
dir and resumes an interrupted proof (``plonk/checkpoint.py``);
``create_proof(shards=N)`` proves over a mesh of N shards (``parallel/``),
and ``prepare`` gives what a proof proves (pk, advice, instances) for a
caller's own mesh.
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
from ..circuits.p256_ecdsa import ECDSAInput, build_ecdsa_trace, trace_inputs
from ..commit import ParamsKZG, gen_srs
from ..curves.host_curve import SECP256R1
from ..device import resolve
from ..fields import BN254_FR, mont
from ..interop import load_pk, save_pk
from ..ntt import Domain
from ..parallel.mesh import service_mesh
from ..plonk.keygen import ProvingKey, VerifyingKey, keygen
from ..plonk.prover import create_proof
from ..plonk.verifier import verify_proof
from ..transcript import TranscriptWriter


def _sample_input() -> ECDSAInput:
    """Deterministic valid P-256 signature for structure tracing."""
    c = SECP256R1
    d = 0xC0FFEE1234567890ABCDEF
    pub = c.mul(d, c.g)
    z = 0x1122334455667788990011223344556677889900112233445566778899001122 % c.n
    k = 0xDEADBEEFCAFEBABE1337
    r = c.mul(k, c.g)[0] % c.n
    s = pow(k, -1, c.n) * (z + r * d) % c.n
    return ECDSAInput(r=r, s=s, msghash=z, x=pub[0], y=pub[1])


SAMPLE_INPUT = _sample_input()


class ECDSAProver:
    """keygen / prove / verify with cached artifacts (base.rs:93-283)."""

    K_DEFAULT = 18  # base.rs:134 gen_srs(18)

    def __init__(self, params_dir: str = "params", k: int = K_DEFAULT,
                 transcript: str = "blake2b", lookup_bits: int | None = None,
                 multiopen: str = "shplonk", device=None):
        if multiopen not in ("shplonk", "gwc"):
            raise ValueError(f"unknown multiopen {multiopen!r}")
        self.params_dir = params_dir
        self.k = k
        self.transcript_kind = transcript
        self.multiopen = multiopen
        # lookup table must fit the domain: 2^17 table needs k >= 18
        self.lookup_bits = lookup_bits if lookup_bits is not None else min(17, k - 1)
        self._device = device
        self._pk: ProvingKey | None = None
        self._vk: VerifyingKey | None = None
        self._params: ParamsKZG | None = None
        self._compiled = None
        self._builder = None
        self._structure_ctx = None
        self._tape = None
        self.last_phases: dict[str, float] = {}

    @property
    def device(self) -> torch.device:
        """Where keygen and proofs run: the card unless the caller named
        another device (raises without a card and without `device`)."""
        return resolve(self._device)

    # --- artifacts --------------------------------------------------------

    @property
    def pk_path(self):
        return os.path.join(self.params_dir, f"pk_k{self.k}.npz")

    @property
    def pinning_path(self):
        return os.path.join(self.params_dir, "pinning.json")

    @property
    def vk_path(self):
        return os.path.join(self.params_dir, f"vk_k{self.k}.json")

    @property
    def tape_path(self):
        return os.path.join(self.params_dir, f"tape_k{self.k}.npz")

    def _compile(self, pinning: Pinning | None = None):
        trace = build_ecdsa_trace(SAMPLE_INPUT, self.lookup_bits)
        builder = CircuitBuilder(self.k, lookup_bits=self.lookup_bits)
        compiled = builder.compile(trace, pinning)
        self._structure_ctx = trace  # structural index lists for witness fill
        return builder, compiled, trace

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
            lambda tr: build_ecdsa_trace(SAMPLE_INPUT, self.lookup_bits, tracer=tr)
        )
        os.makedirs(self.params_dir, exist_ok=True)
        tape.save(self.tape_path)
        self._tape = tape
        return tape

    def params(self) -> ParamsKZG:
        if self._params is None:
            self._params = ParamsKZG(srs=gen_srs(self.k, cache_dir=self.params_dir,
                                                 device=self.device))
        return self._params

    def keygen(self, force: bool = False) -> ProvingKey:
        os.makedirs(self.params_dir, exist_ok=True)
        if not force and self._pk is not None:
            return self._pk
        if not force and os.path.exists(self.pk_path) and os.path.exists(self.pinning_path):
            try:
                return self._load()
            except Exception:
                # corrupt artifacts are regenerated, like read_pinning (base.rs:102-114)
                pass
        params = self.params()
        builder, compiled, _ = self._compile()
        pk = keygen(params, compiled.cs, compiled.fixed_values, self.transcript_kind,
                    device=self.device)
        self._pk, self._builder, self._compiled = pk, builder, compiled
        self._save(pk, compiled.pinning)
        return pk

    def _save(self, pk: ProvingKey, pinning: Pinning) -> None:
        with open(self.pinning_path, "w") as f:
            f.write(pinning.to_json())
        save_pk(self.pk_path, pk)
        vk_data = {
            "k": pk.vk.k,
            "transcript": pk.vk.transcript_kind,
            "fixed_commitments": [list(c) if c else None for c in pk.vk.fixed_commitments],
            "permutation_commitments": [list(c) if c else None for c in pk.vk.permutation_commitments],
        }
        with open(self.vk_path, "w") as f:
            json.dump(vk_data, f)

    def _vk_from_files(self, compiled) -> VerifyingKey:
        with open(self.vk_path) as f:
            vk_data = json.load(f)
        assert vk_data["k"] == self.k
        return VerifyingKey(
            k=self.k,
            cs=compiled.cs,
            fixed_commitments=[tuple(c) if c else None for c in vk_data["fixed_commitments"]],
            permutation_commitments=[
                tuple(c) if c else None for c in vk_data["permutation_commitments"]
            ],
            transcript_kind=vk_data["transcript"],
        )

    def _load(self) -> ProvingKey:
        with open(self.pinning_path) as f:
            pinning = Pinning.from_json(f.read())
        builder, compiled, _ = self._compile(pinning)
        vk = self._vk_from_files(compiled)
        domain = Domain(BN254_FR, self.k, compiled.cs.extended_k(self.k))
        pk = load_pk(self.pk_path, vk, domain, self.device)
        self._pk, self._builder, self._compiled = pk, builder, compiled
        return pk

    def load_vk(self) -> VerifyingKey:
        """Light verifier path: builds the vk from vk.json + pinning.json
        WITHOUT loading the multi-GB pk arrays. Verification only needs
        commitments + the circuit structure + the host G2 points."""
        if self._pk is not None:
            return self._pk.vk
        if self._vk is not None:
            return self._vk
        if not (os.path.exists(self.vk_path) and os.path.exists(self.pinning_path)):
            return self.keygen().vk
        with open(self.pinning_path) as f:
            pinning = Pinning.from_json(f.read())
        builder, compiled, _ = self._compile(pinning)
        self._vk = self._vk_from_files(compiled)
        self._builder, self._compiled = builder, compiled
        return self._vk

    # --- proving ----------------------------------------------------------

    def _phase(self, name: str, t0: float, timing: bool) -> float:
        now = time.perf_counter()
        self.last_phases[name] = now - t0
        metrics.record(f"runtime.{name}", now - t0, k=self.k)
        if timing:
            print(f"[runtime] {name}: {now - t0:.2f}s", file=sys.stderr, flush=True)
        return now

    def prepare(self, inp: ECDSAInput, timing: bool = False):
        """What ``create_proof`` proves: (pk, advice columns on the device,
        instances), with the keygen (or load), the native tape replay, the
        witness fill and the device encode timed into ``last_phases``."""
        from ..witness.native import eval_tape_raw

        t = time.perf_counter()
        pk = self.keygen()
        t = self._phase("keygen(cached)", t, timing)
        # compiled witness generation: replay the recorded tape natively
        raw = eval_tape_raw(self._get_tape(), trace_inputs(inp))
        t = self._phase("witness replay", t, timing)
        sctx = self._structure_ctx
        limbs = self._builder.witness_limbs(self._compiled, sctx, raw)
        inst = [
            int.from_bytes(raw[c].tobytes(), "little") for c in sctx.instance_cells
        ]
        instances = [inst]
        t = self._phase("witness fill", t, timing)
        assert len(instances[0]) == 15, "expected 15 public instances"
        assert instances[0] == inp.as_instances()
        adv = mont.to_mont(BN254_FR, torch.from_numpy(limbs.astype(np.int32)).to(self.device))
        advice_dev = [adv[i] for i in range(adv.shape[0])]
        self._phase("device encode", t, timing)
        return pk, advice_dev, instances

    def create_proof(self, inp: ECDSAInput, evm: bool = False, timing: bool = True,
                     shards: int | None = None,
                     checkpoint: bool = False,
                     self_verify: bool | None = None, *,
                     blinding_seed: bytes | None = None) -> bytes:
        """evm: prove under the keccak transcript (the EVM verifier's).
        shards: prove over a mesh of N shards (``parallel.service_mesh``: N
        CPU shards on the CPU, else N cards, the service's own first, raising
        when there are fewer); the proof bytes equal the one-device proof's.
        self_verify: verify the proof before returning. Default: the
        ZKDCAP_SELF_VERIFY env var (reference analog of debug_assertions).
        blinding_seed: passed to ``plonk.prover.create_proof``; None draws
        fresh entropy (hiding proofs), a seed gives reproducible bytes.
        checkpoint: persist per-round state under params_dir for resumable
        proofs (a re-invoked proof with the same input resumes).
        Phase times land in ``last_phases`` and ``metrics``."""
        mesh = service_mesh(shards, self.device)
        self.last_phases.clear()
        pk, advice_dev, instances = self.prepare(inp, timing)
        t = time.perf_counter()
        kind = "keccak" if evm else self.transcript_kind
        proof = create_proof(self.params(), pk, advice_dev, instances, TranscriptWriter(kind),
                             blinding_seed=blinding_seed, timing=timing, mesh=mesh,
                             checkpoint_dir=self.params_dir if checkpoint else None,
                             multiopen=self.multiopen, device=self.device)
        self._phase("create_proof", t, timing)
        # structured metrics artifact: one JSON-lines file per params dir,
        # appended per proof
        metrics.dump(os.path.join(self.params_dir, "metrics.jsonl"))
        if self_verify is None:
            self_verify = os.environ.get("ZKDCAP_SELF_VERIFY", "") == "1"
        if self_verify:
            # prove-then-verify (base.rs:214-247): the evm path compiles and
            # executes the generated Solidity verifier
            t = time.perf_counter()
            assert self.verify(instances[0], proof, evm=evm), "self-verify failed"
            self._phase("self-verify" + (" (evm executed)" if evm else ""), t, timing)
        return proof

    def verifier_params(self) -> ParamsKZG:
        """Verification needs only the host G2 points (derived from the
        deterministic dev tau) — not the 2^k G1 powers."""
        if self._params is not None:
            return self._params
        from ..commit.srs import SRS, _dev_tau
        from ..curves.pairing import G2_GEN, g2_mul

        tau = _dev_tau()
        srs = SRS(k=self.k, g1_powers=None, g2=G2_GEN, s_g2=g2_mul(tau, G2_GEN),
                  g1=(1, 2))
        return ParamsKZG(srs=srs)

    def gen_evm_verifier(self) -> str:
        """Solidity verifier source for this circuit (base.rs:251-271).
        Needs only the vk + host G2 points — never loads the pk arrays."""
        from ..evm.solidity import gen_evm_verifier

        vk = self.load_vk()
        return gen_evm_verifier(self.verifier_params(), vk, num_instances=15,
                                multiopen=self.multiopen)

    def _evm_bytecode(self) -> bytes:
        """Runtime bytecode of the generated verifier, cached per vk under
        params_dir (the reference re-runs solc each time, base.rs:218; the
        cache keeps `verify --evm` interactive)."""
        from ..evm.solc import compile_solidity

        path = os.path.join(self.params_dir, f"evm_verifier_k{self.k}_{self.multiopen}.bin")
        if os.path.exists(path):
            try:
                with open(path, "rb") as f:
                    return f.read()
            except OSError:
                pass
        code = compile_solidity(self.gen_evm_verifier())
        os.makedirs(self.params_dir, exist_ok=True)
        with open(path, "wb") as f:
            f.write(code)
        return code

    def verify(self, inp_instances: list[int], proof: bytes, evm: bool = False) -> bool:
        """Host verify against the vk of the params dir. evm=True compiles
        the generated Solidity verifier and executes it on the proof
        calldata, like the reference's verify path (bin/src/main.rs:233-238:
        gen_evm_verifier -> compile_solidity -> deploy_and_call)."""
        if evm:
            from ..evm.calldata import encode_calldata
            from ..evm.interp import EvmRevert, deploy_and_call

            code = self._evm_bytecode()
            try:
                out = deploy_and_call(code, encode_calldata(inp_instances, proof))
            except EvmRevert:
                return False
            return out == b"\x01"
        vk = self.load_vk()
        return verify_proof(self.verifier_params(), vk, [inp_instances], proof,
                            transcript_kind=self.transcript_kind,
                            multiopen=self.multiopen)
