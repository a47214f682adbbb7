"""The fixture of reference proofs is current.

``zkdcap_tpu_torch/testdata/reference_proofs.json`` holds the JAX package's
proofs of the circuits of ``REFERENCE_CASES`` (the toy circuit of
``tests/test_plonk_e2e.py`` under the blake2b, poseidon and keccak
transcripts, and the small flex-gate circuit) under fixed blinding seeds,
with the SHPLONK multiopen (``proofs``) and with GWC (``gwc_proofs``).
The port's CPU tests and ``chip_smoke.py`` hold the port's proofs to these
bytes; this test proves the circuits again with
``zkdcap_tpu.plonk.prover.create_proof`` and requires the file to be equal,
so that it cannot drift from the reference.

``zkdcap_tpu_torch/testdata/p256_proof.json`` holds the JAX package's proof
of the P-256 ECDSA circuit on the reference test vector, made through the
steps of ``zkdcap_tpu.runtime.prover.ECDSAProver.create_proof`` under a fixed
blinding seed (``p256_fixture``), under the blake2b transcript (``proof``)
and under the keccak transcript of the EVM verifier (``proof_keccak``).
``chip_smoke.py`` holds the port's proofs of the same circuit to them;
regenerating them takes the JAX package's CPU path far beyond tier-1's
budget, so their tests are marked ``slow``.

Regenerate the fixtures after a deliberate change of the proof format with
``JAX_PLATFORMS=cpu python tests/test_torch_reference_proofs.py`` (the small
proofs) and ``JAX_PLATFORMS=cpu python tests/test_torch_reference_proofs.py
p256`` (the P-256 proof) and ``... p256_evm`` (only its keccak proof,
``proof_keccak``); ``... dcap``, ``... cert_chain`` and ``... quote``
make the DCAP fixture and the JAX keygen's vks of the cert-chain and quote
circuits (``testdata/{cert_chain,quote}_vk.json``), and ``... card
build/chip_smoke.json`` adds the card's proofs of a ``chip_smoke.py`` run
to those three files and the card's GWC keccak proof of the P-256 circuit to
``p256_proof.json`` (``CARD_KEYS``), which later card runs and the CPU tests
hold to.
"""

import contextlib
import json
import sys
import tempfile
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from zkdcap_tpu.commit import ParamsKZG as JParamsKZG  # noqa: E402
from zkdcap_tpu.commit import gen_srs as j_gen_srs  # noqa: E402
from zkdcap_tpu.fields import BN254_FR as J_FR  # noqa: E402
from zkdcap_tpu.fields import mont as jmont  # noqa: E402
from zkdcap_tpu.plonk import cs as jcs  # noqa: E402
from zkdcap_tpu.plonk.keygen import keygen as j_keygen  # noqa: E402
from zkdcap_tpu.plonk.prover import create_proof as j_create_proof  # noqa: E402
from zkdcap_tpu.plonk.verifier import verify_proof as j_verify_proof  # noqa: E402
from zkdcap_tpu.transcript import TranscriptWriter as JTranscriptWriter  # noqa: E402
from zkdcap_tpu_torch.testdata.circuits import REFERENCE_CASES, padded_advice  # noqa: E402

FIXTURE = ROOT / "zkdcap_tpu_torch" / "testdata" / "reference_proofs.json"
P256_FIXTURE = ROOT / "zkdcap_tpu_torch" / "testdata" / "p256_proof.json"
# the P-256 fixture's circuit size and blinding seed
P256_K, P256_LOOKUP_BITS, P256_SEED = 18, 17, b"p256-reference-vector"
DCAP_FIXTURE = ROOT / "zkdcap_tpu_torch" / "testdata" / "dcap_proof.json"
# the DCAP fixture's circuit size and blinding seed
DCAP_K, DCAP_SEED = 17, b"dcap-demo-input"
# the fixtures of the cert-chain and quote circuits: the JAX keygen's vk
CIRCUIT_FIXTURES = {
    "cert_chain": ROOT / "zkdcap_tpu_torch" / "testdata" / "cert_chain_vk.json",
    "quote": ROOT / "zkdcap_tpu_torch" / "testdata" / "quote_vk.json",
}
# keys that the card's runs add to a fixture (its proofs there, with their
# seeds); the JAX package's CPU path does not make them
CARD_KEYS = ("card", "card_gwc", "card_gwc_keccak")
# the P-256 fixture's keys that ``... p256_evm`` writes: the keccak proof
P256_EVM_KEYS = ("proof_keccak", "seconds_keccak")


def reference_fixture(srs_dir: str) -> dict:
    """The JAX package's proofs of every case, in the fixture's layout."""
    out = {}
    for name, (build, seed, kinds) in REFERENCE_CASES.items():
        circ = build(jcs)
        params = JParamsKZG(srs=j_gen_srs(circ.k, cache_dir=srs_dir))
        pk = j_keygen(params, circ.cs, circ.fixed_values)
        advice = [jmont.encode_ints(J_FR, col) for col in padded_advice(circ)]

        def prove(kind, multiopen):
            return j_create_proof(params, pk, advice, circ.instances, JTranscriptWriter(kind),
                                  blinding_seed=seed, multiopen=multiopen).hex()

        out[name] = {"k": circ.k, "seed": seed.decode(), "instances": circ.instances,
                     "proofs": {kind: prove(kind, "shplonk") for kind in kinds},
                     "gwc_proofs": {kind: prove(kind, "gwc") for kind in kinds}}
    return out


@contextlib.contextmanager
def _dev_tau_commitments():
    """Commit with the dev SRS's known tau: its G1 points are [tau^i]G, so
    the MSM of a poly's coefficients against them is [f(tau)]G, one Horner
    sum and one scalar multiplication. Inside the block the JAX package's
    ``ParamsKZG.commit``/``commit_many`` compute exactly that, in place of
    the device MSM, whose CPU path is far too slow for a k = 18 proof; the
    group elements, and with them the proof bytes, are the same."""
    from zkdcap_tpu.commit.kzg import ParamsKZG
    from zkdcap_tpu.commit.srs import _dev_tau
    from zkdcap_tpu.curves import BN254_G1 as J_G1

    import numpy as np

    tau, r = _dev_tau(), J_FR.p

    def commit(self, coeffs, mesh=None):
        std = np.asarray(jmont.from_mont(J_FR, coeffs), dtype=np.uint32).astype("<u2")
        buf = std.tobytes()
        acc = 0
        for i in range(std.shape[0] - 1, -1, -1):
            acc = (acc * tau + int.from_bytes(buf[32 * i : 32 * i + 32], "little")) % r
        return J_G1.mul(acc, J_G1.g)

    saved = ParamsKZG.commit, ParamsKZG.commit_many
    ParamsKZG.commit = commit
    ParamsKZG.commit_many = lambda self, cols, mesh=None: [commit(self, c) for c in cols]
    try:
        yield
    finally:
        ParamsKZG.commit, ParamsKZG.commit_many = saved


@contextlib.contextmanager
def _eager_quotient():
    """Run the JAX package's quotient program op by op: compiled as one XLA
    program for the CPU it asks for about 128 GB of host memory at k = 18;
    op by op it holds only the arrays its Python code keeps alive. Same
    operations, same values."""
    import jax

    from zkdcap_tpu.plonk import prover as jprover

    compiled = jprover._compute_quotient

    def eager(*args, **kwargs):
        with jax.disable_jit():
            return compiled(*args, **kwargs)

    jprover._compute_quotient = eager
    try:
        yield
    finally:
        jprover._compute_quotient = compiled


def p256_fixture(params_dir: str, k: int = P256_K, lookup_bits: int = P256_LOOKUP_BITS,
                 seed: bytes = P256_SEED, evm: bool = False) -> dict:
    """The JAX package's proof of the reference test vector, through the
    steps of ``ECDSAProver.create_proof`` (keygen, tape replay, witness fill,
    encode, ``create_proof``; ``evm`` proves under the keccak transcript, as
    ``create_proof(evm=True)`` does) with ``blinding_seed`` passed to the prover,
    the commitments taken from the dev tau (``_dev_tau_commitments``) and
    the quotient evaluated op by op (``_eager_quotient``). At
    k = 18 the keygen's commitments must equal ``assets/vk_k18.json``, which
    the JAX package's device MSM made. The pk stays in memory."""
    from zkdcap_tpu.circuits.p256_ecdsa import ECDSAInput, trace_inputs
    from zkdcap_tpu.runtime.prover import ECDSAProver
    from zkdcap_tpu.witness.native import eval_tape_raw

    from test_p256_circuit import REF_MSGHASH, REF_PUBKEY, REF_SIG

    import jax.numpy as jnp
    import numpy as np

    inp = ECDSAInput.from_hex(REF_MSGHASH, REF_SIG, REF_PUBKEY)
    prover = ECDSAProver(params_dir=params_dir, k=k, lookup_bits=lookup_bits)
    prover._params = prover.verifier_params()  # no G1 powers: the commitments use the tau
    t0 = time.perf_counter()
    with _dev_tau_commitments(), _eager_quotient():
        builder, compiled, sctx = prover._compile()
        pk = j_keygen(prover._params, compiled.cs, compiled.fixed_values, prover.transcript_kind)
        if k == 18:
            vk = json.loads((ROOT / "assets" / "vk_k18.json").read_text())
            assert [list(c) for c in pk.vk.fixed_commitments] == vk["fixed_commitments"]
            assert [list(c) for c in pk.vk.permutation_commitments] == \
                vk["permutation_commitments"]
        prover._pk, prover._builder, prover._compiled = pk, builder, compiled
        raw = eval_tape_raw(prover._get_tape(), trace_inputs(inp))
        assert raw is not None, "the JAX package's native witness evaluator is not built"
        limbs = builder.witness_limbs(compiled, sctx, raw)
        instances = [[int.from_bytes(raw[c].tobytes(), "little") for c in sctx.instance_cells]]
        assert instances[0] == inp.as_instances()
        adv = jmont.to_mont(J_FR, jnp.asarray(limbs.astype(np.uint32)))
        kind = "keccak" if evm else prover.transcript_kind
        proof = j_create_proof(prover._params, pk, [adv[i] for i in range(adv.shape[0])],
                               instances, JTranscriptWriter(kind), blinding_seed=seed)
    assert j_verify_proof(prover._params, pk.vk, instances, proof, transcript_kind=kind)
    return {"k": k, "lookup_bits": lookup_bits, "seed": seed.decode(),
            "transcript": kind, "msghash": REF_MSGHASH, "signature": REF_SIG,
            "pubkey": REF_PUBKEY, "instances": instances,
            "proof": proof.hex(), "seconds": round(time.perf_counter() - t0, 1)}


def dcap_fixture(params_dir: str, k: int = DCAP_K, seed: bytes = DCAP_SEED) -> dict:
    """The JAX package's proof of the DCAP circuit on its demo input, through
    the steps of ``CircuitProver.create_proof`` (keygen, tape replay, witness
    fill, encode, ``create_proof``) with ``blinding_seed`` passed to the
    prover, the commitments taken from the dev tau and the quotient evaluated
    op by op, as ``p256_fixture`` does. The circuit has no public instances;
    the fixture also holds the vk's commitments (``vk``, as the prover's
    ``dcap_vk_k17.json`` holds them), which no committed asset has for this
    circuit."""
    from zkdcap_tpu.runtime.dcap_prover import DcapProver
    from zkdcap_tpu.witness.native import eval_tape_raw

    import jax.numpy as jnp
    import numpy as np

    prover = DcapProver(params_dir=params_dir, k=k)
    prover._params = prover.verifier_params()  # no G1 powers: the commitments use the tau
    inp = prover.structure_input()
    t0 = time.perf_counter()
    with _dev_tau_commitments(), _eager_quotient():
        builder, compiled = prover._compile()
        pk = j_keygen(prover._params, compiled.cs, compiled.fixed_values, prover.transcript_kind)
        prover._pk, prover._builder, prover._compiled = pk, builder, compiled
        raw = eval_tape_raw(prover._get_tape(), prover.trace_inputs(inp))
        assert raw is not None, "the JAX package's native witness evaluator is not built"
        limbs = builder.witness_limbs(compiled, prover._structure_ctx, raw)
        adv = jmont.to_mont(J_FR, jnp.asarray(limbs.astype(np.uint32)))
        proof = j_create_proof(prover._params, pk, [adv[i] for i in range(adv.shape[0])],
                               [], JTranscriptWriter(prover.transcript_kind),
                               blinding_seed=seed)
    assert j_verify_proof(prover._params, pk.vk, [], proof)
    return {"k": k, "lookup_bits": prover.lookup_bits, "seed": seed.decode(),
            "transcript": prover.transcript_kind, "instances": [],
            "vk": prover._vk_data(pk.vk),
            "proof": proof.hex(), "seconds": round(time.perf_counter() - t0, 1)}


def structure_json(v):
    """A structure input (a dataclass of bytes, ints, tuples and lists) as
    JSON: bytes as hex, ints as 0x-hex."""
    import dataclasses

    if dataclasses.is_dataclass(v):
        return {f.name: structure_json(getattr(v, f.name)) for f in dataclasses.fields(v)}
    if isinstance(v, bytes):
        return v.hex()
    if isinstance(v, int):
        return hex(v)
    return [structure_json(x) for x in v]


def circuit_structure(name: str, mod_root: str = "zkdcap_tpu"):
    """The structure input that the fixture of circuit `name` was made for,
    from either package (`mod_root`): the Intel chain that the JAX CLI's
    ``cert-chain-prove`` proves, and ``quote-prove``'s demo quote."""
    import importlib

    if name == "cert_chain":
        return importlib.import_module(f"{mod_root}.circuits.cert_chain").make_intel_demo_chain()
    return importlib.import_module(f"{mod_root}.circuits.quote").make_demo_quote()


def circuit_vk_fixture(name: str, params_dir: str, k: int = 17) -> dict:
    """The JAX package's keygen of the cert-chain or quote circuit on its
    structure input (``circuit_structure``), with the commitments taken from
    the dev tau (``_dev_tau_commitments``): the vk commitments in the layout
    of the prover's ``{NAME}_vk_k{k}.json`` (``vk``), with k, the lookup bits
    and the structure input. The card's proofs, which these vks verify, are
    added under ``CARD_KEYS``."""
    from zkdcap_tpu.runtime.chain_provers import CertChainProver, QuoteProver

    cls = CertChainProver if name == "cert_chain" else QuoteProver
    structure = circuit_structure(name)
    prover = cls(params_dir=params_dir, k=k, structure=structure)
    prover._params = prover.verifier_params()  # no G1 powers: the commitments use the tau
    t0 = time.perf_counter()
    with _dev_tau_commitments():
        _, compiled = prover._compile()
        pk = j_keygen(prover._params, compiled.cs, compiled.fixed_values, prover.transcript_kind)
    return {"k": k, "lookup_bits": prover.lookup_bits, "transcript": prover.transcript_kind,
            "structure": structure_json(structure), "vk": prover._vk_data(pk.vk),
            "seconds": round(time.perf_counter() - t0, 1)}


def add_card_proofs(report: dict) -> None:
    """Write the card's proofs from a ``chip_smoke.py`` report
    (``build/chip_smoke.json``) into the fixtures, with their seeds: the
    cert-chain and quote proofs as ``card``, the GWC DCAP proof as
    ``card_gwc``, the keccak GWC P-256 proof as ``card_gwc_keccak``."""
    targets = [(CIRCUIT_FIXTURES[name], "card", report[name]) for name in CIRCUIT_FIXTURES]
    targets.append((DCAP_FIXTURE, "card_gwc", report["gwc"]))
    targets.append((P256_FIXTURE, "card_gwc_keccak", report["service"]["evm"]["gwc"]))
    for path, key, step in targets:
        fixture = json.loads(path.read_text())
        fixture[key] = {"seed": step["seed"], "proof": step["proof"]}
        path.write_text(json.dumps(fixture, indent=1) + "\n")
        print(f"wrote {key} into {path}")


def _without(d: dict, keys) -> dict:
    return {k: v for k, v in d.items() if k not in keys}


def test_fixture_is_current(tmp_path):
    assert json.loads(FIXTURE.read_text()) == reference_fixture(str(tmp_path))


@pytest.mark.slow
def test_p256_fixture_is_current(tmp_path):
    want = json.loads(P256_FIXTURE.read_text())
    got = p256_fixture(str(tmp_path), want["k"], want["lookup_bits"], want["seed"].encode())
    assert _without(got, ("seconds",)) == _without(want, ("seconds",) + P256_EVM_KEYS + CARD_KEYS)


@pytest.mark.slow
def test_p256_evm_fixture_is_current(tmp_path):
    want = json.loads(P256_FIXTURE.read_text())
    got = p256_fixture(str(tmp_path), want["k"], want["lookup_bits"], want["seed"].encode(),
                       evm=True)
    assert got["transcript"] == "keccak" and got["instances"] == want["instances"]
    assert got["proof"] == want["proof_keccak"]


@pytest.mark.slow
def test_dcap_fixture_is_current(tmp_path):
    want = json.loads(DCAP_FIXTURE.read_text())
    got = dcap_fixture(str(tmp_path), want["k"], want["seed"].encode())
    assert _without(got, ("seconds",)) == _without(want, ("seconds",) + CARD_KEYS)


@pytest.mark.slow
def test_cert_chain_fixture_is_current(tmp_path):
    want = json.loads(CIRCUIT_FIXTURES["cert_chain"].read_text())
    got = circuit_vk_fixture("cert_chain", str(tmp_path), want["k"])
    assert _without(got, ("seconds",)) == _without(want, ("seconds",) + CARD_KEYS)


@pytest.mark.slow
def test_quote_fixture_is_current(tmp_path):
    want = json.loads(CIRCUIT_FIXTURES["quote"].read_text())
    got = circuit_vk_fixture("quote", str(tmp_path), want["k"])
    assert _without(got, ("seconds",)) == _without(want, ("seconds",) + CARD_KEYS)


if __name__ == "__main__":
    if sys.argv[1:2] == ["card"]:
        add_card_proofs(json.loads(Path(sys.argv[2]).read_text()))
        sys.exit(0)
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, str(ROOT / "tests"))
    with tempfile.TemporaryDirectory() as tmp:
        if sys.argv[1:2] == ["p256"]:
            k = int(sys.argv[2]) if len(sys.argv) > 2 else P256_K
            fixture = p256_fixture(tmp, k, min(P256_LOOKUP_BITS, k - 1))
            if P256_FIXTURE.exists():  # keep the keccak and the card's proofs
                old = json.loads(P256_FIXTURE.read_text())
                fixture.update((key, old[key]) for key in P256_EVM_KEYS + CARD_KEYS if key in old)
            P256_FIXTURE.write_text(json.dumps(fixture, indent=1) + "\n")
            print(f"wrote {P256_FIXTURE} in {fixture['seconds']} s")
        elif sys.argv[1:2] == ["p256_evm"]:
            fixture = json.loads(P256_FIXTURE.read_text())
            got = p256_fixture(tmp, fixture["k"], fixture["lookup_bits"],
                               fixture["seed"].encode(), evm=True)
            assert got["instances"] == fixture["instances"]
            fixture["proof_keccak"], fixture["seconds_keccak"] = got["proof"], got["seconds"]
            P256_FIXTURE.write_text(json.dumps(fixture, indent=1) + "\n")
            print(f"wrote proof_keccak into {P256_FIXTURE} in {got['seconds']} s")
        elif sys.argv[1:2] == ["dcap"]:
            fixture = dcap_fixture(tmp)
            DCAP_FIXTURE.write_text(json.dumps(fixture, indent=1) + "\n")
            print(f"wrote {DCAP_FIXTURE} in {fixture['seconds']} s")
        elif sys.argv[1:2] in (["cert_chain"], ["quote"]):
            path = CIRCUIT_FIXTURES[sys.argv[1]]
            fixture = circuit_vk_fixture(sys.argv[1], tmp)
            if path.exists():  # keep the card's proofs
                old = json.loads(path.read_text())
                fixture.update((k, old[k]) for k in CARD_KEYS if k in old)
            path.write_text(json.dumps(fixture, indent=1) + "\n")
            print(f"wrote {path} in {fixture['seconds']} s")
        else:
            FIXTURE.write_text(json.dumps(reference_fixture(tmp), indent=1) + "\n")
            print(f"wrote {FIXTURE}")
