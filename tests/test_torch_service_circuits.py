"""Shared checks of ``test_torch_cert_chain.py`` and ``test_torch_quote.py``:
a k = 17 service circuit of the port against the JAX package's. This module
holds no tests of its own.

Each side traces and compiles the circuit once a file. The port's witness
tape is recorded in a second file per circuit (``*_tape.py``), where its
native replay is held to the JAX package's cells, so that the two halves
run on two workers.
"""

import json
from pathlib import Path

import numpy as np

from zkdcap_tpu.chips import CircuitBuilder as JBuilder
from zkdcap_tpu.plonk.keygen import permutation_mappings as j_permutation_mappings
from zkdcap_tpu_torch.chips import CircuitBuilder as TBuilder
from zkdcap_tpu_torch.plonk.keygen import permutation_mappings as t_permutation_mappings
from zkdcap_tpu_torch.witness import native
from zkdcap_tpu_torch.witness.tape import cells_u16, record

ROOT = Path(__file__).resolve().parent.parent
TESTDATA = ROOT / "zkdcap_tpu_torch" / "testdata"
K, LOOKUP_BITS = 17, 16
FIELDS = ("cells", "gate_offsets", "copies", "lookup_cells", "instance_cells",
          "constant_cells", "spread_pairs")


def jax_side(build, inp) -> dict:
    ctx = build(inp, LOOKUP_BITS)
    builder = JBuilder(K, lookup_bits=LOOKUP_BITS)
    return {"trace": ctx, "builder": builder, "compiled": builder.compile(ctx)}


def port_side(build, inp) -> dict:
    ctx = build(inp, LOOKUP_BITS)
    builder = TBuilder(K, lookup_bits=LOOKUP_BITS)
    return {"trace": ctx, "builder": builder, "compiled": builder.compile(ctx)}


def check_tape(build_jax, build_port, inp_jax, inp_port, trace_inputs):
    """The tape that the port's prover records (one traced run of the
    circuit) materialises the JAX package's trace, and the port's native
    evaluator replays it on the input to the JAX package's cells."""
    jctx = build_jax(inp_jax, LOOKUP_BITS)
    tctx, tape = record(lambda tr: build_port(inp_port, LOOKUP_BITS, tracer=tr))
    for name in FIELDS:
        assert getattr(tctx, name) == getattr(jctx, name), name
    raw = native.eval_tape_raw(tape, trace_inputs)
    assert np.array_equal(raw, cells_u16(jctx.cells))


def load_fixture(name: str) -> dict:
    return json.loads((TESTDATA / f"{name}_vk.json").read_text())


def _plain_copies(cs):
    return [tuple((c.kind, c.index, r) for c, r in pair) for pair in cs.copies]


def check_trace(jax, port):
    for name in FIELDS:
        assert getattr(port["trace"], name) == getattr(jax["trace"], name), name


def check_compile(jax, port, pinning_counts):
    j, t = jax["compiled"], port["compiled"]
    pin = t.pinning
    assert (pin.num_advice, pin.num_lookup_advice, pin.num_spread_advice, pin.num_cells) == \
        pinning_counts
    assert pin.to_json() == j.pinning.to_json()
    assert t.cs.canonical_bytes() == j.cs.canonical_bytes()
    assert t.cs.extended_k(K) == j.cs.extended_k(K)
    assert [str(g) for g in t.cs.gates] == [str(g) for g in j.cs.gates]
    assert [str(lk) for lk in t.cs.lookups] == [str(lk) for lk in j.cs.lookups]
    for kind, count in (("advice", t.cs.num_advice), ("fixed", t.cs.num_fixed)):
        assert [t.cs.column_name(kind, i) for i in range(count)] == \
            [j.cs.column_name(kind, i) for i in range(count)]
    assert _plain_copies(t.cs) == _plain_copies(j.cs)
    assert t.fixed_values == j.fixed_values  # the lookup tables among them


def check_permutation_mappings(jax, port):
    n = 1 << K
    got = t_permutation_mappings(port["compiled"].cs, n)
    want = j_permutation_mappings(jax["compiled"].cs, n)
    assert got.shape == want.shape and np.array_equal(got, want)


def check_witness_fill(jax, port):
    """The witness fill from the cells (which ``check_tape`` holds the
    native replay to) is the JAX package's."""
    raw = cells_u16(jax["trace"].cells)
    got = port["builder"].witness_limbs(port["compiled"], port["trace"], raw)
    want = jax["builder"].witness_limbs(jax["compiled"], jax["trace"], raw)
    assert np.array_equal(got, want)


def cached_compile(prover, side):
    """Give a prover the module's compile in place of a new trace and
    compile, after checking that the pinning it read from its params dir is
    the one that compile made."""
    def compile_(pinning=None):
        assert pinning is not None and pinning.to_json() == side["compiled"].pinning.to_json()
        prover._structure_ctx = side["trace"]
        return side["builder"], side["compiled"]
    prover._compile = compile_


def light_prover(cls, params_dir, side, fixture, **kw):
    """A prover of either package whose params dir holds the fixture's vk
    (the JAX keygen's) and the side's pinning, on the side's compile."""
    name, k = cls.NAME, fixture["k"]
    (params_dir / f"{name}_vk_k{k}.json").write_text(json.dumps(fixture["vk"]))
    (params_dir / f"{name}_pinning_k{k}.json").write_text(side["compiled"].pinning.to_json())
    prover = cls(params_dir=str(params_dir), k=k, **kw)
    cached_compile(prover, side)
    return prover


def check_card_proof(jax, port, fixture, jcls, tcls, tmp_path, key="card", multiopen="shplonk"):
    """The JAX package's host verifier, with the JAX keygen's vk, and the
    port's verifier accept the card's committed proof and reject it with one
    byte flipped."""
    proof = bytes.fromhex(fixture[key]["proof"])
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    for cls, side, sub in ((jcls, jax, "jax"), (tcls, port, "port")):
        (tmp_path / sub).mkdir()
        prover = light_prover(cls, tmp_path / sub, side, fixture, multiopen=multiopen)
        assert prover.verify(proof), sub
        assert prover._pk is None  # the light path loads no pk
        assert not prover.verify(bytes(bad)), sub
