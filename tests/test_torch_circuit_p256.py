"""Port vs reference: the P-256 ECDSA circuit's host stack.

The port's copies of ``chips/``, ``circuits/p256_ecdsa.py`` and the builder
must lay the circuit out exactly as the JAX package does: the pinning, the
vk and every proof depend on it. Traces of the sample input and of the
reference test vector, the k = 18 compile (constraint system, fixed columns,
pinning, equal to ``assets/pinning_k18.json``), the permutation mappings of
the real copy graph (the host half of the vk) and the witness fill are held
to the JAX package's, one module-scoped trace and compile per package.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from zkdcap_tpu.chips import CircuitBuilder as JBuilder
from zkdcap_tpu.circuits import p256_ecdsa as jp256
from zkdcap_tpu.plonk.keygen import VerifyingKey as JVerifyingKey
from zkdcap_tpu.plonk.keygen import permutation_mappings as j_permutation_mappings
from zkdcap_tpu.runtime.prover import SAMPLE_INPUT as J_SAMPLE
from zkdcap_tpu_torch.chips import CircuitBuilder as TBuilder
from zkdcap_tpu_torch.circuits import p256_ecdsa as tp256
from zkdcap_tpu_torch.plonk.keygen import VerifyingKey as TVerifyingKey
from zkdcap_tpu_torch.plonk.keygen import permutation_mappings as t_permutation_mappings
from zkdcap_tpu_torch.runtime.prover import SAMPLE_INPUT as T_SAMPLE
from zkdcap_tpu_torch.witness.tape import cells_u16

from test_p256_circuit import REF_MSGHASH, REF_PUBKEY, REF_SIG

ASSETS = Path(__file__).resolve().parent.parent / "assets"
K, LOOKUP_BITS = 18, 17
FIELDS = ("cells", "gate_offsets", "copies", "lookup_cells", "instance_cells",
          "constant_cells", "spread_pairs")


def _plain_copies(cs):
    """Copy constraints as ((kind, index, row), (kind, index, row)) pairs:
    the two packages' Column classes differ."""
    return [tuple((c.kind, c.index, r) for c, r in pair) for pair in cs.copies]


def _ref_input(mod):
    return mod.ECDSAInput.from_hex(REF_MSGHASH, REF_SIG, REF_PUBKEY)


@pytest.fixture(scope="module")
def jax_side():
    trace = jp256.build_ecdsa_trace(J_SAMPLE, LOOKUP_BITS)
    builder = JBuilder(K, lookup_bits=LOOKUP_BITS)
    return {"sample": trace, "ref": jp256.build_ecdsa_trace(_ref_input(jp256), LOOKUP_BITS),
            "builder": builder, "compiled": builder.compile(trace)}


@pytest.fixture(scope="module")
def port_side():
    trace = tp256.build_ecdsa_trace(T_SAMPLE, LOOKUP_BITS)
    builder = TBuilder(K, lookup_bits=LOOKUP_BITS)
    return {"sample": trace, "ref": tp256.build_ecdsa_trace(_ref_input(tp256), LOOKUP_BITS),
            "builder": builder, "compiled": builder.compile(trace)}


def test_inputs_and_instances_match():
    assert T_SAMPLE == tp256.ECDSAInput(**vars(J_SAMPLE))
    inp = _ref_input(tp256)
    assert inp.verify_native() and T_SAMPLE.verify_native()
    assert inp.as_instances() == _ref_input(jp256).as_instances()
    assert tp256.trace_inputs(inp) == jp256.trace_inputs(_ref_input(jp256))


@pytest.mark.parametrize("which", ["sample", "ref"])
def test_trace_matches_reference(jax_side, port_side, which):
    j, t = jax_side[which], port_side[which]
    for name in FIELDS:
        assert getattr(t, name) == getattr(j, name), name


def test_compile_matches_reference(jax_side, port_side):
    j, t = jax_side["compiled"], port_side["compiled"]
    assert t.cs.canonical_bytes() == j.cs.canonical_bytes()
    assert (t.cs.num_advice, t.cs.num_fixed, t.cs.num_instance) == \
        (j.cs.num_advice, j.cs.num_fixed, j.cs.num_instance)
    assert [str(g) for g in t.cs.gates] == [str(g) for g in j.cs.gates]
    assert _plain_copies(t.cs) == _plain_copies(j.cs)
    assert t.fixed_values == j.fixed_values
    assert t.pinning.to_json() == j.pinning.to_json()
    assert json.loads(t.pinning.to_json()) == json.loads((ASSETS / "pinning_k18.json").read_text())
    # the vk's transcript hash over the committed vk's commitments
    vk = json.loads((ASSETS / "vk_k18.json").read_text())
    fixed = [tuple(c) if c else None for c in vk["fixed_commitments"]]
    perm = [tuple(c) if c else None for c in vk["permutation_commitments"]]
    assert TVerifyingKey(K, t.cs, fixed, perm).transcript_repr() == \
        JVerifyingKey(K, j.cs, fixed, perm).transcript_repr()


def test_permutation_mappings_match_reference(jax_side, port_side):
    n = 1 << K
    got = t_permutation_mappings(port_side["compiled"].cs, n)
    want = j_permutation_mappings(jax_side["compiled"].cs, n)
    assert got.shape == want.shape and np.array_equal(got, want)


def test_witness_fill_matches_reference(jax_side, port_side):
    raw = cells_u16(port_side["ref"].cells)
    got = port_side["builder"].witness_limbs(port_side["compiled"], port_side["sample"], raw)
    want = jax_side["builder"].witness_limbs(jax_side["compiled"], jax_side["sample"], raw)
    assert np.array_equal(got, want)
    assert port_side["builder"].instance_values(port_side["ref"]) == \
        jax_side["builder"].instance_values(jax_side["ref"]) == [_ref_input(tp256).as_instances()]
