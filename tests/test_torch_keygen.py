"""Port vs reference: the constraint system, keygen, the lookup permute,
the opening plan and SHPLONK.

Each circuit of ``zkdcap_tpu_torch/testdata/circuits.py`` is built once over
each package's ``cs`` module. Canonical bytes, queries, permutation cycles,
the opening plan and every array and commitment of the pk must equal the
reference's; a pk carried over from the reference must prove the
reference's bytes.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from zkdcap_tpu.commit import ParamsKZG as JParamsKZG  # noqa: E402
from zkdcap_tpu.commit import gen_srs as j_gen_srs  # noqa: E402
from zkdcap_tpu.fields.params import NUM_LIMBS  # noqa: E402
from zkdcap_tpu.plonk import cs as jcs  # noqa: E402
from zkdcap_tpu.plonk import keygen as jkeygen  # noqa: E402
from zkdcap_tpu.plonk.prover import _evals_query_plan, _permute_lookup_pair_rows  # noqa: E402
from zkdcap_tpu_torch import interop  # noqa: E402
from zkdcap_tpu_torch.commit import ParamsKZG, gen_srs  # noqa: E402
from zkdcap_tpu_torch.commit.shplonk import (  # noqa: E402
    ProverQuery, VerifierQuery, shplonk_open, shplonk_verify)
from zkdcap_tpu_torch.fields import BN254_FR, mont  # noqa: E402
from zkdcap_tpu_torch.plonk import cs as tcs  # noqa: E402
from zkdcap_tpu_torch.plonk.keygen import collect_queries, keygen, permutation_mappings  # noqa: E402
from zkdcap_tpu_torch.plonk.prover import create_proof, evals_query_plan, lookup_permute  # noqa: E402
from zkdcap_tpu_torch.poly.ops import poly_eval  # noqa: E402
from zkdcap_tpu_torch.testdata.circuits import REFERENCE_CASES  # noqa: E402
from zkdcap_tpu_torch.transcript import TranscriptReader, TranscriptWriter  # noqa: E402

FIXTURE = ROOT / "zkdcap_tpu_torch" / "testdata" / "reference_proofs.json"
CIRCUITS = {name: case[0] for name, case in REFERENCE_CASES.items()}
R = BN254_FR.p


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def keys(tmp_path_factory):
    """(reference circuit, pk) and (port circuit, params, pk) per name,
    built on first use."""
    jdir = str(tmp_path_factory.mktemp("jax_srs"))
    tdir = str(tmp_path_factory.mktemp("port_srs"))
    cache = {}

    def get(name):
        if name not in cache:
            jc, tc = CIRCUITS[name](jcs), CIRCUITS[name](tcs)
            jpk = jkeygen.keygen(JParamsKZG(srs=j_gen_srs(jc.k, cache_dir=jdir)),
                                 jc.cs, jc.fixed_values)
            params = ParamsKZG(srs=gen_srs(tc.k, cache_dir=tdir, device="cpu"))
            cache[name] = (jc, jpk, tc, params, keygen(params, tc.cs, tc.fixed_values, device="cpu"))
        return cache[name]

    return get


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_constraint_system_and_plans(name):
    jc, tc = CIRCUITS[name](jcs), CIRCUITS[name](tcs)
    n = 1 << jc.k
    assert tc.cs.canonical_bytes() == jc.cs.canonical_bytes()
    assert collect_queries(tc.cs) == jkeygen.collect_queries(jc.cs)
    for attr in ("extended_k", "usable_rows"):
        assert getattr(tc.cs, attr)(jc.k if attr == "extended_k" else n) == \
            getattr(jc.cs, attr)(jc.k if attr == "extended_k" else n)
    assert tc.cs.quotient_pieces() == jc.cs.quotient_pieces()
    assert evals_query_plan(tc.cs, n) == _evals_query_plan(jc.cs, n)
    assert np.array_equal(permutation_mappings(tc.cs, n), jkeygen.permutation_mappings(jc.cs, n))


def test_permutation_cycles_of_random_copies():
    """Random copy graphs (chains, stars, repeats) against the reference's
    union-find cycles."""
    n = 32
    copies = np.random.default_rng(11).integers(0, [4, n, 4, n], size=(60, 4))
    built = []
    for mod in (jcs, tcs):
        cs = mod.ConstraintSystem()
        cols = [cs.advice_column() for _ in range(3)] + [cs.fixed_column()]
        for a, ra, b, rb in copies:
            cs.copy((cols[a], int(ra)), (cols[b], int(rb)))
        built.append(cs)
    assert np.array_equal(permutation_mappings(built[1], n),
                          jkeygen.permutation_mappings(built[0], n))


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_keygen_matches_reference(keys, name):
    jc, jpk, tc, params, pk = keys(name)
    assert pk.vk.fixed_commitments == jpk.vk.fixed_commitments
    assert pk.vk.permutation_commitments == jpk.vk.permutation_commitments
    assert pk.vk.transcript_repr() == jpk.vk.transcript_repr()
    for key in interop.PK_LISTS:
        got, want = getattr(pk, key), getattr(jpk, key)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert np.array_equal(interop.to_numpy(g), np.asarray(w)), key
    for key in interop.PK_ARRAYS:
        assert np.array_equal(interop.to_numpy(getattr(pk, key)), np.asarray(getattr(jpk, key))), key


def test_carried_over_pk_proves_reference_bytes(keys):
    """The reference's pk, carried across, isolates the prover from keygen."""
    jc, jpk, tc, params, _ = keys("toy")
    arrays = {key: [np.asarray(a) for a in getattr(jpk, key)] for key in interop.PK_LISTS}
    arrays.update((key, np.asarray(getattr(jpk, key))) for key in interop.PK_ARRAYS)
    pk = interop.proving_key_from_numpy(tc.cs, jc.k, arrays, jpk.vk.fixed_commitments,
                                        jpk.vk.permutation_commitments, device="cpu")
    advice = [mont.encode_ints(BN254_FR, col, device="cpu") for col in tc.advice_values]
    fixture = json.loads(FIXTURE.read_text())["toy"]
    proof = create_proof(params, pk, advice, tc.instances, TranscriptWriter("blake2b"),
                         blinding_seed=fixture["seed"].encode(), device="cpu")
    assert proof.hex() == fixture["proofs"]["blake2b"]


def test_unported_options_raise(keys):
    """A mesh must be a ``parallel.Mesh``."""
    _, _, tc, params, pk = keys("toy")
    with pytest.raises(TypeError, match="Mesh"):
        create_proof(params, pk, [], tc.instances, TranscriptWriter(), device="cpu",
                     mesh=object())


# --- the lookup permute: the cases of tests/test_lookup_permute.py ----------

K = 6
N = 1 << K
U = N - 7


def _rows(rng, values):
    out = np.zeros((N, NUM_LIMBS), np.uint32)
    for i, v in enumerate(values):
        out[i, 0] = v & 0xFFFF
        out[i, 1] = (v >> 16) & 0xFFFF
    out[:, 2] = rng.integers(0, 3, size=N)
    out[len(values):] = rng.integers(0, 1 << 16, size=(N - len(values), NUM_LIMBS))
    return out


def _permute_cases():
    rng = np.random.default_rng(7)
    table_vals = list(range(16)) * (U // 16) + list(range(U % 16))
    in_vals = [int(v) for v in rng.choice(np.arange(16), size=U)]
    s_std = _rows(rng, table_vals)
    a_std = _rows(rng, in_vals)
    a_std[:U] = s_std[rng.integers(0, U, size=U)]
    yield "drawn", a_std, s_std
    s_std = np.tile(np.arange(NUM_LIMBS, dtype=np.uint32)[None] % 7, (N, 1))
    yield "all-equal", s_std.copy(), s_std
    rng = np.random.default_rng(12)
    s_std = _rows(rng, [0] * U)  # degenerate table: few distinct rows
    yield "degenerate", s_std[rng.integers(0, U, size=N)], s_std


@pytest.mark.parametrize("case", ["drawn", "all-equal", "degenerate"])
def test_lookup_permute_matches_host(case):
    _, a_std, s_std = next(c for c in _permute_cases() if c[0] == case)
    ao, sp = _permute_lookup_pair_rows(a_std[:U], s_std[:U])
    got_ao, got_sp = lookup_permute(interop.to_torch(a_std, "cpu"), interop.to_torch(s_std, "cpu"), U)
    assert np.array_equal(got_ao.numpy(), ao) and np.array_equal(got_sp.numpy(), sp)


def test_lookup_permute_missing_value_raises():
    rng = np.random.default_rng(9)
    s_std = _rows(rng, list(range(8)) * (U // 8 + 1))
    a_std = s_std.copy()
    a_std[3, 0] = 0xBEEF
    a_std[3, 2] = 9
    with pytest.raises(ValueError):
        _permute_lookup_pair_rows(a_std[:U], s_std[:U])
    with pytest.raises(ValueError, match="not in table"):
        lookup_permute(interop.to_torch(a_std, "cpu"), interop.to_torch(s_std, "cpu"), U)


def test_shplonk_round_trip(tmp_path):
    params = ParamsKZG(srs=gen_srs(4, cache_dir=str(tmp_path), device="cpu"))
    rng = np.random.default_rng(4)
    polys = [mont.encode_ints(BN254_FR, [int(v) for v in rng.integers(0, 1 << 60, 16)],
                              device="cpu") for _ in range(3)]
    x, w = 0x5EED, BN254_FR.nth_root_of_unity(4)
    points = {"a": [x, x * w % R], "b": [x], "c": [x, x * w % R]}
    queries = [ProverQuery(name, polys["abc".index(name)], pt)
               for name, pts in points.items() for pt in pts]
    tw = TranscriptWriter()
    shplonk_open(params, tw, queries)
    proof = tw.finalize()
    commits = params.commit_many(polys)
    vqs = [VerifierQuery(q.name, commits["abc".index(q.name)], q.point,
                         poly_eval(BN254_FR, q.poly, q.point)) for q in queries]
    assert shplonk_verify(params, TranscriptReader(proof), vqs)
    vqs[1].eval = (vqs[1].eval + 1) % R
    assert not shplonk_verify(params, TranscriptReader(proof), vqs)
