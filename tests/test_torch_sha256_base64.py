"""Port vs reference: the SHA-256 and base64 chips and the MockProver.

The port's copies of ``chips/sha256.py`` and ``chips/base64.py`` must lay
circuits out exactly as the JAX package does (the pinning, the vk and the
proofs depend on it): traces, compiled constraint systems, fixed columns
(the spread table included) and pinnings are held to the JAX package's for
the fixed-length and the dynamic-length digest of messages of 0, 55, 56, 64
and 200 bytes and for base64 decodes. The port's ``MockProver`` (on the CPU
here) must give the JAX package's verdicts, failures included, at the K its
own chip tests use (13 for SHA-256, 10 for base64).
"""

import base64
import hashlib
import types

import pytest
import torch

from zkdcap_tpu import chips as jchips
from zkdcap_tpu.chips.base64 import Base64Chip as JBase64Chip
from zkdcap_tpu.chips.sha256 import Sha256Chip as JSha256Chip
from zkdcap_tpu.chips.sha256 import spread_int as j_spread_int
from zkdcap_tpu.plonk.mock import MockProver as JMockProver
from zkdcap_tpu_torch import chips as tchips
from zkdcap_tpu_torch.chips.base64 import Base64Chip as TBase64Chip
from zkdcap_tpu_torch.chips.sha256 import Sha256Chip as TSha256Chip
from zkdcap_tpu_torch.chips.sha256 import spread_int as t_spread_int
from zkdcap_tpu_torch.plonk.mock import MockProver as TMockProver

SHA_K, SHA_LOOKUP_BITS = 13, 12
B64_K, B64_LOOKUP_BITS = 10, 8
MAX_LEN = 200
LENGTHS = (0, 55, 56, 64, 200)
FIELDS = ("cells", "gate_offsets", "copies", "lookup_cells", "instance_cells",
          "constant_cells", "spread_pairs")

JAX = types.SimpleNamespace(chips=jchips, Sha256Chip=JSha256Chip, Base64Chip=JBase64Chip,
                            mock=lambda *a: JMockProver(*a))
PORT = types.SimpleNamespace(chips=tchips, Sha256Chip=TSha256Chip, Base64Chip=TBase64Chip,
                             mock=lambda *a: TMockProver(*a, device="cpu"))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _message(n: int) -> bytes:
    return bytes((i * 7 + 3) % 256 for i in range(n))


def sha_trace(pkg, data: bytes, dynamic: bool):
    """The chip tests' circuit: range-checked message bytes, then the
    fixed-length digest, or the dynamic one over MAX_LEN padded bytes."""
    ctx = pkg.chips.Context()
    g = pkg.chips.FlexGate(ctx)
    rc = pkg.chips.RangeChip(g, SHA_LOOKUP_BITS)
    chip = pkg.Sha256Chip(g, rc)
    vals = list(data) + [0] * (MAX_LEN - len(data)) if dynamic else list(data)
    cells = []
    for b in vals:
        c = ctx.push(b)
        rc.range_check(c, 8)
        cells.append(c)
    if dynamic:
        len_cell = ctx.push(len(data))
        rc.range_check(len_cell, 8)
        out = chip.digest_bytes_dynamic(cells, vals, len_cell, len(data), MAX_LEN)
    else:
        out = chip.digest_bytes(cells, vals)
    assert bytes(v for _, v in out) == hashlib.sha256(data).digest()
    return ctx, out


def b64_trace(pkg, text: str):
    ctx = pkg.chips.Context()
    g = pkg.chips.FlexGate(ctx)
    rc = pkg.chips.RangeChip(g, B64_LOOKUP_BITS)
    out = pkg.Base64Chip(g, rc).decode(text)
    assert bytes(v for _, v in out) == base64.b64decode(text)
    return ctx, out


def _compile(pkg, ctx, k, lookup_bits):
    builder = pkg.chips.CircuitBuilder(k, lookup_bits=lookup_bits)
    compiled = builder.compile(ctx)
    return builder, compiled


def _assert_same_trace(jctx, tctx):
    for name in FIELDS:
        assert getattr(tctx, name) == getattr(jctx, name), name


def _assert_same_circuit(jctx, tctx, k, lookup_bits):
    _assert_same_trace(jctx, tctx)
    _, jc = _compile(JAX, jctx, k, lookup_bits)
    _, tc = _compile(PORT, tctx, k, lookup_bits)
    assert tc.cs.canonical_bytes() == jc.cs.canonical_bytes()
    assert [str(g) for g in tc.cs.gates] == [str(g) for g in jc.cs.gates]
    assert tc.fixed_values == jc.fixed_values
    assert tc.pinning.to_json() == jc.pinning.to_json()
    for kind, count in (("advice", tc.cs.num_advice), ("fixed", tc.cs.num_fixed)):
        assert [tc.cs.column_name(kind, i) for i in range(count)] == \
            [jc.cs.column_name(kind, i) for i in range(count)]
    return jc, tc


def test_spread_int_matches_reference():
    for x in (0, 0b11, 0b101, 0x7FF, 0x5A5):
        assert t_spread_int(x) == j_spread_int(x)


@pytest.mark.parametrize("dynamic", [False, True], ids=["fixed", "dynamic"])
@pytest.mark.parametrize("length", LENGTHS)
def test_sha256_circuit_matches_reference(length, dynamic):
    """Traces at every length; compiles for every fixed length and for one
    dynamic length: the dynamic circuit's structure depends on MAX_LEN
    alone (the JAX package's ``tests/test_sha256_dynamic.py`` holds that),
    so its other lengths differ only in the cell values the traces hold."""
    data = _message(length)
    jctx, _ = sha_trace(JAX, data, dynamic)
    tctx, _ = sha_trace(PORT, data, dynamic)
    if dynamic and length != 55:
        _assert_same_trace(jctx, tctx)
        return
    _, tc = _assert_same_circuit(jctx, tctx, SHA_K, SHA_LOOKUP_BITS)
    # the spread table's dense/spread fixed columns are laid out
    names = " ".join(tc.cs.column_name("fixed", i) for i in range(tc.cs.num_fixed))
    assert tc.pinning.num_spread_advice > 0
    assert "spread_table.dense" in names and "spread_table.spread" in names


@pytest.mark.parametrize("text", [b"hello world!", b"hello", b"hell"])
def test_base64_circuit_matches_reference(text):
    enc = base64.b64encode(text).decode()
    jctx, _ = b64_trace(JAX, enc)
    tctx, _ = b64_trace(PORT, enc)
    _assert_same_circuit(jctx, tctx, B64_K, B64_LOOKUP_BITS)


def _verdict(pkg, ctx, k, lookup_bits):
    builder, compiled = _compile(pkg, ctx, k, lookup_bits)
    advice = builder.witness_columns(compiled, ctx)
    return [repr(f) for f in pkg.mock(k, compiled.cs, compiled.fixed_values, advice, [])
            .verify()]


@pytest.mark.parametrize("tamper", [None, 0], ids=["satisfied", "tampered-digest"])
def test_sha256_mock_verdicts_match_reference(tamper):
    verdicts = []
    for pkg in (JAX, PORT):
        ctx, out = sha_trace(pkg, b"abc", dynamic=False)
        if tamper is not None:
            ctx.cells[out[tamper][0]] = (ctx.cells[out[tamper][0]] + 1) % 256
        verdicts.append(_verdict(pkg, ctx, SHA_K, SHA_LOOKUP_BITS))
    assert verdicts[1] == verdicts[0]
    assert bool(verdicts[1]) == (tamper is not None)


@pytest.mark.parametrize("tamper", [None, 3], ids=["satisfied", "tampered-byte"])
def test_base64_mock_verdicts_match_reference(tamper):
    enc = base64.b64encode(b"attack at dawn").decode()
    verdicts = []
    for pkg in (JAX, PORT):
        ctx, out = b64_trace(pkg, enc)
        if tamper is not None:
            ctx.cells[out[tamper][0]] = (ctx.cells[out[tamper][0]] + 1) % 256
        verdicts.append(_verdict(pkg, ctx, B64_K, B64_LOOKUP_BITS))
    assert verdicts[1] == verdicts[0]
    assert bool(verdicts[1]) == (tamper is not None)
