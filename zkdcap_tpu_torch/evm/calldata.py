"""EVM calldata encoding (snark-verifier-sdk `encode_calldata` equivalent).

Reference use: `encode_calldata(&[instances], &proof)` at bin/src/main.rs:171
(SURVEY.md §2.2 D-SDK). Layout matches snark-verifier: each public instance
as a 32-byte big-endian word, followed by the raw proof bytes — the exact
byte string the generated Solidity verifier's fallback function consumes.

Port of ``zkdcap_tpu/evm/calldata.py``.
"""

from __future__ import annotations


def encode_calldata(instances: list[int], proof: bytes) -> bytes:
    out = bytearray()
    for v in instances:
        out += int(v).to_bytes(32, "big")
    out += proof
    return bytes(out)


def decode_calldata(data: bytes, num_instances: int) -> tuple[list[int], bytes]:
    insts = [
        int.from_bytes(data[32 * i : 32 * (i + 1)], "big") for i in range(num_instances)
    ]
    return insts, data[32 * num_instances :]
