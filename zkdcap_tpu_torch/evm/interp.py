"""Minimal EVM interpreter — in-process execution harness for the generated
verifier (the reference compiles its emitted Solidity with solc and executes
it under revm on every debug prove/verify, `crates/p256-ecdsa/src/base.rs:218-221`,
`bin/src/main.rs:233-238`; SURVEY.md §2.2 D-SNARKV fixes the capability:
"an EVM-execution test harness … implementation free, capability fixed").

Scope: exactly what verifier bytecode needs — the arithmetic/stack/memory/
control opcodes, SHA3, CALLDATALOAD, STATICCALL to the four BN254/modexp
precompiles (0x05 modexp, 0x06 ecAdd, 0x07 ecMul, 0x08 pairing), RETURN and
REVERT. No gas accounting (the harness answers "does the contract accept",
not "how much does it cost"), no storage, no CALL/CREATE.

Port of ``zkdcap_tpu/evm/interp.py``: the curve, pairing and keccak helpers
are the port's host copies (``curves/host_curve.py``, ``curves/pairing.py``,
``transcript/keccak.py``).
"""

from __future__ import annotations

from ..curves.host_curve import BN254_G1
from ..curves.pairing import Fq2, g2_is_on_curve, pairing_product_is_one
from ..transcript.keccak import keccak256

U256 = (1 << 256) - 1
Q = BN254_G1.p


class EvmRevert(Exception):
    def __init__(self, data: bytes):
        self.data = data
        msg = ""
        # decode Error(string)
        if data[:4] == bytes.fromhex("08c379a0") and len(data) >= 68:
            strlen = int.from_bytes(data[36:68], "big")
            msg = data[68 : 68 + strlen].decode(errors="replace")
        super().__init__(f"EVM revert: {msg or data.hex()}")


def _sgn(v: int) -> int:
    """uint256 -> signed."""
    return v - (1 << 256) if v >> 255 else v


def _modexp_precompile(data: bytes) -> bytes:
    bl = int.from_bytes(data[0:32], "big")
    el = int.from_bytes(data[32:64], "big")
    ml = int.from_bytes(data[64:96], "big")
    rest = data[96:]
    b = int.from_bytes(rest[:bl].ljust(bl, b"\0"), "big")
    e = int.from_bytes(rest[bl : bl + el].ljust(el, b"\0"), "big")
    m = int.from_bytes(rest[bl + el : bl + el + ml].ljust(ml, b"\0"), "big")
    out = pow(b, e, m) if m else 0
    return out.to_bytes(ml, "big")


def _ec_point(x: int, y: int):
    if x == 0 and y == 0:
        return None
    if x >= Q or y >= Q or (y * y - (x * x * x + 3)) % Q:
        raise ValueError("invalid G1 point")
    return (x, y)


def _ec_out(pt) -> bytes:
    if pt is None:
        return bytes(64)
    return pt[0].to_bytes(32, "big") + pt[1].to_bytes(32, "big")


def _ecadd_precompile(data: bytes) -> bytes:
    data = data.ljust(128, b"\0")
    a = _ec_point(int.from_bytes(data[0:32], "big"), int.from_bytes(data[32:64], "big"))
    b = _ec_point(int.from_bytes(data[64:96], "big"), int.from_bytes(data[96:128], "big"))
    return _ec_out(BN254_G1.add(a, b))


def _ecmul_precompile(data: bytes) -> bytes:
    data = data.ljust(96, b"\0")
    a = _ec_point(int.from_bytes(data[0:32], "big"), int.from_bytes(data[32:64], "big"))
    s = int.from_bytes(data[64:96], "big")
    return _ec_out(BN254_G1.mul(s % BN254_G1.n, a))


def _pairing_precompile(data: bytes) -> bytes:
    if len(data) % 192:
        raise ValueError("pairing input not multiple of 192")
    pairs = []
    for off in range(0, len(data), 192):
        g1 = _ec_point(
            int.from_bytes(data[off : off + 32], "big"),
            int.from_bytes(data[off + 32 : off + 64], "big"),
        )
        x_im = int.from_bytes(data[off + 64 : off + 96], "big")
        x_re = int.from_bytes(data[off + 96 : off + 128], "big")
        y_im = int.from_bytes(data[off + 128 : off + 160], "big")
        y_re = int.from_bytes(data[off + 160 : off + 192], "big")
        if max(x_im, x_re, y_im, y_re) >= Q:
            raise ValueError("invalid G2 coordinate")
        if g1 is None:
            continue  # e(O, Q) = 1
        if x_im == x_re == y_im == y_re == 0:
            continue  # e(P, O) = 1
        g2 = (Fq2(x_re, x_im), Fq2(y_re, y_im))
        if not g2_is_on_curve(g2):
            raise ValueError("G2 point not on curve")
        pairs.append((g1, g2))
    ok = pairing_product_is_one(pairs) if pairs else True
    return int(ok).to_bytes(32, "big")


PRECOMPILES = {
    0x05: _modexp_precompile,
    0x06: _ecadd_precompile,
    0x07: _ecmul_precompile,
    0x08: _pairing_precompile,
}


class Memory:
    def __init__(self):
        self.data = bytearray()

    def _grow(self, end: int):
        if end > len(self.data):
            self.data.extend(bytes(((end + 31) // 32) * 32 - len(self.data)))

    def load(self, off: int) -> int:
        self._grow(off + 32)
        return int.from_bytes(self.data[off : off + 32], "big")

    def store(self, off: int, val: int):
        self._grow(off + 32)
        self.data[off : off + 32] = (val & U256).to_bytes(32, "big")

    def store8(self, off: int, val: int):
        self._grow(off + 1)
        self.data[off] = val & 0xFF

    def read(self, off: int, size: int) -> bytes:
        if size == 0:
            return b""
        self._grow(off + size)
        return bytes(self.data[off : off + size])

    def write(self, off: int, blob: bytes):
        if blob:
            self._grow(off + len(blob))
            self.data[off : off + len(blob)] = blob


def execute(code: bytes, calldata: bytes, max_steps: int = 50_000_000) -> bytes:
    """Run `code` against `calldata`; returns RETURN data or raises EvmRevert."""
    stack: list[int] = []
    mem = Memory()
    retdata = b""
    pc = 0
    n = len(code)
    # precompute valid JUMPDESTs (positions not inside PUSH data)
    jumpdests = set()
    i = 0
    while i < n:
        op = code[i]
        if op == 0x5B:
            jumpdests.add(i)
        i += 1 + (op - 0x5F if 0x60 <= op <= 0x7F else 0)

    def push(v: int):
        if len(stack) >= 1024:
            raise RuntimeError("stack overflow")
        stack.append(v & U256)

    def pop() -> int:
        return stack.pop()

    steps = 0
    while pc < n:
        steps += 1
        if steps > max_steps:
            raise RuntimeError("step limit exceeded")
        op = code[pc]
        pc += 1
        if 0x60 <= op <= 0x7F:  # PUSH1..PUSH32
            size = op - 0x5F
            push(int.from_bytes(code[pc : pc + size], "big"))
            pc += size
        elif 0x80 <= op <= 0x8F:  # DUP1..DUP16
            push(stack[-(op - 0x7F)])
        elif 0x90 <= op <= 0x9F:  # SWAP1..SWAP16
            d = op - 0x8F
            stack[-1], stack[-1 - d] = stack[-1 - d], stack[-1]
        elif op == 0x00:  # STOP
            return b""
        elif op == 0x01:  # ADD
            push(pop() + pop())
        elif op == 0x02:  # MUL
            push(pop() * pop())
        elif op == 0x03:  # SUB
            a, b = pop(), pop()
            push(a - b)
        elif op == 0x04:  # DIV
            a, b = pop(), pop()
            push(a // b if b else 0)
        elif op == 0x06:  # MOD
            a, b = pop(), pop()
            push(a % b if b else 0)
        elif op == 0x08:  # ADDMOD
            a, b, m = pop(), pop(), pop()
            push((a + b) % m if m else 0)
        elif op == 0x09:  # MULMOD
            a, b, m = pop(), pop(), pop()
            push((a * b) % m if m else 0)
        elif op == 0x0A:  # EXP
            a, b = pop(), pop()
            push(pow(a, b, 1 << 256))
        elif op == 0x10:  # LT
            a, b = pop(), pop()
            push(int(a < b))
        elif op == 0x11:  # GT
            a, b = pop(), pop()
            push(int(a > b))
        elif op == 0x12:  # SLT
            a, b = pop(), pop()
            push(int(_sgn(a) < _sgn(b)))
        elif op == 0x14:  # EQ
            push(int(pop() == pop()))
        elif op == 0x15:  # ISZERO
            push(int(pop() == 0))
        elif op == 0x16:  # AND
            push(pop() & pop())
        elif op == 0x17:  # OR
            push(pop() | pop())
        elif op == 0x18:  # XOR
            push(pop() ^ pop())
        elif op == 0x19:  # NOT
            push(~pop())
        elif op == 0x1A:  # BYTE
            i_, x = pop(), pop()
            push((x >> (8 * (31 - i_))) & 0xFF if i_ < 32 else 0)
        elif op == 0x1B:  # SHL
            s, v = pop(), pop()
            push(v << s if s < 256 else 0)
        elif op == 0x1C:  # SHR
            s, v = pop(), pop()
            push(v >> s if s < 256 else 0)
        elif op == 0x20:  # SHA3 / KECCAK256
            off, size = pop(), pop()
            push(int.from_bytes(keccak256(mem.read(off, size)), "big"))
        elif op == 0x35:  # CALLDATALOAD
            off = pop()
            push(int.from_bytes(calldata[off : off + 32].ljust(32, b"\0"), "big"))
        elif op == 0x36:  # CALLDATASIZE
            push(len(calldata))
        elif op == 0x37:  # CALLDATACOPY
            dst, src, size = pop(), pop(), pop()
            mem.write(dst, calldata[src : src + size].ljust(size, b"\0"))
        elif op == 0x3D:  # RETURNDATASIZE
            push(len(retdata))
        elif op == 0x3E:  # RETURNDATACOPY
            dst, src, size = pop(), pop(), pop()
            if src + size > len(retdata):
                raise EvmRevert(b"")
            mem.write(dst, retdata[src : src + size])
        elif op == 0x50:  # POP
            pop()
        elif op == 0x51:  # MLOAD
            push(mem.load(pop()))
        elif op == 0x52:  # MSTORE
            off, val = pop(), pop()
            mem.store(off, val)
        elif op == 0x53:  # MSTORE8
            off, val = pop(), pop()
            mem.store8(off, val)
        elif op == 0x56:  # JUMP
            dest = pop()
            if dest not in jumpdests:
                raise RuntimeError(f"bad jump dest {dest}")
            pc = dest
        elif op == 0x57:  # JUMPI
            dest, cond = pop(), pop()
            if cond:
                if dest not in jumpdests:
                    raise RuntimeError(f"bad jump dest {dest}")
                pc = dest
        elif op == 0x58:  # PC
            push(pc - 1)
        elif op == 0x59:  # MSIZE
            push(len(mem.data))
        elif op == 0x5A:  # GAS
            push(10**9)
        elif op == 0x5B:  # JUMPDEST
            pass
        elif op == 0xF3:  # RETURN
            off, size = pop(), pop()
            return mem.read(off, size)
        elif op == 0xFA:  # STATICCALL
            _gas, addr, in_off, in_size, out_off, out_size = (
                pop(), pop(), pop(), pop(), pop(), pop(),
            )
            fn = PRECOMPILES.get(addr)
            if fn is None:
                raise RuntimeError(f"staticcall to unsupported address {addr:#x}")
            try:
                retdata = fn(mem.read(in_off, in_size))
                ok = 1
            except Exception:
                retdata = b""
                ok = 0
            mem.write(out_off, retdata[:out_size].ljust(min(out_size, len(retdata)), b"\0")
                      if retdata else b"")
            push(ok)
        elif op == 0xFD:  # REVERT
            off, size = pop(), pop()
            raise EvmRevert(mem.read(off, size))
        elif op == 0xFE:  # INVALID
            raise EvmRevert(b"")
        else:
            raise RuntimeError(f"unsupported opcode {op:#04x} at {pc - 1}")
    return b""


def deploy_and_call(code: bytes, calldata: bytes) -> bytes:
    """Reference `deploy_and_call` analog (base.rs:218-221): execute the
    runtime bytecode with the given calldata; raises EvmRevert on reject."""
    return execute(code, calldata)
