"""Compiler for the restricted Solidity subset emitted by `gen_evm_verifier`
(evm/solidity.py) — the project does not depend on solc, so this plays the role of
the reference's `compile_solidity` (shelling out to solc 0.8.19,
`bin/README.md:29`, SURVEY.md §2.2 D-SNARKV): it turns the emitted verifier
contract into EVM bytecode executable by `evm/interp.py`, so the generated
artifact really runs against real calldata (revm `deploy_and_call` parity,
`crates/p256-ecdsa/src/base.rs:218-221`).

Supported subset (exactly what the emitter produces):
  * `uint256 constant NAME = ...;` contract-level constants
  * straight-line statements: declarations/assignments of uint256/bytes32/
    bool, fixed `uint256[K] memory` arrays, tuple assignments from
    ecAdd/ecMul, `require(cond, "msg")`, if/else, `for (uint256 j = 0;
    j < LIT; j++)`, blocks, `return hex"01";`
  * expressions: addmod/mulmod, `+ - * %`, comparisons, `&&`, ternary,
    casts, `keccak256(abi.encodePacked(...))`,
    `address(0xN).staticcall(abi.encode(arr))`, `abi.decode(x, (uint256))`
  * builtin helper functions of the emitted contract (calldataloadp,
    expmod, invmod, lagrange, ecAdd, ecMul) are inlined by the compiler.

Variables live in EVM memory slots; loops/branches compile to real
JUMP/JUMPI control flow; helper precompile calls go through STATICCALL.

Port of ``zkdcap_tpu/evm/solc.py`` (pure host code, copied as it is).
"""

from __future__ import annotations

import re

# ---------------------------------------------------------------------------
# lexer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<hex>0x[0-9a-fA-F]+)
  | (?P<num>\d+)
  | (?P<string>"[^"]*")
  | (?P<ident>[A-Za-z_$][A-Za-z0-9_$]*)
  | (?P<op>\+\+|==|!=|<=|>=|&&|\|\||[-+*/%<>=!&|?:;,.(){}\[\]])
  | (?P<ws>\s+)
""",
    re.VERBOSE,
)


def tokenize(src: str) -> list[str]:
    toks = []
    for line in src.splitlines():
        if "//" in line:
            line = line.split("//", 1)[0]
        pos = 0
        while pos < len(line):
            m = _TOKEN_RE.match(line, pos)
            if not m:
                raise SyntaxError(f"lex error at: {line[pos:pos+40]!r}")
            pos = m.end()
            if m.lastgroup != "ws":
                toks.append(m.group())
    return toks


# ---------------------------------------------------------------------------
# EVM assembler
# ---------------------------------------------------------------------------

OPS = {
    "STOP": 0x00, "ADD": 0x01, "MUL": 0x02, "SUB": 0x03, "DIV": 0x04,
    "MOD": 0x06, "ADDMOD": 0x08, "MULMOD": 0x09, "EXP": 0x0A,
    "LT": 0x10, "GT": 0x11, "EQ": 0x14, "ISZERO": 0x15, "AND": 0x16,
    "OR": 0x17, "XOR": 0x18, "NOT": 0x19, "SHL": 0x1B, "SHR": 0x1C,
    "SHA3": 0x20, "CALLDATALOAD": 0x35, "CALLDATASIZE": 0x36,
    "RETURNDATASIZE": 0x3D, "RETURNDATACOPY": 0x3E,
    "POP": 0x50, "MLOAD": 0x51, "MSTORE": 0x52, "MSTORE8": 0x53,
    "JUMP": 0x56, "JUMPI": 0x57, "MSIZE": 0x59, "GAS": 0x5A,
    "JUMPDEST": 0x5B, "RETURN": 0xF3, "STATICCALL": 0xFA, "REVERT": 0xFD,
}


class Asm:
    def __init__(self):
        self.items: list = []  # ints (opcodes), ("PUSH", value), ("PUSHL", label), ("LABEL", name)
        self._label_n = 0

    def op(self, name: str):
        self.items.append(OPS[name])

    def push(self, v: int):
        self.items.append(("PUSH", v))

    def push_label(self, label: str):
        self.items.append(("PUSHL", label))

    def label(self, name: str):
        self.items.append(("LABEL", name))

    def fresh_label(self, prefix="L") -> str:
        self._label_n += 1
        return f"{prefix}{self._label_n}"

    def dup(self, n: int):
        self.items.append(0x7F + n)

    def swap(self, n: int):
        self.items.append(0x8F + n)

    def assemble(self) -> bytes:
        # labels resolved with fixed 3-byte PUSH (code < 16MB)
        size = 0
        positions: dict[str, int] = {}
        sizes = []
        for it in self.items:
            if isinstance(it, int):
                s = 1
            elif it[0] == "PUSH":
                v = it[1]
                nbytes = max((v.bit_length() + 7) // 8, 1)
                s = 1 + nbytes
            elif it[0] == "PUSHL":
                s = 4  # PUSH3 xx xx xx
            else:  # LABEL -> JUMPDEST
                positions[it[1]] = size
                s = 1
            sizes.append(s)
            size += s
        out = bytearray()
        for it, s in zip(self.items, sizes):
            if isinstance(it, int):
                out.append(it)
            elif it[0] == "PUSH":
                v = it[1]
                nbytes = s - 1
                out.append(0x5F + nbytes)
                out += v.to_bytes(nbytes, "big")
            elif it[0] == "PUSHL":
                pos = positions[it[1]]
                out.append(0x62)  # PUSH3
                out += pos.to_bytes(3, "big")
            else:
                out.append(0x5B)
        return bytes(out)


# ---------------------------------------------------------------------------
# parser + code generator (single pass)
# ---------------------------------------------------------------------------

# memory layout
SCRATCH = 0x80            # staticcall / keccak staging (4 KiB)
RETSCRATCH = SCRATCH + 4096
TMP = RETSCRATCH + 0x40   # inlining temporaries
VARS_BASE = TMP + 0x100


class Compiler:
    def __init__(self, src: str):
        self.consts: dict[str, int] = {}
        for m in re.finditer(r"uint256 constant (\w+) = (0x[0-9a-fA-F]+|\d+);", src):
            self.consts[m.group(1)] = int(m.group(2), 0)
        m = re.search(r"fallback\(bytes calldata\) external returns \(bytes memory\) \{", src)
        if not m:
            raise SyntaxError("no fallback function found")
        body = src[m.end():]
        # body runs to the matching close of the fallback; the contract's
        # final two closers are the last '}' chars in the file
        body = body[: body.rfind("}", 0, body.rfind("}"))]
        self.toks = tokenize(body)
        self.pos = 0
        self.asm = Asm()
        self.vars: dict[str, int] = {}       # name -> memory offset
        self.arrays: dict[str, tuple[int, int]] = {}  # name -> (offset, length)
        self.bytes_vars: dict[str, int] = {}  # bytes-memory names -> ret slot
        self.next_var = VARS_BASE
        self.revert_labels: dict[str, str] = {}
        self.tmp_depth = 0

    # --- token helpers ---------------------------------------------------
    def peek(self, k=0) -> str | None:
        return self.toks[self.pos + k] if self.pos + k < len(self.toks) else None

    def next(self) -> str:
        t = self.toks[self.pos]
        self.pos += 1
        return t

    def expect(self, t: str):
        got = self.next()
        if got != t:
            raise SyntaxError(f"expected {t!r}, got {got!r} near {self.toks[self.pos-5:self.pos+5]}")

    # --- variable slots ---------------------------------------------------
    def slot(self, name: str) -> int:
        if name not in self.vars:
            self.vars[name] = self.next_var
            self.next_var += 32
        return self.vars[name]

    def alloc_tmp(self) -> int:
        off = TMP + 32 * self.tmp_depth
        self.tmp_depth += 1
        if self.tmp_depth > 8:
            raise RuntimeError("tmp overflow")
        return off

    def free_tmp(self):
        self.tmp_depth -= 1

    # --- revert helper ----------------------------------------------------
    def require_top(self, msg: str):
        """Stack: [cond]; reverts with Error(msg) if cond is zero."""
        a = self.asm
        if msg not in self.revert_labels:
            self.revert_labels[msg] = a.fresh_label("REV")
        a.op("ISZERO")
        a.push_label(self.revert_labels[msg])
        a.op("JUMPI")

    def emit_revert_blocks(self):
        a = self.asm
        for msg, label in self.revert_labels.items():
            a.label(label)
            payload = (
                bytes.fromhex("08c379a0")
                + (32).to_bytes(32, "big")
                + len(msg).to_bytes(32, "big")
                + msg.encode().ljust(32, b"\0")
            )
            off = 0
            # write with 32-byte stores (over-write into scratch is fine)
            for i in range(0, len(payload), 32):
                chunk = int.from_bytes(payload[i : i + 32].ljust(32, b"\0"), "big")
                a.push(chunk)
                a.push(off + i)
                a.op("MSTORE")
            a.push(len(payload))
            a.push(0)
            a.op("REVERT")

    # --- staticcall helpers -----------------------------------------------
    def staticcall(self, addr: int, in_size: int, out_size: int):
        """Inputs already staged at SCRATCH. Leaves success flag on stack;
        return data written to RETSCRATCH (pre-zeroed)."""
        a = self.asm
        a.push(0)
        a.push(RETSCRATCH)
        a.op("MSTORE")
        if out_size > 32:
            a.push(0)
            a.push(RETSCRATCH + 32)
            a.op("MSTORE")
        a.push(out_size)
        a.push(RETSCRATCH)
        a.push(in_size)
        a.push(SCRATCH)
        a.push(addr)
        a.op("GAS")
        a.op("STATICCALL")

    def stage_args(self, compile_fns: list):
        """Compile each arg and store to SCRATCH+32*i."""
        a = self.asm
        for i, fn in enumerate(compile_fns):
            fn()
            a.push(SCRATCH + 32 * i)
            a.op("MSTORE")

    # --- builtins (inlined) ----------------------------------------------
    def builtin_expmod(self, argfns):
        """expmod(b, e, m) via precompile 0x05 (EIP-198 layout)."""
        a = self.asm
        bfn, efn, mfn = argfns
        self.stage_args([lambda: a.push(32), lambda: a.push(32), lambda: a.push(32),
                         bfn, efn, mfn])
        self.staticcall(0x05, 192, 32)
        self.require_top("expmod")
        a.push(RETSCRATCH)
        a.op("MLOAD")

    def builtin_invmod(self, argfns):
        (afn,) = argfns
        R = self.consts["R"]
        self.builtin_expmod([afn, lambda: self.asm.push(R - 2), lambda: self.asm.push(R)])

    def builtin_lagrange(self, argfns):
        """lagrange(i, x, znum) = wi*NINV * znum * inv(x-wi), wi=OMEGA^i."""
        a = self.asm
        ifn, xfn, zfn = argfns
        R = self.consts["R"]
        wi_t = self.alloc_tmp()
        den_t = self.alloc_tmp()
        self.builtin_expmod([lambda: a.push(self.consts["OMEGA"]), ifn, lambda: a.push(R)])
        a.push(wi_t)
        a.op("MSTORE")
        # den = addmod(x, R - wi, R)
        a.push(R)
        a.push(wi_t)
        a.op("MLOAD")
        a.push(R)
        a.op("SUB")  # EVM SUB = top - next = R - wi  (wi < R always)
        xfn()
        a.op("ADDMOD")
        a.push(den_t)
        a.op("MSTORE")
        # result = mulmod(mulmod(wi, NINV, R), mulmod(znum, invmod(den), R), R)
        a.push(R)
        # mulmod(znum, invmod(den), R)
        a.push(R)
        self.builtin_invmod([lambda: (a.push(den_t), a.op("MLOAD"))])
        zfn()
        a.op("MULMOD")
        # mulmod(wi, NINV, R)
        a.push(R)
        a.push(self.consts["NINV"])
        a.push(wi_t)
        a.op("MLOAD")
        a.op("MULMOD")
        a.op("MULMOD")
        self.free_tmp()
        self.free_tmp()

    def builtin_ec(self, name: str, argfns):
        """ecAdd(4 args)/ecMul(3 args) via 0x06/0x07; leaves (x, y) in
        RETSCRATCH and NOTHING on the stack (tuple handled by caller)."""
        addr = 0x06 if name == "ecAdd" else 0x07
        self.stage_args(argfns)
        self.staticcall(addr, 32 * len(argfns), 64)
        self.require_top(name)

    # --- expressions ------------------------------------------------------
    def compile_expr(self):
        self.ternary()

    def ternary(self):
        self.logical_and()
        if self.peek() == "?":
            a = self.asm
            self.next()
            l_true = a.fresh_label()
            l_end = a.fresh_label()
            a.push_label(l_true)
            a.op("JUMPI")
            # else branch parsed second in source; grab true-expr tokens first
            # source order: cond ? true_expr : false_expr
            # compile: JUMPI true; false; JUMP end; true: ...; end:
            # we must parse true_expr now but emit false first -> use a
            # sub-compilation into the same asm via token replay:
            start = self.pos
            self.skip_expr()  # skip true expr tokens
            self.expect(":")
            self.logical_and()  # false branch (nested ternary unsupported)
            a.push_label(l_end)
            a.op("JUMP")
            a.label(l_true)
            end_tokens = self.pos
            self.pos = start
            self.logical_and()  # true branch
            self.pos = end_tokens
            a.label(l_end)

    def skip_expr(self):
        """Skip tokens of one expression up to an unparenthesized ':' or
        statement end."""
        depth = 0
        while True:
            t = self.peek()
            if t is None:
                return
            if t in "([{":
                depth += 1
            elif t in ")]}":
                if depth == 0:
                    return
                depth -= 1
            elif depth == 0 and t in (":", ";", ","):
                return
            self.next()

    def logical_and(self):
        self.equality()
        while self.peek() == "&&":
            self.next()
            self.equality()
            self.asm.op("AND")

    def equality(self):
        self.relational()
        while self.peek() in ("==", "!="):
            op = self.next()
            self.relational()
            self.asm.op("EQ")
            if op == "!=":
                self.asm.op("ISZERO")

    def relational(self):
        self.additive()
        while self.peek() in ("<", ">"):
            op = self.next()
            self.additive()
            # stack: [a, b]; LT computes a<b with a on top -> swap
            self.asm.swap(1)
            self.asm.op("LT" if op == "<" else "GT")

    def additive(self):
        self.multiplicative()
        while self.peek() in ("+", "-"):
            op = self.next()
            self.multiplicative()
            if op == "+":
                self.asm.op("ADD")
            else:
                # stack [a, b] -> a - b: SUB pops a=top? SUB = top - next.
                self.asm.swap(1)
                self.asm.op("SUB")

    def multiplicative(self):
        self.unary()
        while self.peek() in ("*", "%"):
            op = self.next()
            self.unary()
            if op == "*":
                self.asm.op("MUL")
            else:
                self.asm.swap(1)
                self.asm.op("MOD")

    def unary(self):
        if self.peek() == "-":
            self.next()
            self.unary()
            self.asm.push(0)
            self.asm.op("SUB")
        elif self.peek() == "!":
            self.next()
            self.unary()
            self.asm.op("ISZERO")
        else:
            self.primary()

    def parse_args(self) -> int:
        """Consume '(' args ')' compiling each; returns count (stack grows)."""
        self.expect("(")
        n = 0
        if self.peek() != ")":
            while True:
                self.compile_expr()
                n += 1
                if self.peek() == ",":
                    self.next()
                else:
                    break
        self.expect(")")
        return n

    def parse_arg_fns(self) -> list:
        """Parse '(' e, e, ... ')' returning deferred compile closures."""
        self.expect("(")
        spans = []
        depth = 0
        start = self.pos
        while True:
            t = self.peek()
            if t == "(" or t == "[":
                depth += 1
            elif t == ")" or t == "]":
                if depth == 0:
                    if self.pos > start:
                        spans.append((start, self.pos))
                    self.next()
                    break
                depth -= 1
            elif t == "," and depth == 0:
                spans.append((start, self.pos))
                start = self.pos + 1
            self.next()
        end = self.pos

        def mk(span):
            def fn():
                saved = self.pos
                self.pos = span[0]
                self.compile_expr()
                self.pos = saved
            return fn

        fns = [mk(s) for s in spans]
        self.pos = end
        return fns

    def primary(self):
        a = self.asm
        t = self.next()
        if t.startswith("0x"):
            a.push(int(t, 16))
        elif t.isdigit():
            a.push(int(t))
        elif t == "(":
            self.compile_expr()
            self.expect(")")
        elif t == "true":
            a.push(1)
        elif t == "false":
            a.push(0)
        elif t in ("uint256", "bytes32"):
            # cast: uint256(x) / bytes32(x) — identity on the EVM
            self.expect("(")
            self.compile_expr()
            self.expect(")")
        elif t == "addmod" or t == "mulmod":
            fns = self.parse_arg_fns()
            assert len(fns) == 3
            fns[2]()
            fns[1]()
            fns[0]()
            a.op("ADDMOD" if t == "addmod" else "MULMOD")
        elif t == "calldataloadp":
            self.expect("(")
            self.compile_expr()
            self.expect(")")
            a.op("CALLDATALOAD")
        elif t == "expmod":
            self.builtin_expmod(self.parse_arg_fns())
        elif t == "invmod":
            self.builtin_invmod(self.parse_arg_fns())
        elif t == "lagrange":
            self.builtin_lagrange(self.parse_arg_fns())
        elif t == "keccak256":
            # keccak256(abi.encodePacked(a, b, ...))
            self.expect("(")
            self.expect("abi")
            self.expect(".")
            self.expect("encodePacked")
            fns = self.parse_arg_fns()
            self.expect(")")
            self.stage_args(fns)
            a.push(32 * len(fns))
            a.push(SCRATCH)
            a.op("SHA3")
        elif t == "abi":
            # abi.decode(pout, (uint256))
            self.expect(".")
            self.expect("decode")
            self.expect("(")
            name = self.next()
            slot = self.bytes_vars[name]
            self.expect(",")
            self.expect("(")
            self.expect("uint256")
            self.expect(")")
            self.expect(")")
            a.push(slot)
            a.op("MLOAD")
        elif t in self.consts:
            a.push(self.consts[t])
        elif t in self.vars:
            a.push(self.vars[t])
            a.op("MLOAD")
        else:
            raise SyntaxError(f"unknown identifier {t!r} near {self.toks[self.pos-5:self.pos+5]}")

    # --- statements -------------------------------------------------------
    def compile_block(self):
        """Compile statements until the matching '}' (caller consumed '{')."""
        while self.peek() is not None and self.peek() != "}":
            self.statement()
        if self.peek() == "}":
            self.next()

    def compile_body(self):
        while self.peek() is not None:
            self.statement()
        self.asm.op("STOP")
        self.emit_revert_blocks()

    def statement(self):
        a = self.asm
        t = self.peek()
        if t == "{":
            self.next()
            self.compile_block()
        elif t == ";":
            self.next()
        elif t in ("uint256", "bytes32", "bool"):
            self.next()
            if self.peek() == "[":  # uint256[K] memory name;
                self.next()
                length = int(self.next())
                self.expect("]")
                self.expect("memory")
                name = self.next()
                self.expect(";")
                base = self.next_var
                self.next_var += 32 * length
                self.arrays[name] = (base, length)
                return
            name = self.next()
            self.expect("=")
            self.compile_expr()
            a.push(self.slot(name))
            a.op("MSTORE")
            self.expect(";")
        elif t == "(":
            # tuple assignment: (uint256 tx, uint256 ty) = ecAdd/ecMul(...)
            # or (bool ok, bytes memory out) = address(0xN).staticcall(...)
            self.next()
            names = []
            is_bytes = []
            while True:
                ty = self.next()
                if ty in ("uint256", "bool"):
                    names.append(self.next())
                    is_bytes.append(False)
                elif ty == "bytes":
                    self.expect("memory")
                    names.append(self.next())
                    is_bytes.append(True)
                else:
                    names.append(ty)  # plain existing var
                    is_bytes.append(False)
                if self.peek() == ",":
                    self.next()
                else:
                    break
            self.expect(")")
            self.expect("=")
            fn = self.next()
            if fn in ("ecAdd", "ecMul"):
                self.builtin_ec(fn, self.parse_arg_fns())
                a.push(RETSCRATCH)
                a.op("MLOAD")
                a.push(self.slot(names[0]))
                a.op("MSTORE")
                a.push(RETSCRATCH + 32)
                a.op("MLOAD")
                a.push(self.slot(names[1]))
                a.op("MSTORE")
            elif fn == "address":
                # address(0xN).staticcall(abi.encode(arr))
                self.expect("(")
                addr = int(self.next(), 0)
                self.expect(")")
                self.expect(".")
                self.expect("staticcall")
                self.expect("(")
                self.expect("abi")
                self.expect(".")
                self.expect("encode")
                self.expect("(")
                arr = self.next()
                self.expect(")")
                self.expect(")")
                base, length = self.arrays[arr]
                for i in range(length):
                    a.push(base + 32 * i)
                    a.op("MLOAD")
                    a.push(SCRATCH + 32 * i)
                    a.op("MSTORE")
                self.staticcall(addr, 32 * length, 32)
                a.push(self.slot(names[0]))
                a.op("MSTORE")
                self.bytes_vars[names[1]] = RETSCRATCH
            else:
                raise SyntaxError(f"unsupported tuple rhs {fn!r}")
            self.expect(";")
        elif t == "require":
            self.next()
            self.expect("(")
            self.compile_expr()
            self.expect(",")
            msg = self.next().strip('"')
            self.expect(")")
            self.expect(";")
            self.require_top(msg)
        elif t == "for":
            self.next()
            self.expect("(")
            self.expect("uint256")
            var = self.next()
            self.expect("=")
            self.compile_expr()
            a.push(self.slot(var))
            a.op("MSTORE")
            self.expect(";")
            l_cond = a.fresh_label("FC")
            l_end = a.fresh_label("FE")
            a.label(l_cond)
            self.compile_expr()  # condition
            a.op("ISZERO")
            a.push_label(l_end)
            a.op("JUMPI")
            self.expect(";")
            # increment: VAR++
            inc_var = self.next()
            self.expect("++")
            self.expect(")")
            self.expect("{")
            self.compile_block()
            a.push(1)
            a.push(self.vars[inc_var])
            a.op("MLOAD")
            a.op("ADD")
            a.push(self.vars[inc_var])
            a.op("MSTORE")
            a.push_label(l_cond)
            a.op("JUMP")
            a.label(l_end)
        elif t == "if":
            self.next()
            self.expect("(")
            self.compile_expr()
            self.expect(")")
            l_true = a.fresh_label("IT")
            l_end = a.fresh_label("IE")
            a.push_label(l_true)
            a.op("JUMPI")
            # else-first layout: need to know if else exists; parse then-block
            # tokens, compile else (if any), then then-block.
            self.expect("{")
            then_start = self.pos
            depth = 1
            while depth:
                tk = self.next()
                if tk == "{":
                    depth += 1
                elif tk == "}":
                    depth -= 1
            then_end = self.pos
            if self.peek() == "else":
                self.next()
                self.expect("{")
                self.compile_block()
            a.push_label(l_end)
            a.op("JUMP")
            a.label(l_true)
            after = self.pos
            self.pos = then_start
            self.compile_block()
            self.pos = after
            a.label(l_end)
        elif t == "return":
            self.next()
            self.expect("hex")
            lit = self.next().strip('"')
            payload = bytes.fromhex(lit)
            self.expect(";")
            for i, byte in enumerate(payload):
                a.push(byte)
                a.push(i)
                a.op("MSTORE8")
            a.push(len(payload))
            a.push(0)
            a.op("RETURN")
        else:
            # assignment: NAME = expr;  or  NAME[idx] = expr;
            name = self.next()
            if self.peek() == "[":
                self.next()
                idx_start = self.pos
                self.skip_expr()
                idx_end = self.pos
                self.expect("]")
                self.expect("=")
                self.compile_expr()
                self.expect(";")
                base, _ = self.arrays[name]
                # constant index required
                saved = self.pos
                self.pos = idx_start
                idx_tok = self.next()
                assert self.pos == idx_end and (idx_tok.isdigit() or idx_tok.startswith("0x"))
                self.pos = saved
                a.push(base + 32 * int(idx_tok, 0))
                a.op("MSTORE")
                return
            self.expect("=")
            self.compile_expr()
            a.push(self.slot(name))
            a.op("MSTORE")
            self.expect(";")


def compile_solidity(src: str) -> bytes:
    """Compile the generated verifier contract to runtime EVM bytecode."""
    c = Compiler(src)
    c.compile_body()
    return c.asm.assemble()
