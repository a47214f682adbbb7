"""SHA-256 chip — `halo2-dynamic-sha256` equivalent (SURVEY.md §2.2 D-SHA).

A copy of ``zkdcap_tpu/chips/sha256.py`` (host Python, no device work); the
layout, and with it the pinning, the vk and the proofs, depend on every
detail of it, so it stays line for line the JAX package's.

Reference call pattern: `Sha256DynamicConfig::configure(...)` + `digest(ctx,
input, Some(384))` returning assigned output byte cells
(`circuits/src/sgx_dcap_verifier.rs:195-202,434-439`). Here `digest` takes
byte cells and a static length (the reference's DCAP circuit also uses a
fixed 384-byte length) and returns 32 byte cells.

Design: the Zcash-style SPREAD decomposition. spread(x) interleaves x's
bits with zeros; a (dense, spread) pair lookup table over 11-bit chunks
(2^11 rows, fits any k >= 12) both range-checks pieces and supplies their
spread forms. XOR / Maj / Ch become *field additions of spread forms*
followed by an even/odd-bit split:

    spread(a) + spread(b) + spread(c) = spread(even) + 2 * spread(odd)
    even = a XOR b XOR c ; odd = Maj(a, b, c)
    odd(spread(e)+spread(f)) = e AND f  ->  Ch = (e AND f) + (NOT e AND g)

Rotations are free: each word is decomposed at the rotation boundaries of
its use (Sigma0: 2/13/22, Sigma1: 6/11/25, sigma0: 3/7/18, sigma1:
10/17/19+shr), and a rotated spread is just a constant-weighted
recombination of the piece spreads.
"""

from __future__ import annotations

from .context import Context, FlexGate
from .range import RangeChip

SPREAD_BITS = 11
MASK32 = (1 << 32) - 1

# piece widths (low to high) aligned to each function's rotation boundaries
SIGMA0_WIDTHS = [2, 11, 9, 10]  # boundaries 2, 13, 22
SIGMA1_WIDTHS = [6, 5, 11, 3, 7]  # boundaries 6, 11, 25
LSIGMA0_WIDTHS = [3, 4, 11, 11, 3]  # boundaries 3, 7, 18
LSIGMA1_WIDTHS = [10, 7, 2, 11, 2]  # boundaries 10, 17, 19
EO_WIDTHS = [11, 11, 10]  # generic 32-bit split for even/odd extraction

K_CONSTS = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]
H_INIT = [
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
]


def spread_int(x: int, width: int = 32) -> int:
    # fixed-width loop (not `while x`): iteration count must be
    # input-independent so traced (TInt) values record a static DAG
    # for witness replay
    out = 0
    for i in range(width):
        out = out | (((x >> i) & 1) << (2 * i))
    return out


class _Word:
    """A 32-bit word: dense cell + per-boundary piece decompositions."""

    __slots__ = ("dense", "value", "pieces")

    def __init__(self, dense: int, value: int):
        self.dense = dense
        self.value = value
        self.pieces: dict[tuple, list[tuple[int, int, int, int]]] = {}
        # widths-key -> [(dense_cell, spread_cell, width, offset), ...]


class Sha256Chip:
    def __init__(self, gate: FlexGate, rc: RangeChip):
        self.gate = gate
        self.ctx = gate.ctx
        self.rc = rc

    # --- spread plumbing ---------------------------------------------------

    def _spread_pair(self, val: int, width: int) -> tuple[int, int]:
        """Push (dense, spread) cells for a `width`-bit piece; lookup-check.

        Pieces narrower than SPREAD_BITS are additionally checked via their
        left-shifted forms (spread(x << k) = spread(x) << 2k stays in-table
        iff x < 2^(11-k))."""
        ctx, g = self.ctx, self.gate
        assert 0 <= val < (1 << width) and width <= SPREAD_BITS
        d = ctx.push(val)
        s = ctx.push(spread_int(val, width))
        ctx.spread_pairs.append((d, s))
        if width < SPREAD_BITS:
            sh = SPREAD_BITS - width
            d2 = g.mul_const(d, 1 << sh)
            s2 = g.mul_const(s, 1 << (2 * sh))
            ctx.spread_pairs.append((d2, s2))
        return d, s

    def decompose(self, w: _Word, widths: list[int]) -> list[tuple[int, int, int, int]]:
        """Split w into pieces of `widths` (low-first) with spread cells;
        constrains recomposition to w.dense. Cached per widths-key."""
        key = tuple(widths)
        if key in w.pieces:
            return w.pieces[key]
        g = self.gate
        pieces = []
        off = 0
        v = w.value
        for width in widths:
            pv = (v >> off) & ((1 << width) - 1)
            d, s = self._spread_pair(pv, width)
            pieces.append((d, s, width, off))
            off += width
        assert off == 32
        recon = g.inner_product_const([p[0] for p in pieces], [1 << p[3] for p in pieces])
        g.assert_equal(recon, w.dense)
        w.pieces[key] = pieces
        return pieces

    def spread_of(self, w: _Word, widths: list[int] | None = None) -> int:
        """Cell holding spread(w) from a piece decomposition."""
        pieces = self.decompose(w, widths or EO_WIDTHS)
        g = self.gate
        return g.inner_product_const(
            [p[1] for p in pieces], [1 << (2 * p[3]) for p in pieces]
        )

    def _rot_spread(self, pieces, r: int) -> int:
        """Spread of ROTR(w, r); r must align with piece boundaries."""
        g = self.gate
        cells, weights = [], []
        for d, s, width, off in pieces:
            new_off = (off - r) % 32
            assert new_off + width <= 32, "rotation not aligned to piece boundary"
            cells.append(s)
            weights.append(1 << (2 * new_off))
        return g.inner_product_const(cells, weights)

    def _shr_spread(self, pieces, r: int) -> int:
        g = self.gate
        cells, weights = [], []
        for d, s, width, off in pieces:
            if off >= r:
                cells.append(s)
                weights.append(1 << (2 * (off - r)))
        return g.inner_product_const(cells, weights)

    def _even_odd(self, spread_sum_cell: int, spread_sum_val: int) -> tuple[_Word, _Word]:
        """Split a sum of <= 3 spread forms into even/odd words:
        sum == spread(even) + 2*spread(odd)."""
        g = self.gate
        even_v = odd_v = 0
        for i in range(32):
            digit = (spread_sum_val >> (2 * i)) & 3
            even_v |= (digit & 1) << i
            odd_v |= (digit >> 1) << i
        even = self.new_word(even_v)
        odd = self.new_word(odd_v)
        se = self.spread_of(even)
        so = self.spread_of(odd)
        recon = g.mul_const_add(so, 2, se)
        g.assert_equal(recon, spread_sum_cell)
        return even, odd

    # --- word management ---------------------------------------------------

    def new_word(self, value: int) -> _Word:
        """Fresh witness word; range constrained via its first decomposition
        (every word gets decomposed at least once)."""
        cell = self.ctx.push(value & MASK32)
        w = _Word(cell, value & MASK32)
        self.decompose(w, EO_WIDTHS)  # ensures < 2^32
        return w

    def word_from_cell(self, cell: int, value: int) -> _Word:
        w = _Word(cell, value & MASK32)
        self.decompose(w, EO_WIDTHS)
        return w

    def const_word(self, value: int) -> _Word:
        cell = self.ctx.constant(value & MASK32)
        w = _Word(cell, value & MASK32)
        return w

    def add_mod32(self, terms: list[_Word], extra_consts: list[int] = ()) -> _Word:
        """(sum terms + consts) mod 2^32 with a range-checked carry."""
        g = self.gate
        total = sum(t.value for t in terms) + sum(extra_consts)
        acc = terms[0].dense
        for t in terms[1:]:
            acc = g.add(acc, t.dense)
        for c in extra_consts:
            acc = g.add_const(acc, c)
        out_v = total & MASK32
        carry_v = total >> 32
        n_terms = len(terms) + len(extra_consts)
        assert carry_v < n_terms
        out = self.new_word(out_v)
        carry = self.ctx.push(carry_v)
        self.rc.range_check(carry, max(n_terms - 1, 1).bit_length())
        recon = g.mul_const_add(carry, 1 << 32, out.dense)
        g.assert_equal(recon, acc)
        return out

    # --- SHA-256 compression ops -------------------------------------------

    def Sigma0(self, a: _Word) -> _Word:
        pieces = self.decompose(a, SIGMA0_WIDTHS)
        g = self.gate
        s = g.add(
            g.add(self._rot_spread(pieces, 2), self._rot_spread(pieces, 13)),
            self._rot_spread(pieces, 22),
        )
        sv = (
            spread_int(self._rotr(a.value, 2))
            + spread_int(self._rotr(a.value, 13))
            + spread_int(self._rotr(a.value, 22))
        )
        even, _ = self._even_odd(s, sv)
        return even

    def Sigma1(self, e: _Word) -> _Word:
        pieces = self.decompose(e, SIGMA1_WIDTHS)
        g = self.gate
        s = g.add(
            g.add(self._rot_spread(pieces, 6), self._rot_spread(pieces, 11)),
            self._rot_spread(pieces, 25),
        )
        sv = (
            spread_int(self._rotr(e.value, 6))
            + spread_int(self._rotr(e.value, 11))
            + spread_int(self._rotr(e.value, 25))
        )
        even, _ = self._even_odd(s, sv)
        return even

    def sigma0(self, w: _Word) -> _Word:
        pieces = self.decompose(w, LSIGMA0_WIDTHS)
        g = self.gate
        s = g.add(
            g.add(self._rot_spread(pieces, 7), self._rot_spread(pieces, 18)),
            self._shr_spread(pieces, 3),
        )
        sv = (
            spread_int(self._rotr(w.value, 7))
            + spread_int(self._rotr(w.value, 18))
            + spread_int(w.value >> 3)
        )
        even, _ = self._even_odd(s, sv)
        return even

    def sigma1(self, w: _Word) -> _Word:
        pieces = self.decompose(w, LSIGMA1_WIDTHS)
        g = self.gate
        s = g.add(
            g.add(self._rot_spread(pieces, 17), self._rot_spread(pieces, 19)),
            self._shr_spread(pieces, 10),
        )
        sv = (
            spread_int(self._rotr(w.value, 17))
            + spread_int(self._rotr(w.value, 19))
            + spread_int(w.value >> 10)
        )
        even, _ = self._even_odd(s, sv)
        return even

    def maj(self, a: _Word, b: _Word, c: _Word) -> _Word:
        g = self.gate
        sa, sb, sc = self.spread_of(a), self.spread_of(b), self.spread_of(c)
        s = g.add(g.add(sa, sb), sc)
        sv = spread_int(a.value) + spread_int(b.value) + spread_int(c.value)
        _, odd = self._even_odd(s, sv)
        return odd

    def ch(self, e: _Word, f: _Word, g_w: _Word) -> _Word:
        g = self.gate
        se, sf, sg = self.spread_of(e), self.spread_of(f), self.spread_of(g_w)
        # P = spread(e) + spread(f): odd = e AND f
        p = g.add(se, sf)
        pv = spread_int(e.value) + spread_int(f.value)
        _, ef = self._even_odd(p, pv)
        # Q = spread(~e) + spread(g): odd = ~e AND g
        # gate: se + sne*1 = all_spread  =>  sne = spread(~e)
        all_spread = spread_int(MASK32)
        sne = g.assemble(
            [E_(se), W_(all_spread - spread_int(e.value)), C_(1), C_(all_spread)],
            result_slot=1,
        )
        q = g.add(sne, sg)
        qv = (all_spread - spread_int(e.value)) + spread_int(g_w.value)
        _, neg = self._even_odd(q, qv)
        # Ch = (e AND f) + (~e AND g) (bitwise disjoint)
        ch_v = ef.value + neg.value
        assert ch_v <= MASK32
        cell = g.add(ef.dense, neg.dense)
        return _Word(cell, ch_v)

    @staticmethod
    def _rotr(x: int, r: int) -> int:
        return ((x >> r) | (x << (32 - r))) & MASK32

    # --- digest ------------------------------------------------------------

    def digest_bytes_dynamic(
        self,
        byte_cells: list[int],
        byte_vals: list[int],
        len_cell: int,
        len_val: int,
        max_len: int,
    ) -> list[tuple[int, int]]:
        """SHA-256 of a variable-length message (length is a WITNESS).

        The reference chip's dynamic mode (`Sha256DynamicConfig::digest(ctx,
        input, Some(len))` with max_byte_sizes, SURVEY.md §2.2 D-SHA): the
        circuit shape depends only on `max_len`; `len_cell` selects, in
        circuit, (a) the padded message bytes and (b) which block's chaining
        state is the digest. Cost: ~2 byte-comparisons per position plus a
        num_blocks-way state select.
        """
        g = self.gate
        ctx = self.ctx
        assert len(byte_cells) == max_len == len(byte_vals)
        assert 0 <= len_val <= max_len
        n_blocks = (max_len + 8) // 64 + 1
        total = 64 * n_blocks

        # bit-length as 8 BE bytes, bound to len_cell (arithmetic, not
        # int.to_bytes, so traced len_val values stay on the replay DAG)
        bl = [((8 * len_val) >> (8 * (7 - j))) & 0xFF for j in range(8)]
        len_bytes = []
        for j, bv in enumerate(bl):
            c = ctx.push(bv)
            self.rc.range_check(c, 8)
            len_bytes.append((c, bv))
        recon = g.inner_product_const(
            [c for c, _ in len_bytes], [1 << (8 * (7 - j)) for j in range(8)]
        )
        eight_len = g.mul_const(len_cell, 8)
        g.assert_equal(recon, eight_len)

        # final-block index fb = (len + 8) // 64, r = (len + 8) % 64
        fb_val, r_val = divmod(len_val + 8, 64)
        fb = ctx.push(fb_val)
        rr = ctx.push(r_val)
        self.rc.range_check(fb, max(n_blocks.bit_length(), 1))
        self.rc.range_check(rr, 6)
        recon2 = g.mul_const_add(fb, 64, rr)
        g.assert_equal(recon2, g.add_const(len_cell, 8))

        # padded message: for each position i select message/0x80/len/zero
        cells, vals = [], []
        zero_c = ctx.constant(0)
        for i in range(total):
            if i < max_len:
                lt = self.rc.is_less_than(
                    ctx.constant(i), len_cell, max(max_len.bit_length() + 1, 8)
                )
                eq = g.is_equal(ctx.constant(i), len_cell)
                # v = lt * msg + eq * 0x80 (+ length-field contribution below)
                v = g.mul_add(lt, byte_cells[i], g.mul_const(eq, 0x80))
                val = (byte_vals[i] if i < len_val else 0) + (0x80 if i == len_val else 0)
            else:
                eq = g.is_equal(ctx.constant(i), len_cell)
                v = g.mul_const(eq, 0x80)
                val = 0x80 if i == len_val else 0
            # length field: position i belongs to block floor(i/64) at offset
            # i%64; it carries len_bytes[j] iff i = 64*(fb+1) - 8 + j
            off = i % 64
            if off >= 56:
                j = off - 56
                blk_of_i = i // 64
                in_len_field = g.is_equal(fb, ctx.constant(blk_of_i))
                v = g.mul_add(in_len_field, len_bytes[j][0], v)
                if blk_of_i == fb_val:
                    val += bl[j]
            cells.append(v)
            vals.append(val)
            assert val < 256

        states = self._compress_blocks(cells, vals)
        # select the state after block fb (i.e. states[fb + 1 - 1] post-chain):
        # digest = state after processing blocks 0..fb inclusive
        out_words = []
        for wi in range(8):
            acc = None
            val_sel = 0
            for b in range(n_blocks):
                eq = g.is_equal(fb, ctx.constant(b))
                term = g.mul(eq, states[b][wi].dense)
                acc = term if acc is None else g.add(acc, term)
                if b == fb_val:
                    val_sel = states[b][wi].value
            out_words.append(_Word(acc, val_sel))
        return self._words_to_bytes(out_words)

    def _compress_blocks(self, cells: list[int], vals: list[int]):
        """Run compression over every 64-byte block; returns the list of
        chaining states AFTER each block."""
        g = self.gate
        state = [self.const_word(h) for h in H_INIT]
        states_after = []
        for blk in range(len(cells) // 64):
            state = self._compress_one(
                cells[64 * blk : 64 * (blk + 1)], vals[64 * blk : 64 * (blk + 1)], state
            )
            states_after.append(state)
        return states_after

    def _words_to_bytes(self, words) -> list[tuple[int, int]]:
        g = self.gate
        out = []
        for wrd in words:
            bvals = [(wrd.value >> s) & 0xFF for s in (24, 16, 8, 0)]
            bcells = [self.ctx.push(v) for v in bvals]
            for bc in bcells:
                self.rc.range_check(bc, 8)
            recon = g.inner_product_const(bcells, [1 << 24, 1 << 16, 1 << 8, 1])
            g.assert_equal(recon, wrd.dense)
            out.extend(zip(bcells, bvals))
        return out

    def digest_bytes(self, byte_cells: list[int], byte_vals: list[int]) -> list[tuple[int, int]]:
        """SHA-256 of a fixed-length byte-cell message.

        byte_cells: cells holding 8-bit values (caller range-checks them or
        they come from this chip's own byte decomposition); returns
        [(cell, value)] of the 32 digest bytes.
        """
        g = self.gate
        n = len(byte_cells)
        assert n == len(byte_vals)
        # padding (constants)
        pad = [0x80]
        while (n + len(pad)) % 64 != 56:
            pad.append(0)
        pad += list((8 * n).to_bytes(8, "big"))
        cells = list(byte_cells) + [self.ctx.constant(b) for b in pad]
        vals = list(byte_vals) + pad
        assert len(cells) % 64 == 0

        states = self._compress_blocks(cells, vals)
        return self._words_to_bytes(states[-1])

    def _compress_one(self, block_cells, block_vals, state):
        g = self.gate
        w_words = []
        for i in range(16):
            bc = block_cells[4 * i : 4 * i + 4]
            bv = block_vals[4 * i : 4 * i + 4]
            word_cell = g.inner_product_const(bc, [1 << 24, 1 << 16, 1 << 8, 1])
            word_val = (bv[0] << 24) | (bv[1] << 16) | (bv[2] << 8) | bv[3]
            w_words.append(self.word_from_cell(word_cell, word_val))
        for t in range(16, 64):
            s0 = self.sigma0(w_words[t - 15])
            s1 = self.sigma1(w_words[t - 2])
            w_words.append(self.add_mod32([s1, w_words[t - 7], s0, w_words[t - 16]]))

        a, b, c, d, e, f, gg, h = state
        for t in range(64):
            S1 = self.Sigma1(e)
            ch = self.ch(e, f, gg)
            t1 = self.add_mod32([h, S1, ch, w_words[t]], [K_CONSTS[t]])
            S0 = self.Sigma0(a)
            mj = self.maj(a, b, c)
            t2 = self.add_mod32([S0, mj])
            h, gg, f = gg, f, e
            e = self.add_mod32([d, t1])
            d, c, b = c, b, a
            a = self.add_mod32([t1, t2])
        return [
            self.add_mod32([x, y]) for x, y in zip(state, [a, b, c, d, e, f, gg, h])
        ]


# QuantumCell aliases used inside the chip
from .context import C as C_, E as E_, W as W_  # noqa: E402
