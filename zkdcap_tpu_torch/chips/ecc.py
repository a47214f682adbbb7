"""In-circuit elliptic-curve chip over a non-native field (halo2-ecc EccChip).

A copy of ``zkdcap_tpu/chips/ecc.py`` (host Python, no device work); the
layout, and with it the pinning, the vk and the proofs, depend on every
detail of it, so it stays line for line the JAX package's.

Reference semantics (SURVEY.md §2.2 D-ECC2/4: EccChip, windowed scalar
multiplication with window 4, `ecdsa_verify_no_pubkey_check(..., 4, 4)` at
`circuits/src/sgx_dcap_verifier.rs:701-710` / `crates/p256-ecdsa/src/circuit.rs:51`).

Points are affine pairs of canonical CRT integers; there is no in-circuit
identity. Exceptional cases (x1 == x2 in an addition) are *unsatisfiable*
rather than unsound: every lambda uses `BigIntChip.inv`, whose constraint
a * a^-1 = 1 cannot be met when the denominator is zero. Scalar
multiplication uses the Strauss windowed method over auxiliary base points
with unknown discrete log (derived by try-and-increment hashing), so
accumulators never meet the table points except with negligible
probability — the same completeness argument halo2-ecc's strict adds rely
on.
"""

from __future__ import annotations

import dataclasses
import hashlib

from ..curves.host_curve import CurveParams
from .bigint import BigIntChip, CRTInt

R_NATIVE = None  # (bn254 r lives in chips.bigint)


@dataclasses.dataclass
class EcPoint:
    x: CRTInt
    y: CRTInt
    # tracked host value for witness generation
    host: tuple[int, int]


def aux_point(curve: CurveParams, tag: bytes) -> tuple[int, int]:
    """Nothing-up-my-sleeve curve point via try-and-increment hashing."""
    ctr = 0
    while True:
        h = hashlib.blake2b(b"zkdcap-aux:" + tag + ctr.to_bytes(4, "little")).digest()
        x = int.from_bytes(h, "little") % curve.p
        rhs = (x * x * x + curve.a * x + curve.b) % curve.p
        # p % 4 == 3 for both our curves -> sqrt via exponent
        y = pow(rhs, (curve.p + 1) // 4, curve.p)
        if y * y % curve.p == rhs:
            return (x, y)
        ctr += 1


class EccChip:
    def __init__(self, fp: BigIntChip, curve: CurveParams):
        self.fp = fp
        self.curve = curve
        assert fp.p == curve.p

    # --- loading ----------------------------------------------------------

    def load_private(self, pt: tuple[int, int], check_on_curve: bool = False) -> EcPoint:
        x = self.fp.load_private(pt[0])
        y = self.fp.load_private(pt[1])
        P = EcPoint(x, y, (pt[0], pt[1]))
        if check_on_curve:
            self.assert_on_curve(P)
        return P

    def load_constant(self, pt: tuple[int, int]) -> EcPoint:
        return EcPoint(self.fp.load_constant(pt[0]), self.fp.load_constant(pt[1]), pt)

    def assert_on_curve(self, P: EcPoint) -> None:
        fp = self.fp
        x2 = fp.mul(P.x, P.x)
        x3 = fp.mul(x2, P.x)
        y2 = fp.mul(P.y, P.y)
        ax = fp.mul(fp.load_constant(self.curve.a), P.x)
        rhs = fp.add(fp.add(x3, ax), fp.load_constant(self.curve.b))
        fp.assert_congruent(y2, rhs)

    def neg(self, P: EcPoint) -> EcPoint:
        return EcPoint(P.x, self.fp.neg(P.y), self.curve.neg_pt(P.host))

    def select(self, P: EcPoint, Q: EcPoint, sel: int) -> EcPoint:
        # traced select on the host shadow point too (witness replay)
        from ..witness.tracer import t_sel

        sv = self.fp.ctx.value(sel)
        host = (t_sel(sv, P.host[0], Q.host[0]), t_sel(sv, P.host[1], Q.host[1]))
        return EcPoint(
            self.fp.select(P.x, Q.x, sel), self.fp.select(P.y, Q.y, sel), host
        )

    # --- group law (incomplete affine; exceptions unsatisfiable) ----------

    def _norm_coord(self, x):
        """Re-tighten a coordinate whose structural bounds grew too lazy."""
        from .bigint import LIMB_MASK

        p = self.fp.p
        if x.limb_bound > 8 * LIMB_MASK or x.vmax > 8 * p or x.vmin < -8 * p:
            return self.fp.reduce(x)
        return x

    def _norm(self, P: EcPoint) -> EcPoint:
        return EcPoint(self._norm_coord(P.x), self._norm_coord(P.y), P.host)

    def add_unequal(self, P: EcPoint, Q: EcPoint) -> EcPoint:
        fp = self.fp
        P = self._norm(P)
        Q = self._norm(Q)
        dx = fp.sub(Q.x, P.x)
        dy = fp.sub(Q.y, P.y)
        lam = fp.div_strict(dy, dx)  # strict: x1 == x2 is unsatisfiable
        lam2 = fp.mul(lam, lam)
        x3 = fp.sub(fp.sub(lam2, P.x), Q.x)
        y3 = fp.sub(fp.mul(lam, fp.sub(P.x, x3)), P.y)
        host = self.curve.add(P.host, Q.host)
        assert host is not None
        return EcPoint(x3, y3, host)

    def double(self, P: EcPoint) -> EcPoint:
        fp = self.fp
        P = self._norm(P)
        x2 = fp.mul(P.x, P.x)
        three_x2 = fp.add(fp.add(x2, x2), x2)
        num = fp.add(three_x2, fp.load_constant(self.curve.a))
        den = fp.add(P.y, P.y)
        lam = fp.div_strict(num, den)  # strict: y == 0 is unsatisfiable
        lam2 = fp.mul(lam, lam)
        x3 = fp.sub(fp.sub(lam2, P.x), P.x)
        y3 = fp.sub(fp.mul(lam, fp.sub(P.x, x3)), P.y)
        host = self.curve.add(P.host, P.host)
        return EcPoint(x3, y3, host)

    # --- scalar decomposition ---------------------------------------------

    def scalar_bits(self, s: CRTInt, bigint_chip: BigIntChip) -> list[int]:
        """CRT scalar -> 256 bit cells, LSB first, constrained to recompose."""
        g = self.fp.gate
        ctx = self.fp.ctx
        bits: list[int] = []
        widths = [88, 88, 80]
        for limb_cell, width in zip(s.limbs, widths):
            lv = ctx.value(limb_cell)
            limb_bits = []
            for i in range(width):
                b = ctx.push((lv >> i) & 1)
                g.assert_bit(b)
                limb_bits.append(b)
            recon = g.inner_product_const(limb_bits, [1 << i for i in range(width)])
            g.assert_equal(recon, limb_cell)
            bits.extend(limb_bits)
        return bits

    # --- Strauss multi-scalar multiplication (window 4) --------------------

    def msm_window4(self, points: list[EcPoint], bit_lists: list[list[int]]) -> EcPoint:
        """sum_i s_i P_i; bit_lists are LSB-first bit cells (equal length,
        multiple of 4). Window size 4 matches the reference's (4, 4) params."""
        g = self.fp.gate
        curve = self.curve
        nbits = len(bit_lists[0])
        assert all(len(b) == nbits for b in bit_lists) and nbits % 4 == 0
        n_windows = nbits // 4

        # per-base tables T_i[d] = aux_i + d * P_i
        tables = []
        aux_hosts = []
        for i, P in enumerate(points):
            aux = self.load_constant(aux_point(curve, b"table%d" % i))
            aux_hosts.append(aux.host)
            tab = [aux]
            for d in range(1, 16):
                tab.append(self.add_unequal(tab[-1], P))
            tables.append(tab)

        acc_aux_host = aux_point(curve, b"acc")
        acc = self.load_constant(acc_aux_host)

        def select16(table: list[EcPoint], b0, b1, b2, b3) -> EcPoint:
            # binary select tree, bits LSB->MSB
            level = table
            for bit in (b0, b1, b2, b3):
                nxt = []
                for j in range(0, len(level), 2):
                    nxt.append(self.select(level[j + 1], level[j], bit))
                level = nxt
            return level[0]

        for w in range(n_windows - 1, -1, -1):
            if w != n_windows - 1:
                for _ in range(4):
                    acc = self.double(acc)
            for i, (P, bl) in enumerate(zip(points, bit_lists)):
                b0, b1, b2, b3 = bl[4 * w : 4 * w + 4]
                t = select16(tables[i], b0, b1, b2, b3)
                acc = self.add_unequal(acc, t)

        # correction: acc = 16^(W-1)... precisely:
        #   acc = 2^(4W) ... doublings applied (W-1) times *after* first adds:
        #   acc = 16^(W-1) * (C + sum_i T-contrib of top window) + ...
        # total = 16^(W-1) C + sum_w 16^w sum_i (aux_i + d_{i,w} P_i)
        #       = 16^(W-1) C + K sum_i aux_i + sum_i s_i P_i,  K = (16^W - 1)/15
        K = ((1 << (4 * n_windows)) - 1) // 15
        corr = curve.mul(1 << (4 * (n_windows - 1)), acc_aux_host)
        for ah in aux_hosts:
            corr = curve.add(corr, curve.mul(K, ah))
        corr_neg = self.load_constant(curve.neg_pt(corr))
        return self.add_unequal(acc, corr_neg)

    def scalar_mul(self, P: EcPoint, bits: list[int]) -> EcPoint:
        return self.msm_window4([P], [bits])
