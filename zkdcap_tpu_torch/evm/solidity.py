"""Solidity verifier generator — snark-verifier `EvmLoader` equivalent.

Reference flow (`crates/p256-ecdsa/src/base.rs:251-271`, SURVEY.md §3.5):
compile the vk into a protocol, symbolically run the verifier, emit
Solidity. Here the generator walks the same fixed verification structure as
`plonk/verifier.py` (same transcript layout, same challenge schedule, same
expected-h formula, same SHPLONK check) and emits straight-line Solidity:

  * Keccak transcript: challenge_i = keccak256(prev_digest || absorbed...),
    with proofs carrying uncompressed 64-byte points (see transcript/);
  * field ops via addmod/mulmod, inversions via the modexp precompile;
  * EC ops via the ecAdd(0x06)/ecMul(0x07) precompiles and the final
    SHPLONK check via the pairing precompile (0x08);
  * gate expressions compiled from the Expression AST into mulmod chains.

The emitted source is compiled by the in-repo Solidity-subset compiler
(evm/solc.py) and executed by the in-repo EVM interpreter (evm/interp.py) —
`verify --evm` and the prover's debug self-verification run the contract on
real calldata, mirroring the reference's solc+revm flow (base.rs:218-221,
bin/src/main.rs:233-238; accept/reject tested in tests/test_evm_exec.py).

Port of ``zkdcap_tpu/evm/solidity.py``: it reads the port's vk, constraint
system and expression nodes, which give the same ints in the same order, and
emits the same source character for character. Commitments reach it as host
``(x, y)`` int tuples.
"""

from __future__ import annotations

from ..commit.kzg import ParamsKZG
from ..fields import BN254_FR
from ..plonk.expression import (
    Advice,
    Challenge,
    Constant,
    Fixed,
    Instance,
    Negated,
    Product,
    Scaled,
    Sum,
)
from ..plonk.keygen import DELTA, VerifyingKey, collect_queries

R = BN254_FR.p


class _Emitter:
    def __init__(self):
        self.lines: list[str] = []
        self.tmp = 0

    def fresh(self, prefix="t") -> str:
        self.tmp += 1
        return f"{prefix}{self.tmp}"

    def emit(self, line: str):
        self.lines.append("        " + line)


def _expr_code(e, em: _Emitter, adv, fix, ins, challenges) -> str:
    if isinstance(e, Constant):
        return f"0x{e.value % R:x}"
    if isinstance(e, Challenge):
        return challenges[e.name]
    if isinstance(e, Advice):
        return adv[(e.index, e.rotation)]
    if isinstance(e, Fixed):
        return fix[(e.index, e.rotation)]
    if isinstance(e, Instance):
        return ins[(e.index, e.rotation)]
    if isinstance(e, Negated):
        inner = _expr_code(e.inner, em, adv, fix, ins, challenges)
        v = em.fresh()
        em.emit(f"uint256 {v} = R - ({inner}) % R;")
        return v
    if isinstance(e, Sum):
        a = _expr_code(e.a, em, adv, fix, ins, challenges)
        b = _expr_code(e.b, em, adv, fix, ins, challenges)
        v = em.fresh()
        em.emit(f"uint256 {v} = addmod({a}, {b}, R);")
        return v
    if isinstance(e, Product):
        a = _expr_code(e.a, em, adv, fix, ins, challenges)
        b = _expr_code(e.b, em, adv, fix, ins, challenges)
        v = em.fresh()
        em.emit(f"uint256 {v} = mulmod({a}, {b}, R);")
        return v
    if isinstance(e, Scaled):
        a = _expr_code(e.inner, em, adv, fix, ins, challenges)
        v = em.fresh()
        em.emit(f"uint256 {v} = mulmod({a}, 0x{e.scalar % R:x}, R);")
        return v
    raise TypeError(e)


def gen_evm_verifier(params: ParamsKZG, vk: VerifyingKey, num_instances: int,
                     multiopen: str = "shplonk") -> str:
    """multiopen selects the final KZG argument the contract checks —
    "shplonk" (the reference's pick, `base.rs:266-269`) or "gwc"; it must
    match the prover's choice (proof layout differs: GWC carries one W
    point per distinct opening point instead of SHPLONK's fixed H+W)."""
    assert multiopen in ("shplonk", "gwc"), multiopen
    cs = vk.cs
    k = vk.k
    n = 1 << k
    u = cs.usable_rows(n)
    omega = BN254_FR.nth_root_of_unity(k)
    omega_inv = pow(omega, -1, R)
    adv_q, fix_q, ins_q = collect_queries(cs)
    m = len(cs.permutation_columns)
    chunk = cs.permutation_chunk_len
    num_chunks = (m + chunk - 1) // chunk if m else 0
    n_lookups = len(cs.lookups)
    n_h = cs.quotient_pieces()

    em = _Emitter()
    E = em.emit

    # ---- calldata layout -------------------------------------------------
    # [0 .. 32*NI): instances; then proof with uncompressed points (64B)
    E(f"uint256 PROOF = 32 * {num_instances};")
    off = [0]  # proof byte offset tracker (python-side)

    def rd_scalar(name):
        # canonicality: reject s >= r instead of reducing (matches the
        # native TranscriptReader)
        E(f"uint256 {name} = calldataloadp(PROOF + {off[0]});")
        E(f'require({name} < R, "scalar");')
        off[0] += 32

    def rd_point(name):
        E(f"uint256 {name}x = calldataloadp(PROOF + {off[0]});")
        E(f"uint256 {name}y = calldataloadp(PROOF + {off[0] + 32});")
        E(f'require({name}x < Q && {name}y < Q, "coord");')
        off[0] += 64

    # transcript: the native prover's first absorbed element is the vk
    # transcript repr (prover.py round 0), so the generated contract seeds
    # its keccak buffer with the same constant (a bytes32(0) seed would make
    # every challenge diverge)
    absorbed: list[str] = [f"bytes32(uint256(0x{vk.transcript_repr():064x}))"]

    def absorb_point(namex, namey):
        absorbed.append(f"bytes32({namex})")
        absorbed.append(f"bytes32({namey})")

    def absorb_scalar(name):
        absorbed.append(f"bytes32({name})")

    def squeeze(chal):
        packed = ", ".join(absorbed)
        E(f"bytes32 st_{chal} = keccak256(abi.encodePacked({packed}));")
        E(f"uint256 {chal} = uint256(st_{chal}) % R;")
        absorbed.clear()
        absorbed.append(f"st_{chal}")

    # instances absorbed first (as scalars; must be canonical field elements)
    for i in range(num_instances):
        E(f"uint256 inst{i} = calldataloadp({32 * i});")
        E(f'require(inst{i} < R, "instance");')
        absorb_scalar(f"inst{i}")

    # round 1: advice commitments
    for ci in range(cs.num_advice):
        rd_point(f"a{ci}")
        absorb_point(f"a{ci}x", f"a{ci}y")
    squeeze("theta")
    for li in range(n_lookups):
        rd_point(f"lkA{li}")
        absorb_point(f"lkA{li}x", f"lkA{li}y")
        rd_point(f"lkS{li}")
        absorb_point(f"lkS{li}x", f"lkS{li}y")
    squeeze("beta")
    squeeze("gamma")
    for c in range(num_chunks):
        rd_point(f"pz{c}")
        absorb_point(f"pz{c}x", f"pz{c}y")
    for li in range(n_lookups):
        rd_point(f"lz{li}")
        absorb_point(f"lz{li}x", f"lz{li}y")
    rd_point("rnd")
    absorb_point("rndx", "rndy")
    squeeze("y")
    for i in range(n_h):
        rd_point(f"h{i}")
        absorb_point(f"h{i}x", f"h{i}y")
    squeeze("x")

    # evals
    adv_evals = {}
    for (ci, rot) in adv_q:
        nm = f"ea{ci}_{rot}".replace("-", "m")
        rd_scalar(nm)
        absorb_scalar(nm)
        adv_evals[(ci, rot)] = nm
    fix_evals = {}
    for (ci, rot) in fix_q:
        nm = f"ef{ci}_{rot}".replace("-", "m")
        rd_scalar(nm)
        absorb_scalar(nm)
        fix_evals[(ci, rot)] = nm
    rd_scalar("erand")
    absorb_scalar("erand")
    sigma_evals = []
    for i in range(m):
        rd_scalar(f"es{i}")
        absorb_scalar(f"es{i}")
        sigma_evals.append(f"es{i}")
    perm_z_evals = []
    for c in range(num_chunks):
        rd_scalar(f"ez{c}")
        absorb_scalar(f"ez{c}")
        rd_scalar(f"ezw{c}")
        absorb_scalar(f"ezw{c}")
        last = None
        if c + 1 < num_chunks:
            rd_scalar(f"ezl{c}")
            absorb_scalar(f"ezl{c}")
            last = f"ezl{c}"
        perm_z_evals.append((f"ez{c}", f"ezw{c}", last))
    lookup_evals = []
    for li in range(n_lookups):
        names = [f"elz{li}", f"elzw{li}", f"elA{li}", f"elAp{li}", f"elS{li}"]
        for nm in names:
            rd_scalar(nm)
            absorb_scalar(nm)
        lookup_evals.append(names)

    # ---- instance evals (barycentric over provided instances) ------------
    E("uint256 xn = expmod(x, N, R);")
    E("uint256 znum = addmod(xn, R - 1, R);  // x^n - 1")
    ins_evals = {}
    for (ci, rot) in ins_q:
        pt = em.fresh("ip")
        wrot = pow(omega, rot, R) if rot >= 0 else pow(omega_inv, -rot, R)
        E(f"uint256 {pt} = mulmod(x, 0x{wrot:x}, R);")
        E(f"uint256 {pt}n = addmod(expmod({pt}, N, R), R - 1, R);")
        acc = em.fresh("iv")
        E(f"uint256 {acc} = 0;")
        E(f"for (uint256 j = 0; j < {num_instances}; j++) {{")
        E(f"    uint256 wj = expmod(OMEGA, j, R);")
        E(f"    uint256 den = addmod({pt}, R - wj, R);")
        E(f"    uint256 lj = mulmod(mulmod(wj, NINV, R), mulmod({pt}n, invmod(den), R), R);")
        E(f"    {acc} = addmod({acc}, mulmod(calldataloadp(32 * j) % R, lj, R), R);")
        E("}")
        ins_evals[(ci, rot)] = acc

    # ---- lagrange selectors ----------------------------------------------
    E(f"uint256 l0 = lagrange(0, x, znum);")
    E(f"uint256 llast = lagrange({u}, x, znum);")
    E("uint256 lblind = 0;")
    for j in range(u + 1, n):
        E(f"lblind = addmod(lblind, lagrange({j}, x, znum), R);")
    E("uint256 active = addmod(1, R - addmod(llast, lblind, R), R);")

    # ---- expected h(x) ----------------------------------------------------
    challenges = {"theta": "theta", "beta": "beta", "gamma": "gamma"}
    constraint_terms: list[str] = []
    for g in cs.gates:
        for poly in g.polys:
            constraint_terms.append(
                _expr_code(poly, em, adv_evals, fix_evals, ins_evals, challenges)
            )
    if m:
        col_eval = {}
        for i, col in enumerate(cs.permutation_columns):
            src = {"advice": adv_evals, "fixed": fix_evals, "instance": ins_evals}[col.kind]
            col_eval[i] = src[(col.index, 0)]
        t = em.fresh()
        E(f"uint256 {t} = mulmod(l0, addmod(1, R - {perm_z_evals[0][0]}, R), R);")
        constraint_terms.append(t)
        zl = perm_z_evals[-1][0]
        t = em.fresh()
        E(f"uint256 {t} = mulmod(llast, addmod(mulmod({zl}, {zl}, R), R - {zl}, R), R);")
        constraint_terms.append(t)
        for c in range(1, num_chunks):
            t = em.fresh()
            E(f"uint256 {t} = mulmod(l0, addmod({perm_z_evals[c][0]}, R - {perm_z_evals[c-1][2]}, R), R);")
            constraint_terms.append(t)
        for ci2, c0 in enumerate(range(0, m, chunk)):
            cols = list(range(c0, min(c0 + chunk, m)))
            left = em.fresh("pl")
            right = em.fresh("pr")
            E(f"uint256 {left} = {perm_z_evals[ci2][1]};")
            E(f"uint256 {right} = {perm_z_evals[ci2][0]};")
            for i in cols:
                E(f"{left} = mulmod({left}, addmod(addmod({col_eval[i]}, mulmod(beta, {sigma_evals[i]}, R), R), gamma, R), R);")
                di = DELTA and pow(DELTA, i, R)
                E(f"{right} = mulmod({right}, addmod(addmod({col_eval[i]}, mulmod(mulmod(beta, 0x{di:x}, R), x, R), R), gamma, R), R);")
            t = em.fresh()
            E(f"uint256 {t} = mulmod(active, addmod({left}, R - {right}, R), R);")
            constraint_terms.append(t)
    for lk, names in zip(cs.lookups, lookup_evals):
        zx, zwx, apx, apxp, spx = names
        acc_a = em.fresh("la")
        acc_s = em.fresh("ls")
        E(f"uint256 {acc_a} = 0; uint256 {acc_s} = 0; ")
        # block-scope tpow: it is re-declared per lookup argument
        E("{")
        E("uint256 tpow = 1;")
        for e_in, e_tb in zip(lk.inputs, lk.tables):
            ca = _expr_code(e_in, em, adv_evals, fix_evals, ins_evals, challenges)
            ct = _expr_code(e_tb, em, adv_evals, fix_evals, ins_evals, challenges)
            E(f"{acc_a} = addmod({acc_a}, mulmod(tpow, {ca}, R), R);")
            E(f"{acc_s} = addmod({acc_s}, mulmod(tpow, {ct}, R), R);")
            E("tpow = mulmod(tpow, theta, R);")
        E("}")
        for code in (
            f"mulmod(l0, addmod(1, R - {zx}, R), R)",
            f"mulmod(llast, addmod(mulmod({zx}, {zx}, R), R - {zx}, R), R)",
            f"mulmod(active, addmod(mulmod({zwx}, mulmod(addmod({apx}, beta, R), addmod({spx}, gamma, R), R), R), R - mulmod({zx}, mulmod(addmod({acc_a}, beta, R), addmod({acc_s}, gamma, R), R), R), R), R)",
            f"mulmod(l0, addmod({apx}, R - {spx}, R), R)",
            f"mulmod(active, mulmod(addmod({apx}, R - {spx}, R), addmod({apx}, R - {apxp}, R), R), R)",
        ):
            t = em.fresh()
            E(f"uint256 {t} = {code};")
            constraint_terms.append(t)

    E("uint256 hacc = 0; uint256 ypow = 1;")
    for t in constraint_terms:
        E(f"hacc = addmod(hacc, mulmod(ypow, {t}, R), R); ypow = mulmod(ypow, y, R);")
    E("uint256 expectedH = mulmod(hacc, invmod(znum), R);")

    # ---- combined h commitment: sum x^(n*i) C_hi -------------------------
    E("uint256 hcx = h0x; uint256 hcy = h0y; uint256 xni = xn;")
    for i in range(1, n_h):
        E(f"{{ (uint256 tx, uint256 ty) = ecMul(h{i}x, h{i}y, xni); (hcx, hcy) = ecAdd(hcx, hcy, tx, ty); xni = mulmod(xni, xn, R); }}")

    # ---- SHPLONK multiopen -----------------------------------------------
    # rebuild the prover's query list: (name, point-coeff c where point = x*c)
    W_U = pow(omega, u, R)

    def rotc(rot):
        return pow(omega, rot, R) if rot >= 0 else pow(omega_inv, -rot, R)

    queries: list[tuple[str, int]] = []
    commit_expr: dict[str, tuple[str, str]] = {}
    eval_expr: dict[tuple[str, int], str] = {}
    for (ci, rot) in adv_q:
        queries.append((f"advice{ci}", rotc(rot)))
        commit_expr[f"advice{ci}"] = (f"a{ci}x", f"a{ci}y")
        eval_expr[(f"advice{ci}", rotc(rot))] = adv_evals[(ci, rot)]
    for (ci, rot) in fix_q:
        queries.append((f"fixed{ci}", rotc(rot)))
        c = vk.fixed_commitments[ci] or (0, 0)
        commit_expr[f"fixed{ci}"] = (f"0x{c[0]:x}", f"0x{c[1]:x}")
        eval_expr[(f"fixed{ci}", rotc(rot))] = fix_evals[(ci, rot)]
    queries.append(("random", 1))
    commit_expr["random"] = ("rndx", "rndy")
    eval_expr[("random", 1)] = "erand"
    for i in range(m):
        queries.append((f"sigma{i}", 1))
        c = vk.permutation_commitments[i] or (0, 0)
        commit_expr[f"sigma{i}"] = (f"0x{c[0]:x}", f"0x{c[1]:x}")
        eval_expr[(f"sigma{i}", 1)] = sigma_evals[i]
    queries.append(("h", 1))
    commit_expr["h"] = ("hcx", "hcy")
    eval_expr[("h", 1)] = "expectedH"
    for c_i in range(num_chunks):
        nm = f"permz{c_i}"
        commit_expr[nm] = (f"pz{c_i}x", f"pz{c_i}y")
        queries.append((nm, 1))
        eval_expr[(nm, 1)] = perm_z_evals[c_i][0]
        queries.append((nm, rotc(1)))
        eval_expr[(nm, rotc(1))] = perm_z_evals[c_i][1]
        if c_i + 1 < num_chunks:
            queries.append((nm, W_U))
            eval_expr[(nm, W_U)] = perm_z_evals[c_i][2]
    for li in range(n_lookups):
        zx, zwx, apx, apxp, spx = lookup_evals[li]
        commit_expr[f"lkz{li}"] = (f"lz{li}x", f"lz{li}y")
        commit_expr[f"lkA{li}"] = (f"lkA{li}x", f"lkA{li}y")
        commit_expr[f"lkS{li}"] = (f"lkS{li}x", f"lkS{li}y")
        for nm, pc, ev in (
            (f"lkz{li}", 1, zx),
            (f"lkz{li}", rotc(1), zwx),
            (f"lkA{li}", 1, apx),
            (f"lkA{li}", rotc(-1), apxp),
            (f"lkS{li}", 1, spx),
        ):
            queries.append((nm, pc))
            eval_expr[(nm, pc)] = ev

    if multiopen == "gwc":
        # ---- GWC multiopen (commit/gwc.py gwc_verify in Solidity) --------
        # group queries by opening point, first-appearance order
        order_pcs: list[int] = []
        names_at: dict[int, list[str]] = {}
        for nm, pc in queries:
            if pc not in names_at:
                names_at[pc] = []
                order_pcs.append(pc)
            if nm not in names_at[pc]:
                names_at[pc].append(nm)
        # transcript: v squeezed; one W point per group read; u squeezed
        squeeze("vg")
        for i in range(len(order_pcs)):
            rd_point(f"WG{i}")
            absorb_point(f"WG{i}x", f"WG{i}y")
        squeeze("ug")
        # w_multi = sum u^i W_i ; rhs = sum u^i (z_i W_i + C_i) - e_multi G
        E("uint256 wmx = 0; uint256 wmy = 0; bool wmset = false;")
        E("uint256 rhx = 0; uint256 rhy = 0; bool rhset = false;")
        E("uint256 eMulti = 0; uint256 ugpow = 1;")
        for i, pc in enumerate(order_pcs):
            E("{")
            E("uint256 cbx = 0; uint256 cby = 0; bool cbset = false;")
            E("uint256 ebatch = 0; uint256 vp = 1;")
            for nm in names_at[pc]:
                cx, cy = commit_expr[nm]
                E(f"{{ (uint256 tx, uint256 ty) = ecMul({cx}, {cy}, vp);")
                E("if (cbset) { (cbx, cby) = ecAdd(cbx, cby, tx, ty); }"
                  " else { cbx = tx; cby = ty; cbset = true; } }")
                E(f"ebatch = addmod(ebatch, mulmod(vp, {eval_expr[(nm, pc)]}, R), R);")
                E("vp = mulmod(vp, vg, R);")
            E(f"{{ (uint256 tx, uint256 ty) = ecMul(WG{i}x, WG{i}y, ugpow);")
            E("if (wmset) { (wmx, wmy) = ecAdd(wmx, wmy, tx, ty); }"
              " else { wmx = tx; wmy = ty; wmset = true; } }")
            E(f"{{ (uint256 tx, uint256 ty) = ecMul(WG{i}x, WG{i}y,"
              f" mulmod(ugpow, mulmod(x, 0x{pc:x}, R), R));")
            E("if (rhset) { (rhx, rhy) = ecAdd(rhx, rhy, tx, ty); }"
              " else { rhx = tx; rhy = ty; rhset = true; } }")
            E("{ (uint256 tx, uint256 ty) = ecMul(cbx, cby, ugpow);")
            E("  (rhx, rhy) = ecAdd(rhx, rhy, tx, ty); }")
            E("eMulti = addmod(eMulti, mulmod(ugpow, ebatch, R), R);")
            E("ugpow = mulmod(ugpow, ug, R);")
            E("}")
        E("{ (uint256 tx, uint256 ty) = ecMul(1, 2, R - eMulti);")
        E("  (rhx, rhy) = ecAdd(rhx, rhy, tx, ty); }")
        # pairing: e(w_multi, sG2) * e(-rhs, G2) == 1
        g2 = params.srs.g2
        sg2 = params.srs.s_g2
        E("uint256[12] memory pin;")
        E("pin[0] = wmx; pin[1] = wmy;")
        E(f"pin[2] = 0x{sg2[0].c1:x}; pin[3] = 0x{sg2[0].c0:x};")
        E(f"pin[4] = 0x{sg2[1].c1:x}; pin[5] = 0x{sg2[1].c0:x};")
        E("pin[6] = rhx; pin[7] = rhy == 0 ? 0 : Q - rhy;")
        E(f"pin[8] = 0x{g2[0].c1:x}; pin[9] = 0x{g2[0].c0:x};")
        E(f"pin[10] = 0x{g2[1].c1:x}; pin[11] = 0x{g2[1].c0:x};")
        E("(bool pok, bytes memory pout) = address(0x08).staticcall(abi.encode(pin));")
        E('require(pok && abi.decode(pout, (uint256)) == 1, "pairing");')
        return _wrap_contract(em, k, n, omega, num_instances, multiopen)

    # group names by their point-coefficient set (insertion order)
    name_points: dict[str, list[int]] = {}
    for nm, pc in queries:
        name_points.setdefault(nm, [])
        if pc not in name_points[nm]:
            name_points[nm].append(pc)
    sets: dict[frozenset, list[str]] = {}
    for nm, pcs in name_points.items():
        sets.setdefault(frozenset(pcs), []).append(nm)
    rot_sets = list(sets.items())

    # shplonk transcript: y, v squeezed; H read; u squeezed; W read
    squeeze("ysh")
    squeeze("vsh")
    rd_point("HH")
    absorb_point("HHx", "HHy")
    squeeze("usher")
    rd_point("WW")

    all_pcs = sorted({pc for pcs, _ in rot_sets for pc in pcs})
    for i, pc in enumerate(all_pcs):
        E(f"uint256 pt{i} = mulmod(x, 0x{pc:x}, R);")
    pc_var = {pc: f"pt{i}" for i, pc in enumerate(all_pcs)}
    E("uint256 zT = 1;")
    for pc in all_pcs:
        E(f"zT = mulmod(zT, addmod(usher, R - {pc_var[pc]}, R), R);")

    E("uint256 accx = 0; uint256 accy = 0; bool accset = false;")
    E("uint256 scalarG = 0; uint256 vpow = 1;")
    for point_set, names in rot_sets:
        pcs = sorted(point_set)
        E("{")
        E("uint256 zother = 1;")
        for pc in all_pcs:
            if pc not in point_set:
                E(f"zother = mulmod(zother, addmod(usher, R - {pc_var[pc]}, R), R);")
        E("uint256 scale = mulmod(vpow, zother, R);")
        E("uint256 ypow2 = 1; uint256 rku = 0;")
        for nm in names:
            # interpolate this poly's evals over pcs, evaluated at u
            E("{ uint256 rj = 0;")
            for t_i, pc in enumerate(pcs):
                E(f"uint256 li{t_i} = 1;")
                for t_j, pc2 in enumerate(pcs):
                    if t_j == t_i:
                        continue
                    E(f"li{t_i} = mulmod(li{t_i}, addmod(usher, R - {pc_var[pc2]}, R), R);")
                    E(f"li{t_i} = mulmod(li{t_i}, invmod(addmod({pc_var[pc]}, R - {pc_var[pc2]}, R)), R);")
                E(f"rj = addmod(rj, mulmod({eval_expr[(nm, pc)]}, li{t_i}, R), R);")
            E("rku = addmod(rku, mulmod(ypow2, rj, R), R); }")
            cx, cy = commit_expr[nm]
            E(f"{{ (uint256 tx, uint256 ty) = ecMul({cx}, {cy}, mulmod(scale, ypow2, R));")
            E("if (accset) { (accx, accy) = ecAdd(accx, accy, tx, ty); } else { accx = tx; accy = ty; accset = true; } }")
            E("ypow2 = mulmod(ypow2, ysh, R);")
        E("scalarG = addmod(scalarG, mulmod(scale, rku, R), R);")
        E("vpow = mulmod(vpow, vsh, R);")
        E("}")
    # acc -= scalarG * G ; acc -= zT * H ; lhs = acc + u*W
    E("{ (uint256 tx, uint256 ty) = ecMul(1, 2, R - scalarG);")
    E("  (accx, accy) = ecAdd(accx, accy, tx, ty); }")
    E("{ (uint256 tx, uint256 ty) = ecMul(HHx, HHy, R - zT);")
    E("  (accx, accy) = ecAdd(accx, accy, tx, ty); }")
    E("{ (uint256 tx, uint256 ty) = ecMul(WWx, WWy, usher);")
    E("  (accx, accy) = ecAdd(accx, accy, tx, ty); }")

    # pairing: e(acc, G2) * e(-W, sG2) == 1
    g2 = params.srs.g2
    sg2 = params.srs.s_g2
    E("uint256[12] memory pin;")
    E("pin[0] = accx; pin[1] = accy;")
    E(f"pin[2] = 0x{g2[0].c1:x}; pin[3] = 0x{g2[0].c0:x};")
    E(f"pin[4] = 0x{g2[1].c1:x}; pin[5] = 0x{g2[1].c0:x};")
    E(f"pin[6] = WWx; pin[7] = WWy == 0 ? 0 : Q - WWy;")
    E(f"pin[8] = 0x{sg2[0].c1:x}; pin[9] = 0x{sg2[0].c0:x};")
    E(f"pin[10] = 0x{sg2[1].c1:x}; pin[11] = 0x{sg2[1].c0:x};")
    E("(bool pok, bytes memory pout) = address(0x08).staticcall(abi.encode(pin));")
    E('require(pok && abi.decode(pout, (uint256)) == 1, "pairing");')
    return _wrap_contract(em, k, n, omega, num_instances, multiopen)


def _wrap_contract(em: _Emitter, k: int, n: int, omega: int,
                   num_instances: int, multiopen: str) -> str:
    body = "\n".join(em.lines)

    contract = f"""// SPDX-License-Identifier: MIT
// Generated by zkdcap_tpu gen_evm_verifier (snark-verifier EvmLoader equivalent).
// Verifies proofs of the k={k} circuit with {num_instances} public inputs.
// NOTE: transcript challenge recomputation + expected-quotient evaluation are
// fully generated; the final {multiopen.upper()} pairing check consumes the
// generated values via the 0x06/0x07/0x08 precompiles (verifyMultiopen).
pragma solidity ^0.8.19;

contract Halo2Verifier {{
    uint256 constant R = 0x{R:x};
    uint256 constant Q = 0x{21888242871839275222246405745257275088696311157297823662689037894645226208583:x};
    uint256 constant N = {n};
    uint256 constant OMEGA = 0x{omega:x};
    uint256 constant NINV = 0x{pow(n, -1, R):x};

    function calldataloadp(uint256 o) internal pure returns (uint256 v) {{
        assembly {{ v := calldataload(o) }}
    }}

    function expmod(uint256 b, uint256 e, uint256 mod_) internal view returns (uint256 out) {{
        bool ok;
        (ok, ) = address(0x05).staticcall(abi.encode(32, 32, 32, b, e, mod_));
        require(ok, "expmod");
        assembly {{ returndatacopy(0, 0, 32) out := mload(0) }}
    }}

    function invmod(uint256 a) internal view returns (uint256) {{
        return expmod(a, R - 2, R);
    }}

    function lagrange(uint256 i, uint256 x, uint256 znum) internal view returns (uint256) {{
        uint256 wi = expmod(OMEGA, i, R);
        uint256 den = addmod(x, R - wi, R);
        return mulmod(mulmod(wi, NINV, R), mulmod(znum, invmod(den), R), R);
    }}

    function ecAdd(uint256 ax, uint256 ay, uint256 bx, uint256 by) internal view returns (uint256, uint256) {{
        (bool ok, bytes memory o) = address(0x06).staticcall(abi.encode(ax, ay, bx, by));
        require(ok, "ecAdd");
        return abi.decode(o, (uint256, uint256));
    }}

    function ecMul(uint256 ax, uint256 ay, uint256 s) internal view returns (uint256, uint256) {{
        (bool ok, bytes memory o) = address(0x07).staticcall(abi.encode(ax, ay, s));
        require(ok, "ecMul");
        return abi.decode(o, (uint256, uint256));
    }}

    fallback(bytes calldata) external returns (bytes memory) {{
{body}
        return hex"01";
    }}
}}
"""
    return contract
