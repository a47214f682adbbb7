"""PLONKish verifier (host-side; halo2 `verify_proof` equivalent).

A copy of ``zkdcap_tpu/plonk/verifier.py`` (SHPLONK or GWC multiopen), over
the port's constraint system and transcripts. It runs no device work.

Mirrors the prover's transcript layout exactly (see plonk/prover.py), then:
  * recomputes the expected quotient evaluation h(x) from the written evals
    (gates + permutation + lookup constraint formulas, y-combined in the
    same order as the prover),
  * rebuilds the combined quotient commitment sum_i x^{n i} C_{h_i},
  * delegates the batched opening check to SHPLONK (or GWC) + the BN254
    pairing.

Verification is host-scale (a few hundred G1 ops + 2 Miller loops),
matching the reference architecture (SURVEY.md §3.1 "verify_proof ...
pairing check; host-scale").
"""

from __future__ import annotations

from ..commit.gwc import gwc_verify
from ..commit.kzg import ParamsKZG
from ..commit.shplonk import VerifierQuery, shplonk_verify
from ..curves.host_curve import BN254_G1
from ..fields.params import BN254_FR
from ..transcript import TranscriptReader
from .cs import ConstraintSystem
from .expression import (
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
from .keygen import DELTA, VerifyingKey, collect_queries

R = BN254_FR.p


def _eval_expr(e, adv, fix, ins, challenges):
    if isinstance(e, Constant):
        return e.value % R
    if isinstance(e, Challenge):
        return challenges[e.name] % R
    if isinstance(e, Advice):
        return adv[(e.index, e.rotation)]
    if isinstance(e, Fixed):
        return fix[(e.index, e.rotation)]
    if isinstance(e, Instance):
        return ins[(e.index, e.rotation)]
    if isinstance(e, Negated):
        return (-_eval_expr(e.inner, adv, fix, ins, challenges)) % R
    if isinstance(e, Sum):
        return (
            _eval_expr(e.a, adv, fix, ins, challenges)
            + _eval_expr(e.b, adv, fix, ins, challenges)
        ) % R
    if isinstance(e, Product):
        return (
            _eval_expr(e.a, adv, fix, ins, challenges)
            * _eval_expr(e.b, adv, fix, ins, challenges)
        ) % R
    if isinstance(e, Scaled):
        return _eval_expr(e.inner, adv, fix, ins, challenges) * e.scalar % R
    raise TypeError(f"unknown expression {e!r}")


def _lagrange_at(i: int, x: int, n: int, omega: int) -> int:
    """l_i(x) = (omega^i / n) * (x^n - 1) / (x - omega^i)."""
    wi = pow(omega, i, R)
    num = (pow(x, n, R) - 1) % R
    den = (x - wi) % R
    return wi * pow(n, -1, R) % R * num % R * pow(den, -1, R) % R


def verify_proof(
    params: ParamsKZG,
    vk: VerifyingKey,
    instances: list[list[int]],
    proof: bytes,
    transcript_kind: str | None = None,
    multiopen: str = "shplonk",
) -> bool:
    """transcript_kind overrides vk.transcript_kind for this call (EVM keccak
    vs native path) without mutating the shared vk object (VERDICT round-1
    weak #8). multiopen names the final KZG argument and must match the
    prover's: "shplonk" (BDFG20, the reference's pick) or "gwc" (GWC19).

    A malformed proof (non-canonical scalar, off-curve or truncated point)
    is an INVALID proof, not an error — matching halo2's Result::Err =
    reject semantics."""
    if multiopen not in ("shplonk", "gwc"):
        raise ValueError(f"unknown multiopen {multiopen!r}")
    try:
        return _verify_proof(params, vk, instances, proof, transcript_kind,
                             multiopen)
    except (ValueError, IndexError):
        return False


def _verify_proof(
    params: ParamsKZG,
    vk: VerifyingKey,
    instances: list[list[int]],
    proof: bytes,
    transcript_kind: str | None,
    multiopen: str,
) -> bool:
    cs = vk.cs
    k = vk.k
    n = 1 << k
    u = cs.usable_rows(n)
    omega = BN254_FR.nth_root_of_unity(k)
    omega_inv = pow(omega, -1, R)
    curve = BN254_G1

    adv_q, fix_q, ins_q = collect_queries(cs)
    tr = TranscriptReader(proof, transcript_kind or vk.transcript_kind)
    tr.common_scalar(vk.transcript_repr())
    assert len(instances) == cs.num_instance
    for col in instances:
        for v in col:
            tr.common_scalar(v)

    adv_commits = [tr.read_point() for _ in range(cs.num_advice)]
    theta = tr.squeeze_challenge()
    lookup_perm_commits = []
    for _ in cs.lookups:
        a_c = tr.read_point()
        s_c = tr.read_point()
        lookup_perm_commits.append((a_c, s_c))
    beta = tr.squeeze_challenge()
    gamma = tr.squeeze_challenge()
    m = len(cs.permutation_columns)
    chunk = cs.permutation_chunk_len
    num_chunks = (m + chunk - 1) // chunk if m else 0
    perm_z_commits = [tr.read_point() for _ in range(num_chunks)]
    lookup_z_commits = [tr.read_point() for _ in cs.lookups]
    random_commit = tr.read_point()
    y = tr.squeeze_challenge()
    h_commits = [tr.read_point() for _ in range(cs.quotient_pieces())]
    x = tr.squeeze_challenge()

    def point_at(rot: int) -> int:
        if rot >= 0:
            return x * pow(omega, rot, R) % R
        return x * pow(omega_inv, -rot, R) % R

    # --- read evals in the prover's write order ---------------------------
    adv_evals: dict[tuple[int, int], int] = {}
    for (ci, rot) in adv_q:
        adv_evals[(ci, rot)] = tr.read_scalar()
    fix_evals: dict[tuple[int, int], int] = {}
    for (ci, rot) in fix_q:
        fix_evals[(ci, rot)] = tr.read_scalar()
    random_eval = tr.read_scalar()
    sigma_evals = [tr.read_scalar() for _ in range(m)]
    perm_z_evals = []  # (z(x), z(wx), z(w^u x) | None)
    for c in range(num_chunks):
        zx = tr.read_scalar()
        zwx = tr.read_scalar()
        zlast = tr.read_scalar() if c + 1 < num_chunks else None
        perm_z_evals.append((zx, zwx, zlast))
    lookup_evals = []  # (z(x), z(wx), a'(x), a'(w^-1 x), s'(x))
    for _ in cs.lookups:
        lookup_evals.append(
            (
                tr.read_scalar(),
                tr.read_scalar(),
                tr.read_scalar(),
                tr.read_scalar(),
                tr.read_scalar(),
            )
        )

    # --- instance evals (verifier-computed) ------------------------------
    ins_evals: dict[tuple[int, int], int] = {}
    for (ci, rot) in ins_q:
        pt = point_at(rot)
        col = instances[ci]
        val = 0
        for j, v in enumerate(col):
            if v % R:
                val = (val + v * _lagrange_at(j, pt, n, omega)) % R
        ins_evals[(ci, rot)] = val

    # --- expected h(x) -----------------------------------------------------
    l0 = _lagrange_at(0, x, n, omega)
    llast = _lagrange_at(u, x, n, omega)
    lblind = sum(_lagrange_at(j, x, n, omega) for j in range(u + 1, n)) % R
    active = (1 - llast - lblind) % R
    challenges = {"theta": theta}

    constraints: list[int] = []
    for g in cs.gates:
        for poly in g.polys:
            constraints.append(_eval_expr(poly, adv_evals, fix_evals, ins_evals, challenges))

    if m:
        col_eval = {}
        for i, col in enumerate(cs.permutation_columns):
            if col.kind == "advice":
                col_eval[i] = adv_evals[(col.index, 0)]
            elif col.kind == "fixed":
                col_eval[i] = fix_evals[(col.index, 0)]
            else:
                col_eval[i] = ins_evals[(col.index, 0)]
        constraints.append(l0 * (1 - perm_z_evals[0][0]) % R)
        zl = perm_z_evals[-1][0]
        constraints.append(llast * (zl * zl - zl) % R)
        for c in range(1, num_chunks):
            constraints.append(l0 * (perm_z_evals[c][0] - perm_z_evals[c - 1][2]) % R)
        for ci, c0 in enumerate(range(0, m, chunk)):
            cols = list(range(c0, min(c0 + chunk, m)))
            left = perm_z_evals[ci][1]
            right = perm_z_evals[ci][0]
            for i in cols:
                left = left * (col_eval[i] + beta * sigma_evals[i] + gamma) % R
                right = right * (col_eval[i] + beta * pow(DELTA, i, R) % R * x + gamma) % R
            constraints.append(active * (left - right) % R)

    for lk, (zx, zwx, apx, apx_prev, spx) in zip(cs.lookups, lookup_evals):
        theta_pow = 1
        a_comp = 0
        s_comp = 0
        for e_in, e_tb in zip(lk.inputs, lk.tables):
            a_comp = (a_comp + theta_pow * _eval_expr(e_in, adv_evals, fix_evals, ins_evals, challenges)) % R
            s_comp = (s_comp + theta_pow * _eval_expr(e_tb, adv_evals, fix_evals, ins_evals, challenges)) % R
            theta_pow = theta_pow * theta % R
        constraints.append(l0 * (1 - zx) % R)
        constraints.append(llast * (zx * zx - zx) % R)
        constraints.append(
            active
            * ((zwx * (apx + beta) % R * (spx + gamma)) - (zx * (a_comp + beta) % R * (s_comp + gamma)))
            % R
        )
        constraints.append(l0 * (apx - spx) % R)
        constraints.append(active * (apx - spx) % R * (apx - apx_prev) % R)

    acc = 0
    y_pow = 1
    for cst in constraints:
        acc = (acc + y_pow * cst) % R
        y_pow = y_pow * y % R
    xn = pow(x, n, R)
    expected_h = acc * pow((xn - 1) % R, -1, R) % R

    # combined h commitment
    h_comb = None
    xni = 1
    for c in h_commits:
        h_comb = curve.add(h_comb, curve.mul(xni, c))
        xni = xni * xn % R

    # --- multiopen queries in prover order --------------------------------
    vqs: list[VerifierQuery] = []
    for (ci, rot) in adv_q:
        vqs.append(VerifierQuery(f"advice{ci}", adv_commits[ci], point_at(rot), adv_evals[(ci, rot)]))
    for (ci, rot) in fix_q:
        vqs.append(VerifierQuery(f"fixed{ci}", vk.fixed_commitments[ci], point_at(rot), fix_evals[(ci, rot)]))
    vqs.append(VerifierQuery("random", random_commit, x, random_eval))
    for i in range(m):
        vqs.append(VerifierQuery(f"sigma{i}", vk.permutation_commitments[i], x, sigma_evals[i]))
    vqs.append(VerifierQuery("h", h_comb, x, expected_h))
    for c in range(num_chunks):
        zx, zwx, zlast = perm_z_evals[c]
        vqs.append(VerifierQuery(f"permz{c}", perm_z_commits[c], x, zx))
        vqs.append(VerifierQuery(f"permz{c}", perm_z_commits[c], point_at(1), zwx))
        if c + 1 < num_chunks:
            vqs.append(
                VerifierQuery(f"permz{c}", perm_z_commits[c], x * pow(omega, u, R) % R, zlast)
            )
    for li in range(len(cs.lookups)):
        zx, zwx, apx, apx_prev, spx = lookup_evals[li]
        a_c, s_c = lookup_perm_commits[li]
        vqs.append(VerifierQuery(f"lkz{li}", lookup_z_commits[li], x, zx))
        vqs.append(VerifierQuery(f"lkz{li}", lookup_z_commits[li], point_at(1), zwx))
        vqs.append(VerifierQuery(f"lkA{li}", a_c, x, apx))
        vqs.append(VerifierQuery(f"lkA{li}", a_c, point_at(-1), apx_prev))
        vqs.append(VerifierQuery(f"lkS{li}", s_c, x, spx))

    if multiopen == "gwc":
        return gwc_verify(params, tr, vqs)
    return shplonk_verify(params, tr, vqs)
