"""GWC19 multi-open argument for KZG (halo2 ProverGWC/VerifierGWC).

Port of ``zkdcap_tpu/commit/gwc.py``, the alternative to SHPLONK in
halo2_proofs' ``poly::kzg::multiopen`` (``create_proof(...,
multiopen="gwc")``).

Protocol:
  * v combines the polynomials queried at the SAME point (powers reset
    per point set, order = first appearance in the query list);
  * one witness commitment per distinct point:
        W_i = Cm( (Q_i(X) - Q_i(z_i)) / (X - z_i) )
  * u (squeezed after all W_i) combines across points; the verifier checks
        e(sum u^i W_i, [tau]G2) = e(sum u^i (z_i W_i + C_i - e_i G), G2)
    via one 2-term pairing product.

Proof size: one G1 point per distinct query point (the PLONK pipeline has
3-4) vs SHPLONK's fixed two. The witness quotients run on the device (the
v-combinations through the Montgomery product, kernel E on the card; one
``commit_many`` for every W, through the MSM); the scalar bookkeeping and
the pairing stay on the host.
"""

from __future__ import annotations

import torch

from ..curves.host_curve import BN254_G1
from ..curves.pairing import pairing_product_is_one
from ..fields import mont
from ..fields.params import BN254_FR, NUM_LIMBS
from ..poly.ops import divide_by_linear_row, poly_eval
from .kzg import ParamsKZG
from .shplonk import _combine, _enc

R = BN254_FR.p


def run_witnesses(polys_by_group, e_rows, pt_rows, ptinv_rows, v_row):
    """The reference's ``_gwc_program`` as a plain function: per point group,
    (sum_j v^j f_j - e) / (X - z), with e subtracted from row 0."""
    f = BN254_FR
    ws = []
    for polys, e_row, pt_row, ptinv_row in zip(polys_by_group, e_rows, pt_rows, ptinv_rows):
        comb = _combine(polys, v_row)
        comb[:1] = mont.sub(f, comb[:1], e_row)
        ws.append(divide_by_linear_row(f, comb, pt_row, ptinv_row))
    return ws


def _group_by_point(queries):
    """point -> names (first-appearance order, deduplicated)."""
    order: list[int] = []
    names: dict[int, list[str]] = {}
    for q in queries:
        pt = q.point % R
        if pt not in names:
            names[pt] = []
            order.append(pt)
        if q.name not in names[pt]:
            names[pt].append(q.name)
    return [(pt, names[pt]) for pt in order]


def gwc_open(params: ParamsKZG, transcript, queries, mesh=None,
             evals: dict[tuple[str, int], int] | None = None) -> None:
    """`evals` (name, point) -> claimed value: pass the prover's round-7
    eval cache to skip re-evaluating every poly; None recomputes. `mesh`:
    every witness commitment is a sharded MSM."""
    polys = {q.name: q.poly for q in queries}
    if evals is None:
        evals = {}
        for q in queries:
            key = (q.name, q.point % R)
            if key not in evals:
                evals[key] = poly_eval(BN254_FR, q.poly, q.point)

    groups = _group_by_point(queries)
    n = max(p.shape[0] for p in polys.values())
    for name, p in polys.items():
        if p.shape[0] < n:
            polys[name] = torch.cat([p, p.new_zeros(n - p.shape[0], NUM_LIMBS)])
    dev = next(iter(polys.values())).device

    v = transcript.squeeze_challenge()
    e_combs = []
    for pt, names in groups:
        e_comb, v_pow = 0, 1
        for name in names:
            e_comb = (e_comb + v_pow * evals[(name, pt)]) % R
            v_pow = v_pow * v % R
        e_combs.append(e_comb)
    ws = run_witnesses([[polys[name] for name in names] for _, names in groups],
                       list(_enc(e_combs, dev)), list(_enc([pt for pt, _ in groups], dev)),
                       list(_enc([pow(pt, -1, R) for pt, _ in groups], dev)),
                       _enc([v], dev)[0])
    for w_pt in params.commit_many(ws, mesh=mesh):
        transcript.write_point(w_pt)


def gwc_verify(params: ParamsKZG, transcript, queries) -> bool:
    curve = BN254_G1
    commits = {q.name: q.commitment for q in queries}
    evals = {(q.name, q.point % R): q.eval for q in queries}
    groups = _group_by_point(queries)

    v = transcript.squeeze_challenge()
    w_commits = [transcript.read_point() for _ in groups]
    u = transcript.squeeze_challenge()

    w_multi = None  # sum u^i W_i
    rhs = None  # sum u^i (z_i W_i + C_i)
    e_multi = 0  # sum u^i e_i
    u_pow = 1
    for (pt, names), w in zip(groups, w_commits):
        c_batch = None
        e_batch = 0
        v_pow = 1
        for name in names:
            c_batch = curve.add(c_batch, curve.mul(v_pow, commits[name]))
            e_batch = (e_batch + v_pow * evals[(name, pt)]) % R
            v_pow = v_pow * v % R
        w_multi = curve.add(w_multi, curve.mul(u_pow, w))
        rhs = curve.add(rhs, curve.mul(u_pow * pt % R, w))
        rhs = curve.add(rhs, curve.mul(u_pow, c_batch))
        e_multi = (e_multi + u_pow * e_batch) % R
        u_pow = u_pow * u % R
    rhs = curve.add(rhs, curve.mul((-e_multi) % R, curve.g))

    # e(w_multi, [tau]G2) * e(-rhs, G2) == 1
    return pairing_product_is_one(
        [(w_multi, params.srs.s_g2), (curve.neg_pt(rhs), params.srs.g2)]
    )
