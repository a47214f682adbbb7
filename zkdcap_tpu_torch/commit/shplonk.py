"""SHPLONK (BDFG20) multi-open argument for KZG.

Port of ``zkdcap_tpu/commit/shplonk.py`` (halo2 ProverSHPLONK /
VerifierSHPLONK): two group elements per multiopen (H and W) however many
polynomials and points are opened.

  * queries are grouped by identical point sets ("rotation sets");
  * y combines polynomials within a set, v combines across sets;
  * H = sum_k v^k (Q_k - R_k) / Z_{S_k} is committed; u is squeezed;
  * L(X) = sum_k v^k Z_{T\\S_k}(u) (Q_k(X) - R_k(u)) - Z_T(u) H(X)
    vanishes at u; W = L/(X-u) is committed;
  * the verifier rebuilds Cm(L) from the claimed evals and checks
    e(Cm(L) + u W, G2) * e(-W, [tau]G2) == 1.

The polynomial work (the reference's ``run_h`` / ``run_w`` programs) runs on
the device; the scalar bookkeeping and the pairing stay on the host.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

import torch

from ..curves.host_curve import BN254_G1
from ..curves.pairing import pairing_product_is_one
from ..fields import mont
from ..fields.params import BN254_FR, NUM_LIMBS
from ..poly.ops import divide_by_linear_row, poly_eval
from ..transcript import TranscriptReader, TranscriptWriter
from .kzg import ParamsKZG

R = BN254_FR.p
L = NUM_LIMBS


@dataclasses.dataclass
class ProverQuery:
    name: str  # identity of the polynomial (same name => same poly)
    poly: torch.Tensor | None  # coefficient form, Montgomery
    point: int


@dataclasses.dataclass
class VerifierQuery:
    name: str
    commitment: tuple | None  # host affine G1
    point: int
    eval: int


def _lagrange_interpolate(points: list[int], values: list[int]) -> list[int]:
    """Host interpolation -> coefficient list (low first), len == len(points)."""
    coeffs = [0] * len(points)
    for i, (xi, yi) in enumerate(zip(points, values)):
        # basis poly prod_{j != i} (X - xj) / (xi - xj)
        basis = [1]
        denom = 1
        for j, xj in enumerate(points):
            if j == i:
                continue
            new = [0] * (len(basis) + 1)
            for d, c in enumerate(basis):
                new[d + 1] = (new[d + 1] + c) % R
                new[d] = (new[d] - c * xj) % R
            basis = new
            denom = denom * (xi - xj) % R
        scale = yi * pow(denom, -1, R) % R
        for d, c in enumerate(basis):
            coeffs[d] = (coeffs[d] + c * scale) % R
    return coeffs


def _eval_host(coeffs: list[int], x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % R
    return acc


def _group_rotation_sets(queries):
    """name -> point set; then frozen point set -> names, in order of first
    appearance."""
    by_name_points: dict[str, set[int]] = defaultdict(set)
    for q in queries:
        by_name_points[q.name].add(q.point % R)
    sets: dict[frozenset, list[str]] = defaultdict(list)
    for name in by_name_points:
        sets[frozenset(by_name_points[name])].append(name)
    return list(sets.items())


def _per_set(rot_sets, evals, y: int):
    """(sorted points, names, r_comb) per rotation set: r_comb is the
    y-combination of the sets' interpolants R_k."""
    per_set = []
    for point_set, names in rot_sets:
        points = sorted(point_set)
        r_comb = [0] * len(points)
        y_pow = 1
        for name in names:
            r = _lagrange_interpolate(points, [evals[(name, pt)] for pt in points])
            r_comb = [(a + y_pow * b) % R for a, b in zip(r_comb, r)]
            y_pow = y_pow * y % R
        per_set.append((points, names, r_comb))
    return per_set


def _set_scales(per_set, u: int, v: int):
    """Z_T(u) and, per set, v^k Z_{T\\S_k}(u)."""
    t_points = sorted({pt for s, _, _ in per_set for pt in s})
    z_t_u = 1
    for pt in t_points:
        z_t_u = z_t_u * (u - pt) % R
    scales, vk_pow = [], 1
    for points, _, _ in per_set:
        z_other = 1
        for pt in t_points:
            if pt not in points:
                z_other = z_other * (u - pt) % R
        scales.append(vk_pow * z_other % R)
        vk_pow = vk_pow * v % R
    return z_t_u, scales


def _enc(values, device) -> torch.Tensor:
    return mont.encode_ints(BN254_FR, [v % R for v in values], device=device)


def _combine(polys: list[torch.Tensor], y_row: torch.Tensor) -> torch.Tensor:
    """sum_j y^j f_j."""
    f = BN254_FR
    comb, y_pow = None, mont.one_mont(f, (1,), y_row.device)
    for poly in polys:
        term = mont.mont_mul(f, poly, y_pow)
        comb = term if comb is None else mont.add(f, comb, term)
        y_pow = mont.mont_mul(f, y_pow, y_row)
    return comb


def run_h(polys_by_set, r_devs, pts_rows, ptsinv_rows, y_row, v_row):
    """H = sum_k v^k (Q_k - R_k) / Z_{S_k} with Q_k = sum_j y^j f_j; returns
    (H, [Q_k])."""
    f = BN254_FR
    combs, h_total = [], None
    v_pow = mont.one_mont(f, (1,), y_row.device)
    for polys, r_dev, pts, ptsinv in zip(polys_by_set, r_devs, pts_rows, ptsinv_rows):
        comb = _combine(polys, y_row)
        combs.append(comb)
        numer = comb.clone()
        numer[: len(pts)] = mont.sub(f, comb[: len(pts)], r_dev)
        for pt, ptinv in zip(pts, ptsinv):
            numer = divide_by_linear_row(f, numer, pt, ptinv)
        term = mont.mont_mul(f, numer, v_pow)
        h_total = term if h_total is None else mont.add(f, h_total, term)
        v_pow = mont.mont_mul(f, v_pow, v_row)
    return h_total, combs


def run_w(combs, h_total, r_u_rows, scale_rows, z_t_u_row, u_row, uinv_row):
    """W = L / (X - u) with L(X) = sum_k v^k Z_{T\\S_k}(u) (Q_k(X) - R_k(u))
    - Z_T(u) H(X); `scale_rows` carry v^k Z_{T\\S_k}(u)."""
    f = BN254_FR
    acc = None
    for comb, r_u, sc in zip(combs, r_u_rows, scale_rows):
        comb = comb.clone()
        comb[:1] = mont.sub(f, comb[:1], r_u)
        term = mont.mont_mul(f, comb, sc)
        acc = term if acc is None else mont.add(f, acc, term)
    acc = mont.sub(f, acc, mont.mont_mul(f, h_total, z_t_u_row))
    return divide_by_linear_row(f, acc, u_row, uinv_row)


def shplonk_open(params: ParamsKZG, transcript: TranscriptWriter, queries: list[ProverQuery],
                 mesh=None, evals: dict[tuple[str, int], int] | None = None) -> None:
    """`evals` (name, point) -> claimed value: the prover's round-7 values;
    None evaluates every poly here. `mesh`: H and W are sharded MSMs."""
    polys = {q.name: q.poly for q in queries}
    if evals is None:
        evals = {}
        for q in queries:
            key = (q.name, q.point % R)
            if key not in evals:
                evals[key] = poly_eval(BN254_FR, q.poly, q.point)
    rot_sets = _group_rotation_sets(queries)
    n = max(p.shape[0] for p in polys.values())
    for name, p in polys.items():
        if p.shape[0] < n:
            polys[name] = torch.cat([p, p.new_zeros(n - p.shape[0], L)])
    dev = next(iter(polys.values())).device

    y = transcript.squeeze_challenge()
    v = transcript.squeeze_challenge()
    per_set = _per_set(rot_sets, evals, y)
    h_total, combs = run_h(
        [[polys[name] for name in names] for _, names, _ in per_set],
        [_enc(r_comb, dev) for _, _, r_comb in per_set],
        [list(_enc(points, dev)) for points, _, _ in per_set],
        [list(_enc([pow(pt, -1, R) for pt in points], dev)) for points, _, _ in per_set],
        _enc([y], dev)[0], _enc([v], dev)[0])
    transcript.write_point(params.commit(h_total, mesh=mesh))
    u = transcript.squeeze_challenge()

    z_t_u, scales = _set_scales(per_set, u, v)
    W = run_w(combs, h_total, list(_enc([_eval_host(r, u) for _, _, r in per_set], dev)),
              list(_enc(scales, dev)), _enc([z_t_u], dev)[0], _enc([u], dev)[0],
              _enc([pow(u, -1, R)], dev)[0])
    transcript.write_point(params.commit(W, mesh=mesh))


def shplonk_verify(params: ParamsKZG, transcript: TranscriptReader,
                   queries: list[VerifierQuery]) -> bool:
    curve = BN254_G1
    rot_sets = _group_rotation_sets(queries)
    commits = {q.name: q.commitment for q in queries}
    evals = {(q.name, q.point % R): q.eval for q in queries}

    y = transcript.squeeze_challenge()
    v = transcript.squeeze_challenge()
    h_commit = transcript.read_point()
    u = transcript.squeeze_challenge()
    w_commit = transcript.read_point()

    per_set = _per_set(rot_sets, evals, y)
    z_t_u, scales = _set_scales(per_set, u, v)
    # Cm(L) = sum_k v^k Z_{T\S_k}(u) (sum_j y^j C_j - R_k(u) G) - Z_T(u) H
    acc = None
    scalar_g = 0
    for (points, names, r_comb), scale in zip(per_set, scales):
        y_pow = 1
        for name in names:
            acc = curve.add(acc, curve.mul(scale * y_pow % R, commits[name]))
            y_pow = y_pow * y % R
        scalar_g = (scalar_g + scale * _eval_host(r_comb, u)) % R
    acc = curve.add(acc, curve.mul((-scalar_g) % R, curve.g))
    acc = curve.add(acc, curve.mul((-z_t_u) % R, h_commit))

    # e(Cm(L) + u W, G2) * e(-W, [tau]G2) == 1
    lhs = curve.add(acc, curve.mul(u, w_commit))
    return pairing_product_is_one(
        [(lhs, params.srs.g2), (curve.neg_pt(w_commit), params.srs.s_g2)])
