"""Pippenger multi-scalar multiplication over BN254 G1.

Port of ``zkdcap_tpu/msm/pippenger.py``, the path the JAX package runs on
its TPU. Every commitment is one MSM. Stages (signed c-bit windows,
ceil(256/c) windows, 2^(c-1) buckets each):

1. signed digit recoding, digits in [-2^(c-1), 2^(c-1) - 1];
2. per window, a sort of |digit| (``torch.sort``) and one gather of the
   u16-packed affine point rows in sorted order;
3. the segmented scan over G lanes of M = N/G sorted points each, windows
   merged into B = WP*G lanes (kernel B);
4. compaction of each lane's run ends, at most K = G + 2^(c-1) per window;
5. a segmented Hillis-Steele scan over those partial sums, run for
   ceil(log2(longest same-digit run)) levels, which one host read per window
   group measures (kernel C per level);
6. deposit of each run's total into a dense bucket table;
7. split-weight aggregation sum_i (i+1) B_i (kernel C in its tree sums and
   suffix scans);
8. the window join (kernel D).

Two switches of the JAX package, off by default there and here, change
stage 2 (``_Sorts``): ``ZKDCAP_MSM_BITONIC=1`` sorts the digits (and the
run ends of stage 4) with kernel F, ``ZKDCAP_MSM_ROWSORT=1`` sorts the
packed point planes with the digits (kernel F with 9 operands, Y negated
before the sort), so that no gather follows; above 2^18 points it sorts
per segment and stages 4-6 run per (window, segment).

Digit-0 points and encoded infinities become the identity (0 : 1 : 0),
which the complete formulas absorb. Sort ties are not ordered, so the
sorted stream may differ from the JAX package's; the buckets and the result
do not.
"""

from __future__ import annotations

import os

import torch

from ..curves.device_g1 import G1_SPEC, CurveSpec, Point, affine_to_projective, decode_points, ec_inf
from ..curves.ec_kernels import (
    ec_add_select,
    ec_madd_scan_full,
    ec_window_join,
    pack_affine_rows,
)
from ..fields import mont
from ..fields.params import BN254_FR, NUM_LIMBS
from ..utils import device_sort
from ..utils.device_sort import bitonic_sort, rows_sort_segments, sort_rows_by_key, sort_supported

L = NUM_LIMBS
_IDX_BITS = 30  # the sign packs above the index in the digit sort's payload
# Point counts at or below this take the fixed-window ladder (msm_ladder).
SMALL_MSM_MAX = 512


def _auto_c(n: int) -> int:
    return 16 if n >= (1 << 20) else 13


def _signed_digits(scalars_std: torch.Tensor, c: int) -> torch.Tensor:
    """int32[N, 16] standard-form limbs -> int64[W, N] signed window digits.

    Scalars are < r < 2^254, so the top window never carries out."""
    s = scalars_std.to(torch.int64)
    n_windows = -(-256 // c)
    half, full = 1 << (c - 1), 1 << c
    digits = []
    carry = torch.zeros_like(s[:, 0])
    for w in range(n_windows):
        bit = c * w
        li, r = bit // 16, bit % 16
        v = s[:, li] >> r
        if r + c > 16 and li + 1 < 16:
            v = v | (s[:, li + 1] << (16 - r))
        d = (v & (full - 1)) + carry
        over = d >= half
        digits.append(torch.where(over, d - full, d))
        carry = over.to(torch.int64)
    return torch.stack(digits)


def _window_parallel(n_windows: int, lanes: int) -> int:
    """Largest divisor of n_windows (at most 10) with WP*lanes <= 2^17, which
    bounds the scan's (M, 16, WP*lanes) outputs at 1.6 GB for 2^20 points."""
    for wp in range(min(10, n_windows), 0, -1):
        if n_windows % wp == 0 and wp * lanes <= 131072:
            return wp
    return 1


def _add(spec: CurveSpec, P: Point, Q: Point, mask=None, fallback: str = "p") -> Point:
    """Kernel C over any batch shape (..., 16); mask None adds every lane."""
    shape = P[0].shape
    flat = lambda T: tuple(c.reshape(-1, L).contiguous() for c in T)
    n = P[0].numel() // L
    if mask is None:
        mask = torch.ones(n, dtype=torch.int32, device=P[0].device)
    out = ec_add_select(spec, flat(P), flat(Q), mask.reshape(n), fallback)
    return tuple(c.reshape(shape) for c in out)


def msm_ladder(spec: CurveSpec, points: torch.Tensor, scalars_std: torch.Tensor) -> Point:
    """Fixed-window MSM for small N: a table of d*P_i (d < 16) per point,
    then 64 steps of four doublings and one addition of the table entry of
    each scalar's next 4-bit digit, every point at once (kernel C for every
    addition), then a log-depth tree sum. Same group element as msm_device.
    Scalars (N, 16), or (B, N, 16) for B MSMs over the same points."""
    shape = scalars_std.shape[:-1]
    dev = points.device
    P = tuple(c.expand(*shape, L) for c in affine_to_projective(spec, points))
    # T[m:2m] = T[:m] + m*P, with m*P = T[m/2] + T[m/2]
    T = tuple(torch.stack([i, c]) for i, c in zip(ec_inf(spec, shape, dev), P))
    while T[0].shape[0] < 16:
        half = tuple(c[c.shape[0] // 2] for c in T)
        mP = _add(spec, half, half)
        T = tuple(torch.cat([c, s]) for c, s in
                  zip(T, _add(spec, T, tuple(d.expand_as(c) for d, c in zip(mP, T)))))
    s = scalars_std.to(torch.int64)
    acc = ec_inf(spec, shape, dev)
    for w in range(63, -1, -1):
        for _ in range(4 if w < 63 else 0):
            acc = _add(spec, acc, acc)
        digit = (s[..., w // 4] >> (4 * (w % 4))) & 15
        idx = digit[None, ..., None].expand(1, *shape, L)
        entry = tuple(torch.gather(c, 0, idx)[0] for c in T)
        acc = _add(spec, acc, entry, digit != 0)
    return _tree_sum(spec, acc, len(shape) - 1)


def _tree_sum(spec: CurveSpec, T: Point, axis: int) -> Point:
    """Sum along `axis` by pairwise halving (kernel C); pads odd lengths
    with the identity."""
    m = T[0].shape[axis]
    while m > 1:
        if m % 2:
            pad = list(T[0].shape)
            pad[axis] = 1
            T = tuple(torch.cat([c, i], axis) for c, i in
                      zip(T, ec_inf(spec, pad[:-1], T[0].device)))
            m += 1
        half = m // 2
        T = _add(spec, tuple(c.narrow(axis, 0, half) for c in T),
                 tuple(c.narrow(axis, half, half) for c in T))
        m = half
    return tuple(c.squeeze(axis) for c in T)


def _suffix_scan(spec: CurveSpec, T: Point) -> Point:
    """Hillis-Steele suffix sums along axis 1 of (W, m, 16) coordinates."""
    m = T[0].shape[1]
    idx = torch.arange(m, device=T[0].device)
    for s in range(max((m - 1).bit_length(), 1)):
        shift = 1 << s
        nxt = tuple(torch.roll(c, -shift, dims=1) for c in T)
        valid = ((idx + shift) < m)[None, :].expand(T[0].shape[0], m)
        T = _add(spec, T, nxt, valid.to(torch.int32))
    return T


def _hs_levels(vd: torch.Tensor, lanes: int) -> int:
    """Hillis-Steele levels that close every run of equal nonzero digits in
    the compacted (WP, K) digit rows: ceil(log2(longest run)), capped by the
    static bound (a digit has at most one partial per lane). Levels past the
    longest run are exact no-ops, so stopping there changes no result. One
    host read."""
    WP, K = vd.shape
    nz = vd != 0
    change = torch.ones_like(nz)
    change[:, 1:] = vd[:, 1:] != vd[:, :-1]
    pos = torch.arange(K, device=vd.device)[None].expand(WP, K)
    start_pos = torch.cummax(torch.where(change | ~nz, pos, 0), dim=1).values
    max_run = int(torch.where(nz, pos - start_pos + 1, 0).max())
    n_levels = max(min((K - 1).bit_length(), (lanes - 1).bit_length()), 1)
    return sum(1 for s in range(n_levels) if max_run > (1 << s))


def neg_packed_y(f, y_pm: torch.Tensor, sign: torch.Tensor) -> torch.Tensor:
    """f the base field; y_pm (8, N) u16-packed Montgomery Y planes; sign
    (WP, N) bool. Returns (WP, 8, N): p - y where sign (one borrow chain; y < p so no net
    borrow; y = 0 maps to p, but those rows are encoded infinities whose
    sort key is 0, never selected by the scan)."""
    v = y_pm.to(torch.int64) & 0xFFFFFFFF
    limbs = torch.stack([v & 0xFFFF, v >> 16], 1).reshape(2 * 8, -1)
    p_l = [int(x) for x in f.p_limbs]
    neg, bw = [], torch.zeros_like(limbs[0])
    for j in range(16):
        t = p_l[j] - limbs[j] - bw
        neg.append(t & 0xFFFF)
        bw = (t >> 16) & 1
    words = torch.stack([neg[2 * j] | (neg[2 * j + 1] << 16) for j in range(8)])
    nplanes = torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)
    return torch.where(sign[:, None, :], nplanes[None], y_pm[None])


class _Sorts:
    """Which sorts an MSM runs: the JAX package's switches, read at call time
    from the same environment variables. ``ZKDCAP_MSM_BITONIC=1`` runs the
    digit sort and the run-end sort through kernel F; ``ZKDCAP_MSM_ROWSORT=1``
    runs the fused digit + point-row sort (kernel F with 9 operands), so no
    row gather follows. Off the card they run kernel F's plain version. The
    default is ``torch.sort`` and the packed-row gather."""

    def __init__(self, N: int, G: int):
        env = os.environ.get
        seg = min(N, device_sort.ROWS_SORT_SEG)
        S = rows_sort_segments(N)
        self.rows = (sort_supported(seg, n_ops=9) and N % seg == 0
                     and G % S == 0 and env("ZKDCAP_MSM_ROWSORT", "0") == "1")
        self.S = S if self.rows else 1
        bitonic_ok = env("ZKDCAP_MSM_BITONIC", "0") == "1"
        self.digits = sort_supported(N) and bitonic_ok
        self.ends = sort_supported(N // self.S) and bitonic_ok


def run_steps(steps):
    """Run a generator of steps (it yields before each host read) to its end;
    returns its value."""
    while True:
        try:
            next(steps)
        except StopIteration as done:
            return done.value


def _group_buckets(spec: CurveSpec, rows: torch.Tensor, d_grp: torch.Tensor,
                   G: int, M: int, nb: int, sorts: _Sorts) -> Point:
    """(WP, N) signed digits -> (WP, nb, 16) bucket sums (slot i = bucket i+1)."""
    return run_steps(_group_buckets_steps(spec, rows, d_grp, G, M, nb, sorts))


def _group_buckets_steps(spec: CurveSpec, rows: torch.Tensor, d_grp: torch.Tensor,
                         G: int, M: int, nb: int, sorts: _Sorts):
    """:func:`_group_buckets` as steps: a generator that yields once, before
    its host read, and returns the bucket sums.

    With the row sort each window splits into S segments of N / S points
    (G / S lanes), sorted independently: the tail below runs per (window,
    segment) row and the S bucket tables of a window are added at the end."""
    WP, N = d_grp.shape
    S = sorts.S
    WS, n_seg, G_seg = WP * S, N // S, G // S
    B = WP * G
    K = min(n_seg, G_seg + nb)
    dev = rows.device

    def to_mb(a):  # (WP, N) -> (M, B), column b = w*G + lane
        return a.reshape(WP, G, M).permute(2, 0, 1).reshape(M, B)

    if sorts.rows:
        # -- fused digit + row sort: no gather ------------------------------
        rows_pm = rows.T.contiguous()  # (16, N) plane-major
        key = torch.where((rows == 0).all(-1)[None], 0, d_grp.abs()).to(torch.int32)
        skey, sx = sort_rows_by_key(key, rows_pm[:8], per_window=False)
        y_neg = neg_packed_y(spec.field, rows_pm[8:], d_grp < 0)  # (WP, 8, N)
        _, sy = sort_rows_by_key(key, y_neg, per_window=True)
        skey = skey.to(torch.int64)
        valid = skey != 0  # 0 = digit 0 or infinity
        Pm = torch.cat([sx, sy], 1).reshape(WP, L, G, M).permute(3, 1, 0, 2).reshape(M, L, B)
        negate = torch.zeros_like(valid)  # Y is negated inside the sorted stream
    else:
        # -- sort by |digit|, then gather the packed rows in sorted order ---
        if sorts.digits:
            idx = torch.arange(N, dtype=torch.int32, device=dev)
            payload = torch.where(d_grp < 0, idx | (1 << _IDX_BITS), idx).to(torch.int32)
            skey, sp = bitonic_sort((d_grp.abs().to(torch.int32), payload))
            skey, sp = skey.to(torch.int64), sp.to(torch.int64)
            order, negate = sp & ((1 << _IDX_BITS) - 1), (sp >> _IDX_BITS) == 1
        else:
            skey, order = torch.sort(d_grp.abs(), dim=1)
            negate = torch.gather(d_grp < 0, 1, order)
        g = rows[order]  # (WP, N, 16)
        valid = (skey != 0) & (g != 0).any(-1)
        Pm = g.reshape(WP, G, M, L).permute(2, 3, 0, 1).reshape(M, L, B)
    dm = to_mb(skey)
    same = torch.zeros_like(dm, dtype=torch.bool)
    same[1:] = dm[1:] == dm[:-1]
    masks = torch.stack([same, to_mb(valid), to_mb(negate)], 1).to(torch.int32).contiguous()

    # -- segmented scan (kernel B) -------------------------------------------
    oX, oY, oZ = ec_madd_scan_full(spec, Pm.contiguous(), masks)

    # -- run-end compaction, per (window, segment) row -------------------------
    skey = skey.reshape(WS, n_seg)
    idxS = torch.arange(n_seg, device=dev)
    d_next = torch.cat([skey[:, 1:], skey.new_full((WS, 1), -1)], 1)
    is_end = ((idxS % M) == M - 1)[None] | (skey != d_next)
    n_ends = is_end.sum(1)
    if sorts.ends:
        # one u32 key, the end flag above the index: ends first, in order
        ekey = ((~is_end).to(torch.int32) << _IDX_BITS) | idxS.to(torch.int32)[None]
        (ekey,) = bitonic_sort((ekey,))
        cidx = (ekey & ((1 << _IDX_BITS) - 1)).to(torch.int64)[:, :K]
    else:
        cidx = torch.sort((~is_end).to(torch.int32), dim=1, stable=True).indices[:, :K]
    idxK = torch.arange(K, device=dev)
    dead = idxK[None] >= n_ends[:, None]
    vd = torch.where(dead, 0, torch.gather(skey, 1, cidx))
    m_idx = cidx % M
    b_idx = cidx // M + torch.arange(WS, device=dev)[:, None] * G_seg
    C = tuple(o[m_idx, :, b_idx] for o in (oX, oY, oZ))  # (WS, K, 16)
    deadc = (dead | (vd == 0))[..., None]
    one = mont.one_mont(spec.field, (), dev)
    C = (torch.where(deadc, 0, C[0]), torch.where(deadc, one, C[1]),
         torch.where(deadc, 0, C[2]))
    vd = torch.where(deadc[..., 0], 0, vd)

    # -- segmented Hillis-Steele over the run partials --------------------------
    nz = vd != 0
    pos = idxK[None].expand(WS, K)
    yield  # _hs_levels reads the device back: on a mesh, the other shards issue first
    for s in range(_hs_levels(vd, G_seg)):
        shift = 1 << s
        inf = ec_inf(spec, (WS, shift), dev)
        prev = tuple(torch.cat([i, c[:, : K - shift]], 1) for i, c in zip(inf, C))
        pd = torch.cat([vd.new_zeros(WS, shift), vd[:, : K - shift]], 1)
        ok = (pos >= shift) & (pd == vd) & nz
        C = _add(spec, C, prev, ok.to(torch.int32))

    # -- deposit run totals into dense buckets --------------------------------
    vd_next = torch.cat([vd[:, 1:], vd.new_full((WS, 1), -1)], 1)
    slot = torch.where((vd != vd_next) & (vd > 0), vd - 1, nb)
    idx = slot[..., None].expand(WS, K, L)
    tables = ec_inf(spec, (WS, nb + 1), dev)
    T = tuple(t.scatter(1, idx, c)[:, :nb] for t, c in zip(tables, C))
    if S > 1:  # add the S segment tables of every window
        T = _tree_sum(spec, tuple(t.reshape(WP, S, nb, L) for t in T), 1)
    return T


def msm_device(spec: CurveSpec, points: torch.Tensor, scalars_std: torch.Tensor,
               lanes: int, c: int = 0) -> Point:
    """points: int32[N, 2, 16] Montgomery affine ((0, 0) = infinity);
    scalars_std: int32[N, 16] standard form; N a multiple of `lanes`.
    c: signed-window width (0 = the size-tuned default). Returns one
    projective point as a 3-tuple of (16,)."""
    return run_steps(msm_device_steps(spec, points, scalars_std, lanes, c))


def msm_device_steps(spec: CurveSpec, points: torch.Tensor, scalars_std: torch.Tensor,
                     lanes: int, c: int = 0):
    """:func:`msm_device` as steps: a generator that yields before each of
    its host reads (one a window group) and returns the point, so that
    ``Mesh.map`` can issue the other shards' work while a card catches up."""
    N = points.shape[0]
    c = c or _auto_c(N)
    if not 2 <= c <= 16:
        raise ValueError(f"window width {c} outside [2, 16]")
    if N % lanes:
        raise ValueError(f"{N} points do not split into {lanes} lanes")
    n_windows = -(-256 // c)
    nb = 1 << (c - 1)
    G, M = lanes, N // lanes
    digits = _signed_digits(scalars_std, c)
    WP = _window_parallel(n_windows, G)
    rows = pack_affine_rows(points)
    sorts = _Sorts(N, G)
    parts = []
    for w in range(0, n_windows, WP):
        parts.append((yield from _group_buckets_steps(spec, rows, digits[w : w + WP], G, M,
                                                      nb, sorts)))
    buckets = tuple(torch.cat([p[i] for p in parts]) for i in range(3))  # (W, nb, 16)

    # split-weight aggregation: slot i holds bucket i+1 and i = hi*2^H + lo;
    # sum_i (i+1) B_i = 2^H * sum_hi hi*C_hi + sum_lo (lo+1)*D_lo with
    # C_hi = sum_lo B[hi, lo] and D_lo = sum_hi B[hi, lo]
    H = (c - 1) // 2
    lo_n, hi_n = 1 << H, nb >> H
    B4 = tuple(b.reshape(n_windows, hi_n, lo_n, L) for b in buckets)
    C3 = _tree_sum(spec, B4, 2)  # (W, hi_n, 16)
    D3 = _tree_sum(spec, B4, 1)  # (W, lo_n, 16)
    S = _suffix_scan(spec, C3)
    one = mont.one_mont(spec.field, (), points.device)
    S = (S[0].clone(), S[1].clone(), S[2].clone())
    S[0][:, 0], S[1][:, 0], S[2][:, 0] = 0, one, 0  # slot 0 carries weight hi = 0
    A3 = _tree_sum(spec, S, 1)  # (W, 16)
    B3 = _tree_sum(spec, _suffix_scan(spec, D3), 1)
    for _ in range(H):
        A3 = _add(spec, A3, A3)
    T = _add(spec, A3, B3)
    return ec_window_join(spec, T, c)


def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    if x.shape[0] >= n:
        return x
    return torch.cat([x, x.new_zeros((n - x.shape[0],) + tuple(x.shape[1:]))])


def msm(points: torch.Tensor, scalars_mont: torch.Tensor, spec: CurveSpec = G1_SPEC) -> Point:
    """Full MSM: points (N, 2, 16) x Montgomery Fr scalars (N, 16), scalars
    shorter than the points padded with zeros. Returns a projective point."""
    N = points.shape[0]
    scalars_std = _pad_rows(mont.from_mont(BN254_FR, scalars_mont), N)
    if N <= SMALL_MSM_MAX:
        return msm_ladder(spec, points, scalars_std)
    n_pow = 1 << (N - 1).bit_length()
    lanes = min(16384, n_pow)
    return msm_device(spec, _pad_rows(points, n_pow), _pad_rows(scalars_std, n_pow), lanes)


def msm_host(points: torch.Tensor, scalars_mont: torch.Tensor, spec: CurveSpec = G1_SPEC):
    """MSM returning a host affine point (or None)."""
    R = msm(points, scalars_mont, spec)
    return decode_points(spec, tuple(r.reshape(1, L) for r in R))[0]


def msm_many_host(points: torch.Tensor, scalars_mont_list, spec: CurveSpec = G1_SPEC):
    """Many scalar vectors against one point set (the prover's per-round
    multi-column commitments), as one batched ladder for small N. Returns
    host affine points."""
    N = points.shape[0]
    if N > SMALL_MSM_MAX or not scalars_mont_list:
        return [msm_host(points, s, spec) for s in scalars_mont_list]
    std = torch.stack([_pad_rows(mont.from_mont(BN254_FR, s), N) for s in scalars_mont_list])
    return decode_points(spec, msm_ladder(spec, points, std))
