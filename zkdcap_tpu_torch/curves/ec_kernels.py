"""Kernels B, C and D of the G1 path: wrappers and plain torch versions.

Counterparts of ``zkdcap_tpu/curves/ec_kernels.py``:

* B ``ec_madd_scan_full`` (``csrc/madd_scan.cu``): the MSM's whole segmented
  mixed-addition scan (``_mk_madd_scan_full_kernel[_r12]``; with M = 1 the
  single step of ``_mk_ec_madd_kernel``).
* C ``ec_add_select`` (``csrc/ec_add_select.cu``): complete addition with a
  per-lane select (``_mk_ec_add_kernel``), row-major like the reference's
  public ``ec_add_select``.
* D ``ec_window_join`` (``csrc/window_join.cu``): R = sum_w 2^(c*w) T_w
  (``_mk_window_join_kernel``).

Each wrapper launches its kernel for CUDA tensors and runs the plain version
for CPU tensors. Kernel and plain version compute the same canonical field
values, so their outputs agree limb for limb.
"""

from __future__ import annotations

import torch

from .. import _build
from ..fields import mont
from ..fields.params import NUM_LIMBS
from .device_g1 import G1_SPEC, CurveSpec, Point, ec_add64, ec_double64, to32_pt, to64_pt

L = NUM_LIMBS


def _require_g1(spec: CurveSpec) -> None:
    if spec != G1_SPEC:
        raise ValueError("the CUDA kernels are built for BN254 G1 only")


def _device_kind(name: str, t: torch.Tensor) -> str:
    if t.is_cuda:
        return "cuda"
    if t.device.type == "cpu":
        return "cpu"
    raise ValueError(f"{name}: unsupported device {t.device}")


def pack_affine_rows(points: torch.Tensor) -> torch.Tensor:
    """(N, 2, 16) 16-bit-limb affine Montgomery points -> (N, 16) packed rows:
    limbs 2j, 2j+1 as the lo/hi halves of one 32-bit word (X in words 0..7,
    Y in 8..15), stored as that bit pattern in int32. The encoded infinity
    (0, 0) packs to an all-zero row."""
    n = points.shape[0]
    pairs = points.reshape(n, 2, L // 2, 2).to(torch.int64)
    word = pairs[..., 0] | (pairs[..., 1] << 16)
    word = torch.where(word >= 1 << 31, word - (1 << 32), word)
    return word.reshape(n, L).to(torch.int32)


def unpack_rows64(rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(16, B) packed planes -> X, Y as limb-major int64 (16, B)."""
    v = rows.to(torch.int64) & 0xFFFFFFFF
    limbs = torch.stack([v & 0xFFFF, v >> 16], dim=1).reshape(2 * L, -1)
    return limbs[:L], limbs[L:]


# --- kernel C: complete addition with per-lane select --------------------

def ec_add_select(spec: CurveSpec, P: Point, Q: Point, mask: torch.Tensor,
                  fallback: str) -> Point:
    """P, Q 3-tuples of (M, 16); mask (M,) bool or int.
    Returns mask ? P + Q : (Q if fallback == "q" else P)."""
    if fallback not in ("p", "q"):
        raise ValueError(f"fallback must be 'p' or 'q', got {fallback!r}")
    if _device_kind("ec_add_select", P[0]) == "cuda":
        return _ec_add_select_cuda(spec, P, Q, mask, fallback)
    return ec_add_select_plain(spec, P, Q, mask, fallback)


def ec_add_select_plain(spec: CurveSpec, P: Point, Q: Point, mask: torch.Tensor,
                        fallback: str) -> Point:
    s = to32_pt(ec_add64(spec, to64_pt(P), to64_pt(Q)))
    fb = Q if fallback == "q" else P
    keep = (mask != 0)[:, None]
    return tuple(torch.where(keep, a, b) for a, b in zip(s, fb))


def _ec_add_select_cuda(spec, P, Q, mask, fallback) -> Point:
    _require_g1(spec)
    n = P[0].shape[0]
    P = tuple(c.contiguous() for c in P)
    Q = tuple(c.contiguous() for c in Q)
    for c in P + Q:
        if tuple(c.shape) != (n, L):
            raise ValueError(f"ec_add_select: coordinates must be ({n}, {L})")
    m32 = mask.reshape(n).to(torch.int32).contiguous()
    dev = _build.check_cuda("ec_add_select", *P, *Q, m32)
    out = tuple(torch.empty_like(P[0]) for _ in range(3))
    _build.launch("ec_add_select", *(t.data_ptr() for t in (*P, *Q, m32, *out)),
                  n, 1 if fallback == "q" else 0, device=dev)
    return out


# --- kernel B: whole segmented mixed-addition scan -----------------------

def ec_madd_scan_full(spec: CurveSpec, Pm: torch.Tensor, masks: torch.Tensor) -> Point:
    """Pm (M, 16, B) packed affine rows (see pack_affine_rows), masks
    (M, 3, B) int32 rows [same-run; valid; negate-Y]. Returns the projective
    accumulator after every step as a 3-tuple of (M, 16, B)."""
    M, _, B = Pm.shape
    if tuple(Pm.shape) != (M, L, B) or tuple(masks.shape) != (M, 3, B):
        raise ValueError(f"ec_madd_scan_full: shapes {tuple(Pm.shape)}, {tuple(masks.shape)}")
    if _device_kind("ec_madd_scan_full", Pm) == "cuda":
        _require_g1(spec)
        Pm, masks = Pm.contiguous(), masks.contiguous()
        dev = _build.check_cuda("madd_scan", Pm, masks)
        out = tuple(torch.empty_like(Pm) for _ in range(3))
        _build.launch("madd_scan", *(t.data_ptr() for t in (Pm, masks, *out)), M, B,
                      device=dev)
        return out
    return ec_madd_scan_plain(spec, Pm, masks)


def ec_madd_scan_plain(spec: CurveSpec, Pm: torch.Tensor, masks: torch.Tensor) -> Point:
    """Plain version of kernel B: M steps of batched mixed additions (the
    complete addition with Z2 = 1 gives the same field values)."""
    f = spec.field
    M, _, B = Pm.shape
    one = mont.lift(mont.to64(mont.one_mont(f, (), Pm.device)), 2).expand(L, B)
    zero = torch.zeros_like(one)
    inf = (zero, one, zero)
    acc = inf
    outs = ([], [], [])
    for m in range(M):
        X2, Y2 = unpack_rows64(Pm[m])
        same, valid, negate = (masks[m, i] != 0 for i in range(3))
        Y2 = torch.where(negate, mont.sub64(f, zero, Y2), Y2)
        q = (X2, Y2, one)
        s = ec_add64(spec, acc, q)
        held = tuple(torch.where(same, a, z) for a, z in zip(acc, inf))
        added = tuple(torch.where(same, a, b) for a, b in zip(s, q))
        acc = tuple(torch.where(valid, a, b) for a, b in zip(added, held))
        for o, c in zip(outs, acc):
            o.append(c.to(torch.int32))
    return tuple(torch.stack(o) for o in outs)


# --- kernel D: window join ---------------------------------------------------

def ec_window_join(spec: CurveSpec, T: Point, window_bits: int) -> Point:
    """Join per-window sums T (3-tuple of (W, 16)) into sum_w 2^(c*w) T_w.
    Returns one projective point as a 3-tuple of (16,)."""
    W = T[0].shape[0]
    if _device_kind("ec_window_join", T[0]) == "cuda":
        _require_g1(spec)
        T = tuple(c.contiguous() for c in T)
        dev = _build.check_cuda("window_join", *T)
        out = tuple(torch.empty(L, dtype=torch.int32, device=T[0].device) for _ in range(3))
        _build.launch("window_join", *(t.data_ptr() for t in (*T, *out)), W, window_bits,
                      device=dev)
        return out
    return ec_window_join_plain(spec, T, window_bits)


def ec_window_join_plain(spec: CurveSpec, T: Point, window_bits: int) -> Point:
    """Plain version of kernel D: Horner from the top window."""
    T = to64_pt(T)  # (16, W)
    W = T[0].shape[1]
    R = tuple(c[:, W - 1 : W] for c in T)
    for w in range(W - 2, -1, -1):
        for _ in range(window_bits):
            R = ec_double64(spec, R)
        R = ec_add64(spec, R, tuple(c[:, w : w + 1] for c in T))
    return tuple(c[0] for c in to32_pt(R))
