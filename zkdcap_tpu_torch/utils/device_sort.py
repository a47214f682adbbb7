"""Kernel F: batched bitonic sort of u32 operands by the first, and the
MSM's fused digit + point-row sort built on it.

Port of ``zkdcap_tpu/utils/device_sort.py``. Both entry points run the
bitonic network of the TPU kernel ``_mk_sort_kernel`` exactly: stages
k = 1..log n, strides d = 2^(k-1)..1, ascending runs where bit k of the
index is 0, a pair swapping only on strict inequality. Ties never move, so
the result, payloads included, is a fixed function of the input and equals
the JAX package's array for array. Not a stable sort: callers that need
stability pack a tiebreaker into the key.

Keys are u32 in the JAX package; the port stores the same bit patterns as
int32 and compares them as unsigned, in the kernel and in the plain version.

On CUDA tensors the wrappers launch ``csrc/bitonic_sort.cu`` (one launch
counted per sort); on CPU tensors they run the plain torch version of the
same network, which nothing on the card path calls. The kernel puts only the
key and one 32-bit companion through the network; for ``sort_rows_by_key``
the companion is the position within the segment, and the planes are then
written once from it: the swaps read only the keys, so that equals the
network on every operand, ties included.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

# The TPU kernel keeps a whole array resident in VMEM; the port keeps its
# bounds, so that the MSM takes the same paths: 2^10..2^21 elements, and the
# row sort in segments of 2^18 (one key + 8 planes per block).
MAX_LOG_N = 21
MIN_LOG_N = 10
ROWS_SORT_SEG = 1 << 18
# operand counts the kernel is built for: key, key + payload, key + 8 planes
KERNEL_OPS = (1, 2, 9)


def sort_supported(n: int, n_ops: int = 2) -> bool:
    if n & (n - 1):
        return False
    log_n = n.bit_length() - 1
    if not MIN_LOG_N <= log_n <= MAX_LOG_N:
        return False
    return 4 * n * 2 * n_ops < 90 * 1024 * 1024


def rows_sort_segments(n: int) -> int:
    return max(n // ROWS_SORT_SEG, 1)


def _log2(n: int) -> int:
    if n < 2 or n & (n - 1):
        raise ValueError(f"bitonic sort needs a power-of-two length >= 2, got {n}")
    return n.bit_length() - 1


# --- plain version -------------------------------------------------------

def bitonic_network_plain(ops: list[torch.Tensor]) -> list[torch.Tensor]:
    """The network on (batch, n) int32 operands, sorted by operand 0 as
    unsigned; returns new tensors."""
    batch, n = ops[0].shape
    log_n = _log2(n)
    key = ops[0].to(torch.int64) & 0xFFFFFFFF
    vals = [key] + [o.clone() for o in ops]
    for k in range(1, log_n + 1):
        for dl in range(k - 1, -1, -1):
            d = 1 << dl
            blocks = n // (2 * d)
            # pair (i, i + d): i = blk * 2d + j; bit k of i is bit k-dl-1 of blk
            asc = ((torch.arange(blocks, device=key.device) >> (k - dl - 1)) & 1) == 0
            v = vals[0].view(batch, blocks, 2, d)
            lo, hi = v[:, :, 0], v[:, :, 1]
            swap = torch.where(asc[None, :, None], hi < lo, hi > lo)
            for idx, t in enumerate(vals):
                t = t.view(batch, blocks, 2, d)
                lo, hi = t[:, :, 0], t[:, :, 1]
                vals[idx] = torch.stack([torch.where(swap, hi, lo), torch.where(swap, lo, hi)],
                                        2).reshape(batch, n)
    return vals[1:]


# --- kernel F --------------------------------------------------------------

def _sort_cuda(ins: list[tuple[torch.Tensor, int, int, int]],
               outs: list[tuple[torch.Tensor, int, int, int]], W: int, S: int, n: int) -> None:
    """Launch kernel F. Each operand is (tensor, element offset, batch
    stride, segment stride): block (w, s) of operand o starts at element
    offset + w * batch stride + s * segment stride of its tensor. The row
    sort (9 operands) gets a scratch buffer for the positions and the planes'
    rows."""
    if len(ins) not in KERNEL_OPS:
        raise ValueError(f"kernel F is built for {KERNEL_OPS} operands, got {len(ins)}")
    dev = _build.check_cuda("bitonic_sort", *{id(t): t for t, *_ in ins + outs}.values())
    n_ops = len(ins)
    scratch = None
    if n_ops == max(KERNEL_OPS):  # the positions, then the planes as 32-byte rows
        rows = 8 * (1 if ins[1][2] == 0 else W) * S * n
        scratch = torch.empty(-(-W * S * n // 4) * 4 + rows, dtype=torch.int32,
                              device=ins[0][0].device)

    def ptrs(ops):
        return (ctypes.c_void_p * n_ops)(*(t.data_ptr() + 4 * off for t, off, _, _ in ops))

    def strides(ops, i):
        return (ctypes.c_long * n_ops)(*(op[i] for op in ops))

    in_p, out_p = ptrs(ins), ptrs(outs)
    in_ws, in_ss, out_ws, out_ss = strides(ins, 2), strides(ins, 3), strides(outs, 2), strides(outs, 3)
    _build.launch("bitonic_sort", ctypes.addressof(in_p), ctypes.addressof(out_p),
                  ctypes.addressof(in_ws), ctypes.addressof(in_ss), ctypes.addressof(out_ws),
                  ctypes.addressof(out_ss), n_ops, W, S, _log2(n),
                  None if scratch is None else scratch.data_ptr(), device=dev)


# --- entry points ----------------------------------------------------------

def _as_batched(operands) -> tuple[list[torch.Tensor], bool]:
    squeeze = operands[0].dim() == 1
    ops = [(o[None] if squeeze else o).contiguous() for o in operands]
    if any(o.shape != ops[0].shape or o.dtype != torch.int32 for o in ops):
        raise ValueError("bitonic_sort: operands must be int32 tensors of one shape")
    return ops, squeeze


def bitonic_sort(operands) -> tuple[torch.Tensor, ...]:
    """Sort 1-D or 2-D (batched) int32 operands by the first, as unsigned.

    operands: equal-shape int32 tensors, (n,) or (batch, n), n a power of
    two. Returns the operands reordered so operand 0 ascends. Not stable
    for equal keys (callers pack tiebreakers into the key)."""
    if operands[0].device.type == "cpu":
        return bitonic_sort_plain(operands)
    if not operands[0].is_cuda:
        raise ValueError(f"bitonic_sort: unsupported device {operands[0].device}")
    ops, squeeze = _as_batched(operands)
    batch, n = ops[0].shape
    out = [torch.empty_like(o) for o in ops]
    _sort_cuda([(o, 0, n, 0) for o in ops], [(o, 0, n, 0) for o in out], batch, 1, n)
    return tuple(o[0] for o in out) if squeeze else tuple(out)


def bitonic_sort_plain(operands) -> tuple[torch.Tensor, ...]:
    """Plain version of ``bitonic_sort`` (any device)."""
    ops, squeeze = _as_batched(operands)
    out = bitonic_network_plain(ops)
    return tuple(o[0] for o in out) if squeeze else tuple(out)


def _rows_shapes(key, planes, per_window):
    n_w, n = key.shape
    p = planes.shape[-2]
    if planes.shape[-1] != n or (per_window and planes.shape[0] != n_w):
        raise ValueError(f"sort_rows_by_key: planes {tuple(planes.shape)} for key {tuple(key.shape)}")
    n_seg = rows_sort_segments(n)
    return n_w, n, p, n_seg, n // n_seg


def sort_rows_by_key(key: torch.Tensor, planes: torch.Tensor, per_window: bool):
    """Batched fused digit + row sort: key (W, N) int32 (compared as u32);
    planes PLANE-MAJOR (P, N) shared by every window, or (W, P, N) when
    per_window. Splits N into ROWS_SORT_SEG segments sorted independently
    (callers handle the segment-local grouping). Returns
    (sorted_key (W, N), sorted_planes (W, P, N))."""
    if key.device.type == "cpu":
        return sort_rows_by_key_plain(key, planes, per_window)
    if not key.is_cuda:
        raise ValueError(f"sort_rows_by_key: unsupported device {key.device}")
    key, planes = key.contiguous(), planes.contiguous()
    n_w, n, p, n_seg, seg = _rows_shapes(key, planes, per_window)
    out_key = torch.empty_like(key)
    out_planes = torch.empty((n_w, p, n), dtype=planes.dtype, device=planes.device)
    plane_ws = p * n if per_window else 0
    ins = [(key, 0, n, seg)] + [(planes, i * n, plane_ws, seg) for i in range(p)]
    outs = [(out_key, 0, n, seg)] + [(out_planes, i * n, p * n, seg) for i in range(p)]
    _sort_cuda(ins, outs, n_w, n_seg, seg)
    return out_key, out_planes


def sort_rows_by_key_plain(key: torch.Tensor, planes: torch.Tensor, per_window: bool):
    """Plain version of ``sort_rows_by_key`` (any device)."""
    n_w, n, p, n_seg, seg = _rows_shapes(key, planes, per_window)
    if not per_window:
        planes = planes[None].expand(n_w, p, n)
    ops = [key.reshape(n_w * n_seg, seg)]
    ops += [planes[:, i].reshape(n_w * n_seg, seg) for i in range(p)]
    out = bitonic_network_plain(ops)
    return out[0].reshape(n_w, n), torch.stack([o.reshape(n_w, n) for o in out[1:]], 1)
