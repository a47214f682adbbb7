"""Radix-2 NTT over BN254 Fr: kernel A's passes and kernel G's stages.

Port of ``zkdcap_tpu/ntt/ntt.py``. A transform of n <= 2^11 points is one
pass of kernel A (``fields/ntt_kernels.py``); 2^12 <= n <= 2^22 is the
four-step transform n = N1 * N2 with N1 = 2^floor(log n / 2): pass A runs
the N2 size-N1 transforms of the columns and multiplies by the inter-pass
twiddles w^(j*k1) (times n^-1 for the inverse) into a scratch array, pass B
runs the N1 size-N2 transforms of the rows; kernel A reads the columns and
writes the transposed output through strided views, so no copy moves the
data between them. Larger n, and every n >= 2^12 while
``ZKDCAP_NO_FOUR_STEP`` is set to a non-empty value (read at each call, as
the JAX package reads it), take the flat radix-2 path: one launch of kernel
A runs stages 0-10 on every 2^11-point chunk of the bit-reversed array (each
chunk a column of the array, read in place), and one launch of kernel G
(``fields/butterfly_kernels.py``) runs each further stage; the inverse then
multiplies by n^-1 (kernel E).

Inputs and outputs are ``int32[n, 16]`` Montgomery limbs in natural order.
Tables are built in torch on the input's device and cached per device.
"""

from __future__ import annotations

import functools
import os

import torch

from ..device import resolve
from ..fields import mont
from ..fields.butterfly_kernels import butterfly
from ..fields.ntt_kernels import MAX_PASS_LOG, ntt_pass
from ..fields.params import BN254_FR, NUM_LIMBS, R, FieldParams, int_to_limbs

L = NUM_LIMBS
# the largest transform of the four-step path; above it the flat path runs
MAX_FOUR_STEP_LOG = 2 * MAX_PASS_LOG


def _mont_limbs(params: FieldParams, value: int, device) -> torch.Tensor:
    """int32[16] Montgomery limbs of a host integer."""
    return torch.as_tensor(int_to_limbs(value * R % params.p).astype("int32"), device=device)


def _power_table(params: FieldParams, base: int, log_len: int, device) -> torch.Tensor:
    """[base^0 .. base^(2^log_len - 1)] (Montgomery, int32[2^log_len, 16]) by
    repeated doubling T_{k+1} = [T_k, T_k * base^(2^k)], one product of
    kernel E per step."""
    tab = _mont_limbs(params, 1, device)[None]
    step = base % params.p
    for _ in range(log_len):
        tab = torch.cat([tab, mont.mont_mul(params, tab, _mont_limbs(params, step, device))])
        step = step * step % params.p
    return tab


def power_table(params: FieldParams, base: int, n: int, device=None) -> torch.Tensor:
    """Table [base^0 .. base^(n-1)] in Montgomery form, int32[n, 16]."""
    log_n = max((n - 1).bit_length(), 1)
    return _power_table(params, base, log_n, resolve(device))[:n].contiguous()


def _root(params: FieldParams, log_n: int, inverse: bool) -> int:
    w = params.nth_root_of_unity(log_n)
    return pow(w, -1, params.p) if inverse else w


@functools.cache
def _pass_twiddles(log_size: int, inverse: bool, device: torch.device) -> torch.Tensor:
    """Kernel A's stage table for a size-2^log_size pass: w^0 .. w^(2^(S-1)-1)."""
    w = _root(BN254_FR, log_size, inverse)
    return power_table(BN254_FR, w, 1 << (log_size - 1), device).contiguous()


@functools.cache
def _n_inv(log_n: int, device: torch.device) -> torch.Tensor:
    return _mont_limbs(BN254_FR, pow(1 << log_n, -1, BN254_FR.p), device)[None]


@functools.cache
def _flat_twiddles(log_n: int, inverse: bool, device: torch.device) -> torch.Tensor:
    """Kernel G's table for a 2^log_n transform: w^0 .. w^(n/2 - 1) of the
    n-th root; stage s reads w_{2^(s+1)}^i at row i * n / 2^(s+1). One table
    per size and direction serves every stage (512 MiB at 2^24)."""
    return _power_table(BN254_FR, _root(BN254_FR, log_n, inverse), log_n - 1, device)


def _flat(batch: torch.Tensor, log_n: int, inverse: bool) -> torch.Tensor:
    """The flat radix-2 transform of every row of (B, n, 16), n >= 2^12:
    one pass of kernel A over the 2^11-point chunks, one launch of kernel G
    per stage from 11 up, and n^-1 for the inverse."""
    nb, n, _ = batch.shape
    dev = batch.device
    log_c = log_n - MAX_PASS_LOG
    # after a global bit reversal, chunk c holds the bit reversal of
    # x_c[u] = a[u * 2^log_c + bitrev(c)], column bitrev(c) of the
    # (2^11, 2^log_c) view; kernel A reverses by its load address, so it reads
    # that column in place in natural order
    cols = batch.unflatten(1, (1 << MAX_PASS_LOG, 1 << log_c)).transpose(1, 2)
    a = ntt_pass(cols, _pass_twiddles(MAX_PASS_LOG, inverse, dev), rev_rows=True).view(nb, n, L)
    tw = _flat_twiddles(log_n, inverse, dev)
    for s in range(MAX_PASS_LOG, log_n):
        butterfly(a, tw, s, n >> (s + 1), out=a)
    if inverse:
        a = mont.mont_mul(BN254_FR, a, _n_inv(log_n, dev))
    return a


def four_step_split(log_n: int) -> tuple[int, int]:
    log_n1 = log_n // 2
    return log_n1, log_n - log_n1


@functools.cache
def four_step_twiddles(log_n: int, inverse: bool, device: torch.device) -> torch.Tensor:
    """(n, 16) table: tw[j*N1 + k1] = w^(j*k1) [* n^-1 if inverse]."""
    f = BN254_FR
    n = 1 << log_n
    log_n1, log_n2 = four_step_split(log_n)
    ptab = _power_table(f, _root(f, log_n, inverse), log_n, device)
    j = torch.arange(1 << log_n2, device=device)[:, None]
    k1 = torch.arange(1 << log_n1, device=device)[None, :]
    tw = ptab[((j * k1) % n).reshape(-1)]
    if inverse:
        tw = mont.mont_mul(f, tw, _mont_limbs(f, pow(n, -1, f.p), device))
    return tw


def _transform(params: FieldParams, batch: torch.Tensor, inverse: bool) -> torch.Tensor:
    """(B, n, 16) -> the NTT (or inverse NTT, 1/n included) of every row."""
    if params != BN254_FR:
        raise ValueError("the NTT runs over BN254 Fr")
    nb, n, _ = batch.shape
    log_n = n.bit_length() - 1
    if n != 1 << log_n:
        raise ValueError(f"NTT size {n} is not a power of two")
    if n == 1:
        return batch
    if log_n > MAX_FOUR_STEP_LOG or (log_n > MAX_PASS_LOG
                                     and os.environ.get("ZKDCAP_NO_FOUR_STEP")):
        return _flat(batch, log_n, inverse)
    dev = batch.device
    if log_n <= MAX_PASS_LOG:
        ptw = _n_inv(log_n, dev) if inverse else None
        return ntt_pass(batch, _pass_twiddles(log_n, inverse, dev), ptw)
    log_n1, log_n2 = four_step_split(log_n)
    N1, N2 = 1 << log_n1, 1 << log_n2
    # pass A over i for each column j: a[i*N2 + j] is column j, element i of
    # the (N1, N2) view, read in place; it writes (nb, N2, N1) contiguous
    cols = torch.empty(nb, N2, N1, L, dtype=batch.dtype, device=dev)
    ntt_pass(batch.unflatten(1, (N1, N2)).transpose(1, 2), _pass_twiddles(log_n1, inverse, dev),
             four_step_twiddles(log_n, inverse, dev), out=cols)
    # pass B over j for each row k1 (a column of cols), written in natural
    # order: out[k1 + N1*k2] = D[k1, k2]
    out = torch.empty(nb, n, L, dtype=batch.dtype, device=dev)
    ntt_pass(cols.transpose(1, 2), _pass_twiddles(log_n2, inverse, dev),
             out=out.view(nb, N2, N1, L).transpose(1, 2))
    return out


def ntt_rows(params: FieldParams, batch: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """The NTT (or inverse NTT) of every row of a (B, n, 16) tensor or
    strided view whose limb dimension is contiguous (kernel A reads the
    strides): the sharded NTT's local transforms. Returns a new contiguous
    (B, n, 16) tensor, or the input itself when n == 1."""
    return _transform(params, batch, inverse)


def ntt(params: FieldParams, a: torch.Tensor) -> torch.Tensor:
    """Forward NTT: coefficients (natural order) -> evaluations at w^i."""
    return _transform(params, a[None], False)[0]


def intt(params: FieldParams, a: torch.Tensor) -> torch.Tensor:
    """Inverse NTT: evaluations -> coefficients (natural order)."""
    return _transform(params, a[None], True)[0]


def ntt_many(params: FieldParams, arrays: list[torch.Tensor]) -> list[torch.Tensor]:
    """Batched forward NTT of equal-length polys."""
    if not arrays:
        return []
    return list(_transform(params, torch.stack(arrays), False).unbind(0))


def intt_many(params: FieldParams, arrays: list[torch.Tensor]) -> list[torch.Tensor]:
    """Batched inverse NTT of equal-length polys."""
    if not arrays:
        return []
    return list(_transform(params, torch.stack(arrays), True).unbind(0))


class Domain:
    """Evaluation domain over BN254 Fr (halo2 EvaluationDomain analog).

    Moves polynomials between coefficient form, Lagrange form on H = <omega>
    (|H| = 2^k) and Lagrange form on the extended coset g*H'
    (|H'| = 2^extended_k) used for quotient evaluation."""

    def __init__(self, params: FieldParams, k: int, extended_k: int | None = None):
        self.params = params
        self.k = k
        self.n = 1 << k
        self.extended_k = extended_k if extended_k is not None else k
        self.extended_n = 1 << self.extended_k
        p = params.p
        self.omega = params.nth_root_of_unity(k)
        self.omega_inv = pow(self.omega, -1, p)
        self.extended_omega = params.nth_root_of_unity(self.extended_k)
        # coset generator: the field's multiplicative generator (zeta in halo2)
        self.g_coset = params.generator
        self.g_coset_inv = pow(self.g_coset, -1, p)
        self._powers = {}

    def _coset_powers(self, inverse: bool, device) -> torch.Tensor:
        key = (inverse, device)
        if key not in self._powers:
            base = self.g_coset_inv if inverse else self.g_coset
            self._powers[key] = power_table(self.params, base, self.extended_n, device)
        return self._powers[key]

    def coeff_to_lagrange(self, a: torch.Tensor) -> torch.Tensor:
        return ntt(self.params, a)

    def lagrange_to_coeff(self, a: torch.Tensor) -> torch.Tensor:
        return intt(self.params, a)

    def coeff_to_extended(self, a: torch.Tensor) -> torch.Tensor:
        """Evaluate coeffs on the extended coset g*H'. Input len <= extended_n,
        output len extended_n."""
        pad = self.extended_n - a.shape[0]
        if pad > 0:
            a = torch.cat([a, a.new_zeros(pad, L)])
        a = mont.mont_mul(self.params, a, self._coset_powers(False, a.device))
        return ntt(self.params, a)

    def extended_to_coeff(self, a: torch.Tensor) -> torch.Tensor:
        """Inverse of coeff_to_extended; returns extended_n coefficients."""
        a = intt(self.params, a)
        return mont.mont_mul(self.params, a, self._coset_powers(True, a.device))
