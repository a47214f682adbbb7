#!/usr/bin/env python3
"""On-card smoke run of zkdcap_tpu_torch, the PyTorch + CUDA port.

    python3 chip_smoke.py

Needs one CUDA card (an H100 for the numbers the repo keeps) and nvcc; it
fails, printing no result, without them or outside a checkout of the repo.

1. builds the seven CUDA kernels from ``zkdcap_tpu_torch/csrc`` (one nvcc
   per source, in parallel) and the host witness evaluator (g++); prints
   each kernel function's registers, stack and spills (``-Xptxas -v``) and
   the SASS instruction count of one Fq product, addition and subtraction
   (probe kernels read with ``cuobjdump -sass``, where the toolkit has it);
2. runs each kernel and its plain torch version on the same seeded inputs at
   the main paths' shapes and requires an exact match, timing both (and,
   for kernel F, the PyTorch sort + gather that computes the same function);
   kernel A also at the DCAP proof's passes (2^8 x 22 * 2^9 and 2^9 x 22 *
   2^8 rows, 2^9 x 2^10 and 2^10 x 2^9) and in the 2^22 transforms' own
   strided layouts (the four-step passes' columns and transposed output,
   the flat pass's bit-reversed columns), every input with the edge values
   0, 1, p - 1 and R (``A_ROWS``); kernel B also at the proofs' scans (8
   and 16 steps over 5 x 16384 lanes) and kernel C at the proofs'
   Hillis-Steele level (102,400 lanes) and suffix scans (1,280 lanes); each
   kernel's ``ms`` is the CUDA-event
   time around back-to-back calls of its wrapper, its ``kernel_ms`` the
   device time of its own CUDA functions per call (torch.profiler);
   kernel G at the top stages of the DCAP proof's flat 2^17 (22 advice
   columns) and 2^19 transforms and of a 2^24 transform; kernel D at the
   proofs' W = 20, c = 13 and the 2^20 MSM's W = 16, c = 16, with its time
   per chain step;
3. drives the commitment engine at k = 18 through its entry points, each
   phase against an independent host oracle: gen_srs(18), commit_lagrange
   and commit_many of 2^18-point polys, the Domain(18, 20) coset round trip,
   a 2^20-point msm_device at 16384 lanes, 2^22- and 2^19-point NTTs; then the
   2^20 MSM and the 2^18 commitment again under ``ZKDCAP_MSM_ROWSORT=1`` and
   ``ZKDCAP_MSM_BITONIC=1``, equal to the default path's points; the flat
   NTT: 2^23 and 2^24 round trips and sparse polys against host sums, the
   2^22 NTT under ``ZKDCAP_NO_FOUR_STEP=1`` equal to the four-step result,
   and the Domain(21, 23) coset round trip; every kernel's launch count must
   rise during this phase;
4. drives the prover: the small circuits of the CPU tests must prove the
   bytes of ``zkdcap_tpu_torch/testdata/reference_proofs.json`` (the JAX
   package's proofs, SHPLONK and GWC; the keccak toy proofs also through
   their generated Solidity verifier, compiled by ``evm/solc.py`` and
   executed by ``evm/interp.py``: accepted, and reverted with a changed
   instance or a flipped byte), then a circuit with the k = 18 P-256 ECDSA circuit's
   layout (``assets/pinning_k18.json``) goes through keygen and three seeded
   proofs, which must be identical, pass the port's verifier and fail it
   with one byte flipped; every kernel but F must launch here;
5. drives the slice's main path, the P-256 ECDSA prover service
   ``ECDSAProver(k=18)`` on the real circuit, in a fresh params dir: keygen
   (its ``vk_k18.json`` must equal ``assets/vk_k18.json``), a reload from the
   saved artifacts, and proofs of the reference test vector under one
   blinding seed, one untimed and then one each with the default sorts,
   ``ZKDCAP_MSM_ROWSORT=1`` and ``ZKDCAP_MSM_BITONIC=1``: identical, equal
   to the JAX package's proof in
   ``zkdcap_tpu_torch/testdata/p256_proof.json``, accepted by ``verify``
   (and a flipped byte rejected), with the native witness evaluator run for
   each; ``assets/p256_proof.hex`` must verify; kernels A-F must launch;
   then the EVM verifier on the loaded prover: a keccak proof
   (``create_proof(evm=True)``) equal to the fixture's ``proof_keccak``,
   ``gen_evm_verifier``, ``compile_solidity`` and ``verify(evm=True)``
   (accepts; rejects a changed instance and three flipped bytes), and an
   ``ECDSAProver(multiopen="gwc")`` on the same artifacts whose keccak proof
   its GWC contract accepts and the SHPLONK contract rejects (equal to the
   fixture's ``card_gwc_keccak`` once it holds one);
6. drives this slice's main path, the DCAP prover ``DcapProver(k=17)`` on
   the demo input, in a fresh params dir: keygen (SRS, trace + compile,
   device keygen and the pk's save timed apart; its vk must hold the JAX
   package's commitments of ``zkdcap_tpu_torch/testdata/dcap_proof.json``),
   one untimed proof, then one proof with the default NTT and one under
   ``ZKDCAP_NO_FOUR_STEP=1``, all with the fixture's seed and equal to its
   bytes, with the native evaluator run for each and kernel G launched in
   the switched proof; ``verify`` accepts (and a flipped byte fails);
   kernels A-E and G must launch;
6b. drives the sharded prover (``parallel/``) on step 3's inputs and the
   provers of steps 5 and 6, over a mesh of shards on distinct cards, or of
   virtual shards of ``cuda:0`` on a machine with one card (it prints
   ``cards: N`` and ``virtual``): the 2^20 MSM and the 2^22 NTT over 2, 4 and
   8 shards, equal to one device's results (medians of three, beside one
   device's; each with the number of lanes ``Mesh.map`` issued the shards
   in: one a card, so one for virtual shards), and on distinct cards
   one profiled call of each with the cards' busy ms and the concurrency
   ratio (their sum over the wall time; above 1, the cards overlapped); the
   P-256 proof on one device, over 2 and 4 shards and again
   with ``ZKDCAP_SHARD_ROWS=0``, and the DCAP proof on one device and over 2
   shards, each equal to its fixture (seconds, rounds, launches and peak
   memory each);
   ``dryrun_multichip(8)``; and a child process in a one-process NCCL group
   (``init_distributed`` from ``ZKDCAP_COORDINATOR`` and a free port) whose
   ``(1, 2)`` ``multihost_mesh`` gives a 2^16 MSM and NTT equal to one
   device's; kernels A-E must launch;
7. builds ``DcapProver(multiopen="gwc")`` on step 6's params dir and the
   artifacts step 6 loaded, and proves the demo input under the fixture's
   seed: the GWC verifier accepts it, the SHPLONK one rejects it, it is
   longer than the SHPLONK proof and equal to ``testdata/dcap_proof.json``'s
   ``card_gwc`` (once the fixture holds one);
8. proves the DCAP circuit with ``create_proof(checkpoint=True)`` in a
   fresh params dir (the same loaded artifacts), preempted after r1, r3 and
   r6 and resumed each time: every resumed proof equals
   ``testdata/dcap_proof.json``, no ``ck_*.npz`` is left, and each round's
   save is timed and measured;
9. profiles the engine's phases (the 2^20 MSM also under each sort switch),
   one k = 18 P-256 proof (the default sorts; kernel F's device ms per proof
   under a switch is step 5's launches times its ``kernel_ms``) and one DCAP
   proof (the default NTT, without host tracing; kernel G's device ms per
   flat proof is step 6's launches times its ``kernel_ms``) with
   torch.profiler, kernel C's launches in the
   default DCAP proof counted and timed by lane count, every NTT of the
   P-256 proof in a marked range (the device ms of torch's kernels inside
   it: the copies and gathers around kernel A) and the NTT calls of the
   default proofs listed
   in the report (``ntt_calls``, which ``tools/kernel_ab.py`` replays); then
   ranks the kernels by the device time each loses per proof against its
   bound; then frees the P-256 and DCAP provers;
10. drives the prover CLI (``zkdcap_tpu_torch.cli``) on the params dirs of
   steps 5 and 6: in this process ``prove --evm`` (a pk reload and a proof
   on the card, kernels A-E launched), ``gen-solidity --output`` (step 5's
   source) and ``verify --evm`` of a flipped proof (exit 1); as processes of
   their own ``verify --evm`` of the CLI's proof (exit 0), ``gen-calldata``
   and ``dcap-verify`` of step 6's proof (exit 0);
11-12. drives the cert-chain and quote prover services,
   ``CertChainProver(k=17, structure=make_intel_demo_chain())`` and
   ``QuoteProver(k=17)`` on ``make_demo_quote()``, each in a fresh params
   dir with a copy of step 6's SRS: keygen (phases timed; its vk must hold
   the JAX keygen's commitments of ``testdata/{cert_chain,quote}_vk.json``),
   the tape, a warm-up and a timed proof under one seed (identical, equal to
   the fixture's card proof once it holds one, kernels A-E launched in
   each), ``verify`` (and a flipped byte; their profiled proofs are cut for
   the time limit since PR 10), the proof's hex in the report; each prover
   is freed after its step;
13. prints the kernel table as one JSON line (launches of steps 5-8 and
   10-12 and 6b, and per cert-chain, quote and sharded P-256 proof), the card's name and power
   limit, the seconds at which each step started, and last
   ``{"ok": true, "device": {...}}``.

Everything it prints also lands in ``build/chip_smoke.json``.
"""

from __future__ import annotations

import gc
import importlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()

# Peak rates of one H100 SXM at its 700 W limit: HBM bandwidth, and 32-bit
# integer multiply-adds at half the 67 TFLOP/s (33.5 T FMA/s) float32 rate
# (Hopper runs 64 IMAD per SM and clock against 128 FFMA).
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 33.5e12 / 2
# 32-bit multiply-adds of one 8 x 32-bit Montgomery product: 64 + 64 wide
# products (two IMADs each) and 8 for the REDC multipliers.
IMAD_PER_MONT_MUL = 2 * (64 + 64) + 8
LIMB_BYTES = 64  # one element: 16 int32 limbs
POINT_BYTES = 3 * LIMB_BYTES  # one projective point
# Montgomery products of the RCB'15 formulas with b3 = 9 done by additions:
# mixed addition 11, complete addition 12, doubling 8 (6M + 2S).
MADD_MULS, ADD_MULS, DBL_MULS = 11, 12, 8
# TPU kernels of the same contract that each CUDA kernel also stands for.
ALSO_REPLACES = {
    "ntt_pass": ["zkdcap_tpu/fields/pallas_mont.py:396", "zkdcap_tpu/fields/pallas_mont.py:738"],
    "madd_scan": ["zkdcap_tpu/curves/ec_kernels.py:560",
                  "zkdcap_tpu/curves/ec_kernels.py:149 (as one step, M = 1)"],
    "bitonic_sort": ["zkdcap_tpu/utils/device_sort.py:105 (_sort_call, bitonic_sort)",
                     "zkdcap_tpu/utils/device_sort.py:153 (_rows_sort_call, sort_rows_by_key)"],
}

# The main path's shapes: a k = 18 SRS and commitments, the Domain(18, 20)
# extension, bench.py's 2^20-point MSM at 16384 lanes (its scans and
# Hillis-Steele levels: B_ROWS, C_ROWS) and its 2^22-point NTT (four-step
# passes of 2^11; the 2^20 and 2^18 transforms use passes of 2^10 and 2^9),
# and the DCAP proof's extended 2^19 (passes of 2^9 and 2^10).
SIZES = {"k": 18, "ext_k": 20, "msm_log": 20, "lanes": 16384, "ntt_log": 22,
         "ntt_ext_log": 19, "pass_logs": (9, 10, 11), "pool": 4096, "mul_log": 20, "proofs": 3}
# Kernel D's shapes (windows, window bits): every commitment of both proofs
# (below 2^20 points, _auto_c picks c = 13: 20 windows), the main row; and
# bench.py's 2^20 MSM (c = 16)
JOIN_SHAPES = {"window_join": (20, 13), "window_join/2^20": (16, 16)}
KERNELS = ("ntt_pass", "madd_scan", "ec_add_select", "window_join", "mont_mul", "bitonic_sort",
           "butterfly")
# Kernel G's shapes: (rows, log n) of the top stage of the DCAP proof's flat
# transforms under ZKDCAP_NO_FOUR_STEP=1 (round 1's intt_many of the 22
# advice columns at 2^17, one extended-coset column at 2^19) and of a 2^24
# transform, the flat path's size above the four-step limit
BUTTERFLY_SHAPES = {"butterfly/2^17": (22, 17), "butterfly": (1, 19), "butterfly/2^24": (1, 24)}
# the flat path's sizes in the engine step, and Domain(21, 23)
FLAT_LOGS, FLAT_DOMAIN = (23, 24), (21, 23)
NO_FOUR_STEP = "ZKDCAP_NO_FOUR_STEP"
# the record_function range around every NTT in step 9's profiles
NTT_RANGE = "ntt _transform"
# the blinding seed of the k = 18 layout proofs
PROOF_SEED = b"chip-smoke-k18"
# Kernel F's shapes on the main path: the window groups of a 2^18 commitment
# (c = 13: 20 windows, 5 per group, digits |d| <= 2^12) and of bench.py's
# 2^20 MSM (c = 16: 8 per group, |d| <= 2^15); the row sort's 2^18 segment
# holds the key and the 8 u16-packed point planes.
SORT_SHAPES = {"commit": (5, 18, 12), "msm": (8, 20, 15)}
SWITCHES = {"rowsort": "ZKDCAP_MSM_ROWSORT", "bitonic": "ZKDCAP_MSM_BITONIC"}
# where a tampered proof has one byte flipped before the generated EVM
# verifier executes it (fractions of the proof's length)
EVM_FLIPS = (0.2, 0.65, 0.95)
# CUDA functions of a kernel where they are not named <kernel>_kernel (none
# of kernel F's holds "gather", which gather_ms counts)
KERNEL_FUNCS = {"bitonic_sort": ("bitonic_tile_kernel", "bitonic_group_kernel",
                                 "bitonic_rows_kernel", "bitonic_permute_kernel"),
                "ec_add_select": ("ec_add_select_kernel", "ec_add_select_group_kernel")}
# Kernel B's rows of step 2, (steps M, lanes B, masks, timed calls): the
# 2^20 MSM's scan (c = 16: 8 windows merged into 64 steps over 8 x 16384
# lanes, random masks, every run starting at step 0); the scans of the DCAP
# proof's 2^17-point commitments (M = 8) and of the P-256 proof's 2^18
# (M = 16), 5 windows x 16384 lanes, masks from sorted random c = 13 window
# digits as a commitment's scan sees them; and one step over 2^20 lanes
# with 60% of them adding (onto the identity), the work of the TPU's
# single-step kernel (ec_kernels.py:149)
B_ROWS = {"madd_scan": (64, 8 * 16384, "random", 3),
          "madd_scan/8x81920": (8, 5 * 16384, "digits", 3),
          "madd_scan/16x81920": (16, 5 * 16384, "digits", 3),
          "madd_scan/M=1": (1, 1 << 20, "one step", 10)}
# Kernel C's rows, (lanes, mask, timed calls): the 2^20 MSM's Hillis-Steele
# level (8 windows x K = 16384 + 32768) and the proofs' (c = 13: 5 windows
# x K = 16384 + 4096 run partials), half the lanes adding at random; and
# the aggregation's suffix scans (20 windows x 64 slots), every slot but the
# last of each window adding
C_ROWS = {"ec_add_select": (8 * (16384 + 32768), "half", 5),
          "ec_add_select/102400": (5 * (16384 + 4096), "half", 20),
          "ec_add_select/1280": (20 * 64, "suffix", 20)}
# Kernel A's rows of step 2, (log S, rows, inverse, log n of the four-step
# twiddles post-multiplied or None, layout, timed calls): each size of
# SIZES["pass_logs"] over as many rows, both directions, with the
# 2^(2S)-point four-step twiddles and without (the main row: 2^11 x 2048,
# forward, post-multiplied, the 2^22 transform's pass A); the proofs' passes:
# the DCAP proof's 2^17 transforms of its 22 advice columns (2^8 over 22 x
# 2^9 columns with the twiddles, 2^9 over 22 x 2^8 rows) and its 2^19
# extension (2^9 over 2^10 with, 2^10 over 2^9 without), on contiguous rows;
# and the 2^22 four-step passes in their own strided layouts: pass A reads
# the columns of the (2^11, 2^11) array, pass B reads the columns of its
# scratch and writes the transposed output; and the flat 2^22 transform's
# pass, which reads the columns in bit-reversed order. Every input holds the
# edge values 0, 1, p - 1 and R (elements 0-3 of every row; rows 0 and 1 all
# p - 1 and all R).
A_ROWS = {("ntt_pass" if (s, inv, post) == (11, False, True)
           else f"ntt_pass/{s}/{int(inv)}/{int(post)}"): (s, 1 << s, inv, 2 * s if post else None,
                                                         "rows", 5)
          for s in (9, 10, 11) for inv in (False, True) for post in (True, False)}
A_ROWS.update({"ntt_pass/2^8x11264": (8, 22 << 9, False, 17, "rows", 10),
               "ntt_pass/2^9x5632": (9, 22 << 8, False, None, "rows", 10),
               "ntt_pass/2^9x1024": (9, 1 << 10, False, 19, "rows", 10),
               "ntt_pass/2^10x512": (10, 1 << 9, False, None, "rows", 10),
               "ntt_pass/4step-A": (11, 1 << 11, False, 22, "columns", 5),
               "ntt_pass/4step-B": (11, 1 << 11, False, None, "transposed", 5),
               "ntt_pass/flat": (11, 1 << 11, False, None, "bit-reversed columns", 5)})
# upper bounds of the lane-count buckets of kernel C's launches in the
# profiled DCAP proof (the aggregation's 20-lane sums up to the levels)
C_BUCKETS = (32, 256, 2048, 16384, 131072)
# field operations whose SASS is counted, each alone in a probe kernel
# (the 64-bit multiply-add versions of kernels A, D, E, G and the
# carry-chain versions of kernels B and C)
SASS_PROBES = {op + cc: f"{op}{cc}<Fq>(x, y)" for op in ("fe_mul", "fe_add", "fe_sub")
               for cc in ("", "_cc")}


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn over `reps` runs after one warm-up (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def wall_s(fn) -> tuple[float, object]:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def bound(n_mont: int, n_bytes: int) -> tuple[float, str]:
    t_ops = n_mont * IMAD_PER_MONT_MUL / IMAD_PER_S
    t_bytes = n_bytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def int_bound(n_ops: int, n_bytes: int) -> tuple[float, str]:
    """Bound of a kernel of 32-bit integer operations (compares, selects)."""
    t_ops = n_ops / IMAD_PER_S
    t_bytes = n_bytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def kernel_functions(kname: str) -> tuple[str, ...]:
    return KERNEL_FUNCS.get(kname, (f"{kname}_kernel",))


def sass_counts(nvcc: str) -> dict:
    """SASS instructions of each field operation of SASS_PROBES, from
    ``cuobjdump -sass`` of probe kernels that load two elements, apply it
    once and store the result, less a probe that only loads and stores."""
    import re

    cuobjdump = Path(nvcc).with_name("cuobjdump")
    if not cuobjdump.exists():
        return {"available": False}
    work = ROOT / "build" / "probe"
    work.mkdir(parents=True, exist_ok=True)
    body = ["#include \"bn254_mont.cuh\"", "using namespace zk;",
            "__device__ __forceinline__ Fe ld(const uint32_t* p, long i) {",
            "  Fe r; for (int k = 0; k < 8; k++) r.v[k] = p[i * 8 + k]; return r; }",
            "__device__ __forceinline__ void st(uint32_t* p, long i, const Fe& a) {",
            "  for (int k = 0; k < 8; k++) p[i * 8 + k] = a.v[k]; }"]
    ops = {"copy": "Fe{{x.v[0] ^ y.v[0], x.v[1] ^ y.v[1], x.v[2] ^ y.v[2], x.v[3] ^ y.v[3], "
                   "x.v[4] ^ y.v[4], x.v[5] ^ y.v[5], x.v[6] ^ y.v[6], x.v[7] ^ y.v[7]}}",
           **SASS_PROBES}
    for name, expr in ops.items():
        body += [f"extern \"C\" __global__ void probe_{name}(const uint32_t* a, const uint32_t* b,"
                 " uint32_t* o) {",
                 "  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;",
                 f"  const Fe x = ld(a, i), y = ld(b, i); st(o, i, {expr}); }}"]
    (work / "probe.cu").write_text("\n".join(body) + "\n")
    res = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                          "-cubin", "-I", str(ROOT / "zkdcap_tpu_torch" / "csrc"),
                          "-o", str(work / "probe.cubin"), str(work / "probe.cu")],
                         capture_output=True, text=True, timeout=300)
    if res.returncode:
        raise RuntimeError(f"the SASS probe does not build:\n{res.stdout}{res.stderr}")
    sass = subprocess.run([str(cuobjdump), "-sass", str(work / "probe.cubin")],
                          capture_output=True, text=True, timeout=120, check=True).stdout
    per, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : probe_(\w+)", line)
        if m:
            cur = per.setdefault(m.group(1), {})
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                     r"([A-Z][A-Z0-9_]*(?:\.WIDE|\.HI|\.MOV|\.X)?)", line)
        if m and cur is not None and m.group(1) != "NOP":
            cur[m.group(1)] = cur.get(m.group(1), 0) + 1
    base = per.get("copy", {})
    out = {"available": True}
    for name in SASS_PROBES:
        ops_ = {op: n - base.get(op, 0) for op, n in per.get(name, {}).items()}
        out[name] = {"instructions": sum(per.get(name, {}).values()) - sum(base.values()),
                     "imad": sum(n for op, n in ops_.items() if op.startswith("IMAD")),
                     "by_opcode": {op: n for op, n in sorted(ops_.items()) if n}}
    return out


def lane_bucket(n: int) -> str:
    for top in C_BUCKETS:
        if n <= top:
            return f"C lanes <= {top}"
    return f"C lanes > {C_BUCKETS[-1]}"


def max_abs_err(got, ref) -> tuple[float, int]:
    """Largest limb difference and number of differing elements."""
    import torch

    err, bad = 0, 0
    for g, r in zip(got, ref):
        d = (g.to(torch.int64) - r.to(torch.int64)).abs()
        err = max(err, int(d.max()))
        bad += int((d.reshape(-1, d.shape[-1]) != 0).any(-1).sum()) if d.dim() > 1 else int((d != 0).sum())
    return float(err), bad


def kernel_events(prof, names) -> list[float]:
    """Device ms of each launch of the kernels whose CUDA function names
    contain one of `names`, in the order they ran."""
    from torch.autograd import DeviceType

    evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                  and any(n in e.name for n in names)), key=lambda e: e.time_range.start)
    return [(e.time_range.end - e.time_range.start) / 1e3 for e in evs]


def kernel_ms(fn, names, reps: int) -> float:
    """Device ms per call of fn of the kernels whose CUDA function names
    contain one of `names`, over `reps` calls after one warm-up
    (torch.profiler): the kernel's own time, without the host's launch gaps
    and the wrapper's other work. Every call launches at least one such
    kernel, so a trace with fewer launches than calls lost records: it is
    taken again, at most three times in all. Raises where the trace holds
    none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ms = kernel_events(prof, names)
        if len(ms) >= reps:
            break
    if not ms:
        raise RuntimeError(f"torch.profiler traced no launch of {names} in three tries")
    return sum(ms) / reps


def timed(fn, kname: str, reps: int) -> tuple[float, float]:
    """(CUDA-event ms per call of fn, kernel_ms of kernel `kname`)."""
    return cuda_ms(fn, reps), kernel_ms(fn, kernel_functions(kname), reps)


def point_pool(dev):
    """SIZES["pool"] distinct affine points of G1 on `dev` (G + i * step)."""
    from zkdcap_tpu_torch.curves import BN254_G1
    from zkdcap_tpu_torch.curves.device_g1 import G1_SPEC, encode_points

    host_pts = [BN254_G1.g]
    step = BN254_G1.mul(0xABCDEF123457, BN254_G1.g)
    for _ in range(SIZES["pool"] - 1):
        host_pts.append(BN254_G1.add(host_pts[-1], step))
    return encode_points(G1_SPEC, host_pts, device=dev)


def pass_row(name: str, dev) -> dict:
    """Kernel A at A_ROWS[name] on inputs seeded by the name: its output and
    the plain version's, its times (`timed`) and its work. Shared with
    ``zkdcap_tpu_torch/tools/kernel_ab.py``, which runs the rows of layout
    "rows" (the call every tree's wrapper takes) on two trees."""
    import zlib

    import numpy as np
    import torch

    from zkdcap_tpu_torch.fields import BN254_FR, mont
    from zkdcap_tpu_torch.fields.ntt_kernels import ntt_pass, ntt_pass_plain
    from zkdcap_tpu_torch.fields.params import R, int_to_limbs
    from zkdcap_tpu_torch.ntt.ntt import four_step_twiddles, _pass_twiddles

    log_s, rows, inverse, ptw_log, layout, reps = A_ROWS[name]
    size, p = 1 << log_s, BN254_FR.p
    torch.manual_seed(zlib.crc32(name.encode()))
    base = torch.randint(0, 1 << 16, (rows * size, 16), dtype=torch.int32, device=dev)
    base[:, 15] &= 0x2FFF  # canonical: below 0x3000 * 2^240 < p
    # the logical (rows, size, 16) view: rows, or the columns of (size, rows)
    x = base.view(rows, size, 16) if layout == "rows" else base.view(size, rows, 16).transpose(0, 1)
    edges = torch.from_numpy(np.stack([int_to_limbs(v) for v in (0, 1, p - 1, R % p)])
                             .astype(np.int32)).to(dev)
    x[:, :4] = edges
    x[0] = edges[2]
    x[1] = edges[3]
    tw = _pass_twiddles(log_s, inverse, dev)
    post = None if ptw_log is None else four_step_twiddles(ptw_log, inverse, dev)
    out = None
    if layout == "columns":
        out = torch.empty(rows, size, 16, dtype=torch.int32, device=dev)
    elif layout == "transposed":
        out = torch.empty(rows * size, 16, dtype=torch.int32, device=dev)
        out = out.view(size, rows, 16).transpose(0, 1)

    rev = layout == "bit-reversed columns"

    def call():
        if out is None and not rev:
            return ntt_pass(x, tw, post)  # the call every tree's wrapper takes
        return ntt_pass(x, tw, post, out=out, rev_rows=rev)

    got = call()
    ms, k_ms = timed(call, "ntt_pass", reps)
    plain_s, ref = wall_s(lambda: ntt_pass_plain(x, tw, post, rev_rows=True) if rev
                          else ntt_pass_plain(x, tw, post))
    n = rows * size
    # stage s multiplies by w^0 (no product) in one butterfly of 2^s; the
    # post-multiply by R (the Montgomery one) is no product either
    n_mont = rows * sum((1 << (log_s - 1)) - (1 << (log_s - 1 - s)) for s in range(log_s))
    period = 0 if post is None else post.shape[0]
    if post is not None:
        one = mont.one_mont(BN254_FR, device=dev)
        n_mont += int((post != one).any(-1).sum()) * (n // period)
    # x and the output once each, the post-multiplier's table once, the stage twiddles once
    n_bytes = LIMB_BYTES * (2 * n + period + size // 2)
    post_mul = "no post-mul" if post is None else f"post-mul by the 2^{ptw_log} four-step twiddles"
    shape = f"pass 2^{log_s} x {rows} rows, {'inv' if inverse else 'fwd'}, {post_mul}, {layout}, " \
            "edge values"
    return {"got": (got,), "ref": (ref,), "ms": ms, "kernel_ms": k_ms, "plain_ms": plain_s * 1e3,
            "n_mont": n_mont, "n_bytes": n_bytes, "shape": shape}


def scan_row(name: str, pool) -> dict:
    """Kernel B at B_ROWS[name] on inputs seeded by the name: its output and
    the plain version's, its times (`timed`) and its work. Shared with
    ``zkdcap_tpu_torch/tools/kernel_ab.py``, which runs it on two trees."""
    import zlib

    import torch

    from zkdcap_tpu_torch.curves import ec_kernels as ek
    from zkdcap_tpu_torch.curves.device_g1 import G1_SPEC

    M, B, kind, reps = B_ROWS[name]
    dev = pool.device
    torch.manual_seed(zlib.crc32(name.encode()))
    idx = torch.randint(0, pool.shape[0], (M * B,), device=dev)
    rows_pm = ek.pack_affine_rows(pool)[idx].reshape(M, B, 16).transpose(1, 2).contiguous()
    if kind == "digits":
        windows, lanes = B // 16384, 16384
        d = torch.randint(-(1 << 12), 1 << 12, (windows, lanes * M), device=dev).abs()
        dm = d.sort(dim=1).values.reshape(windows, lanes, M).permute(2, 0, 1).reshape(M, B)
        same = torch.zeros_like(dm, dtype=torch.bool)
        same[1:] = dm[1:] == dm[:-1]
        masks = torch.stack([same, dm != 0, torch.rand(M, B, device=dev) < 0.5], 1)
    else:
        masks = torch.rand(M, 3, B, device=dev) < torch.tensor([0.6, 0.97, 0.5], device=dev)[:, None]
        if kind == "random":
            masks[0, 0] = False
    masks = masks.to(torch.int32).contiguous()
    got = ek.ec_madd_scan_full(G1_SPEC, rows_pm, masks)
    ms, k_ms = timed(lambda: ek.ec_madd_scan_full(G1_SPEC, rows_pm, masks), "madd_scan", reps)
    plain_s, ref = wall_s(lambda: ek.ec_madd_scan_plain(G1_SPEC, rows_pm, masks))
    # a step-lane adds only where valid and same; it reads its row only where valid
    n_madd = int((masks[:, 0] & masks[:, 1]).sum())
    n_valid = int(masks[:, 1].sum())
    return {"got": got, "ref": ref, "ms": ms, "kernel_ms": k_ms, "plain_ms": plain_s * 1e3,
            "n_mont": MADD_MULS * n_madd, "n_bytes": n_valid * LIMB_BYTES + M * B * (12 + POINT_BYTES),
            "shape": f"M={M} step{'s' if M > 1 else ''} x B={B} lanes, {kind} masks, "
                     f"{n_madd} mixed additions"}


def add_row(name: str, pool) -> dict:
    """Kernel C at C_ROWS[name], as scan_row: both fallbacks are checked,
    fallback p is timed."""
    import zlib

    import torch

    from zkdcap_tpu_torch.curves import ec_kernels as ek
    from zkdcap_tpu_torch.curves.device_g1 import G1_SPEC, affine_to_projective

    n, kind, reps = C_ROWS[name]
    dev = pool.device
    torch.manual_seed(zlib.crc32(name.encode()))
    P, Q = (affine_to_projective(G1_SPEC, pool[torch.randint(0, pool.shape[0], (n,), device=dev)])
            for _ in range(2))
    if kind == "half":
        mask = (torch.rand(n, device=dev) < 0.5).to(torch.int32)
    else:
        mask = (torch.arange(n, device=dev) % 64 != 63).to(torch.int32)
    got = ek.ec_add_select(G1_SPEC, P, Q, mask, "p")
    ms, k_ms = timed(lambda: ek.ec_add_select(G1_SPEC, P, Q, mask, "p"), "ec_add_select", reps)
    plain_s, ref = wall_s(lambda: ek.ec_add_select_plain(G1_SPEC, P, Q, mask, "p"))
    got += ek.ec_add_select(G1_SPEC, P, Q, mask, "q")
    ref += ek.ec_add_select_plain(G1_SPEC, P, Q, mask, "q")
    # every lane reads its mask and fallback and writes a point; only the
    # lanes that add read the other operand
    added = int(mask.sum())
    return {"got": got, "ref": ref, "ms": ms, "kernel_ms": k_ms, "plain_ms": plain_s * 1e3,
            "n_mont": ADD_MULS * added, "n_bytes": n * (4 + 2 * POINT_BYTES) + added * POINT_BYTES,
            "shape": f"n={n} lanes, {added} adding ({kind}), fallback p and q"}


def device_breakdown(fn, top: int = 10, ranges=(), sequence=()) -> dict:
    """One run of fn under torch.profiler: its wall time, the device time by
    kernel (self time, summed over launches), the device's busy share and
    the device time of the kernels launched inside each named
    ``record_function`` range of `ranges`; with `sequence`, the device ms
    of each launch of the kernels so named, in order. The host's operations
    are traced only where `ranges` needs them, which keeps the trace small."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if ranges else [])
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    # device-side kernels only: a CPU op's row repeats its kernels' time, and
    # a range's device-side row spans its kernels and the gaps between them
    rows = [(e.key, e.count, e.self_device_time_total / 1e3) for e in averages
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not e.key.startswith("Activity Buffer") and e.key not in ranges]
    rows.sort(key=lambda r: -r[2])
    busy_ms = sum(r[2] for r in rows)
    in_ranges = {e.key: {"calls": e.count, "device_ms": e.device_time_total / 1e3}
                 for e in averages if e.key in ranges and e.device_type == DeviceType.CPU}
    ours = {}  # the repo's kernels A-G by their CUDA function names
    for key, count, ms in rows:
        for kname in KERNELS:
            if any(f in key for f in KERNEL_FUNCS.get(kname, (f"{kname}_kernel",))):
                acc = ours.setdefault(kname, {"launches": 0, "ms": 0.0})
                acc["launches"] += count
                acc["ms"] += ms
    gather_ms = sum(ms for key, _, ms in rows if "gather" in key)
    return {"wall_ms_profiled": wall_ms, "device_busy_ms": busy_ms, "gather_ms": gather_ms,
            "busy_share": busy_ms / wall_ms if wall_ms else None,
            "kernel_launches": sum(r[1] for r in rows), "ranges": in_ranges, "ours": ours,
            "top": [{"kernel": k[:120], "launches": n, "ms": ms} for k, n, ms in rows[:top]],
            "sequence_ms": kernel_events(prof, sequence) if sequence else []}


def sort_checks(record, dev) -> None:
    """Kernel F against its plain version, exact, at the shapes of a 2^18
    commitment's and the 2^20 MSM's window groups: the digit sort (|d| and
    sign<<30 | index), the run-end sort (one key, notend<<30 | index) and,
    for the commitment, the row sort of the key with the 8 X planes shared
    by the windows and with per-window Y planes. Each is timed beside its
    plain version and beside torch.sort plus a gather of every payload."""
    import torch

    from zkdcap_tpu_torch.utils import device_sort as ds

    src, rep = "zkdcap_tpu_torch/csrc/bitonic_sort.cu", "zkdcap_tpu/utils/device_sort.py:42"

    def library(key, payloads, shared=False):
        # torch.sort by key (its keys here are below 2^31, where a signed
        # sort is the unsigned one), then one gather per payload
        skey, order = torch.sort(key, dim=1)
        if shared:
            return skey, [p[order] for p in payloads]
        return skey, [torch.gather(p, -1, order) for p in payloads]

    def check(name, fn, plain, lib, batch, n, n_ops, moved, shape):
        got = fn()
        ms, k_ms = timed(fn, "bitonic_sort", 5)
        plain_s, ref = wall_s(plain)
        lib_ms = cuda_ms(lib, 5)
        log_n = n.bit_length() - 1
        exchanges = batch * (n // 2) * log_n * (log_n + 1) // 2
        # a compare-exchange: one compare and two selects per operand. The
        # swaps depend on the key alone, so the same output, ties included,
        # comes from the network on key + index and one gather of the other
        # operands: at most two operands go through the network, the rest
        # are moved once (their bytes are in `moved`)
        record(name, src, rep, got, ref, ms, k_ms, plain_s * 1e3, 0, 4 * moved, shape,
               library_ms=lib_ms, n_ops=exchanges * (1 + 2 * min(n_ops, 2)))

    for label, (wp, log_n, dbits) in SORT_SHAPES.items():
        n = 1 << log_n
        digit = torch.randint(-(1 << dbits), 1 << dbits, (wp, n), device=dev, dtype=torch.int32)
        idx = torch.arange(n, device=dev, dtype=torch.int32)
        key = digit.abs()
        pay = torch.where(digit < 0, idx | (1 << 30), idx).to(torch.int32)
        check(f"bitonic_sort/digits/{label}", lambda: ds.bitonic_sort((key, pay)),
              lambda: ds.bitonic_sort_plain((key, pay)), lambda: library(key, [pay]),
              wp, n, 2, 2 * 2 * wp * n, f"digit sort, {wp} x 2^{log_n}, key + payload")
        notend = (torch.rand(wp, n, device=dev) > 0.1).to(torch.int32)
        ekey = (notend << 30) | idx
        check(f"bitonic_sort/ends/{label}", lambda: ds.bitonic_sort((ekey,)),
              lambda: ds.bitonic_sort_plain((ekey,)), lambda: library(ekey, []),
              wp, n, 1, 2 * wp * n, f"run-end sort, {wp} x 2^{log_n}, one key")
        if label != "commit":
            continue
        planes = torch.randint(-(1 << 31), 1 << 31, (8, n), device=dev, dtype=torch.int64)
        planes = planes.to(torch.int32)
        check("bitonic_sort/rows/shared", lambda: ds.sort_rows_by_key(key, planes, False),
              lambda: ds.sort_rows_by_key_plain(key, planes, False),
              lambda: library(key, list(planes), shared=True), wp, n, 9,
              2 * wp * n + 8 * n + 8 * wp * n,
              f"row sort, {wp} x 2^{log_n}, key + 8 planes shared by the windows")
        yplanes = torch.randint(-(1 << 31), 1 << 31, (wp, 8, n), device=dev,
                                dtype=torch.int64).to(torch.int32)
        check("bitonic_sort", lambda: ds.sort_rows_by_key(key, yplanes, True),
              lambda: ds.sort_rows_by_key_plain(key, yplanes, True),
              lambda: library(key, [yplanes[:, i] for i in range(8)]), wp, n, 9,
              2 * 9 * wp * n, f"row sort, {wp} x 2^{log_n}, key + 8 planes per window")
        del planes, yplanes
    torch.cuda.empty_cache()


def flipped(proof: bytes, frac: float) -> bytes:
    bad = bytearray(proof)
    bad[int(len(bad) * frac)] ^= 1
    return bytes(bad)


def evm_contract(params, vk, instances: list[int], proof: bytes, multiopen: str) -> dict:
    """Generate the Solidity verifier of `vk`, compile it, and execute it on
    `proof`: it must accept, and revert on a changed instance and on a byte
    flipped at each of EVM_FLIPS. Returns the seconds of each part and the
    byte counts of the source, the bytecode and the calldata."""
    from zkdcap_tpu_torch.evm.calldata import encode_calldata
    from zkdcap_tpu_torch.evm.interp import EvmRevert, deploy_and_call
    from zkdcap_tpu_torch.evm.solc import compile_solidity
    from zkdcap_tpu_torch.evm.solidity import gen_evm_verifier

    gen_s, src = wall_s(lambda: gen_evm_verifier(params, vk, len(instances), multiopen=multiopen))
    compile_s, code = wall_s(lambda: compile_solidity(src))
    calldata = encode_calldata(instances, proof)
    call_s, ret = wall_s(lambda: deploy_and_call(code, calldata))
    if ret != b"\x01":
        raise AssertionError(f"the {multiopen} contract returned {ret.hex()} on a valid proof")
    rejects = [([instances[0] + 1] + instances[1:], proof)] + [
        (instances, flipped(proof, f)) for f in EVM_FLIPS]
    reject_s = []
    for inst, bad in rejects:
        t0 = time.perf_counter()
        try:
            deploy_and_call(code, encode_calldata(inst, bad))
        except EvmRevert:
            reject_s.append(time.perf_counter() - t0)
        else:
            raise AssertionError(f"the {multiopen} contract accepts a tampered proof")
    return {"gen_s": gen_s, "compile_s": compile_s, "call_s": call_s, "reject_s": reject_s,
            "source_chars": len(src), "bytecode_bytes": len(code),
            "calldata_bytes": len(calldata)}


def prove_phase(say, card: str, dev, srs) -> dict:
    """Step 4: the prover's path, with the launch counts set to 0 first.
    Returns the readings and the launch counts of the whole step."""
    import torch

    from zkdcap_tpu_torch import _build
    from zkdcap_tpu_torch.commit import ParamsKZG, gen_srs
    from zkdcap_tpu_torch.fields import BN254_FR, mont
    from zkdcap_tpu_torch.plonk import cs as tcs
    from zkdcap_tpu_torch.plonk import prover as tprover
    from zkdcap_tpu_torch.plonk.keygen import keygen
    from zkdcap_tpu_torch.plonk.verifier import verify_proof
    from zkdcap_tpu_torch.testdata.circuits import (
        FLEX_SMALL, REFERENCE_CASES, flex_circuit_from_pinning, padded_advice)
    from zkdcap_tpu_torch.transcript import TranscriptWriter

    out = {"small": {}}
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()

    def advice_of(circ):
        return [mont.encode_ints(BN254_FR, col, device=dev) for col in padded_advice(circ)]

    def host_s(fn):
        t0 = time.perf_counter()
        res = fn()
        return time.perf_counter() - t0, res

    # (a) the circuits of the CPU tests against the JAX package's proofs;
    # the keccak proofs also go through their generated EVM verifier
    fixture = json.loads((ROOT / "zkdcap_tpu_torch" / "testdata" / "reference_proofs.json")
                         .read_text())
    out["evm"] = {}
    for name, ref in fixture.items():
        circ = REFERENCE_CASES[name][0](tcs)
        if circ.k != ref["k"] or circ.instances != ref["instances"]:
            raise AssertionError(f"circuit {name} is not the fixture's")
        params = ParamsKZG(srs=gen_srs(circ.k, cache_dir=str(ROOT / "build" / "smoke_srs"),
                                       device=dev))
        pk = keygen(params, circ.cs, circ.fixed_values, device=dev)
        advice = advice_of(circ)
        for multiopen, key in (("shplonk", "proofs"), ("gwc", "gwc_proofs")):
            for kind, want in ref[key].items():
                t, proof = wall_s(lambda: tprover.create_proof(
                    params, pk, advice, circ.instances, TranscriptWriter(kind),
                    blinding_seed=ref["seed"].encode(), multiopen=multiopen, device=dev))
                if proof.hex() != want:
                    raise AssertionError(f"{name}/{kind}/{multiopen}: the proof differs from "
                                         "the JAX package's")
                out["small"][f"{name}/{kind}" + ("/gwc" if multiopen == "gwc" else "")] = t
                if kind == "keccak":
                    out["evm"][f"{name}/{multiopen}"] = evm_contract(
                        params, pk.vk, circ.instances[0], proof, multiopen)
    say(f"prover: {len(out['small'])} small proofs (k = 4 toy under blake2b, poseidon, "
        f"keccak; k = {FLEX_SMALL['k']} flex; SHPLONK and GWC) equal the JAX package's bytes in "
        "testdata/reference_proofs.json; seconds "
        + ", ".join(f"{key} {t:.2f}" for key, t in out["small"].items()))
    for key, e in out["evm"].items():
        say(f"prover: the generated EVM verifier of {key} (keccak): source {e['source_chars']} "
            f"chars in {e['gen_s']:.3f} s, compile_solidity {e['bytecode_bytes']} bytes in "
            f"{e['compile_s']:.3f} s; deploy_and_call accepts the card's proof "
            f"({e['calldata_bytes']} calldata bytes) in {e['call_s']:.2f} s and reverts on a "
            f"changed instance and on a byte flipped at {EVM_FLIPS} of the proof in "
            + ", ".join(f"{t:.2f}" for t in e["reject_s"]) + f" s ({card})")

    # (b) the k = 18 P-256 ECDSA circuit's layout
    pinning = json.loads((ROOT / "assets" / "pinning_k18.json").read_text())
    out["circuit_s"], circ = host_s(lambda: flex_circuit_from_pinning(tcs, pinning))
    out["encode_s"], advice = wall_s(lambda: advice_of(circ))
    params = ParamsKZG(srs=srs)
    out["keygen_s"], pk = wall_s(lambda: keygen(params, circ.cs, circ.fixed_values, device=dev))
    say(f"prover k={circ.k}: circuit {out['circuit_s']:.1f} s on the host "
        f"({circ.cs.num_advice} advice, {circ.cs.num_fixed} fixed, "
        f"{len(circ.cs.permutation_columns)} permuted columns, {len(circ.cs.copies)} copies, "
        f"{pinning['num_cells']} flex cells, {pinning['num_lookup_cells']} lookup cells), "
        f"witness upload {out['encode_s']:.1f} s, keygen {out['keygen_s']:.2f} s ({card})")

    def prove_once() -> bytes:
        return tprover.create_proof(params, pk, advice, circ.instances, TranscriptWriter("blake2b"),
                                    blinding_seed=PROOF_SEED, device=dev)

    runs, proofs = [], []
    for _ in range(SIZES["proofs"]):
        before = dict(_build.launches)
        t, proof = wall_s(prove_once)
        proofs.append(proof)
        runs.append({"s": t, "phases_s": dict(tprover.last_phases),
                     "launches": {k: _build.launches[k] - before[k] for k in before}})
    if len(set(proofs)) != 1:
        raise AssertionError("three proofs under one seed differ")
    out["runs"] = runs
    median = sorted(runs, key=lambda r: r["s"])[len(runs) // 2]
    out["prove_s_median"] = median["s"]
    out["proof_bytes"] = len(proofs[0])
    say(f"prover k={circ.k}: {len(runs)} proofs identical ({len(proofs[0])} bytes), "
        f"seconds {[round(r['s'], 3) for r in runs]}; median's rounds: "
        + ", ".join(f"{ph} {s:.3f}" for ph, s in median["phases_s"].items())
        + f"; launches per proof {median['launches']} ({card})")
    out["verify_s"], ok = host_s(lambda: verify_proof(params, pk.vk, circ.instances, proofs[0]))
    if not ok:
        raise AssertionError("the port's verifier rejects the k = 18 proof")
    bad = bytearray(proofs[0])
    bad[len(bad) // 2] ^= 1
    if verify_proof(params, pk.vk, circ.instances, bytes(bad)):
        raise AssertionError("the port's verifier accepts a tampered k = 18 proof")
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["launches"] = dict(_build.launches)
    say(f"prover k={circ.k}: verify_proof accepts ({out['verify_s']:.2f} s on the host) and "
        f"rejects the proof with byte {len(bad) // 2} flipped; peak device memory "
        f"{out['peak_gb']:.1f} GB; launches over step 4 {out['launches']}")
    return out


def service_phase(say, card: str, dev, fixture: dict) -> dict:
    """Step 5, the slice's main path: ``ECDSAProver(k=18)`` on the real P-256
    circuit in a fresh params dir, with the launch counts set to 0 first.
    Returns the readings, the launch counts of the whole step and, under
    "prove_once", a function that runs one more proof (for the profile)."""
    import torch

    from zkdcap_tpu_torch import _build
    from zkdcap_tpu_torch.circuits.p256_ecdsa import ECDSAInput
    from zkdcap_tpu_torch.plonk import prover as tprover
    from zkdcap_tpu_torch.runtime import ECDSAProver
    from zkdcap_tpu_torch.witness import native

    inp = ECDSAInput.from_hex(fixture["msghash"], fixture["signature"], fixture["pubkey"])
    if [inp.as_instances()] != fixture["instances"]:
        raise AssertionError("the fixture's instances are not the reference vector's")
    seed = fixture["seed"].encode()
    params_dir = ROOT / "build" / "smoke_params"
    shutil.rmtree(params_dir, ignore_errors=True)
    out = {}
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()

    # keygen in the fresh dir: SRS, trace + compile, device keygen, save
    first = ECDSAProver(params_dir=str(params_dir), k=18, device=dev)
    saves = []
    save = first._save
    first._save = lambda *a: saves.append(wall_s(lambda: save(*a))[0])
    out["keygen_s"], _ = wall_s(first.keygen)
    out["save_s"] = saves[0]
    vk = json.loads((params_dir / "vk_k18.json").read_text())
    if vk != json.loads((ROOT / "assets" / "vk_k18.json").read_text()):
        raise AssertionError("keygen's vk_k18.json differs from assets/vk_k18.json")
    out["pk_bytes"] = (params_dir / "pk_k18.npz").stat().st_size
    say(f"service keygen k=18: {out['keygen_s']:.1f} s, of which the pk's save (deflate level 1) "
        f"{out['save_s']:.1f} s ({out['pk_bytes'] / 1e9:.2f} GB); vk_k18.json equals "
        f"assets/vk_k18.json (fixed and permutation commitments, blake2b) ({card})")
    del first, save
    torch.cuda.empty_cache()

    # a second prover reloads the saved artifacts
    prover = ECDSAProver(params_dir=str(params_dir), k=18, device=dev)
    prover._save = None  # a reload must not regenerate the pk
    out["reload_s"], _ = wall_s(prover.keygen)
    out["tape_s"], _ = wall_s(prover._get_tape)
    say(f"service reload from pk/vk/pinning: {out['reload_s']:.1f} s; witness tape recorded "
        f"and saved in {out['tape_s']:.1f} s ({card})")

    def prove_once() -> bytes:
        return prover.create_proof(inp, timing=False, blinding_seed=seed)

    # one untimed proof first (it builds the witness fill's index cache),
    # then one proof under each sort
    out["warmup_s"], warm = wall_s(prove_once)
    runs, proofs = {}, [warm]
    for label, var in (("default", None), *SWITCHES.items()):
        if var:
            os.environ[var] = "1"
        try:
            before, replays = dict(_build.launches), native.replays
            t, proof = wall_s(prove_once)
            proofs.append(proof)
        finally:
            if var:
                del os.environ[var]
        if native.replays != replays + 1:
            raise AssertionError("the native witness evaluator did not run for the proof")
        run = {"s": t, "runtime_s": dict(prover.last_phases),
               "rounds_s": dict(tprover.last_phases),
               "launches": {k: _build.launches[k] - before[k] for k in before}}
        runs.setdefault(label, []).append(run)
        say(f"service proof ({label} sorts): {t:.3f} s; runtime phases "
            + ", ".join(f"{ph} {v:.3f}" for ph, v in prover.last_phases.items())
            + "; create_proof rounds "
            + ", ".join(f"{ph} {v:.3f}" for ph, v in tprover.last_phases.items())
            + f"; launches {run['launches']} ({card})")
    for label, rs in runs.items():
        out[f"prove_s_mean/{label}"] = statistics.fmean(r["s"] for r in rs)
    say(f"service: after a warm-up proof of {out['warmup_s']:.3f} s, one proof per sort: " + ", ".join(f"{label} {out[f'prove_s_mean/{label}']:.3f} s" for label in runs)
        + f" ({card})")
    for label, var in SWITCHES.items():
        if min(r["launches"]["bitonic_sort"] for r in runs[label]) <= 0:
            raise AssertionError(f"{var}=1: kernel F did not launch in the proof")
    if len(set(proofs)) != 1:
        raise AssertionError("the proofs under the default, row and bitonic sorts differ")
    proof = proofs[0]
    out["runs"] = runs
    out["proof_bytes"] = len(proof)
    instances = inp.as_instances()
    out["verify_s"], ok = wall_s(lambda: prover.verify(instances, proof))
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    golden = bytes.fromhex((ROOT / "assets" / "p256_proof.hex").read_text().strip()
                           .removeprefix("0x"))
    if not ok or prover.verify(instances, bytes(bad)) or not prover.verify(instances, golden):
        raise AssertionError("verify: the proof, the flipped proof or the golden proof")
    if fixture["k"] != 18 or proof.hex() != fixture["proof"]:
        raise AssertionError("the k=18 proof differs from the JAX package's fixture")
    say(f"service: {len(proofs)} proofs identical ({len(proof)} bytes)"
        + ", equal to the JAX package's k=18 proof in testdata/p256_proof.json"
        + f"; verify accepts it ({out['verify_s']:.2f} s) and assets/p256_proof.hex, rejects "
        f"byte {len(bad) // 2} flipped ({card})")
    out["evm"], out["evm_source"] = evm_service(say, card, dev, prover, inp, seed, fixture)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["launches"] = dict(_build.launches)
    say(f"service: peak device memory {out['peak_gb']:.1f} GB; launches over step 5 "
        f"{out['launches']} ({card})")
    out["prove_once"] = prove_once
    out["prover"], out["inp"] = prover, inp  # step 6b's sharded proofs
    return out


def evm_service(say, card: str, dev, prover, inp, seed: bytes, fixture: dict):
    """Step 5's EVM half, on the loaded `prover`: a keccak proof under the
    fixture's seed, equal to the JAX package's ``proof_keccak``; the
    generated verifier (``gen_evm_verifier``), compiled and executed by
    ``verify(evm=True)``: it accepts, and rejects a changed instance and a
    byte flipped at each of EVM_FLIPS; then an ``ECDSAProver(multiopen="gwc")``
    on the same artifacts makes a keccak GWC proof, which its own contract
    accepts and the SHPLONK one rejects (equal to ``card_gwc_keccak`` once
    the fixture holds one). Returns the readings and the SHPLONK source."""
    from zkdcap_tpu_torch import _build
    from zkdcap_tpu_torch.evm.calldata import encode_calldata
    from zkdcap_tpu_torch.evm.solc import compile_solidity
    from zkdcap_tpu_torch.runtime import ECDSAProver

    out = {}
    instances = inp.as_instances()
    before = dict(_build.launches)
    out["prove_s"], proof = wall_s(lambda: prover.create_proof(
        inp, evm=True, timing=False, blinding_seed=seed))
    out["proof_launches"] = launched(before)
    require_kernels("the keccak P-256 proof", out["proof_launches"])
    if proof.hex() != fixture["proof_keccak"]:
        raise AssertionError("the keccak k=18 proof differs from the JAX package's "
                             "proof_keccak in testdata/p256_proof.json")
    out["gen_s"], src = wall_s(prover.gen_evm_verifier)
    out["compile_s"], code = wall_s(lambda: compile_solidity(src))
    out["verify_s"], ok = wall_s(lambda: prover.verify(instances, proof, evm=True))
    cached = Path(prover.params_dir) / "evm_verifier_k18_shplonk.bin"
    if not ok or cached.read_bytes() != code:
        raise AssertionError("verify(evm=True) rejects the keccak proof, or its cached "
                             "bytecode is not compile_solidity's")
    rejects = [([instances[0] + 1] + instances[1:], proof)] + [
        (instances, flipped(proof, f)) for f in EVM_FLIPS]
    out["reject_s"] = []
    for inst, bad in rejects:
        t, accepted = wall_s(lambda: prover.verify(inst, bad, evm=True))
        if accepted:
            raise AssertionError("the generated k=18 verifier accepts a tampered proof")
        out["reject_s"].append(t)
    out.update(proof_bytes=len(proof), source_chars=len(src), bytecode_bytes=len(code),
               calldata_bytes=len(encode_calldata(instances, proof)), proof=proof.hex())
    say(f"evm: keccak proof {out['prove_s']:.3f} s ({len(proof)} bytes), equal to the JAX "
        f"package's proof_keccak; gen_evm_verifier {out['gen_s']:.3f} s ({len(src)} chars), "
        f"compile_solidity {out['compile_s']:.3f} s ({len(code)} bytes); verify(evm=True) "
        f"executes the contract on {out['calldata_bytes']} calldata bytes and accepts in "
        f"{out['verify_s']:.2f} s; reverts on a changed instance and on a byte flipped at "
        f"{EVM_FLIPS} of the proof in " + ", ".join(f"{t:.2f}" for t in out["reject_s"])
        + f" s ({card})")

    gwc = ECDSAProver(params_dir=prover.params_dir, k=18, multiopen="gwc", device=dev)
    adopt(gwc, prover)
    before = dict(_build.launches)
    out["gwc_prove_s"], gproof = wall_s(lambda: gwc.create_proof(
        inp, evm=True, timing=False, blinding_seed=seed))
    out["gwc_proof_launches"] = launched(before)
    require_kernels("the keccak GWC P-256 proof", out["gwc_proof_launches"])
    out["gwc_verify_s"], ok = wall_s(lambda: gwc.verify(instances, gproof, evm=True))
    out["gwc_shplonk_verify_s"], crossed = wall_s(
        lambda: prover.verify(instances, gproof, evm=True))
    if not ok or crossed or gwc.verify(instances, proof, evm=True):
        raise AssertionError("the keccak GWC proof must pass the GWC contract only")
    held = "card_gwc_keccak" in fixture
    if held and (fixture["card_gwc_keccak"]["seed"] != fixture["seed"]
                 or fixture["card_gwc_keccak"]["proof"] != gproof.hex()):
        raise AssertionError("the keccak GWC proof differs from testdata/p256_proof.json's "
                             "card_gwc_keccak")
    gcode = (Path(prover.params_dir) / "evm_verifier_k18_gwc.bin").read_bytes()
    out.update(gwc_proof_bytes=len(gproof), gwc_bytecode_bytes=len(gcode),
               gwc={"seed": fixture["seed"], "proof": gproof.hex()})
    say(f"evm gwc: ECDSAProver(multiopen='gwc') on the same artifacts: keccak proof "
        f"{out['gwc_prove_s']:.3f} s ({len(gproof)} bytes), "
        + ("equal to" if held else "not yet in")
        + " testdata/p256_proof.json's card_gwc_keccak; its contract (generated, compiled "
        f"and cached by verify: {len(gcode)} bytes) accepts it in {out['gwc_verify_s']:.2f} s, "
        f"the SHPLONK contract rejects it in {out['gwc_shplonk_verify_s']:.2f} s (and the GWC "
        f"contract the SHPLONK proof); launches {out['gwc_proof_launches']} ({card})")
    return out, src


def dcap_phase(say, card: str, dev, fixture: dict) -> dict:
    """Step 6, this slice's main path: ``DcapProver(k=17)`` on the demo
    input in a fresh params dir, with the launch counts set to 0 first."""
    import torch

    from zkdcap_tpu_torch import _build
    from zkdcap_tpu_torch.circuits.dcap import load_demo_input
    from zkdcap_tpu_torch.plonk import prover as tprover
    from zkdcap_tpu_torch.runtime import DcapProver
    from zkdcap_tpu_torch.witness import native

    params_dir = ROOT / "build" / "smoke_params_dcap"
    shutil.rmtree(params_dir, ignore_errors=True)
    out = {}
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()

    # keygen in the fresh dir: SRS, trace + compile, device keygen, pk save
    prover = DcapProver(params_dir=str(params_dir), k=fixture["k"], device=dev)
    out["keygen_s"], _ = wall_s(prover.keygen)
    out["keygen_phases_s"] = dict(prover.keygen_phases)
    out["pk_bytes"] = Path(prover.pk_path).stat().st_size
    if json.loads(Path(prover.vk_path).read_text()) != fixture["vk"]:
        raise AssertionError("keygen's dcap_vk_k17.json differs from the JAX package's vk "
                             "in testdata/dcap_proof.json")
    pin = json.loads(Path(prover.pinning_path).read_text())
    cs = prover._compiled.cs
    out["layout"] = {"advice": cs.num_advice, "fixed": cs.num_fixed,
                     "permuted": len(cs.permutation_columns), "lookups": len(cs.lookups),
                     "extended_k": cs.extended_k(prover.k), "cells": pin["num_cells"]}
    say(f"dcap keygen k={prover.k}: {out['keygen_s']:.1f} s: "
        + ", ".join(f"{ph} {v:.1f} s" for ph, v in out["keygen_phases_s"].items())
        + f" (deflate level 1, {out['pk_bytes'] / 1e9:.2f} GB); layout {out['layout']}; "
        "dcap_vk_k17.json holds the JAX package's commitments (testdata/dcap_proof.json) "
        f"({card})")
    out["tape_s"], _ = wall_s(prover._get_tape)
    say(f"dcap witness tape recorded and saved in {out['tape_s']:.1f} s ({card})")

    inp, seed = load_demo_input(), fixture["seed"].encode()

    def prove_once() -> bytes:
        return prover.create_proof(inp, timing=False, blinding_seed=seed)

    # one untimed proof first, then one with the default NTT and one on the
    # flat path, all under the fixture's seed
    out["warmup_s"], warm = wall_s(prove_once)
    runs, proofs = {}, [warm]
    for label, var in (("default", None), ("flat", NO_FOUR_STEP)):
        if var:
            os.environ[var] = "1"
        try:
            before, replays = dict(_build.launches), native.replays
            t, proof = wall_s(prove_once)
            proofs.append(proof)
        finally:
            if var:
                del os.environ[var]
        if native.replays != replays + 1:
            raise AssertionError("the native witness evaluator did not run for the DCAP proof")
        run = {"s": t, "runtime_s": dict(prover.last_phases),
               "rounds_s": dict(tprover.last_phases),
               "launches": {k: _build.launches[k] - before[k] for k in before}}
        runs.setdefault(label, []).append(run)
        say(f"dcap proof ({label} NTT): {t:.3f} s; runtime phases "
            + ", ".join(f"{ph} {v:.3f}" for ph, v in prover.last_phases.items())
            + "; create_proof rounds "
            + ", ".join(f"{ph} {v:.3f}" for ph, v in tprover.last_phases.items())
            + f"; launches {run['launches']} ({card})")
    for label, rs in runs.items():
        out[f"prove_s_mean/{label}"] = statistics.fmean(r["s"] for r in rs)
    say(f"dcap: after a warm-up proof of {out['warmup_s']:.3f} s, one proof each: "
        + ", ".join(f"{label} {out[f'prove_s_mean/{label}']:.3f} s" for label in runs)
        + f" ({card})")
    if min(r["launches"]["butterfly"] for r in runs["flat"]) <= 0:
        raise AssertionError(f"{NO_FOUR_STEP}=1: kernel G did not launch in the DCAP proof")
    if len(set(proofs)) != 1:
        raise AssertionError("the DCAP proofs under the default and the flat NTT differ")
    proof = proofs[0]
    if proof.hex() != fixture["proof"]:
        raise AssertionError("the DCAP proof differs from the JAX package's fixture")
    out["runs"] = runs
    out["proof_bytes"] = len(proof)
    out["proof"] = proof.hex()
    out["verify_s"], ok = wall_s(lambda: prover.verify(proof))
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    if not ok or prover.verify(bytes(bad)):
        raise AssertionError("verify: the DCAP proof or the flipped proof")
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["launches"] = dict(_build.launches)
    say(f"dcap: {len(proofs)} proofs identical ({len(proof)} bytes), equal to the JAX "
        f"package's proof in testdata/dcap_proof.json; verify accepts it "
        f"({out['verify_s']:.2f} s) and rejects byte {len(bad) // 2} flipped; peak device "
        f"memory {out['peak_gb']:.1f} GB; launches over step 6 {out['launches']} ({card})")
    out["prove_once"] = prove_once
    out["prover"] = prover
    return out


# The shard counts of step 6b's sharded MSM and NTT, and of its sharded
# P-256 proofs; the shards of the NCCL child's mesh and its sizes (log 2)
SHARDS = (2, 4, 8)
P256_SHARDS = (2, 4)
NCCL_SHARDS, NCCL_LOG = 2, 16
NCCL_CHILD = r"""
import json, sys
sys.path.insert(0, %(root)r)
import torch
from zkdcap_tpu_torch.curves.device_g1 import G1_SPEC, decode_points
from zkdcap_tpu_torch.commit import gen_srs
from zkdcap_tpu_torch.fields import BN254_FR, mont
from zkdcap_tpu_torch.msm import msm_host
from zkdcap_tpu_torch.ntt import ntt
from zkdcap_tpu_torch.parallel import (
    gather_rows, init_distributed, multihost_mesh, sharded_msm, sharded_ntt)
import torch.distributed as dist

assert init_distributed() is True
backend = dist.get_backend()
dev = torch.device("cuda", torch.cuda.current_device())
mesh = multihost_mesh(devices=[dev] * %(shards)d)
n = 1 << %(log)d
srs = gen_srs(%(log)d, cache_dir=%(srs)r, device=dev)
g = torch.Generator().manual_seed(5)
x = torch.randint(0, 1 << 16, (n, 16), generator=g, dtype=torch.int32)
x[:, 15] &= 0x2FFF
x = x.to(dev)
R = sharded_msm(mesh, srs.g1_powers, x)
msm_ok = decode_points(G1_SPEC, tuple(r.reshape(1, -1) for r in R))[0] == msm_host(srs.g1_powers, x)
ntt_ok = torch.equal(gather_rows(mesh, sharded_ntt(mesh, x)), ntt(BN254_FR, x))
dist.destroy_process_group()
print("RESULT " + json.dumps({"backend": backend, "shape": mesh.shape, "msm": msm_ok,
                              "ntt": ntt_ok}), flush=True)
"""


def sharded_phase(say, card: str, dev, pts20, scal_std, msm_point, a22, p256: dict,
                  dcap: dict, fixture: dict, dcap_fixture: dict) -> dict:
    """Step 6b, the sharded prover (``parallel/``) on step 3's engine inputs
    and the provers steps 5 and 6 loaded, with the launch counts set to 0
    first: the 2^20 MSM and the 2^22 NTT over 2, 4 and 8 shards against one
    device; the k = 18 P-256 proof on one device, over 2 and 4 shards and
    with ``ZKDCAP_SHARD_ROWS=0``, and the k = 17 DCAP proof on one device and
    over 2 shards, each equal to its fixture; ``dryrun_multichip(8)``; and a child process in a
    one-process NCCL group on a ``(1, 2)`` mesh. On one card every shard is
    ``cuda:0`` (virtual shards), so the readings show what the sharding
    costs, not what it gains; with more cards the shards take distinct
    ones."""
    import socket

    import torch

    from zkdcap_tpu_torch import _build
    from zkdcap_tpu_torch.curves.device_g1 import G1_SPEC, decode_points
    from zkdcap_tpu_torch.fields import BN254_FR, mont
    from zkdcap_tpu_torch.msm import msm_device
    from zkdcap_tpu_torch.ntt import ntt
    from zkdcap_tpu_torch.parallel import gather_rows, proving_mesh, sharded_msm, sharded_ntt
    from zkdcap_tpu_torch.parallel.dryrun import dryrun_multichip
    from zkdcap_tpu_torch.plonk import prover as tprover
    from zkdcap_tpu_torch.transcript import TranscriptWriter

    cards = torch.cuda.device_count()
    out = {"cards": cards, "virtual": cards == 1}
    say(f"sharded: cards: {cards}; " + ("virtual: every shard is cuda:0, so these readings "
                                        "show what sharding costs, not what it gains"
                                        if cards == 1 else "shards on distinct cards")
        + f" ({card})")
    _build.reset_launches()

    def mesh(n):
        return proving_mesh(n, devices=[torch.device("cuda", i % cards) for i in range(n)])

    def timed3(fn):
        """The median of three wall times after one warm-up, every card synchronised."""
        def run():
            r = fn()
            for i in range(cards):
                torch.cuda.synchronize(i)
            return r
        res = run()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            times.append(time.perf_counter() - t0)
        return statistics.median(times) * 1e3, times, res

    scal_m = mont.to_mont(BN254_FR, scal_std)
    n20 = scal_std.shape[0]
    ms, _, _ = timed3(lambda: msm_device(G1_SPEC, pts20, scal_std, SIZES["lanes"]))
    out["msm_single_ms"] = ms
    out["msm"] = {}
    for n in SHARDS:
        m = mesh(n)
        ms, times, R = timed3(lambda: sharded_msm(m, pts20, scal_m))
        if decode_points(G1_SPEC, tuple(r.reshape(1, -1) for r in R))[0] != msm_point:
            raise AssertionError(f"sharded MSM 2^{SIZES['msm_log']} over {n} shards differs "
                                 "from msm_device and the host oracle")
        out["msm"][n] = {"ms": ms, "runs_ms": [t * 1e3 for t in times], "lanes": len(set(m.devices))}
    say(f"sharded MSM 2^{n20.bit_length() - 1}: equals msm_device and the host oracle over "
        + ", ".join(f"{n} shards {r['ms']:.1f} ms ({r['lanes']} lane"
                    f"{'s' if r['lanes'] > 1 else ''})" for n, r in out["msm"].items())
        + f"; one device {out['msm_single_ms']:.1f} ms (medians of 3) ({card})")
    ms, _, ref = timed3(lambda: ntt(BN254_FR, a22))
    out["ntt_single_ms"] = ms
    out["ntt"] = {}
    for n in SHARDS:
        m = mesh(n)
        ms, times, got = timed3(lambda: gather_rows(m, sharded_ntt(m, a22)))
        if not torch.equal(got, ref):
            raise AssertionError(f"sharded NTT 2^{SIZES['ntt_log']} over {n} shards != ntt")
        out["ntt"][n] = {"ms": ms, "runs_ms": [t * 1e3 for t in times], "lanes": len(set(m.devices))}
    say(f"sharded NTT 2^{SIZES['ntt_log']} (row blocks gathered): equals ntt over "
        + ", ".join(f"{n} shards {r['ms']:.2f} ms ({r['lanes']} lane"
                    f"{'s' if r['lanes'] > 1 else ''})" for n, r in out["ntt"].items())
        + f"; one device {out['ntt_single_ms']:.2f} ms (medians of 3) ({card})")
    del ref, got
    if cards > 1:
        # distinct cards: how far their kernels overlapped (one profiled call each)
        from zkdcap_tpu_torch.tools.concurrency import concurrency

        n = 1 << (min(cards, max(SHARDS)).bit_length() - 1)
        m = mesh(n)
        out["concurrency"] = {}
        for name, fn in ((f"MSM 2^{SIZES['msm_log']}", lambda: sharded_msm(m, pts20, scal_m)),
                         (f"NTT 2^{SIZES['ntt_log']}", lambda: sharded_ntt(m, a22))):
            c = concurrency(fn)
            c.pop("result")
            out["concurrency"][name] = c
            say(f"sharded {name} over {n} cards ({len(set(m.devices))} lanes), profiled: wall "
                f"{c['wall_ms']:.1f} ms, busy " + ", ".join(
                    f"cuda:{d} {b:.1f}" for d, b in c["busy_ms"].items())
                + f" ms, {c['overlap_ms']:.1f} ms of it with two or more cards at once; "
                f"concurrency ratio {c['ratio']:.2f} ({card})")

    def prove(name, prover, inp, fix, n, rows=True):
        pk, advice, instances = prover.prepare(inp)
        kind = prover.transcript_kind
        m = mesh(n) if n > 1 else None
        before = dict(_build.launches)
        for i in range(cards):
            torch.cuda.reset_peak_memory_stats(i)
        if not rows:
            os.environ["ZKDCAP_SHARD_ROWS"] = "0"
        try:
            t, proof = wall_s(lambda: tprover.create_proof(
                prover.params(), pk, advice, instances, TranscriptWriter(kind),
                blinding_seed=fix["seed"].encode(), mesh=m, multiopen=prover.multiopen,
                device=dev))
        finally:
            os.environ.pop("ZKDCAP_SHARD_ROWS", None)
        label = (f"{name} over {n} shards" if n > 1 else f"{name} on one device") + (
            "" if rows else " ZKDCAP_SHARD_ROWS=0")
        if proof.hex() != fix["proof"]:
            raise AssertionError(f"the {label} differs from its fixture")
        run = {"s": t, "rounds_s": dict(tprover.last_phases),
               "launches": {k: _build.launches[k] - before[k] for k in before},
               "peak_gb": max(torch.cuda.max_memory_allocated(i) for i in range(cards)) / 1e9}
        out["proofs"][label] = run
        say(f"sharded {label}: {t:.3f} s, equal to the fixture's bytes; create_proof rounds "
            + ", ".join(f"{ph} {v:.3f}" for ph, v in run["rounds_s"].items())
            + f"; launches {run['launches']}; peak device memory {run['peak_gb']:.1f} GB "
            f"({card})")

    out["proofs"] = {}
    p256_prover, p256_inp = p256.pop("prover"), p256.pop("inp")
    # each circuit's proof on one device first, through the same calls
    for n in (1, *P256_SHARDS):
        prove("P-256 proof k=18", p256_prover, p256_inp, fixture, n)
    prove("P-256 proof k=18", p256_prover, p256_inp, fixture, P256_SHARDS[0], rows=False)
    from zkdcap_tpu_torch.circuits.dcap import load_demo_input
    for n in (1, 2):
        prove("DCAP proof k=17", dcap["prover"], load_demo_input(), dcap_fixture, n)
    del p256_prover

    t0 = time.perf_counter()
    dry = dryrun_multichip(8, devices=[torch.device("cuda", i % cards) for i in range(8)])
    out["dryrun"] = {"s": time.perf_counter() - t0, "checks_s": dry}
    say(f"sharded: dryrun_multichip(8) passed in {out['dryrun']['s']:.1f} s: "
        + ", ".join(f"{k} {v:.2f} s" for k, v in dry.items()) + f" ({card})")

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    srs_dir = ROOT / "build" / "smoke_srs_nccl"
    env = dict(os.environ, ZKDCAP_COORDINATOR=f"127.0.0.1:{port}", ZKDCAP_NUM_PROCESSES="1",
               ZKDCAP_PROCESS_ID="0")
    code = NCCL_CHILD % {"root": str(ROOT), "shards": NCCL_SHARDS, "log": NCCL_LOG,
                         "srs": str(srs_dir)}
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=300)
    out["nccl_s"] = time.perf_counter() - t0
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("RESULT ")]
    if res.returncode or not lines:
        raise AssertionError(f"the NCCL child failed ({res.returncode}): {res.stderr[-3000:]}")
    child = out["nccl"] = json.loads(lines[-1][len("RESULT "):])
    if child["backend"] != "nccl" or not (child["msm"] and child["ntt"]):
        raise AssertionError(f"the NCCL child's checks: {child}")
    say(f"sharded: a child process in a one-process NCCL group ({child['backend']}) on a "
        f"{child['shape']} mesh: MSM and NTT 2^{NCCL_LOG} equal one device's, "
        f"{out['nccl_s']:.1f} s with its start ({card})")
    out["launches"] = dict(_build.launches)
    say(f"sharded: launches over step 6b {out['launches']} ({card})")
    return out


# The prover services of the cert-chain and quote circuits, each on the
# structure input its fixture was made for, and the blinding seed of the
# card's proofs that the fixtures keep (testdata/{name}_vk.json, "card")
CIRCUIT_SERVICES = {"cert_chain": ("CertChainProver", "make_intel_demo_chain",
                                   b"cert-chain-intel-demo"),
                    "quote": ("QuoteProver", "make_demo_quote", b"quote-demo")}
# kernels every proof of the new services must launch
PROOF_KERNELS = ("ntt_pass", "madd_scan", "ec_add_select", "window_join", "mont_mul")
# rounds after which the checkpoint step preempts a DCAP proof
CHECKPOINT_ROUNDS = ("r1", "r3", "r6")


def launched(before: dict) -> dict:
    from zkdcap_tpu_torch import _build

    return {k: _build.launches[k] - before[k] for k in before}


def require_kernels(what: str, launches: dict) -> None:
    missing = [k for k in PROOF_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{what}: kernels {missing} did not launch")


def circuit_service_phase(say, card: str, dev, name: str, fixture: dict, srs_dir: Path) -> dict:
    """Steps 11-12: the cert-chain or quote prover service on the structure
    input of its fixture, in a fresh params dir that holds a copy of the
    DCAP step's k = 17 SRS, with the launch counts set to 0 first: keygen
    (its vk must be the JAX keygen's of the fixture), the tape, a warm-up
    proof and a timed one under one seed (identical; equal to the fixture's
    card proof once it holds one), verify (and a flipped byte). The prover is
    freed before the step returns."""
    import torch

    from zkdcap_tpu_torch import _build, runtime
    from zkdcap_tpu_torch.plonk import prover as tprover
    from zkdcap_tpu_torch.witness import native

    cls_name, make, seed = CIRCUIT_SERVICES[name]
    structure = getattr(importlib.import_module(f"zkdcap_tpu_torch.circuits.{name}"), make)()
    k = fixture["k"]
    params_dir = ROOT / "build" / f"smoke_params_{name}"
    shutil.rmtree(params_dir, ignore_errors=True)
    params_dir.mkdir(parents=True)
    srs_file = f"kzg_bn254_{k}.srs.npz"
    shutil.copy(srs_dir / srs_file, params_dir / srs_file)
    out = {"structure": make, "seed": seed.decode()}
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()

    prover = getattr(runtime, cls_name)(params_dir=str(params_dir), k=k, structure=structure,
                                        device=dev)
    if prover.lookup_bits != fixture["lookup_bits"]:
        raise AssertionError(f"{name}: lookup bits {prover.lookup_bits}, fixture's "
                             f"{fixture['lookup_bits']}")
    before = dict(_build.launches)
    out["keygen_s"], _ = wall_s(prover.keygen)
    out["keygen_phases_s"] = dict(prover.keygen_phases)
    out["keygen_launches"] = launched(before)
    out["pk_bytes"] = Path(prover.pk_path).stat().st_size
    if json.loads(Path(prover.vk_path).read_text()) != fixture["vk"]:
        raise AssertionError(f"keygen's {Path(prover.vk_path).name} differs from the JAX "
                             f"keygen's vk in testdata/{name}_vk.json")
    pin = json.loads(Path(prover.pinning_path).read_text())
    cs = prover._compiled.cs
    out["layout"] = {"advice": cs.num_advice, "fixed": cs.num_fixed,
                     "permuted": len(cs.permutation_columns), "lookups": len(cs.lookups),
                     "extended_k": cs.extended_k(k), "cells": pin["num_cells"]}
    say(f"{name} keygen k={k} ({make}()): {out['keygen_s']:.1f} s: "
        + ", ".join(f"{ph} {v:.1f} s" for ph, v in out["keygen_phases_s"].items())
        + f" ({out['pk_bytes'] / 1e9:.2f} GB); layout {out['layout']}; its vk holds the JAX "
        f"keygen's commitments (testdata/{name}_vk.json) ({card})")
    out["tape_s"], _ = wall_s(prover._get_tape)
    say(f"{name} witness tape recorded and saved in {out['tape_s']:.1f} s ({card})")

    def prove_once() -> bytes:
        return prover.create_proof(structure, timing=False, blinding_seed=seed)

    runs, proofs = [], []
    for label in ("warm-up", "timed"):
        before, replays = dict(_build.launches), native.replays
        t, proof = wall_s(prove_once)
        proofs.append(proof)
        if native.replays != replays + 1:
            raise AssertionError(f"{name}: the native witness evaluator did not run")
        run = {"label": label, "s": t, "runtime_s": dict(prover.last_phases),
               "rounds_s": dict(tprover.last_phases), "launches": launched(before)}
        require_kernels(f"{name} proof ({label})", run["launches"])
        runs.append(run)
        say(f"{name} proof ({label}): {t:.3f} s; runtime phases "
            + ", ".join(f"{ph} {v:.3f}" for ph, v in prover.last_phases.items())
            + "; create_proof rounds "
            + ", ".join(f"{ph} {v:.3f}" for ph, v in tprover.last_phases.items())
            + f"; launches {run['launches']} ({card})")
    if len(set(proofs)) != 1:
        raise AssertionError(f"{name}: two proofs under one seed differ")
    proof = proofs[0]
    out.update(runs=runs, prove_s=runs[-1]["s"], proof_bytes=len(proof), proof=proof.hex())
    held = "card" in fixture
    if held and (fixture["card"]["seed"] != seed.decode() or fixture["card"]["proof"] != proof.hex()):
        raise AssertionError(f"{name}: the proof differs from the card proof in "
                             f"testdata/{name}_vk.json")
    out["verify_s"], ok = wall_s(lambda: prover.verify(proof))
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    if not ok or prover.verify(bytes(bad)):
        raise AssertionError(f"{name}: verify of the proof or of the flipped proof")
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    say(f"{name}: 2 proofs identical ({len(proof)} bytes), "
        + ("equal to the card proof in" if held else "no card proof yet in")
        + f" testdata/{name}_vk.json; verify accepts it ({out['verify_s']:.2f} s) and rejects "
        f"byte {len(bad) // 2} flipped; peak device memory {out['peak_gb']:.1f} GB ({card})")
    out["launches"] = dict(_build.launches)
    del prover
    torch.cuda.empty_cache()
    return out


def adopt(prover, loaded) -> None:
    """Give `prover` the artifacts `loaded` already holds (pk, compile,
    structure trace, tape, SRS): the same circuit, not read again."""
    for attr in ("_pk", "_builder", "_compiled", "_structure_ctx", "_tape", "_params"):
        setattr(prover, attr, getattr(loaded, attr))


def gwc_phase(say, card: str, dev, fixture: dict, shplonk_proof: bytes, loaded) -> dict:
    """Step 7: ``DcapProver(multiopen="gwc")`` on the DCAP step's params
    dir and the artifacts that `loaded` (step 6's prover) holds, with the
    launch counts set to 0 first: one proof of the demo input under the
    fixture's seed, accepted under GWC and rejected under SHPLONK, longer
    than the SHPLONK proof (and equal to the fixture's card GWC proof once
    it holds one)."""
    import torch

    from zkdcap_tpu_torch import _build
    from zkdcap_tpu_torch.circuits.dcap import load_demo_input
    from zkdcap_tpu_torch.runtime import DcapProver

    params_dir = ROOT / "build" / "smoke_params_dcap"
    out = {}
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    prover = DcapProver(params_dir=str(params_dir), k=fixture["k"], multiopen="gwc", device=dev)
    adopt(prover, loaded)
    seed = fixture["seed"].encode()
    before = dict(_build.launches)
    out["prove_s"], proof = wall_s(lambda: prover.create_proof(
        load_demo_input(), timing=False, blinding_seed=seed))
    out["rounds_s"] = dict(prover.last_phases)
    out["proof_launches"] = launched(before)
    require_kernels("the GWC DCAP proof", out["proof_launches"])
    out["verify_s"], ok = wall_s(lambda: prover.verify(proof))
    if not ok or loaded.verify(proof) or prover.verify(shplonk_proof):
        raise AssertionError("the GWC DCAP proof must verify under GWC only")
    if len(proof) <= len(shplonk_proof):
        raise AssertionError("the GWC DCAP proof is not longer than the SHPLONK one")
    held = "card_gwc" in fixture
    if held and (fixture["card_gwc"]["seed"] != fixture["seed"]
                 or fixture["card_gwc"]["proof"] != proof.hex()):
        raise AssertionError("the GWC DCAP proof differs from testdata/dcap_proof.json's card_gwc")
    out.update(proof_bytes=len(proof), proof=proof.hex(), seed=fixture["seed"],
               peak_gb=torch.cuda.max_memory_allocated() / 1e9, launches=dict(_build.launches))
    say(f"gwc: DcapProver(multiopen='gwc') on step 6's artifacts: proof "
        f"{out['prove_s']:.3f} s ({len(proof)} bytes against SHPLONK's {len(shplonk_proof)}), "
        + ("equal to" if held else "not yet in")
        + f" testdata/dcap_proof.json's card_gwc; verify accepts it under GWC "
        f"({out['verify_s']:.2f} s) and the SHPLONK verifier rejects it (and GWC the SHPLONK "
        f"proof); launches {out['proof_launches']} ({card})")
    return out


def checkpoint_phase(say, card: str, dev, fixture: dict, loaded) -> dict:
    """Step 8: the DCAP circuit under the fixture's seed with
    ``create_proof(checkpoint=True)`` in a fresh params dir (the prover
    takes the artifacts that `loaded`, step 6's prover, holds), with
    the launch counts set to 0 first: preempted after each round of
    CHECKPOINT_ROUNDS through the prover's test hook, then resumed; each
    resumed proof must equal the fixture's bytes and leave no ck_*.npz.
    Each round's save is timed and its file measured."""
    import torch

    from zkdcap_tpu_torch import _build
    from zkdcap_tpu_torch.circuits.dcap import load_demo_input
    from zkdcap_tpu_torch.plonk import checkpoint
    from zkdcap_tpu_torch.runtime import DcapProver, circuit_prover

    params_dir = ROOT / "build" / "smoke_checkpoint"
    shutil.rmtree(params_dir, ignore_errors=True)
    params_dir.mkdir(parents=True)
    out = {"saves": {}, "runs": {}}
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    prover = DcapProver(params_dir=str(params_dir), k=fixture["k"], device=dev)
    adopt(prover, loaded)
    inp, seed = load_demo_input(), fixture["seed"].encode()
    create = circuit_prover.create_proof
    save = checkpoint.ProofCheckpoint.save

    def timed_save(self, name, *args, **kw):
        t, _ = wall_s(lambda: save(self, name, *args, **kw))
        out["saves"].setdefault(name, []).append(
            {"s": t, "bytes": os.path.getsize(self._path(name))})

    checkpoint.ProofCheckpoint.save = timed_save
    try:
        for rnd in CHECKPOINT_ROUNDS:
            circuit_prover.create_proof = lambda *a, **kw: create(*a, _abort_after=rnd, **kw)
            t0 = time.perf_counter()
            try:
                prover.create_proof(inp, timing=False, checkpoint=True, blinding_seed=seed)
            except checkpoint.Preempted:
                t_abort = time.perf_counter() - t0
            else:
                raise AssertionError(f"the proof was not preempted after {rnd}")
            finally:
                circuit_prover.create_proof = create
            left = sorted(f.name for f in params_dir.glob("ck_*.npz"))
            want = [f"ck_blake2b_r{i}.npz" for i in range(1, int(rnd[1]) + 1)]
            if left != want:
                raise AssertionError(f"after {rnd}: checkpoint files {left}, wanted {want}")
            before = dict(_build.launches)
            t_resume, proof = wall_s(lambda: prover.create_proof(
                inp, timing=False, checkpoint=True, blinding_seed=seed))
            if proof.hex() != fixture["proof"]:
                raise AssertionError(f"the proof resumed after {rnd} differs from "
                                     "testdata/dcap_proof.json")
            if list(params_dir.glob("ck_*.npz")):
                raise AssertionError(f"checkpoint files left after the proof resumed at {rnd}")
            out["runs"][rnd] = {"preempted_s": t_abort, "resume_s": t_resume,
                                "launches": launched(before),
                                "rounds_s": dict(prover.last_phases)}
            say(f"checkpoint: preempted after {rnd} in {t_abort:.3f} s ({', '.join(left)}), "
                f"resumed in {t_resume:.3f} s to the bytes of testdata/dcap_proof.json, no "
                f"ck_*.npz left ({card})")
    finally:
        checkpoint.ProofCheckpoint.save = save
        circuit_prover.create_proof = create
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["launches"] = dict(_build.launches)
    say("checkpoint saves (seconds, MB): " + "; ".join(
        f"{name} " + ", ".join(f"{r['s']:.2f} s {r['bytes'] / 1e6:.0f} MB" for r in rs)
        for name, rs in sorted(out["saves"].items())) + f"; peak device memory "
        f"{out['peak_gb']:.1f} GB ({card})")
    return out


def run_cli(argv: list[str]) -> tuple[int, str]:
    """``zkdcap_tpu_torch.cli.main(argv)`` in this process: its exit code (0
    when it returns) and what it printed."""
    import contextlib
    import io

    from zkdcap_tpu_torch import cli

    buf = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(buf):
        try:
            cli.main(argv)
        except SystemExit as e:
            code = e.code
    return code, buf.getvalue()


def cli_subprocess(argv: list[str]) -> tuple[float, int, str]:
    """``python -m zkdcap_tpu_torch.cli`` as a process of its own, from the
    checkout's root: its seconds, exit code and standard output."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "zkdcap_tpu_torch.cli", *argv], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    if proc.returncode not in (0, 1):
        raise AssertionError(f"cli {argv[2:4]} failed ({proc.returncode}): {proc.stderr[-2000:]}")
    return time.perf_counter() - t0, proc.returncode, proc.stdout


def cli_phase(say, card: str, fixture: dict, evm_source: str, dcap_proof: str) -> dict:
    """Step 10: the prover CLI on the params dirs of steps 5 and 6, with the
    launch counts set to 0 first. In this process, so that the counts see
    it: ``prove --evm`` (a pk reload and a keccak proof on the card, A-E
    launched), ``gen-solidity --output`` (equal to step 5's source) and
    ``verify --evm`` of a flipped proof (exit 1, ``INVALID``). As processes
    of their own: ``verify --evm`` of the CLI's proof (exit 0, ``valid``),
    ``gen-calldata`` (equal to ``encode_calldata`` of it) and
    ``dcap-verify`` of step 6's proof (exit 0)."""
    from zkdcap_tpu_torch import _build
    from zkdcap_tpu_torch.circuits.p256_ecdsa import ECDSAInput
    from zkdcap_tpu_torch.evm.calldata import encode_calldata

    work = ROOT / "build" / "smoke_cli"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    p256 = ["--params-dir", str(ROOT / "build" / "smoke_params")]
    ecdsa = ["--msghash", "0x" + fixture["msghash"], "--signature", "0x" + fixture["signature"],
             "--pubkey", "0x" + fixture["pubkey"]]
    instances = ECDSAInput.from_hex(fixture["msghash"], fixture["signature"],
                                    fixture["pubkey"]).as_instances()
    out = {"s": {}}
    _build.reset_launches()

    proof_file = work / "proof.hex"
    out["s"]["prove --evm"], (code, text) = wall_s(
        lambda: run_cli([*p256, "prove", "--evm", *ecdsa, "--output", str(proof_file)]))
    proof = bytes.fromhex(proof_file.read_text().removeprefix("0x"))
    if code != 0 or text.strip() != f"proof written to {proof_file} ({len(proof)} bytes)":
        raise AssertionError(f"cli prove --evm: exit {code}, printed {text!r}")
    out["prove_launches"] = dict(_build.launches)
    require_kernels("cli prove --evm", out["prove_launches"])

    sol_file = work / "Verifier.sol"
    out["s"]["gen-solidity"], (code, text) = wall_s(
        lambda: run_cli([*p256, "gen-solidity", "--output", str(sol_file)]))
    if code != 0 or text.strip() != f"verifier written to {sol_file}" \
            or sol_file.read_text() != evm_source:
        raise AssertionError("cli gen-solidity: not step 5's source")

    bad_file = work / "flipped.hex"
    bad_file.write_text("0x" + flipped(proof, EVM_FLIPS[1]).hex())
    out["s"]["verify --evm (flipped)"], (code, text) = wall_s(
        lambda: run_cli([*p256, "verify", "--evm", "--proof", str(bad_file), *ecdsa]))
    if code != 1 or text.strip() != "INVALID":
        raise AssertionError(f"cli verify --evm of a flipped proof: exit {code}, {text!r}")
    out["launches"] = dict(_build.launches)

    t, code, text = cli_subprocess([*p256, "verify", "--evm", "--proof", str(proof_file),
                                    *ecdsa])
    out["s"]["verify --evm (process)"] = t
    if code != 0 or text.strip() != "valid":
        raise AssertionError(f"cli verify --evm of its own proof: exit {code}, {text!r}")
    t, code, text = cli_subprocess([*p256, "gen-calldata", "--proof", str(proof_file), *ecdsa])
    out["s"]["gen-calldata (process)"] = t
    if code != 0 or text.strip() != "0x" + encode_calldata(instances, proof).hex():
        raise AssertionError("cli gen-calldata: not encode_calldata of the proof")
    dcap_file = work / "dcap_proof.hex"
    dcap_file.write_text("0x" + dcap_proof)
    t, code, text = cli_subprocess(["--params-dir", str(ROOT / "build" / "smoke_params_dcap"),
                                    "dcap-verify", "--proof", str(dcap_file)])
    out["s"]["dcap-verify (process)"] = t
    if code != 0 or text.strip() != "valid":
        raise AssertionError(f"cli dcap-verify of step 6's proof: exit {code}, {text!r}")
    out["proof_bytes"] = len(proof)
    say("cli: " + "; ".join(f"{c} {t:.1f} s" for c, t in out["s"].items())
        + f": prove --evm reloaded the pk and proved on the card ({len(proof)} bytes, "
        f"launches {out['prove_launches']}), its proof passes verify --evm in a process of its "
        "own, gen-calldata prints encode_calldata of it, gen-solidity writes step 5's source, "
        "a flipped byte exits 1 with INVALID, dcap-verify accepts step 6's proof "
        f"({card})")
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        return fail("torch is not installed")
    if not torch.cuda.is_available():
        return fail("no CUDA device")
    if not (ROOT / "zkdcap_tpu_torch" / "csrc").is_dir():
        return fail(f"{ROOT} is not a checkout of the repo (no zkdcap_tpu_torch/)")
    sys.path.insert(0, str(ROOT))

    import numpy as np

    from zkdcap_tpu_torch import _build
    from zkdcap_tpu_torch.commit import ParamsKZG, gen_srs
    from zkdcap_tpu_torch.commit.srs import _dev_tau
    from zkdcap_tpu_torch.curves import BN254_G1
    from zkdcap_tpu_torch.curves import ec_kernels as ek
    from zkdcap_tpu_torch.curves.device_g1 import (
        G1_SPEC, affine_to_projective, decode_points)
    from zkdcap_tpu_torch.fields import BN254_FQ, BN254_FR, mont, mul_kernels
    from zkdcap_tpu_torch.fields.butterfly_kernels import butterfly, butterfly_plain
    from zkdcap_tpu_torch.msm import msm_device
    from zkdcap_tpu_torch.ntt import Domain, intt, ntt
    ntt_module = importlib.import_module("zkdcap_tpu_torch.ntt.ntt")
    from zkdcap_tpu_torch.ntt.ntt import _flat_twiddles

    dev = torch.device("cuda")
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    kind = torch.cuda.get_device_name(0)
    report = {"device": kind, "sizes": SIZES}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi unavailable"
    report["card"] = card
    r_ord = BN254_FR.p
    gen = np.random.default_rng(2024)

    def say(msg: str) -> None:
        print(msg, flush=True)

    step_start = {}  # the seconds from the start of the script at which each step started

    def mark(step: str) -> None:
        step_start[step] = time.perf_counter() - T_START

    # -- 1. build ----------------------------------------------------------
    mark("1 build")
    t0 = time.perf_counter()
    _build.lib()
    report["build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _build.witness_lib()
    report["witness_build_s"] = time.perf_counter() - t0
    say(f"build: kernels {report['build_s']:.1f} s, witness evaluator (g++) "
        f"{report['witness_build_s']:.1f} s ({card})")
    ptxas = report["ptxas"] = _build.ptxas_report(_build.build_log)

    def kernel_ptxas(kname: str) -> dict:
        return {f: r for f, r in ptxas.items() if any(k in f for k in kernel_functions(kname))}

    for kname in KERNELS:
        say(f"ptxas {kname}: " + "; ".join(
            f"{f[:60]}: {r.get('registers')} registers, {r.get('stack')} B stack, "
            f"{r.get('spill_stores')} B spill stores, {r.get('spill_loads')} B spill loads"
            for f, r in kernel_ptxas(kname).items()))
    report["sass"] = sass_counts(_build._nvcc())
    say("sass per field operation (probe less load/store): " + (
        "; ".join(f"{op}: {r['instructions']} instructions, {r['imad']} IMAD-class "
                  f"{r['by_opcode']}" for op, r in report["sass"].items() if op != "available")
        if report["sass"]["available"] else "cuobjdump not in the toolkit: not measured"))

    def rand_fr(shape) -> torch.Tensor:
        """Canonical Fr limbs (top limb < 0x3000 keeps the value below p)."""
        x = torch.randint(0, 1 << 16, (*shape, 16), dtype=torch.int32, device=dev)
        x[..., 15] &= 0x2FFF
        return x

    pool = point_pool(dev)
    torch.manual_seed(7)

    # -- 2. each kernel against its plain version ----------------------------
    mark("2 kernels")
    kernels = {}

    def record(name, source, replaces, got, ref, ms, kernel_ms, plain_ms, n_mont, n_bytes, shape,
               library_ms=None, n_ops=None):
        err, bad = max_abs_err(got, ref)
        b_ms, b_by = bound(n_mont, n_bytes) if n_ops is None else int_bound(n_ops, n_bytes)
        kernels[name] = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "also_replaces": ALSO_REPLACES.get(name.split("/")[0], []),
            "launches": 0, "max_abs_err": err, "mismatches": bad, "ms": ms,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms, "shape": shape, "ptxas": kernel_ptxas(name.split("/")[0])}
        lib = "" if library_ms is None else f", library {library_ms:.4f} ms"
        say(f"check {name} {shape}: mismatches {bad}, {ms:.4f} ms (events; the kernel's own "
            f"{kernel_ms:.4f} ms), plain {plain_ms:.1f} ms{lib}, bound {b_ms:.4f} ms ({b_by}) "
            f"({card})")
        if bad or err:
            raise AssertionError(f"kernel {name} disagrees with its plain version at {shape}")

    # A: NTT passes 2^9, 2^10, 2^11 over 2^18, 2^20, 2^22 elements, the
    # proofs' passes and the four-step layouts (A_ROWS)
    def kernel_row(name, source, replaces, r):
        record(name, source, replaces, r["got"], r["ref"], r["ms"], r["kernel_ms"],
               r["plain_ms"], r["n_mont"], r["n_bytes"], r["shape"])

    for name in A_ROWS:
        kernel_row(name, "zkdcap_tpu_torch/csrc/ntt_pass.cu",
                   "zkdcap_tpu/fields/pallas_mont.py:257", pass_row(name, dev))
        torch.cuda.empty_cache()

    # B: the 2^20 MSM's scan and the proofs' (B_ROWS); C: the 2^20 MSM's
    # Hillis-Steele level and the proofs' level and suffix scans (C_ROWS)
    for name in B_ROWS:
        kernel_row(name, "zkdcap_tpu_torch/csrc/madd_scan.cu", "zkdcap_tpu/curves/ec_kernels.py:"
                   + ("149" if name == "madd_scan/M=1" else "459"), scan_row(name, pool))
        torch.cuda.empty_cache()
    for name in C_ROWS:
        kernel_row(name, "zkdcap_tpu_torch/csrc/ec_add_select.cu",
                   "zkdcap_tpu/curves/ec_kernels.py:102", add_row(name, pool))

    # D: the proofs' join (20 windows of 13 bits) and the 2^20 MSM's (16 of
    # 16); a dependent chain, so its time per step is printed too
    for name, (W, c) in JOIN_SHAPES.items():
        T = affine_to_projective(G1_SPEC, pool[:W])
        got = ek.ec_window_join(G1_SPEC, T, c)
        ms, k_ms = timed(lambda: ek.ec_window_join(G1_SPEC, T, c), "window_join", 10)
        plain_s, ref = wall_s(lambda: ek.ec_window_join_plain(G1_SPEC, T, c))
        steps = c * (W - 1) + W - 1
        record(name, "zkdcap_tpu_torch/csrc/window_join.cu", "zkdcap_tpu/curves/ec_kernels.py:275",
               got, ref, ms, k_ms, plain_s * 1e3, (W - 1) * (c * DBL_MULS + ADD_MULS),
               (W + 1) * POINT_BYTES, f"W={W} windows, c={c}")
        kernels[name]["us_per_step"] = 1e3 * ms / steps
        say(f"check {name}: {1e3 * ms / steps:.3f} us per chain step ({steps} dependent steps: "
            f"{c * (W - 1)} doublings, {W - 1} additions) beside the operation bound "
            f"{kernels[name]['bound_ms']:.5f} ms, which a dependent chain does not reach ({card})")
        del got, ref, T

    # E: 2^20 elementwise products (one extended-coset column of the k = 18
    # quotient), Fr and Fq, b in full and b as one broadcast row
    n_mul = 1 << SIZES["mul_log"]
    for fname, fp in (("fr", BN254_FR), ("fq", BN254_FQ)):
        a, b = rand_fr((n_mul,)), rand_fr((n_mul,))  # < 0x3000 * 2^240 < both moduli
        for mode, bb in (("full", b), ("broadcast", b[:1])):
            got = mul_kernels.mont_mul(fp, a, bb)
            # timed by launching the kernel itself into one output: the
            # wrapper's host work per call is as long as a launch of this size
            out = torch.empty_like(a)
            args = (a.data_ptr(), bb.data_ptr(), out.data_ptr(), n_mul, bb.shape[0], 1,
                    mul_kernels._FIELD_CODE[fp])
            ms, k_ms = timed(lambda: _build.launch("mont_mul", *args, device=a.device),
                             "mont_mul", 50)
            plain_s, ref = wall_s(lambda: mul_kernels.mont_mul_plain(fp, a, bb))
            # a and out once each, b once per element or one row
            n_bytes = LIMB_BYTES * (2 * n_mul + bb.shape[0])
            record("mont_mul" if (fname, mode) == ("fr", "full") else f"mont_mul/{fname}/{mode}",
                   "zkdcap_tpu_torch/csrc/mont_mul.cu", "zkdcap_tpu/fields/pallas_mont.py:153",
                   (got, out), (ref, ref), ms, k_ms, plain_s * 1e3, n_mul, n_bytes,
                   f"{fname.capitalize()}, n=2^{SIZES['mul_log']}, b {mode}")
            del got, out, ref
    del a, b

    # F: the MSM's sorts at the main path's shapes
    sort_checks(record, dev)

    # G: the top stage (m = n/2, twiddle stride 1) of the flat transforms
    for name, (rows, log_n) in BUTTERFLY_SHAPES.items():
        s = log_n - 1
        x = rand_fr((rows, 1 << log_n))
        tw = _flat_twiddles(log_n, False, dev)
        got = butterfly(x, tw, s)
        out = torch.empty_like(x)
        ms, k_ms = timed(lambda: butterfly(x, tw, s, out=out), "butterfly", 10)
        plain_s, ref = wall_s(lambda: butterfly_plain(x, tw, s))
        # a butterfly reads lo and hi and writes two rows; the m distinct
        # twiddles are read once each; butterfly 0's product is by w^0 = 1
        n_bf = rows << s
        record(name, "zkdcap_tpu_torch/csrc/butterfly.cu", "zkdcap_tpu/fields/pallas_mont.py:36",
               (got,), (ref,), ms, k_ms, plain_s * 1e3, rows * ((1 << s) - 1),
               LIMB_BYTES * (4 * n_bf + (1 << s)), f"stage {s} of 2^{log_n} x {rows} rows")
        del x, got, out, ref
    torch.cuda.empty_cache()

    # -- 3. the main path at k = 18 -------------------------------------------
    mark("3 engine")
    tau = _dev_tau()
    k = SIZES["k"]
    n18 = 1 << k
    tau_pows = [1] * n18
    for i in range(1, n18):
        tau_pows[i] = tau_pows[i - 1] * tau % r_ord

    def horner(coeffs, x):
        acc = 0
        for cf in reversed(coeffs):
            acc = (acc * x + cf) % r_ord
        return acc

    def commit_oracle(coeffs):
        return BN254_G1.mul(sum(a * b for a, b in zip(coeffs, tau_pows)) % r_ord, BN254_G1.g)

    phases = {}
    _build.reset_launches()

    def phase(name, fn, runs=3):
        before = dict(_build.launches)
        times, out = [], None
        for _ in range(runs):
            t, out = wall_s(fn)
            times.append(t)
        phases[name] = {"median_s": statistics.median(times), "runs_s": times,
                        "launches": {k: _build.launches[k] - before[k] for k in before}}
        say(f"phase {name}: median {phases[name]['median_s']:.3f} s over {runs} runs "
            f"{times} launches {phases[name]['launches']} ({card})")
        return out

    srs_dir = ROOT / "build" / "smoke_srs"

    def fresh_srs():
        shutil.rmtree(srs_dir, ignore_errors=True)
        return gen_srs(k, cache_dir=str(srs_dir), device=dev)

    srs = phase(f"gen_srs({k})", fresh_srs, runs=1)
    check = [0, 1, 2, n18 // 3, n18 - 1] + [int(i) for i in gen.integers(0, n18, 3)]
    idx_t = torch.tensor(check, device=dev)
    got_pts = decode_points(G1_SPEC, affine_to_projective(G1_SPEC, srs.g1_powers[idx_t]))
    for i, pt in zip(check, got_pts):
        if pt != BN254_G1.mul(tau_pows[i], BN254_G1.g):
            raise AssertionError(f"g1_powers[{i}] != [tau^{i}]G")
    say(f"gen_srs({k}): g1_powers[i] == [tau^i]G at i = {check}")
    params = ParamsKZG(srs=srs)

    def rand_coeffs(count):
        vals = [int.from_bytes(gen.bytes(32), "little") % r_ord for _ in range(count)]
        return vals, mont.encode_ints(BN254_FR, vals, device=dev)

    c0, c0_t = rand_coeffs(n18)
    evals = ntt(BN254_FR, c0_t)
    commit_pt = phase(f"commit_lagrange 2^{k}", lambda: params.commit_lagrange(evals))
    if commit_pt != commit_oracle(c0):
        raise AssertionError("commit_lagrange != [f(tau)]G")
    polys = [rand_coeffs(n18) for _ in range(4)]
    got = phase(f"commit_many 4 x 2^{k}", lambda: params.commit_many([p[1] for p in polys]))
    if got != [commit_oracle(p[0]) for p in polys]:
        raise AssertionError("commit_many != [f_j(tau)]G")
    say("commitments: commit_lagrange and commit_many equal [f(tau)]G by host Horner sums")

    dom = Domain(BN254_FR, k, SIZES["ext_k"])
    back = phase(f"Domain({k},{SIZES['ext_k']}) coeff->extended->coeff",
                 lambda: dom.extended_to_coeff(dom.coeff_to_extended(c0_t)))
    if not (torch.equal(back[:n18], c0_t) and not back[n18:].any()):
        raise AssertionError("Domain round trip")
    say(f"Domain({k}, {SIZES['ext_k']}): extended_to_coeff(coeff_to_extended(a)) == a, zero-padded")

    n20 = 1 << SIZES["msm_log"]
    pts20 = srs.g1_powers.repeat(n20 // n18, 1, 1)
    sbytes = np.frombuffer(gen.bytes(32 * n20), dtype=np.uint8).reshape(n20, 32).copy()
    sbytes[:, 31] &= 0x1F  # scalars < 2^253 < r
    raw = sbytes.tobytes()
    scal_ints = [int.from_bytes(raw[32 * i : 32 * i + 32], "little") for i in range(n20)]
    scal = torch.from_numpy(sbytes.view(np.uint16).astype(np.int32)).to(dev)
    R = phase(f"msm_device 2^{SIZES['msm_log']}, lanes {SIZES['lanes']}",
              lambda: msm_device(G1_SPEC, pts20, scal, SIZES["lanes"]))
    got = msm20_point = decode_points(G1_SPEC, tuple(r[None] for r in R))[0]
    expect = BN254_G1.mul(sum(s * tau_pows[i % n18] for i, s in enumerate(scal_ints)) % r_ord,
                          BN254_G1.g)
    if got != expect:
        raise AssertionError("msm_device != [sum s_i tau^(i mod 2^k)]G")
    say(f"msm_device 2^{SIZES['msm_log']}: equals [sum_i s_i tau^(i mod 2^{k})]G")

    # the JAX package's sort switches: the same points through kernel F
    for var in SWITCHES.values():
        os.environ[var] = "1"
        try:
            R_sw = phase(f"msm_device 2^{SIZES['msm_log']} {var}=1",
                         lambda: msm_device(G1_SPEC, pts20, scal, SIZES["lanes"]), runs=2)
            c_sw = phase(f"commit_lagrange 2^{k} {var}=1", lambda: params.commit_lagrange(evals),
                         runs=2)
        finally:
            del os.environ[var]
        if decode_points(G1_SPEC, tuple(r[None] for r in R_sw))[0] != got or c_sw != commit_pt:
            raise AssertionError(f"{var}=1 changes the MSM's or the commitment's point")
        launched = [phases[name]["launches"]["bitonic_sort"] for name in list(phases)[-2:]]
        if min(launched) <= 0:
            raise AssertionError(f"{var}=1: kernel F did not launch")
        say(f"{var}=1: msm_device 2^{SIZES['msm_log']} and commit_lagrange 2^{k} equal the "
            f"default path's points; kernel F launches {launched}")

    n22 = 1 << SIZES["ntt_log"]
    a22 = rand_fr((n22,))
    ev = phase(f"ntt 2^{SIZES['ntt_log']}", lambda: ntt(BN254_FR, a22))
    back = phase(f"intt 2^{SIZES['ntt_log']}", lambda: intt(BN254_FR, ev))
    if not torch.equal(back, a22):
        raise AssertionError("intt(ntt(a)) != a")
    coeffs = mont.decode_ints(BN254_FR, a22)
    w = BN254_FR.nth_root_of_unity(SIZES["ntt_log"])
    for j in (1, int(gen.integers(2, n22))):
        want = horner(coeffs, pow(w, j, r_ord))
        if mont.decode_ints(BN254_FR, ev[j : j + 1])[0] != want:
            raise AssertionError(f"ntt at w^{j}")
    say(f"ntt 2^{SIZES['ntt_log']}: intt round trip exact; f(w^j) equals host Horner at two j")
    # the DCAP proof's extended size: four-step passes of 2^9 and 2^10
    n19 = 1 << SIZES["ntt_ext_log"]
    a19 = rand_fr((n19,))
    ev19 = phase(f"ntt 2^{SIZES['ntt_ext_log']}", lambda: ntt(BN254_FR, a19))
    if not torch.equal(phase(f"intt 2^{SIZES['ntt_ext_log']}", lambda: intt(BN254_FR, ev19)), a19):
        raise AssertionError(f"intt(ntt(a)) != a at 2^{SIZES['ntt_ext_log']}")
    j = int(gen.integers(2, n19))
    w19 = pow(BN254_FR.nth_root_of_unity(SIZES["ntt_ext_log"]), j, r_ord)
    if mont.decode_ints(BN254_FR, ev19[j : j + 1])[0] != horner(mont.decode_ints(BN254_FR, a19),
                                                                   w19):
        raise AssertionError(f"ntt 2^{SIZES['ntt_ext_log']} at w^{j}")
    say(f"ntt 2^{SIZES['ntt_ext_log']}: intt round trip exact; f(w^{j}) equals host Horner")
    del a19, ev19

    # the flat path: kernel A's chunk pass and kernel G's stages
    os.environ[NO_FOUR_STEP] = "1"
    try:
        ev_flat = phase(f"ntt 2^{SIZES['ntt_log']} {NO_FOUR_STEP}=1", lambda: ntt(BN254_FR, a22))
    finally:
        del os.environ[NO_FOUR_STEP]
    if not torch.equal(ev_flat, ev):
        raise AssertionError(f"{NO_FOUR_STEP}=1: the flat 2^22 NTT differs from the four-step one")
    say(f"{NO_FOUR_STEP}=1: ntt 2^{SIZES['ntt_log']} equals the four-step result")
    del ev_flat, ev, back
    for log_n in FLAT_LOGS:
        n = 1 << log_n
        a = rand_fr((n,))
        ev = phase(f"ntt 2^{log_n} (flat)", lambda: ntt(BN254_FR, a))
        back = phase(f"intt 2^{log_n} (flat)", lambda: intt(BN254_FR, ev))
        if not torch.equal(back, a):
            raise AssertionError(f"intt(ntt(a)) != a at 2^{log_n}")
        del a, ev, back
        # a sparse poly: f(w^j) = sum_i c_i w^(i j) on the host
        pos = [0, 1, 2, int(gen.integers(3, n - 1)), n - 1]
        vals = [int.from_bytes(gen.bytes(32), "little") % r_ord for _ in pos]
        sp = torch.zeros((n, 16), dtype=torch.int32, device=dev)
        sp[pos] = mont.encode_ints(BN254_FR, vals, device=dev)
        sev = ntt(BN254_FR, sp)
        w = BN254_FR.nth_root_of_unity(log_n)
        js = [0, 1, n // 2 + 1, int(gen.integers(2, n - 1)), n - 1]
        want = [sum(v * pow(w, i * j, r_ord) for i, v in zip(pos, vals)) % r_ord for j in js]
        if mont.decode_ints(BN254_FR, sev[js]) != want:
            raise AssertionError(f"flat ntt 2^{log_n} of a sparse poly")
        del sp, sev
        say(f"ntt 2^{log_n} (flat): intt round trip exact; a 5-term poly's f(w^j) equals the "
            f"host sum at j = {js}")
    k_lo, k_hi = FLAT_DOMAIN
    dom_flat = Domain(BN254_FR, k_lo, k_hi)
    c_lo = rand_fr((1 << k_lo,))
    back = phase(f"Domain({k_lo},{k_hi}) coeff->extended->coeff",
                 lambda: dom_flat.extended_to_coeff(dom_flat.coeff_to_extended(c_lo)), runs=2)
    if not (torch.equal(back[: 1 << k_lo], c_lo) and not back[1 << k_lo :].any()):
        raise AssertionError(f"Domain({k_lo}, {k_hi}) round trip")
    say(f"Domain({k_lo}, {k_hi}): extended_to_coeff(coeff_to_extended(a)) == a, zero-padded")
    del back, c_lo, dom_flat
    torch.cuda.empty_cache()

    totals = {k: sum(p["launches"][k] for p in phases.values()) for k in _build.launches}
    for name in KERNELS:
        if totals[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the commitment engine's path")

    # -- 4. the prover --------------------------------------------------------
    mark("4 prover")
    prover = prove_phase(say, card, dev, srs)
    for name in KERNELS:
        if name not in ("bitonic_sort", "butterfly") and prover["launches"][name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the prover's path")

    # -- 5. the slice's main path: the P-256 prover service ------------------------
    mark("5 p256")
    fixture = json.loads((ROOT / "zkdcap_tpu_torch" / "testdata" / "p256_proof.json").read_text())
    service = service_phase(say, card, dev, fixture)
    evm_source = service.pop("evm_source")
    for name in KERNELS:
        if name != "butterfly" and service["launches"][name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the prover service's path")

    # -- 6. this slice's main path: the DCAP prover ---------------------------------
    mark("6 dcap")
    dcap_fixture = json.loads((ROOT / "zkdcap_tpu_torch" / "testdata" / "dcap_proof.json")
                              .read_text())
    dcap = dcap_phase(say, card, dev, dcap_fixture)
    for name in KERNELS:
        if name != "bitonic_sort" and dcap["launches"][name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the DCAP prover's path")

    # -- 6b. the sharded prover: MSM, NTT and proofs over a mesh ------------------
    mark("6b sharded")
    sharded = sharded_phase(say, card, dev, pts20, scal, msm20_point, a22, service, dcap,
                            fixture, dcap_fixture)
    for name in KERNELS:
        if name not in ("bitonic_sort", "butterfly") and sharded["launches"][name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the sharded path")

    # -- 7. GWC: the DCAP proof under the GWC multiopen --------------------------
    mark("7 gwc")
    dcap_prover = dcap.pop("prover")
    gwc = gwc_phase(say, card, dev, dcap_fixture, bytes.fromhex(dcap_fixture["proof"]),
                    dcap_prover)

    # -- 8. per-round checkpoints of the DCAP proof ------------------------------
    mark("8 checkpoints")
    ckpt = checkpoint_phase(say, card, dev, dcap_fixture, dcap_prover)
    require_kernels("the checkpoint step", ckpt["launches"])
    del dcap_prover

    # -- 9. where the device time goes: one profiled run of each phase --------
    mark("9 profiles")
    # every NTT (ntt_module._transform) runs in a marked range, so that the
    # device time of its non-A kernels (the copies of a four-step transform,
    # the flat path's gather) shows per profile; the calls of the default
    # proofs are listed (tools/kernel_ab.py replays them on two trees)
    breakdown = {}
    transform = ntt_module._transform
    ntt_calls = []

    def marked_transform(params_, batch, inverse):
        ntt_calls.append([int(batch.shape[0]), int(batch.shape[1]), bool(inverse)])
        with torch.profiler.record_function(NTT_RANGE):
            return transform(params_, batch, inverse)

    def ntt_share(name, b):
        """The device ms of profile `name`'s NTT range and A's, printed and
        kept in b["ntt"]. The profiler attributes to a range the kernels of
        the torch operations called inside it (the four-step copies, the
        flat path's gather), not the port's kernels, which the library
        launches itself (A, G, E): those are counted by name."""
        rng = b["ranges"].get(NTT_RANGE, {"calls": 0, "device_ms": 0.0})
        a = b["ours"].get("ntt_pass", {"ms": 0.0, "launches": 0})
        b["ntt"] = {"calls": rng["calls"], "torch_ms": rng["device_ms"], "a_ms": a["ms"],
                    "a_launches": a["launches"]}
        say(f"profile {name}: NTT x{rng['calls']}: torch's kernels inside (copies, gathers) "
            f"{rng['device_ms']:.2f} ms; A x{a['launches']} {a['ms']:.2f} ms ({card})")

    ntt_module._transform = marked_transform
    def switched(var, fn):
        def run():
            os.environ[var] = "1"
            try:
                return fn()
            finally:
                del os.environ[var]
        return run

    msm20 = lambda: msm_device(G1_SPEC, pts20, scal, SIZES["lanes"])  # noqa: E731
    profiled = {
        f"msm_device 2^{SIZES['msm_log']}": msm20,
        **{f"msm_device 2^{SIZES['msm_log']} {var}=1": switched(var, msm20)
           for var in SWITCHES.values()},
        f"commit_lagrange 2^{k}": lambda: params.commit_lagrange(evals),
        f"ntt 2^{SIZES['ntt_log']}": lambda: ntt(BN254_FR, a22),
    }
    for name, fn in profiled.items():
        b = breakdown[name] = device_breakdown(
            fn, ranges=(NTT_RANGE,) if name.startswith("ntt") else ())
        if not b["device_busy_ms"]:
            say(f"profile {name}: device time not measured (no CUDA events in the trace)")
            continue
        if name.startswith("ntt"):
            ntt_share(name, b)
        top = "; ".join(f"{t['kernel'][:48]} x{t['launches']} {t['ms']:.2f} ms"
                        for t in b["top"][:6])
        ours = "; ".join(f"{kn} x{r['launches']} {r['ms']:.2f} ms" for kn, r in b["ours"].items())
        say(f"profile {name}: {b['wall_ms_profiled']:.1f} ms wall under the profiler, "
            f"device busy {b['device_busy_ms']:.1f} ms ({100 * b['busy_share']:.0f}%); "
            f"kernels A-G: {ours}; top: {top} ({card})")
    # one k = 18 proof, with the plain field additions, subtractions and
    # negations (mont.add/sub/neg) marked as ranges
    name = f"ECDSAProver.create_proof k={k}"
    marked = {"add": "plain field add", "sub": "plain field sub", "neg": "plain field neg"}
    originals = {fn: getattr(mont, fn) for fn in marked}

    def in_range(label, fn):
        def run(*args, **kwargs):
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)
        return run

    for fn, label in marked.items():
        setattr(mont, fn, in_range(label, originals[fn]))
    prove_once = service.pop("prove_once")
    ntt_calls.clear()
    try:
        b = breakdown[name] = device_breakdown(prove_once, top=15,
                                               ranges=(*marked.values(), NTT_RANGE))
    finally:
        for fn, orig in originals.items():
            setattr(mont, fn, orig)
    report["ntt_calls"] = {"P-256": list(ntt_calls)}
    if b["device_busy_ms"]:
        top = "; ".join(f"{t['kernel'][:48]} x{t['launches']} {t['ms']:.1f} ms"
                        for t in b["top"][:8])
        share = "; ".join(f"{lb} x{r['calls']} {r['device_ms']:.1f} ms "
                          f"({100 * r['device_ms'] / b['device_busy_ms']:.1f}% of busy)"
                          for lb, r in b["ranges"].items() if lb != NTT_RANGE)
        ours = "; ".join(f"{kn} x{r['launches']} {r['ms']:.1f} ms" for kn, r in b["ours"].items())
        say(f"profile {name}: {b['wall_ms_profiled']:.0f} ms wall under the profiler, "
            f"device busy {b['device_busy_ms']:.0f} ms ({100 * b['busy_share']:.0f}%), "
            f"{b['kernel_launches']} kernel launches; ranges: {share}; kernels A-G: {ours}; "
            f"top: {top} ({card})")
        ntt_share(name, b)
    else:
        say(f"profile {name}: device time not measured (no CUDA events in the trace)")
    # the k = 18 proofs under the sort switches are not profiled (cut for the
    # script's time limit): the ranking takes kernel F's device ms per such
    # proof from step 5's launches times its kernel_ms
    base = breakdown[name]
    if base["device_busy_ms"]:
        say(f"profile {name}: gathers {base['gather_ms']:.1f} ms ({card})")
    # one DCAP proof with the default NTT, kernel C's launches counted and
    # timed by lane count (the wrapper's launches in order, matched to the
    # profiled kernels in order), without host tracing; the flat path is not
    # profiled (cut for the script's time limit: the ranking takes kernel G's
    # device ms per flat proof from step 6's launches times its kernel_ms)
    dcap_once = dcap.pop("prove_once")
    c_lanes = []

    def by_lanes(fn):
        def run():
            launch = _build.launch

            def counted(name, *args, **kw):
                if name == "ec_add_select":
                    c_lanes.append(args[10])
                return launch(name, *args, **kw)
            _build.launch = counted
            try:
                return fn()
            finally:
                _build.launch = launch
        return run

    for label, fn in (("default", by_lanes(dcap_once)),):
        name = f"DcapProver.create_proof k=17 {label}"
        ntt_calls.clear()
        b = breakdown[name] = device_breakdown(
            fn, top=10, sequence=kernel_functions("ec_add_select"))
        if label == "default":
            report["ntt_calls"]["DCAP"] = list(ntt_calls)
        if not b["device_busy_ms"]:
            say(f"profile {name}: device time not measured (no CUDA events in the trace)")
            continue
        if label == "default":
            hist = {}
            matched = len(b["sequence_ms"]) == len(c_lanes)
            for i, n in enumerate(c_lanes):
                h = hist.setdefault(lane_bucket(n), {"launches": 0, "device_ms": 0.0})
                h["launches"] += 1
                h["device_ms"] = h["device_ms"] + b["sequence_ms"][i] if matched else None
            order = [lane_bucket(top) for top in C_BUCKETS] + [lane_bucket(C_BUCKETS[-1] + 1)]
            b["c_by_lanes"] = hist = {lb: hist[lb] for lb in order if lb in hist}
            say(f"profile {name}: kernel C by lanes: " + "; ".join(
                f"{lb}: {h['launches']} launches, "
                + (f"{h['device_ms']:.2f} ms" if matched else "device ms not matched")
                for lb, h in hist.items()) + f" ({card})")
        top = "; ".join(f"{t['kernel'][:48]} x{t['launches']} {t['ms']:.1f} ms"
                        for t in b["top"][:8])
        ours = "; ".join(f"{kn} x{r['launches']} {r['ms']:.1f} ms" for kn, r in b["ours"].items())
        say(f"profile {name}: {b['wall_ms_profiled']:.0f} ms wall under the profiler, "
            f"device busy {b['device_busy_ms']:.0f} ms ({100 * b['busy_share']:.0f}%), "
            f"{b['kernel_launches']} kernel launches, gathers {b['gather_ms']:.1f} ms; "
            f"kernels A-G: {ours}; top: {top} ({card})")
    ntt_module._transform = transform
    # free the P-256 and DCAP provers before the next services start
    del prove_once, dcap_once, fn
    gc.collect()
    torch.cuda.empty_cache()

    # -- 10. the prover CLI on the params dirs of steps 5 and 6 -------------------
    mark("10 cli")
    cli = cli_phase(say, card, fixture, evm_source, dcap["proof"])

    # -- 11-12. the cert-chain and quote prover services ---------------------------
    circuit_steps = {}
    for step, name in zip((11, 12), CIRCUIT_SERVICES):
        mark(f"{step} {name}")
        fix = json.loads((ROOT / "zkdcap_tpu_torch" / "testdata" / f"{name}_vk.json")
                         .read_text())
        circuit_steps[name] = circuit_service_phase(say, card, dev, name, fix,
                                                    ROOT / "build" / "smoke_params_dcap")
    mark("13 table")

    # the device time each kernel loses per proof against its bound: its
    # profiled device ms times (1 - bound/kernel_ms) at its main row's shape
    # in step 2 (the kernel's own device time, as the profiles count it),
    # the largest over the profiled proofs of each circuit; kernels whose
    # wrapper is slower than the PyTorch call for the same function (both
    # timed by CUDA events) first
    ranking = []
    proof_profiles = {"P-256": [n for n in breakdown if n.startswith("ECDSAProver")],
                      "DCAP": [n for n in breakdown if n.startswith("DcapProver")]}
    for kname in KERNELS:
        row = kernels[kname]
        slack = max(0.0, 1 - row["bound_ms"] / row["kernel_ms"])
        entry = {"kernel": kname, "ms_over_bound": row["kernel_ms"] / row["bound_ms"],
                 "slower_than_library": row["library_ms"] is not None
                 and row["ms"] > row["library_ms"]}
        for circuit, names in proof_profiles.items():
            per = {n: breakdown[n]["ours"].get(kname, {"ms": 0.0})["ms"] for n in names}
            if circuit == "P-256" and kname == "bitonic_sort":
                for label, var in SWITCHES.items():
                    per[f"{var}=1 (step 5's launches x kernel_ms)"] = (
                        max(r["launches"][kname] for r in service["runs"][label])
                        * row["kernel_ms"])
            if circuit == "DCAP" and kname == "butterfly":
                per[f"{NO_FOUR_STEP}=1 (step 6's launches x kernel_ms)"] = (
                    max(r["launches"][kname] for r in dcap["runs"]["flat"]) * row["kernel_ms"])
            worst = max(per, key=per.get) if per else None
            entry[circuit] = {"device_ms": per.get(worst, 0.0), "lost_ms": per.get(worst, 0.0) * slack,
                              "proof": worst}
        ranking.append(entry)
    ranking.sort(key=lambda e: (not e["slower_than_library"],
                                -(e["P-256"]["lost_ms"] + e["DCAP"]["lost_ms"])))
    report["ranking"] = ranking
    say("ranking by device ms lost per proof against the bound: " + "; ".join(
        f"{e['kernel']} {e['ms_over_bound']:.1f}x bound"
        + (", slower than the library call" if e["slower_than_library"] else "")
        + f", P-256 {e['P-256']['lost_ms']:.1f} of {e['P-256']['device_ms']:.1f} ms, "
        f"DCAP {e['DCAP']['lost_ms']:.1f} of {e['DCAP']['device_ms']:.1f} ms" for e in ranking)
        + f" ({card})")

    table = []
    for name, row in kernels.items():
        base = name.split("/")[0]
        # the main paths: the P-256 service (step 5), the DCAP prover (step 6),
        # GWC (step 7), the checkpoints (step 8), the CLI (step 10) and the
        # cert-chain and quote services (steps 11-12)
        row["launches"] = (service["launches"][base] + dcap["launches"][base]
                           + sum(c["launches"][base] for c in circuit_steps.values())
                           + gwc["launches"][base] + ckpt["launches"][base]
                           + cli["launches"][base] + sharded["launches"][base])
        row["launches_sharded"] = sharded["launches"][base]
        row["launches_per_sharded_p256_proof"] = \
            sharded["proofs"][f"P-256 proof k=18 over {P256_SHARDS[0]} shards"]["launches"][base]
        row["launches_service"] = service["launches"][base]
        row["launches_dcap"] = dcap["launches"][base]
        for cname, c in circuit_steps.items():
            row[f"launches_{cname}"] = c["launches"][base]
            row[f"launches_per_{cname}_proof"] = c["runs"][-1]["launches"][base]
        row["launches_gwc"] = gwc["launches"][base]
        row["launches_checkpoint"] = ckpt["launches"][base]
        row["launches_cli"] = cli["launches"][base]
        row["launches_engine"] = totals[base]
        row["launches_layout_prover"] = prover["launches"][base]
    for name in KERNELS:
        row = dict(kernels[name])
        row.pop("shape")
        table.append(row)
    report.update({"kernel_checks": list(kernels.values()), "phases": phases,
                   "launch_totals": totals, "prover": prover, "service": service,
                   "dcap": dcap, "sharded": sharded, "breakdown": breakdown,
                   **circuit_steps, "gwc": gwc,
                   "checkpoint": ckpt, "cli": cli, "step_start_s": step_start,
                   "total_s": time.perf_counter() - T_START})
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    say(f"chip_smoke: {report['total_s']:.0f} s from the start of the script; steps started at "
        + ", ".join(f"{st} {t:.0f} s" for st, t in step_start.items()) + f" ({card})")
    say(json.dumps({"kernels": table}))
    say(card)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
