"""Time the design variants of kernels B and C (and E's product) on one card.

    python3 -m zkdcap_tpu_torch.tools.kernel_variants

Needs a CUDA card and nvcc. Builds ``kernel_variants.cu`` (the variants,
with the package's own sources included) into ``build/variants/`` and
prints each variant's registers and spills. Then, at the main paths' shapes, it holds every variant against the
plain torch version (exactly; B's run-ends variant at the run ends only)
and times them in turns (each variant, then again in reverse order): with
CUDA events around back-to-back launches, and by the kernels' own device
time from torch.profiler (the launch gaps of small launches left out).
Everything goes to ``build/kernel_variants.json``.

Kernel C runs at 20 to 393,216 lanes (the aggregation's sizes, the proofs'
Hillis-Steele level and the 2^20 MSM's), half the lanes adding and all of
them; kernel B at the 2^20 MSM's M = 64 x 131,072 (random masks) and the
proofs' M = 8 and 16 x 81,920 (masks from sorted random 13-bit window
digits); E at 2^20 Fr products.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from .. import _build
from ..curves import BN254_G1
from ..curves import ec_kernels as ek
from ..curves.device_g1 import G1_SPEC, affine_to_projective, encode_points
from ..fields import BN254_FR, mul_kernels

HERE = Path(__file__).resolve().parent
OUT = _build.BUILD_DIR.parent / "variants"
C_DESIGNS = {0: "entry point", 1: "grouped", 2: "large 256/128", 3: "large 128/128"}
B_DESIGNS = {0: "entry point", 1: "2 lanes/thread", 2: "1 lane/thread, run ends",
             3: "group of 8/lane", 4: "1 lane/thread, fe_mul", 5: "4 blocks/SM", 6: "5 blocks/SM"}
C_LANES = (20, 640, 1280, 2560, 5120, 10240, 20480, 40960, 102400, 393216)
B_SHAPES = {"main": (64, 131072), "dcap": (8, 81920), "p256": (16, 81920)}


def build() -> tuple[ctypes.CDLL, dict]:
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / "libkernel_variants.so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
                          str(_build.CSRC), "-o", str(lib), str(HERE / "kernel_variants.cu")],
                         capture_output=True, text=True, timeout=600)
    if res.returncode:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    handle = ctypes.CDLL(str(lib))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    handle.zkv_ec_add_select.argtypes = [I] + [P] * 10 + [I, I, P]
    handle.zkv_madd_scan.argtypes = [I] + [P] * 5 + [I, I, P]
    handle.zkv_mont_mul.argtypes = [I, P, P, P, L, P]
    for fn in (handle.zkv_ec_add_select, handle.zkv_madd_scan, handle.zkv_mont_mul):
        fn.restype = I
    return handle, _build.ptxas_report(res.stdout + res.stderr)


def turns(fns: dict, reps: int) -> dict:
    """Mean device ms of each fn over `reps` launches, timed in the order
    given and again in reverse (CUDA events), after one warm-up each."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {k: [] for k in fns}
    for key in [*fns, *reversed(list(fns))]:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fns[key]()
        end.record()
        end.synchronize()
        times[key].append(start.elapsed_time(end) / reps)
    return {k: sum(v) / len(v) for k, v in times.items()}


def kernel_turns(fns: dict, reps: int) -> dict:
    """Mean device time of one launch of each fn's kernel (each call
    launches one) over the launches the trace holds, without the host's
    launch gaps (torch.profiler), in the same turns as `turns`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    times = {k: [] for k in fns}
    for key in [*fns, *reversed(list(fns))]:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fns[key]()
            torch.cuda.synchronize()
        us = [e.time_range.end - e.time_range.start for e in prof.events()
              if e.device_type == DeviceType.CUDA and not e.name.startswith("Activity Buffer")]
        times[key].append(sum(us) / 1e3 / len(us))  # each call launches one kernel
    return {k: sum(v) / len(v) for k, v in times.items()}


def check(rc: int) -> None:
    if rc:
        raise RuntimeError(f"CUDA error {rc}")


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    lib, ptxas = build()
    report = {"card": card, "ptxas": ptxas, "C": {}, "B": {}, "E": {}}
    for f, r in ptxas.items():
        print(f"ptxas {f[:70]}: {r}")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    torch.manual_seed(11)
    pts, step = [BN254_G1.g], BN254_G1.mul(0x1234567, BN254_G1.g)
    for _ in range(1023):
        pts.append(BN254_G1.add(pts[-1], step))
    pool = encode_points(G1_SPEC, pts, device=dev)

    # C
    for n in C_LANES:
        P, Q = (tuple(c.contiguous() for c in affine_to_projective(
            G1_SPEC, pool[torch.randint(0, len(pts), (n,), device=dev)])) for _ in range(2))
        for frac in (0.5, 1.0):
            mask = (torch.rand(n, device=dev) < frac).to(torch.int32)
            out = tuple(torch.empty_like(P[0]) for _ in range(3))
            ref = ek.ec_add_select_plain(G1_SPEC, P, Q, mask, "p")
            fns = {}
            for d, label in C_DESIGNS.items():
                args = (d, *(t.data_ptr() for t in (*P, *Q, mask, *out)), n, 0)
                fns[label] = (lambda a=args: check(lib.zkv_ec_add_select(*a, stream())))
                fns[label]()
                torch.cuda.synchronize()
                if not all(torch.equal(o, r) for o, r in zip(out, ref)):
                    raise AssertionError(f"C {label} at n = {n} differs from the plain version")
            reps = 20 if n < 50000 else 5
            ms, kms = turns(fns, reps), kernel_turns(fns, reps)
            report["C"][f"{n}/{frac}"] = {"events_ms": ms, "kernel_ms": kms}
            print(f"C n={n} adding {frac}: kernel " + ", ".join(
                f"{k} {kms[k]:.4f} ms" for k in fns) + "; events " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in ms.items()) + f" ({card})", flush=True)

    # B
    for label, (M, B) in B_SHAPES.items():
        idx = torch.randint(0, len(pts), (M * B,), device=dev)
        rows = ek.pack_affine_rows(pool)[idx].reshape(M, B, 16).transpose(1, 2).contiguous()
        if label == "main":
            masks = (torch.rand(M, 3, B, device=dev)
                     < torch.tensor([0.6, 0.97, 0.5], device=dev)[:, None]).to(torch.int32)
            masks[0, 0] = 0
        else:
            windows, lanes = B // 16384, 16384
            d = torch.randint(-(1 << 12), 1 << 12, (windows, lanes * M), device=dev).abs()
            dm = d.sort(dim=1).values.reshape(windows, lanes, M).permute(2, 0, 1).reshape(M, B)
            same = torch.zeros_like(dm, dtype=torch.bool)
            same[1:] = dm[1:] == dm[:-1]
            masks = torch.stack([same, dm != 0, torch.rand(M, B, device=dev) < 0.5], 1)
        masks = masks.to(torch.int32).contiguous()
        ref = ek.ec_madd_scan_plain(G1_SPEC, rows, masks)
        ends = torch.ones(M, B, dtype=torch.bool, device=dev)
        ends[:-1] = masks[1:, 0] == 0
        fns = {}
        for d, name in B_DESIGNS.items():
            out = tuple(torch.zeros_like(rows) for _ in range(3))
            args = (d, *(t.data_ptr() for t in (rows, masks, *out)), M, B)
            fns[name] = (lambda a=args: check(lib.zkv_madd_scan(*a, stream())))
            fns[name]()
            torch.cuda.synchronize()
            keep = ends[:, None, :] if d == 2 else torch.ones_like(ends)[:, None, :]
            if not all(torch.equal(torch.where(keep, o, 0), torch.where(keep, r, 0))
                       for o, r in zip(out, ref)):
                raise AssertionError(f"B {name} at {label} differs from the plain version")
        ms, kms = turns(fns, 3), kernel_turns(fns, 3)
        report["B"][label] = {"M": M, "B": B, "events_ms": ms, "kernel_ms": kms,
                              "adding_steps": int((masks[:, 0] & masks[:, 1]).sum()),
                              "run_ends": int(ends.sum())}
        print(f"B {label} M={M} x B={B}: kernel " + ", ".join(
            f"{k} {kms[k]:.4f} ms" for k in fns) + "; events " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in ms.items()) + f" ({card})", flush=True)
        del rows, masks, ref
        torch.cuda.empty_cache()

    # E: 2^20 Fr products with either product
    n = 1 << 20
    a = torch.randint(0, 1 << 16, (n, 16), dtype=torch.int32, device=dev)
    b = torch.randint(0, 1 << 16, (n, 16), dtype=torch.int32, device=dev)
    a[:, 15] &= 0x2FFF
    b[:, 15] &= 0x2FFF
    ref = mul_kernels.mont_mul_plain(BN254_FR, a, b)
    fns = {}
    for d, name in ((0, "fe_mul"), (1, "fe_mul_cc")):
        out = torch.empty_like(a)
        args = (d, a.data_ptr(), b.data_ptr(), out.data_ptr(), n)
        fns[name] = (lambda x=args: check(lib.zkv_mont_mul(*x, stream())))
        fns[name]()
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(f"E with {name} differs from the plain version")
    report["E"] = {"events_ms": turns(fns, 50), "kernel_ms": kernel_turns(fns, 50)}
    e = report["E"]
    print("E 2^20 Fr: kernel " + ", ".join(f"{k} {v:.4f} ms" for k, v in e["kernel_ms"].items())
          + "; events " + ", ".join(f"{k} {v:.4f} ms" for k, v in e["events_ms"].items())
          + f" ({card})")
    (OUT.parent / "kernel_variants.json").write_text(json.dumps(report, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
