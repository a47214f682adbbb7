"""Time the design variants of kernels A, B and C (and E's product) on one card.

    python3 -m zkdcap_tpu_torch.tools.kernel_variants [A] [B] [C] [E]

runs the kernels named, or all of them. Needs a CUDA card and nvcc. Builds
``kernel_variants.cu`` (the variants, with the package's own sources
included) into ``build/variants/`` and prints each variant's registers and
spills. Then, at the main paths' shapes, it holds every variant against the
plain torch version (exactly; B's run-ends variant at the run ends only)
and times them in turns (each variant, then again in reverse order): with
CUDA events around back-to-back launches, and by the kernels' own device
time from torch.profiler (the launch gaps of small launches left out).
Everything goes to ``build/kernel_variants.json``.

Kernel A runs at its main row (one 2^11 pass over 2048 rows, forward,
post-multiplied), the proofs' passes (2^8 x 22 * 2^9, 2^9 x 22 * 2^8, 2^9 x
2^10, 2^10 x 2^9, and 2^10 x 2^10 with the 2^20 twiddles) and the 2^22
four-step passes in their strided layouts
(columns in; columns in, transposed out): the package's kernel as its entry
point launches it and at each tile; 2, 4 and 8 elements a thread with
several products and launch bounds; the first design (contiguous rows only);
and, alone, the rate of each product (four independent chains a thread).
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
from ..fields import BN254_FR, mul_kernels, ntt_kernels
from ..ntt.ntt import four_step_twiddles, _pass_twiddles

HERE = Path(__file__).resolve().parent
OUT = _build.BUILD_DIR.parent / "variants"
C_DESIGNS = {0: "entry point", 1: "grouped", 2: "large 256/128", 3: "large 128/128"}
B_DESIGNS = {0: "entry point", 1: "2 lanes/thread", 2: "1 lane/thread, run ends",
             3: "group of 8/lane", 4: "1 lane/thread, fe_mul", 5: "4 blocks/SM", 6: "5 blocks/SM"}
C_LANES = (20, 640, 1280, 2560, 5120, 10240, 20480, 40960, 102400, 393216)
B_SHAPES = {"main": (64, 131072), "dcap": (8, 81920), "p256": (16, 81920)}
A_DESIGNS = {0: "entry point", 1: "4 fe_mul", 2: "4 fe_mul_cc", 3: "4 fe_mul called",
             4: "4 fe_mul_cc called", 5: "4 fe_mul 256x3", 6: "4 fe_mul_a", 7: "4 fe_mul_p",
             8: "8 fe_mul", 9: "8 fe_mul called", 10: "2 fe_mul", 11: "first design"}
A_TILES = (8, 9, 10, 11)  # the entry point's kernel forced to each tile (log2 elements)
# (log S, rows, log n of the post-multiplied four-step twiddles or None, layout)
A_SHAPES = {"main": (11, 2048, 22, "rows"), "dcap 2^8": (8, 22 << 9, 17, "rows"),
            "dcap 2^9": (9, 22 << 8, None, "rows"), "ext 2^9": (9, 1 << 10, 19, "rows"),
            "ext 2^10": (10, 1 << 9, None, "rows"), "2^20 A": (10, 1 << 10, 20, "rows"),
            "4-step A": (11, 2048, 22, "columns"),
            "4-step B": (11, 2048, None, "transposed")}


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
    handle.zkv_ntt_pass.argtypes = [I, I, P, P, P, P, L, L, I, L] + [L] * 6 + [P]
    handle.zkv_product_rate.argtypes = [I, P, P, P, L, I, P]
    for fn in (handle.zkv_ec_add_select, handle.zkv_madd_scan, handle.zkv_mont_mul,
               handle.zkv_ntt_pass, handle.zkv_product_rate):
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
        # a trace now and then comes back without the kernels' records: take
        # it again, at most three times in all
        for _ in range(3):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fns[key]()
                torch.cuda.synchronize()
            us = [e.time_range.end - e.time_range.start for e in prof.events()
                  if e.device_type == DeviceType.CUDA and not e.name.startswith("Activity Buffer")]
            if us:
                break
        else:
            raise RuntimeError(f"torch.profiler traced no launch of {key} in three tries")
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
    report = {"card": card, "ptxas": ptxas, "A": {}, "C": {}, "B": {}, "E": {}}
    for f, r in ptxas.items():
        print(f"ptxas {f[:70]}: {r}")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    torch.manual_seed(11)
    pts, step = [BN254_G1.g], BN254_G1.mul(0x1234567, BN254_G1.g)
    for _ in range(1023):
        pts.append(BN254_G1.add(pts[-1], step))
    pool = encode_points(G1_SPEC, pts, device=dev)

    only = set(sys.argv[1:]) or {"A", "B", "C", "E"}
    # A
    for label, (log_s, rows, ptw_log, layout) in A_SHAPES.items() if "A" in only else ():
        size = 1 << log_s
        base = torch.randint(0, 1 << 16, (rows * size, 16), dtype=torch.int32, device=dev)
        base[:, 15] &= 0x2FFF
        x = base.view(rows, size, 16) if layout == "rows" else \
            base.view(size, rows, 16).transpose(0, 1)
        out = torch.empty(rows * size, 16, dtype=torch.int32, device=dev)
        out = out.view(size, rows, 16).transpose(0, 1) if layout == "transposed" else \
            out.view(rows, size, 16)
        tw = _pass_twiddles(log_s, False, dev)
        ptw = None if ptw_log is None else four_step_twiddles(ptw_log, False, dev)
        ref = ntt_kernels.ntt_pass_plain(x, tw, ptw)
        fns = {}
        designs = [(d, 0, name) for d, name in A_DESIGNS.items()
                   if d != 11 or layout == "rows"]
        designs += [(0, tl, f"tile 2^{tl}") for tl in A_TILES if tl >= max(log_s, 8)]
        for d, tl, name in designs:
            args = (d, tl, x.data_ptr(), out.data_ptr(), tw.data_ptr(),
                    None if ptw is None else ptw.data_ptr(), 1, rows, log_s,
                    1 if ptw is None else ptw.shape[0], 0, *x.stride()[:2], 0,
                    *out.stride()[:2])
            fns[name] = (lambda a=args: check(lib.zkv_ntt_pass(*a, stream())))
            out.zero_()
            fns[name]()
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise AssertionError(f"A {name} at {label} differs from the plain version")
        reps = 5 if rows * size >= 1 << 21 else 20
        ms, kms = turns(fns, reps), kernel_turns(fns, reps)
        report["A"][label] = {"log_s": log_s, "rows": rows, "layout": layout,
                              "events_ms": ms, "kernel_ms": kms}
        print(f"A {label} (2^{log_s} x {rows} rows, {layout}): kernel " + ", ".join(
            f"{k} {kms[k]:.4f} ms" for k in fns) + "; events " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in ms.items()) + f" ({card})", flush=True)
        del base, x, out, ref
        torch.cuda.empty_cache()

    # the product's rate alone: 2^18 threads x 4 independent chains, each
    # product first held against mont_mul_plain
    if "A" in only:
        threads, iters = 1 << 18, 64
        px = torch.randint(0, 1 << 16, (4 * threads, 16), dtype=torch.int32, device=dev)
        pw = torch.randint(0, 1 << 16, (threads, 16), dtype=torch.int32, device=dev)
        px[:, 15] &= 0x2FFF
        pw[:, 15] &= 0x2FFF
        pref = mul_kernels.mont_mul_plain(BN254_FR, px, pw.repeat_interleave(4, 0))
        pout = torch.empty_like(px)
        fns = {}
        for mul, name in ((0, "fe_mul"), (1, "fe_mul_cc"), (2, "fe_mul called"), (3, "fe_mul_a"),
                          (4, "fe_mul_p")):
            check(lib.zkv_product_rate(mul, px.data_ptr(), pw.data_ptr(), pout.data_ptr(),
                                       threads, 1, stream()))
            torch.cuda.synchronize()
            if not torch.equal(pout, pref):
                raise AssertionError(f"the product rate kernel with {name} differs from "
                                     "mont_mul_plain")
            args = (mul, px.data_ptr(), pw.data_ptr(), pout.data_ptr(), threads, iters)
            fns[name] = (lambda a=args: check(lib.zkv_product_rate(*a, stream())))
        kms = kernel_turns(fns, 5)
        n_products = 4 * threads * iters
        report["product_rate"] = {k: {"kernel_ms": v, "products_per_s": n_products / v * 1e3}
                                  for k, v in kms.items()}
        print(f"product rate ({n_products} products, 4 independent chains a thread): "
              + ", ".join(f"{k} {v:.4f} ms = {n_products / v / 1e6:.1f} G products/s"
                          for k, v in kms.items()) + f" ({card})", flush=True)
        del px, pw, pref, pout

    # C
    for n in C_LANES if "C" in only else ():
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
    for label, (M, B) in B_SHAPES.items() if "B" in only else ():
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
    if "E" not in only:
        (OUT.parent / "kernel_variants.json").write_text(json.dumps(report, indent=1))
        print(card)
        return 0
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
