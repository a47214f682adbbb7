"""Time kernels A, B and C of this checkout against another checkout's, in turns, on one card.

    python3 -m zkdcap_tpu_torch.tools.kernel_ab OTHER_CHECKOUT

Needs a CUDA card and nvcc. Runs, with the other checkout's package
("parent") and with this one's ("change"), in the order parent, change,
change, parent, each time in a fresh process started in that checkout (so it
imports and builds that checkout's kernels):

- every row of this checkout's ``chip_smoke.py`` ``B_ROWS`` and ``C_ROWS``
  (``scan_row``, ``add_row``) and the rows of ``A_ROWS`` on contiguous rows
  (``pass_row``: the call ``ntt_pass(x, tw, ptw)`` that every tree's wrapper
  takes), with the same seeded inputs and the same timing; each must equal
  its plain version;
- ``ntt`` and ``intt`` at 2^22 and 2^19 (the four-step path through
  ``_transform``): CUDA-event ms per call, all kernels' device ms per call
  and kernel A's (torch.profiler); each round trip must be exact;
- where ``build/chip_smoke.json`` of this checkout lists the NTT calls of a
  profiled DCAP and P-256 proof (``ntt_calls``, written by chip_smoke.py's
  step 9), the same calls replayed on seeded data of their shapes: the
  device ms of kernel A and of every other kernel inside them, per proof;
- kernel A's registers, stack and spills from that checkout's build.

Prints, for each reading and side, the mean over the two runs, and writes
``build/kernel_ab.json``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

RUN = r"""
import importlib, importlib.util, json, sys
import torch
sys.path.insert(0, ".")
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from zkdcap_tpu_torch import _build
from zkdcap_tpu_torch.fields import BN254_FR
nm = importlib.import_module("zkdcap_tpu_torch.ntt.ntt")
dev = torch.device("cuda")
A = ("ntt_pass_kernel",)

def device_ms(fn, reps):
    # (all kernels', kernel A's) device ms per call of fn, after one warm-up
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and not e.name.startswith("Activity Buffer")]
    total = sum(e.time_range.end - e.time_range.start for e in evs) / 1e3 / reps
    return total, sum(cs.kernel_events(prof, A)) / reps

def rand(n):
    x = torch.randint(0, 1 << 16, (n, 16), dtype=torch.int32, device=dev)
    x[:, 15] &= 0x2FFF
    return x

pool = cs.point_pool(dev)
out = {}
for name in [n for n, r in cs.A_ROWS.items() if r[4] == "rows"]:
    r = cs.pass_row(name, dev)
    if not all(torch.equal(a, b) for a, b in zip(r["got"], r["ref"])):
        raise SystemExit(f"{name} differs from its plain version")
    out[name] = {"ms": r["ms"], "kernel_ms": r["kernel_ms"]}
    del r
    torch.cuda.empty_cache()
for name in [*cs.B_ROWS, *cs.C_ROWS]:
    r = (cs.scan_row if name in cs.B_ROWS else cs.add_row)(name, pool)
    if not all(torch.equal(a, b) for a, b in zip(r["got"], r["ref"])):
        raise SystemExit(f"{name} differs from its plain version")
    out[name] = {"ms": r["ms"], "kernel_ms": r["kernel_ms"]}
    del r
    torch.cuda.empty_cache()
torch.manual_seed(5)
for log_n in (22, 19):
    a = rand(1 << log_n)
    ev = nm.ntt(BN254_FR, a)
    if not torch.equal(nm.intt(BN254_FR, ev), a):
        raise SystemExit(f"intt(ntt(a)) != a at 2^{log_n}")
    for label, fn in (("ntt", lambda: nm.ntt(BN254_FR, a)),
                      ("intt", lambda: nm.intt(BN254_FR, ev))):
        total, a_ms = device_ms(fn, 5)
        out[f"{label} 2^{log_n}"] = {"ms": cs.cuda_ms(fn, 10), "device_ms": total, "a_ms": a_ms}
    del a, ev
calls = json.loads(sys.argv[2]) if len(sys.argv) > 2 else {}
for circuit, seq in calls.items():
    buf = rand(max(nb * n for nb, n, _ in seq))
    def replay(seq=seq, buf=buf):
        for nb, n, inverse in seq:
            nm._transform(BN254_FR, buf[: nb * n].view(nb, n, 16), inverse)
    total, a_ms = device_ms(replay, 1)
    out[f"NTT calls of one {circuit} proof"] = {"calls": len(seq), "device_ms": total,
                                                "a_ms": a_ms, "other_ms": total - a_ms}
    del buf
    torch.cuda.empty_cache()
ptxas = _build.ptxas_report(_build.build_log)
out["ptxas ntt_pass"] = {f: r for f, r in ptxas.items() if "ntt_pass" in f}
print(json.dumps(out))
"""


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    trees = {"parent": Path(sys.argv[1]).resolve(), "change": ROOT}
    report = ROOT / "build" / "chip_smoke.json"
    calls = json.loads(report.read_text()).get("ntt_calls", {}) if report.exists() else {}
    runs = {"parent": [], "change": []}
    for label in ("parent", "change", "change", "parent"):
        res = subprocess.run([sys.executable, "-c", RUN, str(ROOT / "chip_smoke.py"),
                              json.dumps(calls)],
                             cwd=trees[label], capture_output=True, text=True, timeout=1200)
        if res.returncode:
            print(f"kernel_ab: the {label} run failed:\n{res.stdout}{res.stderr}", file=sys.stderr)
            return 1
        runs[label].append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(f"kernel_ab: {label} run done", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    means = {label: {row: {key: statistics.fmean(r[row][key] for r in rs)
                           for key, v in rs[0][row].items() if isinstance(v, (int, float))}
                     for row in rs[0] if not row.startswith("ptxas")}
             for label, rs in runs.items()}
    for row in means["parent"]:
        print(f"{row}: " + "; ".join(
            f"{label} " + ", ".join(f"{k} {v:.4f}" for k, v in means[label][row].items())
            for label in ("parent", "change")) + f" ({card})")
    for label in ("parent", "change"):
        print(f"ptxas ntt_pass, {label}: {runs[label][0]['ptxas ntt_pass']}")
    (ROOT / "build").mkdir(exist_ok=True)
    (ROOT / "build" / "kernel_ab.json").write_text(
        json.dumps({"card": card, "runs": runs, "means": means}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
