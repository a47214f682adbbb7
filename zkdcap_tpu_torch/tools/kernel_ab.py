"""Time kernels B and C of this checkout against another checkout's, in turns, on one card.

    python3 -m zkdcap_tpu_torch.tools.kernel_ab OTHER_CHECKOUT

Needs a CUDA card and nvcc. Runs every row of this checkout's
``chip_smoke.py`` ``B_ROWS`` and ``C_ROWS`` (its ``scan_row`` and
``add_row``: the same seeded inputs and masks, the same timing) with the
other checkout's package ("parent") and with this one's ("change"), in the
order parent, change, change, parent, each time in a fresh process started
in that checkout (so it imports and builds that checkout's kernels; the
wrappers' signatures are the same in both). Each run requires every row to
equal its plain version. Prints, for each row and side, the mean of the
wrapper's CUDA-event ms (``ms``) and of the kernel's own device ms per call
(``kernel_ms``, torch.profiler), and writes ``build/kernel_ab.json``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

RUN = r"""
import importlib.util, json, sys
import torch
sys.path.insert(0, ".")
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
pool = cs.point_pool(torch.device("cuda"))
out = {}
for name in [*cs.B_ROWS, *cs.C_ROWS]:
    r = (cs.scan_row if name in cs.B_ROWS else cs.add_row)(name, pool)
    if not all(torch.equal(a, b) for a, b in zip(r["got"], r["ref"])):
        raise SystemExit(f"{name} differs from its plain version")
    out[name] = {"ms": r["ms"], "kernel_ms": r["kernel_ms"]}
    del r
    torch.cuda.empty_cache()
print(json.dumps(out))
"""


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    trees = {"parent": Path(sys.argv[1]).resolve(), "change": ROOT}
    runs = {"parent": [], "change": []}
    for label in ("parent", "change", "change", "parent"):
        res = subprocess.run([sys.executable, "-c", RUN, str(ROOT / "chip_smoke.py")],
                             cwd=trees[label], capture_output=True, text=True, timeout=900)
        if res.returncode:
            print(f"kernel_ab: the {label} run failed:\n{res.stdout}{res.stderr}", file=sys.stderr)
            return 1
        runs[label].append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(f"kernel_ab: {label} run done", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    means = {label: {row: {key: statistics.fmean(r[row][key] for r in rs)
                           for key in ("ms", "kernel_ms")} for row in rs[0]}
             for label, rs in runs.items()}
    for row in means["parent"]:
        print(f"{row}: " + "; ".join(
            f"{label} {m[row]['ms']:.4f} ms (events), {m[row]['kernel_ms']:.4f} ms (kernel)"
            for label, m in ((k, means[k]) for k in ("parent", "change")))
            + f" ({card})")
    (ROOT / "build").mkdir(exist_ok=True)
    (ROOT / "build" / "kernel_ab.json").write_text(
        json.dumps({"card": card, "runs": runs, "means": means}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
