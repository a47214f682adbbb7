"""Time DCAP proofs of this checkout against another checkout, in turns, on one card.

    python3 -m zkdcap_tpu_torch.tools.proof_ab OTHER_CHECKOUT [PROOFS]

Needs a CUDA card. Runs ``DcapProver(k=17)`` on the demo input from the
other checkout ("parent") and from this one ("change") in the order parent,
change, change, parent, each time in a fresh process started in that
checkout (so it imports and builds that checkout's package). All runs share
one params dir, ``build/proof_ab_params`` of this checkout: the first run's
keygen writes it, the others load it. Each run makes one untimed proof (it
records the witness tape the first time), requires its bytes to equal
``zkdcap_tpu_torch/testdata/dcap_proof.json``, then times PROOFS proofs
(default 3), each ended by a device synchronise. Prints each run's seconds
and both means, and writes ``build/proof_ab.json``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

RUN = r"""
import json, sys, time
import torch
sys.path.insert(0, ".")
from zkdcap_tpu_torch.circuits.dcap import load_demo_input
from zkdcap_tpu_torch.runtime import DcapProver

fixture = json.load(open("zkdcap_tpu_torch/testdata/dcap_proof.json"))
prover = DcapProver(params_dir=sys.argv[1], k=17, device="cuda")
prover.keygen()
inp, seed = load_demo_input(), fixture["seed"].encode()
if prover.create_proof(inp, timing=False, blinding_seed=seed).hex() != fixture["proof"]:
    raise SystemExit("the DCAP proof differs from the fixture")
times = []
for _ in range(int(sys.argv[2])):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prover.create_proof(inp, timing=False, blinding_seed=seed)
    torch.cuda.synchronize()
    times.append(time.perf_counter() - t0)
print(json.dumps({"proof_s": times}))
"""


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve()
    proofs = sys.argv[2] if len(sys.argv) > 2 else "3"
    params = ROOT / "build" / "proof_ab_params"
    trees = {"parent": other, "change": ROOT}
    runs = {"parent": [], "change": []}
    for label in ("parent", "change", "change", "parent"):
        res = subprocess.run([sys.executable, "-c", RUN, str(params), proofs], cwd=trees[label],
                             capture_output=True, text=True, timeout=1200)
        if res.returncode:
            print(f"proof_ab: the {label} run failed:\n{res.stdout}{res.stderr}", file=sys.stderr)
            return 1
        times = json.loads(res.stdout.strip().splitlines()[-1])["proof_s"]
        runs[label].append(times)
        print(f"{label}: " + ", ".join(f"{t:.3f}" for t in times) + " s", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    means = {k: statistics.fmean(t for r in v for t in r) for k, v in runs.items()}
    print("mean DCAP proof: " + ", ".join(f"{k} {v:.3f} s" for k, v in means.items())
          + f" ({card})")
    (ROOT / "build" / "proof_ab.json").write_text(
        json.dumps({"card": card, "runs": runs, "mean_s": means}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
