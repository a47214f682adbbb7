"""Sharding over distinct cards against one card, in one process.

    python3 -m zkdcap_tpu_torch.tools.shard_scaling [OUT_JSON [PART ...]]

Needs CUDA cards: up to four distinct ones are used. On a machine with one,
every shard is ``cuda:0`` (virtual shards: a rehearsal of the script whose
readings show only what sharding costs). Every reading is taken in this one
process and every result is checked:

* the 2^20 MSM (the k = 18 dev SRS repeated, random scalars) and the 2^22
  NTT: on one card; over 2 and over every card (at most 4) with a lane a
  card (``Mesh.map``: the cards' steps in turn); and over every card in one
  lane (``Mesh._lane_key`` made one key: the shards one after another, the
  serial form, as plain loops issue it); the 2^22 MSM on one card and over every card
  in both forms. Medians of three after a warm-up, each card synchronised;
  every result equal to one card's. Then one profiled call of each over
  every card in both forms (``tools/concurrency.py``): each card's busy ms,
  the time two or more cards ran at once and the concurrency ratio;
* the k = 18 P-256 proof (``ECDSAProver``, the reference vector) on one card
  and over 2 and 4 cards, and over 4 cards in one lane; the k = 17 DCAP
  proof (``DcapProver``, the demo input) on one card and over 2 cards, and
  over 2 in one lane. Each mesh proves once untimed (its blocks of the
  SRS and the pk are cut then); then each is timed twice, the forms in turn
  forwards and then backwards (A B C C B A: a drift of the host's speed
  falls on every form alike), with each run's rounds; every proof equals
  ``testdata/{p256,dcap}_proof.json``. One profiled P-256 proof over every
  card, and one profiled DCAP proof over 2 cards in each form, give the
  cards' busy ms and the ratio for a whole proof.

PARTs (``engine``, ``p256``, ``dcap``; default all three) pick what runs.
Prints one line per reading and writes them all to OUT_JSON (default
``build/shard_scaling.json``). The params dirs are made anew under
``build/`` (a keygen each).
"""

from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
TESTDATA = ROOT / "zkdcap_tpu_torch" / "testdata"
# the engine's sizes (log 2): the dev SRS, repeated to the MSMs' points, the
# MSMs (the bigger one: a card's work outweighs the host's issue time) and the NTT
SRS_K, MSM_LOG, MSM_BIG_LOG, NTT_LOG = 18, 20, 22, 22


def _timed(fn, runs: int):
    """One untimed call, then the median of `runs` wall times (ms), every
    card synchronised; returns (median, times, the last result)."""
    from zkdcap_tpu_torch.tools.concurrency import sync_all

    res = fn()
    sync_all()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        res = fn()
        sync_all()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times, res


class _Run:
    """The cards, the meshes and the report of one run."""

    def __init__(self, out_path: Path):
        self.out_path = out_path
        self.cards = torch.cuda.device_count()
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True).stdout
        self.card = "; ".join(dict.fromkeys(ln.strip() for ln in smi.splitlines() if ln.strip()))
        self.top = 4 if self.cards == 1 else min(self.cards, 4)
        self.devs = [torch.device("cuda", i % self.cards) for i in range(self.top)]
        self.dev = self.devs[0]
        self.report: dict = {"cards": self.cards, "virtual": self.cards == 1, "card": self.card,
                             "smi": smi.strip().splitlines(), "errors": {}, "concurrency": {}}
        self.t_start = time.perf_counter()

    def say(self, msg: str) -> None:
        print(f"[{time.perf_counter() - self.t_start:7.1f} s] {msg} ({self.card})", flush=True)

    def mesh(self, n: int, lanes_by: str = "device"):
        """n cards; lanes_by "one": every shard in one lane (the serial form)."""
        from zkdcap_tpu_torch.parallel import proving_mesh

        m = proving_mesh(n, devices=self.devs[:n])
        if lanes_by == "one":
            m._lane_key = lambda i, dev: None
        return m

    def save(self) -> None:
        self.report["seconds"] = time.perf_counter() - self.t_start
        self.out_path.parent.mkdir(parents=True, exist_ok=True)
        self.out_path.write_text(json.dumps(self.report, indent=1, default=str))


def _engine(run: _Run) -> None:
    """The MSMs and the NTT in every form, then their profiles."""
    from zkdcap_tpu_torch.commit import gen_srs
    from zkdcap_tpu_torch.curves.device_g1 import G1_SPEC, decode_points
    from zkdcap_tpu_torch.fields import BN254_FR, mont
    from zkdcap_tpu_torch.msm.pippenger import msm_device
    from zkdcap_tpu_torch.ntt import ntt
    from zkdcap_tpu_torch.parallel import gather_rows, sharded_msm, sharded_ntt
    from zkdcap_tpu_torch.tools.concurrency import concurrency

    top, dev, report = run.top, run.dev, run.report
    forms = [(2, "device"), (top, "device"), (top, "one")] if top > 2 else \
        [(2, "device"), (2, "one")]
    gen = np.random.default_rng(11)
    srs = gen_srs(SRS_K, cache_dir=str(ROOT / "build" / "scaling_srs"), device=dev)

    def point(R):
        return decode_points(G1_SPEC, tuple(c.reshape(1, -1) for c in R))[0]

    msm_inputs = {}
    for log, shapes in ((MSM_LOG, forms), (MSM_BIG_LOG, [(top, "device"), (top, "one")])):
        n_msm = 1 << log
        pts = srs.g1_powers.repeat(n_msm // srs.g1_powers.shape[0], 1, 1)
        sbytes = np.frombuffer(gen.bytes(32 * n_msm), dtype=np.uint8).reshape(n_msm, 32).copy()
        sbytes[:, 31] &= 0x1F  # below r
        scal_std = torch.from_numpy(sbytes.view(np.uint16).astype(np.int32)).to(dev)
        scal = mont.to_mont(BN254_FR, scal_std)
        msm_inputs[log] = pts, scal
        ms, times, ref = _timed(lambda: msm_device(G1_SPEC, pts, scal_std, min(16384, n_msm)),
                                3)
        ref = point(ref)
        del scal_std
        rows = report[f"msm 2^{log}"] = {"one card": {"ms": ms, "runs_ms": times}}
        for n, by in shapes:
            m = run.mesh(n, by)
            ms, times, got = _timed(lambda: sharded_msm(m, pts, scal), 3)
            if point(got) != ref:
                raise AssertionError(f"the MSM 2^{log} over {n} cards ({by}) differs from one "
                                     "card's")
            rows[f"{n} cards, lanes by {by}"] = {"ms": ms, "runs_ms": times}
        run.say(f"MSM 2^{log}: " + "; ".join(f"{k} {v['ms']:.1f} ms" for k, v in rows.items()))

    a22 = torch.randint(0, 1 << 16, (1 << NTT_LOG, 16),
                        generator=torch.Generator().manual_seed(3), dtype=torch.int32)
    a22[:, 15] &= 0x2FFF
    a22 = a22.to(dev)
    ms, times, ref = _timed(lambda: ntt(BN254_FR, a22), 3)
    report["ntt"] = {"one card": {"ms": ms, "runs_ms": times}}
    for n, by in forms:
        m = run.mesh(n, by)
        ms, times, got = _timed(lambda: gather_rows(m, sharded_ntt(m, a22)), 3)
        if not torch.equal(got, ref):
            raise AssertionError(f"the NTT over {n} cards ({by}) differs from one card's")
        report["ntt"][f"{n} cards, lanes by {by}"] = {"ms": ms, "runs_ms": times}
    run.say(f"NTT 2^{NTT_LOG}: "
            + "; ".join(f"{k} {v['ms']:.2f} ms" for k, v in report["ntt"].items()))

    profiled = [(f"MSM 2^{log}", lambda m, x=msm_inputs[log]: sharded_msm(m, *x))
                for log in (MSM_LOG, MSM_BIG_LOG)]
    for name, fn in profiled + [(f"NTT 2^{NTT_LOG}", lambda m: sharded_ntt(m, a22))]:
        for by in ("device", "one"):
            m = run.mesh(top, by)
            fn(m)  # warm: the mesh's SRS blocks, the twiddle tables
            c = concurrency(lambda: fn(m))
            c.pop("result")
            report["concurrency"][f"{name} over {top} cards, lanes by {by}"] = c
            run.say(f"{name} over {top} cards, lanes by {by}: wall {c['wall_ms']:.1f} ms, "
                    "busy " + ", ".join(f"cuda:{d} {b:.1f}" for d, b in c["busy_ms"].items())
                    + f" ms, {c['overlap_ms']:.1f} ms of it with two or more cards at once; "
                    f"concurrency ratio {c['ratio']:.2f}")


def _proofs(run: _Run, label: str, prover, inp, fixture: dict, shapes, profiled) -> dict:
    """Each shape's (cards, lanes) proof: untimed, then twice timed with the
    shapes in turn (forwards, then backwards); then one profiled proof of
    each of the `profiled` shapes."""
    from zkdcap_tpu_torch.plonk import prover as tprover
    from zkdcap_tpu_torch.tools.concurrency import concurrency, sync_all
    from zkdcap_tpu_torch.transcript import TranscriptWriter

    prover.keygen()
    pk, advice, instances = prover.prepare(inp)
    kind, seed = prover.transcript_kind, fixture["seed"].encode()

    def prove(m, what):
        proof = tprover.create_proof(prover.params(), pk, advice, instances,
                                     TranscriptWriter(kind), blinding_seed=seed, mesh=m,
                                     multiopen=prover.multiopen, device=run.dev)
        if proof.hex() != fixture["proof"]:
            raise AssertionError(f"the {label} ({what}) differs from its fixture")

    def key(n, by):
        return "one card" if n == 1 else f"{n} cards, lanes by {by}"

    meshes = {key(n, by): run.mesh(n, by) if n > 1 else None for n, by in shapes}
    for k, m in meshes.items():
        prove(m, k)  # untimed: the mesh's blocks of the SRS and the pk are cut here
    res = {k: {"runs_s": [], "rounds_s": []} for k in meshes}
    for k in list(meshes) + list(meshes)[::-1]:
        sync_all()
        t0 = time.perf_counter()
        prove(meshes[k], k)
        sync_all()
        res[k]["runs_s"].append(time.perf_counter() - t0)
        res[k]["rounds_s"].append(dict(tprover.last_phases))
    for r in res.values():
        r["s"] = statistics.median(r["runs_s"])
    run.say(f"{label}, equal to its fixture (runs in turn, forwards then backwards): "
            + "; ".join(f"{k} {v['s']:.3f} s ({', '.join(f'{t:.3f}' for t in v['runs_s'])})"
                        for k, v in res.items()))
    for n, by in profiled:
        m = meshes.get(key(n, by)) or run.mesh(n, by)
        c = concurrency(lambda: prove(m, "profiled"))
        c.pop("result")
        run.report["concurrency"][f"{label} over {n} cards, lanes by {by}"] = c
        run.say(f"{label} over {n} cards, lanes by {by}, profiled: wall {c['wall_ms']:.0f} ms, "
                "busy " + ", ".join(f"cuda:{d} {b:.0f}" for d, b in c["busy_ms"].items())
                + f" ms; concurrency ratio {c['ratio']:.2f}")
    return res


def _p256(run: _Run) -> None:
    from zkdcap_tpu_torch.circuits.p256_ecdsa import ECDSAInput
    from zkdcap_tpu_torch.runtime import ECDSAProver

    fix = json.loads((TESTDATA / "p256_proof.json").read_text())
    params_dir = ROOT / "build" / "scaling_p256"
    shutil.rmtree(params_dir, ignore_errors=True)
    prover = ECDSAProver(params_dir=str(params_dir), k=18, device=run.dev)
    inp = ECDSAInput.from_hex(fix["msghash"], fix["signature"], fix["pubkey"])
    shapes = [(1, "")] + [(n, "device") for n in (2, 4) if n <= run.top] + [(run.top, "one")]
    run.report["p256"] = _proofs(run, "P-256 proof k=18", prover, inp, fix, shapes,
                                 [(run.top, "device")])


def _dcap(run: _Run) -> None:
    from zkdcap_tpu_torch.circuits.dcap import load_demo_input
    from zkdcap_tpu_torch.runtime import DcapProver

    fix = json.loads((TESTDATA / "dcap_proof.json").read_text())
    params_dir = ROOT / "build" / "scaling_dcap"
    shutil.rmtree(params_dir, ignore_errors=True)
    prover = DcapProver(params_dir=str(params_dir), k=17, device=run.dev)
    shapes = [(1, ""), (2, "device"), (2, "one")]
    run.report["dcap"] = _proofs(run, "DCAP proof k=17", prover, load_demo_input(), fix, shapes,
                                 shapes[1:])


def main() -> int:
    from zkdcap_tpu_torch import _build

    if not torch.cuda.is_available():
        print("shard_scaling needs a CUDA card", file=sys.stderr)
        return 2
    out_path = Path(sys.argv[1]) if len(sys.argv) > 1 else ROOT / "build" / "shard_scaling.json"
    run = _Run(out_path)
    _build.lib()
    # each part on its own, so that a failed one still leaves the others' readings
    parts = {"engine": _engine, "p256": _p256, "dcap": _dcap}
    for name in sys.argv[2:] or parts:
        part = parts[name]
        try:
            part(run)
        except Exception:
            run.report["errors"][name] = traceback.format_exc()
            print(f"{name} failed:\n{run.report['errors'][name]}", file=sys.stderr, flush=True)
        torch.cuda.empty_cache()
        run.save()
    run.say(f"wrote {out_path}")
    return 1 if run.report["errors"] else 0


if __name__ == "__main__":
    sys.exit(main())
