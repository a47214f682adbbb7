"""Circuit-shape config files (reference `CircuitParams` / `ECDSA_CONFIG`).

The reference selects a JSON circuit shape via the ECDSA_CONFIG env var
(`circuits/src/sgx_dcap_verifier.rs:49-59,163-168`; files at
`circuits/src/configs/*.config`). This is the port's analog:

  * same JSON schema (strategy/degree/num_advice/num_lookup_advice/
    num_fixed/lookup_bits/limb_bits/num_limbs) so reference config files
    parse unchanged;
  * selected by the ZKDCAP_CONFIG env var or an explicit path (CLI
    --config);
  * `num_advice`/`num_lookup_advice`/`num_fixed` are AUTO-DERIVED by the
    tape layout (chips/builder.py, halo2-base `calculate_params` analog) —
    when a config pins them they are treated as expectations and checked
    after compile (sweep tooling);
  * `bench_ecdsa.config`-style files hold one JSON object per line — a
    degree sweep (the rows-vs-columns tradeoff, reference
    `bench_ecdsa.config:1-9`).

Port of ``zkdcap_tpu/config.py``; it reads the repo's `configs/` files.
"""

from __future__ import annotations

import dataclasses
import json
import os

ENV_VAR = "ZKDCAP_CONFIG"
DEFAULT_PATH = os.path.join(os.path.dirname(__file__), "..", "configs",
                            "ecdsa_circuit.config")


@dataclasses.dataclass
class CircuitConfig:
    degree: int
    lookup_bits: int
    strategy: str = "Simple"
    num_advice: int | None = None         # expectation only (auto-derived)
    num_lookup_advice: int | None = None  # expectation only
    num_fixed: int | None = None          # expectation only
    limb_bits: int = 88
    num_limbs: int = 3
    transcript: str = "blake2b"
    # final KZG multi-open argument: "shplonk" (the reference's pick,
    # base.rs:266-269) or "gwc" (GWC19; the reference exposes the choice as
    # the compile-time ProverGWC/ProverSHPLONK type parameter)
    multiopen: str = "shplonk"

    @staticmethod
    def from_json(s: str) -> "CircuitConfig":
        d = json.loads(s)
        known = {f.name for f in dataclasses.fields(CircuitConfig)}
        return CircuitConfig(**{k: v for k, v in d.items() if k in known})

    def to_json(self) -> str:
        d = {k: v for k, v in dataclasses.asdict(self).items() if v is not None}
        return json.dumps(d)

    def validate(self) -> None:
        # the CRT layout is pinned by the instance encoding (lib.rs:80-81);
        # only the reference's own values are accepted. ValueError, not
        # assert: user-supplied config must fail loudly under `python -O`.
        if self.num_limbs != 3:
            raise ValueError("instance encoding requires 3 limbs")
        if not 88 <= self.limb_bits <= 91:
            raise ValueError(f"limb_bits={self.limb_bits} outside the "
                             "reference range [88, 91]")
        if self.lookup_bits >= self.degree:
            raise ValueError("lookup table must fit the domain: "
                             f"lookup_bits={self.lookup_bits} >= "
                             f"degree={self.degree}")
        if self.multiopen not in ("shplonk", "gwc"):
            raise ValueError(f"unknown multiopen scheme {self.multiopen!r} "
                             "(expected 'shplonk' or 'gwc')")


def load_config(path: str | None = None) -> CircuitConfig:
    """Explicit path > ZKDCAP_CONFIG env var > built-in default file >
    built-in defaults."""
    path = path or os.environ.get(ENV_VAR)
    if path is None and os.path.exists(DEFAULT_PATH):
        path = DEFAULT_PATH
    if path is None:
        return CircuitConfig(degree=18, lookup_bits=17)
    with open(path) as f:
        cfg = CircuitConfig.from_json(f.readline())
    cfg.validate()
    return cfg


def load_sweep(path: str) -> list[CircuitConfig]:
    """One JSON object per line (reference bench_ecdsa.config format)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(CircuitConfig.from_json(line))
    return out
