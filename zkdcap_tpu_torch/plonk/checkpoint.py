"""Per-transcript-round proof checkpointing (SURVEY.md §5.3).

Port of ``zkdcap_tpu/plonk/checkpoint.py``, in its file format down to the
byte layout, so that a checkpoint that either package writes resumes in the
other. ``create_proof(checkpoint_dir=...)`` saves, after each commit round,
(a) the transcript's replayable op log (hash cores are not serializable:
resume replays the log into a fresh core) and (b) the round's arrays, to one
``ck_{tag}_{round}.npz`` per round: a ``__spec__`` member (the JSON of the
log, the inputs' fingerprint and each key's kind) beside one ``uint32``
limb array per tensor. A re-invoked create_proof with the same arguments
skips completed rounds, reloads their outputs, and continues, emitting a
byte-identical proof. Checkpoints are deleted on successful finalize.

Round state is a dict of {int | bytes | tensor | list[tensor] |
list[dict[str, tensor]]}: exactly the shapes the prover carries between
rounds.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..interop import to_numpy, to_torch


class Preempted(RuntimeError):
    """Raised by the test-only abort hook to simulate preemption."""


def _enc_scalar(v):
    if v is None:
        return None
    if isinstance(v, bytes):
        return {"b": v.hex()}
    return {"i": hex(v)}


def _dec_scalar(e):
    if e is None:
        return None
    if "b" in e:
        return bytes.fromhex(e["b"])
    return int(e["i"], 16)


def _enc_log(log):
    out = []
    for op, v in log:
        if op in ("cp", "wp"):
            out.append([op, None if v is None else [hex(v[0]), hex(v[1])]])
        elif op in ("cs", "ws"):
            out.append([op, hex(v)])
        else:
            out.append([op, None])
    return out


def _dec_log(data):
    out = []
    for op, v in data:
        if op in ("cp", "wp"):
            out.append((op, None if v is None else (int(v[0], 16), int(v[1], 16))))
        elif op in ("cs", "ws"):
            out.append((op, int(v, 16)))
        else:
            out.append((op, None))
    return out


class ProofCheckpoint:
    def __init__(self, directory: str, tag: str = "proof"):
        self.dir = directory
        self.tag = tag
        os.makedirs(directory, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.dir, f"ck_{self.tag}_{name}.npz")

    def has(self, name: str) -> bool:
        return os.path.exists(self._path(name))

    def save(self, name: str, transcript, fingerprint: str, **state) -> None:
        """state values: int | bytes | tensor | list[tensor] |
        list[dict[str, tensor]]; tensors are written as uint32 limbs."""
        arrays: dict[str, np.ndarray] = {}
        spec: dict = {"log": _enc_log(transcript.log), "fp": fingerprint,
                      "keys": {}}

        def put(path, t):
            arrays[path] = to_numpy(t)

        for key, val in state.items():
            if val is None or isinstance(val, (int, bytes)):
                spec["keys"][key] = {"kind": "scalar", "v": _enc_scalar(val)}
            elif isinstance(val, list) and val and isinstance(val[0], dict):
                names = sorted(val[0].keys())
                spec["keys"][key] = {"kind": "dictlist", "n": len(val),
                                     "names": names}
                for i, d in enumerate(val):
                    assert sorted(d.keys()) == names, "ragged dictlist"
                    for nm in names:
                        put(f"{key}.{i}.{nm}", d[nm])
            elif isinstance(val, list):
                spec["keys"][key] = {"kind": "list", "n": len(val)}
                for i, a in enumerate(val):
                    put(f"{key}.{i}", a)
            else:
                spec["keys"][key] = {"kind": "array"}
                put(key, val)
        arrays["__spec__"] = np.frombuffer(json.dumps(spec).encode(), np.uint8)
        tmp = self._path(name) + ".tmp"  # np.savez appends .npz
        np.savez(tmp, **arrays)
        os.replace(tmp + ".npz", self._path(name))  # atomic publish

    def load(self, name: str, transcript, fingerprint: str, device=None) -> dict:
        """Restores the transcript to this round's state and returns the
        saved arrays as int32 tensors on `device` (the card unless named)."""
        with np.load(self._path(name), allow_pickle=False) as data:
            spec = json.loads(bytes(data["__spec__"]).decode())
            assert spec["fp"] == fingerprint, (
                "checkpoint was written for different proof inputs — remove "
                f"{self._path(name)} or pass the original inputs")
            transcript.restore(_dec_log(spec["log"]))

            def get(path):
                return to_torch(data[path], device)

            out: dict = {}
            for key, meta in spec["keys"].items():
                if meta["kind"] == "scalar":
                    out[key] = _dec_scalar(meta["v"])
                elif meta["kind"] == "array":
                    out[key] = get(key)
                elif meta["kind"] == "list":
                    out[key] = [get(f"{key}.{i}") for i in range(meta["n"])]
                else:
                    out[key] = [{nm: get(f"{key}.{i}.{nm}") for nm in meta["names"]}
                                for i in range(meta["n"])]
        return out

    def clear(self) -> None:
        for f in os.listdir(self.dir):
            if f.startswith(f"ck_{self.tag}_") and f.endswith(".npz"):
                os.remove(os.path.join(self.dir, f))
