"""Compiled witness generation (SURVEY.md §2.3 row 3).

Port of ``zkdcap_tpu/witness``.

The reference jit-compiles witness generation per proof (halo2-base's
`synthesize` re-runs Rust closures; rayon parallelises them). Here the
analog is record-once / replay-native: one Python trace records the
witness dataflow as a big-integer DAG (`tracer.py`), which is serialized
with the pinning and re-evaluated per proof by a C++ engine
(``csrc_host/witness_eval.cpp``, built by ``_build``, ~µs/cell) — the
Python chip stack never runs again for new inputs.
"""

from .tracer import TInt, Tracer, t_sel

__all__ = ["TInt", "Tracer", "t_sel"]
