"""Native witness replay (the C++ evaluator through ctypes).

Port of ``zkdcap_tpu/witness/replay.py``: the port builds its own evaluator
(``_build.witness_lib``) and raises where it cannot, with no fallback.
"""

from __future__ import annotations


def replay_native(tape, inputs) -> list[int]:
    from .native import eval_tape

    return eval_tape(tape, inputs)
