"""Port vs reference: the quote circuit's witness tape and evaluator.

The tape that the port's ``QuoteProver`` records on the demo quote
materialises the JAX package's trace, and the port's C++ evaluator replays
it to the JAX package's cells (``test_torch_service_circuits.check_tape``). The
circuit's compile and witness fill are held in ``test_torch_quote.py``.
"""

import test_torch_service_circuits as svc
from zkdcap_tpu.circuits import quote as jquote
from zkdcap_tpu_torch.circuits import quote as tquote


def test_tape_replay_matches_reference():
    q = tquote.make_demo_quote()
    svc.check_tape(jquote.build_quote_trace, tquote.build_quote_trace,
                   jquote.make_demo_quote(), q, tquote.trace_inputs(q))
