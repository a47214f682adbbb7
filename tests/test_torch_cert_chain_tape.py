"""Port vs reference: the cert-chain circuit's witness tape and evaluator.

The tape that the port's ``CertChainProver`` records on the Intel chain
materialises the JAX package's trace, and the port's C++ evaluator replays
it to the JAX package's cells (``test_torch_service_circuits.check_tape``). The
circuit's compile and witness fill are held in ``test_torch_cert_chain.py``.
"""

import test_torch_service_circuits as svc
from zkdcap_tpu.circuits import cert_chain as jcc
from zkdcap_tpu_torch.circuits import cert_chain as tcc


def test_tape_replay_matches_reference():
    chain = tcc.make_intel_demo_chain()
    svc.check_tape(jcc.build_cert_chain_trace, tcc.build_cert_chain_trace,
                   jcc.make_intel_demo_chain(), chain, tcc.trace_inputs(chain))
