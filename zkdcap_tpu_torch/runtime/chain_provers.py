"""Prover lifecycles for the roadmap circuits: cert-chain and full-quote
(reference README.md:10-51 roadmap items; lifecycle template
base.rs:133-249 via the generic CircuitProver).

Both circuits' structure is parameterised by a concrete *structure input*
(the reference analog: circuit shape constants like measurement values and
chain layout are baked into fixed columns at keygen):

  * CertChainProver: link count, per-link tbs lengths, issuer-pubkey
    offsets, and the trust-anchor root pubkey;
  * QuoteProver: the expected MRENCLAVE/MRSIGNER/min-CPUSVN measurement
    constants.

A proof input must share its prover's structure (same shapes, same baked
constants); the pinning assert catches violations on witness fill.

Port of ``zkdcap_tpu/runtime/chain_provers.py``: the same artifact names, so a
params dir written by either package loads in the other. Keygen and proofs
run on the card unless ``device`` names another device.
"""

from __future__ import annotations

from ..circuits.cert_chain import (
    CertChainInput,
    build_cert_chain_trace,
    make_demo_chain,
)
from ..circuits.cert_chain import trace_inputs as chain_trace_inputs
from ..circuits.quote import QuoteInput, build_quote_trace, make_demo_quote
from ..circuits.quote import trace_inputs as quote_trace_inputs
from .circuit_prover import CircuitProver


class CertChainProver(CircuitProver):
    NAME = "cert_chain"
    K_DEFAULT = 17
    LOOKUP_BITS = 16

    def __init__(self, *args, structure: CertChainInput | None = None, **kw):
        super().__init__(*args, **kw)
        self._structure = structure

    def build_trace(self, inp: CertChainInput, tracer=None):
        return build_cert_chain_trace(inp, self.lookup_bits, tracer=tracer)

    def structure_input(self) -> CertChainInput:
        if self._structure is None:
            self._structure = make_demo_chain()
        return self._structure

    def trace_inputs(self, inp: CertChainInput) -> list[int]:
        return chain_trace_inputs(inp)


class QuoteProver(CircuitProver):
    NAME = "quote"
    K_DEFAULT = 17
    LOOKUP_BITS = 16

    def __init__(self, *args, structure: QuoteInput | None = None, **kw):
        super().__init__(*args, **kw)
        self._structure = structure

    def build_trace(self, inp: QuoteInput, tracer=None):
        return build_quote_trace(inp, self.lookup_bits, tracer=tracer)

    def structure_input(self) -> QuoteInput:
        if self._structure is None:
            self._structure = make_demo_quote()
        return self._structure

    def trace_inputs(self, inp: QuoteInput) -> list[int]:
        return quote_trace_inputs(inp)
