"""DCAP prover lifecycle: keygen/artifact cache/prove/verify for the k=17
SGX DCAP circuit (reference SURVEY.md §5.4 — the reference's stack A never
got a production lifecycle; this gives the DCAP circuit the stack-B
treatment via the generic CircuitProver template, base.rs:50-283).

Port of ``zkdcap_tpu/runtime/dcap_prover.py``."""

from __future__ import annotations

from ..circuits.dcap import (
    DCAP_LOOKUP_BITS,
    DcapInput,
    build_dcap_trace,
    load_demo_input,
    trace_inputs,
)
from .circuit_prover import CircuitProver


class DcapProver(CircuitProver):
    NAME = "dcap"
    K_DEFAULT = 17  # sgx_dcap_verifier.rs:765
    LOOKUP_BITS = DCAP_LOOKUP_BITS

    def build_trace(self, inp: DcapInput, tracer=None):
        return build_dcap_trace(inp, self.lookup_bits, tracer=tracer)

    def structure_input(self) -> DcapInput:
        return load_demo_input()

    def trace_inputs(self, inp: DcapInput) -> list[int]:
        return trace_inputs(inp)
