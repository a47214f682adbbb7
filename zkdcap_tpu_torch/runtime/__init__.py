from .prover import ECDSAProver, SAMPLE_INPUT
from .circuit_prover import CircuitProver
from .dcap_prover import DcapProver
from .chain_provers import CertChainProver, QuoteProver
