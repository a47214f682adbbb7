from .prover import ECDSAProver, SAMPLE_INPUT
