from .p256_ecdsa import ECDSAInput, build_ecdsa_trace
