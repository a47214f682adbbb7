"""zkdcap_tpu_torch: the port of zkdcap_tpu to PyTorch and CUDA on Hopper.

Slice 1 is the KZG commitment engine: BN254 field arithmetic (``fields``),
G1 arithmetic (``curves``), the NTT and its ``Domain`` (``ntt``), the
Pippenger MSM (``msm``) and the dev SRS with KZG commitments (``commit``).
Slice 2 is the PLONK prover on top of it: polynomial utilities (``poly``),
the host transcripts (``transcript``), the BN254 pairing (``curves.pairing``),
SHPLONK (``commit.shplonk``), and ``plonk``: the constraint system,
``keygen``, ``create_proof`` and the host ``verify_proof``. Slice 3 is the
P-256 ECDSA prover service on the real k = 18 circuit: ``runtime.ECDSAProver``
(keygen with an artifact cache in the JAX package's file formats, proofs,
host verify) over copies of the host circuit stack (``chips``, ``circuits``,
``witness`` with its C++ evaluator in ``csrc_host/``, ``metrics``), and the
MSM's opt-in bitonic sorts (``utils.device_sort``). Slice 4 is the DCAP
k = 17 prover, ``runtime.DcapProver`` over the generic ``CircuitProver``,
with the SHA-256 and base64 chips, ``circuits.dcap`` and ``plonk.mock``, and
the flat radix-2 NTT (above 2^22, or under ``ZKDCAP_NO_FOUR_STEP``). Slice 8
adds the cert-chain and quote services, GWC (``commit.gwc``) and proof
checkpoints (``plonk.checkpoint``); slice 9 the EVM verifier (``evm``: the
Solidity generator, its subset compiler and the interpreter that executes
it), ``config`` and the prover CLI (``python -m zkdcap_tpu_torch.cli``). The JAX package
``zkdcap_tpu`` is the reference it is held against; this package imports
neither it nor JAX.

Entry points run on the card (``cuda``) unless the caller passes
``device="cpu"``; with no card and no explicit device they raise. On CUDA
tensors the seven hand-written kernels in ``csrc/`` run (built at first use
by ``_build``): the NTT pass (A), the MSM's mixed-add scan (B), complete
addition with select (C), the window join (D), the elementwise Montgomery
product (E), which every field product goes through, and the bitonic sort
(F) behind ``ZKDCAP_MSM_BITONIC=1`` and ``ZKDCAP_MSM_ROWSORT=1``, and the
flat NTT's radix-2 butterfly stage (G). On CPU
tensors their plain torch versions run.
"""
