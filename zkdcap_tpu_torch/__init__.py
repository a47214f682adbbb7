"""zkdcap_tpu_torch: the port of zkdcap_tpu to PyTorch and CUDA on Hopper.

This slice holds the KZG commitment engine: BN254 field arithmetic
(``fields``), G1 arithmetic (``curves``), the NTT and its ``Domain``
(``ntt``), the Pippenger MSM (``msm``) and the dev SRS with KZG commitments
(``commit``). The JAX package ``zkdcap_tpu`` is the reference it is held
against; this package imports neither it nor JAX.

Entry points run on the card (``cuda``) unless the caller passes
``device="cpu"``; with no card and no explicit device they raise. On CUDA
tensors the four hand-written kernels in ``csrc/`` run (built at first use by
``_build``); on CPU tensors their plain torch versions run.
"""
