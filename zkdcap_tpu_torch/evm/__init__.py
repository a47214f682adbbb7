"""The EVM verifier: the Solidity generator (``solidity``), the compiler of its
Solidity subset (``solc``), the interpreter that executes the bytecode
(``interp``) and the calldata layout (``calldata``). Host code only; the
port's copy of ``zkdcap_tpu/evm/``, importing neither JAX nor that package."""
