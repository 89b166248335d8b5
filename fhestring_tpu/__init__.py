"""fhestring_tpu: a TFHE encrypted-string framework in JAX.

A from-scratch rebuild of the capabilities of MakisChristou/fhestring
(Rust + tfhe-rs) as a JAX/XLA stack: characters are encrypted per-8-bit-char
as 4x 2-bit shortint radix blocks; every string method lowers to batched
programmable bootstraps whose negacyclic polynomial products run as exact
integer contractions on the accelerator (crypto/pbs.py).
"""

from .params import (  # noqa: F401
    PARAM_MESSAGE_2_CARRY_2_KS_PBS_64,
    PARAM_PROD,
    PARAM_TEST_NOISY,
    PARAM_TEST_ZERO_NOISE,
    CryptoParams,
)
from .ciphertext import (  # noqa: F401
    Comparison,
    FheChar,
    FheSplit,
    FheString,
    FheStrip,
    PublicParameters,
)

__version__ = "0.1.0"
