"""Native (C++) runtime components.

- csprng: AES-128-CTR secure randomness for client-side key generation and
  encryption, replacing the reference's concrete-csprng/aes native deps
  (SURVEY.md section 2.3). Falls back to numpy's PCG64 (flagged
  non-secure) if no compiler is available.
- keygen: full TFHE keygen (secret keys, bootstrap key, keyswitch key) in
  C++/OpenMP — the production path for large parameter sets, where the
  NumPy oracle keygen takes ~70 s. Semantics match numpy_ref.keygen
  (binary keys, gadget-scaled GGSW/KSK encryptions); randomness is drawn
  from AES-CTR counter regions disjoint from the client's encryption
  stream.

Both libraries are built from the .cpp sources beside this file with g++
at first use, into ``build/`` here (listed in .gitignore), and rebuilt
when a source is newer than the library.
"""

from __future__ import annotations

import ctypes
import os
import secrets
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_HERE, "build")
_CSPRNG_SRC = os.path.join(_HERE, "csprng.cpp")
_KEYGEN_SRC = os.path.join(_HERE, "keygen.cpp")
_SO_PATH = os.path.join(BUILD_DIR, "libcsprng.so")
_KG_SO_PATH = os.path.join(BUILD_DIR, "libkeygen.so")
_LIB = None
_KG_LIB = None


def _compile(src: str, out: str, extra_groups) -> bool:
    """Build src into out with the first flag group g++ accepts.  Writes a
    per-process temporary and renames it, so concurrent builders (test
    workers) never load a half-written library."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    flags = ["-O3", "-shared", "-fPIC", "-std=c++17"]
    for extra in extra_groups:
        cmd = ["g++", *flags, *extra, src, "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True)
        except (subprocess.CalledProcessError, FileNotFoundError):
            continue
        os.replace(tmp, out)
        return True
    return False


def _stale(so_path: str, srcs) -> bool:
    """Rebuild when missing or older than any of its sources."""
    if not os.path.exists(so_path):
        return True
    so_m = os.path.getmtime(so_path)
    return any(os.path.getmtime(s) > so_m for s in srcs)


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    if _stale(_SO_PATH, (_CSPRNG_SRC,)):
        if not _compile(_CSPRNG_SRC, _SO_PATH, (["-maes", "-msse4.1"], [])):
            return None
    lib = ctypes.CDLL(_SO_PATH)
    lib.aes128_ctr_fill.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_uint64]
    lib.aes128_ctr_fill.restype = None
    lib.csprng_has_aesni.restype = ctypes.c_int
    _LIB = lib
    return lib


def _load_keygen():
    global _KG_LIB
    if _KG_LIB is not None:
        return _KG_LIB
    # keygen.cpp #includes csprng.cpp
    if _stale(_KG_SO_PATH, (_KEYGEN_SRC, _CSPRNG_SRC)):
        if not _compile(_KEYGEN_SRC, _KG_SO_PATH,
                        (["-maes", "-msse4.1", "-fopenmp"],
                         ["-maes", "-msse4.1"], ["-fopenmp"], [])):
            return None
    lib = ctypes.CDLL(_KG_SO_PATH)
    c = ctypes
    lib.tfhe_keygen.argtypes = [
        c.c_uint32, c.c_uint32, c.c_uint32, c.c_uint32, c.c_uint32,
        c.c_uint32, c.c_uint32, c.c_uint32, c.c_double, c.c_double,
        c.c_char_p, c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p]
    lib.tfhe_keygen.restype = None
    _KG_LIB = lib
    return lib


def keygen_available() -> bool:
    return _load_keygen() is not None


def keygen_native(params, key: bytes):
    """Native keygen: returns (SecretKeys, ServerKeys) like
    numpy_ref.keygen (same layouts, independent randomness).

    `key` is the client's 16-byte AES key; this draws from counter regions
    >= 2^32, disjoint from SecureRng's encryption stream (which counts up
    from 0).
    """
    lib = _load_keygen()
    if lib is None:
        raise RuntimeError("no C++ compiler available for native keygen")
    from ..numpy_ref import core as ref

    p = params
    assert p.q_bits == 64, "native keygen assumes the 64-bit torus"
    n, k, N, ell = (p.lwe_dimension, p.glwe_dimension, p.polynomial_size,
                    p.pbs_level)
    lwe_sk = np.zeros(n, dtype=np.int64)
    glwe_sk = np.zeros((k, N), dtype=np.int64)
    bsk = np.zeros((n, (k + 1) * ell, k + 1, N), dtype=np.uint64)
    ksk = np.zeros((k * N, p.ks_level, n + 1), dtype=np.uint64)
    assert len(key) == 16
    lib.tfhe_keygen(
        n, k, N, ell, p.pbs_base_log, p.ks_level, p.ks_base_log,
        p.torus_bits, float(p.lwe_noise_std), float(p.glwe_noise_std), key,
        lwe_sk.ctypes.data_as(ctypes.c_void_p),
        glwe_sk.ctypes.data_as(ctypes.c_void_p),
        bsk.ctypes.data_as(ctypes.c_void_p),
        ksk.ctypes.data_as(ctypes.c_void_p),
    )
    return ref.SecretKeys(p, lwe_sk, glwe_sk), ref.ServerKeys(p, bsk, ksk)


class SecureRng:
    """AES-CTR-backed RNG with the numpy Generator subset the crypto layer
    uses (integers, normal).  Deterministic given (key, counter) — useful
    for reproducible test vectors; pass key=None for a fresh random key."""

    def __init__(self, key: bytes | None = None, seed: int | None = None):
        if key is None:
            key = (secrets.token_bytes(16) if seed is None
                   else int(seed).to_bytes(16, "little", signed=False))
        assert len(key) == 16
        self._key = key
        self._counter = 0
        self._lib = _load()
        self._fallback = None
        if self._lib is None:
            self._fallback = np.random.default_rng(
                int.from_bytes(key, "little") & ((1 << 63) - 1))

    @property
    def is_secure(self) -> bool:
        return self._lib is not None

    def _bytes(self, n: int) -> np.ndarray:
        if self._lib is None:
            return self._fallback.integers(0, 256, size=n, dtype=np.uint8)
        out = np.empty(n, dtype=np.uint8)
        self._lib.aes128_ctr_fill(
            out.ctypes.data_as(ctypes.c_void_p), n, self._key, self._counter)
        self._counter += (n + 15) // 16
        return out

    def integers(self, low, high, size=None, dtype=np.int64):
        size = () if size is None else size
        n = int(np.prod(size)) if size else 1
        span = int(high) - int(low)
        raw = self._bytes(n * 8).view(np.uint64)
        if span & (span - 1) == 0:  # power of two: no modulo bias
            vals = (raw & np.uint64(span - 1)).astype(np.uint64)
        else:
            vals = raw % np.uint64(span)
        out = (vals.astype(np.uint64) + np.uint64(low)).astype(dtype)
        return out.reshape(size) if size else dtype(out[0])

    def normal(self, loc=0.0, scale=1.0, size=None):
        size = () if size is None else size
        n = int(np.prod(size)) if size else 1
        m = n + (n & 1)
        u = self._bytes(m * 8).view(np.uint64)
        # uniforms in (0, 1]
        u01 = (u.astype(np.float64) + 1.0) / 2.0**64
        u1, u2 = u01[: m // 2], u01[m // 2:]
        r = np.sqrt(-2.0 * np.log(u1))
        z = np.concatenate([r * np.cos(2 * np.pi * u2),
                            r * np.sin(2 * np.pi * u2)])[:n]
        out = loc + scale * z
        return out.reshape(size) if size else float(out[0])
