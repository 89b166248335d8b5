"""Client-side runtime: key generation, encryption, decryption (CPU).

API parity with the reference's MyClientKey (src/client_key.rs:30-106):
``from_params``, ``encrypt(string, padding)`` (appends ``padding`` NUL bytes,
rejects non-ASCII and embedded NULs), ``encrypt_no_padding``,
``encrypt_char``, ``decrypt`` (truncates at the first NUL),
``decrypt_char``, ``get_server_key``, ``get_public_parameters``.

All secret-key operations stay on the host CPU; only evaluation keys and
ciphertexts ever reach the accelerator.
"""

from __future__ import annotations

import numpy as np

from . import torus
from .ciphertext import FheChar, FheString, PublicParameters
from .crypto.keys import pack_server_keys
from .numpy_ref import core as ref
from .params import PARAM_PROD, CryptoParams
from .shortint import Blocks

NB = 4


class ClientKey:
    def __init__(self, params: CryptoParams = PARAM_PROD, seed: int | None = 0,
                 native_keygen: bool | None = None):
        """seed=None uses a fresh AES-CTR key (secure); an int seed gives a
        deterministic AES-CTR stream (tests/benchmarks).

        native_keygen: use the C++ keygen (native/keygen.cpp; ~70x faster
        at production parameters). Default: auto — native for production
        sizes (N >= 1024) when a compiler is available, NumPy otherwise.
        """
        from . import native
        from .native import SecureRng

        self.params = params
        self._rng = SecureRng(seed=seed)
        if native_keygen is None:
            native_keygen = (params.polynomial_size >= 1024
                             and native.keygen_available())
        if native_keygen:
            # Counter regions >= 2^32: disjoint from self._rng's encryption
            # stream, which counts up from 0 under the same key.
            self.secret, self._server_raw = native.keygen_native(
                params, self._rng._key)
        else:
            self.secret, self._server_raw = ref.keygen(params, self._rng)
        self.public_parameters = PublicParameters(num_blocks=params.num_blocks)

    @classmethod
    def from_params(cls, params: CryptoParams = PARAM_PROD,
                    seed: int | None = 0) -> "ClientKey":
        return cls(params, seed)

    def get_server_key(self, cache_path: str | None = None):
        """Pack the evaluation keys for the device, in the layout the
        platform's bootstrap path reads (crypto.pbs.bootstrap_path).

        cache_path: optional packed-key checkpoint (.npz). If it exists, the
        device-format keys are LOADED instead of re-packed — NTT-domain
        packing is host transforms over the whole bootstrap key, and
        without a cache every server process start pays it again. On a miss
        the packed keys are saved there after packing.
        """
        import os

        from .crypto.pbs import bootstrap_path
        from .server import ServerKey

        with_ntt = bootstrap_path(self.params).use_ntt
        if cache_path and os.path.exists(cache_path):
            from . import serialize

            srv = serialize.load_packed_server_key(cache_path)
            if srv.params != self.params:
                raise ValueError(
                    f"packed-key cache {cache_path!r} was created for "
                    f"parameter set {srv.params.name!r}, not "
                    f"{self.params.name!r}")
            if not with_ntt or srv.backend.sc.keys.bsk_ntt is not None:
                return srv
            # Cache was packed without the NTT-domain key (e.g. on CPU);
            # repack with it and overwrite the checkpoint.
        srv = ServerKey(
            pack_server_keys(self._server_raw, with_ntt=with_ntt),
            self.params)
        if cache_path:
            from . import serialize

            serialize.save_packed_server_key(cache_path, srv)
        return srv

    def get_public_parameters(self) -> PublicParameters:
        return self.public_parameters

    def get_public_key(self, zero_count: int | None = None):
        """LWE public key: encryptions of zero enabling encryption WITHOUT
        the secret key (numpy_ref.public_encrypt).

        Functional parity with the tfhe-rs PublicKey the reference
        constructs and threads through PublicParameters but never actually
        uses (reference src/client_key.rs:32, fheasciichar.rs:22 — every
        server-side constant is a trivial encryption instead). At the LHL-
        secure zero_count the key is multi-GB at production parameters —
        the same tradeoff that made the reference leave its copy unused —
        so it is built on demand rather than carried in PublicParameters.
        """
        return ref.public_keygen(self.secret, self._rng,
                                 zero_count=zero_count)

    def encrypt_with_public_key(self, pk, string: str,
                                padding: int = 1) -> FheString:
        """Public-key string encryption (NUL-padding protocol as encrypt)."""
        self._check_ascii(string)
        data = string.encode("ascii") + b"\0" * padding
        p = self.params
        n_ct = p.big_lwe_dimension + 1
        out = np.zeros((len(data), NB, n_ct), dtype=np.uint64)
        for i, byte in enumerate(data):
            for b in range(NB):
                out[i, b] = ref.public_encrypt(pk, (byte >> (2 * b)) & 3,
                                               self._rng)
        return FheString(Blocks(torus.from_numpy(out), 3, 1.0))

    # ---- encryption ---------------------------------------------------------
    def _encrypt_bytes(self, data: bytes) -> Blocks:
        """Encrypt bytes as [len, 4, kN+1] block tensor."""
        p = self.params
        n_ct = p.big_lwe_dimension + 1
        out = np.zeros((len(data), NB, n_ct), dtype=np.uint64)
        for i, byte in enumerate(data):
            for b in range(NB):
                val = (byte >> (2 * b)) & 3
                out[i, b] = ref.lwe_encrypt_raw(
                    self.secret.big_lwe_sk, ref.encode(val, p), p.glwe_noise_std,
                    self._rng, p.torus_bits)
        return Blocks(torus.from_numpy(out), 3, 1.0)

    @staticmethod
    def _check_ascii(string: str) -> None:
        # reference client_key.rs:52-55 input validation
        assert all(ord(c) < 128 and c != "\0" for c in string), (
            "The input string must only contain ascii letters and not "
            "include null characters"
        )

    def encrypt(self, string: str, padding: int = 1) -> FheString:
        """Encrypt with NUL padding appended (reference client_key.rs:45-65)."""
        self._check_ascii(string)
        data = string.encode("ascii") + b"\0" * padding
        return FheString(self._encrypt_bytes(data))

    def encrypt_no_padding(self, string: str) -> FheString:
        """Unpadded encryption, used for patterns (client_key.rs:67-79)."""
        self._check_ascii(string)
        return FheString(self._encrypt_bytes(string.encode("ascii")))

    def encrypt_char(self, value: int) -> FheChar:
        blocks = self._encrypt_bytes(bytes([value]))
        from .torus import U64

        ct = U64(blocks.ct.lo[0], blocks.ct.hi[0])
        return FheChar(Blocks(ct, 3, 1.0))

    # ---- decryption ---------------------------------------------------------
    def _decrypt_block_values(self, blocks: Blocks) -> np.ndarray:
        p = self.params
        cts = torus.to_numpy(blocks.ct)  # [..., kN+1]
        sk = self.secret.big_lwe_sk.astype(np.uint64)
        phase = cts[..., -1] - (cts[..., :-1] * sk).sum(axis=-1, dtype=np.uint64)
        decoded = ((phase + np.uint64(p.delta // 2)) // np.uint64(p.delta)) % np.uint64(
            p.full_space
        )
        return (decoded % np.uint64(p.plaintext_space)).astype(np.int64)

    def decrypt_blocks_to_bytes(self, blocks: Blocks) -> np.ndarray:
        """[..., 4] block tensor -> [...] uint8 values."""
        vals = self._decrypt_block_values(blocks)  # [..., 4]
        out = np.zeros(vals.shape[:-1], dtype=np.int64)
        for b in range(NB):
            out += (vals[..., b] % 4) << (2 * b)
        return (out % 256).astype(np.uint8)

    def decrypt_bits(self, bits: Blocks) -> np.ndarray:
        """Decrypt bit-valued blocks (no block axis) to a 0/1 array."""
        return self._decrypt_block_values(bits).astype(np.uint8)

    def decrypt_char(self, c: FheChar) -> int:
        return int(self.decrypt_blocks_to_bytes(c.blocks))

    def decrypt_split(self, split) -> tuple[list[str], int]:
        """FheSplit -> (buffer strings, pattern_found), mirroring
        FheSplit::decrypt (reference fhesplit.rs:29-40)."""
        grid = self.decrypt_blocks_to_bytes(split.buffers)  # [n_buf, L]
        out = []
        for row in grid:
            chars = bytearray()
            for byte in row:
                if byte == 0:
                    break
                chars.append(int(byte))
            out.append(chars.decode("ascii"))
        return out, self.decrypt_char(split.pattern_found)

    def decrypt_strip(self, strip) -> tuple[str, int]:
        """FheStrip -> (string, flag) (reference fhestrip.rs:18-23)."""
        return self.decrypt(strip.string), self.decrypt_char(strip.pattern_found)

    def decrypt(self, s: FheString) -> str:
        """Decrypt and truncate at the first NUL (client_key.rs:89-106)."""
        if len(s) == 0:
            return ""
        data = self.decrypt_blocks_to_bytes(s.blocks)
        out = bytearray()
        for byte in data:
            if byte == 0:
                break
            out.append(int(byte))
        return out.decode("ascii")
