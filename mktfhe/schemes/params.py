"""Parameter dataclasses for the four scheme families.

Counterpart of /root/reference/src/tfhe/scheme.jl:1-101 (the typed
parameter structs are the reference's de facto config schema).  The
type-parameter convention there -- T unsigned torus, R keygen-float,
S boot-float -- collapses to just the torus widths here, because the exact
CRT-NTT needs no float precision choices.

Each dataclass derives the CRT prime count from the worst contraction it
performs: every external/hybrid/LEV product reconstructs an integer bounded
by halfB * 2^(torus_bits-1) * N * nterms, which must stay below
prod(primes)/2 for Garner reconstruction to be exact
(mktfhe/ring/context.py:nprimes_needed).
"""

from __future__ import annotations

import dataclasses

from ..ring.context import nprimes_needed


@dataclasses.dataclass(frozen=True)
class CggiParams:
    """Single-key binary-secret params (TFHEparams_bin, scheme.jl:6-19)."""

    n: int  # LWE dimension
    alpha: float  # LWE noise stddev (absolute torus units)
    f: int  # key-switching gadget length
    log_d: int  # key-switching gadget base bits
    big_n: int  # RLWE dimension N
    k: int  # RLWE rank
    beta: float  # RLWE noise stddev
    l_gsw: int  # blind-rotation gadget length
    log_b_gsw: int  # blind-rotation gadget base bits
    torus_bits: int = 32

    @property
    def nprimes(self) -> int:
        return nprimes_needed(
            self.torus_bits,
            self.big_n,
            [(1 << (self.log_b_gsw - 1), self.l_gsw * (self.k + 1))],
        )


@dataclasses.dataclass(frozen=True)
class BlockParams:
    """Block-binary-secret params, LMSS23 (TFHEparams_block, scheme.jl:22-36).

    The blind rotation accumulates ell external products (each multiplied by
    a monomial X^a - 1, doubling the bound) in the evaluation domain before
    one reconstruction per block (bootstrapping.jl:129-164).
    """

    d: int  # number of blocks
    ell: int  # block length
    alpha: float
    f: int
    log_d: int
    big_n: int
    k: int
    beta: float
    l_gsw: int
    log_b_gsw: int
    torus_bits: int = 32

    @property
    def n(self) -> int:
        return self.d * self.ell

    @property
    def nprimes(self) -> int:
        return nprimes_needed(
            self.torus_bits,
            self.big_n,
            [(1 << (self.log_b_gsw - 1), self.l_gsw * (self.k + 1) * self.ell * 2)],
        )


@dataclasses.dataclass(frozen=True)
class CcsParams:
    """CCS19 multi-key params (CCSparams, scheme.jl:40-54); ring rank 1."""

    n: int
    alpha: float
    f: int
    log_d: int
    big_n: int
    beta: float
    l_uni: int
    log_b_uni: int
    k: int  # number of parties
    torus_bits: int = 32

    @property
    def nprimes(self) -> int:
        # hybrid product contracts l_uni digits over up to k+1 components
        return nprimes_needed(
            self.torus_bits,
            self.big_n,
            [(1 << (self.log_b_uni - 1), self.l_uni * (self.k + 1))],
        )


@dataclasses.dataclass(frozen=True)
class KmsParams:
    """KMS two-phase multi-key params (KMSparams, scheme.jl:57-77).

    Dual torus widths: uint32 LWE layer, uint64 RLWE layer.
    """

    n: int
    alpha: float
    f: int
    log_d: int
    big_n: int
    beta: float
    l_gsw: int
    log_b_gsw: int
    l_lev: int
    log_b_lev: int
    l_uni: int
    log_b_uni: int
    k: int
    lwe_torus_bits: int = 32
    ring_torus_bits: int = 64

    def _crt_terms(self):
        return [
            # phase 1: single-key external products on RLEV rows
            (1 << (self.log_b_gsw - 1), self.l_gsw * 2),
            # phase 2: LEV contraction over up to k components
            (1 << (self.log_b_lev - 1), self.l_lev * max(self.k, 1)),
            # phase 2: hybrid product over up to k components
            (1 << (self.log_b_uni - 1), self.l_uni * max(self.k, 1)),
        ]

    @property
    def ring_nprimes(self) -> int:
        return nprimes_needed(self.ring_torus_bits, self.big_n, self._crt_terms())


@dataclasses.dataclass(frozen=True)
class KmsBlockParams:
    """KMS with block-binary LWE secrets (KMSparams_block, scheme.jl:80-101)."""

    d: int
    ell: int
    alpha: float
    f: int
    log_d: int
    big_n: int
    beta: float
    l_gsw: int
    log_b_gsw: int
    l_lev: int
    log_b_lev: int
    l_uni: int
    log_b_uni: int
    k: int
    lwe_torus_bits: int = 32
    ring_torus_bits: int = 64

    @property
    def n(self) -> int:
        return self.d * self.ell

    def _crt_terms(self):
        return [
            # phase 1 accumulates ell monomial-weighted external products
            (1 << (self.log_b_gsw - 1), self.l_gsw * 2 * self.ell * 2),
            (1 << (self.log_b_lev - 1), self.l_lev * max(self.k, 1)),
            (1 << (self.log_b_uni - 1), self.l_uni * max(self.k, 1)),
        ]

    @property
    def ring_nprimes(self) -> int:
        return nprimes_needed(self.ring_torus_bits, self.big_n, self._crt_terms())
