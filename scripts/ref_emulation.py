"""Reference-pipeline emulation: CGGI and KMS in the reference's OWN
arithmetic (SURVEY.md section 4b stand-in; round-4 verdict item 4).

The Julia reference cannot run in this image, so this script ports its
pipeline SEMANTICS to numpy and Monte-Carlos gate bootstraps:

* ring multiplication through a Float64 twisted FFT with the trunc-to-
  torus fold (fft.jl:47-81,105-210; arithmetic.jl:1-17) -- including the
  precision loss the reference accepts on the 2^64 KMS torus, where
  Float64's 53-bit mantissa cannot carry 64-bit coefficients exactly;
* keygen in exact integer arithmetic (standing in for the reference's
  Float64x2 keygen transforms, scheme.jl:154-155 -- MultiFloats are
  exact for these magnitudes);
* the reference's balanced/unbalanced digit decompositions
  (gsw.jl:34-64), CGGI16 blind rotation (bootstrapping.jl:32-76), KMS
  two-phase rotation (bootstrapping.jl:369-558), digit-value-table /
  per-party key switches (bootstrapping.jl:81-109,564-594), and gate
  affine + modswitch (gate.jl:1-8, bootstrapping.jl:8-23).

Output: decrypt success counts and phase-error statistics per preset --
directly comparable with this framework's exact-CRT measurements
(margins.json / NOISE.md).  Agreement of decrypt behaviour and noise
stddev between the two pipelines is the ciphertext-level anchor the
missing Julia runtime would otherwise provide; the emulation's only
liberty is numpy's pocketfft standing in for the hand-unrolled radix
kernels (equal-or-smaller rounding error).

The CCS scheme has its own dedicated emulation (ccs_ref_emulation.py).

Usage: python scripts/ref_emulation.py cggi [n_gates] [batch]
       python scripts/ref_emulation.py kms[k] [n_gates] [batch]
       python scripts/ref_emulation.py tiny-kms   (pytest marker entry)
"""

import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")

from mktfhe.schemes.presets import ALL_PRESETS  # noqa: E402

U32 = np.uint32
U64 = np.uint64
MOD32 = 2.0**32
MOD64 = 2.0**64


# ─── Float64 twisted-FFT rings (fft.jl semantics) ────────────────────────


class F64Ring:
    """Float64 negacyclic multiplication on a 2^bits torus.

    fwd: signed-center the coefficients, fold N reals into N/2 complex
    with the psi-twist (fft.jl:47-54), pocketfft.  inv: inverse + the
    reference's `native` fold (arithmetic.jl:1-17).  At bits=64 the f64
    mantissa cannot represent the low bits -- exactly the precision
    compromise the reference's README admits.
    """

    def __init__(self, n, bits):
        self.n = n
        self.bits = bits
        self.mod = 2.0**bits
        self.half = 1 << (bits - 1)
        self.udtype = U32 if bits == 32 else U64
        m = n // 2
        self.m = m
        j = np.arange(m)
        self.w = np.exp(1j * np.pi * j / n) * np.exp(1j * np.pi * j / m)
        self.winv = np.exp(-1j * np.pi * j / m) * np.exp(-1j * np.pi * j / n)

    def fwd(self, u):
        s = u.astype(np.int64) if self.bits == 32 else u.view(np.int64)
        if self.bits == 32:
            s = np.where(s >= 1 << 31, s - (1 << 32), s)
        s = s.astype(np.float64)
        c = (s[..., : self.m] - 1j * s[..., self.m :]) * self.w
        return np.fft.fft(c, axis=-1)

    def fwd_signed(self, d):
        """Signed int digits (already centered) -> eval domain."""
        s = d.astype(np.float64)
        c = (s[..., : self.m] - 1j * s[..., self.m :]) * self.w
        return np.fft.fft(c, axis=-1)

    def inv(self, f):
        z = np.fft.ifft(f, axis=-1) * self.winv
        return np.concatenate(
            [self._native(z.real), self._native(-z.imag)], axis=-1
        )

    def _native(self, x):
        # native(): x mod 2^bits, trunc to unsigned (arithmetic.jl:1-17)
        x = x - np.floor(x * (1.0 / self.mod)) * self.mod
        x = np.where(x >= self.mod, x - self.mod, x)
        if self.bits == 32:
            return np.floor(x).astype(np.int64).astype(U32)
        # float64 -> uint64 via high/low split (values up to 2^64)
        hi = np.floor(x * 2.0**-32)
        lo = np.floor(x - hi * MOD32)
        return (hi.astype(np.int64).astype(U64) << U64(32)) + lo.astype(
            np.int64
        ).astype(U64)


def negacyclic_exact(a, key, udtype=None):
    """Exact negacyclic a*key mod 2^bits (key in {-1,0,1}) via wrapping
    unsigned shifts-and-adds; stands in for the Float64x2 keygen
    transforms.  Works batched over leading axes of a."""
    n = a.shape[-1]
    out = np.zeros_like(a)
    for i in np.nonzero(key)[0]:
        kv = int(key[i])
        if i == 0:
            if kv == 1:
                out += a
            else:
                out -= a
        elif kv == 1:
            out[..., i:] += a[..., : n - i]
            out[..., :i] -= a[..., n - i :]
        else:
            out[..., i:] -= a[..., : n - i]
            out[..., :i] += a[..., n - i :]
    return out


def gauss(rng, sigma, shape, udtype):
    return np.rint(rng.normal(0.0, sigma, shape)).astype(np.int64).astype(udtype)


def balanced_decomp_ref(a, l, log_b, bits):
    """decompto! (gsw.jl:42-64,86-96) -> [l, ...] int64 digits, most-
    significant first."""
    ud = a.dtype.type
    mask = ud((1 << log_b) - 1)
    half = ud(1 << (log_b - 1))
    low = bits - l * log_b
    if low > 0:
        carry = (a << ud(bits - low)) >> ud(bits - 1)
        ai = (a >> ud(low)) + carry
    else:
        ai = a.copy()
    digs = [None] * l
    for j in range(l - 1, 0, -1):
        d = ai & mask
        ai >>= ud(log_b)
        ai += d >> ud(log_b - 1)
        digs[j] = d.astype(np.int64) - (((d & half) > 0) << np.int64(log_b))
    d = ai & mask
    digs[0] = d.astype(np.int64) - (((d & half) > 0) << np.int64(log_b))
    return np.stack(digs)


def unbalanced_decomp_ref(a, l, log_b, bits):
    ud = a.dtype.type
    low = bits - l * log_b
    if low > 0:
        carry = (a << ud(bits - low)) >> ud(bits - 1)
        ai = (a >> ud(low)) + carry
    else:
        ai = a.copy()
    mask = ud((1 << log_b) - 1)
    digs = [None] * l
    for j in range(l - 1, -1, -1):
        digs[j] = ai & mask
        ai >>= ud(log_b)
    return np.stack(digs)


def divbits(x, bit, bits):
    """Round-to-nearest shift (arithmetic.jl:23-27)."""
    ud = x.dtype.type
    carry = (x << ud(bits - bit)) >> ud(bits - 1)
    return (x >> ud(bit)) + carry


def testvector(tilde_b, n_ring, udtype, bits):
    """-1/8 test polynomial rotated by X^tilde_b (bootstrapping.jl:11-23)."""
    g = tilde_b.shape[0]
    eighth = 1 << (bits - 3)
    base = np.full(n_ring, -eighth, dtype=object)
    acc_b = np.zeros((g, n_ring), dtype=udtype)
    mod = 1 << bits
    for gi in range(g):
        tb = int(tilde_b[gi]) % (2 * n_ring)
        r = tb % n_ring
        rolled = np.concatenate([-base[n_ring - r :], base[: n_ring - r]]) if r else base.copy()
        if tb >= n_ring:
            rolled = -rolled
        acc_b[gi] = np.vectorize(lambda v: v % mod, otypes=[udtype])(rolled)
    return acc_b


# ─── CGGI (single key, u32 torus) ────────────────────────────────────────


class CggiEmu:
    """setup + BootKey_bin (scheme.jl:151-166, keygen.jl:7-26)."""

    def __init__(self, rng, params):
        self.p = params
        n, N, l, log_b = params.n, params.big_n, params.l_gsw, params.log_b_gsw
        self.lwe_key = rng.integers(0, 2, n).astype(U32)
        self.ring_key = rng.integers(0, 2, N).astype(np.int64)
        gvec = (U32(1) << np.array(
            [32 - (i + 1) * log_b for i in range(l)], dtype=U32))
        # brk[i] = RGSW(s_i): rows (c in {b,a}, j in [l]); each an RLWE
        # sample (b = -s*a + e) with s_i * gvec[j] added on component c.
        a_all = rng.integers(0, MOD32, (n, 2, l, N), dtype=np.int64).astype(U32)
        b_all = (negacyclic_exact(a_all, -self.ring_key)
                 + gauss(rng, params.beta, (n, 2, l, N), U32))
        sel = self.lwe_key.astype(bool)
        b_all[sel, 0, :, 0] += gvec[None, :]  # message on coeff 0, b-rows
        a_all[sel, 1, :, 0] += gvec[None, :]  # a-rows carry it on a
        self.brk = np.stack([b_all, a_all], axis=3)  # [i, cin, j, (b,a), N]
        # ksk table [D-1, N, f] of LEVs of j * ringkey-coeff (keygen.jl:17-23)
        f, log_d = params.f, params.log_d
        dmax = (1 << log_d) - 1
        kg = (U32(1) << np.array(
            [32 - (i + 1) * log_d for i in range(f)], dtype=U32))
        self.ksk_a = rng.integers(
            0, MOD32, (dmax, N, f, n), dtype=np.int64).astype(U32)
        msg = (np.arange(1, dmax + 1, dtype=U64)[:, None, None]
               * self.ring_key.astype(U64)[None, :, None]
               * kg.astype(U64)[None, None, :])
        asum = (self.ksk_a.astype(U64)
                * self.lwe_key.astype(U64)[None, None, None, :]).sum(axis=-1)
        self.ksk_b = (msg - asum
                      + gauss(rng, params.alpha, (dmax, N, f), U32).astype(U64)
                      ).astype(U32)

    def bootstrap(self, bb, aa, ring):
        """NAND-affine input -> bootstrapped LWE (bootstrapping.jl:4-27)."""
        p = self.p
        N, l, log_b = p.big_n, p.l_gsw, p.log_b_gsw
        g = bb.shape[0]
        logN = N.bit_length() - 1
        shift = 32 - logN - 1
        tilde_b = divbits(bb, shift, 32) & U32(2 * N - 1)
        tilde_a = (divbits(aa, shift, 32) & U32(2 * N - 1)).astype(np.int64)
        acc_b = testvector(tilde_b, N, U32, 32)
        acc_a = np.zeros((g, N), dtype=U32)
        tbrk = ring.fwd(self.brk)  # [n, 2, l, 2, M]
        for i in range(p.n):
            t = tilde_a[:, i]  # [g]
            bd = balanced_decomp_ref(acc_b, l, log_b, 32)  # [l, g, N]
            ad = balanced_decomp_ref(acc_a, l, log_b, 32)
            tb = ring.fwd_signed(bd)
            ta = ring.fwd_signed(ad)
            tacc = (np.einsum("lgm,lcm->gcm", tb, tbrk[i, 0])
                    + np.einsum("lgm,lcm->gcm", ta, tbrk[i, 1]))
            # monomial (X^t - 1); t == 0 contributes zero
            monop = np.zeros((g, N), dtype=np.int64)
            for gi in range(g):
                tt = int(t[gi])
                if tt == 0:
                    continue
                monop[gi, 0] -= 1
                if tt < N:
                    monop[gi, tt] += 1
                elif tt == N:
                    monop[gi, 0] -= 1
                else:
                    monop[gi, tt - N] -= 1
            mono = ring.fwd_signed(monop)
            d = ring.inv(tacc * mono[:, None])  # [g, 2, N]
            acc_b = acc_b + d[:, 0]
            acc_a = acc_a + d[:, 1]
        # key switch (bootstrapping.jl:81-109)
        f, log_d = p.f, p.log_d
        res_b = acc_b[:, 0].copy()
        coeffs = np.concatenate(
            [acc_a[:, :1], (-(acc_a[:, 1:][:, ::-1].astype(np.int64))).astype(U32)],
            axis=-1,
        )
        digs = unbalanced_decomp_ref(coeffs, f, log_d, 32)  # [f, g, N]
        res_a = np.zeros((g, p.n), dtype=U32)
        for dv in range(1, 1 << log_d):
            m = digs == dv
            res_b += np.einsum(
                "fgN,Nf->g", m.astype(U64), self.ksk_b[dv - 1].astype(U64)
            ).astype(U32)
            res_a += np.einsum(
                "fgN,Nfn->gn", m.astype(U64), self.ksk_a[dv - 1].astype(U64)
            ).astype(U32)
        return res_b, res_a


# ─── LMSS (single key, block-binary secrets, u32 torus) ──────────────────


class LmssEmu:
    """setup + BootKey_block (scheme.jl:190-205, keygen.jl:29-55)."""

    def __init__(self, rng, params):
        self.p = params
        d, ell = params.d, params.ell
        n, N, l, log_b = params.n, params.big_n, params.l_gsw, params.log_b_gsw
        # block-binary secret: <= 1 one per block (sampler.jl:7-22)
        pos = rng.integers(0, ell + 1, d)
        key = np.zeros(n, dtype=U32)
        for bi in range(d):
            if pos[bi] > 0:
                key[bi * ell + pos[bi] - 1] = 1
        self.lwe_key = key
        # partial ring key: first n coefficients ARE the LWE key
        # (key.jl:52-88)
        rk = rng.integers(0, 2, N).astype(np.int64)
        rk[:n] = key
        self.ring_key = rk
        gvec = (U32(1) << np.array(
            [32 - (i + 1) * log_b for i in range(l)], dtype=U32))
        a_all = rng.integers(0, MOD32, (n, 2, l, N), dtype=np.int64).astype(U32)
        b_all = (negacyclic_exact(a_all, -self.ring_key)
                 + gauss(rng, params.beta, (n, 2, l, N), U32))
        sel = key.astype(bool)
        b_all[sel, 0, :, 0] += gvec[None, :]
        a_all[sel, 1, :, 0] += gvec[None, :]
        self.brk = np.stack([b_all, a_all], axis=3)
        # ksk: balanced digit-value table for TAIL ring coefficients only
        # (rows > n pass for free; keygen.jl:29-55), D/2 digit values
        f, log_d = params.f, params.log_d
        dmax = (1 << log_d) // 2
        kg = (U32(1) << np.array(
            [32 - (i + 1) * log_d for i in range(f)], dtype=U32))
        tail = rk[n:]
        self.ksk_a = rng.integers(
            0, MOD32, (dmax, N - n, f, n), dtype=np.int64).astype(U32)
        msg = (np.arange(1, dmax + 1, dtype=U64)[:, None, None]
               * tail.astype(U64)[None, :, None]
               * kg.astype(U64)[None, None, :])
        asum = (self.ksk_a.astype(U64)
                * key.astype(U64)[None, None, None, :]).sum(axis=-1)
        self.ksk_b = (msg - asum
                      + gauss(rng, params.alpha, (dmax, N - n, f), U32).astype(U64)
                      ).astype(U32)

    def bootstrap(self, bb, aa, ring):
        """Block rotation (bootstrapping.jl:114-165) + partial key switch
        (:170-229)."""
        p = self.p
        N, l, log_b = p.big_n, p.l_gsw, p.log_b_gsw
        d, ell, n = p.d, p.ell, p.n
        g = bb.shape[0]
        logN = N.bit_length() - 1
        shift = 32 - logN - 1
        tilde_b = divbits(bb, shift, 32) & U32(2 * N - 1)
        tilde_a = (divbits(aa, shift, 32) & U32(2 * N - 1)).astype(np.int64)
        tilde_a = tilde_a.reshape(g, d, ell)
        acc_b = testvector(tilde_b, N, U32, 32)
        acc_a = np.zeros((g, N), dtype=U32)
        tbrk = ring.fwd(self.brk).reshape(d, ell, 2, l, 2, ring.m)
        for bi in range(d):
            bd = balanced_decomp_ref(acc_b, l, log_b, 32)
            ad = balanced_decomp_ref(acc_a, l, log_b, 32)
            tb = ring.fwd_signed(bd)
            ta = ring.fwd_signed(ad)
            tacc2 = np.zeros((g, 2, ring.m), dtype=np.complex128)
            for m in range(ell):
                t = tilde_a[:, bi, m]
                eh = (np.einsum("lgm,lcm->gcm", tb, tbrk[bi, m, 0])
                      + np.einsum("lgm,lcm->gcm", ta, tbrk[bi, m, 1]))
                monop = np.zeros((g, N), dtype=np.int64)
                for gi in range(g):
                    tt = int(t[gi])
                    if tt == 0:
                        continue
                    monop[gi, 0] -= 1
                    if tt < N:
                        monop[gi, tt] += 1
                    elif tt == N:
                        monop[gi, 0] -= 1
                    else:
                        monop[gi, tt - N] -= 1
                mono = ring.fwd_signed(monop)
                tacc2 = tacc2 + eh * mono[:, None]
            dacc = ring.inv(tacc2)
            acc_b = acc_b + dacc[:, 0]
            acc_a = acc_a + dacc[:, 1]
        # partial key switch: coefficients < n pass free, tail through the
        # balanced digit-value table
        f, log_d = p.f, p.log_d
        dmax = (1 << log_d) // 2
        res_b = acc_b[:, 0].copy()
        coeffs = np.concatenate(
            [acc_a[:, :1], (-(acc_a[:, 1:][:, ::-1].astype(np.int64))).astype(U32)],
            axis=-1,
        )  # [g, N]
        res_a = coeffs[:, :n].copy()
        digs = balanced_decomp_ref(coeffs[:, n:], f, log_d, 32)  # [f,g,N-n] signed
        for dv in range(1, dmax + 1):
            mp = (digs == dv).astype(np.int64)
            mm = (digs == -dv).astype(np.int64)
            mdiff = (mp - mm).transpose(1, 2, 0)  # [g, N-n, f]
            res_b += np.einsum(
                "gNf,Nf->g", mdiff, self.ksk_b[dv - 1].astype(np.int64)
            ).astype(U32)
            res_a += np.einsum(
                "gNf,Nfn->gn", mdiff, self.ksk_a[dv - 1].astype(np.int64)
            ).astype(U32)
        return res_b, res_a


def run_lmss(n_gates, batch, seed=0):
    params = ALL_PRESETS["Block"]
    p = params
    rng = np.random.default_rng(seed)
    ring = F64Ring(p.big_n, 32)
    t0 = time.time()
    emu = LmssEmu(rng, p)
    keygen_s = time.time() - t0
    errs = []
    oks = 0
    total = 0
    t0 = time.time()
    for _ in range(max(1, n_gates // batch)):
        g = batch
        m1 = rng.integers(0, 2, g).astype(bool)
        m2 = rng.integers(0, 2, g).astype(bool)
        want = ~(m1 & m2)

        def enc(m):
            av = rng.integers(0, MOD32, (g, p.n), dtype=np.int64).astype(U32)
            mu = (2 * m.astype(U64) - 1).astype(U32) << U32(29)
            bv = (gauss(rng, p.alpha, g, U32)
                  - (av.astype(U64)
                     * emu.lwe_key.astype(U64)[None]).sum(-1).astype(U32)
                  + mu)
            return bv, av

        b1, a1 = enc(m1)
        b2, a2 = enc(m2)
        bb = (U32(1) << U32(29)) - b1 - b2
        aa = (-(a1.astype(np.int64) + a2.astype(np.int64))).astype(U32)
        ob, oa = emu.bootstrap(bb, aa, ring)
        ph = (ob.astype(U64)
              + (oa.astype(U64) * emu.lwe_key.astype(U64)[None]).sum(-1))
        ph &= U64(0xFFFFFFFF)
        ideal = np.where(want, U64(1 << 29), U64((1 << 32) - (1 << 29)))
        err = (ph - ideal) & U64(0xFFFFFFFF)
        err = np.where(err >= 1 << 31, err.astype(np.int64) - (1 << 32),
                       err.astype(np.int64))
        errs.append(err)
        oks += int(((ph < U64(1 << 31)) == want).sum())
        total += g
        print(json.dumps({
            "batch_done": total,
            "std_bits": float(np.log2(np.concatenate(errs).std() + 1e-9)),
        }), flush=True)
    errs = np.concatenate(errs).astype(np.float64)
    std = errs.std()
    rec = {
        "pipeline": "reference-emulation-f64fft",
        "preset": "Block",
        "gates": total,
        "decrypt_ok": oks,
        "keygen_s": round(keygen_s, 1),
        "boot_s": round(time.time() - t0, 1),
        "std_bits": round(float(np.log2(std + 1e-9)), 2),
        "max_abs_bits": round(float(np.log2(np.abs(errs).max() + 1)), 2),
        "margin_sigmas": round(float(1 << 28) / std, 2) if std > 0 else None,
    }
    print(json.dumps(rec), flush=True)
    return rec


# ─── KMS (multi-key, u32 LWE / u64 ring, two-phase) ──────────────────────


class KmsPartyEmu:
    """party_keygen + BootKey_KMS (scheme.jl:273-287, keygen.jl:85-118)."""

    def __init__(self, rng, crs, params):
        p = params
        n, N = p.n, p.big_n
        self.lwe_key = rng.integers(0, 2, n).astype(U32)
        self.gsw_key = rng.integers(0, 2, N).astype(np.int64)
        self.uni_key = rng.integers(0, 2, N).astype(np.int64)
        lu, lbu = p.l_uni, p.log_b_uni
        guni = (U64(1) << np.array(
            [64 - (i + 1) * lbu for i in range(lu)], dtype=U64))
        # pub b = -uni*crs + e
        self.pub_b = np.stack([
            negacyclic_exact(crs[j], -self.uni_key, U64)
            + gauss(rng, p.beta, N, U64)
            for j in range(lu)
        ])
        # rlk = UniEnc(gsw_key) under uni_key (unienc.jl:36-75):
        # d[j] = r*crs[j] + e + gsw_key_poly * guni[j]; f[j] = RLWE(r*guni[j])
        r = rng.integers(-1, 2, N).astype(np.int64)  # ternary ephemeral
        self.rlk_d = np.stack([
            (negacyclic_exact(crs[j], r, U64)
             + gauss(rng, p.beta, N, U64)
             + (self.gsw_key.astype(U64) * guni[j]))
            for j in range(lu)
        ])
        self.rlk_f = np.zeros((lu, 2, N), dtype=U64)
        for j in range(lu):
            a = rng.integers(0, 1 << 63, N, dtype=np.int64).astype(U64)
            a = a << U64(1) | rng.integers(0, 2, N).astype(U64)
            b = (negacyclic_exact(a, -self.uni_key, U64)
                 + gauss(rng, p.beta, N, U64)
                 + (r.astype(U64) * guni[j]))
            self.rlk_f[j, 0] = b
            self.rlk_f[j, 1] = a
        # brk[i] = RGSW(s_i) under gsw_key (u64 ring)
        l, log_b = p.l_gsw, p.log_b_gsw
        ggsw = (U64(1) << np.array(
            [64 - (i + 1) * log_b for i in range(l)], dtype=U64))
        a_all = (rng.integers(0, 1 << 63, (n, 2, l, N), dtype=np.int64
                              ).astype(U64) << U64(1)
                 ) | rng.integers(0, 2, (n, 2, l, N)).astype(U64)
        b_all = (negacyclic_exact(a_all, -self.gsw_key)
                 + gauss(rng, p.beta, (n, 2, l, N), U64))
        sel = self.lwe_key.astype(bool)
        b_all[sel, 0, :, 0] += ggsw[None, :]  # message on coeff 0, b-rows
        a_all[sel, 1, :, 0] += ggsw[None, :]  # a-rows carry it on a
        self.brk = np.stack([b_all, a_all], axis=3)  # [i, cin, j, (b,a), N]
        # ksk encrypts uni_key coeffs on the u32 torus (keygen.jl:110-114)
        f, log_d = p.f, p.log_d
        dmax = (1 << log_d) - 1
        kg = (U32(1) << np.array(
            [32 - (i + 1) * log_d for i in range(f)], dtype=U32))
        self.ksk_a = rng.integers(
            0, MOD32, (dmax, N, f, n), dtype=np.int64).astype(U32)
        msg = (np.arange(1, dmax + 1, dtype=U64)[:, None, None]
               * self.uni_key.astype(U64)[None, :, None]
               * kg.astype(U64)[None, None, :])
        asum = (self.ksk_a.astype(U64)
                * self.lwe_key.astype(U64)[None, None, None, :]).sum(axis=-1)
        self.ksk_b = (msg - asum
                      + gauss(rng, p.alpha, (dmax, N, f), U32).astype(U64)
                      ).astype(U32)


def kms_phase1(tildea_p, party, iter_rows, ring, params):
    """Per-party single-key RLEV rotation (bootstrapping.jl:389-443)."""
    p = params
    N, l, log_b = p.big_n, p.l_gsw, p.log_b_gsw
    g = tildea_p.shape[0]
    glev = (U64(1) << np.array(
        [64 - (i + 1) * p.log_b_lev for i in range(p.l_lev)], dtype=U64))
    acc = np.zeros((g, iter_rows, 2, N), dtype=U64)
    acc[:, :, 0, 0] = glev[None, :iter_rows]
    tbrk = ring.fwd(party.brk)  # [n, 2, l, 2, M]
    for i in range(p.n):
        t = tildea_p[:, i]
        bd = balanced_decomp_ref(acc[:, :, 0], l, log_b, 64)  # [l,g,rows,N]
        ad = balanced_decomp_ref(acc[:, :, 1], l, log_b, 64)
        tb = ring.fwd_signed(bd)
        ta = ring.fwd_signed(ad)
        tacc = (np.einsum("lgrm,lcm->grcm", tb, tbrk[i, 0])
                + np.einsum("lgrm,lcm->grcm", ta, tbrk[i, 1]))
        monop = np.zeros((g, N), dtype=np.int64)
        for gi in range(g):
            tt = int(t[gi])
            if tt == 0:
                continue
            monop[gi, 0] -= 1
            if tt < N:
                monop[gi, tt] += 1
            elif tt == N:
                monop[gi, 0] -= 1
            else:
                monop[gi, tt - N] -= 1
        mono = ring.fwd_signed(monop)
        d = ring.inv(tacc * mono[:, None, None])
        acc = acc + d
    return acc  # [g, rows, 2, N] u64


def kms_phase2_party(acc, levkey, p1, party, parties, crs, ring, params):
    """One phase-2 merge step (bootstrapping.jl:448-558).

    acc: [g, k+1, N] u64 (component 0 = b); levkey [g, rows, 2, N].
    """
    p = params
    rows = levkey.shape[1]
    sl = acc[:, :p1]  # [g, p1, N]
    dig = balanced_decomp_ref(sl, p.l_lev, p.log_b_lev, 64)[:rows]  # [rows,g,p1,N]
    td = ring.fwd_signed(dig)
    tlev = ring.fwd(levkey)  # [g, rows, 2, M]
    x = np.einsum("rgpm,grm->gpm", td, tlev[:, :, 0])
    y = np.einsum("rgpm,grm->gpm", td, tlev[:, :, 1])
    y_t = ring.inv(y)  # [g, p1, N] u64
    # hybrid product with rlk
    yd = balanced_decomp_ref(y_t, p.l_uni, p.log_b_uni, 64)  # [lu,g,p1,N]
    tyd = ring.fwd_signed(yd)
    trd = ring.fwd(party.rlk_d)  # [lu, M]
    u = np.einsum("lgpm,lm->gpm", tyd, trd)
    tcrs = ring.fwd(crs)
    v0 = -np.einsum("lgm,lm->gm", tyd[:, :, 0], tcrs)
    v = v0
    if p1 > 1:
        pub_hat_t = ring.fwd(np.stack([pt.pub_b for pt in parties[: p1 - 1]]))
        v = v + np.einsum("lgpm,plm->gm", tyd[:, :, 1:], pub_hat_t)
    v_t = ring.inv(v)  # [g, N]
    vd = balanced_decomp_ref(v_t, p.l_uni, p.log_b_uni, 64)
    tvd = ring.fwd_signed(vd)
    trf = ring.fwd(party.rlk_f)  # [lu, 2, M]
    w_b = np.einsum("lgm,lm->gm", tvd, trf[:, 0])
    w_a = np.einsum("lgm,lm->gm", tvd, trf[:, 1])
    tx = x + u
    tx[:, 0] += w_b
    new = ring.inv(np.concatenate([tx, w_a[:, None]], axis=1))  # [g, p1+1, N]
    g = acc.shape[0]
    out = np.zeros_like(acc)
    out[:, : p1 + 1] = new
    return out


def run_kms(k, n_gates, batch, seed=0, preset=None):
    params = preset or ALL_PRESETS[f"KMS{k}party"]
    p = params
    n, N = p.n, p.big_n
    rng = np.random.default_rng(seed)
    ring = F64Ring(N, 64)
    crs = (rng.integers(0, 1 << 63, (p.l_uni, N), dtype=np.int64).astype(U64)
           << U64(1)) | rng.integers(0, 2, (p.l_uni, N)).astype(U64)
    t0 = time.time()
    parties = [KmsPartyEmu(rng, crs, p) for _ in range(p.k)]
    keygen_s = time.time() - t0

    errs = []
    oks = 0
    total = 0
    t0 = time.time()
    for _ in range(max(1, n_gates // batch)):
        g = batch
        m1 = rng.integers(0, 2, g).astype(bool)
        m2 = rng.integers(0, 2, g).astype(bool)
        want = ~(m1 & m2)

        def enc(m, pi):
            av = np.zeros((g, p.k * n), dtype=U32)
            seg = rng.integers(0, MOD32, (g, n), dtype=np.int64).astype(U32)
            av[:, pi * n : (pi + 1) * n] = seg
            mu = (2 * m.astype(U64) - 1).astype(U32) << U32(29)
            bv = (gauss(rng, p.alpha, g, U32)
                  - (seg.astype(U64)
                     * parties[pi].lwe_key.astype(U64)[None]).sum(-1).astype(U32)
                  + mu)
            return bv, av

        b1, a1 = enc(m1, 0)
        b2, a2 = enc(m2, 1)
        bb = (U32(1) << U32(29)) - b1 - b2
        aa = (-(a1.astype(np.int64) + a2.astype(np.int64))).astype(U32)
        # modswitch to 2N on the u32 LWE side
        logN = N.bit_length() - 1
        shift = 32 - logN - 1
        tilde_b = divbits(bb, shift, 32) & U32(2 * N - 1)
        tilde_a = (divbits(aa, shift, 32) & U32(2 * N - 1)).astype(np.int64)
        tilde_a = tilde_a.reshape(g, p.k, n)
        # phase 1 per party
        levkeys = [
            kms_phase1(tilde_a[:, i], parties[i],
                       1 if i == 0 else p.l_lev, ring, p)
            for i in range(p.k)
        ]
        # phase 2: init acc with the rotated test vector
        acc = np.zeros((g, p.k + 1, N), dtype=U64)
        acc[:, 0] = testvector(tilde_b, N, U64, 64)
        for p1 in range(1, p.k + 1):
            acc = kms_phase2_party(acc, levkeys[p1 - 1], p1,
                                   parties[p1 - 1], parties, crs, ring, p)
        # key switch: modswitch 64->32 then per-party table
        acc32 = (acc >> U64(32)).astype(U32)
        res_b = acc32[:, 0, 0].copy()
        res_a = np.zeros((g, p.k, n), dtype=U32)
        f, log_d = p.f, p.log_d
        for i in range(p.k):
            pt = parties[i]
            ai = acc32[:, i + 1]
            coeffs = np.concatenate(
                [ai[:, :1], (-(ai[:, 1:][:, ::-1].astype(np.int64))).astype(U32)],
                axis=-1,
            )
            digs = unbalanced_decomp_ref(coeffs, f, log_d, 32)
            for dv in range(1, 1 << log_d):
                msk = digs == dv
                res_b += np.einsum(
                    "fgN,Nf->g", msk.astype(U64), pt.ksk_b[dv - 1].astype(U64)
                ).astype(U32)
                res_a[:, i] += np.einsum(
                    "fgN,Nfn->gn", msk.astype(U64), pt.ksk_a[dv - 1].astype(U64)
                ).astype(U32)
        # phase + decrypt
        ph = res_b.astype(U64)
        for i in range(p.k):
            ph = ph + (res_a[:, i].astype(U64)
                       * parties[i].lwe_key.astype(U64)[None]).sum(-1)
        ph &= U64(0xFFFFFFFF)
        ideal = np.where(want, U64(1 << 29), U64((1 << 32) - (1 << 29)))
        err = (ph - ideal) & U64(0xFFFFFFFF)
        err = np.where(err >= 1 << 31, err.astype(np.int64) - (1 << 32),
                       err.astype(np.int64))
        errs.append(err)
        dec = ph < U64(1 << 31)
        oks += int((dec == want).sum())
        total += g
        print(json.dumps({
            "batch_done": total,
            "std_bits": float(np.log2(np.concatenate(errs).std() + 1e-9)),
        }), flush=True)

    errs = np.concatenate(errs).astype(np.float64)
    std = errs.std()
    rec = {
        "pipeline": "reference-emulation-f64fft",
        "preset": getattr(p, "name", None) or f"KMS{p.k}party",
        "gates": total,
        "decrypt_ok": oks,
        "keygen_s": round(keygen_s, 1),
        "boot_s": round(time.time() - t0, 1),
        "std_bits": round(float(np.log2(std + 1e-9)), 2),
        "max_abs_bits": round(float(np.log2(np.abs(errs).max() + 1)), 2),
        "margin_sigmas": round(float(1 << 28) / std, 2) if std > 0 else None,
    }
    print(json.dumps(rec), flush=True)
    return rec


def run_cggi(n_gates, batch, seed=0):
    params = ALL_PRESETS["CGGI"]
    p = params
    rng = np.random.default_rng(seed)
    ring = F64Ring(p.big_n, 32)
    t0 = time.time()
    emu = CggiEmu(rng, p)
    keygen_s = time.time() - t0
    errs = []
    oks = 0
    total = 0
    t0 = time.time()
    for _ in range(max(1, n_gates // batch)):
        g = batch
        m1 = rng.integers(0, 2, g).astype(bool)
        m2 = rng.integers(0, 2, g).astype(bool)
        want = ~(m1 & m2)

        def enc(m):
            av = rng.integers(0, MOD32, (g, p.n), dtype=np.int64).astype(U32)
            mu = (2 * m.astype(U64) - 1).astype(U32) << U32(29)
            bv = (gauss(rng, p.alpha, g, U32)
                  - (av.astype(U64)
                     * emu.lwe_key.astype(U64)[None]).sum(-1).astype(U32)
                  + mu)
            return bv, av

        b1, a1 = enc(m1)
        b2, a2 = enc(m2)
        bb = (U32(1) << U32(29)) - b1 - b2
        aa = (-(a1.astype(np.int64) + a2.astype(np.int64))).astype(U32)
        ob, oa = emu.bootstrap(bb, aa, ring)
        ph = (ob.astype(U64)
              + (oa.astype(U64) * emu.lwe_key.astype(U64)[None]).sum(-1))
        ph &= U64(0xFFFFFFFF)
        ideal = np.where(want, U64(1 << 29), U64((1 << 32) - (1 << 29)))
        err = (ph - ideal) & U64(0xFFFFFFFF)
        err = np.where(err >= 1 << 31, err.astype(np.int64) - (1 << 32),
                       err.astype(np.int64))
        errs.append(err)
        oks += int(((ph < U64(1 << 31)) == want).sum())
        total += g
        print(json.dumps({
            "batch_done": total,
            "std_bits": float(np.log2(np.concatenate(errs).std() + 1e-9)),
        }), flush=True)
    errs = np.concatenate(errs).astype(np.float64)
    std = errs.std()
    rec = {
        "pipeline": "reference-emulation-f64fft",
        "preset": "CGGI",
        "gates": total,
        "decrypt_ok": oks,
        "keygen_s": round(keygen_s, 1),
        "boot_s": round(time.time() - t0, 1),
        "std_bits": round(float(np.log2(std + 1e-9)), 2),
        "max_abs_bits": round(float(np.log2(np.abs(errs).max() + 1)), 2),
        "margin_sigmas": round(float(1 << 28) / std, 2) if std > 0 else None,
    }
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "cggi"
    n_gates = int(sys.argv[2]) if len(sys.argv) > 2 else 64
    batch = int(sys.argv[3]) if len(sys.argv) > 3 else 16
    if which == "cggi":
        run_cggi(n_gates, batch)
    elif which == "lmss":
        run_lmss(n_gates, batch)
    elif which.startswith("kms"):
        run_kms(int(which[3:]), n_gates, batch)
    elif which == "tiny-kms":
        from mktfhe.schemes.presets import TEST_PRESETS

        run_kms(2, 16, 16, preset=TEST_PRESETS["TinyKMS2partyN128"])
    else:
        raise SystemExit(f"unknown target {which}")
