"""Reference-pipeline emulation for the CCS k=2/4 marginality question.

Round-3 verdict item: the claim "the reference's published CCS2/4party
parameters are inherently ~2.5/1.8 sigma" (NOISE.md) rested on this
repo's exact-arithmetic implementation.  This script emulates the
REFERENCE'S OWN arithmetic pipeline in numpy -- Float64 twisted FFT
multiplication with the trunc-to-torus fold (fft.jl:47-81,105-210,
arithmetic.jl:1-9), its balanced digit decomposition (gsw.jl:42-64,
unienc.jl:4-18), the CCS hybrid-product blind rotation
(bootstrapping.jl:234-328), the digit-value-table key switch
(bootstrapping.jl:333-364, keygen.jl:74-79), ternary uni-encryption
ephemerals (unienc.jl:36-55), and exact (Float64x2-grade) keygen
arithmetic (integer convolution stands in for MultiFloat exactness) --
and Monte-Carlos NAND bootstraps at the published CCS presets.

The only liberty: numpy's pocketfft replaces the reference's hand-rolled
radix-2/8 Float64 FFT.  pocketfft's rounding error is equal or smaller,
so if margins still come out ~2.5/1.8 sigma the "inherent to the
parameters" claim holds a fortiori.

Usage: python scripts/ccs_ref_emulation.py [k] [n_gates] [batch]
       (defaults 2 256 32; writes a JSON line per batch + summary)
"""

import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")

from mktfhe.schemes.presets import ALL_PRESETS  # noqa: E402

U32 = np.uint32
MOD = 2.0**32


class F64Ring:
    """Float64 twisted-FFT negacyclic multiplication on the u32 torus,
    matching FFTransformer semantics (fft.jl:18-81)."""

    def __init__(self, n):
        self.n = n
        m = n // 2
        self.m = m
        j = np.arange(m)
        # fold twist (roots, fft.jl:39) * negacyclic twist for the
        # length-m complex negacyclic transform, realised via np.fft
        self.w = np.exp(1j * np.pi * j / n) * np.exp(1j * np.pi * j / m)
        self.winv = np.exp(-1j * np.pi * j / m) * np.exp(-1j * np.pi * j / n)

    def fwd(self, u):
        """u: [..., N] uint32 -> eval domain [..., N/2] complex128."""
        s = u.astype(np.int64)
        s = np.where(s >= 1 << 31, s - (1 << 32), s).astype(np.float64)
        c = (s[..., : self.m] - 1j * s[..., self.m :]) * self.w
        return np.fft.fft(c, axis=-1)

    def inv(self, f):
        """eval domain -> uint32 [..., N] via the reference's native()
        fold (floor-mod then trunc, arithmetic.jl:1-4)."""
        z = np.fft.ifft(f, axis=-1) * self.winv
        return np.concatenate(
            [self._native(z.real), self._native(-z.imag)], axis=-1
        )

    @staticmethod
    def _native(x):
        x = x - np.floor(x * 2.0**-32) * MOD
        x = np.where(x >= MOD, x - MOD, x)
        return np.floor(x).astype(np.int64).astype(U32)


def negacyclic_exact(a, key):
    """Exact integer negacyclic a*key mod 2^32 (key in {-1,0,1} or {0,1});
    stands in for the reference's Float64x2 keygen transforms."""
    n = a.shape[-1]
    c = np.convolve(a.astype(np.int64), key.astype(np.int64))
    res = np.zeros(n, dtype=np.int64)
    res[: n - 1] = -c[n : 2 * n - 1]
    res += c[:n]
    return res.astype(np.uint64).astype(U32)


def gauss(rng, sigma, shape):
    """unsigned(round(signed(T), gaussian(sigma))) (sampler.jl:24-28)."""
    return np.rint(rng.normal(0.0, sigma, shape)).astype(np.int64).astype(U32)


def balanced_decomp_ref(a, l, log_b):
    """decompto! (gsw.jl:86-96) on u32 arrays -> [l, ...] int64 digits,
    most-significant first (digit j weights gvec[j] = 2^(32-(j+1)log_b))."""
    mask = U32((1 << log_b) - 1)
    half = U32(1 << (log_b - 1))
    low = 32 - l * log_b
    carry = (a << U32(32 - low)) >> U32(31) if low > 0 else np.zeros_like(a)
    ai = (a >> U32(low)) + carry if low > 0 else a.copy()
    digs = [None] * l
    for j in range(l - 1, 0, -1):
        d = ai & mask
        ai >>= U32(log_b)
        ai += d >> U32(log_b - 1)
        digs[j] = (d.astype(np.int64)) - (((d & half) > 0) << np.int64(log_b))
    d = ai & mask
    digs[0] = (d.astype(np.int64)) - (((d & half) > 0) << np.int64(log_b))
    return np.stack(digs)


def unbalanced_decomp_ref(a, l, log_b):
    """unbalanceddecompto! (gsw.jl:34-40) -> [l, ...] uint32 digits."""
    low = 32 - l * log_b
    carry = (a << U32(32 - low)) >> U32(31) if low > 0 else np.zeros_like(a)
    ai = (a >> U32(low)) + carry if low > 0 else a.copy()
    mask = U32((1 << log_b) - 1)
    digs = [None] * l
    for j in range(l - 1, -1, -1):
        digs[j] = ai & mask
        ai >>= U32(log_b)
    return np.stack(digs)


class Party:
    """BootKey_CCS per party (keygen.jl:57-83) with exact keygen math."""

    def __init__(self, rng, crs, params):
        n, N = params.n, params.big_n
        l, log_b = params.l_uni, params.log_b_uni
        self.lwe_key = rng.integers(0, 2, n).astype(U32)
        self.ring_key = rng.integers(0, 2, N).astype(U32)  # binary_ringkey
        gvec = (U32(1) << np.array([32 - (i + 1) * log_b for i in range(l)], dtype=U32))

        # pub b = -s*a + e per CRS row (gen_b, unienc.jl:77-90)
        self.pub_b = np.stack([
            (negacyclic_exact(crs[i], -self.ring_key.astype(np.int64))
             + gauss(rng, params.beta, N))
            for i in range(l)
        ])
        # brk[i]: UniEnc of lwe key bit i with TERNARY ephemeral r
        # (unienc.jl:36-55)
        self.brk_d = np.zeros((n, l, N), dtype=U32)
        self.brk_f = np.zeros((n, l, 2, N), dtype=U32)  # RLEV: (b, a)
        for i in range(n):
            r = rng.integers(-1, 2, N).astype(np.int64)  # ternary
            for j in range(l):
                d = negacyclic_exact(crs[j], r) + gauss(rng, params.beta, N)
                if self.lwe_key[i]:
                    d[0] = U32(d[0] + gvec[j])  # wrapping add
                self.brk_d[i, j] = d
                # f stack j: RLWE(gvec[j]*r) under ring_key
                a = rng.integers(0, MOD, N, dtype=np.int64).astype(U32)
                b = (negacyclic_exact(a, -self.ring_key.astype(np.int64))
                     + gauss(rng, params.beta, N)
                     + (r.astype(np.uint64) * np.uint64(gvec[j])).astype(U32))
                self.brk_f[i, j, 0] = b
                self.brk_f[i, j, 1] = a
        # ksk digit-value table (keygen.jl:74-79): [D-1, N, f] LWEs
        f, log_d = params.f, params.log_d
        dmax = (1 << log_d) - 1
        kg = (U32(1) << np.array([32 - (i + 1) * log_d for i in range(f)], dtype=U32))
        self.ksk_b = np.zeros((dmax, N, f), dtype=U32)
        self.ksk_a = rng.integers(0, MOD, (dmax, N, f, n), dtype=np.int64).astype(U32)
        msg = (np.arange(1, dmax + 1, dtype=np.uint64)[:, None, None]
               * self.ring_key.astype(np.uint64)[None, :, None]
               * kg.astype(np.uint64)[None, None, :])
        noise = gauss(rng, params.alpha, (dmax, N, f))
        asum = (self.ksk_a.astype(np.uint64)
                * self.lwe_key.astype(np.uint64)[None, None, None, :]).sum(axis=-1)
        self.ksk_b = (msg - asum + noise.astype(np.uint64)).astype(U32)


def blind_rotate(tildea, acc_b, parties, tcrs, pub_hat_t, tmono, ring, params):
    """CCS hybrid-product rotation (bootstrapping.jl:234-328), batched
    over gates.  tildea: [g, k, n] int; acc_b: [g, N] u32 test vector.
    Returns (b [g,N], a [g,k,N]) u32."""
    g = acc_b.shape[0]
    k, n, N = params.k, params.n, params.big_n
    l, log_b = params.l_uni, params.log_b_uni
    b = acc_b.copy()
    a = np.zeros((g, k, N), dtype=U32)
    for idx in range(k):
        pt = parties[idx]
        tbrk_d = ring.fwd(pt.brk_d)  # [n, l, M] (per step row below)
        tbrk_f = ring.fwd(pt.brk_f)  # [n, l, 2, M]
        cnt = idx + 1  # a-components decomposed: parties 1..idx 1-based,
        # INCLUDING the current party's own accumulating component
        # (decomptoith!(avec, acc.a, idx), bootstrapping.jl:265)
        for i in range(n):
            t = tildea[:, idx, i]  # [g]
            bd = balanced_decomp_ref(b, l, log_b)  # [l, g, N]
            tb = ring.fwd(bd.astype(np.uint64).astype(U32))  # [l, g, M]
            u_b = np.einsum("lgm,lm->gm", tb, tbrk_d[i])
            tv0 = -np.einsum("lgm,lm->gm", tb, tcrs)
            ad = balanced_decomp_ref(a[:, :cnt], l, log_b)  # [l,g,cnt,N]
            ta = ring.fwd(ad.astype(np.uint64).astype(U32))
            u_a = np.einsum("lgjm,lm->gjm", ta, tbrk_d[i])
            tv = np.einsum("lgjm,jlm->gjm", ta, pub_hat_t[:cnt])
            v = ring.inv(np.concatenate([tv0[:, None], tv], axis=1))
            # re-decompose v (v0 + cnt rows) and contract against f
            vd = balanced_decomp_ref(v, l, log_b)  # [l, g, cnt+1, N]
            tvd = ring.fwd(vd.astype(np.uint64).astype(U32))
            w_b = np.einsum("lgjm,lm->gm", tvd, tbrk_f[i, :, 0])
            w_a = np.einsum("lgjm,lm->gm", tvd, tbrk_f[i, :, 1])
            # assemble tacc (b, a[0..idx]) and monomial-multiply
            tacc_b = u_b + w_b
            tacc_a = u_a
            tacc_a[:, idx] += w_a
            mono = tmono[t]  # [g, M] FFT of X^t - 1 (zero when t == 0)
            db = ring.inv(tacc_b * mono)
            da = ring.inv(tacc_a * mono[:, None])
            b += db
            a[:, :cnt] += da
    return b, a


def keyswitch(b, a, parties, params):
    """Digit-value-table key switch (bootstrapping.jl:333-364)."""
    g = b.shape[0]
    k, n, N = params.k, params.n, params.big_n
    f, log_d = params.f, params.log_d
    res_b = b[:, 0].copy()
    res_a = np.zeros((g, k, n), dtype=U32)
    for i in range(k):
        pt = parties[i]
        # extraction order: coeff 1 = a[0]; coeff j>=2 = -a[N-j+1]
        coeffs = np.concatenate(
            [a[:, i, :1], (-(a[:, i, 1:][:, ::-1].astype(np.int64))).astype(U32)],
            axis=-1,
        )  # [g, N]
        digs = unbalanced_decomp_ref(coeffs, f, log_d)  # [f, g, N]
        for d in range(1, 1 << log_d):
            m = digs == d  # [f, g, N]
            # ksk[d-1, coeff, level]
            res_b += np.einsum(
                "fgN,Nf->g", m.astype(np.uint64), pt.ksk_b[d - 1].astype(np.uint64)
            ).astype(U32)
            res_a[:, i] += np.einsum(
                "fgN,Nfn->gn", m.astype(np.uint64), pt.ksk_a[d - 1].astype(np.uint64)
            ).astype(U32)
    return res_b, res_a.reshape(g, k * n)


def run(k, n_gates, batch, seed=0):
    params = ALL_PRESETS[f"CCS{k}party"]
    n, N = params.n, params.big_n
    rng = np.random.default_rng(seed)
    ring = F64Ring(N)
    crs = rng.integers(0, MOD, (params.l_uni, N), dtype=np.int64).astype(U32)
    t0 = time.time()
    parties = [Party(rng, crs, params) for _ in range(k)]
    tcrs = ring.fwd(crs)
    pub_hat_t = ring.fwd(np.stack([p.pub_b for p in parties]))
    # monomial table: tmono[t] = FFT(X^t - 1), t in [0, 2N) (t=0 -> 0)
    monos = np.zeros((2 * N, N), dtype=np.int64)
    for t in range(1, 2 * N):
        monos[t, 0] -= 1
        if t < N:
            monos[t, t] += 1
        elif t > N:
            monos[t, t - N] -= 1
        else:
            monos[t, 0] -= 1
    tmono = ring.fwd(monos.astype(np.uint64).astype(U32))
    keygen_s = time.time() - t0

    errs = []
    oks = 0
    total = 0
    t0 = time.time()
    for _ in range(n_gates // batch):
        g = batch
        m1 = rng.integers(0, 2, g).astype(bool)
        m2 = rng.integers(0, 2, g).astype(bool)
        want = ~(m1 & m2)

        def enc(m, pi):
            av = np.zeros((g, k * n), dtype=U32)
            seg = rng.integers(0, MOD, (g, n), dtype=np.int64).astype(U32)
            av[:, pi * n : (pi + 1) * n] = seg
            mu = (2 * m.astype(np.uint64) - 1).astype(U32) << U32(29)
            bv = (gauss(rng, params.alpha, g)
                  - (seg.astype(np.uint64)
                     * parties[pi].lwe_key.astype(np.uint64)).sum(-1).astype(U32)
                  + mu)
            return bv, av

        b1, a1 = enc(m1, 0)
        b2, a2 = enc(m2, 1)
        # NAND affine (gate.jl:1-8)
        bb = (U32(1) << U32(29)) - b1 - b2
        aa = (-(a1.astype(np.int64) + a2.astype(np.int64))).astype(U32)
        # mod switch to 2N (bootstrapping.jl:8-9): divbits
        logN = N.bit_length() - 1
        shift = 32 - logN - 1

        def divbits(x):
            carry = (x << U32(32 - shift)) >> U32(31)
            return ((x >> U32(shift)) + carry) & U32(2 * N - 1)

        tilde_b = divbits(bb)
        tilde_a = divbits(aa).reshape(g, k, n).astype(np.int64)
        # test vector (bootstrapping.jl:11-23): X^tildeb * tv
        eighth = U32(1) << U32(29)
        base = np.full(N, -np.int64(eighth), dtype=np.int64)
        acc_b = np.zeros((g, N), dtype=U32)
        for gi in range(g):  # negacyclic roll by tilde_b
            tb = int(tilde_b[gi])
            rolled = np.concatenate([-base[N - (tb % N):], base[: N - (tb % N)]]
                                    if tb % N else [base])
            if (tb // N) % 2:
                rolled = -rolled
            acc_b[gi] = rolled.astype(np.uint64).astype(U32)
        rb, ra = blind_rotate(tilde_a, acc_b, parties, tcrs, pub_hat_t, tmono, ring, params)
        ob, oa = keyswitch(rb, ra, parties, params)

        # phase error vs ideal +-1/8 (utils/noise.py convention)
        ph = ob.astype(np.uint64)
        for i in range(k):
            ph = ph + (oa[:, i * n : (i + 1) * n].astype(np.uint64)
                       * parties[i].lwe_key.astype(np.uint64)).sum(-1)
        ph &= np.uint64(0xFFFFFFFF)
        ideal = np.where(want, np.uint64(1 << 29), np.uint64((1 << 32) - (1 << 29)))
        err = (ph - ideal) & np.uint64(0xFFFFFFFF)
        err = np.where(err >= 1 << 31, err.astype(np.int64) - (1 << 32),
                       err.astype(np.int64))
        errs.append(err)
        dec = ph < np.uint64(1 << 31)
        oks += int((dec == want).sum())
        total += g
        print(json.dumps({"batch_done": total, "std_bits": float(np.log2(np.concatenate(errs).std()))}), flush=True)

    errs = np.concatenate(errs).astype(np.float64)
    std = errs.std()
    margin = float(1 << 28)
    rec = {
        "pipeline": "reference-emulation-f64fft",
        "preset": f"CCS{k}party",
        "gates": total,
        "decrypt_ok": oks,
        "keygen_s": round(keygen_s, 1),
        "boot_s": round(time.time() - t0, 1),
        "std_bits": round(float(np.log2(std)), 2),
        "max_abs_bits": round(float(np.log2(np.abs(errs).max() + 1)), 2),
        "margin_bits": 28.0,
        "margin_sigmas": round(margin / std, 2),
    }
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    k = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    n_gates = int(sys.argv[2]) if len(sys.argv) > 2 else 256
    batch = int(sys.argv[3]) if len(sys.argv) > 3 else 32
    run(k, n_gates, batch)
