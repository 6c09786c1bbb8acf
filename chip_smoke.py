"""Smoke test of the main path on one NVIDIA GPU, at full preset widths.

    python chip_smoke.py               # one card, every phase below
    python chip_smoke.py --four-cards  # the party-sharded paths on four cards

Phases (one card), in order; any failure exits nonzero:
  1. device check: JAX must see a GPU (never falls back to the CPU);
  2. CGGI at the full preset, batch 256: a dependent NAND chain through
     cggi.bootstrap, decrypted against the cleartext;
  3. KMS8party at the full preset (k=8, n=560, N=2048), batch 128, through
     kms.crs -> party_keygen -> setup -> bootstrap: keygen time, first-call
     time, steady time per batch and peak device memory, decrypt-checked;
     then the same with pallas_ntt=True, bit-identical to the jnp path;
  4. bit-identity of kms.bootstrap on the GPU and on the CPU backend, for
     KMS2party and KMS8partyblock at batch 2, with the same keys and
     ciphertexts device_put to both (exact integers: tolerance zero; no
     float matmul is on the path, so TF32 cannot touch it);
  5. the Pallas NTT kernel as compiled for the card vs ring/ntt.py at N=2048.

--four-cards runs only KMS8party at batch 8 on a (party=4, batch=1) mesh:
parallel/mesh.py's partitioner path and parallel/shardmap.py's shard_map
path with and without shard_phase2, each compared bit for bit with
single-card kms.bootstrap.  Their first calls (mostly compiles) run side by
side in threads.

The last line of stdout is one JSON object: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import gc
import json
import os
import sys
import time

from mktfhe.utils.harness import card_names, kms_nand_inputs, require_gpu


def log(msg: str) -> None:
    print(msg, flush=True)


def result_line(devs) -> str:
    d = devs[0]
    return json.dumps(
        {"ok": True, "device": {"platform": d.platform, "kind": d.device_kind, "count": len(devs)}}
    )


def _nand_chain(boot, decrypt, c1, c2, m1, m2, depth: int):
    """depth dependent NANDs: out = NAND(...NAND(NAND(c1, c2), c2)..., c2)."""
    import numpy as np

    from mktfhe.schemes.gates import GATE_IDS, gate_affine

    nand = GATE_IDS["NAND"]
    out, want = boot(gate_affine(nand, c1, c2)), ~(m1 & m2)
    for _ in range(depth - 1):
        out, want = boot(gate_affine(nand, out, c2)), ~(want & m2)
    got = np.asarray(decrypt(out))
    if not np.array_equal(got, want):
        raise AssertionError(f"decrypt mismatch in {int((got != want).sum())} of {got.size} gates")
    return out


def _assert_same(name: str, got, want) -> None:
    import numpy as np

    for field in ("b", "a"):
        g, w = np.asarray(getattr(got, field)), np.asarray(getattr(want, field))
        if g.shape != w.shape or not np.array_equal(g, w):
            raise AssertionError(f"{name}: {field} differs ({g.shape} vs {w.shape})")


def phase_cggi(card: str) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mktfhe.schemes import cggi
    from mktfhe.schemes.gates import lwe_decrypt_bit, lwe_encrypt_bit
    from mktfhe.schemes.presets import CGGI_PARAM as params

    batch, depth = 256, 4
    t0 = time.perf_counter()
    lwe_key, _ring_key, scheme = cggi.setup(jax.random.key(10), params)
    jax.block_until_ready(scheme)
    keygen_s = time.perf_counter() - t0
    rng = np.random.default_rng(10)
    m1, m2 = rng.integers(0, 2, (2, batch)).astype(bool)
    c1 = lwe_encrypt_bit(jax.random.key(11), jnp.asarray(m1), lwe_key, params.alpha, (batch,))
    c2 = lwe_encrypt_bit(jax.random.key(12), jnp.asarray(m2), lwe_key, params.alpha, (batch,))
    t0 = time.perf_counter()
    _nand_chain(
        lambda ct: cggi.bootstrap(ct, scheme, params),
        lambda ct: lwe_decrypt_bit(ct, lwe_key), c1, c2, m1, m2, depth,
    )
    log(
        f"cggi: CGGI batch {batch}, {depth}-deep NAND chain decrypts OK; keygen "
        f"{keygen_s:.2f} s, chain incl. compile {time.perf_counter() - t0:.2f} s [{card}]"
    )


def phase_kms8(card: str, dev) -> None:
    import jax

    from mktfhe.schemes import kms
    from mktfhe.schemes.gates import lwe_decrypt_bit_mk
    from mktfhe.schemes.presets import KMS_8PARTY as params

    batch, reps = 128, 3
    scheme, lwe_keys, c1, c2, m1, m2, keygen_s = kms_nand_inputs(params, batch, seed=20)
    log(f"kms8: KMS8party keygen (8 parties + setup) {keygen_s:.2f} s [{card}]")
    boot = lambda ct: kms.bootstrap(ct, scheme, params)
    decrypt = lambda ct: lwe_decrypt_bit_mk(ct, lwe_keys)

    from mktfhe.schemes.gates import GATE_IDS, gate_affine

    first_in = gate_affine(GATE_IDS["NAND"], c1, c2)
    t0 = time.perf_counter()
    jax.block_until_ready(boot(first_in))
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = _nand_chain(boot, decrypt, c1, c2, m1, m2, reps)
    jax.block_until_ready(out)
    steady_s = (time.perf_counter() - t0) / reps
    peak = dev.memory_stats()["peak_bytes_in_use"]
    log(f"kms8: KMS8party batch {batch} first call (compile + run) {first_s:.2f} s [{card}]")
    log(f"kms8: KMS8party batch {batch} compile ~ first call - steady = {first_s - steady_s:.2f} s [{card}]")
    log(
        f"kms8: KMS8party batch {batch} steady {steady_s:.4f} s/batch "
        f"({batch / steady_s:.2f} bootstraps/s), {reps}-deep NAND chain decrypts OK [{card}]"
    )
    log(f"kms8: KMS8party peak device memory {peak / 2**30:.2f} GiB [{card}]")

    # the same bootstrap with every NTT in the Pallas kernel: same bits
    fast = lambda ct: kms.bootstrap(ct, scheme, params, pallas_ntt=True)
    want = jax.block_until_ready(boot(first_in))
    t0 = time.perf_counter()
    got = jax.block_until_ready(fast(first_in))
    first_s = time.perf_counter() - t0
    _assert_same("pallas_ntt=True", got, want)
    t0 = time.perf_counter()
    jax.block_until_ready(_nand_chain(fast, decrypt, c1, c2, m1, m2, reps))
    steady_s = (time.perf_counter() - t0) / reps
    log(
        f"kms8: KMS8party batch {batch} pallas_ntt=True == jnp path bit for bit; first call "
        f"{first_s:.2f} s, steady {steady_s:.4f} s/batch ({batch / steady_s:.2f} bootstraps/s), "
        f"{reps}-deep NAND chain decrypts OK [{card}]"
    )


def phase_identity(card: str) -> None:
    import jax

    from mktfhe.schemes import kms
    from mktfhe.schemes.gates import GATE_IDS, gate_affine
    from mktfhe.schemes.presets import KMS_2PARTY, KMS_8PARTY_BLOCK

    cpu = jax.devices("cpu")[0]
    for name, params in (("KMS2party", KMS_2PARTY), ("KMS8partyblock", KMS_8PARTY_BLOCK)):
        t0 = time.perf_counter()
        scheme, _keys, c1, c2, *_ = kms_nand_inputs(params, 2, seed=30)
        ct = gate_affine(GATE_IDS["NAND"], c1, c2)
        out_gpu = kms.bootstrap(ct, scheme, params)
        out_cpu = kms.bootstrap(jax.device_put(ct, cpu), jax.device_put(scheme, cpu), params)
        where = [next(iter(o.b.devices())).platform for o in (out_gpu, out_cpu)]
        if where != ["gpu", "cpu"]:
            raise AssertionError(f"{name}: outputs came from {where}, not from the GPU and the CPU")
        _assert_same(name, out_gpu, out_cpu)
        log(
            f"identity: {name} batch 2 GPU == CPU bit for bit "
            f"({time.perf_counter() - t0:.2f} s incl. keygen and both compiles) [{card}]"
        )
        del scheme
        gc.collect()


def phase_ntt_kernel(card: str, dev) -> None:
    import jax
    import numpy as np

    from mktfhe.kernels.ntt_pallas import fwd_ntt_pallas, inv_ntt_pallas
    from mktfhe.ring import fwd_ntt, inv_ntt, make_plan

    rng = np.random.default_rng(40)
    for npr in (3, 4):
        plan = make_plan(2048, npr)
        p = plan.primes.astype(np.uint64)[:, None]
        x = (rng.integers(0, 1 << 32, (128, 6, npr, 2048), dtype=np.uint64) % p).astype(np.uint32)
        x = jax.device_put(x, dev)
        for kernel, ref in ((fwd_ntt_pallas, fwd_ntt), (inv_ntt_pallas, inv_ntt)):
            got = jax.jit(lambda a: kernel(a, plan))(x)
            want = jax.jit(lambda a: ref(a, plan))(x)
            if not np.array_equal(np.asarray(got), np.asarray(want)):
                raise AssertionError(f"{kernel.__name__} differs from {ref.__name__} (npr={npr})")
        log(f"ntt: Pallas fwd/inv NTT == ring/ntt.py bit for bit, N=2048, {npr} primes, 768 polys [{card}]")


def four_cards(devs, card: str) -> None:
    import jax

    from mktfhe.parallel import kms_bootstrap_sharded, kms_bootstrap_shardmap, make_mesh, shard_scheme
    from mktfhe.schemes import kms
    from mktfhe.schemes.gates import GATE_IDS, gate_affine
    from mktfhe.schemes.presets import KMS_8PARTY as params

    scheme, _keys, c1, c2, *_, keygen_s = kms_nand_inputs(params, 8, seed=50)
    log(f"four: KMS8party keygen {keygen_s:.2f} s [{card}]")
    ct = gate_affine(GATE_IDS["NAND"], c1, c2)
    mesh = make_mesh(4, 1)
    sh = shard_scheme(scheme, mesh)
    want = set(devs)
    for name in ("brk_hat", "rlk_d_hat", "ksk_a"):
        got = getattr(sh, name).sharding.device_set
        if got != want:
            raise AssertionError(f"{name} lives on {sorted(d.id for d in got)}, not on all four cards")
    paths = (
        ("kms.bootstrap on one card", lambda: kms.bootstrap(ct, scheme, params)),
        ("mesh.kms_bootstrap_sharded", lambda: kms_bootstrap_sharded(ct, sh, params, mesh)),
        ("shardmap.kms_bootstrap_shardmap", lambda: kms_bootstrap_shardmap(ct, sh, params, mesh)),
        ("shardmap.kms_bootstrap_shardmap(shard_phase2=True)",
         lambda: kms_bootstrap_shardmap(ct, sh, params, mesh, shard_phase2=True)),
    )
    # first calls (mostly XLA compiles) run side by side, then one timed call each
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(paths)) as pool:
        firsts = list(pool.map(lambda p: jax.block_until_ready(p[1]()), paths))
    log(f"four: first calls of the reference and the three sharded paths, side by side: {time.perf_counter() - t0:.2f} s [{card}]")
    ref = firsts[0]
    if next(iter(ref.b.devices())) != devs[0]:
        raise AssertionError("the single-card reference did not run on card 0")
    for (name, run), out in zip(paths[1:], firsts[1:]):
        _assert_same(name, out, ref)
        t0 = time.perf_counter()
        jax.block_until_ready(run())
        log(
            f"four: {name} on (party=4, batch=1) == single-card bit for bit; "
            f"second call {time.perf_counter() - t0:.3f} s [{card}]"
        )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true", help="run only the party-sharded paths on four GPUs")
    args = ap.parse_args(argv)
    n_cards = 4 if args.four_cards else 1

    devs = require_gpu(n_cards, "chip_smoke")
    import jax

    import mktfhe

    cards = card_names()
    for line in cards:
        log(f"gpu: {line}")
    card = cards[0]
    log(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"compile cache: {mktfhe.CACHE_DIR}")
    t_all = time.perf_counter()
    if args.four_cards:
        four_cards(devs, card)
    else:
        phase_cggi(card)
        gc.collect()
        phase_kms8(card, devs[0])
        gc.collect()
        phase_identity(card)
        phase_ntt_kernel(card, devs[0])
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(result_line(devs), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
