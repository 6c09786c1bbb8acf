"""Pallas NTT kernel vs XLA's ring/ntt.py on one GPU, alone and end to end.

    python scripts/ntt_kernel_bench.py [--reps N] [--out chiprun_out/ntt_kernel_bench.jsonl]

1. The transform alone at KMS phase-1 shapes (N=2048, batch 128): the
   forward input of one blind-rotation step and the inverse input, for
   KMS8party (3 primes) and KMS2party (4 primes).  Median of --reps calls,
   each ending in block_until_ready.
2. KMS8party at batch 128 end to end, kms.bootstrap with pallas_ntt=False
   and =True on the same keys, in turns (off, on, on, off), each a timed
   dependent NAND chain that is decrypt-checked.

Prints one line per measurement with the card's name and power limit and
appends the same records as JSON lines to --out.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from mktfhe.utils.harness import card_names, kms_nand_inputs, require_gpu


def _median_s(fn, x, reps):
    jax.block_until_ready(fn(x))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(x))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def transforms(emit, reps):
    from mktfhe.kernels.ntt_pallas import fwd_ntt_pallas, inv_ntt_pallas
    from mktfhe.ring import fwd_ntt, inv_ntt, make_plan

    # phase-1 step at batch 128: [k, G, rows, 2, l_gsw] forward, [k, G, rows, 2] inverse
    cases = (
        ("KMS8party fwd", (8, 128, 3, 2, 4), 3, True),
        ("KMS8party inv", (8, 128, 3, 2), 3, False),
        ("KMS2party fwd", (2, 128, 2, 2, 3), 4, True),
        ("KMS2party inv", (2, 128, 2, 2), 4, False),
    )
    rng = np.random.default_rng(0)
    for label, lead, npr, forward in cases:
        plan = make_plan(2048, npr)
        p = plan.primes.astype(np.uint32)[:, None]
        x = jnp.asarray(rng.integers(0, 1 << 29, (*lead, npr, 2048), dtype=np.uint32) % p)
        xla = jax.jit(lambda a: (fwd_ntt if forward else inv_ntt)(a, plan))
        pal = jax.jit(lambda a: (fwd_ntt_pallas if forward else inv_ntt_pallas)(a, plan))
        same = bool(jnp.array_equal(xla(x), pal(x)))
        t_xla = _median_s(xla, x, reps)
        t_pal = _median_s(pal, x, reps)
        nbytes = 2 * x.size * 4
        emit({
            "what": "transform", "case": label, "shape": list(x.shape),
            "xla_ms": t_xla * 1e3, "pallas_ms": t_pal * 1e3,
            "xla_gbps": nbytes / t_xla / 1e9, "pallas_gbps": nbytes / t_pal / 1e9,
            "speedup": t_xla / t_pal, "bit_identical": same,
        })


def end_to_end(emit, reps):
    from mktfhe.schemes import kms
    from mktfhe.schemes.gates import GATE_IDS, gate_affine, lwe_decrypt_bit_mk
    from mktfhe.schemes.presets import KMS_8PARTY as params

    batch = 128
    scheme, keys, c1, c2, m1, m2, _keygen_s = kms_nand_inputs(params, batch, seed=1)
    nand = GATE_IDS["NAND"]
    for pallas in (False, True, True, False):
        boot = lambda ct: kms.bootstrap(ct, scheme, params, pallas_ntt=pallas)
        t0 = time.perf_counter()
        out = jax.block_until_ready(boot(gate_affine(nand, c1, c2)))
        first = time.perf_counter() - t0
        want = ~(m1 & m2)
        t0 = time.perf_counter()
        for _ in range(reps):
            out, want = boot(gate_affine(nand, out, c2)), ~(want & m2)
        jax.block_until_ready(out)
        steady = (time.perf_counter() - t0) / reps
        ok = bool(np.array_equal(np.asarray(lwe_decrypt_bit_mk(out, keys)), want))
        emit({
            "what": "kms8party_b128", "pallas_ntt": pallas, "first_call_s": first,
            "steady_s_per_batch": steady, "bootstraps_per_s": batch / steady, "decrypt_ok": ok,
        })


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--e2e-reps", type=int, default=3)
    ap.add_argument("--out", default="chiprun_out/ntt_kernel_bench.jsonl")
    args = ap.parse_args()
    require_gpu(1, "ntt_kernel_bench")
    card = card_names()[0]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)

    def emit(rec):
        rec["card"] = card
        print(json.dumps(rec), flush=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")

    transforms(emit, args.reps)
    end_to_end(emit, args.e2e_reps)


if __name__ == "__main__":
    main()
