"""Tiny-preset run of the reference-pipeline oracle (SURVEY.md 4b).

scripts/ref_emulation.py ports the reference's Float64-FFT pipeline
semantics to numpy; this test keeps the tiny-preset comparison green in
CI (full-preset Monte-Carlos are committed in NOISE.md).  Decrypt
agreement between that pipeline and this framework's exact-CRT pipeline
(exercised everywhere else in the suite on the same presets) is the
ciphertext-level behavioural anchor available without a Julia runtime.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "scripts"))


def test_tiny_kms_reference_emulation_decrypts():
    from ref_emulation import run_kms

    from mktfhe.schemes.presets import TEST_PRESETS

    rec = run_kms(2, 16, 16, preset=TEST_PRESETS["TinyKMS2partyN128"])
    assert rec["decrypt_ok"] == rec["gates"], rec
    assert rec["margin_sigmas"] > 6, rec
