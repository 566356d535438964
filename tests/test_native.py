"""Native C++ host codec: byte parity with golden and liblz4.

The golden encoder is byte-identical to LZ4_compress_default (established
in test_golden); the native encoder implements the same greedy semantics,
so all three implementations must agree byte-for-byte on compress, and all
pairs must inter-decode."""

import numpy as np
import pytest

from lz4_sgori_tpu import format as F, golden, native
from lz4_sgori_tpu.utils import oracle

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native codec unavailable")


def test_encoder_byte_parity_with_golden(fixtures):
    for name, data in fixtures.items():
        for blk in (data[:4096], data[:65536], data):
            assert native.compress(blk) == golden.compress(blk), name


def test_encoder_byte_parity_with_liblz4(fixtures):
    if not oracle.available():
        pytest.skip("liblz4 not available")
    for name, data in fixtures.items():
        if not data:
            continue  # liblz4 rejects empty input
        assert native.compress(data) == oracle.compress(data), name


def test_decoder_roundtrip_and_cross(fixtures):
    for name, data in fixtures.items():
        comp = native.compress(data)
        assert native.decompress(comp, len(data)) == data, name
        assert golden.decompress(comp, max(1, len(data))) == data, name
        gcomp = golden.compress(data)
        assert native.decompress(gcomp, max(1, len(data))) == data, name


def test_decoder_malformed():
    for case in [b"", b"\xff", b"\x10", b"\x14a\x00",
                 b"\x04" + b"abcd" + b"\x00\x00\x00"]:
        with pytest.raises(ValueError):
            native.decompress(case, 4096)


def test_limited_output():
    data = bytes(100)  # compresses tiny
    comp = native.compress(data, max_output=16)
    assert golden.decompress(comp, 100) == data
    incompressible = np.random.default_rng(5).integers(
        0, 256, 1000, dtype=np.uint8).tobytes()
    with pytest.raises(ValueError):
        native.compress(incompressible, max_output=100)


def test_fuzz_parity_small_inputs():
    rng = np.random.default_rng(11)
    for trial in range(200):
        n = int(rng.integers(0, 400))
        alphabet = int(rng.integers(1, 5))
        data = rng.integers(0, 2 ** alphabet, n, dtype=np.uint8).tobytes()
        g = golden.compress(data)
        c = native.compress(data)
        assert g == c, f"trial {trial} n={n}"
        assert native.decompress(c, max(1, n)) == data


def test_fuzz_malformed_at_scale():
    """4096 corrupted streams through the native C decoder: strict
    bidirectional error equivalence with golden.decompress (and byte
    equality on acceptance) — the host-side arm of the round-4 scaled
    adversarial fuzz (the device arm is tests/test_decode_fuzz.py)."""
    from lz4_sgori_tpu.utils.mutants import make_mutants

    rng = np.random.default_rng(0xBEEF)
    fix = [
        b"the quick brown fox jumps over the lazy dog " * 40,
        bytes(2048),
        bytes(range(256)) * 8,
        rng.integers(0, 256, 2048, dtype=np.uint8).tobytes(),
    ]
    bases = [golden.compress(d[:2048]) for d in fix]
    muts = make_mutants(bases, rng, 4096, 4096)
    n_acc = n_rej = 0
    for j, m in enumerate(muts):
        try:
            want = golden.decompress(m, 2048)
            ok_ref = True
        except ValueError:
            ok_ref = False
        try:
            got = native.decompress(m, 2048)
            ok_nat = True
        except ValueError:
            ok_nat = False
        assert ok_nat == ok_ref, f"mutant {j}"
        if ok_ref:
            n_acc += 1
            assert got == want, f"mutant {j}"
        else:
            n_rej += 1
    assert n_acc >= 128 and n_rej >= 1024, (n_acc, n_rej)
