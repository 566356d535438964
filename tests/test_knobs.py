"""Config-knob contract tests: acceleration semantics of the golden encoder.

The reference exposes acceleration through LZ4E_compress_default
(lz4e.h:9 LZ4E_ACCELERATION_DEFAULT; skip scaling lz4e_compress.c:296-307).
Parity oracle: liblz4's LZ4_compress_fast must produce byte-identical
output at every acceleration for <= 64 KiB blocks.
"""

import pytest

from lz4_sgori_tpu import golden
from lz4_sgori_tpu.utils import oracle

HAS_LZ4 = oracle.available()


@pytest.mark.skipif(not HAS_LZ4, reason="liblz4 not available")
@pytest.mark.parametrize("accel", [2, 8, 64])
def test_golden_acceleration_parity_liblz4(fixtures, accel):
    for name, data in fixtures.items():
        ours = golden.compress(data, acceleration=accel)
        ref = oracle.compress_fast(data, accel)
        assert ours == ref, (name, accel)


@pytest.mark.skipif(not HAS_LZ4, reason="liblz4 not available")
def test_acceleration_changes_output(fixtures):
    # acceleration > 1 must actually change the parse on compressible data
    data = fixtures["text_small"]
    a1 = golden.compress(data, acceleration=1)
    a64 = golden.compress(data, acceleration=64)
    assert len(a64) > len(a1)  # skip search trades ratio for speed
    assert golden.decompress(a64, len(data)) == data
