"""Golden codec tests: round-trip, format invariants, and cross-implementation
parity against system liblz4 (the contract the reference tests in-band on
every write, lz4e_bdev/lz4e_chunk.c:119-137)."""

import pytest

from lz4_sgori_tpu import format as F
from lz4_sgori_tpu import golden
from lz4_sgori_tpu.utils import oracle

HAS_LZ4 = oracle.available()


def test_compress_bound():
    assert F.compress_bound(0) == 16
    assert F.compress_bound(255) == 272
    assert F.compress_bound(65536) == 65536 + 257 + 16 - 1 + 1 - 0  # 65809
    assert F.compress_bound(F.MAX_INPUT_SIZE + 1) == 0


def test_roundtrip_all_fixtures(fixtures):
    for name, data in fixtures.items():
        comp = golden.compress(data)
        assert len(comp) <= F.compress_bound(len(data)), name
        out = golden.decompress(comp, len(data))
        assert out == data, f"round-trip mismatch for {name}"


def test_roundtrip_boundary_sizes():
    # every size around MIN_LENGTH and MFLIMIT boundaries
    for n in list(range(0, 32)) + [63, 64, 65, 255, 256, 4095, 4096, 4097]:
        data = (b"abcabcabcabc" * ((n // 12) + 1))[:n]
        comp = golden.compress(data)
        assert golden.decompress(comp, n) == data, n


def test_small_input_is_stored_as_literals():
    data = b"hello!!!"
    comp = golden.compress(data)
    # token with literal run only + the bytes
    assert comp[0] == len(data) << F.ML_BITS
    assert comp[1:] == data


def test_compressible_data_compresses(fixtures):
    comp = golden.compress(fixtures["zeros_64k"])
    assert len(comp) < 600  # zeros collapse to a few long matches
    comp = golden.compress(fixtures["text_large"])
    assert len(comp) < len(fixtures["text_large"]) // 2


def test_limited_output_raises(fixtures):
    data = fixtures["random_4k"]
    with pytest.raises(ValueError):
        golden.compress(data, max_output=100)


@pytest.mark.skipif(not HAS_LZ4, reason="liblz4 not available")
class TestCrossOracle:
    def test_liblz4_decodes_golden(self, fixtures):
        for name, data in fixtures.items():
            comp = golden.compress(data)
            assert oracle.decompress(comp, len(data)) == data, name

    def test_golden_decodes_liblz4(self, fixtures):
        for name, data in fixtures.items():
            if not data:
                continue  # liblz4 0-byte blocks are a degenerate case
            comp = oracle.compress(data)
            assert golden.decompress(comp, len(data)) == data, name

    def test_byte_parity_with_lz4_default(self, fixtures):
        """The golden encoder reproduces LZ4_compress_default byte-for-byte
        (same greedy parse, same hash geometry) — the strongest form of the
        BASELINE.json contract 'compressed size <= LZ4_compress_default'."""
        for name, data in fixtures.items():
            if not data:
                continue
            ours = golden.compress(data)
            theirs = oracle.compress(data)
            assert ours == theirs, (name, len(ours), len(theirs))


class TestDecodeErrors:
    def test_empty_input(self):
        with pytest.raises(golden.DecodeError):
            golden.decompress(b"", 10)

    def test_truncated_literals(self):
        with pytest.raises(golden.DecodeError):
            golden.decompress(bytes([5 << 4]) + b"ab", 100)

    def test_offset_past_start(self):
        # 4 literals then a match with offset 100 (past output start)
        bad = bytes([(4 << 4) | 0]) + b"abcd" + (100).to_bytes(2, "little") + bytes([0 << 4])
        with pytest.raises(golden.DecodeError):
            golden.decompress(bad, 100)

    def test_zero_offset(self):
        bad = bytes([(4 << 4) | 0]) + b"abcd" + (0).to_bytes(2, "little") + bytes([0])
        with pytest.raises(golden.DecodeError):
            golden.decompress(bad, 100)

    def test_output_overflow(self):
        data = bytes(1000)
        comp = golden.compress(data)
        with pytest.raises(golden.DecodeError):
            golden.decompress(comp, 999)

    def test_truncated_lsic(self):
        bad = bytes([15 << 4, 255, 255])  # literal LSIC chain runs off the end
        with pytest.raises(golden.DecodeError):
            golden.decompress(bad, 10**6)
