"""Encoder-side adversarial-input fuzz.

Structured adversarial *inputs* — RLE edges, short periods, matches at the
MFLIMIT boundary, 0xFF LSIC length boundaries, 64 KiB-window-straddling
repeats, incompressible tails — through the device encoder, asserting the
reference cross-decoder contract (lz4e_bdev/lz4e_chunk.c:119-137): liblz4
must decode every produced block back to the original bytes, and the
aggregate size must not exceed LZ4_compress_default's.

The default lane runs one 64 KiB block of each of the 16 families, plus
all of them in one batch for the size contract; the ``gpu`` lane runs 1024
blocks on a card.
"""

import numpy as np
import pytest

from lz4_sgori_tpu import format as F
from lz4_sgori_tpu import golden
from lz4_sgori_tpu.ops import compress_blocks_device
from lz4_sgori_tpu.utils import oracle

BS = 65536
N_FAMILIES = 16


def adversarial_blocks(n: int, block_size: int = BS, seed: int = 0):
    """Deterministic structured adversarial inputs, cycling families."""
    rng = np.random.RandomState(seed)
    out = []
    lorem = (b"Lorem ipsum dolor sit amet, consectetur adipiscing elit, "
             b"sed do eiusmod tempor incididunt ut labore. ")

    def rnd(k):
        return rng.randint(0, 256, k).astype(np.uint8).tobytes()

    fam = 0
    while len(out) < n:
        f = fam % N_FAMILIES
        fam += 1
        if f == 0:                       # all zeros (RLE offset-1)
            b = bytes(block_size)
        elif f == 1:                     # short periods 1..8
            p = (fam % 8) + 1
            b = (rnd(p) * (block_size // p + 1))[:block_size]
        elif f == 2:                     # literal run hitting RUN_MASK
            # lengths around 15, 270, 270+255 ... LSIC 0xFF boundaries
            k = [14, 15, 16, 269, 270, 271, 524, 525][fam % 8]
            b = (rnd(k) + bytes(8) + rnd(k) + bytes(8))
            b = (b * (block_size // len(b) + 1))[:block_size]
        elif f == 3:                     # match ending exactly at MFLIMIT
            tail = 12 + (fam % 4)
            b = rnd(block_size - 64 - tail) + bytes(64 + tail)
        elif f == 4:                     # window-straddling repeats
            unit = rnd(1024)
            gap = bytes(65535 - 1024 + (fam % 3) - 1)
            b = (unit + gap + unit + rnd(block_size))[:block_size]
        elif f == 5:                     # incompressible
            b = rnd(block_size)
        elif f == 6:                     # compressible head, random tail
            b = (lorem * 200)[:block_size // 2] + rnd(block_size // 2)
        elif f == 7:                     # match lengths at ML_MASK edges
            k = [18, 19, 20, 274, 275, 276][fam % 6]
            unit = rnd(8) + rnd(4) * (k // 4)
            b = (unit * (block_size // len(unit) + 1))[:block_size]
        elif f == 8:                     # alternating zero/random pages
            parts = []
            for i in range(block_size // 256):
                parts.append(bytes(256) if i % 2 else rnd(256))
            b = b"".join(parts)
        elif f == 9:                     # text
            b = (lorem * (block_size // len(lorem) + 1))[:block_size]
        elif f == 10:                    # 0xFF fill (LSIC byte value)
            b = b"\xff" * block_size
        elif f == 11:                    # short block (partial tail)
            b = rnd(13 + (fam % 77))
        elif f == 12:                    # barely-compressible
            b = b"".join(rnd(255) + rnd(1) for _ in range(
                block_size // 256))[:block_size]
        elif f == 13:                    # long match after long literal
            b = (rnd(4096) + (b"Q" * 4096)) * (block_size // 8192)
        elif f == 14:                    # period straddling 4 KiB boundaries
            b = ((b"x" * 4095) + b"Z") * (block_size // 4096)
        else:                            # mixed structured
            t = np.arange(block_size // 2, dtype=np.float32)
            b = (np.sin(t / 50).astype(np.float16).tobytes()
                 + rnd(block_size - 2 * (block_size // 2)))
            b = b[:block_size]
        out.append(b[:block_size])
    return out[:n]


def _pack(blocks, block_size):
    raw = np.zeros((len(blocks), block_size), np.uint8)
    rlen = np.zeros(len(blocks), np.int32)
    for j, b in enumerate(blocks):
        raw[j, :len(b)] = np.frombuffer(b, np.uint8)
        rlen[j] = len(b)
    return raw, rlen


def _check_roundtrip(blocks, comp, clen, label):
    """liblz4 (golden without it) decodes every block exactly; returns the
    aggregate compressed size and the reference encoder's."""
    comp = np.asarray(comp)
    clen = np.asarray(clen)
    total = 0
    lz4_total = 0
    for j, b in enumerate(blocks):
        assert clen[j] > 0 or len(b) == 0, f"{label}: block {j} failed"
        stream = comp[j, :clen[j]].tobytes()
        if oracle.available():
            got = oracle.decompress(stream, len(b))
            lz4_total += len(oracle.compress(b))
        else:
            got = golden.decompress(stream, len(b))
            lz4_total += len(golden.compress(b))
        assert got == b, f"{label}: round-trip mismatch at block {j}"
        total += int(clen[j])
    return total, lz4_total


def _check_contract(blocks, comp, clen, label):
    """Round trip plus per-batch size dominance."""
    total, lz4_total = _check_roundtrip(blocks, comp, clen, label)
    assert total <= lz4_total, \
        f"{label}: aggregate size {total} > lz4 {lz4_total}"


def _encode(blocks, block_size):
    raw, rlen = _pack(blocks, block_size)
    return compress_blocks_device(raw, rlen, block_size)


@pytest.mark.parametrize("family", range(N_FAMILIES))
def test_encode_fuzz_family_roundtrips(family):
    """One block of each family: liblz4 (or golden) decodes it exactly and
    it fits COMPRESSBOUND."""
    block = adversarial_blocks(N_FAMILIES, BS, seed=3)[family]
    comp, clen = _encode([block], BS)
    assert int(np.asarray(clen)[0]) <= F.compress_bound(len(block))
    _check_roundtrip([block], comp, clen, f"family {family}")


def test_encode_fuzz_aggregate_size_contract():
    """Two blocks of every family in one batch: the aggregate compressed
    size stays at or below LZ4_compress_default's."""
    blocks = adversarial_blocks(2 * N_FAMILIES, BS, seed=5)
    comp, clen = _encode(blocks, BS)
    _check_contract(blocks, comp, clen, "xla")


@pytest.mark.gpu
def test_encode_fuzz_gpu_scale():
    """1024 adversarial 64 KiB blocks on a card, in batches of 256:
    liblz4 round trip and the aggregate size contract."""
    n = 1024
    blocks = adversarial_blocks(n, BS, seed=17)
    comps, clens = [], []
    for s in range(0, n, 256):
        comp, clen = _encode(blocks[s:s + 256], BS)
        comps.append(np.asarray(comp))
        clens.append(np.asarray(clen))
    _check_contract(blocks, np.concatenate(comps), np.concatenate(clens),
                    "xla-gpu")
