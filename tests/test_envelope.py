"""The fio block-size envelope (test/fio_tests/test_4k.fio..test_4m.fio)
through the device codec.

- Blocks encoded by the native C++ encoder (LZ4_compress_default
  semantics) decode byte-exact on the device at every size, 4 KiB-4 MiB.
- The device encoder's blocks decode byte-exact on the device and under
  the native decoder at every size from 4 KiB to 1 MiB; the ``gpu`` lane
  adds 4 MiB on a card.

Each case ends in a partial block, so padding past ``raw_len`` is covered.
"""

import numpy as np
import pytest

from __graft_entry__ import _synth_corpus
from lz4_sgori_tpu import format as F
from lz4_sgori_tpu import native
from lz4_sgori_tpu.blocks import split_blocks
from lz4_sgori_tpu.ops import compress_blocks_device, decompress_blocks_device

FIO_SIZES = [4096 << k for k in range(11)]          # 4 KiB .. 4 MiB


def _corpus(block_size: int) -> bytes:
    # two blocks and a third of one below 1 MiB; one and a third above
    full = 2 if block_size < (1 << 20) else 1
    return _synth_corpus(full * block_size + block_size // 3,
                         seed=block_size.bit_length())


def _device_decode(streams, block_size):
    slot = F.compress_bound(block_size) + 8
    comp = np.zeros((len(streams), slot), np.uint8)
    clen = np.zeros(len(streams), np.int32)
    for j, s in enumerate(streams):
        comp[j, :len(s)] = np.frombuffer(s, np.uint8)
        clen[j] = len(s)
    out, out_len, err = decompress_blocks_device(comp, clen, block_size)
    return np.asarray(out), np.asarray(out_len), np.asarray(err)


def _check_decoded(blocks, out, out_len, err):
    for j, b in enumerate(blocks):
        assert not err[j], f"block {j}: decode error"
        assert out_len[j] == len(b), f"block {j}: length"
        assert out[j, :out_len[j]].tobytes() == b, f"block {j}: bytes"


def _encode_and_check(block_size):
    data = _corpus(block_size)
    raw, rlen = split_blocks(data, block_size)
    blocks = [raw[j, :rlen[j]].tobytes() for j in range(raw.shape[0])]
    comp, clen = compress_blocks_device(raw, rlen, block_size)
    comp, clen = np.asarray(comp), np.asarray(clen)
    streams = [comp[j, :clen[j]].tobytes() for j in range(len(blocks))]
    for j, (b, s) in enumerate(zip(blocks, streams)):
        assert len(s) <= F.compress_bound(len(b)), j
        assert native.decompress(s, block_size) == b, f"native, block {j}"
    _check_decoded(blocks, *_device_decode(streams, block_size))


@pytest.mark.skipif(not native.available(), reason="native codec unavailable")
@pytest.mark.parametrize("block_size", FIO_SIZES)
def test_device_decodes_native_blocks(block_size):
    data = _corpus(block_size)
    blocks = [data[i:i + block_size]
              for i in range(0, len(data), block_size)]
    streams = [native.compress(b) for b in blocks]
    _check_decoded(blocks, *_device_decode(streams, block_size))


@pytest.mark.skipif(not native.available(), reason="native codec unavailable")
@pytest.mark.parametrize("block_size", [s for s in FIO_SIZES
                                        if s <= (1 << 20)])
def test_device_encode_decode_roundtrip(block_size):
    _encode_and_check(block_size)


@pytest.mark.gpu
def test_device_encode_decode_4mib_gpu():
    _encode_and_check(4 << 20)
