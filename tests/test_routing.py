"""Engine selection: each direction has one engine, the XLA program.

``impl`` accepts "auto" and "xla"; the names of the removed lane-lockstep
engines raise a ValueError that says they were removed, and nothing falls
back to another engine or to interpret mode.
"""

import numpy as np
import pytest

from lz4_sgori_tpu.ops import (compress_blocks_device,
                               decompress_blocks_device, routing)


@pytest.mark.parametrize("direction", ["encode", "decode"])
@pytest.mark.parametrize("impl", ["auto", "xla"])
def test_xla_impl_names_accepted(direction, impl):
    routing.check_impl(impl, direction)


@pytest.mark.parametrize("impl", routing.REMOVED_ENCODE_IMPLS)
def test_removed_encode_impl_raises(impl):
    raw = np.zeros((1, 4096), np.uint8)
    with pytest.raises(ValueError, match="removed"):
        compress_blocks_device(raw, np.array([4096], np.int32), 4096,
                               impl=impl)


@pytest.mark.parametrize("impl", routing.REMOVED_DECODE_IMPLS)
def test_removed_decode_impl_raises(impl):
    comp = np.zeros((1, 64), np.uint8)
    with pytest.raises(ValueError, match="removed"):
        decompress_blocks_device(comp, np.array([1], np.int32), 4096,
                                 impl=impl)


@pytest.mark.parametrize("direction", ["encode", "decode"])
def test_unknown_impl_raises(direction):
    # "scalar" was a retired round-1 kernel: it must error, not reroute
    with pytest.raises(ValueError, match="unknown"):
        routing.check_impl("scalar", direction)


def test_removed_names_are_direction_specific():
    # a decode engine's name is unknown to the encoder, and vice versa
    with pytest.raises(ValueError, match="unknown encode impl"):
        routing.check_impl("lockstep_v7", "encode")
    with pytest.raises(ValueError, match="unknown decode impl"):
        routing.check_impl("enc3", "decode")


def test_forced_xla_matches_auto():
    raw = np.zeros((2, 4096), np.uint8)
    raw[0, :100] = np.arange(100) % 7
    rl = np.array([4096, 100], np.int32)
    ca, la = compress_blocks_device(raw, rl, 4096)
    cx, lx = compress_blocks_device(raw, rl, 4096, impl="xla")
    assert (np.asarray(la) == np.asarray(lx)).all()
    assert (np.asarray(ca) == np.asarray(cx)).all()
    slot = np.pad(np.asarray(ca), ((0, 0), (0, 8)))
    oa = decompress_blocks_device(slot, la, 4096)
    ox = decompress_blocks_device(slot, la, 4096, impl="xla")
    for a, b in zip(oa, ox):
        assert (np.asarray(a) == np.asarray(b)).all()
