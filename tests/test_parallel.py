"""Sharded codec over the simulated 8-device CPU mesh.

The fake-backend analog of the reference testing against a brd ramdisk
(test/bash_tests/test_proxy.sh:9): a virtual device mesh stands in for a
set of GPUs; the sharding/collective program is identical."""

import jax
import numpy as np
import pytest

from lz4_sgori_tpu import blocks, format as F
from lz4_sgori_tpu.parallel import (compress_blocks_sharded,
                                    decompress_blocks_sharded, make_mesh,
                                    write_pipeline_sharded)

BS = 1024


@pytest.fixture(scope="module")
def mesh():
    return make_mesh()


def _batch(fixtures, nblocks=16):
    rng = np.random.default_rng(3)
    data = (fixtures["text_large"] + bytes(4096) +
            rng.integers(0, 256, 4096, dtype=np.uint8).tobytes())
    data = (data * 4)[:nblocks * BS]
    return blocks.split_blocks(data, BS)


def test_mesh_has_8_devices(mesh):
    assert mesh.devices.size == 8


def test_sharded_roundtrip(mesh, fixtures):
    raw, rlen = _batch(fixtures)
    comp, clen = compress_blocks_sharded(raw, rlen, BS, mesh)
    comp, clen = np.asarray(comp), np.asarray(clen)
    slot = F.compress_bound(BS) + 8
    padded = np.zeros((comp.shape[0], slot), np.uint8)
    padded[:, :comp.shape[1]] = comp
    out, olen, err = decompress_blocks_sharded(padded, clen, BS, mesh)
    out, olen, err = np.asarray(out), np.asarray(olen), np.asarray(err)
    assert not err.any()
    assert (olen == rlen).all()
    assert (np.asarray(out) == raw).all()


def test_write_pipeline_stats(mesh, fixtures):
    raw, rlen = _batch(fixtures)
    comp, clen, ok, stats = write_pipeline_sharded(raw, rlen, BS, mesh)
    ok = np.asarray(ok)
    assert ok.all()
    from lz4_sgori_tpu.parallel import stats_totals
    total, failed, raw_bytes, comp_bytes = stats_totals(stats)
    assert total == raw.shape[0]
    assert failed == 0
    assert raw_bytes == int(rlen.sum())
    assert comp_bytes == int(np.asarray(clen).sum())


def test_sharded_matches_unsharded(mesh, fixtures):
    from lz4_sgori_tpu.ops import compress_blocks_device
    raw, rlen = _batch(fixtures)
    c1, l1 = compress_blocks_sharded(raw, rlen, BS, mesh)
    c2, l2 = compress_blocks_device(raw, rlen, BS)
    assert (np.asarray(l1) == np.asarray(l2)).all()
    assert (np.asarray(c1) == np.asarray(c2)).all()
