"""Sharded codec entry points and the distributed write pipeline.

Device equivalent of the reference's request path (lz4e_bdev/lz4e_req.c):
the write pipeline compresses, decode-verifies, and accumulates stats — but
block-parallel across a device mesh instead of synchronously inside one
kernel thread. Collectives (the NCCL-analog, SURVEY.md §5): ``psum`` for
global stats over the block axis; compressed sizes and payloads stay sharded
in original block order, so the ordered "gather" is XLA's output layout, not
an explicit permutation.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from .. import format as F
from ..ops import compress_blocks_device, decompress_blocks_device
from .mesh import BLOCK_AXIS


def pad_to_multiple(num_blocks: int, n_shards: int) -> int:
    return -(-num_blocks // n_shards) * n_shards


def compress_blocks_sharded(raw, raw_len, block_size: int, mesh: Mesh,
                            axis: str = BLOCK_AXIS):
    """Shard-parallel batched encode. num_blocks must divide the mesh size
    (the host framing layer pads with empty blocks)."""

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(axis, None), P(axis)),
        out_specs=(P(axis, None), P(axis)), check_vma=False)
    def local(r, rl):
        return compress_blocks_device(r, rl, block_size)

    return jax.jit(local)(raw, raw_len)


def decompress_blocks_sharded(comp, comp_len, out_size: int, mesh: Mesh,
                              axis: str = BLOCK_AXIS):
    """Shard-parallel batched decode."""

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(axis, None), P(axis)),
        out_specs=(P(axis, None), P(axis), P(axis)), check_vma=False)
    def local(c, cl):
        return decompress_blocks_device(c, cl, out_size)

    return jax.jit(local)(comp, comp_len)


def write_pipeline_sharded(raw, raw_len, block_size: int, mesh: Mesh,
                           axis: str = BLOCK_AXIS):
    """The full write-request pipeline, sharded: compress -> decode-verify ->
    global stats psum. This is the device analog of lz4e_write_req_init
    (lz4e_req.c:144-213: SG-compress, verify-decompress, stats update).

    Returns (comp, comp_len, ok, stats) with comp/comp_len/ok sharded over
    the block axis and stats replicated:
    stats = [blocks_total, blocks_failed, raw_hi, raw_lo, comp_hi, comp_lo]
    (the analog of the 4 per-direction counters, lz4e_stats.h:17-22,
    globally reduced). The byte counters are split at bit 8
    (bytes = hi * 256 + lo) so the int32 psum cannot wrap: hi sums values
    <= 2^22 and lo values <= 255, keeping both components under 2^31 for
    any step up to the format's 2 GB-per-block envelope. Reassemble with
    ``stats_totals``.
    """
    slot = F.compress_bound(block_size) + 8

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(axis, None), P(axis)),
        out_specs=(P(axis, None), P(axis), P(axis), P()),
        check_vma=False)
    def local(r, rl):
        comp, clen = compress_blocks_device(r, rl, block_size)
        padded = jnp.pad(comp, ((0, 0), (0, slot - comp.shape[1])))
        out, olen, err = decompress_blocks_device(padded, clen, block_size)
        same = jnp.all(
            jnp.where(jnp.arange(block_size)[None, :] < rl[:, None],
                      out == r, True), axis=-1)
        ok = (~err) & (olen == rl) & same
        rb = jnp.where(ok, rl, 0)
        cb = jnp.where(ok, clen, 0)
        stats = jnp.stack([
            jnp.sum(jnp.ones_like(rl)),
            jnp.sum(jnp.where(ok, 0, 1)),
            jnp.sum(rb >> 8), jnp.sum(rb & 255),
            jnp.sum(cb >> 8), jnp.sum(cb & 255),
        ]).astype(jnp.int32)  # split byte counters: no int32 wrap (docstring)
        stats = jax.lax.psum(stats, axis)
        return comp, clen, ok, stats

    return jax.jit(local)(raw, raw_len)


def stats_totals(stats):
    """Reassemble write_pipeline_sharded's split counters into Python ints:
    (blocks_total, blocks_failed, raw_bytes, comp_bytes)."""
    import numpy as np
    s = np.asarray(stats).astype(np.int64)
    return int(s[0]), int(s[1]), int(s[2] * 256 + s[3]), int(s[4] * 256 + s[5])


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None) -> None:
    """Bring up cross-host communication (jax.distributed). No-op when
    running single-process. The reference has no multi-node story; this is
    the framework's scaling path (BASELINE.md: 1 chip -> 1 host -> N hosts).
    """
    if num_processes in (None, 1):
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id)


def assemble_container_sharded(comp, comp_len, mesh: Mesh,
                               axis: str = BLOCK_AXIS):
    """Explicit cross-shard ordered assembly (SURVEY.md §5 collective set):
    all_gather the per-shard compressed sizes, derive global byte offsets,
    and build the dense ordered payload with every block's bytes packed
    back-to-back in original block order — the collective analog of the
    reference returning per-chunk dstPos and the bdev writing chunks in
    submission order (lz4e_compress.c:533, lz4e_req.c:191-198).

    comp: uint8 [num_blocks, slot] sharded over `axis`; comp_len int32
    sharded the same way. Returns (payload uint8 [total_cap], sizes int32
    [num_blocks], total int32) all replicated, where total_cap =
    num_blocks * slot and payload[:total] is the packed container body.

    Collectives used: all_gather (NCCL between GPUs) for sizes and the
    slot-padded payloads; offsets via a cross-shard exclusive scan of the
    gathered sizes. The ragged pack itself is a vectorized
    prefix-sum/searchsorted program on replicated data — O(total) work,
    no per-block host loop.
    """
    nblocks, slot = comp.shape

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(axis, None), P(axis)),
        out_specs=(P(), P(), P()), check_vma=False)
    def local(c, cl):
        # ordered all-gathers: axis index 0..n-1 keeps original block order
        sizes = jax.lax.all_gather(cl, axis, tiled=True)      # [nblocks]
        full = jax.lax.all_gather(c, axis, tiled=True)        # [nb, slot]
        offs = jnp.cumsum(sizes) - sizes                      # exclusive
        total = offs[-1] + sizes[-1]
        # dense pack: for every output byte t, find its block via
        # searchsorted over offsets, then its byte within the block
        cap = nblocks * slot
        t = jnp.arange(cap, dtype=jnp.int32)
        blk = jnp.searchsorted(offs, t, side="right").astype(jnp.int32) - 1
        blk = jnp.clip(blk, 0, nblocks - 1)
        within = t - offs[blk]
        payload = jnp.where(t < total,
                            full[blk, jnp.clip(within, 0, slot - 1)], 0)
        return payload.astype(jnp.uint8), sizes, total.astype(jnp.int32)

    return jax.jit(local)(comp, comp_len)
