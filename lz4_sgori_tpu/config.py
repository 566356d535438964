"""Runtime configuration (the analog of the reference's two config tiers:
compile-time macros lz4e.h:9-14,53-55 + sysfs module params
lz4e_module.c:195-202). A single dataclass, overridable per call."""

from __future__ import annotations

from dataclasses import dataclass, field

from . import format as F


@dataclass(frozen=True)
class CodecConfig:
    """Knobs for the device codec and framing.

    block_size:      independent-block framing size (4 KiB..4 MiB envelope,
                     the reference's fio sweep range).
    acceleration:    LZ4_compress_fast semantics (lz4e.h:9, skip-search
                     scaling lz4e_compress.c:296-307). The device encoder
                     evaluates every position, has no skip loop and
                     ignores it.
    verify_writes:   decode-verify every compressed block before accepting
                     it (the reference's always-on write verify,
                     lz4e_chunk.c:119-137).
    max_sequences:   optional cap on sequences/block for the decode chain;
                     None = format worst case (out_size//4+2).
    mesh_axis:       name of the block-parallel mesh axis.
    """

    block_size: int = 65536
    acceleration: int = F.ACCELERATION_DEFAULT
    # prior occurrences evaluated per position; the hash-chain-depth analog
    # of the reference's (stubbed) HC ambitions. None = depth 3
    match_depth: int | None = None
    verify_writes: bool = True
    max_sequences: int | None = None
    mesh_axis: str = "blocks"

    def __post_init__(self):
        if not (1 <= self.block_size <= F.MAX_INPUT_SIZE):
            raise ValueError(f"block_size {self.block_size} out of range")


DEFAULT = CodecConfig()
