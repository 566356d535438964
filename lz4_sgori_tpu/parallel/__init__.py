"""Block-data-parallel sharding and collectives (SURVEY.md §2 parallelism
inventory).

The reference is single-threaded kernel C; its seed of parallelism is that
every chunk compresses independently with its own hash table and output slot
(lz4e_bdev/lz4e_req.c:154-177). This package promotes that to the
framework's first-class parallelism axis: blocks shard over a
``jax.sharding.Mesh`` via ``shard_map``, per-shard sizes are all-gathered,
stats are ``psum``-reduced, and outputs remain in original block order
across devices.
"""

from .mesh import make_mesh  # noqa: F401
from .dist import (compress_blocks_sharded, decompress_blocks_sharded,  # noqa: F401
                   write_pipeline_sharded, initialize_multihost, stats_totals)
