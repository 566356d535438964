"""Device codec ops: batched LZ4 encode/decode as dense XLA programs.

The reference's codec layer (lz4e/lz4e_compress.c, lz4e/lz4e_decompress.c) is
scalar kernel C walking scatter-gather iterators byte by byte. Here blocks are
dense ``[num_blocks, block_bytes]`` arrays and both directions are expressed as
vector programs: per-position field computation, associative scans,
pointer-doubling over the sequence chain, segment expansion, and fixpoint
match-copy rounds. See SURVEY.md §7.
"""

from .decode import decompress_blocks_device  # noqa: F401
from .encode import compress_blocks_device  # noqa: F401
