"""lz4_sgori_tpu — a batched LZ4 block codec on the GPU.

Built from scratch in JAX/XLA with the capabilities of the reference
project tllvvv/lz4-sgori (a Linux-kernel LZ4 over scatter-gather buffers plus
a verifying proxy block device). See SURVEY.md for the layer map.

Layer map (top-down, mirroring SURVEY.md §1):

- ``cli`` / ``store``        — admin + device surface (lz4e_bdev analog)
- ``blocks``                 — chunk framing + container (lz4e_chunk analog)
- ``parallel``               — mesh sharding + collectives (the scaling axis)
- ``ops``                    — batched device encode/decode (lz4e codec analog)
- ``format`` / ``golden``    — format contract + scalar oracle
- ``utils``                  — stats, liblz4 oracle, logging
"""

from . import blocks  # noqa: F401
from . import format  # noqa: F401
from . import golden  # noqa: F401
from .blocks import compress, decompress  # noqa: F401

__version__ = "0.1.0"

__all__ = ["format", "golden", "blocks", "compress", "decompress",
           "__version__"]
