"""Chunk stores: the device-codec analog of the reference's proxy block device.

The reference's lz4e_bdev stack (lz4e_bdev/lz4e_dev.c, lz4e_req.c,
lz4e_under_dev.c) exposes /dev/lz4e0 over an underlying device: every write
is SG-compressed, decode-verified, and the *round-tripped original* bytes
are written through (lz4e_req.c:177-198); reads are pass-through clones
(lz4e_req.c:53-75). Its purpose is to exercise the codec in-band, not to
store compressed data.

Two stores are provided:

- ``ProxyStore`` — behavior-parity with the reference device: writes run
  the full compress + decode-verify pipeline on device, then persist the
  original bytes to the backing file; reads are pass-through. Stats count
  requests/blocks/bytes per direction exactly like lz4e_stats.
- ``CompressedStore`` — the framework-native upgrade the reference stops
  short of: chunks persist compressed (container framing per chunk group),
  reads decompress on device.

The module-level map/unmap/stats registry mirrors the sysfs admin surface
(lz4e_bdev/lz4e_module.c:27-146) — with a lock, because the reference's
unsynchronized singleton (lz4e_module.c:22,29-56) is a latent race SURVEY.md
§5 flags as not-to-be-copied.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass

import numpy as np

from . import blocks as B
from . import format as F
from .utils.stats import Stats


class StoreError(RuntimeError):
    """I/O failure; the analog of BLK_STS_* error propagation
    (lz4e_req.c:157-227)."""


class ProxyStore:
    """Verifying pass-through store over a backing file.

    Write: device-compress each chunk, decode-verify, persist the original
    bytes (lz4e_req.c:177-198 semantics). Read: pass-through
    (lz4e_req.c:53-75). Every write therefore proves the codec round-trips
    on the actual I/O data, in-band.
    """

    def __init__(self, backing_path: str, chunk_size: int = 4096,
                 capacity: int | None = None):
        if chunk_size < 1:
            raise StoreError("chunk_size must be positive")
        self.backing_path = backing_path
        self.chunk_size = chunk_size
        self.stats = Stats()
        mode = "r+b" if os.path.exists(backing_path) else "w+b"
        self._f = open(backing_path, mode)
        if capacity is not None:
            self._f.truncate(capacity)
        self._f.seek(0, os.SEEK_END)
        self.capacity = self._f.tell()
        self._lock = threading.Lock()

    # -- request path -----------------------------------------------------
    def write(self, offset: int, data: bytes) -> None:
        """Compress + verify + write-through (the reference's write request,
        lz4e_req.c:144-213). Raises StoreError if the codec pipeline fails,
        mirroring BLK_STS_IOERR on compression failure."""
        self._check_range(offset, len(data))
        try:
            cb = B.compress_to_blocks(data, self.chunk_size, verify=True)
        except Exception as e:  # codec failure -> failed request, counted
            self.stats.update(is_write=True, ok=False, blocks=0, nbytes=0)
            raise StoreError(f"compress pipeline failed: {e}") from e
        # round-trip succeeded (verify=True enforces it); write ORIGINAL
        # bytes through, as the reference does.
        with self._lock:
            self._f.seek(offset)
            self._f.write(data)
            self._f.flush()
        self.stats.update(is_write=True, ok=True, blocks=cb.num_blocks,
                          nbytes=len(data))

    def read(self, offset: int, size: int) -> bytes:
        self._check_range(offset, size)
        with self._lock:
            self._f.seek(offset)
            data = self._f.read(size)
        nblocks = max(1, -(-size // self.chunk_size))
        self.stats.update(is_write=False, ok=True, blocks=nblocks,
                          nbytes=len(data))
        return data

    # -- lifecycle --------------------------------------------------------
    def close(self) -> None:
        self._f.close()

    def info(self) -> str:
        # analog of the mapper param read: "proxy over X" (lz4e_module.c:75-94)
        return f"proxy over {self.backing_path}"

    def _check_range(self, offset: int, size: int) -> None:
        if offset < 0 or size < 0 or offset + size > self.capacity:
            raise StoreError(
                f"range [{offset}, {offset + size}) outside capacity "
                f"{self.capacity}")


class CompressedStore:
    """Chunk store that actually persists compressed data.

    Chunks are fixed-size (``chunk_size``); each occupies one container in a
    directory keyed by chunk index. Reads decompress on device; short/absent
    chunks read as zeros (sparse semantics, like a fresh ramdisk).
    """

    def __init__(self, root: str, chunk_size: int = 65536):
        self.root = root
        self.chunk_size = chunk_size
        self.stats = Stats()
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()

    def _path(self, idx: int) -> str:
        return os.path.join(self.root, f"chunk_{idx:08d}.lz4j")

    def write_chunk(self, idx: int, data: bytes) -> int:
        """Store one chunk compressed; returns compressed size."""
        if len(data) > self.chunk_size:
            raise StoreError(
                f"chunk {idx}: {len(data)} > chunk_size {self.chunk_size}")
        container = B.compress(data, self.chunk_size, verify=True,
                               stats=self.stats)
        with self._lock:
            tmp = self._path(idx) + ".tmp"
            with open(tmp, "wb") as f:
                f.write(container)
            os.replace(tmp, self._path(idx))
        return len(container)

    def read_chunk(self, idx: int) -> bytes:
        path = self._path(idx)
        if not os.path.exists(path):
            self.stats.update(is_write=False, ok=True, blocks=1, nbytes=0)
            return bytes(self.chunk_size)
        with open(path, "rb") as f:
            container = f.read()
        data = B.decompress(container, stats=self.stats)
        if len(data) < self.chunk_size:
            data = data + bytes(self.chunk_size - len(data))
        return data

    def close(self) -> None:
        pass

    def info(self) -> str:
        return f"compressed store at {self.root} (chunk {self.chunk_size})"


# -- module-level admin surface (sysfs analog) ----------------------------

@dataclass
class _Registry:
    store: ProxyStore | CompressedStore | None = None


_registry = _Registry()
_registry_lock = threading.Lock()


def map_store(backing_path: str, chunk_size: int = 4096,
              capacity: int | None = None, *,
              compressed: bool = False):
    """Create the singleton device (analog of writing the `mapper` sysfs
    param, lz4e_module.c:27-57). -EBUSY if one exists."""
    with _registry_lock:
        if _registry.store is not None:
            raise StoreError("store already mapped (EBUSY)")
        if compressed:
            _registry.store = CompressedStore(backing_path, chunk_size)
        else:
            _registry.store = ProxyStore(backing_path, chunk_size, capacity)
        return _registry.store


def unmap_store() -> None:
    """Tear down (analog of the `unmapper` param, lz4e_module.c:59-73)."""
    with _registry_lock:
        if _registry.store is None:
            raise StoreError("no store mapped (ENODEV)")
        _registry.store.close()
        _registry.store = None


def get_store():
    with _registry_lock:
        if _registry.store is None:
            raise StoreError("no store mapped (ENODEV)")
        return _registry.store


def stats_text() -> str:
    """Analog of reading the `stats` param (lz4e_module.c:96-146)."""
    return get_store().stats.render()


def stats_reset() -> None:
    """Analog of writing `reset` to the stats param."""
    get_store().stats.reset()
