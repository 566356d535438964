"""Smoke test of the codec's main path on NVIDIA GPUs, in one process.

    python chip_smoke.py             # one card: every phase below
    python chip_smoke.py --cards 4   # four cards: the sharded path only

One card:

  write      a 256 MiB seeded corpus through ``blocks.compress(verify=True)``
             and ``blocks.decompress`` at 64 KiB blocks: byte-exact, with no
             host re-encode of any block
  cross      every device-encoded block decodes byte-exact under the native
             C++ codec (and liblz4 when installed); the device decodes the
             native encoder's blocks of the same corpus; the aggregate
             compressed size is at most the native encoder's
  envelope   round trip at every fio block size from 4 KiB to 4 MiB
  malformed  corrupt streams get golden's verdict from the device decoder
  stores     ProxyStore and CompressedStore take 4 KiB writes and read them
             back byte-equal
  gpu-tests  the ``gpu``-marked tests, run in this process
  timing     compile time and the median of 5 steady runs of the encode and
             decode programs

Four cards: ``parallel.write_pipeline_sharded`` and
``assemble_container_sharded`` over a 1-D mesh of the four cards on 1 GiB,
compared with one card's ``compress_blocks_device`` bytes, the packed
container body and the host's counts.

Exits non-zero, and prints no result line, when JAX finds no GPU or any
phase fails. Otherwise the last line of stdout is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

MiB = 1 << 20
BLOCK_SIZE = 65536
WRITE_BYTES = 256 * MiB
SHARDED_BYTES = 1024 * MiB
SHARDED_BLOCKS_PER_CARD = 1024     # 64 MiB of 64 KiB blocks on each card
FIO_SIZES = [4096 << k for k in range(11)]          # 4 KiB .. 4 MiB
ENVELOPE_BYTES = 4 * MiB
REPO = os.path.dirname(os.path.abspath(__file__))


def _log(msg: str) -> None:
    print(msg, flush=True)


def card_lines() -> list[str]:
    """Name and power limit of each card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def largest_batch(block_size: int, max_blocks: int,
                  bytes_limit: int) -> int:
    """Largest power-of-two block count whose encode and decode programs
    both fit in 80% of ``bytes_limit``, from their compiled memory use at
    64 blocks (it grows linearly with the block count)."""
    from lz4_sgori_tpu.ops.decode import _decompress_blocks_impl
    from lz4_sgori_tpu.ops.encode import _compress_blocks_impl

    probe = 64
    enc, _ = _compile_encode(_compress_blocks_impl, probe, block_size)
    dec, _ = _compile_decode(_decompress_blocks_impl, probe, block_size)
    per_block = max(_footprint(enc), _footprint(dec)) / probe
    batch = 1
    while batch < max_blocks and 2 * batch * per_block <= 0.8 * bytes_limit:
        batch *= 2
    return batch


def _footprint(compiled) -> int:
    m = compiled.memory_analysis()
    return (m.argument_size_in_bytes + m.output_size_in_bytes
            + m.temp_size_in_bytes)


def _memory_line(compiled) -> str:
    m = compiled.memory_analysis()
    return (f"argument {m.argument_size_in_bytes} B, output "
            f"{m.output_size_in_bytes} B, temp {m.temp_size_in_bytes} B")


def _compile_encode(fn, batch: int, block_size: int):
    import jax
    import jax.numpy as jnp

    t0 = time.perf_counter()
    compiled = fn.lower(
        jax.ShapeDtypeStruct((batch, block_size), jnp.uint8),
        jax.ShapeDtypeStruct((batch,), jnp.int32),
        block_size=block_size, match_depth=3).compile()
    return compiled, time.perf_counter() - t0


def _compile_decode(fn, batch: int, block_size: int):
    import jax
    import jax.numpy as jnp

    from lz4_sgori_tpu import format as F

    t0 = time.perf_counter()
    compiled = fn.lower(
        jax.ShapeDtypeStruct((batch, F.compress_bound(block_size) + 8),
                             jnp.uint8),
        jax.ShapeDtypeStruct((batch,), jnp.int32),
        out_size=block_size).compile()
    return compiled, time.perf_counter() - t0


def _peak_bytes() -> int | None:
    import jax

    stats = jax.devices()[0].memory_stats()
    return stats.get("peak_bytes_in_use") if stats else None


def _round_trip(data: bytes, block_size: int) -> bytes:
    """``blocks.compress`` with verify, then ``blocks.decompress``;
    requires equal bytes and no host re-encode. Returns the container."""
    from lz4_sgori_tpu import blocks
    from lz4_sgori_tpu.utils.stats import Stats

    stats = Stats()
    container = blocks.compress(data, block_size, verify=True, stats=stats)
    if stats.encode_fallbacks:
        raise AssertionError(
            f"{stats.encode_fallbacks} blocks were re-encoded on the host")
    if blocks.decompress(container) != data:
        raise AssertionError(f"round trip differs at block size {block_size}")
    return container


def write_path(data: bytes, block_size: int, batch_blocks: int) -> list:
    """Round-trip ``data`` in slices of ``batch_blocks`` blocks; returns
    the containers."""
    step = batch_blocks * block_size
    containers = []
    for s in range(0, len(data), step):
        t0 = time.perf_counter()
        containers.append(_round_trip(data[s:s + step], block_size))
        _log(f"write: {min(step, len(data) - s)} bytes in "
             f"{time.perf_counter() - t0:.3f} s (compile included on the "
             f"first slice), peak_bytes_in_use {_peak_bytes()}")
    return containers


def cross_implementation(data: bytes, containers: list, block_size: int,
                         batch_blocks: int) -> None:
    """The device's blocks against the native codec and liblz4, and the
    native encoder's blocks against the device decoder."""
    from lz4_sgori_tpu import native
    from lz4_sgori_tpu.blocks import CompressedBlocks, split_blocks
    from lz4_sgori_tpu.ops import decompress_blocks_device
    from lz4_sgori_tpu.utils import oracle

    if not native.available():
        raise RuntimeError("the native C++ codec could not be built")
    raw, rlen = split_blocks(data, block_size)
    blocks = [raw[j, :rlen[j]].tobytes() for j in range(raw.shape[0])]
    streams = []
    for c in containers:
        cb = CompressedBlocks.from_container(c)
        streams += [cb.comp[j, :cb.comp_len[j]].tobytes()
                    for j in range(cb.num_blocks)]
    if len(streams) != len(blocks):
        raise AssertionError(f"{len(streams)} streams for {len(blocks)} "
                             "blocks")
    use_lz4 = oracle.available()
    for j, (b, s) in enumerate(zip(blocks, streams)):
        if native.decompress(s, block_size) != b:
            raise AssertionError(f"native decode differs at block {j}")
        if use_lz4 and oracle.decompress(s, block_size) != b:
            raise AssertionError(f"liblz4 decode differs at block {j}")

    native_streams = [native.compress(b) for b in blocks]
    slot = max(map(len, native_streams)) + 8
    for s in range(0, len(blocks), batch_blocks):
        part = native_streams[s:s + batch_blocks]
        comp = np.zeros((len(part), slot), np.uint8)
        clen = np.array([len(p) for p in part], np.int32)
        for j, p in enumerate(part):
            comp[j, :len(p)] = np.frombuffer(p, np.uint8)
        out, out_len, err = decompress_blocks_device(comp, clen, block_size)
        out, out_len, err = (np.asarray(out), np.asarray(out_len),
                             np.asarray(err))
        if err.any() or not (out_len == rlen[s:s + len(part)]).all():
            raise AssertionError(f"device rejected native blocks near {s}")
        valid = np.arange(block_size)[None, :] < out_len[:, None]
        if not (np.where(valid, out, 0) == raw[s:s + len(part)]).all():
            raise AssertionError(f"device decode of native blocks differs "
                                 f"near block {s}")

    ours = sum(map(len, streams))
    ref = sum(map(len, native_streams))
    _log(f"cross: {len(blocks)} blocks decoded by native"
         f"{' and liblz4 ' + oracle.version() if use_lz4 else ''}; device "
         f"decoded the native encoder's blocks")
    _log(f"cross: size {ours} B vs native {ref} B: {ours / ref:.6f}")
    if ours > ref:
        raise AssertionError("aggregate size exceeds the native encoder's")
    if use_lz4:
        lz4 = sum(len(oracle.compress(b)) for b in blocks)
        _log(f"cross: size vs LZ4_compress_default {lz4} B: {ours / lz4:.6f}")
        if ours > lz4:
            raise AssertionError("aggregate size exceeds LZ4_compress_default")


def envelope(corpus: bytes, sizes: list, nbytes: int) -> None:
    """Round trip ``nbytes`` plus a partial block at each block size."""
    for bs in sizes:
        n = max(nbytes, bs) + bs // 3
        t0 = time.perf_counter()
        container = _round_trip(corpus[:n], bs)
        _log(f"envelope: {bs} B blocks, {n} B -> {len(container)} B in "
             f"{time.perf_counter() - t0:.2f} s (compile included)")


def malformed(corpus: bytes, count: int) -> None:
    """Mutants of native-encoded 4 KiB blocks of the corpus, decoded on the
    device in one batch, each held to golden's verdict."""
    from lz4_sgori_tpu import format as F
    from lz4_sgori_tpu import native
    from lz4_sgori_tpu.utils.mutants import check_verdicts, make_mutants

    bs = 4096
    bases = [native.compress(corpus[k * 7919:k * 7919 + bs])
             for k in range(8)]
    muts = make_mutants(bases, np.random.default_rng(0xFADE), count,
                        F.compress_bound(bs) + 8)
    n_acc, n_rej, n_diverge = check_verdicts(muts, bs)
    _log(f"malformed: {n_acc} accepted and {n_rej} rejected, as golden "
         f"decided; liblz4 disagreed on {n_diverge}")
    if n_rej == 0:
        raise AssertionError("no mutant was rejected")


def stores(n_chunks: int) -> None:
    """4 KiB writes through both stores, read back byte-equal."""
    from lz4_sgori_tpu.store import CompressedStore, ProxyStore

    rng = np.random.default_rng(3)
    chunks = []
    for k in range(n_chunks):
        if k % 3 == 0:
            chunks.append(bytes(4096))
        elif k % 3 == 1:
            chunks.append(rng.integers(0, 256, 4096, np.uint8).tobytes())
        else:
            chunks.append((b"block %d of the store " % k * 300)[:4096])
    with tempfile.TemporaryDirectory() as tmp:
        proxy = ProxyStore(os.path.join(tmp, "backing"), chunk_size=4096,
                           capacity=4096 * n_chunks)
        try:
            for k, c in enumerate(chunks):
                proxy.write(4096 * k, c)
            for k, c in enumerate(chunks):
                if proxy.read(4096 * k, 4096) != c:
                    raise AssertionError(f"ProxyStore chunk {k} differs")
        finally:
            proxy.close()
        if proxy.stats.write.reqs_failed or \
                proxy.stats.write.reqs_total != n_chunks:
            raise AssertionError(f"ProxyStore stats {proxy.stats.as_dict()}")
        store = CompressedStore(os.path.join(tmp, "chunks"), chunk_size=4096)
        for k, c in enumerate(chunks):
            store.write_chunk(k, c)
        for k, c in enumerate(chunks):
            if store.read_chunk(k) != c:
                raise AssertionError(f"CompressedStore chunk {k} differs")
        if store.stats.encode_fallbacks:
            raise AssertionError("CompressedStore re-encoded on the host")
    _log(f"stores: {n_chunks} chunks of 4 KiB through ProxyStore and "
         "CompressedStore")


class _Outcomes:
    """pytest plugin that counts test outcomes."""

    def __init__(self):
        self.passed = self.failed = self.skipped = 0

    def pytest_runtest_logreport(self, report):
        if report.passed and report.when == "call":
            self.passed += 1
        elif report.failed:
            self.failed += 1
        elif report.skipped:
            self.skipped += 1


def gpu_tests() -> None:
    """The ``gpu``-marked tests, in this process: a second JAX process
    could not get the card's memory."""
    import pytest

    counts = _Outcomes()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(REPO, "tests")], plugins=[counts])
    _log(f"gpu-tests: {counts.passed} passed, {counts.failed} failed, "
         f"{counts.skipped} skipped (pytest exit {rc})")
    if rc != 0 or counts.failed or counts.skipped or not counts.passed:
        raise AssertionError("gpu-marked tests did not all pass")


def _median_runs(fn, n: int = 5) -> list:
    import jax

    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return sorted(ts)


def timing(data: bytes, block_size: int, batch_blocks: int,
           card: str) -> None:
    """Compile time, memory and steady time of the encode and decode
    programs on one batch. For the record: not a benchmark."""
    import jax
    import jax.numpy as jnp

    from lz4_sgori_tpu.blocks import split_blocks
    from lz4_sgori_tpu.ops.decode import _decompress_blocks_impl
    from lz4_sgori_tpu.ops.encode import _compress_blocks_impl

    raw, rlen = split_blocks(data[:batch_blocks * block_size], block_size)
    if raw.shape[0] != batch_blocks:
        raise ValueError("timing needs a full batch of blocks")
    raw_d, rlen_d = jax.device_put(raw), jax.device_put(rlen)
    nbytes = int(rlen.sum())
    enc, t_enc = _compile_encode(_compress_blocks_impl, batch_blocks,
                                 block_size)
    _log(f"timing: encode [{batch_blocks}, {block_size}] compile "
         f"{t_enc:.2f} s; {_memory_line(enc)}")
    comp, clen = enc(raw_d, rlen_d)
    comp = jnp.pad(comp, ((0, 0), (0, 8)))
    dec, t_dec = _compile_decode(_decompress_blocks_impl, batch_blocks,
                                 block_size)
    _log(f"timing: decode [{batch_blocks}, {block_size}] compile "
         f"{t_dec:.2f} s; {_memory_line(dec)}")
    for name, fn in (("encode", lambda: enc(raw_d, rlen_d)),
                     ("decode", lambda: dec(comp, clen))):
        fn()
        ts = _median_runs(fn)
        _log(f"timing: {name} {nbytes / ts[2] / 1e9:.4f} GB/s (median of 5: "
             f"{ts[2]:.6f} s, quartiles {ts[1]:.6f}/{ts[3]:.6f} s) "
             f"on {card}")
    _log(f"timing: peak_bytes_in_use {_peak_bytes()}")


def sharded(data: bytes, block_size: int, blocks_per_card: int,
            n_cards: int) -> None:
    """The sharded write pipeline and container assembly over ``n_cards``
    devices, against one device's encode and the host's counts."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from lz4_sgori_tpu.blocks import split_blocks
    from lz4_sgori_tpu.ops import compress_blocks_device
    from lz4_sgori_tpu.parallel import (make_mesh, stats_totals,
                                        write_pipeline_sharded)
    from lz4_sgori_tpu.parallel.dist import assemble_container_sharded
    from lz4_sgori_tpu.parallel.mesh import BLOCK_AXIS

    mesh = make_mesh(n_cards)
    rows = NamedSharding(mesh, P(BLOCK_AXIS, None))
    vec = NamedSharding(mesh, P(BLOCK_AXIS))
    one = jax.devices()[0]
    step = n_cards * blocks_per_card * block_size
    for s in range(0, len(data), step):
        raw, rlen = split_blocks(data[s:s + step], block_size)
        pad = (-raw.shape[0]) % n_cards
        raw = np.pad(raw, ((0, pad), (0, 0)))
        rlen = np.pad(rlen, (0, pad))
        nb = raw.shape[0]
        raw_d, rlen_d = jax.device_put(raw, rows), jax.device_put(rlen, vec)
        shards = raw_d.addressable_shards
        if (len({sh.device for sh in shards}) != n_cards
                or any(sh.data.shape[0] != nb // n_cards for sh in shards)):
            raise AssertionError("the batch is not spread over the mesh")

        t0 = time.perf_counter()
        comp, clen, ok, stats = jax.block_until_ready(
            write_pipeline_sharded(raw_d, rlen_d, block_size, mesh))
        t1 = time.perf_counter()
        payload, sizes, total = jax.block_until_ready(
            assemble_container_sharded(comp, clen, mesh))
        t2 = time.perf_counter()
        comp1, clen1 = jax.block_until_ready(compress_blocks_device(
            jax.device_put(raw, one), jax.device_put(rlen, one), block_size))
        t3 = time.perf_counter()

        comp1, clen1 = np.asarray(comp1), np.asarray(clen1)
        if not np.asarray(ok).all():
            raise AssertionError("sharded decode-verify failed")
        if not (np.asarray(clen) == clen1).all() or \
                not np.array_equal(np.asarray(comp), comp1):
            raise AssertionError("sharded blocks differ from one card's")
        body = b"".join(comp1[j, :clen1[j]].tobytes() for j in range(nb))
        if (not (np.asarray(sizes) == clen1).all() or int(total) != len(body)
                or np.asarray(payload)[:len(body)].tobytes() != body):
            raise AssertionError("assembled container body differs")
        want = (nb, 0, int(rlen.sum()), int(clen1.sum()))
        if stats_totals(stats) != want:
            raise AssertionError(f"psum stats {stats_totals(stats)} != "
                                 f"host counts {want}")
        _log(f"sharded: {nb} blocks ({int(rlen.sum())} B) on {n_cards} "
             f"devices: pipeline {t1 - t0:.3f} s, assembly (all_gather) "
             f"{t2 - t1:.3f} s, one device's encode {t3 - t2:.3f} s "
             f"(compile included on the first batch)")
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use")
             for d in mesh.devices.flat]
    _log(f"sharded: peak_bytes_in_use per device {peaks}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4 runs only the sharded path over four cards")
    ap.add_argument("--seed", type=int, default=42,
                    help="seed of the synthetic corpus")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {devices[0].platform}",
              file=sys.stderr)
        return 1
    if len(devices) < args.cards:
        print(f"chip_smoke: needs {args.cards} GPUs; JAX found "
              f"{len(devices)}", file=sys.stderr)
        return 1
    try:
        from __graft_entry__ import _synth_corpus
        from lz4_sgori_tpu.utils.compile_cache import enable_compile_cache
    except ImportError as e:
        print(f"chip_smoke: run it from the repository root ({e})",
              file=sys.stderr)
        return 1
    cards = card_lines()
    _log(f"device_kind {devices[0].device_kind}, {len(devices)} devices, "
         f"jax {jax.__version__}, XLA_FLAGS={os.environ.get('XLA_FLAGS')!r}, "
         f"compile cache {enable_compile_cache()}")
    for ln in cards:
        _log(f"card: {ln}")

    t0 = time.perf_counter()
    if args.cards == 4:
        data = _synth_corpus(SHARDED_BYTES, seed=args.seed)
        phases = [("sharded", lambda: sharded(
            data, BLOCK_SIZE, SHARDED_BLOCKS_PER_CARD, 4))]
    else:
        data = _synth_corpus(WRITE_BYTES, seed=args.seed)
        limit = devices[0].memory_stats()["bytes_limit"]
        batch = largest_batch(BLOCK_SIZE, len(data) // BLOCK_SIZE, limit)
        _log(f"write: batch of {batch} blocks of {BLOCK_SIZE} B "
             f"(bytes_limit {limit})")
        state = {}
        phases = [
            ("write", lambda: state.update(
                containers=write_path(data, BLOCK_SIZE, batch))),
            ("cross", lambda: cross_implementation(
                data, state["containers"], BLOCK_SIZE, batch)),
            ("envelope", lambda: envelope(data, FIO_SIZES, ENVELOPE_BYTES)),
            ("malformed", lambda: malformed(data, 1024)),
            ("stores", lambda: stores(64)),
            ("gpu-tests", gpu_tests),
            ("timing", lambda: timing(data, BLOCK_SIZE, batch, cards[0])),
        ]
    _log(f"corpus: {len(data)} B, seed {args.seed}, made in "
         f"{time.perf_counter() - t0:.1f} s")

    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # noqa: BLE001 - every phase reports and goes on
            traceback.print_exc()
            failed.append(name)
            _log(f"== {name}: FAILED after {time.perf_counter() - t0:.1f} s")
            continue
        _log(f"== {name}: ok in {time.perf_counter() - t0:.1f} s")
    if failed:
        print(f"chip_smoke: failed phases: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    for ln in cards:
        _log(ln)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
