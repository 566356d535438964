"""Admin + codec CLI: the userspace analog of the reference's sysfs surface.

Reference admin surface (lz4e_bdev/lz4e_module.c:195-202):
  echo -n /dev/ram0 > .../parameters/mapper     -> `lz4j map`
  echo -n 1 > .../parameters/unmapper           -> `lz4j unmap`
  cat .../parameters/mapper                     -> `lz4j info`
  cat .../parameters/stats ; echo reset > ...   -> `lz4j stats [--reset]`
plus userspace conveniences the kernel module cannot have:
  `lz4j compress/decompress` on files (container framing),
  `lz4j verify` (fio-style round-trip sweep over a file).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time

from . import blocks
from . import store as S
from .utils.compile_cache import enable_compile_cache


def _cmd_map(args) -> int:
    st = S.map_store(args.backing, chunk_size=args.chunk_size,
                     capacity=args.capacity, compressed=args.compressed)
    print(st.info())
    return 0


def _cmd_unmap(_args) -> int:
    S.unmap_store()
    print("unmapped")
    return 0


def _cmd_info(_args) -> int:
    print(S.get_store().info())
    return 0


def _cmd_stats(args) -> int:
    if args.reset:
        S.stats_reset()
    print(S.stats_text(), end="")
    return 0


def _cmd_compress(args) -> int:
    data = open(args.input, "rb").read()
    t0 = time.perf_counter()
    container = blocks.compress(data, args.block_size,
                                verify=not args.no_verify,
                                acceleration=args.acceleration,
                                match_depth=args.match_depth)
    dt = time.perf_counter() - t0
    open(args.output, "wb").write(container)
    ratio = len(data) / max(1, len(container))
    print(f"{len(data)} -> {len(container)} bytes "
          f"(ratio {ratio:.3f}, {len(data) / dt / 1e9:.3f} GB/s incl. host)")
    return 0


def _cmd_decompress(args) -> int:
    container = open(args.input, "rb").read()
    t0 = time.perf_counter()
    data = blocks.decompress(container)
    dt = time.perf_counter() - t0
    open(args.output, "wb").write(data)
    print(f"{len(container)} -> {len(data)} bytes "
          f"({len(data) / dt / 1e9:.3f} GB/s incl. host)")
    return 0


def _cmd_verify(args) -> int:
    """Round-trip sweep across block sizes with sha256 verification — the
    fio-suite analog (test/fio_tests/global.fio: verify=sha256 over
    bs=4k..4m)."""
    data = open(args.input, "rb").read()
    ref = hashlib.sha256(data).hexdigest()
    results = []
    for bs_kib in args.block_sizes:
        bs = bs_kib * 1024
        container = blocks.compress(data, bs, verify=True)
        out = blocks.decompress(container)
        ok = hashlib.sha256(out).hexdigest() == ref
        results.append({"block_size": bs, "ok": ok,
                        "compressed": len(container)})
        status = "ok" if ok else "FAIL"
        print(f"bs={bs_kib}k: {status} ({len(container)} bytes)")
        if not ok:
            return 1
    if args.json:
        print(json.dumps(results))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="lz4j", description=__doc__)
    p.add_argument("--platform", default=None, metavar="P",
                   help="force the JAX backend (e.g. 'cpu', 'cuda'); "
                        "default: whatever the environment attached")
    sub = p.add_subparsers(dest="cmd", required=True)

    m = sub.add_parser("map", help="map a backing file as the store")
    m.add_argument("backing")
    m.add_argument("--chunk-size", type=int, default=4096)
    m.add_argument("--capacity", type=int, default=None)
    m.add_argument("--compressed", action="store_true",
                   help="store compressed chunks instead of proxy-verify")
    m.set_defaults(fn=_cmd_map)

    sub.add_parser("unmap", help="tear down the store").set_defaults(fn=_cmd_unmap)
    sub.add_parser("info", help="describe the mapped store").set_defaults(fn=_cmd_info)

    st = sub.add_parser("stats", help="print (and optionally reset) stats")
    st.add_argument("--reset", action="store_true")
    st.set_defaults(fn=_cmd_stats)

    c = sub.add_parser("compress", help="compress a file to a container")
    c.add_argument("input")
    c.add_argument("output")
    c.add_argument("--block-size", type=int, default=blocks.DEFAULT_BLOCK_SIZE)
    c.add_argument("--no-verify", action="store_true")
    c.add_argument("--acceleration", type=int, default=1,
                   help="LZ4_compress_fast-style speed/ratio knob (>=1)")
    c.add_argument("--match-depth", type=int, default=None,
                   help="1 = greedy level-1; >1 = deep-match engine; "
                        "default: engine-appropriate")
    c.set_defaults(fn=_cmd_compress)

    d = sub.add_parser("decompress", help="decompress a container to a file")
    d.add_argument("input")
    d.add_argument("output")
    d.set_defaults(fn=_cmd_decompress)

    v = sub.add_parser("verify", help="round-trip sweep with sha256 verify")
    v.add_argument("input")
    v.add_argument("--block-sizes", type=int, nargs="+",
                   default=[4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048,
                            4096],
                   help="block sizes in KiB (the full fio sweep envelope, "
                        "test_4k.fio..test_4m.fio)")
    v.add_argument("--json", action="store_true")
    v.set_defaults(fn=_cmd_verify)

    args = p.parse_args(argv)
    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)
    enable_compile_cache()
    try:
        return args.fn(args)
    except (ValueError, OSError) as e:
        # clean CLI error surface (malformed container, bad sizes, io);
        # unexpected exceptions still traceback for debuggability
        print(f"lz4j: error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
