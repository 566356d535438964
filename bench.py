"""Benchmark harness: device codec GB/s vs the reference-equivalent baseline.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.

Headline metric (BASELINE.json config 1): decompress GB/s on one GPU on a
Silesia-like mixed corpus at 64 KiB blocks (Silesia itself is unreachable
without network access, so a deterministic corpus spanning the same
compressibility regimes stands in). ``vs_baseline`` compares against
single-core liblz4 decode throughput measured on the same corpus on this
host — the reference's own speed class, since its codec is stock
single-threaded LZ4 semantics in kernel C (SURVEY.md §6: the reference
publishes no numbers).

Also measured, per BASELINE.json:
  config 2 — enwik8-like text at 256 KiB blocks (long literal runs,
             multi-byte LSIC lengths), encoded on the host by the native
             codec and decoded on the device.
  config 3 — bdev-style 4 KiB chunks, zero/random mix.
  config 5 — deep-match mode (match_depth=3) on a distinct 128 MiB corpus.
  config 6 — 1 MiB blocks: device encode and decode.

Every time is the median (with quartiles) of 5 runs that each end in
``block_until_ready``, after one warm-up run that compiles. The script
fails unless JAX's default device is a GPU.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

BLOCK_SIZE = 65536
CORPUS_MB = 32


def _log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


# Peak device-memory bandwidth by JAX device_kind, in GB/s. Source:
# NVIDIA H100 Tensor Core GPU data sheet (H100 SXM: 80 GB HBM3, 3.35 TB/s).
HBM_PEAK_GBPS = {"NVIDIA H100 80GB HBM3": 3350.0}


def hbm_peak_gbps(device_kind: str) -> float:
    """Published peak memory bandwidth of ``device_kind``; an unknown
    device is an error, not a default."""
    try:
        return HBM_PEAK_GBPS[device_kind]
    except KeyError:
        raise ValueError(f"no peak bandwidth recorded for {device_kind!r}; "
                         "add it to HBM_PEAK_GBPS with its source") from None


def _time(fn, iters: int = 5) -> dict:
    """Median and quartiles of ``iters`` runs of ``fn`` after one warm-up
    run; each run ends in block_until_ready."""
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    q1, med, q3 = np.percentile(ts, [25, 50, 75])
    return {"median": float(med), "q1": float(q1), "q3": float(q3)}


def _card_line() -> str:
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.splitlines()[0].strip()


def _synth_text(nbytes: int, seed: int = 7) -> bytes:
    """enwik8-like corpus: wiki-markup text — long natural-language literal
    runs, repeated tag/template structure, LSIC-exercising run lengths."""
    rng = np.random.default_rng(seed)
    vocab = (
        "the of and in to a is was for on as by with from at it that this "
        "article page history category external links references see also "
        "redirect template infobox population area country state city "
        "which were has had its an be are or not but his her their one "
        "two first second new old large small national international "
        "system theory science language world war year century government"
    ).split()
    parts = []
    while sum(map(len, parts)) < nbytes:
        title = " ".join(rng.choice(vocab, rng.integers(1, 4)))
        parts.append(f"<page>\n  <title>{title}</title>\n  <text>".encode())
        for _ in range(int(rng.integers(2, 8))):
            n = int(rng.integers(40, 400))
            words = rng.choice(vocab, n)
            sent = " ".join(words)
            if rng.random() < 0.3:
                sent = "[[" + sent[:20] + "]]" + sent[20:]
            parts.append(sent.encode() + b". ")
        parts.append(b"\n  </text>\n</page>\n")
    return b"".join(parts)[:nbytes]


def main() -> None:
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _synth_corpus
    from lz4_sgori_tpu import golden, native
    from lz4_sgori_tpu.blocks import split_blocks
    from lz4_sgori_tpu.ops.decode import decompress_blocks_device
    from lz4_sgori_tpu.ops.encode import compress_blocks_device
    from lz4_sgori_tpu.utils import oracle
    from lz4_sgori_tpu.utils.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {dev.platform}")
    hbm_peak = hbm_peak_gbps(dev.device_kind)
    card = _card_line()
    _log(f"{dev.device_kind}, {len(jax.devices())} devices, jax "
         f"{jax.__version__}, XLA_FLAGS={os.environ.get('XLA_FLAGS')!r}, "
         f"card {card}, compile cache {enable_compile_cache()}")

    def gbps(nbytes, t):
        return round(nbytes / t["median"] / 1e9, 4)

    def check_decode(comp, clen, raw, rlen, block_size):
        out, ln, e = decompress_blocks_device(comp, clen, block_size)
        assert int(jnp.sum(e)) == 0, "decode errors"
        assert int(jnp.sum(ln)) == int(jnp.sum(rlen)), "decoded length"
        valid = jnp.arange(block_size)[None, :] < rlen[:, None]
        mismatch = int(jnp.sum(jnp.where(valid, out != raw, False)))
        assert mismatch == 0, f"{mismatch} mismatching bytes"

    def pad8(comp):
        return jnp.pad(comp, ((0, 0), (0, 8)))

    # --- config 1 (headline): 64 KiB blocks, mixed corpus ---
    data = _synth_corpus(CORPUS_MB << 20)
    raw_np, rlen_np = split_blocks(data, BLOCK_SIZE)
    raw_all = jax.device_put(raw_np, dev)
    rlen_all = jax.device_put(rlen_np, dev)
    _log(f"corpus {CORPUS_MB} MiB, {raw_np.shape[0]} blocks of {BLOCK_SIZE}")

    comp_dev, clen_dev = compress_blocks_device(raw_all, rlen_all, BLOCK_SIZE)
    comp_total = int(jnp.sum(clen_dev))
    t_enc = _time(lambda: compress_blocks_device(raw_all, rlen_all,
                                                 BLOCK_SIZE))
    enc_gbps = gbps(len(data), t_enc)
    _log(f"encode {enc_gbps} GB/s {t_enc}, compressed {comp_total}")
    got = golden.decompress(
        np.asarray(comp_dev[0, :clen_dev[0]]).tobytes(), BLOCK_SIZE)
    assert got == data[:BLOCK_SIZE], "encode spot-check failed"

    comp_all = pad8(comp_dev)
    check_decode(comp_all, clen_dev, raw_all, rlen_all, BLOCK_SIZE)
    t_dec = _time(lambda: decompress_blocks_device(comp_all, clen_dev,
                                                   BLOCK_SIZE))
    dec_gbps = gbps(len(data), t_dec)
    _log(f"decode {dec_gbps} GB/s {t_dec}, verified bit-exact on device")

    # --- baseline: single-core liblz4 on the same blocks (the reference's
    # speed class: stock LZ4 in kernel C, single-threaded). Median of 7. ---
    base_dec_gbps = base_enc_gbps = ratio_vs_lz4 = None
    baseline_protocol = None
    if oracle.available():
        blocks_raw = [data[i:i + BLOCK_SIZE]
                      for i in range(0, len(data), BLOCK_SIZE)]
        reps = 7
        te, td = [], []
        for _ in range(reps):
            t0 = time.perf_counter()
            lz4_comps = [oracle.compress(b) for b in blocks_raw]
            te.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            for c, b in zip(lz4_comps, blocks_raw):
                oracle.decompress(c, len(b))
            td.append(time.perf_counter() - t0)
        te.sort()
        td.sort()
        base_enc_gbps = len(data) / te[reps // 2] / 1e9
        base_dec_gbps = len(data) / td[reps // 2] / 1e9
        ratio_vs_lz4 = comp_total / sum(len(c) for c in lz4_comps)
        baseline_protocol = {
            "stat": f"median of {reps}",
            "corpus": f"fixed-seed synth {CORPUS_MB} MiB @ {BLOCK_SIZE}",
            "decode_spread_gbps": [round(len(data) / td[-1] / 1e9, 3),
                                   round(len(data) / td[0] / 1e9, 3)],
            "lz4_version": oracle.version(),
        }
        _log(f"liblz4 baseline: encode {base_enc_gbps:.3f} GB/s, decode "
             f"{base_dec_gbps:.3f} GB/s, size ratio {ratio_vs_lz4:.4f}")

    # --- config 2: enwik8-like text, 256 KiB blocks, encoded on the host
    # by the native codec (LZ4_compress_default semantics) ---
    bs2 = 256 * 1024
    text = _synth_text(CORPUS_MB << 20)
    raw2_np, rlen2_np = split_blocks(text, bs2)
    comp2s = [native.compress(text[i:i + bs2])
              for i in range(0, len(text), bs2)]
    comp2_np = np.zeros((len(comp2s), max(map(len, comp2s)) + 8), np.uint8)
    clen2_np = np.zeros(len(comp2s), np.int32)
    for j, c in enumerate(comp2s):
        comp2_np[j, :len(c)] = np.frombuffer(c, np.uint8)
        clen2_np[j] = len(c)
    comp2, clen2 = jax.device_put(comp2_np, dev), jax.device_put(clen2_np, dev)
    raw2, rlen2 = jax.device_put(raw2_np, dev), jax.device_put(rlen2_np, dev)
    check_decode(comp2, clen2, raw2, rlen2, bs2)
    t_dec2 = _time(lambda: decompress_blocks_device(comp2, clen2, bs2))
    dec2_gbps = gbps(len(text), t_dec2)
    total2 = int(clen2_np.sum())
    ratio2_vs_lz4 = None
    if oracle.available():
        ratio2_vs_lz4 = total2 / sum(len(oracle.compress(text[i:i + bs2]))
                                     for i in range(0, len(text), bs2))
    _log(f"config 2: decode {dec2_gbps} GB/s {t_dec2}, ratio "
         f"{len(text) / total2:.3f}")

    # --- config 3: bdev-style 4 KiB chunks, zero/random mix ---
    rng = np.random.RandomState(77)
    raw4 = np.stack([np.zeros(4096, np.uint8) if rng.rand() < 0.5
                     else rng.randint(0, 256, 4096).astype(np.uint8)
                     for _ in range(4096)])
    raw4_d = jax.device_put(raw4, dev)
    rlen4_d = jax.device_put(np.full(4096, 4096, np.int32), dev)
    comp4, clen4 = compress_blocks_device(raw4_d, rlen4_d, 4096)
    total4 = int(jnp.sum(clen4))
    t_enc4 = _time(lambda: compress_blocks_device(raw4_d, rlen4_d, 4096))
    comp4 = pad8(comp4)
    check_decode(comp4, clen4, raw4_d, rlen4_d, 4096)
    t_dec4 = _time(lambda: decompress_blocks_device(comp4, clen4, 4096))
    enc4_gbps, dec4_gbps = gbps(raw4.size, t_enc4), gbps(raw4.size, t_dec4)
    _log(f"config 3: encode {enc4_gbps} GB/s, decode {dec4_gbps} GB/s, "
         f"ratio {raw4.size / total4:.3f}")

    # --- config 5: deep-match mode on a distinct corpus ---
    deep_mib = int(os.environ.get("LZ4J_DEEP_MIB", "128"))
    base5 = _synth_corpus(deep_mib << 20, seed=1234)
    raw5_np, rlen5_np = split_blocks(base5, BLOCK_SIZE)
    raw5, rlen5 = jax.device_put(raw5_np, dev), jax.device_put(rlen5_np, dev)
    comp5, clen5 = compress_blocks_device(raw5, rlen5, BLOCK_SIZE,
                                          match_depth=3)
    deep_total = int(jnp.sum(clen5))
    check_decode(pad8(comp5), clen5, raw5, rlen5, BLOCK_SIZE)
    t_deep = _time(lambda: compress_blocks_device(raw5, rlen5, BLOCK_SIZE,
                                                  match_depth=3))
    deep_gbps = gbps(len(base5), t_deep)
    deep_vs_lz4 = None
    if oracle.available():
        deep_vs_lz4 = deep_total / sum(
            len(oracle.compress(base5[i:i + BLOCK_SIZE]))
            for i in range(0, len(base5), BLOCK_SIZE))
    _log(f"config 5: deep encode {deep_gbps} GB/s, size vs lz4 {deep_vs_lz4}")

    # --- config 6: 1 MiB blocks ---
    bs6 = 1 << 20
    big_mib = int(os.environ.get("LZ4J_BIG_MIB", "128"))
    data6 = _synth_corpus(big_mib << 20, seed=55)
    raw6_np, rlen6_np = split_blocks(data6, bs6)
    raw6, rlen6 = jax.device_put(raw6_np, dev), jax.device_put(rlen6_np, dev)
    comp6, clen6 = compress_blocks_device(raw6, rlen6, bs6)
    total6 = int(jnp.sum(clen6))
    t_enc6 = _time(lambda: compress_blocks_device(raw6, rlen6, bs6))
    # liblz4 must decode every block bit-exactly (cross-implementation
    # contract) and the size contract holds per aggregate
    comp6_np, clen6_np = np.asarray(comp6), np.asarray(clen6)
    big_vs_lz4 = None
    if oracle.available():
        lz4_total6 = 0
        for j in range(raw6_np.shape[0]):
            blk = data6[j * bs6:(j + 1) * bs6]
            got = oracle.decompress(comp6_np[j, :clen6_np[j]].tobytes(),
                                    len(blk))
            assert got == blk, f"liblz4 decode mismatch at 1 MiB block {j}"
            lz4_total6 += len(oracle.compress(blk))
        big_vs_lz4 = total6 / lz4_total6
    comp6p = pad8(comp6)
    check_decode(comp6p, clen6, raw6, rlen6, bs6)
    t_dec6 = _time(lambda: decompress_blocks_device(comp6p, clen6, bs6))
    enc6_gbps, dec6_gbps = gbps(len(data6), t_enc6), gbps(len(data6), t_dec6)
    _log(f"config 6: encode {enc6_gbps} GB/s, decode {dec6_gbps} GB/s, "
         f"size vs lz4 {big_vs_lz4}")

    def r4(x):
        return round(x, 4) if x is not None else None

    print(json.dumps({
        "metric": "decompress_gbps_silesia_like_64k_blocks",
        "value": dec_gbps,
        "unit": "GB/s",
        "vs_baseline": r4(dec_gbps / base_dec_gbps if base_dec_gbps
                          else None),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
        "jax": jax.__version__,
        "xla_flags": os.environ.get("XLA_FLAGS"),
        "corpus_mb": CORPUS_MB,
        "decode_time_s": t_dec,
        "encode_gbps": enc_gbps,
        "encode_time_s": t_enc,
        "encode_vs_lz4": r4(enc_gbps / base_enc_gbps if base_enc_gbps
                            else None),
        "ratio": round(len(data) / comp_total, 4),
        "compressed_size_vs_lz4": r4(ratio_vs_lz4),
        "baseline_liblz4_decode_gbps": r4(base_dec_gbps),
        "baseline_protocol": baseline_protocol,
        "hbm_peak_gbps": hbm_peak,
        "hbm_fraction": round(dec_gbps / hbm_peak, 6),
        "enwik8_256k_decode_gbps": dec2_gbps,
        "enwik8_256k_ratio": round(len(text) / total2, 4),
        "enwik8_256k_size_vs_lz4": r4(ratio2_vs_lz4),
        "bdev_4k_mix_encode_gbps": enc4_gbps,
        "bdev_4k_mix_decode_gbps": dec4_gbps,
        "bdev_4k_mix_ratio": round(raw4.size / total4, 4),
        "deep_encode_gbps": deep_gbps,
        "deep_ratio": round(len(base5) / deep_total, 4),
        "deep_size_vs_lz4": r4(deep_vs_lz4),
        "big_1m_encode_gbps": enc6_gbps,
        "big_1m_decode_gbps": dec6_gbps,
        "big_1m_ratio": round(len(data6) / total6, 4),
        "big_1m_size_vs_lz4": r4(big_vs_lz4),
    }))


if __name__ == "__main__":
    main()
