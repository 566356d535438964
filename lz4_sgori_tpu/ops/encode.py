"""Batched LZ4 block encode as a dense, data-parallel XLA program.

The reference compressor (lz4e/lz4e_compress.c:218-534) is a scalar greedy
loop: hash 4 bytes, probe a single-entry hash table, extend the match
forward (LZ4E_count) and backward ("catch up"), emit token/LSIC/literals,
repeat. The decomposition here keeps the *greedy parse semantics* but
computes every ingredient for all positions at once (SURVEY.md §7 layer 3):

1. **Match-candidate discovery** — instead of a racy evolving hash table,
   the exact nearest previous occurrence of each 4-byte word is found with
   one stable sort of the words: equal words become adjacent, and the left
   neighbor in sort order *is* the most recent prior occurrence. This is a
   strict upgrade over the reference's single-probe table (which loses
   candidates to hash collisions and skip-insertions) and needs no
   sequential state.
2. **Match lengths** — forward extension is a per-position binary search
   over range equality, tested with two independent 32-bit polynomial
   prefix hashes (collision odds ~2^-64 per test; the framing layer's
   decode-verify — the reference's own every-write verify,
   lz4e_bdev/lz4e_chunk.c:119-137 — backstops exactness). Backward
   "catch-up" extension is an exact bounded byte scan.
3. **Greedy parse** — the anchor chain ``a' = nextmatch(a) + mlen`` is a
   per-position composable function, so the sequence list is extracted with
   pointer doubling (no scalar loop), exactly like the decode chain.
4. **Emission** — per-sequence byte sizes are exclusive-scanned into output
   offsets; every output byte classifies itself (token / LSIC run /
   literal / LE16 offset / LSIC match) via segment expansion and one
   gather. Blocks never exceed COMPRESSBOUND (lz4e.h:25-28).

Block-termination rules are enforced structurally: no match starts after
``n - MFLIMIT`` and match length is capped at ``n - LASTLITERALS``
(lz4e_compress.c:234-235, doc/BlockFormat.md).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .. import format as F
from . import routing
from .primitives import exclusive_cumsum, le_word, segment_ids, take1

# Two independent odd multipliers for the polynomial range hashes.
_HA = (0x9E3779B1, 0x85EBCA77)
_CATCHUP_MAX = 16  # exact backward-extension bound (see module docstring)
# Look-ahead span for lazy deferral. 1 = classic zlib-style one-step lazy
# (defer when the very next position has a strictly longer match); larger
# windows over-defer on text (measured: W=8 costs ~2 bytes on lorem-like
# data) because skipped literals are only free when the run is already open.
_LAZY_WINDOW = 1


def _prefix_hashes(b32: jax.Array, mult: int) -> jax.Array:
    """H[x] = b[0]*A^(x-1) + ... + b[x-1] (mod 2^32); H has width M+1."""
    a = jnp.uint32(mult)
    bu = b32.astype(jnp.uint32)
    mults = jnp.full(bu.shape, a, jnp.uint32)

    def combine(l, r):
        return (l[0] * r[0], l[1] * r[0] + r[1])

    _, h = jax.lax.associative_scan(combine, (mults, bu), axis=-1)
    zero = jnp.zeros(bu.shape[:-1] + (1,), jnp.uint32)
    return jnp.concatenate([zero, h], axis=-1)


def _range_eq(h, al, x1, x2, span) -> jax.Array:
    """hash-equality of b[x1:x1+span) and b[x2:x2+span) for one prefix
    hash, where span = 2^k and al = A^span (traced scalars)."""
    h1a, h1b = take1(h, x1), take1(h, x1 + span)
    h2a, h2b = take1(h, x2), take1(h, x2 + span)
    return (h1b - h1a * al) == (h2b - h2a * al)


def _prev_occurrence(w32: jax.Array) -> jax.Array:
    """Nearest previous position with an identical 4-byte word, else -1."""
    m = w32.shape[-1]
    idx = jnp.broadcast_to(jnp.arange(m, dtype=jnp.int32), w32.shape)
    order = jnp.argsort(w32.astype(jnp.uint32), axis=-1, stable=True)
    key_sorted = take1(w32, order)
    prev_sorted = jnp.concatenate(
        [jnp.full(w32.shape[:-1] + (1,), -1, jnp.int32), order[..., :-1]],
        axis=-1)
    same = jnp.concatenate(
        [jnp.zeros(w32.shape[:-1] + (1,), bool),
         key_sorted[..., 1:] == key_sorted[..., :-1]], axis=-1)
    prev_sorted = jnp.where(same, prev_sorted, -1)
    # scatter back to positional order: prev[order[k]] = prev_sorted[k]
    bidx = jnp.broadcast_to(
        jnp.arange(w32.shape[0], dtype=jnp.int32)[:, None], w32.shape)
    prev = jnp.zeros(w32.shape, jnp.int32).at[bidx, order].set(prev_sorted)
    return jnp.where(idx >= 1, prev, -1)


def _match_lengths(b, prev, raw_len, n, hashes):
    """Forward LCP beyond the guaranteed 4 bytes, via binary search on
    hash range equality; returns ml[i] = full match length at i."""
    i = jnp.broadcast_to(jnp.arange(b.shape[-1], dtype=jnp.int32), b.shape)
    matchlimit = raw_len - F.LASTLITERALS
    lim = jnp.maximum(matchlimit - (i + F.MINMATCH), 0)

    bits = max(1, (n - 1).bit_length())
    x1 = i + F.MINMATCH
    x2 = prev + F.MINMATCH

    # MSB-first binary search as a fori_loop: one gather set in the HLO
    # instead of `bits` unrolled copies (compile-time, not runtime, win).
    def step(j, cur):
        k = bits - 1 - j
        span = jnp.left_shift(jnp.int32(1), k)
        ok = (cur + span) <= lim
        for h, apow in hashes:
            al = jnp.take(apow, k)
            ok = ok & _range_eq(h, al, x1 + cur, x2 + cur, span)
        return cur + jnp.where(ok, span, 0)

    # carry init derives from `prev` (data) so its sharding/varying type
    # matches the body output under shard_map
    cur = jax.lax.fori_loop(0, bits, step, jnp.zeros_like(prev))
    return F.MINMATCH + cur


def _best_candidates(b, w32, raw_len, n, depth: int):
    """Evaluate the `depth` nearest previous occurrences of each position's
    4-byte word and keep the one with the longest exact match.

    The reference's single-probe table does not insert positions covered by
    matches (lz4e_compress.c:459-464 refills only pos-2), so its candidate
    is sometimes an *older* occurrence with a longer continuation. Chasing
    the prev-occurrence chain a few steps and taking the max match length
    dominates that behavior on real data (ties break to the nearest
    candidate). Returns (best_prev, best_ml, any_valid).
    """
    i = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32), b.shape)
    # apow[k] = A^(2^k) mod 2^32
    hashes = [(_prefix_hashes(b, mult),
               jnp.array([pow(mult, 1 << k, 1 << 32) for k in range(24)],
                         dtype=jnp.uint32))
              for mult in _HA]

    prev = _prev_occurrence(w32)
    best_prev = jnp.full_like(i, -1)
    best_ml = jnp.zeros_like(i)
    for _ in range(depth):
        valid = (prev >= 0) & (i - prev <= F.DISTANCE_MAX)
        ml = _match_lengths(b, jnp.maximum(prev, 0), raw_len, n, hashes)
        ml = jnp.where(valid, ml, 0)
        better = ml > best_ml  # strict: ties keep the nearer candidate
        best_prev = jnp.where(better, prev, best_prev)
        best_ml = jnp.where(better, ml, best_ml)
        prev = jnp.where(prev >= 0, take1(prev, jnp.maximum(prev, 0)), -1)
    return best_prev, best_ml, best_ml >= F.MINMATCH


def _backward_runs(b, prev):
    """Exact bounded catch-up: rl[i] = #t<CATCHUP_MAX with b[i-1-t]==b[prev-1-t]."""
    i = jnp.broadcast_to(jnp.arange(b.shape[-1], dtype=jnp.int32), b.shape)

    def step(t, rl):
        lhs_idx = i - 1 - t
        rhs_idx = prev - 1 - t
        ok = (lhs_idx >= 0) & (rhs_idx >= 0) & \
            (take1(b, lhs_idx) == take1(b, rhs_idx))
        return rl + jnp.where((rl == t) & ok, 1, 0)

    return jax.lax.fori_loop(0, _CATCHUP_MAX, step, jnp.zeros_like(b))


def compress_blocks_device(raw, raw_len, block_size: int,
                           match_depth: int | None = None,
                           impl: str = "auto", acceleration: int = 1):
    """Batch-bucketing wrapper around the device encode: pads the block
    count to the next power of two (with empty blocks) so recurring calls
    hit a small set of compiled shapes, then trims.

    impl: "auto" or "xla" (the one engine); other names raise ValueError
    (``ops.routing.check_impl``).

    match_depth: the number of prior occurrences of each position's
    4-byte word evaluated as match candidates. None selects depth 3.

    acceleration: LZ4_compress_fast semantics (skip-search scaling,
    lz4e_compress.c:296-307). This engine evaluates every position and
    has no skip loop, so it ignores the value and warns when it is > 1.
    """
    routing.check_impl(impl, "encode")
    raw = jnp.asarray(raw)
    raw_len = jnp.asarray(raw_len)
    nb = raw.shape[0]
    nbp = 1 << max(0, (nb - 1).bit_length())
    if nbp != nb:
        raw = jnp.pad(raw, ((0, nbp - nb), (0, 0)))
        raw_len = jnp.pad(raw_len, (0, nbp - nb))
    if acceleration > 1:
        import warnings
        warnings.warn(
            f"acceleration={acceleration} is ignored: the encoder evaluates "
            "every position and has no skip loop.", stacklevel=2)
    depth = 3 if match_depth is None else (match_depth or 1)
    comp, comp_len = _compress_blocks_impl(raw, raw_len, block_size, depth)
    if nbp != nb:
        comp, comp_len = comp[:nb], comp_len[:nb]
    return comp, comp_len


@functools.partial(jax.jit, static_argnames=("block_size", "match_depth"))
def _compress_blocks_impl(raw: jax.Array, raw_len: jax.Array,
                          block_size: int, match_depth: int = 3):
    """Encode a batch of independent LZ4 blocks on device.

    Args:
      raw: uint8 [num_blocks, block_size] input blocks, zero-padded past
        their lengths.
      raw_len: int32 [num_blocks] actual block sizes (<= block_size).
      block_size: static block capacity (the framing slot).

    Returns:
      (comp, comp_len): uint8 [num_blocks, COMPRESSBOUND(block_size)] and
      int32 [num_blocks]. Output always fits COMPRESSBOUND; the reference's
      limited-output failure mode (lz4e_compress.c:358-363) surfaces at the
      API layer as a size check instead of a mid-stream abort.
    """
    if raw.dtype != jnp.uint8:
        raise TypeError(f"raw must be uint8, got {raw.dtype}")
    n = block_size
    cb = F.compress_bound(n)
    b = raw.astype(jnp.int32)
    nblk = b.shape[0]
    rlen = raw_len.astype(jnp.int32)[:, None]
    i = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32), b.shape)

    w32 = le_word(b, 4)
    prev, ml, valid = _best_candidates(b, w32, rlen, n, depth=match_depth)
    rl = _backward_runs(b, jnp.maximum(prev, 0))
    rl = jnp.minimum(rl, jnp.maximum(prev, 0))  # cannot extend before pos 0

    mflimit = rlen - F.MFLIMIT
    has_match = valid & (i <= mflimit) & (i >= 1)

    # Windowed lazy deferral: skip the match at t when a strictly longer
    # match starts within the next _LAZY_WINDOW bytes. Skipped literals
    # cover their own output 1:1, so "longer match ahead" is the
    # end-position-dominant criterion (zlib-style lazy generalized past
    # d=1). The reference's level-1 parse is purely greedy
    # (lz4e_compress.c:291-336); this look-ahead dominates its parse
    # quality while staying per-position computable. Deferred positions
    # drop out of the match set, so multi-step deferral chains resolve
    # through the next-match scan below.
    best_alt = jnp.full_like(ml, 0)
    for d in range(1, _LAZY_WINDOW + 1):
        hm_d = jnp.pad(has_match, ((0, 0), (0, d)))[..., d:]
        ml_d = jnp.pad(ml, ((0, 0), (0, d)))[..., d:]
        best_alt = jnp.maximum(best_alt, jnp.where(hm_d, ml_d, 0))
    has_match = has_match & ~(best_alt > ml)

    # next match position at or after every position (width n+2: the anchor
    # domain is [0, n+1] with sentinel n+1)
    sent = jnp.int32(n + 1)
    cand = jnp.where(has_match, i, sent)
    nm = jnp.flip(jax.lax.cummin(jnp.flip(cand, -1), axis=cand.ndim - 1), -1)
    nm = jnp.concatenate(
        [nm, jnp.full((nblk, 2), sent, jnp.int32)], axis=-1)

    # anchor-advance function g over the anchor domain [0, n+1]
    a_dom = jnp.broadcast_to(jnp.arange(n + 2, dtype=jnp.int32), (nblk, n + 2))
    t_a = take1(nm, jnp.maximum(a_dom, 1))
    ml_t = take1(ml, jnp.minimum(t_a, n - 1))
    valid_t = t_a < sent
    g = jnp.where(valid_t, t_a + ml_t, sent)
    g = jnp.where(a_dom == sent, sent, g)

    # pointer-doubling over the anchor chain
    s_max = F.worst_case_sequences(n)
    p = jnp.zeros((nblk, 1), jnp.int32)
    while p.shape[-1] < s_max:
        p = jnp.concatenate([p, take1(g, p)], axis=-1)
        if p.shape[-1] < s_max:
            g = take1(g, g)
    p = p[..., :s_max]
    s = p.shape[-1]
    k = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), p.shape)

    # per-sequence records
    a_k = p
    t_k = take1(nm, jnp.maximum(a_k, 1))
    term_k = (t_k >= sent) | (a_k >= sent)
    t_k = jnp.minimum(t_k, n - 1)
    prev_k = take1(prev, t_k)
    ml_k = take1(ml, t_k)
    rl_k = jnp.minimum(take1(rl, t_k), t_k - a_k)  # catch-up, anchor-bounded
    kstar = jnp.argmax(term_k, axis=-1).astype(jnp.int32)[:, None]
    live = k <= kstar
    mid = k < kstar

    lit_len = jnp.where(mid, t_k - rl_k - a_k, rlen - jnp.minimum(a_k, rlen))
    lit_len = jnp.maximum(lit_len, 0)
    off_k = t_k - prev_k
    mlc = jnp.where(mid, rl_k + ml_k - F.MINMATCH, 0)  # match code (len-4)

    lit_ext = jnp.where(lit_len >= F.RUN_MASK,
                        1 + (lit_len - F.RUN_MASK) // 255, 0)
    ml_ext = jnp.where(mid & (mlc >= F.ML_MASK),
                       1 + (mlc - F.ML_MASK) // 255, 0)
    seq_bytes = jnp.where(
        mid, 1 + lit_ext + lit_len + 2 + ml_ext,
        jnp.where(live, 1 + lit_ext + lit_len, 0))
    so = exclusive_cumsum(seq_bytes)  # sequence start offsets in output
    comp_len = jnp.sum(seq_bytes, axis=-1)

    # byte-level emission over the output slot
    seg = segment_ids(so, live, cb)
    o = jnp.broadcast_to(jnp.arange(cb, dtype=jnp.int32), (nblk, cb))
    so_o = take1(so, seg)
    r = o - so_o
    lit_ext_o = take1(lit_ext, seg)
    lit_len_o = take1(lit_len, seg)
    ml_ext_o = take1(ml_ext, seg)
    mlc_o = take1(mlc, seg)
    off_o = take1(off_k, seg)
    a_o = take1(a_k, seg)
    is_mid_o = take1(mid.astype(jnp.int32), seg) == 1

    token = (jnp.minimum(lit_len_o, F.RUN_MASK) << F.ML_BITS) | \
        jnp.where(is_mid_o, jnp.minimum(mlc_o, F.ML_MASK), 0)

    lit_rem = lit_len_o - F.RUN_MASK
    ml_rem = mlc_o - F.ML_MASK

    r_lit0 = 1 + lit_ext_o                     # literals region start
    r_off0 = r_lit0 + lit_len_o                # offset region start
    r_mle0 = r_off0 + 2                        # match-LSIC region start

    in_litext = (r >= 1) & (r < r_lit0)
    in_lit = (r >= r_lit0) & (r < r_off0)
    in_off = is_mid_o & (r >= r_off0) & (r < r_mle0)
    in_mlext = is_mid_o & (r >= r_mle0)

    # LSIC extension: (count-1) bytes of 255, then rem - 255*(count-1)
    litext_val = jnp.where(r < lit_ext_o, 255,
                           lit_rem - 255 * (lit_ext_o - 1))
    mlext_r = r - r_mle0
    mlext_val = jnp.where(mlext_r < ml_ext_o - 1, 255,
                          ml_rem - 255 * (ml_ext_o - 1))

    lit_src = a_o + (r - r_lit0)
    lit_val = take1(b, lit_src)
    off_val = jnp.where(r == r_off0, off_o & 255, off_o >> 8)

    val = jnp.where(in_lit, lit_val, token)
    val = jnp.where(in_litext, litext_val, val)
    val = jnp.where(in_off, off_val, val)
    val = jnp.where(in_mlext, mlext_val, val)
    val = jnp.where(o < comp_len[:, None], val, 0)
    return val.astype(jnp.uint8), comp_len
