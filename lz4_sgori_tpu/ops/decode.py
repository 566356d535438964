"""Batched LZ4 block decode as a dense, data-parallel XLA program.

The reference decoder (lz4e/lz4e_decompress.c:62-460) is a scalar loop: read
token, LSIC literal length, copy literals, read LE16 offset, LSIC match
length, overlap-safe match copy, repeat. A data-parallel decomposition does
not walk bytes serially, so decode is re-expressed in four data-parallel phases
(SURVEY.md §7, layer 2):

1. **Speculative per-position parse** — every byte position is treated as if
   it were a token; literal/match lengths, LSIC extension sizes, the LE16
   offset, and the next-token position ``nxt[i]`` are computed for *all*
   positions with vector ops + clipped gathers. LSIC 0xFF runs resolve with
   one reversed cumulative-min (``next_false_index``).
2. **Sequence-chain extraction by pointer doubling** — the real token
   positions are ``0, nxt[0], nxt[nxt[0]], ...``; the chain is materialized
   in ``log2(max_sequences)`` rounds of gather-composition (no scalar loop).
3. **Literal placement by segment expansion** — per-sequence output offsets
   come from an exclusive scan of advances; a scatter+cumsum maps every
   output byte to its sequence, and literals land with one gather.
4. **Fixpoint match resolution** — self-overlapping matches (offset <
   length, the inc32/dec64 special-case at lz4e_decompress.c:93-94,407-418)
   are collapsed algebraically: the effective source of output position
   ``o`` inside a match starting at ``m`` with offset ``d`` is
   ``m - d + (o - m) mod d``, which always points *before* the match. The
   remaining cross-match dependency chain is resolved by iterating
   ``out <- where(in_match, out[esrc], out)`` to fixpoint; each round
   resolves one level of the dependency DAG and early convergence is sound.

Safe-decode semantics: malformed inputs set a per-block error flag instead
of trapping (the analog of the reference's negative return,
lz4e_decompress.c:458-459). All gathers are clipped; errors are reported,
never hidden.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .. import format as F
from . import routing
from .primitives import (exclusive_cumsum, next_false_index, segment_ids,
                         shift_left, take1)


def _parse_all_positions(b: jax.Array, comp_len: jax.Array):
    """Phase 1: speculative sequence parse at every byte position.

    b: [B, M] int32 bytes (zero-padded past comp_len); comp_len: [B, 1].
    Returns per-position int32 arrays, all shape [B, M].
    """
    m = b.shape[-1]
    i = jnp.broadcast_to(jnp.arange(m, dtype=jnp.int32), b.shape)

    nn = next_false_index(b == 255)  # first non-0xFF byte at or after i

    lit_nib = b >> 4
    ml_nib = b & 15

    # LSIC literal length: extension bytes start at i+1
    nn1 = shift_left(nn, 1, jnp.int32(m))
    k1 = nn1 - (i + 1)  # number of 0xFF bytes
    last1 = take1(b, nn1)
    lit15 = lit_nib == F.RUN_MASK
    lit_len = jnp.where(lit15, F.RUN_MASK + 255 * k1 + last1, lit_nib)
    lit_hdr = jnp.where(lit15, 1 + k1, 0)

    ls = i + 1 + lit_hdr          # literal run start
    le = ls + lit_len             # literal run end == LE16 offset position

    off = take1(b, le) | (take1(b, le + 1) << 8)

    # LSIC match length: extension bytes start at le+2
    q2 = le + 2
    nn2 = take1(nn, q2)
    k2 = nn2 - q2
    last2 = take1(b, nn2)
    ml15 = ml_nib == F.ML_MASK
    ml_len = F.MINMATCH + jnp.where(ml15, F.ML_MASK + 255 * k2 + last2, ml_nib)
    ml_hdr = jnp.where(ml15, 1 + k2, 0)

    nxt = q2 + ml_hdr             # next token position

    # Block termination: input exhausted exactly after the literals
    # (doc/BlockFormat.md termination rules; golden.decompress mirrors).
    terminal = le == comp_len
    lit_overrun = le > comp_len
    tail_overrun = ~terminal & (nxt > comp_len)

    return dict(lit_len=lit_len, ls=ls, le=le, off=off, ml_len=ml_len,
                nxt=nxt, terminal=terminal,
                parse_err=lit_overrun | tail_overrun)


def _sequence_chain(nxt: jax.Array, terminal: jax.Array, s_max: int):
    """Phase 2: materialize token positions by pointer doubling.

    Returns P: [B, s_max] int32 token positions (chain parks at the sentinel
    M-1 after the terminal sequence).
    """
    m = nxt.shape[-1]
    sent = m - 1
    i = jnp.broadcast_to(jnp.arange(m, dtype=jnp.int32), nxt.shape)
    # Terminal sequences and out-of-range successors park at the sentinel;
    # the sentinel maps to itself. nxt >= i+3 structurally, so chains are
    # strictly increasing and always reach the sentinel.
    f = jnp.where(terminal, sent, jnp.minimum(nxt, sent))
    f = jnp.where(i == sent, sent, f)

    p = jnp.zeros(nxt.shape[:-1] + (1,), jnp.int32)
    while p.shape[-1] < s_max:
        p = jnp.concatenate([p, take1(f, p)], axis=-1)
        if p.shape[-1] < s_max:
            f = take1(f, f)
    return p[..., :s_max]


def decompress_blocks_device(comp, comp_len, out_size: int,
                             max_sequences: int | None = None,
                             impl: str = "auto"):
    """Batch-bucketing wrapper around the device decode: pads the block
    count to the next power of two (with valid empty blocks) so recurring
    calls hit a small set of compiled shapes, then trims.

    impl: "auto" or "xla" (the one engine); other names raise ValueError
    (``ops.routing.check_impl``).
    """
    routing.check_impl(impl, "decode")
    comp = jnp.asarray(comp)
    comp_len = jnp.asarray(comp_len)
    nb = comp.shape[0]
    nbp = 1 << max(0, (nb - 1).bit_length())
    if nbp != nb:
        comp = jnp.pad(comp, ((0, nbp - nb), (0, 0)))
        # a zero byte is a valid empty terminal block
        comp_len = jnp.pad(comp_len, (0, nbp - nb), constant_values=1)
    out, out_len, err = _decompress_blocks_impl(
        comp, comp_len, out_size, max_sequences)
    if nbp != nb:
        out, out_len, err = out[:nb], out_len[:nb], err[:nb]
    return out, out_len, err


@functools.partial(jax.jit, static_argnames=("out_size", "max_sequences"))
def _decompress_blocks_impl(comp: jax.Array, comp_len: jax.Array,
                            out_size: int,
                            max_sequences: int | None = None):
    """Decode a batch of independent LZ4 blocks on device.

    Args:
      comp: uint8 [num_blocks, slot] compressed blocks, zero-padded; the slot
        must leave at least one pad byte after the longest block.
      comp_len: int32 [num_blocks] compressed sizes.
      out_size: static decompressed-block capacity (the framing layer's block
        size; the analog of the bio size in lz4e_req.c:144-165).
      max_sequences: static bound on sequences per block. Defaults to the
        format-worst-case out_size // 4 + 2 (back-to-back 4-byte matches).

    Returns:
      (out, out_len, err): uint8 [num_blocks, out_size], int32 [num_blocks],
      bool [num_blocks]. ``err`` is the safe-decode failure flag (malformed
      stream, offset outside output, or capacity overflow); on error the
      block's bytes and length are unspecified, mirroring the reference's
      negative-return contract (lz4e_decompress.c:458-459).
    """
    if comp.dtype != jnp.uint8:
        raise TypeError(f"comp must be uint8, got {comp.dtype}")
    if max_sequences is None:
        max_sequences = F.worst_case_sequences(out_size)
    n = out_size
    b = comp.astype(jnp.int32)
    clen = comp_len.astype(jnp.int32)[:, None]

    fields = _parse_all_positions(b, clen)
    p = _sequence_chain(fields["nxt"], fields["terminal"], max_sequences)
    s = p.shape[-1]
    k = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), p.shape)

    # Gather per-sequence records from the per-position arrays.
    term_k = take1(fields["terminal"].astype(jnp.int32), p) == 1
    lit_len_k = take1(fields["lit_len"], p)
    ls_k = take1(fields["ls"], p)
    off_k = take1(fields["off"], p)
    ml_len_k = take1(fields["ml_len"], p)
    perr_k = take1(fields["parse_err"].astype(jnp.int32), p) == 1

    has_term = jnp.any(term_k, axis=-1)
    kstar = jnp.argmax(term_k, axis=-1).astype(jnp.int32)[:, None]

    live = k <= kstar               # sequences up to and including terminal
    mid = k < kstar                 # sequences carrying a match
    adv = jnp.where(mid, lit_len_k + ml_len_k,
                    jnp.where(live, lit_len_k, 0))
    od = exclusive_cumsum(adv)      # output offset of each sequence's literals
    out_len = jnp.sum(adv, axis=-1)

    # Error aggregation (safe-decode contract).
    mstart_k = od + lit_len_k       # match destination start
    err = (~has_term
           | jnp.any(live & perr_k, axis=-1)
           | jnp.any(live & (p >= clen), axis=-1)      # walked past the end
           | jnp.any(mid & (off_k == 0), axis=-1)
           | jnp.any(mid & (off_k > mstart_k), axis=-1)
           | (out_len > n))

    # Phase 3: literal placement via segment expansion.
    seg = segment_ids(od, live, n)
    o = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32), seg.shape)
    od_o = take1(od, seg)
    lit_len_o = take1(lit_len_k, seg)
    ls_o = take1(ls_k, seg)
    off_o = jnp.maximum(take1(off_k, seg), 1)
    rel = o - od_o
    valid_o = o < out_len[:, None]
    in_lit = valid_o & (rel < lit_len_o)
    in_match = valid_o & ~in_lit
    out0 = jnp.where(in_lit, take1(b, ls_o + rel), 0)

    # Phase 4: fixpoint match resolution. Self-overlap collapses via the
    # modulo form, so esrc always points strictly before the match start.
    mstart_o = od_o + lit_len_o
    esrc = jnp.clip(mstart_o - off_o + (o - mstart_o) % off_o, 0, n - 1)

    def cond(carry):
        return carry[1]

    def body(carry):
        out, _ = carry
        nxt = jnp.where(in_match, take1(out, esrc), out)
        return nxt, jnp.any(nxt != out)

    # Initial "changed" flag derived from the data (any matches at all), so
    # the carry has consistent sharding under shard_map and blocks with no
    # matches skip the loop entirely.
    out_final, _ = jax.lax.while_loop(
        cond, body, (out0, jnp.any(in_match)))
    out_final = jnp.where(valid_o, out_final, 0).astype(jnp.uint8)
    out_len = jnp.where(err, 0, out_len)
    return out_final, out_len, err
