"""Golden scalar LZ4 block codec (pure Python).

This is the framework's layer-1 oracle: a reference-semantic greedy LZ4
level-1 encoder and a safe decoder, used to validate the device codec and
cross-checked against the system liblz4 (the same way the reference
validates its SG compressor against stock kernel LZ4, lz4e_bdev/lz4e_chunk.c:119-137).

Encoder semantics follow the reference's greedy match finder
(lz4e/lz4e_compress.c:218-534): single-probe multiplicative hash table,
skip-accelerated candidate search, backward match extension ("catch up"),
LSIC length encoding, the two-byte-rollback table refill, and the
immediate-rematch fast path. It is written from the algorithm, not the code.

Not performance-critical — the device codec and the native C++ library are
the fast paths.
"""

from __future__ import annotations

from . import format as F


class DecodeError(ValueError):
    """Malformed compressed block. `position` mirrors the reference's
    negative-return convention (lz4e/lz4e_decompress.c:458-459)."""

    def __init__(self, message: str, position: int):
        super().__init__(f"{message} (at input byte {position})")
        self.position = position


def compress(src: bytes | bytearray | memoryview, acceleration: int = 1,
             max_output: int | None = None) -> bytes:
    """Greedy LZ4 block compress. Returns the compressed block.

    If `max_output` is given and the block does not fit, raises ValueError
    (the analog of the reference's limited-output 0 return,
    lz4e_compress.c:358-363,425-430,505-509).
    """
    src = bytes(src)
    n = len(src)
    if n > F.MAX_INPUT_SIZE:
        raise ValueError(f"input too large: {n} > {F.MAX_INPUT_SIZE}")
    if acceleration < 1:
        acceleration = F.ACCELERATION_DEFAULT

    limit = max_output if max_output is not None else F.compress_bound(n)
    limited = max_output is not None and max_output < F.compress_bound(n)
    dst = bytearray()

    def rd32(i: int) -> int:
        return int.from_bytes(src[i:i + 4], "little")

    hashlog = F.hashlog_for_input(n)
    small = n < F.SMALL_INPUT_LIMIT
    if small:
        def hpos(i: int) -> int:
            return F.hash4(rd32(i), hashlog)
    else:
        def hpos(i: int) -> int:
            return F.hash5(int.from_bytes(src[i:i + 8], "little"), hashlog)

    anchor = 0
    pos = 0

    if n >= F.MIN_LENGTH:
        # Last searchable match start is n - MFLIMIT inclusive (the format
        # allows matches starting up to 12 bytes before the end); the search
        # loop exits when the *next* forward position passes this limit.
        # (The reference's kernel-style bound is one position more
        # conservative, lz4e_compress.c:300-301; we use the exact format
        # limit, which can only shrink output.)
        mflimit = n - F.MFLIMIT
        matchlimit = n - F.LASTLITERALS
        table = [0] * (1 << hashlog)

        # First byte
        table[hpos(0)] = 0
        pos = 1
        fh = hpos(1)

        while True:
            # --- Find a match (skip-accelerated search) ---
            fpos = pos
            step = 1
            search_match_nb = acceleration << F.SKIPTRIGGER
            found = False
            while True:
                h = fh
                if fpos + step > mflimit + 1:
                    break  # -> last literals
                pos = fpos
                fpos += step
                step = search_match_nb >> F.SKIPTRIGGER
                search_match_nb += 1
                mpos = table[h]
                fh = hpos(fpos)
                table[h] = pos
                if (small or mpos + F.DISTANCE_MAX >= pos) and rd32(mpos) == rd32(pos):
                    found = True
                    break
            if not found:
                break  # no match found before mflimit -> last literals

            # --- Catch up (backward extension) ---
            while pos > anchor and mpos > 0 and src[pos - 1] == src[mpos - 1]:
                pos -= 1
                mpos -= 1

            # --- Encode literals ---
            lit_len = pos - anchor
            token_at = len(dst)
            dst.append(0)
            if limited and len(dst) + lit_len + (2 + 1 + F.LASTLITERALS) + lit_len // 255 > limit:
                raise ValueError("output buffer too small (literals)")
            if lit_len >= F.RUN_MASK:
                token = F.RUN_MASK << F.ML_BITS
                rem = lit_len - F.RUN_MASK
                while rem >= 255:
                    dst.append(255)
                    rem -= 255
                dst.append(rem)
            else:
                token = lit_len << F.ML_BITS
            dst += src[anchor:pos]

            # --- Encode match(es) ---
            while True:  # _next_match
                offset = pos - mpos
                dst += offset.to_bytes(2, "little")

                # match length beyond MINMATCH, capped at matchlimit
                p = pos + F.MINMATCH
                m = mpos + F.MINMATCH
                count_limit = matchlimit - p
                match_code = 0
                while match_code < count_limit and src[p + match_code] == src[m + match_code]:
                    match_code += 1
                pos = p + match_code

                if limited and len(dst) + 1 + F.LASTLITERALS + (match_code >> 8) > limit:
                    raise ValueError("output buffer too small (match)")
                if match_code >= F.ML_MASK:
                    token += F.ML_MASK
                    rem = match_code - F.ML_MASK
                    while rem >= 255:
                        dst.append(255)
                        rem -= 255
                    dst.append(rem)
                else:
                    token += match_code
                dst[token_at] = token

                anchor = pos
                if pos > mflimit:
                    break

                # Refill table at pos-2 (lz4e_compress.c:459-464)
                table[hpos(pos - 2)] = pos - 2

                # Immediate re-match test at the new position
                h = hpos(pos)
                mpos = table[h]
                table[h] = pos
                if (small or mpos + F.DISTANCE_MAX >= pos) and rd32(mpos) == rd32(pos):
                    token = 0
                    token_at = len(dst)
                    dst.append(0)
                    continue
                break

            if pos > mflimit:
                break
            pos += 1
            fh = hpos(pos)

    # --- Last literals ---
    last_run = n - anchor
    if limited and len(dst) + last_run + 1 + (last_run + 255 - F.RUN_MASK) // 255 > limit:
        raise ValueError("output buffer too small (last literals)")
    if last_run >= F.RUN_MASK:
        dst.append(F.RUN_MASK << F.ML_BITS)
        rem = last_run - F.RUN_MASK
        while rem >= 255:
            dst.append(255)
            rem -= 255
        dst.append(rem)
    else:
        dst.append(last_run << F.ML_BITS)
    dst += src[anchor:]
    return bytes(dst)


def decompress(src: bytes | bytearray | memoryview, max_output: int) -> bytes:
    """Safe LZ4 block decode: bounds-checked, raises DecodeError on malformed
    input (semantics of lz4e/lz4e_decompress.c:62-460, noDict/decode_full_block)."""
    src = bytes(src)
    ilen = len(src)
    if ilen == 0:
        raise DecodeError("empty input", 0)
    out = bytearray()
    ip = 0

    while True:
        if ip >= ilen:
            raise DecodeError("truncated block: missing token", ip)
        token = src[ip]
        ip += 1

        # literal length
        lit_len = token >> F.ML_BITS
        if lit_len == F.RUN_MASK:
            while True:
                if ip >= ilen:
                    raise DecodeError("truncated LSIC literal length", ip)
                b = src[ip]
                ip += 1
                lit_len += b
                if b != 255:
                    break
        if ip + lit_len > ilen:
            raise DecodeError("literal run exceeds input", ip)
        if len(out) + lit_len > max_output:
            raise DecodeError("literal run exceeds output capacity", ip)
        out += src[ip:ip + lit_len]
        ip += lit_len

        if ip == ilen:
            # Block termination: last sequence is literal-only
            # (doc/BlockFormat.md:17-21).
            break

        # offset
        if ip + 2 > ilen:
            raise DecodeError("truncated offset", ip)
        offset = int.from_bytes(src[ip:ip + 2], "little")
        ip += 2
        match = len(out) - offset
        if offset == 0 or match < 0:
            raise DecodeError(f"offset {offset} outside output", ip - 2)

        # match length
        match_len = (token & F.ML_MASK) + F.MINMATCH
        if (token & F.ML_MASK) == F.ML_MASK:
            while True:
                if ip >= ilen:
                    raise DecodeError("truncated LSIC match length", ip)
                b = src[ip]
                ip += 1
                match_len += b
                if b != 255:
                    break
        if len(out) + match_len > max_output:
            raise DecodeError("match exceeds output capacity", ip)

        # overlap-safe copy (offset may be < match_len)
        for _ in range(match_len):
            out.append(out[match])
            match += 1

    return bytes(out)
