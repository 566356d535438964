"""Corrupted LZ4 block streams, and the check that holds a device decoder
to the golden decoder's verdict on them.

The safe-decode contract (lz4e_decompress.c:62-460): a stream the golden
decoder accepts decodes to golden's bytes, and a stream it rejects sets the
device decoder's ``err`` flag. liblz4, when installed, is a third
implementation; on malformed corners it legitimately disagrees both ways (it
rejects some end-of-block shapes the reference accepts, and accepts
offset-0 matches the reference rejects), so its disagreements are counted
and its bytes must agree only where both accept.
"""

from __future__ import annotations

import numpy as np

from .. import format as F
from .. import golden
from . import oracle


def mutate(comp: bytes, rng) -> bytes:
    """Random single-point corruption strategies used by the fuzz test."""
    b = bytearray(comp)
    mode = rng.integers(0, 6)
    if mode == 0 and len(b) > 2:          # flip a random byte
        i = int(rng.integers(0, len(b)))
        b[i] ^= int(rng.integers(1, 256))
    elif mode == 1:                        # truncate
        b = b[:int(rng.integers(1, len(b)))]
    elif mode == 2:                        # huge literal length chain
        b = bytearray([0xF0]) + b"\xff" * int(rng.integers(4, 64)) + b
    elif mode == 3 and len(b) > 4:         # zero an offset
        b[3] = 0
        b[4] = 0
    elif mode == 4 and len(b) > 4:         # huge offset (beyond output)
        b[3] = 0xFF
        b[4] = 0xFF
    else:                                  # garbage tail
        b = b + bytes(rng.integers(0, 256, size=16, dtype=np.uint8))
    return bytes(b)


def make_mutants(bases, rng, count: int, slot: int):
    """`count` corrupted/adversarial streams (round-4 scaled fuzz pool):
    single-point mutations plus bit flips, mid-stream surgery, stream
    splices, and pure-noise streams, all clipped to `slot`."""
    muts = []
    while len(muts) < count:
        base = bytearray(bases[int(rng.integers(0, len(bases)))])
        mode = int(rng.integers(0, 10))
        if mode < 5:
            m = mutate(bytes(base), rng)
        elif mode == 5 and len(base) > 1:  # single bit flip
            i = int(rng.integers(0, len(base)))
            base[i] ^= 1 << int(rng.integers(0, 8))
            m = bytes(base)
        elif mode == 6 and len(base) > 8:  # mid-stream LSIC injection
            i = int(rng.integers(1, len(base) - 1))
            m = bytes(base[:i]) + b"\xff" * int(rng.integers(1, 32)) \
                + bytes(base[i:])
        elif mode == 7:                    # splice two streams
            other = bases[int(rng.integers(0, len(bases)))]
            i = int(rng.integers(0, len(base)))
            j = int(rng.integers(0, len(other)))
            m = bytes(base[:i]) + bytes(other[j:])
        elif mode == 8:                    # pure noise
            m = bytes(rng.integers(0, 256, size=int(rng.integers(1, 512)),
                                   dtype=np.uint8))
        else:                              # offset surgery mid-stream
            i = int(rng.integers(0, max(1, len(base) - 2)))
            base[i:i + 2] = int(rng.integers(0, 65536)).to_bytes(2, "little")
            m = bytes(base)
        if len(m) == 0:
            m = b"\x00"
        muts.append(m[:slot])
    return muts


def check_verdicts(muts, out_size: int):
    """Decode ``muts`` in one device batch and hold every verdict to
    golden's. Returns (accepted, rejected, liblz4 disagreements)."""
    from ..ops import decompress_blocks_device

    slot = F.compress_bound(out_size) + 8
    comp = np.zeros((len(muts), slot), np.uint8)
    clen = np.zeros(len(muts), np.int32)
    for j, m in enumerate(muts):
        comp[j, :len(m)] = np.frombuffer(m, np.uint8)
        clen[j] = len(m)
    out, olen, err = decompress_blocks_device(comp, clen, out_size)
    out, olen, err = np.asarray(out), np.asarray(olen), np.asarray(err)
    n_acc = n_rej = n_diverge = 0
    for j, m in enumerate(muts):
        try:
            want = golden.decompress(m, out_size)
            ok_ref = True
        except golden.DecodeError:
            ok_ref = False
        if bool(err[j]) == ok_ref:
            raise AssertionError(
                f"mutant {j}: device err={bool(err[j])} golden ok={ok_ref}")
        lz_ok, lz_out = None, None
        if oracle.available():
            try:
                lz_out = oracle.decompress(m, out_size)
                lz_ok = True
            except ValueError:
                lz_ok = False
        if ok_ref:
            n_acc += 1
            if olen[j] != len(want) or out[j, :olen[j]].tobytes() != want:
                raise AssertionError(f"mutant {j}: device bytes differ")
            if lz_ok and lz_out != want:
                raise AssertionError(f"mutant {j}: liblz4 bytes differ")
            n_diverge += int(lz_ok is False)
        else:
            n_rej += 1
            n_diverge += int(lz_ok is True)
    return n_acc, n_rej, n_diverge
