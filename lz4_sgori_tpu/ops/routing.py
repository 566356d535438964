"""Engine names accepted by the device codec.

Each direction has one engine: the dense XLA program in ``ops/encode.py``
and ``ops/decode.py``. ``impl`` accepts ``"auto"`` and ``"xla"``, which
both select it. The names of the removed lane-lockstep Pallas engines
raise a ``ValueError`` that says so, so a caller that forced one learns
why instead of silently getting another engine.
"""

from __future__ import annotations

IMPLS = ("auto", "xla")
REMOVED_ENCODE_IMPLS = ("enc3", "seg", "pallas")
REMOVED_DECODE_IMPLS = ("lockstep", "lockstep_v6", "lockstep_v7",
                        "lockstep_v8")


def check_impl(impl: str, direction: str) -> None:
    """Raise ValueError unless ``impl`` names the XLA engine.

    direction: "encode" or "decode"."""
    if impl in IMPLS:
        return
    removed = (REMOVED_ENCODE_IMPLS if direction == "encode"
               else REMOVED_DECODE_IMPLS)
    if impl in removed:
        raise ValueError(
            f"{direction} impl {impl!r} was a lane-lockstep Pallas engine "
            f"and has been removed; use one of {IMPLS}")
    raise ValueError(
        f"unknown {direction} impl {impl!r}; expected one of {IMPLS}")
