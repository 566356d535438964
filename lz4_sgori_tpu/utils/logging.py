"""Leveled logging + profiling hooks.

The reference's observability is printk macros (LZ4E_PR_ERR/INFO/DEBUG,
lz4e_bdev/include/lz4e_static.h:29-38) and nothing else (SURVEY.md §5: no
tracing). Here: standard logging with the same three levels, plus a
jax.profiler trace context for the bench harness (the device-side upgrade
over delegating throughput measurement to fio).
"""

from __future__ import annotations

import contextlib
import logging
import os

log = logging.getLogger("lz4_sgori_tpu")
if not log.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("lz4j %(levelname).1s %(message)s"))
    log.addHandler(_h)
    log.setLevel(os.environ.get("LZ4J_LOG", "WARNING").upper())

pr_err = log.error
pr_info = log.info
pr_debug = log.debug


@contextlib.contextmanager
def profile_trace(dirname: str | None):
    """jax.profiler trace scope; no-op when dirname is None."""
    if not dirname:
        yield
        return
    import jax
    with jax.profiler.trace(dirname):
        yield
