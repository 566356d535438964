"""Malformed-stream fuzz through the device decoder.

Corrupted and adversarial streams (``utils.mutants``) must get the same
verdict from the device decoder as from ``golden.decompress``: every stream
golden accepts decodes to golden's bytes, and every stream golden rejects
sets ``err``. liblz4 is a third implementation: where it and golden both
accept, the bytes agree.

The default lane runs 128 mutants of each base stream; the ``gpu`` lane
runs 2048 mutants of all of them in one batch on a card.
"""

import numpy as np
import pytest

from lz4_sgori_tpu import format as F
from lz4_sgori_tpu import golden
from lz4_sgori_tpu.utils.mutants import check_verdicts, make_mutants

BS = 4096
BASE_FIXTURES = ("text_small", "zeros_4k", "rle_period3", "random_4k",
                 "structured", "mixed")


@pytest.mark.parametrize("base", BASE_FIXTURES)
def test_mutant_verdicts_match_golden(fixtures, base):
    """128 mutants of one base stream: strict err equivalence with golden.

    On malformed corners liblz4 legitimately disagrees both ways: it
    rejects some end-of-block shapes the reference accepts, and accepts
    offset-0 matches that the reference rejects. Such disagreements are
    counted and bounded; byte agreement on mutual accepts stays strict."""
    seed = BASE_FIXTURES.index(base)
    rng = np.random.default_rng(0xC0FFEE + seed)
    bases = [golden.compress(fixtures[base][:BS])]
    muts = make_mutants(bases, rng, 128, F.compress_bound(BS) + 8)
    n_acc, n_rej, n_diverge = check_verdicts(muts, BS)
    assert n_rej >= 16, (n_acc, n_rej)
    assert n_diverge <= max(4, n_rej // 4), (n_diverge, n_rej)


@pytest.mark.gpu
def test_mutant_verdicts_gpu_scale(fixtures):
    """2048 mutants of all base streams in one batch on a card."""
    rng = np.random.default_rng(0xC0FFEE)
    bases = [golden.compress(fixtures[n][:BS]) for n in BASE_FIXTURES]
    muts = make_mutants(bases, rng, 2048, F.compress_bound(BS) + 8)
    n_acc, n_rej, n_diverge = check_verdicts(muts, BS)
    # the pool exercises both verdicts heavily; cross-implementation
    # divergence on malformed streams stays a rare corner
    assert n_acc >= 64 and n_rej >= 512, (n_acc, n_rej)
    assert n_diverge <= n_rej // 8, (n_diverge, n_rej)
