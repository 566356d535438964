"""chip_smoke.py: its refusal without a GPU, and each phase at a tiny size
on the CPU (the sharded phase on four of the virtual CPU devices)."""

import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke
from __graft_entry__ import _synth_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_script(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_refuses_without_gpu():
    proc = _run_script(REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "needs a GPU" in proc.stderr


def test_refuses_outside_the_repository(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run_script(tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


@pytest.fixture(scope="module")
def corpus():
    return _synth_corpus(80_000, seed=9)


def test_write_path_and_cross_implementation(corpus):
    containers = chip_smoke.write_path(corpus, 4096, batch_blocks=8)
    assert len(containers) == 3              # 20 blocks in slices of 8
    chip_smoke.cross_implementation(corpus, containers, 4096, 8)


def test_cross_implementation_catches_a_wrong_container(corpus):
    containers = chip_smoke.write_path(corpus[:8192], 4096, batch_blocks=2)
    with pytest.raises(AssertionError):
        chip_smoke.cross_implementation(corpus[4096:12288], containers,
                                        4096, 2)


def test_envelope(corpus):
    chip_smoke.envelope(corpus, [4096, 8192], 16384)


def test_malformed(corpus):
    chip_smoke.malformed(corpus, 64)


def test_stores():
    chip_smoke.stores(6)


def test_timing(corpus):
    chip_smoke.timing(corpus, 4096, 4, "cpu")


def test_largest_batch_follows_the_memory_limit():
    assert chip_smoke.largest_batch(4096, 64, 1 << 40) == 64
    assert chip_smoke.largest_batch(4096, 64, 1) == 1


def test_sharded_on_four_virtual_devices(corpus):
    chip_smoke.sharded(corpus, 4096, blocks_per_card=2, n_cards=4)
