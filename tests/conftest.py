"""Test fixtures.

Tests run on the JAX CPU backend with a simulated 8-device mesh (the analog
of the reference testing against a brd ramdisk instead of real storage,
test/bash_tests/test_proxy.sh:9). ``JAX_PLATFORMS`` is only defaulted, so
``JAX_PLATFORMS=cuda python -m pytest -m gpu`` runs the tests marked
``gpu`` on a card; they skip everywhere else.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

from lz4_sgori_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def fixtures() -> dict:
    """Compressibility-spectrum fixtures mirroring the reference's test files
    (test/test_files: lorem text, larger text, incompressible JPEG) plus
    zeros/patterns for the RLE paths."""
    rng = np.random.default_rng(0xC0DEC)

    lorem = (
        b"Lorem ipsum dolor sit amet, consectetur adipiscing elit, sed do "
        b"eiusmod tempor incididunt ut labore et dolore magna aliqua. Ut enim "
        b"ad minim veniam, quis nostrud exercitation ullamco laboris nisi ut "
        b"aliquip ex ea commodo consequat. Duis aute irure dolor in "
        b"reprehenderit in voluptate velit esse cillum dolore eu fugiat nulla "
        b"pariatur. Excepteur sint occaecat cupidatat non proident, sunt in "
        b"culpa qui officia deserunt mollit anim id est laborum. "
    )
    text_small = (lorem * 12)[:4900]           # ~ test_files/01.txt scale
    text_large = (lorem * 48)[:18500]          # ~ test_files/02.txt scale
    random_big = rng.integers(0, 256, size=275_000, dtype=np.uint8).tobytes()

    # structured-but-binary data: compressible non-text
    t = np.arange(65536, dtype=np.float32)
    structured = (np.sin(t / 100.0) * 100).astype(np.int16).tobytes()

    return {
        "empty": b"",
        "one": b"A",
        "tiny": b"hello world!",            # < MIN_LENGTH
        "min_len": b"aaaaaaaaaaaaa",        # == 13 bytes
        "zeros_4k": bytes(4096),
        "zeros_64k": bytes(65536),
        "rle_short_period": b"ab" * 8192,
        "rle_period3": b"xyz" * 5000,
        "text_small": text_small,
        "text_large": text_large,
        "random_4k": rng.integers(0, 256, size=4096, dtype=np.uint8).tobytes(),
        "random_jpeg_scale": random_big,
        "structured": structured,
        "mixed": text_large + bytes(8192) + random_big[:8192] + text_small,
    }


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip a ``gpu``-marked test unless JAX's default device is a GPU.

    Decided here, when the test runs, and not while modules are imported:
    every xdist worker must collect the same tests."""
    if (request.node.get_closest_marker("gpu") is not None
            and jax.devices()[0].platform != "gpu"):
        pytest.skip("needs a GPU: run with JAX_PLATFORMS=cuda on a card")
