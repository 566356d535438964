"""Cross-shard assembly and multi-host bring-up tests.

- assemble_container_sharded on the virtual 8-device CPU mesh must produce
  byte-identical container payloads to a single-device pack (VERDICT r1
  item 7: the explicit all_gather-of-sizes + ordered ragged assembly).
- initialize_multihost gets a real 2-process jax.distributed smoke test.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from lz4_sgori_tpu import format as F
from lz4_sgori_tpu.parallel import make_mesh
from lz4_sgori_tpu.parallel.dist import (assemble_container_sharded,
                                         compress_blocks_sharded)
from lz4_sgori_tpu.blocks import split_blocks

BS = 512


@pytest.fixture(scope="module")
def mesh():
    return make_mesh()


def test_assembly_matches_single_device(mesh, fixtures):
    data = (fixtures["text_large"] + fixtures["zeros_4k"]
            + fixtures["random_4k"] + fixtures["text_small"])
    n = mesh.devices.size
    raw, rlen = split_blocks(data, BS)
    pad = (-raw.shape[0]) % n
    if pad:
        raw = np.pad(raw, ((0, pad), (0, 0)))
        rlen = np.pad(rlen, (0, pad))
    comp, clen = compress_blocks_sharded(raw, rlen, BS, mesh)
    payload, sizes, total = assemble_container_sharded(comp, clen, mesh)
    payload, sizes, total = (np.asarray(payload), np.asarray(sizes),
                             int(total))
    comp_h, clen_h = np.asarray(comp), np.asarray(clen)
    want = b"".join(comp_h[j, :clen_h[j]].tobytes()
                    for j in range(comp_h.shape[0]))
    assert (sizes == clen_h).all()
    assert total == len(want)
    assert payload[:total].tobytes() == want


_WORKER = r"""
import os, sys
import jax
jax.config.update("jax_platforms", "cpu")
pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
from lz4_sgori_tpu.parallel import initialize_multihost
initialize_multihost(coordinator_address=f"127.0.0.1:{port}",
                     num_processes=nproc, process_id=pid)
assert jax.process_count() == nproc, jax.process_count()
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
import numpy as np
mesh = Mesh(np.array(jax.devices()), ("blocks",))
@jax.jit
def f(x):
    return x
# a real cross-process collective: psum over the global mesh
from functools import partial
@partial(jax.shard_map, mesh=mesh, in_specs=P("blocks"), out_specs=P())
def g(x):
    return jax.lax.psum(x, "blocks")
xs = jax.make_array_from_process_local_data(
    jax.sharding.NamedSharding(mesh, P("blocks")),
    np.full(1, pid + 1, np.int32), (jax.process_count(),))
out = g(xs)
expect = sum(range(1, nproc + 1))
assert int(np.asarray(out)[0]) == expect, (out, expect)
print(f"proc {pid}: psum ok = {int(np.asarray(out)[0])}")
"""


def test_initialize_multihost_two_processes(tmp_path):
    """2-process jax.distributed bring-up on CPU: initialize_multihost
    connects both processes and a psum crosses them."""
    port = "29781"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo
    # one CPU device per process (the parent test env forces 8)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(pid), "2", port],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=240)
        outs.append(out.decode())
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert "psum ok = 3" in out, out
