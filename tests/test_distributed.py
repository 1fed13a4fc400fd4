"""Multi-host (multi-process) init smoke tests.

The reference is a single C++ process with no communication backend; the
multi-process path here is new capability (SURVEY §5 "Distributed
communication backend").  The real target is several GPU hosts; CI runs
the same code as 2 CPU processes talking gloo over localhost — the jax API
surface (distributed.initialize, global jax.devices(), psum across
processes) is identical.
"""

import os
import socket
import subprocess
import sys
import textwrap

import pytest

from svbfm.parallel import mesh as pmesh


def test_single_process_noop(monkeypatch):
    # without any coordinator config, distributed_init must be a no-op that
    # leaves single-process behavior untouched
    monkeypatch.delenv("SVBFM_COORDINATOR", raising=False)
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    assert pmesh.distributed_init() is False
    pidx, pcnt = pmesh.process_info()
    assert pidx == 0 and pcnt == 1


_CHILD = textwrap.dedent("""
    import sys
    import jax
    jax.config.update("jax_platforms", "cpu")  # env var is latched too late
    from svbfm.parallel.mesh import (distributed_init, make_mesh,
                                     process_info, shard_rows, psum_data)
    assert distributed_init() is True
    assert distributed_init() is True  # idempotent
    pidx, pcnt = process_info()
    assert pcnt == 2, pcnt
    assert jax.device_count() == 2 * jax.local_device_count()

    import numpy as np
    from functools import partial
    from jax.sharding import NamedSharding, PartitionSpec as P
    mesh = make_mesh()  # global mesh spanning both processes
    assert mesh.devices.size == jax.device_count()

    @partial(jax.shard_map, mesh=mesh, in_specs=P("data"), out_specs=P())
    def total(x):
        return psum_data(x.sum())

    # each process materializes only its local shard of the global array
    data = np.arange(16, dtype=np.float32)
    arr = jax.make_array_from_callback(
        data.shape, NamedSharding(mesh, P("data")), lambda idx: data[idx])
    out = float(np.asarray(jax.jit(total)(arr)))
    assert out == float(data.sum()), out
    print(f"OK pid={pidx} psum={out}", flush=True)
""")


@pytest.mark.skipif(sys.platform != "linux", reason="gloo/localhost test")
def test_two_process_psum(tmp_path):
    child = tmp_path / "child.py"
    child.write_text(_CHILD)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    # children run with cwd=tmp_path, so the repo root must be on their
    # PYTHONPATH explicitly; APPEND it so existing entries keep precedence
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pypath = os.pathsep.join(
        [p for p in (os.environ.get("PYTHONPATH", ""), repo_root) if p])
    procs = []
    for pid in range(2):
        env = dict(os.environ,
                   SVBFM_COORDINATOR=f"127.0.0.1:{port}",
                   SVBFM_NUM_PROCESSES="2",
                   SVBFM_PROCESS_ID=str(pid),
                   PYTHONPATH=pypath)
        # the parent conftest forces an 8-device virtual mesh via XLA_FLAGS;
        # keep the children at their natural 1 local device each
        env.pop("XLA_FLAGS", None)
        procs.append(subprocess.Popen(
            [sys.executable, str(child)], env=env, cwd=tmp_path,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for out, p in zip(outs, procs):
        assert p.returncode == 0, out
        assert "OK pid=" in out, out
