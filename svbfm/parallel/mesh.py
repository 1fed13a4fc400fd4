"""Device mesh construction and sharding helpers.

The reference is a single C++ process with no parallel backend (its OpenMP
pragmas are commented out, ``fm_learn_vb.h:394,426``).  Here every learner
runs SPMD over a 1-D ``(data,)`` mesh: training rows and their e/q/t residual
caches are row-sharded, model/variational parameters are replicated, and
per-column / scalar sufficient statistics are combined with ``psum`` over the
data axis inside ``shard_map``.  A single-device mesh is the degenerate case,
so one code path serves 1 chip to a pod slice.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
FEATURE_AXIS = "feature"

_DISTRIBUTED_INITIALIZED = False


def distributed_init(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_device_ids=None) -> bool:
    """Initialize ``jax.distributed`` for multi-host SPMD training.

    The reference is strictly single-process (one C++ binary, no comm
    backend); this is the scale-out axis it never had.  After this call,
    ``jax.devices()`` returns the *global* device list across all hosts, so
    ``make_mesh``/``make_mesh2d`` transparently span the hosts and every
    ``psum`` in the learners is an NCCL all-reduce: over NVLink between the
    GPUs of one host, over the network between hosts.

    Mesh layout: put the ``data`` axis outermost so it is the one crossing
    hosts — the per-iteration cross-host traffic is then only the psum'd
    sufficient statistics (O(C·B + K·C) scalars), while the ``feature``
    axis of :func:`make_mesh2d` (which moves s_f partials every sweep)
    stays inside a host on NVLink.  ``make_mesh2d(n_feature=
    local_device_count)`` achieves this because ``jax.devices()`` orders
    devices process-major.

    Configuration sources, in priority order:
      1. explicit arguments,
      2. ``SVBFM_COORDINATOR`` / ``SVBFM_NUM_PROCESSES`` / ``SVBFM_PROCESS_ID``
         environment variables,
      3. JAX's own cluster auto-detection (Slurm, OpenMPI) when
         ``JAX_COORDINATOR_ADDRESS`` is set.

    Returns True if distributed mode was (or already is) initialized, False
    when no multi-process configuration was found (single-process runs are
    untouched — every call site may call this unconditionally).

    Idempotent: a second call is a no-op returning True.
    """
    global _DISTRIBUTED_INITIALIZED
    if _DISTRIBUTED_INITIALIZED:
        return True
    if coordinator_address is None:
        coordinator_address = os.environ.get("SVBFM_COORDINATOR")
    if num_processes is None:
        v = os.environ.get("SVBFM_NUM_PROCESSES")
        num_processes = int(v) if v else None
    if process_id is None:
        v = os.environ.get("SVBFM_PROCESS_ID")
        process_id = int(v) if v else None
    env_autodetect = "JAX_COORDINATOR_ADDRESS" in os.environ
    if coordinator_address is None and not env_autodetect:
        return False  # single-process: nothing to do
    if (num_processes or 1) > 1 or env_autodetect:
        # Cross-process collectives on the CPU backend need gloo; GPU
        # collectives use NCCL regardless of this setting.
        try:
            jax.config.update("jax_cpu_collectives_implementation", "gloo")
        except Exception:
            pass
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=local_device_ids)
    _DISTRIBUTED_INITIALIZED = True
    return True


def process_info() -> tuple[int, int]:
    """(process_index, process_count) — (0, 1) when single-process."""
    return jax.process_index(), jax.process_count()


def make_mesh(num_devices: Optional[int] = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    if num_devices is not None:
        devices = devices[:num_devices]
    return Mesh(np.asarray(devices), (DATA_AXIS,))


def make_mesh2d(n_data: Optional[int] = None, n_feature: int = 1,
                devices=None) -> Mesh:
    """2-D ``(data, feature)`` mesh for feature-sharded (tensor-parallel)
    training: rows shard over ``data``, parameter tables over ``feature``.
    With ``n_data=None`` all devices are used (``n_data = len/n_feature``)."""
    if devices is None:
        devices = jax.devices()
    if n_data is None:
        n_data = len(devices) // n_feature
    devices = devices[: n_data * n_feature]
    arr = np.asarray(devices).reshape(n_data, n_feature)
    return Mesh(arr, (DATA_AXIS, FEATURE_AXIS))


def data_spec(mesh: Mesh, *, axis: int = 0) -> NamedSharding:
    spec = [None] * (axis + 1)
    spec[axis] = DATA_AXIS
    return NamedSharding(mesh, P(*spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_rows(mesh: Mesh, arr) -> jax.Array:
    """Place a [N, ...] array row-sharded over the data axis."""
    return jax.device_put(arr, data_spec(mesh))


def put_replicated(mesh: Mesh, arr) -> jax.Array:
    return jax.device_put(arr, replicated(mesh))


def psum_data(x):
    """psum over the data axis (call inside shard_map)."""
    return jax.lax.psum(x, DATA_AXIS)
