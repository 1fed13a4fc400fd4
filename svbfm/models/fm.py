"""Factorization-machine model core (point-estimate parameters).

Parity with reference ``src/fm_core/fm_model.h``: parameters are the global
bias w0, linear weights w[D], and the factor matrix V[K, D]; prediction uses
the O(K*nnz) pairwise trick.  Initialization matches ``fm_model::init``
(w0=0, w=0, V ~ N(init_mean, init_stdev)); the learner dispatch re-inits w
~ N(0, init_stdev) for mcmc/vb/vb_online exactly as ``libfm.cpp:298,307,313``
does.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from svbfm.ops.forward import fm_scores
from svbfm.utils.pytree import pytree_dataclass

TASK_REGRESSION = 0
TASK_CLASSIFICATION = 1
TASK_POISSON = 2  # the reference's undocumented task "p" (exp-family SGD)


@pytree_dataclass
class FMParams:
    w0: jax.Array  # scalar
    w: jax.Array  # [D]
    v: jax.Array  # [K, D]


def init_fm_params(
    key: jax.Array,
    num_attributes: int,
    num_factor: int,
    init_stdev: float = 0.1,
    init_mean: float = 0.0,
    init_w_normal: bool = False,
    dtype=jnp.float32,
) -> FMParams:
    kv, kw = jax.random.split(key)
    v = init_mean + init_stdev * jax.random.normal(kv, (num_factor, num_attributes), dtype)
    if init_w_normal:
        w = init_mean + init_stdev * jax.random.normal(kw, (num_attributes,), dtype)
    else:
        w = jnp.zeros((num_attributes,), dtype)
    return FMParams(w0=jnp.zeros((), dtype), w=w, v=v)


def fm_predict(
    params: FMParams,
    ids: jax.Array,
    vals: jax.Array,
    task: int = TASK_REGRESSION,
    min_target: Optional[float] = None,
    max_target: Optional[float] = None,
    k0: bool = True,
    k1: bool = True,
    factor_chunk: int | None = None,
) -> jax.Array:
    """Scores -> task-space predictions (clamped regression / sigmoid prob)."""
    p = fm_scores(params.w0, params.w, params.v, ids, vals, k0=k0, k1=k1,
                  factor_chunk=factor_chunk)
    if task == TASK_REGRESSION:
        if max_target is not None:
            p = jnp.minimum(p, max_target)
        if min_target is not None:
            p = jnp.maximum(p, min_target)
        return p
    elif task == TASK_CLASSIFICATION:
        return jax.nn.sigmoid(p)
    else:
        return jnp.exp(p)
