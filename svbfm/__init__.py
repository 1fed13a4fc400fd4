"""svbfm — Scalable Variational Bayesian Factorization Machines in JAX.

A from-scratch JAX/XLA re-design of the capability surface of
rishabhmisra/Scalable-Variational-Bayesian-Factorization-Machine (a libFM
1.4.2 fork with VBFM/OVBFM inference).  The reference is a single-process
C++ program built around serial Gauss-Seidel coordinate sweeps; this
framework reformulates every learner as vectorized, conflict-free binned
column sweeps that run as fused XLA programs on the GPU, and scales over
a ``jax.sharding.Mesh`` with psum'd sufficient statistics.

Inference menu (parity with the reference CLI ``-method`` flag):
  sgd, sgda, sgd_online, als, mcmc, vb, vb_online, exp_sgd, exp_sgd_stoc
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

_REPO_CACHE = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")


def compile_cache_dir(environ=None) -> str:
    """Directory of the persistent XLA compilation cache.

    ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it itself);
    otherwise one fixed directory inside the checkout.  The path is part of
    each cache entry's key, so it must not vary between runs."""
    environ = _os.environ if environ is None else environ
    return environ.get("JAX_COMPILATION_CACHE_DIR") or _REPO_CACHE


# Sweep programs over large sparse data take tens of seconds to compile
# while steady-state steps take milliseconds, so compilations are cached
# across processes.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", compile_cache_dir())

from svbfm.data.dataset import SparseDataset, SweepPlan  # noqa: E402,F401
from svbfm.models.fm import FMParams, fm_predict  # noqa: E402,F401
