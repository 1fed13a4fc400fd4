"""Package-level behaviour: compile-cache placement and dependencies."""

import os
import subprocess
import sys

import jax
import pytest

import svbfm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("environ, expected", [
    ({"JAX_COMPILATION_CACHE_DIR": "/cache/here"}, "/cache/here"),
    ({}, os.path.join(REPO, ".jax_cache")),
    ({"JAX_COMPILATION_CACHE_DIR": ""}, os.path.join(REPO, ".jax_cache")),
])
def test_compile_cache_dir(environ, expected):
    assert svbfm.compile_cache_dir(environ) == expected


def test_compile_cache_in_effect_is_the_chosen_one():
    assert jax.config.jax_compilation_cache_dir == svbfm.compile_cache_dir()


_IMPORT_ALL = """
import sys
import svbfm, svbfm.cli, svbfm.serve
from svbfm.learners import (base, bpr, exp_sgd, mcmc, mcmc_bs, mcmc_windowed,
                            sgd, vb, vb_online, vb_windowed)
from svbfm.parallel import tp_mcmc, tp_ovb, tp_sgd, tp_vb
import jax
print(sorted(m for m in sys.modules if m.split(".")[0] == "flax"))
print(jax.config.jax_compilation_cache_dir)
"""


@pytest.mark.parametrize("cache_env", [None, "set"])
def test_import_leaves_flax_out_and_places_the_cache(tmp_path, cache_env):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if cache_env:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cc")
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    flax_mods, cache = out.stdout.split("\n")[:2]
    assert flax_mods == "[]"
    assert cache == (str(tmp_path / "cc") if cache_env
                     else os.path.join(REPO, ".jax_cache"))
