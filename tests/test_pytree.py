"""The pytree dataclass helper that carries learner states and device data."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from svbfm.learners.base import BlockData, PlanData
from svbfm.models.fm import FMParams
from svbfm.utils.checkpoint import load_checkpoint, save_checkpoint
from svbfm.utils.pytree import pytree_dataclass


def _params():
    return FMParams(w0=jnp.float32(0.5), w=jnp.arange(3, dtype=jnp.float32),
                    v=jnp.ones((2, 3), jnp.float32))


def test_replace_returns_an_updated_copy():
    p = _params()
    q = p.replace(w0=jnp.float32(2.0))
    assert float(q.w0) == 2.0 and float(p.w0) == 0.5
    assert q.w is p.w and q.v is p.v
    with pytest.raises(TypeError):
        p.replace(bogus=1)


def test_instances_are_frozen():
    with pytest.raises(dataclasses.FrozenInstanceError):
        _params().w0 = jnp.float32(1.0)


def test_jit_round_trip():
    @jax.jit
    def step(p):
        return p.replace(w=p.w * 2.0, v=p.v + p.w0)

    out = step(_params())
    assert isinstance(out, FMParams)
    np.testing.assert_allclose(out.w, [0.0, 2.0, 4.0])
    np.testing.assert_allclose(out.v, np.full((2, 3), 1.5))


def test_nested_pytrees_flatten_through_tuples():
    blk = BlockData(*(jnp.zeros((1, 2, 4)),) * 2, *(jnp.zeros(2),) * 5)
    plan = PlanData(blocks=((blk, blk), (blk,)), attr_group=jnp.zeros(3),
                    num_attr_per_group=jnp.ones(1), unobserved=jnp.zeros(3))
    assert len(jax.tree.leaves(plan)) == 3 * 7 + 3
    doubled = jax.tree.map(lambda a: a + 1, plan)
    assert float(doubled.blocks[1][0].cnt[0]) == 1.0


def test_checkpoint_key_paths_name_the_fields(tmp_path):
    """Checkpoints name leaves by key path; the helper must flatten to the
    attribute paths the files were written with."""
    p = _params()
    flat, _ = jax.tree_util.tree_flatten_with_path(p)
    assert [jax.tree_util.keystr(k) for k, _ in flat] == [".w0", ".w", ".v"]
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, p, step=3)
    restored, step, _ = load_checkpoint(path, p)
    assert step == 3 and isinstance(restored, FMParams)
    np.testing.assert_array_equal(restored.v, np.asarray(p.v))


def test_decorator_keeps_field_order_and_defaults():
    @pytree_dataclass
    class Pair:
        a: jax.Array
        b: object = None

    leaves = jax.tree.leaves(Pair(a=jnp.ones(2)))
    assert len(leaves) == 1
    assert [f.name for f in dataclasses.fields(Pair)] == ["a", "b"]
