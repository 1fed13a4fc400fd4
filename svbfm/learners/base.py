"""Shared learner infrastructure: config, device data bundles, eval, logs.

Mirrors the responsibilities of the reference's abstract ``fm_learn``
(``src/libfm/src/fm_learn.h:38-265``): task handling, clamped evaluation
(RMSE/MAE), classification accuracy + log10-likelihood, and the auto-named
per-iteration trajectory files (``test_rmse_<k0><k1><K>_<method>`` etc.).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from svbfm.data.dataset import SparseDataset, SweepPlan
from svbfm.data.meta import DataMetaInfo
from svbfm.parallel.mesh import DATA_AXIS, put_replicated, shard_rows
from svbfm.utils.pytree import pytree_dataclass

TASK_REGRESSION = 0
TASK_CLASSIFICATION = 1
TASK_POISSON = 2


@dataclass(frozen=True)
class FMConfig:
    """Static learner configuration (hashable; closed over by jitted steps)."""

    num_attributes: int
    num_factor: int
    k0: bool = True
    k1: bool = True
    task: int = TASK_REGRESSION
    min_target: float = -np.inf
    max_target: float = np.inf
    num_groups: int = 1
    num_iter: int = 100
    seed: int = 0
    init_stdev: float = 0.1
    # method-specific knobs (kept here so the CLI maps 1:1)
    learn_rate: float = 0.1
    reg0: float = 0.0
    regw: float = 0.0
    regv: float = 0.0
    do_sample: bool = True
    do_multilevel: bool = True
    num_batches: int = 50  # online methods' epoch chunking (-batch flag)
    # factors per block in VB/MCMC v sweeps.  0 = auto (all K at once when
    # the temps fit HBM); 1 = the reference's factor-major sequential chain.
    # Within a block the per-bin gathers are channel-stacked over factors
    # (index passes per sweep drop from O(K) to O(1)).
    # VB updates factors Jacobi-style inside a block (exact e/q patches);
    # MCMC/ALS keep EXACT sequential conditionals via closed-form
    # cross-factor corrections (learners.mcmc._v_blocked_sweep), unless
    # mcmc_factor_jacobi asks for the cheaper Jacobi fixed-point (valid for
    # deterministic ALS only — not a Gibbs kernel).
    factor_block: int = 0
    mcmc_factor_jacobi: bool = False
    # exponential-family multipliers for stochastic SGD (exp_sgd_stoc,
    # exp_fm_learn_sgd_stoc_element.h:29-43)
    exp_family: bool = False
    batch_size: int = 0  # SGD minibatch size; 0 = full vectorized "per-example" epoch
    stdev: float = 1.0  # exp-SGD residual scale (-stdev flag)
    # vb_online: re-partition chunk MEMBERSHIP every epoch like the
    # reference's per-epoch disk re-split (fm_learn_vb_online_simultaneous
    # .h:74-101).  Default False keeps membership fixed (one compiled
    # program, no per-epoch host rebuild) — measured to cost ~5e-3 test
    # RMSE at 100k rows / 10 chunks vs the reference (PARITY_RUNS.md);
    # True recovers the reference asymptote at the price of a per-epoch
    # host-side plan rebuild + chunk re-upload.
    reshuffle: bool = False

    @property
    def dim_tag(self) -> str:
        return f"{int(self.k0)}{int(self.k1)}{self.num_factor}"


@pytree_dataclass
class RowData:
    """Row-layout device arrays (sharded over the data axis)."""

    ids: jax.Array  # int32 [N, P]
    vals: jax.Array  # f32 [N, P]
    target: jax.Array  # f32 [N]
    valid: jax.Array  # f32 [N] 1.0 for real rows, 0.0 for shard padding


@pytree_dataclass
class BlockData:
    """One ColumnBlock on device (rows/x sharded on axis 0, rest replicated)."""

    rows: jax.Array  # int32 [S, C, L]
    x: jax.Array  # f32 [S, C, L]
    cols: jax.Array  # int32 [C]
    group: jax.Array  # int32 [C]
    sx2: jax.Array  # f32 [C]
    cnt: jax.Array  # f32 [C]
    col_count: jax.Array  # f32 [C]


@pytree_dataclass
class PlanData:
    """SweepPlan device arrays: nested (bins -> buckets) BlockData pytree."""

    blocks: tuple  # tuple[tuple[BlockData, ...], ...]
    attr_group: jax.Array  # int32 [D]
    num_attr_per_group: jax.Array  # f32 [G]
    unobserved: jax.Array  # bool [D]


# Datasets at or above this many rows get their row count padded to a
# multiple of ROW_QUANTUM per shard, so the large-N row-tiled cache
# patch (learners/vb.py) can run its pad-free in-place loop (tile length
# must divide the shard-local row count; 16384 = 1024 lane alignment *
# 16 max exact tile count).  Small datasets never tile, so they keep
# their exact (shard-multiple) count.
ROW_QUANTUM = 16384
_ROW_QUANTUM_MIN_ROWS = 2_000_000


def build_row_data(mesh, ds: SparseDataset):
    """Returns (RowData, num_cases)."""
    n = mesh.devices.size
    if ds.num_rows >= _ROW_QUANTUM_MIN_ROWS:
        ds = ds.padded_to(n * ROW_QUANTUM)
    ds = ds.padded_to(n)
    valid = (np.arange(ds.ids.shape[0]) < ds.num_rows).astype(np.float32)
    return RowData(
        ids=shard_rows(mesh, ds.ids),
        vals=shard_rows(mesh, ds.vals),
        target=shard_rows(mesh, ds.target),
        valid=shard_rows(mesh, valid),
    ), ds.num_rows


def build_plan_data(mesh, plan: SweepPlan, meta: DataMetaInfo) -> PlanData:
    blocks = tuple(
        tuple(
            BlockData(
                rows=shard_rows(mesh, blk.rows),
                x=shard_rows(mesh, blk.x),
                cols=put_replicated(mesh, blk.cols),
                group=put_replicated(mesh, blk.group),
                sx2=put_replicated(mesh, blk.sx2),
                cnt=put_replicated(mesh, blk.cnt),
                col_count=put_replicated(mesh, blk.col_count),
            )
            for blk in bin_blocks
        )
        for bin_blocks in plan.blocks
    )
    return PlanData(
        blocks=blocks,
        attr_group=put_replicated(mesh, meta.attr_group),
        num_attr_per_group=put_replicated(mesh, meta.num_attr_per_group.astype(np.float32)),
        unobserved=put_replicated(mesh, plan.unobserved),
    )


def plan_specs_for(plan_data: PlanData):
    """shard_map PartitionSpec pytree mirroring a PlanData's nested blocks."""
    from jax.sharding import PartitionSpec as P

    rep, shd = P(), P(DATA_AXIS)
    blocks = tuple(
        tuple(
            BlockData(rows=shd, x=shd, cols=rep, group=rep, sx2=rep, cnt=rep,
                      col_count=rep)
            for _blk in bin_blocks
        )
        for bin_blocks in plan_data.blocks
    )
    return PlanData(blocks=blocks, attr_group=rep, num_attr_per_group=rep,
                    unobserved=rep)


def named_shardings(mesh, specs):
    """Map a PartitionSpec pytree to NamedShardings for ``jit(in_shardings=)``.

    Pinning the fused programs' input shardings makes dispatch RESHARD
    mismatched inputs instead of recompiling: on a 1-device mesh a
    shard_map output comes back with spec P() even when the out_spec said
    P('data'), so feeding a run's output state into the next run would
    otherwise compile (or reload from the compile cache) a second,
    semantically identical program on the first post-warmup run() call."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    return jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                        is_leaf=lambda x: isinstance(x, P))


# ---------------------------------------------------------------------------
# Reference-parity numeric helpers
# ---------------------------------------------------------------------------

def ref_erf(x):
    """Abramowitz-Stegun 7.1.26 polynomial erf — the reference's ``erf``
    (``src/util/random.h:47-62``), kept bit-compatible for curve parity."""
    t = 1.0 / (1.0 + 0.3275911 * jnp.abs(x))
    poly = t * (0.254829592 + t * (-0.284496736 + t * (1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    r = 1.0 - poly * jnp.exp(-x * x)
    return jnp.where(x >= 0, r, -r)


def ref_cdf_gaussian(x):
    return 0.5 + 0.5 * ref_erf(0.707106781 * x)


def truncnorm_mean_positive(mu):
    """E[z | z>0], z~N(mu,1) with the reference's constants
    (``fm_learn_vb_simultaneous.h:184-188``)."""
    phi = jnp.exp(-mu * mu / 2.0) / jnp.sqrt(3.141 * 2)
    Phi = ref_cdf_gaussian(-mu)
    return mu + phi / (1 - Phi)


def truncnorm_mean_negative(mu):
    phi = jnp.exp(-mu * mu / 2.0) / jnp.sqrt(3.141 * 2)
    Phi = ref_cdf_gaussian(-mu)
    return mu - phi / Phi


def keep_finite(new, old):
    """The reference's NaN/Inf revert guard (e.g. fm_learn_vb.h:545-565)."""
    return jnp.where(jnp.isfinite(new), new, old)


def zero_counters(families):
    """All-zero nan/inf candidate-counter dict for the given parameter
    families (fixed key set => static pytree structure under jit)."""
    z = jnp.zeros((), jnp.int32)
    return {k: z for fam in families for k in (f"nan_{fam}", f"inf_{fam}")}


def counter_specs(families):
    """Replicated PartitionSpecs matching :func:`zero_counters` (every count
    derives from psum'd statistics, so all shards agree)."""
    from jax.sharding import PartitionSpec as P
    return {k: P() for fam in families for k in (f"nan_{fam}", f"inf_{fam}")}


def print_nonzero_nans(rec, verbose=True):
    """Print a history record's nonzero ``nan_*``/``inf_*`` draw counters,
    one line per iteration, matching the reference's print-only-when-nonzero
    convention (fm_learn_mcmc_simultaneous.h:100-128,
    fm_learn_vb_online_simultaneous.h:159-186)."""
    if not verbose:
        return
    bad = {k: int(v) for k, v in rec.items()
           if (k.startswith("nan_") or k.startswith("inf_")) and int(v) != 0}
    if bad:
        print("\t".join(f"#{k.split('_', 1)[0]}s in {k.split('_', 1)[1]}: {v}"
                        for k, v in bad.items()))


# ---------------------------------------------------------------------------
# Evaluation (reference _evaluate / _evaluate_class semantics)
# ---------------------------------------------------------------------------

def evaluate_regression(pred, target, min_target, max_target, normalizer=1.0,
                        num_eval_cases: Optional[int] = None):
    pred = np.asarray(pred, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    if num_eval_cases is not None:
        pred, target = pred[:num_eval_cases], target[:num_eval_cases]
    p = np.clip(pred * normalizer, min_target, max_target)
    err = p - target
    return float(np.sqrt(np.mean(err**2))), float(np.mean(np.abs(err)))


def evaluate_classification(prob, target, normalizer=1.0,
                            num_eval_cases: Optional[int] = None):
    """Accuracy + negative mean log10-likelihood (fm_learn_*_simultaneous)."""
    prob = np.asarray(prob, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    if num_eval_cases is not None:
        prob, target = prob[:num_eval_cases], target[:num_eval_cases]
    p = prob * normalizer
    acc = np.mean(((p >= 0.5) & (target > 0)) | ((p < 0.5) & (target < 0)))
    m = (target + 1.0) * 0.5
    pll = np.clip(p, 0.01, 0.99)
    ll = -np.mean(m * np.log10(pll) + (1 - m) * np.log10(1 - pll))
    return float(acc), float(ll)


def map_at_k(pred, user_ids, item_ids, positives: dict, k: int = 5):
    """MAP@k over per-user ranked predictions, using the reference's exact
    (nonstandard) average-precision recurrence (fm_learn.h:203-231): on a
    hit at 0-based rank r the AP state updates as (ap*r + 1)/(r+1) and is
    accumulated — this differs from textbook AP when misses interleave
    hits, and the curves were produced with it.

    positives: {user_id: set(item_id)} of positively-rated items.
    """
    user_ids = np.asarray(user_ids)
    item_ids = np.asarray(item_ids)
    order = np.argsort(user_ids, kind="stable")
    users, items, preds = user_ids[order], item_ids[order], np.asarray(pred)[order]
    ap_sum, n_users = 0.0, 0
    start = 0
    while start < len(users):
        end = start
        while end < len(users) and users[end] == users[start]:
            end += 1
        u = users[start]
        pos = positives.get(int(u), set())
        topk = np.argsort(-preds[start:end], kind="stable")[:k]
        ap, temp = 0.0, 0.0
        for rank, idx in enumerate(topk):
            if int(items[start + idx]) in pos:
                ap = (ap * rank + 1.0) / (rank + 1)
                temp += ap
        if len(pos) > 0:
            ap_sum += temp / len(pos)
        n_users += 1
        start = end
    return ap_sum / max(n_users, 1)


def load_map_fixture(path: str, item_offset: int = 0):
    """Implicit-feedback MAP fixture: libFM-style lines
    ``<rating> <user>:1 <item>:1`` aligned with the test rows
    (the reference hardcodes this file's path and an item offset,
    fm_learn.h:118-153; both are flags here).

    Returns (user_ids [N], item_ids [N], positives {user: set(items)}).
    """
    users, items = [], []
    positives: dict[int, set] = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 3:
                continue
            rating = int(float(parts[0]))
            user = int(parts[1].split(":")[0])
            item = int(parts[2].split(":")[0]) - item_offset
            users.append(user)
            items.append(item)
            if rating == 1:
                positives.setdefault(user, set()).add(item)
    return (np.asarray(users, np.int64), np.asarray(items, np.int64),
            positives)


class MapEval:
    """Per-iteration implicit-feedback MAP@k evaluator for classification.

    The reference evaluates MAP@5 *inside* the MCMC and OVBFM iteration
    loops (fm_learn_mcmc_simultaneous.h:270-275 on the posterior-mean
    probabilities, fm_learn_vb_online_simultaneous.h:258-262 on the current
    epoch's probabilities), using a fixture whose path is hardcoded
    (fm_learn_mcmc.h:1164-1196); here the fixture comes from the
    ``-map_eval``/``-map_item_offset``/``-map_k`` flags and is attached to a
    learner as ``learner.map_eval = MapEval.from_file(...)`` before ``run``.

    Note a deliberate deviation: the reference's ``test_user_prediction_item``
    multimap is never cleared between iterations, so its iteration-i MAP ranks
    a mixture of predictions from ALL iterations <= i; we rank each
    iteration's predictions alone (see PARITY.md).
    """

    def __init__(self, user_ids, item_ids, positives: dict, k: int = 5):
        self.user_ids = np.asarray(user_ids)
        self.item_ids = np.asarray(item_ids)
        self.positives = positives
        self.k = int(k)

    @classmethod
    def from_file(cls, path: str, item_offset: int = 0, k: int = 5) -> "MapEval":
        u, i, pos = load_map_fixture(path, item_offset)
        return cls(u, i, pos, k)

    def __call__(self, probs) -> float:
        return map_at_k(probs, self.user_ids, self.item_ids,
                        self.positives, k=self.k)


# ---------------------------------------------------------------------------
# Trajectory files (test_rmse_* / free_energy_*), reference-compatible names
# ---------------------------------------------------------------------------

class TrajectoryFile:
    def __init__(self, kind: str, cfg: FMConfig, method: str, out_dir: str = ".",
                 enabled: bool = True):
        self.path = os.path.join(out_dir, f"{kind}_{cfg.dim_tag}_{method}")
        self.enabled = enabled
        if enabled:
            open(self.path, "w").close()  # truncate at run start, like the reference

    def append(self, value: float) -> None:
        if self.enabled:
            with open(self.path, "a") as f:
                f.write(f"{value:g}\n")
