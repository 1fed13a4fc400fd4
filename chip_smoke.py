"""Smoke test of the training path on NVIDIA GPUs.

    python chip_smoke.py              # one card: phases 0-6
    python chip_smoke.py --cards 4    # four cards: the multi-card phase only

Drives the libFM-compatible CLI and the learners at MovieLens-1M width
(6,040 users x 3,952 items, about 1M train and 100k test rows, K=20) on data
generated from fixed seeds, compares every result with its reference, and
prints one line per phase: ``phase=<name> ok=<bool> seconds=<s> {numbers}``.
The last line is one JSON object naming the device.  The script refuses to
run on anything but a GPU, and a failed phase makes it exit non-zero.

Phases on one card:
  0 device        devices, versions, card name and power limit, XLA_FLAGS,
                  the native tools build and the libFM parser in use
  1 parity        VB (factor_block=1) and ALS against the float64 oracles of
                  tests/oracle.py
  2 main          ``-method vb -iter 5`` through the CLI against the recorded
                  CPU trajectory; compile time, steady time per sweep, memory
  3 learners      mcmc, als, vb_online and sgd through the CLI against the
                  recorded CPU trajectories
  4 out_of_core   windowed VB (``-cache_size``) from binary files against
                  resident VB; streaming vb_online from a binary file
  5 workarounds   row/column-tiled VB as fused multi-sweep programs against
                  one sweep per program; blocked against sequential ALS-BS
  6 serve_resume  BatchScorer against the learner's scores; a checkpointed
                  and resumed CLI run against an uninterrupted one

With ``--cards 4``: data-parallel VB and MCMC on four cards against one,
feature-sharded VB on (2, 2) and (1, 4) meshes, and one CLI run with
``-feature_shards 4``.

The CPU trajectories (chip_smoke_trajectory.json) are recorded by
``JAX_PLATFORMS=cpu python scripts/record_smoke_trajectory.py``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import re
import resource
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
TRAJECTORY = os.path.join(REPO, "chip_smoke_trajectory.json")
WORKDIR = os.path.join(REPO, ".smoke_work")


@dataclasses.dataclass(frozen=True)
class Sizes:
    users: int
    items: int
    ratings: int            # rows generated; 1/11 of them become the test set
    num_factor: int
    vb_iters: int           # phase 2
    iters: int              # every other run
    timed_sweeps: int       # phase 2 steady-state window
    parity_users: int       # phase 1 (the oracles are serial float64 loops)
    parity_items: int
    parity_ratings: int
    parity_factor: int
    tile_budget: int        # phase 5: VB_TILE_BUDGET low enough to tile
    cache_size: int         # phase 4: -cache_size bytes, >= 4 windows
    bs_rows: int            # phase 5 relational problem
    bs_users: int
    bs_items: int
    bs_attrs: int
    bs_factor: int


# MovieLens-1M width, generated as bench.py does (seeds 42/43).
FULL = Sizes(users=6040, items=3952, ratings=1_100_000, num_factor=20,
             vb_iters=5, iters=3, timed_sweeps=5,
             parity_users=60, parity_items=40, parity_ratings=3000,
             parity_factor=4, tile_budget=32 * 1024 * 1024,
             cache_size=6_000_000, bs_rows=200_000, bs_users=5000,
             bs_items=1000, bs_attrs=4, bs_factor=8)

# CPU test size: every phase at a few thousand rows.
TINY = Sizes(users=40, items=30, ratings=5500, num_factor=4,
             vb_iters=3, iters=2, timed_sweeps=2,
             parity_users=9, parity_items=7, parity_ratings=96,
             parity_factor=3, tile_budget=4096, cache_size=20_000,
             bs_rows=400, bs_users=11, bs_items=6, bs_attrs=2, bs_factor=3)

# The CLI runs compared with the recorded CPU trajectories.
CLI_RUNS = ("vb", "mcmc", "als", "vb_online", "sgd")

# Relative tolerance of each run's per-iteration test RMSE and free energy
# against the CPU trajectory (None: not compared), and why it is that wide.
BANDS = {
    # deterministic coordinate ascent; only the order of float32 sums
    # differs between the CPU and GPU compilers
    "vb": (1e-3, 1e-3),
    # deterministic ALS; float32 reassociation as for vb
    "als": (2e-3, None),
    # the Gibbs draws use the same random bits, but each conditions on
    # float32 sums that reassociate differently on the GPU, so the chain
    # drifts from the CPU one
    "mcmc": (1e-2, None),
    # deterministic natural-gradient steps; float32 reassociation
    "vb_online": (2e-3, 2e-3),
    # example-level scatter-adds (learners/sgd.py) are atomics on the GPU:
    # the summation order, and so the bits, change from run to run
    "sgd": (1e-2, None),
}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def max_rel_dev(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    check(got.shape == want.shape, f"shape {got.shape} != {want.shape}")
    check(bool(np.isfinite(got).all()), f"non-finite values: {got}")
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))


def within(name: str, got, want, rtol: float) -> float:
    dev = max_rel_dev(got, want)
    check(dev <= rtol, f"{name}: max relative deviation {dev:.3g} > {rtol:g}"
          f"\n got  {list(np.asarray(got))}\n want {list(np.asarray(want))}")
    return dev


# ---------------------------------------------------------------------------
# Device, card and memory
# ---------------------------------------------------------------------------

def require_gpu(devices, count: int = 1) -> None:
    """Exit non-zero unless JAX found at least ``count`` GPUs."""
    platform = devices[0].platform if devices else "none"
    if platform != "gpu" or len(devices) < count:
        raise SystemExit(f"chip_smoke: needs {count} GPU(s); JAX found "
                         f"{len(devices)} device(s) of platform {platform!r}")


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def card_name_and_power() -> str:
    """``name, power.limit`` of each card, from nvidia-smi (which does not
    touch JAX's hold on the card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())


def device_memory_stat(device, key: str) -> int | None:
    """``bytes_in_use`` or ``peak_bytes_in_use`` of the device's allocator,
    or None where the backend keeps no statistics (the CPU)."""
    stats = device.memory_stats()
    return None if stats is None else int(stats[key])


def host_rss_bytes() -> int | None:
    """Resident set size of this process, or None where /proc lacks it."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, IndexError, ValueError):
        return None


class MemoryWatch:
    """Peak device bytes in use and host RSS over a with-block.

    The allocator's ``peak_bytes_in_use`` and ``getrusage``'s ``ru_maxrss``
    cover the whole process, so a thread samples both every 2 ms instead;
    ``numbers`` reports the process-wide ``ru_maxrss`` beside them."""

    def __init__(self, device):
        self.device = device
        self.device_peak = None
        self.host_peak = None

    def _sample(self):
        for attr, value in (("device_peak",
                             device_memory_stat(self.device, "bytes_in_use")),
                            ("host_peak", host_rss_bytes())):
            if value is not None:
                setattr(self, attr, max(getattr(self, attr) or 0, value))

    def _poll(self):
        while not self._stop.wait(0.002):
            self._sample()

    def __enter__(self):
        self._sample()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self._sample()
        return False

    def numbers(self) -> dict:
        return {"device_peak_bytes_sampled": self.device_peak,
                "host_peak_rss_bytes_sampled": self.host_peak,
                "host_maxrss_process_bytes":
                    resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024}


# ---------------------------------------------------------------------------
# Data and CLI runs
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Data:
    train_txt: str
    test_txt: str
    train_bin: str          # prefix of the reference-format .x/.y files
    train: object           # COOData as the CLI parses it
    test: object
    D: int


def make_data(workdir: str, s: Sizes) -> Data:
    from svbfm.data.binary import save_coo_binary
    from svbfm.data.libfm_text import load_libfm_text, save_libfm_text
    from svbfm.data.synth import make_movielens_like, train_test_split

    coo = make_movielens_like(num_users=s.users, num_items=s.items,
                              num_ratings=s.ratings, rank=8, noise=0.6,
                              seed=42)
    tr, te = train_test_split(coo, 1.0 / 11.0, seed=43)
    os.makedirs(workdir, exist_ok=True)
    paths = [os.path.join(workdir, n) for n in ("train.libfm", "test.libfm",
                                                "train_bin")]
    save_libfm_text(paths[0], tr)
    save_libfm_text(paths[1], te)
    save_coo_binary(paths[2], tr)
    train, test = load_libfm_text(paths[0]), load_libfm_text(paths[1])
    return Data(*paths, train=train, test=test,
                D=max(train.num_features, test.num_features))


def run_cli(args, rundir: str) -> str:
    """Run the CLI in-process inside ``rundir`` (it writes its trajectory
    files to the working directory) and return what it printed."""
    from svbfm.cli import main

    shutil.rmtree(rundir, ignore_errors=True)
    os.makedirs(rundir)
    log = os.path.join(rundir, "stdout.txt")
    old = os.getcwd()
    os.chdir(rundir)
    try:
        with open(log, "w") as f, contextlib.redirect_stdout(f):
            rc = main(list(args))
    finally:
        os.chdir(old)
    check(rc == 0, f"CLI {args} returned {rc}")
    with open(log) as f:
        return f.read()


def _read_floats(path: str) -> list[float]:
    with open(path) as f:
        return [float(x) for x in f.read().split()]


def printed_test_rmse(stdout: str) -> list[float]:
    """Per-iteration ``Test=`` values of the CLI's ``#Iter=`` lines."""
    return [float(m) for m in re.findall(r"^#Iter=.*\tTest=([^\t\n]+)",
                                         stdout, re.M)]


class Smoke:
    """What the phases share: sizes, work directory, data, references."""

    def __init__(self, sizes: Sizes, workdir: str, reference=None):
        self.sizes = sizes
        self.workdir = workdir
        self.reference = reference      # {"runs": {name: trajectory}}
        self.vb_state = None            # set by phase 2, used by phase 6

    @functools.cached_property
    def data(self) -> Data:
        return make_data(self.workdir, self.sizes)

    @functools.cached_property
    def device(self):
        import jax
        return jax.devices()[0]

    def cli_args(self, name: str) -> list[str]:
        s, d = self.sizes, self.data
        common = ["-task", "r", "-train", d.train_txt, "-test", d.test_txt,
                  "-dim", f"1,1,{s.num_factor}"]
        it = ["-iter", str(s.iters)]
        return {
            "vb": common + ["-method", "vb", "-iter", str(s.vb_iters)],
            "mcmc": common + ["-method", "mcmc"] + it,
            "als": common + ["-method", "als", "-regular", "0.05"] + it,
            "vb_online": common + ["-method", "vb_online"] + it,
            "sgd": common + ["-method", "sgd", "-learn_rate", "0.01"] + it,
        }[name]

    def cli_trajectory(self, name: str, args=None) -> dict:
        """Run one CLI configuration; its per-iteration test RMSE (and free
        energy for the VB methods) from the trajectory files."""
        args = self.cli_args(name) if args is None else args
        rundir = os.path.join(self.workdir, f"run_{name}")
        out = run_cli(args, rundir)
        method = args[args.index("-method") + 1]
        suffix = {"als": "mcmc"}.get(method, method)
        tag = f"11{self.sizes.num_factor}_{suffix}"
        traj = {"rmse": _read_floats(os.path.join(rundir, f"test_rmse_{tag}"))}
        fe = os.path.join(rundir, f"free_energy_{tag}")
        if os.path.exists(fe):
            traj["free_energy"] = _read_floats(fe)
        traj["stdout"] = out
        return traj

    def compare_with_reference(self, name: str, traj: dict) -> dict:
        rtol_rmse, rtol_fe = BANDS[name]
        want = self.reference["runs"][name]
        out = {"test_rmse": traj["rmse"],
               "rmse_max_rel_dev": within(f"{name} test RMSE", traj["rmse"],
                                          want["rmse"], rtol_rmse)}
        if rtol_fe is not None:
            out["free_energy"] = traj["free_energy"]
            out["fe_max_rel_dev"] = within(
                f"{name} free energy", traj["free_energy"],
                want["free_energy"], rtol_fe)
        return out

    def config(self):
        """FMConfig and DataMetaInfo as the CLI builds them for this data."""
        from svbfm.data.meta import DataMetaInfo
        from svbfm.learners.base import FMConfig

        tr = self.data.train
        cfg = FMConfig(num_attributes=self.data.D,
                       num_factor=self.sizes.num_factor,
                       min_target=float(tr.target.min()),
                       max_target=float(tr.target.max()), num_groups=1)
        return cfg, DataMetaInfo(self.data.D)

    def datasets(self):
        from svbfm.data.dataset import SparseDataset
        return (SparseDataset.from_coo(self.data.train, self.data.D),
                SparseDataset.from_coo(self.data.test, self.data.D))


def record_reference(ctx: Smoke) -> dict:
    """The trajectories of every compared CLI run (on the current backend)."""
    import jax
    runs = {}
    for name in CLI_RUNS:
        traj = ctx.cli_trajectory(name)
        traj.pop("stdout")
        runs[name] = traj
    return {"sizes": dataclasses.asdict(ctx.sizes),
            "platform": jax.devices()[0].platform,
            "jax": jax.__version__, "runs": runs}


def load_reference(sizes: Sizes) -> dict:
    with open(TRAJECTORY) as f:
        ref = json.load(f)
    check(ref["sizes"] == dataclasses.asdict(sizes),
          f"{TRAJECTORY} was recorded at other sizes; re-record it")
    check(ref["platform"] == "cpu", f"{TRAJECTORY} is not a CPU recording")
    return ref


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_device(ctx: Smoke) -> dict:
    import jax
    import jaxlib

    tools = subprocess.run(["make", "-C", os.path.join(REPO, "tools"), "-s"],
                           capture_output=True, text=True, timeout=600)
    check(tools.returncode == 0,
          f"make -C tools failed ({tools.returncode}): {tools.stderr[-400:]}")
    from svbfm.data import libfm_text
    devs = jax.devices()
    return {"devices": [str(d) for d in devs],
            "device_kind": devs[0].device_kind, "count": len(devs),
            "jax": jax.__version__, "jaxlib": jaxlib.__version__,
            "card": card_name_and_power(),
            "XLA_FLAGS": os.environ.get("XLA_FLAGS", ""),
            "tools_build_stderr": tools.stderr.strip()[-400:],
            "libfm_parser": ("native" if libfm_text._load_native() is not None
                             else "python")}


def phase_parity(ctx: Smoke) -> dict:
    """factor_block=1 VB and ALS against the float64 oracles, with the
    tolerances of tests/test_vb.py and tests/test_mcmc.py."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from oracle import ALSOracle, VBOracle

    from svbfm.data.dataset import SparseDataset
    from svbfm.data.meta import DataMetaInfo
    from svbfm.data.synth import make_movielens_like, train_test_split
    from svbfm.learners.base import FMConfig
    from svbfm.learners.mcmc import ALSLearner
    from svbfm.learners.vb import VBLearner
    from svbfm.parallel.mesh import make_mesh

    s = ctx.sizes
    coo = make_movielens_like(num_users=s.parity_users,
                              num_items=s.parity_items,
                              num_ratings=s.parity_ratings, rank=2,
                              noise=0.4, seed=2)
    tr, te = train_test_split(coo, 0.25, seed=3)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, s.parity_users])
    base = dict(num_attributes=D, num_factor=s.parity_factor,
                min_target=float(tr.target.min()),
                max_target=float(tr.target.max()),
                num_groups=meta.num_attr_groups, seed=7, factor_block=1)
    tr_ds, te_ds = SparseDataset.from_coo(tr, D), SparseDataset.from_coo(te, D)
    close = np.testing.assert_allclose
    out = {"rows": tr.num_rows, "D": D, "K": s.parity_factor}

    vb = VBLearner(FMConfig(**base), tr_ds, te_ds, meta, mesh=make_mesh(1),
                   write_files=False)
    st = vb.init_state()
    orc = VBOracle(tr.row, tr.col, tr.val, tr.target, D, s.parity_factor,
                   groups=meta.attr_group)
    orc.init(float(st.mu_0), float(st.sigma_0_dash), np.asarray(st.mu_w),
             np.asarray(st.sigma_w_dash), np.asarray(st.mu_v),
             np.asarray(st.sigma_v_dash))
    dev = 0.0
    for _ in range(3):
        st, fe = vb._step(st, vb.train_row, vb.plan_data)
        fe_o = orc.iterate()
        close(np.asarray(st.mu_w), orc.mu_w, rtol=3e-3, atol=3e-4)
        close(np.asarray(st.mu_v), orc.mu_v, rtol=3e-3, atol=3e-4)
        close(np.asarray(st.sigma_w_dash), orc.sigma_w_dash, rtol=3e-3,
              atol=1e-6)
        close(float(st.alpha), orc.alpha, rtol=3e-3)
        close(float(st.mu_0), orc.mu_0, rtol=3e-3, atol=1e-5)
        close(float(fe), fe_o, rtol=2e-3)
        dev = max(dev, float(np.max(np.abs(np.asarray(st.mu_v) - orc.mu_v))))
    out["vb_max_abs_dev_mu_v"] = dev

    als = ALSLearner(FMConfig(**base, regw=0.05, regv=0.05), tr_ds, te_ds,
                     meta, mesh=make_mesh(1), write_files=False)
    st = als.init_state()
    orc = ALSOracle(tr.row, tr.col, tr.val, tr.target, D, s.parity_factor,
                    groups=meta.attr_group, regw=0.05, regv=0.05)
    orc.init(float(st.w0), np.asarray(st.w), np.asarray(st.v))
    dev = 0.0
    for _ in range(3):
        st, _nans = als._step(st, als.train_row, als.plan_data)
        orc.iterate()
        close(float(st.w0), orc.w0, rtol=2e-3, atol=1e-5)
        close(np.asarray(st.w), orc.w, rtol=5e-3, atol=5e-4)
        close(np.asarray(st.v), orc.v, rtol=5e-3, atol=5e-4)
        close(np.asarray(st.e)[: tr.num_rows], orc.e, rtol=5e-3, atol=5e-3)
        dev = max(dev, float(np.max(np.abs(np.asarray(st.v) - orc.v))))
    out["als_max_abs_dev_v"] = dev
    return out


def phase_main(ctx: Smoke) -> dict:
    """The CLI's batch VB run against the CPU trajectory, then the sweep
    program's compile time, steady time and memory."""
    import jax

    from svbfm.learners.vb import VBLearner

    traj = ctx.cli_trajectory("vb")
    out = ctx.compare_with_reference("vb", traj)

    cfg, meta = ctx.config()
    tr_ds, te_ds = ctx.datasets()
    learner = VBLearner(cfg, tr_ds, te_ds, meta, write_files=False)
    state = learner.init_state()
    rest = () if learner._rest_valid is None else (learner._rest_valid,)
    t0 = time.perf_counter()
    compiled = learner._fused_steps(1).lower(
        state, learner.train_row, learner.plan_data, learner.test_row,
        *rest).compile()
    out["compile_seconds"] = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    out["sweep_memory_analysis"] = {
        k: getattr(mem, k) for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "alias_size_in_bytes", "temp_size_in_bytes",
            "generated_code_size_in_bytes") if hasattr(mem, k)}
    state, _ = learner.run(state, num_iter=1, chunk=1, verbose=False)
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    state, hist = learner.run(state, num_iter=ctx.sizes.timed_sweeps,
                              chunk=1, verbose=False)
    jax.block_until_ready(state)
    out["steady_seconds_per_sweep"] = ((time.perf_counter() - t0)
                                       / ctx.sizes.timed_sweeps)
    check(all(np.isfinite(r["rmse"]) for r in hist), "non-finite test RMSE")
    out["card"] = card_name_and_power()
    out["peak_bytes_in_use"] = device_memory_stat(ctx.device,
                                                  "peak_bytes_in_use")
    ctx.vb_state = (learner, state)
    return out


def phase_learners(ctx: Smoke) -> dict:
    out = {}
    for name in ("mcmc", "als", "vb_online", "sgd"):
        out[name] = ctx.compare_with_reference(name, ctx.cli_trajectory(name))
    return out


def phase_out_of_core(ctx: Smoke) -> dict:
    """Windowed VB from binary files against resident VB at the same
    factor block, and streaming vb_online from a binary file."""
    s, d = ctx.sizes, ctx.data
    common = ["-task", "r", "-test", d.test_txt, "-dim",
              f"1,1,{s.num_factor}", "-iter", str(s.iters)]
    vb = ["-method", "vb", "-factor_block", "4"]
    out = {}
    runs = {
        "resident_vb": common + vb + ["-train", d.train_txt],
        "windowed_vb": common + vb + ["-train", d.train_bin,
                                      "-cache_size", str(s.cache_size)],
        "streaming_vb_online": common + ["-method", "vb_online",
                                         "-train", d.train_bin],
    }
    traj = {}
    for name, args in runs.items():
        with MemoryWatch(ctx.device) as mw:
            traj[name] = ctx.cli_trajectory(name, args)
        out[name] = {"test_rmse": traj[name]["rmse"], **mw.numbers()}
    windows = re.search(r"# out-of-core: (\d+) windows",
                        traj["windowed_vb"]["stdout"])
    check(windows is not None and int(windows.group(1)) >= 4,
          "windowed VB ran fewer than 4 windows")
    out["windows"] = int(windows.group(1))
    # windows split each column's sum into per-window partial sums
    out["windowed_rmse_max_rel_dev"] = within(
        "windowed VB test RMSE", traj["windowed_vb"]["rmse"],
        traj["resident_vb"]["rmse"], 2e-4)
    out["windowed_fe_max_rel_dev"] = within(
        "windowed VB free energy", traj["windowed_vb"]["free_energy"],
        traj["resident_vb"]["free_energy"], 2e-4)
    # streaming chunks are contiguous row ranges of the file, the in-memory
    # chunks a seeded permutation, so the two runs differ by more than
    # rounding; both must converge to the same level
    got = traj["streaming_vb_online"]["rmse"]
    check(bool(np.isfinite(got).all()) and got[-1] < got[0],
          f"streaming vb_online did not converge: {got}")
    out["streaming_final_rel_dev"] = within(
        "streaming vb_online final test RMSE", got[-1:],
        ctx.reference["runs"]["vb_online"]["rmse"][-1:], 2e-2)
    return out


def _bs_relation(num_rows: int, num_attrs: int, seed: int):
    """One-hot id plus ``num_attrs`` attributes with two possible columns
    each (as scripts/bench_bs.py builds its relations)."""
    from svbfm.data.meta import DataMetaInfo
    from svbfm.data.relation import RelationData

    rng = np.random.default_rng(seed)
    D = num_rows + 2 * num_attrs
    ids = np.arange(num_rows, dtype=np.int32)
    rows = np.concatenate([ids] * (1 + num_attrs))
    cols = np.concatenate([ids] + [
        num_rows + 2 * a + rng.integers(0, 2, num_rows).astype(np.int32)
        for a in range(num_attrs)])
    vals = np.concatenate([np.ones(num_rows, np.float32)] + [
        rng.uniform(0.2, 1.0, num_rows).astype(np.float32)
        for _ in range(num_attrs)])
    order = np.argsort(rows, kind="stable")
    return RelationData(row=rows[order], col=cols[order], val=vals[order],
                        num_rows=num_rows, num_features=D,
                        meta=DataMetaInfo(D))


def phase_workarounds(ctx: Smoke) -> dict:
    """Two schedules that were forced by a compiler fault of the earlier
    accelerator: row/column-tiled VB sweeps ran one sweep per program, and
    relational BS needed its sequential factor order checked against the
    blocked one."""
    from svbfm.data.dataset import SparseDataset
    from svbfm.data.libfm_text import COOData
    from svbfm.data.meta import DataMetaInfo
    from svbfm.data.relation import build_joined_meta
    from svbfm.learners import vb as vbmod
    from svbfm.learners.base import FMConfig
    from svbfm.learners.mcmc_bs import ALSBSLearner

    s = ctx.sizes
    out = {}
    cfg, meta = ctx.config()
    tr_ds, te_ds = ctx.datasets()
    budget = vbmod.VB_TILE_BUDGET
    vbmod.VB_TILE_BUDGET = s.tile_budget
    try:
        learner = vbmod.VBLearner(cfg, tr_ds, te_ds, meta, write_files=False)
        check(learner._needs_row_tiling(), "VB tiling did not engage")
        s0 = learner.init_state()
        _, one = learner.run(s0, num_iter=s.iters, chunk=1, verbose=False,
                             donate=False)
        _, fused = learner.run(s0, num_iter=s.iters, chunk=s.iters,
                               verbose=False, donate=False)
    finally:
        vbmod.VB_TILE_BUDGET = budget
    # the same arithmetic in both schedules; XLA may fuse the loop bodies
    # differently, which reorders float32 sums
    out["tiled_vb_fused_vs_chunk1_rmse_dev"] = within(
        "tiled VB fused vs chunk=1 test RMSE", [r["rmse"] for r in fused],
        [r["rmse"] for r in one], 1e-4)
    out["tiled_vb_fused_vs_chunk1_fe_dev"] = within(
        "tiled VB fused vs chunk=1 free energy",
        [r["free_energy"] for r in fused], [r["free_energy"] for r in one],
        1e-4)

    rng = np.random.default_rng(5)
    users = rng.integers(0, s.bs_users, s.bs_rows).astype(np.int32)
    items = rng.integers(0, s.bs_items, s.bs_rows).astype(np.int32)
    y = (3.6 + 0.4 * rng.standard_normal(s.bs_users)[users]
         + 0.4 * rng.standard_normal(s.bs_items)[items]
         + 0.5 * rng.standard_normal(s.bs_rows)).astype(np.float32)
    rels = [_bs_relation(s.bs_users, s.bs_attrs, 7),
            _bs_relation(s.bs_items, s.bs_attrs, 8)]
    bmeta = build_joined_meta(DataMetaInfo(0), rels)
    D = bmeta.num_attributes
    n_te = max(1, s.bs_rows // 10)

    def empty(target):  # every feature lives in the relations
        return SparseDataset.from_coo(COOData(
            row=np.zeros(0, np.int32), col=np.zeros(0, np.int32),
            val=np.zeros(0, np.float32), target=target,
            num_rows=len(target), num_features=0), D)

    bcfg = FMConfig(num_attributes=D, num_factor=s.bs_factor,
                    min_target=float(y.min()), max_target=float(y.max()),
                    num_groups=bmeta.num_attr_groups, seed=7, regw=0.05,
                    regv=0.05)
    hist = {}
    for name, fb in (("blocked", 0), ("sequential", 1)):
        bs = ALSBSLearner(dataclasses.replace(bcfg, factor_block=fb), empty(y),
                          empty(y[:n_te]), rels, [users, items],
                          [users[:n_te], items[:n_te]], bmeta, 0,
                          write_files=False)
        _, h = bs.run(num_iter=s.iters, verbose=False)
        hist[name] = [r["rmse"] for r in h]
    # the blocked sweep visits (bin, factor) pairs in another order than
    # the factor-sequential one: two Gauss-Seidel orders of one ALS
    # objective, which must descend and end at the same level
    blk = hist["blocked"]
    check(blk[-1] < blk[0], f"blocked ALS-BS did not descend: {blk}")
    out["bs_rmse_blocked"] = blk
    out["bs_rmse_sequential"] = hist["sequential"]
    out["bs_blocked_vs_sequential_final_dev"] = within(
        "ALS-BS blocked vs sequential final test RMSE", blk[-1:],
        hist["sequential"][-1:], 5e-2)
    return out


def phase_serve_resume(ctx: Smoke) -> dict:
    from svbfm.parallel.mesh import make_mesh
    from svbfm.serve import BatchScorer

    out = {}
    if ctx.vb_state is None:
        from svbfm.learners.vb import VBLearner
        cfg, meta = ctx.config()
        learner = VBLearner(cfg, *ctx.datasets(), meta, write_files=False)
        ctx.vb_state = (learner, learner.run(num_iter=ctx.sizes.iters,
                                             verbose=False)[0])
    learner, state = ctx.vb_state
    cfg = learner.cfg
    te = ctx.datasets()[1]
    n = te.num_rows
    scorer = BatchScorer.from_state(state, cfg, mesh=make_mesh(1),
                                    batch_rows=max(1024, n // 4))
    got = scorer.score_rows(te.ids[:n], te.vals[:n])
    want = np.clip(learner.predict_test_scores(state), cfg.min_target,
                   cfg.max_target)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    out["scored_rows"] = int(n)
    out["score_max_abs_dev"] = float(np.max(np.abs(got - want)))

    ck = os.path.join(ctx.workdir, "checkpoints")
    shutil.rmtree(ck, ignore_errors=True)
    base = ctx.cli_args("vb")
    base = base[: base.index("-iter")]
    full = run_cli(base + ["-iter", "4"], os.path.join(ctx.workdir, "full"))
    resume = ["-checkpoint", ck, "-checkpoint_every", "2"]
    run_cli(base + ["-iter", "2"] + resume, os.path.join(ctx.workdir, "half"))
    rest = run_cli(base + ["-iter", "4"] + resume,
                   os.path.join(ctx.workdir, "rest"))
    want, got = printed_test_rmse(full)[2:], printed_test_rmse(rest)
    check(len(got) == 2, f"the resumed run ran {len(got)} sweeps, not 2")
    # the CLI prints 6 significant digits, and the resumed run executes a
    # 2-sweep program where the uninterrupted one runs 4 sweeps in one
    out["resume_rmse_max_rel_dev"] = within("resumed VB test RMSE", got,
                                            want, 1e-4)
    return out


def phase_multi_card(ctx: Smoke, cards: int = 4) -> dict:
    """Data-parallel VB and MCMC on ``cards`` devices against one, and
    feature-sharded VB, at the phase-2 shape."""
    import jax

    from svbfm.learners.mcmc import MCMCLearner
    from svbfm.learners.vb import VBLearner
    from svbfm.parallel.mesh import make_mesh, make_mesh2d
    from svbfm.parallel.tp_vb import TPVBLearner

    s = ctx.sizes
    cfg, meta = ctx.config()
    tr_ds, te_ds = ctx.datasets()
    devices = jax.devices()[:cards]
    out = {}

    def trajectory(cls, mesh):
        _, h = cls(cfg, tr_ds, te_ds, meta, mesh=mesh,
                   write_files=False).run(num_iter=s.iters, verbose=False)
        return ([r["rmse"] for r in h],
                [r["free_energy"] for r in h] if "free_energy" in h[0]
                else None)

    vb1 = trajectory(VBLearner, make_mesh(1))
    # sharded runs psum per-shard partial sums: float32 reassociation
    vbn = trajectory(VBLearner, make_mesh(cards))
    out["vb_data_parallel_rmse_dev"] = within(
        f"VB on {cards} devices, test RMSE", vbn[0], vb1[0], 2e-3)
    out["vb_data_parallel_fe_dev"] = within(
        f"VB on {cards} devices, free energy", vbn[1], vb1[1], 2e-3)
    # the Gibbs chain drifts with that reassociation (see BANDS["mcmc"])
    out["mcmc_data_parallel_rmse_dev"] = within(
        f"MCMC on {cards} devices, test RMSE",
        trajectory(MCMCLearner, make_mesh(cards))[0],
        trajectory(MCMCLearner, make_mesh(1))[0], BANDS["mcmc"][0])
    for nf in (2, 4):
        mesh = make_mesh2d(n_feature=nf, devices=devices)
        tp = trajectory(TPVBLearner, mesh)
        out[f"tp_vb_{mesh.devices.shape[0]}x{nf}_rmse_dev"] = within(
            f"TP VB on a {mesh.devices.shape} mesh, test RMSE", tp[0],
            vb1[0], 2e-3)
    traj = ctx.cli_trajectory("vb_feature_shards", ctx.cli_args("vb") + [
        "-feature_shards", str(cards)])
    out["cli_feature_shards"] = ctx.compare_with_reference("vb", traj)
    return out


PHASES = (("device", phase_device), ("parity", phase_parity),
          ("main", phase_main), ("learners", phase_learners),
          ("out_of_core", phase_out_of_core),
          ("workarounds", phase_workarounds),
          ("serve_resume", phase_serve_resume))


def run_phase(name: str, fn, ctx: Smoke) -> dict:
    t0 = time.perf_counter()
    try:
        numbers = fn(ctx)
    except BaseException:
        print(f"phase={name} ok=false seconds={time.perf_counter() - t0}",
              flush=True)
        raise
    print(f"phase={name} ok=true seconds={time.perf_counter() - t0} "
          f"{json.dumps(numbers, default=str)}", flush=True)
    return numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the multi-card phase on four GPUs")
    args = ap.parse_args(argv)

    import jax
    devices = jax.devices()
    require_gpu(devices, args.cards)

    print(f"card: {card_name_and_power()}", flush=True)
    shutil.rmtree(WORKDIR, ignore_errors=True)
    ctx = Smoke(FULL, WORKDIR, reference=load_reference(FULL))
    try:
        if args.cards == 1:
            for name, fn in PHASES:
                run_phase(name, fn, ctx)
        else:
            run_phase("multi_card",
                      functools.partial(phase_multi_card, cards=args.cards),
                      ctx)
    finally:
        shutil.rmtree(WORKDIR, ignore_errors=True)
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
