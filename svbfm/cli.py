"""libFM-compatible command-line driver.

Flag-surface parity with the reference CLI (``src/libfm/libfm.cpp:84-114``),
dispatching to the JAX learners:

    python -m svbfm.cli -task r -train tr.libfm -test te.libfm \
        -dim '1,1,20' -method vb -iter 100

Preserved semantics (``libfm.cpp``):
  - ``-method als`` is rewritten to mcmc with do_sampling=0, do_multilevel=0
    (``:131-135``)
  - ``-task c`` binarizes targets to +-1 (``:337-350``)
  - ``-regular`` accepts 0, 1, 3, or 1+2*num_groups values (``:367-427``)
  - ``-learn_rate`` accepts 1 or 3 values (``:428-484``)
  - mcmc/vb/vb_online re-draw w ~ N(0, init_stdev) (``:298,307,313``)
  - per-iteration trajectory files ``test_rmse_<k0><k1><K>_<method>`` (and
    ``free_energy_*`` for the VB methods) are written to CWD
  - ``-rlog`` writes a TSV with a declared schema
  - ``-seed`` is honored (the reference registers it but seeds from
    time(NULL), ``libfm.cpp:123`` — deliberate fix)
  - ``-out`` writes final test predictions, one per line (works for every
    method here; the reference's VB predict is stubbed,
    ``fm_learn_vb.h:321-348``)
"""

from __future__ import annotations

import os
import sys
from typing import Optional

import numpy as np

METHODS = ("sgd", "sgda", "sgd_online", "als", "mcmc", "vb", "vb_online",
           "exp_sgd", "exp_sgd_stoc", "bpr")

HELP = """svbfm — libFM-compatible factorization machines in JAX
Flags (libFM-compatible; -name value):
  -task        r=regression, c=binary classification [MANDATORY]
  -train       filename for training data [MANDATORY]
  -test        filename for test data [MANDATORY]
  -validation  filename for validation data (only for SGDA)
  -meta        filename with one group id per attribute line
  -out         filename for final test predictions
  -dim         'k0,k1,k2': bias,1-way,2-way dim; default=1,1,8
  -regular     'r0,r1,r2' (or 1 or 1+2*groups values)
  -init_stdev  stdev for init of 2-way factors; default=0.1
  -stdev       model stdev (exp-SGD); default=1
  -iter        number of iterations; default=100
  -learn_rate  SGD learn rate (1 or 3 values); default=0.1
  -method      sgd|sgda|sgd_online|als|mcmc|vb|vb_online|exp_sgd|
               exp_sgd_stoc|bpr (bpr = pairwise implicit-feedback
               ranking, the reference's fm_pairSGD kernel made
               CLI-reachable; extension)
  -batch       number of chunks for the online methods; default=50
  -reshuffle   vb_online: 1 = re-partition chunk membership every epoch
               (reference disk-re-split semantics); default 0 keeps
               membership fixed with shuffled order (faster, one program)
  -verbosity   how much to print; default=0
  -rlog        TSV metrics file
  -seed        RNG seed (honored, unlike the reference)
  -relation    BS relation file prefixes (comma separated)
  -cache_size  bytes of HBM for windowed row data: -method vb/mcmc/als
               train out-of-core (HBM-windowed sweeps, resident caches;
               the reference's LargeSparseMatrixHD path); other methods
               accept it for compatibility and stay HBM-resident
  -bins        column-bin mode: auto|fields|greedy|jacobi (extension)
  -factor_block  factors per sweep block; 0=all (fast), 1=reference-exact
  -checkpoint  directory for periodic checkpoints (resumes if present)
  -checkpoint_every  iterations between checkpoints; default=10
  -map_eval    implicit-feedback MAP fixture file (task c; the reference
               hardcodes this path, fm_learn.h:124)
  -map_item_offset  subtract from fixture item ids; default=0
  -map_k       MAP cutoff; default=5
  -profile     jax.profiler trace directory (TensorBoard/XProf)
  -distributed 1 to initialize jax.distributed multi-host SPMD (or set
               SVBFM_COORDINATOR/SVBFM_NUM_PROCESSES/SVBFM_PROCESS_ID)
  -feature_shards  shard the w/v parameter tables over this many devices
               (tensor parallelism over a (data, feature) mesh; vb/mcmc/
               als/vb_online/sgd; device count must be divisible by it) —
               use when D*K outgrows one device's HBM (extension)
  -help        this screen
"""


class CmdLine:
    """`-name value` parser with duplicate detection and unknown-flag
    rejection (reference ``src/util/cmdline.h:29-197``)."""

    def __init__(self, argv: list[str]):
        self.args: dict[str, str] = {}
        i = 0
        while i < len(argv):
            tok = argv[i]
            if not tok.startswith("-") or _is_number(tok):
                raise SystemExit(f"expected parameter, found '{tok}'")
            name = tok.lstrip("-")
            if name in self.args:
                raise SystemExit(f"the parameter '{name}' is specified twice")
            if i + 1 < len(argv) and (not argv[i + 1].startswith("-")
                                      or _is_number(argv[i + 1])):
                self.args[name] = argv[i + 1]
                i += 2
            else:
                self.args[name] = ""
                i += 1

    def check(self, known: set[str]) -> None:
        for k in self.args:
            if k not in known:
                raise SystemExit(f"unknown parameter '{k}'")

    def has(self, name: str) -> bool:
        return name in self.args

    def get_str(self, name: str, default: str = "") -> str:
        return self.args.get(name, default)

    def get_int(self, name: str, default: int = 0) -> int:
        v = self.args.get(name, "")
        return int(v) if v else default

    def get_float(self, name: str, default: float = 0.0) -> float:
        v = self.args.get(name, "")
        return float(v) if v else default

    def get_list(self, name: str) -> list[float]:
        v = self.args.get(name, "")
        if not v:
            return []
        return [float(x) for x in v.replace(";", ",").split(",") if x != ""]


def _is_number(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


KNOWN = {"task", "meta", "train", "test", "validation", "out", "dim",
         "regular", "init_stdev", "stdev", "iter", "learn_rate", "method",
         "verbosity", "rlog", "seed", "help", "relation", "cache_size",
         "batch", "do_sampling", "do_multilevel", "num_eval_cases", "bins",
         "factor_block", "factor_jacobi", "checkpoint", "checkpoint_every",
         "map_eval",
         "map_item_offset", "map_k", "profile", "distributed",
         "feature_shards", "reshuffle", "bpr_neg_field"}


def main(argv: Optional[list[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    cmd = CmdLine(argv)
    if cmd.has("help") or not argv:
        print(HELP)
        return 0
    cmd.check(KNOWN)

    # multi-host SPMD: initialize jax.distributed BEFORE any jax.devices()
    # call so make_mesh sees the global device list (SURVEY §5 distributed
    # comm backend; the reference has no multi-process story at all)
    if cmd.get_int("distributed", 0) or os.environ.get("SVBFM_COORDINATOR"):
        from svbfm.parallel.mesh import distributed_init, process_info
        if distributed_init():
            pidx, pcnt = process_info()
            print(f"# distributed: process {pidx}/{pcnt}, "
                  f"{__import__('jax').device_count()} global devices")

    from svbfm.data.dataset import SparseDataset
    from svbfm.data.libfm_text import load_libfm_text
    from svbfm.data.meta import DataMetaInfo
    from svbfm.learners.base import (FMConfig, TASK_CLASSIFICATION,
                                     TASK_REGRESSION)
    from svbfm.utils.rlog import RLog

    task_s = cmd.get_str("task")
    if task_s not in ("r", "c", "p"):
        raise SystemExit("unknown task (use r, c)")
    task = {"r": TASK_REGRESSION, "c": TASK_CLASSIFICATION, "p": 2}[task_s]

    method = cmd.get_str("method", "mcmc").lower()
    if method not in METHODS:
        raise SystemExit(f"unknown method '{method}'")
    do_sample = cmd.get_int("do_sampling", 1) != 0
    do_multilevel = cmd.get_int("do_multilevel", 1) != 0
    if method == "als":  # libfm.cpp:131-135
        method = "mcmc"
        do_sample = False
        do_multilevel = False
        als = True
    else:
        als = False

    dim = cmd.get_list("dim") or [1, 1, 8]
    if len(dim) != 3:
        raise SystemExit("-dim needs 3 values 'k0,k1,k2'")
    k0, k1, K = bool(int(dim[0])), bool(int(dim[1])), int(dim[2])

    train_file = cmd.get_str("train")
    test_file = cmd.get_str("test")
    if not train_file or not test_file:
        raise SystemExit("-train and -test are mandatory")

    verbosity = cmd.get_int("verbosity", 0)

    def _debug_data(coo) -> None:
        # Data::debug (Data.h:569-579): first <=4 rows as "target id:value..."
        first = np.searchsorted(coo.row, np.arange(5), side="left")
        for r in range(min(4, coo.num_rows)):
            ent = " ".join(f"{coo.col[j]}:{coo.val[j]:g}"
                           for j in range(first[r], first[r + 1]))
            print(f"{coo.target[r]:g} {ent}".rstrip())

    def _load(path):
        # reference Data::load picks binary .x/.y (or .data/.target) when
        # present, else parses the text file (Data.h:106-171)
        from svbfm.data.binary import has_binary, load_coo_binary
        if has_binary(path):
            return load_coo_binary(path)
        return load_libfm_text(path)

    # deferred train loading for the online methods (libfm.cpp:149-171
    # never loads the train file for vb_online/sgd_online): with
    # reference-format binary input the training set streams from disk and
    # is never fully resident in host RAM or HBM
    import os as _os
    from svbfm.data.binary import has_binary
    cache_bytes = cmd.get_int("cache_size", 0)
    defer_train = ((method in ("vb_online", "sgd_online")
                    or (method in ("vb", "mcmc", "als") and cache_bytes > 0))
                   and has_binary(train_file) and not cmd.has("relation"))
    reader = None
    if defer_train:
        from svbfm.data.stream import BinaryChunkReader
        xp = train_file + (".x" if _os.path.exists(train_file + ".x")
                           else ".data")
        yp = train_file + (".y" if _os.path.exists(train_file + ".y")
                           else ".target")
        reader = BinaryChunkReader(xp, yp)
        train = None
    else:
        train = _load(train_file)
        if verbosity > 0:
            _debug_data(train)  # libfm.cpp:154
    test = _load(test_file)
    if verbosity > 0:
        _debug_data(test)  # libfm.cpp:158
    D = max(reader.num_cols if defer_train else train.num_features,
            test.num_features)

    if task == TASK_CLASSIFICATION:  # libfm.cpp:337-350
        if train is not None:
            train.target = np.where(train.target > 0, 1.0, -1.0).astype(np.float32)
        if reader is not None and reader.targets is not None:
            reader.targets = np.where(reader.targets > 0, 1.0,
                                      -1.0).astype(np.float32)
        test.target = np.where(test.target > 0, 1.0, -1.0).astype(np.float32)
        min_t, max_t = -1.0, 1.0
    elif defer_train:
        # targets vector is small (4 bytes/row); dims via the binary header
        # replace the reference's find_max_feature text scan
        min_t = float(reader.targets.min())
        max_t = float(reader.targets.max())
    else:
        min_t = float(train.target.min())
        max_t = float(train.target.max())

    meta = DataMetaInfo(D)
    if cmd.has("meta"):
        meta.load_groups_from_file(cmd.get_str("meta"))

    # relational block structure (libfm.cpp:188-256).  MCMC/ALS exploit the
    # blocks natively (fm_learn_mcmc.h:459-620, never materializing the
    # join — see learners.mcmc_bs); every other learner gets the
    # model-identical expanded design matrix (our extension: the reference
    # only supports BS for MCMC/ALS).
    bs_native = None
    if cmd.has("relation"):
        from svbfm.data.relation import (RelationData, build_joined_meta,
                                         join_relations, load_join)
        prefixes = [r for r in cmd.get_str("relation").replace(";", ",").split(",") if r]
        rels = [RelationData.load(pfx) for pfx in prefixes]
        tr_joins = [load_join(pfx + ".train", train.num_rows) for pfx in prefixes]
        te_joins = [load_join(pfx + ".test", test.num_rows) for pfx in prefixes]
        meta = build_joined_meta(meta, rels)
        if method == "mcmc":
            bs_native = (rels, tr_joins, te_joins, D)
        else:
            train = join_relations(train, rels, tr_joins, D)
            test = join_relations(test, rels, te_joins, D)
        D = meta.num_attributes
    G = meta.num_attr_groups
    if verbosity > 0:  # DataMetaInfo::debug (Data.h:63-68, libfm.cpp:252)
        print(f"#attr={meta.num_attributes}\t#groups={G}")
        for g in range(G):
            print(f"#attr_in_group[{g}]={meta.num_attr_per_group[g]}")

    # -regular parsing (libfm.cpp:367-427)
    reg = cmd.get_list("regular")
    reg0 = regw = regv = 0.0
    w_lambda = v_lambda = None
    if len(reg) == 0:
        pass
    elif len(reg) == 1:
        reg0 = regw = regv = reg[0]
    elif len(reg) == 3:
        reg0, regw, regv = reg
    elif len(reg) == 1 + 2 * G:
        reg0 = reg[0]
        w_lambda = np.asarray(reg[1:1 + G], np.float32)
        v_lambda = np.tile(np.asarray(reg[1 + G:], np.float32)[:, None], (1, K))
    else:
        raise SystemExit("-regular takes 0, 1, 3 or 1+2*num_groups values")

    lr = cmd.get_list("learn_rate") or [0.1]
    if len(lr) not in (1, 3):
        raise SystemExit("-learn_rate takes 1 or 3 values")
    learn_rate = lr[0]

    cfg = FMConfig(
        num_attributes=D, num_factor=K, k0=k0, k1=k1, task=task,
        min_target=min_t, max_target=max_t, num_groups=G,
        num_iter=cmd.get_int("iter", 100), seed=cmd.get_int("seed", 0),
        init_stdev=cmd.get_float("init_stdev", 0.1),
        learn_rate=learn_rate, reg0=reg0, regw=regw, regv=regv,
        do_sample=do_sample, do_multilevel=do_multilevel,
        num_batches=cmd.get_int("batch", 50),
        stdev=cmd.get_float("stdev", 1.0),
        factor_block=cmd.get_int("factor_block", 0),
        mcmc_factor_jacobi=cmd.get_int("factor_jacobi", 0) == 1,
        reshuffle=cmd.get_int("reshuffle", 0) == 1,
    )
    if cfg.mcmc_factor_jacobi and cfg.do_sample:
        print("# WARNING: -factor_jacobi is ignored when sampling "
              "(factor-Jacobi is not a valid Gibbs kernel); it applies "
              "only to deterministic ALS (-method als / -do_sampling 0).",
              flush=True)
    bins = cmd.get_str("bins", "auto")
    verbose = True

    tr_ds = SparseDataset.from_coo(train, D) if train is not None else None
    te_ds = SparseDataset.from_coo(test, D)

    rlog = RLog(cmd.get_str("rlog") or None)

    # -feature_shards: tensor-parallel training over a (data, feature)
    # mesh — w/v tables shard over `fs` devices (extension; parallel/tp_*)
    fs = cmd.get_int("feature_shards", 1)
    tp_mesh = None
    if fs > 1:
        if method not in ("mcmc", "als", "vb", "vb_online", "sgd"):
            raise SystemExit(
                "-feature_shards supports vb/mcmc/als/vb_online/sgd only")
        if cmd.has("relation"):
            raise SystemExit("-feature_shards is not supported with native "
                             "-relation block structure")
        import jax as _jax
        if len(_jax.devices()) % fs:
            raise SystemExit(f"-feature_shards {fs} does not divide the "
                             f"device count {len(_jax.devices())}")
        from svbfm.parallel.mesh import make_mesh2d
        tp_mesh = make_mesh2d(n_feature=fs)

    if method == "mcmc":
        if bs_native is not None:
            from svbfm.learners.mcmc_bs import ALSBSLearner, MCMCBSLearner
            cls = ALSBSLearner if als else MCMCBSLearner
            rels_l, trj, tej, d_main = bs_native
            learner = cls(cfg, tr_ds, te_ds, rels_l, trj, tej, meta, d_main,
                          bins=bins, w_lambda_init=w_lambda,
                          v_lambda_init=v_lambda)
        elif tp_mesh is not None:
            from svbfm.parallel.tp_mcmc import TPALSLearner, TPMCMCLearner
            cls = TPALSLearner if als else TPMCMCLearner
            learner = cls(cfg, tr_ds, te_ds, meta, mesh=tp_mesh, bins=bins,
                          write_files=True, w_lambda_init=w_lambda,
                          v_lambda_init=v_lambda)
        elif cache_bytes > 0:
            # out-of-core batch Gibbs/ALS: HBM-windowed sweeps with
            # resident e/q caches (the reference's LargeSparseMatrixHD
            # path feeds MCMC too, fmatrix.h:110-233 / Data.h:112-171)
            from svbfm.learners.mcmc_windowed import (
                WindowedALSLearner, WindowedMCMCLearner)
            if cmd.get_int("num_eval_cases", 0):
                raise SystemExit("-num_eval_cases is not supported with "
                                 "-cache_size")
            if cmd.has("checkpoint"):
                raise SystemExit("-checkpoint is not supported with "
                                 "-cache_size yet")
            cls = WindowedALSLearner if als else WindowedMCMCLearner
            learner = cls(cfg, reader if defer_train else tr_ds, te_ds,
                          meta, cache_bytes=cache_bytes, bins=bins,
                          w_lambda_init=w_lambda, v_lambda_init=v_lambda)
        else:
            from svbfm.learners.mcmc import ALSLearner, MCMCLearner
            cls = ALSLearner if als else MCMCLearner
            learner = cls(cfg, tr_ds, te_ds, meta, bins=bins,
                          w_lambda_init=w_lambda, v_lambda_init=v_lambda,
                          num_eval_cases=cmd.get_int("num_eval_cases", 0)
                          or None)
    elif method == "vb":
        if cache_bytes > 0 and tp_mesh is None:
            # out-of-core batch VB: HBM-windowed sweeps with resident
            # caches (the reference's LargeSparseMatrixHD path,
            # fmatrix.h:110-233 / Data.h:112-171)
            from svbfm.learners.vb_windowed import WindowedVBLearner
            if cmd.get_int("num_eval_cases", 0):
                raise SystemExit("-num_eval_cases is not supported with "
                                 "-cache_size")
            if cmd.has("checkpoint"):
                raise SystemExit("-checkpoint is not supported with "
                                 "-cache_size yet")
            learner = WindowedVBLearner(
                cfg, reader if defer_train else tr_ds, te_ds, meta,
                cache_bytes=cache_bytes, bins=bins)
        elif tp_mesh is not None:
            from svbfm.parallel.tp_vb import TPVBLearner
            learner = TPVBLearner(cfg, tr_ds, te_ds, meta, mesh=tp_mesh,
                                  bins=bins, write_files=True)
        else:
            from svbfm.learners.vb import VBLearner
            learner = VBLearner(cfg, tr_ds, te_ds, meta, bins=bins,
                                num_eval_cases=cmd.get_int("num_eval_cases",
                                                           0) or None)
    elif method == "vb_online":
        if tp_mesh is not None:
            from svbfm.parallel.tp_ovb import TPOVBLearner
            if defer_train:
                raise SystemExit("-feature_shards with out-of-core "
                                 "vb_online streaming is not supported "
                                 "yet; load the train set in memory")
            learner = TPOVBLearner(cfg, tr_ds, te_ds, meta, mesh=tp_mesh,
                                   bins=bins)
        else:
            from svbfm.learners.vb_online import OVBLearner
            if defer_train:
                learner = OVBLearner.from_reader(cfg, reader, te_ds, meta,
                                                 bins=bins)
            else:
                learner = OVBLearner(cfg, tr_ds, te_ds, meta, bins=bins)
    elif method == "sgd":
        if tp_mesh is not None:
            from svbfm.parallel.tp_sgd import TPSGDLearner
            learner = TPSGDLearner(cfg, tr_ds, te_ds, meta, mesh=tp_mesh)
        else:
            from svbfm.learners.sgd import SGDLearner
            learner = SGDLearner(cfg, tr_ds, te_ds, meta)
    elif method == "sgd_online":
        from svbfm.learners.sgd import SGDOnlineLearner
        if defer_train:
            learner = SGDOnlineLearner.from_reader(cfg, reader, te_ds, meta)
        else:
            learner = SGDOnlineLearner(cfg, tr_ds, te_ds, meta)
    elif method == "sgda":
        from svbfm.learners.sgd import SGDALearner
        val_file = cmd.get_str("validation")
        if not val_file:
            raise SystemExit("-validation is mandatory for SGDA")
        val = load_libfm_text(val_file)
        if verbosity > 0:
            _debug_data(val)  # libfm.cpp:184
        if task == TASK_CLASSIFICATION:
            val.target = np.where(val.target > 0, 1.0, -1.0).astype(np.float32)
        learner = SGDALearner(cfg, tr_ds, te_ds,
                              SparseDataset.from_coo(val, D), meta)
    elif method == "bpr":
        from svbfm.learners.bpr import BPRLearner
        learner = BPRLearner(cfg, tr_ds, te_ds, meta,
                             neg_field=cmd.get_int("bpr_neg_field", -1))
    elif method in ("exp_sgd", "exp_sgd_stoc"):
        from svbfm.learners.exp_sgd import ExpSGDLearner, ExpSGDStocLearner
        cls = ExpSGDLearner if method == "exp_sgd" else ExpSGDStocLearner
        learner = cls(cfg, tr_ds, te_ds, meta)
    else:  # pragma: no cover
        raise SystemExit(f"method '{method}' not wired")
    if hasattr(learner, "num_windows"):
        print(f"# out-of-core: {learner.num_windows} windows of "
              f"{learner.wlen} rows", flush=True)

    # Initial-V dump (fm_model::init writes v_file.txt, fm_model.h:92-101).
    # The state built here is handed to run() below — init happens ONCE per
    # CLI invocation (at 10M+ rows an init is a multi-minute cache pass),
    # and a genuine init failure propagates with context instead of being
    # swallowed and resurfacing later.
    init_state = learner.init_state()
    v0 = getattr(init_state, "v", None)
    if v0 is None:
        v0 = getattr(init_state, "mu_v", None)
    if v0 is None and isinstance(init_state, tuple):
        v0 = init_state[2]
    if v0 is not None:
        # feature-sharded learners pad the feature dim; the dump keeps
        # the libFM-parity [K, D] shape (fm_model.h:92-101)
        np.savetxt("v_file.txt", np.asarray(v0)[..., :D], fmt="%g")

    # Reference-parity RLog schema, streamed per iteration by the learner
    # (fm_learn.h:78-95 base fields + the learner-specific column sets;
    # see utils/rlog_schema.py for the registration map)
    from svbfm.utils.rlog_schema import register_for
    register_for(learner, rlog)

    # per-iteration MAP@k inside the MCMC/OVBFM classification loops
    # (fm_learn_mcmc_simultaneous.h:270-275, fm_learn_vb_online_
    # simultaneous.h:258-262); the reference hardcodes the fixture path —
    # here it is the -map_eval flag, loaded once before the run
    if cmd.has("map_eval") and task == TASK_CLASSIFICATION \
            and hasattr(type(learner), "map_eval"):
        from svbfm.learners.base import MapEval
        learner.map_eval = MapEval.from_file(
            cmd.get_str("map_eval"), cmd.get_int("map_item_offset", 0),
            cmd.get_int("map_k", 5))

    if verbosity > 0:
        # fm_model::debug + fm_learn*::debug (fm_model.h:81-90,
        # fm_learn.h:157-161, fm_learn_sgd.h:66-69, fm_learn_mcmc.h:1237-1242)
        print(f"num_attributes={D}")
        print(f"use w0={int(k0)}")
        print(f"use w1={int(k1)}")
        print(f"dim v ={K}")
        print(f"reg_w0={reg0:g}")
        print(f"reg_w={regw:g}")
        print(f"reg_v={regv:g}")
        print(f"init ~ N(0,{cfg.init_stdev:g})")
        if method == "sgda":  # adapt_reg.h:346-349
            print("method=sgda")
        if method in ("sgd", "sgda", "sgd_online", "exp_sgd", "exp_sgd_stoc"):
            print(f"num_iter={cfg.num_iter}")  # fm_learn_sgd.h:66-69
        print(f"task={task}")
        print(f"min_target={min_t:g}")
        print(f"max_target={max_t:g}")
        if method == "mcmc":
            print(f"do_multilevel={int(do_multilevel)}")
            print(f"do_sampling={int(do_sample)}")
            print(f"num_eval_cases={cmd.get_int('num_eval_cases', 0) or te_ds.num_rows}")

    run_kw = {}
    if cmd.has("checkpoint"):
        from svbfm.utils.checkpoint import CheckpointManager
        run_kw["ckpt"] = CheckpointManager(cmd.get_str("checkpoint"))
        run_kw["ckpt_every"] = cmd.get_int("checkpoint_every", 10)
    from svbfm.utils.profiling import trace
    with trace(cmd.get_str("profile") or None):
        state, history = learner.run(state=init_state, num_iter=cfg.num_iter,
                                     verbose=verbose, **run_kw)
    rlog.close()

    # final evaluation + -out predictions (libfm.cpp:508-519).  Sampling
    # MCMC uses the posterior-mean accumulator via final_test_predictions
    # (reference predict(), fm_learn_mcmc.h:355-379); the probit methods
    # (vb/mcmc/vb_online) output cdf_gaussian probabilities clamped to
    # [0,1], the SGD family sigmoid (matching each learner's likelihood).
    scores = learner.predict_test_scores(state)
    final_fn = getattr(learner, "final_test_predictions", None)
    if task == TASK_REGRESSION:
        out_vals = (final_fn(state) if final_fn is not None
                    else np.clip(scores, min_t, max_t))
        out_vals = np.clip(out_vals, min_t, max_t)
    elif final_fn is not None:  # sampling MCMC: already probabilities
        out_vals = final_fn(state)
    elif method in ("vb", "vb_online"):
        from svbfm.learners.base import ref_cdf_gaussian
        import jax.numpy as _jnp
        out_vals = np.clip(
            np.asarray(ref_cdf_gaussian(_jnp.asarray(scores))), 0.0, 1.0)
    else:
        out_vals = 1.0 / (1.0 + np.exp(-np.asarray(scores, np.float64)))
    nec = cmd.get_int("num_eval_cases", 0) or None
    vals_eval = out_vals[:nec] if nec else out_vals
    target_eval = test.target[:nec] if nec else test.target
    if cmd.has("map_eval"):
        from svbfm.learners.base import load_map_fixture, map_at_k
        u, i, pos = load_map_fixture(cmd.get_str("map_eval"),
                                     cmd.get_int("map_item_offset", 0))
        mk = cmd.get_int("map_k", 5)
        print(f"MAP@{mk}\t{map_at_k(scores, u, i, pos, k=mk):.6g}")
    if task == TASK_REGRESSION:
        rmse = float(np.sqrt(np.mean((vals_eval - target_eval) ** 2)))
        print(f"Final\tTest={rmse:.6g}")
    else:
        acc = float(np.mean((vals_eval >= 0.5) == (target_eval > 0)))
        print(f"Final\tTest={acc:.6g}")
    if cmd.has("out"):
        with open(cmd.get_str("out"), "w") as f:
            for v in out_vals:
                f.write(f"{float(v):g}\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
