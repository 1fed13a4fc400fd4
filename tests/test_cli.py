import os

import numpy as np
import pytest

from svbfm.data.libfm_text import save_libfm_text
from svbfm.data.synth import make_movielens_like, train_test_split


@pytest.fixture(scope="module")
def data_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    coo = make_movielens_like(num_users=20, num_items=15, num_ratings=1500,
                              rank=2, noise=0.4, seed=11)
    tr, te = train_test_split(coo, 0.2, seed=12)
    trf, tef = str(d / "tr.libfm"), str(d / "te.libfm")
    save_libfm_text(trf, tr)
    save_libfm_text(tef, te)
    groups = np.zeros(coo.num_features, np.int64)
    groups[20:] = 1
    gf = str(d / "groups.txt")
    np.savetxt(gf, groups, fmt="%d")
    return d, trf, tef, gf


def _run_cli(args, cwd):
    from svbfm.cli import main
    old = os.getcwd()
    os.chdir(cwd)
    try:
        return main(args)
    finally:
        os.chdir(old)


@pytest.mark.parametrize("method", ["vb", "sgd", "als", "mcmc", "vb_online",
                                    "exp_sgd", "exp_sgd_stoc"])
def test_cli_methods_run(data_files, tmp_path, method):
    d, trf, tef, gf = data_files
    rc = _run_cli(["-task", "r", "-train", trf, "-test", tef,
                   "-dim", "1,1,4", "-method", method, "-iter", "3",
                   "-meta", gf, "-seed", "3", "-batch", "3",
                   "-learn_rate", "0.05", "-regular", "0.01"],
                  str(tmp_path))
    assert rc == 0
    suffix = "mcmc" if method == "als" else method
    traj = tmp_path / f"test_rmse_114_{suffix}"
    assert traj.exists()
    vals = [float(x) for x in traj.read_text().split()]
    assert len(vals) == 3
    assert all(np.isfinite(vals))


def test_cli_sgda_and_out(data_files, tmp_path):
    d, trf, tef, gf = data_files
    out = str(tmp_path / "pred.txt")
    rc = _run_cli(["-task", "r", "-train", trf, "-test", tef,
                   "-validation", tef, "-dim", "1,1,4", "-method", "sgda",
                   "-iter", "3", "-learn_rate", "0.02", "-out", out,
                   "-rlog", str(tmp_path / "rlog.tsv")],
                  str(tmp_path))
    assert rc == 0
    preds = np.loadtxt(out)
    assert np.isfinite(preds).all()
    rlog = (tmp_path / "rlog.tsv").read_text().splitlines()
    assert rlog[0].split("\t")[0] == "rmse"
    assert len(rlog) == 4  # header + 3 iterations


def test_rlog_mcmc_reference_schema(data_files, tmp_path):
    """TSV column set matches fm_learn.h:78-95 + fm_learn_mcmc.h:1120-1150
    for a grouped-meta regression run, streamed per iteration."""
    d, trf, tef, gf = data_files
    rc = _run_cli(["-task", "r", "-train", trf, "-test", tef,
                   "-dim", "1,1,2", "-method", "mcmc", "-iter", "3",
                   "-meta", gf, "-seed", "5",
                   "-rlog", str(tmp_path / "rlog.tsv")],
                  str(tmp_path))
    assert rc == 0
    lines = (tmp_path / "rlog.tsv").read_text().splitlines()
    header = lines[0].split("\t")
    expected = ["rmse", "mae", "time_pred", "time_learn", "time_learn2",
                "time_learn4", "alpha", "rmse_mcmc_this", "rmse_mcmc_all",
                "rmse_mcmc_all_but5"]
    for g in range(2):
        expected += [f"wmu[{g}]", f"wlambda[{g}]"]
        for f in range(2):
            expected += [f"vmu[{g},{f}]", f"vlambda[{g},{f}]"]
    assert header == expected
    assert len(lines) == 4  # header + one streamed row per iteration
    rows = [ln.split("\t") for ln in lines[1:]]
    col = {name: i for i, name in enumerate(header)}
    # per-iteration hyperparameter traces are real and move
    wmu0 = [float(r[col["wmu[0]"]]) for r in rows]
    assert all(np.isfinite(wmu0))
    assert len(set(wmu0)) > 1
    alpha = [float(r[col["alpha"]]) for r in rows]
    assert all(np.isfinite(alpha))
    # documented superset: the reference logs time_pred only via
    # fm_learn.h::evaluate (which the mcmc loop does not call, leaving
    # NaN); we stream the real host-visible eval segment for every learner
    tp = [float(r[col["time_pred"]]) for r in rows]
    tl = [float(r[col["time_learn"]]) for r in rows]
    assert all(np.isfinite(v) and v >= 0 for v in tp + tl)


def test_rlog_vb_precision_columns(data_files, tmp_path):
    d, trf, tef, gf = data_files
    rc = _run_cli(["-task", "r", "-train", trf, "-test", tef,
                   "-dim", "1,1,2", "-method", "vb", "-iter", "2",
                   "-meta", gf, "-rlog", str(tmp_path / "rlog.tsv")],
                  str(tmp_path))
    assert rc == 0
    lines = (tmp_path / "rlog.tsv").read_text().splitlines()
    header = lines[0].split("\t")
    # vb registers this/all but NOT all_but5 (fm_learn_vb.h:714-742)
    assert "rmse_mcmc_all" in header and "rmse_mcmc_all_but5" not in header
    col = {name: i for i, name in enumerate(header)}
    rows = [ln.split("\t") for ln in lines[1:]]
    assert len(rows) == 2
    # VB streams real precision values into the wlambda/vlambda columns
    # (documented superset: the reference registers them but leaves NaN)
    wl0 = [float(r[col["wlambda[0]"]]) for r in rows]
    assert all(np.isfinite(wl0)) and all(v > 0 for v in wl0)
    # wmu is registered but NaN for VB (no such hyperparameter in VB)
    assert all(r[col["wmu[0]"]] == "nan" for r in rows)


def test_cli_classification(data_files, tmp_path):
    d, trf, tef, gf = data_files
    rc = _run_cli(["-task", "c", "-train", trf, "-test", tef,
                   "-dim", "1,1,4", "-method", "vb", "-iter", "2"],
                  str(tmp_path))
    assert rc == 0


def test_cli_help_and_errors(tmp_path):
    from svbfm.cli import main
    assert main(["-help"]) == 0
    with pytest.raises(SystemExit):
        main(["-task", "r", "-bogus", "1", "-train", "x", "-test", "y"])
    with pytest.raises(SystemExit):
        main(["-task", "z", "-train", "x", "-test", "y"])


def test_map_at_k_reference_recurrence():
    from svbfm.learners.base import map_at_k
    # one user, items ranked [a(hit), b(miss), c(hit)]
    pred = np.array([3.0, 2.0, 1.0])
    users = np.array([7, 7, 7])
    items = np.array([10, 11, 12])
    pos = {7: {10, 12}}
    # reference recurrence: hit@0 -> ap=1, temp=1; hit@2 -> ap=(1*2+1)/3=1,
    # temp=2; /2 positives = 1.0 (textbook AP would give 0.8333)
    assert abs(map_at_k(pred, users, items, pos, k=5) - 1.0) < 1e-12


def test_cli_map_eval(data_files, tmp_path):
    d, trf, tef, gf = data_files
    # fixture aligned with test rows: "<rating> <user>:1 <item>:1"
    import itertools
    te_lines = open(tef).read().splitlines()
    fixture = tmp_path / "map_fixture"
    with open(fixture, "w") as f:
        for i, line in enumerate(te_lines):
            f.write(f"{1 if i % 3 == 0 else 0} {i % 5}:1 {100 + i % 7}:1\n")
    rc = _run_cli(["-task", "c", "-train", trf, "-test", tef,
                   "-dim", "1,1,3", "-method", "vb", "-iter", "2",
                   "-map_eval", str(fixture), "-map_k", "5"],
                  str(tmp_path))
    assert rc == 0


def test_cli_binary_input(data_files, tmp_path):
    from svbfm.data.binary import save_coo_binary
    from svbfm.data.libfm_text import load_libfm_text
    d, trf, tef, gf = data_files
    tr = load_libfm_text(trf)
    save_coo_binary(str(tmp_path / "trbin"), tr)
    rc = _run_cli(["-task", "r", "-train", str(tmp_path / "trbin"),
                   "-test", tef, "-dim", "1,1,3", "-method", "als",
                   "-iter", "2", "-regular", "0.05"], str(tmp_path))
    assert rc == 0


def test_cli_verbosity_debug(data_files, tmp_path, capsys):
    # -verbosity > 0 prints the reference's debug dumps (libfm.cpp:154,
    # 158,252,489-492): first <=4 data rows, meta group sizes, model and
    # learner configuration
    d, trf, tef, gf = data_files
    rc = _run_cli(["-task", "r", "-train", trf, "-test", tef,
                   "-dim", "1,1,3", "-method", "mcmc", "-iter", "2",
                   "-meta", gf, "-verbosity", "1", "-seed", "1"],
                  str(tmp_path))
    assert rc == 0
    out = capsys.readouterr().out
    assert "#attr=" in out and "#attr_in_group[1]=" in out
    assert "num_attributes=" in out and "dim v =3" in out
    assert "do_sampling=1" in out and "do_multilevel=1" in out
    assert "min_target=" in out
    # Data::debug rows: "target id:value ..." with 2 nnz per row
    first = out.splitlines()[0]
    assert ":" in first and len(first.split()) == 3

    # verbosity=0 (default) prints none of it
    rc = _run_cli(["-task", "r", "-train", trf, "-test", tef,
                   "-dim", "1,1,3", "-method", "sgd", "-iter", "1",
                   "-learn_rate", "0.02", "-seed", "1"], str(tmp_path))
    assert rc == 0
    out = capsys.readouterr().out
    assert "num_attributes=" not in out and "#attr=" not in out


@pytest.mark.parametrize("method", ["vb", "mcmc", "als", "sgd"])
def test_cli_feature_shards(data_files, tmp_path, method):
    """-feature_shards routes vb/mcmc/als/sgd to the tensor-parallel
    learners over a (data, feature) mesh and still writes predictions."""
    d, trf, tef, gf = data_files
    out = str(tmp_path / "pred.txt")
    rc = _run_cli(["-task", "r", "-train", trf, "-test", tef,
                   "-meta", gf, "-dim", "1,1,4", "-iter", "3",
                   "-method", method, "-feature_shards", "4",
                   "-seed", "5", "-out", out], tmp_path)
    assert rc == 0
    preds = np.loadtxt(out)
    assert preds.shape[0] > 0 and np.isfinite(preds).all()


def test_cli_feature_shards_rejects_unsupported(data_files, tmp_path):
    d, trf, tef, gf = data_files
    with pytest.raises(SystemExit):
        _run_cli(["-task", "r", "-train", trf, "-test", tef,
                  "-dim", "1,1,4", "-iter", "2", "-method", "exp_sgd",
                  "-feature_shards", "4"], tmp_path)


def test_cli_single_init(data_files, tmp_path, monkeypatch):
    """The CLI builds the learner state exactly once: the v_file.txt dump
    state is the state run() trains from (no double init — at 10M+ rows an
    init is a multi-minute cache pass)."""
    from svbfm.learners.vb import VBLearner

    calls = []
    orig = VBLearner.init_state

    def counting(self, *a, **kw):
        calls.append(1)
        return orig(self, *a, **kw)

    monkeypatch.setattr(VBLearner, "init_state", counting)
    d, trf, tef, gf = data_files
    rc = _run_cli(["-task", "r", "-train", trf, "-test", tef,
                   "-dim", "1,1,4", "-method", "vb", "-iter", "2"],
                  str(tmp_path))
    assert rc == 0
    assert len(calls) == 1
    assert (tmp_path / "v_file.txt").exists()


def test_num_eval_cases_per_iteration(data_files, tmp_path):
    """-num_eval_cases subsets the per-iteration eval (reference
    fm_learn_mcmc_simultaneous.h:239-241) and streams the held-back
    remainder as rmse_mcmc_test2_* (documented superset of :252-258).
    Training is eval-independent, so subset and remainder recombine to the
    full-set RMSE of an identical full-eval run."""
    d, trf, tef, gf = data_files
    with open(tef) as f:
        n_test = sum(1 for _ in f)
    m = n_test // 2
    args = ["-task", "r", "-train", trf, "-test", tef, "-dim", "1,1,2",
            "-method", "mcmc", "-iter", "3", "-seed", "5", "-meta", gf]
    rc = _run_cli(args, str(tmp_path / "full") if (tmp_path / "full").mkdir()
                  is None else str(tmp_path / "full"))
    assert rc == 0
    (tmp_path / "sub").mkdir()
    rc = _run_cli(args + ["-num_eval_cases", str(m),
                          "-rlog", str(tmp_path / "rlog.tsv")],
                  str(tmp_path / "sub"))
    assert rc == 0
    lines = (tmp_path / "rlog.tsv").read_text().splitlines()
    header = lines[0].split("\t")
    assert "rmse_mcmc_test2_this" in header
    assert "rmse_mcmc_test2_all" in header
    col = {name: i for i, name in enumerate(header)}
    rows = [ln.split("\t") for ln in lines[1:]]
    full = [float(x) for x in
            (tmp_path / "full" / "test_rmse_112_mcmc").read_text().split()]
    sub = [float(x) for x in
           (tmp_path / "sub" / "test_rmse_112_mcmc").read_text().split()]
    for it, r in enumerate(rows):
        r_sub = float(r[col["rmse_mcmc_all"]])
        r2 = float(r[col["rmse_mcmc_test2_all"]])
        assert np.isfinite(r2)
        recombined = np.sqrt((r_sub ** 2 * m + r2 ** 2 * (n_test - m))
                             / n_test)
        np.testing.assert_allclose(recombined, full[it], rtol=1e-4)
        # the trajectory file now carries the subset rmse
        np.testing.assert_allclose(sub[it], r_sub, rtol=1e-5)
    assert sub != full


def test_num_eval_cases_vb(data_files, tmp_path):
    """VB per-iteration eval subsetting (fm_learn_vb_simultaneous.h:220)
    with the remainder streamed as rmse_mcmc_test2_this (:227-232)."""
    d, trf, tef, gf = data_files
    with open(tef) as f:
        n_test = sum(1 for _ in f)
    m = n_test // 3
    args = ["-task", "r", "-train", trf, "-test", tef, "-dim", "1,1,3",
            "-method", "vb", "-iter", "2", "-seed", "4"]
    (tmp_path / "full").mkdir()
    (tmp_path / "sub").mkdir()
    assert _run_cli(args, str(tmp_path / "full")) == 0
    assert _run_cli(args + ["-num_eval_cases", str(m),
                            "-rlog", str(tmp_path / "rlog.tsv")],
                    str(tmp_path / "sub")) == 0
    lines = (tmp_path / "rlog.tsv").read_text().splitlines()
    header = lines[0].split("\t")
    assert "rmse_mcmc_test2_this" in header
    assert "rmse_mcmc_test2_all" not in header  # vb has no accumulator
    col = {name: i for i, name in enumerate(header)}
    rows = [ln.split("\t") for ln in lines[1:]]
    full = [float(x) for x in
            (tmp_path / "full" / "test_rmse_113_vb").read_text().split()]
    for it, r in enumerate(rows):
        r_sub = float(r[col["rmse"]])
        r2 = float(r[col["rmse_mcmc_test2_this"]])
        recombined = np.sqrt((r_sub ** 2 * m + r2 ** 2 * (n_test - m))
                             / n_test)
        np.testing.assert_allclose(recombined, full[it], rtol=1e-4)


def test_cli_cache_size_windowed_vb(data_files, tmp_path):
    """-cache_size trains batch VB out-of-core (HBM-windowed) from the
    reference binary format and matches the resident run's trajectory."""
    from svbfm.data.binary import save_coo_binary
    from svbfm.data.libfm_text import load_libfm_text
    d, trf, tef, gf = data_files
    tr = load_libfm_text(trf)
    save_coo_binary(str(tmp_path / "trbin"), tr)
    common = ["-task", "r", "-test", tef, "-dim", "1,1,4", "-method", "vb",
              "-iter", "3", "-seed", "3", "-factor_block", "2"]
    resident = tmp_path / "resident"
    windowed = tmp_path / "windowed"
    resident.mkdir(), windowed.mkdir()
    assert _run_cli(common + ["-train", trf], str(resident)) == 0
    # a tiny cache forces multiple windows; binary input streams via
    # BinaryChunkReader
    assert _run_cli(common + ["-train", str(tmp_path / "trbin"),
                              "-cache_size", "100000"], str(windowed)) == 0
    ref = [float(x) for x in
           (resident / "test_rmse_114_vb").read_text().split()]
    win = [float(x) for x in
           (windowed / "test_rmse_114_vb").read_text().split()]
    np.testing.assert_allclose(win, ref, rtol=2e-4, atol=2e-5)
    fe = [float(x) for x in
          (windowed / "free_energy_114_vb").read_text().split()]
    assert all(np.isfinite(fe))


@pytest.mark.parametrize("method", ["mcmc", "als"])
def test_cli_cache_size_windowed_mcmc(data_files, tmp_path, method):
    """-cache_size trains batch Gibbs/ALS out-of-core (HBM-windowed) from
    the reference binary format and matches the resident trajectory (the
    windowed learner mirrors the resident RNG key chain exactly)."""
    from svbfm.data.binary import save_coo_binary
    from svbfm.data.libfm_text import load_libfm_text
    d, trf, tef, gf = data_files
    tr = load_libfm_text(trf)
    save_coo_binary(str(tmp_path / "trbin"), tr)
    common = ["-task", "r", "-test", tef, "-dim", "1,1,4", "-method", method,
              "-iter", "3", "-seed", "3", "-factor_block", "2"]
    resident = tmp_path / "resident"
    windowed = tmp_path / "windowed"
    resident.mkdir(), windowed.mkdir()
    assert _run_cli(common + ["-train", trf], str(resident)) == 0
    assert _run_cli(common + ["-train", str(tmp_path / "trbin"),
                              "-cache_size", "100000"], str(windowed)) == 0
    ref = [float(x) for x in
           (resident / "test_rmse_114_mcmc").read_text().split()]
    win = [float(x) for x in
           (windowed / "test_rmse_114_mcmc").read_text().split()]
    np.testing.assert_allclose(win, ref, rtol=5e-4, atol=5e-5)
