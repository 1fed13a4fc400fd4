"""chip_smoke.py on the CPU: its refusals, its last line, and every phase at
a tiny size against a reference recorded here on the CPU."""

import json
import os
import shutil
import subprocess
import sys
import types

import jax
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fake_devices(n, platform="gpu", kind="NVIDIA H100 80GB HBM3"):
    return [types.SimpleNamespace(platform=platform, device_kind=kind)] * n


@pytest.mark.parametrize("count", [1, 4])
def test_result_line_has_exactly_the_contract_keys(count):
    line = json.loads(chip_smoke.result_line(_fake_devices(count)))
    assert line == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count}}


@pytest.mark.parametrize("devices, count", [
    (None, 1),                       # the CPU devices of this test process
    (_fake_devices(1), 4),           # one GPU where four are asked for
    (_fake_devices(4, "cpu"), 1),
    ([], 1),
])
def test_require_gpu_exits_nonzero(devices, count):
    devices = jax.devices() if devices is None else devices
    with pytest.raises(SystemExit) as e:
        chip_smoke.require_gpu(devices, count)
    assert e.value.code not in (0, None)


def test_require_gpu_accepts_enough_gpus():
    chip_smoke.require_gpu(_fake_devices(4), 4)


def _run(args, cwd, env_drop=()):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for k in env_drop:
        env.pop(k, None)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("alone", [False, True])
def test_script_refuses_the_cpu(tmp_path, alone):
    """In the checkout and copied alone into an empty directory, the script
    exits non-zero on the CPU and prints no result."""
    if alone:
        script = str(tmp_path / "chip_smoke.py")
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), script)
    else:
        script = os.path.join(REPO, "chip_smoke.py")
    out = _run([script], tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_recorder_needs_an_explicit_cpu_platform(tmp_path):
    out = _run([os.path.join(REPO, "scripts", "record_smoke_trajectory.py"),
                str(tmp_path / "t.json")], tmp_path,
               env_drop=("JAX_PLATFORMS",))
    assert out.returncode != 0
    assert not (tmp_path / "t.json").exists()


def test_committed_trajectory_matches_the_full_sizes():
    ref = chip_smoke.load_reference(chip_smoke.FULL)
    assert set(ref["runs"]) == set(chip_smoke.CLI_RUNS)
    for name, traj in ref["runs"].items():
        n = (chip_smoke.FULL.vb_iters if name == "vb"
             else chip_smoke.FULL.iters)
        assert len(traj["rmse"]) == n
        if chip_smoke.BANDS[name][1] is not None:
            assert "free_energy" in traj


def test_bands_cover_every_compared_run():
    assert set(chip_smoke.BANDS) == set(chip_smoke.CLI_RUNS)


def test_printed_test_rmse_reads_iteration_lines():
    out = "#Iter=  0\tTrain=0.9\tTest=0.81\n# other\n#Iter=  1\tTest=0.8\n"
    assert chip_smoke.printed_test_rmse(out) == [0.81, 0.8]


def test_within_rejects_drift_and_non_finite():
    assert chip_smoke.within("x", [1.0, 2.0], [1.0, 2.0001], 1e-4) < 1e-4
    with pytest.raises(AssertionError):
        chip_smoke.within("x", [1.0, 2.1], [1.0, 2.0], 1e-2)
    with pytest.raises(AssertionError):
        chip_smoke.within("x", [float("nan")], [1.0], 1.0)


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    ctx = chip_smoke.Smoke(chip_smoke.TINY,
                           str(tmp_path_factory.mktemp("smoke")))
    ctx.reference = chip_smoke.record_reference(ctx)
    return ctx


def test_full_sizes_are_the_benchmark_shape():
    """Phase 2 runs the configuration of bench.py's headline row."""
    import bench

    full = chip_smoke.FULL
    assert (full.users, full.items, full.num_factor) == (
        bench.NUM_USERS, bench.NUM_ITEMS, bench.K)
    assert full.ratings == bench.NUM_TRAIN + bench.NUM_TRAIN // 10


@pytest.mark.parametrize("name", [
    "device", "parity", "main", "learners", "out_of_core", "workarounds",
    "serve_resume", "multi_card"])
def test_phase_runs_at_tiny_size(smoke, name, capsys, monkeypatch):
    # no nvidia-smi without a card
    monkeypatch.setattr(chip_smoke, "card_name_and_power",
                        lambda: "no card, 0 W")
    fn = dict(chip_smoke.PHASES, multi_card=chip_smoke.phase_multi_card)[name]
    numbers = chip_smoke.run_phase(name, fn, smoke)
    assert isinstance(numbers, dict) and numbers
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"phase={name} ok=true seconds=")
    json.loads(line.split(" ", 3)[3])
