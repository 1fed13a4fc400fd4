"""Record the CPU trajectories that chip_smoke.py compares the GPU with.

    JAX_PLATFORMS=cpu python scripts/record_smoke_trajectory.py [out.json]

Runs every CLI configuration of chip_smoke.CLI_RUNS at the smoke test's
full size on the CPU backend and writes their per-iteration test RMSE and
free energy to ``chip_smoke_trajectory.json`` (or ``out.json``).  It refuses
to run unless ``JAX_PLATFORMS=cpu`` is set explicitly.
"""

import json
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    if os.environ.get("JAX_PLATFORMS") != "cpu":
        raise SystemExit("record_smoke_trajectory: set JAX_PLATFORMS=cpu")
    sys.path.insert(0, REPO)
    import chip_smoke

    out = sys.argv[1] if len(sys.argv) > 1 else chip_smoke.TRAJECTORY
    workdir = chip_smoke.WORKDIR + "_record"
    shutil.rmtree(workdir, ignore_errors=True)
    try:
        ref = chip_smoke.record_reference(
            chip_smoke.Smoke(chip_smoke.FULL, workdir))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    with open(out, "w") as f:
        json.dump(ref, f, indent=1)
        f.write("\n")
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
