import os
import sys

# Force a deterministic 8-device virtual CPU mesh for all tests so the
# multi-device sharding paths are exercised without GPUs.  jax may already
# be imported (by a plugin) when this runs, so the platform is also set
# through jax.config; backends initialize lazily, so the XLA_FLAGS update
# below is still honored by the CPU client.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
assert jax.devices()[0].platform == "cpu"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# Build the native tools (ctypes parser fast path + convert/transpose) once
# per session so the byte-compat tests in test_tools.py run instead of
# silently skipping on a fresh checkout.  Tolerates a missing toolchain —
# the skipif guards then engage as before.
import shutil
import subprocess

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pytest_sessionstart(session):
    # best-effort builds: a hung/missing toolchain must not abort the
    # session (check=False silences failures but NOT TimeoutExpired) —
    # the tool tests' skipif guards handle absent binaries
    tools = os.path.join(_REPO, "tools")
    if shutil.which("make") and shutil.which("g++"):
        try:
            subprocess.run(["make", "-C", tools, "-s"], check=False,
                           capture_output=True, timeout=120)
        except subprocess.TimeoutExpired:
            pass
    # reference convert (byte-compat oracle): build once into /tmp/refbuild
    ref = "/root/reference/src/libfm/tools/convert.cpp"
    out = "/tmp/refbuild/convert"
    if (not os.path.exists(out) and os.path.exists(ref)
            and shutil.which("g++")):
        os.makedirs("/tmp/refbuild", exist_ok=True)
        try:
            subprocess.run(
                ["g++", "-O2", "-o", out, ref,
                 "-I", "/root/reference/src"],
                check=False, capture_output=True, timeout=300)
        except subprocess.TimeoutExpired:
            pass
