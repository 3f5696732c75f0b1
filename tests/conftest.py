import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)


def run_multidevice(code: str, devices: int = 8, timeout: int = 600):
    """Run a snippet in a subprocess with N forced host devices.

    Tests in this process see 1 device (dryrun sets its own flag itself);
    multi-device semantics are validated out of process.
    """
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True,
        text=True,
        timeout=timeout,
        env=env,
    )
    if proc.returncode != 0:
        raise AssertionError(
            f"multidevice subprocess failed:\nSTDOUT:\n{proc.stdout}\nSTDERR:\n{proc.stderr[-4000:]}"
        )
    return proc.stdout


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips inside the test when none is present"
    )


@pytest.fixture
def multidevice():
    return run_multidevice
