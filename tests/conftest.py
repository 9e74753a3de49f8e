"""Test configuration: the CPU backend with 8 virtual devices.

Tests run without an accelerator: Pallas kernels execute in the
interpreter and the multi-device sharding paths run on a fake 8-device
mesh.  ``JAX_PLATFORMS`` picks the platform (default ``cpu``); the tests
marked ``gpu`` need a card and skip elsewhere (run them on a GPU machine
with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``).
"""

import os

_platform = os.environ.setdefault("JAX_PLATFORMS", "cpu")
if _platform == "cpu":
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if _platform == "cpu":
    try:
        jax.config.update("jax_num_cpu_devices", 8)
    except RuntimeError:
        # Backends already initialized: the XLA_FLAGS above are then the
        # only lever, and tests that need 8 devices skip (mesh8 fixture).
        pass

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_addoption(parser):
    parser.addoption(
        "--runslow",
        action="store_true",
        default=False,
        help="run the slow tier too (tests/slow_tests.txt + @slow marks)",
    )


def _slow_manifest():
    path = os.path.join(os.path.dirname(__file__), "slow_tests.txt")
    try:
        with open(path) as f:
            return {
                ln.strip()
                for ln in f
                if ln.strip() and not ln.startswith("#")
            }
    except OSError:
        return set()


def pytest_collection_modifyitems(config, items):
    """Two test tiers: the default run deselects the slow tier (the
    measured-duration manifest tests/slow_tests.txt, regenerated by
    tools/gen_slow_manifest.py, plus anything marked @pytest.mark.slow)
    so ``pytest tests/ -q`` stays a ~5-minute full-code-path pass;
    ``--runslow`` runs everything (docs/DEVELOPMENT.md).  Explicitly
    named node ids always run."""
    if config.getoption("--runslow"):
        return
    if any("::" in a for a in config.invocation_params.args):
        return  # a directly requested test must not be deselected
    manifest = _slow_manifest()
    keep, drop = [], []
    for item in items:
        if item.nodeid in manifest or item.get_closest_marker("slow"):
            drop.append(item)
        else:
            keep.append(item)
    if drop:
        config.hook.pytest_deselected(items=drop)
        items[:] = keep


@pytest.fixture
def gpu():
    """The GPU device, for tests marked ``gpu``; decided here, at run
    time, so every xdist worker collects the same tests."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip("needs a GPU (compiled Pallas-Triton kernels)")
    return devices[0]


@pytest.fixture(scope="session")
def integrator():
    from tpu_montecarlo import MonteCarloIntegrator

    return MonteCarloIntegrator()


@pytest.fixture(scope="session")
def mesh8():
    from tpu_montecarlo.parallel import default_mesh

    devices = jax.devices()
    if len(devices) < 8:
        pytest.skip("needs 8 virtual devices")
    return default_mesh(devices[:8])
