"""Test configuration: the tests run on the CPU, on a virtual 8-device mesh.

``JAX_PLATFORMS=cpu`` and ``xla_force_host_platform_device_count=8`` are
forced before JAX starts, so multi-device sharding paths run on fake CPU
devices (the standard JAX trick). ``chip_smoke.py`` runs the ``gpu``-marked
tests inside its own GPU process; it sets ``PTS_TEST_PLATFORM=gpu`` so this
file leaves the platform alone there.
"""

import os

import pytest

if os.environ.get("PTS_TEST_PLATFORM", "cpu") == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

    # an already-imported jax ignores the env var; pin it through the
    # config as well
    import jax  # noqa: E402

    jax.config.update("jax_platforms", "cpu")


@pytest.fixture(scope="session")
def assets_dir():
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.join(os.path.dirname(here), "assets")


@pytest.fixture
def gpu():
    """The GPU device, or a skip. Decided when the test runs (never at
    import or collection), so every xdist worker collects the same tests."""
    import jax

    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU (run through chip_smoke.py on the card)")
    return devs[0]
