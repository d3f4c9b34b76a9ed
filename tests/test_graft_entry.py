"""Entry-point checks.

dryrun_multichip must be hermetic: it runs the mesh work in a subprocess
that forces the CPU platform before any device is touched, whatever the
parent's environment says; these tests exercise that public path (the
subprocess), not just the in-process impl.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import __graft_entry__ as graft  # noqa: E402


def test_dryrun_multichip_subprocess_8():
    # Public wrapper: must succeed regardless of the parent's jax platform.
    graft.dryrun_multichip(8)


@pytest.mark.slow
def test_dryrun_multichip_survives_hostile_env(monkeypatch):
    # Even if the parent env pins the GPU platform and a conflicting
    # host-device-count flag, the wrapper must scrub/override both.
    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    monkeypatch.setenv("JAX_PLATFORM_NAME", "gpu")
    monkeypatch.setenv(
        "XLA_FLAGS", "--xla_force_host_platform_device_count=1")
    graft.dryrun_multichip(2)


def test_entry_compiles_single_device():
    import jax

    fn, args = graft.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-v"]))
