"""A rehearsal of chip_smoke.py's phases at tiny sizes on the CPU.

The card runs them at full size; here each phase function runs end to end
(kernel in interpret mode) so a broken phase shows before a chip run.
"""

import io
import os
import sys
from contextlib import redirect_stdout

import jax
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402


def test_main_without_gpu_fails_and_prints_no_result(monkeypatch):
    # keep this test process on JAX's default cache setting
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "unused")
    buf = io.StringIO()
    with redirect_stdout(buf), pytest.raises(AssertionError, match="gpu"):
        chip_smoke.main([])
    assert '"ok"' not in buf.getvalue()


def test_phase_device_reports_this_device():
    dev = chip_smoke.phase_device("cpu", 1)
    assert dev == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())}


def test_phase_cli(tmp_path):
    chip_smoke.phase_cli(str(tmp_path), res=(32, 32), spp=4)
    assert (tmp_path / "cornell_spectra.txt").exists()


def test_phase_scenes_with_bvh_probe():
    bs = chip_smoke._bs()
    specs = chip_smoke.scene_specs(scale=64)[:5] + [
        ("cornell_bvh", lambda: bs.cornell_scene((16, 16), 2), 1,
         {"backend": "bvh"})]
    chip_smoke.phase_scenes(specs)


def test_phase_fidelity():
    chip_smoke.phase_fidelity(chip_smoke.fidelity_specs(scale=16), spp=1)


def test_phase_kernel_interpret():
    chip_smoke.phase_kernel(cornell_res=(16, 16), textured_res=(24, 16),
                            reps=1, interpret=True, e2e_spp=None)


def test_phase_devices_on_four_virtual_devices():
    chip_smoke.phase_devices(4, res=(16, 16), spp=1, depth=2)
