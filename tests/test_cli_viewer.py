"""CLI end-to-end (render/info/peek/new/import) and viewer conversion."""

import json
import os

import numpy as np
import pytest

from pathtracing_spectrum_tpu import cli, viewer
from pathtracing_spectrum_tpu.utils import scene_io

from scene_helpers import cornell_scene


@pytest.fixture
def scene_file(tmp_path):
    sc = cornell_scene(depth=2, res=(16, 16))
    p = str(tmp_path / "scene.pts")
    scene_io.save_scene(sc, p)
    return p


def test_cli_render_export_png_checkpoint(tmp_path, scene_file, capsys):
    out = str(tmp_path / "out.txt")
    png = str(tmp_path / "img")
    ck = str(tmp_path / "ck.npz")
    rc = cli.main(["render", scene_file, "--spp", "3", "--out", out,
                   "--png", png, "--checkpoint", ck, "--quiet",
                   "--backend", "dense"])
    assert rc == 0
    assert os.path.exists(out)
    assert os.path.exists(ck)
    for k in range(4):
        assert os.path.exists(f"{png}_ch{k}.png")
    # export has nw * h lines
    lines = open(out).read().splitlines()
    assert len(lines) == 4 * 16
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["samples"] == 3


def test_cli_resume(tmp_path, scene_file):
    out1 = str(tmp_path / "a.txt")
    ck = str(tmp_path / "ck.npz")
    cli.main(["render", scene_file, "--spp", "2", "--out", out1,
              "--checkpoint", ck, "--quiet", "--backend", "dense"])
    out2 = str(tmp_path / "b.txt")
    rc = cli.main(["render", scene_file, "--spp", "5", "--out", out2,
                   "--resume", ck, "--quiet", "--backend", "dense"])
    assert rc == 0
    out3 = str(tmp_path / "c.txt")
    cli.main(["render", scene_file, "--spp", "5", "--out", out3,
              "--quiet", "--backend", "dense"])
    np.testing.assert_allclose(np.loadtxt(out2), np.loadtxt(out3),
                               rtol=1e-5, atol=1e-7)


def test_cli_missing_object_redirect(tmp_path, scene_file, capsys):
    # rewrite the scene to point at a missing OBJ
    sc = scene_io.load_scene(scene_file)
    real = sc.objects[0].filename
    sc.objects[0].filename = "/missing/cornell.obj"
    bad = str(tmp_path / "bad.pts")
    scene_io.save_scene(sc, bad)

    rc = cli.main(["render", bad, "--spp", "1", "--quiet",
                   "--out", str(tmp_path / "x.txt")])
    assert rc == 2  # refuses with a redirect hint
    rc = cli.main(["render", bad, "--spp", "1", "--quiet",
                   "--out", str(tmp_path / "x.txt"),
                   "--redirect", f"0={real}", "--backend", "dense"])
    assert rc == 0


def test_cli_peek_info_new_import(tmp_path, scene_file, capsys):
    assert cli.main(["peek", scene_file]) == 0
    assert capsys.readouterr().out.strip() == "16x16"

    assert cli.main(["info", scene_file]) == 0
    out = capsys.readouterr().out
    assert "triangles: 36" in out
    assert "light" in out

    p = str(tmp_path / "empty.pts")
    assert cli.main(["new", p]) == 0
    assert scene_io.get_resolution_from_scene_file(p) == (1024, 768)

    wv = tmp_path / "waves.txt"
    wv.write_text("100 200 300\n")
    assert cli.main(["import", "waves", str(wv)]) == 0
    assert "3 wavelengths" in capsys.readouterr().out


def test_cli_live_view_advances(tmp_path, scene_file, monkeypatch):
    """--live N refreshes the live PNG mid-render with advancing content."""
    out = str(tmp_path / "out.txt")
    live = str(tmp_path / "live.png")
    snapshots = []
    real = viewer.save_png

    def spy(img, channel, path, **kw):
        real(img, channel, path, **kw)
        if path == live:
            snapshots.append(open(path, "rb").read())

    monkeypatch.setattr(viewer, "save_png", spy)
    rc = cli.main(["render", scene_file, "--spp", "6", "--live", "2",
                   "--live-out", live, "--out", out, "--quiet",
                   "--backend", "dense"])
    assert rc == 0
    assert len(snapshots) == 3          # refreshed at 2, 4, 6 spp
    assert os.path.exists(live)
    assert any(a != b for a, b in zip(snapshots, snapshots[1:]))


def test_cli_viewport_auto_res(tmp_path):
    """autoRes scenes derive the render resolution from --viewport."""
    sc = cornell_scene(depth=2, res=(16, 16))
    sc.auto_res = True
    p = str(tmp_path / "auto.pts")
    scene_io.save_scene(sc, p)
    out = str(tmp_path / "out.txt")
    rc = cli.main(["render", p, "--spp", "1", "--viewport", "12x6",
                   "--out", out, "--quiet", "--backend", "dense"])
    assert rc == 0
    lines = open(out).read().splitlines()
    assert len(lines) == 4 * 6                    # nw * h rows
    assert len(lines[0].split()) == 12            # w floats per row

    # without autoRes the viewport is ignored
    sc.auto_res = False
    scene_io.save_scene(sc, p)
    cli.main(["render", p, "--spp", "1", "--viewport", "12x6",
              "--out", out, "--quiet", "--backend", "dense"])
    assert len(open(out).read().splitlines()) == 4 * 16


def test_viewer_grayscale_and_ascii():
    img = np.zeros((4, 4, 2), np.float32)
    img[0, 0, 0] = 1.0
    img[1, 1, 0] = 0.5
    img[2, 2, 0] = np.nan
    g = viewer.to_grayscale(img, 0)
    assert g.dtype == np.uint8
    assert g[0, 0] == 255 and g[1, 1] == 127 and g[2, 2] == 0
    gn = viewer.normalized_grayscale(img * 10.0, 0)
    assert gn[0, 0] == 255
    txt = viewer.ascii_preview(img, 0, width=4)
    assert isinstance(txt, str) and len(txt) > 0
    # out-of-range channel: black
    assert viewer.to_grayscale(img, 5).max() == 0


def test_spectral_to_srgb_hue_ordering():
    """Monochromatic samples land in the right hue; flat visible spectrum
    is near-neutral; thermal-IR wavenumbers map to black."""
    from pathtracing_spectrum_tpu.viewer import spectral_to_srgb

    # wavenumbers for 450 nm (blue), 550 nm (green), 650 nm (red)
    wn = [1e7 / 450.0, 1e7 / 550.0, 1e7 / 650.0]
    img = np.zeros((1, 3, 3), np.float32)
    img[0, 0, 0] = 1.0   # pixel 0: pure 450 nm
    img[0, 1, 1] = 1.0   # pixel 1: pure 550 nm
    img[0, 2, 2] = 1.0   # pixel 2: pure 650 nm
    rgb = spectral_to_srgb(img, wn).astype(int)
    assert rgb[0, 0, 2] > rgb[0, 0, 0]          # 450 nm: blue dominates
    assert rgb[0, 1, 1] >= rgb[0, 1, 0] and rgb[0, 1, 1] > rgb[0, 1, 2]
    assert rgb[0, 2, 0] > rgb[0, 2, 2]          # 650 nm: red dominates

    # flat equal-energy across the visible band -> near-neutral gray
    wn_flat = [1e7 / l for l in (460, 520, 580, 640)]
    flat = np.ones((1, 1, 4), np.float32)
    g = spectral_to_srgb(flat, wn_flat).astype(int)[0, 0]
    assert g.max() - g.min() < 80 and g.min() > 60

    # thermal IR only (the benchmark scenes' 500..2000 1/cm) -> black
    dark = spectral_to_srgb(np.ones((1, 1, 4), np.float32),
                            [500.0, 1000.0, 1500.0, 2000.0],
                            auto_expose=False)
    assert int(dark.max()) == 0


def test_srgb_device_matches_host():
    """The device (jnp) sRGB epilogue is the host pipeline within f32
    rounding: every uint8 value within 1 step, on a spectral image with
    NaNs, zeros and a bright tail exercising the auto-expose percentile."""
    import jax.numpy as jnp
    from pathtracing_spectrum_tpu.viewer import (spectral_to_srgb,
                                                 spectral_to_srgb_device)

    rng = np.random.default_rng(7)
    wn = [1e7 / 450, 1e7 / 520, 1e7 / 590, 1e7 / 650]
    img = rng.uniform(0, 1, (12, 9, 4)).astype(np.float32)
    img[0, 0] = np.nan
    img[1, 1] = 0.0
    img[2, 2] = 50.0                      # outlier past the 99.5 pctile
    for kw in (dict(), dict(exposure=1.5), dict(auto_expose=False)):
        host = spectral_to_srgb(img, wn, **kw).astype(np.int32)
        dev = np.asarray(spectral_to_srgb_device(jnp.asarray(img), wn,
                                                 **kw)).astype(np.int32)
        assert np.abs(host - dev).max() <= 1, kw


def test_session_result_srgb_golden():
    """RenderSession.result_srgb (device epilogue incl. tile-order
    unscramble) equals the host conversion of session.result()."""
    from pathtracing_spectrum_tpu.render import RenderSession
    from pathtracing_spectrum_tpu.viewer import spectral_to_srgb

    sc = cornell_scene(depth=2, res=(16, 8))
    s = RenderSession(sc, backend="dense", seed=3)
    s.start()
    s.step(2)
    dev = s.result_srgb().astype(np.int32)
    host = spectral_to_srgb(s.result(), sc.wavelengths).astype(np.int32)
    assert dev.shape == (8, 16, 3)
    assert np.abs(dev - host).max() <= 1


def test_save_srgb_png(tmp_path):
    from pathtracing_spectrum_tpu.viewer import save_srgb_png

    img = np.random.default_rng(0).uniform(
        0, 1, (8, 8, 3)).astype(np.float32)
    p = str(tmp_path / "c.png")
    save_srgb_png(img, [1e7 / 450, 1e7 / 550, 1e7 / 650], p)
    from pathtracing_spectrum_tpu.utils.png import read_png
    assert read_png(p).shape == (8, 8, 3)
