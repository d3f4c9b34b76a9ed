"""Render session state machine, target-spp auto-pause, checkpoint/resume."""

import numpy as np
import pytest

from pathtracing_spectrum_tpu.render import RenderSession, RenderStatus

from scene_helpers import cornell_scene


def small_session(**kw):
    sc = cornell_scene(depth=2, res=(8, 8))
    return RenderSession(sc, backend="dense", **kw)


def test_progressive_mean_semantics():
    s = small_session()
    s.start()
    img1 = s.step(1)
    total1 = img1 * 1
    img4 = s.step(3)
    assert s.samples == 4
    # out = total / samples (pathtracer.cpp:595-598): means stay bounded
    assert np.isfinite(img4).all()
    assert img4.shape == (8, 8, 4)


def test_pause_keeps_stop_discards():
    s = small_session()
    s.start()
    s.step(2)
    s.pause()
    assert s.status == RenderStatus.PAUSED
    assert s.samples == 2
    s.resume()
    s.step(1)
    assert s.samples == 3
    s.stop()
    s.start()  # restart from stopped -> accumulator reset
    assert s.samples == 0


def test_restart_resets():
    s = small_session()
    s.start()
    s.step(2)
    s.restart()
    assert s.samples == 0
    s.step(1)
    assert s.samples == 1


def test_target_spp_auto_pause():
    s = small_session()
    s.run(target_spp=3)
    assert s.samples == 3
    assert s.status == RenderStatus.PAUSED


def test_deterministic_given_seed():
    a = small_session(seed=7).run(target_spp=2)
    b = small_session(seed=7).run(target_spp=2)
    np.testing.assert_array_equal(a, b)
    c = small_session(seed=8).run(target_spp=2)
    assert not np.array_equal(a, c)


def test_checkpoint_exact_resume(tmp_path):
    p = str(tmp_path / "ckpt.npz")
    a = small_session(seed=3)
    a.run(target_spp=2)
    a.save_checkpoint(p)
    a.run(target_spp=5)
    full = a.result()

    b = small_session(seed=3)
    b.start()
    b.load_checkpoint(p)
    assert b.samples == 2
    b.run(target_spp=5)
    np.testing.assert_array_equal(b.result(), full)


def test_checkpoint_mismatch_rejected(tmp_path):
    p = str(tmp_path / "ckpt.npz")
    a = small_session()
    a.run(target_spp=1)
    a.save_checkpoint(p)
    sc = cornell_scene(depth=2, res=(16, 16))
    b = RenderSession(sc, backend="dense")
    b.start()
    with pytest.raises(ValueError):
        b.load_checkpoint(p)


def test_run_batches_dispatches(monkeypatch):
    """run(64) issues <= 9 device dispatches (batched render_samples)."""
    import pathtracing_spectrum_tpu.render as render_mod

    calls = {"n": 0}
    real = render_mod.render_samples

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(render_mod, "render_samples", counting)
    s = small_session()
    s.run(target_spp=64)
    assert s.samples == 64
    assert calls["n"] <= 9


def test_run_batched_matches_per_sample():
    a = small_session(seed=5).run(target_spp=5, batch=4)
    b = small_session(seed=5).run(target_spp=5, batch=1)
    np.testing.assert_array_equal(a, b)


def test_checkpoint_scene_content_mismatch(tmp_path):
    """Same shapes, different scene content -> refuse to resume."""
    p = str(tmp_path / "ckpt.npz")
    a = small_session()
    a.run(target_spp=1)
    a.save_checkpoint(p)

    sc = cornell_scene(depth=2, res=(8, 8))       # identical shapes...
    m = sc.objects[0].elements[0].material.copy()
    m.temperature = 99.0                          # ...different content
    sc.set_material(0, 0, m)
    b = RenderSession(sc, backend="dense")
    b.start()
    with pytest.raises(ValueError, match="scene mismatch"):
        b.load_checkpoint(p)

    # the unmodified scene still resumes
    c = small_session()
    c.start()
    c.load_checkpoint(p)
    assert c.samples == 1


def test_content_digest_sensitivity():
    a = cornell_scene(depth=2, res=(8, 8))
    b = cornell_scene(depth=2, res=(8, 8))
    assert a.content_digest() == b.content_digest()
    b.trace_depth = 5
    assert a.content_digest() != b.content_digest()


def test_stats():
    s = small_session()
    s.run(target_spp=2)
    st = s.stats()
    assert st["samples"] == 2
    assert st["elapsed_s"] > 0
    assert st["rays_traced"] > 0
    assert st["mrays_per_s"] > 0
    assert st["triangles"] == 36


@pytest.mark.slow
def test_batched_hoist_matches_render_sample_exactly():
    """render_samples hoists the sample-invariant primary intersection +
    attribute fetch out of the sample loop; the result must stay BIT-equal
    to stepping render_sample with the same key schedule."""
    import jax
    import jax.numpy as jnp
    from pathtracing_spectrum_tpu import camera_rays
    from pathtracing_spectrum_tpu.engine import render_sample, render_samples

    sc = cornell_scene(depth=2, res=(16, 16))
    scene = sc.compile()
    ro, rd = camera_rays(sc.camera(), 16, 16)
    key = jax.random.key(9)
    total_a = jnp.zeros((256, 4), jnp.float32)
    samples_a = jnp.zeros((), jnp.int32)
    total_a, samples_a, out_a, _ = render_samples(
        scene, ro, rd, total_a, samples_a, key, 0, n_steps=3, max_depth=2,
        backend="dense_pallas", interpret=True)

    total_b = jnp.zeros((256, 4), jnp.float32)
    samples_b = jnp.zeros((), jnp.int32)
    for i in range(3):
        total_b, samples_b, out_b, _ = render_sample(
            scene, ro, rd, total_b, samples_b, jax.random.fold_in(key, i),
            max_depth=2, backend="dense_pallas", interpret=True)
    np.testing.assert_array_equal(np.asarray(out_a), np.asarray(out_b))


def test_run_jitter_batches_dispatches(monkeypatch):
    """Jitter mode now batches too: run(64) issues <= 9 dispatches via
    in-dispatch ray regeneration."""
    import pathtracing_spectrum_tpu.render as render_mod

    calls = {"samples": 0, "persample": 0}
    real = render_mod.render_samples

    def counting(*a, **kw):
        calls["samples"] += 1
        return real(*a, **kw)

    real1 = render_mod.render_sample

    def counting1(*a, **kw):
        calls["persample"] += 1
        return real1(*a, **kw)

    monkeypatch.setattr(render_mod, "render_samples", counting)
    monkeypatch.setattr(render_mod, "render_sample", counting1)
    s = small_session(jitter=True)
    s.run(target_spp=64)
    assert s.samples == 64
    assert calls["samples"] <= 9
    assert calls["persample"] == 0


def test_jitter_batched_deterministic_and_sane():
    a = small_session(jitter=True, seed=3).run(target_spp=8)
    b = small_session(jitter=True, seed=3).run(target_spp=8)
    np.testing.assert_array_equal(a, b)
    assert not np.isnan(a).any() and (a >= 0).all() and a.mean() > 0
    # non-jitter samples pixel CORNERS (reference parity) — at 8x8 the two
    # estimators target measurably different images, so only check they
    # disagree; cross-seed jitter runs must agree statistically
    c = small_session(jitter=False, seed=3).run(target_spp=8)
    assert not np.array_equal(a, c)
    # cross-seed agreement is statistical; the hot emitter + RR make this
    # scene high-variance, so compare at 32 spp with a loose bound
    d = small_session(jitter=True, seed=11).run(target_spp=32)
    e = small_session(jitter=True, seed=3).run(target_spp=32)
    rel = abs(e.mean() - d.mean()) / e.mean()
    assert rel < 0.3


def test_jitter_checkpoint_exact_resume(tmp_path):
    p = str(tmp_path / "j.npz")
    s = small_session(jitter=True, seed=7)
    s.run(target_spp=3)
    s.save_checkpoint(p)
    s.run(target_spp=6)
    full = s.result()

    r = small_session(jitter=True, seed=7)
    r.start()
    r.load_checkpoint(p)
    r.run(target_spp=6)
    np.testing.assert_array_equal(r.result(), full)


def test_jitter_checkpoint_mode_mismatch_refused(tmp_path):
    p = str(tmp_path / "j.npz")
    s = small_session(jitter=True, seed=1)
    s.run(target_spp=2)
    s.save_checkpoint(p)
    t = small_session(jitter=False, seed=1)
    t.start()
    with pytest.raises(ValueError, match="jitter"):
        t.load_checkpoint(p)


def test_chunked_trace_bit_identical():
    """chunks (bounded-width wavefront): per-pixel math is width-
    independent, so tracing the frame as sub-wavefronts with the same
    per-pixel variates reproduces the full-width radiance bit for bit."""
    import jax
    import jax.numpy as jnp
    from pathtracing_spectrum_tpu import camera_rays
    from pathtracing_spectrum_tpu.engine import trace_radiance

    sc = cornell_scene(depth=2, res=(16, 8))
    scene = sc.compile()
    ro, rd = camera_rays(sc.camera(), 16, 8)
    n = 128
    key = jax.random.key(9)
    R = jax.random.uniform(jax.random.key(4), (4, 4, n))
    full = np.asarray(trace_radiance(scene, ro, rd, key, 2,
                                     backend="dense",
                                     rand_override=R).radiance)
    parts = []
    for c in range(4):
        s = slice(c * 32, (c + 1) * 32)
        parts.append(np.asarray(trace_radiance(
            scene, ro[s], rd[s], key, 2, backend="dense",
            rand_override=R[:, :, s]).radiance))
    np.testing.assert_array_equal(np.concatenate(parts, axis=0), full)


def test_chunked_session_runs_and_converges():
    a = small_session(seed=5).run(target_spp=64, batch=32)
    b = small_session(seed=5, chunks=4).run(target_spp=64, batch=32)
    # different variate streams (per-chunk key fold), same estimator
    rel = abs(a.mean() - b.mean()) / a.mean()
    assert np.isfinite(b).all() and rel < 0.1


def test_chunked_checkpoint_exact_resume_and_mismatch(tmp_path):
    p = str(tmp_path / "c.npz")
    s = small_session(seed=2, chunks=4)
    s.run(target_spp=3)
    s.save_checkpoint(p)
    s.run(target_spp=6)
    full = s.result()

    r = small_session(seed=2, chunks=4)
    r.start()
    r.load_checkpoint(p)
    r.run(target_spp=6)
    np.testing.assert_array_equal(r.result(), full)

    t = small_session(seed=2)          # chunks=1: different key folds
    t.start()
    with pytest.raises(ValueError, match="chunks"):
        t.load_checkpoint(p)


def test_render_samples_chunked_exact_vs_per_chunk_truth():
    """Drive render_samples(chunks=N) itself (the lax.map + sliced
    primary0 plumbing) against an independently-computed truth: the same
    per-chunk key folds (fold_in(sample_key, 0xC40000+c)) replayed
    through direct trace_radiance calls on each chunk slice. Pins the
    chunk plumbing end-to-end — the trace-level width-independence test
    above cannot see a bug in the fold/slice/scan wiring."""
    import jax
    import jax.numpy as jnp
    from pathtracing_spectrum_tpu import camera_rays
    from pathtracing_spectrum_tpu.engine import render_samples, trace_radiance

    sc = cornell_scene(depth=2, res=(16, 8))
    scene = sc.compile()
    ro, rd = camera_rays(sc.camera(), 16, 8)
    n, nw = 128, len(sc.wavelengths)
    chunks, nc = 4, 32
    base_key = jax.random.key(11)
    n_steps = 3

    total0 = jnp.zeros((n, nw), jnp.float32)
    tot, samples, out, rays = render_samples(
        scene, ro, rd, total0, jnp.zeros((), jnp.int32), base_key,
        0, n_steps=n_steps, max_depth=2, backend="dense", chunks=chunks)

    want = np.zeros((n, nw), np.float32)
    for i in range(n_steps):
        k = jax.random.fold_in(base_key, i)
        for c in range(chunks):
            s = slice(c * nc, (c + 1) * nc)
            kc = jax.random.fold_in(k, 0xC40000 + c)
            want[s] += np.asarray(trace_radiance(
                scene, ro[s], rd[s], kc, 2, backend="dense").radiance)
    assert int(samples) == n_steps
    np.testing.assert_allclose(np.asarray(tot), want, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(np.asarray(out), want / n_steps,
                               rtol=1e-6, atol=1e-8)
