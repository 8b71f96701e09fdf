"""Render driver, image IO, checkpointing, sharded execution."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pbrs_jax import parallel, render as render_mod
from pbrs_jax.geometry import camera as cam_mod
from pbrs_jax.io import image as io_image
from pbrs_jax.scene import presets


@pytest.fixture(scope="module")
def tiny_cornell():
    scene = presets.cornell_box()
    cam = cam_mod.looking_at(
        cam_mod.make_camera((16, 16), 40.0), (278, 278, -800), (278, 278, 0),
        (0, 1, 0),
    )
    return scene.replace(camera=cam)


def test_render_image_driver(tiny_cornell):
    img, stats = render_mod.render_image(tiny_cornell, spp=4, max_depth=4)
    assert img.shape == (16, 16, 3)
    assert stats.spp == 4
    assert stats.camera_rays == 16 * 16 * 4
    assert not np.isnan(img).any()


def test_film_checkpoint_resume(tiny_cornell, tmp_path):
    ckpt = str(tmp_path / "film.npz")
    img_full, _ = render_mod.render_image(tiny_cornell, spp=4, seed=3)
    # Render 2 samples, checkpoint, resume for the remaining 2.
    film = render_mod.Film(width=16, height=16)
    render_mod.render_image(tiny_cornell, spp=4, seed=3, film=film,
                            checkpoint_path=ckpt, checkpoint_every=2)
    film2 = render_mod.Film.load(ckpt)
    assert film2.samples_done == 4
    # Restart midway: rebuild from a 2-sample checkpoint.
    film3 = render_mod.Film(width=16, height=16)
    render_mod.render_image(
        tiny_cornell, spp=4, seed=3,
        film=film3, checkpoint_path=ckpt, checkpoint_every=999,
    )
    np.testing.assert_allclose(film3.mean_image(), img_full, atol=1e-6)


def test_sigterm_checkpoints_film(tiny_cornell, tmp_path):
    """Preemption mid-render flushes whole sample batches to the checkpoint
    and raises; resuming from the checkpoint reproduces a straight render."""
    import signal
    import threading

    ckpt = str(tmp_path / "film_preempt.npz")
    img_full, _ = render_mod.render_image(tiny_cornell, spp=16, seed=5)

    # chunk_pixels=256 keeps one sample per launch (16 launches), giving the
    # signal many safe commit points.
    fired = threading.Timer(0.05, os.kill, (os.getpid(), signal.SIGTERM))
    fired.start()
    film = render_mod.Film(width=16, height=16)
    try:
        render_mod.render_image(
            tiny_cornell, spp=16, seed=5, film=film, chunk_pixels=256,
            checkpoint_path=ckpt, checkpoint_every=0,
        )
        interrupted = False
    except KeyboardInterrupt:
        interrupted = True
    finally:
        fired.cancel()

    saved = render_mod.Film.load(ckpt)
    assert saved.samples_done >= 1
    if interrupted:
        assert saved.samples_done < 16
    # Resume to 16 spp and compare against the uninterrupted render.
    render_mod.render_image(tiny_cornell, spp=16, seed=5, film=saved,
                            checkpoint_path=ckpt)
    np.testing.assert_allclose(saved.mean_image(), img_full, atol=1e-5)


def test_exr_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.random((7, 13, 3)).astype(np.float32) * 20.0
    path = str(tmp_path / "test.exr")
    io_image.write_exr(path, img)
    back = io_image.read_exr(path)
    np.testing.assert_array_equal(img, back)


def test_png_write(tmp_path):
    img = np.zeros((8, 8, 3), np.float32)
    img[:4] = [1.0, 0.5, 0.25]
    path = str(tmp_path / "test.png")
    io_image.write_png(path, img)
    from PIL import Image

    loaded = np.asarray(Image.open(path))
    assert loaded.shape == (8, 8, 3)
    assert loaded[0, 0, 0] == 255  # gamma(1.0) -> 255


def test_sharded_render_matches_single(tiny_cornell):
    """8-device CPU mesh: dp×sp sharded render must agree with the
    single-device driver bitwise (same sampler streams)."""
    assert len(jax.devices()) == 8
    mesh = parallel.make_mesh(n_dp=4, n_sp=2)
    img_sharded = parallel.render_image_sharded(
        tiny_cornell, spp=4, mesh=mesh, max_depth=4, seed=0
    )
    img_single, _ = render_mod.render_image(
        tiny_cornell, spp=4, max_depth=4, seed=0
    )
    np.testing.assert_allclose(img_sharded, img_single, rtol=2e-5, atol=1e-6)


def test_cli_smoke(tmp_path, monkeypatch):
    from pbrs_jax import cli

    monkeypatch.chdir(tmp_path)
    out = str(tmp_path / "out.png")
    rc = cli.main([
        "--scene_name", "quad", "--msaa", "1", "--depth", "2",
        "--resolution", "16x16", "--output", out,
    ])
    assert rc == 0
    assert os.path.exists(out)


def test_morton_pixel_order_is_permutation():
    from pbrs_jax.integrators import wavefront

    for w, h in ((7, 5), (800, 600), (64, 64)):
        order = wavefront.morton_pixel_order(w, h)
        assert order.shape == (w * h,)
        assert np.array_equal(np.sort(order), np.arange(w * h))
    # Z-curve locality: the first 4 pixels of a pow2 image form a 2x2 tile.
    o = wavefront.morton_pixel_order(64, 64)[:4]
    xs, ys = o % 64, o // 64
    assert xs.max() - xs.min() == 1 and ys.max() - ys.min() == 1
