"""chip_smoke.py's helpers on the CPU: the device check, the compile-cache
rule, the device-vs-reference tolerance logic and the four-card sharded
phase (on four virtual CPU devices). The `chip` tests need the card."""

import json

import jax
import numpy as np
import pytest

import chip_smoke
from pbrs_jax import checks, runtime
from pbrs_jax.geometry import camera as cam_mod
from pbrs_jax.scene import presets


def test_check_device_fails_without_gpu():
    with pytest.raises(runtime.NoAcceleratorError):
        chip_smoke.check_device()


def test_main_prints_no_result_without_gpu(capsys):
    with pytest.raises(runtime.NoAcceleratorError):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("env", [None, "/some/where/cache"])
def test_compile_cache_dir_resolution(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = runtime.checkout_dir() + "/.jax_cache"
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
        want = env
    assert runtime.compile_cache_dir() == want


def test_enable_compile_cache_keeps_a_configured_directory(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    assert before  # conftest's per-run directory
    assert runtime.enable_compile_cache() == before
    assert jax.config.jax_compilation_cache_dir == before


def _img(seed=0, shape=(64, 64, 3)):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _one_pixel_off(img):
    out = img.copy()
    out[3, 5] += 0.5
    return out


def _many_pixels_off(img):
    out = img.copy()
    out[:1, :] += 0.01  # 64 of 4096 pixels: 1.6%
    out[1:2, :] -= 0.01  # keep the sum
    return out


def _with_nan(img):
    out = img.copy()
    out[0, 0, 0] = np.nan
    return out


@pytest.mark.parametrize("perturb, ok", [
    (lambda x: x, True),
    (lambda x: x * (1 + 1e-6), True),
    (_one_pixel_off, True),
    (_many_pixels_off, False),
    (lambda x: x * 1.01, False),
    (_with_nan, False),
])
def test_compare_images_limits(perturb, ok):
    ref = _img()
    rep = checks.compare_images(perturb(ref), ref)
    assert rep["ok"] is ok, rep


def test_render_crop_is_the_center_block():
    scene = presets.cornell_box()
    ids, size = checks.center_crop_pixels(scene, 64)
    w, h = scene.camera.width, scene.camera.height
    assert size == 64 and ids.shape == (64 * 64,)
    ys, xs = ids // w, ids % w
    assert (ys.min() + ys.max()) // 2 == h // 2 - 1 + (h % 2)
    assert (xs.min() + xs.max()) // 2 == w // 2 - 1 + (w % 2)
    img = checks.render_crop(scene, jax.devices("cpu")[0], size=8, spp=1,
                             max_depth=2)
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()


def test_sharded_phase_on_four_devices(capsys):
    """The --cards 4 phase on four virtual CPU devices: both meshes match
    the one-device render and every device reports its memory."""
    cam = cam_mod.looking_at(cam_mod.make_camera((16, 16), 40.0),
                             (278, 278, -800), (278, 278, 0), (0, 1, 0))
    scene = presets.cornell_box().replace(camera=cam)
    reports = chip_smoke.sharded_phase(scene, jax.devices()[:4], spp=4,
                                       max_depth=3)
    assert [r["mesh"] for r in reports] == ["dp4xsp1", "dp2xsp2"]
    assert all(r["ok"] for r in reports), reports
    out = capsys.readouterr().out
    assert out.count("peak_bytes_in_use") == 4
    for line in out.splitlines():
        if line.startswith("[sharded] {"):
            json.loads(line[len("[sharded] "):])


@pytest.mark.chip
def test_nvidia_smi_names_the_card(gpu):
    line = runtime.gpu_name_and_power_limit()
    assert gpu.device_kind.split()[-1] in line


@pytest.mark.chip
def test_reference_crops_match_on_the_card(gpu):
    cpu = jax.devices("cpu")[0]
    scene = presets.cornell_box()
    rep = checks.compare_images(checks.render_crop(scene, gpu),
                                checks.render_crop(scene, cpu))
    assert rep["ok"], rep
