"""Chunking the pixel grid of a zoo scene (pbrs_jax/scene/zoo.py) into
several launches must not change the image."""

import numpy as np
import pytest

from pbrs_jax import render
from pbrs_jax.scene import zoo


@pytest.mark.parametrize("name", sorted(zoo.ZOO))
def test_zoo_chunk_invariance(name):
    """Three pixel chunks per sample (the last one padded) vs the whole
    frame in one launch: identical images."""
    scene = zoo.ZOO[name]()
    n = scene.camera.width * scene.camera.height
    whole, _ = render.render_image(scene, spp=4, max_depth=4, seed=1,
                                   chunk_pixels=n)
    split, stats = render.render_image(scene, spp=4, max_depth=4, seed=1,
                                       chunk_pixels=n // 3 + 1)
    assert stats.launches == 3 * 4
    assert np.asarray(whole).sum() > 0.0
    np.testing.assert_allclose(split, whole, rtol=1e-6, atol=1e-7)
