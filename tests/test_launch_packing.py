"""Launch packing: several samples of a small frame packed into one
launch (lanes = pixels x samples) must render the same image as one
sample per launch."""

import numpy as np
import pytest

from pbrs_jax import render
from pbrs_jax.scene import zoo


@pytest.mark.parametrize("name", sorted(zoo.ZOO))
def test_zoo_launch_packing_invariance(name):
    scene = zoo.ZOO[name]()
    n = scene.camera.width * scene.camera.height
    one, s1 = render.render_image(scene, spp=4, max_depth=4, seed=2,
                                  chunk_pixels=n)
    packed, s4 = render.render_image(scene, spp=4, max_depth=4, seed=2)
    assert (s1.launches, s4.launches) == (4, 1)
    assert s1.traced_rays == s4.traced_rays > 0
    np.testing.assert_allclose(packed, one, rtol=1e-5, atol=1e-6)
