#!/usr/bin/env python
"""MSE/RMSE between two EXR images (BASELINE.md accuracy methodology).

    python tools/compare_exr.py a.exr b.exr

The reference publishes no images and its mounted snapshot does not build
(SURVEY §2.10), so accuracy is validated against corrected-reference ground
truth: a high-spp render of the same estimator (plus the NEE-vs-brute-force
cross-check in tests/test_integrator.py).
"""

import json
import sys

import numpy as np

sys.path.insert(0, ".")
from pbrs_jax.io import image as io_image  # noqa: E402


def main(a_path, b_path):
    a = io_image.read_exr(a_path)
    b = io_image.read_exr(b_path)
    assert a.shape == b.shape, (a.shape, b.shape)
    diff = (a - b).astype(np.float64)
    mse = float((diff**2).mean())
    # Tone-mapped MSE (sqrt gamma, as the PNG path) for perceptual scale.
    ga = np.sqrt(np.clip(a, 0, None))
    gb = np.sqrt(np.clip(b, 0, None))
    mse_gamma = float(((ga - gb) ** 2).mean())
    print(json.dumps({
        "mse_linear": mse,
        "rmse_linear": mse ** 0.5,
        "mse_gamma": mse_gamma,
        "max_abs": float(np.abs(diff).max()),
    }))


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
