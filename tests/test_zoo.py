"""The material/light zoo scenes (pbrs_jax/scene/zoo.py) through the
general wavefront: pinned golden checksums."""

import pytest

from pbrs_jax import checks
from pbrs_jax.scene import zoo


@pytest.mark.parametrize("name", sorted(zoo.ZOO))
def test_zoo_golden_checksum(name):
    build, depth = checks.golden_families()[name]
    got = checks.golden_checksum(build(), depth)
    want = checks.load_golden()[name]
    assert got > 0.0
    assert checks.golden_ok(got, want), (name, got, want)
