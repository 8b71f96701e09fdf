"""Checksum-pinned estimator regression tests.

Rounds of performance work must not silently shift radiance: every scene
family gets a tiny deterministic render whose radiance sum is pinned to a
stored value (pbrs_jax/data/golden_checksums.json). The PCG sampler is
stateless, so these values are stable across backends; the tolerance
covers float-order drift only. chip_smoke.py checks the same families on
the GPU.

Regenerate after an INTENTIONAL estimator change:
    python tests/test_golden.py --regen
"""

import json
import os

import pytest

from pbrs_jax import checks

# The preset families; the zoo families run in tests/test_zoo.py.
PRESET_FAMILIES = ("cornell_box", "mesh_ball_l2", "plates", "two_perlin",
                   "env_mapped", "mixed_spheres", "everything")


def _check_family(name):
    golden = checks.load_golden()
    mk, depth = checks.golden_families()[name]
    got = checks.golden_checksum(mk(), depth)
    want = golden[name]
    assert checks.golden_ok(got, want), (
        f"{name}: checksum {got!r} drifted from pinned {want!r} "
        f"(rel {abs(got - want) / max(abs(want), 1e-9):.2e}) — if the "
        "estimator change is intentional, regenerate with "
        "`python tests/test_golden.py --regen` and document it")


@pytest.mark.parametrize("name", PRESET_FAMILIES)
def test_pinned_checksums(name):
    _check_family(name)


def test_every_family_is_pinned():
    assert sorted(checks.load_golden()) == sorted(checks.golden_families())


if __name__ == "__main__":
    import sys

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    if "--regen" in sys.argv:
        names = sys.argv[sys.argv.index("--regen") + 1:]
        out = checks.load_golden()
        for name, (mk, depth) in checks.golden_families().items():
            if names and name not in names:
                continue
            out[name] = checks.golden_checksum(mk(), depth)
            print(name, out[name], flush=True)
        with open(checks.GOLDEN_PATH, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {checks.GOLDEN_PATH}")
