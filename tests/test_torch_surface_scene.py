"""gags_torch.utils.synthetic.make_surface_scene (the port's copy of the
trained-statistics surface scene) against gags_tpu's: every array equal,
bit for bit, for the same arguments."""

import numpy as np
import pytest

from gags_tpu.utils.synthetic import make_surface_scene as jax_surface
from gags_torch.utils.synthetic import make_surface_scene


@pytest.mark.parametrize("n,width,height,seed,layers", [
    (2000, 128, 64, 0, 2),
    (3001, 160, 90, 3, 3),
    (517, 64, 48, 7, 1),
    (4096, 96, 96, 11, 4),
])
def test_surface_scene_equals_jax(n, width, height, seed, layers):
    got = make_surface_scene(n, width, height, seed=seed, layers=layers, opaque_frac=0.7)
    want = jax_surface(n, width, height, seed=seed, layers=layers, opaque_frac=0.7)
    assert set(got) == set(want) == {"means", "quats", "scales", "opacities", "sh", "features"}
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape[0] == n, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # surface-aligned pancakes: unit quaternions, the normal axis thinnest
    np.testing.assert_allclose(np.linalg.norm(got["quats"], axis=1), 1.0, atol=1e-5)
    assert (got["scales"][:, 2] < got["scales"][:, 0]).all()
