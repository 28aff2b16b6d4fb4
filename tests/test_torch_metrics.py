"""PSNR and SSIM (gags_torch.utils.metrics) and SSIM's gradient against
gags_tpu.utils.metrics and jax.grad on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gags_tpu.utils import metrics as jm
from gags_torch.utils import metrics as tm


def _pair(h, w, c, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, size=(h, w, c)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, size=a.shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("h,w,c", [(16, 32, 3), (37, 23, 3), (9, 12, 1)])
def test_ssim_and_psnr_match_jax(h, w, c):
    a, b = _pair(h, w, c, seed=h)
    np.testing.assert_allclose(float(tm.ssim(torch.as_tensor(a), torch.as_tensor(b))),
                               float(jm.ssim(jnp.asarray(a), jnp.asarray(b))), atol=1e-6)
    np.testing.assert_allclose(float(tm.psnr(torch.as_tensor(a), torch.as_tensor(b))),
                               float(jm.psnr(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)
    assert float(tm.ssim(torch.as_tensor(a), torch.as_tensor(a))) == pytest.approx(1.0, abs=1e-6)


@pytest.mark.parametrize("h,w", [(16, 32), (25, 18)])
def test_ssim_gradient_matches_jax_grad(h, w):
    a, b = _pair(h, w, 3, seed=w)
    want = np.asarray(jax.grad(lambda x: jm.ssim(x, jnp.asarray(b)))(jnp.asarray(a)))
    x = torch.as_tensor(a).requires_grad_(True)
    tm.ssim(x, torch.as_tensor(b)).backward()
    np.testing.assert_allclose(x.grad.numpy(), want, atol=1e-6)
    assert np.abs(want).max() > 1e-4


def test_filter_is_separable_gaussian_with_zero_padding():
    """A unit impulse in the corner gives the window's outer product,
    cropped by the zero 'same' padding."""
    img = torch.zeros((12, 12, 1))
    img[0, 0, 0] = 1.0
    win = tm._gaussian_window(11)
    out = tm._filter2d_same(img, win)[..., 0]
    np.testing.assert_allclose(out[:6, :6].numpy(), np.outer(win[5:], win[5:]), atol=1e-7)
    assert float(win.sum()) == pytest.approx(1.0)
