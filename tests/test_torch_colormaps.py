"""The device turbo colormap against the host one (no JAX: runs on the card too)."""

import zlib

import numpy as np
import pytest
import torch

from gags_torch.utils.colormaps import turbo, turbo_png_pixels
from gags_torch.utils.image import encode_png


def _png_pixels(b):
    w, h = np.frombuffer(b[16:24], ">u4")
    n = int(np.frombuffer(b[33:37], ">u4")[0])
    rows = np.frombuffer(zlib.decompress(b[41:41 + n]), np.uint8).reshape(h, 1 + 3 * w)
    return rows[:, 1:].reshape(h, w, 3)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_turbo_png_pixels_are_the_host_colormaps(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(0)
    x = np.concatenate([np.linspace(-0.1, 1.1, 2_000_001, dtype=np.float32),
                        rng.uniform(size=1_000_000).astype(np.float32),
                        np.float32([0.0, 1.0, np.nextafter(np.float32(1), np.float32(0))])])
    want = _png_pixels(encode_png(turbo(x).reshape(1, -1, 3)))[0]
    got = turbo_png_pixels(torch.from_numpy(x).to(device)).cpu().numpy()
    np.testing.assert_array_equal(got, want)
