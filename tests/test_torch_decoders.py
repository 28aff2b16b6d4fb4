"""gags_torch.models.decoders vs the flax decoders, through
models.weights.decoder_state_from_flax. Tolerance 2e-5: the same float32
products summed in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gags_tpu.models.decoders import FeatureDecoder as JFeat
from gags_tpu.models.decoders import ScaleDecoder as JScale
from gags_torch.models.decoders import FeatureDecoder, ScaleDecoder
from gags_torch.models.weights import decoder_state_from_flax

TOL = 2e-5


def _np_params(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("seed", [0, 1])
def test_feature_decoder_matches_flax(seed):
    x = np.random.default_rng(seed).normal(size=(6, 7, 16)).astype(np.float32)
    jdec = JFeat()
    params = jdec.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    want = np.asarray(jdec.apply(params, jnp.asarray(x)))
    dec = FeatureDecoder()
    dec.load_state_dict(decoder_state_from_flax(_np_params(params)))
    with torch.no_grad():
        got = dec(torch.as_tensor(x)).numpy()
    assert got.shape == (6, 7, 512)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def test_scale_decoder_matches_flax():
    x = np.random.default_rng(2).normal(size=(40, 16)).astype(np.float32)
    jdec = JScale()
    params = jdec.init(jax.random.PRNGKey(3), jnp.asarray(x))
    want = np.asarray(jdec.apply(params, jnp.asarray(x)))
    dec = ScaleDecoder()
    dec.load_state_dict(decoder_state_from_flax(_np_params(params)["params"]))
    with torch.no_grad():
        got = dec(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_generator_init_is_seeded_and_bounded():
    a = FeatureDecoder(generator=torch.Generator().manual_seed(5))
    b = FeatureDecoder(generator=torch.Generator().manual_seed(5))
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
    bound = (1.0 / 256) ** 0.5
    assert a.d3.bias.abs().max() <= bound and a.d3.bias.abs().max() > 0
    with torch.no_grad():  # zero features still decode to unit vectors
        out = a(torch.zeros(3, 16))
    np.testing.assert_allclose(out.norm(dim=-1).numpy(), 1.0, atol=1e-5)
