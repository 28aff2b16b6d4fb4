"""Query modules of gags_torch against gags_tpu on the same numpy inputs:
relevancy.iou, grounding (decode_features_chunked, point_relevancy,
smooth_point_mask, select_gaussians; knn_with_indices against
_knn_with_indices), edit
(select_by_text, apply_edit, EditConfig.from_yaml), clip_editor
(augment_image with JAX's draws, CLIPEditor.encode_image),
alpha_encoder (AlphaClipEncoder), colormaps.apply_boolean_colormap,
Camera.resized and sh_to_rgb.

Tolerances: 2e-5 for float32 products summed in another order (the
decoder, relevancy, CLIP towers); 1e-6 for elementwise chains; masks,
labels and index sets equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gags_tpu.core.camera import Camera as JCamera
from gags_tpu.core.sh import sh_to_rgb as jsh_to_rgb
from gags_tpu.models import clip as jc
from gags_tpu.models.decoders import FeatureDecoder as JFeat
from gags_tpu.query import alpha_encoder as jalpha
from gags_tpu.query import clip_editor as jedit_clip
from gags_tpu.query import edit as jedit
from gags_tpu.query import grounding as jg
from gags_tpu.query.relevancy import iou as jiou
from gags_tpu.scene.gaussian_data import GaussianScene as JScene
from gags_tpu.utils.colormaps import apply_boolean_colormap as japply_boolean
from gags_torch.core.camera import Camera
from gags_torch.core.sh import sh_to_rgb
from gags_torch.knn.knn import knn_with_indices
from gags_torch.models import clip as tc
from gags_torch.models.decoders import FeatureDecoder
from gags_torch.models.weights import decoder_state_from_flax
from gags_torch.query import alpha_encoder, clip_editor, edit, grounding
from gags_torch.query.relevancy import iou
from gags_torch.scene.gaussian_data import GaussianScene
from gags_torch.utils.colormaps import apply_boolean_colormap
from test_torch_clip import CFG, JCFG, random_openclip_state

PROD_TOL = 2e-5
ELEM_TOL = 1e-6


def _unit(a):
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def decoders():
    """A flax FeatureDecoder and the port's, carried across."""
    jdec = JFeat()
    params = jdec.init(jax.random.PRNGKey(0), jnp.zeros((1, 16)))
    dec = FeatureDecoder()
    dec.load_state_dict(decoder_state_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    return jdec, params, dec.eval()


def test_iou_matches():
    rng = np.random.default_rng(0)
    for _ in range(5):
        a, b = rng.random((2, 20, 30)) < 0.4
        assert iou(a, b) == jiou(a, b)
        assert iou(torch.from_numpy(a), torch.from_numpy(b)) == jiou(a, b)
    assert iou(np.zeros((3, 3), bool), np.zeros((3, 3), bool)) == 0.0


def test_decode_features_chunked_matches(decoders):
    jdec, params, dec = decoders
    f = np.random.default_rng(1).normal(size=(300, 16)).astype(np.float32)
    want = np.asarray(jg.decode_features_chunked(jdec.apply, params, jnp.asarray(f), chunk=128))
    got = grounding.decode_features_chunked(dec, torch.from_numpy(f), chunk=128).numpy()
    np.testing.assert_allclose(got, want, atol=PROD_TOL, rtol=PROD_TOL)


def test_point_relevancy_matches():
    rng = np.random.default_rng(2)
    d = _unit(rng.normal(size=(200, 32))).astype(np.float32)
    pos, neg = _unit(rng.normal(size=(3, 32))).astype(np.float32), \
        _unit(rng.normal(size=(4, 32))).astype(np.float32)
    for norm in (True, False):
        want = np.asarray(jg.point_relevancy(jnp.asarray(d), jnp.asarray(pos), jnp.asarray(neg),
                                             normalize=norm))
        got = grounding.point_relevancy(torch.from_numpy(d), torch.from_numpy(pos),
                                        torch.from_numpy(neg), normalize=norm).numpy()
        np.testing.assert_allclose(got, want, atol=PROD_TOL, rtol=PROD_TOL)


def _cloud(n, seed):
    """Clustered points: neighbourhoods inside the 0.05 vote radius."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-1, 1, (max(n // 60, 1), 3))
    return (centres[rng.integers(0, len(centres), n)]
            + rng.normal(0, 0.03, (n, 3))).astype(np.float32)


@pytest.mark.parametrize("n,k", [(1500, 32), (300, 8)])
def test_knn_with_indices_matches(n, k):
    """n = 1500 fills neither a 1024-row nor a 4096-column block exactly:
    distances within 1e-5 (absolute, on squares of ~1e-3), index sets
    equal wherever the k-th distance is not tied with the (k+1)-th."""
    xyz = _cloud(n, 3)
    wd, wi = (np.asarray(a) for a in jg._knn_with_indices(jnp.asarray(xyz), k))
    gd, gi = knn_with_indices(torch.from_numpy(xyz), k)
    gd, gi = gd.numpy(), gi.numpy()
    np.testing.assert_allclose(gd, wd, atol=1e-5, rtol=0)
    assert np.all(np.diff(gd, axis=1) >= 0) and not np.any(gi == np.arange(n)[:, None])
    assert all(set(a) == set(b) for a, b in zip(gi.tolist(), wi.tolist()))


def test_knn_larger_blocks_same_sets():
    xyz = torch.from_numpy(_cloud(1500, 4))
    d1, i1 = knn_with_indices(xyz, 16)
    d2, i2 = knn_with_indices(xyz, 16, row_block=4096, col_block=16384)
    np.testing.assert_allclose(d1.numpy(), d2.numpy(), atol=1e-6, rtol=0)
    assert all(set(a) == set(b) for a, b in zip(i1.tolist(), i2.tolist()))


def test_smooth_point_mask_and_select_match():
    xyz = _cloud(1200, 5)
    rng = np.random.default_rng(6)
    rel = rng.random((1200, 2)).astype(np.float32)
    rel[:, 0] = np.where(xyz[:, 0] > 0, 0.9, 0.1) + 0.05 * rng.random(1200)
    for smooth in (True, False):
        for p in (0, 1):
            want = np.asarray(jg.select_gaussians(jnp.asarray(rel), p, 0.5, jnp.asarray(xyz),
                                                  smooth=smooth))
            got = grounding.select_gaussians(torch.from_numpy(rel), p, 0.5,
                                             torch.from_numpy(xyz), smooth=smooth).numpy()
            np.testing.assert_array_equal(got, want)
    mask = rel[:, 0] > 0.5
    want = np.asarray(jg.smooth_point_mask(jnp.asarray(xyz), jnp.asarray(mask), k=16,
                                           radius=0.06, min_votes=8))
    got = grounding.smooth_point_mask(torch.from_numpy(xyz), torch.from_numpy(mask), k=16,
                                      radius=0.06, min_votes=8).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < mask.sum()  # the vote removes some points, keeps most


def _scenes(n=20):
    rng = np.random.default_rng(0)
    arrays = dict(means=rng.normal(size=(n, 3)), sh=rng.normal(size=(n, 16, 3)),
                  opacities_raw=rng.normal(size=n), scales_raw=rng.normal(size=(n, 3)),
                  quats=np.tile([1, 0, 0, 0], (n, 1)),
                  semantic_features=rng.normal(size=(n, 8)))
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    return (JScene(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            GaussianScene(**{k: torch.from_numpy(v) for k, v in arrays.items()}))


def test_select_by_text_matches():
    rng = np.random.default_rng(7)
    dec = rng.normal(size=(50, 8)).astype(np.float32)
    emb = rng.normal(size=(4, 8)).astype(np.float32)
    for targets, thr in (([1], None), ([0, 2], None), ([0], 0.2), ([1, 3], -0.1)):
        want = np.asarray(jedit.select_by_text(jnp.asarray(dec), jnp.asarray(emb), targets, thr))
        got = edit.select_by_text(torch.from_numpy(dec), torch.from_numpy(emb), targets,
                                  thr).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", ["deletion", "extraction", "color_func"])
def test_apply_edit_matches(op):
    js, ts = _scenes()
    mask = np.random.default_rng(8).random(20) < 0.4
    src = "lambda color: np.clip(color[..., [2, 1, 0]] * 0.5 + 0.1, 0, 1)"
    want = jedit.apply_edit(js, jnp.asarray(mask), op,
                            jedit.parse_color_func(src) if op == "color_func" else None)
    got = edit.apply_edit(ts, torch.from_numpy(mask), op,
                          edit.parse_color_func(src) if op == "color_func" else None)
    assert got.num_gaussians == want.num_gaussians
    for name in ("means", "sh", "opacities_raw", "scales_raw", "quats", "semantic_features"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=ELEM_TOL, rtol=ELEM_TOL)


def test_edit_config_yaml_and_color_func(tmp_path):
    p = tmp_path / "edit.yaml"
    p.write_text("edit:\n  objects: [\"car\", \"tree\"]\n  operations: [\"color_func\"]\n"
                 "  targets: \"car\"\n  colorFunc: \"lambda c: 1.0 - c\"\n")
    got, want = edit.EditConfig.from_yaml(str(p)), jedit.EditConfig.from_yaml(str(p))
    assert got.__dict__ == want.__dict__
    assert got.operation == "color_func" and got.targets == ["car"] and got.threshold is None
    with pytest.raises(ValueError, match="callable"):
        edit.parse_color_func("3")
    with pytest.raises(NameError):
        edit.parse_color_func("lambda c: open('x')")(0)
    with pytest.raises(ValueError, match="unknown edit"):
        edit.apply_edit(_scenes()[1], torch.zeros(20, dtype=torch.bool), "blur")


def _jax_draws(key, jitter=0.1, max_rot=20.0):
    """augment_image's draws from a PRNG key, in its order of splits."""
    k_flip, k_b, k_c, k_s, k_rot, k_blur = jax.random.split(key, 6)
    u = lambda k, lo, hi: float(jax.random.uniform(k, minval=lo, maxval=hi))  # noqa: E731
    ang = jax.random.uniform(k_rot, minval=-max_rot, maxval=max_rot) * (jnp.pi / 180.0)
    return clip_editor.AugmentDraws(
        flip=bool(jax.random.bernoulli(k_flip)), brightness=u(k_b, 1 - jitter, 1 + jitter),
        contrast=u(k_c, 1 - jitter, 1 + jitter), saturation=u(k_s, 1 - jitter, 1 + jitter),
        angle=float(ang), sigma=u(k_blur, 0.01, 2.0))


@pytest.mark.parametrize("hw,out", [((48, 40), 32), ((20, 24), 32)])
def test_augment_image_matches_with_jax_draws(hw, out):
    """Down- and up-sampling resizes; 1e-5 on [0, 1] pixels."""
    img = np.random.default_rng(9).uniform(0, 1, (*hw, 3)).astype(np.float32)
    for seed in range(2):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jedit_clip.augment_image(jnp.asarray(img), key, out))
        got = clip_editor.augment_image(torch.from_numpy(img), _jax_draws(key), out).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("hw,out", [((48, 40), 32), ((20, 24), 32), ((7, 9), 16)])
def test_resize_cubic_matches_jax_image_resize(hw, out):
    img = np.random.default_rng(10).normal(size=(2, *hw, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(img), (2, out, out, 3), "cubic"))
    got = clip_editor.resize_cubic_like_jax(torch.from_numpy(img), (out, out)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_clip_editor_encode_image_matches():
    sd = random_openclip_state(CFG, seed=11)
    model = tc.load_openclip_state_dict(sd, CFG, device="cpu")
    jed = jedit_clip.CLIPEditor(JCFG, jc.load_openclip_state_dict(sd, JCFG))
    ed = clip_editor.CLIPEditor(model)
    img = np.random.default_rng(12).uniform(0, 1, (48, 40, 3)).astype(np.float32)
    np.testing.assert_allclose(ed.encode_image(torch.from_numpy(img)).numpy(),
                               np.asarray(jed.encode_image(jnp.asarray(img))),
                               atol=PROD_TOL, rtol=0)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jed.encode_image(jnp.asarray(img), stochastic=3, key=key))
    draws = [_jax_draws(k) for k in jax.random.split(key, 3)]
    got = ed.encode_image(torch.from_numpy(img), stochastic=3, draws=draws).numpy()
    np.testing.assert_allclose(got, want, atol=PROD_TOL, rtol=0)
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    a = ed.encode_image(torch.from_numpy(img), stochastic=2, generator=gen())
    assert torch.equal(a, ed.encode_image(torch.from_numpy(img), stochastic=2, generator=gen()))
    assert a.shape == (2, CFG.embed_dim) and not torch.equal(a[0], a[1])


def test_alpha_encoder_matches():
    """The cases of tests/test_alphaclip_parity.py's encoder test, held to
    the JAX encoder on one random alpha_clip-layout state dict."""
    sd = random_openclip_state(CFG, seed=13, alpha=True)
    path_sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    jvis = jc.load_alphaclip_state_dict(sd, JCFG)
    jtext = {"params": jc.load_openclip_state_dict(
        {k: v for k, v in sd.items() if "conv1_alpha" not in k}, JCFG)["params"]["text"]}
    jenc = jalpha.AlphaClipEncoder(JCFG, jvis, jtext)
    enc = alpha_encoder.AlphaClipEncoder(
        CFG, tc.load_alphaclip_state_dict(path_sd, CFG, device="cpu"),
        alpha_encoder.load_text_tower(path_sd, CFG, device="cpu"))
    s = CFG.image_size
    rng = np.random.default_rng(14)
    image = rng.normal(size=(1, s, s, 3)).astype(np.float32)
    for a in (np.ones((1, s, s, 1)), np.zeros((1, s, s, 1))):
        am = alpha_encoder.mask_transform(a)
        np.testing.assert_array_equal(am, jalpha.mask_transform(a))
        want = np.asarray(jenc.encode_image(jnp.asarray(image), jnp.asarray(am)))
        got = enc.encode_image(torch.from_numpy(image).permute(0, 3, 1, 2),
                               torch.from_numpy(am).permute(0, 3, 1, 2)).numpy()
        np.testing.assert_allclose(got, want, atol=PROD_TOL, rtol=0)
    r = _unit(rng.normal(size=(3, CFG.embed_dim))).astype(np.float32)
    jenc.pos_embeds, jenc._neg_embeds = jnp.asarray(r[:1]), jnp.asarray(r[1:])
    enc.pos_embeds, enc._neg_embeds = torch.from_numpy(r[:1]), torch.from_numpy(r[1:])
    emb = rng.normal(size=(2, CFG.embed_dim)).astype(np.float32)
    np.testing.assert_allclose(enc.get_relevancy(torch.from_numpy(emb), 0).numpy(),
                               np.asarray(jenc.get_relevancy(jnp.asarray(emb), 0)),
                               atol=PROD_TOL, rtol=0)
    sem = rng.normal(size=(2, 4, 5, CFG.embed_dim)).astype(np.float32)
    got = enc.get_max_across(torch.from_numpy(sem)).numpy()
    assert got.shape == (2, 1, 4, 5)
    np.testing.assert_allclose(got, np.asarray(jenc.get_max_across(jnp.asarray(sem))),
                               atol=PROD_TOL, rtol=0)
    with pytest.raises(ValueError, match="set_positives"):
        alpha_encoder.AlphaClipEncoder(CFG, enc.visual, enc.text).get_max_across(sem)


def test_boolean_colormap_resized_camera_sh_to_rgb():
    m = np.random.default_rng(15).random((5, 7)) < 0.5
    np.testing.assert_array_equal(apply_boolean_colormap(m), japply_boolean(m))
    K = np.array([[300.0, 0, 320], [0, 310.0, 180], [0, 0, 1]], np.float32)
    vm = np.eye(4, dtype=np.float32)
    want = JCamera(viewmat=jnp.asarray(vm), K=jnp.asarray(K), width=640, height=360).resized(
        988, 731)
    got = Camera(viewmat=torch.from_numpy(vm), K=torch.from_numpy(K), width=640,
                 height=360).resized(988, 731)
    assert (got.width, got.height) == (want.width, want.height)
    np.testing.assert_array_equal(got.K.numpy(), np.asarray(want.K))
    sh = np.random.default_rng(16).normal(size=(10, 3)).astype(np.float32)
    np.testing.assert_allclose(sh_to_rgb(torch.from_numpy(sh)).numpy(),
                               np.asarray(jsh_to_rgb(jnp.asarray(sh))), atol=ELEM_TOL, rtol=0)
