"""The frozen counts against values worked out by hand at small shapes."""

import math

import torch

from benchmark.counts import ops, pairs

FEATURE = [(16, 256)] + [(256, 256)] * 7 + [(256, 512)]
SCALE = [(16, 64), (64, 128), (128, 64), (64, 32), (32, 16), (16, 3)]


def test_decoder_macs_per_pixel():
    # 16*256 + 7*256*256 + 256*512 and 16*64 + 64*128 + 128*64 + 64*32 + 32*16 + 16*3
    assert ops.mlp_macs(FEATURE) == 4096 + 458752 + 131072 == 593920
    assert ops.mlp_macs(SCALE) == 1024 + 8192 + 8192 + 2048 + 512 + 48 == 20016


def test_gad_step_flops_at_640x360():
    # 3 x 2 x 613,936 MACs a pixel at 230,400 pixels is 0.8487 TFLOP (the 0.849 of a 3x rule); the
    # scale decoder's first layer needs no input gradient (its input is
    # the detached feature map), 2 x 1,024 x 230,400 FLOP less
    px = 640 * 360
    assert 3 * 2 * 613936 * px == 848_705_126_400
    got = ops.decoder_train_flops(px, FEATURE, SCALE)
    assert got == 848_705_126_400 - 2 * 1024 * px == 848_233_267_200
    assert round(got / 1e12, 3) == 0.848
    assert math.isclose(1e3 * got / ops.PEAK_F32_FLOPS, 12.6602, rel_tol=1e-5)  # ms at peak


def test_blend_ops_rules():
    # 16 per near pair a walk; 4 + 2C, 2C and 45 + 6C per blended pair
    assert ops.blend_ops(10, 4, 7) == 160 + 28
    assert ops.forward_blend_ops(10, 4, 16) == 160 + 4 * 36
    assert ops.colour_backward_ops(10, 4, 16) == 160 + 4 * 32
    assert ops.full_backward_ops(10, 4, 3) == 2 * 160 + 4 * 63


def test_byte_rules():
    # 5 Gaussians seen, 7 instances, 2 tiles, 6 pixels, C = 3
    assert ops.forward_blend_bytes(5, 7, 2, 6, 3) == 4 * (5 * 11 + 7 + 4 + 3 + 6 * 4)
    assert ops.colour_backward_bytes(5, 7, 2, 6, 3) == 4 * (5 * 8 + 7 + 4 + 18 + 21)
    assert ops.full_backward_bytes(5, 7, 2, 6, 3) == 4 * (5 * 11 + 7 + 4 + 24 + 7 * 11)
    assert ops.bound_s(67e12, 0) == 1.0
    assert ops.bound_s(0, 3.35e12) == 1.0


def test_ssim_flops():
    # 8 filtered maps a channel (5 forward, 3 backward), 2 passes of 11 MACs
    assert ops.ssim_flops(1, 3) == 8 * 3 * 2 * 11 * 2 == 1056
    assert ops.ssim_flops(1280 * 720, 3) == 973_209_600


def _one_splat(op):
    """One isotropic Gaussian of world sigma 2 at depth 2 on the optical
    axis of a 32x32 camera with focal 2: one pixel a unit there, so its
    screen covariance is 4 + 0.3 (the low-pass) on the diagonal."""
    means = torch.tensor([[0.0, 0.0, 2.0]])
    quats = torch.tensor([[1.0, 0.0, 0.0, 0.0]])
    scales = torch.full((1, 3), 2.0)
    K = torch.tensor([[2.0, 0.0, 16.0], [0.0, 2.0, 16.0], [0.0, 0.0, 1.0]])
    return means, quats, scales, torch.tensor([op]), torch.eye(4), K


def test_pair_counts_one_splat_by_hand():
    means, quats, scales, opac, vm, K = _one_splat(0.9)
    got = pairs.count(means, quats, scales, opac, vm, K, 32, 32)
    # by hand: sigma = 0.5 d^2 / 4.3 at the pixel centres; a pixel blends
    # where 0.9 exp(-sigma) >= 1/255 and is near where sigma <= ln(229.5)
    # + 0.01; nothing ends a pixel (one splat), so every pixel walks it
    blended = near = 0
    for y in range(32):
        for x in range(32):
            d2 = (x + 0.5 - 16.0) ** 2 + (y + 0.5 - 16.0) ** 2
            sig = 0.5 * d2 / 4.3
            blended += 0.9 * math.exp(-sig) >= 1 / 255
            near += sig <= math.log(255 * 0.9) + 0.01
    assert got["walked"] == 32 * 32
    assert got["blended"] == blended
    assert got["near"] == near
    assert got["instances"] == 1 and got["visible"] == 1 and got["tiles"] == 1
