"""Operations and bytes of the work the timed path must do, from its
shapes and the pair counts of its own inputs: the yardstick of every
share of a peak or a roofline this benchmark reports.

Peaks are the published H100 SXM ones: 67 TFLOP/s in float32 outside the
tensor cores (the configurations compute in float32 with TF32 off) and
3.35 TB/s of HBM3. A kernel's bound is the larger of its operations at
the float32 rate and its bytes at the memory rate, each input read once
and each output written once; counts of data-dependent work are what
these inputs need, so a bound never exceeds the least time the work can
take.
"""

from __future__ import annotations

PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
F32 = 4


def blend_ops(near: int, blended: int, per_blended: int, walks: int = 1) -> int:
    """A blend's operations: per walk, 16 on each pair near enough to its
    splat that no exact test short of alpha excludes it (sigma <= ln(255
    op) + 0.01), and `per_blended` on each blended pair. Frozen from the
    port's chip smoke run (`blend_ops`), whose bounds PERF.md tabulates."""
    return walks * 16 * near + per_blended * blended


def forward_blend_ops(near: int, blended: int, channels: int) -> int:
    """K1 / K5: the alpha, the weight and C multiply-adds a blended pair."""
    return blend_ops(near, blended, 4 + 2 * channels)


def colour_backward_ops(near: int, blended: int, channels: int) -> int:
    """K2: the walk again and C multiply-adds a blended pair."""
    return blend_ops(near, blended, 2 * channels)


def full_backward_ops(near: int, blended: int, channels: int) -> int:
    """K8: two walks; per blended pair 5 + 2C on the first and ~40 + 4C on
    the second (the prefix, the chain rule, C + 6 products and sums)."""
    return blend_ops(near, blended, 45 + 6 * channels, walks=2)


def forward_blend_bytes(visible: int, instances: int, tiles: int, pixels: int,
                        channels: int) -> int:
    """K1 / K5: geometry rows (8 floats) and colour rows of the Gaussians
    seen, an id a instance, a start and a count a tile, the background,
    the image and its alpha written."""
    return F32 * (visible * (8 + channels) + instances + 2 * tiles + channels
                  + pixels * (channels + 1))


def colour_backward_bytes(visible: int, instances: int, tiles: int, pixels: int,
                          channels: int) -> int:
    """K2: geometry rows, ids, ranges, the image cotangent read; a colour
    gradient row an instance written."""
    return F32 * (visible * 8 + instances + 2 * tiles + pixels * channels
                  + instances * channels)


def full_backward_bytes(visible: int, instances: int, tiles: int, pixels: int,
                        channels: int) -> int:
    """K8: geometry and colour rows, ids, ranges, the image and alpha
    cotangents read; a colour row and a geometry row (8) an instance
    written."""
    return F32 * (visible * (8 + channels) + instances + 2 * tiles + pixels * (channels + 1)
                  + instances * (channels + 8))


def bound_s(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES)


def mlp_macs(widths) -> int:
    return sum(a * b for a, b in widths)


def decoder_train_flops(pixels: int, feature_widths, scale_widths) -> int:
    """Both GAD decoders' matrix products, forward and backward, at
    `pixels` pixels: forward, the weight gradients, and the input
    gradients of every layer but the scale decoder's first (its input is
    the detached feature map). Bias adds and activations are left out."""
    f, s = mlp_macs(feature_widths), mlp_macs(scale_widths)
    a0, b0 = scale_widths[0]
    return 2 * pixels * (3 * f + 3 * s - a0 * b0)


def ssim_flops(pixels: int, channels: int = 3, taps: int = 11) -> int:
    """SSIM's separable Gaussian filtering, forward and backward: five
    filtered maps a channel forward (mu1, mu2, E[x^2], E[y^2], E[xy]) and
    the three that depend on the rendered image backward, each two passes
    of `taps` multiply-adds a pixel."""
    return (5 + 3) * channels * 2 * taps * 2 * pixels
