"""Projection, binning, blend kernels and the inference rasterizer.

Submodules are imported directly (``gags_torch.splat.rasterizer`` ...);
the kernels build only when first launched on a CUDA tensor.
"""
