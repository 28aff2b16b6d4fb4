"""GAS, stage 2 of the pipeline (port of gags_tpu.gas): depth samples,
depth-adaptive SAM prompts, the four-granularity mask generator and the
mask post-processing that feeds CLIP."""

from gags_torch.gas import depth_sampler, masks, prompts

__all__ = ["prompts", "masks", "depth_sampler"]
