from gags_torch.query.grounding import (
    decode_features_chunked,
    decode_map_rows,
    point_relevancy,
    select_gaussians,
    smooth_point_mask,
)
from gags_torch.query.relevancy import (
    DEFAULT_NEGATIVES,
    box_filter_reflect101,
    heatmap_to_mask,
    iou,
    majority_smooth,
    max_across_levels,
    relevancy,
)

__all__ = [
    "decode_features_chunked",
    "decode_map_rows",
    "point_relevancy",
    "select_gaussians",
    "smooth_point_mask",
    "DEFAULT_NEGATIVES",
    "box_filter_reflect101",
    "heatmap_to_mask",
    "iou",
    "majority_smooth",
    "max_across_levels",
    "relevancy",
]
