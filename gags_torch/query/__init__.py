from gags_torch.query.grounding import decode_map_rows
from gags_torch.query.relevancy import (
    box_filter_reflect101,
    heatmap_to_mask,
    majority_smooth,
    max_across_levels,
    relevancy,
)

__all__ = [
    "decode_map_rows",
    "box_filter_reflect101",
    "heatmap_to_mask",
    "majority_smooth",
    "max_across_levels",
    "relevancy",
]
