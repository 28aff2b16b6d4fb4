from gags_torch.knn.knn import knn_sq_dists, knn_with_indices, mean_knn_sq_dist

__all__ = ["mean_knn_sq_dist", "knn_sq_dists", "knn_with_indices"]
