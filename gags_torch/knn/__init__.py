from gags_torch.knn.knn import knn_sq_dists, mean_knn_sq_dist

__all__ = ["mean_knn_sq_dist", "knn_sq_dists"]
