from gags_torch.scene.gaussian_data import GaussianScene, scene_from_arrays

__all__ = ["GaussianScene", "scene_from_arrays"]
