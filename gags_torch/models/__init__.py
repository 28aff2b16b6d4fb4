from gags_torch.models.decoders import FeatureDecoder, ScaleDecoder

__all__ = ["FeatureDecoder", "ScaleDecoder"]
