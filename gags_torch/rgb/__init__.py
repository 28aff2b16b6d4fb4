"""RGB 3DGS pretraining (port of gags_tpu.rgb)."""
