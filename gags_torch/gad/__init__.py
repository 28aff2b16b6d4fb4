"""GAD feature distillation: losses, supervision, the train step, the data
loader and checkpoints (port of gags_tpu.gad)."""
