"""Plain PyTorch references: float32, no kernel of the program, nothing
of ``bluefog_tpu_torch`` imported."""
