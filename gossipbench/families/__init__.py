"""Builders of the program's models, one module per model family, named
by a configuration's ``family``."""

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
