"""Plain PyTorch references of each model family. Nothing here imports
``tpu_dra_torch``, ``tpu_dra`` or JAX."""
