"""Container integration via CDI for GPUs (counterpart of tpu_dra.cdi)."""
