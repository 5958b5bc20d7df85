"""Device information for the port (counterpart of tpu_dra.native)."""
