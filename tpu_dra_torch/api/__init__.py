"""API group ``resource.gpu.dev/v1beta1`` of the GPU driver (counterpart
of tpu_dra.api): opaque per-claim config kinds, sharing types and
strict/non-strict decoders."""
