"""API group ``resource.gpu.dev/v1beta1`` of the GPU driver (counterpart
of tpu_dra.api): opaque per-claim config kinds, sharing types, the
compute-domain kinds (the ComputeDomain CRD, its manifest in ``crd``)
and strict/non-strict decoders."""
