"""Validating admission webhook (counterpart of tpu_dra/webhook).

Rejects ResourceClaims/ResourceClaimTemplates carrying malformed opaque
device configs owned by this driver *at admission time*, instead of at
node-side prepare where the pod is already scheduled.
"""

from tpu_dra_torch.webhook.server import AdmissionHandler, WebhookServer  # noqa: F401
