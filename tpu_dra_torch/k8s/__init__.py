"""Kubernetes client machinery (counterpart of tpu_dra.k8s): a REST
client over stdlib HTTP, its retrying wrapper, and an in-memory fake API
server for tests and the card's smoke run. No informer yet."""

from tpu_dra_torch.k8s.client import (  # noqa: F401
    AlreadyExistsError, ApiClient, ApiError, ConflictError, GVR,
    HttpApiClient, NotFoundError, RetryingApiClient, label_selector_matches,
)
from tpu_dra_torch.k8s.fake import FakeCluster  # noqa: F401
from tpu_dra_torch.k8s.resources import (  # noqa: F401
    NODES, RESOURCECLAIMS, RESOURCESLICES, new_object_meta,
)
