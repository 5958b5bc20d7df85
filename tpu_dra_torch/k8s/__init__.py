"""Kubernetes client machinery (counterpart of tpu_dra.k8s): a REST
client over stdlib HTTP with its retrying wrapper, an in-memory fake API
server with watch streams (``fakeserver`` serves it over HTTP), and the
list+watch informer the controllers and the sim scheduler run on."""

from tpu_dra_torch.k8s.client import (  # noqa: F401
    AlreadyExistsError, ApiClient, ApiError, ConflictError, GVR,
    HttpApiClient, NotFoundError, RetryingApiClient, label_selector_matches,
)
from tpu_dra_torch.k8s.fake import FakeCluster  # noqa: F401
from tpu_dra_torch.k8s.informer import Informer  # noqa: F401
from tpu_dra_torch.k8s.resources import (  # noqa: F401
    COMPUTEDOMAINS, DAEMONSETS, DEPLOYMENTS, DEVICECLASSES, LEASES, NODES,
    PODS, RESOURCECLAIMS, RESOURCECLAIMTEMPLATES, RESOURCESLICES,
    new_object_meta,
)
