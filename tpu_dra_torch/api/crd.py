"""ComputeDomain CRD manifest (counterpart of tpu_dra/api/crd.py): the
schema of the resource.gpu.dev ComputeDomain, with the CEL rule that
makes its spec immutable and the status subresource.

Generated as a dict, so a deploy tool renders it to YAML and tests can
introspect the schema.
"""

from __future__ import annotations

from typing import Dict

from tpu_dra_torch.api.types import GROUP, VERSION


def compute_domain_crd() -> Dict:
    node_props = {
        "name": {"type": "string"},
        "ipAddress": {"type": "string"},
        "cliqueID": {"type": "string"},
        "index": {"type": "integer"},
        "status": {"type": "string", "enum": ["Ready", "NotReady"]},
    }
    spec_schema = {
        "type": "object",
        # Spec is immutable after creation.
        "x-kubernetes-validations": [{
            "rule": "self == oldSelf",
            "message": "ComputeDomain spec is immutable",
        }],
        "properties": {
            "numNodes": {
                "type": "integer",
                "minimum": 0,
                "description": "Deprecated: drives only the global Ready "
                               "status; daemons start eagerly and workloads "
                               "release on local readiness.",
            },
            "channel": {
                "type": "object",
                "required": ["resourceClaimTemplate"],
                "properties": {
                    "resourceClaimTemplate": {
                        "type": "object",
                        "required": ["name"],
                        "properties": {"name": {"type": "string",
                                                "minLength": 1}},
                    },
                    "allocationMode": {
                        "type": "string",
                        "enum": ["Single", "All"],
                        "default": "Single",
                    },
                },
            },
        },
        "required": ["channel"],
    }
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": f"computedomains.{GROUP}"},
        "spec": {
            "group": GROUP,
            "scope": "Namespaced",
            "names": {
                "plural": "computedomains",
                "singular": "computedomain",
                "kind": "ComputeDomain",
                "shortNames": ["cd"],
            },
            "versions": [{
                "name": VERSION,
                "served": True,
                "storage": True,
                "subresources": {"status": {}},
                "schema": {"openAPIV3Schema": {
                    "type": "object",
                    "properties": {
                        "spec": spec_schema,
                        "status": {
                            "type": "object",
                            "properties": {
                                "status": {"type": "string",
                                           "enum": ["Ready", "NotReady"]},
                                "nodes": {
                                    "type": "array",
                                    "items": {"type": "object",
                                              "properties": node_props},
                                },
                                # NVLink placement summary the
                                # controller stamps on multi-node
                                # domains under the
                                # TopologyAwareScheduling gate (without
                                # it a structural schema would prune the
                                # field).
                                "topology": {
                                    "type": "object",
                                    "properties": {
                                        "cliques": {"type": "integer"},
                                        "cliqueAligned": {"type": "boolean"},
                                    },
                                },
                            },
                        },
                    },
                }},
                "additionalPrinterColumns": [
                    {"name": "Status", "type": "string",
                     "jsonPath": ".status.status"},
                    {"name": "Nodes", "type": "integer",
                     "jsonPath": ".spec.numNodes"},
                    {"name": "Age", "type": "date",
                     "jsonPath": ".metadata.creationTimestamp"},
                ],
            }],
        },
    }
