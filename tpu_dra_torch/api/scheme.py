"""Scheme + strict/non-strict decoders for the resource.gpu.dev group
(counterpart of tpu_dra/api/scheme.py).

The StrictDecoder rejects unknown fields and is used for user-supplied
opaque configs (NodePrepareResources); the NonstrictDecoder drops unknown
fields and is used for checkpoint round-trips, so a downgraded driver can
still read checkpoints written by a newer version.
"""

from __future__ import annotations

import json
from typing import Dict, Type

from tpu_dra_torch.api import types as t


class DecodeError(ValueError):
    pass


class Scheme:
    """Registry of (apiVersion, kind) -> type, with decode helpers."""

    def __init__(self):
        self._kinds: Dict[tuple, Type] = {}

    def add_known_type(self, api_version: str, kind: str, cls: Type):
        self._kinds[(api_version, kind)] = cls

    def decode(self, data, strict: bool):
        """Decode a JSON document (str/bytes/dict) into a registered type."""
        if isinstance(data, (str, bytes)):
            try:
                data = json.loads(data)
            except json.JSONDecodeError as e:
                raise DecodeError(f"invalid JSON: {e}") from e
        if not isinstance(data, dict):
            raise DecodeError(f"expected JSON object, got {type(data).__name__}")
        api_version = data.get("apiVersion", "")
        kind = data.get("kind", "")
        cls = self._kinds.get((api_version, kind))
        if cls is None:
            raise DecodeError(
                f"no kind {kind!r} registered for version {api_version!r}")
        try:
            return cls.from_dict(data, strict=strict)
        except t.ValidationError as e:
            raise DecodeError(str(e)) from e


_scheme = Scheme()
for _cls in (t.GpuConfig, t.MigDeviceConfig, t.PassthroughConfig):
    _scheme.add_known_type(t.API_VERSION, _cls.KIND, _cls)


class _Decoder:
    def __init__(self, scheme: Scheme, strict: bool):
        self._scheme = scheme
        self._strict = strict

    def decode(self, data):
        return self._scheme.decode(data, strict=self._strict)


StrictDecoder = _Decoder(_scheme, strict=True)
NonstrictDecoder = _Decoder(_scheme, strict=False)
