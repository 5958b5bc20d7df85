"""Proto3 wire codec for the kubelet's DRA v1 and plugin-registration
messages (counterpart of tpu_dra/kubeletplugin/gen/dra_v1_pb2.py and
pluginregistration_pb2.py, whose schemas are
tpu_dra/kubeletplugin/protos/*.proto).

Hand-written over varints, so neither transport of the
plugin needs ``google.protobuf``: the framed socket carries these bytes
as they are, and the gRPC socket takes ``SerializeToString`` and
``FromString`` as its (de)serializers. Each message is a dataclass whose
``FIELDS`` give its proto field numbers and kinds, in field-number order:

- a message serializes its set fields in that order (proto3 leaves out a
  field at its default), so its bytes equal protobuf's;
- a ``map<string, Message>`` serializes one entry per key, in insertion
  order, each with its key and its value, as protobuf writes them (its
  own order of entries is its hash order);
- parsing skips fields it does not know, concatenates repeated fields
  and lets a later map entry for the same key win, as protobuf's does.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import ClassVar, Dict, List, Tuple

# Wire types.
VARINT = 0
FIXED64 = 1
LEN = 2
FIXED32 = 5

# Field kinds a schema entry names.
STRING = "string"
BOOL = "bool"
REPEATED_STRING = "repeated string"
REPEATED_MESSAGE = "repeated message"
MAP_MESSAGE = "map<string, message>"


class WireError(ValueError):
    """Bytes that are not a well-formed encoding of the message."""


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        byte = n & 0x7F
        n >>= 7
        if n:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        if pos >= len(data):
            raise WireError("truncated varint")
        byte = data[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, pos
        shift += 7
        if shift >= 64:
            raise WireError("varint longer than 10 bytes")


def _len_field(number: int, payload: bytes) -> bytes:
    return _varint(number << 3 | LEN) + _varint(len(payload)) + payload


def _fields(data: bytes):
    """(field number, wire type, value) of every field in `data`: an int
    for a varint, bytes for a length-delimited field; fixed-width fields
    are read and dropped."""
    pos = 0
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        number, wire_type = tag >> 3, tag & 7
        if number == 0:
            raise WireError("field number 0")
        if wire_type == VARINT:
            value, pos = _read_varint(data, pos)
        elif wire_type == LEN:
            n, pos = _read_varint(data, pos)
            if pos + n > len(data):
                raise WireError("truncated length-delimited field")
            value, pos = data[pos:pos + n], pos + n
        elif wire_type in (FIXED64, FIXED32):
            pos += 8 if wire_type == FIXED64 else 4
            if pos > len(data):
                raise WireError("truncated fixed-width field")
            continue
        else:
            raise WireError(f"unsupported wire type {wire_type}")
        yield number, wire_type, value


def _text(raw: bytes) -> str:
    try:
        return raw.decode("utf-8")
    except UnicodeDecodeError as e:
        raise WireError(f"string field is not UTF-8: {e}") from e


class Message:
    """Base of the messages below. ``FIELDS``: (number, attribute, kind,
    message class or None) in field-number order."""

    FIELDS: ClassVar[Tuple[tuple, ...]] = ()

    def SerializeToString(self) -> bytes:  # noqa: N802 — protobuf's name
        out = bytearray()
        for number, attr, kind, cls in self.FIELDS:
            value = getattr(self, attr)
            if kind == STRING:
                if value:
                    out += _len_field(number, value.encode("utf-8"))
            elif kind == BOOL:
                if value:
                    out += _varint(number << 3 | VARINT) + b"\x01"
            elif kind == REPEATED_STRING:
                for item in value:
                    out += _len_field(number, item.encode("utf-8"))
            elif kind == REPEATED_MESSAGE:
                for item in value:
                    out += _len_field(number, item.SerializeToString())
            else:  # MAP_MESSAGE
                for key, item in value.items():
                    entry = (_len_field(1, key.encode("utf-8"))
                             + _len_field(2, item.SerializeToString()))
                    out += _len_field(number, entry)
        return bytes(out)

    @classmethod
    def FromString(cls, data: bytes):  # noqa: N802 — protobuf's name
        by_number = {f[0]: f for f in cls.FIELDS}
        msg = cls()
        for number, wire_type, value in _fields(bytes(data)):
            spec = by_number.get(number)
            if spec is None:
                continue   # unknown field: skipped, as protobuf does
            _, attr, kind, sub = spec
            want = VARINT if kind == BOOL else LEN
            if wire_type != want:
                raise WireError(f"{cls.__name__}.{attr}: wire type "
                                f"{wire_type}, want {want}")
            if kind == STRING:
                setattr(msg, attr, _text(value))
            elif kind == BOOL:
                setattr(msg, attr, bool(value))
            elif kind == REPEATED_STRING:
                getattr(msg, attr).append(_text(value))
            elif kind == REPEATED_MESSAGE:
                getattr(msg, attr).append(sub.FromString(value))
            else:  # MAP_MESSAGE
                key, item = "", sub()
                for n, wt, v in _fields(value):
                    if n == 1 and wt == LEN:
                        key = _text(v)
                    elif n == 2 and wt == LEN:
                        item = sub.FromString(v)
                getattr(msg, attr)[key] = item
        return msg

    def to_dict(self) -> Dict:
        """The message as plain values, for comparisons."""
        out = {}
        for f in fields(self):
            value = getattr(self, f.name)
            if isinstance(value, list):
                value = [v.to_dict() if isinstance(v, Message) else v
                         for v in value]
            elif isinstance(value, dict):
                value = {k: v.to_dict() for k, v in value.items()}
            out[f.name] = value
        return out


# ---------------------------------------------------------------------------
# k8s.io.kubelet.pkg.apis.dra.v1 (dra_v1.proto)
# ---------------------------------------------------------------------------

@dataclass
class Claim(Message):
    namespace: str = ""
    uid: str = ""
    name: str = ""
    FIELDS: ClassVar = ((1, "namespace", STRING, None),
                        (2, "uid", STRING, None),
                        (3, "name", STRING, None))


@dataclass
class Device(Message):
    request_names: List[str] = field(default_factory=list)
    pool_name: str = ""
    device_name: str = ""
    cdi_device_ids: List[str] = field(default_factory=list)
    FIELDS: ClassVar = ((1, "request_names", REPEATED_STRING, None),
                        (2, "pool_name", STRING, None),
                        (3, "device_name", STRING, None),
                        (4, "cdi_device_ids", REPEATED_STRING, None))


@dataclass
class NodePrepareResourcesRequest(Message):
    claims: List[Claim] = field(default_factory=list)
    FIELDS: ClassVar = ((1, "claims", REPEATED_MESSAGE, Claim),)


@dataclass
class NodePrepareResourceResponse(Message):
    devices: List[Device] = field(default_factory=list)
    error: str = ""
    FIELDS: ClassVar = ((1, "devices", REPEATED_MESSAGE, Device),
                        (2, "error", STRING, None))


@dataclass
class NodePrepareResourcesResponse(Message):
    claims: Dict[str, NodePrepareResourceResponse] = field(
        default_factory=dict)
    FIELDS: ClassVar = ((1, "claims", MAP_MESSAGE,
                         NodePrepareResourceResponse),)


@dataclass
class NodeUnprepareResourcesRequest(Message):
    claims: List[Claim] = field(default_factory=list)
    FIELDS: ClassVar = ((1, "claims", REPEATED_MESSAGE, Claim),)


@dataclass
class NodeUnprepareResourceResponse(Message):
    error: str = ""
    FIELDS: ClassVar = ((1, "error", STRING, None),)


@dataclass
class NodeUnprepareResourcesResponse(Message):
    claims: Dict[str, NodeUnprepareResourceResponse] = field(
        default_factory=dict)
    FIELDS: ClassVar = ((1, "claims", MAP_MESSAGE,
                         NodeUnprepareResourceResponse),)


# ---------------------------------------------------------------------------
# pluginregistration (pluginregistration.proto)
# ---------------------------------------------------------------------------

@dataclass
class PluginInfo(Message):
    type: str = ""
    name: str = ""
    endpoint: str = ""
    supported_versions: List[str] = field(default_factory=list)
    FIELDS: ClassVar = ((1, "type", STRING, None),
                        (2, "name", STRING, None),
                        (3, "endpoint", STRING, None),
                        (4, "supported_versions", REPEATED_STRING, None))


@dataclass
class RegistrationStatus(Message):
    plugin_registered: bool = False
    error: str = ""
    FIELDS: ClassVar = ((1, "plugin_registered", BOOL, None),
                        (2, "error", STRING, None))


@dataclass
class RegistrationStatusResponse(Message):
    pass


@dataclass
class InfoRequest(Message):
    pass
