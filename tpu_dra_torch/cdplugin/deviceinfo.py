"""Synthetic ComputeDomain devices (counterpart of
tpu_dra/cdplugin/deviceinfo.py).

The CD plugin advertises devices that are not hardware: up to 2048
per-node ``channel`` devices (the claimable handle that gates workload
readiness) and one ``daemon`` device (claimed by the domain-daemon pod
itself). Only channel 0 and the daemon are published in the
ResourceSlice — channels are a cluster-granted resource, not per-node
inventory.

A channel carries no device node here: preparing it injects the
domain's rendezvous *env*; the device exists so DRA scheduling and
readiness gating work as they do for NVIDIA's IMEX channels.
"""

from __future__ import annotations

from typing import Dict, List

CHANNEL_COUNT = 2048  # NVIDIA's IMEX channel count per node

DEVICE_TYPE_CHANNEL = "channel"
DEVICE_TYPE_DAEMON = "daemon"


def channel_device_name(channel_id: int) -> str:
    return f"channel-{channel_id}"


DAEMON_DEVICE_NAME = "daemon"


def published_devices(clique_id: str) -> List[Dict]:
    """resourceapi devices for the ResourceSlice: channel-0 + daemon."""
    return [
        {
            "name": channel_device_name(0),
            "attributes": {
                "type": {"string": DEVICE_TYPE_CHANNEL},
                "id": {"int": 0},
                "cliqueID": {"string": clique_id},
            },
            "capacity": {},
        },
        {
            "name": DAEMON_DEVICE_NAME,
            "attributes": {
                "type": {"string": DEVICE_TYPE_DAEMON},
                "cliqueID": {"string": clique_id},
            },
            "capacity": {},
        },
    ]


def parse_channel_id(device_name: str) -> int:
    """channel-N -> N; raises ValueError for non-channel devices."""
    if not device_name.startswith("channel-"):
        raise ValueError(f"not a channel device: {device_name!r}")
    return int(device_name.split("-", 1)[1])
