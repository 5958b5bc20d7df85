"""Stable peer naming: /etc/hosts block + nodes.cfg rendering
(counterpart of tpu_dra/cddaemon/dnsnames.py).

In the default DNS-names mode the rendezvous config lists *stable*
per-clique names (``gpu-cd-daemon-%04d``) so the native daemon's config
never churns when IPs change; the name->IP mapping lives in a managed
/etc/hosts block that is rewritten on membership updates, after which
the daemon gets SIGUSR1 to re-resolve.
"""

from __future__ import annotations

import os
import tempfile
from typing import List, Tuple

STABLE_NAME_FMT = "gpu-cd-daemon-{:04d}"
BLOCK_BEGIN = "# BEGIN gpu-dra compute-domain peers\n"
BLOCK_END = "# END gpu-dra compute-domain peers\n"


def stable_name(index: int) -> str:
    return STABLE_NAME_FMT.format(index)


def render_hosts_block(nodes: List[Tuple[int, str]]) -> str:
    """nodes: [(index, ip)] within this clique group."""
    lines = [BLOCK_BEGIN]
    for index, ip in sorted(nodes):
        lines.append(f"{ip}\t{stable_name(index)}\n")
    lines.append(BLOCK_END)
    return "".join(lines)


def update_hosts_file(path: str, nodes: List[Tuple[int, str]]) -> bool:
    """Replace (or append) the managed block, writing IN PLACE — /etc/hosts
    is a kubelet bind mount in pods and rename-over-mount fails EBUSY, so a
    torn read is possible but heals on the next resolve. Returns True if
    the content changed."""
    try:
        with open(path) as f:
            content = f.read()
    except FileNotFoundError:
        content = ""
    begin = content.find(BLOCK_BEGIN)
    end = content.find(BLOCK_END)
    block = render_hosts_block(nodes)
    if begin >= 0 and end >= 0:
        new = content[:begin] + block + content[end + len(BLOCK_END):]
    else:
        sep = "" if content.endswith("\n") or not content else "\n"
        new = content + sep + block
    if new == content:
        return False
    # In-place write, NOT rename: in a pod /etc/hosts is a kubelet bind
    # mount and rename-over-mount fails with EBUSY.
    with open(path, "w") as f:
        f.write(new)
    return True


def write_nodes_config(path: str, names_or_ips: List[str], port: int) -> bool:
    """Write the native daemon's peer list (one host:port per line).
    Returns True if content changed."""
    body = "".join(f"{n}:{port}\n" for n in names_or_ips)
    try:
        with open(path) as f:
            if f.read() == body:
                return False
    except FileNotFoundError:
        pass
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               prefix=".nodes-")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(body)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise
    return True
