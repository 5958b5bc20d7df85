"""Version info (counterpart of tpu_dra/version.py; the reference driver
stamps its version with Go ldflags)."""

import os
import subprocess

__version__ = "0.1.0"


def git_commit() -> str:
    """The checkout's short commit hash, read at call time (there is no
    link step to stamp it), or "unknown" outside a git checkout."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=5,
        )
        if out.returncode == 0:
            return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return "unknown"
