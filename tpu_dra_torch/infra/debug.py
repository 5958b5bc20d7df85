"""Debug signal handlers (counterpart of tpu_dra/infra/debug.py).

SIGUSR2 dumps every thread's stack to ``thread-stacks.dump`` in the
process's temporary directory (``tempfile.gettempdir()``, so ``TMPDIR``
places it); faulthandler covers hard crashes.
"""

from __future__ import annotations

import faulthandler
import os
import signal
import sys
import tempfile
import threading
import traceback
from typing import Optional

STACK_DUMP_NAME = "thread-stacks.dump"


def stack_dump_path() -> str:
    return os.path.join(tempfile.gettempdir(), STACK_DUMP_NAME)


def dump_stacks(path: Optional[str] = None) -> str:
    path = path or stack_dump_path()
    frames = sys._current_frames()
    names = {t.ident: t.name for t in threading.enumerate()}
    with open(path, "w") as f:
        for ident, frame in frames.items():
            f.write(f"--- thread {names.get(ident, '?')} ({ident}) ---\n")
            traceback.print_stack(frame, file=f)
            f.write("\n")
    return path


def start_debug_signal_handlers(path: Optional[str] = None) -> None:
    """Install SIGUSR2 -> stack dump. Also arms faulthandler for hard
    crashes. Only callable from the main thread (signal API restriction)."""
    faulthandler.enable()
    path = path or stack_dump_path()

    def _handler(signum, frame):
        try:
            dump_stacks(path)
        except Exception as e:  # noqa: BLE001
            # Signal-handler context: logging machinery may deadlock;
            # a raw stderr line beats a dump that silently never happened.
            sys.stderr.write(f"stack dump to {path} failed: {e}\n")

    signal.signal(signal.SIGUSR2, _handler)
