"""Env-backed CLI flag system + logging configuration (counterpart of
tpu_dra/infra/flags.py, copied as it is).

Every flag has an env-var mirror (12-factor: Helm values -> container
env -> flags). Built on argparse; each Flag declares its env mirror and
the parsed config can be dumped at startup.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from tpu_dra_torch.infra import featuregates


@dataclass
class Flag:
    name: str                 # e.g. "node-name"
    env: str                  # e.g. "NODE_NAME"
    default: Any = None
    type: Callable = str
    help: str = ""
    required: bool = False

    @property
    def attr(self) -> str:
        return self.name.replace("-", "_")


class FlagSet:
    def __init__(self, prog: str, flags: List[Flag]):
        self._flags = flags
        self._parser = argparse.ArgumentParser(prog=prog)
        for f in flags:
            env_val = os.environ.get(f.env)
            default = f.default
            if env_val is not None:
                default = self._coerce(f, env_val)
            # argparse's type=bool would turn any non-empty string (including
            # "false") into True; route bools through the same str coercion
            # the env mirror uses.
            argtype = (lambda raw, _f=f: self._coerce(_f, raw)) if f.type is bool else f.type
            self._parser.add_argument(
                f"--{f.name}", dest=f.attr, default=default, type=argtype,
                help=f"{f.help} [env: {f.env}]")

    @staticmethod
    def _coerce(f: Flag, raw: str) -> Any:
        if f.type is bool:
            return raw.strip().lower() in ("1", "true", "yes", "on")
        return f.type(raw)

    def parse(self, argv: Optional[List[str]] = None) -> argparse.Namespace:
        ns = self._parser.parse_args(argv)
        for f in self._flags:
            if f.required and getattr(ns, f.attr) in (None, ""):
                self._parser.error(
                    f"--{f.name} (or env {f.env}) is required")
        return ns

    def dump_config(self, ns: argparse.Namespace, log: logging.Logger) -> None:
        """Startup-config dump (pkg/flags LogStartupConfig analog)."""
        cfg = {f.name: getattr(ns, f.attr) for f in self._flags}
        cfg["feature-gates"] = featuregates.Features.as_string()
        log.info("startup configuration: %s", json.dumps(cfg, default=str, sort_keys=True))


def feature_gate_flag() -> Flag:
    return Flag(name="feature-gates", env="FEATURE_GATES", default="",
                help="comma-separated Name=true|false feature gate assignments")


def apply_feature_gates(ns: argparse.Namespace) -> None:
    raw = getattr(ns, "feature_gates", "")
    if raw:
        featuregates.Features.set_from_string(raw)


_JSON_LOGGING = False


class _JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        doc = {"ts": self.formatTime(record), "level": record.levelname.lower(),
               "logger": record.name, "msg": record.getMessage()}
        if record.exc_info:
            doc["exc"] = self.formatException(record.exc_info)
        return json.dumps(doc)


def setup_logging(verbosity: int = 0, json_format: bool = False) -> logging.Logger:
    """klog-style: -v levels map to logging levels; optional JSON output
    (pkg/flags/logging.go supports a JSON logging config)."""
    level = logging.DEBUG if verbosity >= 4 else logging.INFO
    handler = logging.StreamHandler(sys.stderr)
    if json_format:
        handler.setFormatter(_JsonFormatter())
    else:
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname).1s %(name)s] %(message)s"))
    root = logging.getLogger("tpu_dra_torch")
    root.handlers[:] = [handler]
    root.setLevel(level)
    return root


def logging_flags() -> List[Flag]:
    return [
        Flag(name="v", env="LOG_VERBOSITY", default=0, type=int,
             help="log verbosity (klog-style numeric level)"),
        Flag(name="log-json", env="LOG_JSON", default=False, type=bool,
             help="emit JSON-formatted logs"),
    ]
