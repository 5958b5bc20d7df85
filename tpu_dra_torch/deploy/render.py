"""Render the chart and the demo specs to YAML (counterpart of
tpu_dra/deploy/render.py and hack/render-chart.py; needs PyYAML).

    python -m tpu_dra_torch.deploy.render [--set key.path=value ...]
        [--values FILE] [--namespace NS] [--release NAME]
        [-o OUT_DIR] [--demo-dir DIR]

Without ``-o`` the chart's documents go to stdout as one multi-document
YAML stream (``| kubectl apply -f -``); with ``-o`` to
``OUT_DIR/gpu-dra-driver.yaml``. ``--demo-dir`` also writes each demo of
``demos.all_demos()`` to ``DIR/<name>.yaml``. ``--set`` is repeatable;
``true``/``false`` and integers are coerced, as helm does. A value the
chart's validation refuses exits 1 with the template's message.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List, Optional

from tpu_dra_torch.deploy import demos, manifests
from tpu_dra_torch.deploy.helmlite import TemplateError


def _coerce(v: str):
    if v in ("true", "false"):
        return v == "true"
    try:
        return int(v)
    except ValueError:
        return v


def set_path(values: Dict, dotted: str, raw: str) -> None:
    """values[a][b][c] = raw coerced, for dotted "a.b.c"."""
    keys = dotted.split(".")
    for k in keys[:-1]:
        values = values.setdefault(k, {})
    values[keys[-1]] = _coerce(raw)


def overrides(sets: List[str], values_file: Optional[str] = None) -> Dict:
    """The values a render takes: the --values file, then each --set
    "key.path=value" over it. Raises ValueError on a --set without =."""
    import yaml

    out: Dict = {}
    if values_file:
        with open(values_file) as f:
            out = yaml.safe_load(f) or {}
    for s in sets:
        key, eq, raw = s.partition("=")
        if not eq or not key:
            raise ValueError(f"bad --set {s!r} (need key.path=value)")
        set_path(out, key, raw)
    return out


def write_demos(demo_dir: str) -> List[str]:
    import yaml

    os.makedirs(demo_dir, exist_ok=True)
    written = []
    for name, spec_docs in demos.all_demos().items():
        p = os.path.join(demo_dir, f"{name}.yaml")
        with open(p, "w") as f:
            yaml.safe_dump_all(spec_docs, f, sort_keys=False)
        written.append(p)
    return written


def main(argv=None) -> int:
    import yaml

    ap = argparse.ArgumentParser(prog="python -m tpu_dra_torch.deploy.render")
    ap.add_argument("--set", action="append", default=[], dest="sets",
                    metavar="key.path=value")
    ap.add_argument("--values", "-f", default=None,
                    help="a values YAML file, merged over values.yaml")
    ap.add_argument("--namespace", "-n", default=manifests.DEFAULT_NAMESPACE)
    ap.add_argument("--release", default=manifests.APP)
    ap.add_argument("-o", "--out-dir", default=None,
                    help="write OUT_DIR/gpu-dra-driver.yaml (default: "
                         "stdout)")
    ap.add_argument("--demo-dir", default=None,
                    help="also write every demo spec to DIR/<name>.yaml")
    args = ap.parse_args(argv)
    try:
        values = overrides(args.sets, args.values)
        docs = manifests.render(values, args.namespace, args.release)
    except (TemplateError, ValueError) as e:
        print(f"render error: {e}", file=sys.stderr)
        return 1
    text = yaml.safe_dump_all(docs, sort_keys=False)
    if args.out_dir is None:
        sys.stdout.write(text)
    else:
        os.makedirs(args.out_dir, exist_ok=True)
        path = os.path.join(args.out_dir, f"{manifests.APP}.yaml")
        with open(path, "w") as f:
            f.write(text)
        print(path)
    if args.demo_dir:
        for path in write_demos(args.demo_dir):
            print(path, file=sys.stderr if args.out_dir is None
                  else sys.stdout)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
