"""Write the chart's ComputeDomain CRD from the API module (the port's
counterpart of hack/gen-chart-crd.py, the controller-gen analog):

    python -m tpu_dra_torch.deploy.gencrd [--out PATH]

The default PATH is the chart's own crds/ file, which
``tpu_dra_torch.api.crd.compute_domain_crd()`` is the one source of;
needs PyYAML.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from tpu_dra_torch.api.crd import compute_domain_crd

OUT = (Path(__file__).resolve().parent / "chart" / "gpu-dra-driver"
       / "crds" / "resource.gpu.dev_computedomains.yaml")

HEADER = ("# Generated by python -m tpu_dra_torch.deploy.gencrd from "
          "tpu_dra_torch/api/crd.py — do not edit.\n")


def render() -> str:
    """The CRD file's text: the header, then the CRD as YAML."""
    import yaml

    return HEADER + yaml.safe_dump(compute_domain_crd(),
                                   default_flow_style=False, sort_keys=False)


def write(path: Path = OUT) -> Path:
    path = Path(path)
    path.write_text(render(), encoding="utf-8")
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpu_dra_torch.deploy.gencrd",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=OUT,
                    help="where to write the CRD (default: the chart's)")
    args = ap.parse_args(argv)
    print(f"wrote {write(args.out)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
