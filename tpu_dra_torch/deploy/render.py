"""Render the deployment manifests and demo specs to YAML (counterpart of
tpu_dra/deploy/render.py; needs PyYAML).

Run: ``python -m tpu_dra_torch.deploy.render -o OUT_DIR --demo-dir DIR``
"""

from __future__ import annotations

import argparse
import os

from tpu_dra_torch.deploy import demos, manifests


def render_all(out_dir: str, ns: str, image: str, demo_dir: str,
               ca_bundle: str = "") -> list:
    import yaml

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{manifests.APP}.yaml")
    docs = manifests.all_manifests(ns, image, ca_bundle)
    with open(path, "w") as f:
        yaml.safe_dump_all(docs, f, sort_keys=False)
    written = [path]
    os.makedirs(demo_dir, exist_ok=True)
    for name, spec_docs in demos.all_demos().items():
        p = os.path.join(demo_dir, f"{name}.yaml")
        with open(p, "w") as f:
            yaml.safe_dump_all(spec_docs, f, sort_keys=False)
        written.append(p)
    return written


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gpu-dra-render")
    ap.add_argument("-o", "--out-dir", required=True)
    ap.add_argument("--demo-dir", required=True)
    ap.add_argument("--namespace", default=manifests.DEFAULT_NAMESPACE)
    ap.add_argument("--image", default=manifests.DEFAULT_IMAGE)
    ap.add_argument("--ca-bundle", default="",
                    help="base64 CA bundle for the webhook clientConfig "
                         "(pair with the gpu-dra-driver-webhook-tls "
                         "Secret an operator or cert-manager provides)")
    ns = ap.parse_args(argv)
    for path in render_all(ns.out_dir, ns.namespace, ns.image,
                           demo_dir=ns.demo_dir, ca_bundle=ns.ca_bundle):
        print(path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
