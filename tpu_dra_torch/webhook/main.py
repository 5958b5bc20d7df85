"""Webhook entry point (counterpart of tpu_dra/webhook/main.py).

Run: ``python -m tpu_dra_torch.webhook.main [flags]``
"""

from __future__ import annotations

import signal
import threading

from tpu_dra_torch.infra import debug
from tpu_dra_torch.infra.flags import (
    Flag, FlagSet, apply_feature_gates, feature_gate_flag, logging_flags,
    setup_logging,
)
from tpu_dra_torch.webhook.server import WebhookServer


def flags() -> FlagSet:
    return FlagSet("gpu-dra-webhook", [
        Flag("port", "WEBHOOK_PORT", default=8443, type=int,
             help="HTTPS listen port"),
        Flag("tls-cert-file", "TLS_CERT_FILE", default="",
             help="PEM certificate (empty = plain HTTP, dev only)"),
        Flag("tls-key-file", "TLS_KEY_FILE", default="",
             help="PEM private key"),
        feature_gate_flag(),
        *logging_flags(),
    ])


def main(argv=None) -> int:
    fs = flags()
    ns = fs.parse(argv)
    logger = setup_logging(ns.v, ns.log_json)
    apply_feature_gates(ns)
    fs.dump_config(ns, logger)
    debug.start_debug_signal_handlers()

    server = WebhookServer(port=ns.port,
                           cert_file=ns.tls_cert_file or None,
                           key_file=ns.tls_key_file or None)
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    server.start()
    logger.info("webhook serving on :%d", server.port)
    stop.wait()
    server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
