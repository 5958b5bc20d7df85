"""Shared infrastructure of the port: its own copies of the reference's
feature gates, quantities, vfs seam, fault registry, metrics and tracer
(tpu_dra/infra), so the port imports nothing of the reference."""
