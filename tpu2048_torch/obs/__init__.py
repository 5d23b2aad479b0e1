"""Observability of the port: logging, metrics, job handles and host
timing, copied from ``tpu2048/obs`` so the port imports nothing of
``tpu2048``."""
