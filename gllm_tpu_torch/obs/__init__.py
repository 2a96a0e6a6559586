"""Observability: the Prometheus-style metrics registry (``metrics.py``)."""
