"""Observability, host bookkeeping only (counterpart of
``gllm_tpu/obs``): the Prometheus-style metrics registry (``metrics``),
the step-trace ring and its window summary (``steptrace``), request
spans, the step FLOPs model, the card's peak table and the Chrome-trace
converter (``spans``), and the JSONL dump tool (``dump``, imported on
use: ``python -m gllm_tpu_torch.obs.dump`` runs it as ``__main__``)."""

from gllm_tpu_torch.obs import metrics, spans, steptrace  # noqa: F401

__all__ = ["metrics", "spans", "steptrace", "dump"]
