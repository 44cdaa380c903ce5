"""Standalone operator-facing components.

Counterpart of ``dynamo_exp_tpu/components/``: the KV router as a
service of its own (``router.py``), the Prometheus metrics exporter
(``metrics.py``) and a mock worker that exercises both without a card
(``mock_worker.py``). Each has a ``python -m`` entry point.
"""
