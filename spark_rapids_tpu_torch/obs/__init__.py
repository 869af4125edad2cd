"""Observability: so far the typed metric registry (``metrics.py``)."""
