"""Training resilience: the non-finite sentinel (``sentinel.py``)."""
