"""Training resilience: the non-finite sentinel (``sentinel.py``),
bounded retry with backoff (``retry.py``) and whole-file durable writes
(``durable.py``)."""
