"""Training resilience: the non-finite sentinel (``sentinel.py``) and
whole-file durable writes (``durable.py``)."""
