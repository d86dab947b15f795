"""Networks: layer configurations, the DAG runtime, compute policy."""
