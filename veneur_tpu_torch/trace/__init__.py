"""The self-trace plane's pure helpers (`store.py`). The trace client,
its span store and exemplars arrive with the tracing plane."""
