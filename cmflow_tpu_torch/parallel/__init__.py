"""Data parallelism, one process per card (``mesh.py``)."""
