"""Parallelism: the process group (``mesh.py``), the data-parallel steps (``dp.py``) and
floor sharding (``sp.py``)."""
