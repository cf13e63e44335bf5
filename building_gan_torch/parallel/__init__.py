"""Data parallelism: the process group (``mesh.py``) and the parallel steps (``dp.py``)."""
