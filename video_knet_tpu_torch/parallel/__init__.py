"""Data parallelism over every visible GPU: the mesh (`mesh.py`) and the
process group (`distributed.py`)."""
