"""Hand-written CUDA kernels of the port and their build (``build.py``)."""
