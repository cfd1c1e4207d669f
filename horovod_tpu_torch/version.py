"""Copy of ``horovod_tpu/version.py`` (the port imports nothing of the JAX
package, so it keeps its own copy)."""

__version__ = "0.1.0"
