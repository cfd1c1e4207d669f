"""The port's launcher: ``python -m horovod_tpu_torch.runner.launch``.

Copies of the JAX package's framework-free ``runner/`` modules
(``launch.py``, ``http_server.py``, ``hosts.py``, ``safe_shell_exec.py``):
the card's machine has no jax, so the port carries its own launcher, KV
server and rendezvous.  The elastic driver is in ``elastic/``.
"""
