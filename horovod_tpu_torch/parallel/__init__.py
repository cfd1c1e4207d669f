"""Parallelism building blocks of the port (so far: the attention mask
vocabulary that serving's paged attention shares with training)."""
