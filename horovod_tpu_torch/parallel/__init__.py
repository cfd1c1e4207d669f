"""Parallelism building blocks of the port (so far: flash attention,
whose mask vocabulary serving's paged attention shares)."""
