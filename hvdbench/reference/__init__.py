"""The plain reference: f32 PyTorch written from the configuration
files' equations.  It imports nothing of the program under test."""
