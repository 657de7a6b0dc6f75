"""Plain references of the benchmark's configurations: plain PyTorch, float32, importing nothing of the program under test or of JAX."""
