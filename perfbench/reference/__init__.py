"""Plain float32/float64 PyTorch references that decide ``correct``.

Nothing here imports the program, JAX or the JAX package: the towers,
the preprocessing, the fine-tuning steps and the exact search are written
from their published descriptions, and take only the inputs and weights
the benchmark makes from the seed.
"""
