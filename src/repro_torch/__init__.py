"""PyTorch + CUDA port of the ASAP prefill-serving system (`repro` is the JAX
reference this package is held against).  Imports torch and numpy only."""
