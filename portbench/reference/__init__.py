"""The plain reference: float32 PyTorch, TF32 off, written from the
configuration's description and imported by neither the program nor its
tests. It imports no JAX, no JAX package and nothing of the port."""
