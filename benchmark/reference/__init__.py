"""The benchmark's plain reference: a path tracer of the reference tracer's
semantics in plain PyTorch and NumPy, which reads the scene document and
the seed and nothing the program made."""
