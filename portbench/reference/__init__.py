"""The benchmark's plain reference: float64 PyTorch written from the
equations, independent of the program (it imports nothing of it)."""
