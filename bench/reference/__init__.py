"""The plain reference of the benchmark's models: float32 PyTorch,
independent of the program (it imports nothing of ``repro_torch``)."""
