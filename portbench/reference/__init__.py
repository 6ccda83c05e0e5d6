"""The plain reference the benchmark holds the port to: NumPy threefry
draws, LeNet-5, a MoE decoder, and FedMom rounds, in plain PyTorch.  It
imports nothing of the system under test."""
