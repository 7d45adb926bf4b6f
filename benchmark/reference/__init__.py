"""The plain reference: the immersed-boundary Euler march and its FAS
cycle in plain PyTorch, on mesh tables worked out again from the
configuration by frozen copies of the numpy host build. It imports
nothing of the program and takes nothing the program made."""
