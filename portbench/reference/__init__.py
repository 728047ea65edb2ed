"""The plain reference: the scene, the hits and the integrators in plain PyTorch."""
