"""The plain reference: nets, losses, optimisers and host steps in plain PyTorch and numpy."""
