"""Dense transformer (llama family) in plain PyTorch."""
