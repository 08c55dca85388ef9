"""Multi-rank verification of the port over torch.distributed."""
