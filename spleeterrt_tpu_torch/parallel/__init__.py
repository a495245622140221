"""Process groups and the (stem, data) device mesh over torch.distributed."""
