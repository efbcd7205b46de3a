"""Process layout: the device mesh over ``torch.distributed`` ranks."""
