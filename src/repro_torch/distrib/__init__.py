"""Homa-scheduled gradient sync on ``torch.distributed``."""
