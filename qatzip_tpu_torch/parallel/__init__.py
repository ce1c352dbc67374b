"""Distributed layer: block-data-parallel over a list of devices, and
multi-process runs over torch.distributed."""
