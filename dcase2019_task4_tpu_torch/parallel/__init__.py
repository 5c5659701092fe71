"""Data parallelism over a torch.distributed process group (counterpart of
dcase2019_task4_tpu/parallel/)."""
