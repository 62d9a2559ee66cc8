"""Data, sequence and FSDP parallelism over a torch.distributed mesh (port of vidi_tpu/parallel)."""
