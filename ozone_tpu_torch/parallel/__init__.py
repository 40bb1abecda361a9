"""The multi-device codec: a mesh of slots, its sharded forms on the fused
kernel, the persistent mesh executor and the torch.distributed bootstrap.

Port of `ozone_tpu/parallel/`."""
