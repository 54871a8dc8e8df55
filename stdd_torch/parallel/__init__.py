"""Data-parallel training and sharded serving over ``torch.distributed``
(port of ``stdd_tpu/parallel``)."""
