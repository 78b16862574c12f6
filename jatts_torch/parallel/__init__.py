"""Multi-process training on ``torch.distributed`` (counterpart of
jatts_tpu/parallel): the ``("data", "model")`` mesh, the batch's layout
over it, tensor-parallel parameter sharding and the collectives the
modules take part in."""
