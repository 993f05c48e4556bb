"""Data and tensor parallelism over ``torch.distributed`` (port of
``ecoflap_tpu/parallel``): ``dist`` starts the process group from what
``torchrun`` sets, ``mesh`` names the (dp, tp) axes and their groups,
``sharding`` places the weights and slices the batches."""
