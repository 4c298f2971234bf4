"""Multi-process data parallelism over ``torch.distributed``: the process
group, each rank's device and slice of the global batch, and the
collectives the train step needs (counterpart of
``wavenet_autoencoders_tpu/parallel/``)."""
