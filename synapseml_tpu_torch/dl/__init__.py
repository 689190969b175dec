"""Deep-learning model formats on the port: the CNTK v2 reader
(:mod:`.cntk_format`) and :class:`~synapseml_tpu_torch.dl.cntk.CNTKModel`."""
