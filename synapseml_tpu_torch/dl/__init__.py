"""Deep-learning models on the port: the CNTK v2 reader
(:mod:`.cntk_format`), :class:`~synapseml_tpu_torch.dl.cntk.CNTKModel`,
and the MoE sequence tagger (:mod:`.tagger`: config, weights, forward,
loss and AdamW train step on one card)."""
