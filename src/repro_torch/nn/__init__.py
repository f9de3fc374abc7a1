"""The LM substrate of the port (every family of the reference's ten
architectures, training and serving): parameter specs and layers,
attention, MoE, SSM, RG-LRU, transformer blocks and the whole model."""
