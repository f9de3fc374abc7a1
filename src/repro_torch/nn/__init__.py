"""The LM substrate of the port (dense GQA family): parameter specs and
layers, attention, transformer blocks and the whole model."""
