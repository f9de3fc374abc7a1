"""The port's checkpointing (``checkpoint.py``): the reference's on-disk
layout, so a checkpoint written by either package restores in the
other."""
