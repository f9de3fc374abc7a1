"""Fault tolerance of the port: the solver half of
``repro/ft/fault_tolerance.py`` (`fault_tolerance`).  `TrainSupervisor`,
which drives a train step and a checkpointer, waits for the port's
training path."""
