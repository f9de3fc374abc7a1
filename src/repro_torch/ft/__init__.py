"""Fault tolerance of the port (``fault_tolerance.py``, the port of
``repro/ft/fault_tolerance.py``): failure detection, the solver's
elastic re-mesh and lane rebalance, and `TrainSupervisor`, which drives a
train step and a checkpointer."""
