"""Workload models of the port (this slice: RCPSP)."""
