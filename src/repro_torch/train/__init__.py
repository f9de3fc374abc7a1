"""Serving steps of the port (``serve_step.py``); training is not ported
yet (ROADMAP queue 1 item 9)."""
