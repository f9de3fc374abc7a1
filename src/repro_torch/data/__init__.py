"""The port's data pipeline (``pipeline.py``): the reference's seeded
synthetic LM batches, equal to its own bit for bit."""
