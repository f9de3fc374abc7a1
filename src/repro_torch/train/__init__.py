"""Training and serving steps of the port: `optimizer` (AdamW, the
cosine / WSD / const schedules), `train_step` (cross-entropy, the loss,
one optimizer step with microbatch accumulation) and `serve_step`
(prefill, decode, generate)."""
