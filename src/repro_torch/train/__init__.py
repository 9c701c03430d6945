"""repro_torch.train — LM training on the card (counterpart of
``repro.train``): AdamW (:mod:`.optimizer`), the microbatched train step
(:mod:`.train_step`), atomic step checkpoints in the JAX package's layout
(:mod:`.checkpoint`) and keep-k rotation with per-step straggler detection
(:mod:`.fault_tolerance`)."""
