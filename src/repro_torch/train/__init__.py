"""Training: AdamW with warmup + cosine, and the checkpointed Trainer."""
