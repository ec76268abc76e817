"""Training: LoRA or full fine-tuning steps, the Noam/Adam optimizer, the
epoch runners and checkpoints with the reference's roles."""
