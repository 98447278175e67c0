"""Training: the irtr fine-tune step (objectives, optimizer, schedule)."""
