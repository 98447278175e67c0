"""Training: the irtr fine-tune step (objectives, optimizer, schedule) and
the RegMean gram pass."""
