"""Training: the Trainer and its loops, the train and eval steps
(objectives, optimizer, schedule), full-state checkpoints and the RegMean
gram pass."""
