"""Parameter loading and eval-time casts."""
