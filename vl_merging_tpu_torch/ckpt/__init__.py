"""Checkpoints: torch file I/O, surgery, the ingest pipeline, parameter
loading and eval-time casts."""
