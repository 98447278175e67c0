"""Evaluation: image-text retrieval recall."""
