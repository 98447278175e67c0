"""Hand-written Hopper kernels and their plain PyTorch twins.

Each kernel wrapper runs its kernel on CUDA tensors (or raises) and its
plain twin on CPU tensors; ``<wrapper>.launches`` counts kernel launches.
"""
