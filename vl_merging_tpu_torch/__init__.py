"""vl-merging-tpu on PyTorch and CUDA (NVIDIA Hopper).

The port of ``vl_merging_tpu`` (the JAX/TPU package, kept beside it as the
reference).  Module names follow the JAX package, so each function's
counterpart is found under the same path.  Plain tensor code is PyTorch;
every Pallas kernel the JAX package runs on the ported path is a
hand-written CUDA C++ kernel for ``sm_90a`` under ``csrc/``, built at
first use by ``ops/_build.py``.

This package imports ``torch`` and never ``jax`` nor the JAX package,
and reads no file of it: ``config.py`` is its own copy of the
pure-Python config module.

Ported so far: the COCO/Flickr retrieval eval (``evaluation.retrieval``)
over the single-modality towers (``models.model.infer_image_ft`` /
``infer_text_ft``), and the irtr fine-tune step over the same towers
(``train.loop.build_train_step``).
"""

__version__ = "0.1.0"
