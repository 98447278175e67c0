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
``infer_text_ft``), in bf16 and in the W8A8 int8 mode (``eval_int8``,
``ops.int8``), and the irtr fine-tune step over the same towers
(``train.loop.build_train_step``), and the merging suite: checkpoint I/O,
surgery and ingest (``ckpt``), host and fleet merging (``merging``), the
RegMean gram pass through activation taps (``train.gram``,
``models.taps``) and the ``merge`` / ``convert`` CLIs; the fused VL pass
(``models.model.infer``) and the downstream eval
(``evaluation.downstream``); every objective of the JAX package's
``compute_losses`` in training (``train.objectives``: mlm, mim, ifm with
the towers' vlffn re-runs, itm with hard negatives, irtr, vqa, nlvr2,
img_cls; mixed single/multi-modal batches), the adamw, adam and sgd
optimizers, and the dVAE that gives MIM its labels (``dvae``); the
Trainer (``train.loop.Trainer``: fit, validate, recall, test, checkpoints
and resume), the ``run`` and ``cache_gram_matrices`` CLIs, and the data
pipeline (``data``, ``runtime``, ``utils``), in one process.
"""

__version__ = "0.1.0"
