#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

The main path is the COCO/Flickr retrieval eval
(``vl_merging_tpu_torch.evaluation.retrieval.compute_irtr_recall``) at the
full width of ViT-B/16 @384 (``task_finetune_irtr_coco_square_randaug_base_
image384`` + ``ufo``, bf16): 577 image tokens, 12 layers, C=768, 12 heads,
MLP 3072; 40 text tokens.  Weights are random from a seed, with a
non-zero rel-pos bias table; images and captions are synthetic.

Phases, each fatal on failure:
  1. a CUDA device (printed as nvidia-smi names it, with its power limit);
  2. the kernels built from ``vl_merging_tpu_torch/csrc`` (build time);
  3. each kernel (K1 ln_linear, K2 packed_attention, K3 proj_mlp_tail) at
     main-path shapes (B=32, N=577) against its plain twin on the same
     inputs, with its tolerance, and both timed with CUDA events;
  4. ``compute_irtr_recall`` over 64 images (batches of 32) and 320
     captions: every kernel launched 12 times per image batch, finite
     features, image cls_feats within cosine 0.999 of the plain path's,
     and the image tower's images/s on both paths.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1 and
prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from vl_merging_tpu_torch.ckpt.convert import eval_cast_params, \
    params_from_numpy
from vl_merging_tpu_torch.config import build_config
from vl_merging_tpu_torch.device import require_cuda
from vl_merging_tpu_torch.evaluation.retrieval import compute_irtr_recall, \
    extract_features
from vl_merging_tpu_torch.models.spec import init_params, make_model_spec
from vl_merging_tpu_torch.ops import _build
from vl_merging_tpu_torch.ops import attention as attn_ops
from vl_merging_tpu_torch.ops import fused_block as fb_ops

SEED = 0
CONFIG = ("task_finetune_irtr_coco_square_randaug_base_image384", "ufo")
IMAGE_BATCH, N_IMAGES = 32, 64
CAPTIONS_PER_IMAGE, TEXT_BATCH = 5, 64
BF16_ULP = 2.0 ** -7
# Kernel vs twin: K1 and K3 round where their twins do, so they differ by
# f32 summation order (and erff's last ulp): 2 bf16 ulps.  K2 rounds
# exp(s - running max) to bf16 before normalising, its twin the
# normalised probabilities, and it adds the bias inside the f32
# accumulation of q·kᵀ: 4 ulps.
ULPS = {"ln_linear": 2, "packed_attention": 4, "proj_mlp_tail": 2}
MIN_COSINE = 0.999
TIMED_ITERS = 20


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = TIMED_ITERS) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_inputs(dev, gen):
    """Main-path shapes of one image-tower block at B=32 (bf16)."""
    B, N, C, H, Hd = IMAGE_BATCH, 577, 768, 12, 3072

    def r(*shape, s=1.0, bf16=False, shift=0.0):
        t = shift + s * torch.randn(*shape, device=dev, generator=gen)
        return t.bfloat16() if bf16 else t

    mask = torch.ones(B, N, dtype=torch.int32, device=dev)
    mask[-1, 500:] = 0   # exercise the key mask too
    return {
        "ln_linear": (r(B, N, C, bf16=True), r(C, s=0.1, shift=1.0),
                      r(C, s=0.1), r(3 * C, C, s=0.02, bf16=True),
                      r(3 * C, s=0.1)),
        "packed_attention": (r(B, N, 3 * C, bf16=True), r(H, N, N), mask,
                             64 ** -0.5, H),
        "proj_mlp_tail": (r(B, N, C, bf16=True), r(C, C, s=0.02, bf16=True),
                          r(C, s=0.1), r(C, s=0.1), r(B, N, C, bf16=True),
                          r(C, s=0.1, shift=1.0), r(C, s=0.1),
                          r(Hd, C, s=0.02, bf16=True), r(Hd, s=0.1),
                          r(C, Hd, s=0.02, bf16=True), r(C, s=0.1),
                          r(C, s=0.1)),
    }


KERNELS = {
    # name: (wrapper, plain twin, source, the TPU kernel it replaces)
    "ln_linear": (fb_ops.ln_linear, fb_ops.ln_linear_reference,
                  "vl_merging_tpu_torch/csrc/ln_linear.cu",
                  "vl_merging_tpu/ops/fused_block.py:86"),
    "packed_attention": (attn_ops.packed_attention,
                         attn_ops.packed_attention_reference,
                         "vl_merging_tpu_torch/csrc/packed_attention.cu",
                         "vl_merging_tpu/ops/attention.py:234"),
    "proj_mlp_tail": (fb_ops.proj_mlp_tail, fb_ops.proj_mlp_tail_reference,
                      "vl_merging_tpu_torch/csrc/proj_mlp_tail.cu",
                      "vl_merging_tpu/ops/fused_block.py:116"),
}


def check_kernels(dev, card: str) -> dict:
    gen = torch.Generator(device=dev).manual_seed(SEED)
    inputs = kernel_inputs(dev, gen)
    rows = {}
    for name, (kernel, twin, source, replaces) in KERNELS.items():
        args = inputs[name]
        got = kernel(*args)
        want = twin(*args)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        ref = want.float().abs()
        bound = ULPS[name] * BF16_ULP * (ref + ref.mean())
        worst = float((err / bound).max())
        max_err = float(err.max())
        print(f"{name}: max |kernel - twin| = {max_err:.6g}, worst "
              f"err/bound = {worst:.3f} (bound {ULPS[name]} bf16 ulps)")
        if not bool(torch.isfinite(got).all()) or worst > 1.0:
            fail(f"{name} disagrees with its plain twin")
        ms = time_ms(lambda: kernel(*args))
        plain_ms = time_ms(lambda: twin(*args), iters=TIMED_ITERS // 2)
        print(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms at "
              f"B=32 N=577 bf16 [{card}]")
        rows[name] = {"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "max_abs_err": max_err,
                      "ms": ms, "plain_ms": plain_ms}
    return rows


def synthetic_eval_set(spec, dev, gen):
    images = torch.randn(N_IMAGES, 3, spec.image_size, spec.image_size,
                         device=dev, generator=gen)
    n_txt = N_IMAGES * CAPTIONS_PER_IMAGE
    T = spec.max_text_len
    ids = torch.randint(1000, spec.vocab_size, (n_txt, T), device=dev,
                        generator=gen)
    lengths = torch.randint(8, T + 1, (n_txt, 1), device=dev, generator=gen)
    masks = (torch.arange(T, device=dev)[None] < lengths).to(torch.int32)
    image_batches = [{"image": images[i:i + IMAGE_BATCH]}
                     for i in range(0, N_IMAGES, IMAGE_BATCH)]
    text_batches = [{"text_ids": ids[i:i + TEXT_BATCH],
                     "text_masks": masks[i:i + TEXT_BATCH]}
                    for i in range(0, n_txt, TEXT_BATCH)]
    tiids = np.repeat(np.arange(N_IMAGES), CAPTIONS_PER_IMAGE)
    return text_batches, image_batches, tiids, np.arange(N_IMAGES)


def seeded_params(spec, cfg, dev):
    gen = torch.Generator().manual_seed(SEED)
    params = init_params(spec, gen)
    # the reference starts these at zero; non-zero values exercise the
    # kernels' bias paths (rel-pos bias in K2, the q/v bias in K1)
    table = params["relative_position_bias_table"]
    params["relative_position_bias_table"] = 0.5 * torch.randn(
        table.shape, generator=gen)
    for k in params:
        if k.endswith((".q_bias", ".v_bias")):
            params[k] = 0.1 * torch.randn(params[k].shape, generator=gen)
    return eval_cast_params(params_from_numpy(params, dev), spec, cfg)


def images_per_sec(params, spec, image_batches, kernels: bool) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    extract_features(params, spec, image_batches, "image", kernels=kernels)
    torch.cuda.synchronize()
    return N_IMAGES / (time.perf_counter() - t0)


def run_main_path(dev, card: str) -> dict:
    cfg = build_config(*CONFIG)
    spec = make_model_spec(cfg)
    params = seeded_params(spec, cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    text_batches, image_batches, tiids, iids = synthetic_eval_set(
        spec, dev, gen)

    for _, (kernel, *_rest) in KERNELS.items():
        kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    recall = compute_irtr_recall(params, spec, text_batches, image_batches,
                                 tiids, iids)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: k.launches for name, (k, *_r) in KERNELS.items()}
    want = spec.num_layers * len(image_batches)
    print(f"compute_irtr_recall: {seconds:.3f} s for {N_IMAGES} images and "
          f"{len(tiids)} captions; kernel launches {launches} "
          f"(want {want} each: {spec.num_layers} per image batch)")
    if any(n != want for n in launches.values()):
        fail(f"kernel launches {launches}, want {want} each")
    print("recall: " + json.dumps(recall))
    if not all(0.0 <= v <= 1.0 for v in recall.values()):
        fail(f"recall out of range: {recall}")

    with torch.no_grad():
        img_k = extract_features(params, spec, image_batches, "image")
        img_p = extract_features(params, spec, image_batches, "image",
                                 kernels=False)
        txt = extract_features(params, spec, text_batches, "text")
    for name, t, rows in (("image (kernels)", img_k, N_IMAGES),
                          ("image (plain)", img_p, N_IMAGES),
                          ("text", txt, len(tiids))):
        if t.shape != (rows, spec.hidden_size) or \
                not bool(torch.isfinite(t).all()):
            fail(f"{name} features: shape {tuple(t.shape)} or not finite")
    cos = torch.nn.functional.cosine_similarity(img_k.float(), img_p.float(),
                                                dim=-1)
    print(f"image cls_feats, kernels vs plain path: min cosine "
          f"{float(cos.min()):.6f} (need >= {MIN_COSINE})")
    if float(cos.min()) < MIN_COSINE:
        fail("kernel-path image features disagree with the plain path")

    # plain, kernels, kernels, plain: compare the two only within this call
    rates = {"plain": [], "kernels": []}
    for which in ("plain", "kernels", "kernels", "plain"):
        rates[which].append(images_per_sec(params, spec, image_batches,
                                           kernels=which == "kernels"))
    print(f"image tower (ViT-B/16 @384, bf16, batch {IMAGE_BATCH}): "
          f"kernels {max(rates['kernels']):.1f} img/s, plain "
          f"{max(rates['plain']):.1f} img/s (best of 2, {N_IMAGES} images "
          f"each) [{card}]")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    dev = require_cuda()
    card = card_line()
    print(card)

    prebuilt = _build.library_path().exists()
    t0 = time.perf_counter()
    _build.library()
    print(f"kernels ready in {time.perf_counter() - t0:.1f} s ("
          + ("library already built" if prebuilt else "built by nvcc") + ")")

    rows = check_kernels(dev, card)
    launches = run_main_path(dev, card)
    for name, n in launches.items():
        rows[name]["launches"] = n
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
