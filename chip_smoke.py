#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Both paths run ``task_finetune_irtr_coco_square_randaug_base_image384`` +
``ufo`` at the full width of ViT-B/16 @384 (bf16): 577 image tokens, 12
layers, C=768, 12 heads, MLP 3072; 40 text tokens.  Weights are random
from a seed, with a non-zero rel-pos bias table and q/v biases; images
and captions are synthetic.

  * the COCO/Flickr retrieval eval
    (``vl_merging_tpu_torch.evaluation.retrieval.compute_irtr_recall``);
  * the irtr fine-tune step (``vl_merging_tpu_torch.train.loop.
    build_train_step``): f32 master params, micro-batches of 32 image/
    caption pairs, 2 micro-batches per optimizer step, 3 steps, no warmup.

Phases, each fatal on failure:
  1. a CUDA device (printed as nvidia-smi names it, with its power limit);
  2. the kernels built from ``vl_merging_tpu_torch/csrc`` (build time);
  3. each kernel (K1 ln_linear, K2 packed_attention, K3 proj_mlp_tail,
     K9 packed_attention_bwd, K13 mlp) at main-path shapes against its
     plain twin on the same inputs, with its tolerance; kernel, twin and
     (where one PyTorch call computes the same function) library call
     timed with CUDA events, beside the least time the card could take;
  4. ``compute_irtr_recall`` over 64 images (batches of 32) and 320
     captions (batches of 64): K1-K3 launched 12 times per image batch,
     K13 12 times per text batch; finite features, image cls_feats within
     cosine 0.999 of the plain path's; the image tower's images/s on both
     paths;
  5. three train steps: K2 and K9 launched 12 times and K13 24 times per
     micro-batch, finite loss and grad norm every step; kernel-path
     gradients within global cosine 0.999 of the plain path's at the same
     params, batch and random draws; step time, pairs/s and peak memory on
     both paths.

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
import torch.nn.functional as F

from vl_merging_tpu_torch.ckpt.convert import eval_cast_params, \
    master_params, params_from_numpy
from vl_merging_tpu_torch.config import build_config
from vl_merging_tpu_torch.device import require_cuda
from vl_merging_tpu_torch.evaluation.retrieval import compute_irtr_recall, \
    extract_features
from vl_merging_tpu_torch.models.spec import init_params, make_model_spec
from vl_merging_tpu_torch.ops import _build
from vl_merging_tpu_torch.ops import attention as attn_ops
from vl_merging_tpu_torch.ops import fused_block as fb_ops
from vl_merging_tpu_torch.ops import mlp as mlp_ops
from vl_merging_tpu_torch.train import train_step
from vl_merging_tpu_torch.train.loop import accum_steps, build_train_step

SEED = 0
CONFIG = ("task_finetune_irtr_coco_square_randaug_base_image384", "ufo")
IMAGE_BATCH, N_IMAGES = 32, 64
CAPTIONS_PER_IMAGE, TEXT_BATCH = 5, 64
MICRO_BATCH, TRAIN_STEPS = 32, 3
N, C, HEADS, HIDDEN = 577, 768, 12, 3072
BF16_ULP = 2.0 ** -7
# Kernel vs twin: K1, K3 and K13 round where their twins do, so they differ
# by f32 summation order (and erf's last f32 ulp): 2 bf16 ulps.  K2 rounds
# exp(s - running max) to bf16 before normalising, its twin the
# normalised probabilities, and it adds the bias inside the f32
# accumulation of q·kᵀ: 4 ulps.  K9 rounds p and ds where its twin does,
# but a ds on the other side of a rounding boundary moves the dq/dk sums
# it enters: 4 ulps; its f32 dbias (a sum over 32 samples) is held to a
# relative norm error of 1e-3.
ULPS = {"ln_linear": 2, "packed_attention": 4, "proj_mlp_tail": 2,
        "packed_attention_bwd": 4, "mlp": 2}
DBIAS_REL = 1e-3
MIN_COSINE = 0.999
TIMED_ITERS = 20
# H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor cores, HBM3
PEAK_BF16_FLOPS, PEAK_BYTES = 989e12, 3.35e12


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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(flops: float, bytes_: float) -> tuple:
    """The least time (ms) the card could take: the larger of the
    operations over the bf16 peak and the bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, bytes_ / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), \
        "operations" if t_ops >= t_bytes else "bytes"


# --------------------------------------------------------------------------
# Phase 3: every kernel against its twin, at main-path shapes
# --------------------------------------------------------------------------

def kernel_inputs(dev, gen):
    """Main-path shapes: one image block of the eval or of a training
    micro-batch at B=32 (bf16), and the training image MLP's 32·577 rows."""
    B = IMAGE_BATCH

    def r(*shape, s=1.0, bf16=False, shift=0.0):
        t = shift + s * torch.randn(*shape, device=dev, generator=gen)
        return t.bfloat16() if bf16 else t

    mask = torch.ones(B, N, dtype=torch.int32, device=dev)
    mask[-1, 500:] = 0   # exercise the key mask too
    return {
        "ln_linear": (r(B, N, C, bf16=True), r(C, s=0.1, shift=1.0),
                      r(C, s=0.1), r(3 * C, C, s=0.02, bf16=True),
                      r(3 * C, s=0.1)),
        "packed_attention": (r(B, N, 3 * C, bf16=True), r(HEADS, N, N), mask,
                             64 ** -0.5, HEADS),
        "proj_mlp_tail": (r(B, N, C, bf16=True), r(C, C, s=0.02, bf16=True),
                          r(C, s=0.1), r(C, s=0.1), r(B, N, C, bf16=True),
                          r(C, s=0.1, shift=1.0), r(C, s=0.1),
                          r(HIDDEN, C, s=0.02, bf16=True), r(HIDDEN, s=0.1),
                          r(C, HIDDEN, s=0.02, bf16=True), r(C, s=0.1),
                          r(C, s=0.1)),
        "packed_attention_bwd": (r(B, N, 3 * C, bf16=True), r(HEADS, N, N),
                                 mask, r(B, N, C, bf16=True),
                                 64 ** -0.5, HEADS),
        "mlp": (r(B, N, C, bf16=True), r(HIDDEN, C, s=0.02, bf16=True),
                r(HIDDEN, s=0.1), r(C, HIDDEN, s=0.02, bf16=True),
                r(C, s=0.1)),
    }


def _valid_keys(mask) -> int:
    return int(mask.sum())


def work(name: str, args) -> tuple:
    """(flops, bytes) the function needs on these inputs: each input read
    once, each output written once, products over valid keys only."""
    if name == "ln_linear":
        x, lw, lb, w, b = args
        M, O = x.shape[0] * x.shape[1], w.shape[0]
        return 2 * M * C * O, nbytes(x, lw, lb, w, b) + M * O * 2
    if name == "packed_attention":
        qkv, bias, mask = args[:3]
        flops = 4 * 64 * N * HEADS * _valid_keys(mask)
        return flops, nbytes(qkv, bias, mask) + qkv.numel() // 3 * 2
    if name == "proj_mlp_tail":
        M = args[0].shape[0] * args[0].shape[1]
        return 2 * M * C * C + 4 * M * C * HIDDEN, \
            nbytes(*args) + M * C * 2
    if name == "packed_attention_bwd":
        qkv, bias, mask, g = args[:4]
        flops = 10 * 64 * N * HEADS * _valid_keys(mask)
        return flops, 2 * nbytes(qkv, bias) + nbytes(mask, g)
    if name == "mlp":
        M = args[0].shape[0] * args[0].shape[1]
        return 4 * M * C * HIDDEN, nbytes(*args) + M * C * 2
    raise KeyError(name)


def _sdpa_args(qkv, bias, mask):
    """q, k, v (B, H, N, d) views of the packed qkv and the additive mask
    (B, H, N, N) bf16: the bias with masked keys at -inf."""
    B = qkv.shape[0]
    q, k, v = qkv.view(B, N, 3, HEADS, 64).permute(2, 0, 3, 1, 4)
    am = bias[None] + torch.zeros_like(mask, dtype=torch.float32).masked_fill(
        mask == 0, float("-inf"))[:, None, None, :]
    return q, k, v, am.to(qkv.dtype)


def library_call(name: str, args):
    """One PyTorch call computing the same function, as a yardstick (the
    port never calls it), or None where there is none: LN+linear (K1), the
    fused proj/MLP tail (K3) and fc1+gelu+fc2 (K13) take several calls."""
    if name == "packed_attention":
        q, k, v, am = _sdpa_args(*args[:3])
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am,
                                                      scale=args[3])
    if name == "packed_attention_bwd":
        qkv, bias, mask, g = args[:4]
        q, k, v, am = (t.detach().requires_grad_()
                       for t in _sdpa_args(qkv, bias, mask))
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=am,
                                             scale=args[4])
        gh = g.view(g.shape[0], N, HEADS, 64).transpose(1, 2)
        return lambda: torch.autograd.grad(out, (q, k, v, am), gh,
                                           retain_graph=True)
    return None


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
    "packed_attention_bwd": (attn_ops.packed_attention_bwd,
                             attn_ops.packed_attention_bwd_reference,
                             "vl_merging_tpu_torch/csrc/"
                             "packed_attention_bwd.cu",
                             "vl_merging_tpu/ops/attention.py:511"),
    "mlp": (mlp_ops.mlp_kernel, mlp_ops.mlp_kernel_reference,
            "vl_merging_tpu_torch/csrc/mlp.cu",
            "vl_merging_tpu/ops/mlp.py:140"),
}


def ulp_check(name: str, got, want) -> tuple:
    err = (got.float() - want.float()).abs()
    ref = want.float().abs()
    worst = float((err / (ULPS[name] * BF16_ULP * (ref + ref.mean()))).max())
    return float(err.max()), worst


def check_kernels(dev, card: str) -> dict:
    gen = torch.Generator(device=dev).manual_seed(SEED)
    inputs = kernel_inputs(dev, gen)
    rows = {}
    for name, (kernel, twin, source, replaces) in KERNELS.items():
        args = inputs[name]
        got, want = kernel(*args), twin(*args)
        torch.cuda.synchronize()
        if name == "packed_attention_bwd":
            (got, dbias), (want, dbias_want) = got, want
            rel = float((dbias - dbias_want).norm() / dbias_want.norm())
            print(f"{name}: dbias relative norm error {rel:.3e} (bound "
                  f"{DBIAS_REL})")
            if not bool(torch.isfinite(dbias).all()) or rel > DBIAS_REL:
                fail(f"{name}: dbias disagrees with its plain twin")
        max_err, worst = ulp_check(name, got, want)
        print(f"{name}: max |kernel - twin| = {max_err:.6g}, worst "
              f"err/bound = {worst:.3f} (bound {ULPS[name]} bf16 ulps)")
        if not bool(torch.isfinite(got).all()) or worst > 1.0:
            fail(f"{name} disagrees with its plain twin")
        ms = time_ms(lambda: kernel(*args))
        plain_ms = time_ms(lambda: twin(*args), iters=TIMED_ITERS // 2)
        lib = library_call(name, args)
        library_ms = None if lib is None else time_ms(lib)
        bound_ms, bound_by = bound(*work(name, args))
        shape = "x".join(map(str, args[0].shape))
        print(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
              + ("none (no single PyTorch call computes it)"
                 if library_ms is None else f"{library_ms:.4f} ms")
              + f", bound {bound_ms:.4f} ms ({bound_by}) at {shape} bf16 "
              f"[{card}]")
        rows[name] = {"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": 0,
                      "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "library_ms": library_ms}
    # K13 also runs on the eval's text blocks: 64 captions x 40 tokens
    args = (inputs["mlp"][0].reshape(-1, C)[:TEXT_BATCH * 40].reshape(
        TEXT_BATCH, 40, C), *inputs["mlp"][1:])
    max_err, worst = ulp_check("mlp", mlp_ops.mlp_kernel(*args),
                               mlp_ops.mlp_kernel_reference(*args))
    print(f"mlp at 64x40 rows: max |kernel - twin| = {max_err:.6g}, worst "
          f"err/bound = {worst:.3f}, kernel "
          f"{time_ms(lambda: mlp_ops.mlp_kernel(*args)):.4f} ms, bound "
          f"{bound(*work('mlp', args))[0]:.4f} ms [{card}]")
    if worst > 1.0:
        fail("mlp disagrees with its plain twin at the text tower's rows")
    return rows


def reset_launches() -> None:
    for kernel, *_ in KERNELS.values():
        kernel.launches = 0


def read_launches() -> dict:
    return {name: k.launches for name, (k, *_r) in KERNELS.items()}


# --------------------------------------------------------------------------
# Phase 4: the retrieval eval
# --------------------------------------------------------------------------

def seeded_params(spec, dev):
    """f32 params from the seed; the reference starts the rel-pos table and
    the q/v biases at zero: non-zero values exercise the kernels' bias
    paths (the rel-pos bias in K2/K9, the q/v bias in K1)."""
    gen = torch.Generator().manual_seed(SEED)
    params = init_params(spec, gen)
    table = params["relative_position_bias_table"]
    params["relative_position_bias_table"] = 0.5 * torch.randn(
        table.shape, generator=gen)
    for k in params:
        if k.endswith((".q_bias", ".v_bias")):
            params[k] = 0.1 * torch.randn(params[k].shape, generator=gen)
    return params_from_numpy(params, dev)


def synthetic_captions(spec, n, dev, gen):
    T = spec.max_text_len
    ids = torch.randint(1000, spec.vocab_size, (n, T), device=dev,
                        generator=gen)
    lengths = torch.randint(8, T + 1, (n, 1), device=dev, generator=gen)
    masks = (torch.arange(T, device=dev)[None] < lengths).to(torch.int32)
    return ids, masks


def synthetic_eval_set(spec, dev, gen):
    images = torch.randn(N_IMAGES, 3, spec.image_size, spec.image_size,
                         device=dev, generator=gen)
    n_txt = N_IMAGES * CAPTIONS_PER_IMAGE
    ids, masks = synthetic_captions(spec, n_txt, dev, gen)
    image_batches = [{"image": images[i:i + IMAGE_BATCH]}
                     for i in range(0, N_IMAGES, IMAGE_BATCH)]
    text_batches = [{"text_ids": ids[i:i + TEXT_BATCH],
                     "text_masks": masks[i:i + TEXT_BATCH]}
                    for i in range(0, n_txt, TEXT_BATCH)]
    tiids = np.repeat(np.arange(N_IMAGES), CAPTIONS_PER_IMAGE)
    return text_batches, image_batches, tiids, np.arange(N_IMAGES)


def images_per_sec(params, spec, image_batches, kernels: bool) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    extract_features(params, spec, image_batches, "image", kernels=kernels)
    torch.cuda.synchronize()
    return N_IMAGES / (time.perf_counter() - t0)


def run_eval(dev, card: str) -> dict:
    cfg = build_config(*CONFIG)
    spec = make_model_spec(cfg)
    params = eval_cast_params(seeded_params(spec, dev), spec, cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    text_batches, image_batches, tiids, iids = synthetic_eval_set(
        spec, dev, gen)

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    recall = compute_irtr_recall(params, spec, text_batches, image_batches,
                                 tiids, iids)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    per_image = spec.num_layers * len(image_batches)
    want = {"ln_linear": per_image, "packed_attention": per_image,
            "proj_mlp_tail": per_image, "packed_attention_bwd": 0,
            "mlp": spec.num_layers * len(text_batches)}
    print(f"compute_irtr_recall: {seconds:.3f} s for {N_IMAGES} images and "
          f"{len(tiids)} captions; kernel launches {launches} (want {want}: "
          f"K1-K3 {spec.num_layers} per image batch, K13 "
          f"{spec.num_layers} per text batch)")
    if launches != want:
        fail(f"eval kernel launches {launches}, want {want}")
    print("recall: " + json.dumps(recall))
    if not all(0.0 <= v <= 1.0 for v in recall.values()):
        fail(f"recall out of range: {recall}")

    with torch.no_grad():
        img_k = extract_features(params, spec, image_batches, "image")
        img_p = extract_features(params, spec, image_batches, "image",
                                 kernels=False)
        txt_k = extract_features(params, spec, text_batches, "text")
        txt_p = extract_features(params, spec, text_batches, "text",
                                 kernels=False)
    for name, k, p in (("image", img_k, img_p), ("text", txt_k, txt_p)):
        for t in (k, p):
            if t.shape[1] != spec.hidden_size or \
                    not bool(torch.isfinite(t).all()):
                fail(f"{name} features: shape {tuple(t.shape)} or not "
                     f"finite")
        cos = F.cosine_similarity(k.float(), p.float(), dim=-1)
        print(f"{name} cls_feats, kernels vs plain path: min cosine "
              f"{float(cos.min()):.6f} (need >= {MIN_COSINE})")
        if float(cos.min()) < MIN_COSINE:
            fail(f"kernel-path {name} features disagree with the plain path")

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


# --------------------------------------------------------------------------
# Phase 5: the irtr fine-tune step
# --------------------------------------------------------------------------

def train_config(kernels: bool):
    return build_config(*CONFIG, overrides=dict(
        per_device_batch_size=MICRO_BATCH, batch_size=2 * MICRO_BATCH,
        warmup_steps=0, pallas_attention=kernels))


def synthetic_train_batch(spec, accum: int, dev, gen):
    """(accum, micro, ...) image/caption pairs."""
    n = accum * MICRO_BATCH
    images = torch.randn(n, 3, spec.image_size, spec.image_size, device=dev,
                         generator=gen)
    ids, masks = synthetic_captions(spec, n, dev, gen)
    return {k: v.reshape(accum, MICRO_BATCH, *v.shape[1:]) for k, v in
            (("image", images), ("text_ids", ids), ("text_masks", masks))}


def timed_step(step, state, batch):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    return state, metrics, 1e3 * (time.perf_counter() - t0)


def global_cosine(a: dict, b: dict) -> float:
    dot = sum((a[k].double() * b[k].double()).sum() for k in a)
    na = torch.sqrt(sum(a[k].double().square().sum() for k in a))
    nb = torch.sqrt(sum(b[k].double().square().sum() for k in b))
    return float(dot / (na * nb))


def run_training(dev, card: str) -> dict:
    cfg = train_config(kernels=True)
    spec = make_model_spec(cfg)
    accum = accum_steps(cfg)
    base = seeded_params(spec, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    batch = synthetic_train_batch(spec, accum, dev, gen)
    state, step = build_train_step(cfg, spec, master_params(base),
                                   TRAIN_STEPS)

    reset_launches()
    step_ms = []
    for i in range(TRAIN_STEPS):
        state, metrics, ms = timed_step(step, state, batch)
        step_ms.append(ms)
        loss, gnorm = float(metrics["total_loss"]), float(metrics["grad_norm"])
        print(f"train step {i + 1}: loss {loss:.6f}, grad norm {gnorm:.6f}, "
              f"{ms:.1f} ms")
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            fail(f"train step {i + 1}: loss or grad norm not finite")
    launches = read_launches()
    micro = TRAIN_STEPS * accum
    L = spec.num_layers
    want = {"ln_linear": 0, "packed_attention": L * micro,
            "proj_mlp_tail": 0, "packed_attention_bwd": L * micro,
            "mlp": 2 * L * micro}
    print(f"train: kernel launches {launches} over {micro} micro-batches "
          f"(want {want}: K2 {L}, K9 {L}, K13 {2 * L} per micro-batch)")
    if launches != want:
        fail(f"train kernel launches {launches}, want {want}")

    # kernel path vs plain path: the same params, micro-batch and draws
    params = master_params(base)
    mb = {k: v[0] for k, v in batch.items()}
    grads = {}
    for kernels in (True, False):
        g = torch.Generator(device=dev).manual_seed(SEED + 3)
        loss, _, grads[kernels] = train_step.loss_and_grads(
            params, spec, cfg, mb, g, kernels=kernels)
        print(f"micro-batch loss, {'kernel' if kernels else 'plain'} path: "
              f"{float(loss):.6f}")
    cos = global_cosine(grads[True], grads[False])
    worst = min((float(F.cosine_similarity(
        grads[True][k].flatten().double(), grads[False][k].flatten().double(),
        dim=0)), k) for k in grads[True] if grads[False][k].any())
    print(f"gradients, kernel vs plain path: global cosine {cos:.6f} (need "
          f">= {MIN_COSINE}), worst leaf {worst[0]:.6f} ({worst[1]})")
    if cos < MIN_COSINE:
        fail("kernel-path gradients disagree with the plain path")
    del grads, params

    # step time, pairs/s and peak memory: plain, kernels, kernels, plain
    plain_state, plain_step = build_train_step(
        train_config(kernels=False), spec, master_params(base), TRAIN_STEPS)
    runs = {True: (state, step), False: (plain_state, plain_step)}
    times = {True: [], False: []}
    peak = {True: 0, False: 0}
    for kernels in (False, True):
        st, fn = runs[kernels]
        runs[kernels] = (fn(st, batch)[0], fn)   # warm-up step
    for kernels in (False, True, True, False):
        st, fn = runs[kernels]
        torch.cuda.reset_peak_memory_stats()
        st, _, ms = timed_step(fn, st, batch)
        peak[kernels] = max(peak[kernels], torch.cuda.max_memory_allocated())
        runs[kernels] = (st, fn)
        times[kernels].append(ms)
    pairs = accum * MICRO_BATCH
    for kernels in (True, False):
        ms = min(times[kernels])
        print(f"train step ({'kernel' if kernels else 'plain'} path, "
              f"micro-batch {MICRO_BATCH} x {accum}): {ms:.1f} ms, "
              f"{1e3 * pairs / ms:.1f} pairs/s, peak memory "
              f"{peak[kernels] / 2**30:.2f} GiB (best of 2) [{card}]")
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
    eval_launches = run_eval(dev, card)
    train_launches = run_training(dev, card)
    for name, row in rows.items():
        row["launches_eval"] = eval_launches[name]
        row["launches_train"] = train_launches[name]
        row["launches"] = eval_launches[name] + train_launches[name]
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
