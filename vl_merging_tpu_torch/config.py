"""Configuration system: flat config dict + named-config composition (the
port's own copy of ``vl_merging_tpu/config.py``).

Mirrors the reference's Sacred setup (reference: src/vilt/config.py:25-711) —
a flat dict of ~100 keys, a base config, task named-configs, step/epoch
modifiers, and architecture-mode configs (ufo / ln_moe / attn_moe / ffn_moe /
all_moe).  Composition semantics match Sacred's ``with a b k=v``: later
named configs override earlier ones, explicit key=value overrides win last.

The file is pure Python and is kept key-for-key equal to the JAX
package's, so a config name builds the same dict in both packages
(tests/test_torch_port_config.py holds them equal for every named config
and model mode).  Keys that only the JAX package reads (mesh layout, the
TPU PRNG, Pallas switches) are kept so that the dicts compare equal; the
port reads ``pallas_attention`` as its kernel switch
(``train/train_step._resolve_kernels``).
"""

from __future__ import annotations

import ast
import copy
from typing import Any, Callable, Dict, List, Optional

ConfigDict = Dict[str, Any]

LOSS_KEYS = (
    "itm",          # image-text matching loss
    "ifm",          # image-text contrastive loss
    "mlm",          # masked language modeling loss
    "vqa",
    "nlvr2",
    "irtr",         # retrieval fine-tune contrastive loss
    "mim",          # masked image modeling loss
    "image_only_mim",
    "text_only_mlm",
    "img_cls",      # image classification loss
    "mnc",          # declared but never implemented in the reference
    "mld",          # declared but never implemented in the reference
)


def _loss_names(d: Dict[str, float]) -> Dict[str, float]:
    """reference: src/vilt/config.py:6-22."""
    ret = {k: 0 for k in LOSS_KEYS}
    unknown = set(d) - set(LOSS_KEYS)
    if unknown:
        raise KeyError(f"unknown loss names: {sorted(unknown)}")
    ret.update(d)
    return ret


def base_config() -> ConfigDict:
    """Base config; key-for-key with reference src/vilt/config.py:25-168."""
    return dict(
        exp_name="vlmo",
        seed=1,
        datasets=["coco", "vg", "sbu", "gcc"],
        loss_names=_loss_names({"itm": 1, "ifm": 1, "mlm": 1}),
        batch_size=1024,  # desired global batch; grad accumulation derived

        # Image setting
        train_transform_keys=["square_transform_randaug"],
        val_transform_keys=["square_transform"],
        image_size=224,
        max_image_len=-1,
        patch_size=32,
        draw_false_image=0,
        image_only=False,
        img_cls_label_size=1000,

        # Text setting
        vqav2_label_size=3129,
        max_text_len=40,
        max_text_len_of_initckpt=196,
        tokenizer="bert-base-uncased",
        vocab_size=30522,
        whole_word_masking=False,
        mlm_prob=0.15,
        # In-graph MLM masking (north star / SURVEY §7.6): the collator
        # emits RNG-free word-boundary ids and the (whole-word) masking +
        # 80/10/10 replacement compile into the train step's XLA graph
        # (ops/text_masking.py).  mask_token_id is resolved from the
        # datamodule tokenizer when None (bert-base-uncased: 103).
        device_mlm=False,
        mask_token_id=None,
        # In-graph train-image augmentation (north star / SURVEY §7.5):
        # the train dataset emits native-size uint8 on a zero-padded
        # canvas; RandomResizedCrop + HFlip + RandAugment(2,7) + normalize
        # compile into the train step (ops/augment.augment_train_batch).
        # Scalar RNG (crop boxes, op choices) stays host-side — cheap and
        # torchvision/reference-distribution-exact.
        device_augment=False,
        canvas_size=640,  # natives larger than this are PIL-downscaled
        draw_false_text=0,
        vl_mlm_weight=1,
        ifm_weight=1,

        # Video (kept for checkpoint compatibility; single frame only)
        num_frames=1,

        # VL setting
        max_vl_text_len=None,
        use_temporal_roll_module=False,
        vl_mlm_prob=0.15,

        # Transformer setting
        vit="vit_base_patch16_224",
        hidden_size=768,
        num_heads=12,
        num_layers=12,
        mlp_ratio=4,
        drop_rate=0.1,
        vlffn_start_layer_index=-1,

        # Optimizer setting
        optim_type="adamw",
        beta_2=0.98,
        learning_rate=1e-4,
        weight_decay=0.01,
        weight_decay_custom_modules=0.01,
        decay_power=1,
        max_epoch=100,
        max_steps=200000,
        warmup_steps=2500,
        end_lr=0.0,
        lr_mult=1,

        use_cpu=False,
        # Surgical rematerialization in the JAX package's training step
        # (recompute the O(N²) attention einsums in the backward pass);
        # numerically a no-op.  The port does not rematerialize.
        use_remat=True,

        all_mlp_mult=False,
        all_vl_mult=False,
        all_v_mult=False,
        all_l_mult=False,

        # Downstream setting
        get_recall_metric=False,
        itm_rerank_topk=0,  # >0: ITC rank + ITM rerank (extension)

        # Trainer setting
        resume_from=None,
        fast_dev_run=False,
        val_check_interval=1.0,
        test_only=False,
        validation_only=False,
        use_sharded_training=False,   # → shard params/opt over an fsdp axis
        resume_during_pretraining=False,
        limit_val_batches=1.0,
        limit_train_batches=1.0,

        # Environment
        data_root="",
        data_roots=None,
        log_dir="result",
        per_device_batch_size=0,  # reference: per_gpu_batchsize
        num_devices=None,         # None → all visible devices
        num_hosts=1,
        load_path="",
        num_workers=8,
        precision="bf16",         # "bf16" | "f32" (reference: fp16 AMP)
        # "f32" (reference parity) | "bf16" (faster, approximate): bf16
        # logits can flip retrieval top-k ranks when score gaps are tight,
        # so reported R@k numbers use f32; the reference computes f32
        # logits even under AMP.
        attention_logits_dtype="f32",
        # W8A8 int8 eval projections: accuracy-gated opt-in like bf16
        # logits: per-channel int8 weights + per-token dynamic int8
        # activations for qkv/proj/fc1/fc2; attention logits stay f32.
        eval_int8=False,
        # Serving-loop batching for the VQA test loop: >1 runs K
        # same-shape batches per dispatch; predictions are identical for
        # every value.
        eval_scan_k=1,
        # Kernel path in train/eval steps (eval always uses it).  None =
        # auto: on for training when image_len >= 577 (@384+), off at @224
        # shapes.  The port reads it as its CUDA-kernel switch.
        pallas_attention=None,
        # PRNG impl of the JAX package's training step ("unsafe_rbg" |
        # "threefry"); the port draws from a torch.Generator instead.
        # Dropout patterns carry no reference-parity contract.
        train_rng_impl="unsafe_rbg",
        # Pre-cast 2-D+ matmul weights to bf16 for eval sweeps (recall /
        # VQA test).  Bit-identical to feeding f32 masters when
        # precision="bf16" (every such weight is cast per-use anyway);
        # halves weight reads (ckpt/convert.eval_cast_params).
        eval_params_bf16=True,
        compute_memory=False,

        # Middle-representation extraction (gram caching)
        get_middle_representation=False,
        get_block_representation=False,
        get_finegrained_representation=False,
        representation_name="tmp",
        # "f64_host" = reference-parity f64(x)ᵀf64(x) per hook call
        # (cache_gram_matrices.py:251-252); "f32_device" = fast approximate
        gram_precision="f64_host",

        # Checkpoint source flavors
        use_beit_weight=False,
        use_self_weight=False,

        # ufo (modality-agnostic, shared weights)
        use_ufo=False,
        separate_inference=True,
        # moe (modality experts)
        use_moe=False,
        self_attn_for_single_mode=False,
        use_vision_weights_for_other_modalities=False,
        in_attn=False,
        in_ffn=True,

        # merging
        merge_weights=False,
        merge_ratio=0.5,
        sum_task_vectors=False,
        central_weight=None,
        sum_lambda=1,
        only_activate_used_experts=False,
        regmean=False,
        gram_matrices=None,
        scaling_for_non_diag=1,

        # custom layer norm
        use_custom_ln_attn=False,
        use_custom_ln_ffn=False,

        # masked image modeling (MIM)
        discrete_vae_weight_path="",
        num_mask_patches=75,
        max_mask_patches_per_block=None,
        min_mask_patches_per_block=16,
        dvae_image_size=112,

        # mixed single/multi-modal training
        tasks=None,
        random_initialization=False,
    )


_NAMED_CONFIGS: Dict[str, Callable[[], ConfigDict]] = {}


def named_config(fn: Callable[[], ConfigDict]) -> Callable[[], ConfigDict]:
    _NAMED_CONFIGS[fn.__name__] = fn
    return fn


def named_config_names() -> List[str]:
    return sorted(_NAMED_CONFIGS)


# --------------------------------------------------------------------------
# Task named-configs (reference: src/vilt/config.py:171-608)
# --------------------------------------------------------------------------

@named_config
def task_mlm_itm_ifm_square_randaug_base() -> ConfigDict:
    return dict(
        exp_name="mlm_itm_ifm_square_randaug_base",
        datasets=["coco", "vg", "sbu", "gcc"],
        loss_names=_loss_names({"itm": 1, "mlm": 1, "ifm": 1}),
        batch_size=1024,
        max_epoch=10,
        max_image_len=196,
        max_text_len_of_initckpt=196,
        train_transform_keys=["square_transform_randaug"],
        val_transform_keys=["square_transform"],
        image_size=224,
        patch_size=16,
        vlffn_start_layer_index=10,
        vit="vit_base_patch16_224",
    )


@named_config
def task_finetune_nlvr2_square_randaug_base() -> ConfigDict:
    return dict(
        exp_name="finetune_nlvr2_square_randaug_base",
        datasets=["nlvr2"],
        train_transform_keys=["square_transform_randaug"],
        loss_names=_loss_names({"nlvr2": 1}),
        batch_size=128,
        max_epoch=10,
        max_steps=None,
        warmup_steps=0.1,
        draw_false_image=0,
        learning_rate=1e-4,
        val_transform_keys=["square_transform"],
        image_size=224,
        patch_size=16,
        vlffn_start_layer_index=10,
        use_sharded_training=False,
        vit="vit_base_patch16_224",
    )


@named_config
def task_finetune_nlvr2_square_randaug_base_image384() -> ConfigDict:
    return dict(
        exp_name="finetune_nlvr2_square_randaug_base_image384",
        datasets=["nlvr2"],
        train_transform_keys=["square_transform_randaug"],
        loss_names=_loss_names({"nlvr2": 1}),
        batch_size=128,
        max_epoch=10,
        max_steps=None,
        warmup_steps=0.1,
        draw_false_image=0,
        learning_rate=5e-5,
        val_transform_keys=["square_transform"],
        image_size=384,
        # @384 the attention kernels carry training and the forward runs
        # once: reference batch sizes are small enough that activations fit
        use_remat=False,
        patch_size=16,
        vlffn_start_layer_index=10,
        use_sharded_training=False,
        vit="vit_base_patch16_384",
    )


@named_config
def task_finetune_vqa_square_randaug_base_image384() -> ConfigDict:
    return dict(
        exp_name="finetune_vqa_square_randaug_base_image384",
        datasets=["vqa"],
        train_transform_keys=["square_transform_randaug"],
        loss_names=_loss_names({"vqa": 1}),
        batch_size=512,
        max_epoch=10,
        max_steps=None,
        warmup_steps=0.1,
        draw_false_image=0,
        learning_rate=1e-4,
        val_transform_keys=["square_transform"],
        val_check_interval=1.0,
        lr_mult=10,
        image_size=224,
        patch_size=16,
        vlffn_start_layer_index=10,
        use_sharded_training=False,
        vit="vit_base_patch16_384",
        use_moe=False,
    )


@named_config
def task_finetune_vqa_square_randaug_base_image384_ufo() -> ConfigDict:
    cfg = task_finetune_vqa_square_randaug_base_image384()
    cfg.update(
        exp_name="finetune_vqa_square_randaug_base_image384_ufo",
        learning_rate=3e-5,
    )
    return cfg


@named_config
def task_finetune_vqa_square_randaug_large_image384_ufo() -> ConfigDict:
    cfg = task_finetune_vqa_square_randaug_base_image384_ufo()
    cfg.update(
        exp_name="finetune_vqa_square_randaug_large_image384_ufo",
        vlffn_start_layer_index=21,
        vit="vit_large_patch16_384",
        hidden_size=1024,
        num_heads=16,
        num_layers=24,
    )
    return cfg


@named_config
def task_all_in_one_pretraining() -> ConfigDict:
    return dict(
        exp_name="all_in_one_pretraining",
        train_transform_keys=["square_transform_randaug_mim"],
        tasks=["v", "l", "vl"],
        datasets=[
            ["imagenet"],
            ["bookcorpus", "wikipedia"],
            ["webvid", "sbu", "gcc", "coco", "vg"],
        ],
        data_roots=[[""], ["", ""], ["", "", "", "", ""]],
        discrete_vae_weight_path="",
        loss_names=_loss_names(
            {"image_only_mim": 1, "text_only_mlm": 1, "mim": 1,
             "itm": 1, "mlm": 1, "ifm": 1}
        ),
        batch_size=512,
        max_epoch=10,
        max_steps=None,
        warmup_steps=0.1,
        draw_false_image=0,
        learning_rate=1e-4,
        val_transform_keys=["square_transform_mim"],
        val_check_interval=1.0,
        image_size=224,
        patch_size=16,
        vlffn_start_layer_index=10,
        use_sharded_training=False,
        vit="vit_base_patch16_224",
        use_moe=False,
        random_initialization=True,
        max_vl_text_len=40,
    )


@named_config
def task_finetune_imagenet_square_randaug_base_image384() -> ConfigDict:
    return dict(
        exp_name="finetune_imagenet_square_randaug_base_image384_ufo",
        datasets=["imagenet1k"],
        train_transform_keys=["square_transform_randaug"],
        loss_names=_loss_names({"img_cls": 1}),
        batch_size=512,
        max_epoch=100,
        max_steps=None,
        warmup_steps=0.1,
        draw_false_image=0,
        learning_rate=1e-3,
        val_transform_keys=["square_transform"],
        val_check_interval=1.0,
        lr_mult=10,
        image_size=384,
        # @384 the attention kernels carry training and the forward runs
        # once: reference batch sizes are small enough that activations fit
        use_remat=False,
        patch_size=16,
        vlffn_start_layer_index=10,
        use_sharded_training=False,
        vit="vit_base_patch16_384",
        use_moe=False,
    )


@named_config
def task_finetune_imagenet_square_randaug_base_image224() -> ConfigDict:
    cfg = task_finetune_imagenet_square_randaug_base_image384()
    cfg.update(
        exp_name="finetune_imagenet_square_randaug_base_image224_ufo",
        warmup_steps=0.2,
        weight_decay=0.05,
        learning_rate=3e-3,
        lr_mult=1,
        image_size=224,
    )
    return cfg


@named_config
def task_finetune_irtr_f30k_square_randaug_base() -> ConfigDict:
    return dict(
        exp_name="finetune_irtr_f30k_square_randaug_base",
        datasets=["f30k"],
        train_transform_keys=["square_transform_randaug"],
        val_transform_keys=["square_transform"],
        loss_names=_loss_names({"irtr": 1.0}),
        batch_size=1024,
        max_epoch=10,
        max_steps=None,
        warmup_steps=0.1,
        get_recall_metric=True,
        draw_false_text=0,
        learning_rate=5e-5,
        image_size=224,
        patch_size=16,
        vlffn_start_layer_index=10,
        use_sharded_training=False,
        vit="vit_base_patch16_224",
    )


@named_config
def task_finetune_irtr_f30k_square_randaug_base_image384() -> ConfigDict:
    cfg = task_finetune_irtr_f30k_square_randaug_base()
    cfg.update(
        exp_name="finetune_irtr_f30k_square_randaug_base_image384",
        max_epoch=40,
        image_size=384,
        # @384 the attention kernels carry training and the forward runs
        # once: reference batch sizes are small enough that activations fit
        use_remat=False,
        vit="vit_base_patch16_384",
    )
    return cfg


@named_config
def task_finetune_irtr_f30k_square_randaug_large_image384() -> ConfigDict:
    cfg = task_finetune_irtr_f30k_square_randaug_base()
    cfg.update(
        exp_name="finetune_irtr_f30k_square_randaug_large_image384",
        image_size=384,
        # @384 the attention kernels carry training and the forward runs
        # once: reference batch sizes are small enough that activations fit
        use_remat=False,
        vlffn_start_layer_index=21,
        vit="vit_large_patch16_384",
        hidden_size=1024,
        num_heads=16,
        num_layers=24,
    )
    return cfg


@named_config
def task_finetune_irtr_coco_square_randaug_base_image384() -> ConfigDict:
    return dict(
        exp_name="finetune_irtr_coco_square_randaug_base_image384",
        datasets=["coco"],
        train_transform_keys=["square_transform_randaug"],
        val_transform_keys=["square_transform"],
        loss_names=_loss_names({"irtr": 1.0}),
        batch_size=1024,
        max_epoch=20,
        max_steps=None,
        warmup_steps=0.1,
        get_recall_metric=True,
        draw_false_text=0,
        learning_rate=2e-5,
        image_size=384,
        # @384 the attention kernels carry training and the forward runs
        # once: reference batch sizes are small enough that activations fit
        use_remat=False,
        patch_size=16,
        vlffn_start_layer_index=10,
        use_sharded_training=False,
        vit="vit_base_patch16_384",
    )


@named_config
def task_finetune_irtr_msrvtt_frame_square_randaug_base() -> ConfigDict:
    return dict(
        exp_name="finetune_irtr_msrvtt_frame_square_randaug_base",
        datasets=["msrvtt"],
        train_transform_keys=["square_transform_randaug"],
        val_transform_keys=["square_transform"],
        loss_names=_loss_names({"irtr": 1.0, "ifm": 1.0, "itm": 1.0}),
        batch_size=1024,
        max_epoch=10,
        max_steps=None,
        warmup_steps=0.1,
        get_recall_metric=True,
        draw_false_text=0,
        learning_rate=5e-5,
        image_size=224,
        patch_size=16,
        vlffn_start_layer_index=10,
        use_sharded_training=False,
        vit="vit_base_patch16_224",
        use_moe=False,
    )


@named_config
def task_mlm_itm_ifm_square_randaug_base_vl() -> ConfigDict:
    return dict(
        exp_name="mlm_itm_ifm_square_randaug_base_vl",
        train_transform_keys=["square_transform_randaug"],
        tasks=["vl"],
        datasets=[["sbu", "gcc", "coco", "vg"]],
        data_roots=[["", "", "", ""]],
        discrete_vae_weight_path="",
        loss_names=_loss_names({"itm": 1, "mlm": 1, "ifm": 1}),
        batch_size=512,
        max_epoch=10,
        max_steps=None,
        warmup_steps=0.1,
        draw_false_image=0,
        learning_rate=2e-4,
        val_transform_keys=["square_transform"],
        val_check_interval=1.0,
        image_size=224,
        patch_size=16,
        vlffn_start_layer_index=10,
        use_sharded_training=False,
        vit="vit_base_patch16_224",
        max_vl_text_len=40,
        max_text_len=40,
    )


@named_config
def task_test_vit_tiny_mlm_itm_ifm_square_randaug_base_vl() -> ConfigDict:
    cfg = task_mlm_itm_ifm_square_randaug_base_vl()
    cfg.update(
        exp_name="vit_tiny_mlm_itm_ifm_square_randaug_base_vl",
        datasets=[["f30k"]],
        data_roots=[[""]],
        hidden_size=192,
        num_heads=3,
        vit="vit_tiny_patch16_224",
    )
    return cfg


@named_config
def task_vit_tiny_pretraining() -> ConfigDict:
    cfg = task_mlm_itm_ifm_square_randaug_base_vl()
    cfg.update(
        exp_name="vit_tiny_pretraining",
        vit="vit_tiny_patch16_224",
        hidden_size=192,
        num_heads=3,
    )
    return cfg


# --------------------------------------------------------------------------
# Step/epoch modifier configs (reference: src/vilt/config.py:611-662)
# --------------------------------------------------------------------------

@named_config
def step10k() -> ConfigDict:
    return dict(max_epoch=100, max_steps=10000)


@named_config
def step25k() -> ConfigDict:
    return dict(max_epoch=100, max_steps=25000)


@named_config
def step50k() -> ConfigDict:
    return dict(max_epoch=100, warmup_steps=625, max_steps=50000)


@named_config
def step100k() -> ConfigDict:
    return dict(max_epoch=100, warmup_steps=1250, max_steps=100000)


@named_config
def step150k() -> ConfigDict:
    return dict(max_epoch=150, warmup_steps=1875, max_steps=150000)


@named_config
def step200k() -> ConfigDict:
    return dict(max_epoch=200, warmup_steps=2500, max_steps=200000)


@named_config
def step400k() -> ConfigDict:
    return dict(max_epoch=300, warmup_steps=5000, max_steps=400000)


@named_config
def epoch100() -> ConfigDict:
    return dict(max_epoch=100, warmup_steps=10000)


# --------------------------------------------------------------------------
# Architecture-mode configs (reference: src/vilt/config.py:664-711)
# --------------------------------------------------------------------------

@named_config
def ufo() -> ConfigDict:
    return dict(use_ufo=True, separate_inference=True)


@named_config
def ln_moe() -> ConfigDict:
    return dict(
        use_moe=False, in_attn=False, in_ffn=False,
        use_custom_ln_attn=True, use_custom_ln_ffn=True,
        separate_inference=True,
    )


@named_config
def attn_moe() -> ConfigDict:
    return dict(
        use_moe=True, in_attn=True, in_ffn=False,
        use_custom_ln_attn=True, use_custom_ln_ffn=False,
        self_attn_for_single_mode=True,
    )


@named_config
def ffn_moe() -> ConfigDict:
    return dict(
        use_moe=True, in_attn=False, in_ffn=True,
        use_custom_ln_attn=False, use_custom_ln_ffn=True,
        separate_inference=True,
    )


@named_config
def all_moe() -> ConfigDict:
    return dict(
        use_moe=True, in_attn=True, in_ffn=True,
        use_custom_ln_ffn=True, use_custom_ln_attn=True,
        self_attn_for_single_mode=True,
    )


# --------------------------------------------------------------------------
# Composition
# --------------------------------------------------------------------------

def build_config(*names: str, overrides: Optional[ConfigDict] = None) -> ConfigDict:
    """Compose base + named configs + overrides, Sacred-style.

    ``build_config("task_x", "step100k", "ufo", overrides={"seed": 2})``
    matches the reference CLI ``python run.py with task_x step100k ufo seed=2``.
    """
    cfg = base_config()
    for name in names:
        if name not in _NAMED_CONFIGS:
            raise KeyError(
                f"unknown named config {name!r}; known: {named_config_names()}"
            )
        cfg.update(copy.deepcopy(_NAMED_CONFIGS[name]()))
    if overrides:
        for k, v in overrides.items():
            if k not in cfg:
                raise KeyError(f"unknown config key {k!r}")
            if k == "loss_names" and isinstance(v, dict):
                v = _loss_names(v)
            cfg[k] = v
    _validate(cfg)
    return cfg


def parse_cli(argv: List[str]) -> ConfigDict:
    """Parse ``with``-style CLI args: named configs and key=value overrides."""
    names: List[str] = []
    overrides: ConfigDict = {}
    args = list(argv)
    if args and args[0] == "with":
        args = args[1:]
    for arg in args:
        if "=" in arg:
            key, raw = arg.split("=", 1)
            try:
                overrides[key] = ast.literal_eval(raw)
            except (ValueError, SyntaxError):
                overrides[key] = raw
        else:
            names.append(arg)
    return build_config(*names, overrides=overrides)


# Architecture presets implied by the reference's timm factory names
# (reference vision_transformer.py:1238+); named configs must agree.
VIT_PRESETS = {
    "vit_tiny_patch16_224": dict(hidden_size=192, num_heads=3, num_layers=12,
                                 patch_size=16),
    "vit_tiny_patch16_384": dict(hidden_size=192, num_heads=3, num_layers=12,
                                 patch_size=16),
    "vit_base_patch16_224": dict(hidden_size=768, num_heads=12,
                                 num_layers=12, patch_size=16),
    "vit_base_patch16_384": dict(hidden_size=768, num_heads=12,
                                 num_layers=12, patch_size=16),
    "vit_base_patch32_224": dict(hidden_size=768, num_heads=12,
                                 num_layers=12, patch_size=32),
    "vit_large_patch16_224": dict(hidden_size=1024, num_heads=16,
                                  num_layers=24, patch_size=16),
    "vit_large_patch16_384": dict(hidden_size=1024, num_heads=16,
                                  num_layers=24, patch_size=16),
    # declared by the reference registry but unused by its named configs
    # (vision_transformer.py:1238+) — kept for checkpoint compatibility
    "vit_small_patch16_224": dict(hidden_size=384, num_heads=6,
                                  num_layers=12, patch_size=16),
    "vit_small_patch16_384": dict(hidden_size=384, num_heads=6,
                                  num_layers=12, patch_size=16),
    "vit_base_patch32_384": dict(hidden_size=768, num_heads=12,
                                 num_layers=12, patch_size=32),
    "vit_large_patch32_224": dict(hidden_size=1024, num_heads=16,
                                  num_layers=24, patch_size=32),
    "vit_large_patch32_384": dict(hidden_size=1024, num_heads=16,
                                  num_layers=24, patch_size=32),
    "vit_huge_patch14_224": dict(hidden_size=1280, num_heads=16,
                                 num_layers=32, patch_size=14),
    # DeiT variants (vision_transformer.py:1609-1714); the *_distilled_*
    # ones build DistilledVisionTransformer (dist token + abs pos embeds +
    # dynamic patch sampling — models/distilled.py)
    "vit_deit_tiny_patch16_224": dict(hidden_size=192, num_heads=3,
                                      num_layers=12, patch_size=16),
    "vit_deit_small_patch16_224": dict(hidden_size=384, num_heads=6,
                                       num_layers=12, patch_size=16),
    "vit_deit_base_patch16_224": dict(hidden_size=768, num_heads=12,
                                      num_layers=12, patch_size=16),
    "vit_deit_base_patch16_384": dict(hidden_size=768, num_heads=12,
                                      num_layers=12, patch_size=16),
    "vit_deit_tiny_distilled_patch16_224": dict(
        hidden_size=192, num_heads=3, num_layers=12, patch_size=16),
    "vit_deit_small_distilled_patch16_224": dict(
        hidden_size=384, num_heads=6, num_layers=12, patch_size=16),
    "vit_deit_base_distilled_patch16_224": dict(
        hidden_size=768, num_heads=12, num_layers=12, patch_size=16),
    "vit_deit_base_distilled_patch16_384": dict(
        hidden_size=768, num_heads=12, num_layers=12, patch_size=16),
}


def _validate(cfg: ConfigDict) -> None:
    if cfg["hidden_size"] % cfg["num_heads"] != 0:
        raise ValueError("hidden_size must be divisible by num_heads")
    if cfg["image_size"] % cfg["patch_size"] != 0:
        raise ValueError("image_size must be divisible by patch_size")
    if cfg["precision"] not in ("bf16", "f32"):
        raise ValueError(f"unknown precision {cfg['precision']!r}")
    # catch the footgun of setting vit=<large/tiny> while leaving the
    # architecture keys at their ViT-base defaults
    preset = VIT_PRESETS.get(cfg["vit"])
    if preset and preset["hidden_size"] != 768 and cfg["hidden_size"] == 768:
        raise ValueError(
            f"vit={cfg['vit']!r} implies hidden_size="
            f"{preset['hidden_size']}; set hidden_size/num_heads/num_layers "
            f"to match (the reference's named configs do)")
    # max_vl_text_len TRUNCATES the vl text window relative to the pure-NLP
    # max_text_len (reference vilt_module.py:195-201 slices the
    # max_text_len-sized index by [:max_vl_text_len]).  A value >=
    # max_text_len is a NO-OP in the reference (a python slice clamps), so
    # normalize it to None here — downstream code (relpos, datasets,
    # model.infer's static split) treats None as "no truncation" and a
    # stale over-long value would otherwise crash on shape mismatch.
    if cfg["max_vl_text_len"] is not None and \
            cfg["max_vl_text_len"] >= cfg["max_text_len"]:
        cfg["max_vl_text_len"] = None
